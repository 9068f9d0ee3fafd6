"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program: every import's top-level name
(the part before the first dot) is compared whole, so that the port
(``cusrl_tpu_torch``) is not taken for the JAX package (``cusrl_tpu``)."""

from __future__ import annotations

import ast

import pytest
from conftest import ROOT

from portbench.harness.runner import FORBIDDEN_MODULES, forbidden_modules

MODULES = sorted(p for p in (ROOT / "portbench").rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_in_the_benchmark(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "cusrl_tpu"}


@pytest.mark.parametrize("path", [p for p in MODULES if "reference" in p.parts],
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_the_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "cusrl_tpu", "cusrl_tpu_torch", "chip_smoke"}
    assert all(name in {"portbench", "torch", "math", "contextlib", "dataclasses", "__future__"}
               for name in top_level_imports(path)), top_level_imports(path)


def test_the_parser_sees_an_import_of_jax(tmp_path):
    source = tmp_path / "m.py"
    source.write_text("import os\nfrom jax.numpy import zeros\nimport cusrl_tpu_torch.nn\n")
    assert top_level_imports(source) == {"os", "jax", "cusrl_tpu_torch"}


def test_the_run_time_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    before = set(forbidden_modules())
    monkeypatch.setitem(sys.modules, "cusrl_tpu_torch_probe.sub", types.ModuleType("cusrl_tpu_torch_probe.sub"))
    assert set(forbidden_modules()) == before
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("jaxlib.xla_client"))
    assert set(forbidden_modules()) == before | {"jaxlib"}
    assert set(FORBIDDEN_MODULES) == {"jax", "jaxlib", "flax", "cusrl_tpu"}
