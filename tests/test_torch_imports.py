"""The port and its chip smoke script import neither JAX, optax nor the JAX
package: an AST walk over every module."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "cusrl_tpu")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _port_files():
    return sorted((ROOT / "cusrl_tpu_torch").rglob("*.py"))


def test_port_has_modules():
    names = {p.relative_to(ROOT / "cusrl_tpu_torch").as_posix() for p in _port_files()}
    assert {"nn/kernels/fused_mlp.py", "template/actor_critic.py", "nn/layer/linear.py", "nn/kernels/lane_attention.py",
            "nn/module/causal_attn.py", "nn/layer/mha.py", "nn/base.py", "nn/kernels/fused_block.py",
            "hook/on_policy/joint_seq_eval.py", "nn/kernels/banded_attention.py"} <= names


@pytest.mark.parametrize("target", ["cusrl_tpu_torch", "chip_smoke.py"])
def test_no_forbidden_imports(target):
    files = _port_files() if target == "cusrl_tpu_torch" else [ROOT / "chip_smoke.py"]
    offenders = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & set(FORBIDDEN)) for p in files}
    offenders = {k: v for k, v in offenders.items() if v}
    assert not offenders, f"forbidden imports: {offenders}"


def test_ast_walk_catches_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("def f():\n    from cusrl_tpu.nn import base\n    import jax.numpy as jnp\n")
    assert _imported_roots(bad) & set(FORBIDDEN) == {"cusrl_tpu", "jax"}
