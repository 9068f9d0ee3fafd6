"""The port's package exports against the JAX package's: for every
``__init__.py`` of ``cusrl_tpu``, each name it imports (read from its source)
must resolve on the port's matching package, less the JAX-only names below;
none resolves to an object of JAX or of the JAX package, and resolving all of
them in a fresh interpreter imports neither."""

import ast
import importlib
import inspect
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "cusrl_tpu"

# Names with no port counterpart, with the reason.
JAX_ONLY = {
    # JAX's module system and pytree helpers (cusrl_tpu/nn/base.py): the port's modules are torch.nn.Modules.
    "Module", "ModuleFactory", "combine", "frozen_field", "partition", "static_field", "trainable_mask", "tree_paths",
    # The jitted rollout and its functional state: the port's TensorEnvironment, RolloutDriver and stateful agents.
    "JaxEnvironment", "ScanRolloutDriver", "AgentState", "DummyJaxEnvironment",
    # JAX's device mesh, PRNG keys and compilation cache; the Pallas kernels' mesh rule.
    "mesh", "device_count", "new_key", "enable_compilation_cache", "kernel_mesh_status",
}
GUARDED = {  # the simulators' adapters: neither IsaacLab nor mjlab is installed where the port runs
    "IsaacLabEnvAdapter", "IsaacLabEnvLauncher", "TrainerCfg", "make_isaaclab_env",
    "MjlabEnvAdapter", "MjlabPlayer", "make_mjlab_env",
}
ALSO = {  # names of a JAX module's ``__all__`` that the port's package exports beyond JAX's ``__init__``
    "cusrl_tpu_torch.parallel": ("collect_tp_specs", "data_axes"),
}
COUNTERPARTS = {  # the port's names in place of JAX-only ones
    "cusrl_tpu_torch": ("TensorEnvironment", "RolloutDriver"),
    "cusrl_tpu_torch.template": ("TensorEnvironment", "RolloutDriver"),
}


def _inits():
    return sorted(JAX_ROOT.rglob("__init__.py"))


def _package(path: Path) -> str:
    return ".".join(path.parent.relative_to(ROOT).parts)


def _exported_names(path: Path) -> list[str]:
    """The names an ``__init__.py`` binds by its ``from`` imports and its
    assignments (``__version__``), but ``__all__``."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names.extend(alias.asname or alias.name for alias in node.names)
        elif isinstance(node, ast.Assign):
            names.extend(t.id for t in node.targets if isinstance(t, ast.Name) and t.id != "__all__")
    return names


@pytest.mark.parametrize("init", _inits(), ids=lambda p: _package(p))
def test_every_jax_export_resolves_on_the_port(init):
    port_name = _package(init).replace("cusrl_tpu", "cusrl_tpu_torch", 1)
    port = importlib.import_module(port_name)
    wanted = [n for n in _exported_names(init) if n not in JAX_ONLY | GUARDED] + list(ALSO.get(port_name, ()))
    missing = [n for n in wanted + list(COUNTERPARTS.get(port_name, ())) if not hasattr(port, n)]
    assert not missing, f"{port_name} lacks {missing}"
    for name in wanted:
        value = getattr(port, name)
        if inspect.ismodule(value) or inspect.isclass(value) or inspect.isfunction(value):
            origin = value.__name__ if inspect.ismodule(value) else value.__module__
            assert origin.split(".")[0] not in ("cusrl_tpu", "jax", "jaxlib"), (name, origin)


def test_the_top_level_names():
    names = _exported_names(JAX_ROOT / "__init__.py")
    assert len(names) == 53
    import cusrl_tpu_torch

    assert set(names) - JAX_ONLY - {"__version__"} <= set(cusrl_tpu_torch.__all__)
    assert {"Module", "JaxEnvironment", "ScanRolloutDriver"} & set(cusrl_tpu_torch.__all__) == set()
    assert cusrl_tpu_torch.InferenceWrapper is cusrl_tpu_torch.InferencePolicy
    assert cusrl_tpu_torch.environment.VelocityLocomotionEnv.__module__ == "cusrl_tpu_torch.environment.locomotion"
    with pytest.raises(AttributeError):
        cusrl_tpu_torch.JaxEnvironment  # noqa: B018


def test_resolving_every_export_imports_no_jax():
    inits = [_package(p).replace("cusrl_tpu", "cusrl_tpu_torch", 1) for p in _inits()]
    code = (
        "import importlib, sys\n"
        f"for name in {inits!r}:\n"
        "    module = importlib.import_module(name)\n"
        "    for attr in getattr(module, '__all__', ()):\n"
        "        getattr(module, attr)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'cusrl_tpu')))\n"
    )
    result = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == "[]"
