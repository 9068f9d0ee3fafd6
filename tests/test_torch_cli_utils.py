"""The port's CLI override layer and config helpers against the JAX
package's, on the cases of ``tests/test_cli_zoo.py``: ``parse_value``,
``split_cli_overrides`` and ``apply_overrides`` (through a PPO factory and a
training factory); ``to_dict``/``from_dict``, ``to_dataclass`` and the seed."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from cusrl_tpu.preset.ppo import PpoAgentFactory as JaxPpoAgentFactory
from cusrl_tpu.utils import cli_utils as jax_cli_utils
from cusrl_tpu.utils import dataclass_utils as jax_dataclass_utils
from cusrl_tpu.utils import dict_utils as jax_dict_utils
from cusrl_tpu.zoo.registry import get_experiment as jax_get_experiment
from cusrl_tpu_torch.preset.ppo import PpoAgentFactory
from cusrl_tpu_torch.utils import cli_utils, dataclass_utils, dict_utils
from cusrl_tpu_torch.utils.config import CONFIG
from cusrl_tpu_torch.utils.misc import import_obj, set_global_seed
from cusrl_tpu_torch.zoo.registry import get_experiment

CASES = [
    ("parse", "1e-4"), ("parse", "true"), ("parse", "None"), ("parse", "(64, 64)"), ("parse", "adam"),
    ("parse", "[1, 2]"), ("parse", "NULL"), ("parse", "3"),
    ("split", ["a", "b", "--", "--x.y", "1"]), ("split", ["a", "b"]), ("split", ["--", "--x", "2", "--", "3"]),
    ("factory", ["--lr", "1e-4", "--actor_hidden_dims", "(32, 32)"]), ("factory", ["--lr=5e-4"]),
    ("factory", ["--no_such_field", "5"]), ("factory", ["--lr"]), ("factory", ["lr", "1"]),
    ("training", ["--agent.lr", "5e-4", "--environment_kwargs.num_instances", "4", "--num_iterations", "2"]),
]


def _run(module, kind, arg, ppo_factory, experiment):
    if kind == "parse":
        return module.parse_value(arg)
    if kind == "split":
        return module.split_cli_overrides(arg)
    target = ppo_factory() if kind == "factory" else experiment("Velocity-Flat", "ppo").to_training_factory()
    try:
        new, applied = module.apply_overrides(target, arg)
    except (AttributeError, ValueError) as error:
        return type(error).__name__
    if kind == "factory":
        return applied, new.lr, new.actor_hidden_dims, target.lr
    return applied, new.agent.lr, new.environment_kwargs, new.num_iterations, target.agent.lr


@pytest.mark.parametrize("kind,arg", CASES, ids=[f"{k}-{i}" for i, (k, _) in enumerate(CASES)])
def test_cli_utils_match_jax(kind, arg):
    got = _run(cli_utils, kind, arg, PpoAgentFactory, get_experiment)
    want = _run(jax_cli_utils, kind, arg, JaxPpoAgentFactory, jax_get_experiment)
    assert got == want
    assert type(got) is type(want)


@dataclasses.dataclass
class _Inner:
    a: int = 1
    b: tuple = (1, 2)


@dataclasses.dataclass
class _Outer:
    inner: _Inner = dataclasses.field(default_factory=_Inner)
    name: str = "x"
    kind: type = int


def test_dict_and_dataclass_utils_match_jax():
    obj = _Outer(_Inner(3, (4,)), "y")
    data = dict_utils.to_dict(obj)
    assert data == jax_dict_utils.to_dict(obj)
    assert dict_utils.from_dict(data) == jax_dict_utils.from_dict(data) == obj
    assert dict_utils.from_dict({"name": "z"}, obj) == jax_dict_utils.from_dict({"name": "z"}, obj)
    assert dict_utils.prefix_dict_keys({"a": 1}, "p/") == jax_dict_utils.prefix_dict_keys({"a": 1}, "p/")
    for convert in ("to_dataclass", "to_strict_typed_dataclass"):
        got = getattr(dataclass_utils, convert)(obj)
        want = getattr(jax_dataclass_utils, convert)(obj)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert [f.type for f in dataclasses.fields(got)] == [f.type for f in dataclasses.fields(want)]
    assert import_obj("cusrl_tpu_torch.utils.misc:set_global_seed") is set_global_seed
    assert import_obj("cusrl_tpu_torch.utils.misc.set_global_seed") is set_global_seed


def test_set_global_seed_seeds_python_numpy_and_torch(monkeypatch):
    monkeypatch.setattr(CONFIG, "seed", 0)
    draws = []
    for _ in range(2):
        assert set_global_seed(7) == 7 and CONFIG.seed == 7
        draws.append((random.random(), np.random.rand(), torch.rand(()).item()))
    assert draws[0] == draws[1]
