"""Experiment registry (counterpart of ``cusrl_tpu/zoo/registry.py``).

Global ``registry`` keyed ``"<env>_<algo>"``, with the experiment modules
loaded at the first lookup; ``add_experiment_modules`` adds modules of the
caller's (the CLI's ``-m``).  The port registers only
``cusrl_tpu_torch.zoo.locomotion`` so far.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Iterable, Sequence

from cusrl_tpu_torch.template.player import Player
from cusrl_tpu_torch.zoo.experiment import ExperimentSpec

__all__ = [
    "add_experiment_modules",
    "get_experiment",
    "list_experiments",
    "load_experiment_modules",
    "register_experiment",
    "registry",
]

registry: dict[str, ExperimentSpec] = {}
experiment_modules: list[str] = ["cusrl_tpu_torch.zoo.locomotion"]
_loaded = False


def add_experiment_modules(*modules: str) -> None:
    global _loaded
    experiment_modules.extend(modules)
    _loaded = False


def load_experiment_modules() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for module in experiment_modules:
        importlib.import_module(module)


def register_experiment(
    environment_name: str | Sequence[str],
    algorithm_name: str,
    agent_meta_factory: Callable,
    training_env_factory: Callable,
    agent_meta_factory_kwargs: dict[str, Any] | None = None,
    training_env_factory_kwargs: dict[str, Any] | None = None,
    playing_env_factory: Callable | None = None,
    playing_env_factory_kwargs: dict[str, Any] | None = None,
    benchmarking_env_factory: Callable | None = None,
    benchmarking_env_factory_kwargs: dict[str, Any] | None = None,
    trainer_hooks: Iterable = (),
    player_hooks: Iterable = (),
    player_factory: Callable | None = None,
    num_iterations: int = 1000,
    checkpoint_interval: int = 50,
    iterations_per_dispatch: int = 1,
) -> None:
    names = [environment_name] if isinstance(environment_name, str) else list(environment_name)
    for env_name in names:
        spec = ExperimentSpec(
            environment_name=env_name,
            algorithm_name=algorithm_name,
            agent_meta_factory=agent_meta_factory,
            agent_meta_factory_kwargs=dict(agent_meta_factory_kwargs or {}),
            training_env_factory=training_env_factory,
            training_env_factory_kwargs=dict(training_env_factory_kwargs or {}),
            playing_env_factory=playing_env_factory,
            playing_env_factory_kwargs=playing_env_factory_kwargs,
            benchmarking_env_factory=benchmarking_env_factory,
            benchmarking_env_factory_kwargs=benchmarking_env_factory_kwargs,
            trainer_hooks=tuple(trainer_hooks),
            player_hooks=tuple(player_hooks),
            player_factory=player_factory or Player,
            num_iterations=num_iterations,
            checkpoint_interval=checkpoint_interval,
            iterations_per_dispatch=iterations_per_dispatch,
        )
        if spec.experiment_name in registry:
            raise ValueError(f"Experiment '{spec.experiment_name}' is already registered")
        registry[spec.experiment_name] = spec


def get_experiment(environment_name: str, algorithm_name: str | None = None) -> ExperimentSpec:
    load_experiment_modules()
    key = environment_name if algorithm_name is None else f"{environment_name}_{algorithm_name}"
    if key not in registry:
        raise KeyError(f"Unknown experiment '{key}'. Available: {sorted(registry)}")
    return registry[key]


def list_experiments() -> list[str]:
    load_experiment_modules()
    return sorted(registry)
