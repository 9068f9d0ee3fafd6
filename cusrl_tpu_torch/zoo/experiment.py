"""Experiment specifications (counterpart of ``cusrl_tpu/zoo/experiment.py``).

An ``ExperimentSpec`` bundles the agent meta-factory and the environment
factories; it lowers to a ``TrainingExperimentFactory`` (the ``Trainer``), a
``PlayingExperimentFactory`` (the ``Player``) or a
``BenchmarkingExperimentFactory`` (the Player unpaced, for 1,000 steps by
default), which the CLI builds after applying its ``--`` overrides.  Each
builds its environment and agent on ``device`` (the card unless the caller
asks for the CPU) with ``seed`` (by default ``CONFIG.process_seed``, the
seed ``set_global_seed`` sets plus the process's rank).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from cusrl_tpu_torch.template.player import Player
from cusrl_tpu_torch.template.trainer import Trainer
from cusrl_tpu_torch.utils.config import CONFIG

__all__ = [
    "BenchmarkingExperimentFactory",
    "ExperimentSpec",
    "PlayingExperimentFactory",
    "TrainingExperimentFactory",
]


@dataclasses.dataclass(kw_only=True)
class TrainingExperimentFactory:
    agent: Any  # agent factory dataclass
    environment_factory: Callable
    environment_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    num_iterations: int = 1000
    checkpoint_interval: int = 50
    trainer_hooks: tuple = ()
    iterations_per_dispatch: int = 1

    def __call__(
        self,
        logger_factory=None,
        experiment_name: str = "experiment",
        checkpoint: dict | None = None,
        metadata: dict | None = None,
        verbose: bool = True,
        *,
        device=None,
        seed: int | None = None,
    ) -> Trainer:
        environment = self.environment_factory(**{**self.environment_kwargs, "device": device})
        return Trainer(
            environment=environment,
            agent_factory=self.agent,
            num_iterations=self.num_iterations,
            logger_factory=logger_factory,
            checkpoint_interval=self.checkpoint_interval,
            experiment_name=experiment_name,
            checkpoint=checkpoint,
            hooks=self.trainer_hooks,
            metadata=metadata,
            verbose=verbose,
            iterations_per_dispatch=self.iterations_per_dispatch,
            device=device,
            seed=CONFIG.process_seed if seed is None else seed,
        )


@dataclasses.dataclass(kw_only=True)
class PlayingExperimentFactory:
    agent: Any
    environment_factory: Callable
    environment_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    player_factory: Callable = Player
    player_hooks: tuple = ()
    num_steps: int | None = None
    num_episodes: int | None = None
    deterministic: bool = True
    timestep: float | None = None

    def __call__(self, checkpoint: dict | None = None, verbose: bool = True, *, device=None,
                 seed: int | None = None) -> Player:
        environment = self.environment_factory(**{**self.environment_kwargs, "device": device})
        return self.player_factory(
            environment=environment,
            agent_factory=self.agent,
            checkpoint=checkpoint,
            deterministic=self.deterministic,
            num_steps=self.num_steps,
            num_episodes=self.num_episodes,
            timestep=self.timestep,
            hooks=self.player_hooks,
            verbose=verbose,
            device=device,
            seed=CONFIG.process_seed if seed is None else seed,
        )


@dataclasses.dataclass(kw_only=True)
class BenchmarkingExperimentFactory(PlayingExperimentFactory):
    """Playing with no real-time pacing (timestep=0), reporting metrics."""

    timestep: float | None = 0.0
    num_steps: int | None = 1000


@dataclasses.dataclass(kw_only=True)
class ExperimentSpec:
    environment_name: str
    algorithm_name: str
    agent_meta_factory: Callable
    agent_meta_factory_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    training_env_factory: Callable = None
    training_env_factory_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    playing_env_factory: Callable | None = None
    playing_env_factory_kwargs: dict[str, Any] | None = None
    benchmarking_env_factory: Callable | None = None
    benchmarking_env_factory_kwargs: dict[str, Any] | None = None
    trainer_hooks: tuple = ()
    player_hooks: tuple = ()
    player_factory: Callable = Player
    num_iterations: int = 1000
    checkpoint_interval: int = 50
    iterations_per_dispatch: int = 1

    @property
    def experiment_name(self) -> str:
        return f"{self.environment_name}_{self.algorithm_name}"

    def make_agent_factory(self):
        return self.agent_meta_factory(**self.agent_meta_factory_kwargs)

    def to_training_factory(self) -> TrainingExperimentFactory:
        return TrainingExperimentFactory(
            agent=self.make_agent_factory(),
            environment_factory=self.training_env_factory,
            environment_kwargs=dict(self.training_env_factory_kwargs),
            num_iterations=self.num_iterations,
            checkpoint_interval=self.checkpoint_interval,
            trainer_hooks=self.trainer_hooks,
            iterations_per_dispatch=self.iterations_per_dispatch,
        )

    def to_playing_factory(self) -> PlayingExperimentFactory:
        factory = self.playing_env_factory or self.training_env_factory
        kwargs = self.playing_env_factory_kwargs
        if kwargs is None:
            kwargs = {} if self.playing_env_factory is not None else dict(self.training_env_factory_kwargs)
        return PlayingExperimentFactory(
            agent=self.make_agent_factory(),
            environment_factory=factory,
            environment_kwargs=dict(kwargs),
            player_factory=self.player_factory,
            player_hooks=self.player_hooks,
        )

    def to_benchmarking_factory(self) -> BenchmarkingExperimentFactory:
        factory = self.benchmarking_env_factory or self.training_env_factory
        kwargs = self.benchmarking_env_factory_kwargs
        if kwargs is None:
            kwargs = dict(self.training_env_factory_kwargs)
        return BenchmarkingExperimentFactory(
            agent=self.make_agent_factory(),
            environment_factory=factory,
            environment_kwargs=dict(kwargs),
            player_factory=self.player_factory,
            player_hooks=self.player_hooks,
        )
