"""Experiment specifications (counterpart of ``cusrl_tpu/zoo/experiment.py``).

An ``ExperimentSpec`` bundles the agent meta-factory and the environment
factories; ``to_training_factory`` lowers it to a ``TrainingExperimentFactory``
that builds the ``Trainer``.  The playing and benchmarking factories (and the
playing environment and player fields) wait for the port's ``Player``; the
factories raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from cusrl_tpu_torch.template.trainer import Trainer

__all__ = ["ExperimentSpec", "TrainingExperimentFactory"]


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
        checkpoint: dict | None = None,
        verbose: bool = True,
        *,
        device=None,
        seed: int = 0,
    ) -> Trainer:
        """Builds the environment on ``device`` (the card unless the caller
        asks for the CPU) and the Trainer around it."""
        environment = self.environment_factory(**{**self.environment_kwargs, "device": device})
        return Trainer(
            environment=environment,
            agent_factory=self.agent,
            num_iterations=self.num_iterations,
            logger_factory=logger_factory,
            checkpoint_interval=self.checkpoint_interval,
            checkpoint=checkpoint,
            hooks=self.trainer_hooks,
            verbose=verbose,
            iterations_per_dispatch=self.iterations_per_dispatch,
            device=device,
            seed=seed,
        )


@dataclasses.dataclass(kw_only=True)
class ExperimentSpec:
    environment_name: str
    algorithm_name: str
    agent_meta_factory: Callable
    agent_meta_factory_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    training_env_factory: Callable = None
    training_env_factory_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)
    benchmarking_env_factory: Callable | None = None
    benchmarking_env_factory_kwargs: dict[str, Any] | None = None
    trainer_hooks: tuple = ()
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

    def to_playing_factory(self):
        raise NotImplementedError("playing waits for the port's Player")

    def to_benchmarking_factory(self):
        raise NotImplementedError("benchmarking waits for the port's Player")
