"""The experiment zoo, as the JAX package's ``cusrl_tpu.zoo`` exports it."""

from cusrl_tpu_torch.zoo.experiment import ExperimentSpec
from cusrl_tpu_torch.zoo.registry import (
    add_experiment_modules,
    get_experiment,
    list_experiments,
    load_experiment_modules,
    register_experiment,
    registry,
)
