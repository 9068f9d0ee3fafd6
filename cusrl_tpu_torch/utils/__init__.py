"""The utilities the JAX package's ``cusrl_tpu.utils`` exports by name (those
the port has)."""

from cusrl_tpu_torch.utils.scheduler import (
    CosineAnnealingScheduler,
    ExponentialScheduler,
    LessThan,
    NotLessThan,
    PiecewiseLinearScheduler,
    StepScheduler,
    TanhScheduler,
)
