"""Device ms per iteration of the kernels the optimizer's step launches
(inside PyTorch's ``Optimizer.step#...`` range)."""

from portbench.harness.readers import per_iteration_ms

RANGE = "Optimizer.step#"


def read(ctx):
    return per_iteration_ms(ctx.trace, lambda name, owners: any(o.startswith(RANGE) for o in owners))
