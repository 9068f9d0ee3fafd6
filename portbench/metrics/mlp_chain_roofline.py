"""The MLP chain kernels' share of their roofline: the least time of the
iteration's chain calls (``work.schedule``: K1f/K1b/K2f/K2b at the
configuration's widths and the schedule's rows) over the device time of
the chain kernels (namespaces ``mlpf``, ``mlpb``, ``mlpm``, ``mlp``, and
phase 2, ``dw``, where a chain's backward launched it)."""

from portbench.harness.readers import family_selector, roofline_percent

SELECT = family_selector(("mlpf", "mlpb", "mlpm", "mlp"), shared=("dw",), owners=("_FusedMlp", "_FusedPpoStep"))


def read(ctx):
    return roofline_percent(ctx, "mlp_chain", SELECT)
