"""The fused encoder block's share of its roofline: the least time of the
iteration's K4 pre and post calls over the device time of the block's
kernels (namespaces ``fbf``, ``fbp``, ``fbb``, ``fb``, and phase 2,
``dw``, where a block backward launched it)."""

from portbench.harness.readers import family_selector, roofline_percent

SELECT = family_selector(("fbf", "fbp", "fbb", "fb"), shared=("dw",), owners=("_Pre", "_Post"))


def read(ctx):
    return roofline_percent(ctx, "fused_block", SELECT)
