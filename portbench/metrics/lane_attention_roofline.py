"""The windowed attention's share of its roofline: the least time of the
iteration's K3f, K3b and K6 calls (fp32 CUDA-core peak) over the device
time of the ``lane`` kernels."""

from portbench.harness.readers import family_selector, roofline_percent

SELECT = family_selector(("lane",))


def read(ctx):
    return roofline_percent(ctx, "lane_attention", SELECT)
