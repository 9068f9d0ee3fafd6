"""The whole step's share of the card's bf16 peak while the card works: the
traced chunk's model FLOP (``work.schedule.model_flops`` an iteration)
over its device busy time (the union of the device events) times 989e12,
in percent."""

from portbench.work.arithmetic import PEAK_BF16_FLOPS


def read(ctx):
    trace = ctx.trace
    if trace is None or trace.device_events == 0 or trace.busy_s <= 0:
        return None
    return 100.0 * ctx.model_flops() * trace.iterations / (trace.busy_s * PEAK_BF16_FLOPS)
