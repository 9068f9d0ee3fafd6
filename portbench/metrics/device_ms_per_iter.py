"""The card's time an iteration: the union of the device's kernels, copies
and fills over the whole window (``torch.profiler`` with the device's
activity alone, in a run that is not traced), in ms per iteration."""


def read(ctx):
    busy_s, iterations = ctx.run.window_device_s, ctx.run.window_iterations
    if not busy_s or ctx.run.window_device_events == 0 or iterations == 0:
        return None
    return busy_s * 1e3 / iterations
