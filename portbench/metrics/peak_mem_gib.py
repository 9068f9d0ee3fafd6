"""The learner's device memory: ``torch.cuda.max_memory_allocated()`` over
the window (reset at its start), in GiB."""


def read(ctx):
    peak = ctx.run.memory_peak_bytes
    return peak / 2 ** 30 if peak > 0 else None
