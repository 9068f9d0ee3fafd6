"""Environment steps per second of wall time, in the traced run's window
(before the profiler starts): the steps of the window's chunks over the
window, from its start to the last chunk's host transfer.  The host sets
this rate in the cells at 16,384 environments, and the host's speed moves
between runs by more than any bound holds, so it is a per-layer metric."""


def read(ctx):
    window = ctx.run.window_s
    return ctx.run.env_steps / window if window > 0 and ctx.trace is not None else None
