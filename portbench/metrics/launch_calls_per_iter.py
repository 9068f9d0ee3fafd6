"""Host calls that put work on the device (kernel launches, copies, fills,
graph launches; ``trace.LAUNCH_CALLS``) per iteration of the traced
chunk."""


def read(ctx):
    trace = ctx.trace
    if trace is None or not trace.launch_calls:
        return None
    return sum(trace.launch_calls.values()) / trace.iterations
