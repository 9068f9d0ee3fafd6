"""Set-up: from the start of the process that prints the result to the
window's start (imports, the build or load of the kernels, the Trainer,
the weights, the first chunk, the copy of its first update to the host)."""


def read(ctx):
    return ctx.run.setup_s
