"""setup_s: seconds from the start of the run to the start of its window (imports, the kernels'
load or build, the inputs, the warm-up)."""


def read(ctx):
    return ctx.setup_s
