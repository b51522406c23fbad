"""setup_s: seconds from the start of the process to the start of the
window (imports, weights, inputs, kernel build, warm-up)."""


def read(ctx):
    return ctx.setup_s
