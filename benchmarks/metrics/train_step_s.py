"""train_step_s: the window's time over the steps it finished."""


def read(ctx):
    return ctx.window_s / len(ctx.units)
