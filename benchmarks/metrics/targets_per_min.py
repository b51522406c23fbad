"""targets_per_min: targets whose whole request finished in the window,
over the window's time."""


def read(ctx):
    return 60.0 * len(ctx.units) / ctx.window_s
