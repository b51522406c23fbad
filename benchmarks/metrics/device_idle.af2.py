"""device_idle.af2: the share of the profiled round in which no device
operation ran, %."""
from harness import readers


def read(ctx):
    return readers.idle(ctx)
