"""mfu.train: 3 x the forward's model FLOPs per step over the step's wall
time (recompute not counted), % of the dense TF32 peak."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx)
