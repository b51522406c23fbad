"""mfu.geometry: model FLOPs of both forwards over the request's wall time,
% of the dense TF32 peak."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx)
