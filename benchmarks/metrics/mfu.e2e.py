"""mfu.e2e: model FLOPs of ESM, every Folding cycle and the structure
module over the request's wall time, % of the dense bf16 peak."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx)
