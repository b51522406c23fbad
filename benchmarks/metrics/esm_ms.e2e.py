"""esm_ms.e2e: device ms per target of the ESM-MSA-1b forward (CUDA events
around the call)."""
from harness import readers


def read(ctx):
    return readers.span_mean(ctx, "esm_ms")
