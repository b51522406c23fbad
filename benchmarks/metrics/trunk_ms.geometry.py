"""trunk_ms.geometry: device ms per target in the Predictor2D trunks of
both models (CUDA events from hooks on the first and last block)."""
from harness import readers


def read(ctx):
    return readers.span_mean(ctx, "trunk_ms")
