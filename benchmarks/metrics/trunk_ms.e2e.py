"""trunk_ms.e2e: ms per target in the Folding trunk over every cycle
(device.StageTimer's trunk_k stages, summed)."""
from harness import readers


def read(ctx):
    return readers.span_mean(ctx, "trunk_ms")
