"""structure_ms.e2e: ms per target in the structure module and pLDDT head
over every cycle (StageTimer's structure_k stages, summed)."""
from harness import readers


def read(ctx):
    return readers.span_mean(ctx, "structure_ms")
