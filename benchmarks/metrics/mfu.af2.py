"""mfu.af2: model FLOPs of AlphaFold2 (harness/counts_af2.py: the input
embedding, every cycle's extra-MSA stack, Evoformer and structure module,
the heads) over the request's wall time, % of the dense bf16 peak."""
from harness import readers


def read(ctx):
    return readers.mfu(ctx)
