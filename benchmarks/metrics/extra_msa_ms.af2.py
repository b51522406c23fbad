"""extra_msa_ms.af2: device ms per target in the extra_msa span under af2
(the extra-MSA stack's 4 blocks, every cycle), profiled round."""
from harness import spans


def read(ctx):
    return spans.per_unit(ctx, "extra_msa", parent="af2")
