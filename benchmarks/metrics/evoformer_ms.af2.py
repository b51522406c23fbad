"""evoformer_ms.af2: device ms per target in the evoformer span under af2
(the Evoformer's 48 blocks, every cycle), profiled round."""
from harness import spans


def read(ctx):
    return spans.per_unit(ctx, "evoformer", parent="af2")
