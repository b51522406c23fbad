"""structure_ms.af2: device ms per target in the structure span under af2
(the single projection and the structure module, every cycle), profiled
round."""
from harness import spans


def read(ctx):
    return spans.per_unit(ctx, "structure", parent="af2")
