"""heads_ms.geometry: device ms per target in the heads span (the four
logits heads of Predictor2D.forward, both models), profiled round."""
from harness import spans


def read(ctx):
    return spans.per_unit(ctx, "heads", parent="geometry")
