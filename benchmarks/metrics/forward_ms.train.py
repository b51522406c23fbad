"""forward_ms.train: device ms per step in the forward span (the loss),
profiled round."""
from harness import spans


def read(ctx):
    return spans.per_unit(ctx, "forward", parent="train_step")
