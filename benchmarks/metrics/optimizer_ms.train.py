"""optimizer_ms.train: device ms per step in the optimizer span (the
gradients' clip and AdamW), profiled round."""
from harness import spans


def read(ctx):
    return spans.per_unit(ctx, "optimizer", parent="train_step")
