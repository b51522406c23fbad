"""backward_ms.train: device ms per step in the backward span
(loss.backward()), profiled round."""
from harness import spans


def read(ctx):
    return spans.per_unit(ctx, "backward", parent="train_step")
