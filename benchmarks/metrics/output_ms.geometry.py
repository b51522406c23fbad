"""output_ms.geometry: device ms per target in the output span
(predict_geometry's softmax and copy to the host, both models), profiled
round."""
from harness import spans


def read(ctx):
    return spans.per_unit(ctx, "output", parent="geometry")
