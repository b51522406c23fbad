"""features_ms.geometry: device ms per target in the features span
(models/features.get_f2d, once per model: both models), profiled round."""
from harness import spans


def read(ctx):
    return spans.per_unit(ctx, "features", parent="geometry")
