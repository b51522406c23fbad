"""features_ms.e2e: device ms per target in the features span under
folding (folding_e2e.e2e_pair_features), profiled round."""
from harness import spans


def read(ctx):
    return spans.per_unit(ctx, "features", parent="folding")
