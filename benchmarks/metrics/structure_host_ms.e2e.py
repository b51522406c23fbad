"""structure_host_ms.e2e: host ms per target spent issuing the structure
span (structure module and pLDDT head, every cycle), profiled round;
beside structure_ms.e2e (device ms) it says whether the layer is
host-bound."""
from harness import spans


def read(ctx):
    return spans.per_unit(ctx, "structure", parent="folding", clock="host")
