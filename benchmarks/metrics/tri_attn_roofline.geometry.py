"""tri_attn_roofline.geometry: the triangle-attention kernel's roofline
bound over its device time per launch (profiled round), %."""
from harness import readers


def read(ctx):
    return readers.roofline(ctx, "tri_attn_fwd_kernel")
