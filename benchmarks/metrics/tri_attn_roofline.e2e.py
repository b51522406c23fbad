"""tri_attn_roofline.e2e: the triangle-attention kernel's roofline bound,
bf16 bytes and rate, over its device time per launch (profiled round),
%."""
from harness import readers


def read(ctx):
    return readers.roofline(ctx, "tri_attn_fwd_kernel")
