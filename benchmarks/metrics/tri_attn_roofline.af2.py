"""tri_attn_roofline.af2: the triangle-attention kernel's roofline bound
over its device time, every launch of the profiled round (the Evoformer's
MSA-row launches and the triangle attentions, by AF2_STATS), bf16 bytes
and rate, %."""
from harness import readers


def read(ctx):
    return readers.roofline(ctx, "tri_attn_fwd_kernel")
