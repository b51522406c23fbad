"""Operations and bytes of the benchmark's models, counted from shapes.

Every count is of matrix products only (linear layers, convolutions,
einsums), two operations per multiply-add, in the order the plain
reference (benchmarks/plainref) computes them: norms, softmaxes,
activations and the rigid-body algebra are not counted. The counts are
held against torch's FlopCounterMode on the plain reference at small
shapes (tests/test_bench_counts.py). PERF.md gives the derivation.

Model FLOPs of a request are of the model's forward passes; the input
features (the MSA covariance and its Cholesky inverse) are not model
FLOPs and are not counted.
"""
from __future__ import annotations

# Predictor2D's published widths (evoutils/attn_conv.py:476)
DIM, HEADS, DIM_HEAD = 128, 8, 64
TRI_HEADS, TRI_DIM_HEAD = 4, 32
RES2_WIDTH = 52
OUTER = 32
HEAD_BINS = 37 + 25 + 25 + 13


def tri_attn_ops_bytes(L: int, element_bytes: int, heads: int = TRI_HEADS,
                       dim_head: int = TRI_DIM_HEAD) -> tuple:
    """(operations, bytes) of one row- or column-wise triangle attention
    at L: the q.k and p.v products, 2 L^3 H D each; q, k, v and the bias
    read once and the output written once, at the configuration's
    element size."""
    flops = 4.0 * L ** 3 * heads * dim_head
    nbytes = element_bytes * (4.0 * L * L * heads * dim_head
                              + 1.0 * L * L * heads)
    return flops, nbytes


def roofline_bound_s(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take: operations at the precision's
    peak or bytes at the memory rate, whichever is longer."""
    return max(flops / peaks["flops"], nbytes / peaks["bytes"])


def _tri_update(L: int, d: int) -> float:
    mult = 2 * L * L * (d * 2 * d * 2 + d * d + d * d) + 2.0 * L ** 3 * d
    hd = TRI_HEADS * TRI_DIM_HEAD
    attn = 2 * L * L * (d * 3 * hd + d * TRI_HEADS + d * d + hd * d) \
        + 4.0 * L ** 3 * hd
    w = RES2_WIDTH
    stem = 2 * L * L * (d * 4 * w + 3 * w * w * 9 + 4 * w * d)
    trans = 2 * L * L * (d * 4 * d * 2)
    return 2 * mult + 2 * attn + 4 * stem + trans


def _msa_block(L: int, R: int, d: int) -> float:
    inner = HEADS * DIM_HEAD
    proj = 2 * R * L * (d * 3 * inner + inner * d)          # q, kv, out
    column = proj + 2 * 2 * L * R * R * inner
    row = proj + 2 * 2 * R * L * L * inner + 2 * L * L * d * HEADS
    ff = 2 * R * L * (d * 4 * d * 2)
    update_x = 2 * R * L * d * OUTER + 2 * L * L * OUTER * OUTER * R \
        + 2 * L * L * OUTER * OUTER * d
    update_m = 2 * L * L * d * HEADS + 2 * R * L * d * (d // HEADS) \
        + 2 * R * L * L * d + ff
    return column + row + ff + update_x + update_m


def predictor2d_flops(L: int, R: int, depth: int = 12, d: int = DIM,
                      in_dim: int = 526, emb_dim=None) -> float:
    """One Predictor2D forward at L residues and R trunk rows: the input
    projection, the relative positions, `depth` blocks and the four
    heads; with emb_dim (the e2e flavour) also the ESM embedding."""
    flops = 2 * L * L * in_dim * d + 2 * L * L * 65 * d \
        + 2 * L * L * d * HEAD_BINS
    if emb_dim is not None:
        flops += 2 * R * L * emb_dim * d
    return flops + depth * (_tri_update(L, d) + _msa_block(L, R, d))


def esm_flops(R: int, C: int, layers: int = 12, d: int = 768,
              ffn: int = 3072, vocab: int = 33) -> float:
    """One ESM-MSA-1b forward over an (R, C) MSA, C with the cls column:
    per layer the tied-row and the column attention (4 projections and 2
    products each) and the FFN; then the LM head."""
    per_layer = 2 * 8 * R * C * d * d + 4 * R * C * C * d \
        + 4 * C * R * R * d + 4 * R * C * d * ffn
    return layers * per_layer + 2 * R * C * d * d + 2 * R * C * d * vocab


def structure_module_flops(L: int, blocks: int = 8, c_s: int = 128,
                           c_z: int = 128, c_ipa: int = 16,
                           c_resnet: int = 128, heads: int = 12,
                           qk_points: int = 4, v_points: int = 8,
                           transition_layers: int = 1,
                           resnet_blocks: int = 2, angles: int = 7) -> float:
    """The structure module over L residues: linear_in, then `blocks` IPA
    blocks (shared weights), each with its transition, backbone update
    and angle resnet."""
    H, C = heads, c_ipa
    ipa = 2 * L * c_s * (3 * H * C + 3 * H * qk_points
                         + 3 * H * (qk_points + v_points)) \
        + 2 * L * L * c_z * H + 2 * 2 * H * L * L * C \
        + 2 * H * L * L * v_points * 3 + 2 * L * H * L * c_z \
        + 2 * L * H * (C + c_z + 4 * v_points) * c_s
    transition = transition_layers * 3 * 2 * L * c_s * c_s
    resnet = 2 * 2 * L * c_s * c_resnet \
        + resnet_blocks * 2 * 2 * L * c_resnet * c_resnet \
        + 2 * L * c_resnet * angles * 2
    return 2 * L * c_s * c_s + blocks * (ipa + transition + 2 * L * c_s * 6
                                         + resnet)


def folding_flops(L: int, R: int, cycles: int, depth: int = 12,
                  dim: int = DIM, in_dim: int = 2642, emb_dim: int = 768,
                  plddt_hidden: int = 128, plddt_bins: int = 50,
                  **sm) -> float:
    """Folding.forward without its pair features: per cycle the recycling
    embedder, the e2e trunk, the structure module and the pLDDT head."""
    per_cycle = 2 * L * L * 37 * dim \
        + predictor2d_flops(L, R, depth, dim, in_dim, emb_dim) \
        + structure_module_flops(L, **sm) \
        + 2 * L * (dim * plddt_hidden + plddt_hidden * plddt_hidden
                   + plddt_hidden * plddt_bins)
    return cycles * per_cycle
