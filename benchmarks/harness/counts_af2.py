"""Operations and bytes of AlphaFold2 (plainref/alphafold2.py), counted
from shapes.

As harness/counts.py: matrix products only (linear layers and einsums),
two operations per multiply-add, in the order the plain reference
computes them; the features (the nearest-centre assignment) are not model
FLOPs. Held against torch's FlopCounterMode on the reference at small
shapes (tests/test_bench_counts_af2.py).
"""
from __future__ import annotations

from harness.counts import roofline_bound_s, structure_module_flops

TRI_HEADS, TRI_DIM_HEAD = 4, 32
TARGET_FEAT, MSA_FEAT, EXTRA_MSA_FEAT = 22, 49, 25


def msa_row_ops_bytes(R: int, L: int, element_bytes: int, heads: int = 8,
                      dim_head: int = 32) -> tuple:
    """(operations, bytes) of one MSA-row launch of the triangle-attention
    kernel: q.k and p.v over R rows of L positions, 2 R L^2 H D each; q,
    k, v read and the output written once (R L H D each) and the (L, L, H)
    pair bias read once, at the configuration's element size."""
    flops = 4.0 * R * L * L * heads * dim_head
    nbytes = element_bytes * (4.0 * R * L * heads * dim_head
                              + 1.0 * L * L * heads)
    return flops, nbytes


def block_flops(L: int, R: int, c: int, c_z: int, heads: int,
                dim_head: int, global_column: bool, outer: int = 32,
                n: int = 4) -> float:
    """One Evoformer block (Algorithm 6) over R rows of width c, or with
    global_column one extra-MSA block (Algorithm 18). An empty MSA (R=0)
    leaves only the pair stack."""
    hd = heads * dim_head
    proj = 2.0 * R * L * c * (3 * hd + hd) + 2.0 * R * L * hd * c
    row = proj + 2.0 * L * L * c_z * heads + 4.0 * R * L * L * hd
    if global_column:
        col = 2.0 * R * L * c * (2 * hd + 2 * dim_head) \
            + 2.0 * R * L * hd * c + 4.0 * L * heads * R * dim_head
    else:
        col = proj + 4.0 * L * R * R * hd
    trans = 2.0 * R * L * c * n * c * 2
    opm = 2.0 * 2 * R * L * c * outer + 2.0 * L * L * R * outer * outer \
        + 2.0 * L * L * outer * outer * c_z
    msa = (row + col + trans + opm) if R else 0.0
    th = TRI_HEADS * TRI_DIM_HEAD
    mult = 2.0 * L * L * c_z * c_z * 6 + 2.0 * L ** 3 * c_z
    attn = 2.0 * L * L * c_z * (3 * th + TRI_HEADS + c_z) \
        + 2.0 * L * L * th * c_z + 4.0 * L ** 3 * th
    pair_trans = 2.0 * L * L * c_z * n * c_z * 2
    return msa + 2 * mult + 2 * attn + pair_trans


def af2_flops(L: int, N: int, E: int, cycles: int, c_m: int = 256,
              c_z: int = 128, c_e: int = 64, c_s: int = 384,
              evoformer_blocks: int = 48, extra_blocks: int = 4,
              msa_heads: int = 8, msa_head_dim: int = 32,
              extra_heads: int = 8, extra_head_dim: int = 8,
              outer: int = 32, transition: int = 4, max_relative: int = 32,
              recycle_bins: int = 15, dist_bins: int = 64,
              plddt_hidden: int = 128, plddt_bins: int = 50,
              **_) -> float:
    """One AlphaFold2 forward at L residues, N cluster rows and E extra
    rows: the input embedding (once), `cycles` cycles of recycling
    embedding, extra-MSA stack, Evoformer, single projection and structure
    module (at c_s, the published IPA sizes), then the distogram and pLDDT
    heads."""
    embed = 2.0 * N * L * MSA_FEAT * c_m + 2.0 * L * TARGET_FEAT * c_m \
        + 2.0 * 2 * L * TARGET_FEAT * c_z \
        + 2.0 * L * L * (2 * max_relative + 1) * c_z \
        + 2.0 * E * L * EXTRA_MSA_FEAT * c_e
    cycle = 2.0 * L * L * recycle_bins * c_z \
        + extra_blocks * block_flops(L, E, c_e, c_z, extra_heads,
                                     extra_head_dim, True, outer, transition) \
        + evoformer_blocks * block_flops(L, N, c_m, c_z, msa_heads,
                                         msa_head_dim, False, outer,
                                         transition) \
        + 2.0 * L * c_m * c_s + structure_module_flops(L, c_s=c_s, c_z=c_z)
    heads = 2.0 * L * L * c_z * dist_bins \
        + 2.0 * L * (c_s * plddt_hidden + plddt_hidden * plddt_hidden
                     + plddt_hidden * plddt_bins)
    return embed + cycles * cycle + heads


def msa_row_bound_s(R: int, L: int, peaks: dict, heads: int = 8,
                    dim_head: int = 32) -> float:
    return roofline_bound_s(*msa_row_ops_bytes(
        R, L, peaks["element_bytes"], heads, dim_head), peaks)
