"""AlphaFold2's FLOP and byte counts (harness/counts_af2.py) against hand
counts and torch's FlopCounterMode on the plain reference, at small
shapes."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import counts, counts_af2


def test_msa_row_hand_count():
    # R=2, L=3, H=1, D=2: q.k is 2 rows x 3 queries x 3 keys x 2 products,
    # 2 operations each, and p.v the same: 4 * 2 * 9 * 2 = 144
    flops, nbytes = counts_af2.msa_row_ops_bytes(2, 3, 4, heads=1,
                                                 dim_head=2)
    assert flops == 144
    # q, k, v in and out: 4 x (2 x 3 x 2) floats; bias 9 floats
    assert nbytes == 4 * (4 * 12 + 9)


def test_msa_row_is_the_triangle_count_at_r_equal_l():
    assert counts_af2.msa_row_ops_bytes(7, 7, 2, heads=4, dim_head=32) == \
        counts.tri_attn_ops_bytes(7, 2)


@pytest.mark.parametrize("L,rows,clusters,cycles,blocks,extra_blocks", [
    (9, 12, 6, 2, 1, 2), (7, 5, 5, 1, 2, 1), (11, 30, 8, 2, 1, 1)])
def test_af2_flops_against_the_reference(L, rows, clusters, cycles, blocks,
                                         extra_blocks):
    from plainref import alphafold2 as ref
    extra = 16
    model = ref.AlphaFold2(evoformer_blocks=blocks,
                           extra_blocks=extra_blocks).eval()
    rng = np.random.default_rng(L)
    msa = rng.integers(0, 21, (rows, L))
    feats = ref.features(msa, rng.integers(0, 2, (rows, L)), 1, clusters,
                         extra, "cpu")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(feats, cycles - 1)
    E = min(rows - clusters, extra)
    assert fc.get_total_flops() == counts_af2.af2_flops(
        L, clusters, E, cycles, evoformer_blocks=blocks,
        extra_blocks=extra_blocks)


def test_published_sizes_give_the_cells_counts():
    tflop = [counts_af2.af2_flops(L, 512, 1024, 4) / 1e12
             for L in (272, 304, 336, 368)]
    assert [round(t) for t in tflop] == [129, 152, 177, 204]
