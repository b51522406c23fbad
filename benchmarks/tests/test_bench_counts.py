"""FLOP and byte counts against hand counts and torch's FlopCounterMode on
the plain reference, at small shapes; the peaks they are divided by."""
from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from harness import counts, peaks


def flops_of(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            fn()
    return fc.get_total_flops()


def test_tri_attn_hand_count():
    # L=3, H=1, D=2: q.k is 3 rows x 3 queries x 3 keys x 2 products, 2
    # operations each, and p.v the same: 4 * 27 * 2 = 216
    flops, nbytes = counts.tri_attn_ops_bytes(3, 4, heads=1, dim_head=2)
    assert flops == 216
    # q, k, v in and out: 4 x 9 x 2 floats; bias 9 floats; 4 bytes each
    assert nbytes == 4 * (4 * 9 * 2 + 9)
    assert counts.tri_attn_ops_bytes(3, 2, 1, 2)[1] == nbytes / 2


@pytest.mark.parametrize("wise", ["row", "col"])
def test_tri_attn_against_the_logits_path(wise):
    from plainref.predictor2d import tri_attn_logits
    L, H, D = 5, 4, 32
    q, k, v = (torch.randn(L, L, H, D) for _ in range(3))
    got = flops_of(lambda: tri_attn_logits(q, k, v, torch.randn(L, L, H),
                                           wise))
    assert got == counts.tri_attn_ops_bytes(L, 4)[0]


def test_roofline_bound_takes_the_longer():
    pk = {"flops": 100.0, "bytes": 10.0}
    assert counts.roofline_bound_s(1000.0, 50.0, pk) == 10.0
    assert counts.roofline_bound_s(100.0, 50.0, pk) == 5.0


@pytest.mark.parametrize("L,R,depth", [(6, 5, 1), (9, 3, 2)])
def test_predictor2d_flops(L, R, depth):
    from plainref.predictor2d import Predictor2D
    m = Predictor2D(depth, in_dim=526).eval()
    f2d, msa = torch.randn(L, L, 526), torch.randint(0, 21, (R, L))
    assert flops_of(lambda: m(f2d, msa)) == \
        counts.predictor2d_flops(L, R, depth, in_dim=526)


def test_esm_flops():
    from plainref.esm_msa import ESMMSA
    m = ESMMSA(layers=2, embed_dim=24, heads=2, ffn_dim=40).eval()
    toks = torch.randint(4, 29, (5, 8))
    assert flops_of(lambda: m(toks, repr_layers=(2,))) == \
        counts.esm_flops(5, 8, layers=2, d=24, ffn=40)


def test_folding_flops():
    from plainref import folding
    from plainref.esm_msa import ESMMSA, mymsa_to_esmmsa
    from plainref.structure_module import SMConfig
    L, R, esm_d, cycles = 7, 4, 24, 2
    esm = ESMMSA(layers=12, embed_dim=esm_d, heads=12, ffn_dim=40).eval()
    sm = SMConfig(no_heads_ipa=2, c_resnet=32)
    fold = folding.Folding(depth=1, in_dim=2 * esm_d + 144 + 962,
                           emb_dim=esm_d, sm=sm).eval()
    msa = torch.randint(0, 20, (R, L)).numpy()
    toks = torch.as_tensor(mymsa_to_esmmsa(msa))
    with torch.no_grad():
        emb = esm(toks, repr_layers=(12,))
    reprs, attns = emb["representations"][12], emb["row_attentions"]
    seq = "ACDEFGH"
    total = flops_of(lambda: fold(seq, toks, reprs, attns,
                                  n_recycle=cycles - 1))
    features = flops_of(lambda: folding.e2e_pair_features(reprs, attns,
                                                          toks))
    want = counts.folding_flops(
        L, R, cycles, depth=1, in_dim=2 * esm_d + 144 + 962, emb_dim=esm_d,
        heads=2, c_resnet=32)
    assert total - features == want


def test_peaks_are_the_dense_tensor_core_rates():
    name = "NVIDIA H100 80GB HBM3"
    f32, bf16 = peaks.peaks_for(name, "float32"), peaks.peaks_for(name,
                                                                  "bfloat16")
    assert f32["flops"] == 495e12 and f32["element_bytes"] == 4
    assert bf16["flops"] == 989e12 and bf16["element_bytes"] == 2
    assert f32["bytes"] == bf16["bytes"] == 3.35e12
    assert peaks.datasheet("NVIDIA H100 PCIe")[0] == "H100 PCIe"
