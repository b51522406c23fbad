"""The traffic generator: the same seed, the same requests."""
from __future__ import annotations

import numpy as np
import pytest

from harness import synthetic, traffic

MIX = {"length_min": 160, "length_max": 400, "strata": 8, "msa_rows": 40}
SEEDS = (0, 7, 2 ** 31 + 11, 2 ** 33 + 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_requests(seed):
    a, b = traffic.make_round(MIX, seed), traffic.make_round(MIX, seed)
    assert [r.L for r in a] == [r.L for r in b]
    for x, y in zip(a, b):
        assert np.array_equal(x.msa, y.msa) and x.seq == y.seq


def test_seeds_share_the_set_of_lengths():
    sets = {tuple(sorted(traffic.round_lengths(MIX, s))) for s in SEEDS}
    assert sets == {(175, 205, 235, 265, 295, 325, 355, 385)}
    orders = {tuple(traffic.round_lengths(MIX, s)) for s in SEEDS}
    assert len(orders) > 1
    a, b = traffic.make_round(MIX, 1), traffic.make_round(MIX, 2)
    assert not np.array_equal(a[0].msa[:, :10], b[0].msa[:, :10])


def test_request_contents():
    for r in traffic.make_round(MIX, 3):
        assert r.msa.shape == (40, r.L) and r.msa.dtype == np.uint8
        assert r.msa.max() <= 20 and r.msa[0].max() < 20
        assert len(r.seq) == r.L and "-" not in r.seq


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_holds_the_longest(seed):
    s = traffic.sample(8, 3, seed, must=5)
    assert 5 in s and len(set(s)) == 3 and all(0 <= i < 8 for i in s)
    assert s == traffic.sample(8, 3, seed, must=5)


def test_synthetic_msa_is_the_a3m_files(tmp_path):
    """synthetic_msa's tokens are what the port's parser reads back from
    write_synthetic_a3m's file."""
    from trx2dy_torch.io.a3m import parse_a3m
    path = tmp_path / "t.a3m"
    synthetic.write_synthetic_a3m(path, 30, 25, seed=4)
    msa = synthetic.synthetic_msa(30, 25, np.random.default_rng(4))
    assert np.array_equal(parse_a3m(str(path)), msa)


def test_synthetic_backbone_geometry():
    bb = synthetic.synthetic_backbone(40, np.random.default_rng(0))
    ca = bb["CA"]
    d = np.linalg.norm(ca[1:] - ca[:-1], axis=-1)
    assert np.allclose(d, 3.8, atol=0.1)
    nca = np.linalg.norm(bb["N"] - bb["CA"], axis=-1)
    assert np.allclose(nca, 1.458, atol=1e-6)


def test_synthetic_target_histograms():
    t = synthetic.synthetic_target(20, seed=1)
    assert t["dist"].shape == (20, 20, 37)
    assert np.allclose(t["dist"].sum(-1), 1.0, atol=1e-5)
