"""The port's Dynamics dampening and measurement (trx2dy_torch/dynamics/
dampen.py, loop.py) against the JAX package, on the CPU.

Histograms and decoy coordinates are made with numpy from seeds and handed
to both packages. Decays, one-hot measurements and masks are compared
exactly; renormalised and smoothed histograms within 1e-6 (float32 sums
of 9 products, taken in JAX's order).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from trx2dy.dynamics import dampen as jdampen
from trx2dy.dynamics import driver as jdriver
from trx2dy.dynamics import loop as jloop
from trx2dy_torch.dynamics import dampen as tdampen
from trx2dy_torch.dynamics import driver as tdriver
from trx2dy_torch.dynamics import loop as tloop

torch.set_num_threads(2)

SMOOTH_TOL = 1e-6   # float32 smoothing/renormalisation, absolute
BINS = {"dist": 37, "omega": 25, "theta": 25, "phi": 13}


def _rand_npz(L, key=0):
    """tests/test_dynamics_driver.py:_rand_npz."""
    rng = np.random.default_rng(key)

    def soft(shape):
        x = rng.random(shape).astype(np.float32)
        return x / x.sum(-1, keepdims=True)
    return {k: soft((L, L, n)) for k, n in BINS.items()}


def _peaked(L, nb, seed):
    """Histograms with a mix of sharp (max >= P) and flat pairs, so both
    sides of every dampening mask occur."""
    rng = np.random.default_rng(seed)
    x = rng.random((L, L, nb)).astype(np.float32) ** 4
    x[rng.random((L, L)) < 0.3, rng.integers(0, nb)] += 8.0
    return (x / x.sum(-1, keepdims=True)).astype(np.float32)


def _onehot(L, nb, seed, last_frac=0.2):
    """Realised one-hot bins, a share of them in the last bin, some pairs
    empty (no contact)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, nb, (L, L))
    idx[rng.random((L, L)) < last_frac] = nb - 1
    oh = np.eye(nb, dtype=np.float32)[idx]
    oh[rng.random((L, L)) < 0.1] = 0.0
    return oh


def _walk(L, seed):
    """A random CA walk with N, C and CB at random bond-length offsets: no
    angle sits on a bin edge, so the one-hot bins compare exactly (the
    constant offsets of test_dynamics_driver.py put every omega at 0, an
    edge, where XLA's and PyTorch's last bit decide the bin)."""
    rng = np.random.default_rng(seed)

    def unit(n):
        v = rng.normal(size=(n, 3))
        return v / np.linalg.norm(v, axis=-1, keepdims=True)
    ca = np.cumsum(3.8 * unit(L), axis=0)
    return tuple((ca + r * unit(L)).astype(np.float32) if r else
                 ca.astype(np.float32) for r in (1.46, 0.0, 1.52, 1.53))


def test_dampen_flag_table_matches_jax():
    assert tdampen.DAMPEN_FLAGS.keys() == jdampen.DAMPEN_FLAGS.keys()
    for k, p in tdampen.DAMPEN_FLAGS.items():
        assert tuple(p) == tuple(jdampen.DAMPEN_FLAGS[k])
    assert tuple(tdampen.DampenParams()) == tuple(jdampen.DampenParams())


@pytest.mark.parametrize("nb", [37, 25, 13])
def test_gaussian_smooth_matches_jax(nb):
    x = _peaked(6, nb, seed=nb)
    port = tdampen.gaussian_smooth_bins(torch.from_numpy(x)).numpy()
    ref = np.asarray(jdampen.gaussian_smooth_bins(jnp.asarray(x)))
    assert np.abs(port - ref).max() <= SMOOTH_TOL


@pytest.mark.parametrize("flag", sorted(jdampen.DAMPEN_FLAGS))
def test_dampen_distribution_matches_jax(flag):
    jp, tp = jdampen.DAMPEN_FLAGS[flag], tdampen.DAMPEN_FLAGS[flag]
    pred, fact = _peaked(10, 37, seed=3), _onehot(10, 37, seed=4)
    args_t = (torch.from_numpy(pred), torch.from_numpy(fact))
    args_j = (jnp.asarray(pred), jnp.asarray(fact))
    # the tmp channel (no renormalisation): the same bins decayed, exactly
    port = tdampen.dampen_distribution(*args_t, tp, norm=False).numpy()
    ref = np.asarray(jdampen.dampen_distribution(*args_j, jp, norm=False))
    assert np.array_equal(port, ref)
    assert (port != pred).any()
    # renormalised and smoothed: within SMOOTH_TOL, untouched pairs exact
    port = tdampen.dampen_distribution(*args_t, tp).numpy()
    ref = np.asarray(jdampen.dampen_distribution(*args_j, jp))
    assert np.abs(port - ref).max() <= SMOOTH_TOL
    keep = pred.max(-1) >= tp.P
    assert np.array_equal(port[keep], pred[keep])


def test_last_bin_never_decays():
    """argmax in the last bin: the reference's empty slice (utils.py:392),
    no decay, but the pair is still renormalised and smoothed."""
    L, nb = 8, 25
    pred = _peaked(L, nb, seed=5)
    fact = np.zeros((L, L, nb), np.float32)
    fact[..., -1] = 1.0
    pred[..., -1] = np.maximum(pred[..., -1], 0.1)
    pred = pred / pred.sum(-1, keepdims=True)
    tmp = tdampen.dampen_distribution(torch.from_numpy(pred),
                                      torch.from_numpy(fact),
                                      norm=False).numpy()
    assert np.array_equal(tmp, pred)
    port = tdampen.dampen_distribution(torch.from_numpy(pred),
                                       torch.from_numpy(fact)).numpy()
    ref = np.asarray(jdampen.dampen_distribution(jnp.asarray(pred),
                                                 jnp.asarray(fact)))
    assert np.abs(port - ref).max() <= SMOOTH_TOL
    masked = pred.max(-1) < 0.5
    assert masked.any() and not np.array_equal(port[masked], pred[masked])


def test_measure_decoy_matches_jax():
    n, ca, c, cb = _walk(20, seed=1)
    port = tloop.measure_decoy(*(torch.from_numpy(a) for a in (n, ca, c,
                                                                 cb)))
    ref = jloop.measure_decoy(*(jnp.asarray(a) for a in (n, ca, c, cb)))
    for k, nb in BINS.items():
        p = port[k].numpy()
        assert p.shape == (20, 20, nb)
        assert np.array_equal(p, np.asarray(ref[k]))      # exact one-hot
        assert set(np.unique(p.sum(-1))) <= {0.0, 1.0}


def test_measure_decoy_batches_over_lanes():
    walks = [_walk(12, seed=s) for s in (2, 3)]
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*walks)]
    batch = tloop.measure_decoy(*stacked)
    for b, w in enumerate(walks):
        one = tloop.measure_decoy(*(torch.from_numpy(a) for a in w))
        for k in BINS:
            assert torch.equal(batch[k][b], one[k])


@pytest.mark.parametrize("angle", [True, False])
def test_dampen_step_matches_jax(angle):
    L = 10
    npz = {k: _peaked(L, nb, seed=nb) for k, nb in BINS.items()}
    fact = {k: _onehot(L, nb, seed=nb + 1) for k, nb in BINS.items()}
    port = tloop.dampen_step(tloop.histograms_from_npz(npz),
                             {k: torch.from_numpy(v)
                              for k, v in fact.items()}, angle=angle)
    ref = jloop.dampen_step(jloop.histograms_from_npz(npz),
                            {k: jnp.asarray(v) for k, v in fact.items()},
                            angle=angle)
    for f in jloop.GeomHistograms._fields:
        p, r = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        if f == "tmp" or (f != "dist" and not angle):
            assert np.array_equal(p, r), f
        else:
            assert np.abs(p - r).max() <= SMOOTH_TOL, f


def test_histograms_npz_roundtrip():
    npz = _rand_npz(6)
    h = tloop.histograms_from_npz(npz)
    out = tloop.histograms_to_npz(h)
    assert set(out) == {"dist", "omega", "theta", "phi", "tmp"}
    assert np.array_equal(out["dist"], npz["dist"])
    assert np.array_equal(out["tmp"], npz["dist"])        # tmp defaults
    again = tloop.histograms_from_npz({**npz, "tmp": 2 * npz["dist"]})
    assert np.array_equal(again.tmp.numpy(), 2 * npz["dist"])


def test_reliability_and_convergence_match_jax():
    rng = np.random.default_rng(6)
    t = rng.uniform(-2 * np.pi, 2 * np.pi, (4, 3, 11)).astype(np.float32)
    port = tloop.reliability_score(torch.from_numpy(t)).numpy()
    ref = np.stack([np.asarray(jloop.reliability_score(jnp.asarray(x)))
                    for x in t])
    assert np.array_equal(port, ref)
    ones = np.zeros((3, 10), np.float32)
    ones[0] = np.deg2rad(-60.0)
    assert float(tloop.reliability_score(torch.from_numpy(ones))) == 1.0
    h1 = tloop.histograms_from_npz(_rand_npz(5, key=3))
    h2 = h1._replace(tmp=h1.tmp + 0.25)
    assert abs(tloop.convergence_delta(h1, h2) - 0.25) < 1e-6


def test_chain_update_batch_matches_jax():
    """Measure and dampen every lane at once; lanes that do not advance
    keep their histograms; per-lane max |delta tmp|."""
    L, C = 10, 3
    hists = [_rand_npz(L, key=10 + c) for c in range(C)]
    walks = [_walk(L, seed=20 + c) for c in range(C)]
    atoms = [np.stack(a) for a in zip(*walks)]
    advance = np.array([True, False, True])
    port, d_port = tdriver._chain_update_batch(
        tdriver._stack_hists([tloop.histograms_from_npz(h) for h in hists]),
        *(torch.from_numpy(a) for a in atoms), torch.from_numpy(advance),
        1.0, True)
    ref, d_ref = jdriver._chain_update_batch(
        jdriver._stack_hists([jloop.histograms_from_npz(h) for h in hists]),
        *(jnp.asarray(a) for a in atoms), jnp.asarray(advance), 1.0, True)
    assert np.array_equal(d_port.numpy(), np.asarray(d_ref))
    for f in jloop.GeomHistograms._fields:
        p, r = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert np.abs(p - r).max() <= SMOOTH_TOL, f
        assert np.array_equal(p[1], hists[1][f if f != "tmp" else "dist"])
