"""The port's TM-score engine and native binding against the JAX package,
on the CPU.

Chains are seeded random walks (tests/test_tmscore.py:_random_chain), made
with numpy and given to both packages. Generic chains have distinct
singular values, where both packages' SVDs agree. Kabsch rotations and
translations agree within 1e-5, TM, RMSD and GDT within 1e-5, index maps
exactly, the native bindings within 1e-12 (one source, two builds). The
device engine and the native engine differ in when a seed's search stops
(the native engine stops once the selection fixes or fewer than 4
residues pass, the device engine runs every round): the device TM is
not below the native one (chip_smoke.py allows 1e-3 on the card, where
float32 left one pair of 1225 2.2e-5 lower), and they agree within 1e-3
where TM >= 0.5.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from trx2dy import native as jnative
from trx2dy.analysis import tmscore as jtm
from trx2dy_torch import native as tnative
from trx2dy_torch.analysis import tmscore as ttm

TOL = 1e-5
NATIVE_TM_TOL = 1e-3


def _random_chain(L, key=0):
    rng = np.random.default_rng(key)
    steps = rng.normal(size=(L, 3)).astype(np.float32)
    steps = 3.8 * steps / np.linalg.norm(steps, axis=-1, keepdims=True)
    return np.cumsum(steps, axis=0)


def _rotate(x, key=1):
    rng = np.random.default_rng(key)
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return (x @ Q.T.astype(np.float32) + np.float32([5.0, -3.0, 8.0]))


def _partial(L, key):
    """tests/test_tmscore.py:62-70: the first half matches exactly, the
    second is scrambled."""
    P = _random_chain(L, key)
    Q = P.copy()
    Q[L // 2:] += np.random.default_rng(key + 1).normal(
        scale=15.0, size=(L - L // 2, 3)).astype(np.float32)
    return Q, P


def test_kabsch_matches_jax():
    P = _random_chain(30)
    Q = _rotate(P, key=3) + np.random.default_rng(4).normal(
        scale=0.5, size=P.shape).astype(np.float32)
    w = np.random.default_rng(5).random(30).astype(np.float32)
    for weights in (None, w):
        R, t = ttm.kabsch(torch.from_numpy(P), torch.from_numpy(Q),
                          None if weights is None
                          else torch.from_numpy(weights))
        Rj, tj = jtm.kabsch(jnp.asarray(P), jnp.asarray(Q),
                            None if weights is None else jnp.asarray(weights))
        assert np.abs(R.numpy() - np.asarray(Rj)).max() < TOL
        assert np.abs(t.numpy() - np.asarray(tj)).max() < TOL
        np.testing.assert_allclose(R.numpy() @ R.numpy().T, np.eye(3),
                                   atol=1e-5)
        assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-5
    rmsd = float(ttm.kabsch_rmsd(torch.from_numpy(P), torch.from_numpy(Q)))
    assert abs(rmsd - float(jtm.kabsch_rmsd(jnp.asarray(P),
                                            jnp.asarray(Q)))) < TOL
    exact = ttm.kabsch_rmsd(torch.from_numpy(P), torch.from_numpy(_rotate(P)))
    assert float(exact) < 1e-4


def test_tm_d0_matches_jax():
    for L in (4, 10, 15, 16, 33, 90, 150, 400):
        assert ttm.tm_d0(L) == jtm.tm_d0(L)


@pytest.mark.parametrize("L", [20, 33])
def test_tm_score_pair_matches_jax(L):
    """The partial-match case, normalised by L and by a longer l_norm (a
    prediction longer than the aligned residues)."""
    Q, P = _partial(L, key=L)
    for l_norm in (None, L + 7):
        port = ttm.tm_score_pair(Q, P, l_norm=l_norm, device="cpu")
        ref = jtm.tm_score_pair(jnp.asarray(Q), jnp.asarray(P),
                                l_norm=l_norm)
        for a, b in zip(port, ref):
            assert abs(float(a) - float(b)) < TOL, (l_norm, port, ref)
    assert float(port.tm) < float(ttm.tm_score_pair(Q, P,
                                                    device="cpu").tm)
    one = ttm.tm_score_pair(_rotate(P), P, device="cpu")
    assert float(one.tm) > 0.999 and float(one.rmsd) < 1e-3


def test_tm_score_batch_matches_jax():
    """Three predictions against one native, and per-pair natives."""
    L = 20
    native = _random_chain(L, key=7)
    preds = np.stack([_partial(L, key=k)[0] for k in (20, 21, 22)])
    port = ttm.tm_score_batch(preds, native, device="cpu")
    ref = jtm.tm_score_batch(jnp.asarray(preds), jnp.asarray(native))
    for a, b in zip(port, ref):
        assert a.shape == (3,)
        assert np.abs(a.numpy() - np.asarray(b)).max() < TOL
    pairs = ttm.tm_score_batch(torch.from_numpy(preds),
                               np.broadcast_to(native, preds.shape),
                               device="cpu")
    for a, b in zip(pairs, port):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["resseq", "anchored", "needleman_wunsch"])
def test_alignments_match_jax(case):
    a = "ARNDCQEGHILKMFPSTWYV"
    if case == "resseq":
        res_a = [str(i) for i in range(1, 21)]
        res_b = [str(i) for i in (3, 4, 5, 5, 7, 30)] + ["8A", "9"]
        for fn in (ttm.align_by_resseq, jtm.align_by_resseq):
            assert fn(res_a, res_b)[0].dtype == np.int64
        got = [ttm.align_common(a, a[:8], res_a, res_b)]
        ref = [jtm.align_common(a, a[:8], res_a, res_b)]
    elif case == "anchored":
        got = [ttm.align_common(a, b) for b in (a, a[4:15], "X" + a + "Y")]
        ref = [jtm.align_common(a, b) for b in (a, a[4:15], "X" + a + "Y")]
    else:
        b = "ARNDQEGWHILKMFSTWYVV"
        got = [ttm.nw_align(a, b), ttm.align_common(a, b),
               ttm.align_common(a, b[:12], [str(i) for i in range(20)],
                                [str(i) for i in range(12)], align=True)]
        ref = [jtm.nw_align(a, b), jtm.align_common(a, b),
               jtm.align_common(a, b[:12], [str(i) for i in range(20)],
                                [str(i) for i in range(12)], align=True)]
    for (g_a, g_b), (r_a, r_b) in zip(got, ref):
        np.testing.assert_array_equal(g_a, r_a)
        np.testing.assert_array_equal(g_b, r_b)


def test_native_binding_matches_jax(tmp_path):
    """The port's own build of native/src against the JAX package's
    library: TM-score, RMSD, the all-vs-all matrices and the a3m parse."""
    assert tnative.available()
    assert tnative.library_path().parent.name == "native"
    assert tnative.library_path().parent.parent.name == "build"
    coords = np.stack([_partial(24, key=k)[0] for k in range(4)])
    got = tnative.tmscore(coords[0], coords[1])
    ref = jnative.tmscore(coords[0], coords[1])
    assert np.abs(np.subtract(got, ref)).max() < 1e-12
    for g, r in zip(tnative.tmscore_matrix(coords),
                    jnative.tmscore_matrix(coords)):
        assert np.abs(g - r).max() < 1e-12
    assert tnative.tmscore(coords[0, :3], coords[1, :3]) is None   # L < 4
    a3m = tmp_path / "t.a3m"
    a3m.write_text(">q\nARND-C\n>s1\nAaRNDCC\n>s2\nAR\n>s3\nA-NDxC\n")
    np.testing.assert_array_equal(tnative.parse_a3m(str(a3m)),
                                  jnative.parse_a3m(str(a3m)))


def test_native_build_failure_returns_none(monkeypatch):
    """Where the library cannot be built every call returns None, and the
    callers take their PyTorch path (JAX's contract)."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_tried", False)
    monkeypatch.setattr(tnative, "CXX", "no-such-compiler-trx2dy")
    assert not tnative.available()
    x = _random_chain(8)
    assert tnative.tmscore(x, x) is None
    assert tnative.tmscore_matrix(x[None]) is None


def test_device_engine_agrees_with_native_engine():
    """Noisy copies of one chain, TM 0.06 to 0.97: every round the native
    engine runs, the device engine runs too (it goes on to the wider
    cutoff where the native engine stops), so its TM is never lower;
    where TM >= 0.5 the two agree within NATIVE_TM_TOL. RMSD (Kabsch over
    every residue) within 1e-4."""
    L = 60
    native = _random_chain(L, key=30)
    rng = np.random.default_rng(1)
    preds = np.stack([_rotate(native, key=k) + rng.normal(
        scale=s, size=native.shape).astype(np.float32)
        for k, s in enumerate((0.3, 1.0, 1.5, 2.0, 3.0, 4.0, 8.0))])
    port = ttm.tm_score_batch(preds, native, device="cpu")
    ref = np.array([tnative.tmscore(p, native) for p in preds])
    tm = port.tm.numpy()
    assert tm.min() < 0.2 and tm.max() > 0.9
    assert (tm >= ref[:, 0] - TOL).all(), (tm, ref[:, 0])
    high = ref[:, 0] >= 0.5
    assert high.sum() >= 3
    assert np.abs(tm - ref[:, 0])[high].max() < NATIVE_TM_TOL
    assert np.abs(port.rmsd.numpy() - ref[:, 1]).max() < 1e-4
