"""The port's L-BFGS, folding protocol, PDB I/O and fold CLI against the
JAX package, on the CPU.

Start torsions and histograms are made with numpy from seeds and handed to
both packages. L-BFGS steps are compared elementwise; whole folds
distributionally (trajectories of two frameworks diverge), by their final
energies.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from trx2dy.io import pdbio as jpdbio
from trx2dy.physics import compact as jcompact
from trx2dy.physics import energy as jenergy
from trx2dy.physics import folder as jfolder
from trx2dy.physics import minimize as jmin
from trx2dy.physics import restraints as jrst
from trx2dy_torch.cli import fold as tcli
from trx2dy_torch.io import pdbio as tpdbio
from trx2dy_torch.physics import compact as tcompact
from trx2dy_torch.physics import energy as tenergy
from trx2dy_torch.physics import folder as tfolder
from trx2dy_torch.physics import minimize as tmin
from trx2dy_torch.physics import restraints as trst

torch.set_num_threads(2)

SEQ16 = "ARNDCQEGHILKMFPS"


def _rand_npz(L, key=0):
    """tests/test_physics.py:_rand_npz."""
    rng = np.random.default_rng(key)

    def soft(shape):
        x = rng.random(shape).astype(np.float32)
        return x / x.sum(-1, keepdims=True)
    return {"dist": soft((L, L, 37)), "omega": soft((L, L, 25)),
            "theta": soft((L, L, 25)), "phi": soft((L, L, 13))}


def _x0(B, L, seed):
    """(B, 3, L) basin-sampled start torsions, omega = pi (numpy)."""
    rng = np.random.default_rng(seed)
    basin = rng.choice(6, size=(B, L), p=jfolder._BASIN_P)
    return np.stack([jfolder._BASIN_PHI[basin], jfolder._BASIN_PSI[basin],
                     np.full((B, L), np.pi)], axis=1).astype(np.float32)


# ------------------------------------------------------------------ L-BFGS

def test_two_loop_matches_jax():
    rng = np.random.default_rng(0)
    M, B, D = 10, 3, 12
    g = rng.standard_normal((B, D)).astype(np.float32)
    s = rng.standard_normal((M, B, D)).astype(np.float32)
    y = (s + 0.3 * rng.standard_normal((M, B, D))).astype(np.float32)
    rho = (1.0 / np.sum(s * y, -1)).astype(np.float32)
    valid = rng.random((M, B)) < 0.7
    valid[:, 2] = False                       # a lane with no history
    args = (g, s, y, rho, valid)
    port = tmin._two_loop(*(torch.from_numpy(a) for a in args)).numpy()
    ref = np.asarray(jmin._two_loop(*(jnp.asarray(a) for a in args)))
    assert np.abs(port - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())
    assert np.array_equal(port[2], -g[2])      # no history: steepest descent


def _rosen_t(x):
    return torch.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
                     + (1.0 - x[:, :-1]) ** 2, dim=-1)


def _rosen_j(x):
    return jnp.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2
                   + (1.0 - x[:, :-1]) ** 2, axis=-1)


def test_lbfgs_run_matches_jax_rosenbrock():
    x0 = np.random.default_rng(1).uniform(-1.5, 1.5, (3, 6)).astype(
        np.float32)
    for nm in (0, 4):                         # monotone, nonmonotone ring
        st = tmin.lbfgs_run(_rosen_t, tmin.lbfgs_init(
            _rosen_t, torch.from_numpy(x0), nonmonotone=nm), max_iter=8)
        ref = jmin.lbfgs_run(_rosen_j, jmin.lbfgs_init(
            _rosen_j, jnp.asarray(x0), nonmonotone=nm), max_iter=8)
        assert st.k == int(ref.k) == 8
        for a, b in ((st.x, ref.x), (st.f, ref.f), (st.g, ref.g)):
            b = np.asarray(b)
            assert np.abs(a.numpy() - b).max() <= 1e-4 * max(
                1.0, np.abs(b).max())
        assert np.array_equal(st.smalls.numpy(), np.asarray(ref.smalls))
    # lbfgs_minimize: init + run to convergence, frozen lanes untouched
    freeze = np.array([False, True, False])
    res = tmin.lbfgs_minimize(_rosen_t, torch.from_numpy(x0), max_iter=300,
                              freeze=torch.from_numpy(freeze))
    ref = jmin.lbfgs_minimize(_rosen_j, jnp.asarray(x0), max_iter=300,
                              freeze=jnp.asarray(freeze))
    assert res.converged.tolist() == np.asarray(ref.converged).tolist()
    assert torch.equal(res.x[1], torch.from_numpy(x0[1]))
    assert np.abs(res.f.numpy() - np.asarray(ref.f)).max() < 1e-3


def test_lbfgs_run_matches_jax_fold_energy():
    L = 12
    npz = _rand_npz(L, key=4)
    seq = SEQ16[:L]
    prst = trst.compile_restraints(npz)
    jr = jrst.compile_restraints(npz)
    cr_t = tcompact.compact_to(tcompact.compact_restraints(
        prst, trst.restraint_masks(prst, seq, 1, L)), L, "cpu")
    cr_j = jax.tree.map(jnp.asarray, jcompact.compact_restraints(
        jr, jrst.restraint_masks(jr, seq, 1, L)))
    w = tenergy.weights_to_vec(tenergy.SCOREFXN_CENT)
    x0 = _x0(2, L, seed=5).reshape(2, -1)

    def fun_t(x):
        return tenergy.batched_energy_weighted_compact(x, cr_t,
                                                       torch.from_numpy(w))

    def fun_j(x):
        return jenergy.batched_energy_weighted_compact(x, cr_j,
                                                       jnp.asarray(w))

    # two iterations: the two frameworks' float32 gradients differ by
    # ~7e-5 relative at the start, and that compounds step by step
    st = tmin.lbfgs_run(fun_t, tmin.lbfgs_init(fun_t, torch.from_numpy(x0)),
                        max_iter=2)
    ref = jax.jit(lambda x: jmin.lbfgs_run(
        fun_j, jmin.lbfgs_init(fun_j, x), max_iter=2))(jnp.asarray(x0))
    assert st.k == int(ref.k) == 2
    assert np.abs(st.f.numpy() - np.asarray(ref.f)).max() <= \
        1e-4 * np.abs(np.asarray(ref.f)).max()
    assert np.abs(st.x.numpy() - np.asarray(ref.x)).max() <= 1e-4 * max(
        1.0, np.abs(np.asarray(ref.x)).max())


def test_lbfgs_bookkeeping_failed_line_search():
    """Every value-only trial is non-finite: two failures in a row end the
    lane; a caller-frozen lane never moves."""
    x0 = torch.tensor([[0.5, -1.0], [2.0, 1.0]])

    def fun(x):
        # finite where the gradient is taken, inf in every line-search trial
        e = torch.sum(x * x, -1)
        return e if torch.is_grad_enabled() else e + float("inf")

    tmin.STATS.reset()
    st = tmin.lbfgs_run(fun, tmin.lbfgs_init(
        fun, x0, freeze=torch.tensor([False, True])), max_iter=10)
    assert st.k == 2
    assert st.done.tolist() == [True, True]
    assert st.fails.tolist() == [2, 0]
    assert st.smalls.tolist() == [0, 0]
    assert torch.equal(st.x, x0)
    assert not st.valid.any()
    # init + 2 x (25 trials + 1 gradient); syncs: 2 x (loop + 25 trials)
    # + the final loop check
    assert (tmin.STATS.evals, tmin.STATS.syncs) == (53, 53)


def test_lbfgs_bookkeeping_converges_on_flat_energy():
    """A flat energy accepts every step with no change: three small steps
    in a row end the lane."""
    def fun(x):
        return 0.0 * x.sum(-1) + 1.0

    tmin.STATS.reset()
    st = tmin.lbfgs_run(fun, tmin.lbfgs_init(fun, torch.ones(3, 4)),
                        max_iter=10)
    assert st.k == 3
    assert st.done.all() and (st.smalls == 3).all() and (st.fails == 0).all()
    assert (tmin.STATS.evals, tmin.STATS.syncs) == (7, 10)
    gathered = tmin.state_gather(st, [2, 0])
    assert gathered.x.shape == (2, 4) and gathered.s_hist.shape[1] == 2


# ---------------------------------------------------------------- protocol

def test_random_torsions_basin_frequencies():
    B, L = 400, 50
    t = tfolder.random_torsions(torch.Generator().manual_seed(0), L, B)
    assert t.shape == (B, 3, L)
    assert bool((t[:, 2] == np.float32(np.pi)).all())
    phi = t[:, 0].numpy().ravel()
    basin = np.abs(phi[:, None] - jfolder._BASIN_PHI[None, :]).argmin(1)
    assert np.allclose(t[:, 1].numpy().ravel(),
                       jfolder._BASIN_PSI[basin], atol=1e-6)
    obs = np.bincount(basin, minlength=6)
    exp = B * L * jfolder._BASIN_P
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    assert chi2 < 20.52          # chi-square, 5 degrees of freedom, p=0.001


def test_stage_masks_match_jax():
    npz = _rand_npz(30, key=6)
    seq = "A" * 30
    prst, jr = trst.compile_restraints(npz), jrst.compile_restraints(npz)
    idr = np.arange(30) < 10
    for mode in (0, 1, 2, 3):
        port = tfolder._stage_masks_centroid(prst, seq, mode, 0.05, idr=idr)
        ref = jfolder._stage_masks_centroid(jr, seq, mode, 0.05, idr=idr)
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            for u, v in zip(a, b):
                assert np.array_equal(u, np.asarray(v))


def test_fold_matches_jax_distributionally():
    """JAX's and the port's fold_ensemble from the same start torsions, at
    L=16, 4 decoys, mode 2, no relax, max_iter=20 (every stage of the
    protocol runs; 20 iterations keep the CPU time down): every final
    energy is below its start, and the medians agree within 10 % of
    |median| (the trajectories of the two frameworks diverge, so decoys
    do not pair)."""
    L, B, ITERS = 16, 4, 20
    npz = _rand_npz(L, key=5)
    x0 = _x0(B, L, seed=7)
    ref = jfolder.fold_ensemble(npz, SEQ16, jax.random.PRNGKey(0),
                                n_decoys=B, max_iter=ITERS, fastrelax=False,
                                x0=jnp.asarray(x0))
    log = []
    tmin.STATS.reset()
    port = tfolder.fold_ensemble(npz, SEQ16, None, n_decoys=B,
                                 max_iter=ITERS, fastrelax=False, x0=x0,
                                 device="cpu", stage_log=log)
    e_ref = np.asarray(ref.energy)
    e = port.energy.numpy()
    prst = trst.compile_restraints(npz)
    cr = tcompact.compact_to(tcompact.compact_restraints(
        prst, trst.restraint_masks(prst, SEQ16, 1, L)), L, "cpu")
    with torch.no_grad():
        start = tenergy.batched_energy_weighted_compact(
            torch.from_numpy(x0.reshape(B, -1)), cr,
            torch.from_numpy(tenergy.weights_to_vec(tenergy.SCOREFXN_CENT)))
    assert np.isfinite(e).all() and (e < start.numpy()).all()
    assert (e_ref < start.numpy()).all()
    assert abs(np.median(e) - np.median(e_ref)) <= 0.1 * abs(np.median(e_ref))
    assert port.torsions.shape == (B, 3, L)
    ca = port.atoms["CA"].numpy()
    d = np.linalg.norm(np.diff(ca, axis=1), axis=-1)
    assert (d < 4.2).all() and (d > 2.7).all()   # chain connectivity
    labels = [lab for lab, _, _ in log]
    assert labels.count("cent") == 3 and labels.count("cart") == 1
    assert all(0 < it <= ITERS for lab, it, _ in log if lab != "clash0")
    assert tmin.STATS.evals > 0 and tmin.STATS.syncs > 0


def test_fold_refusals_and_padding(tmp_path):
    npz = _rand_npz(10, key=8)
    seq = SEQ16[:10]
    known = {"dist": np.full((1, 10, 10), 8.0, np.float32)}
    for kwargs, err in (({"staged_execution": False}, NotImplementedError),
                        ({"rst_mode": "af2"}, ValueError),   # --orient
                        ({"rst_mode": "gpcr"}, ValueError),  # no known_npz
                        ({"rst_mode": "xyz"}, ValueError),
                        ({"rst_mode": "gpcr", "known_npz": known,
                          "pad_to": 12}, ValueError)):
        args = {"fastrelax": False, "device": "cpu", **kwargs}
        with pytest.raises(err):
            tfolder.fold_ensemble(npz, seq, None, **args)
    with pytest.raises(ValueError, match="does not match"):
        tfolder.fold_ensemble(npz, seq + "A", None, fastrelax=False,
                              device="cpu")
    res = tfolder.fold_ensemble(npz, seq, torch.Generator().manual_seed(1),
                                n_decoys=2, max_iter=10, fastrelax=False,
                                pad_to=12, oversample=0.5, device="cpu")
    assert res.torsions.shape == (2, 3, 10)
    assert res.atoms["CA"].shape == (2, 10, 3)
    assert np.isfinite(res.energy.numpy()).all()
    assert np.all(np.diff(res.energy.numpy()) >= 0)   # lowest energies kept


# ------------------------------------------------------------- PDB and CLI

def test_pdb_writer_matches_jax_and_reads_back(tmp_path):
    rng = np.random.default_rng(9)
    seq = "AGCW"
    coords = {a: rng.uniform(-50, 50, (4, 3)) for a in tpdbio.BACKBONE_ATOMS}
    coords["O"][2] = np.nan
    tpdbio.write_pdb_backbone(str(tmp_path / "p.pdb"), seq, coords)
    jpdbio.write_pdb_backbone(str(tmp_path / "j.pdb"), seq, coords)
    assert (tmp_path / "p.pdb").read_text() == (tmp_path / "j.pdb").read_text()
    got, gseq = tpdbio.read_pdb_backbone(str(tmp_path / "j.pdb"))
    want, wseq = jpdbio.read_pdb_backbone(str(tmp_path / "j.pdb"))
    assert gseq == wseq == seq
    for a in tpdbio.BACKBONE_ATOMS:
        assert np.array_equal(got[a], want[a], equal_nan=True)


def test_cli_writes_decoys_that_read_back(tmp_path, capsys):
    L = 10
    np.savez(tmp_path / "t.npz", **_rand_npz(L, key=10))
    (tmp_path / "t.fasta").write_text(">t\n" + SEQ16[:L] + "\n")
    base = ["-NPZ", str(tmp_path / "t.npz"), "-FASTA",
            str(tmp_path / "t.fasta"), "-OUT", str(tmp_path / "d.pdb")]
    with pytest.raises(ValueError, match="requires known_npz"):
        tcli.main(base + ["-r", "gpcr", "--device", "cpu"])
    paths, res = tcli.main(base + ["--n_decoys", "2", "--no-fastrelax",
                                   "-n", "10", "--seed", "3", "--device",
                                   "cpu"])
    assert np.isfinite(res.energy.numpy()).all()
    assert paths == [str(tmp_path / "d_0.pdb"), str(tmp_path / "d_1.pdb")]
    assert "[trx2dy] wrote 2 decoys" in capsys.readouterr().out
    for p in paths:
        coords, seq = tpdbio.read_pdb_backbone(p)
        assert seq == SEQ16[:L]
        assert coords["CA"].shape == (L, 3)
        assert np.isfinite(coords["CA"]).all()
