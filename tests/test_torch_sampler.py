"""The port's Dynamics sampler on the CPU: fold_chains_pool against the JAX
package at protocol level, and the driver's file contracts
(trx2dy_torch/dynamics/driver.py, cli/run_inference.py) mirroring
tests/test_dynamics_driver.py's cases on the port alone.

Folds run at L <= 20 with max_iter <= 8 and without relax, except one
fold_chains_pool case with the relax schedules cut to 2 iterations per
stage and one clash round (module constants, as tests/test_torch_relax.py
cuts them). The fold_chains_pool tests run the minimisation; the driver
tests hold files, names, traces and routing, so they fold with no L-BFGS
iteration (max_iter 0; clash rounds, relax and refinement schedules and
sidechain packing cut to 0 iterations: each stage is one evaluation),
which keeps a CPU energy evaluation's ~10-20 ms from multiplying into
minutes.
"""
import functools
import json
import os
import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from trx2dy.physics import folder as jfolder
from trx2dy_torch.cli import run_inference as tcli
from trx2dy_torch.dynamics import driver as tdriver
from trx2dy_torch.dynamics.driver import (
    DynamicsConfig, flatten_directory, generate_ensemble, rename_to_conf,
    run_single,
)
from trx2dy_torch.ops import spline_energy as tops
from trx2dy_torch.physics import cartmin as tcartmin
from trx2dy_torch.physics import folder as tfolder
from trx2dy_torch.physics.minimize import STATS

torch.set_num_threads(2)

SEQ14 = "ARNDCQEGHILKMF"
SEQ16 = "ARNDCQEGHILKMFPS"


def _rand_npz(L, key=0):
    """tests/test_dynamics_driver.py:_rand_npz."""
    rng = np.random.default_rng(key)

    def soft(shape):
        x = rng.random(shape).astype(np.float32)
        return x / x.sum(-1, keepdims=True)
    return {"dist": soft((L, L, 37)), "omega": soft((L, L, 25)),
            "theta": soft((L, L, 25)), "phi": soft((L, L, 13))}


def _tpool(npzs):
    return {k: torch.from_numpy(np.stack([n[k] for n in npzs]))
            for k in ("dist", "omega", "theta", "phi")}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture
def no_minimisation(monkeypatch):
    """Folds without L-BFGS iterations: with cfg max_iter 0 every stage of
    the protocol, relax and the cartesian stages included, is its one
    initial evaluation, and packing keeps the staggered start."""
    monkeypatch.setattr(tfolder, "CLASH_ROUNDS", 0)
    for name in ("RELAX_SCHEDULE_R1", "RELAX_SCHEDULE_R2",
                 "CART_SCHEDULE_R1"):
        monkeypatch.setattr(tfolder, name, tuple(
            (fa, cst, 0) for fa, cst, _ in getattr(tfolder, name)))
    monkeypatch.setattr(tfolder, "CART_REFINE_ITERS", 0)
    monkeypatch.setattr(tcartmin, "IDEALIZE_ITERS", 0)
    for name in ("pack_ensemble", "pack_and_write"):
        monkeypatch.setattr(tdriver, name, functools.partial(
            getattr(tdriver, name), max_iter=0))


def _x0(B, L, seed):
    """(B, 3, L) basin-sampled start torsions, omega = pi (numpy)."""
    rng = np.random.default_rng(seed)
    basin = rng.choice(6, size=(B, L), p=jfolder._BASIN_P)
    return np.stack([jfolder._BASIN_PHI[basin], jfolder._BASIN_PSI[basin],
                     np.full((B, L), np.pi)], axis=1).astype(np.float32)


# ------------------------------------------------------- fold_chains_pool

def test_fold_chains_pool_matches_jax_distributionally():
    """tests/test_tablegen.py::TestFoldChainsPool's program shapes (L=14,
    two histogram rows, an 8-lane bucket, max_iter 8) without relax, here
    as 8 chains of one candidate, from the same start torsions in both
    packages. Trajectories of two frameworks drift apart in float32, so
    the 8 final energies are held as a distribution: median and mean within
    10 % of JAX's (the median of 8 decoys moved 3.8 % between two
    trajectories of one package, PERF.md), and the floors alike."""
    npzs = [_rand_npz(14, key=70), _rand_npz(14, key=71)]
    lanes = [0, 0, 0, 0, 1, 1, 1, 1]
    x0 = _x0(8, 14, seed=3)
    fl_t, fl_j = {}, {}
    port = tfolder.fold_chains_pool(
        _tpool(npzs), lanes, SEQ14, x0=x0, max_iter=8, fastrelax=False,
        lane_bucket=8, bucket_floors=fl_t)
    jpool = {k: jnp.stack([jnp.asarray(n[k]) for n in npzs])
             for k in ("dist", "omega", "theta", "phi")}
    ref = jfolder.fold_chains_pool(
        jpool, lanes, SEQ14, jax.random.PRNGKey(0), x0=jnp.asarray(x0),
        max_iter=8, fastrelax=False, lane_bucket=8, bucket_floors=fl_j)
    assert port.torsions.shape == (8, 3, 14)
    assert port.atoms["CA"].shape == (8, 14, 3)
    assert fl_t == fl_j
    e, r = port.energy.numpy(), np.asarray(ref.energy)
    assert np.isfinite(e).all()
    for stat in (np.median, np.mean):
        assert abs(stat(e) - stat(r)) <= 0.10 * abs(stat(r)), (e, r)


def test_fold_chains_pool_relax_candidates_and_launches(monkeypatch):
    """With relax (schedules cut to 2 iterations a stage, one clash
    round): each chain keeps
    its lowest-energy candidate; every spline-counted evaluation goes
    through the lanes entry once; the floors name every term."""
    for name in ("RELAX_SCHEDULE_R1", "RELAX_SCHEDULE_R2",
                 "CART_SCHEDULE_R1"):
        monkeypatch.setattr(tfolder, name, tuple(
            (fa, cst, 2) for fa, cst, _ in getattr(tfolder, name)))
    monkeypatch.setattr(tfolder, "CART_REFINE_ITERS", 2)
    monkeypatch.setattr(tcartmin, "IDEALIZE_ITERS", 2)
    monkeypatch.setattr(tfolder, "CLASH_ROUNDS", 1)
    seen = {}
    protocol = tfolder._protocol_staged

    def spy(*a, **k):
        seen["x"], seen["f"] = protocol(*a, **k)
        return seen["x"], seen["f"]
    monkeypatch.setattr(tfolder, "_protocol_staged", spy)
    launches = []
    lanes = tops._lanes_fwd
    monkeypatch.setattr(tops, "_lanes_fwd",
                        lambda t, q: launches.append(1) or lanes(t, q))
    floors, log = {}, []
    STATS.reset()
    fr = tfolder.fold_chains_pool(
        _tpool([_rand_npz(14, key=70), _rand_npz(14, key=71)]), [0, 1],
        SEQ14, _gen(0), max_iter=2, candidates=2, lane_bucket=8,
        bucket_floors=floors, stage_log=log)
    assert fr.torsions.shape == (2, 3, 14) and fr.atoms["CA"].shape == \
        (2, 14, 3)
    f = seen["f"].numpy()
    assert np.array_equal(fr.energy.numpy(), f[:4].reshape(2, 2).min(1))
    assert STATS.evals > 0 and len(launches) == STATS.evals
    assert set(floors["all"]) == {"dist", "omega", "theta", "phi"}
    assert {"relax1", "cart_r1", "relax2", "cart_refine"} <= \
        {lab for lab, _, _ in log}


def test_fold_chains_pool_padded_with_res_mask():
    L, Lp = 14, 16
    npz = _rand_npz(L, key=80)
    padded = {k: np.pad(v, [(0, Lp - L), (0, Lp - L), (0, 0)])
              for k, v in npz.items()}
    fr = tfolder.fold_chains_pool(
        _tpool([padded]), [0], SEQ14 + "AA", _gen(1), max_iter=4,
        fastrelax=False, res_mask=torch.arange(Lp) < L, true_len=L)
    assert fr.torsions.shape == (1, 3, L)
    assert fr.atoms["CA"].shape == (1, L, 3)
    assert np.isfinite(fr.energy.numpy()).all()


def test_fold_chains_pool_floors_pin_pair_lists(monkeypatch,
                                                no_minimisation):
    """The floors ratchet keeps one set of pair-list sizes across steps
    with other histograms (tests/test_tablegen.py's ratchet case)."""
    from trx2dy_torch.physics import tablegen
    sizes = []
    compile_ = tablegen.UnionCompiler.compile
    monkeypatch.setattr(tablegen.UnionCompiler, "compile",
                        lambda self, pool, lm, P: sizes.append(P) or
                        compile_(self, pool, lm, P))
    floors = {}
    kw = dict(max_iter=0, fastrelax=False, bucket_floors=floors,
              lane_bucket=4, candidates=2)
    tfolder.fold_chains_pool(_tpool([_rand_npz(16, key=95),
                                     _rand_npz(16, key=96)]), [0, 1], SEQ16,
                             _gen(0), **kw)
    tfolder.fold_chains_pool(_tpool([_rand_npz(16, key=97),
                                     _rand_npz(16, key=98)]), [0, 1], SEQ16,
                             _gen(1), growth_buckets=True, **kw)
    assert len(sizes) == 2 and sizes[0] == sizes[1]
    assert tuple(floors["all"].values()) == sizes[0]


# ---------------------------------------------------------------- driver

def _touch(d, names):
    for n in names:
        with open(os.path.join(d, n), "w") as f:
            f.write("x")


def test_rename_and_flatten_match_jax(tmp_path):
    """rename_to_conf and flatten_directory on identical trees in both
    packages: the same final file names."""
    from trx2dy.dynamics import driver as jdriver
    trees = {}
    for pkg, mod in (("jax", jdriver), ("port", tdriver)):
        d = tmp_path / pkg
        for sub in ("NMR", "Xray"):
            os.makedirs(d / sub)
        _touch(str(d / "NMR"), ["initial0.pdb", "initial1.pdb", "t1.pdb",
                                "t2.pdb", "t10.pdb", ".tmp_s1_1.pdb"])
        _touch(str(d / "Xray"), ["initial0.pdb", "initial1.pdb", "t3.pdb",
                                 "t4.pdb"])
        _touch(str(d), ["conf_1_9.pdb", "notes.txt"])
        mod.flatten_directory(str(d))
        flat = sorted(os.listdir(d))
        mod.rename_to_conf(str(d), num_conf1_others=3)
        trees[pkg] = (flat, sorted(os.listdir(d)))
    assert trees["port"] == trees["jax"]
    assert "initial0_1.pdb" in trees["port"][0]


def test_rename_initial_and_iterations(tmp_path):
    d = str(tmp_path)
    _touch(d, ["initial0.pdb", "initial1.pdb", "initial0_1.pdb",
               "seq1.pdb", "seq2.pdb", "seq3.pdb"])
    rename_to_conf(d, num_conf1_others=2)
    assert sorted(os.listdir(d)) == [
        "conf_1_1.pdb", "conf_1_2.pdb", "conf_1_3.pdb", "conf_1_4.pdb",
        "conf_2_1.pdb", "conf_2_2.pdb"]


def test_generate_ensemble_contract(tmp_path, no_minimisation):
    cfg = DynamicsConfig(init_num=2, Nmax=1, max_iter=0, fastrelax=False,
                         n_chains=2)
    npz_dir, pdb_dir = str(tmp_path / "tmp_npz"), str(tmp_path / "pred_pdb")
    last = generate_ensemble("t", npz_dir, pdb_dir, _rand_npz(20, key=5),
                             "ARNDCQEGHILKMFPSTWYV", cfg, _gen(0),
                             device="cpu")
    assert last >= 1
    for f in ("initial0.pdb", "initial1.pdb", "t1.pdb"):
        assert os.path.exists(os.path.join(pdb_dir, f))
    saved = dict(np.load(os.path.join(npz_dir, "t1.npz")))
    assert set(saved) == {"dist", "omega", "theta", "phi", "tmp"}
    assert saved["dist"].shape == (20, 20, 37)


def test_run_single_with_precomputed_npz(tmp_path, no_minimisation):
    fasta = tmp_path / "t.fasta"
    fasta.write_text(f">t\n{SEQ16}\n")
    (tmp_path / "npz").mkdir()
    np.savez_compressed(tmp_path / "npz" / "t_NMR.npz", **_rand_npz(16, 6))
    cfg = DynamicsConfig(init_num=2, Nmax=1, max_iter=0, fastrelax=False,
                         mult_two_models=False, n_chains=2)
    out = run_single("t", str(fasta), None, str(tmp_path / "out"), cfg,
                     npz_dir=str(tmp_path / "npz"), device="cpu")
    pdbs = sorted(os.listdir(os.path.join(out, "pred_pdb")))
    assert pdbs and all(p.startswith("conf_") for p in pdbs)
    assert not os.path.exists(os.path.join(out, "tmp_npz"))
    assert os.path.exists(os.path.join(out, "pred_npz", "t_NMR.npz"))


def test_chain_mode_produces_decoys(tmp_path, no_minimisation):
    cfg = DynamicsConfig(init_num=2, Nmax=4, max_iter=0, fastrelax=False,
                         n_chains=2)
    last = generate_ensemble("c", str(tmp_path / "npz"),
                             str(tmp_path / "pdb"), _rand_npz(18, key=9),
                             SEQ16 + "TW", cfg, _gen(0), device="cpu")
    pdbs = sorted(os.listdir(tmp_path / "pdb"))
    assert "initial0.pdb" in pdbs and "c1.pdb" in pdbs
    assert last <= cfg.Nmax
    assert os.path.exists(tmp_path / "npz" / "c1.npz")


def _two_model_dir(tmp_path, L, keys):
    fasta = tmp_path / "t.fasta"
    fasta.write_text(f">t\n{(SEQ16 * 2)[:L]}\n")
    (tmp_path / "npz").mkdir()
    for tag, key in zip(("NMR", "Xray"), keys):
        np.savez_compressed(tmp_path / "npz" / f"t_{tag}.npz",
                            **_rand_npz(L, key=key))
    return fasta


def test_two_model_combined_contract(tmp_path, no_minimisation):
    """Both models' chains in one batched fold per step, yet the file
    layout of the reference's serial NMR-then-Xray order: conf_1 = NMR
    initials and chain decoys, conf_2 = X-ray's."""
    fasta = _two_model_dir(tmp_path, 16, (31, 32))
    cfg = DynamicsConfig(init_num=2, Nmax=2, max_iter=0, fastrelax=False,
                         n_chains=2)
    out = run_single("t", str(fasta), None, str(tmp_path / "out"), cfg,
                     npz_dir=str(tmp_path / "npz"), device="cpu")
    pdbs = sorted(os.listdir(os.path.join(out, "pred_pdb")))
    assert all(p.startswith("conf_") for p in pdbs), pdbs
    assert not any(".tmp_" in p for p in pdbs)
    n_c1 = sum(p.startswith("conf_1") for p in pdbs)
    n_c2 = sum(p.startswith("conf_2") for p in pdbs)
    assert n_c1 == n_c2 == 2 + cfg.Nmax
    assert not os.path.exists(os.path.join(out, "tmp_npz"))
    with open(os.path.join(out, "traces.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    decoy_rows = [r for r in rows if r["kind"] in ("initial", "chain")]
    assert {r.get("model") for r in decoy_rows} == {"NMR", "Xray"}
    phase_rows = [r for r in rows if r["kind"] == "phase"]
    assert any("t_fold" in r for r in phase_rows)
    assert all(np.isfinite(v) for r in phase_rows
               for k, v in r.items() if k.startswith("t_"))
    assert all(r["energy_evals"] > 0 for r in phase_rows if "t_fold" in r)


def test_combined_falls_back_on_resume(tmp_path, monkeypatch,
                                      no_minimisation):
    """An in-progress tmp_npz tree takes the serial samplers, whose
    per-file resume contract is exact (run_inference.py:100-102)."""
    fasta = _two_model_dir(tmp_path, 14, (41, 42))
    tdir = tmp_path / "out" / "t" / "tmp_npz" / "NMR"
    tdir.mkdir(parents=True)
    np.savez_compressed(tdir / "t1.npz", **_rand_npz(14, key=43),
                        tmp=_rand_npz(14, key=43)["dist"])
    called = []
    multi = tdriver._generate_chains_multi
    monkeypatch.setattr(tdriver, "_generate_chains_multi",
                        lambda *a, **k: called.append(1) or multi(*a, **k))
    cfg = DynamicsConfig(init_num=1, Nmax=1, max_iter=0, fastrelax=False,
                         n_chains=1)
    run_single("t", str(fasta), None, str(tmp_path / "out"), cfg,
               npz_dir=str(tmp_path / "npz"), device="cpu")
    assert called == []
    pdbs = os.listdir(tmp_path / "out" / "t" / "pred_pdb")
    assert any(p.startswith("conf_") for p in pdbs)


def test_resume_contract(tmp_path, no_minimisation):
    """Re-running generate_ensemble continues from the saved tmp_npz files
    (run_inference.py:100-102)."""
    cfg = DynamicsConfig(init_num=2, Nmax=2, max_iter=0, fastrelax=False,
                         n_chains=2)
    npz_dir, pdb_dir = str(tmp_path / "npz"), str(tmp_path / "pdb")
    npz = _rand_npz(14, key=21)
    generate_ensemble("r", npz_dir, pdb_dir, npz, SEQ14, cfg, _gen(0),
                      device="cpu")
    before = set(os.listdir(npz_dir))
    last = generate_ensemble("r", npz_dir, pdb_dir, npz, SEQ14, cfg,
                             _gen(1), device="cpu")
    assert last >= 1
    assert before <= set(os.listdir(npz_dir))


def test_resume_routes_past_chains_path(tmp_path, monkeypatch,
                                       no_minimisation):
    npz = _rand_npz(14, key=22)
    (tmp_path / "npz").mkdir()
    np.savez_compressed(tmp_path / "npz" / "r1.npz", **npz, tmp=npz["dist"])
    called = []
    chains = tdriver._generate_ensemble_chains
    monkeypatch.setattr(tdriver, "_generate_ensemble_chains",
                        lambda *a, **k: called.append(1) or chains(*a, **k))
    cfg = DynamicsConfig(init_num=1, Nmax=1, max_iter=0, fastrelax=False,
                         n_chains=4)
    generate_ensemble("r", str(tmp_path / "npz"), str(tmp_path / "pdb"),
                      npz, SEQ14, cfg, _gen(0), device="cpu")
    assert called == []


def test_batch_mode_cli(tmp_path, no_minimisation):
    """--name_lst batch mode drives run_single per name (len_bucket 32:
    L=14 folds padded to 32)."""
    for name in ("t1", "t2"):
        (tmp_path / f"{name}.fasta").write_text(f">{name}\n{SEQ14}\n")
        (tmp_path / f"{name}.a3m").write_text(f">{name}\n{SEQ14}\n")
        np.savez_compressed(tmp_path / f"{name}_NMR.npz",
                            **_rand_npz(14, key=int(name[1])))
    (tmp_path / "names.txt").write_text("t1\nt2\n")
    tcli.main(["--name_lst", str(tmp_path / "names.txt"),
               "--fasta_dir", str(tmp_path), "--msa_dir", str(tmp_path),
               "--save_dir", str(tmp_path / "out"),
               "--npz_dir", str(tmp_path), "--init_num", "1", "--Nmax", "1",
               "--max_iter", "0", "--n_chains", "1", "--no-mult_two_models",
               "--device", "cpu"])
    for name in ("t1", "t2"):
        pdbs = os.listdir(tmp_path / "out" / name / "pred_pdb")
        assert any(p.startswith("conf_1") for p in pdbs), name


def _cli_cfg(tmp_path, argv_extra, capsys, monkeypatch):
    captured = {}

    def fake_run_single(name, fasta, msa, save_dir, cfg, **kw):
        captured["cfg"], captured["kw"] = cfg, kw
        return save_dir

    monkeypatch.setattr(tdriver, "run_single", fake_run_single)
    (tmp_path / "t.fasta").write_text(">t\nARND\n")
    tcli.main(["--fasta", str(tmp_path / "t.fasta"), "--name", "t",
               "--save_dir", str(tmp_path / "out"), "--device", "cpu"]
              + argv_extra)
    return captured["cfg"], capsys.readouterr().err, captured["kw"]


def test_explicit_candidates_disable_fill(tmp_path, capsys, monkeypatch):
    cfg, err, _ = _cli_cfg(tmp_path, ["--chain_candidates", "2"], capsys,
                           monkeypatch)
    assert cfg.chain_candidates == 2 and cfg.fill_candidates is False
    assert "energy gating" not in err


def test_candidates_one_warns(tmp_path, capsys, monkeypatch):
    cfg, err, _ = _cli_cfg(tmp_path, ["--chain_candidates", "1"], capsys,
                           monkeypatch)
    assert cfg.chain_candidates == 1 and cfg.fill_candidates is False
    assert "disables per-step energy gating" in err


def test_cli_defaults_match_jax(tmp_path, capsys, monkeypatch):
    """The default flags give the JAX CLI's DynamicsConfig, on the device
    the caller named; --aot_cache (JAX's trace cache) is not a flag."""
    from trx2dy.cli import run_inference as jcli
    cfg, _, kw = _cli_cfg(tmp_path, [], capsys, monkeypatch)
    assert cfg.fill_candidates is True
    ref = jcli.build_parser().parse_args(["--save_dir", "x"])
    port = tcli.build_parser().parse_args(["--save_dir", "x"])
    assert port.device == "cuda"
    assert set(vars(ref)) - set(vars(port)) == {"aot_cache"}
    assert {k: v for k, v in vars(port).items() if k != "device"} == \
        {k: v for k, v in vars(ref).items() if k not in ("device",
                                                         "aot_cache")}
    assert kw["device"] == torch.device("cpu")


def test_driver_emits_full_atom_pdbs(tmp_path, no_minimisation):
    """With full_atom on, decoys carry side-chain heavy atoms (the
    reference dumps full-atom poses after relax, folding.py:273)."""
    cfg = DynamicsConfig(init_num=2, Nmax=1, max_iter=0, fastrelax=False,
                         full_atom=True, n_chains=2)
    pdb_dir = str(tmp_path / "pred_pdb")
    generate_ensemble("t", str(tmp_path / "tmp_npz"), pdb_dir,
                      _rand_npz(16, key=12), SEQ16, cfg, _gen(0),
                      device="cpu")
    with open(os.path.join(pdb_dir, "initial0.pdb")) as f:
        names = {ln[12:16].strip() for ln in f if ln.startswith("ATOM")}
    assert {"N", "CA", "C", "O", "CB"} <= names
    assert {"CG", "CD", "NE", "CZ"} <= names          # arginine


def test_full_atom_defaults_follow_fastrelax():
    assert DynamicsConfig(fastrelax=False).emit_full_atom is False
    assert DynamicsConfig(fastrelax=True).emit_full_atom is True
    assert DynamicsConfig(fastrelax=True,
                          full_atom=False).emit_full_atom is False
    from trx2dy.dynamics.driver import DynamicsConfig as JConfig
    ref, port = JConfig(), DynamicsConfig()
    assert {f: getattr(port, f) for f in vars(ref)} == vars(ref)


def test_run_single_writes_traces(tmp_path, no_minimisation):
    fasta = tmp_path / "t.fasta"
    fasta.write_text(f">t\n{SEQ16}\n")
    (tmp_path / "npz").mkdir()
    np.savez_compressed(tmp_path / "npz" / "t_NMR.npz", **_rand_npz(16, 61))
    # n_chains=1: the sequential sampler selects exactly one seed
    cfg = DynamicsConfig(init_num=2, Nmax=1, max_iter=0, fastrelax=False,
                         mult_two_models=False, n_chains=1)
    out = run_single("t", str(fasta), None, str(tmp_path / "out"), cfg,
                     npz_dir=str(tmp_path / "npz"), device="cpu")
    with open(os.path.join(out, "traces.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    assert {r["kind"] for r in rows} - {"phase"} == {"initial", "chain"}
    init_rows = [r for r in rows if r["kind"] == "initial"]
    assert len(init_rows) == 2
    assert sum(r["selected_seed"] for r in init_rows) == 1
    assert all(np.isfinite(r["energy"]) for r in rows
               if r["kind"] != "phase")


def test_async_io_check_surfaces_errors_without_blocking():
    io = tdriver._AsyncIO()

    def boom():
        raise IOError("disk full")

    io.submit(boom)
    time.sleep(0.2)
    with pytest.raises(IOError):
        io.check()
    io.close()


def test_async_io_close_noraise_keeps_loop_error():
    io = tdriver._AsyncIO()
    io.submit(lambda: 1 / 0)
    time.sleep(0.2)
    io.close(raise_errors=False)      # must not raise


def test_async_io_ordered_writes_complete(tmp_path):
    io = tdriver._AsyncIO()
    for i in range(8):
        io.submit((tmp_path / f"f{i}.txt").write_text, str(i))
    io.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        [f"f{i}.txt" for i in range(8)]


def test_sampler_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """run_single, the run_inference CLI and generate_ensemble default to
    CUDA and refuse before writing anything where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "t.fasta").write_text(">t\nAAAA\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_single("t", str(tmp_path / "t.fasta"), None,
                   str(tmp_path / "out"), DynamicsConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["--fasta", str(tmp_path / "t.fasta"), "--name", "t",
                   "--save_dir", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_ensemble("t", str(tmp_path / "npz"), str(tmp_path / "pdb"),
                          {}, "AAAA", DynamicsConfig())
    assert sorted(p.name for p in tmp_path.iterdir()) == ["t.fasta"]
