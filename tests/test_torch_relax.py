"""The port's relax protocol (FastRelax rounds, the cartesian block and
refinement, the af2/idp/gpcr restraint modes) against the JAX package, on
the CPU.

Histograms come from tests/test_physics.py:_rand_npz, torsions and
displacements from numpy seeds. Restraint tables agree within 1e-6;
energies in float32 within 1e-5 relative, gradients in float64 within
1e-8. The relax rounds and the cartesian block run at shrunken schedules
(3 iterations per stage, both packages' module constants patched) in
float64 and agree within 1e-5. Whole default folds and the CLI are held at
protocol level: finite, no worse than the start, chain connected. JAX
programs are compiled once per module.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from trx2dy.geometry import binning as jbin
from trx2dy.physics import cartmin as jcart
from trx2dy.physics import compact as jcompact
from trx2dy.physics import energy as jenergy
from trx2dy.physics import folder as jfolder
from trx2dy.physics import restraints as jrst
from trx2dy_torch.cli import fold as tcli
from trx2dy_torch.geometry import binning as tbin
from trx2dy_torch.geometry import nerf as tnerf
from trx2dy_torch.io import pdbio as tpdbio
from trx2dy_torch.physics import cartmin as tcart
from trx2dy_torch.physics import compact as tcompact
from trx2dy_torch.physics import energy as tenergy
from trx2dy_torch.physics import folder as tfolder
from trx2dy_torch.physics import minimize as tmin
from trx2dy_torch.physics import restraints as trst

torch.set_num_threads(2)

SEQ = "ARNDCQEGHILK"          # a glycine for nogly
L = len(SEQ)
B = 2
DT = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
SHORT = ((0.02, 1.0, 3), (0.25, 0.5, 3), (0.55, 0.1, 3), (1.0, 0.1, 3))


def _rand_npz(L, key=0):
    """tests/test_physics.py:_rand_npz."""
    rng = np.random.default_rng(key)

    def soft(shape):
        x = rng.random(shape).astype(np.float32)
        return x / x.sum(-1, keepdims=True)
    return {"dist": soft((L, L, 37)), "omega": soft((L, L, 25)),
            "theta": soft((L, L, 25)), "phi": soft((L, L, 13))}


def _rel(port, ref, scale=None):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    s = np.abs(ref).max() if scale is None else scale
    return np.abs(port - ref).max() / max(s, 1e-30)


def _strands(n, seed):
    """(n, 3, L) near-extended start torsions (no clash to remove)."""
    rng = np.random.default_rng(seed)
    phi = np.deg2rad(-140.0) + rng.normal(0, 0.2, (n, L))
    psi = np.deg2rad(153.0) + rng.normal(0, 0.2, (n, L))
    omg = np.pi + rng.normal(0, 0.05, (n, L))
    return np.stack([phi, psi, omg], axis=1).astype(np.float32)


def _helices(n, seed):
    """(n, 3, L) near-helical start torsions: their vdw-only score (rama +
    vdw) stays below the clash cutoff, so no clash stage runs first."""
    rng = np.random.default_rng(seed)
    phi = np.deg2rad(-61.0) + rng.normal(0, 0.02, (n, L))
    psi = np.deg2rad(-41.0) + rng.normal(0, 0.02, (n, L))
    omg = np.pi + rng.normal(0, 0.01, (n, L))
    return np.stack([phi, psi, omg], axis=1)


def _known(rng, n=2):
    return {"dist": rng.uniform(3, 19, (n, L, L)).astype(np.float32),
            "omega": rng.uniform(-3, 3, (n, L, L)).astype(np.float32),
            "theta_asym": rng.uniform(-3, 3, (n, L, L)).astype(np.float32),
            "phi_asym": rng.uniform(0.1, 3, (n, L, L)).astype(np.float32)}


def _shrink(monkeypatch, repeats=None, iters=3):
    """`iters` iterations per relax and cartesian stage, in both packages;
    with repeats, that many repeats of each relax round."""
    short = tuple((fa, cst, iters) for fa, cst, _ in SHORT)
    for mod in (jfolder, tfolder):
        for name in ("RELAX_SCHEDULE_R1", "RELAX_SCHEDULE_R2",
                     "CART_SCHEDULE_R1"):
            monkeypatch.setattr(mod, name, short)
        if repeats is not None:
            monkeypatch.setattr(mod, "RELAX_REPEATS", repeats)
    monkeypatch.setattr(tfolder, "CART_REFINE_ITERS", iters)
    monkeypatch.setattr(tcart, "IDEALIZE_ITERS", iters)


@pytest.fixture(scope="module")
def case():
    """Restraints (both packages) of a random L=12 target, the relax-2
    masks, and a displaced backbone as the cartesian stages see it."""
    npz = _rand_npz(L, key=3)
    prst, jr = trst.compile_restraints(npz), jrst.compile_restraints(npz)
    pm = trst.restraint_masks(prst, SEQ, 1, L, pcut=0.30, nogly=True)
    jm = jrst.restraint_masks(jr, SEQ, 1, L, pcut=0.30, nogly=True)
    t = torch.from_numpy(_strands(B, seed=4))
    atoms = {k: v.numpy() for k, v in
             tnerf.build_backbone(t[:, 0], t[:, 1], t[:, 2]).items()}
    delta = np.random.default_rng(5).normal(
        0, 0.1, (B, 5 * L * 3)).astype(np.float32)
    return npz, prst, jr, pm, jm, atoms, delta


# ------------------------------------------------------- restraint modes

def _leaves_close(port, ref, tol=1e-6):
    pl, rl = jax.tree.leaves(tuple(port)), jax.tree.leaves(tuple(ref))
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.abs(a.astype(np.float64) - b).max() <= \
            tol * max(1.0, np.abs(b).max())


@pytest.mark.parametrize("mode", ["af2", "idp", "idp-noorient", "gpcr",
                                  "gpcr-noorient"])
def test_restraint_modes_match_jax(mode):
    rng = np.random.default_rng(11)
    if mode == "af2":
        d64 = rng.random((L, L, 64), dtype=np.float32)
        npz = {"dist": d64 / d64.sum(-1, keepdims=True),
               "bins": np.linspace(2.3125, 21.6875, 63)}
        port = trst.compile_restraints_af2(npz)
        ref = jrst.compile_restraints_af2(npz)
        assert port.dist.x.shape == (60,)
    else:
        orient = not mode.endswith("noorient")
        npz = _rand_npz(L, key=12)
        npz["idr"] = rng.integers(0, 2, L if mode.startswith("idp")
                                  else (L, L))
        if mode.startswith("idp"):
            port = trst.compile_restraints_idp(npz, use_orient=orient)
            ref = jrst.compile_restraints_idp(npz, use_orient=orient)
        else:
            known = _known(rng)
            port = trst.compile_restraints_gpcr(npz, known,
                                                use_orient=orient)
            ref = jrst.compile_restraints_gpcr(npz, known,
                                               use_orient=orient)
    _leaves_close(port, ref)
    for args in ((1, L, 0.05, False), (1, L, 0.30, True)):
        for a, b in zip(trst.restraint_masks(port, SEQ, *args),
                        jrst.restraint_masks(ref, SEQ, *args)):
            assert np.array_equal(a, np.asarray(b))


def test_gpcr_helpers_and_binning_match_jax():
    rng = np.random.default_rng(13)
    known = _known(rng, n=3)
    for bug in (True, False):
        port = tbin.bin_geometry_maps(
            torch.from_numpy(known["dist"][0]),
            *(torch.from_numpy(known[k][0]) for k in ("omega", "theta_asym",
                                                       "phi_asym")),
            phi_compat_bug=bug)
        ref = jbin.bin_geometry_maps(
            jnp.asarray(known["dist"][0]),
            *(jnp.asarray(known[k][0]) for k in ("omega", "theta_asym",
                                                  "phi_asym")),
            phi_compat_bug=bug)
        assert port.keys() == ref.keys()
        for k in port:
            assert np.array_equal(port[k].numpy(), np.asarray(ref[k])), k
    hist = np.eye(37, dtype=np.float32)[rng.integers(0, 37, (3, L, L))]
    assert np.array_equal(trst._gaussian_vote(hist),
                          jrst._gaussian_vote(hist))
    test = rng.normal(size=(L, L, 35)).astype(np.float32)
    cate = rng.normal(size=(L, L, 35)).astype(np.float32)
    mask = rng.random((L, L)) < 0.5
    bins = trst.dist_knots()
    assert np.array_equal(trst._linear_blend(test, cate, bins, mask),
                          jrst._linear_blend(test, cate, bins, mask))


# ------------------------------------------------------ relax constants

def test_relax_constants_and_ramped_weights_match_jax():
    for name in ("SCOREFXN_RELAX", "RELAX_SCHEDULE_R1", "RELAX_SCHEDULE_R2",
                 "CART_SCHEDULE_R1", "RELAX_REPEATS"):
        assert getattr(tfolder, name) == getattr(jfolder, name), name
    for name in ("K_BOND", "K_ANGLE", "IDEALIZE_ITERS", "IDEALIZE_SCALE",
                 "K_TETHER", "CART_CHUNK"):
        assert getattr(tcart, name) == getattr(jcart, name), name
    for fa, cst, _ in tfolder.RELAX_SCHEDULE_R1 + tfolder.RELAX_SCHEDULE_R2:
        assert tfolder._ramped_relax_weights(fa, cst) == \
            jfolder._ramped_relax_weights(fa, cst)
    for (wp, ip), (wr, ir) in zip(tfolder._cart_r1_stages(),
                                  jfolder._cart_r1_stages()):
        assert ip == ir and np.array_equal(wp, np.asarray(wr))


def test_project_torsions_matches_jax(case):
    _, _, _, _, _, atoms, delta = case
    moved = tcart._delta_unpack({k: torch.from_numpy(v)
                                 for k, v in atoms.items()},
                                torch.from_numpy(delta))
    x = _strands(B, seed=6).reshape(B, -1)
    port = tfolder._project_torsions(torch.from_numpy(x), moved)
    ref = np.asarray(jfolder._project_torsions_jit(
        jnp.asarray(x), {k: jnp.asarray(v.numpy())
                         for k, v in moved.items()}))
    assert np.abs(port.numpy() - ref).max() < 1e-5
    t, r = port.reshape(B, 3, L).numpy(), ref.reshape(B, 3, L)
    # the ends: phi[0] and omega[-1] kept, psi[-1] from the carbonyl O
    x3 = x.reshape(B, 3, L)
    assert np.array_equal(t[:, 0, 0], x3[:, 0, 0])
    assert np.array_equal(t[:, 2, -1], x3[:, 2, -1])
    assert np.abs(t[:, 1, -1] - r[:, 1, -1]).max() < 1e-5
    assert np.abs(t[:, 1, -1] - x3[:, 1, -1]).max() > 1e-3   # it moved
    # on the ideal manifold the projection returns the torsions
    ideal = tnerf.build_backbone(*torch.from_numpy(x.reshape(B, 3, L))
                                 .unbind(1))
    back = tfolder._project_torsions(torch.from_numpy(x), ideal).numpy()
    wrap = np.angle(np.exp(1j * (back - x)))
    assert np.abs(wrap).max() < 1e-4


# ------------------------------------------------------ cartesian energies

def _cast(tree, dt):
    """Every floating leaf as a jax array of dt, the rest as jax arrays
    (the port's compact_to and tables_to cast the tables the same way)."""
    return jax.tree.map(
        lambda a: jnp.asarray(a, dt) if np.issubdtype(np.asarray(a).dtype,
                                                      np.floating)
        else jnp.asarray(a), tree)


def _f64(tree):
    """A restraint set with every floating leaf in float64 (host numpy),
    so that JAX's compaction gives float64 tables, as compact_to(...,
    torch.float64) does."""
    return jax.tree.map(
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


@pytest.fixture(scope="module")
def jax_cart(case):
    """(name, delta, prec) -> JAX values in float32 (forward only, with a
    residue mask), or values and the gradient of their sum in float64
    (through cartmin._cart_init, the program the cartesian block runs; no
    residue mask)."""
    _, _, jr, _, jm, atoms, _ = case
    w = jenergy.weights_to_vec(jfolder.SCOREFXN_RELAX)
    rm = jnp.arange(L) < L - 2
    progs = {}

    def tables(name, dt):
        if name == "compact":
            cr = jcompact.compact_restraints(_f64(jr) if dt == np.float64
                                             else jr, jm)
            return jax.tree.map(jnp.asarray, cr)
        return _cast((jr, jm), dt)

    def call(name, delta, prec):
        dt = DT[prec][0]
        with jax.enable_x64(prec == "f64"):
            at = jax.tree.map(lambda a: jnp.asarray(a, dt), atoms)
            d = jnp.asarray(delta, dt)
            if name == "bonded":
                if prec not in progs:
                    def bonded(a, dd):
                        val, pull = jax.vjp(lambda x: jax.vmap(
                            lambda y: jcart.cart_bonded_energy(
                                y, res_mask=rm))(jcart._delta_unpack(a, x)),
                            dd)
                        return val, pull(jnp.ones_like(val))[0]
                    progs[prec] = jax.jit(bonded)
                return tuple(np.asarray(o) for o in progs[prec](at, d))
            if prec == "f32":
                key = (name, prec)
                if key not in progs:
                    progs[key] = jax.jit(
                        lambda a, dd, tb, n=name: jcart._cart_efun(
                            a, tb, jnp.asarray(w), n, res_mask=rm)(dd))
                return np.asarray(progs[key](at, d, tables(name, dt))), None
            st = jcart._cart_init(at, d, tables(name, dt), w, name)
            return np.asarray(st.f), np.asarray(st.g)
    return call


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("name", ["bonded", "compact", "dense"])
def test_cart_energies_match_jax(case, jax_cart, name, prec):
    _, prst, _, pm, _, atoms, delta = case
    tdt = DT[prec][1]
    at = {k: torch.as_tensor(v, dtype=tdt) for k, v in atoms.items()}
    rm = torch.arange(L) < L - 2 if prec == "f32" or name == "bonded" \
        else None
    w = torch.as_tensor(tenergy.weights_to_vec(tfolder.SCOREFXN_RELAX),
                        dtype=tdt)
    if name == "bonded":
        def efun(d):
            return tcart.cart_bonded_energy(tcart._delta_unpack(at, d),
                                            res_mask=rm)
    else:
        tables = tcompact.compact_to(tcompact.compact_restraints(prst, pm),
                                     L, "cpu", tdt) if name == "compact" \
            else (trst.tables_to(prst, "cpu", tdt), trst.masks_to(pm, "cpu"))
        efun = tcart._cart_efun(at, tables, w, name, res_mask=rm)
    d = torch.as_tensor(delta, dtype=tdt).requires_grad_(True)
    e = efun(d)
    e.sum().backward()
    ref_e, ref_g = jax_cart(name, delta, prec)
    assert _rel(e.detach(), ref_e) < (1e-5 if prec == "f32" else 1e-8)
    if prec == "f64":
        assert _rel(d.grad, ref_g) < 1e-8
    if name == "bonded":        # the NeRF build is the ideal geometry
        assert float(tcart.cart_bonded_energy(at).abs().max()) < 1e-4


def test_cartesian_refine_compact_matches_dense(case, monkeypatch):
    """The compact and dense refinements minimise one objective: from the
    same start in float64 they reach the same atoms, lower the energy and
    move atoms by less than 1.5 A."""
    monkeypatch.setattr(tcart, "IDEALIZE_ITERS", 10)
    _, prst, _, pm, _, atoms, _ = case
    at = {k: torch.as_tensor(v, dtype=torch.float64)
          for k, v in atoms.items()}
    cr = tcompact.compact_to(tcompact.compact_restraints(prst, pm), L,
                             "cpu", torch.float64)
    log = []
    tmin.STATS.reset()
    comp, f_c = tcart.cartesian_refine_compact(at, cr, tfolder.SCOREFXN_RELAX,
                                               max_iter=8, stage_log=log)
    assert [lab for lab, _, _ in log] == ["cart_refine", "idealize"]
    assert 0 < tmin.STATS.free_evals and 0 < tmin.STATS.evals
    dense, f_d = tcart.cartesian_refine(at, prst, pm, tfolder.SCOREFXN_RELAX,
                                        max_iter=8)
    assert _rel(f_c, f_d) < 1e-8
    for k in comp:
        assert np.abs(comp[k].numpy() - dense[k].numpy()).max() < 1e-6
    w = torch.as_tensor(tenergy.weights_to_vec(tfolder.SCOREFXN_RELAX),
                        dtype=torch.float64)
    e0 = tcart._cart_efun(at, cr, w, "compact")(
        torch.zeros(B, 15 * L, dtype=torch.float64))
    # the same start energy as the term sum of explicit atoms
    total = tcart.atoms_energy(at, trst.tables_to(prst, "cpu", torch.float64),
                               trst.masks_to(pm, "cpu"),
                               tfolder.SCOREFXN_RELAX) \
        + tcart.cart_bonded_energy(at)
    assert _rel(total, e0) < 1e-10
    assert (f_c <= e0).all()
    assert float((comp["CA"] - at["CA"]).abs().max()) < 1.5


# --------------------------------------------------------- the protocol

def test_relax_protocol_matches_jax_f64(case, monkeypatch):
    """Centroid stages (3 iterations), relax round 1, the cartesian block,
    relax round 2, each relax round repeated RELAX_REPEATS times with
    accept_to_best, at 3 iterations per stage, float64 with float64
    tables: final torsions and energies, and every stage's iteration
    count, match JAX. The start is near-helical: from a start that the
    clash stage must move, decoys stuck in a clash converge within a few
    iterations, and which iteration meets the tolerance there flips
    between the two packages on differences of 1e-15."""
    _shrink(monkeypatch)
    _, prst, jr, _, _, _, _ = case
    x0 = _helices(B, seed=7).reshape(B, -1)
    stage = [trst.restraint_masks(prst, SEQ, 1, L)]
    r1, r2 = (trst.restraint_masks(prst, SEQ, 1, L, pcut=pc, nogly=True)
              for pc in (0.15, 0.30))

    def dev(m):
        return tcompact.compact_to(tcompact.compact_restraints(prst, m), L,
                                   "cpu", torch.float64)
    log = []
    x, f = tfolder._protocol_staged(
        torch.from_numpy(x0), [dev(m) for m in stage], 3, stage_log=log,
        relax=(dev(r1), dev(r2)), cart_r1=True)
    jlog = []
    with jax.enable_x64(True):
        jx, jf = jfolder._protocol_staged(
            jnp.asarray(x0), _f64(jr), stage, r1, r2, fastrelax=True,
            max_iter=3, dist_on_ca=False, cart_r1=True, stage_log=jlog)
        jx, jf = np.asarray(jx), np.asarray(jf)
    assert _rel(f, jf) < 1e-5
    assert np.abs(x.numpy() - jx).max() < 1e-5 * max(1.0, np.abs(jx).max())
    # the same stages with the same iteration counts (JAX logs both relax
    # rounds as "relax" and no cartesian stage)
    port = [(lab.rstrip("12"), it) for lab, it, _ in log
            if lab != "cart_r1"]
    assert port == [(lab, int(it)) for lab, it, _ in jlog]
    labels = [lab for lab, _, _ in log]
    assert labels.count("cart_r1") == 4
    assert labels.count("relax1") == labels.count("relax2") == \
        4 * tfolder.RELAX_REPEATS


def _centroid_start(npz, x0, seq=SEQ):
    """The centroid energy of the mode-2 stage at x0, as fold_ensemble
    scores its final decoys."""
    rst = trst.compile_restraints(npz)
    (m,) = tfolder._stage_masks_centroid(rst, seq, 2, 0.05)
    cr = tcompact.compact_to(tcompact.compact_restraints(rst, m), L, "cpu")
    with torch.no_grad():
        return tenergy.batched_energy_weighted_compact(
            torch.from_numpy(x0.reshape(len(x0), -1)), cr, torch.from_numpy(
                tenergy.weights_to_vec(tenergy.SCOREFXN_CENT))).numpy()


def _chain_ok(ca):
    d = np.linalg.norm(np.diff(np.asarray(ca), axis=1), axis=-1)
    return bool((d > 2.7).all() and (d < 4.2).all())


@pytest.mark.parametrize("rst_mode", ["no-idp", "af2", "idp", "gpcr"])
def test_fold_ensemble_defaults_protocol_level(case, monkeypatch, rst_mode):
    """fold_ensemble at its defaults (relax, cartesian block and
    refinement) in every restraint mode, schedules shrunk: energies
    finite and below the start's centroid energy, every stage logged, the
    chain connected; the final energy is the centroid score of the
    returned torsions and the refined atoms stay within 1.5 A of their
    NeRF build."""
    _shrink(monkeypatch, repeats=1, iters=2)
    npz = dict(case[0])
    kw = {}
    rng = np.random.default_rng(21)
    if rst_mode == "af2":
        d64 = rng.random((L, L, 64), dtype=np.float32)
        npz = {"dist": d64 / d64.sum(-1, keepdims=True),
               "bins": np.linspace(2.3125, 21.6875, 63)}
        kw["use_orient"] = False
    elif rst_mode in ("idp", "gpcr"):
        npz["idr"] = rng.integers(0, 2, (L, L))
        if rst_mode == "gpcr":
            kw["known_npz"] = _known(rng)
    x0 = _helices(B, seed=8).astype(np.float32)
    log = []
    res = tfolder.fold_ensemble(npz, SEQ, None, n_decoys=B, max_iter=3,
                                x0=x0, rst_mode=rst_mode, device="cpu",
                                stage_log=log, **kw)
    e = res.energy.numpy()
    assert np.isfinite(e).all()
    for a in res.atoms.values():
        assert bool(torch.isfinite(a).all())
    assert _chain_ok(res.atoms["CA"])
    labels = {lab for lab, _, _ in log}
    cart = rst_mode in ("no-idp", "idp")
    assert {"cent", "cart", "relax1", "relax2"} <= labels
    assert ({"cart_r1", "cart_refine", "idealize"} <= labels) == cart
    assert ({"cart_r1", "cart_refine", "idealize"} & labels == set()) \
        == (not cart)
    t = res.torsions
    ideal = tnerf.build_backbone(t[:, 0], t[:, 1], t[:, 2])
    moved = max(float((res.atoms[k] - ideal[k]).abs().max())
                for k in ideal)
    assert moved < 1.5 and (moved > 0) == cart
    if rst_mode == "no-idp":
        assert (e <= _centroid_start(npz, x0)).all()
        assert _rel(e, _centroid_start(npz, t.numpy())) < 1e-5


def test_cli_defaults_write_full_atom_pdbs(case, monkeypatch, tmp_path,
                                           capsys):
    _shrink(monkeypatch, repeats=1, iters=2)
    np.savez(tmp_path / "t.npz", **case[0])
    (tmp_path / "t.fasta").write_text(">t\n" + SEQ + "\n")
    base = ["-NPZ", str(tmp_path / "t.npz"), "-FASTA",
            str(tmp_path / "t.fasta"), "--n_decoys", "2", "-n", "3",
            "--device", "cpu"]
    paths, res = tcli.main(base + ["-OUT", str(tmp_path / "d.pdb")])
    assert "[trx2dy] wrote 2 decoys" in capsys.readouterr().out
    assert np.isfinite(res.energy.numpy()).all()
    assert _chain_ok(res.atoms["CA"])
    for b, p in enumerate(paths):
        lines = [ln for ln in open(p) if ln.startswith("ATOM")]
        names = {ln[12:16].strip() for ln in lines}
        assert {"CG", "OD1", "SG", "NE2"} <= names      # side chains
        coords, seq = tpdbio.read_pdb_backbone(p)
        assert seq == SEQ
        for k in ("N", "CA", "C", "O"):
            assert np.abs(coords[k] - res.atoms[k][b].numpy()).max() < 1e-3
    # --backbone_only writes backbone(+CB) records of the same fold (the
    # fold itself is the one above)
    asked = []

    def same_fold(*args, **kw):
        asked.append(kw)
        return res
    monkeypatch.setattr(tfolder, "fold_ensemble", same_fold)
    paths, _ = tcli.main(base + ["-OUT", str(tmp_path / "b.pdb"),
                                 "--backbone_only"])
    assert asked[0]["fastrelax"] and asked[0]["rst_mode"] == "no-idp"
    for b, p in enumerate(paths):
        names = {ln[12:16].strip() for ln in open(p) if ln.startswith("ATOM")}
        assert names == {"N", "CA", "C", "O", "CB"}
        coords, _ = tpdbio.read_pdb_backbone(p)
        assert np.abs(coords["CA"] - res.atoms["CA"][b].numpy()).max() < 1e-3
