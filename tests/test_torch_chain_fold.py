"""The port's host chain fold (physics/folder.fold_chains and the lanes forms
it builds) against the JAX package, on the CPU.

Histograms come from tests/test_physics.py:_rand_npz, start torsions and
displacements from numpy seeds. JAX stacks per-lane pair lists
(CompactLanes, (M, P, K)); the port builds one union pair list per term
with tables per distinct restraint set behind a lane -> row map
(compact.compact_restraints_lanes), so what is held is each lane's energy
and gradient: float32 values within 1e-4 relative, float64 values within
1e-6 relative and gradients within 1e-6 of the largest, with lanes padded
by repetition (lane_bucket) and a residue mask (pad_to). fold_chains'
contracts (tests/test_physics.py:523-560, 981-1053) are held on the port
with the minimisation cut short (max_iter, clash rounds and the relax and
cartesian schedules cut as tests/test_torch_relax.py and
tests/test_torch_sampler.py cut them); one fold, relax on at 2 iterations
a stage, is held to JAX's in distribution from the same starts.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from trx2dy.geometry.nerf import build_backbone as jbuild
from trx2dy.physics import cartmin as jcart
from trx2dy.physics import compact as jcompact
from trx2dy.physics import energy as jenergy
from trx2dy.physics import folder as jfolder
from trx2dy.physics import restraints as jrst
from trx2dy_torch.geometry import nerf as tnerf
from trx2dy_torch.ops import spline_energy as tops
from trx2dy_torch.physics import cartmin as tcart
from trx2dy_torch.physics import compact as tcompact
from trx2dy_torch.physics import energy as tenergy
from trx2dy_torch.physics import folder as tfolder
from trx2dy_torch.physics import restraints as trst
from trx2dy_torch.physics.minimize import STATS

torch.set_num_threads(2)

SEQ14 = "ARNDCQEGHILKMF"
L = 16
SEQ = "ARNDCQEGHILKMFPS"
FAN = [0, 0, 1, 1, 1, 1]        # two restraint sets; the last two lanes
#                                 repeat the last, as lane_bucket pads
DT = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}


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


def _rel(port, ref, scale=None):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    s = np.abs(ref) if scale is None else scale
    return float(np.max(np.abs(port - ref) / np.maximum(s, 1e-30)))


def _f64(tree):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


@pytest.fixture(scope="module")
def lanes_case():
    """Both packages' restraint sets and stage masks of two random L=16
    targets fanned over FAN, the lanes' start torsions and a displacement
    of the built atoms."""
    npzs = [_rand_npz(L, key=20 + k) for k in range(2)]
    tr = [trst.compile_restraints(n) for n in npzs]
    jr = [jrst.compile_restraints(n) for n in npzs]
    tm = [trst.restraint_masks(r, SEQ, 1, L, pcut=0.04) for r in tr]
    jm = [jrst.restraint_masks(r, SEQ, 1, L, pcut=0.04) for r in jr]
    x = _x0(len(FAN), L, seed=2).reshape(len(FAN), 3 * L)
    delta = np.random.default_rng(5).normal(
        0, 0.1, (len(FAN), 15 * L)).astype(np.float32)
    return ([tr[u] for u in FAN], [tm[u] for u in FAN],
            [jr[u] for u in FAN], [jm[u] for u in FAN], x, delta)


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_lanes_energies_match_jax(lanes_case, prec):
    """batched_energy_weighted_lanes per lane with a residue mask, in
    float32 with compact_restraint_energy_lanes beside it, in float64
    with the gradient of the energies' sum."""
    trs, tms, jrs, jms, x, _ = lanes_case
    ndt, tdt = DT[prec]
    rm = np.arange(L) < L - 2
    w = jenergy.weights_to_vec(jenergy.SCOREFXN_CENT)
    stage = tcompact.compact_restraints_lanes(trs, tms, device="cpu",
                                              dtype=tdt)
    xt = torch.as_tensor(x, dtype=tdt).requires_grad_(True)
    e = tenergy.batched_energy_weighted_lanes(
        xt, stage, torch.as_tensor(w, dtype=tdt),
        res_mask=torch.as_tensor(rm))
    (g,) = torch.autograd.grad(e.sum(), xt)
    with jax.enable_x64(prec == "f64"):
        cl = jax.tree.map(jnp.asarray, jcompact.compact_restraints_lanes(
            [_f64(r) for r in jrs] if prec == "f64" else jrs, jms))

        def energy(xx, cl):
            return jenergy.batched_energy_weighted_lanes(
                xx, cl, jnp.asarray(w, ndt), res_mask=jnp.asarray(rm))
        xj = jnp.asarray(x, ndt)
        if prec == "f64":
            def total(xx, cl):
                ee = energy(xx, cl)
                return ee.sum(), ee
            (_, ref_e), ref_g = jax.jit(jax.value_and_grad(
                total, has_aux=True))(xj, cl)
            ref_e, ref_g = np.asarray(ref_e), np.asarray(ref_g)
        else:
            def restraints(xx, cl):
                t = xx.reshape(len(FAN), 3, L)
                at = jax.vmap(lambda a: jbuild(a[0], a[1], a[2]))(t)
                return jcompact.compact_restraint_energy_lanes(at, cl, 1.0,
                                                               1.0, 1.0)
            ref_e, ref_r = (np.asarray(a) for a in jax.jit(
                lambda xx, cl: (energy(xx, cl), restraints(xx, cl)))(xj, cl))
    if prec == "f64":
        assert _rel(e.detach(), ref_e) < 1e-6, (e, ref_e)
        assert _rel(g, ref_g, np.abs(ref_g).max()) < 1e-6
    else:
        t = xt.detach().reshape(len(FAN), 3, L)
        atoms = tnerf.build_backbone(t[:, 0], t[:, 1], t[:, 2])
        e_r = tcompact.compact_restraint_energy_lanes(atoms, stage, 1.0, 1.0,
                                                      1.0)
        assert _rel(e.detach(), ref_e) < 1e-4, (e, ref_e)
        assert _rel(e_r, ref_r) < 1e-4, (e_r, ref_r)


def test_cartesian_lanes_energy_matches_jax(lanes_case):
    """JAX's "lanes" kind against the port's on the host-built stage, in
    float64: values and the gradient of their sum."""
    trs, tms, jrs, jms, x, delta = lanes_case
    w = jenergy.weights_to_vec(jfolder.SCOREFXN_RELAX)
    t = torch.as_tensor(x, dtype=torch.float64).reshape(len(FAN), 3, L)
    atoms = tnerf.build_backbone(t[:, 0], t[:, 1], t[:, 2])
    stage = tcompact.compact_restraints_lanes(trs, tms, device="cpu",
                                              dtype=torch.float64)
    d = torch.as_tensor(delta, dtype=torch.float64).requires_grad_(True)
    e = tcart._cart_efun(atoms, stage, torch.as_tensor(w), "lanes")(d)
    (g,) = torch.autograd.grad(e.sum(), d)
    with jax.enable_x64(True):
        cl = jax.tree.map(jnp.asarray, jcompact.compact_restraints_lanes(
            [_f64(r) for r in jrs], jms))
        at = {k: jnp.asarray(v.numpy()) for k, v in atoms.items()}
        st = jcart._cart_init(at, jnp.asarray(delta, jnp.float64), cl, w,
                              "lanes")
        ref_e, ref_g = np.asarray(st.f), np.asarray(st.g)
    assert _rel(e.detach(), ref_e) < 1e-6
    assert _rel(g, ref_g, np.abs(ref_g).max()) < 1e-6


def test_compact_restraints_lanes_layout(lanes_case):
    """One union pair list per term; tables only for the distinct (table,
    mask) objects; each lane active exactly on its own mask's pairs; the
    floor respected; padding pairs inert."""
    trs, tms, _, _, _, _ = lanes_case
    st = tcompact.compact_restraints_lanes(trs, tms, floor={"dist": 2048})
    for name, term, act in zip(("dist", "omega", "theta", "phi"),
                               st.ur, st.acts):
        masks = [np.asarray(getattr(m, name)) for m in tms]
        n = int(np.any(masks, axis=0).sum())
        P = term.tab.shape[0]
        assert P == (2048 if name == "dist" else tcompact._bucket(n))
        assert term.tab.shape[1] == 2                   # two distinct sets
        assert term.row.tolist() == FAN and term.row.dtype == torch.int32
        i, j = term.i.idx.numpy(), term.j.idx.numpy()
        assert (i[n:] != j[n:]).all() and not act[n:].any()
        for c, m in enumerate(masks):
            assert np.array_equal(act[:n, c].numpy(), m[i[:n], j[:n]])
            assert int(act[:, c].sum()) == int(m.sum())
        y, _ = tops.expand_lane_tables(term.tab, term.row)
        table = getattr(trs[2], name)
        np.testing.assert_array_equal(
            y[:n, 2].numpy(), np.asarray(table.y)[i[:n], j[:n]])


@pytest.fixture
def short_relax(monkeypatch):
    """Relax and cartesian stages at 2 iterations, one clash round."""
    for name in ("RELAX_SCHEDULE_R1", "RELAX_SCHEDULE_R2",
                 "CART_SCHEDULE_R1"):
        monkeypatch.setattr(tfolder, name, tuple(
            (fa, cst, 2) for fa, cst, _ in getattr(tfolder, name)))
    monkeypatch.setattr(tfolder, "CART_REFINE_ITERS", 2)
    monkeypatch.setattr(tcart, "IDEALIZE_ITERS", 2)
    monkeypatch.setattr(tfolder, "CLASH_ROUNDS", 1)


def test_fold_chains_candidates_pick_best(monkeypatch, short_relax):
    """Relax and cartesian refinement on: each chain keeps its
    lowest-energy candidate, every spline-counted evaluation launches the
    lanes entry once, the floors name every term, the stages are logged."""
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
    fr = tfolder.fold_chains(
        [_rand_npz(14, key=31), _rand_npz(14, key=32)], SEQ14,
        torch.Generator().manual_seed(0), max_iter=2, candidates=2,
        lane_bucket=8, bucket_floors=floors, stage_log=log, device="cpu")
    assert fr.torsions.shape == (2, 3, 14) and fr.atoms["CA"].shape == \
        (2, 14, 3)
    f = seen["f"].numpy()
    assert seen["x"].shape == (8, 3 * 14)
    assert np.array_equal(fr.energy.numpy(), f[:4].reshape(2, 2).min(1))
    assert STATS.evals > 0 and len(launches) == STATS.evals
    assert set(floors["all"]) == {"dist", "omega", "theta", "phi"}
    assert {"relax1", "cart_r1", "relax2", "cart_refine"} <= \
        {lab for lab, _, _ in log}


@pytest.fixture
def no_minimisation(monkeypatch):
    """Every stage one evaluation: no clash round, 0-iteration relax and
    cartesian schedules (callers pass max_iter 0)."""
    monkeypatch.setattr(tfolder, "CLASH_ROUNDS", 0)
    for name in ("RELAX_SCHEDULE_R1", "RELAX_SCHEDULE_R2",
                 "CART_SCHEDULE_R1"):
        monkeypatch.setattr(tfolder, name, tuple(
            (fa, cst, 0) for fa, cst, _ in getattr(tfolder, name)))
    monkeypatch.setattr(tfolder, "CART_REFINE_ITERS", 0)
    monkeypatch.setattr(tcart, "IDEALIZE_ITERS", 0)


def test_fold_chains_dedup_is_by_content(monkeypatch, no_minimisation):
    """Equal-content dicts compile their restraints once, and their lanes
    share one table row."""
    npz = _rand_npz(14, key=41)
    clone = {k: np.array(v, copy=True) for k, v in npz.items()}
    calls, rows = [], []
    compile_ = tfolder.compile_restraints
    monkeypatch.setattr(tfolder, "compile_restraints",
                        lambda *a, **k: calls.append(1) or compile_(*a, **k))
    lanes = tfolder.compact_restraints_lanes

    def spy(*a, **k):
        st = lanes(*a, **k)
        rows.append(st.ur.dist.tab.shape[1])
        return st
    monkeypatch.setattr(tfolder, "compact_restraints_lanes", spy)
    fr = tfolder.fold_chains([npz, clone, npz], SEQ14, max_iter=0,
                             fastrelax=False, device="cpu")
    assert len(calls) == 1 and set(rows) == {1}
    assert fr.torsions.shape == (3, 3, 14)


def test_fold_chains_lane_bucket_keeps_shapes(monkeypatch, no_minimisation):
    """An initial-ensemble-like call (6 chains, one candidate) and a
    chain-step-like call (2 chains, 2 candidates) at one lane bucket and
    one floors dict fold the same lane count over the same pair-list
    sizes."""
    sizes = []
    lanes = tfolder.compact_restraints_lanes

    def spy(*a, **k):
        st = lanes(*a, **k)
        sizes.append((st.splines.n_lanes, st.splines.sizes))
        return st
    monkeypatch.setattr(tfolder, "compact_restraints_lanes", spy)
    floors = {}
    kw = dict(mode=2, max_iter=0, bucket_floors=floors, lane_bucket=8,
              device="cpu")
    a, b = _rand_npz(16, key=201), _rand_npz(16, key=202)
    fr = tfolder.fold_chains([a, a, a, b, b, b], SEQ,
                             torch.Generator().manual_seed(0), **kw)
    assert fr.torsions.shape == (6, 3, 16)
    first = set(sizes)
    sizes.clear()
    fr2 = tfolder.fold_chains([_rand_npz(16, key=203),
                               _rand_npz(16, key=204)], SEQ,
                              torch.Generator().manual_seed(1),
                              candidates=2, **kw)
    assert fr2.torsions.shape == (2, 3, 16)
    assert np.isfinite(fr2.energy.numpy()).all()
    assert len(first) == 1 and set(sizes) == first
    assert next(iter(first))[0] == 8


def test_fold_chains_x0_replication_and_padding(no_minimisation):
    """x0 shorter than the bucketed lanes: the last start is repeated (with
    no iteration the torsions come back as given); pad_to folds inert
    residues and slices them off."""
    x0 = _x0(2, 16, seed=9)
    fr = tfolder.fold_chains([_rand_npz(14, key=51)] * 3, SEQ14, x0=x0,
                             max_iter=0, fastrelax=False, pad_to=16,
                             lane_bucket=4, device="cpu")
    assert fr.torsions.shape == (3, 3, 14)
    assert fr.atoms["CA"].shape == (3, 14, 3)
    want = x0[[0, 1, 1], :, :14]
    np.testing.assert_array_equal(fr.torsions.numpy(), want)
    assert np.isfinite(fr.energy.numpy()).all()


@pytest.mark.parametrize("case", ["candidates_with_x0", "mode_3"])
def test_fold_chains_refusals(case):
    """Both packages refuse candidates > 1 with x0, and mode 3: fold_chains
    builds the stage masks without the npz 'idr' mask, so mode 3 raises
    even with one (a property of both packages)."""
    npz = dict(_rand_npz(14, key=61), idr=np.ones(14, bool))
    if case == "candidates_with_x0":
        kw, match = dict(candidates=2, x0=_x0(1, 14, seed=1)), "candidates"
    else:
        kw, match = dict(mode=3), "mode 3 requires the npz 'idr' mask"
    with pytest.raises(ValueError, match=match):
        tfolder.fold_chains([npz], SEQ14, max_iter=0, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        jfolder.fold_chains([npz], SEQ14, jax.random.PRNGKey(0), max_iter=0,
                            **kw)


def test_fold_chains_matches_jax_distributionally(monkeypatch):
    """8 chains of two L=14 targets, one candidate, from the same starts in
    both packages, FastRelax on with every relax stage at 2 iterations and
    one clash round (both packages' constants), max_iter 8; the final
    cartesian refinement off (its energy is held above). Trajectories of
    two frameworks drift apart in float32, so the 8 final energies are held
    as a distribution: median and mean within 10 % of JAX's (the median
    of 8 decoys moved 3.8 % between two trajectories of one package,
    PERF.md)."""
    for mod in (jfolder, tfolder):
        for name in ("RELAX_SCHEDULE_R1", "RELAX_SCHEDULE_R2",
                     "CART_SCHEDULE_R1"):
            monkeypatch.setattr(mod, name, tuple(
                (fa, cst, 2) for fa, cst, _ in getattr(mod, name)))
        monkeypatch.setattr(mod, "CLASH_ROUNDS", 1)
    npzs = [_rand_npz(14, key=70), _rand_npz(14, key=71)] * 4
    x0 = _x0(8, 14, seed=3)
    kw = dict(max_iter=8, cart_refine=False)
    port = tfolder.fold_chains(npzs, SEQ14, x0=x0, device="cpu", **kw)
    ref = jfolder.fold_chains(npzs, SEQ14, jax.random.PRNGKey(0),
                              x0=jnp.asarray(x0), **kw)
    assert port.torsions.shape == (8, 3, 14)
    e, r = port.energy.numpy(), np.asarray(ref.energy)
    assert np.isfinite(e).all()
    for stat in (np.median, np.mean):
        assert abs(stat(e) - stat(r)) <= 0.10 * abs(stat(r)), (e, r)
