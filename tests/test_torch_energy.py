"""The port's geometry, restraint compilation and energies against the JAX
package, on the CPU.

Inputs are made with numpy from seeds and handed to both packages. The
spline kernels take their plain versions here; the JAX fused path runs its
Pallas kernel in interpret mode.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import trx2dy.ops.spline_energy as jops
from trx2dy.geometry import nerf as jnerf
from trx2dy.geometry import transforms as jtf
from trx2dy.physics import compact as jcompact
from trx2dy.physics import energy as jenergy
from trx2dy.physics import folder as jfolder
from trx2dy.physics import restraints as jrst
from trx2dy_torch.geometry import nerf as tnerf
from trx2dy_torch.geometry import transforms as ttf
from trx2dy_torch.physics import compact as tcompact
from trx2dy_torch.physics import energy as tenergy
from trx2dy_torch.physics import folder as tfolder
from trx2dy_torch.physics import restraints as trst

torch.set_num_threads(2)

SEQ = "ARNDCQEGHILKMFPSTWYVACDE"
SCOREFXNS = ("SCOREFXN_CENT", "SCOREFXN1", "SCOREFXN_VDW", "SCOREFXN_CART")


def _rand_npz(L, key=0):
    """tests/test_physics.py:_rand_npz."""
    rng = np.random.default_rng(key)

    def soft(shape):
        x = rng.random(shape).astype(np.float32)
        return x / x.sum(-1, keepdims=True)
    return {"dist": soft((L, L, 37)), "omega": soft((L, L, 25)),
            "theta": soft((L, L, 25)), "phi": soft((L, L, 13))}


def _torsions(B, L, seed):
    """(B, 3, L) basin torsions with 20 deg noise, omega near 180 deg."""
    rng = np.random.default_rng(seed)
    basin = rng.choice(6, size=(B, L), p=jfolder._BASIN_P)
    noise = rng.normal(0.0, np.deg2rad(20.0), (2, B, L))
    phi = jfolder._BASIN_PHI[basin] + noise[0]
    psi = jfolder._BASIN_PSI[basin] + noise[1]
    omg = np.pi + rng.normal(0.0, np.deg2rad(5.0), (B, L))
    return np.stack([phi, psi, omg], axis=1).astype(np.float32)


def _rel(port, ref, scale=None):
    """max |port - ref| over max(|ref|) (or the given scale)."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    s = np.abs(ref).max() if scale is None else scale
    return np.abs(port - ref).max() / max(s, 1e-30)



@jax.jit
def _atoms_jax(t):
    return jax.vmap(lambda tt: jnerf.build_backbone(tt[0], tt[1], tt[2]))(t)


# ---------------------------------------------------------------- geometry

def test_build_backbone_matches_jax():
    t = _torsions(3, 32, seed=1)
    ref = _atoms_jax(jnp.asarray(t))
    tt = torch.from_numpy(t).requires_grad_(True)
    port = tnerf.build_backbone(tt[:, 0], tt[:, 1], tt[:, 2])
    for a in ("N", "CA", "C", "O", "CB"):
        assert np.abs(port[a].detach().numpy()
                      - np.asarray(ref[a])).max() < 1e-4   # Angstrom
    # gradients of a weighted coordinate sum
    w = np.random.default_rng(2).standard_normal((3, 32, 3)).astype(np.float32)
    sum(torch.sum(port[a] * torch.from_numpy(w) * k)
        for k, a in enumerate(("N", "CA", "C", "O", "CB"), 1)).backward()
    ref_g = jax.jit(jax.grad(lambda x: sum(
        jnp.sum(_atoms_jax(x)[a] * w * k)
        for k, a in enumerate(("N", "CA", "C", "O", "CB"), 1))))(
        jnp.asarray(t))
    assert _rel(tt.grad, ref_g) < 1e-4


def test_prefix_compose_matches_sequential_product():
    rng = np.random.default_rng(3)
    rot = torch.from_numpy(rng.standard_normal((2, 11, 3, 3)))
    tsl = torch.from_numpy(rng.standard_normal((2, 11, 3)))
    cr, ct = tnerf.prefix_compose(rot, tsl)
    r, t = rot[:, 0], tsl[:, 0]
    for i in range(1, 11):
        t = (r @ tsl[:, i, :, None])[..., 0] + t
        r = r @ rot[:, i]
        assert torch.allclose(cr[:, i], r) and torch.allclose(ct[:, i], t)


def test_transforms_match_jax():
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((4, 7, 3)).astype(np.float32) * 3
    tp = [torch.from_numpy(p) for p in pts]
    jp = [jnp.asarray(p) for p in pts]
    assert _rel(ttf.dihedral(*tp), jtf.dihedral(*jp)) < 1e-5
    assert _rel(ttf.bond_angle(*tp[:3]), jtf.bond_angle(*jp[:3])) < 1e-5
    assert _rel(ttf.virtual_cb(*tp[:3]), jtf.virtual_cb(*jp[:3])) < 1e-5
    t = _torsions(1, 20, seed=5)[0]
    atoms = {k: np.asarray(v) for k, v in
             jnerf.build_backbone(*jnp.asarray(t)).items()}
    n, ca, c = (atoms[k] for k in ("N", "CA", "C"))
    port = ttf.geometry_maps_6d(*(torch.from_numpy(a) for a in (n, ca, c)))
    ref = jtf.geometry_maps_6d(jnp.asarray(n), jnp.asarray(ca),
                               jnp.asarray(c))
    for k in ("dist", "omega", "theta", "phi"):
        assert np.abs(port[k].numpy() - np.asarray(ref[k])).max() < 1e-4
    (pt, pm) = ttf.backbone_torsions(*(torch.from_numpy(a)
                                       for a in (n, ca, c)))
    (rt, rm) = jtf.backbone_torsions(jnp.asarray(n), jnp.asarray(ca),
                                     jnp.asarray(c))
    for a, b in zip(pt, rt):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-4
    for a, b in zip(pm, rm):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------- terms

@pytest.fixture(scope="module")
def atoms16():
    t = _torsions(3, 16, seed=6)
    tt = torch.from_numpy(t)
    return t, tnerf.build_backbone(tt[:, 0], tt[:, 1], tt[:, 2]), \
        _atoms_jax(jnp.asarray(t))


def test_energy_terms_match_jax(atoms16):
    t, port, ref = atoms16
    res_mask = np.arange(16) < 13
    for rm in (None, res_mask):
        trm = None if rm is None else torch.from_numpy(rm)
        jrm = None if rm is None else jnp.asarray(rm)
        cases = [
            (tenergy.vdw_energy(port, trm),
             jax.vmap(lambda a: jenergy.vdw_energy(a, jrm))(ref)),
            (tenergy.rama_energy(torch.from_numpy(t[:, 0]),
                                 torch.from_numpy(t[:, 1]), trm),
             jax.vmap(lambda p, s: jenergy.rama_energy(p, s, jrm))(
                 t[:, 0], t[:, 1])),
            (tenergy.omega_planarity_energy(torch.from_numpy(t[:, 2]), trm),
             jax.vmap(lambda o: jenergy.omega_planarity_energy(o, jrm))(
                 t[:, 2])),
            (tenergy.hbond_energy(port, 2.0, 3.0, trm),
             jax.vmap(lambda a: jenergy.hbond_energy(a, 2.0, 3.0, jrm))(ref)),
        ]
        for got, want in cases:
            assert _rel(got, want, max(1.0, np.abs(want).max())) < 1e-5


def test_pairwise_geometry_matches_jax(atoms16):
    _, _, ref = atoms16
    # the same atoms into both: dihedrals amplify coordinate rounding
    got = tenergy.pairwise_geometry(
        {k: torch.from_numpy(np.array(v)) for k, v in ref.items()})
    want = jax.vmap(jenergy.pairwise_geometry)(ref)
    off = ~np.eye(16, dtype=bool)
    for k in ("dist", "omega", "theta", "phi"):
        diff = np.abs(got[k].numpy() - np.asarray(want[k]))[:, off]
        assert diff.max() < 1e-4, k


# ------------------------------------------------- restraint compilation

def test_compile_restraints_and_masks_bit_equal():
    npz = _rand_npz(12, key=8)
    seq = SEQ[:12]
    for orient in (True, False):
        port = trst.compile_restraints(npz, use_orient=orient)
        ref = jrst.compile_restraints(npz, use_orient=orient)
        for a, b in zip(jax.tree.leaves(tuple(port)),
                        jax.tree.leaves(tuple(ref))):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        for args in ((1, 12, 0.05, False), (3, 24, 0.15, True)):
            pm = trst.restraint_masks(port, seq, *args)
            rm = jrst.restraint_masks(ref, seq, *args)
            for a, b in zip(pm, rm):
                assert np.array_equal(a, np.asarray(b))
        pc = tcompact.compact_restraints(port, pm)
        rc = jcompact.compact_restraints(ref, rm)
        for a, b in zip(jax.tree.leaves(tuple(pc)),
                        jax.tree.leaves(tuple(rc))):
            assert a.dtype == np.asarray(b).dtype
            assert np.array_equal(a, np.asarray(b))
    assert all(np.array_equal(a, b) for a, b in zip(
        (trst.dist_knots(), trst.torsion_knots(), trst.planar_knots()),
        (jrst.dist_knots(), jrst.torsion_knots(), jrst.planar_knots())))


def test_disulfide_restraints_bit_equal():
    L = 12
    seq = "ACAAACAAAACA"
    npz = _rand_npz(L, key=9)
    d = npz["dist"].copy()
    d[1, 5] = d[5, 1] = 0.0
    d[1, 5, 4] = d[5, 1, 4] = 1.0          # 4.25 A mode, contact 1
    npz["dist"] = d
    pp = trst.disulfide_pairs(d, seq)
    rp = jrst.disulfide_pairs(d, seq)
    assert np.array_equal(pp, rp) and len(pp)
    port = trst.add_disulfide_restraints(trst.compile_restraints(npz), pp)
    ref = jrst.add_disulfide_restraints(jrst.compile_restraints(npz), rp)
    for a, b in zip(jax.tree.leaves(tuple(port)),
                    jax.tree.leaves(tuple(ref))):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_bucket_ladders_equal():
    ns = list(range(0, 5000, 37)) + [512, 513, 768, 769, 1024, 1025]
    assert [tcompact._bucket(n) for n in ns] == \
        [jcompact._bucket(n) for n in ns]
    assert [tfolder._bucket_size(n) for n in range(0, 300)] == \
        [jfolder._bucket_size(n) for n in range(0, 300)]


# ---------------------------------------------------- batched energies
#
# Values are compared in float32, the working type, within 1e-4 relative.
# Gradients are compared in float64 on both sides within 1e-8 relative:
# in float32 the dense dihedral and angle terms make them ill-conditioned
# at clashing random starts (there the JAX package's own float32 gradient
# departs from its float64 one about as far as the two packages differ),
# so float32 gradients are held only to 1e-2.

L16 = 16
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64,
                                                      torch.float64)}
GRAD_TOL = {"f32": 1e-2, "f64": 1e-8}
VALUE_TOL = {"f32": 1e-4, "f64": 1e-8}


@pytest.fixture(scope="module")
def restraints16():
    npz = _rand_npz(L16, key=3)
    seq = SEQ[:L16]
    prst = trst.compile_restraints(npz)
    jr = jrst.compile_restraints(npz)
    pmasks = trst.restraint_masks(prst, seq, 1, L16)
    jmasks = jrst.restraint_masks(jr, seq, 1, L16)
    return prst, jr, pmasks, jmasks


def _cast(tree, dt):
    """Every floating leaf as a jax array of dt, the rest as jax arrays."""
    return jax.tree.map(
        lambda a: jnp.asarray(a, dt) if np.issubdtype(np.asarray(a).dtype,
                                                      np.floating)
        else jnp.asarray(a), tree)


@pytest.fixture(scope="module")
def jax_vg(restraints16):
    """call(name, x, w, prec, *args) -> JAX energies and the gradient of
    their weighted sum, in prec; one jitted program per path and type."""
    _, jr, _, jmasks = restraints16
    jcr = jcompact.compact_restraints(jr, jmasks)
    orig = jops.spline_energy_batch

    def interpret(y, m, xk, q, mask):
        # the Pallas kernel in interpret mode, as the CPU tests run it
        return orig(y, m, xk, q, mask, True)

    def jitted(energy):
        def run(x, w, *args):
            val, pullback = jax.vjp(lambda a: energy(a, w, *args), x)
            return val, pullback(jnp.arange(1.0, 4.0, dtype=x.dtype))[0]
        return jax.jit(run)

    fns = {
        "compact": jitted(
            lambda a, w, rm: jenergy.batched_energy_weighted_compact(
                a, _cast(jcr, a.dtype), w, res_mask=rm)),
        "fused": jitted(lambda a, w: jenergy.batched_energy_fused(
            a, _cast(jr, a.dtype), _cast(jmasks, bool), w)),
    }

    def call(name, x, w, prec, *args):
        dt = DTYPES[prec][0]
        jops.spline_energy_batch = interpret
        try:
            with jax.enable_x64(prec == "f64"):
                val, g = fns[name](jnp.asarray(x, dt), jnp.asarray(w, dt),
                                   *args)
                return np.asarray(val), np.asarray(g)
        finally:
            jops.spline_energy_batch = orig
    return call


def _port_vg(energy, x, w, prec):
    tdt = DTYPES[prec][1]
    xt = torch.as_tensor(x, dtype=tdt).requires_grad_(True)
    e = energy(xt, torch.as_tensor(w, dtype=tdt))
    (e * torch.arange(1.0, 4.0, dtype=tdt)).sum().backward()
    return e.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("scorefxn", SCOREFXNS)
def test_batched_compact_matches_jax(restraints16, jax_vg, scorefxn, masked,
                                     prec):
    prst, _, pmasks, _ = restraints16
    x = _torsions(3, L16, seed=10).reshape(3, -1)
    w = tenergy.weights_to_vec(getattr(tenergy, scorefxn))
    rm = np.arange(L16) < (13 if masked else L16)
    cr = tcompact.compact_to(tcompact.compact_restraints(prst, pmasks), L16,
                             "cpu", DTYPES[prec][1])
    e, g = _port_vg(lambda xx, ww: tenergy.batched_energy_weighted_compact(
        xx, cr, ww, res_mask=torch.from_numpy(rm)), x, w, prec)
    ref_e, ref_g = jax_vg("compact", x, w, prec, jnp.asarray(rm))
    assert _rel(e, ref_e) < VALUE_TOL[prec]
    assert _rel(g, ref_g) < GRAD_TOL[prec]


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("scorefxn", SCOREFXNS)
def test_batched_fused_matches_jax(restraints16, jax_vg, scorefxn, prec):
    prst, _, pmasks, _ = restraints16
    x = _torsions(3, L16, seed=11).reshape(3, -1)
    w = tenergy.weights_to_vec(getattr(tenergy, scorefxn))
    tdt = DTYPES[prec][1]
    rt = trst.tables_to(prst, "cpu", tdt)
    mt = trst.masks_to(pmasks, "cpu")
    e, g = _port_vg(lambda xx, ww: tenergy.batched_energy_fused(
        xx, rt, mt, ww), x, w, prec)
    ref_e, ref_g = jax_vg("fused", x, w, prec)
    assert _rel(e, ref_e) < VALUE_TOL[prec]
    assert _rel(g, ref_g) < GRAD_TOL[prec]
    # the dense per-decoy path (pose_energy_weighted) gives the same values
    t = torch.as_tensor(x.reshape(3, 3, L16), dtype=tdt)
    dense = torch.stack([tenergy.pose_energy_weighted(
        t[b], rt, mt, torch.as_tensor(w, dtype=tdt)) for b in range(3)])
    assert _rel(dense, ref_e) < VALUE_TOL[prec]


def test_gather_rows_backward_is_a_fixed_order_sum():
    idx = np.array([3, 0, 3, 1, 0, 4, 3, 0])
    rows = tcompact._rows(idx, 6, "cpu")
    a = torch.randn(6, 2, 9, dtype=torch.float64, requires_grad=True)
    g = torch.randn(8, 2, 9, dtype=torch.float64)
    out = tcompact.gather_rows(a, rows)
    assert torch.equal(out, a.index_select(0, torch.from_numpy(idx)))
    (out * g).sum().backward()
    want = torch.zeros(6, 2, 9, dtype=torch.float64).index_add_(
        0, torch.from_numpy(idx), g)
    assert torch.allclose(a.grad, want, rtol=0, atol=1e-12)
    assert (a.grad[2] == 0).all() and (a.grad[5] == 0).all()  # unused rows


def test_single_decoy_compact_energy_matches_jax(restraints16, atoms16):
    prst, jr, pmasks, jmasks = restraints16
    _, port, ref = atoms16
    cr = tcompact.compact_to(tcompact.compact_restraints(prst, pmasks), L16,
                             "cpu")
    jcr = jax.tree.map(jnp.asarray, jcompact.compact_restraints(jr, jmasks))
    for b in range(3):
        got = tcompact.compact_restraint_energy(
            {k: v[b] for k, v in port.items()}, cr, 5.0, 4.0, 4.0)
        want = jcompact.compact_restraint_energy(
            {k: v[b] for k, v in ref.items()}, jcr, 5.0, 4.0, 4.0)
        assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))


def test_pose_energy_matches_jax(restraints16):
    prst, jr, pmasks, jmasks = restraints16
    t = _torsions(1, L16, seed=12)[0]
    rt, mt = trst.tables_to(prst, "cpu"), trst.masks_to(pmasks, "cpu")
    for name in ("SCOREFXN_CENT", "SCOREFXN_VDW"):
        got = tenergy.pose_energy(torch.from_numpy(t), rt, mt,
                                  getattr(tenergy, name))
        want = jenergy.pose_energy(jnp.asarray(t), jr, jmasks,
                                   getattr(jenergy, name))
        assert abs(float(got) - float(want)) <= 1e-4 * abs(float(want))
