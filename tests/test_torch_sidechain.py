"""The port's sidechain packing (AF2 constants, rigid frames, atom14 build,
pack energies, packing) and full-atom PDB writer against the JAX package,
on the CPU.

Torsions, chi and coordinates are made with numpy from seeds and handed to
both packages. Energy values are compared in float32 within 1e-5
relative, gradients in float64 within 1e-8; a short chi L-BFGS runs in
float64 in both packages. JAX programs are compiled once per module.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from trx2dy.geometry import rigid as jrigid
from trx2dy.io import pdbio as jpdbio
from trx2dy.models import constants as jrc
from trx2dy.models import structure_module as jsm
from trx2dy.physics import folder as jfolder
from trx2dy.physics import sidechain as jsc
from trx2dy_torch.geometry import nerf as tnerf
from trx2dy_torch.geometry import rigid as trigid
from trx2dy_torch.io import pdbio as tpdbio
from trx2dy_torch.models import constants as trc
from trx2dy_torch.models import structure_module as tsm
from trx2dy_torch.physics import minimize as tmin
from trx2dy_torch.physics import sidechain as tsc

torch.set_num_threads(2)

SEQ = "MKCAYWAKCRHISFVEPG"        # 18 aa, every chi count, two CYS
L = len(SEQ)
B = 3


def _rel(port, ref, scale=None):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    s = np.abs(ref).max() if scale is None else scale
    return np.abs(port - ref).max() / max(s, 1e-30)


def _torsions(n, seed):
    """(n, 3, L) basin torsions with 15 deg noise, omega near 180 deg."""
    rng = np.random.default_rng(seed)
    basin = rng.choice(6, size=(n, L), p=jfolder._BASIN_P)
    noise = rng.normal(0.0, np.deg2rad(15.0), (2, n, L))
    phi = jfolder._BASIN_PHI[basin] + noise[0]
    psi = jfolder._BASIN_PSI[basin] + noise[1]
    omg = np.pi + rng.normal(0.0, np.deg2rad(5.0), (n, L))
    return np.stack([phi, psi, omg], axis=1).astype(np.float32)


def _chi(n, seed):
    return np.random.default_rng(seed).uniform(
        -np.pi, np.pi, (n, L, 4)).astype(np.float32)


def _pin_jax(dt=jnp.float32):
    pin = jsc.pack_input(SEQ)
    return pin._replace(radii=pin.radii.astype(dt),
                        atom_mask=pin.atom_mask.astype(dt),
                        chi_mask=pin.chi_mask.astype(dt))


@pytest.fixture(scope="module")
def inputs():
    t = _torsions(B, seed=1)
    tt = torch.from_numpy(t)
    atoms = tnerf.build_backbone(tt[:, 0], tt[:, 1], tt[:, 2])
    # a displaced backbone, as the cartesian refinement leaves it
    rng = np.random.default_rng(2)
    moved = {k: v.numpy() + rng.normal(0, 0.05, v.shape).astype(np.float32)
             for k, v in atoms.items()}
    return t, _chi(B, seed=3), moved


# --------------------------------------------------- constants and frames

def test_constants_copy_is_exact():
    with np.load(jrc._DATA) as a, np.load(trc._DATA) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    for name in ("restypes", "restype_3", "atom_types", "restype_order",
                 "restype_num", "unk_restype_index", "van_der_waals_radius"):
        assert getattr(trc, name) == getattr(jrc, name), name
    for name in ("atom14_names", "chi_angles_mask", "chi_pi_periodic",
                 "restype_rigid_group_default_frame",
                 "restype_atom14_to_rigid_group", "restype_atom14_mask",
                 "restype_atom14_rigid_group_positions",
                 "restype_atom37_mask"):
        a, b = getattr(trc, name), getattr(jrc, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.array_equal(trc.sequence_to_aatype(SEQ + "XB"),
                          jrc.sequence_to_aatype(SEQ + "XB"))


def test_rigid_and_frames_match_jax(inputs):
    t, chi, moved = inputs
    n, ca, c = (moved[k][0] for k in ("N", "CA", "C"))
    bb_t = trigid.make_transform_from_reference(
        *(torch.from_numpy(a) for a in (n, ca, c)))
    bb_j = jrigid.make_transform_from_reference(
        *(jnp.asarray(a) for a in (n, ca, c)))
    assert _rel(bb_t.rot, bb_j.rot) < 1e-6
    rng = np.random.default_rng(4)
    m4 = rng.standard_normal((5, 4, 4)).astype(np.float32)
    pts = rng.standard_normal((5, 3)).astype(np.float32)
    a_t, a_j = (trigid.rigid_from_tensor_4x4(torch.from_numpy(m4)),
                jrigid.rigid_from_tensor_4x4(jnp.asarray(m4)))
    comp_t = trigid.rigid_compose(a_t, bb_t._replace(rot=bb_t.rot[:5],
                                                    trans=bb_t.trans[:5]))
    comp_j = jrigid.rigid_compose(a_j, jrigid.Rigid(bb_j.rot[:5],
                                                    bb_j.trans[:5]))
    assert _rel(comp_t.rot, comp_j.rot) < 1e-6
    assert _rel(comp_t.trans, comp_j.trans) < 1e-6
    assert _rel(trigid.rigid_apply(comp_t, torch.from_numpy(pts)),
                jrigid.rigid_apply(comp_j, jnp.asarray(pts))) < 1e-6
    # torsion -> frames -> atom14 over a decoy axis, against JAX per decoy
    aatype = trc.sequence_to_aatype(SEQ)
    alpha = rng.standard_normal((B, L, 7, 2)).astype(np.float32)
    alpha /= np.linalg.norm(alpha, axis=-1, keepdims=True)
    bb_b = trigid.make_transform_from_reference(
        *(torch.from_numpy(moved[k]) for k in ("N", "CA", "C")))
    fr = tsm.torsion_angles_to_frames(bb_b, torch.from_numpy(alpha),
                                      torch.from_numpy(aatype).long())
    xyz, mask = tsm.frames_to_atom14(fr, torch.from_numpy(aatype).long())

    @jax.jit
    @jax.vmap
    def ref(n, ca, c, al):
        fr_j = jsm.torsion_angles_to_frames(
            jrigid.make_transform_from_reference(n, ca, c), al,
            jnp.asarray(aatype))
        return fr_j, jsm.frames_to_atom14(fr_j, jnp.asarray(aatype))
    fr_j, (xyz_j, mask_j) = ref(*(jnp.asarray(moved[k])
                                  for k in ("N", "CA", "C")),
                                jnp.asarray(alpha))
    assert _rel(fr.rot, fr_j.rot) < 1e-5
    assert _rel(fr.trans, fr_j.trans) < 1e-5
    assert _rel(xyz, xyz_j) < 1e-5
    assert np.array_equal(mask.numpy(), np.asarray(mask_j[0]))


@pytest.mark.parametrize("on_backbone", [False, True])
def test_atom14_from_torsions_matches_jax(inputs, on_backbone):
    t, chi, moved = inputs
    pin_t = tsc.pack_input(SEQ)
    pin_j = jsc.pack_input(SEQ)
    bb_t = {k: torch.from_numpy(v) for k, v in moved.items()} \
        if on_backbone else None
    bb_j = {k: jnp.asarray(v) for k, v in moved.items()} \
        if on_backbone else None
    xyz, mask, atoms = tsc.atom14_from_torsions(
        torch.from_numpy(t), torch.from_numpy(chi), pin_t, False, bb_t)
    xyz_j, mask_j, _ = jax.jit(jax.vmap(
        lambda tt, c, bb: jsc.atom14_from_torsions(tt, c, pin_j, False, bb),
        in_axes=(0, 0, None if bb_j is None else 0)))(
        jnp.asarray(t), jnp.asarray(chi), bb_j)
    assert np.abs(xyz.numpy() - np.asarray(xyz_j)).max() < 1e-4
    assert np.array_equal(mask.numpy(), np.asarray(mask_j[0]))
    # pinned: the backbone slots are the atoms, the rest unchanged
    pinned, _, _ = tsc.atom14_from_torsions(
        torch.from_numpy(t), torch.from_numpy(chi), pin_t, True, bb_t)
    for name, slot in tsc._BB_SLOTS.items():
        assert torch.equal(pinned[:, :, slot], atoms[name])
    assert torch.equal(pinned[:, :, 4:], xyz[:, :, 4:])


def test_detect_disulfides_matches_jax():
    rng = np.random.default_rng(5)
    seq = "CACCAACAC"
    cb = rng.uniform(0, 6, (len(seq), 3))
    cb[2] = cb[0] + [3.0, 0.0, 0.0]          # pairs within the cutoff
    cb[6] = cb[3] + [0.0, 2.0, 2.0]
    for cutoff in (3.5, 4.5, 20.0):
        got = tsc.detect_disulfides(cb, seq, cutoff)
        want = jsc.detect_disulfides(cb, seq, cutoff)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len(tsc.detect_disulfides(cb, seq)) >= 2
    assert tsc.detect_disulfides(cb[:3], "AAA").shape == (0, 2)


# ------------------------------------------------------------ energies

@pytest.fixture(scope="module")
def jax_pack_vg():
    """(chi, torsions, pairs, backbone, dtype) -> JAX's per-decoy pack
    energies on that backbone, their clash/rotamer/disulfide parts, and
    the gradient of the energies' sum; one jitted program per dtype."""
    progs = {}

    def parts(chi_flat, t, pairs, pin, bb):
        chi = chi_flat.reshape(L, 4)
        xyz, _, _ = jsc.atom14_from_torsions(t, chi, pin, backbone=bb)
        return jnp.stack([jsc._clash_energy(xyz, pin),
                          jsc._rotamer_energy(chi, pin),
                          jsc._disulfide_energy(xyz, pairs, pin)])

    def call(chi, t, pairs, bb, dt):
        if dt not in progs:
            def run(chi_flat, t, pairs, bb):
                pin = _pin_jax(chi_flat.dtype)
                e, g = jax.vmap(jax.value_and_grad(jsc._pack_energy),
                                in_axes=(0, 0, None, None, 0))(
                    chi_flat, t, pairs, pin, bb)
                p = jax.vmap(parts, in_axes=(0, 0, None, None, 0))(
                    chi_flat, t, pairs, pin, bb)
                return e, g, p
            progs[dt] = jax.jit(run)
        with jax.enable_x64(dt == np.float64):
            out = progs[dt](jnp.asarray(chi.reshape(B, -1), dt),
                            jnp.asarray(t, dt), jnp.asarray(pairs),
                            {k: jnp.asarray(v, dt) for k, v in bb.items()})
            return tuple(np.asarray(o) for o in out)
    return call


PAIRS = np.array([[2, 8]], np.int32)


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_pack_energies_match_jax(inputs, jax_pack_vg, prec):
    """The energies on the displaced backbone, as the fold packs (the NeRF
    build of the torsions is held to JAX in test_torch_energy.py)."""
    t, chi, bb = inputs
    dt, tdt = {"f32": (np.float32, torch.float32),
               "f64": (np.float64, torch.float64)}[prec]
    pin = tsc.pack_input(SEQ, "cpu", tdt)
    bb_t = {k: torch.as_tensor(v, dtype=tdt) for k, v in bb.items()}
    tt = torch.as_tensor(t, dtype=tdt)
    x = torch.as_tensor(chi.reshape(B, -1), dtype=tdt).requires_grad_()
    pairs = torch.as_tensor(PAIRS, dtype=torch.int64)
    e = tsc._pack_energy(x, tt, pairs, pin, bb_t)
    e.sum().backward()
    chi_t = x.detach().reshape(B, L, 4)
    xyz, _, _ = tsc.atom14_from_torsions(tt, chi_t, pin, backbone=bb_t)
    parts = torch.stack([tsc._clash_energy(xyz, pin),
                         tsc._rotamer_energy(chi_t, pin),
                         tsc._disulfide_energy(xyz, pairs, pin)], -1)
    ref_e, ref_g, ref_p = jax_pack_vg(chi, t, PAIRS, bb, dt)
    assert ref_p[:, 0].min() > 0 and ref_p[:, 2].min() > 0   # terms active
    tol = 1e-5 if prec == "f32" else 1e-8
    assert _rel(e.detach(), ref_e) < tol
    for k in range(3):
        assert _rel(parts[:, k], ref_p[:, k]) < tol, k
    if prec == "f64":
        assert _rel(x.grad, ref_g) < 1e-8


def test_pack_lbfgs_matches_jax_f64(inputs):
    """Five chi L-BFGS iterations from the staggered start, float64 in both
    packages: the packed atom14 and energies agree."""
    t, _, moved = inputs
    it = 5
    pin_t = tsc.pack_input(SEQ, "cpu", torch.float64)
    chi0 = np.pi * np.broadcast_to(trc.chi_angles_mask[
        trc.sequence_to_aatype(SEQ)], (B, L, 4)).astype(np.float64)
    xyz, mask, chi, f = tsc._pack(
        torch.from_numpy(t.astype(np.float64)), torch.from_numpy(chi0),
        torch.from_numpy(PAIRS.astype(np.int64)), pin_t, it,
        {k: torch.from_numpy(v.astype(np.float64)) for k, v in moved.items()})
    with jax.enable_x64(True):
        ref = jsc._pack_jit(jnp.asarray(t, jnp.float64),
                            jnp.asarray(chi0), jnp.asarray(PAIRS),
                            _pin_jax(jnp.float64), max_iter=it,
                            backbone={k: jnp.asarray(v, jnp.float64)
                                      for k, v in moved.items()})
        ref = tuple(np.asarray(r) for r in ref)
    assert _rel(f, ref[3]) < 1e-5
    assert _rel(chi, ref[2], 1.0) < 1e-5
    assert _rel(xyz, ref[0]) < 1e-5
    assert np.array_equal(mask.numpy(), ref[1][0])


def test_pack_ensemble_keeps_backbone_and_lowers_clash(inputs):
    t, _, moved = inputs
    bb = {k: torch.from_numpy(v) for k, v in moved.items()}
    tmin.STATS.reset()
    xyz, mask, chi = tsc.pack_ensemble(torch.from_numpy(t), SEQ, max_iter=40,
                                       backbone=bb, device="cpu")
    assert tmin.STATS.evals == 0 and tmin.STATS.free_evals > 0
    assert xyz.shape == (B, L, 14, 3) and mask.shape == (L, 14)
    assert bool(torch.isfinite(xyz).all())
    for name, slot in tsc._BB_SLOTS.items():
        assert torch.equal(xyz[:, :, slot], bb[name])
    pin = tsc.pack_input(SEQ)
    chi0 = torch.full((B, L, 4), np.pi) * pin.chi_mask
    start, _, _ = tsc.atom14_from_torsions(torch.from_numpy(t), chi0, pin,
                                           backbone=bb)
    assert (tsc._clash_energy(xyz, pin)
            <= tsc._clash_energy(start, pin) + 1e-4).all()
    # chi of absent groups stay at 0 (masked start), CYS pair within reach
    assert bool((chi[:, pin.chi_mask == 0] == 0).all())


# ------------------------------------------------------------- writer

def test_write_pdb_atom14_byte_identical(inputs, tmp_path):
    t, chi, _ = inputs
    pin = tsc.pack_input(SEQ)
    xyz, mask, _ = tsc.atom14_from_torsions(torch.from_numpy(t),
                                            torch.from_numpy(chi), pin)
    # an unknown residue last; a non-finite coordinate is written clipped
    seq = SEQ + "X"
    xyz = np.concatenate([xyz[0].numpy(), xyz[0, :1].numpy()])
    xyz[3, 5] = np.nan
    mask = np.concatenate([mask.numpy(), np.ones((1, 14), np.float32)])
    for kw in ({}, {"atom14_mask": mask, "plddt": np.linspace(0, 1, L + 1),
                    "chain": "B"}):
        tpdbio.write_pdb_atom14(str(tmp_path / "p.pdb"), seq, xyz, **kw)
        jpdbio.write_pdb_atom14(str(tmp_path / "j.pdb"), seq, xyz, **kw)
        assert (tmp_path / "p.pdb").read_bytes() == \
            (tmp_path / "j.pdb").read_bytes()
