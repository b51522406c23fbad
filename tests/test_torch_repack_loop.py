"""The port's in-loop repack switch (REPACK_IN_LOOP, relax round 2's
fa_stage) against the JAX package's, on the CPU.

_fa_weighted_fun's value and gradient agree with JAX's in float64 within
1e-8 relative. The protocol with the switch on (centroid stage, both relax
rounds with the cartesian block, round 2 as fa_stage) at 3 iterations per
stage agrees with JAX's in float64 within 1e-5, as the switch-off protocol
test does. A 2-decoy fold_ensemble at L=12 with the switch on in both
packages, schedules shrunk (both packages' module constants patched), is
held in distribution: energies finite and below the start's centroid
energy, medians within 10 % of |median|. Every switch is restored by the
monkeypatch fixture.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from trx2dy.physics import compact as jcompact
from trx2dy.physics import energy as jenergy
from trx2dy.physics import folder as jfolder
from trx2dy.physics import restraints as jrst
from trx2dy.physics import sidechain as jside
from trx2dy_torch.physics import compact as tcompact
from trx2dy_torch.physics import energy as tenergy
from trx2dy_torch.physics import folder as tfolder
from trx2dy_torch.physics import minimize as tmin
from trx2dy_torch.physics import restraints as trst
from trx2dy_torch.physics import sidechain as tside

torch.set_num_threads(2)

SEQ = "ARCDNQEGHCLK"          # two CYS for the disulfide term, a GLY
L = len(SEQ)
B = 2
SHORT = ((0.02, 1.0, 3), (0.25, 0.5, 3), (0.55, 0.1, 3), (1.0, 0.1, 3))


def _rand_npz(L_, key=0):
    """tests/test_physics.py:_rand_npz."""
    rng = np.random.default_rng(key)

    def soft(shape):
        x = rng.random(shape).astype(np.float32)
        return x / x.sum(-1, keepdims=True)
    return {"dist": soft((L_, L_, 37)), "omega": soft((L_, L_, 25)),
            "theta": soft((L_, L_, 25)), "phi": soft((L_, L_, 13))}


def _helices(n, seed):
    rng = np.random.default_rng(seed)
    phi = np.deg2rad(-61.0) + rng.normal(0, 0.02, (n, L))
    psi = np.deg2rad(-41.0) + rng.normal(0, 0.02, (n, L))
    omg = np.pi + rng.normal(0, 0.01, (n, L))
    return np.stack([phi, psi, omg], axis=1)


def _f64(tree):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else a, tree)


def _pack64(pin):
    """JAX's packing constants (sidechain.pack_input) in float64."""
    return pin._replace(**{k: jnp.asarray(getattr(pin, k), jnp.float64)
                           for k in ("radii", "atom_mask", "chi_mask")})


def _rel(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.fixture
def shrunk(monkeypatch):
    """3 iterations per relax and cartesian stage in both packages."""
    for mod in (jfolder, tfolder):
        for name in ("RELAX_SCHEDULE_R1", "RELAX_SCHEDULE_R2",
                     "CART_SCHEDULE_R1"):
            monkeypatch.setattr(mod, name, SHORT)


@pytest.fixture
def repack_on(monkeypatch):
    """REPACK_IN_LOOP on in both packages, restored after the test."""
    for mod in (jfolder, tfolder):
        monkeypatch.setattr(mod, "REPACK_IN_LOOP", True)
    yield
    assert tfolder.REPACK_IN_LOOP and jfolder.REPACK_IN_LOOP


def test_switch_constants_match_jax():
    assert tfolder.REPACK_IN_LOOP is jfolder.REPACK_IN_LOOP is False
    assert tfolder.W_FA_CLASH == jfolder.W_FA_CLASH
    assert tfolder.REPACK_CHI_ITERS == jfolder.REPACK_CHI_ITERS


@pytest.mark.parametrize("ss", [False, True], ids=["no_ss", "ss_pair"])
def test_fa_weighted_fun_matches_jax_f64(ss):
    npz = _rand_npz(L, key=3)
    prst, jr = trst.compile_restraints(npz), jrst.compile_restraints(npz)
    pm = trst.restraint_masks(prst, SEQ, 1, L, pcut=0.30, nogly=True)
    jm = jrst.restraint_masks(jr, SEQ, 1, L, pcut=0.30, nogly=True)
    w = tenergy.weights_to_vec(tfolder._ramped_relax_weights(0.25, 0.5))
    rng = np.random.default_rng(4)
    x = _helices(B, seed=5).reshape(B, -1) \
        + rng.normal(0, 0.1, (B, 3 * L))
    chi = rng.uniform(-np.pi, np.pi, (B, L, 4))
    pairs = np.array([[2, 9]] if ss else np.zeros((0, 2)), np.int64)

    cr = tcompact.compact_to(tcompact.compact_restraints(prst, pm), L, "cpu",
                             torch.float64)
    wt = torch.from_numpy(w).double()
    fun = tfolder._fa_weighted_fun(
        lambda xx: tenergy.batched_energy_weighted_compact(xx, cr, wt),
        torch.from_numpy(chi), torch.from_numpy(pairs),
        tside.pack_input(SEQ, "cpu", torch.float64))
    xt = torch.from_numpy(x).requires_grad_(True)
    e = fun(xt)
    (g,) = torch.autograd.grad(e.sum(), xt)

    with jax.enable_x64(True):
        pin = _pack64(jside.pack_input(SEQ))
        jcr = jax.tree.map(jnp.asarray,
                           jcompact.compact_restraints(_f64(jr), jm))
        # lbfgs_init's value and gradient of _fa_weighted_fun, through the
        # program fa_stage calls, with its arguments: the no-ss case traces
        # it once for this test and test_repack_protocol_matches_jax_f64
        st = jfolder._fa_init_jit(
            jnp.asarray(x), jcr, None, jnp.asarray(w), jnp.asarray(chi),
            jnp.asarray(pairs, jnp.int32), pin, jnp.zeros((B,), bool),
            False, None)
        je, jg = np.asarray(st.f), np.asarray(st.g)
    assert _rel(e.detach(), je) < 1e-8
    assert _rel(g, jg) < 1e-8
    # the clash term is there: the relax energy alone differs
    with torch.no_grad():
        base = tenergy.batched_energy_weighted_compact(
            torch.from_numpy(x), cr, wt)
    assert float((e.detach() - base).abs().min()) > 0


def test_repack_protocol_matches_jax_f64(shrunk):
    """The protocol with round 2 as fa_stage, float64, 3 iterations per
    stage, without the round-1 cartesian block (JAX compiles less): final
    torsions and energies match JAX. As in JAX, fa_stage
    starts its L-BFGS with every lane frozen, so round 2 leaves round 1's
    torsions unchanged (each stage still packs and evaluates once)."""
    npz = _rand_npz(L, key=3)
    prst, jr = trst.compile_restraints(npz), jrst.compile_restraints(npz)
    x0 = _helices(B, seed=7).reshape(B, -1)
    stage = [trst.restraint_masks(prst, SEQ, 1, L)]
    r1, r2 = (trst.restraint_masks(prst, SEQ, 1, L, pcut=pc, nogly=True)
              for pc in (0.15, 0.30))

    def dev(m):
        return tcompact.compact_to(tcompact.compact_restraints(prst, m), L,
                                   "cpu", torch.float64)
    pack = (tside.pack_input(SEQ, "cpu", torch.float64),
            torch.zeros((0, 2), dtype=torch.int64))
    log = []
    tmin.STATS.reset()
    x, f = tfolder._protocol_staged(
        torch.from_numpy(x0), [dev(m) for m in stage], 3, stage_log=log,
        relax=(dev(r1), dev(r2)), pack=pack)
    assert tmin.STATS.free_evals > 0         # the packing, restraint-free
    with jax.enable_x64(True):
        pin = _pack64(jside.pack_input(SEQ))
        jx, jf = jfolder._protocol_staged(
            jnp.asarray(x0), _f64(jr), stage, r1, r2, fastrelax=True,
            max_iter=3, dist_on_ca=False,
            pack_args=(pin, jnp.zeros((0, 2), jnp.int32)))
        jx, jf = np.asarray(jx), np.asarray(jf)
    assert _rel(f, jf) < 1e-5
    assert np.abs(x.numpy() - jx).max() < 1e-5 * max(1.0, np.abs(jx).max())
    fa = [(lab, it) for lab, it, _ in log if lab == "relax2_fa"]
    assert len(fa) == 4 * tfolder.RELAX_REPEATS
    assert all(it == 0 for _, it in fa)
    assert "relax2" not in {lab for lab, _, _ in log}


def test_fold_ensemble_repack_matches_jax_distributionally(
        shrunk, repack_on, monkeypatch):
    """fold_ensemble with the switch on, FastRelax without the cartesian
    stages (cart_refine=False; they do not touch the switch, and JAX's
    compiles of them would double the test's time). JAX's fold_ensemble
    runs its staged protocol in float64, its tables and packing constants
    cast as test_repack_protocol_matches_jax_f64 casts them: at this L, B
    and schedule the two calls' programs are the same (every pair list
    fills one bucket), so a process traces them once."""
    protocol = jfolder._protocol_staged

    def protocol_f64(x0, rst, *args, pack_args, **kwargs):
        pin, ss = pack_args
        return protocol(jnp.asarray(x0, jnp.float64), _f64(rst), *args,
                        pack_args=(_pack64(pin), ss), **kwargs)

    monkeypatch.setattr(jfolder, "_protocol_staged", protocol_f64)
    npz = _rand_npz(L, key=9)
    x0 = _helices(B, seed=8).astype(np.float32)
    with jax.enable_x64(True):
        ref = jfolder.fold_ensemble(npz, SEQ, jax.random.PRNGKey(0),
                                    n_decoys=B, max_iter=3,
                                    x0=jnp.asarray(x0), cart_refine=False)
        e_ref = np.asarray(ref.energy)
    log = []
    tmin.STATS.reset()
    port = tfolder.fold_ensemble(npz, SEQ, None, n_decoys=B, max_iter=3,
                                 x0=x0, cart_refine=False, device="cpu",
                                 stage_log=log)
    e = port.energy.numpy()
    rst = trst.compile_restraints(npz)
    (m,) = tfolder._stage_masks_centroid(rst, SEQ, 2, 0.05)
    cr = tcompact.compact_to(tcompact.compact_restraints(rst, m), L, "cpu")
    with torch.no_grad():
        start = tenergy.batched_energy_weighted_compact(
            torch.from_numpy(x0.reshape(B, -1)), cr, torch.from_numpy(
                tenergy.weights_to_vec(tenergy.SCOREFXN_CENT))).numpy()
    assert np.isfinite(e).all() and (e < start).all()
    assert (e_ref < start).all()
    assert abs(np.median(e) - np.median(e_ref)) <= \
        0.1 * abs(np.median(e_ref))
    labels = [lab for lab, _, _ in log]
    assert labels.count("relax2_fa") == 4 * tfolder.RELAX_REPEATS
    assert "relax2" not in labels and "relax1" in labels
    assert tmin.STATS.evals > 0 and tmin.STATS.free_evals > 0
    ca = port.atoms["CA"].numpy()
    d = np.linalg.norm(np.diff(ca, axis=1), axis=-1)
    assert (d < 4.2).all() and (d > 2.7).all()
