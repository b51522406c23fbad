"""The port's spline restraint energy against the JAX package, on the CPU.

On the CPU the port's kernel wrappers take their plain versions, so these
tests hold that arithmetic (the interval search, the cubic, the linear
extrapolation, the masking and the one-multiply backward) against the
Pallas kernel in interpret mode, spline.masked_spline_energy,
masked_spline_energy_pb and compact.compact_restraint_energy_batch. The
CUDA kernel has no CPU mode; chip_smoke.py holds its entries (the dense
and the pair entry, each four terms in one launch, and the lanes entry)
against float64 plain versions on the card.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from trx2dy.ops.spline_energy import (
    _spline_energy_fwd_pallas, spline_energy_batch,
)
from trx2dy.physics import compact as jcompact
from trx2dy.physics import restraints as jrst
from trx2dy.physics import spline as jspline
from trx2dy_torch.ops.spline_energy import (
    SplineDense, SplinePairs, _check_queries, spline_dense_plain,
    spline_dense_terms_plain, spline_energy_dense, spline_energy_dense_terms,
    spline_energy_pairs, spline_pairs_plain,
)
from trx2dy_torch.physics import compact as tcompact
from trx2dy_torch.physics import restraints as trst
from trx2dy_torch.physics import spline as tspline

torch.set_num_threads(2)

TOL = 1e-5
GRIDS = ("dist", "omega", "theta", "phi")


def _rand_npz(L, key=0):
    """tests/test_physics.py:_rand_npz."""
    rng = np.random.default_rng(key)

    def soft(shape):
        x = rng.random(shape).astype(np.float32)
        return x / x.sum(-1, keepdims=True)
    return {"dist": soft((L, L, 37)), "omega": soft((L, L, 25)),
            "theta": soft((L, L, 25)), "phi": soft((L, L, 13))}


@pytest.fixture(scope="module")
def tables():
    """The port's compiled restraint tables (all four knot grids)."""
    return trst.compile_restraints(_rand_npz(13, key=3))


def _queries(x, shape, seed):
    """Random queries over [x0 - 2, x_last + 2] with every edge case mixed
    in: below x0, exactly on each knot, exactly x_last, above x_last."""
    rng = np.random.default_rng(seed)
    lo, hi = float(x[0]) - 2.0, float(x[-1]) + 2.0
    q = rng.uniform(lo, hi, shape).astype(np.float32)
    flat = q.reshape(-1)
    edges = np.concatenate([x.astype(np.float32),
                            [x[0] - 1.0, x[-1], x[-1] + 1.5]])
    flat[:len(edges)] = edges
    flat[-3:] = [x[-1], x[0], x[-1]]
    return q


def _close(port, ref, scale=1.0):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    bound = TOL * np.maximum(np.abs(ref), scale)
    assert (np.abs(port - ref) <= bound).all(), np.abs(port - ref).max()


@pytest.mark.parametrize("grid", GRIDS)
def test_dense_plain_matches_pallas_interpret(tables, grid):
    tab = getattr(tables, grid)
    L, K = tab.y.shape[0], tab.y.shape[-1]
    B = 3
    q = _queries(tab.x, (B, L, L), seed=K)
    mask = np.random.default_rng(K + 1).random((L, L)) < 0.6
    sums, deriv = spline_dense_plain(
        *(torch.from_numpy(a) for a in (tab.y, tab.m, tab.x, q, mask)))
    ref_sums, ref_deriv = _spline_energy_fwd_pallas(
        jnp.asarray(tab.y), jnp.asarray(tab.m), jnp.asarray(tab.x),
        jnp.asarray(q), jnp.asarray(mask), interpret=True)
    val, _ = jspline.evaluate_spline_with_deriv(
        jspline.SplineTable(jnp.asarray(tab.x), jnp.asarray(tab.y),
                            jnp.asarray(tab.m)), jnp.asarray(q))
    scale = float(np.abs(np.where(mask, np.asarray(val), 0)).sum(
        axis=(1, 2)).max())
    _close(sums, ref_sums, scale)          # 1e-5 relative to sum |val|
    _close(deriv, ref_deriv)
    for b in range(B):                      # the dense JAX evaluator too
        e = jspline.masked_spline_energy(tab.y, tab.m, tab.x, q[b], mask)
        assert abs(float(sums[b]) - float(e)) <= TOL * scale


def _pair_terms(tables, P=40):
    """(y, m, x, act) of the first P pairs of every grid's table, as numpy,
    with a seeded activity mask."""
    out = []
    for grid in GRIDS:
        tab = getattr(tables, grid)
        K = tab.y.shape[-1]
        out.append((tab.y.reshape(-1, K)[:P], tab.m.reshape(-1, K)[:P],
                    tab.x, np.random.default_rng(K).random(P) < 0.7))
    return out


@pytest.mark.parametrize("grid", GRIDS)
def test_pairs_plain_matches_masked_spline_energy_pb(tables, grid):
    """The fused pair entry's plain version with this grid as its one
    term."""
    tab = getattr(tables, grid)
    K = tab.y.shape[-1]
    y = tab.y.reshape(-1, K)[:40]
    m = tab.m.reshape(-1, K)[:40]
    q = _queries(tab.x, (40, 5), seed=2 * K)
    act = np.random.default_rng(K).random(40) < 0.7
    term = tuple(torch.from_numpy(a) for a in (y, m, tab.x, act))
    sums, (deriv,) = spline_pairs_plain([term], [torch.from_numpy(q)])
    val, der = jspline._eval_with_deriv_pb(
        jnp.asarray(y), jnp.asarray(m), jnp.asarray(tab.x), jnp.asarray(q))
    ref_sums = jspline.masked_spline_energy_pb(y, m, tab.x, q, act)
    scale = float(np.abs(np.where(act[:, None], np.asarray(val), 0))
                  .sum(0).max())
    assert sums.shape == (1, 5)
    _close(sums[0], ref_sums, scale)
    _close(deriv, np.where(act[:, None], np.asarray(der), 0.0))
    # the port's autograd Functions against jax.grad of the JAX energies
    qt = torch.from_numpy(q).requires_grad_(True)
    g = torch.arange(1.0, 6.0)
    (spline_energy_pairs(SplinePairs([term]), [qt])[0] * g).sum().backward()
    ref_g = jax.grad(lambda qq: jnp.sum(jspline.masked_spline_energy_pb(
        y, m, tab.x, qq, act) * jnp.arange(1.0, 6.0)))(jnp.asarray(q))
    _close(qt.grad, ref_g)
    qt.grad = None
    tspline.masked_spline_energy_pb(
        *(torch.from_numpy(a) for a in (y, m, tab.x)), qt,
        torch.from_numpy(act)).sum().backward()
    _close(qt.grad, np.where(act[:, None], np.asarray(der), 0.0))


def test_dense_backward_matches_jax_grad(tables):
    tab = tables.dist
    L = tab.y.shape[0]
    q = _queries(tab.x, (2, L, L), seed=9)
    mask = np.triu(np.ones((L, L), bool), 1)
    qt = torch.from_numpy(q).requires_grad_(True)
    (spline_energy_dense(*(torch.from_numpy(a) for a in (tab.y, tab.m,
                                                          tab.x)), qt,
                         torch.from_numpy(mask))
     * torch.tensor([1.0, -2.0])).sum().backward()
    ref = jax.grad(lambda qq: jnp.sum(spline_energy_batch(
        tab.y, tab.m, tab.x, qq, mask, True) * jnp.array([1.0, -2.0])))(
        jnp.asarray(q))
    _close(qt.grad, ref)
    e = tspline.masked_spline_energy(
        *(torch.from_numpy(a) for a in (tab.y, tab.m, tab.x, q[0], mask)))
    assert abs(float(e) - float(jspline.masked_spline_energy(
        tab.y, tab.m, tab.x, q[0], mask))) <= TOL * max(1.0, abs(float(e)))


def test_masked_nan_does_not_leak(tables):
    tab = tables.omega
    K = tab.y.shape[-1]
    y = tab.y.reshape(-1, K)[:6].copy()
    m = tab.m.reshape(-1, K)[:6].copy()
    q = _queries(tab.x, (6, 8), seed=4)
    act = np.array([1, 0, 1, 0, 1, 1], bool)
    q[1] = np.nan
    y[3] = np.inf
    sums, (deriv,) = spline_pairs_plain(
        [tuple(torch.from_numpy(a) for a in (y, m, tab.x, act))],
        [torch.from_numpy(q)])
    assert torch.isfinite(sums).all() and torch.isfinite(deriv).all()
    assert (deriv[~torch.from_numpy(act)] == 0).all()


def test_fit_on_device_matches_host_fit(tables):
    x, y = tables.phi.x, tables.phi.y
    host = tspline.fit_natural_cubic(x, y)
    dev = tspline.fit_natural_cubic(x, torch.from_numpy(y))
    # a float32 product of 16 terms in another order: relative to max |m|
    _close(dev.m, host.m, scale=float(np.abs(host.m).max()))
    ref = jspline.fit_natural_cubic(x, y)
    assert np.array_equal(host.m, np.asarray(ref.m))
    q = _queries(x, y.shape[:-1], seed=3)
    got = tspline.evaluate_spline(dev, torch.from_numpy(q)).numpy()
    want = np.asarray(jspline.evaluate_spline(ref, jnp.asarray(q)))
    _close(got, want, scale=float(np.abs(want).max()))


def test_fused_plain_is_four_one_term_calls(tables):
    """The four-term plain version (one launch on the card) equals four
    one-term calls, bit for bit, and so does its autograd Function."""
    terms = [tuple(torch.from_numpy(a) for a in t)
             for t in _pair_terms(tables)]
    qs = [torch.from_numpy(_queries(x.numpy(), (40, 3), seed=n))
          for n, (_, _, x, _) in enumerate(terms)]
    sums, derivs = spline_pairs_plain(terms, qs)
    assert sums.shape == (4, 3)
    for n, (term, q) in enumerate(zip(terms, qs)):
        one, (d,) = spline_pairs_plain([term], [q])
        assert torch.equal(sums[n], one[0]) and torch.equal(derivs[n], d)
    qg = [q.clone().requires_grad_(True) for q in qs]
    g = torch.tensor([[1.0, 2.0, 3.0]]) * torch.tensor([[1.0], [-2.0], [0.5],
                                                        [4.0]])
    (spline_energy_pairs(SplinePairs(terms), qg) * g).sum().backward()
    for n, (term, q) in enumerate(zip(terms, qs)):
        q1 = q.clone().requires_grad_(True)
        (spline_energy_pairs(SplinePairs([term]), [q1])[0] * g[n]).sum() \
            .backward()
        assert torch.equal(qg[n].grad, q1.grad)


def test_batch_restraint_energy_matches_jax_compact():
    """compact_restraint_energy_batch (the fused pair entry's caller) against
    JAX's on the same seeded pair lists: energies and the gradient through
    every term's q, at float32, within 1e-5 of the largest energy and
    gradient entry (the same arithmetic in another order)."""
    L, B = 12, 3
    npz = _rand_npz(L, key=5)
    prst, jr = trst.compile_restraints(npz), jrst.compile_restraints(npz)
    seq = "ARNDCQEGHILK"
    cr = tcompact.compact_to(tcompact.compact_restraints(
        prst, trst.restraint_masks(prst, seq, 1, L)), L, "cpu")
    jcr = jax.tree.map(jnp.asarray, jcompact.compact_restraints(
        jr, jrst.restraint_masks(jr, seq, 1, L)))
    rng = np.random.default_rng(6)
    atoms = {a: (rng.standard_normal((B, L, 3)) * 6.0).astype(np.float32)
             for a in ("N", "CA", "CB")}
    w = np.array([1.0, -2.0, 3.0], np.float32)
    ta = {a: torch.from_numpy(v).requires_grad_(True)
          for a, v in atoms.items()}
    e = tcompact.compact_restraint_energy_batch(ta, cr, 5.0, 4.0, 3.0)
    (e * torch.from_numpy(w)).sum().backward()
    def energy(at):
        e = jcompact.compact_restraint_energy_batch(at, jcr, 5.0, 4.0, 3.0)
        return jnp.sum(e * w), e

    (_, ref_e), ref_g = jax.jit(jax.value_and_grad(energy, has_aux=True))(
        {a: jnp.asarray(v) for a, v in atoms.items()})
    ref_e = np.asarray(ref_e)
    assert np.abs(e.detach().numpy() - ref_e).max() <= \
        1e-5 * np.abs(ref_e).max()
    scale = max(np.abs(np.asarray(ref_g[a])).max() for a in atoms)
    for a in atoms:
        assert np.abs(ta[a].grad.numpy() - np.asarray(ref_g[a])).max() <= \
            1e-5 * scale, a


@pytest.mark.parametrize("fault", ["dtype", "K", "contiguity"])
def test_compact_to_rejects_malformed_tables(tables, fault):
    """The pair entry's stage constants are checked once, where compact_to
    builds a stage's pair lists, not at every evaluation."""
    L = 13
    seq = "A" * L
    cr = tcompact.compact_restraints(tables,
                                     trst.restraint_masks(tables, seq, 1, L))
    dtype = torch.float32
    if fault == "dtype":
        dtype = torch.float16
    elif fault == "K":
        t = cr.omega
        cr = cr._replace(omega=t._replace(
            y=np.zeros((t.y.shape[0], 65), np.float32),
            m=np.zeros((t.y.shape[0], 65), np.float32),
            x=np.arange(65, dtype=np.float32)))
    else:
        t = cr.phi
        wide = np.repeat(t.y, 2, axis=1)
        cr = cr._replace(phi=t._replace(y=wide[:, ::2]))
        assert not torch.as_tensor(cr.phi.y).is_contiguous()
    with pytest.raises(ValueError, match="must be|K <= 64"):
        tcompact.compact_to(cr, L, "cpu", dtype)
    good = tcompact.compact_to(tcompact.compact_restraints(
        tables, trst.restraint_masks(tables, seq, 1, L)), L, "cpu")
    assert isinstance(good.splines, SplinePairs)
    assert good.splines.sizes == tuple(t.act.shape[0] for t in good[:4])


def test_wrappers_count_no_launch_on_cpu(tables):
    tab = tables.phi
    q = torch.from_numpy(_queries(tab.x, (2, 13, 13), seed=1))
    args = [torch.from_numpy(a) for a in (tab.y, tab.m, tab.x)]
    terms = [tuple(torch.from_numpy(a) for a in t)
             for t in _pair_terms(tables)]
    qs = [torch.zeros(40, 2) for _ in terms]
    dense = SplineDense([(*args, torch.ones(13, 13, dtype=torch.bool))])
    before = (spline_energy_dense.launches, spline_energy_pairs.launches)
    spline_energy_dense(*args, q, torch.ones(13, 13, dtype=torch.bool))
    spline_energy_dense_terms(dense, [q])
    spline_energy_pairs(SplinePairs(terms), qs)
    assert (spline_energy_dense.launches,
            spline_energy_pairs.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        _check_queries(dense, [q])
    with pytest.raises(ValueError, match="CUDA"):
        _check_queries(SplinePairs(terms), qs)


def _dense_terms(tables, B, seed=0):
    """The four grids' (y, m, x, mask) as tensors, seeded masks, and one
    (B, L, L) query tensor per grid with the edge cases mixed in."""
    terms, qs = [], []
    for n, grid in enumerate(GRIDS):
        tab = getattr(tables, grid)
        L = tab.y.shape[0]
        mask = np.random.default_rng(seed + n).random((L, L)) < 0.6
        terms.append(tuple(torch.from_numpy(a)
                           for a in (tab.y, tab.m, tab.x, mask)))
        qs.append(torch.from_numpy(_queries(tab.x, (B, L, L),
                                            seed=seed + 10 + n)))
    return terms, qs


def test_dense_terms_plain_is_four_one_term_calls(tables):
    """The dense entry's four-term plain version (one launch on the card)
    equals four one-term spline_dense_plain calls, bit for bit, and so does
    its autograd Function against four one-term spline_energy_dense
    calls."""
    terms, qs = _dense_terms(tables, 3)
    sums, derivs = spline_dense_terms_plain(terms, qs)
    assert sums.shape == (4, 3)
    for n, (term, q) in enumerate(zip(terms, qs)):
        one, d = spline_dense_plain(*term[:3], q, term[3])
        assert torch.equal(sums[n], one) and torch.equal(derivs[n], d)
    qg = [q.clone().requires_grad_(True) for q in qs]
    g = torch.tensor([[1.0, 2.0, 3.0]]) * torch.tensor([[1.0], [-2.0], [0.5],
                                                        [4.0]])
    out = spline_energy_dense_terms(SplineDense(terms), qg)
    assert torch.equal(out.detach(), sums)
    (out * g).sum().backward()
    for n, (term, q) in enumerate(zip(terms, qs)):
        q1 = q.clone().requires_grad_(True)
        (spline_energy_dense(*term[:3], q1, term[3]) * g[n]).sum().backward()
        assert torch.equal(qg[n].grad, q1.grad)


def test_dense_terms_match_pallas_interpret(tables):
    """Each term of one four-term call against JAX's spline_energy_batch
    (the Pallas kernel in interpret mode), at the tolerance of
    test_dense_plain_matches_pallas_interpret (sums within 1e-5 of
    sum |value|), and the backward against jax.grad of the same weighted
    sum (1e-5)."""
    B = 2
    terms, qs = _dense_terms(tables, B, seed=20)
    w = np.array([1.0, -2.0, 0.5, 4.0], np.float32)
    gb = np.array([1.0, -3.0], np.float32)
    qg = [q.clone().requires_grad_(True) for q in qs]
    sums = spline_energy_dense_terms(SplineDense(terms), qg)
    (sums * torch.from_numpy(w[:, None] * gb[None])).sum().backward()
    np_terms = [tuple(t.numpy() for t in term) for term in terms]
    for n, ((y, m, x, mask), q) in enumerate(zip(np_terms, qs)):
        ref = spline_energy_batch(y, m, x, jnp.asarray(q.numpy()), mask,
                                  True)
        val, _ = jspline.evaluate_spline_with_deriv(
            jspline.SplineTable(jnp.asarray(x), jnp.asarray(y),
                                jnp.asarray(m)), jnp.asarray(q.numpy()))
        scale = float(np.abs(np.where(mask, np.asarray(val), 0)).sum(
            axis=(1, 2)).max())
        _close(sums[n].detach(), ref, scale)
        ref_g = jax.grad(lambda qq: jnp.sum(spline_energy_batch(
            y, m, x, qq, mask, True) * gb * w[n]))(jnp.asarray(q.numpy()))
        _close(qg[n].grad, ref_g)


@pytest.mark.parametrize("fault", ["terms", "shape", "L", "dtype", "K",
                                   "mask_dtype", "devices", "contiguity"])
def test_spline_dense_rejects_malformed_tables(tables, fault):
    """SplineDense checks a stage's tables once, when built: the number of
    terms, shapes (one L for all terms), dtypes, K <= 64, one device and
    contiguity."""
    terms, _ = _dense_terms(tables, 1)
    y, m, x, mask = terms[1]
    if fault == "terms":
        bad = terms + terms[:1]
    elif fault == "shape":
        bad = [(y[:, :, :-1], m, x, mask)]
    elif fault == "L":
        L = mask.shape[0]
        bad = [terms[0], (y[:L - 1, :L - 1].contiguous(),
                          m[:L - 1, :L - 1].contiguous(), x,
                          mask[:L - 1, :L - 1].contiguous())]
    elif fault == "dtype":
        bad = [(y.half(), m.half(), x.half(), mask)]
    elif fault == "K":
        K = 65
        L = mask.shape[0]
        bad = [(torch.zeros(L, L, K), torch.zeros(L, L, K),
                torch.arange(K, dtype=torch.float32), mask)]
    elif fault == "mask_dtype":
        bad = [(y, m, x, mask.to(torch.uint8))]
    elif fault == "devices":
        bad = [(y, m, x, mask.to("meta"))]
    else:
        wide = torch.repeat_interleave(y, 2, dim=-1)[..., ::2]
        assert not wide.is_contiguous()
        bad = [(wide, m, x, mask)]
    with pytest.raises(ValueError, match="must be|K <= 64|terms"):
        SplineDense(bad)
    good = SplineDense(terms)
    L = mask.shape[0]
    assert good.sizes == (L * L,) * 4 and good.L == L
    # the kernel's stage constants: P = L * L pairs a term, each term's K
    assert [(t.P, t.K) for t in good._launch_constants(None)] == \
        [(L * L, x.shape[0]) for _, _, x, _ in terms]
