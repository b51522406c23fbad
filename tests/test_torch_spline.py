"""The port's spline restraint energy against the JAX package, on the CPU.

On the CPU the port's kernel wrappers take their plain versions, so these
tests hold that arithmetic (the interval search, the cubic, the linear
extrapolation, the masking and the one-multiply backward) against the
Pallas kernel in interpret mode and against spline.masked_spline_energy
and masked_spline_energy_pb. The CUDA kernel has no CPU mode; chip_smoke.py
holds it against the plain version on the card.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from trx2dy.ops.spline_energy import (
    _spline_energy_fwd_pallas, spline_energy_batch,
)
from trx2dy.physics import spline as jspline
from trx2dy_torch.ops.spline_energy import (
    _check, spline_dense_plain, spline_energy_dense, spline_energy_pairs,
    spline_pairs_plain,
)
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


@pytest.mark.parametrize("grid", GRIDS)
def test_pairs_plain_matches_masked_spline_energy_pb(tables, grid):
    tab = getattr(tables, grid)
    K = tab.y.shape[-1]
    y = tab.y.reshape(-1, K)[:40]
    m = tab.m.reshape(-1, K)[:40]
    q = _queries(tab.x, (40, 5), seed=2 * K)
    act = np.random.default_rng(K).random(40) < 0.7
    sums, deriv = spline_pairs_plain(
        *(torch.from_numpy(a) for a in (y, m, tab.x, q, act)))
    val, der = jspline._eval_with_deriv_pb(
        jnp.asarray(y), jnp.asarray(m), jnp.asarray(tab.x), jnp.asarray(q))
    ref_sums = jspline.masked_spline_energy_pb(y, m, tab.x, q, act)
    scale = float(np.abs(np.where(act[:, None], np.asarray(val), 0))
                  .sum(0).max())
    _close(sums, ref_sums, scale)
    _close(deriv, np.where(act[:, None], np.asarray(der), 0.0))
    # the port's autograd Functions against jax.grad of the JAX energies
    qt = torch.from_numpy(q).requires_grad_(True)
    g = torch.arange(1.0, 6.0)
    (spline_energy_pairs(*(torch.from_numpy(a) for a in (y, m, tab.x)), qt,
                         torch.from_numpy(act)) * g).sum().backward()
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
    sums, deriv = spline_pairs_plain(
        *(torch.from_numpy(a) for a in (y, m, tab.x, q, act)))
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


def test_wrappers_count_no_launch_on_cpu(tables):
    tab = tables.phi
    q = torch.from_numpy(_queries(tab.x, (2, 13, 13), seed=1))
    args = [torch.from_numpy(a) for a in (tab.y, tab.m, tab.x)]
    before = (spline_energy_dense.launches, spline_energy_pairs.launches)
    spline_energy_dense(*args, q, torch.ones(13, 13, dtype=torch.bool))
    assert (spline_energy_dense.launches,
            spline_energy_pairs.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        _check("spline_energy_dense", *args, q,
               torch.ones(13, 13, dtype=torch.bool), (13, 13), (13, 13))
