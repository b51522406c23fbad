"""Batched natural cubic splines on a shared knot grid.

Port of trx2dy/physics/spline.py. Every pair's table shares the knots, so
the second derivatives of all tables come from one fixed (n, n) operator
(cached per grid) applied as one product. Fitting from numpy stays on the
host, as in JAX (the restraint tables are compiled once per npz); fitting a
tensor stays on its device.

Evaluation picks the interval clip(#{x[:n-1] <= q} - 1, 0, n-2), so
intervals are right-open and q == x[-1] falls in the last one; outside
[x[0], x[-1]] the spline extrapolates linearly with its boundary slope.
The masked energies are autograd Functions whose backward is one multiply
by the derivative computed in the forward pass.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SplineTable(NamedTuple):
    x: object     # (n,) shared knots
    y: object     # (..., n) values
    m: object     # (..., n) second derivatives (natural boundary)


_OP_CACHE: dict = {}


def _second_derivative_operator(x: np.ndarray) -> np.ndarray:
    """(n, n) linear operator y -> M of a natural cubic spline on knots x,
    cached per knot grid."""
    key = x.tobytes()
    hit = _OP_CACHE.get(key)
    if hit is None:
        hit = _OP_CACHE[key] = _second_derivative_operator_impl(x)
    return hit


def _second_derivative_operator_impl(x: np.ndarray) -> np.ndarray:
    n = x.shape[0]
    h = np.diff(x)
    if n < 3:
        return np.zeros((n, n))
    # tridiagonal A (n-2, n-2) and right-hand-side operator D (n-2, n)
    A = np.zeros((n - 2, n - 2))
    D = np.zeros((n - 2, n))
    for i in range(1, n - 1):
        r = i - 1
        A[r, r] = (h[i - 1] + h[i]) / 3.0
        if r > 0:
            A[r, r - 1] = h[i - 1] / 6.0
        if r < n - 3:
            A[r, r + 1] = h[i] / 6.0
        D[r, i - 1] = 1.0 / h[i - 1]
        D[r, i] = -1.0 / h[i - 1] - 1.0 / h[i]
        D[r, i + 1] = 1.0 / h[i]
    op = np.zeros((n, n))
    op[1:-1] = np.linalg.solve(A, D)
    return op


def fit_natural_cubic(x: np.ndarray, y) -> SplineTable:
    """Natural cubic splines for a batch of tables sharing knots x.

    x: (n,) strictly increasing host knots; y: (..., n) values. A numpy y
    is fitted on the host and the table stays numpy; a tensor y is fitted
    on its device in its dtype."""
    op64 = _second_derivative_operator(np.asarray(x, np.float64))
    if isinstance(y, np.ndarray):
        m = np.einsum("...n,kn->...k", y, op64.astype(y.dtype))
        return SplineTable(np.asarray(x, dtype=y.dtype), y, m)
    op = torch.as_tensor(op64, dtype=y.dtype, device=y.device)
    m = torch.einsum("...n,kn->...k", y, op)
    return SplineTable(torch.as_tensor(np.asarray(x), dtype=y.dtype,
                                       device=y.device), y, m)


def _interval(x, q):
    """Interval index clip(#{x[:n-1] <= q} - 1, 0, n-2) of every query."""
    n = x.shape[0]
    k = torch.sum(x[: n - 1] <= q[..., None], dim=-1) - 1
    return torch.clamp(k, 0, n - 2)


def _cubic(q, xk, xk1, yk, yk1, mk, mk1):
    """Value and d/dq of the cubic on [xk, xk1], in the JAX order of ops."""
    h = xk1 - xk
    t = (q - xk) / h
    u = 1.0 - t
    h2 = h * h / 6.0
    val = (u * yk + t * yk1 + (u * u * u - u) * h2 * mk
           + (t * t * t - t) * h2 * mk1)
    der = ((yk1 - yk) / h
           + h / 6.0 * (-(3.0 * u * u - 1.0) * mk + (3.0 * t * t - 1.0) * mk1))
    return val, der


def _slopes(x, y, m):
    """Boundary slopes of the linear extrapolation, over the table batch."""
    h0 = x[1] - x[0]
    hn = x[-1] - x[-2]
    lo = (y[..., 1] - y[..., 0]) / h0 - h0 * (2.0 * m[..., 0] + m[..., 1]) / 6.0
    hi = ((y[..., -1] - y[..., -2]) / hn
          + hn * (m[..., -2] + 2.0 * m[..., -1]) / 6.0)
    return lo, hi


def evaluate_spline_with_deriv(table: SplineTable, q: torch.Tensor):
    """Spline value and dvalue/dq at q.

    table.y/m: (..., n) with a batch that q's shape (...,) ends with (a
    leading decoy axis of q shares the tables). Returns two tensors of q's
    shape."""
    x, y, m = table
    n = x.shape[0]
    if y.shape[:-1] != q.shape:
        y = y.expand(*q.shape, n)
        m = m.expand(*q.shape, n)
    k = _interval(x, q)[..., None]
    k1 = k + 1
    val, der = _cubic(q, x[k[..., 0]], x[k1[..., 0]],
                      torch.gather(y, -1, k)[..., 0],
                      torch.gather(y, -1, k1)[..., 0],
                      torch.gather(m, -1, k)[..., 0],
                      torch.gather(m, -1, k1)[..., 0])
    slope_lo, slope_hi = _slopes(x, y, m)
    below = y[..., 0] + slope_lo * (q - x[0])
    above = y[..., -1] + slope_hi * (q - x[-1])
    lo, hi = q < x[0], q > x[-1]
    val = torch.where(lo, below, torch.where(hi, above, val))
    der = torch.where(lo, slope_lo, torch.where(hi, slope_hi, der))
    return val, der


def evaluate_spline(table: SplineTable, q: torch.Tensor) -> torch.Tensor:
    """Spline values at q (see evaluate_spline_with_deriv)."""
    return evaluate_spline_with_deriv(table, q)[0]


def _eval_with_deriv_pb(y, m, x, q):
    """evaluate_spline_with_deriv for pair-major queries: y/m (P, K) per-pair
    tables, q (P, B) with B decoys per pair. Returns value and dvalue/dq,
    both (P, B)."""
    k = _interval(x, q)                                   # (P, B)
    k1 = k + 1
    val, der = _cubic(q, x[k], x[k1], torch.gather(y, 1, k),
                      torch.gather(y, 1, k1), torch.gather(m, 1, k),
                      torch.gather(m, 1, k1))
    slope_lo, slope_hi = (s[:, None] for s in _slopes(x, y, m))
    below = y[:, :1] + slope_lo * (q - x[0])
    above = y[:, -1:] + slope_hi * (q - x[-1])
    lo, hi = q < x[0], q > x[-1]
    val = torch.where(lo, below, torch.where(hi, above, val))
    der = torch.where(lo, slope_lo, torch.where(hi, slope_hi, der))
    return val, der


class _MaskedSplineEnergy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, m, x, q, mask):
        val, der = evaluate_spline_with_deriv(SplineTable(x, y, m), q)
        zero = torch.zeros((), dtype=q.dtype, device=q.device)
        ctx.save_for_backward(torch.where(mask, der, zero))
        return torch.sum(torch.where(mask, val, zero))

    @staticmethod
    def backward(ctx, g):
        (der,) = ctx.saved_tensors
        return None, None, None, g * der, None


def masked_spline_energy(y, m, x, q, mask):
    """sum(where(mask, spline(q), 0)); y/m (..., n), x (n,), q/mask (...).
    Differentiable in q only, by a one-multiply backward."""
    return _MaskedSplineEnergy.apply(y, m, x, q, mask)


class _MaskedSplineEnergyPB(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, m, x, q, mask):
        val, der = _eval_with_deriv_pb(y, m, x, q)
        zero = torch.zeros((), dtype=q.dtype, device=q.device)
        ctx.save_for_backward(torch.where(mask[:, None], der, zero))
        return torch.sum(torch.where(mask[:, None], val, zero), dim=0)

    @staticmethod
    def backward(ctx, g):
        (der,) = ctx.saved_tensors
        return None, None, None, g[None, :] * der, None


def masked_spline_energy_pb(y, m, x, q, mask):
    """Per-decoy masked spline energy over pair-major queries: y/m (P, K),
    q (P, B), mask (P,) bool -> (B,). Differentiable in q only."""
    return _MaskedSplineEnergyPB.apply(y, m, x, q, mask)


class _MaskedSplineEnergyLanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, m, x, q, mask):
        val, der = evaluate_spline_with_deriv(SplineTable(x, y, m), q)
        zero = torch.zeros((), dtype=q.dtype, device=q.device)
        ctx.save_for_backward(torch.where(mask, der, zero))
        return torch.sum(torch.where(mask, val, zero), dim=-1)

    @staticmethod
    def backward(ctx, g):
        (der,) = ctx.saved_tensors
        return None, None, None, g[..., None] * der, None


def masked_spline_energy_lanes(y, m, x, q, mask):
    """Per-lane masked spline energy, each lane with its own tables and
    active set: y/m (M, P, K), x (K,), q/mask (M, P) -> (M,) sums over each
    lane's active pairs. Differentiable in q only, by a one-multiply
    backward. The sampler's kernel path (ops.spline_energy_lanes) takes the
    same tables pair-major."""
    return _MaskedSplineEnergyLanes.apply(y, m, x, q, mask)
