"""Batched L-BFGS with Armijo backtracking.

Port of trx2dy/physics/minimize.py (the stand-in for Rosetta's
lbfgs_armijo_nonmonotone MinMover, folding/folding.py:91-104). The whole
decoy ensemble minimises together: every state tensor carries a leading
batch axis, and converged or caller-frozen decoys are held by masks.

JAX runs the two loops inside lax.while_loop. Here they are Python loops
over device work, and each data-dependent loop condition costs exactly one
host sync: `~all(done)` once per iteration, `~all(accepted | done)` once
per line-search trial. So the port makes the same energy evaluations as
JAX: one value-only call per trial and one value-and-gradient call per
iteration. STATS counts both (evals) and the syncs.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

_C1 = 1e-4            # Armijo sufficient-decrease constant
_MAX_BACKTRACK = 25   # max step halvings per iteration


class _Stats:
    """Energy evaluations (value-only and value-and-gradient calls of an
    objective) and host syncs of the fold, since the last reset()."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.evals = 0
        self.syncs = 0


STATS = _Stats()


def host_all(flags: torch.Tensor) -> bool:
    """all(flags) on the host: one sync, counted."""
    STATS.syncs += 1
    return bool(torch.all(flags))


def host_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor copied to the host: one sync, counted."""
    STATS.syncs += 1
    return t.detach().cpu().numpy()


class LBFGSResult(NamedTuple):
    x: torch.Tensor          # (B, D) final parameters
    f: torch.Tensor          # (B,) final energies
    n_iter: int              # iterations executed
    converged: torch.Tensor  # (B,) convergence flags


class LBFGSState(NamedTuple):
    """Optimizer state; k is the host-side iteration count."""
    k: int
    x: torch.Tensor        # (B, D)
    f: torch.Tensor        # (B,)
    g: torch.Tensor        # (B, D)
    s_hist: torch.Tensor   # (M, B, D)
    y_hist: torch.Tensor   # (M, B, D)
    rho: torch.Tensor      # (M, B)
    valid: torch.Tensor    # (M, B)
    done: torch.Tensor     # (B,) converged or frozen
    frozen: torch.Tensor   # (B,) caller-frozen decoys
    fails: torch.Tensor    # (B,) consecutive line-search failures
    smalls: torch.Tensor   # (B,) consecutive below-tolerance improvements
    # (W, B) ring of recent f for nonmonotone acceptance; None = monotone
    f_hist: Optional[torch.Tensor] = None


def _value(fun: Callable, x: torch.Tensor) -> torch.Tensor:
    STATS.evals += 1
    with torch.no_grad():
        return fun(x)


def _value_and_grad_batch(fun: Callable) -> Callable:
    """fun: (B, D) -> (B,); returns x -> (values (B,), grads (B, D)).

    Decoys are independent, so the gradient of the batch sum is the
    per-decoy gradient: one backward pass for the whole ensemble."""
    def vg(x):
        STATS.evals += 1
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            vals = fun(xg)
            (grads,) = torch.autograd.grad(vals.sum(), xg)
        return vals.detach(), grads
    return vg


def _two_loop(g, s_hist, y_hist, rho, valid):
    """Batched L-BFGS two-loop recursion; history oldest to newest along
    axis 0. Returns the (B, D) descent direction -H g."""
    M = s_hist.shape[0]
    q = g
    alpha = [None] * M
    for j in reversed(range(M)):                     # newest -> oldest
        a = rho[j] * torch.sum(s_hist[j] * q, dim=-1)
        a = torch.where(valid[j], a, 0.0)
        q = q - a[:, None] * y_hist[j]
        alpha[j] = a

    # initial Hessian scale gamma = s.y / y.y of the newest valid entry
    sy = torch.sum(s_hist * y_hist, dim=-1)                   # (M, B)
    yy = torch.sum(y_hist * y_hist, dim=-1)
    order = torch.arange(M, dtype=g.dtype, device=g.device)[:, None]
    newest = torch.argmax(torch.where(valid, order, -1.0), dim=0)[None]
    gamma = torch.where(
        torch.any(valid, dim=0),
        torch.gather(sy, 0, newest)[0]
        / torch.clamp_min(torch.gather(yy, 0, newest)[0], 1e-20),
        1.0)
    r = gamma[:, None] * q
    for j in range(M):
        b = rho[j] * torch.sum(y_hist[j] * r, dim=-1)
        b = torch.where(valid[j], b, 0.0)
        corr = (alpha[j] - b)[:, None] * s_hist[j]
        r = r + torch.where(valid[j][:, None], corr, 0.0)
    return -r


def lbfgs_init(fun: Callable, x0: torch.Tensor, history: int = 10,
               freeze: Optional[torch.Tensor] = None,
               nonmonotone: int = 0) -> LBFGSState:
    """Initial optimizer state (one energy-and-gradient evaluation)."""
    B, D = x0.shape
    M = history
    f0, g0 = _value_and_grad_batch(fun)(x0)
    dev, dt = x0.device, x0.dtype
    frozen0 = (torch.zeros((B,), dtype=torch.bool, device=dev)
               if freeze is None else freeze)
    return LBFGSState(
        k=0, x=x0, f=f0, g=g0,
        s_hist=torch.zeros((M, B, D), dtype=dt, device=dev),
        y_hist=torch.zeros((M, B, D), dtype=dt, device=dev),
        rho=torch.zeros((M, B), dtype=dt, device=dev),
        valid=torch.zeros((M, B), dtype=torch.bool, device=dev),
        done=frozen0, frozen=frozen0,
        fails=torch.zeros((B,), dtype=torch.int32, device=dev),
        smalls=torch.zeros((B,), dtype=torch.int32, device=dev),
        f_hist=f0.repeat(nonmonotone, 1) if nonmonotone > 0 else None,
    )


def _push(hist, new, keep):
    """Roll the history by one (slot M-1 newest), then zero lanes not kept."""
    out = torch.cat([hist[1:], new[None]], dim=0)
    return out * keep.view((1, -1) + (1,) * (hist.dim() - 2)).to(out.dtype)


def _iteration(fun, vg, st: LBFGSState, tol: float) -> LBFGSState:
    B = st.x.shape[0]
    d = _two_loop(st.g, st.s_hist, st.y_hist, st.rho, st.valid)
    # steepest descent where d is not a descent direction
    gd = torch.sum(st.g * d, dim=-1)
    bad = gd >= 0.0
    d = torch.where(bad[:, None], -st.g, d)
    gd = torch.where(bad, -torch.sum(st.g * st.g, dim=-1), gd)

    # batched Armijo backtracking, value-only trials; unit first step with
    # curvature history, gradient-scaled (at most ~0.5 per coordinate) on
    # (re)starts
    f_ref = st.f if st.f_hist is None else torch.amax(st.f_hist, dim=0)
    has_hist = torch.any(st.valid, dim=0)
    d_inf = torch.amax(d.abs(), dim=-1)
    t = torch.where(has_hist, 1.0,
                    torch.clamp_max(0.5 / torch.clamp_min(d_inf, 1e-8), 1.0))
    accepted = torch.zeros((B,), dtype=torch.bool, device=st.x.device)
    f_new, x_new = st.f, st.x
    n = 0
    while n < _MAX_BACKTRACK and not host_all(accepted | st.done):
        x_try = st.x + t[:, None] * d
        f_try = _value(fun, x_try)
        ok = (f_try <= f_ref + _C1 * t * gd) & torch.isfinite(f_try)
        newly = ok & ~accepted
        f_new = torch.where(newly, f_try, f_new)
        x_new = torch.where(newly[:, None], x_try, x_new)
        t = torch.where(ok | accepted, t, t * 0.5)
        accepted = accepted | ok
        n += 1

    moved = accepted & ~st.done
    x_next = torch.where(moved[:, None], x_new, st.x)
    f_next = torch.where(moved, f_new, st.f)
    _, g_next = vg(x_next)
    g_next = torch.where(moved[:, None], g_next, st.g)

    # history update; a line-search failure wipes the history so the next
    # iteration retries as steepest descent before declaring convergence
    s = x_next - st.x
    y = g_next - st.g
    sy = torch.sum(s * y, dim=-1)
    good = moved & (sy > 1e-10)
    failed = ~accepted & ~st.done
    keep = ~failed
    s_hist = _push(st.s_hist, torch.where(good[:, None], s, 0.0), keep)
    y_hist = _push(st.y_hist, torch.where(good[:, None], y, 0.0), keep)
    rho = _push(st.rho, torch.where(good, 1.0 / torch.clamp_min(sy, 1e-20),
                                    0.0), keep)
    valid = torch.cat([st.valid[1:], good[None]], dim=0) & keep[None, :]
    fails = torch.where(failed, st.fails + 1, 0).to(torch.int32)

    # convergence: several consecutive below-tolerance steps
    denom = 0.5 * (st.f.abs() + f_next.abs()) + 1e-8
    small = (st.f - f_next).abs() <= tol * denom
    smalls = torch.where(moved & small, st.smalls + 1, 0).to(torch.int32)
    done = st.done | (smalls >= 3) | (fails >= 2)

    f_hist = st.f_hist
    if f_hist is not None:
        f_hist = torch.cat([f_hist[1:],
                            torch.where(moved, f_next, st.f)[None]], dim=0)
    return LBFGSState(st.k + 1, x_next, f_next, g_next, s_hist, y_hist, rho,
                      valid, done, st.frozen, fails, smalls, f_hist)


def lbfgs_run(fun: Callable, st: LBFGSState, max_iter: int,
              tol: float = 1e-4) -> LBFGSState:
    """Advance the optimizer by up to max_iter iterations (resumable)."""
    vg = _value_and_grad_batch(fun)
    stop_k = st.k + max_iter
    while st.k < stop_k and not host_all(st.done):
        st = _iteration(fun, vg, st, tol)
    return st


def state_gather(st: LBFGSState, idx) -> LBFGSState:
    """The state of a subset of batch lanes (the fold's converged-lane
    repacking)."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64,
                          device=st.x.device)

    def take(a, axis):
        return a.index_select(axis, idx)

    return LBFGSState(
        k=st.k, x=take(st.x, 0), f=take(st.f, 0), g=take(st.g, 0),
        s_hist=take(st.s_hist, 1), y_hist=take(st.y_hist, 1),
        rho=take(st.rho, 1), valid=take(st.valid, 1),
        done=take(st.done, 0), frozen=take(st.frozen, 0),
        fails=take(st.fails, 0), smalls=take(st.smalls, 0),
        f_hist=None if st.f_hist is None else take(st.f_hist, 1),
    )


def lbfgs_minimize(fun: Callable, x0: torch.Tensor, max_iter: int = 1000,
                   tol: float = 1e-4, history: int = 10,
                   freeze: Optional[torch.Tensor] = None,
                   nonmonotone: int = 0) -> LBFGSResult:
    """Minimise a batch of independent objectives fun: (B, D) -> (B,)."""
    st = lbfgs_run(fun, lbfgs_init(fun, x0, history=history, freeze=freeze,
                                   nonmonotone=nonmonotone),
                   max_iter=max_iter, tol=tol)
    return LBFGSResult(x=st.x, f=st.f, n_iter=st.k,
                       converged=st.done & ~st.frozen)
