"""Masked spline restraint energy: the CUDA kernel, its plain versions, the
wrappers.

The kernel (csrc/spline_energy.cu) replaces the Pallas TPU kernel
trx2dy/ops/spline_energy.py:_spline_kernel. Per decoy it sums a masked
natural-cubic spline over its queries and returns dE/dq in the same pass,
so each wrapper is an autograd Function whose backward is `g * deriv`.
Two entry points:

  spline_energy_dense(y, m, x, q, mask)  y, m (L, L, K); q (B, L, L);
      mask (L, L) bool -> (B,). The TPU kernel's layout
      (spline_energy_batch), run by energy.batched_energy_fused.
  spline_energy_pairs(y, m, x, q, act)   y, m (P, K); q (P, B); act (P,)
      bool -> (B,). The compacted pair lists of the production fold
      (compact.compact_restraint_energy_batch).

Both take knots x (K,), K <= 64, and float32 tensors. A CPU tensor takes
the plain version (the port of spline.evaluate_spline_with_deriv or
_eval_with_deriv_pb); a CUDA tensor launches the kernel or raises.
`spline_energy_dense.launches` and `spline_energy_pairs.launches` count
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from trx2dy_torch.physics.spline import (
    SplineTable, _eval_with_deriv_pb, evaluate_spline_with_deriv,
)

MAX_K = 64


def spline_dense_plain(y, m, x, q, mask):
    """(per-decoy masked sums (B,), masked deriv (B, L, L)) in PyTorch."""
    val, der = evaluate_spline_with_deriv(SplineTable(x, y, m), q)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    return (torch.sum(torch.where(mask, val, zero), dim=(1, 2)),
            torch.where(mask, der, zero))


def spline_pairs_plain(y, m, x, q, act):
    """(per-decoy masked sums (B,), masked deriv (P, B)) in PyTorch."""
    val, der = _eval_with_deriv_pb(y, m, x, q)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    keep = act[:, None]
    return (torch.sum(torch.where(keep, val, zero), dim=0),
            torch.where(keep, der, zero))


def _lib():
    from trx2dy_torch.ops import _build
    lib = _build.load("spline_energy")
    if lib.trx2dy_spline_dense.argtypes is None:
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.trx2dy_spline_dense.argtypes = [vp, vp, vp, i, vp, vp, ll, i,
                                            vp, i, vp, vp]
        lib.trx2dy_spline_pairs.argtypes = [vp, vp, vp, i, vp, vp, i, i,
                                            vp, i, vp, vp]
        lib.trx2dy_spline_dense_blocks.argtypes = [ll]
        lib.trx2dy_spline_pairs_blocks.argtypes = [i]
        for fn in (lib.trx2dy_spline_dense, lib.trx2dy_spline_pairs,
                   lib.trx2dy_spline_dense_blocks,
                   lib.trx2dy_spline_pairs_blocks):
            fn.restype = ctypes.c_int
    return lib


def _check(name, y, m, x, q, mask, table_shape, mask_shape):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must be on a CUDA device, "
                         f"got {dev}")
    K = x.shape[0] if x.dim() == 1 else -1
    if not 2 <= K <= MAX_K:
        raise ValueError(f"{name}: knots must be (K,) with 2 <= K <= "
                         f"{MAX_K}, got {tuple(x.shape)}")
    for tname, t, shape in (("y", y, table_shape + (K,)),
                            ("m", m, table_shape + (K,)), ("x", x, (K,)),
                            ("mask", mask, mask_shape)):
        want = torch.bool if tname == "mask" else torch.float32
        if t.device != dev or t.dtype != want:
            raise ValueError(f"{name}: {tname} must be {want} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tname} must be {shape}, got "
                             f"{tuple(t.shape)}")
    if q.dtype != torch.float32:
        raise ValueError(f"{name}: q must be float32, got {q.dtype}")
    for tname, t in (("y", y), ("m", m), ("x", x), ("q", q), ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")


def _launch(name, fn, args, B, n_blocks, q):
    """Allocate the (B, n_blocks) partials and the deriv, launch on the
    current stream, and return (partials summed per decoy, deriv)."""
    partial = torch.empty((B, n_blocks), dtype=torch.float32, device=q.device)
    deriv = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*args, B, partial.data_ptr(), n_blocks,
                 deriv.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return partial.sum(dim=1), deriv


def _dense_fwd(y, m, x, q, mask):
    if q.device.type == "cpu":
        return spline_dense_plain(y, m, x, q, mask)
    B, L, _ = q.shape
    _check("spline_energy_dense", y, m, x, q, mask, (L, L), (L, L))
    lib = _lib()
    n_pairs = L * L
    n_blocks = lib.trx2dy_spline_dense_blocks(n_pairs)
    out = _launch("spline_energy_dense", lib.trx2dy_spline_dense,
                  (y.data_ptr(), m.data_ptr(), x.data_ptr(), x.shape[0],
                   q.data_ptr(), mask.data_ptr(), n_pairs),
                  B, n_blocks, q)
    spline_energy_dense.launches += 1
    return out


def _pairs_fwd(y, m, x, q, act):
    if q.device.type == "cpu":
        return spline_pairs_plain(y, m, x, q, act)
    P, B = q.shape
    _check("spline_energy_pairs", y, m, x, q, act, (P,), (P,))
    lib = _lib()
    n_blocks = lib.trx2dy_spline_pairs_blocks(P)
    out = _launch("spline_energy_pairs", lib.trx2dy_spline_pairs,
                  (y.data_ptr(), m.data_ptr(), x.data_ptr(), x.shape[0],
                   q.data_ptr(), act.data_ptr(), P),
                  B, n_blocks, q)
    spline_energy_pairs.launches += 1
    return out


class _Dense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, m, x, q, mask):
        sums, deriv = _dense_fwd(y, m, x, q, mask)
        ctx.save_for_backward(deriv)
        return sums

    @staticmethod
    def backward(ctx, g):
        (deriv,) = ctx.saved_tensors
        return None, None, None, g[:, None, None] * deriv, None


class _Pairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, m, x, q, act):
        sums, deriv = _pairs_fwd(y, m, x, q, act)
        ctx.save_for_backward(deriv)
        return sums

    @staticmethod
    def backward(ctx, g):
        (deriv,) = ctx.saved_tensors
        return None, None, None, g[None, :] * deriv, None


def spline_energy_dense(y, m, x, q, mask):
    """(B,) masked spline energies of q (B, L, L) over shared (L, L, K)
    tables; differentiable in q."""
    return _Dense.apply(y, m, x, q, mask)


def spline_energy_pairs(y, m, x, q, act):
    """(B,) masked spline energies of pair-major q (P, B) over (P, K)
    tables; differentiable in q."""
    return _Pairs.apply(y, m, x, q, act)


spline_energy_dense.launches = 0
spline_energy_pairs.launches = 0
