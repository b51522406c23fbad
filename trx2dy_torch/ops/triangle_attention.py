"""Triangle attention core: the CUDA kernel, its plain version, the wrapper.

The kernel (csrc/triangle_attention.cu) replaces the Pallas TPU kernel
trx2dy/ops/triangle_attention.py:_tri_attn_kernel. It computes, for row
r, query i and head h,

  out[r,i,h,:] = sum_j softmax_j(q[r,i,h].k[r,j,h] / sqrt(D) + bias[i,j,h])
                 v[r,j,h,:]

without the (L, L, L, H) logits. Column-wise attention is the same
function on exchanged row and position axes of q, k, v and out, with the
bias untransposed; the wrapper passes swapped strides, so no transposed
copy is made.

`tri_attn_core` launches the kernel for CUDA tensors (or raises) and takes
the plain version only for CPU tensors. `tri_attn_core.launches` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

D_HEAD = 32


def tri_attn_core_plain(q, k, v, bias, wise: str):
    """The logits path of trx2dy/models/predictor2d.py:206-216 in torch.

    q, k, v: (L, L, H, D); bias: (L, L, H). Returns (L, L, H, D)."""
    scale = q.shape[-1] ** 0.5
    if wise == "row":
        attn = torch.softmax(
            torch.einsum("rihd,rjhd->rijh", q, k) / scale + bias[None],
            dim=2)
        return torch.einsum("rijh,rjhd->rihd", attn, v)
    if wise == "col":
        attn = torch.softmax(
            torch.einsum("ilhd,jlhd->ijlh", q, k) / scale
            + bias[:, :, None, :], dim=1)
        return torch.einsum("ijlh,jlhd->ilhd", attn, v)
    raise ValueError(f"wise must be 'row' or 'col', got {wise!r}")


def _lib():
    from trx2dy_torch.ops import _build
    lib = _build.load("triangle_attention")
    fn = lib.trx2dy_tri_attn_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 11 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, bias):
    if q.device.type != "cuda":
        raise ValueError(f"tri_attn_core: tensors must be on a CUDA device, "
                         f"got {q.device}")
    L, L2, H, D = q.shape
    if L != L2 or D != D_HEAD:
        raise ValueError(f"q must be (L, L, H, {D_HEAD}), got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {q.device}, got "
                             f"{t.dtype} on {t.device}")
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                             f"{tuple(q.shape)}")
        if t.stride(3) != 1 or t.stride(2) != D:
            raise ValueError(f"{name} needs contiguous (H, D) trailing axes, "
                             f"strides {t.stride()}")
        if t.data_ptr() % 16 or t.stride(0) % 4 or t.stride(1) % 4:
            raise ValueError(f"{name} must be 16-byte aligned per (row, "
                             f"position, head) vector")
    if bias.device != q.device or bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32 on {q.device}")
    if bias.shape != (L, L, H):
        raise ValueError(f"bias must be {(L, L, H)}, got {tuple(bias.shape)}")


def tri_attn_core(q, k, v, bias, wise: str):
    """Row- or column-wise triangle attention core, (L, L, H, D) out.

    q, k, v: (L, L, H, D=32) float32, any strides on the first two axes;
    bias: (L, L, H) float32. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return tri_attn_core_plain(q, k, v, bias, wise)
    _check(q, k, v, bias)
    if wise not in ("row", "col"):
        raise ValueError(f"wise must be 'row' or 'col', got {wise!r}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    views = (q, k, v, out)
    if wise == "col":   # column l becomes the kernel's row axis
        views = tuple(t.transpose(0, 1) for t in views)
    qv, kv, vv, ov = views
    L, _, H, D = q.shape
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(qv.data_ptr(), kv.data_ptr(), vv.data_ptr(),
                 bias.data_ptr(), ov.data_ptr(), L, H, D,
                 qv.stride(0), qv.stride(1), kv.stride(0), kv.stride(1),
                 vv.stride(0), vv.stride(1), ov.stride(0), ov.stride(1),
                 bias.stride(0), bias.stride(1), bias.stride(2), stream)
    if err != 0:
        raise RuntimeError(f"triangle attention kernel launch failed: "
                           f"cudaError {err}")
    tri_attn_core.launches += 1
    return out


tri_attn_core.launches = 0
