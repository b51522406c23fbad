"""Triangle attention core: the CUDA kernel, its plain version, the wrapper.

The kernel (csrc/triangle_attention.cu) replaces the Pallas TPU kernel
trx2dy/ops/triangle_attention.py:_tri_attn_kernel. It computes, for row
r, query i and head h,

  out[r,i,h,:] = sum_j softmax_j(q[r,i,h].k[r,j,h] / sqrt(D) + bias[i,j,h])
                 v[r,j,h,:]

without the (L, L, L, H) logits, with float32 accuracy on the tensor
cores (see the source). The dtype of q, k and v picks the kernel: float32
ones take the 3xTF32 kernel; bf16 ones (the bf16 models' products, passed
without a cast) take the bf16-operand kernel, which computes the same
float32 function of those values (q.k as one exact bf16 product, P.V
with P split exactly into three bf16 terms, the bias, bf16 or float32,
read once for several rows). The output is float32 either way.
Column-wise attention is the same function on exchanged row and position
axes of q, k, v and out, with the bias untransposed; the wrapper passes
swapped strides, so no transposed copy is made. The bias may have any
strides; a head-major one (the trunk's) is read contiguously. Row-wise,
the rows need not number L: q, k, v and out may be (R, L, H, D) for any
R >= 1, which is the MSA row attention with pair bias of AlphaFold2's
Evoformer (R the MSA's depth, the bias (L, L, H) from the pair
representation). Column-wise calls keep R = L.

`tri_attn_core` launches a kernel for CUDA tensors (or raises) and takes
the plain version only for CPU tensors. `tri_attn_core.launches` counts
kernel launches, `tri_attn_core.launches_bf16` those of the bf16 kernel.
The kernels are forward-only, as the TPU kernel is (a `pallas_call` with
no VJP, so `jax.grad` through it raises): where autograd would need the
core's gradient, a CUDA call raises rather than return an output with no
graph. Training takes the logits path
(`tri_attn_core_plain`), as the JAX package's does.
"""
from __future__ import annotations

import ctypes

import torch

D_HEAD = 32


def tri_attn_core_plain(q, k, v, bias, wise: str):
    """The logits path of trx2dy/models/predictor2d.py:206-216 in torch.

    q, k, v: (R, L, H, D), R = L column-wise; bias: (L, L, H). Returns
    (R, L, H, D). bf16 inputs are cast to float32 first: the function the
    kernels compute on them."""
    q, k, v, bias = (t.float() if t.dtype == torch.bfloat16 else t
                     for t in (q, k, v, bias))
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
    """The library's two entries: (float32, bf16)."""
    from trx2dy_torch.ops import _build
    lib = _build.load("triangle_attention")
    f32, bf16 = lib.trx2dy_tri_attn_fwd, lib.trx2dy_tri_attn_fwd_bf16
    if f32.argtypes is None:
        f32.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                        + [ctypes.c_longlong] * 11 + [ctypes.c_void_p])
        f32.restype = ctypes.c_int
    if bf16.argtypes is None:
        bf16.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                         + [ctypes.c_void_p] + [ctypes.c_int] * 4
                         + [ctypes.c_longlong] * 11 + [ctypes.c_void_p])
        bf16.restype = ctypes.c_int
    return f32, bf16


def _check(q, k, v, bias, wise: str = "row"):
    if q.dim() != 4 or q.shape[-1] != D_HEAD or 0 in q.shape:
        raise ValueError(f"q must be (R, L, H, {D_HEAD}), got "
                         f"{tuple(q.shape)}")
    R, L, H, _ = q.shape
    if wise == "col" and R != L:
        raise ValueError(f"column-wise q must be (L, L, H, {D_HEAD}), got "
                         f"{tuple(q.shape)}")
    if R > 65535 or L > 65535:
        raise ValueError(f"at most 65535 rows and positions, got "
                         f"{tuple(q.shape)}")
    if bias.shape != (L, L, H):
        raise ValueError(f"bias must be {(L, L, H)}, got {tuple(bias.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got dtype "
                         f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must have q's dtype {q.dtype} on "
                             f"{q.device}, got {t.dtype} on {t.device}")
        if t.shape != q.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != q shape "
                             f"{tuple(q.shape)}")
        if t.stride(3) != 1 or t.stride(2) != D_HEAD:
            raise ValueError(f"{name} needs contiguous (H, D) trailing axes, "
                             f"strides {t.stride()}")
        per = 16 // t.element_size()
        if t.data_ptr() % 16 or t.stride(0) % per or t.stride(1) % per:
            raise ValueError(f"{name} must be 16-byte aligned per (row, "
                             f"position, head) vector")
    bias_dtypes = (torch.float32,) if q.dtype == torch.float32 \
        else (torch.float32, torch.bfloat16)
    if bias.device != q.device or bias.dtype not in bias_dtypes:
        raise ValueError(f"bias must have dtype "
                         f"{' or '.join(map(str, bias_dtypes))} on "
                         f"{q.device}, got {bias.dtype} on {bias.device}")
    if q.device.type != "cuda":
        raise ValueError(f"tri_attn_core: tensors must be on a CUDA device, "
                         f"got {q.device}")


def needs_grad(*tensors) -> bool:
    """Whether autograd would record a gradient through these inputs."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def tri_attn_core(q, k, v, bias, wise: str):
    """Row- or column-wise triangle attention core, (R, L, H, D) out.

    q, k, v: (R, L, H, D=32), all float32 or all bf16, any strides on the
    first two axes, any R >= 1 row-wise and R = L column-wise; bias:
    (L, L, H), float32 (bf16 too with bf16 q, k, v). Returns float32. CPU
    tensors take the plain version; CUDA tensors launch the kernel of
    their dtype or raise, also where a gradient is needed (the kernels
    have no backward)."""
    if q.device.type == "cpu":
        return tri_attn_core_plain(q, k, v, bias, wise)
    if needs_grad(q, k, v, bias):
        raise RuntimeError(
            "tri_attn_core: the CUDA kernel is forward-only and autograd "
            "needs its gradient; run inference under torch.no_grad() or "
            "torch.inference_mode(), or take the logits path "
            "(Predictor2D(..., use_flash=False), as training does)")
    if wise not in ("row", "col"):
        raise ValueError(f"wise must be 'row' or 'col', got {wise!r}")
    _check(q, k, v, bias, wise)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    views = (q, k, v, out)
    if wise == "col":   # column l becomes the kernel's row axis
        views = tuple(t.transpose(0, 1) for t in views)
    qv, kv, vv, ov = views
    R, L, H, D = q.shape
    f32, bf16 = _lib()
    bf16_path = q.dtype == torch.bfloat16
    pointers = (qv.data_ptr(), kv.data_ptr(), vv.data_ptr(), bias.data_ptr())
    if bf16_path:
        pointers += (int(bias.dtype == torch.bfloat16),)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = (bf16 if bf16_path else f32)(
            *pointers, ov.data_ptr(), R, L, H, D,
            qv.stride(0), qv.stride(1), kv.stride(0), kv.stride(1),
            vv.stride(0), vv.stride(1), ov.stride(0), ov.stride(1),
            bias.stride(0), bias.stride(1), bias.stride(2), stream)
    if err != 0:
        raise RuntimeError(f"triangle attention kernel launch failed: "
                           f"cudaError {err}")
    tri_attn_core.launches += 1
    tri_attn_core.launches_bf16 += int(bf16_path)
    return out


tri_attn_core.launches = 0
tri_attn_core.launches_bf16 = 0
