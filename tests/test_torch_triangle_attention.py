"""The port's triangle attention against the JAX package, on the CPU.

On the CPU the port's wrapper takes its plain version (the logits path),
so these tests hold that arithmetic, the modules around it and the weight
carry against the Pallas kernel in interpret mode, the JAX logits path and
an exact float64 computation. The CUDA kernel itself has no CPU mode; it
is held against the plain version on the card by chip_smoke.py (this file
imports JAX, which the GPU machine does not have).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from trx2dy.models.predictor2d import triangle_attention as jax_tri_attn
from trx2dy.ops.triangle_attention import (
    triangle_attention_flash, triangle_attention_pallas,
)
from trx2dy_torch.models.convert import init_state_dict, state_dict_from_flat
from trx2dy_torch.models.predictor2d import TriangleAttention
from trx2dy_torch.ops.triangle_attention import (
    _check, tri_attn_core, tri_attn_core_plain,
)

torch.set_num_threads(2)

H, D = 4, 32


def _inputs(L, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((L, L, H, D)).astype(np.float32)
               for _ in range(3))
    b = rng.standard_normal((L, L, H)).astype(np.float32)
    return q, k, v, b


def _exact(q, k, v, b, wise):
    """float64 triangle attention; column-wise by swapping axes 0 and 1."""
    if wise == "col":
        q, k, v = (np.swapaxes(t, 0, 1) for t in (q, k, v))
    q, k, v, b = (t.astype(np.float64) for t in (q, k, v, b))
    logits = np.einsum("rihd,rjhd->rijh", q, k) / D ** 0.5 + b[None]
    logits -= logits.max(axis=2, keepdims=True)
    p = np.exp(logits)
    out = np.einsum("rijh,rjhd->rihd", p / p.sum(axis=2, keepdims=True), v)
    return np.swapaxes(out, 0, 1) if wise == "col" else out


@pytest.mark.parametrize("wise", ["row", "col"])
@pytest.mark.parametrize("L", [10, 16])
def test_plain_core_matches_flash_and_exact(L, wise):
    q, k, v, b = _inputs(L, seed=L)
    port = tri_attn_core(*(torch.from_numpy(t) for t in (q, k, v, b)),
                         wise).numpy()
    if wise == "row":
        flash = triangle_attention_flash(q, k, v, b, interpret=True)
    else:
        flash = jnp.swapaxes(triangle_attention_flash(
            *(np.swapaxes(t, 0, 1) for t in (q, k, v)), b, interpret=True),
            0, 1)
    exact = _exact(q, k, v, b, wise)
    assert port.shape == (L, L, H, D)
    # f32 logits path against f64: rounding of 32-term dots and the softmax
    assert np.abs(port - exact).max() < 1e-5
    # against the Pallas kernel: the tolerance of tests/test_pallas_ops.py
    assert np.abs(port - np.asarray(flash)).max() < 5e-3


def test_plain_core_float64_is_exact():
    q, k, v, b = _inputs(10, seed=3)
    for wise in ("row", "col"):
        out = tri_attn_core_plain(
            *(torch.from_numpy(t.astype(np.float64)) for t in (q, k, v, b)),
            wise).numpy()
        assert np.abs(out - _exact(q, k, v, b, wise)).max() < 1e-12


@pytest.fixture(scope="module")
def depth1_params():
    """Depth-1 params with noise on biases and norm weights."""
    return init_state_dict(seed=7, depth=1)


@pytest.mark.parametrize("wise", ["row", "col"])
def test_module_matches_pallas_and_logits(depth1_params, wise):
    name = f"net.net.blocks.0.0.pair_{wise}_attn"
    prefix = name + "."
    mod = TriangleAttention(wise)
    mod.load_state_dict({k[len(prefix):]: v for k, v in
                         state_dict_from_flat(depth1_params).items()
                         if k.startswith(prefix)})
    z = np.random.default_rng(11).standard_normal((14, 14, 128)) \
        .astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in depth1_params.items()
          if k.startswith(prefix)}
    ref = np.asarray(jax_tri_attn(jp, name, jnp.asarray(z), wise))
    pallas = np.asarray(triangle_attention_pallas(jp, name, jnp.asarray(z),
                                                  wise, interpret=True))
    with torch.no_grad():
        port = mod(torch.from_numpy(z)).numpy()
    # same f32 arithmetic in another order (outputs are O(1))
    assert np.abs(port - ref).max() < 1e-4
    assert np.abs(port - pallas).max() < 1e-3


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits, nearest, ties away from
    zero): cvt.rna.tf32.f32, as the kernel computes it with integers."""
    b = x.view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _products(a, b):
    """(3xTF32, single-pass TF32) a @ b as the kernel's mma products form
    them: TF32 operands, exact products, accumulated here in float64 so
    that only the split is measured."""
    ahi, bhi = _tf32(a), _tf32(b)
    alo, blo = _tf32(a - ahi), _tf32(b - bhi)
    d = torch.float64
    three = (alo.to(d) @ bhi.to(d) + ahi.to(d) @ blo.to(d)) \
        + ahi.to(d) @ bhi.to(d)
    return three, ahi.to(d) @ bhi.to(d)


def test_3xtf32_split_keeps_float32_accuracy():
    """The kernel's accuracy assumption, checked where it cannot run: on
    trunk-shaped q.k^T (D=32, scaled as the kernel scales q) and p.v
    (a softmax row over L keys), the 3xTF32 product is within 1e-6 of the
    float64 product relative to sum |a_i b_i| (its bound is 3 * 2^-22),
    while single-pass TF32 is not within 1e-4."""
    assert torch.equal(_tf32(torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                                           1.0 + 2.0 ** -12, 3.0])),
                       torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                     1.0, 3.0]))
    L = 96
    q, k, v, b = (torch.from_numpy(t) for t in _inputs(L, seed=21))
    scale = np.float32(np.log2(np.e) / np.sqrt(D))
    qs, kt = q[0, :, 0] * scale, k[0, :, 0].T.contiguous()   # (L, D), (D, L)
    s = torch.softmax(qs @ kt + b[:, :, 0], dim=-1)           # (L, L)
    for a, bb in ((qs, kt), (s, v[0, :, 0])):
        exact = a.double() @ bb.double()
        mag = a.double().abs() @ bb.double().abs()
        three, one = _products(a.contiguous(), bb.contiguous())
        assert ((three - exact).abs() / mag).max() <= 1e-6
        assert ((one - exact).abs() / mag).max() > 1e-4


def test_wrapper_counts_no_launch_on_cpu():
    q, k, v, b = (torch.from_numpy(t) for t in _inputs(8, seed=5))
    before = tri_attn_core.launches
    tri_attn_core(q, k, v, b, "row")
    assert tri_attn_core.launches == before


def test_check_rejects_cpu_tensors():
    q, k, v, b = (torch.from_numpy(t) for t in _inputs(8, seed=6))
    with pytest.raises(ValueError, match="CUDA"):
        _check(q, k, v, b)

