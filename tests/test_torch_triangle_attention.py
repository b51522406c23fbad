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
import trx2dy_torch.models.predictor2d as p2d
from trx2dy_torch.models.predictor2d import TriangleAttention
from trx2dy_torch.ops.triangle_attention import (
    _check, needs_grad, tri_attn_core, tri_attn_core_plain,
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


@pytest.mark.parametrize("wise", ["row", "col"])
def test_plain_core_on_bf16_inputs_is_the_float32_function(wise):
    """bf16 q, k, v and bias (or a float32 bias) give, bit for bit, what
    the same values give in float32: the function the bf16 kernel
    computes."""
    q, k, v, b = (torch.from_numpy(t).to(torch.bfloat16)
                  for t in _inputs(6, seed=13))
    ref = tri_attn_core_plain(q.float(), k.float(), v.float(), b.float(),
                              wise)
    for bias in (b, b.float()):
        out = tri_attn_core_plain(q, k, v, bias, wise)
        assert out.dtype == torch.float32 and torch.equal(out, ref)


def _bf16_trunc(x):
    """float32 with its low 16 bits cleared (bf16 by truncation), as the
    bf16 kernel splits P with integers."""
    return (x.view(torch.int32) & -0x10000).view(torch.float32)


def _bf16_kernel_attend(x, v, drop_lo=False, tile=32):
    """softmax(x) @ v, x in log2 units (rows, keys), v bf16 (keys, D), as
    the bf16 kernel groups it in float32: per 32-key tile the running max,
    P = hi + mid + lo split by masks, pv_hi = hi.v and pv_lo = lo.v + mid.v
    in their own accumulators, then o = fma(o, c, pv_hi + pv_lo) (each
    product of two float32 is exact in float64, so the FMA is one
    rounding); drop_lo leaves lo out."""
    vf = v.float()
    o = torch.zeros(x.shape[0], vf.shape[1])
    m = torch.full((x.shape[0], 1), -float("inf"))
    l = torch.zeros(x.shape[0], 1)
    for j in range(0, x.shape[1], tile):
        xt, vt = x[:, j:j + tile], vf[j:j + tile]
        m_new = torch.maximum(m, xt.max(-1, keepdim=True).values)
        c, m = torch.exp2(m - m_new), m_new            # 0 on the first tile
        p = torch.exp2(xt - m)
        hi = _bf16_trunc(p)
        mid = _bf16_trunc(p - hi)
        lo = p - hi - mid
        for term in (hi, mid, lo):                     # each exact in bf16
            assert torch.equal(term.to(torch.bfloat16).float(), term)
        assert torch.equal(hi + mid + lo, p)
        pv_hi = hi @ vt
        pv_lo = mid @ vt if drop_lo else lo @ vt + mid @ vt
        o = (o.double() * c.double() + (pv_hi + pv_lo).double()).float()
        l = l * c + p.sum(-1, keepdim=True)
    return o / l


def test_bf16_p_split_keeps_float32_accuracy():
    """The bf16 kernel's P.V, checked where it cannot run: on bf16 q, k, v
    and a float32 bias (L=96, D=32), its float32 grouping of the three
    exact bf16 terms of P (hi, mid, lo, each product with bf16 V exact) is
    within 1e-6 of float64 relative to sum p |v| / sum p, while leaving lo
    out (the top 16 significant bits of P) is not within 2e-6."""
    L = 96
    q, k, v, b = (torch.from_numpy(t) for t in _inputs(L, seed=22))
    qb, kb, vb = (t[0, :, 0].to(torch.bfloat16) for t in (q, k, v))
    scale = np.float32(np.log2(np.e) / np.sqrt(D))
    x = (qb.float() @ kb.float().T) * scale + b[:, :, 0]     # log2 units
    w = torch.softmax(x.double() * np.log(2.0), dim=-1)
    exact, mag = w @ vb.double(), w @ vb.double().abs()
    err = lambda o: ((o.double() - exact).abs() / mag).max().item()
    assert err(_bf16_kernel_attend(x, vb)) <= 1e-6
    assert err(_bf16_kernel_attend(x, vb, drop_lo=True)) > 2e-6


def test_check_takes_bf16_operands_and_refuses_mixed_dtypes():
    """bf16 q, k, v pass every check but the device one with a bf16 or a
    float32 bias; mixed q, k, v dtypes, a bf16 bias with float32 q, k, v
    and other dtypes are refused for their dtype."""
    q, k, v, b = (torch.from_numpy(t) for t in _inputs(8, seed=7))
    bf = lambda *ts: tuple(t.to(torch.bfloat16) for t in ts)
    for args in (bf(q, k, v, b), bf(q, k, v) + (b,)):
        with pytest.raises(ValueError, match="CUDA device"):
            _check(*args)
    for args in ((q, *bf(k), v, b), (*bf(q, k), v, b), (q, k, v, *bf(b)),
                 bf(q, k, v) + (b.half(),),
                 tuple(t.half() for t in (q, k, v, b))):
        with pytest.raises(ValueError, match="dtype"):
            _check(*args)


def test_wrapper_counts_no_launch_on_cpu():
    q, k, v, b = (torch.from_numpy(t) for t in _inputs(8, seed=5))
    before = tri_attn_core.launches
    tri_attn_core(q, k, v, b, "row")
    assert tri_attn_core.launches == before


def test_check_rejects_cpu_tensors():
    q, k, v, b = (torch.from_numpy(t) for t in _inputs(8, seed=6))
    with pytest.raises(ValueError, match="CUDA"):
        _check(q, k, v, b)



# --------------------------------------------------------------------------
# the kernel is forward-only: where autograd needs its gradient it raises
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["grad", "bias_grad", "no_grad",
                                  "inference_mode", "no_requires_grad"])
def test_needs_grad_decides_where_autograd_records(case):
    q, k, v, b = (torch.from_numpy(t) for t in _inputs(4, seed=8))
    if case == "bias_grad":
        b.requires_grad_(True)
    elif case != "no_requires_grad":
        q.requires_grad_(True)
    if case == "no_grad":
        ctx = torch.no_grad()
    elif case == "inference_mode":
        ctx = torch.inference_mode()
    else:
        ctx = torch.enable_grad()
    with ctx:
        assert needs_grad(q, k, v, b) == (case in ("grad", "bias_grad"))


def test_logits_path_trains_without_the_kernel_wrapper(depth1_params,
                                                       monkeypatch):
    """use_flash=False (training) never reaches tri_attn_core and gives
    to_qkv and linear_for_pair a gradient; use_flash=True goes through
    tri_attn_core."""
    prefix = "net.net.blocks.0.0.pair_row_attn."
    mod = TriangleAttention("row")
    mod.load_state_dict({k[len(prefix):]: v for k, v in
                         state_dict_from_flat(depth1_params).items()
                         if k.startswith(prefix)})
    z = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (6, 6, 128)).astype(np.float32))
    calls = []
    monkeypatch.setattr(p2d, "tri_attn_core",
                        lambda *a: calls.append(1) or tri_attn_core_plain(*a))
    mod(z, use_flash=False).square().sum().backward()
    assert not calls
    for lin in (mod.to_qkv, mod.linear_for_pair):
        assert lin.weight.grad.abs().max() > 0
    with torch.no_grad():
        mod(z)
    assert calls == [1]
