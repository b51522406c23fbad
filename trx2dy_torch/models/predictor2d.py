"""Predictor2D — the trRosettaX2 2D-geometry trunk, inference.

PyTorch counterpart of trx2dy/models/predictor2d.py (Predictor2D with
dim=128, depth=12, msa_tie_row_attn=True). Module and parameter names
follow the checkpoint's state_dict keys (prefix "net." from the Dynamics
checkpoints' DistPredictorBaseline wrapper, "net2d." inside the e2e
Folding model), so the pretrained `.pth` files and the JAX package's flat
param dicts load by name. `nn.Sequential` placeholders stand where a key
carries an index (`to_gate.0`, `linear2.1`, `feed_forward.3`). Some
parameters exist in the checkpoint and are never read, e.g.
`attn_width.pair_norm`/`pair_linear`; they are kept so the keys line up.

Per block (reference order):
  m += MSAAttention(LN(m), pair-bias x)   tied-row + column axial attention
  m += FF(LN(m))
  x  = UpdateX(x, m)                      MSA outer-product -> pair
  x  = TriUpdate(x)                       4x [tri-op + Res2Net conv] + trans
  m  = UpdateM(x, m)                      pair-attention -> MSA + FF

Two flavours share the module. The Dynamics one reads 526 pair features
and 21 MSA tokens. The e2e one (attn_conv_e2e.py:525-576) reads the 2642
ESM-MSA pair features and ESM-vocabulary tokens, adds `linear_emb` of the
ESM representations to the token embedding (msa_emb) and the recycling
embeddings to m[0] and x (rec_reprs), and can return its pair and MSA
representations; in_dim and the vocabulary come from the checkpoint.

Weights may be bfloat16 (convert.cast_params, the reference's autocast):
Linear and Conv2d then cast their input to the weight's dtype and add the
float32 bias after the product, and the norms keep float32 statistics and
return the input's dtype, as in JAX. So a projection without bias (to_q,
to_kv, to_qkv, linear_for_pair, pair_linear) yields bfloat16. The
triangle attention core takes float32 only: in bf16 mode its q, k, v and
pair bias are cast to float32 first, on the card and on the CPU alike, so
the kernel and its plain version compute one function; that core is then
more precise than JAX's bf16 einsums. With float32 weights every
operation is the one it was before bf16 existed.

Works unbatched and channel-last: pair x is (L, L, D), MSA m is (R, L, D).
Dropout is identity (inference only); remat is not part of this module.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from trx2dy_torch.ops.triangle_attention import tri_attn_core

DIM = 128
DEPTH = 12
HEADS = 8
DIM_HEAD = 64
IN_DIM = 526
N_TOKENS = 21
TRI_HEADS = 4
TRI_DIM_HEAD = 32
RES2_WIDTH = 52          # Res2Net: expansion 1, scale 4, baseWidth 26
_EPS = 1e-5


# --------------------------------------------------------------------------
# primitive layers
# --------------------------------------------------------------------------

class Linear(nn.Linear):
    """nn.Linear; with a weight of another dtype than float32 (bf16), the
    input is cast to it and the float32 bias added after the product."""

    def forward(self, x):
        w, b = self.weight, self.bias
        if w.dtype == torch.float32 and x.dtype == torch.float32:
            return F.linear(x, w, b)
        y = F.linear(x.to(w.dtype), w)
        return y if b is None else y + b


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with statistics in float32, output in the input dtype."""

    def __init__(self, d: int):
        super().__init__(d, eps=_EPS)

    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True) on channel-last (H, W, C) input, with
    statistics in float32."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        x32 = x.float()
        var, mu = torch.var_mean(x32, dim=(0, 1), keepdim=True,
                                 correction=0)
        out = (x32 - mu) / torch.sqrt(var + _EPS) * self.weight.float() \
            + self.bias.float()
        return out.to(x.dtype)


class Conv2d(nn.Conv2d):
    """Conv2d on channel-last (H, W, C); weight kept OIHW. 1x1 runs as a
    product, 3x3 as a stride-1 SAME convolution. With a bf16 weight the
    input is cast to it and the float32 bias added after, as Linear."""

    def __init__(self, i: int, o: int, k: int):
        super().__init__(i, o, k, padding=k // 2)

    def forward(self, x):
        w, b = self.weight, self.bias
        cast = w.dtype != torch.float32 or x.dtype != torch.float32
        fused_b = None if cast else b
        x = x.to(w.dtype)
        if self.kernel_size == (1, 1):
            y = F.linear(x, w[:, :, 0, 0], fused_b)
        else:
            y = F.conv2d(x.permute(2, 0, 1)[None], w, fused_b,
                         padding=self.padding)[0].permute(1, 2, 0)
        return y + b if cast else y


class FeedForward(nn.Module):
    """Linear(d, 4d), ReLU, [Dropout], Linear(4d, d)."""

    def __init__(self, d: int):
        super().__init__()
        self.feed_forward = nn.Sequential(
            Linear(d, 4 * d), nn.ReLU(), nn.Identity(), Linear(4 * d, d))

    def forward(self, x):
        return self.feed_forward(x)


# --------------------------------------------------------------------------
# pair blocks
# --------------------------------------------------------------------------

class Bottle2neck(nn.Module):
    """Res2Net bottleneck: expansion=1, scale=4, width 52, no shortcut."""

    def __init__(self, d: int = DIM):
        super().__init__()
        w = RES2_WIDTH
        self.bn1 = InstanceNorm(d)
        self.conv1 = Conv2d(d, 4 * w, 1)
        self.bns = nn.ModuleList(InstanceNorm(w) for _ in range(3))
        self.convs = nn.ModuleList(Conv2d(w, w, 3) for _ in range(3))
        self.bn3 = InstanceNorm(4 * w)
        self.conv3 = Conv2d(4 * w, d, 1)

    def forward(self, x):
        out = self.conv1(F.elu(self.bn1(x)))
        spx = torch.split(out, RES2_WIDTH, dim=-1)
        outs = []
        sp = None
        for i in range(3):
            sp = spx[i] if i == 0 else sp + spx[i]
            sp = self.convs[i](F.elu(self.bns[i](sp)))
            outs.append(sp)
        out = torch.cat(outs + [spx[3]], dim=-1)
        return self.conv3(F.elu(self.bn3(out)))


class TriangleMultiplication(nn.Module):
    def __init__(self, direct: str, d: int = DIM):
        super().__init__()
        self.direct = direct
        self.norm = LayerNorm(d)
        self.linear1 = Linear(d, 2 * d)
        self.linear2 = nn.Sequential(Linear(d, 2 * d), nn.Sigmoid())
        self.to_gate = nn.Sequential(Linear(d, d), nn.Sigmoid())
        self.to_out = nn.Sequential(LayerNorm(d))
        self.linear_out = Linear(d, d)

    def forward(self, z):
        z = self.norm(z)
        a, b = torch.chunk(self.linear2(z) * self.linear1(z), 2, dim=-1)
        gate = self.to_gate(z)
        if self.direct == "outgoing":
            prod = torch.einsum("ikd,jkd->ijd", a, b)
        else:
            prod = torch.einsum("kid,kjd->ijd", a, b)
        return gate * self.linear_out(self.to_out(prod))


class TriangleAttention(nn.Module):
    """Gated triangle attention; the core goes through tri_attn_core (the
    CUDA kernel on the card, the logits path on the CPU)."""

    def __init__(self, wise: str, d: int = DIM):
        super().__init__()
        self.wise = wise
        hd = TRI_HEADS * TRI_DIM_HEAD
        self.norm = LayerNorm(d)
        self.to_qkv = Linear(d, 3 * hd, bias=False)
        self.linear_for_pair = Linear(d, TRI_HEADS, bias=False)
        self.to_gate = nn.Sequential(Linear(d, d), nn.Sigmoid())
        self.to_out = Linear(hd, d)

    def forward(self, z):
        z = self.norm(z)
        L = z.shape[0]
        # the core runs in float32 (a no-op cast with float32 weights)
        q, k, v = (t.reshape(L, L, TRI_HEADS, TRI_DIM_HEAD)
                   for t in torch.chunk(self.to_qkv(z).float(), 3, dim=-1))
        # (L, L, H) as a view of a head-major (H, L, L) product, so that
        # the kernel reads each head's bias tile contiguously
        w = self.linear_for_pair.weight
        bias = torch.matmul(w, z.reshape(L * L, -1).T.to(w.dtype)).float() \
            .reshape(-1, L, L).permute(1, 2, 0)
        gate = self.to_gate(z)
        out = tri_attn_core(q, k, v, bias, self.wise)
        return self.to_out(gate * out.reshape(L, L, -1))


class PairTransition(nn.Module):
    def __init__(self, d: int = DIM):
        super().__init__()
        self.norm = LayerNorm(d)
        self.linear1 = Linear(d, 4 * d)
        self.linear2 = nn.Sequential(nn.ReLU(), Linear(4 * d, d))

    def forward(self, z):
        return self.linear2(self.linear1(self.norm(z)))


class TriUpdate(nn.Module):
    """4x [triangle op + Res2Net conv stem] + pair transition."""

    def __init__(self, d: int = DIM):
        super().__init__()
        self.pair_multi_out = TriangleMultiplication("outgoing", d)
        self.pair_multi_in = TriangleMultiplication("incoming", d)
        self.pair_row_attn = TriangleAttention("row", d)
        self.pair_col_attn = TriangleAttention("col", d)
        self.pair_trans = PairTransition(d)
        self.conv_stem = nn.ModuleList(
            nn.Sequential(nn.Identity(), Bottle2neck(d)) for _ in range(4))

    def forward(self, z):
        ops = (self.pair_multi_out, self.pair_multi_in,
               self.pair_row_attn, self.pair_col_attn)
        for op, stem in zip(ops, self.conv_stem):
            z = z + op(z) + stem(z)
        return z + self.pair_trans(z)


# --------------------------------------------------------------------------
# MSA blocks
# --------------------------------------------------------------------------

class SelfAttention(nn.Module):
    """One axial attention of MSAAttention. `pair_norm`/`pair_linear` are
    read only by the tied-row (height) attention."""

    def __init__(self, d: int = DIM):
        super().__init__()
        inner = HEADS * DIM_HEAD
        self.to_q = Linear(d, inner, bias=False)
        self.to_kv = Linear(d, 2 * inner, bias=False)
        self.to_out = Linear(inner, d)
        self.pair_norm = LayerNorm(d)
        self.pair_linear = Linear(d, HEADS, bias=False)

    def _qkv(self, x):
        k, v = torch.chunk(self.to_kv(x), 2, dim=-1)
        shape = x.shape[:2] + (HEADS, DIM_HEAD)
        return self.to_q(x).reshape(shape), k.reshape(shape), v.reshape(shape)

    def column(self, m):
        """Attention along the row axis R of (R, L, D), batched over L."""
        x = m.transpose(0, 1)                                # (L, R, D)
        q, k, v = self._qkv(x)
        dots = torch.einsum("bihd,bjhd->bhij", q, k) * DIM_HEAD ** -0.5
        out = torch.einsum("bhij,bjhd->bihd", torch.softmax(dots, dim=-1), v)
        out = self.to_out(out.reshape(x.shape[0], x.shape[1], -1))
        return out.transpose(0, 1)

    def row_tied(self, m, pair):
        """Tied-row attention with pair bias, shared across the R rows."""
        R = m.shape[0]
        q, k, v = self._qkv(m)
        scale = DIM_HEAD ** -0.5 * R ** -0.5
        dots = torch.einsum("rihd,rjhd->hij", q, k) * scale
        pb = self.pair_linear(self.pair_norm(pair))          # (L, L, H)
        attn = torch.softmax(dots + pb.permute(2, 0, 1), dim=-1)
        out = torch.einsum("hij,rjhd->rihd", attn, v)
        return self.to_out(out.reshape(R, m.shape[1], -1))


class MSAAttention(nn.Module):
    def __init__(self, d: int = DIM):
        super().__init__()
        self.attn_width = SelfAttention(d)
        self.attn_height = SelfAttention(d)

    def forward(self, m, pair):
        return (self.attn_width.column(m)
                + self.attn_height.row_tied(m, pair)) / 2.0


class PreNorm(nn.Module):
    def __init__(self, fn: nn.Module, d: int = DIM):
        super().__init__()
        self.norm = LayerNorm(d)
        self.fn = fn

    def forward(self, x, *args):
        return self.fn(self.norm(x), *args)


class UpdateX(nn.Module):
    """MSA outer product -> pair update."""

    def __init__(self, d: int = DIM):
        super().__init__()
        self.proj_down1 = Linear(d, 32)
        self.proj_down2 = Linear(32 * 32, d)

    def forward(self, x, m):
        mm = self.proj_down1(m)                              # (R, L, 32)
        outer = torch.einsum("rid,rjc->ijcd", mm, mm) / mm.shape[0]
        return x + self.proj_down2(outer.reshape(x.shape[0], x.shape[1], -1))


class UpdateM(nn.Module):
    """Pair-derived attention over the MSA, then a feed-forward."""

    def __init__(self, d: int = DIM):
        super().__init__()
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)
        self.norm3 = LayerNorm(d)
        self.linear1 = Linear(d, HEADS)
        self.linear2 = Linear(d, d // HEADS)
        self.ff = FeedForward(d)

    def forward(self, x, m):
        pair = self.norm1((x + x.transpose(0, 1)) / 2.0)
        attn = torch.softmax(self.linear1(pair), dim=-2)     # over j
        values = self.linear2(self.norm2(m))                 # (R, L, d/h)
        out = m + torch.einsum("ijh,rjd->rihd", attn, values).reshape(m.shape)
        return out + self.ff(self.norm3(out))


class TrunkBlock(nn.ModuleList):
    """Indices 0..4 as in the checkpoint: TriUpdate, PreNorm(MSAAttention),
    UpdateX, PreNorm(FeedForward), UpdateM."""

    def __init__(self, d: int = DIM):
        super().__init__([TriUpdate(d), PreNorm(MSAAttention(d), d),
                          UpdateX(d), PreNorm(FeedForward(d), d), UpdateM(d)])

    def forward(self, x, m):
        tri, msa_attn, upd_x, ff, upd_m = self
        m = m + msa_attn(m, x)
        m = m + ff(m)
        x = upd_x(x, m)
        x = tri(x)
        return x, upd_m(x, m)


class Trunk(nn.Module):
    def __init__(self, depth: int, d: int = DIM):
        super().__init__()
        self.blocks = nn.ModuleList(TrunkBlock(d) for _ in range(depth))


class RelPos(nn.Module):
    """Clamp i-j to +-32, one-hot over 65 offsets, linear."""

    def __init__(self, d: int = DIM):
        super().__init__()
        self.linear = Linear(65, d)

    def forward(self, res_id):
        rel = (res_id[:, None] - res_id[None, :]).clamp(-32, 32) + 32
        return self.linear(F.one_hot(rel, 65).to(self.linear.weight.dtype))


class InputEmb(nn.Module):
    def __init__(self, d: int = DIM):
        super().__init__()
        self.relpos = RelPos(d)


class Predictor2D(nn.Module):
    """emb_dim: the width of the ESM representations read by `linear_emb`
    (the e2e flavour); None for the Dynamics flavour, which has none."""

    def __init__(self, depth: int = DEPTH, d: int = DIM, in_dim: int = IN_DIM,
                 n_tokens: int = N_TOKENS, emb_dim: Optional[int] = None):
        super().__init__()
        self.bn1 = InstanceNorm(in_dim)
        self.conv1 = Conv2d(in_dim, d, 1)
        self.token_emb = nn.Embedding(n_tokens, d)
        if emb_dim is not None:
            self.linear_emb = Linear(emb_dim, d)
        self.input_emb = InputEmb(d)
        self.net = Trunk(depth, d)
        self.to_dist_logits = Conv2d(d, 37, 1)
        self.to_theta_logits = Conv2d(d, 25, 1)
        self.to_omega_logits = Conv2d(d, 25, 1)
        self.to_phi_logits = Conv2d(d, 13, 1)

    def forward(self, f2d, msa, msa_emb=None, rec_reprs=None,
                return_repr: bool = False, depth: Optional[int] = None):
        """f2d (L, L, in_dim) features, msa (R, L) tokens already capped to
        the trunk's rows. e2e only: msa_emb (R, L, emb_dim) ESM
        representations; rec_reprs {'single': (L, d), 'pair': (L, L, d)}
        recycling embeddings; depth runs the first `depth` blocks. Returns
        LOGITS {dist (L,L,37), omega (L,L,25), theta (L,L,25), phi
        (L,L,13)}, the caller applies the softmax; with return_repr also
        {'pair': x, 'msa': m}."""
        x = self.conv1(F.elu(self.bn1(f2d)))                 # (L, L, d)
        m = self.token_emb(msa.long())                       # (R, L, d)
        if msa_emb is not None:
            m = m + self.linear_emb(msa_emb)
        if rec_reprs is not None:
            m[0] += rec_reprs["single"]          # m's dtype, as JAX
            x = x + rec_reprs["pair"]
        x = x + self.input_emb.relpos(
            torch.arange(f2d.shape[0], device=f2d.device))
        for block in self.net.blocks[:depth]:
            x, m = block(x, m)
        sym = (x + x.transpose(0, 1)) * 0.5
        out = {
            "dist": self.to_dist_logits(sym),
            "theta": self.to_theta_logits(x),
            "omega": self.to_omega_logits(sym),
            "phi": self.to_phi_logits(x),
        }
        if return_repr:
            return out, {"pair": x, "msa": m}
        return out


class DistPredictor(nn.Module):
    """The checkpoint's wrapper: every key sits under `net.`."""

    def __init__(self, depth: int = DEPTH, d: int = DIM, in_dim: int = IN_DIM):
        super().__init__()
        self.net = Predictor2D(depth, d, in_dim)

    def forward(self, f2d, msa):
        return self.net(f2d, msa)
