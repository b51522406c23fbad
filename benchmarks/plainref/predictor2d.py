"""Predictor2D, the trRosettaX2 2D-geometry network, in plain PyTorch.

A frozen copy of the port's plain path (trx2dy_torch/models/predictor2d.py
as of the benchmark's first version), cut to what the benchmark's
reference needs: float32 only (a bf16 model's weights are handed over
upcast), the triangle attention on its logits path (the (L, L, L, H)
logits, no kernel), one process (no MSA rows split over ranks), no
dropout; each block can be recomputed in the backward pass (remat) so
that a train step fits beside nothing else. Every product goes through
plainref.lowp, so the control can lower its precision. Module and
parameter names are the checkpoint's, so the benchmark's state dicts load
into it by name.

Per block (reference order, evoutils/attn_conv.py:476):
  m += MSAAttention(LN(m), pair-bias x)   tied-row + column axial attention
  m += FF(LN(m))
  x  = UpdateX(x, m)                      MSA outer-product -> pair
  x  = TriUpdate(x)                       4x [tri-op + Res2Net conv] + trans
  m  = UpdateM(x, m)                      pair-attention -> MSA + FF

The e2e flavour (attn_conv_e2e.py:525-576) adds `linear_emb` of the ESM
representations to the token embedding (msa_emb) and the recycling
embeddings (rec_reprs), and can return its pair and MSA representations.
Unbatched and channel-last: pair x is (L, L, D), MSA m is (R, L, D).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from plainref import lowp

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


class Linear(nn.Linear):
    def forward(self, x):
        return lowp.linear(x, self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    def __init__(self, d: int):
        super().__init__(d, eps=_EPS)


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True) on channel-last (H, W, C) input."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        var, mu = torch.var_mean(x, dim=(0, 1), keepdim=True, correction=0)
        return (x - mu) / torch.sqrt(var + _EPS) * self.weight + self.bias


class Conv2d(nn.Conv2d):
    """Conv2d on channel-last (H, W, C); weight OIHW, SAME padding."""

    def __init__(self, i: int, o: int, k: int):
        super().__init__(i, o, k, padding=k // 2)

    def forward(self, x):
        w, b = self.weight, self.bias
        if self.kernel_size == (1, 1):
            return lowp.linear(x, w[:, :, 0, 0], b)
        return lowp.conv2d(x.permute(2, 0, 1)[None], w, b,
                           padding=self.padding)[0].permute(1, 2, 0)


class FeedForward(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.feed_forward = nn.Sequential(
            Linear(d, 4 * d), nn.ReLU(), nn.Identity(), Linear(4 * d, d))

    def forward(self, x):
        return self.feed_forward[3](F.relu(self.feed_forward[0](x)))


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
            prod = lowp.einsum("ikd,jkd->ijd", a, b)
        else:
            prod = lowp.einsum("kid,kjd->ijd", a, b)
        return gate * self.linear_out(self.to_out(prod))


def tri_attn_logits(q, k, v, bias, wise: str):
    """Row- or column-wise triangle attention through its (L, L, L, H)
    logits. q, k, v: (L, L, H, D); bias: (L, L, H)."""
    scale = q.shape[-1] ** 0.5
    if wise == "row":
        attn = torch.softmax(
            lowp.einsum("rihd,rjhd->rijh", q, k) / scale + bias[None], dim=2)
        return lowp.einsum("rijh,rjhd->rihd", attn, v)
    attn = torch.softmax(
        lowp.einsum("ilhd,jlhd->ijlh", q, k) / scale + bias[:, :, None, :],
        dim=1)
    return lowp.einsum("ijlh,jlhd->ilhd", attn, v)


class TriangleAttention(nn.Module):
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
        q, k, v = (t.reshape(L, L, TRI_HEADS, TRI_DIM_HEAD)
                   for t in torch.chunk(self.to_qkv(z), 3, dim=-1))
        bias = self.linear_for_pair(z)                       # (L, L, H)
        gate = self.to_gate(z)
        out = tri_attn_logits(q, k, v, bias, self.wise)
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
        ops = (self.pair_multi_out, self.pair_multi_in, self.pair_row_attn,
               self.pair_col_attn)
        for op, stem in zip(ops, self.conv_stem):
            z = z + op(z) + stem(z)
        return z + self.pair_trans(z)


class SelfAttention(nn.Module):
    """One axial attention of MSAAttention; `pair_norm`/`pair_linear` are
    read only by the tied-row attention."""

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
        x = m.transpose(0, 1)                                # (L, R, D)
        q, k, v = self._qkv(x)
        dots = lowp.einsum("bihd,bjhd->bhij", q, k) * DIM_HEAD ** -0.5
        out = lowp.einsum("bhij,bjhd->bihd", torch.softmax(dots, dim=-1), v)
        out = self.to_out(out.reshape(x.shape[0], x.shape[1], -1))
        return out.transpose(0, 1)

    def row_tied(self, m, pair):
        R = m.shape[0]
        q, k, v = self._qkv(m)
        scale = DIM_HEAD ** -0.5 * R ** -0.5
        dots = lowp.einsum("rihd,rjhd->hij", q, k) * scale
        pb = self.pair_linear(self.pair_norm(pair))          # (L, L, H)
        attn = torch.softmax(dots + pb.permute(2, 0, 1), dim=-1)
        out = lowp.einsum("hij,rjhd->rihd", attn, v)
        return self.to_out(out.reshape(m.shape[0], m.shape[1], -1))


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
    def __init__(self, d: int = DIM):
        super().__init__()
        self.proj_down1 = Linear(d, 32)
        self.proj_down2 = Linear(32 * 32, d)

    def forward(self, x, m):
        mm = self.proj_down1(m)                              # (R, L, 32)
        outer = lowp.einsum("rid,rjc->ijcd", mm, mm) / mm.shape[0]
        return x + self.proj_down2(outer.reshape(x.shape[0], x.shape[1], -1))


class UpdateM(nn.Module):
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
        out = m + lowp.einsum("ijh,rjd->rihd", attn, values).reshape(m.shape)
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
    def __init__(self, d: int = DIM):
        super().__init__()
        self.linear = Linear(65, d)

    def forward(self, res_id):
        rel = (res_id[:, None] - res_id[None, :]).clamp(-32, 32) + 32
        return self.linear(F.one_hot(rel, 65).float())


class InputEmb(nn.Module):
    def __init__(self, d: int = DIM):
        super().__init__()
        self.relpos = RelPos(d)


class Predictor2D(nn.Module):
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
                return_repr: bool = False, remat: bool = False):
        """f2d (L, L, in_dim), msa (R, L) tokens already capped to the
        trunk's rows. Returns the LOGITS {dist, omega, theta, phi}; with
        return_repr also {'pair': x, 'msa': m}. remat recomputes each
        block in the backward pass (the same function, less memory)."""
        x = self.conv1(F.elu(self.bn1(f2d)))
        m = self.token_emb(msa.long())
        if msa_emb is not None:
            m = m + self.linear_emb(msa_emb)
        if rec_reprs is not None:
            m[0] += rec_reprs["single"]
            x = x + rec_reprs["pair"]
        x = x + self.input_emb.relpos(
            torch.arange(f2d.shape[0], device=f2d.device))
        for block in self.net.blocks:
            if remat and torch.is_grad_enabled():
                x, m = checkpoint(block, x, m, use_reentrant=False)
            else:
                x, m = block(x, m)
        sym = (x + x.transpose(0, 1)) * 0.5
        out = {"dist": self.to_dist_logits(sym),
               "theta": self.to_theta_logits(x),
               "omega": self.to_omega_logits(sym),
               "phi": self.to_phi_logits(x)}
        if return_repr:
            return out, {"pair": x, "msa": m}
        return out


class DistPredictor(nn.Module):
    """The checkpoint's wrapper: every key sits under `net.`."""

    def __init__(self, depth: int = DEPTH, d: int = DIM, in_dim: int = IN_DIM):
        super().__init__()
        self.net = Predictor2D(depth, d, in_dim)

    def forward(self, f2d, msa, remat: bool = False):
        return self.net(f2d, msa, remat=remat)
