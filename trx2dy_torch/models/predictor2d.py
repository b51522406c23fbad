"""Predictor2D — the trRosettaX2 2D-geometry trunk, inference and training.

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
triangle attention core takes those bf16 q, k, v and pair bias as they
are and computes in float32 on their values, on the card (the kernel's
bf16-operand path) and on the CPU (its plain version casts them first)
alike, so the kernel and its plain version compute one function; that
core is then more precise than JAX's bf16 einsums. With float32 weights
every operation is the one it was before bf16 existed.

Training (models/train.py) passes three switches to `forward`, as JAX's
predictor2d_apply takes them:
- use_flash=False takes the logits path of the triangle attention core
  (tri_attn_core_plain, the counterpart of JAX's XLA triangle_attention),
  which autograd differentiates; the default True takes tri_attn_core,
  the forward-only CUDA kernel on the card (JAX's default is the logits
  path; the port's inference callers take the kernel);
- dropout: one BlockDropout per block, the reference's structured
  training dropout with the masks drawn beforehand (draw_dropout): rows
  of the pair shared over the first axis on both triangle
  multiplications and the row attention, columns on the column
  attention, at PAIR_DROPOUT; elementwise between the ReLU and the
  second linear of UpdateM's feed-forward at FF_DROPOUT. None (inference)
  makes every dropout the identity;
- remat: each block is rematerialised in the backward pass
  (torch.utils.checkpoint). The masks are tensors passed into the block,
  so the recompute applies the same ones: checkpointing restores the
  default RNG states, not an explicit generator's.

MSA rows split over ranks (forward's `mp`, a process group; JAX's
msa_sharding over the mesh's mp axis, trx2dy/models/train.py:100-104):
each rank holds its R/mp rows of m, the pair x whole. Rows meet in three
places, each through a collective of parallel/mesh.py: the column
attention gathers its keys and values over mp (gather_rows), the tied-row
attention sums q.k over mp before the pair bias and softmax (sum_over),
and UpdateX sums its outer product over mp (sum_over), each divided or
scaled by the global R. Where a pair tensor meets the rank's rows (the
tied-row attention's weights, UpdateM's attention) it passes copy_to, so
that its gradient sums every rank's rows. Everything else is row-local or
computed alike on every rank. With mp None nothing changes.

Works unbatched and channel-last: pair x is (L, L, D), MSA m is (R, L, D).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from trx2dy_torch.ops.triangle_attention import (
    tri_attn_core, tri_attn_core_plain,
)
from trx2dy_torch.parallel.mesh import (
    copy_to, gather_rows, group_size, sum_over,
)
from trx2dy_torch.utils.profiling import span

DIM = 128
DEPTH = 12
HEADS = 8
DIM_HEAD = 64
IN_DIM = 526
N_TOKENS = 21
TRI_HEADS = 4
TRI_DIM_HEAD = 32
RES2_WIDTH = 52          # Res2Net: expansion 1, scale 4, baseWidth 26
PAIR_DROPOUT = 0.10      # dropout_rate_pair of TriUpdate's branches
FF_DROPOUT = 0.10        # UpdateM's feed-forward
_EPS = 1e-5


# --------------------------------------------------------------------------
# training-time dropout (evoutils/dropout.py:35-78 semantics)
# --------------------------------------------------------------------------

# One block's dropout masks (True keeps), in JAX's draw order: [0:3]
# row-wise (1, L, d) for pair_multi_out, pair_multi_in and pair_row_attn,
# [3] column-wise (L, 1, d) for pair_col_attn, [4] elementwise (R, L, 4d)
# for UpdateM's feed-forward.
BlockDropout = Tuple[torch.Tensor, ...]


def dropout_shapes(L: int, R: int, d: int = DIM) -> tuple:
    """The shapes of one block's masks, in draw order."""
    return ((1, L, d),) * 3 + ((L, 1, d), (R, L, 4 * d))


def draw_dropout(generator: torch.Generator, depth: int, L: int, R: int,
                 d: int = DIM) -> List[BlockDropout]:
    """Every block's masks from `generator`, on its device: a value is
    kept with probability 1 - rate (jax.random.bernoulli's uniform < p)."""
    rates = (PAIR_DROPOUT,) * 4 + (FF_DROPOUT,)
    dev = generator.device
    return [tuple(torch.rand(shape, generator=generator, device=dev)
                  < 1.0 - rate
                  for shape, rate in zip(dropout_shapes(L, R, d), rates))
            for _ in range(depth)]


def apply_dropout(x, keep, rate: float):
    """Inverted dropout with a drawn mask broadcast against x."""
    return torch.where(keep, x / (1.0 - rate), 0.0)


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
    """Linear(d, 4d), ReLU, [Dropout], Linear(4d, d); the dropout (at
    FF_DROPOUT) runs where a mask is given."""

    def __init__(self, d: int):
        super().__init__()
        self.feed_forward = nn.Sequential(
            Linear(d, 4 * d), nn.ReLU(), nn.Identity(), Linear(4 * d, d))

    def forward(self, x, keep=None):
        h = F.relu(self.feed_forward[0](x))
        if keep is not None:
            h = apply_dropout(h, keep, FF_DROPOUT)
        return self.feed_forward[3](h)


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
    """Gated triangle attention. With use_flash the core goes through
    tri_attn_core (the CUDA kernel on the card, the logits path on the
    CPU), without it through the logits path on every device."""

    def __init__(self, wise: str, d: int = DIM):
        super().__init__()
        self.wise = wise
        hd = TRI_HEADS * TRI_DIM_HEAD
        self.norm = LayerNorm(d)
        self.to_qkv = Linear(d, 3 * hd, bias=False)
        self.linear_for_pair = Linear(d, TRI_HEADS, bias=False)
        self.to_gate = nn.Sequential(Linear(d, d), nn.Sigmoid())
        self.to_out = Linear(hd, d)

    def forward(self, z, use_flash: bool = True):
        z = self.norm(z)
        L = z.shape[0]
        # q, k, v and the bias in the products' dtype: the core computes
        # in float32 either way (with bf16 weights, on the bf16 values)
        q, k, v = (t.reshape(L, L, TRI_HEADS, TRI_DIM_HEAD)
                   for t in torch.chunk(self.to_qkv(z), 3, dim=-1))
        # (L, L, H) as a view of a head-major (H, L, L) product, so that
        # the kernel reads each head's bias tile contiguously
        w = self.linear_for_pair.weight
        bias = torch.matmul(w, z.reshape(L * L, -1).T.to(w.dtype)) \
            .reshape(-1, L, L).permute(1, 2, 0)
        gate = self.to_gate(z)
        core = tri_attn_core if use_flash else tri_attn_core_plain
        out = core(q, k, v, bias, self.wise)
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

    def forward(self, z, use_flash: bool = True,
                drop: Optional[BlockDropout] = None):
        """drop: the block's masks; the conv stems take none."""
        branches = (self.pair_multi_out, self.pair_multi_in,
                    lambda t: self.pair_row_attn(t, use_flash),
                    lambda t: self.pair_col_attn(t, use_flash))
        for i, (op, stem) in enumerate(zip(branches, self.conv_stem)):
            y = op(z)
            if drop is not None:
                y = apply_dropout(y, drop[i], PAIR_DROPOUT)
            z = z + y + stem(z)
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

    def column(self, m, mp=None):
        """Attention along the row axis R of (R, L, D), batched over L; with
        mp, this rank's rows query the keys and values of every rank's."""
        x = m.transpose(0, 1)                                # (L, R, D)
        shape = x.shape[:2] + (HEADS, DIM_HEAD)
        q = self.to_q(x).reshape(shape)
        kv = gather_rows(self.to_kv(x), mp, dim=1)
        k, v = (t.reshape(x.shape[0], kv.shape[1], HEADS, DIM_HEAD)
                for t in torch.chunk(kv, 2, dim=-1))
        dots = torch.einsum("bihd,bjhd->bhij", q, k) * DIM_HEAD ** -0.5
        out = torch.einsum("bhij,bjhd->bihd", torch.softmax(dots, dim=-1), v)
        out = self.to_out(out.reshape(x.shape[0], x.shape[1], -1))
        return out.transpose(0, 1)

    def row_tied(self, m, pair, mp=None):
        """Tied-row attention with pair bias, shared across the R rows
        (over every rank's rows with mp)."""
        R = m.shape[0] * group_size(mp)
        q, k, v = self._qkv(m)
        scale = DIM_HEAD ** -0.5 * R ** -0.5
        dots = sum_over(torch.einsum("rihd,rjhd->hij", q, k), mp) * scale
        pb = self.pair_linear(self.pair_norm(pair))          # (L, L, H)
        attn = copy_to(torch.softmax(dots + pb.permute(2, 0, 1), dim=-1), mp)
        out = torch.einsum("hij,rjhd->rihd", attn, v)
        return self.to_out(out.reshape(m.shape[0], m.shape[1], -1))


class MSAAttention(nn.Module):
    def __init__(self, d: int = DIM):
        super().__init__()
        self.attn_width = SelfAttention(d)
        self.attn_height = SelfAttention(d)

    def forward(self, m, pair, mp=None):
        return (self.attn_width.column(m, mp)
                + self.attn_height.row_tied(m, pair, mp)) / 2.0


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

    def forward(self, x, m, mp=None):
        mm = self.proj_down1(m)                              # (R, L, 32)
        outer = sum_over(torch.einsum("rid,rjc->ijcd", mm, mm), mp) \
            / (mm.shape[0] * group_size(mp))
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

    def forward(self, x, m, drop: Optional[BlockDropout] = None, mp=None):
        pair = self.norm1((x + x.transpose(0, 1)) / 2.0)
        # softmax over j
        attn = copy_to(torch.softmax(self.linear1(pair), dim=-2), mp)
        values = self.linear2(self.norm2(m))                 # (R, L, d/h)
        out = m + torch.einsum("ijh,rjd->rihd", attn, values).reshape(m.shape)
        keep = None if drop is None else drop[4]
        return out + self.ff(self.norm3(out), keep)


class TrunkBlock(nn.ModuleList):
    """Indices 0..4 as in the checkpoint: TriUpdate, PreNorm(MSAAttention),
    UpdateX, PreNorm(FeedForward), UpdateM."""

    def __init__(self, d: int = DIM):
        super().__init__([TriUpdate(d), PreNorm(MSAAttention(d), d),
                          UpdateX(d), PreNorm(FeedForward(d), d), UpdateM(d)])

    def forward(self, x, m, use_flash: bool = True,
                drop: Optional[BlockDropout] = None, mp=None):
        tri, msa_attn, upd_x, ff, upd_m = self
        m = m + msa_attn(m, x, mp)
        m = m + ff(m)
        x = upd_x(x, m, mp)
        x = tri(x, use_flash, drop)
        return x, upd_m(x, m, drop, mp)


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
                return_repr: bool = False, depth: Optional[int] = None,
                use_flash: bool = True,
                dropout: Optional[List[BlockDropout]] = None,
                remat: bool = False, mp=None):
        """f2d (L, L, in_dim) features, msa (R, L) tokens already capped to
        the trunk's rows. e2e only: msa_emb (R, L, emb_dim) ESM
        representations; rec_reprs {'single': (L, d), 'pair': (L, L, d)}
        recycling embeddings; depth runs the first `depth` blocks.
        Training: use_flash=False (the differentiable logits attention),
        dropout (one BlockDropout per block run, from draw_dropout) and
        remat (see the module's docstring). mp: the process group over
        which the MSA rows are split; msa (and dropout's UpdateM masks)
        then hold this rank's rows (see the module's docstring). Returns
        LOGITS {dist (L,L,37),
        omega (L,L,25), theta (L,L,25), phi (L,L,13)}, the caller applies
        the softmax; with return_repr also {'pair': x, 'msa': m}."""
        x = self.conv1(F.elu(self.bn1(f2d)))                 # (L, L, d)
        m = self.token_emb(msa.long())                       # (R, L, d)
        if msa_emb is not None:
            m = m + self.linear_emb(msa_emb)
        if rec_reprs is not None:
            if mp is not None:
                raise ValueError("the recycled single representation "
                                 "feeds row 0; the e2e trunk runs unsplit")
            m[0] += rec_reprs["single"]          # m's dtype, as JAX
            x = x + rec_reprs["pair"]
        x = x + self.input_emb.relpos(
            torch.arange(f2d.shape[0], device=f2d.device))
        with span("trunk"):
            for i, block in enumerate(self.net.blocks[:depth]):
                drop = None if dropout is None else dropout[i]
                if remat:
                    # no default-RNG draw inside a block: the masks come in
                    x, m = checkpoint(block, x, m, use_flash, drop, mp,
                                      use_reentrant=False,
                                      preserve_rng_state=False)
                else:
                    x, m = block(x, m, use_flash, drop, mp)
        with span("heads"):
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

    def row_parameters(self) -> List[nn.Parameter]:
        """The parameters that act on MSA rows. With the rows split over mp
        each rank's gradient of these holds only its rows' share, and the
        sharded train step sums it over mp; every other parameter sits on
        the pair path, whose gradient every rank holds whole."""
        mods = [self.token_emb]
        if hasattr(self, "linear_emb"):
            mods.append(self.linear_emb)
        for _, msa_attn, upd_x, ff, upd_m in self.net.blocks:
            mods += [msa_attn.norm, ff, upd_x.proj_down1, upd_m.norm2,
                     upd_m.linear2, upd_m.norm3, upd_m.ff]
            for attn in (msa_attn.fn.attn_width, msa_attn.fn.attn_height):
                mods += [attn.to_q, attn.to_kv, attn.to_out]
        return [p for mod in mods for p in mod.parameters()]


class DistPredictor(nn.Module):
    """The checkpoint's wrapper: every key sits under `net.`."""

    def __init__(self, depth: int = DEPTH, d: int = DIM, in_dim: int = IN_DIM):
        super().__init__()
        self.net = Predictor2D(depth, d, in_dim)

    def forward(self, f2d, msa, **kwargs):
        """Predictor2D.forward of `net`; kwargs as there."""
        return self.net(f2d, msa, **kwargs)
