"""AlphaFold2, monomer, without templates, on the port.

After Jumper et al., "Highly accurate protein structure prediction with
AlphaFold", Nature 596:583 (2021), Supplementary Algorithms 2-32, and the
template-free models of alphafold/model/config.py (model_3 to model_5).
Per recycling cycle (Algorithm 2):

  input embedding (Alg. 3-4) + recycling embedding (Alg. 32: the last
  cycle's MSA first row and pair, normed, and its pseudo-beta distances
  in 15 bins over 3.25-20.75 A)
  -> extra-MSA stack (Alg. 18): 4 blocks at c_e 64 over the extra MSA,
     row attention with pair bias 8 x 8, global column attention (Alg. 19)
  -> Evoformer (Alg. 6): 48 blocks at c_m 256, c_z 128:
       m += row attention with pair bias (Alg. 7, 8 x 32)
       m += column attention (Alg. 8, 8 x 32, gated)
       m += transition (Alg. 9, factor 4)
       z += outer product mean (Alg. 10, 32 channels)
       z += triangle multiplication, outgoing and incoming (Alg. 11-12)
       z += triangle attention, starting and ending node (Alg. 13-14)
       z += pair transition (Alg. 15)
  -> single = Linear(m[0]) (256 -> 384)
  -> structure module (Alg. 20; models/structure_module.py at c_s 384)
and after the last cycle the distogram (64 bins over 2.3125-21.6875 A)
and pLDDT (models/folding_e2e.PLDDTHead at 384, 128, 50) heads.

The pair stack is predictor2d's: TriangleMultiplication, TriangleAttention
and PairTransition are AlphaFold2's gated forms at c_z 128 with 4 x 32
attention heads. The ending-node attention runs the starting-node module
on the transposed pair and transposes its update back, as AlphaFold2's
code does, which gives Algorithm 14's bias b_ki. The Evoformer's row
attention with pair bias is the triangle-attention kernel's row-wise
function with the MSA's rows in place of the pair's (ops/
triangle_attention.tri_attn_core, R = the clusters); the column attention
goes through scaled_dot_product_attention; the extra MSA's row attention
(8-wide heads, which the kernel does not take) through
scaled_dot_product_attention in float32 with the pair bias as its mask.

Precision follows the e2e predictor: with bf16 weights (convert.build_af2)
the products run in bf16 with float32 accumulation and biases, norms,
softmaxes and the residual streams stay float32, and the kernel's core is
float32 on the bf16 q, k, v and pair bias (its bf16-operand path).

Departures, for the port's use: no templates (the template-free models);
no ensembling (num_ensemble 1, as released inference runs); no
masked-MSA, experimentally-resolved or pTM heads; no masks (the inputs
carry no padding, where every mask bias is exactly 0); the outer product
mean is the mean of Algorithm 10 (the released code adds the output bias
before dividing by the row count, plus 1e-3); the input embedding is made
once and shared by the cycles, whose features are the same
(af2_features).

`AF2_STATS` counts what the forward launched: the triangle-attention
kernel's launches by use (msa_row, tri_start, tri_end), the rows of the
MSA-row launches, and the calls of global column attention.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from trx2dy_torch.models.af2_features import (
    EXTRA_MSA, EXTRA_MSA_FEAT, MSA_CLUSTERS, MSA_FEAT, TARGET_FEAT, featurize,
)
from trx2dy_torch.models.folding_e2e import PLDDTHead
from trx2dy_torch.models.predictor2d import (
    LayerNorm, Linear, PairTransition, TriangleAttention,
    TriangleMultiplication,
)
from trx2dy_torch.models.structure_module import SMConfig, StructureModule
from trx2dy_torch.ops.triangle_attention import D_HEAD, tri_attn_core
from trx2dy_torch.utils.profiling import span

GLY = 7                           # aatype of glycine (residue order ARND...)
CA, CB = 1, 4                     # atom14 slots


class AF2Config(NamedTuple):
    """The published widths (alphafold/model/config.py, template-free)."""
    c_m: int = 256
    c_z: int = 128
    c_e: int = 64
    c_s: int = 384
    evoformer_blocks: int = 48
    extra_blocks: int = 4
    msa_heads: int = 8
    msa_head_dim: int = 32
    extra_heads: int = 8
    extra_head_dim: int = 8
    outer: int = 32
    transition: int = 4
    max_relative: int = 32
    recycle_bins: int = 15
    recycle_min: float = 3.25
    recycle_max: float = 20.75
    dist_bins: int = 64           # over 2.3125-21.6875 A
    plddt_hidden: int = 128
    plddt_bins: int = 50


class _Stats:
    def __init__(self):
        self.reset()

    def reset(self):
        self.launches = {"msa_row": 0, "tri_start": 0, "tri_end": 0}
        self.msa_row_rows = 0
        self.global_col = 0


AF2_STATS = _Stats()


def _counted(use: str, fn, *args):
    before = tri_attn_core.launches
    out = fn(*args)
    AF2_STATS.launches[use] += tri_attn_core.launches - before
    return out


class MSARowAttentionWithPairBias(nn.Module):
    """Algorithm 7. Heads of D_HEAD (32) go through tri_attn_core, the
    others through scaled_dot_product_attention with the bias as a float32
    mask."""

    def __init__(self, c: int, c_z: int, heads: int, head_dim: int):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        hd = heads * head_dim
        self.norm_m = LayerNorm(c)
        self.norm_z = LayerNorm(c_z)
        self.to_qkv = Linear(c, 3 * hd, bias=False)
        self.to_b = Linear(c_z, heads, bias=False)
        self.to_gate = Linear(c, hd)
        self.to_out = Linear(hd, c)

    def forward(self, m, z):
        R, L, _ = m.shape
        H, D = self.heads, self.head_dim
        m = self.norm_m(m)
        q, k, v = (t.reshape(R, L, H, D)
                   for t in torch.chunk(self.to_qkv(m), 3, dim=-1))
        # (L, L, H) as a view of a head-major product, as TriangleAttention
        w = self.to_b.weight
        zn = self.norm_z(z)
        bias = torch.matmul(w, zn.reshape(L * L, -1).T.to(w.dtype)) \
            .reshape(H, L, L)
        if D == D_HEAD:     # the products' dtype: float32 in the core
            before = tri_attn_core.launches
            o = tri_attn_core(q, k, v, bias.permute(1, 2, 0), "row")
            n = tri_attn_core.launches - before
            AF2_STATS.launches["msa_row"] += n
            AF2_STATS.msa_row_rows += n * R
        else:
            q, k, v = (t.float().transpose(1, 2) for t in (q, k, v))
            o = F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias.float()[None]).transpose(1, 2)
        gate = torch.sigmoid(self.to_gate(m))
        return self.to_out(gate * o.reshape(R, L, H * D))


class MSAColumnAttention(nn.Module):
    """Algorithm 8: gated self-attention along each column of the MSA."""

    def __init__(self, c: int, heads: int, head_dim: int):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        hd = heads * head_dim
        self.norm_m = LayerNorm(c)
        self.to_qkv = Linear(c, 3 * hd, bias=False)
        self.to_gate = Linear(c, hd)
        self.to_out = Linear(hd, c)

    def forward(self, m):
        R, L, _ = m.shape
        H, D = self.heads, self.head_dim
        m = self.norm_m(m)
        # (L, H, R, D): each column's rows attend to each other
        q, k, v = (t.reshape(R, L, H, D).permute(1, 2, 0, 3)
                   for t in torch.chunk(self.to_qkv(m), 3, dim=-1))
        o = F.scaled_dot_product_attention(q, k, v)
        o = o.permute(2, 0, 1, 3).reshape(R, L, H * D)
        gate = torch.sigmoid(self.to_gate(m))
        return self.to_out(gate * o.float())


class MSAColumnGlobalAttention(nn.Module):
    """Algorithm 19: each column's mean query attends to its rows' keys
    and values (one head of width head_dim shared by every query head)."""

    def __init__(self, c: int, heads: int, head_dim: int):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        hd = heads * head_dim
        self.norm_m = LayerNorm(c)
        self.to_q = Linear(c, hd, bias=False)
        self.to_kv = Linear(c, 2 * head_dim, bias=False)
        self.to_gate = Linear(c, hd)
        self.to_out = Linear(hd, c)

    def forward(self, m):
        R, L, _ = m.shape
        H, D = self.heads, self.head_dim
        AF2_STATS.global_col += 1
        m = self.norm_m(m)
        q = self.to_q(m).float().mean(dim=0).reshape(L, H, D) * D ** -0.5
        k, v = torch.chunk(self.to_kv(m).float(), 2, dim=-1)   # (R, L, D)
        a = torch.softmax(torch.einsum("lhd,rld->lhr", q, k), dim=-1)
        o = torch.einsum("lhr,rld->lhd", a, v)
        gate = torch.sigmoid(self.to_gate(m)).reshape(R, L, H, D)
        return self.to_out((gate * o).reshape(R, L, H * D))


class Transition(nn.Module):
    """Algorithm 9: LN, Linear(c, n c), ReLU, Linear(n c, c)."""

    def __init__(self, c: int, n: int):
        super().__init__()
        self.norm = LayerNorm(c)
        self.linear1 = Linear(c, n * c)
        self.linear2 = Linear(n * c, c)

    def forward(self, m):
        return self.linear2(F.relu(self.linear1(self.norm(m))))


class OuterProductMean(nn.Module):
    """Algorithm 10: the mean over rows of a_si (x) b_sj, projected to
    c_z."""

    def __init__(self, c: int, c_z: int, c_opm: int):
        super().__init__()
        self.norm = LayerNorm(c)
        self.linear_a = Linear(c, c_opm)
        self.linear_b = Linear(c, c_opm)
        self.linear_out = Linear(c_opm * c_opm, c_z)

    def forward(self, m):
        R, L, _ = m.shape
        m = self.norm(m)
        w = self.linear_out.weight
        a = (self.linear_a(m) / R).to(w.dtype)
        b = self.linear_b(m).to(w.dtype)
        o = torch.einsum("sic,sjd->ijcd", a, b)
        return self.linear_out(o.reshape(L, L, -1))


class EvoformerBlock(nn.Module):
    """Algorithm 6; with global_column, the extra-MSA stack's block
    (Algorithm 18)."""

    def __init__(self, c: int, c_z: int, heads: int, head_dim: int,
                 global_column: bool, outer: int, n: int):
        super().__init__()
        self.row_attn = MSARowAttentionWithPairBias(c, c_z, heads, head_dim)
        self.col_attn = (MSAColumnGlobalAttention if global_column
                         else MSAColumnAttention)(c, heads, head_dim)
        self.msa_transition = Transition(c, n)
        self.outer_product_mean = OuterProductMean(c, c_z, outer)
        self.tri_mul_out = TriangleMultiplication("outgoing", c_z)
        self.tri_mul_in = TriangleMultiplication("incoming", c_z)
        self.tri_att_start = TriangleAttention("row", c_z)
        self.tri_att_end = TriangleAttention("row", c_z)
        self.pair_transition = PairTransition(c_z)

    def forward(self, m, z):
        if m.shape[0]:                  # an empty extra MSA adds nothing
            m = m + self.row_attn(m, z)
            m = m + self.col_attn(m)
            m = m + self.msa_transition(m)
            z = z + self.outer_product_mean(m)
        z = z + self.tri_mul_out(z)
        z = z + self.tri_mul_in(z)
        z = z + _counted("tri_start", self.tri_att_start, z)
        z = z + _counted("tri_end", self.tri_att_end,
                         z.transpose(0, 1)).transpose(0, 1)
        return m, z + self.pair_transition(z)


class InputEmbedder(nn.Module):
    """Algorithms 3-4, and the extra MSA's projection (Algorithm 2 line
    4)."""

    def __init__(self, cfg: AF2Config):
        super().__init__()
        self.max_relative = cfg.max_relative
        self.linear_tf_m = Linear(TARGET_FEAT, cfg.c_m)
        self.linear_msa_m = Linear(MSA_FEAT, cfg.c_m)
        self.linear_tf_zi = Linear(TARGET_FEAT, cfg.c_z)
        self.linear_tf_zj = Linear(TARGET_FEAT, cfg.c_z)
        self.linear_relpos = Linear(2 * cfg.max_relative + 1, cfg.c_z)
        self.linear_extra = Linear(EXTRA_MSA_FEAT, cfg.c_e)

    def forward(self, feats):
        tf = feats["target_feat"]
        m = self.linear_msa_m(feats["msa_feat"]) + self.linear_tf_m(tf)
        ri = feats["residue_index"]
        d = torch.clamp(ri[:, None] - ri[None, :], -self.max_relative,
                        self.max_relative) + self.max_relative
        z = self.linear_tf_zi(tf)[:, None] + self.linear_tf_zj(tf)[None] \
            + self.linear_relpos(
                F.one_hot(d, 2 * self.max_relative + 1).float())
        return m, z, self.linear_extra(feats["extra_msa_feat"])


class RecyclingEmbedder(nn.Module):
    """Algorithm 32: the last cycle's MSA first row and pair, normed, and
    its pseudo-beta distances one-hot over `bins` bins whose lower edges
    run from lo to hi (under lo: no bin)."""

    def __init__(self, cfg: AF2Config):
        super().__init__()
        self.edges = (cfg.recycle_min, cfg.recycle_max, cfg.recycle_bins)
        self.norm_m = LayerNorm(cfg.c_m)
        self.norm_z = LayerNorm(cfg.c_z)
        self.linear_dist = Linear(cfg.recycle_bins, cfg.c_z)

    def forward(self, m1_prev, z_prev, x_prev):
        lo = torch.linspace(*self.edges, device=x_prev.device) ** 2
        hi = torch.cat([lo[1:], lo.new_full((1,), 1e8)])
        d2 = torch.sum((x_prev[:, None] - x_prev[None]) ** 2, dim=-1,
                       keepdim=True)
        dgram = ((d2 > lo) & (d2 < hi)).float()
        return self.norm_m(m1_prev), \
            self.norm_z(z_prev) + self.linear_dist(dgram)


def pseudo_beta(atom14: torch.Tensor, aatype: torch.Tensor) -> torch.Tensor:
    """Cb, or Ca for glycine, of atom14 coordinates (L, 14, 3)."""
    return torch.where((aatype == GLY)[:, None], atom14[:, CA], atom14[:, CB])


class AlphaFold2(nn.Module):
    """The template-free monomer model; see the module's docstring."""

    def __init__(self, cfg: AF2Config = AF2Config()):
        super().__init__()
        self.cfg = cfg
        self.embedder = InputEmbedder(cfg)
        self.recycling = RecyclingEmbedder(cfg)
        self.extra_msa = nn.ModuleList(
            EvoformerBlock(cfg.c_e, cfg.c_z, cfg.extra_heads,
                           cfg.extra_head_dim, True, cfg.outer,
                           cfg.transition)
            for _ in range(cfg.extra_blocks))
        self.evoformer = nn.ModuleList(
            EvoformerBlock(cfg.c_m, cfg.c_z, cfg.msa_heads, cfg.msa_head_dim,
                           False, cfg.outer, cfg.transition)
            for _ in range(cfg.evoformer_blocks))
        self.linear_single = Linear(cfg.c_m, cfg.c_s)
        self.structure_module = StructureModule(SMConfig(c_s=cfg.c_s,
                                                         c_z=cfg.c_z))
        self.distogram = Linear(cfg.c_z, cfg.dist_bins)
        self.plddt = PLDDTHead(cfg.c_s, cfg.plddt_hidden, cfg.plddt_bins)

    def forward(self, feats: dict, n_recycle: int = 3) -> dict:
        """feats: af2_features.featurize's. Returns the last cycle's
        'distogram' (L, L, 64 probabilities), 'plddt' (L,) and
        'plddt_prob', 'pair' (L, L, c_z), 'msa_first_row' (L, c_m),
        'single' (L, c_s), and the structure module's outputs (frames,
        angles, cords_ca, atom14, atom14_mask)."""
        aatype = feats["aatype"]
        L = aatype.shape[0]
        dev = aatype.device
        with span("embed"):
            m0, z0, e0 = self.embedder(feats)
        m1 = torch.zeros(L, self.cfg.c_m, device=dev)
        z = torch.zeros(L, L, self.cfg.c_z, device=dev)
        x = torch.zeros(L, 3, device=dev)
        for _ in range(1 + n_recycle):
            with span("recycle"):
                m1_rec, z_rec = self.recycling(m1, z, x)
                m = torch.cat([m0[:1] + m1_rec, m0[1:]])
                z = z0 + z_rec
            with span("extra_msa"):
                e = e0
                for block in self.extra_msa:
                    e, z = block(e, z)
            with span("evoformer"):
                for block in self.evoformer:
                    m, z = block(m, z)
            with span("structure"):
                single = self.linear_single(m[0])
                sm = self.structure_module(single, z, aatype)
            m1, x = m[0], pseudo_beta(sm["atom14"], aatype)
        with span("heads"):
            logits = self.distogram(z)
            dist = torch.softmax(logits + logits.transpose(0, 1), dim=-1)
            plddt, plddt_prob = self.plddt(sm["single"])
        return {**sm, "distogram": dist, "plddt": plddt,
                "plddt_prob": plddt_prob, "pair": z, "msa_first_row": m1}


def predict(model: AlphaFold2, msa, deletion, seed: int, n_recycle: int = 3,
            clusters: int = MSA_CLUSTERS, extra: int = EXTRA_MSA) -> tuple:
    """What the predict CLI runs between its weights and its files, for
    AlphaFold2: featurize on the model's device, the forward, and atom14,
    its mask, pLDDT and the distogram copied to the host. Returns (host
    numpy arrays, the forward's outputs on the device)."""
    dev = model.distogram.weight.device
    with span("af2"):
        with torch.inference_mode():
            feats = featurize(msa, deletion, seed, clusters, extra, dev)
            out = model(feats, n_recycle)
        host = {"atom14": out["atom14"].float().cpu().numpy(),
                "atom14_mask": out["atom14_mask"].cpu().numpy(),
                "plddt": out["plddt"].float().cpu().numpy(),
                "distogram": out["distogram"].float().cpu().numpy()}
    return host, out
