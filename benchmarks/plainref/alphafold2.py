"""AlphaFold2, monomer, without templates: the plain reference.

Written from the Supplementary Algorithms of Jumper et al., Nature
596:583 (2021): the input featurization (1.2.5-1.2.7), the input and
recycling embedders (Alg. 3, 4, 32), the extra-MSA stack (Alg. 18, 19),
the Evoformer (Alg. 6-15), the structure module (Alg. 20, through
plainref.structure_module at c_s 384), the distogram and pLDDT heads, and
the recycling loop (Alg. 2). Plain torch in float32 (the benchmark turns
TF32 off), every product through plainref.lowp, no kernel, no cache and
no batching; each attention's logits are computed whole, or in blocks of
rows (of queries' rows) where they would pass LOGITS_BLOCK elements.
Parameter names are the port's, so one state dict loads into both.

Departures, as the port's (trx2dy_torch/models/alphafold2.py): no
templates, no ensembling, no masked-MSA, experimentally-resolved or pTM
heads, no masks (no padding: every mask bias is 0); one cluster draw for
every cycle and no masked-MSA replacement in the features; the outer
product mean is Algorithm 10's mean; the input embedding is the same every
cycle and made once.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from plainref import lowp
from plainref.structure_module import SMConfig, StructureModule

LOGITS_BLOCK = 2 ** 29
GAP, N_TOK = 21, 23


# --------------------------------------------------------------------------
# features (Supplementary 1.2.5-1.2.7)
# --------------------------------------------------------------------------

def features(msa, deletion, seed: int, clusters: int, extra: int,
             device) -> dict:
    """msa (rows, L) tokens ARNDCQEGHILKMFPSTWYV = 0-19, gap 20; deletion
    (rows, L) counts."""
    msa = torch.as_tensor(msa, device=device).long()
    dele = torch.as_tensor(deletion, device=device).float()
    rows, L = msa.shape
    gen = torch.Generator().manual_seed(int(seed))
    order = torch.cat([torch.tensor([0]),
                       1 + torch.randperm(rows - 1, generator=gen)])
    n = min(rows, clusters)
    ci, ei = order[:n].to(device), order[n:n + extra].to(device)
    tok = msa.clone()
    tok[tok == 20] = GAP
    c, e = tok[ci], tok[ei]
    # nearest centre: the most positions where the extra row holds the
    # centre's token and that token is a residue or X
    same = (e[:, None, :] == c[None, :, :]) & (e[:, None, :] < GAP)
    nearest = same.sum(-1).argmax(-1)                        # (E,)
    c_hot, e_hot = F.one_hot(c, N_TOK).float(), F.one_hot(e, N_TOK).float()
    members = torch.ones(n, device=device)
    profile, del_sum = c_hot.clone(), dele[ci].clone()
    for r in range(e.shape[0]):
        j = nearest[r]
        members[j] += 1
        profile[j] += e_hot[r]
        del_sum[j] += dele[ei][r]
    profile = profile / members[:, None, None]
    del_mean = del_sum / members[:, None]

    def dval(d):
        return 2.0 / math.pi * torch.atan(d / 3.0)

    dc, de = dele[ci], dele[ei]
    msa_feat = torch.cat([c_hot, (dc > 0).float()[..., None],
                          dval(dc)[..., None], profile,
                          dval(del_mean)[..., None]], -1)
    extra_feat = torch.cat([e_hot, (de > 0).float()[..., None],
                            dval(de)[..., None]], -1)
    aatype = msa[0].clamp(max=20)
    target_feat = torch.cat([torch.zeros(L, 1, device=device),
                             F.one_hot(aatype, 21).float()], -1)
    return {"target_feat": target_feat, "msa_feat": msa_feat,
            "extra_msa_feat": extra_feat, "aatype": aatype}


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def lin(mod: nn.Linear, x):
    return lowp.linear(x, mod.weight, mod.bias)


def ln(mod: nn.LayerNorm, x):
    return F.layer_norm(x, mod.normalized_shape, mod.weight, mod.bias,
                        1e-5)


def attend(q, k, v, bias, gate):
    """softmax_j(q_ij . k_aj / sqrt(d) + bias) over keys j, by row a.

    q, k, v (A, Q|K, H, d); bias broadcast against (A, H, Q, K) or None;
    gate (A, Q, H, d). Returns the gated output (A, Q, H * d), computed in
    blocks of rows a where the logits would pass LOGITS_BLOCK."""
    A, Q, H, d = q.shape
    K = k.shape[1]
    step = max(1, LOGITS_BLOCK // (Q * K * H))
    out = []
    for a in range(0, A, step):
        s = lowp.einsum("aqhd,akhd->ahqk", q[a:a + step], k[a:a + step]) \
            / math.sqrt(d)
        if bias is not None:
            s = s + bias
        p = torch.softmax(s, dim=-1)
        out.append(lowp.einsum("ahqk,akhd->aqhd", p, v[a:a + step]))
    return (gate * torch.cat(out)).reshape(A, Q, H * d)


class RowAttentionPairBias(nn.Module):
    """Algorithm 7."""

    def __init__(self, c, c_z, h, d):
        super().__init__()
        self.h, self.d = h, d
        self.norm_m, self.norm_z = nn.LayerNorm(c), nn.LayerNorm(c_z)
        self.to_qkv = nn.Linear(c, 3 * h * d, bias=False)
        self.to_b = nn.Linear(c_z, h, bias=False)
        self.to_gate = nn.Linear(c, h * d)
        self.to_out = nn.Linear(h * d, c)

    def forward(self, m, z):
        S, L, _ = m.shape
        m = ln(self.norm_m, m)
        q, k, v = lin(self.to_qkv, m).reshape(S, L, 3, self.h, self.d) \
            .unbind(2)
        b = lin(self.to_b, ln(self.norm_z, z)).permute(2, 0, 1)  # (h, i, j)
        g = torch.sigmoid(lin(self.to_gate, m)).reshape(S, L, self.h, self.d)
        return lin(self.to_out, attend(q, k, v, b, g))


class ColumnAttention(nn.Module):
    """Algorithm 8."""

    def __init__(self, c, h, d):
        super().__init__()
        self.h, self.d = h, d
        self.norm_m = nn.LayerNorm(c)
        self.to_qkv = nn.Linear(c, 3 * h * d, bias=False)
        self.to_gate = nn.Linear(c, h * d)
        self.to_out = nn.Linear(h * d, c)

    def forward(self, m):
        S, L, _ = m.shape
        m = ln(self.norm_m, m).transpose(0, 1)                  # (L, S, c)
        q, k, v = lin(self.to_qkv, m).reshape(L, S, 3, self.h, self.d) \
            .unbind(2)
        g = torch.sigmoid(lin(self.to_gate, m)).reshape(L, S, self.h, self.d)
        return lin(self.to_out, attend(q, k, v, None, g)).transpose(0, 1)


class GlobalColumnAttention(nn.Module):
    """Algorithm 19."""

    def __init__(self, c, h, d):
        super().__init__()
        self.h, self.d = h, d
        self.norm_m = nn.LayerNorm(c)
        self.to_q = nn.Linear(c, h * d, bias=False)
        self.to_kv = nn.Linear(c, 2 * d, bias=False)
        self.to_gate = nn.Linear(c, h * d)
        self.to_out = nn.Linear(h * d, c)

    def forward(self, m):
        S, L, _ = m.shape
        m = ln(self.norm_m, m)
        q = lin(self.to_q, m).reshape(S, L, self.h, self.d).mean(0)
        kv = lin(self.to_kv, m)
        k, v = kv[..., :self.d], kv[..., self.d:]               # (S, L, d)
        a = torch.softmax(lowp.einsum("ihc,tic->iht", q, k)
                          / math.sqrt(self.d), dim=-1)
        o = lowp.einsum("iht,tic->ihc", a, v)                   # (L, h, d)
        g = torch.sigmoid(lin(self.to_gate, m)).reshape(S, L, self.h, self.d)
        return lin(self.to_out, (g * o).reshape(S, L, -1))


class MSATransition(nn.Module):
    """Algorithm 9."""

    def __init__(self, c, n):
        super().__init__()
        self.norm = nn.LayerNorm(c)
        self.linear1, self.linear2 = nn.Linear(c, n * c), nn.Linear(n * c, c)

    def forward(self, m):
        return lin(self.linear2, torch.relu(lin(self.linear1,
                                                ln(self.norm, m))))


class OuterProductMean(nn.Module):
    """Algorithm 10."""

    def __init__(self, c, c_z, c_o):
        super().__init__()
        self.norm = nn.LayerNorm(c)
        self.linear_a, self.linear_b = nn.Linear(c, c_o), nn.Linear(c, c_o)
        self.linear_out = nn.Linear(c_o * c_o, c_z)

    def forward(self, m):
        S, L, _ = m.shape
        m = ln(self.norm, m)
        a, b = lin(self.linear_a, m), lin(self.linear_b, m)
        o = lowp.einsum("sic,sjd->ijcd", a, b) / S
        return lin(self.linear_out, o.reshape(L, L, -1))


class TriangleMultiplication(nn.Module):
    """Algorithms 11 (outgoing) and 12 (incoming)."""

    def __init__(self, c_z, outgoing):
        super().__init__()
        self.outgoing = outgoing
        self.norm = nn.LayerNorm(c_z)
        self.linear1 = nn.Linear(c_z, 2 * c_z)                   # a, b
        self.linear2 = nn.Sequential(nn.Linear(c_z, 2 * c_z))    # their gates
        self.to_gate = nn.Sequential(nn.Linear(c_z, c_z))
        self.to_out = nn.Sequential(nn.LayerNorm(c_z))
        self.linear_out = nn.Linear(c_z, c_z)

    def forward(self, z):
        c = z.shape[-1]
        z = ln(self.norm, z)
        ab = torch.sigmoid(lin(self.linear2[0], z)) * lin(self.linear1, z)
        a, b = ab[..., :c], ab[..., c:]
        if self.outgoing:
            t = lowp.einsum("ikc,jkc->ijc", a, b)
        else:
            t = lowp.einsum("kic,kjc->ijc", a, b)
        g = torch.sigmoid(lin(self.to_gate[0], z))
        return g * lin(self.linear_out, ln(self.to_out[0], t))


class TriangleAttention(nn.Module):
    """Algorithms 13 (starting node) and 14 (ending node)."""

    def __init__(self, c_z, starting, h=4, d=32):
        super().__init__()
        self.starting, self.h, self.d = starting, h, d
        self.norm = nn.LayerNorm(c_z)
        self.to_qkv = nn.Linear(c_z, 3 * h * d, bias=False)
        self.linear_for_pair = nn.Linear(c_z, h, bias=False)
        self.to_gate = nn.Sequential(nn.Linear(c_z, c_z))
        self.to_out = nn.Linear(h * d, c_z)

    def forward(self, z):
        L = z.shape[0]
        z = ln(self.norm, z)
        q, k, v = lin(self.to_qkv, z).reshape(L, L, 3, self.h, self.d) \
            .unbind(2)
        b = lin(self.linear_for_pair, z)                         # (L, L, h)
        g = torch.sigmoid(lin(self.to_gate[0], z)).reshape(L, L, self.h,
                                                           self.d)
        if self.starting:
            # a_ijk = q_ij . k_ik + b_jk: row i, query j, key k
            o = attend(q, k, v, b.permute(2, 0, 1), g)
        else:
            # a_ijk = q_ij . k_kj + b_ki: column j, query i, key k
            o = attend(q.transpose(0, 1), k.transpose(0, 1),
                       v.transpose(0, 1), b.permute(2, 1, 0),
                       g.transpose(0, 1)).transpose(0, 1)
        return lin(self.to_out, o)


class PairTransition(nn.Module):
    """Algorithm 15."""

    def __init__(self, c_z, n):
        super().__init__()
        self.norm = nn.LayerNorm(c_z)
        self.linear1 = nn.Linear(c_z, n * c_z)
        self.linear2 = nn.Sequential(nn.ReLU(), nn.Linear(n * c_z, c_z))

    def forward(self, z):
        return lin(self.linear2[1], torch.relu(lin(self.linear1,
                                                   ln(self.norm, z))))


class Block(nn.Module):
    """Algorithm 6 (Evoformer) or 18 (extra MSA, global column
    attention)."""

    def __init__(self, c, c_z, h, d, extra, c_o=32, n=4):
        super().__init__()
        self.row_attn = RowAttentionPairBias(c, c_z, h, d)
        self.col_attn = (GlobalColumnAttention if extra
                         else ColumnAttention)(c, h, d)
        self.msa_transition = MSATransition(c, n)
        self.outer_product_mean = OuterProductMean(c, c_z, c_o)
        self.tri_mul_out = TriangleMultiplication(c_z, True)
        self.tri_mul_in = TriangleMultiplication(c_z, False)
        self.tri_att_start = TriangleAttention(c_z, True)
        self.tri_att_end = TriangleAttention(c_z, False)
        self.pair_transition = PairTransition(c_z, n)

    def forward(self, m, z):
        if m.shape[0] > 0:
            m = m + self.row_attn(m, z)
            m = m + self.col_attn(m)
            m = m + self.msa_transition(m)
            z = z + self.outer_product_mean(m)
        for op in (self.tri_mul_out, self.tri_mul_in, self.tri_att_start,
                   self.tri_att_end, self.pair_transition):
            z = z + op(z)
        return m, z


class Embedder(nn.Module):
    """Algorithms 3, 4 and the extra MSA's projection."""

    def __init__(self, c_m, c_z, c_e, relpos=32):
        super().__init__()
        self.relpos = relpos
        self.linear_tf_m, self.linear_msa_m = nn.Linear(22, c_m), \
            nn.Linear(49, c_m)
        self.linear_tf_zi, self.linear_tf_zj = nn.Linear(22, c_z), \
            nn.Linear(22, c_z)
        self.linear_relpos = nn.Linear(2 * relpos + 1, c_z)
        self.linear_extra = nn.Linear(25, c_e)


class Recycling(nn.Module):
    """Algorithm 32."""

    def __init__(self, c_m, c_z, bins=15):
        super().__init__()
        self.norm_m, self.norm_z = nn.LayerNorm(c_m), nn.LayerNorm(c_z)
        self.linear_dist = nn.Linear(bins, c_z)


class PLDDT(nn.Sequential):
    def __init__(self, c_s, hidden, bins):
        super().__init__(nn.LayerNorm(c_s), nn.Linear(c_s, hidden),
                         nn.ReLU(), nn.Linear(hidden, hidden), nn.ReLU(),
                         nn.Linear(hidden, bins))


class AlphaFold2(nn.Module):
    def __init__(self, c_m=256, c_z=128, c_e=64, c_s=384,
                 evoformer_blocks=48, extra_blocks=4, msa_heads=8,
                 msa_head_dim=32, extra_heads=8, extra_head_dim=8,
                 dist_bins=64, plddt_hidden=128, plddt_bins=50):
        super().__init__()
        self.c_m, self.c_z, self.dist_bins = c_m, c_z, dist_bins
        self.embedder = Embedder(c_m, c_z, c_e)
        self.recycling = Recycling(c_m, c_z)
        self.extra_msa = nn.ModuleList(
            Block(c_e, c_z, extra_heads, extra_head_dim, True)
            for _ in range(extra_blocks))
        self.evoformer = nn.ModuleList(
            Block(c_m, c_z, msa_heads, msa_head_dim, False)
            for _ in range(evoformer_blocks))
        self.linear_single = nn.Linear(c_m, c_s)
        self.structure_module = StructureModule(SMConfig(c_s=c_s, c_z=c_z))
        self.distogram = nn.Linear(c_z, dist_bins)
        self.plddt = PLDDT(c_s, plddt_hidden, plddt_bins)

    def forward(self, f: dict, n_recycle: int = 3) -> dict:
        em = self.embedder
        aatype = f["aatype"]
        L = aatype.shape[0]
        dev = aatype.device
        tf = f["target_feat"]
        m_in = lin(em.linear_msa_m, f["msa_feat"]) \
            + lin(em.linear_tf_m, tf)[None]
        i = torch.arange(L, device=dev)
        rel = F.one_hot((i[:, None] - i[None, :]).clamp(-em.relpos,
                                                        em.relpos)
                        + em.relpos, 2 * em.relpos + 1).float()
        z_in = lin(em.linear_tf_zi, tf)[:, None] \
            + lin(em.linear_tf_zj, tf)[None, :] + lin(em.linear_relpos, rel)
        e_in = lin(em.linear_extra, f["extra_msa_feat"])
        rc = self.recycling
        breaks = torch.linspace(3.25, 20.75, 15, device=dev)
        upper = torch.cat([breaks[1:], torch.tensor([1e4], device=dev)])
        prev_m1 = torch.zeros(L, self.c_m, device=dev)
        prev_z = torch.zeros(L, L, self.c_z, device=dev)
        prev_x = torch.zeros(L, 3, device=dev)
        for _ in range(n_recycle + 1):
            dist = torch.sqrt(((prev_x[:, None] - prev_x[None, :]) ** 2)
                              .sum(-1))[..., None]
            dgram = ((dist > breaks) & (dist < upper)).float()
            m = m_in.clone()
            m[0] = m[0] + ln(rc.norm_m, prev_m1)
            z = z_in + ln(rc.norm_z, prev_z) + lin(rc.linear_dist, dgram)
            e = e_in
            for block in self.extra_msa:
                e, z = block(e, z)
            for block in self.evoformer:
                m, z = block(m, z)
            sm = self.structure_module(lin(self.linear_single, m[0]), z,
                                       aatype)
            prev_m1, prev_z = m[0], z
            x14 = sm["atom14"]
            prev_x = torch.where((aatype == 7)[:, None], x14[:, 1],
                                 x14[:, 4])
        logits = lin(self.distogram, z)
        dist = torch.softmax(logits + logits.transpose(0, 1), dim=-1)
        prob = torch.softmax(_plddt_logits(self.plddt, sm["single"]), -1)
        n = prob.shape[-1]
        centres = (torch.arange(n, device=dev) + 0.5) / n
        return {**sm, "distogram": dist, "plddt": (prob * centres).sum(-1),
                "pair": z, "msa_first_row": prev_m1}


def _plddt_logits(head: PLDDT, s):
    x = ln(head[0], s)
    x = torch.relu(lin(head[1], x))
    x = torch.relu(lin(head[3], x))
    return lin(head[5], x)


def predict(model: AlphaFold2, msa, deletion, seed: int, n_recycle: int,
            clusters: int, extra: int, device) -> dict:
    """The features, then the model."""
    return model(features(msa, deletion, seed, clusters, extra, device),
                 n_recycle)
