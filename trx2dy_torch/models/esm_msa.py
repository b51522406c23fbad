"""ESM-MSA-1b, the axial MSA transformer, inference.

Port of trx2dy/models/esm_msa.py, after the vendored fairseq MSA
Transformer (trRosettaX2/esm/model.py:225-420, esm/axial_attention.py,
esm/modules.py): `layers` AxialTransformerLayers (published: 12 layers, 768
wide, 12 heads, FFN 3072, ~100 M parameters), each a pre-LN residual
[tied row self-attention -> column self-attention -> exact-GELU FFN], with
learned positions (or custom residue positions, the MSATransformer1b arm),
per-row MSA position scalars, the RobertaLMHead and the contact head.

Parameter names are the upgraded fairseq state_dict's
(convert.upgrade_esm_state_dict), so the published checkpoint and the JAX
package's flat dicts load by name. Width, heads and layers are
constructor arguments.

Row attention ties its maps across the R rows with 1/sqrt(R) scaling; with
row_chunk, the q.k logits accumulate over blocks of rows, then one
softmax, then the context (axial_attention.py:42-74). Column attention is
independent per column, so col_chunk runs it over blocks of columns. Both
engage at the reference's block sizes where R*C exceeds
MAX_TOKENS_PER_MSA. Attention here is plain PyTorch (einsum + softmax), as
in JAX: it returns the row attention maps, and no kernel of the port
replaces it.

Works on one MSA: tokens (R, C) in the ESM vocabulary (33 symbols,
padding_idx 1), mapped from the 21-token alphabet by mymsa_to_esmmsa.
Products go through predictor2d.Linear, so bf16 weights follow JAX's rule
(input cast to the weight's dtype, float32 bias after).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trx2dy_torch.models.predictor2d import Linear
from trx2dy_torch.utils.profiling import span

EMBED_DIM = 768
HEADS = 12
LAYERS = 12
FFN_DIM = 3072
VOCAB = 33
MAX_POSITIONS = 1024
MAX_ROWS = 1024              # msa_position_embedding (1, 1024, 1, 1)
PADDING_IDX = 1
MAX_TOKENS_PER_MSA = 2 ** 16   # reference default (esm/pretrained.py:61)
_LN_EPS = 1e-12

# 21-token alphabet -> ESM-MSA vocabulary (utils_trX2dy/utils.py:800-821)
_ESM_TOKEN_TABLE = np.array([5, 10, 17, 13, 23, 16, 9, 6, 21, 12, 4, 15, 20,
                             18, 14, 8, 11, 22, 19, 7, 30, 32])


def mymsa_to_esmmsa(msa: np.ndarray, input_type: str = "msa") -> np.ndarray:
    """Prepend cls (0), map the tokens, and for a fasta append eos (2)."""
    msa = np.asarray(msa).astype(np.int64)
    cls = np.zeros_like(msa[..., 0:1])
    body = _ESM_TOKEN_TABLE[msa]
    if input_type == "fasta":
        eos = 2 * np.ones_like(msa[..., 0:1])
        return np.concatenate([cls, body, eos], axis=-1)
    return np.concatenate([cls, body], axis=-1)


class ESM1bLayerNorm(nn.Module):
    """TF-style layer norm, eps 1e-12 inside the sqrt (esm/modules.py:
    47-64), computed in the input's dtype; the float32 affine promotes a
    bf16 input to float32, as in JAX."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + _LN_EPS) * self.weight + self.bias


class _Projections(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.k_proj = Linear(d, d)
        self.v_proj = Linear(d, d)
        self.q_proj = Linear(d, d)
        self.out_proj = Linear(d, d)


class RowSelfAttention(_Projections):
    """Tied row self-attention (axial_attention.py:12-140)."""

    def __init__(self, d: int, heads: int):
        super().__init__(d)
        self.heads = heads

    def forward(self, x, padding_mask, row_chunk: Optional[int] = None):
        """x (R, C, D), padding_mask (R, C) float or None. Returns
        (out (R, C, D), attn (H, C, C))."""
        R, C, D = x.shape
        H = self.heads
        hd = D // H
        scaling = hd ** -0.5 / math.sqrt(R)

        def qk(xc, mask_c):
            q = self.q_proj(xc).reshape(xc.shape[0], C, H, hd) * scaling
            if mask_c is not None:
                q = q * (1 - mask_c[..., None, None])
            k = self.k_proj(xc).reshape(xc.shape[0], C, H, hd)
            return torch.einsum("rihd,rjhd->hij", q, k)

        if row_chunk is None or R <= row_chunk:
            attn_w = qk(x, padding_mask)
        else:
            # rows past R contribute nothing in JAX's padded scan (their
            # q is zeroed), so the blocks are the slices themselves
            attn_w = None
            for r0 in range(0, R, row_chunk):
                mc = None if padding_mask is None \
                    else padding_mask[r0:r0 + row_chunk]
                part = qk(x[r0:r0 + row_chunk], mc)
                attn_w = part if attn_w is None else attn_w + part
        if padding_mask is not None:
            # keyed on the first row's padding (axial_attention.py:100-104)
            attn_w = attn_w.masked_fill(padding_mask[0][None, None, :] > 0,
                                        -10000.0)
        attn = torch.softmax(attn_w, dim=-1)                 # (H, C, C)
        v = self.v_proj(x).reshape(R, C, H, hd)
        ctx = torch.einsum("hij,rjhd->rihd", attn, v)
        return self.out_proj(ctx.reshape(R, C, D)), attn


class ColumnSelfAttention(_Projections):
    """Column self-attention (axial_attention.py:140-245): each column's
    (R x R) attention is independent, so col_chunk blocks are exact."""

    def __init__(self, d: int, heads: int):
        super().__init__(d)
        self.heads = heads

    def _block(self, xc, mask_c):
        R, Cc, D = xc.shape
        H = self.heads
        hd = D // H
        q = self.q_proj(xc).reshape(R, Cc, H, hd) * hd ** -0.5
        k = self.k_proj(xc).reshape(R, Cc, H, hd)
        v = self.v_proj(xc).reshape(R, Cc, H, hd)
        attn_w = torch.einsum("ichd,jchd->hcij", q, k)
        if mask_c is not None:
            attn_w = attn_w.masked_fill(
                mask_c.T[None, :, None, :] > 0, -10000.0)
        attn = torch.softmax(attn_w, dim=-1)
        ctx = torch.einsum("hcij,jchd->ichd", attn, v)
        return self.out_proj(ctx.reshape(R, Cc, D))

    def forward(self, x, padding_mask, col_chunk: Optional[int] = None):
        R, C, _ = x.shape
        if R == 1:
            return self.out_proj(self.v_proj(x))
        if col_chunk is None or C <= col_chunk:
            return self._block(x, padding_mask)
        return torch.cat([
            self._block(x[:, c0:c0 + col_chunk],
                        None if padding_mask is None
                        else padding_mask[:, c0:c0 + col_chunk])
            for c0 in range(0, C, col_chunk)], dim=1)


class _Residual(nn.Module):
    """Pre-LN residual wrapper: `layer` and `layer_norm`, the keys of
    esm/modules.py:380-412's NormalizedResidualBlock."""

    def __init__(self, layer: nn.Module, d: int):
        super().__init__()
        self.layer = layer
        self.layer_norm = ESM1bLayerNorm(d)


class FeedForward(nn.Module):
    def __init__(self, d: int, ffn: int):
        super().__init__()
        self.fc1 = Linear(d, ffn)
        self.fc2 = Linear(ffn, d)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))                 # exact GELU


class AxialTransformerLayer(nn.Module):
    def __init__(self, d: int, heads: int, ffn: int):
        super().__init__()
        self.row_self_attention = _Residual(RowSelfAttention(d, heads), d)
        self.column_self_attention = _Residual(
            ColumnSelfAttention(d, heads), d)
        self.feed_forward_layer = _Residual(FeedForward(d, ffn), d)

    def forward(self, x, padding_mask, row_chunk, col_chunk):
        row = self.row_self_attention
        h, attn = row.layer(row.layer_norm(x), padding_mask, row_chunk)
        x = x + h
        col = self.column_self_attention
        x = x + col.layer(col.layer_norm(x), padding_mask, col_chunk)
        ff = self.feed_forward_layer
        return x + ff.layer(ff.layer_norm(x)), attn


class LMHead(nn.Module):
    """RobertaLMHead (esm/modules.py:318-334); the output projection is the
    token embedding (tied), so its `weight` key, where a checkpoint has
    one, is not read."""

    def __init__(self, d: int, vocab: int):
        super().__init__()
        self.dense = Linear(d, d)
        self.layer_norm = ESM1bLayerNorm(d)
        self.bias = nn.Parameter(torch.zeros(vocab))


class ContactHead(nn.Module):
    def __init__(self, n_feats: int):
        super().__init__()
        self.regression = Linear(n_feats, 1)


class ESMMSA(nn.Module):
    """MSATransformer(1b).forward (esm/model.py:334-420, 586-602) for one
    MSA."""

    def __init__(self, layers: int = LAYERS, embed_dim: int = EMBED_DIM,
                 heads: int = HEADS, ffn_dim: int = FFN_DIM,
                 vocab: int = VOCAB, max_positions: int = MAX_POSITIONS,
                 max_rows: int = MAX_ROWS):
        super().__init__()
        self.embed_tokens = nn.Embedding(vocab, embed_dim)
        self.embed_positions = nn.Embedding(
            max_positions + PADDING_IDX + 1, embed_dim)
        self.msa_position_embedding = nn.Parameter(
            torch.zeros(1, max_rows, 1, 1))
        self.emb_layer_norm_before = ESM1bLayerNorm(embed_dim)
        self.layers = nn.ModuleList(
            AxialTransformerLayer(embed_dim, heads, ffn_dim)
            for _ in range(layers))
        self.emb_layer_norm_after = ESM1bLayerNorm(embed_dim)
        self.lm_head = LMHead(embed_dim, vocab)
        self.contact_head = ContactHead(layers * heads)

    def forward(self, tokens, repr_layers=(12,),
                need_head_weights: bool = True,
                row_chunk: Optional[int] = None,
                col_chunk: Optional[int] = None,
                max_tokens_per_msa: int = MAX_TOKENS_PER_MSA,
                res_idx=None) -> dict:
        """tokens (R, C) int ESM-vocabulary tokens, C including the cls
        column. row_chunk / col_chunk: accumulate the tied-row logits over
        blocks of that many rows / run column attention over blocks of that
        many columns; where R*C > max_tokens_per_msa both engage at the
        reference's sizes (max_tokens // C rows, max_tokens // R columns).
        res_idx: custom residue positions, (C,) or (C-1,) without the cls
        slot (a cls position min-1 is prepended), shifted so the minimum is
        2 and clamped to [0, 1000] (esm/modules.py:268, model.py:598-601).

        Returns {'representations': {layer: (R, C, D)}, 'row_attentions'
        (layers, H, C, C) with need_head_weights, 'logits' (R, C, vocab)}.
        """
        with span("esm"):
            R, C = tokens.shape
            n_layers = len(self.layers)
            if R * C > max_tokens_per_msa:
                if row_chunk is None:
                    row_chunk = max(1, max_tokens_per_msa // C)
                if col_chunk is None:
                    col_chunk = max(1, max_tokens_per_msa // R)
            tokens = tokens.long()
            pad = tokens == PADDING_IDX
            padding_mask = pad.float() if bool(pad.any()) else None

            x = self.embed_tokens(tokens)                    # (R, C, D)
            if res_idx is None:
                mask = (~pad).long()
                positions = torch.cumsum(mask, dim=1) * mask + PADDING_IDX
            else:
                r = torch.as_tensor(res_idx, device=tokens.device).reshape(-1)
                if r.shape[0] == C - 1:            # no cls slot: prepend one
                    r = torch.cat([r[:1] - 1, r])
                positions = torch.clamp(r + (2 - r.min()), 0, 1000)
                positions = positions[None, :].expand(R, C)
            x = x + self.embed_positions(positions)
            x = x + self.msa_position_embedding[0, :R]
            x = self.emb_layer_norm_before(x)
            if padding_mask is not None:
                x = x * (1 - padding_mask[..., None])

            reprs = {}
            if 0 in repr_layers:
                reprs[0] = x
            row_attns = []
            for li, layer in enumerate(self.layers):
                x, attn = layer(x, padding_mask, row_chunk, col_chunk)
                if need_head_weights:
                    row_attns.append(attn)
                if li + 1 in repr_layers:
                    reprs[li + 1] = x
            x = self.emb_layer_norm_after(x)
            if n_layers in repr_layers:
                reprs[n_layers] = x                  # post-LN (model.py:419)

            out = {"representations": reprs}
            if need_head_weights:
                out["row_attentions"] = torch.stack(row_attns)
            head = self.lm_head
            h = head.layer_norm(F.gelu(head.dense(x)))
            out["logits"] = torch.einsum(
                "rcd,vd->rcv", h, self.embed_tokens.weight.to(h.dtype)) \
                + head.bias
            return out

    def contacts(self, row_attentions, prepend_bos: bool = True):
        """ContactPredictionHead (esm/modules.py:337-377): symmetrise, APC,
        logistic regression over the (layers * heads) attention maps."""
        a = row_attentions
        if prepend_bos:
            a = a[..., 1:, 1:]
        C = a.shape[-1]
        a = a.reshape(-1, C, C)
        a = a + a.transpose(-1, -2)
        a_i = a.sum(dim=-1, keepdim=True)
        a_j = a.sum(dim=-2, keepdim=True)
        a_all = a.sum(dim=(-1, -2), keepdim=True)
        a = a - a_i * a_j / a_all
        feats = a.permute(1, 2, 0)                           # (C, C, L*H)
        return torch.sigmoid(self.contact_head.regression(feats)[..., 0])
