"""The end-to-end static structure predictor (trRosettaX2 "model_1").

Port of trx2dy/models/folding_e2e.py, after main_chunk.py:20-196
(Folding): ESM-MSA features -> a recycling loop of [RecyclingEmbedder ->
e2e Predictor2D trunk -> StructureModuleFullAtom -> pLDDT head].

Pair features (InputEmbedder.get_f2d, main_chunk.py:29-53):
  f2d (L, L, 2642) = [query ESM repr tiled over i (768) | over j (768) |
                      row attentions 12 x 12 (144) | 31-token DCA (962)]
The ESM layer-12 representations of the trunk's rows (msa_emb) are added
to its token embedding through `net2d.linear_emb`.

The trunk's, structure module's and pLDDT head's sizes come from the
checkpoint's shapes (model_1.json is not distributed; predict.py:118-121
only forwards its keys): Folding.config_of. The reference passes
the cycle-0 zero coordinates to the RecyclingEmbedder on every cycle
(main_chunk.py:150-156), so its coordinate recycling is inert;
coord_recycling=False (the default) keeps that, and True passes each
cycle's CA coordinates to the next, as JAX's folding_apply does.
"""
from __future__ import annotations

import re
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from trx2dy_torch.device import StageTimer
from trx2dy_torch.models.constants import sequence_to_aatype
from trx2dy_torch.models.features import fast_dca, reweight
from trx2dy_torch.models.predictor2d import (
    DEPTH, DIM, LayerNorm, Linear, Predictor2D,
)
from trx2dy_torch.models.structure_module import SMConfig, StructureModule

N_ESM_TOKENS = 31
ESM_DIM = 768
E2E_IN_DIM = 2 * ESM_DIM + 144 + N_ESM_TOKENS ** 2 + 1     # 2642
DIST_BINS = np.arange(2.0, 20.5, 0.5)   # 37 recycling distance bins
PLDDT_BINS = 50
PLDDT_HIDDEN = 128


def e2e_pair_features(esm_repr: torch.Tensor, row_attn: torch.Tensor,
                      msa_esm: torch.Tensor):
    """((L, L, 2642) pair features, (R, L, D) representations without the
    cls column).

    esm_repr: (R, C) layer-12 representations with the cls column; row_attn
    (layers, heads, C, C); msa_esm (R, C) ESM-vocabulary tokens with cls,
    for the DCA block."""
    repr_noclr = esm_repr[:, 1:]                         # (R, L, D)
    seq_emb = repr_noclr[0]                              # (L, D)
    L = seq_emb.shape[0]
    pair_emb = torch.cat([seq_emb[None, :, :].expand(L, L, -1),
                          seq_emb[:, None, :].expand(L, L, -1)], dim=-1)
    attn_feats = row_attn[:, :, 1:, 1:].reshape(-1, L, L).permute(1, 2, 0)
    tokens = msa_esm[:, 1:].long()
    msa1hot = (torch.arange(N_ESM_TOKENS, device=tokens.device)
               == tokens[..., None]).float()
    if tokens.shape[0] > 1:
        dca = fast_dca(msa1hot, reweight(msa1hot, 0.8))  # (L, L, 962)
    else:
        dca = msa1hot.new_zeros((L, L, N_ESM_TOKENS ** 2 + 1))
    return torch.cat([pair_emb, attn_feats, dca], dim=-1), repr_noclr


def one_hot_dist(x: torch.Tensor) -> torch.Tensor:
    """Recycling distance binning (main_chunk.py:10-17)."""
    bins = torch.as_tensor(DIST_BINS, dtype=x.dtype, device=x.device)
    binned = torch.sum(bins <= x[..., None], dim=-1)
    binned = torch.clamp_max(binned, len(DIST_BINS) - 1)
    return F.one_hot(binned, len(DIST_BINS)).to(x.dtype)


class RecyclingEmbedder(nn.Module):
    """main_chunk.py:97-112."""

    def __init__(self, d: int = DIM):
        super().__init__()
        self.linear = Linear(len(DIST_BINS), d)
        self.norm_pair = LayerNorm(d)
        self.norm_msa = LayerNorm(d)

    def forward(self, pair_prev, single_prev, x_prev):
        d = torch.sqrt(torch.sum(
            (x_prev[:, None, :] - x_prev[None, :, :]) ** 2, dim=-1) + 1e-12)
        pair = self.norm_pair(pair_prev) + self.linear(one_hot_dist(d))
        return self.norm_msa(single_prev), pair


class PLDDTHead(nn.Sequential):
    """to_plddt (main_chunk.py:128-135, 188-191): LN, Linear, ReLU,
    Linear, ReLU, Linear; the pLDDT is the expectation over 50 bins."""

    def __init__(self, c_s: int = DIM, hidden: int = PLDDT_HIDDEN,
                 bins: int = PLDDT_BINS):
        super().__init__(LayerNorm(c_s), Linear(c_s, hidden), nn.ReLU(),
                         Linear(hidden, hidden), nn.ReLU(),
                         Linear(hidden, bins))

    def forward(self, single):
        prob = torch.softmax(super().forward(single), dim=-1)
        n = prob.shape[-1]
        centers = torch.arange(n, dtype=prob.dtype, device=prob.device) \
            * (1.0 / n) + 0.5 / n                         # 0.01, ..., 0.99
        return torch.sum(prob * centers, dim=-1), prob


def infer_sm_config(state: Mapping[str, torch.Tensor],
                    prefix: str = "structure_module") -> SMConfig:
    """The structure module's sizes from a checkpoint's weight shapes."""
    def shape(k):
        return tuple(state[f"{prefix}.{k}"].shape)
    n_heads = shape("ipa.head_weights")[0]
    no_qk = shape("ipa.linear_q_points.weight")[0] // (n_heads * 3)
    no_v = shape("ipa.linear_kv_points.weight")[0] // (n_heads * 3) - no_qk

    def count(part):
        return len({k.split(".")[3] for k in state
                    if k.startswith(f"{prefix}.{part}.layers.")})
    return SMConfig(
        c_s=shape("linear_in.weight")[0], c_z=shape("layer_norm_z.weight")[0],
        c_ipa=shape("ipa.linear_q.weight")[0] // n_heads,
        no_heads_ipa=n_heads, no_qk_points=no_qk, no_v_points=no_v,
        c_resnet=shape("angle_resnet.linear_in.weight")[0],
        no_resnet_blocks=count("angle_resnet"),
        no_transition_layers=count("transition"))


_BLOCK_RE = re.compile(r"^net2d\.net\.blocks\.(\d+)\.")


class Folding(nn.Module):
    """main_chunk.py:20-196's Folding: `net2d` (the e2e Predictor2D),
    `recycle_embedder`, `structure_module`, `to_plddt`."""

    def __init__(self, depth: int = DEPTH, dim: int = DIM,
                 in_dim: int = E2E_IN_DIM, n_tokens: int = N_ESM_TOKENS,
                 emb_dim: int = ESM_DIM, sm: SMConfig = SMConfig(),
                 plddt_hidden: int = PLDDT_HIDDEN,
                 plddt_bins: int = PLDDT_BINS):
        super().__init__()
        self.dim = dim
        self.net2d = Predictor2D(depth, dim, in_dim, n_tokens, emb_dim)
        self.recycle_embedder = RecyclingEmbedder(dim)
        self.structure_module = StructureModule(sm)
        self.to_plddt = PLDDTHead(sm.c_s, plddt_hidden, plddt_bins)

    @staticmethod
    def config_of(state: Mapping[str, torch.Tensor]) -> dict:
        """Constructor arguments read from a checkpoint's shapes."""
        conv1 = state["net2d.conv1.weight"]
        depth = 1 + max(int(m.group(1)) for k in state
                        if (m := _BLOCK_RE.match(k)))
        return {"depth": depth, "dim": conv1.shape[0],
                "in_dim": conv1.shape[1],
                "n_tokens": state["net2d.token_emb.weight"].shape[0],
                "emb_dim": state["net2d.linear_emb.weight"].shape[1],
                "sm": infer_sm_config(state),
                "plddt_hidden": state["to_plddt.1.weight"].shape[0],
                "plddt_bins": state["to_plddt.5.weight"].shape[0]}

    def forward(self, seq: str, msa_esm, esm_repr, row_attn,
                n_recycle: int = 3, msa_cutoff: int = 500,
                sm_blocks: int = 8, trunk_depth: Optional[int] = DEPTH,
                coord_recycling: bool = False,
                timer: Optional[StageTimer] = None) -> dict:
        """Folding.forward (main_chunk.py:137-195), folding_apply in JAX.

        msa_esm (R, C) ESM-vocabulary tokens with cls (the filtered MSA);
        esm_repr (R, C, D) and row_attn (layers, heads, C, C), ESM-MSA's
        outputs for the same MSA. trunk_depth runs the trunk's first blocks.
        timer, if given, is called at the end of each stage: the features,
        then each cycle's trunk and structure module with its pLDDT head.

        Returns the last cycle's {'geoms': softmaxed dist/omega/theta/phi,
        'plddt' (L,), 'plddt_prob', and the structure module's outputs
        (frames, angles, single, cords_ca, atom14, atom14_mask)}."""
        dev = msa_esm.device
        tick = timer or (lambda stage: None)
        aatype = torch.as_tensor(sequence_to_aatype(seq), device=dev)
        L = len(seq)
        f2d, repr_noclr = e2e_pair_features(esm_repr, row_attn, msa_esm)
        msa_trunk = msa_esm[:msa_cutoff, 1:]
        msa_emb = repr_noclr[:msa_cutoff]
        tick("features")

        pair_prev = torch.zeros(L, L, self.dim, device=dev)
        single_prev = torch.zeros(L, self.dim, device=dev)
        x_prev = torch.zeros(L, 3, device=dev)
        out = None
        for cycle in range(1 + n_recycle):
            rec_single, rec_pair = self.recycle_embedder(
                pair_prev, single_prev, x_prev)
            logits, reprs = self.net2d(
                f2d, msa_trunk, msa_emb=msa_emb,
                rec_reprs={"single": rec_single, "pair": rec_pair},
                return_repr=True, depth=trunk_depth)
            geoms = {k: torch.softmax(v, dim=-1) for k, v in logits.items()}
            tick(f"trunk_{cycle}")
            sm_out = self.structure_module(reprs["msa"][0], reprs["pair"],
                                           aatype, no_blocks=sm_blocks)
            plddt, plddt_prob = self.to_plddt(sm_out["single"])
            tick(f"structure_{cycle}")
            out = {"geoms": geoms, "plddt": plddt, "plddt_prob": plddt_prob,
                   **sm_out}
            pair_prev, single_prev = reprs["pair"], reprs["msa"][0]
            if coord_recycling:
                x_prev = sm_out["cords_ca"]
        return out

