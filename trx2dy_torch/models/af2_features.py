"""AlphaFold2's input features, built on the device from MSA tokens and
deletion counts.

After the monomer data pipeline of AlphaFold2 (Jumper et al., Nature
596:583, 2021, Supplementary 1.2.5-1.2.7; alphafold/model/tf/
data_transforms.py): the query stays the first row; the other rows are
shuffled by a seed, the first `clusters - 1` of them join the query as the
cluster centres and the next `extra` rows (at most) form the extra MSA;
each extra row is assigned to the centre it agrees with at the most
positions (gaps and mask tokens count for nothing), which gives every
centre its profile and mean deletion count. Then

- msa_feat (49): the centre's one-hot (23), has_deletion, deletion_value,
  the cluster profile (23), deletion_mean_value;
- extra_msa_feat (25): the extra row's one-hot (23), has_deletion,
  deletion_value;
- target_feat (22): has_break (0 for one chain) and the query's one-hot
  over the 20 residues and X.

Deletion values are atan(d / 3) * 2 / pi. AlphaFold2's 23 MSA tokens are
the 20 residues in the port's order (ARNDCQEGHILKMFPSTWYV), X (20), the
gap (21) and the mask token (22); the port's alphabet (io/a3m.py) has the
residues at 0-19 and the gap at 20, which becomes 21.

Departures from the released inference pipeline, for the port's use:
one draw of the clusters for every recycling cycle (AlphaFold2 draws
them anew each cycle), and no masked-MSA replacement of the centres
(its 15 % are randomly replaced at inference too): the features are a
function of the MSA, the deletions and the seed alone.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from trx2dy_torch.utils.profiling import span

PORT_GAP = 20
AF2_X, AF2_GAP, AF2_MASK = 20, 21, 22
MSA_TOKENS = 23
MSA_FEAT, EXTRA_MSA_FEAT, TARGET_FEAT = 49, 25, 22
MSA_CLUSTERS = 512        # max_msa_clusters of the monomer config
EXTRA_MSA = 1024          # max_extra_msa of the base config


def cluster_order(n_rows: int, seed: int) -> torch.Tensor:
    """The query (0), then rows 1..n_rows-1 in an order drawn from `seed`
    (on the CPU, so every device draws the same)."""
    gen = torch.Generator().manual_seed(int(seed))
    rest = torch.randperm(n_rows - 1, generator=gen) + 1
    return torch.cat([torch.zeros(1, dtype=torch.long), rest])


def _deletion_value(d: torch.Tensor) -> torch.Tensor:
    return torch.atan(d / 3.0) * (2.0 / math.pi)


def featurize(msa, deletion, seed: int, clusters: int = MSA_CLUSTERS,
              extra: int = EXTRA_MSA, device=None) -> dict:
    """{'target_feat' (L, 22), 'msa_feat' (N, L, 49), 'extra_msa_feat'
    (E, L, 25), 'aatype' (L,), 'residue_index' (L,)} on `device`.

    msa: (rows, L) tokens in the port's alphabet (numpy or tensor);
    deletion: (rows, L) deletion counts (the lowercase letters before each
    column of an a3m row); N = min(rows, clusters), E = min(rows - N,
    extra)."""
    with span("features"):
        msa = torch.as_tensor(np.asarray(msa), device=device).long()
        deletion = torch.as_tensor(np.asarray(deletion), device=msa.device,
                                   dtype=torch.float32)
        rows, L = msa.shape
        order = cluster_order(rows, seed).to(msa.device)
        n = min(rows, clusters)
        centres, others = order[:n], order[n:n + extra]
        tokens = torch.where(msa == PORT_GAP, AF2_GAP, msa)
        c_hot = F.one_hot(tokens[centres], MSA_TOKENS).float()
        e_hot = F.one_hot(tokens[others], MSA_TOKENS).float()
        c_del, e_del = deletion[centres], deletion[others]

        weight = torch.ones(MSA_TOKENS, device=msa.device)
        weight[AF2_GAP] = weight[AF2_MASK] = 0.0
        agreement = torch.einsum("elc,nlc->en", e_hot * weight, c_hot)
        assign = agreement.argmax(dim=1)                   # (E,)
        count = torch.bincount(assign, minlength=n).float()
        profile = c_hot.index_add(0, assign, e_hot) \
            / (1.0 + count)[:, None, None]
        del_mean = c_del.index_add(0, assign, e_del) / (1.0 + count)[:, None]

        msa_feat = torch.cat([c_hot, (c_del > 0).float()[..., None],
                              _deletion_value(c_del)[..., None], profile,
                              _deletion_value(del_mean)[..., None]], dim=-1)
        extra_feat = torch.cat([e_hot, (e_del > 0).float()[..., None],
                                _deletion_value(e_del)[..., None]], dim=-1)
        aatype = torch.clamp_max(msa[0], AF2_X)            # a gap is X
        target_feat = torch.cat([torch.zeros(L, 1, device=msa.device),
                                 F.one_hot(aatype, AF2_X + 1).float()],
                                dim=-1)
        return {"target_feat": target_feat, "msa_feat": msa_feat,
                "extra_msa_feat": extra_feat, "aatype": aatype,
                "residue_index": torch.arange(L, device=msa.device)}
