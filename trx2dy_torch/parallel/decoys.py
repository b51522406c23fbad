"""The decoy ensemble sharded over the mesh's dp axis.

PyTorch counterpart of trx2dy/parallel/decoys.py. The ensemble is
embarrassingly parallel: every rank draws the same global start torsions,
folds its dp slice of them through fold_ensemble on its own device (lane
compaction and every stage inside the rank, restraint tables built on
each rank), and the results are gathered into global decoy order. The mp
ranks of one dp index fold the same slice, as JAX's P("dp", None, None)
replicates the batch over mp.

JAX keeps its staged programs sharded with `_batch_sharder`/`state_put`
(trx2dy/physics/folder.py:56-85, minimize.py:252-265, cartmin.py:307,404,
sidechain.py:268): one controller drives every device, so each array it
makes must be committed to the batch's sharding, or the program would
pull the whole batch onto one device. Here each rank is its own process
driving its own device, so nothing needs that machinery.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from trx2dy_torch.parallel.mesh import axis, gather, shard_batch
from trx2dy_torch.physics import sidechain
from trx2dy_torch.physics.folder import (
    FoldResult, fold_ensemble, random_torsions,
)


def fold_ensemble_sharded(mesh, npz: dict, seq: str,
                          generator: Optional[torch.Generator],
                          n_decoys: int, device="cuda",
                          return_starts: bool = False, **fold_kwargs):
    """fold_ensemble with the decoy batch sharded over the mesh's dp axis;
    every rank returns the whole result, in global decoy order, on
    `device`. n_decoys must be divisible by the dp size (ValueError).
    Every rank passes a generator in the same state: the starts are drawn
    on the CPU from it (folder.random_torsions). return_starts: return
    (result, starts), the (n_decoys, 3, L) start torsions each rank
    folded, gathered the same way. Every other fold_ensemble option
    passes through."""
    _, dp, _ = axis(mesh, "dp")
    if n_decoys % dp:
        raise ValueError(f"n_decoys={n_decoys} not divisible by dp={dp}")
    x0 = shard_batch(random_torsions(generator, len(seq), n_decoys), mesh)
    res = fold_ensemble(npz, seq, None, n_decoys=n_decoys // dp, x0=x0,
                        device=device, **fold_kwargs)
    out = FoldResult(
        torsions=gather(res.torsions, mesh, "dp"),
        energy=gather(res.energy, mesh, "dp"),
        atoms={k: gather(v, mesh, "dp") for k, v in res.atoms.items()})
    if return_starts:
        return out, gather(x0.to(res.energy.device), mesh, "dp")
    return out


def pack_ensemble_sharded(mesh, res: FoldResult, seq: str,
                          max_iter: int = 150, device="cuda"):
    """sidechain.pack_ensemble of a whole fold result, each rank packing
    its dp slice of the decoys onto their atoms, gathered into global
    decoy order: (atom14 (B, L, 14, 3), atom14_mask (L, 14), chi (B, L,
    4)). The disulfide pairs come from the whole ensemble's mean CB, as
    one process detects them."""
    atoms = {k: torch.as_tensor(v) for k, v in res.atoms.items()}
    pairs = sidechain.detect_disulfides(
        atoms["CB"].float().mean(0).cpu().numpy(), seq)
    xyz, mask, chi = sidechain.pack_ensemble(
        shard_batch(torch.as_tensor(res.torsions), mesh), seq,
        max_iter=max_iter, pairs=np.asarray(pairs),
        backbone={k: shard_batch(v, mesh) for k, v in atoms.items()},
        device=device)
    return gather(xyz, mesh, "dp"), mask, gather(chi, mesh, "dp")
