"""What each rank of the port's sharded CPU tests runs
(tests/test_torch_parallel.py). The ranks are fresh processes
(scripts/ranks.py spawn_ranks), which import this module and not the test
module, so that no rank imports JAX.
"""
import numpy as np
import torch
import torch.distributed as dist

from trx2dy_torch.models.convert import build_model
from trx2dy_torch.models.train import (
    init_train_state, make_optimizer, make_train_step, value_and_grad,
)
from trx2dy_torch.parallel.decoys import (
    fold_ensemble_sharded, pack_ensemble_sharded,
)
from scripts.ranks import digest
from trx2dy_torch.parallel.mesh import (
    axis, make_mesh, replicated, shard, shard_msa,
)

TRAIN_DEPTH = 1
TRUNK_DEPTH = 2
DROPOUT_SEED = 7
STEPS = 3
FOLD_DECOYS = 4
FOLD_ITERS = 5


def tensors(batch, device="cpu"):
    """(f2d, msa, labels, mask) as tensors on device from numpy."""
    f2d, msa, labels, mask = batch
    to = lambda a: torch.from_numpy(a).to(device)
    return to(f2d), to(msa), {k: to(v) for k, v in labels.items()}, to(mask)


def loss_and_grads(params, batch, dropout: bool, mesh=None, device="cpu"):
    """The step's loss and gradients (before clipping) from fresh weights,
    as numpy; with dropout, the masks of step 0 of DROPOUT_SEED."""
    model = build_model(params, device)
    gen = torch.Generator(device=device).manual_seed(DROPOUT_SEED) \
        if dropout else None
    loss = value_and_grad(model, *tensors(batch, device), depth=TRAIN_DEPTH,
                          generator=gen, mesh=mesh)
    return float(loss), {k: (np.zeros(tuple(p.shape), np.float32)
                             if p.grad is None else p.grad.cpu().numpy())
                         for k, p in model.named_parameters()}


def train_steps(params, batch, mesh=None, device="cpu"):
    """STEPS steps with dropout and remat: (losses, digest of the
    parameters after them)."""
    opt = make_optimizer(lr=1e-3)
    state = init_train_state(build_model(params, device), opt)
    step = make_train_step(opt, mesh=mesh, depth=TRAIN_DEPTH, dropout=True,
                           remat=True, dropout_seed=DROPOUT_SEED)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, *tensors(batch, device))
        losses.append(float(loss))
    return losses, digest(list(state.model.parameters()))


def trunk_logits(params, f2d, msa, mesh=None):
    """Predictor2D's logits at TRUNK_DEPTH, with the rows split over the
    mesh's mp axis."""
    model = build_model(params, "cpu")
    mp, _, _ = axis(mesh, "mp")
    with torch.inference_mode():
        out = model(torch.from_numpy(f2d),
                    shard(torch.from_numpy(msa), mesh, "mp"), mp=mp)
    return {k: v.numpy() for k, v in out.items()}


def fold(npz, seq, seed, mesh=None, n_decoys=FOLD_DECOYS):
    """fold_ensemble_sharded at FOLD_ITERS without FastRelax, the starts
    it folded and the packed side chains, as numpy."""
    gen = torch.Generator().manual_seed(seed)
    res, starts = fold_ensemble_sharded(mesh, npz, seq, gen, n_decoys,
                                        device="cpu", max_iter=FOLD_ITERS,
                                        fastrelax=False, return_starts=True)
    xyz, _, chi = pack_ensemble_sharded(mesh, res, seq, max_iter=20,
                                        device="cpu")
    return {"starts": starts.numpy(), "torsions": res.torsions.numpy(),
            "energy": res.energy.numpy(),
            "ca": res.atoms["CA"].numpy(), "xyz": xyz.numpy(),
            "chi": chi.numpy()}


def references(train, trunk, fold_args):
    """The one-process results the world is held to, on the same inputs:
    the loss and gradients without and with dropout, the trunk's logits
    and the fold (in a process of its own, one torch thread, as a rank)."""
    params, batch = train
    return {"grads": {d: loss_and_grads(params, batch, d)
                      for d in (False, True)},
            "trunk": trunk_logits(*trunk), "fold": fold(*fold_args)}


def world(train, trunk, fold_args):
    """One rank of the 4-rank (dp=2, mp=2) gloo world: the mesh, the
    sharded train step's loss and gradients without and with dropout,
    STEPS sharded steps, the mp-split trunk and the dp-sharded fold (and
    its refusal of an indivisible decoy count). Rank 0 returns the
    tensors; every rank returns the digests and the losses."""
    mesh = make_mesh(device_type="cpu")
    rank = dist.get_rank()
    params, batch = train
    replicated([torch.from_numpy(v) for v in params.values()])
    out = {"shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "coords": (axis(mesh, "dp")[2], axis(mesh, "mp")[2]),
           "msa_shard": shard_msa(torch.arange(4 * 6 * 3).reshape(4, 6, 3),
                                  mesh).numpy()}
    grads = {}
    for dropout in (False, True):
        loss, g = loss_and_grads(params, batch, dropout, mesh)
        grads[dropout] = (loss, g if rank == 0 else None)
    out["grads"] = grads
    out["steps"] = train_steps(params, batch, mesh)
    logits = trunk_logits(*trunk, mesh=mesh)
    out["trunk"] = logits if rank == 0 else None
    folded = fold(*fold_args, mesh=mesh)
    out["fold_digest"] = digest([torch.from_numpy(v)
                                 for v in folded.values()])
    out["fold"] = folded if rank == 0 else None
    try:
        fold(*fold_args, mesh=mesh, n_decoys=FOLD_DECOYS - 1)
    except ValueError as e:
        out["indivisible"] = str(e)
    return out
