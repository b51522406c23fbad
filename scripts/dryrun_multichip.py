"""One sharded train step and one decoy-sharded fold over every rank of a
torchrun world: the port's counterpart of __graft_entry__.dryrun_multichip.

    torchrun --nproc_per_node 4 scripts/dryrun_multichip.py          # NCCL
    torchrun --nproc_per_node 4 scripts/dryrun_multichip.py --device cpu

One process a card (LOCAL_RANK), NCCL on the cards, gloo with --device
cpu. The mesh is make_mesh()'s (dp, mp): 4 ranks give (2, 2). At the
model's width (dim 128) and JAX's dry-run depth and shapes: the step
(depth 2, L=12, one sample a dp rank, max(2 mp, 4) rows) is held to the
same step on one process on rank 0 (loss and gradients within 1e-4
relative), and the ranks' parameters after it must be bit-identical; the
fold (L=10, 2 decoys a dp rank, FastRelax, max_iter 3) must give finite
energies in global decoy order on every rank, and its sharded packing
finite side chains. Rank 0 prints one line; any failure raises.
"""
import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEPTH, L_TRAIN, L_FOLD = 2, 12, 10
TOL = 1e-4


def tiny_inputs(L: int, R: int, B: int, seed: int):
    """__graft_entry__._tiny_inputs: (f2d, msa, labels, mask) as numpy."""
    rng = np.random.default_rng(seed)
    msa = rng.integers(0, 21, (B, R, L))
    msa[:, 0] = rng.integers(0, 20, (B, L))
    f2d = rng.normal(size=(B, L, L, 526)).astype(np.float32)
    labels = {k: rng.integers(0, n, (B, L, L))
              for k, n in (("dist", 37), ("omega", 25), ("theta", 25),
                           ("phi", 13))}
    return f2d, msa, labels, np.ones((B, L, L), bool)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu")
    args = p.parse_args()

    from trx2dy_torch.device import resolve_device
    from trx2dy_torch.models.convert import build_model, init_state_dict
    from trx2dy_torch.models.train import (
        init_train_state, make_optimizer, make_train_step, value_and_grad,
    )
    from trx2dy_torch.parallel.decoys import (
        fold_ensemble_sharded, pack_ensemble_sharded,
    )
    from scripts.ranks import digest
    from trx2dy_torch.parallel.mesh import axis, make_mesh

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        mesh = make_mesh(device_type=dev.type)
        rank = dist.get_rank()
        _, dp, _ = axis(mesh, "dp")
        _, mp, _ = axis(mesh, "mp")
        f2d, msa, labels, mask = tiny_inputs(L_TRAIN, max(2 * mp, 4), dp, 1)
        batch = (torch.as_tensor(f2d, device=dev),
                 torch.as_tensor(msa, device=dev),
                 {k: torch.as_tensor(v, device=dev)
                  for k, v in labels.items()},
                 torch.as_tensor(mask, device=dev))
        params = init_state_dict(0, DEPTH)

        model = build_model(params, dev)
        loss = value_and_grad(model, *batch, mesh=mesh).item()
        grads = {k: p.grad for k, p in model.named_parameters()}
        if rank == 0:
            ref = build_model(params, dev)
            ref_loss = value_and_grad(ref, *batch).item()
            worst = max(
                float((grads[k] - p.grad).abs().max()
                      / p.grad.abs().max().clamp_min(1e-30))
                for k, p in ref.named_parameters() if p.grad is not None
                and float(p.grad.abs().max()) > 1e-6)
            if abs(loss - ref_loss) > TOL * abs(ref_loss) or worst > TOL:
                raise RuntimeError(f"sharded step: loss {loss} vs "
                                   f"{ref_loss}, gradients {worst}")
        opt = make_optimizer()
        step = make_train_step(opt, mesh=mesh, depth=DEPTH)
        state, step_loss = step(init_train_state(build_model(params, dev),
                                                 opt), *batch)
        digests = [None] * dist.get_world_size()
        dist.all_gather_object(digests,
                               digest(list(state.model.parameters())))
        if len(set(digests)) != 1:
            raise RuntimeError("ranks hold other parameters after the step")

        rng = np.random.default_rng(2)

        def soft(shape):
            x = rng.random(shape).astype(np.float32)
            return x / x.sum(-1, keepdims=True)
        npz = {"dist": soft((L_FOLD, L_FOLD, 37)),
               "omega": soft((L_FOLD, L_FOLD, 25)),
               "theta": soft((L_FOLD, L_FOLD, 25)),
               "phi": soft((L_FOLD, L_FOLD, 13))}
        seq = "A" * L_FOLD
        res = fold_ensemble_sharded(mesh, npz, seq,
                                    torch.Generator().manual_seed(1),
                                    n_decoys=2 * dp, device=dev, max_iter=3,
                                    fastrelax=True)
        xyz, _, _ = pack_ensemble_sharded(mesh, res, seq, max_iter=3,
                                          device=dev)
        if not (torch.isfinite(res.energy).all()
                and torch.isfinite(xyz).all()
                and res.torsions.shape[0] == 2 * dp):
            raise RuntimeError("sharded fold: non-finite or short result")
        if rank == 0:
            print(f"[trx2dy] dryrun_multichip OK: {dist.get_world_size()} "
                  f"ranks on {dev.type}, mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, train "
                  f"loss {float(step_loss):.4f} (one process "
                  f"{ref_loss:.4f}, gradients within {worst:.2e}), "
                  f"sharded fold {res.torsions.shape[0]} decoys, packed "
                  f"atom14 {tuple(xyz.shape)}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
