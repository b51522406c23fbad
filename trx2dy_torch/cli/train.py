"""Train the Predictor2D geometry network on the PyTorch port
(trx2dy/cli/train.py's flags, example order, log lines and checkpoints).

Per-target (a3m, native PDB) pairs -> features (reweight/PSSM/DCA) +
binned-geometry labels -> masked cross-entropy over the four heads, AdamW
with clipping, npz checkpoints ckpt_<step>.npz under the checkpoint's own
keys, which the inference pipeline and either package's load_params_npz
read. As in JAX, the step takes the logits attention (the CUDA kernel is
forward-only) and runs without dropout or remat.

    python -m trx2dy_torch.cli.train --data_dir data/ --out_dir ckpt/ \\
        [--steps 1000] [--lr 1e-3] [--depth 12] [--msa_rows 128] \\
        [--ckpt_every 200] [--resume ckpt_200.npz] [--seed 0] [--mesh] \\
        [--device cpu]

--data_dir holds <name>.a3m + <name>.pdb pairs. --mesh builds the (dp,
mp) mesh (parallel.mesh.make_mesh: over the ranks of a process group the
caller made, the (1, 1) mesh in one process) and prints its shape; as in
JAX, the CLI's step does not use it. Sharded training is
models.train.make_train_step(mesh=...), one process a rank.
"""
from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train trx2dy Predictor2D")
    p.add_argument("--data_dir", required=True,
                   help="directory of <name>.a3m + <name>.pdb pairs")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--depth", type=int, default=12)
    p.add_argument("--msa_rows", type=int, default=128,
                   help="MSA rows fed to the trunk per example")
    p.add_argument("--ckpt_every", type=int, default=200)
    p.add_argument("--resume", type=str, default=None,
                   help="npz checkpoint to resume from")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", action="store_true",
                   help="build the (dp, mp) mesh and print its shape")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch path)")
    return p


def main(argv=None, timings: list = None):
    """Train and write the checkpoints; returns (final TrainState, the loss
    of every step). timings, if given, receives (stage, seconds) for each
    step's features ("features"), train step ("step") and checkpoint
    ("checkpoint")."""
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from trx2dy_torch.device import StageTimer, resolve_device
    from trx2dy_torch.models.convert import (
        build_model, init_state_dict, load_params, save_params_npz,
    )
    from trx2dy_torch.models.dataset import load_example
    from trx2dy_torch.models.features import get_f2d
    from trx2dy_torch.models.train import (
        init_train_state, make_optimizer, make_train_step,
    )

    dev = resolve_device(args.device)
    names = sorted({os.path.splitext(f)[0]
                    for f in os.listdir(args.data_dir)
                    if f.endswith(".a3m")})
    examples = []
    for name in names:
        pdb = os.path.join(args.data_dir, name + ".pdb")
        a3m = os.path.join(args.data_dir, name + ".a3m")
        if not os.path.exists(pdb):
            continue
        ex = load_example(a3m, pdb)
        if ex is not None:
            examples.append(ex)
    if not examples:
        raise SystemExit(f"no usable (a3m, pdb) pairs in {args.data_dir}")
    print(f"[trx2dy] {len(examples)} training targets")

    params = load_params(args.resume) if args.resume \
        else init_state_dict(args.seed, depth=args.depth)
    opt = make_optimizer(lr=args.lr)
    state = init_train_state(build_model(params, dev), opt)
    if args.mesh:
        from trx2dy_torch.parallel.mesh import make_mesh
        mesh = make_mesh(device_type=dev.type)
        print(f"[trx2dy] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    # JAX's CLI step: one sample, no dropout, no remat
    step = make_train_step(opt, depth=args.depth)

    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    losses = []
    tick = StageTimer(timings, dev)
    for it in range(args.steps):
        ex = examples[int(rng.integers(len(examples)))]
        msa = torch.as_tensor(ex.msa[:args.msa_rows], dtype=torch.int64,
                              device=dev)
        f2d = get_f2d(msa)
        labels = {k: torch.as_tensor(v, device=dev)[None]
                  for k, v in ex.labels.items()}
        mask = torch.as_tensor(ex.mask, device=dev)[None]
        tick("features")
        state, loss = step(state, f2d[None], msa[None], labels, mask)
        tick("step")
        losses.append(float(loss))
        if it % 10 == 0:
            print(f"[trx2dy] step {it} loss {losses[-1]:.4f}", flush=True)
        if (it + 1) % args.ckpt_every == 0 or it == args.steps - 1:
            path = os.path.join(args.out_dir, f"ckpt_{it + 1}.npz")
            save_params_npz(state.model.state_dict(), path)
            print(f"[trx2dy] saved {path}", flush=True)
        tick("checkpoint")
    return state, losses


if __name__ == "__main__":
    main()
