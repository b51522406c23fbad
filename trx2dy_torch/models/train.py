"""Training step for the Predictor2D geometry network.

PyTorch counterpart of trx2dy/models/train.py:

  * loss: masked cross-entropy of the four geometry heads against binned
    native geometry (labels from models/dataset.py), summed over the heads;
  * float32 throughout with TF32 off (device.pin_float32, which
    make_train_step calls), as the JAX step computes in its float32
    params' dtype;
  * the triangle attention core on the logits path (use_flash=False), as
    JAX's geometry_loss takes it: the CUDA kernel is forward-only;
  * the reference's structured dropout, its masks drawn per step from an
    explicit torch.Generator seeded from (dropout_seed, step), the
    counterpart of fold_in(PRNGKey(dropout_seed), step);
  * remat per trunk block (torch.utils.checkpoint);
  * clip_by_global_norm then AdamW, with optax's semantics, in a fixed
    number of multi-tensor calls over all the parameter tensors: their
    norms, the scale and torch's fused AdamW.

A TrainState holds the model (whose parameters are JAX's `params`), the
torch AdamW that holds the moments (JAX's `opt_state`) and the step.

With a mesh (parallel/mesh.py make_mesh: one process a rank), the step
takes the global batch on every rank, as JAX's sharded jit does: each
rank runs its dp slice of the samples, each on its mp slice of the MSA
rows (the trunk's `mp`), with the parameters and AdamW state replicated.
After the backward pass, reduce_gradients sums the row parameters'
gradients over mp (each rank holds its rows' share; the pair path's are
whole on every rank and averaged) and averages every gradient over dp
(the loss is a mean over samples); clipping and AdamW then see the same
gradients on every rank, so the ranks take the same step, the one-device
step on the whole batch.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from trx2dy_torch.device import pin_float32
from trx2dy_torch.models.predictor2d import draw_dropout
from trx2dy_torch.parallel.mesh import (
    all_reduce_, axis, replicated, shard, shard_batch, shard_msa,
)
from trx2dy_torch.utils.profiling import span

HEAD_BINS = {"dist": 37, "omega": 25, "theta": 25, "phi": 13}


class TrainState(NamedTuple):
    model: torch.nn.Module          # a DistPredictor; JAX's params
    opt_state: torch.optim.AdamW
    step: int


def geometry_loss(model, f2d: torch.Tensor, msa: torch.Tensor,
                  labels: Dict[str, torch.Tensor],
                  mask: Optional[torch.Tensor] = None,
                  depth: Optional[int] = None, dropout=None,
                  remat: bool = False, mp=None) -> torch.Tensor:
    """Masked mean cross-entropy over the four heads for ONE sample.

    labels: dict of (L, L) int bin indices; mask: (L, L) bool of valid
    pairs. dropout: one BlockDropout per block (predictor2d.draw_dropout)
    or None; remat rematerialises each trunk block; mp: the process group
    over which msa's rows are split (msa then holds this rank's rows)."""
    logits = model(f2d, msa, depth=depth, use_flash=False, dropout=dropout,
                   remat=remat, mp=mp)
    if mask is None:
        mask = torch.ones(f2d.shape[:2], dtype=torch.bool,
                          device=f2d.device)
    count = mask.sum().clamp(min=1)
    total = torch.zeros((), device=f2d.device)
    for k in HEAD_BINS:
        logp = F.log_softmax(logits[k], dim=-1)
        nll = -logp.gather(-1, labels[k][..., None].long())[..., 0]
        total = total + torch.where(mask, nll, 0.0).sum() / count
    return total


def batched_loss(model, f2d, msa, labels, mask, depth: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False, mesh=None) -> torch.Tensor:
    """Mean loss over the leading batch axis. The trunk is unbatched, so
    the samples run in turn; with a generator, each draws its masks from
    it in sample order. With a mesh the inputs are the global batch: this
    rank runs its dp slice of the samples on its mp slice of the rows and
    returns the mean over its samples; masks are drawn for every sample
    of the global batch and every row, and the rank keeps its own."""
    blocks = len(model.net.net.blocks[:depth])
    dim = model.net.token_emb.embedding_dim
    mp, _, _ = axis(mesh, "mp")
    # this rank's samples -> their rows
    local = dict(zip(shard_batch(torch.arange(f2d.shape[0]), mesh).tolist(),
                     shard_msa(msa, mesh)))
    per = []
    for b in range(f2d.shape[0]):
        drop = None
        if generator is not None:
            drop = draw_dropout(generator, blocks, f2d.shape[1],
                                msa.shape[1], dim)
        if b not in local:
            continue
        if drop is not None and mesh is not None:
            drop = [blk[:4] + (shard(blk[4], mesh, "mp"),) for blk in drop]
        per.append(geometry_loss(
            model, f2d[b], local[b],
            {k: v[b] for k, v in labels.items()}, mask[b], depth=depth,
            dropout=drop, remat=remat, mp=mp))
    return torch.stack(per).mean()


def value_and_grad(model, f2d, msa, labels, mask,
                   depth: Optional[int] = None,
                   generator: Optional[torch.Generator] = None,
                   remat: bool = False, mesh=None) -> torch.Tensor:
    """batched_loss, detached, with its gradients accumulated into the
    parameters' .grad; with a mesh, the global batch's loss and gradients
    on every rank (reduce_gradients, and the loss averaged over dp)."""
    with span("forward"):
        loss = batched_loss(model, f2d, msa, labels, mask, depth=depth,
                            generator=generator, remat=remat, mesh=mesh)
    with span("backward"):
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            reduce_gradients(model, mesh)
            # the mp ranks of a dp index hold the same loss: the mean over
            # every rank is the mean over dp, the same bits on every rank
            all_reduce_([loss], None, scale=1.0 / dist.get_world_size())
    return loss


def reduce_gradients(model, mesh) -> None:
    """The sharded step's gradients made the one-device step's: every
    parameter the loss does not read gets a zero gradient, the row
    parameters' (Predictor2D.row_parameters) are summed over mp and the
    pair path's, whole on every mp rank, averaged over mp (on a GPU the
    ranks' copies differ in their last bits, from kernels that sum with
    atomics, and the ranks must take bit-identical steps), then all are
    averaged over dp; in place."""
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    rows = {id(p) for p in model.net.row_parameters()}
    mp, n_mp, _ = axis(mesh, "mp")
    dp, n_dp, _ = axis(mesh, "dp")
    if n_mp > 1:
        for p in params:
            if id(p) not in rows:
                p.grad.div_(n_mp)
        all_reduce_([p.grad for p in params], mp)
    if n_dp > 1:
        all_reduce_([p.grad for p in params], dp, scale=1.0 / n_dp)


class _OptimizerStats:
    """Optimizer.update's work since the last reset(): the updates taken,
    the gradients their multi-tensor calls covered (every parameter's, each
    update), and those of them the update allocated as zeros because the
    loss did not read their parameter."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.updates = 0
        self.tensors = 0
        self.zero_filled = 0


OPTIMIZER_STATS = _OptimizerStats()


class Optimizer(NamedTuple):
    """optax.chain(clip_by_global_norm(clip), adamw(lr, weight_decay)):
    b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected,
    decay decoupled and applied to every parameter (one param group of a
    fused torch.optim.AdamW: its step counts live on the device)."""
    lr: float = 1e-3
    weight_decay: float = 1e-4
    clip: float = 1.0

    def init(self, params) -> torch.optim.AdamW:
        return torch.optim.AdamW(list(params), lr=self.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=self.weight_decay,
                                 fused=True)

    def update(self, opt_state: torch.optim.AdamW) -> None:
        """Clip the parameters' gradients and take one AdamW step, in a
        fixed number of multi-tensor calls over all of them (the norms, the
        scale, the fused AdamW) and with no sync with the host. A parameter
        the loss does not read gets a zero gradient, so that it decays as
        optax decays it (AdamW skips a None gradient)."""
        (group,) = opt_state.param_groups
        params = group["params"]
        grads = [p.grad for p in params]
        for i, g in enumerate(grads):
            if g is None:
                grads[i] = params[i].grad = torch.zeros_like(params[i])
                OPTIMIZER_STATS.zero_filled += 1
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        # optax scales by clip / norm only where the norm reaches the clip
        scale = torch.where(norm < self.clip, 1.0, self.clip / norm)
        torch._foreach_mul_(grads, scale)
        opt_state.step()
        OPTIMIZER_STATS.updates += 1
        OPTIMIZER_STATS.tensors += len(grads)


def make_optimizer(lr: float = 1e-3, weight_decay: float = 1e-4,
                   clip: float = 1.0) -> Optimizer:
    return Optimizer(lr, weight_decay, clip)


def init_train_state(model, optimizer: Optimizer) -> TrainState:
    return TrainState(model=model,
                      opt_state=optimizer.init(model.parameters()), step=0)


def step_seed(dropout_seed: int, step: int) -> int:
    """A step's dropout seed from (dropout_seed, step)."""
    seq = np.random.SeedSequence([dropout_seed, step])
    return int(seq.generate_state(1)[0])


def make_train_step(optimizer: Optimizer, mesh=None,
                    depth: Optional[int] = None, dropout: bool = False,
                    remat: bool = False, dropout_seed: int = 0):
    """The train step: step(state, f2d (B, L, L, in_dim), msa (B, R, L),
    labels {head: (B, L, L)}, mask (B, L, L)) -> (state, loss), the loss
    detached and the model and AdamW updated in place.

    dropout=True enables the reference's structured training dropout, its
    generator seeded per step from (dropout_seed, state.step) on the
    inputs' device; remat=True rematerialises each trunk block. mesh: a
    (dp, mp) DeviceMesh (parallel/mesh.py); every rank passes the global
    batch and gets the global loss (see the module's docstring). The
    first step checks that the ranks hold the same parameters. Building
    the step switches TF32 off (pin_float32), whatever device it runs
    on."""
    pin_float32()

    def step_fn(state: TrainState, f2d, msa, labels, mask):
        with span("train_step"):
            if mesh is not None and state.step == 0:
                replicated(list(state.model.parameters()))
            generator = None
            if dropout:
                generator = torch.Generator(device=f2d.device).manual_seed(
                    step_seed(dropout_seed, state.step))
            state.opt_state.zero_grad(set_to_none=True)
            loss = value_and_grad(state.model, f2d, msa, labels, mask,
                                  depth=depth, generator=generator,
                                  remat=remat, mesh=mesh)
            with span("optimizer"):
                optimizer.update(state.opt_state)
            return state._replace(step=state.step + 1), loss

    return step_fn
