"""The (dp, mp) device mesh, the sharding functions and the collectives of
the port's sharded paths.

PyTorch counterpart of trx2dy/parallel/mesh.py. The axes are JAX's:

  dp: data parallel over training samples and fold decoys;
  mp: Predictor2D's MSA rows split over ranks. The column attention's keys,
      the tied-row attention's sum over rows and UpdateX's outer-product
      sum meet over mp (the collectives JAX's partitioner inserts).

The mesh is a torch.distributed DeviceMesh over the process group its
caller made (one process a rank, as torchrun starts them); in a
process with no group, make_mesh gives the (1, 1) mesh of a one-rank gloo
world. JAX's shardings (data_sharding, msa_sharding, replicated) become
functions that take the global tensor and return this rank's part;
`gather` is the way back. The only collectives are all_reduce, all_gather
and broadcast, which NCCL and gloo both take.

The three collectives autograd differentiates are Megatron's operators,
each a torch.autograd.Function whose backward its docstring states:
sum_over (the sum every rank consumes alike), copy_to (a tensor every
rank holds whole, feeding work on its own rows) and gather_rows (rows
gathered over the group). With group None each is the identity.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def mesh_shape(n: int, mp_size: Optional[int] = None) -> Tuple[int, int]:
    """(dp, mp) for n ranks: mp defaults to 2 when n is even and above 1,
    else 1 (JAX's rule); n not divisible by mp raises ValueError."""
    if mp_size is None:
        mp_size = 2 if (n % 2 == 0 and n > 1) else 1
    if n % mp_size:
        raise ValueError(f"{n} devices not divisible by mp={mp_size}")
    return n // mp_size, mp_size


def make_mesh(world_size: Optional[int] = None,
              axes: Tuple[str, str] = ("dp", "mp"),
              mp_size: Optional[int] = None,
              device_type: str = "cuda") -> DeviceMesh:
    """A 2D (dp, mp) DeviceMesh over every rank of the default process
    group, rank = dp_index * mp + mp_index (JAX's reshape of its device
    list). In a process with no process group it is the (1, 1) mesh of a
    one-rank gloo world made here. world_size, if given, must be the
    group's size."""
    if not dist.is_initialized():
        if world_size not in (None, 1):
            raise ValueError(f"a mesh of {world_size} ranks needs a process "
                             "group of that size; none is initialised")
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    if world_size not in (None, n):
        raise ValueError(f"a mesh of {world_size} ranks, but the process "
                         f"group has {n}")
    return init_device_mesh(device_type, mesh_shape(n, mp_size),
                            mesh_dim_names=tuple(axes))


def axis(mesh: Optional[DeviceMesh], name: str):
    """(process group, size, this rank's index) of a mesh axis; (None, 1,
    0) without a mesh."""
    if mesh is None:
        return None, 1, 0
    dim = mesh.mesh_dim_names.index(name)
    return mesh.get_group(name), mesh.size(dim), mesh.get_local_rank(name)


def shard(t: torch.Tensor, mesh: Optional[DeviceMesh], name: str,
          dim: int = 0) -> torch.Tensor:
    """This rank's slice of t along dim, split evenly over the mesh axis
    `name` in rank order; a size the axis does not divide raises
    ValueError."""
    _, n, r = axis(mesh, name)
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"{size} along dim {dim} not divisible by "
                         f"{name}={n}")
    return t.narrow(dim, r * (size // n), size // n)


def shard_batch(t: torch.Tensor, mesh: Optional[DeviceMesh],
                batch_axis: int = 0) -> torch.Tensor:
    """data_sharding: the batch axis over dp, the rest whole."""
    return shard(t, mesh, "dp", batch_axis)


def shard_msa(msa: torch.Tensor, mesh: Optional[DeviceMesh]) -> torch.Tensor:
    """msa_sharding: (B, R, L) tokens, the batch over dp, rows over mp."""
    return shard(shard_batch(msa, mesh), mesh, "mp", 1)


def replicated(tensors: Sequence[torch.Tensor],
               group=None) -> Sequence[torch.Tensor]:
    """The tensors, which every rank of the group holds whole. A broadcast
    of rank 0's copy checks that the ranks agree, bit for bit: a rank
    whose copy differs raises ValueError."""
    if group is None and not dist.is_initialized():
        return tensors
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=dist.get_global_rank(group, 0)
                   if group is not None else 0, group=group)
    if not torch.equal(ref, flat):
        raise ValueError(f"rank {dist.get_rank()} holds other values than "
                         "rank 0 of its group")
    return tensors


def gather(t: torch.Tensor, mesh: Optional[DeviceMesh], name: str,
           dim: int = 0) -> torch.Tensor:
    """The ranks' slices along dim over the mesh axis `name`, concatenated
    in rank order (the inverse of shard); no gradient."""
    group, n, _ = axis(mesh, name)
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _contiguous_clone(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


class _SumOver(torch.autograd.Function):
    """Forward: the sum of x over the group's ranks (all_reduce). Backward:
    the identity. Every rank consumes the sum alike, so the gradient each
    holds is already the whole gradient of the sum, and so of its own
    summand."""

    @staticmethod
    def forward(ctx, x, group):
        y = _contiguous_clone(x)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """Forward: the identity, for a tensor every rank holds whole that
    feeds work on this rank's rows. Backward: the gradient summed over the
    group (all_reduce), since each rank's holds only its rows' share."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = _contiguous_clone(g)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    """Forward: the ranks' x concatenated along dim in rank order
    (all_gather). Backward: the gradient summed over the group
    (all_reduce), of which this rank keeps its own slice: every rank's
    output reads every rank's rows."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(group_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = _contiguous_clone(g)
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """_SumOver over `group`; x itself with group None."""
    return x if group is None else _SumOver.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """_CopyTo over `group`; x itself with group None."""
    return x if group is None else _CopyTo.apply(x, group)


def gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """_GatherRows over `group` along dim; x itself with group None."""
    return x if group is None else _GatherRows.apply(x, group, dim)


def all_reduce_(tensors: Sequence[torch.Tensor], group,
                scale: float = 1.0) -> None:
    """Sum the tensors over the group in place, through one flat buffer,
    then multiply by scale."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if scale != 1.0:
        flat.mul_(scale)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))
