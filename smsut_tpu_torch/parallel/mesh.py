# -*- coding: utf-8 -*-
"""The group's collectives in PyTorch's idiom: the counterpart of
``make_mesh``, ``replicate`` and ``shard_batch`` of
``smsut_tpu/parallel/mesh.py``.

The JAX package lays a ``('data',)`` mesh over the devices and lets XLA
insert the gradient all-reduce; GSPMD keeps the global-batch semantics.
Here each rank holds its rows of the global batch (the loaders shard them)
and the program says where the ranks meet:

- :func:`replicate_`: the parameters broadcast from rank 0 when a train
  state is made, so that every rank starts from the same weights;
- :func:`reduce_gradients_`: one all-reduce that averages a whole gradient
  tree before the optimizer, so that every rank updates identically;
- :func:`global_sum`: a differentiable all-reduce (its backward
  all-reduces the cotangent) for the losses that are not a plain mean of
  per-sample terms (the batch Dice's sums, masked and weighted means);
  with the gradients averaged, the gradient of a ratio of sums over the
  global batch is exact;
- :func:`all_gather_rows`: the eval sweep's per-rank results, gathered.

Without a group each of these is the identity.  Only the data axis is
ported: ``spatial_parallel > 1`` and the channel-wise tensor parallelism
of ``make_mesh_2d``/``shard_params_channelwise`` raise (ROADMAP A10c).
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

from smsut_tpu_torch.parallel.distributed import process_count

Tensors = Dict[str, torch.Tensor]


def check_config(cfg) -> int:
    """The group's world size, after checking ``cfg``'s parallel knobs
    against it: ``data_parallel`` 0 (every rank) or the world size,
    ``spatial_parallel`` 1, and a ``batch_size`` the world divides."""
    world = process_count()
    if cfg.spatial_parallel > 1:
        raise NotImplementedError(
            f"spatial_parallel={cfg.spatial_parallel}: the port shards the "
            f"batch only; the spatial axis is ROADMAP A10c")
    dp = cfg.data_parallel
    if dp not in (0, world):
        if world == 1:
            raise ValueError(
                f"data_parallel={dp} in a single process: launch {dp} "
                f"processes (python -m torch.distributed.run "
                f"--nproc_per_node {dp} -m smsut_tpu_torch.trainer...)")
        raise ValueError(f"data_parallel={dp} does not match the group of "
                         f"{world} processes (0 or {world})")
    if cfg.batch_size % world:
        raise ValueError(f"batch_size {cfg.batch_size} is not divisible by "
                         f"the {world} processes")
    return world


def make_mesh_2d(dp: int, tp: int):
    raise NotImplementedError("channel-wise tensor parallelism is not "
                              "ported: ROADMAP A10c")


def shard_params_channelwise(mesh, params):
    raise NotImplementedError("channel-wise tensor parallelism is not "
                              "ported: ROADMAP A10c")


def _flatten(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _views(flat: torch.Tensor, like: List[torch.Tensor]
           ) -> List[torch.Tensor]:
    sizes = [t.numel() for t in like]
    return [v.view(t.shape) for v, t in zip(flat.split(sizes), like)]


@torch.no_grad()
def replicate_(tree: Tensors) -> Tensors:
    """``tree``'s tensors overwritten with rank 0's (one broadcast per
    dtype); returns ``tree``."""
    if not dist.is_initialized():
        return tree
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for v in tree.values():
        by_dtype.setdefault(v.dtype, []).append(v)
    for vals in by_dtype.values():
        flat = _flatten(vals)
        dist.broadcast(flat, 0)
        torch._foreach_copy_(vals, _views(flat, vals))
    return tree


@torch.no_grad()
def reduce_gradients_(grads: Tensors) -> Tensors:
    """``grads`` averaged over the group: flattened in the tree's key
    order into one buffer, one all-reduce, divided by the world size; the
    tree's values become views of the buffer.  Returns ``grads``."""
    if not dist.is_initialized():
        return grads
    keys = list(grads)
    vals = [grads[k] for k in keys]
    flat = _flatten(vals)
    dist.all_reduce(flat)
    n = dist.get_world_size()
    if n > 1:
        flat.div_(n)
    grads.update(zip(keys, _views(flat, vals)))
    return grads


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the group, differentiably: the backward sums the
    cotangent over the group too.  ``x`` itself without a group."""
    if not dist.is_initialized():
        return x
    return _GlobalSum.apply(x)


def batch_sums(*sums: torch.Tensor) -> List[torch.Tensor]:
    """Sums over a rank's rows of the batch, of one shape, made sums over
    the global batch with one :func:`global_sum`; as they are without a
    group."""
    if not dist.is_initialized():
        return list(sums)
    return list(global_sum(torch.stack(sums)).unbind(0))


@torch.no_grad()
def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (one shape on every rank) concatenated along
    dim 0 in rank order; ``x`` without a group or in a group of one."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


@torch.no_grad()
def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the group (the logged metrics); ``x`` without a
    group."""
    if not dist.is_initialized():
        return x
    return global_sum(x) / dist.get_world_size()
