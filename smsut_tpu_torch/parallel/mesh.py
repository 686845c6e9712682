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

The space axis (``spatial_parallel = sp > 1``, the JAX package's
``('data', 'space')`` mesh, where GSPMD splits every activation's H over
``'space'``): :func:`check_config` lays the group out as ``dp x sp``
(:func:`set_spatial`: rank ``r`` has data coordinate ``r // sp`` and
space coordinate ``r % sp``; the ranks of one data coordinate form a space
group), and each rank then holds rows ``[s*H/sp, (s+1)*H/sp)`` of every
map of its data coordinate's images.  The layers meet their neighbours
through:

- :func:`halo_rows`: ``k // 2`` rows from each neighbour (zeros at the
  image's top and bottom), differentiable twice (the gradient penalty);
  the convs run SAME on the haloed rows and keep the middle ones;
  :func:`inner_halo_rows` takes only the neighbours' rows that exist
  (the fused blocks' conv2 and dw2, which normalise what they read);
- :func:`space_sum`: a differentiable sum over the space group, for the
  per-sample sums over H*W (the instance norm's statistics, the per-image
  Dice, the GP's gradient norm, the discriminator's class head) and
  :func:`space_all_reduce_`, its in-place form for the kernels' sums;
- :func:`space_gather`: the group's rows of a tensor concatenated in
  space order (the SegFormer's keys and values, which every rank's
  queries attend to over the whole image; the eval sweep's logits and
  CoraNet's pseudo-labels, whole again); its backward is its adjoint, a
  reduce-scatter (the cotangent summed over the space group, then the
  rank's rows), and the reduce-scatter's the gather, so both are twice
  differentiable.

Every collective's backward is its adjoint (the all-reduce's an
all-reduce, the halo's the halo's rows sent back and added), so each
rank's gradient is the gradient of the sum of every rank's loss, and the
gradient all-reduce's average over the ``dp x sp`` ranks is the one
process's gradient where the loss terms are means of equal shards or
sums over the group (:func:`batch_sums`).

The model axis (the JAX package's ``('data', 'model')`` mesh of
``make_mesh_2d``/``shard_params_channelwise``, where GSPMD shards every
eligible kernel on its output channels): :func:`make_mesh_2d` lays the
group out as ``dp x tp`` (rank ``r`` has data coordinate ``r // tp`` and
model coordinate ``r % tp``; the ranks of one data coordinate form a
model group, those of one model coordinate a data group), and
:func:`shard_params_channelwise` keeps each rank's shard
``[..., m*C/tp:(m+1)*C/tp]`` of every tensor the JAX rule shards
(:func:`channel_sharded`: two dims or more, the last ``C`` a multiple of
``tp`` and ``C/tp >= 4``), in the parameter and the optimizer trees
alike (the zoo's EMA teacher and second net too); the rest is
replicated.  The layers compute a sharded weight's
output channels on their rank and gather them right after
(:func:`gather_channels`), so activations stay whole on every rank of a
model group, which holds the same batch rows, and every norm runs on
whole maps with its replicated scale.  The gather's backward is its
adjoint, a reduce-scatter (the cotangent summed over the model group,
then the rank's slice: gloo has no reduce-scatter, so an all-reduce and a
slice), and the reduce-scatter's the gather, so both are twice
differentiable (the gradient penalty); :func:`model_mean` averages a
gradient taken in a replicated input (the GP's) over the model group.  A
rank's gradient is then that of the sum of every rank's loss, as on the
space axis: a sharded parameter's is summed over its data group and a
replicated one's, partial where its cotangent came through a sharded
layer, over the whole group (:func:`reduce_gradients_`, one flat buffer
each), both divided by the group's size.  The batch sums run over the
data group (:func:`batch_sums`).  ``tp > 1`` with a space axis raises, as
the JAX package's guard does (GSPMD mis-compiles feature- and
space-sharded convolutions there; the guard stays for parity).

Without a group each of these is the identity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, FrozenSet, List, Mapping, Optional,
                    Sequence)

import torch
import torch.distributed as dist

from smsut_tpu_torch.parallel import distributed
from smsut_tpu_torch.parallel.distributed import process_count

Tensors = Dict[str, torch.Tensor]

# the widest halo of each of the U-Net's levels (0: the input's size; the
# 5x5 stems there), 1 below; and of the discriminator's (its 4x4 stride-2
# stem and its 3x3 convs)
_STEM_HALO = 2


def check_config(cfg, gan: bool = False,
                 maps: Optional[Callable[[int, int], None]] = None) -> int:
    """The group's world size, after checking ``cfg``'s parallel knobs
    against it: ``spatial_parallel`` ``sp`` dividing the world,
    ``data_parallel`` 0 (every data coordinate) or the world over ``sp``,
    and a ``batch_size`` the data axis divides; under ``sp > 1`` also the
    maps' rows (:func:`check_spatial`: the model's ``maps`` rule, or the
    U-Net's with the discriminator's pyramid where ``gan``).  Then lays
    the group out (:func:`set_spatial`)."""
    world = process_count()
    sp = cfg.spatial_parallel
    if sp < 1:
        raise ValueError(f"spatial_parallel={sp} is not a positive count")
    if world % sp:
        if world == 1:
            raise ValueError(
                f"spatial_parallel={sp} in a single process: launch a "
                f"multiple of {sp} processes (python -m torch.distributed"
                f".run --nproc_per_node {sp} -m smsut_tpu_torch.trainer...)")
        raise ValueError(f"spatial_parallel={sp} does not divide the group "
                         f"of {world} processes")
    dpw = world // sp
    dp = cfg.data_parallel
    if dp not in (0, dpw):
        if world == 1:
            raise ValueError(
                f"data_parallel={dp} in a single process: launch {dp} "
                f"processes (python -m torch.distributed.run "
                f"--nproc_per_node {dp} -m smsut_tpu_torch.trainer...)")
        raise ValueError(f"data_parallel={dp} does not match the group of "
                         f"{world} processes over spatial_parallel={sp} "
                         f"(0 or {dpw})")
    if cfg.batch_size % dpw:
        raise ValueError(f"batch_size {cfg.batch_size} is not divisible by "
                         f"the {dpw} data-parallel processes")
    if sp > 1 and cfg.pack_levels > 0:
        # the data axis takes packing as it is (packing is per image)
        raise ValueError(f"spatial_parallel={sp} with pack_levels="
                         f"{cfg.pack_levels}: the packed levels (hw or W) "
                         f"on the space axis are ROADMAP A13c (set "
                         f"pack_levels=0)")
    if sp > 1:
        check_spatial(cfg, sp, gan, maps)
    set_spatial(sp)
    return world


def check_spatial(cfg, sp: int, gan: bool = False,
                  maps: Optional[Callable[[int, int], None]] = None
                  ) -> None:
    """Refuse a configuration the space axis of ``sp`` cannot take, naming
    ``spatial_parallel``: the JAX Trainer's guard (``input_size // 16 >=
    max(4, sp)``), then the model's rule, ``maps(input_size, sp)``, which
    raises a ValueError naming ``spatial_parallel`` where a map does not
    split into the rows its layers need (the SegFormer's:
    ``models/segformer.py`` ``check_rows``); without one the U-Net's,
    :func:`check_maps` (the fused block kernels, ``block_pallas``, run
    split at their statistics there)."""
    size = cfg.input_size
    if size // 16 < max(4, sp):
        raise ValueError(f"spatial_parallel={sp} needs input_size >= "
                         f"{16 * max(4, sp)} (got {size})")
    if maps is not None:
        maps(size, sp)
        return
    check_maps(size, sp, gan)


def check_maps(size: int, sp: int, gan: bool = False) -> None:
    """Raise a ValueError naming ``spatial_parallel`` where a map of the
    U-Net (the UGAN towers, CoraNet's and DTC's U-Nets too) at input
    ``size`` does not split into whole rows of at least its halo per rank
    over ``sp`` ranks: its five levels, an even count of rows before a
    2x2 pool, at least the widest halo at each (the 5x5 stem's 2 at the
    input's size, 1 below); with ``gan`` also the discriminator's pyramid
    from its stem down to its ``input_size / 2^(log2(input_size) - 2)``
    map."""
    if sp == 1:
        return
    # (map size, widest halo, whether a 2x2 pool or stride-2 conv follows)
    levels = [(size >> k, _STEM_HALO if k == 0 else 1, k < 4)
              for k in range(5)]
    if gan:
        n = int(math.log2(size)) - 2
        levels.append((size, 1, True))                  # the 4x4 stem
        levels += [(size >> k, 1, k < n) for k in range(1, n + 1)]
    for m, halo, halves in levels:
        rows, left = divmod(m, sp)
        if left or rows < halo or (halves and rows % 2):
            raise ValueError(
                f"spatial_parallel={sp}: the {m}x{m} map of input_size "
                f"{size} does not split into whole rows of at least {halo}"
                f"{', an even count,' if halves else ''} per rank")


# the space groups made for (default group, world, sp): dist.new_group is
# a collective that every rank calls for every group, in one order
_GROUPS: Dict[tuple, list] = {}


def set_spatial(sp: int) -> None:
    """Lay the group out as ``world / sp`` data coordinates by ``sp``
    space coordinates (row-major, as the JAX ``('data', 'space')`` mesh)
    and make this rank's space group; ``sp`` 1 takes the axis away.
    Every rank calls it with the same ``sp``."""
    if sp == 1 or not dist.is_initialized():
        distributed.set_space(1, None)
        return
    refuse_tp_sp(distributed.model_count(), sp)
    world = dist.get_world_size()
    groups = _new_groups(("space", sp), [
        list(range(d * sp, (d + 1) * sp)) for d in range(world // sp)])
    distributed.set_space(sp, groups[dist.get_rank() // sp])


def _new_groups(what: tuple, ranks: List[List[int]]) -> list:
    """One ``dist.new_group`` per list of ``ranks``, made once per (default
    group, world, ``what``)."""
    key = (id(dist.group.WORLD), dist.get_world_size()) + what
    groups = _GROUPS.get(key)
    if groups is None:
        groups = _GROUPS[key] = [dist.new_group(r) for r in ranks]
    return groups


def space_slice(n: int) -> slice:
    """This rank's rows ``[s*n/sp, (s+1)*n/sp)`` of ``n`` rows; all of
    them without a space axis."""
    h = n // distributed.space_count()
    return slice(distributed.space_index() * h,
                 (distributed.space_index() + 1) * h)


def space_rows(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's rows ``[s*H/sp, (s+1)*H/sp)`` of dim ``dim`` of a
    whole-image tensor; ``x`` without a space axis."""
    if distributed.space_count() == 1:
        return x
    sl = space_slice(x.shape[dim])
    return x.narrow(dim, sl.start, sl.stop - sl.start)


def space_all_reduce_(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the space group in place (not differentiable);
    ``x`` without one."""
    group = distributed.space_group()
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


class _SpaceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return space_all_reduce_(
            x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return _SpaceSum.apply(g)


def space_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the space group, differentiably (its backward is
    the same sum of the cotangent, itself differentiable); ``x`` without
    a space axis."""
    if distributed.space_group() is None:
        return x
    return _SpaceSum.apply(x)


def _space_parts(x: torch.Tensor) -> List[torch.Tensor]:
    """Every space rank's ``x`` (one shape on every rank), in space
    order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(distributed.space_count())]
    dist.all_gather(parts, x, group=distributed.space_group())
    return parts


class _RowGather(torch.autograd.Function):
    """[B, h, ...] -> [B, sp*h, ...]: the space group's rows (or tokens)
    of dim 1 in space order."""

    @staticmethod
    def forward(ctx, x):
        return torch.cat(_space_parts(x), dim=1)

    @staticmethod
    def backward(ctx, g):
        return _RowScatter.apply(g)


class _RowScatter(torch.autograd.Function):
    """The adjoint of :class:`_RowGather`: [B, sp*h, ...] summed over the
    space group, then the rank's [B, h, ...]."""

    @staticmethod
    def forward(ctx, g):
        s = space_all_reduce_(g.clone(memory_format=torch.contiguous_format))
        h = s.shape[1] // distributed.space_count()
        return s.narrow(1, distributed.space_index() * h, h).contiguous()

    @staticmethod
    def backward(ctx, gg):
        return _RowGather.apply(gg)


def space_gather(x: torch.Tensor) -> torch.Tensor:
    """The space group's parts of dim 1 of ``x`` (a rank's rows of a map,
    or the tokens of its rows), concatenated in space order on every rank
    of the group, twice differentiable (its backward is the cotangent
    summed over the group, then the rank's part); ``x`` without a space
    axis."""
    if distributed.space_group() is None:
        return x
    return _RowGather.apply(x)


def _exchange(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """(the ``hi`` part of the rank above, the ``lo`` part of the rank
    below), zeros at the image's top and bottom edges: one all-gather
    over the space group of the rank's two parts."""
    parts = _space_parts(torch.stack([lo, hi]))
    s, sp = distributed.space_index(), distributed.space_count()
    above = parts[s - 1][1] if s > 0 else torch.zeros_like(hi)
    below = parts[s + 1][0] if s < sp - 1 else torch.zeros_like(lo)
    return above, below


class _Halo(torch.autograd.Function):
    """[B, h, ...] -> [B, h + 2r, ...]: the rank's rows between the ``r``
    last rows of the rank above and the ``r`` first of the rank below."""

    @staticmethod
    def forward(ctx, x, r):
        ctx.r = r
        above, below = _exchange(x, x[:, :r], x[:, -r:])
        return torch.cat([above, x, below], dim=1)

    @staticmethod
    def backward(ctx, g):
        return _HaloT.apply(g, ctx.r), None


class _HaloT(torch.autograd.Function):
    """The adjoint of :class:`_Halo`: the middle rows of [B, h + 2r, ...],
    plus the rows the neighbours hold as their halos of this rank's rows
    (sent back and added)."""

    @staticmethod
    def forward(ctx, g, r):
        ctx.r = r
        h = g.shape[1] - 2 * r
        out = g[:, r:r + h].clone(memory_format=torch.contiguous_format)
        above, below = _exchange(g, g[:, :r], g[:, r + h:])
        out[:, :r] += above
        out[:, h - r:] += below
        return out

    @staticmethod
    def backward(ctx, gg):
        return _Halo.apply(gg, ctx.r), None


def inner_halo_offset(r: int) -> int:
    """The rows :func:`inner_halo_rows` puts before the rank's own: ``r``
    where a rank above exists, else 0."""
    return r if distributed.space_index() > 0 else 0


def inner_halo_rows(x: torch.Tensor, r: int):
    """(``x`` with ``r`` rows of the neighbours that exist and no rows
    beyond the image, the rows before ``x``'s first): the input of a conv
    that normalises and activates what it reads (the fused block's conv2
    and dw2), where a zero row beyond the image would become ``lrelu(h)``
    instead of the padding's 0; ``(x, 0)`` without a space axis.  Not
    differentiable."""
    if distributed.space_group() is None:
        return x, 0
    above, below = _exchange(x, x[:, :r], x[:, -r:])
    s, sp = distributed.space_index(), distributed.space_count()
    parts = ([above] if s > 0 else []) + [x] + ([below] if s < sp - 1
                                               else [])
    return torch.cat(parts, dim=1), inner_halo_offset(r)


def halo_rows(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC ``x``, a rank's rows of each image, with ``r`` rows of its
    neighbours' above and below (zeros beyond the image), twice
    differentiable; ``x`` padded with ``r`` zero rows without a space
    axis."""
    if distributed.space_group() is None:
        return torch.nn.functional.pad(x, (0, 0, 0, 0, r, r))
    if x.shape[1] < r:
        raise ValueError(f"a halo of {r} rows needs at least {r} rows a "
                         f"rank (got {x.shape[1]}): check spatial_parallel")
    return _Halo.apply(x, r)


# ------------------------------------------------------------ model axis

@dataclasses.dataclass(frozen=True)
class Mesh:
    """The group laid out as ``dp`` data by ``tp`` model coordinates (the
    JAX ``Mesh(devices.reshape(dp, tp), ('data', 'model'))``)."""
    dp: int
    tp: int

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.dp, "model": self.tp}


def refuse_tp_sp(tp: int, sp: int) -> None:
    """The JAX package's guard: no model axis with a space axis."""
    if tp > 1 and sp > 1:
        raise ValueError(
            "channel-wise tensor parallelism cannot be combined with "
            "spatial parallelism ('model' and 'space' mesh axes both > 1): "
            "the JAX package's guard against XLA GSPMD's mis-compiled "
            "feature+space-sharded convolutions, kept for parity.  Use "
            "dp x tp or dp x sp.")


def make_mesh_2d(dp: int, tp: int) -> Mesh:
    """Lay the group out as ``dp x tp`` (``make_mesh_2d`` of the JAX
    package, whose devices are taken in order and reshaped ``(dp, tp)``):
    rank ``r`` gets data coordinate ``r // tp`` and model coordinate ``r %
    tp``, with its model group and data group.  ``dp * tp`` must be the
    group's size (a process group has no spare ranks); ``tp`` 1 takes the
    model axis away.  Every rank calls it with the same sizes."""
    world = process_count()
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(f"make_mesh_2d(dp={dp}, tp={tp}): dp x tp must be "
                         f"the group's {world} processes (a process group "
                         f"has no spare ranks)")
    refuse_tp_sp(tp, distributed.space_size())
    if tp == 1:
        distributed.set_model(1, None, None)
        return Mesh(dp, tp)
    model = _new_groups(("model", tp), [
        list(range(d * tp, (d + 1) * tp)) for d in range(dp)])
    data = (_new_groups(("data", tp), [list(range(m, world, tp))
                                       for m in range(tp)])
            if dp > 1 else [None] * tp)
    rank = dist.get_rank()
    distributed.set_model(tp, model[rank // tp], data[rank % tp])
    return Mesh(dp, tp)


def channel_sharded(shape: Sequence[int], tp: int) -> bool:
    """The JAX rule (``smsut_tpu/parallel/mesh.py``
    ``shard_params_channelwise``) on a tensor of the whole ``shape``: at
    least two dims, the last (the output channels of a conv's HWIO kernel,
    a Dense kernel ``[in, out]``, a transposed conv's ``[Cin, 2, 2, Cout]``)
    a multiple of ``tp`` with at least 4 channels a shard."""
    return (tp > 1 and len(shape) >= 2 and shape[-1] % tp == 0
            and shape[-1] // tp >= 4)


def sharded_keys(shapes: Mapping[str, Sequence[int]], tp: int
                 ) -> FrozenSet[str]:
    """The keys of a tree of whole ``shapes`` that :func:`channel_sharded`
    shards over ``tp`` ranks."""
    return frozenset(k for k, s in shapes.items() if channel_sharded(s, tp))


def shard_tensor(x: torch.Tensor, tp: int, index: int) -> torch.Tensor:
    """Model coordinate ``index``'s shard of a whole tensor (a contiguous
    copy), or a copy of ``x`` where :func:`channel_sharded` keeps it
    whole."""
    if not channel_sharded(x.shape, tp):
        return x.clone()
    c = x.shape[-1] // tp
    return x.narrow(-1, index * c, c).contiguous()


def shard_params_channelwise(mesh: Mesh, tree):
    """This rank's output-channel shard of every tensor of ``tree`` that
    :func:`channel_sharded` shards over ``mesh``'s model axis, copies of
    the rest.  ``tree``: a tensor, a mapping of them (parameters, SGD's
    traces), a dataclass of them (``AdamState``: its count stays whole),
    or a train state, whose trees are sharded and whose shard keys are
    recorded.  The mesh must be the layout's (:func:`make_mesh_2d`); a
    model axis with a space axis raises, as the JAX package's does."""
    tp = mesh.shape["model"]
    refuse_tp_sp(tp, distributed.space_size())
    if tp != distributed.model_count():
        raise ValueError(f"a mesh of tp={tp} on a group laid out with a "
                         f"model axis of {distributed.model_count()}: call "
                         f"make_mesh_2d first")
    index = distributed.model_index()

    def put(t):
        if hasattr(t, "shard_channelwise"):
            return t.shard_channelwise(mesh)
        if isinstance(t, torch.Tensor):
            return shard_tensor(t, tp, index)
        if isinstance(t, Mapping):
            return {k: put(v) for k, v in t.items()}
        if dataclasses.is_dataclass(t):
            return dataclasses.replace(t, **{
                f.name: put(getattr(t, f.name))
                for f in dataclasses.fields(t)})
        return t

    return put(tree)


def shard_shape(shape: Sequence[int], tp: int) -> tuple:
    """The shape of a rank's shard of a tensor of the whole ``shape``."""
    if not channel_sharded(shape, tp):
        return tuple(shape)
    return (*shape[:-1], shape[-1] // tp)


def check_shards(what: str, shapes: Mapping[str, Sequence[int]],
                 tree: Mapping[str, torch.Tensor],
                 shards: Optional[FrozenSet[str]] = None) -> None:
    """Refuse a tree that does not match the model axis: ``tree`` must
    hold each tensor of the whole ``shapes`` as its shard
    (:func:`shard_shape`), and ``shards``, a state's record, name exactly
    the sharded keys.  Nothing to check without a model axis and shards."""
    tp = distributed.model_count()
    if tp == 1 and not shards:
        return
    bad = sorted(k for k, s in shapes.items()
                 if tuple(tree[k].shape) != shard_shape(s, tp))
    if bad or (shards is not None and shards != sharded_keys(shapes, tp)):
        raise ValueError(
            f"{what}: the tree's shards do not match the model axis of {tp} "
            f"({bad[:3] or 'the recorded shard keys'}): shard the whole "
            f"train state with shard_params_channelwise(make_mesh_2d(dp, "
            f"tp), state)")


def _model_parts(x: torch.Tensor) -> List[torch.Tensor]:
    """Every model rank's ``x`` (one shape on every rank), in model
    order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(distributed.model_count())]
    dist.all_gather(parts, x, group=distributed.model_group())
    return parts


class _ChannelGather(torch.autograd.Function):
    """[..., c] -> [..., tp*c]: the model ranks' shards in model order."""

    @staticmethod
    def forward(ctx, x):
        return torch.cat(_model_parts(x), dim=-1)

    @staticmethod
    def backward(ctx, g):
        return _ChannelScatter.apply(g)


class _ChannelScatter(torch.autograd.Function):
    """The adjoint of :class:`_ChannelGather`: [..., tp*c] summed over the
    model group, then the rank's [..., c]."""

    @staticmethod
    def forward(ctx, g):
        s = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(s, group=distributed.model_group())
        c = s.shape[-1] // distributed.model_count()
        return s.narrow(-1, distributed.model_index() * c, c).contiguous()

    @staticmethod
    def backward(ctx, gg):
        return _ChannelGather.apply(gg)


def gather_channels(y: torch.Tensor, full: int) -> torch.Tensor:
    """``y``, a rank's output-channel shard of a tensor of ``full``
    channels (the output of its shard of a sharded weight), whole on every
    model rank, twice differentiable; ``y`` where it is whole already."""
    if y.shape[-1] == full:
        return y
    return _ChannelGather.apply(y)


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=distributed.model_group())
        return y

    @staticmethod
    def backward(ctx, g):
        return _ModelSum.apply(g)


def model_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the model group, twice differentiable: a
    gradient taken in a replicated input (each model rank holds its part
    of the gradient of the sum of the ranks' outputs, ``tp`` times the
    output's), made the whole gradient on every rank; ``x`` without a
    model axis."""
    tp = distributed.model_count()
    if tp == 1:
        return x
    return _ModelSum.apply(x) / tp


@torch.no_grad()
def gather_tree(tree: Mapping[str, torch.Tensor],
                shards: FrozenSet[str]) -> Dict[str, torch.Tensor]:
    """``tree`` with each of its ``shards`` whole again (gathered over the
    model group, every rank of which must call it), the rest as it is."""
    parts = set(_split(tree, shards)[1])
    return {k: torch.cat(_model_parts(v), dim=-1) if k in parts else v
            for k, v in tree.items()}


def _flatten(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _views(flat: torch.Tensor, like: List[torch.Tensor]
           ) -> List[torch.Tensor]:
    sizes = [t.numel() for t in like]
    return [v.view(t.shape) for v, t in zip(flat.split(sizes), like)]


def _split(tree: Tensors, shards: FrozenSet[str]):
    """(the keys of ``tree`` held whole, those held as a rank's shards):
    ``shards`` under a model axis, none without one."""
    if distributed.model_count() == 1 or not shards:
        return list(tree), []
    return ([k for k in tree if k not in shards],
            [k for k in tree if k in shards])


@torch.no_grad()
def replicate_(tree: Tensors, shards: FrozenSet[str] = frozenset()
               ) -> Tensors:
    """``tree``'s tensors overwritten with rank 0's (one broadcast per
    dtype), and its ``shards`` (under a model axis) with those of the
    first rank of this rank's data group, which holds the same shard;
    returns ``tree``."""
    if not dist.is_initialized():
        return tree
    whole, parts = _split(tree, shards)
    data = distributed.data_group()
    for group, src, keys in ((None, 0, whole),
                             (data, distributed.model_index(),
                              parts if data is not None else [])):
        by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
        for k in keys:
            by_dtype.setdefault(tree[k].dtype, []).append(tree[k])
        for vals in by_dtype.values():
            flat = _flatten(vals)
            dist.broadcast(flat, src, group=group)
            torch._foreach_copy_(vals, _views(flat, vals))
    return tree


@torch.no_grad()
def reduce_gradients_(grads: Tensors, shards: FrozenSet[str] = frozenset()
                      ) -> Tensors:
    """``grads`` averaged over the group: flattened in the tree's key
    order into one buffer, one all-reduce, divided by the world size; the
    tree's values become views of the buffer.  Under a model axis the
    gradients of ``shards``, a rank's shards, go into a second buffer
    summed over the data group alone (each model coordinate holds its own
    shard), divided by the world size too.  Returns ``grads``."""
    if not dist.is_initialized():
        return grads
    n = dist.get_world_size()
    whole, parts = _split(grads, shards)
    data = distributed.data_group()
    for reduce, group, keys in ((True, None, whole),
                                (data is not None, data, parts)):
        if not keys:
            continue
        vals = [grads[k] for k in keys]
        flat = _flatten(vals)
        if reduce:
            dist.all_reduce(flat, group=group)
        if n > 1:
            flat.div_(n)
        grads.update(zip(keys, _views(flat, vals)))
    return grads


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the group, differentiably: the backward sums the
    cotangent over the group too.  ``x`` itself without a group."""
    if not dist.is_initialized():
        return x
    return _GlobalSum.apply(x, None)


def batch_sums(*sums: torch.Tensor) -> List[torch.Tensor]:
    """Sums over a rank's rows of the batch, of one shape, made sums over
    the global batch with one :func:`global_sum` (over the data group
    under a model axis, whose model ranks hold the same rows: nothing to
    sum with one data coordinate); as they are without a group."""
    if not dist.is_initialized():
        return list(sums)
    if distributed.model_count() > 1:
        group = distributed.data_group()
        if group is None:
            return list(sums)
        return list(_GlobalSum.apply(torch.stack(sums), group).unbind(0))
    return list(global_sum(torch.stack(sums)).unbind(0))


@torch.no_grad()
def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every data coordinate's ``x`` (one shape on every rank)
    concatenated along dim 0 in order: every rank's in rank order without
    a space or model axis; under one, the ranks of space (model)
    coordinate 0 (a space group's or a model group's ranks hold the same
    rows of the batch).  ``x`` without a group or in a group of one."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts[::distributed.space_size()
                           * distributed.model_count()])


@torch.no_grad()
def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the group (the logged metrics); ``x`` without a
    group."""
    if not dist.is_initialized():
        return x
    return global_sum(x) / dist.get_world_size()
