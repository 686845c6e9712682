# -*- coding: utf-8 -*-
"""The process group: port of ``smsut_tpu/parallel/distributed.py``.

``train/cli.py`` ``run_main`` calls :func:`initialize` once per process
before anything touches the card.  Every rank then runs the same program
on its contiguous rows of each global batch (``data/samplers.py``
``ShardedBatchSampler``), the gradients are averaged over the group
(``parallel/mesh.py``), and rank 0 writes the logs and checkpoints.

With ``spatial_parallel = sp > 1`` the group of ``dp x sp`` ranks is laid
out as the JAX package's ``('data', 'space')`` mesh, row-major: rank ``r``
has data coordinate ``r // sp`` and space coordinate ``r % sp``.  The
batch rows follow the data coordinate (:func:`local_batch_slice`), so the
``sp`` ranks of a space group hold the same images, each its own rows of
every map (``parallel/mesh.py`` :func:`~smsut_tpu_torch.parallel.mesh.set_spatial`).

With a model axis of ``tp > 1`` (``parallel/mesh.py`` ``make_mesh_2d``)
the group of ``dp x tp`` ranks is laid out as the JAX package's ``('data',
'model')`` mesh, the ``reshape(dp, tp)`` of the rank order: rank ``r`` has
data coordinate ``r // tp`` and model coordinate ``r % tp``.  The ``tp``
ranks of one data coordinate (a model group) hold the same batch rows and
each its output-channel shard of the sharded parameters; the ``dp`` ranks
of one model coordinate (a data group) hold the same shards.  The two
axes are never both above 1 (the JAX package's guard).

Launch N processes with ``python -m torch.distributed.run --nproc_per_node
N -m smsut_tpu_torch.trainer.unetTrainer ...`` (its ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``), or set the
JAX package's contract on each: ``SMSUT_COORDINATOR=host:port``,
``SMSUT_NUM_PROCESSES=N``, ``SMSUT_PROCESS_ID=i``.

The backend follows one rule: NCCL where the ranks run on CUDA and each
has a card of its own (no more ranks on the node than cards), gloo
otherwise (the CPU, or two ranks sharing one card, which NCCL refuses).
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

# a rank that does not arrive fails the others after this long
TIMEOUT_S = 300.0


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _coordinator() -> Optional[str]:
    addr = os.environ.get("SMSUT_COORDINATOR")
    if addr:
        return addr
    if os.environ.get("MASTER_ADDR"):
        return (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', '29500')}")
    return None


def _on_cuda(device: Optional[Union[str, torch.device]]) -> bool:
    """Whether the ranks run on CUDA: ``device`` None (the card, as the
    entry points default) or a CUDA device, on a host with a card."""
    return torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")


def backend_for(world: int, device: Optional[Union[str, torch.device]] = None
                ) -> str:
    """NCCL when the ranks run on CUDA and the node has a card for each of
    its ranks, else gloo."""
    local = _env_int("LOCAL_WORLD_SIZE") or world
    if _on_cuda(device) and local <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Optional[Union[str, torch.device]] = None,
               timeout_s: float = TIMEOUT_S) -> bool:
    """``torch.distributed.init_process_group`` from the arguments, else
    the ``SMSUT_*`` contract, else ``torch.distributed.run``'s variables.
    A no-op that returns False in a single process (no coordinator and at
    most one process); True once the group exists.  On CUDA the rank's
    default card becomes ``LOCAL_RANK % device_count``."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or _coordinator()
    if num_processes is None:
        num_processes = _env_int("SMSUT_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("SMSUT_PROCESS_ID", "RANK")
    if num_processes in (None, 1) and coordinator_address is None:
        return False
    if coordinator_address is None or process_id is None:
        raise ValueError(f"a group of {num_processes} processes needs a "
                         "coordinator address and this process's rank "
                         "(SMSUT_COORDINATOR and SMSUT_PROCESS_ID)")
    world = num_processes or 1
    backend = backend_for(world, device)
    if _on_cuda(device):
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device((process_id if local is None else local)
                              % torch.cuda.device_count())
    addr = coordinator_address
    dist.init_process_group(
        backend, init_method=addr if "://" in addr else f"tcp://{addr}",
        world_size=world, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


# the space axis: its size and this rank's space group (None at size 1),
# set by parallel/mesh.py ``set_spatial``; ``_SPACE_OFF`` turns it off
# for a forward that one rank runs alone on whole images
_SPACE = {"size": 1, "group": None}
_SPACE_OFF = [False]


# the model axis: its size, this rank's model group (the ranks of its data
# coordinate) and data group (the ranks of its model coordinate), set by
# parallel/mesh.py ``make_mesh_2d``; size 1 and no groups without one
_MODEL = {"size": 1, "group": None, "data_group": None}


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def set_space(size: int, group) -> None:
    """This rank's space axis: its size and its space group (None at size
    1); parallel/mesh.py ``set_spatial`` makes the groups."""
    _SPACE.update(size=size, group=group)


@contextlib.contextmanager
def no_space():
    """Within it, the layers run whole images in this rank alone (a
    forward that only one rank makes, such as the GAN's sample grid)."""
    prev, _SPACE_OFF[0] = _SPACE_OFF[0], True
    try:
        yield
    finally:
        _SPACE_OFF[0] = prev


def space_size() -> int:
    """The size of the space axis as the group is laid out (also where a
    forward turned it off)."""
    return _SPACE["size"]


def space_count() -> int:
    """The size of the space axis the layers see: 1 without one, or where
    it is off."""
    return 1 if _SPACE_OFF[0] else _SPACE["size"]


def space_index() -> int:
    """This rank's space coordinate (its rows of every map)."""
    return process_index() % _SPACE["size"] if space_count() > 1 else 0


def space_group():
    """This rank's space group, None where the space axis is 1 or off."""
    return _SPACE["group"] if space_count() > 1 else None


def set_model(size: int, group, data_group) -> None:
    """This rank's model axis: its size, its model group and its data
    group (both None at size 1); parallel/mesh.py ``make_mesh_2d`` makes
    the groups."""
    _MODEL.update(size=size, group=group, data_group=data_group)


def model_count() -> int:
    """The size of the model axis: 1 without one."""
    return _MODEL["size"]


def model_index() -> int:
    """This rank's model coordinate (its shard of every sharded
    parameter)."""
    return process_index() % _MODEL["size"]


def model_group():
    """The ranks of this rank's data coordinate, None without a model
    axis."""
    return _MODEL["group"]


def data_group():
    """The ranks of this rank's model coordinate (the same shards), None
    without a model axis."""
    return _MODEL["data_group"]


def data_count() -> int:
    """The size of the data axis: the ranks over the space and model
    axes' sizes."""
    return process_count() // (_SPACE["size"] * _MODEL["size"])


def data_index() -> int:
    """This rank's data coordinate (its rows of every global batch)."""
    return process_index() // (_SPACE["size"] * _MODEL["size"])


def is_primary() -> bool:
    """Rank 0 owns the logs, checkpoints and TensorBoard."""
    return process_index() == 0


def backend() -> Optional[str]:
    """The group's backend, None without a group."""
    return dist.get_backend() if dist.is_initialized() else None


def capturable() -> bool:
    """Whether a CUDA graph can hold the group's collectives: NCCL's can,
    gloo's cannot (they run on the host)."""
    return backend() in (None, "nccl")


def local_batch_slice(global_batch: int) -> slice:
    """This rank's contiguous rows ``[d*B/D, (d+1)*B/D)`` of a global
    batch of ``B`` rows, ``d`` its data coordinate of ``D`` (the rank and
    the group's size without a space or model axis)."""
    count = data_count()
    if global_batch % count:
        raise ValueError(
            f"global batch {global_batch} is not divisible by the {count} "
            f"data-parallel processes: rows would be silently dropped.  "
            f"Pick a batch_size that is a multiple of the process count.")
    per = global_batch // count
    start = data_index() * per
    return slice(start, start + per)


def barrier() -> None:
    """Every rank waits here for the others; nothing in a single process."""
    if not dist.is_initialized():
        return
    if backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()

