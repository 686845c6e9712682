# -*- coding: utf-8 -*-
"""Checkpoints under the reference's tags (``best``, ``last``, ...).

Port of ``smsut_tpu/train/checkpoints.py``: each tag holds the full train
state -- step, parameters and optimizer state -- so that a run can resume.
Where the JAX package writes an orbax directory, the port writes one
``torch.save`` file, ``{ckpt_root}/{prefix}.ckpt``, with float32 CPU
tensors: ``{"step", "params", "opt_state"}`` for a ``TrainState`` under
SGD, ``{"step", "params", "opt_mu", "opt_nu", "opt_count"}`` under Adam
(M3L: the moments and the update count), with ``ema_params`` (Mean
Teacher, CoraNet, M3L) and ``params2``/``opt_state2`` (cross-pseudo
supervision) where the state holds them, and
``{"step", "g_params", "g_opt_state", "d_params", "d_opt_mu",
"d_opt_nu", "d_opt_count"}`` for a ``GANTrainState`` (SGD traces of G,
Adam moments and update count of D).  A restored state's device step
counter is set from the saved ``step``.

Under a process group every rank holds the same state: rank 0 writes the
file and the other ranks wait for it at a barrier, writing nothing.  The
file holds the whole state whatever the group's size, so a checkpoint
written by N ranks loads into one process and the other way round.  Under
a model axis (``parallel/mesh.py`` ``make_mesh_2d``) each sharded tensor
of the state (its ``shards``, ``g_shards``, ``d_shards``) is gathered
whole over the model group before rank 0 writes, so the file is the one
a process without a mesh writes; :func:`load_state` keeps the rank's
shard of each tensor the template holds sharded, at any ``dp x tp``.
"""
from __future__ import annotations

import dataclasses
import os
from os.path import join as pjoin
from typing import Any, Dict, FrozenSet, Optional, Union

import torch

from smsut_tpu_torch.parallel import distributed, mesh
from smsut_tpu_torch.train.state import AdamState, GANTrainState, TrainState


def _path(ckpt_root: str, prefix: str) -> str:
    return os.path.abspath(pjoin(ckpt_root, f"{prefix}.ckpt"))


def _host(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", torch.float32, copy=True)
            for k, v in tree.items()}


def _shards(state, name: str) -> FrozenSet[str]:
    """The keys of the checkpoint tree ``name`` that ``state`` holds as
    this rank's shards."""
    if isinstance(state, GANTrainState):
        return state.g_shards if name.startswith("g_") else state.d_shards
    return state.shards


def _trees(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """The state's tensor trees by their checkpoint names."""
    if isinstance(state, GANTrainState):
        return {"g_params": state.g_params, "g_opt_state": state.g_opt_state,
                "d_params": state.d_params,
                "d_opt_mu": state.d_opt_state.mu,
                "d_opt_nu": state.d_opt_state.nu}
    trees = {"params": state.params}
    if isinstance(state.opt_state, AdamState):
        trees.update(opt_mu=state.opt_state.mu, opt_nu=state.opt_state.nu)
    else:
        trees["opt_state"] = state.opt_state
    for name in ("ema_params", "params2", "opt_state2"):
        if getattr(state, name) is not None:
            trees[name] = getattr(state, name)
    return trees


def save_state(state: Union[TrainState, GANTrainState], ckpt_root: str,
               prefix: str) -> Optional[str]:
    """``state`` to ``{ckpt_root}/{prefix}.ckpt`` by rank 0; every rank
    returns when the file is written.  The path on rank 0, None on the
    others."""
    path = None
    # every rank takes part in the gathers of the sharded tensors
    trees = {k: mesh.gather_tree(v, _shards(state, k))
             for k, v in _trees(state).items()}
    if distributed.is_primary():
        path = _path(ckpt_root, prefix)
        raw = {"step": int(state.step),
               **{k: _host(v) for k, v in trees.items()}}
        if isinstance(state, GANTrainState):
            raw["d_opt_count"] = int(state.d_opt_state.count)
        elif isinstance(state.opt_state, AdamState):
            raw["opt_count"] = int(state.opt_state.count)
        torch.save(raw, path)
    distributed.barrier()
    return path


def load_raw(ckpt_root: str, prefix: str) -> Dict[str, Any]:
    """A checkpoint as saved, on the CPU."""
    return torch.load(_path(ckpt_root, prefix), map_location="cpu",
                      weights_only=True)


def load_state(template: Union[TrainState, GANTrainState], ckpt_root: str,
               prefix: str) -> Union[TrainState, GANTrainState]:
    """Restore into ``template``'s structure: each tensor takes the
    template's device and dtype, and the rank's shard where the template
    holds a shard (a template sharded over a model axis); a missing or
    extra key raises."""
    raw = load_raw(ckpt_root, prefix)
    tp, index = distributed.model_count(), distributed.model_index()

    def like(tree: Dict[str, torch.Tensor], what: str
             ) -> Dict[str, torch.Tensor]:
        saved = raw[what]
        if saved.keys() != tree.keys():
            raise KeyError(f"{what}: checkpoint keys differ from the state's "
                           f"({sorted(set(saved) ^ set(tree))})")
        shards = _shards(template, what)
        out = {}
        for k, t in tree.items():
            v = mesh.shard_tensor(saved[k], tp, index) if k in shards \
                else saved[k]
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{what}/{k}: shape {tuple(v.shape)} "
                                 f"!= {tuple(t.shape)}")
            out[k] = v.to(t.device, t.dtype).contiguous()
        return out

    trees = {k: like(v, k) for k, v in _trees(template).items()}
    step = int(raw["step"])
    count = lambda n: torch.full((), n, dtype=torch.int64,
                                 device=template.count.device)
    if isinstance(template, GANTrainState):
        return dataclasses.replace(
            template, step=step, g_params=trees["g_params"],
            g_opt_state=trees["g_opt_state"], d_params=trees["d_params"],
            d_opt_state=AdamState(count(int(raw["d_opt_count"])),
                                  trees["d_opt_mu"], trees["d_opt_nu"]),
            count=count(step))
    if isinstance(template.opt_state, AdamState):
        trees["opt_state"] = AdamState(count(int(raw["opt_count"])),
                                       trees.pop("opt_mu"),
                                       trees.pop("opt_nu"))
    return dataclasses.replace(template, step=step, count=count(step),
                               **trees)
