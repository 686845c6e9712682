# -*- coding: utf-8 -*-
"""Checkpoints under the reference's tags (``best``, ``last``, ...).

Port of ``smsut_tpu/train/checkpoints.py``: each tag holds the full train
state -- step, parameters and momentum traces -- so that a run can resume.
Where the JAX package writes an orbax directory, the port writes one
``torch.save`` file, ``{ckpt_root}/{prefix}.ckpt``, of
``{"step", "params", "opt_state"}`` with float32 CPU tensors.
"""
from __future__ import annotations

import dataclasses
import os
from os.path import join as pjoin
from typing import Any, Dict

import torch

from smsut_tpu_torch.train.state import TrainState


def _path(ckpt_root: str, prefix: str) -> str:
    return os.path.abspath(pjoin(ckpt_root, f"{prefix}.ckpt"))


def _host(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", torch.float32, copy=True)
            for k, v in tree.items()}


def save_state(state: TrainState, ckpt_root: str, prefix: str) -> str:
    path = _path(ckpt_root, prefix)
    torch.save({"step": int(state.step), "params": _host(state.params),
                "opt_state": _host(state.opt_state)}, path)
    return path


def load_raw(ckpt_root: str, prefix: str) -> Dict[str, Any]:
    """A checkpoint as saved: ``{"step", "params", "opt_state"}`` on the
    CPU."""
    return torch.load(_path(ckpt_root, prefix), map_location="cpu",
                      weights_only=True)


def load_state(template: TrainState, ckpt_root: str, prefix: str
               ) -> TrainState:
    """Restore into ``template``'s structure: each tensor takes the
    template's device and dtype; a missing or extra key raises."""
    raw = load_raw(ckpt_root, prefix)

    def like(tree: Dict[str, torch.Tensor], saved: Dict[str, torch.Tensor],
             what: str) -> Dict[str, torch.Tensor]:
        if saved.keys() != tree.keys():
            raise KeyError(f"{what}: checkpoint keys differ from the state's "
                           f"({sorted(set(saved) ^ set(tree))})")
        out = {}
        for k, t in tree.items():
            if tuple(saved[k].shape) != tuple(t.shape):
                raise ValueError(f"{what}/{k}: shape {tuple(saved[k].shape)} "
                                 f"!= {tuple(t.shape)}")
            out[k] = saved[k].to(t.device, t.dtype).contiguous()
        return out

    return dataclasses.replace(
        template, step=int(raw["step"]),
        params=like(template.params, raw["params"], "params"),
        opt_state=like(template.opt_state, raw["opt_state"], "opt_state"))
