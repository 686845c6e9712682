# -*- coding: utf-8 -*-
"""Carry U-Net weights between the flax parameter tree of the JAX package
and the port's ``state_dict``.

Paths match one for one (``encoder/layer1/conv1/kernel`` <->
``encoder.layer1.conv1.weight``).  Conv kernels are HWIO on both sides;
norms map ``scale``/``bias`` to ``weight``/``bias``.  The one reshaping is
the transposed conv: flax's ``ConvTranspose`` (``transpose_kernel=False``)
convolves the stride-dilated input with its kernel, so output subpixel
(dy, dx) takes the tap ``kernel[1-dy, 1-dx]``; the port stores those taps
as ``weight[ci, dy, dx, co]``.  Both directions only flip and transpose,
so a round trip is exact.

The tree is a nested mapping of numpy arrays (``jax.device_get`` of the
flax params); nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn

_CONVT = "up"   # UpSampleAndConcat's ConvTranspose child, in both trees


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def unet_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree -> the port's ``state_dict`` (float32, CPU)."""
    out = {}
    for path, leaf in _leaves(tree):
        *mods, name = path
        a = np.array(leaf, np.float32)   # a writable copy
        if name == "kernel" and mods[-1] == _CONVT:
            a = a[::-1, ::-1].transpose(2, 0, 1, 3)
        tname = "weight" if name in ("kernel", "scale") else name
        out[".".join(mods + [tname])] = torch.from_numpy(
            np.ascontiguousarray(a))
    return out


def unet_to_flax(state: Union[nn.Module, Mapping[str, torch.Tensor]]
                 ) -> Dict[str, Any]:
    """The port's module or ``state_dict`` -> a flax ``params`` tree of
    numpy float32 arrays."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    tree: Dict[str, Any] = {}
    for key, t in state.items():
        *mods, name = key.split(".")
        a = t.detach().cpu().float().numpy()
        if name == "weight" and mods[-1] == _CONVT:
            a, name = a.transpose(1, 2, 0, 3)[::-1, ::-1], "kernel"
        elif name == "weight":
            name = "kernel" if a.ndim == 4 else "scale"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return tree
