# -*- coding: utf-8 -*-
"""Carry weights between the flax parameter trees of the JAX package and
the port's ``state_dict``: the U-Net (CoraNet's 13-channel one too), the
UGAN generators (``UGAN``, ``UGANnce`` with its ``netF``), the
discriminator, the dual-task U-Net (``DTCUNet``) and M3L's SegFormer
(``LinearFusionMaskedConsistencyMixBatch``); and a JAX train state's
parameter trees at once
(:func:`state_trees_from_flax`: the parameters, Mean Teacher's and
CoraNet's ``ema_params``, cross-pseudo supervision's ``params2``).

Paths match one for one (``encoder/layer1/conv1/kernel`` <->
``encoder.layer1.conv1.weight``).  Conv kernels are HWIO on both sides
(the SegFormer's depthwise kernel (3, 3, 1, C), its spatial-reduction
conv (sr, sr, C, C)), Dense kernels [in, out]; norms (instance, batch and
LayerNorm) map ``scale``/``bias`` to ``weight``/``bias``; conv and Dense
biases keep their name, and so do the SegFormer's own leaves,
``backbone/mask_token``, ``fuse_scale`` and ``fuse_bias``.  The one
reshaping is the transposed conv: flax's ``ConvTranspose`` (``transpose_kernel=False``)
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

from smsut_tpu_torch.ops import acc

_CONVT = "up"   # UpSampleAndConcat's ConvTranspose child, in both trees


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``params`` tree -> the port's ``state_dict`` (float32, CPU)."""
    out = {}
    for path, leaf in _leaves(tree):
        *mods, name = path
        a = np.array(leaf, np.float32)   # a writable copy
        if name == "kernel" and mods[-1:] == [_CONVT]:
            a = a[::-1, ::-1].transpose(2, 0, 1, 3)
        tname = "weight" if name in ("kernel", "scale") else name
        out[".".join(mods + [tname])] = torch.from_numpy(
            np.ascontiguousarray(a))
    return out


def to_flax(state: Union[nn.Module, Mapping[str, torch.Tensor]]
            ) -> Dict[str, Any]:
    """The port's module or ``state_dict`` -> a flax ``params`` tree of
    numpy float32 arrays (float64 for float64 tensors)."""
    if isinstance(state, nn.Module):
        state = state.state_dict()
    tree: Dict[str, Any] = {}
    for key, t in state.items():
        *mods, name = key.split(".")
        a = acc(t.detach().cpu()).numpy().copy()  # no alias
        if name == "weight" and mods[-1:] == [_CONVT]:
            a, name = a.transpose(1, 2, 0, 3)[::-1, ::-1], "kernel"
        elif name == "weight":
            name = "kernel" if a.ndim >= 2 else "scale"
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return tree


# the parameter trees a JAX TrainState may hold, by field name
STATE_TREES = ("params", "ema_params", "params2")


def state_trees_from_flax(state: Any) -> Dict[str, Dict[str, torch.Tensor]]:
    """The parameter trees of a JAX ``TrainState`` (read as attributes of
    ``jax.device_get(state)`` or keys of a mapping) that are present, as
    the port's ``state_dict``s by field name: ``params`` always,
    ``ema_params`` and ``params2`` where the state holds them."""
    get = (state.get if isinstance(state, Mapping)
           else lambda k: getattr(state, k, None))
    return {k: from_flax(get(k)) for k in STATE_TREES if get(k) is not None}


# one mapping serves every model of the port: the U-Net takes the plain
# names, the GAN's generators and discriminator these
ugan_from_flax = disc_from_flax = from_flax
ugan_to_flax = disc_to_flax = to_flax
