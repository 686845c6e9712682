# -*- coding: utf-8 -*-
"""Segmentation U-Net, NHWC (port of ``smsut_tpu/models/unet.py`` ``UNet``
with ``pack_levels=0``, instance norm, leaky ReLU).

Logits are returned in float32 so that losses and argmax stay
full-precision under bfloat16 compute.

``remat`` rematerialises the encoder and the decoder in the backward, as
the JAX package's ``nn.remat(Encoder)`` and ``nn.remat(Decoder)`` do: each
runs under its own checkpoint (:func:`rematerialised`), which keeps only
its inputs and runs it again in the backward (the fused blocks' K3
included, and under a space group their halos and sums, in the forward's
order).  The same function on another schedule: less activation memory
for one more forward of the towers.  Only under grad; serving does not
change.
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from smsut_tpu_torch.device import resolve_device
from smsut_tpu_torch.models.blocks import Decoder, Encoder


def rematerialised(mod: nn.Module, *args,
                   params: Optional[Mapping[str, torch.Tensor]] = None):
    """``mod(*args)`` under ``torch.utils.checkpoint``, non-reentrant and
    keeping no RNG state (the port's forwards draw nothing: their draws
    are inputs; and a CUDA graph's capture may not read the RNG state).
    ``mod``'s parameters (``params``, or those it holds now: the leaves of
    an enclosing ``torch.func.functional_call``) are inputs of the
    checkpointed function, so that the backward's second forward runs on
    the same tensors after ``functional_call`` has put the module's own
    back."""
    p = dict(mod.named_parameters()) if params is None else dict(params)
    return checkpoint(lambda p, *a: torch.func.functional_call(mod, p, a),
                      p, *args, use_reentrant=False,
                      preserve_rng_state=False)


class UNet(nn.Module):
    """``UNet(out_ch, width)``: the trainers build ``UNet(5, 16)``.

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    (so a seed gives the same weights on every device), then moved to
    ``device``: the card unless ``device`` names another (no CUDA and no
    device raises).  ``block_fused`` runs each BasicBlock through kernel
    K3 on the card; ``remat`` rematerialises the encoder and the decoder
    under grad (module docstring)."""

    def __init__(self, out_ch: int, width: int = 16, in_ch: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 block_fused: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0, remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.remat = remat
        g = torch.Generator().manual_seed(seed)
        self.encoder = Encoder(width, in_ch, block_fused, g)
        self.decoder = Decoder(out_ch, width, block_fused, g)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        if self.remat and torch.is_grad_enabled():
            h, skips = rematerialised(self.encoder, x)
            return rematerialised(self.decoder, h, skips).float()
        h, skips = self.encoder(x)
        return self.decoder(h, skips).float()
