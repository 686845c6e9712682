# -*- coding: utf-8 -*-
"""Segmentation U-Net, NHWC (port of ``smsut_tpu/models/unet.py`` ``UNet``
with ``pack_levels=0``, instance norm, leaky ReLU).

Logits are returned in float32 so that losses and argmax stay
full-precision under bfloat16 compute.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from smsut_tpu_torch.device import resolve_device
from smsut_tpu_torch.models.blocks import Decoder, Encoder


class UNet(nn.Module):
    """``UNet(out_ch, width)``: the trainers build ``UNet(5, 16)``.

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    (so a seed gives the same weights on every device), then moved to
    ``device``: the card unless ``device`` names another (no CUDA and no
    device raises).  ``block_fused`` runs each BasicBlock through kernel
    K3 on the card."""

    def __init__(self, out_ch: int, width: int = 16, in_ch: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 block_fused: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        g = torch.Generator().manual_seed(seed)
        self.encoder = Encoder(width, in_ch, block_fused, g)
        self.decoder = Decoder(out_ch, width, block_fused, g)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, skips = self.encoder(x.to(self.compute_dtype))
        return self.decoder(h, skips).float()
