# -*- coding: utf-8 -*-
"""The dual-task U-Net, NHWC (port of ``smsut_tpu/models/dtc.py``
``DTCUNet``): the shared 5-level Encoder and one 4-level decoder with two
1x1 heads, ``fc1`` through tanh (a signed-distance regression) and ``fc2``
(plain segmentation logits), both returned in float32 (float64 for a
float64 model).

Its defaults are width 64, batch norm and ReLU (``models/layers.py``
``batch_norm``, plain PyTorch); with ``norm_type="instance"`` every norm
runs K1 forward and K4 backward, and with instance norm and leaky ReLU
``block_fused`` runs each BasicBlock as K3 forward and K6 backward.  Every
3x3 conv the kernels take runs K2 forward, K2 (dx) and K5 (dw) backward,
whatever the norm.  No trainer of the JAX package uses the network, so
the port has the model and no training CLI.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from smsut_tpu_torch.device import resolve_device
from smsut_tpu_torch.models.blocks import Decoder, Encoder
from smsut_tpu_torch.models.layers import Conv
from smsut_tpu_torch.ops import acc


class DualTaskDecoder(Decoder):
    """The U-Net's decoder levels with the heads ``fc1`` (tanh) and
    ``fc2``, both bias-free 1x1 convs."""

    def heads(self, out_ch: int, width: int,
              generator: Optional[torch.Generator], act_type: str) -> None:
        self.fc1 = Conv(width, out_ch, 1, generator, act_type=act_type)
        self.fc2 = Conv(width, out_ch, 1, generator, act_type=act_type)

    def forward(self, x: torch.Tensor, skips
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.levels(x, skips)
        return acc(torch.tanh(self.fc1(x))), acc(self.fc2(x))


class DTCUNet(nn.Module):
    """``DTCUNet(out_ch, width=64, norm_type="batch", act_type="relu")``.

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``,
    then moved to ``device``: the card unless ``device`` names another (no
    CUDA and no device raises).  Returns (tanh head, logits), each float32
    [B, H, W, out_ch]."""

    def __init__(self, out_ch: int, width: int = 64, in_ch: int = 1,
                 norm_type: str = "batch", act_type: str = "relu",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 block_fused: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        g = torch.Generator().manual_seed(seed)
        self.encoder = Encoder(width, in_ch, block_fused, g, norm_type,
                               act_type)
        self.decoder = DualTaskDecoder(out_ch, width, block_fused, g,
                                       norm_type, act_type)
        self.to(device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h, skips = self.encoder(x.to(self.compute_dtype))
        return self.decoder(h, skips)
