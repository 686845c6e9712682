# -*- coding: utf-8 -*-
"""Residual blocks and the 5-level encoder/decoder pair, NHWC.

Port of the unpacked path of ``smsut_tpu/models/blocks.py``: 5x5 stem,
residual BasicBlocks with a 1x1+norm shortcut on channel change, max-pool
downsampling, 2x2 stride-2 transposed-conv upsampling with skip concat,
widths w/2, w .. 16w.  Module and parameter names mirror the flax tree
(models/transplant.py maps one onto the other).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from smsut_tpu_torch.models.layers import (
    Conv,
    NormAct,
    kaiming_normal_fan_out,
    max_pool2,
)
from smsut_tpu_torch.ops.block import basic_block
from smsut_tpu_torch.ops.instnorm import lrelu


class BasicBlock(nn.Module):
    """2x(conv3x3 + norm), 1x1(+norm) shortcut when channels change,
    leaky ReLU after the sum.  ``fused`` runs the whole block as one call of
    kernel K3 (``Config.block_pallas``) instead of K2 + K1 per layer."""

    def __init__(self, cin: int, features: int, fused: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fused = fused
        self.conv1 = Conv(cin, features, 3, generator)
        self.bn1 = NormAct(features, "lrelu")
        self.conv2 = Conv(features, features, 3, generator)
        self.bn2 = NormAct(features, None)
        self.has_shortcut = cin != features
        if self.has_shortcut:
            self.shortcut1 = Conv(cin, features, 1, generator)
            self.shortcut2 = NormAct(features, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            dt = x.dtype
            short = ((self.shortcut1.weight.to(dt), self.shortcut2.weight,
                      self.shortcut2.bias) if self.has_shortcut else ())
            return basic_block(x, self.conv1.weight.to(dt), self.bn1.weight,
                               self.bn1.bias, self.conv2.weight.to(dt),
                               self.bn2.weight, self.bn2.bias, *short)
        y = self.bn2(self.conv2(self.bn1(self.conv1(x))))
        idn = self.shortcut2(self.shortcut1(x)) if self.has_shortcut else x
        return lrelu(y + idn)


class ConvTranspose2x2(nn.Module):
    """2x2 stride-2 transposed conv, bias-free.  ``weight`` [Cin, 2, 2, Cout]
    holds the tap that lands on output subpixel (dy, dx):
    y[2i+dy, 2j+dx] = x[i, j] @ weight[:, dy, dx].  (flax's ConvTranspose
    kernel is the same array flipped in space: models/transplant.py.)"""

    def __init__(self, cin: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # fan_out of the flax kernel [2, 2, Cin, Cout] is 4*Cout
        self.weight = nn.Parameter(kaiming_normal_fan_out(
            (cin, 2, 2, features), 4 * features, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, cin = x.shape
        cout = self.weight.shape[-1]
        y = x @ self.weight.to(x.dtype).reshape(cin, 4 * cout)
        y = y.reshape(b, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(b, 2 * h, 2 * w, cout)


class UpSampleAndConcat(nn.Module):
    """2x transposed-conv upsample, then channel concat with the skip."""

    def __init__(self, cin: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.up = ConvTranspose2x2(cin, features, generator)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        y = self.up(x)
        return torch.cat([y, skip.to(y.dtype)], dim=-1)


_MULTS = (1, 2, 4, 8)


class Encoder(nn.Module):
    """5x5 stem to w/2, then 4x(BasicBlock + maxpool) and a bottleneck
    block; widths w .. 16w.  Returns (bottleneck, skips)."""

    def __init__(self, width: int, cin: int = 1, fused: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = width
        self.pre_conv = Conv(cin, w // 2, 5, generator)
        self.pre_bn = NormAct(w // 2, "lrelu")
        prev = w // 2
        for i, mult in enumerate(_MULTS):
            setattr(self, f"layer{i + 1}",
                    BasicBlock(prev, mult * w, fused, generator))
            prev = mult * w
        self.layer5 = BasicBlock(prev, 16 * w, fused, generator)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        x = self.pre_bn(self.pre_conv(x))
        skips = []
        for i in range(len(_MULTS)):
            x = getattr(self, f"layer{i + 1}")(x)
            skips.append(x)
            x = max_pool2(x)
        return self.layer5(x), skips


class Decoder(nn.Module):
    """4-level decoder: transposed-conv up + concat, BasicBlock, then a
    1x1 head."""

    def __init__(self, out_ch: int, width: int, fused: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = width
        for i in (4, 3, 2, 1):
            mult = _MULTS[i - 1]
            setattr(self, f"up{i}",
                    UpSampleAndConcat(2 * mult * w, mult * w, generator))
            setattr(self, f"layer{i}",
                    BasicBlock(2 * mult * w, mult * w, fused, generator))
        self.fc = Conv(w, out_ch, 1, generator)

    def forward(self, x: torch.Tensor,
                skips: Sequence[torch.Tensor]) -> torch.Tensor:
        for i in (4, 3, 2, 1):
            x = getattr(self, f"up{i}")(x, skips[i - 1])
            x = getattr(self, f"layer{i}")(x)
        return self.fc(x)
