# -*- coding: utf-8 -*-
"""Residual blocks and the 5-level encoder/decoder pair, NHWC.

Port of the unpacked path of ``smsut_tpu/models/blocks.py``: 5x5 stem,
residual BasicBlocks with a 1x1+norm shortcut on channel change, max-pool
downsampling, 2x2 stride-2 transposed-conv (or bilinear + 1x1)
upsampling with skip concat, widths w/2, w .. 16w; and the
discriminator's BottleBlock.  ``norm_type`` (``"instance"`` or
``"batch"``) and ``act_type`` (``"lrelu"`` or ``"relu"``) pass down from
the Encoder and Decoder to every block and norm, as in the JAX package;
the U-Net and the UGAN towers keep instance norm and leaky ReLU, the
dual-task U-Net (``models/dtc.py``) defaults to batch norm and ReLU.
Module and parameter names mirror the flax tree (models/transplant.py
maps one onto the other).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from smsut_tpu_torch.models.layers import (
    Conv,
    NormAct,
    activation,
    avg_pool2,
    kaiming_normal_fan_out,
    max_pool2,
    upsample_bilinear2,
)
from smsut_tpu_torch.ops import block as k3
from smsut_tpu_torch.ops.block import basic_block
from smsut_tpu_torch.ops.instnorm import lrelu


class BasicBlock(nn.Module):
    """2x(conv3x3 + norm), 1x1(+norm) shortcut when channels change, the
    activation after the sum.  ``fused`` runs the whole block as one call
    of kernel K3 forward and K6 backward (``Config.block_pallas``) instead
    of K2 + K1 (K4, K2, K5 backward) per layer, where those kernels take
    the block's shape (``block.takes``); a block they do not take runs the
    unfused chain and is counted in ``block.basic_block.routed``, as the
    JAX package sends such shapes to XLA (``block_pallas.enabled_for``).
    K3 and K6 compute instance norm and leaky ReLU, so another
    ``norm_type`` or ``act_type`` runs the unfused chain by its
    configuration, uncounted."""

    def __init__(self, cin: int, features: int, fused: bool = False,
                 generator: Optional[torch.Generator] = None,
                 norm_type: str = "instance", act_type: str = "lrelu"):
        super().__init__()
        self.fused = fused and (norm_type, act_type) == ("instance", "lrelu")
        self.act = activation(act_type)
        conv = lambda ci, k: Conv(ci, features, k, generator,
                                  act_type=act_type)
        self.conv1 = conv(cin, 3)
        self.bn1 = NormAct(features, act_type, norm_type)
        self.conv2 = conv(features, 3)
        self.bn2 = NormAct(features, None, norm_type)
        self.has_shortcut = cin != features
        if self.has_shortcut:
            self.shortcut1 = conv(cin, 1)
            self.shortcut2 = NormAct(features, None, norm_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            dt = x.dtype
            if not k3.takes(x.shape, self.conv1.weight.shape[-1],
                            self.has_shortcut, dt):
                basic_block.routed += 1
            else:
                short = ((self.shortcut1.weight.to(dt), self.shortcut2.weight,
                          self.shortcut2.bias) if self.has_shortcut else ())
                return basic_block(x, self.conv1.weight.to(dt),
                                   self.bn1.weight, self.bn1.bias,
                                   self.conv2.weight.to(dt), self.bn2.weight,
                                   self.bn2.bias, *short)
        y = self.bn2(self.conv2(self.bn1(self.conv1(x))))
        idn = self.shortcut2(self.shortcut1(x)) if self.has_shortcut else x
        return self.act(y + idn)


class ConvTranspose2x2(nn.Module):
    """2x2 stride-2 transposed conv, bias-free.  ``weight`` [Cin, 2, 2, Cout]
    holds the tap that lands on output subpixel (dy, dx):
    y[2i+dy, 2j+dx] = x[i, j] @ weight[:, dy, dx].  (flax's ConvTranspose
    kernel is the same array flipped in space: models/transplant.py.)"""

    def __init__(self, cin: int, features: int,
                 generator: Optional[torch.Generator] = None,
                 act_type: str = "lrelu"):
        super().__init__()
        # fan_out of the flax kernel [2, 2, Cin, Cout] is 4*Cout
        self.weight = nn.Parameter(kaiming_normal_fan_out(
            (cin, 2, 2, features), 4 * features, generator, act_type))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, cin = x.shape
        cout = self.weight.shape[-1]
        y = x @ self.weight.to(x.dtype).reshape(cin, 4 * cout)
        y = y.reshape(b, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(b, 2 * h, 2 * w, cout)


class UpSampleAndConcat(nn.Module):
    """2x upsample, then channel concat with the skip: a 2x2 stride-2
    transposed conv (``up``), or with ``transposed=False`` half-pixel
    bilinear then a 1x1 conv (``up_conv``)."""

    def __init__(self, cin: int, features: int,
                 generator: Optional[torch.Generator] = None,
                 transposed: bool = True, act_type: str = "lrelu"):
        super().__init__()
        if transposed:
            self.up = ConvTranspose2x2(cin, features, generator, act_type)
        else:
            self.up_conv = Conv(cin, features, 1, generator,
                                act_type=act_type)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "up"):
            y = self.up(x)
        else:
            y = self.up_conv(upsample_bilinear2(x))
        return torch.cat([y, skip.to(y.dtype)], dim=-1)


class BottleBlock(nn.Module):
    """The discriminator's residual block: conv3x3 + norm + lrelu, a 2x2
    average pool with ``stride`` 2, conv3x3 + norm; the shortcut is the
    pooled input, through a 1x1 conv + norm (``short_conv``,
    ``short_norm``) when channels change; lrelu after the sum.  Its 3x3
    convs and norms run K2/K5 and K1/K4, twice differentiable (the
    gradient penalty)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"BottleBlock: stride {stride} is not 1 or 2")
        self.stride = stride
        self.conv1 = Conv(cin, features, 3, generator)
        self.bn1 = NormAct(features, "lrelu")
        self.conv2 = Conv(features, features, 3, generator)
        self.bn2 = NormAct(features, None)
        self.has_shortcut = cin != features
        if self.has_shortcut:
            self.short_conv = Conv(cin, features, 1, generator)
            self.short_norm = NormAct(features, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn1(self.conv1(x))
        idn = x
        if self.stride == 2:
            y, idn = avg_pool2(y), avg_pool2(x)
        y = self.bn2(self.conv2(y))
        if self.has_shortcut:
            idn = self.short_norm(self.short_conv(idn))
        return lrelu(y + idn)


_MULTS = (1, 2, 4, 8)


class Encoder(nn.Module):
    """5x5 stem to w/2, then 4x(BasicBlock + maxpool) and a bottleneck
    block; widths w .. 16w.  Returns (bottleneck, skips)."""

    def __init__(self, width: int, cin: int = 1, fused: bool = False,
                 generator: Optional[torch.Generator] = None,
                 norm_type: str = "instance", act_type: str = "lrelu"):
        super().__init__()
        w = width
        block = lambda ci, co: BasicBlock(ci, co, fused, generator,
                                          norm_type, act_type)
        self.pre_conv = Conv(cin, w // 2, 5, generator, act_type=act_type)
        self.pre_bn = NormAct(w // 2, act_type, norm_type)
        prev = w // 2
        for i, mult in enumerate(_MULTS):
            setattr(self, f"layer{i + 1}", block(prev, mult * w))
            prev = mult * w
        self.layer5 = block(prev, 16 * w)

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
                 generator: Optional[torch.Generator] = None,
                 norm_type: str = "instance", act_type: str = "lrelu"):
        super().__init__()
        w = width
        for i in (4, 3, 2, 1):
            mult = _MULTS[i - 1]
            setattr(self, f"up{i}", UpSampleAndConcat(
                2 * mult * w, mult * w, generator, act_type=act_type))
            setattr(self, f"layer{i}", BasicBlock(
                2 * mult * w, mult * w, fused, generator, norm_type,
                act_type))
        self.heads(out_ch, w, generator, act_type)

    def heads(self, out_ch: int, width: int,
              generator: Optional[torch.Generator], act_type: str) -> None:
        """The 1x1 head ``fc``."""
        self.fc = Conv(width, out_ch, 1, generator, act_type=act_type)

    def levels(self, x: torch.Tensor,
               skips: Sequence[torch.Tensor]) -> torch.Tensor:
        """The four up + concat + block levels, without the head."""
        for i in (4, 3, 2, 1):
            x = getattr(self, f"up{i}")(x, skips[i - 1])
            x = getattr(self, f"layer{i}")(x)
        return x

    def forward(self, x: torch.Tensor,
                skips: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.fc(self.levels(x, skips))
