# -*- coding: utf-8 -*-
"""Shared low-level layers, NHWC.

Port of the parts of ``smsut_tpu/models/layers.py`` that the U-Net uses.
Activations flow in the compute dtype (bfloat16 by default); parameters
and normalisation statistics stay float32.  Conv weights are stored HWIO
[k, k, Cin, Cout], the layout the kernels read and the flax layout.

On a CUDA tensor every instance norm runs kernel K1 and every 3x3 conv
kernel K2.  The other convs (5x5 stem, 1x1 head and shortcut) and the
pooling stay plain PyTorch, as XLA computed them in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from smsut_tpu_torch.ops.conv3x3 import conv3x3
from smsut_tpu_torch.ops.instnorm import instance_norm

# torch.nn.init.calculate_gain('leaky_relu') uses negative_slope=0.01.
_LRELU_GAIN2 = 2.0 / (1.0 + 0.01 ** 2)


def kaiming_normal_fan_out(shape, fan_out: int,
                           generator: Optional[torch.Generator]) -> torch.Tensor:
    """Kaiming-normal, mode='fan_out', leaky-ReLU gain (the JAX package's
    ``kaiming_normal_fan_out``), float32 on the CPU."""
    std = math.sqrt(_LRELU_GAIN2 / fan_out)
    return torch.randn(shape, generator=generator) * std


def conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME conv with odd-k HWIO ``w`` where no kernel of the port applies:
    a matmul for 1x1, ``F.conv2d`` on the channels-last view otherwise."""
    k = w.shape[0]
    if k == 1:
        return x @ w[0, 0]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=k // 2)
    return y.permute(0, 2, 3, 1).contiguous()


class Conv(nn.Module):
    """Bias-free SAME conv, torch Conv2d(k, padding=k//2) semantics."""

    def __init__(self, cin: int, features: int, kernel: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(kaiming_normal_fan_out(
            (kernel, kernel, cin, features), kernel * kernel * features,
            generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if w.shape[0] == 3:
            return conv3x3(x, w)
        return conv_plain(x, w)


class NormAct(nn.Module):
    """InstanceNorm2d(affine=True, eps 1e-5) with f32 statistics, then
    LeakyReLU(0.01) when ``act_type == "lrelu"``."""

    def __init__(self, features: int, act_type: Optional[str] = None):
        super().__init__()
        if act_type not in (None, "lrelu"):
            raise NotImplementedError(act_type)
        self.act = act_type == "lrelu"
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.weight, self.bias, self.act)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool, NHWC (odd edges dropped, as VALID pooling)."""
    b, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
