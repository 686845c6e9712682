# -*- coding: utf-8 -*-
"""Shared low-level layers, NHWC.

Port of the parts of ``smsut_tpu/models/layers.py`` that the U-Net, the
UGAN towers, the discriminator and the dual-task U-Net (``models/dtc.py``)
use: the convs, ``NormAct`` with instance norm or training-mode batch norm
(``BatchNorm``) and leaky ReLU or ReLU, the pools and the 2x upsample.
Activations flow in the compute dtype (bfloat16 by default); parameters
and normalisation statistics stay float32.  Conv weights are stored HWIO
[k, k, Cin, Cout], the layout the kernels read and the flax layout.

On a CUDA tensor every instance norm runs kernel K1 forward and K4
backward, and every 3x3 conv that the kernels take (``conv3x3.takes``)
kernel K2 forward, K2 (dx) and K5 (dw) backward.  A 3x3 conv they do not
take, such as the first block's at ``base_width=8``, goes to
:func:`conv_plain` by its shape alone and is counted in
``conv3x3.conv3x3.routed``, as the JAX package sends the shapes its Pallas
conv does not take to XLA (``conv_pallas.enabled_for``).  The weights are
cast to the activation dtype per call, and the gradient comes back through
that cast to the float32 parameter.  The other convs (5x5 stem, 1x1 head
and shortcut) and the pooling stay plain PyTorch with autograd, as XLA
computed them in the JAX package.  Every op here is twice
differentiable, for the discriminator's gradient penalty.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from smsut_tpu_torch.ops import acc
from smsut_tpu_torch.ops import conv3x3 as k2
from smsut_tpu_torch.ops.conv3x3 import conv3x3
from smsut_tpu_torch.ops.instnorm import instance_norm, lrelu

# torch.nn.init.calculate_gain('leaky_relu') uses negative_slope=0.01.
_LRELU_GAIN2 = 2.0 / (1.0 + 0.01 ** 2)
BN_EPS = 1e-5


def kaiming_normal_fan_out(shape, fan_out: int,
                           generator: Optional[torch.Generator],
                           act_type: Optional[str] = "lrelu") -> torch.Tensor:
    """Kaiming-normal, mode='fan_out', with the gain of ``act_type`` (2 for
    ReLU, the leaky-ReLU gain otherwise: the JAX package's
    ``kaiming_normal_fan_out``), float32 on the CPU."""
    gain2 = 2.0 if act_type == "relu" else _LRELU_GAIN2
    return torch.randn(shape, generator=generator) * math.sqrt(gain2 / fan_out)


def activation(act_type: Optional[str]) -> Callable[[torch.Tensor],
                                                     torch.Tensor]:
    """``"relu"``, ``"lrelu"`` (slope 0.01) or ``None`` (identity): the
    JAX package's ``get_act``."""
    if act_type == "relu":
        return torch.relu
    if act_type == "lrelu":
        return lrelu
    if act_type is None:
        return lambda y: y
    raise NotImplementedError(act_type)


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = BN_EPS) -> torch.Tensor:
    """Training-mode BatchNorm2d over NHWC ``x``: statistics over (B, H, W)
    in float32 (float64 for float64 ``x``), var = E[x^2] - E[x]^2, no
    running averages; the result in ``x``'s dtype."""
    xf = acc(x)
    mean = xf.mean(dim=(0, 1, 2))
    var = (xf * xf).mean(dim=(0, 1, 2)) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps) * scale + bias
    return y.to(x.dtype)


def conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME conv with odd-k HWIO ``w`` where no kernel of the port applies:
    a matmul for 1x1, ``F.conv2d`` on the channels-last view otherwise."""
    k = w.shape[0]
    if k == 1:
        return x @ w[0, 0]
    # a contiguous weight: the CPU's float64 conv (slow_conv2d) refuses a
    # strided one in its double backward
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(),
                 padding=k // 2)
    return y.permute(0, 2, 3, 1).contiguous()


class Conv(nn.Module):
    """SAME conv, torch Conv2d(k, padding=k//2) semantics; with
    ``use_bias`` a float32 bias (zeros at init, flax's default) added
    after the conv in the activation dtype, as flax adds it."""

    def __init__(self, cin: int, features: int, kernel: int,
                 generator: Optional[torch.Generator] = None,
                 use_bias: bool = False, act_type: Optional[str] = "lrelu"):
        super().__init__()
        self.weight = nn.Parameter(kaiming_normal_fan_out(
            (kernel, kernel, cin, features), kernel * kernel * features,
            generator, act_type))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if w.shape[0] == 3 and k2.takes(x.shape, w.shape[-1], x.dtype):
            y = conv3x3(x, w)
        else:
            if w.shape[0] == 3:
                conv3x3.routed += 1
            y = conv_plain(x, w)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class NormAct(nn.Module):
    """A norm with f32 statistics and eps 1e-5, then ``act_type`` (None,
    ``"lrelu"`` or ``"relu"``).  ``norm_type`` ``"instance"``:
    InstanceNorm2d(affine=True), kernel K1 (with the leaky ReLU fused);
    ``"batch"``: training-mode batch norm (:func:`batch_norm`)."""

    def __init__(self, features: int, act_type: Optional[str] = None,
                 norm_type: str = "instance"):
        super().__init__()
        if norm_type not in ("instance", "batch"):
            raise NotImplementedError(norm_type)
        self.norm_type = norm_type
        self.act_type = act_type
        self.act = activation(act_type)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_type == "batch":
            return self.act(batch_norm(x, self.weight, self.bias))
        if self.act_type == "lrelu":
            return instance_norm(x, self.weight, self.bias, True)
        return self.act(instance_norm(x, self.weight, self.bias, False))


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool, NHWC (odd edges dropped, as VALID pooling)."""
    b, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool, NHWC, VALID (odd edges dropped)."""
    b, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def upsample_bilinear2(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with half-pixel centres, NHWC: the JAX
    package's ``jax.image.resize(..., "bilinear")`` at x2, whose edge
    weights renormalise to the edge pixel as the clamp here does."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)
