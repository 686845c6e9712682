# -*- coding: utf-8 -*-
"""K1: instance norm (+ LeakyReLU 0.01) forward, NHWC.

Port of ``smsut_tpu/ops/instnorm_pallas.py`` ``_fwd_call`` (public
``instance_norm_lrelu`` / ``instance_norm_affine``).  On a CUDA tensor
:func:`instance_norm_fwd` launches the kernel of ``csrc/instnorm.cu``; on a
CPU tensor it runs :func:`instance_norm_plain`, the same math in PyTorch.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from smsut_tpu_torch.ops import on_card, require, require_like
from smsut_tpu_torch.ops._build import I, P, bind, check, stream_of

NEG_SLOPE = 0.01
EPS = 1e-5
# elements of x one statistics block sums; sets how H*W is split
_BLOCK_ELEMS = 16384
_MAX_SPLITS = 256


def lrelu(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y >= 0, y, NEG_SLOPE * y)


def stats(yf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd) [B, C] of a float32 NHWC map over H*W, with the JAX
    reference's var = E[x^2] - mean^2 (not ``torch.var``)."""
    n = yf.shape[1] * yf.shape[2]
    mean = yf.sum(dim=(1, 2)) / n
    var = (yf * yf).sum(dim=(1, 2)) / n - mean * mean
    return mean, torch.rsqrt(var + EPS)


def instance_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, act: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K1: (out in x's dtype, mean [B,C], rstd [B,C])."""
    xf = x.float()
    mean, rstd = stats(xf)
    y = (xf - mean[:, None, None]) * rstd[:, None, None] * scale + bias
    return (lrelu(y) if act else y).to(x.dtype), mean, rstd


def splits(hw: int, c: int) -> Tuple[int, int]:
    """(nsplit, rows): the statistics pass cuts H*W into nsplit slices of
    ``rows`` rows, about _BLOCK_ELEMS elements each."""
    n = -(-hw * c // _BLOCK_ELEMS)
    n = max(1, min(_MAX_SPLITS, n, hw))
    rows = -(-hw // n)
    return -(-hw // rows), rows


@functools.lru_cache(maxsize=None)
def _kernel():
    return bind("instnorm", "smsut_instnorm_fwd",
                [P] * 7 + [I] * 7 + [P])


def instance_norm_fwd(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, act: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """InstanceNorm2d(affine, eps 1e-5) over H*W of NHWC ``x``, then
    LeakyReLU(0.01) when ``act``.  Returns (out, mean, rstd); statistics
    are float32 whatever the dtype of ``x``."""
    if not on_card(x):
        return instance_norm_plain(x, scale, bias, act)
    dt = require(x, "instance_norm", 4)
    b, h, w, c = x.shape
    for name, t in (("scale", scale), ("bias", bias)):
        require_like(t, f"instance_norm {name}", (c,), torch.float32, x.device)
    nsplit, rows = splits(h * w, c)
    out = torch.empty_like(x)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    part = torch.empty((b, nsplit, 2, c), dtype=torch.float32, device=x.device)
    check(_kernel()(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                    part.data_ptr(), b, h * w, c, nsplit, rows, dt, int(act),
                    stream_of(x)), "instance_norm")
    instance_norm_fwd.launches += 1
    return out, mean, rstd


instance_norm_fwd.launches = 0


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  act: bool) -> torch.Tensor:
    return instance_norm_fwd(x, scale, bias, act)[0]
