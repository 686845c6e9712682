# -*- coding: utf-8 -*-
"""K2: 3x3 stride-1 SAME convolution forward, NHWC, HWIO weights.

Port of ``smsut_tpu/ops/conv_pallas.py`` ``_conv_fwd`` (public
``conv_same_pallas``).  On a CUDA tensor :func:`conv3x3` launches the
kernel of ``csrc/conv3x3.cu``; on a CPU tensor it runs
:func:`conv3x3_plain`: the nine taps as shifted views times the [Cin, Cout]
tap weight, summed in float32, rounded once to the input's dtype.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from smsut_tpu_torch.ops import on_card, require, require_like
from smsut_tpu_torch.ops._build import I, P, bind, check, stream_of


def conv_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME conv of NHWC ``x`` with odd-k HWIO ``w`` [k,k,Cin,Cout],
    accumulated tap by tap in float32 (float32 result)."""
    k = w.shape[0]
    b, h, wd, _ = x.shape
    xf, wf = x.float(), w.float()
    r = k // 2
    xp = F.pad(xf, (0, 0, r, r, r, r)) if r else xf
    y = None
    for u in range(k):
        for v in range(k):
            t = xp[:, u:u + h, v:v + wd, :] @ wf[u, v]
            y = t if y is None else y + t
    return y


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K2."""
    return conv_f32(x, w).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    return bind("conv3x3", "smsut_conv3x3_fwd", [P] * 3 + [I] * 6 + [P])


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y = conv(x, w)``, SAME zero padding; ``w`` [3,3,Cin,Cout] in x's
    dtype.  Float32 accumulation, output in x's dtype.  On the card Cout
    must be a multiple of 16."""
    if not on_card(x):
        return conv3x3_plain(x, w)
    dt = require(x, "conv3x3")
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    require_like(w, "conv3x3 weight", (3, 3, cin, cout), x.dtype, x.device)
    if cout % 16:
        raise ValueError(f"conv3x3: Cout {cout} is not a multiple of 16")
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    check(_kernel()(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, cin,
                    cout, dt, stream_of(x)), "conv3x3")
    conv3x3.launches += 1
    return y


conv3x3.launches = 0
