# -*- coding: utf-8 -*-
"""K3: fused residual BasicBlock forward, NHWC, identity and 1x1-shortcut
forms.

Port of ``smsut_tpu/ops/block_pallas.py`` ``_fwd_call`` (public
``fused_block``, ``fused_block_short``, ``fused_block_fwd``), on the
unpacked NHWC map.  On a CUDA tensor :func:`basic_block` launches the chain
of ``csrc/block.cu``; on a CPU tensor it runs :func:`basic_block_plain`.

Both follow the TPU kernel's rounding: statistics from the float32 conv
accumulators, normalisation applied to the stored (dtype-rounded) conv
outputs, the pre-activation sum in float32.  In float32 that equals the
unfused K2 + K1 chain up to summation order; in bfloat16 the unfused chain
takes its statistics from the rounded conv outputs instead, so the two
differ by bfloat16 rounding.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from smsut_tpu_torch.ops import on_card, require, require_like
from smsut_tpu_torch.ops._build import I, P, bind, check, stream_of
from smsut_tpu_torch.ops.conv3x3 import conv_f32
from smsut_tpu_torch.ops.instnorm import lrelu, stats


def _affine(yf: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """(g, h) with norm(y)*scale + bias == y*g + h, from float32 y."""
    mean, rstd = stats(yf)
    g = scale * rstd
    return g[:, None, None], (bias - mean * g)[:, None, None]


def basic_block_plain(x, w1, s1, b1, w2, s2, b2, ws=None, ss=None, bs=None):
    """Plain version of K3."""
    dt = x.dtype
    y1f = conv_f32(x, w1)
    g1, h1 = _affine(y1f, s1, b1)
    z1 = lrelu(y1f.to(dt).float() * g1 + h1).to(dt)
    y2f = conv_f32(z1, w2)
    g2, h2 = _affine(y2f, s2, b2)
    pre = y2f.to(dt).float() * g2 + h2
    if ws is None:
        pre = pre + x.float()
    else:
        uf = conv_f32(x, ws)
        gs, hs = _affine(uf, ss, bs)
        pre = pre + (uf.to(dt).float() * gs + hs)
    return lrelu(pre).to(dt)


@functools.lru_cache(maxsize=None)
def _kernel():
    return bind("block", "smsut_block_fwd", [P] * 16 + [I] * 6 + [P])


@functools.lru_cache(maxsize=None)
def _ntiles_fn():
    return bind("block", "smsut_block_ntiles", [I] * 3)


def basic_block(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                b1: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
                b2: torch.Tensor, ws: Optional[torch.Tensor] = None,
                ss: Optional[torch.Tensor] = None,
                bs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """lrelu(IN(conv3(lrelu(IN(conv3(x, w1))), w2)) + idn), idn = x or
    IN(conv1x1(x, ws)).  Conv weights HWIO in x's dtype (``ws``
    [1,1,Cin,Cout]); norm parameters [Cout] float32.  On the card Cout must
    be a multiple of 16."""
    if not on_card(x):
        return basic_block_plain(x, w1, s1, b1, w2, s2, b2, ws, ss, bs)
    dt = require(x, "basic_block")
    b, h, wd, ci = x.shape
    co = w1.shape[-1]
    dev = x.device
    require_like(w1, "basic_block w1", (3, 3, ci, co), x.dtype, dev)
    require_like(w2, "basic_block w2", (3, 3, co, co), x.dtype, dev)
    params = [("s1", s1), ("b1", b1), ("s2", s2), ("b2", b2)]
    if ws is not None:
        require_like(ws, "basic_block ws", (1, 1, ci, co), x.dtype, dev)
        params += [("ss", ss), ("bs", bs)]
    elif ci != co:
        raise ValueError(f"basic_block: identity form needs Cin == Cout, "
                         f"got {ci} -> {co}")
    for name, t in params:
        require_like(t, f"basic_block {name}", (co,), torch.float32, dev)
    if co % 16:
        raise ValueError(f"basic_block: Cout {co} is not a multiple of 16")
    out = torch.empty((b, h, wd, co), dtype=x.dtype, device=dev)
    y1 = torch.empty_like(out)
    y2 = torch.empty_like(out)
    u = torch.empty_like(out) if ws is not None else None
    nt = _ntiles_fn()(h, wd, co)
    part = torch.empty((b, nt, 2, co), dtype=torch.float32, device=dev)
    gh = torch.empty((3, b, 2, co), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    check(_kernel()(x.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), ptr(ws),
                    ptr(ss), ptr(bs), out.data_ptr(), y1.data_ptr(),
                    y2.data_ptr(), ptr(u), part.data_ptr(), gh.data_ptr(),
                    b, h, wd, ci, co, dt, stream_of(x)), "basic_block")
    basic_block.launches += 1
    return out


basic_block.launches = 0
