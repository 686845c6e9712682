# -*- coding: utf-8 -*-
"""3x3 SAME convolutions on the tensor cores: the three conv candidates of
``tools/microbench_pallas_conv.py``, forward only.

Each wrapper computes ``y[b,i,j,co] = sum_{u,v,ci} x[b,i+u-1,j+v-1,ci] *
w[u,v,ci,co]`` with zero padding, NHWC ``x``, HWIO ``w`` [3,3,C,Cout],
float32 accumulation and one rounding to x's dtype, as the Pallas
candidate it replaces does:

- :func:`conv3x3_dots`: ``pallas_conv_dots`` (nine accumulated tap products);
- :func:`conv3x3_im2col`: ``pallas_conv_im2col`` (one K = 9C product per
  pixel tile, the input copied and multiplied in turn);
- :func:`conv3x3_im2col2`: ``pallas_conv_im2col2`` (the same with the next
  input's copy in flight during the products).

On a CUDA tensor each launches its kernel of ``csrc/conv3x3_mma.cu``, on
Hopper's ``wgmma``, TMA and mbarriers: the im2col pair in
``csrc/conv3x3_im2col_sm90.cuh``, dots in ``csrc/conv3x3_dots_sm90.cuh``
(its weights held in registers).  dots takes C over 64 too, on a bf16
``mma.sync`` kernel; :func:`dots_route` says which of the two a shape
runs, decided by shape before the launch.  On a CPU tensor, or under
``ops.plain()``, each runs :func:`conv3x3_mma_plain`.  ``strip`` is the
number of image rows one block (one Pallas strip) walks in the mma.sync
dots kernel; the Hopper kernels pick their own bands.  It does not
change the math, and H must be a multiple of it.  On the card the
kernels take bfloat16, C and Cout multiples of 16, 16-byte aligned
tensors and a shape whose staged rows and weights fit a block's shared
memory (the im2col pair: C up to 64); they refuse any other shape, and
the wrapper raises ``ValueError``.  The Pallas candidates have no
backward, so neither do these.
"""
from __future__ import annotations

import functools

import torch

from smsut_tpu_torch.ops import counter, on_card, require, require_like
from smsut_tpu_torch.ops._build import I, P, bind, check, stream_of
from smsut_tpu_torch.ops.conv3x3 import conv_f32


def conv3x3_mma_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of all three: the taps summed in float32, rounded once
    to x's dtype."""
    return conv_f32(x, w).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel(variant: str):
    return bind("conv3x3_mma", f"smsut_conv3x3_{variant}",
                [P] * 3 + [I] * 6 + [P])


def _conv(variant: str, wrapper, x: torch.Tensor, w: torch.Tensor,
          strip: int) -> torch.Tensor:
    name = f"conv3x3_{variant}"
    b, h, wd, c = x.shape
    cout = w.shape[-1]
    if strip < 1 or h % strip:
        raise ValueError(f"{name}: H {h} is not a multiple of strip {strip}")
    if not on_card(x):
        return conv3x3_mma_plain(x, w)
    require(x, name)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {x.dtype}")
    require_like(w, f"{name} weight", (3, 3, c, cout), x.dtype, x.device)
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    check(_kernel(variant)(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h,
                           wd, c, cout, strip, stream_of(x)), name,
          f"the kernel does not take x {tuple(x.shape)}, Cout {cout}: C and "
          f"Cout must be multiples of 16, x, w and y 16-byte aligned, and a "
          f"block's shared memory must hold W {wd} and C {c}"
          + (" (dots: C up to 64 on the Hopper kernel, else the mma.sync "
             "kernel's weight slab and rows)" if variant == "dots" else ""))
    wrapper.launches += 1
    return y


def conv3x3_dots(x: torch.Tensor, w: torch.Tensor,
                 strip: int = 16) -> torch.Tensor:
    """Nine tap products per row of pixels from a ring of staged input
    rows (``pallas_conv_dots``): on the card, the Hopper kernel with the
    taps' weights in registers where C <= 64, else mma.sync
    (:func:`dots_route`)."""
    return _conv("dots", conv3x3_dots, x, w, strip)


DOTS_ROUTES = {0: None, 1: "conv_dots_kernel", 2: "conv_dots_sm90_kernel"}


def dots_route(b: int, h: int, w: int, c: int, cout: int) -> str | None:
    """The kernel :func:`conv3x3_dots` runs at x [b,h,w,c] -> cout on this
    process's current card (whatever strip and alignment):
    ``"conv_dots_sm90_kernel"`` (C <= 64 and its ring fits the card's
    shared memory), ``"conv_dots_kernel"`` (mma.sync) or None (refused).
    Needs the card: it asks the built library."""
    f = bind("conv3x3_mma", "smsut_conv3x3_dots_route", [I] * 5)
    return DOTS_ROUTES[f(b, h, w, c, cout)]


def conv3x3_im2col(x: torch.Tensor, w: torch.Tensor,
                   strip: int = 16) -> torch.Tensor:
    """One K = 9C product per column tile (``pallas_conv_im2col``)."""
    return _conv("im2col", conv3x3_im2col, x, w, strip)


def conv3x3_im2col2(x: torch.Tensor, w: torch.Tensor,
                    strip: int = 16) -> torch.Tensor:
    """im2col with the next input rows' TMA copies in flight during the
    products (``pallas_conv_im2col2``)."""
    return _conv("im2col2", conv3x3_im2col2, x, w, strip)


for _f in (conv3x3_dots, conv3x3_im2col, conv3x3_im2col2):
    counter(_f)
