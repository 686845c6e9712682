#!/usr/bin/env python
# -*- coding: utf-8 -*-
"""Microbench: the port's tensor-core 3x3 conv candidates against the
library conv and K2, at the GAN step's hw-packed level-0 shape
([B,128,128,64] x [3,3,64,64] -> [B,128,128,64], bfloat16).

Port of ``tools/microbench_pallas_conv.py``.  Candidates:
  library     ``F.conv2d`` on the channels-last view (cuDNN on the card):
              the yardstick, which no path of the port calls
  k2          ``conv3x3_fwd`` (K2; in bfloat16 its tensor-core kernel)
  dots        ``conv3x3_dots``: nine accumulated tap products
  im2col      ``conv3x3_im2col``: one [M, 9C] @ [9C, Cout] product per tile
  im2col2     ``conv3x3_im2col2``: im2col with the next input's copy in
              flight during the products
  im2col2_32, im2col_32: the same at strip 32

Timing: a chain of ``iters`` applications y = f(y) after a warm-up,
between two CUDA events, enqueued while a sleep kernel holds the stream, so
that the events time the device and not the host's launch rate (an
application of tens of us is shorter than its enqueue).  ``rel_err`` is
max |f(x) - plain(x)| / max |plain(x)| against the plain version of the
same function; a candidate over ``REL_TOL``, or one that fails, raises.

Usage: python -m smsut_tpu_torch.tools.microbench_conv [batch] [iters]
"""
from __future__ import annotations

import functools
import sys
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from smsut_tpu_torch.device import resolve_device
from smsut_tpu_torch.ops.conv3x3 import conv3x3_fwd
from smsut_tpu_torch.ops.conv_mma import (conv3x3_dots, conv3x3_im2col,
                                          conv3x3_im2col2, conv3x3_mma_plain)

# one bf16 rounding of the largest output (2^-8 of it), with room for the
# library's own order of summation
REL_TOL = 8e-3


def library_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """PyTorch's conv on the channels-last view of NHWC ``x``."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def candidates() -> List[Tuple[str, Callable]]:
    return [("library", library_conv),
            ("k2", conv3x3_fwd),
            ("dots", conv3x3_dots),
            ("im2col", conv3x3_im2col),
            ("im2col2", conv3x3_im2col2),
            ("im2col2_32", functools.partial(conv3x3_im2col2, strip=32)),
            ("im2col_32", functools.partial(conv3x3_im2col, strip=32))]


def time_chain(fn: Callable, x: torch.Tensor, w: torch.Tensor,
               iters: int) -> float:
    """Seconds per application of a chain y = fn(y, w) of ``iters``
    applications: CUDA events on the card, the host clock on the CPU."""
    y = fn(x, w)
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    y = fn(y, w)
    host_s = time.perf_counter() - t0
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        y = x
        # about 2e9 cycles a second; twice the host's time for the chain
        torch.cuda._sleep(int(min(2 * iters * host_s, 1.0) * 2e9))
        start.record()
        for _ in range(iters):
            y = fn(y, w)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    y = x
    for _ in range(iters):
        y = fn(y, w)
    return (time.perf_counter() - t0) / iters


def main(argv: Optional[Sequence[str]] = None, device=None) -> List[dict]:
    """Run every candidate at [batch, 128, 128, 64] and print one line
    each; returns the rows.  On the card unless ``device`` names another."""
    args = list(sys.argv[1:] if argv is None else argv)
    b = int(args[0]) if args else 16
    iters = int(args[1]) if len(args) > 1 else 50
    dev = resolve_device(device)
    hw, c = 128, 64
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        where = torch.cuda.get_device_name(dev)
    else:
        where = f"{dev} (host clock, not a device time)"
    gx = torch.Generator(device=dev).manual_seed(0)
    gw = torch.Generator(device=dev).manual_seed(1)
    x = (torch.randn((b, hw, hw, c), generator=gx, device=dev)
         * 0.1).to(torch.bfloat16)
    w = (torch.randn((3, 3, c, c), generator=gw, device=dev)
         * 0.05).to(torch.bfloat16)
    flops = 2 * b * hw * hw * 9 * c * c
    print(f"microbench_conv on {where}: x [{b},{hw},{hw},{c}] bf16, w "
          f"[3,3,{c},{c}], {flops / 1e9:.3f} GFLOP per application, chains "
          f"of {iters}", flush=True)
    ref = conv3x3_mma_plain(x, w).float()
    scale = float(ref.abs().max()) + 1e-9
    rows = []
    for name, fn in candidates():
        out = fn(x, w).float()
        if tuple(out.shape) != tuple(ref.shape) \
                or not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"{name}: output {tuple(out.shape)} is not "
                               f"finite of shape {tuple(ref.shape)}")
        err = float((out - ref).abs().max()) / scale
        if not err <= REL_TOL:
            raise RuntimeError(f"{name}: rel_err {err:.3g} above {REL_TOL}")
        sec = time_chain(fn, x, w, iters)
        rows.append({"name": name, "us": sec * 1e6,
                     "tflops": flops / sec / 1e12, "rel_err": err})
        print(f"{name:10s} {sec * 1e6:10.2f} us  {flops / sec / 1e12:7.2f} "
              f"TF/s  rel_err={err:.2e}", flush=True)
    return rows


if __name__ == "__main__":
    main()
