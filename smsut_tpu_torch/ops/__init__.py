# -*- coding: utf-8 -*-
"""The port's kernels.  Each wrapper launches its hand-written CUDA kernel
on a CUDA tensor, and takes its plain PyTorch version, in the same module,
on a CPU tensor.  There is no fallback: a CUDA tensor the kernel does not
take raises.

:func:`plain` makes the wrappers run their plain versions on any device,
so that a caller can hold the kernel path against the plain one on the
card.  Launches made there are not counted.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_PLAIN = contextvars.ContextVar("smsut_plain", default=False)

# dtype codes of the C entry points
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@contextlib.contextmanager
def plain():
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def on_card(x: torch.Tensor) -> bool:
    """True where the wrapper must launch its kernel."""
    return x.is_cuda and not _PLAIN.get()


def require(x: torch.Tensor, what: str, channels_mult: int = 1) -> int:
    """Check what every kernel needs of an activation on the card; return
    its dtype code."""
    if x.dtype not in DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} is not float32/bfloat16")
    if x.dim() != 4:
        raise ValueError(f"{what}: expected NHWC, got shape {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: input must be contiguous and 16-byte "
                         f"aligned")
    if x.shape[-1] % channels_mult:
        raise ValueError(f"{what}: channels {x.shape[-1]} are not a "
                         f"multiple of {channels_mult}")
    return DTYPES[x.dtype]


def require_like(t: torch.Tensor, what: str, shape, dtype,
                 device: torch.device) -> None:
    """Check a weight or norm parameter handed to a kernel."""
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{what}: expected contiguous {dtype} {tuple(shape)} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
