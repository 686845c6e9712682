# -*- coding: utf-8 -*-
"""The port's kernels.  Each wrapper launches its hand-written CUDA kernel
on a CUDA tensor, and takes its plain PyTorch version, in the same module,
on a CPU tensor.  There is no fallback: a CUDA tensor the kernel does not
take raises.  The model layer (``models/layers.py``, ``models/blocks.py``)
sends a shape that a conv or block kernel does not take to plain PyTorch
before any wrapper is called, by shape alone (``conv3x3.takes``,
``block.takes``), and counts it (``conv3x3.conv3x3.routed``,
``block.basic_block.routed``).

:func:`plain` makes the wrappers run their plain versions on any device,
so that a caller can hold the kernel path against the plain one on the
card.  Launches made there are not counted.

Every wrapper counts its launches, and the model layer its routes, in an
attribute of a function (``instance_norm_fwd.launches``,
``conv3x3.routed``), registered with :func:`counter`.  They count Python
calls: a CUDA graph's replay makes none, so ``train/graphs.py`` records
the counts a capture saw (:func:`counts`) and adds them at each replay
(:func:`add_counts`).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import List, Sequence, Tuple

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


# (function, attribute) of every launch and route counter
_COUNTERS: List[Tuple[object, str]] = []


def counter(fn, attr: str = "launches") -> None:
    """Register ``fn.<attr>`` as a counter, starting at 0."""
    setattr(fn, attr, 0)
    _COUNTERS.append((fn, attr))


def counts() -> List[int]:
    """Every counter's value, in registration order."""
    return [getattr(f, a) for f, a in _COUNTERS]


def add_counts(delta: Sequence[int]) -> None:
    """Add ``delta`` (as :func:`counts` orders it) to the counters."""
    for (f, a), d in zip(_COUNTERS, delta):
        setattr(f, a, getattr(f, a) + d)


def plain_active() -> bool:
    """True inside :func:`plain`."""
    return _PLAIN.get()


def acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the accumulation type: float32, or float64 for a float64
    tensor (the plain versions' own checks, such as gradgradcheck)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def on_card(x: torch.Tensor) -> bool:
    """True where the wrapper must launch its kernel."""
    return x.is_cuda and not _PLAIN.get()


def require(x: torch.Tensor, what: str) -> int:
    """Check what every kernel needs of an activation on the card; return
    its dtype code."""
    if x.dtype not in DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} is not float32/bfloat16")
    if x.dim() != 4:
        raise ValueError(f"{what}: expected NHWC, got shape {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: input must be contiguous and 16-byte "
                         f"aligned")
    return DTYPES[x.dtype]


def require_like(t: torch.Tensor, what: str, shape, dtype,
                 device: torch.device) -> None:
    """Check a weight or norm parameter handed to a kernel."""
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{what}: expected contiguous {dtype} {tuple(shape)} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
