# -*- coding: utf-8 -*-
"""The poly learning-rate schedule as a function of the step counter, the
sigmoid rampup and the EMA decay of Mean Teacher and CoraNet.

Port of ``poly_lr_schedule``, ``poly_lr_host``, ``sigmoid_rampup`` and
``mean_teacher_alpha`` of ``smsut_tpu/ops/schedules.py``.  The reference mutates the optimizer's LR
after each step, so step k trains with poly(max(k - 1, 0)); both functions
keep that one-step lag, and clamp the base at 0 past ``total_iters``.
:func:`poly_lr_table` lists ``poly_lr_host`` by step count, so that the
train states read the LR on the card from their device step counter
(train/state.py): the same float64 values, rounded once to the
parameters' dtype, as the host floats the optimizer took before.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def poly_lr_host(base_lr: float, step: int, total_iters: int,
                 power: float = 0.9) -> float:
    """lr * (1 - max(step - 1, 0)/total)^power, the base clamped at 0 (a
    negative base to a fractional power is complex in Python)."""
    eff = max(int(step) - 1, 0)
    return float(base_lr * max(1.0 - eff / total_iters, 0.0) ** power)


def poly_lr_schedule(base_lr: float, total_iters: int,
                     power: float = 0.9) -> Callable[[int], float]:
    """count -> the LR of the step with that count (``poly_lr_host``)."""

    def schedule(count: int) -> float:
        return poly_lr_host(base_lr, count, total_iters, power)

    return schedule


def poly_lr_table(base_lr: float, total_iters: int,
                  power: float = 0.9) -> np.ndarray:
    """float64 [total_iters + 2]: row k is ``poly_lr_host`` at count k.  The
    last row, 0, is the LR of every count past it."""
    return np.array([poly_lr_host(base_lr, k, total_iters, power)
                     for k in range(total_iters + 2)], np.float64)


def sigmoid_rampup(current: float, rampup_length: float) -> float:
    """exp(-5 (1 - t)^2), t = current / rampup_length clipped to [0, 1];
    1 for a zero length.  Host-side."""
    if rampup_length == 0:
        return 1.0
    current = np.clip(current, 0.0, rampup_length)
    phase = 1.0 - current / rampup_length
    return float(np.exp(-5.0 * phase * phase))


def mean_teacher_alpha(iteration: int, ema_decay: float = 0.99) -> float:
    """The EMA decay: 0 for the first 100 iterations, then min(1 - 1/(t +
    1), ``ema_decay``).  Host-side."""
    if iteration < 100:
        return 0.0
    return min(1.0 - 1.0 / (iteration + 1), ema_decay)


def ema_alpha(iteration: torch.Tensor, ema_decay: float = 0.99
              ) -> torch.Tensor:
    """:func:`mean_teacher_alpha` of a 0-d device count, on the device and
    in float32 as the JAX step computes it, so that a replayed graph reads
    the count it runs at."""
    it = iteration.to(torch.float32)
    return torch.where(it < 100, torch.zeros_like(it),
                       torch.clamp(1.0 - 1.0 / (it + 1.0), max=ema_decay))


def gate(count: torch.Tensor, at: int,
         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """1 from device count ``at`` on, else 0, as a 0-d tensor of ``dtype``
    on the count's device."""
    return (count >= at).to(dtype)
