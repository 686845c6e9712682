# -*- coding: utf-8 -*-
"""Segmentation losses over NHWC logits, in float32.

Port of the unpacked losses of ``smsut_tpu/ops/losses.py``:
``one_hot_last``, ``get_tp_fp_fn``, ``soft_dice_loss``,
``cross_entropy_loss`` and ``dice_and_ce_loss`` (the reference's
``DiceAndCrossEntropyLoss`` with ``batch_dice=True``, the loss of every
trainer).  No kernel: the JAX package leaves them to XLA too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def one_hot_last(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).float()


def get_tp_fp_fn(probs: torch.Tensor, labels: torch.Tensor,
                 batch_dice: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tp/fp/fn reduced over the spatial dims, and the batch dim with
    ``batch_dice``: [C] or [B, C].  fp = sum(p) - tp, fn = sum(gt) - tp."""
    gt = one_hot_last(labels, probs.shape[-1])
    dims = (0, 1, 2) if batch_dice else (1, 2)
    tp = (probs * gt).sum(dim=dims)
    fp = probs.sum(dim=dims) - tp
    fn = gt.sum(dim=dims) - tp
    return tp, fp, fn


def soft_dice_loss(logits: torch.Tensor, labels: torch.Tensor,
                   batch_dice: bool = True,
                   smooth: float = 1e-5) -> torch.Tensor:
    """Softmax, tp/fp/fn, background channel excluded, 1 - mean dice."""
    probs = torch.softmax(logits.float(), dim=-1)
    tp, fp, fn = get_tp_fp_fn(probs, labels, batch_dice)
    dc = (2.0 * tp + smooth) / (2.0 * tp + fp + fn + smooth + 1e-8)
    dc = dc[1:] if batch_dice else dc[:, 1:]
    return 1.0 - dc.mean()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: Optional[torch.Tensor] = None,
                       reduce: bool = True) -> torch.Tensor:
    """nn.CrossEntropyLoss over [B,H,W,C] logits and [B,H,W] labels; with
    ``class_weights`` the mean is weighted by the per-pixel class weight."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    gt = one_hot_last(labels, logits.shape[-1])
    nll = -(logp * gt).sum(dim=-1)
    if class_weights is not None:
        w = gt @ torch.as_tensor(class_weights, dtype=torch.float32,
                                 device=gt.device)
        if not reduce:
            return nll * w
        return (nll * w).sum() / torch.clamp(w.sum(), min=1e-8)
    return nll.mean() if reduce else nll


def dice_and_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                     weight_dc: float = 0.5, weight_ce: float = 0.5,
                     batch_dice: bool = True) -> torch.Tensor:
    """weight_dc * SoftDice + weight_ce * CE.  With both weights active the
    two share one stabilised softmax: probs = e/s and logp = (x - m) -
    log(s) from the same (m = max, detached; e = exp(x - m); s = sum e)."""
    if weight_dc == 0 or weight_ce == 0:
        dc = soft_dice_loss(logits, labels, batch_dice) if weight_dc else 0.0
        ce = cross_entropy_loss(logits, labels) if weight_ce else 0.0
        return weight_dc * dc + weight_ce * ce
    x = logits.float()
    m = x.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(x - m)
    s = e.sum(dim=-1, keepdim=True)
    probs = e / s
    gt = one_hot_last(labels, x.shape[-1])
    dims = (0, 1, 2) if batch_dice else (1, 2)
    tp = (probs * gt).sum(dim=dims)
    fp = probs.sum(dim=dims) - tp
    fn = gt.sum(dim=dims) - tp
    dcv = (2.0 * tp + 1e-5) / (2.0 * tp + fp + fn + 1e-5 + 1e-8)
    dcv = dcv[1:] if batch_dice else dcv[:, 1:]
    dc = 1.0 - dcv.mean()
    nll = -((x * gt).sum(dim=-1) - m[..., 0] - torch.log(s[..., 0]))
    return weight_dc * dc + weight_ce * nll.mean()
