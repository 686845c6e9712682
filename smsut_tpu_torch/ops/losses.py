# -*- coding: utf-8 -*-
"""Segmentation losses over NHWC logits, in float32 (float64 for float64
logits).

Port of the unpacked losses of ``smsut_tpu/ops/losses.py``:
``one_hot_last``, ``get_tp_fp_fn``, ``soft_dice_loss``,
``cross_entropy_loss`` and ``dice_and_ce_loss`` (the reference's
``DiceAndCrossEntropyLoss`` with ``batch_dice=True``, the loss of every
trainer), and the GAN's ``argmax_consistency_loss``, ``patch_nce_loss``
(as :func:`patch_nce_in_groups`, the form a process group needs; the
mean over the one NCE layer is the step's), ``l1_loss`` and
``softmax_ce_with_logits``; Mean
Teacher's ``softmax_mse_consistency``; M3L's ``soft_cross_entropy``
(``smsut_tpu/train/steps/m3l.py``); and CoraNet's three-head losses
(``split_heads``, ``coranet_weights``, ``three_head_losses`` and the stage-B
terms of ``smsut_tpu/train/steps/coranet.py``) in their plain form.  The
JAX package evaluates the CoraNet tail channel-first in one fused pass, a
TPU lane-padding device with the same math (its own tests hold it against
the plain form).  No kernel: the JAX package leaves them to XLA too.

The packed variants (``pack_labels``, ``argmax_packed``,
``dice_and_ce_loss_packed4``, ``dice_and_ce_loss_packed``,
``softmax_mse_consistency_packed``) take the packed logits [B, H, W, 4C]
of ``pack_levels`` (channel ``s*C + c``, ``models/packed.py``) as they are
(``packed_loss_tails``): a per-pixel loss does not see the repacking, so
each is its unpacked loss on the free view [B, H, 4W, C] with the labels
packed alike, the softmax of each subpixel group stabilised by its own
max.

Under a process group (``parallel/``) each rank holds its rows of the
global batch and the gradients are averaged over the group, which makes
every plain mean of per-sample terms exact; under a space axis a rank
holds rows of each image, every plain mean over equal shards stays exact,
and the per-image sums over H*W (the Dice with ``batch_dice=False``) are
the space group's (``parallel.mesh.space_sum``).  The reductions over the batch
axis that are not such a mean become sums over the global batch through
``parallel.mesh.batch_sums``: the batch Dice's tp/fp/fn
(:func:`get_tp_fp_fn`, :func:`dice_and_ce_loss`, and so
:func:`argmax_consistency_loss` and CoraNet's head 0), the class-weighted
CE's mean (:func:`cross_entropy_loss`), and CoraNet's masked means
(:func:`masked_certain_loss`, :func:`masked_head_mse`).  Without a group
they are the sums they were.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from smsut_tpu_torch.ops import acc
from smsut_tpu_torch.parallel.mesh import batch_sums, space_sum


def one_hot_last(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(labels.long(), num_classes).float()


def get_tp_fp_fn(probs: torch.Tensor, labels: torch.Tensor,
                 batch_dice: bool, over_group: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tp/fp/fn reduced over the spatial dims, and the batch dim with
    ``batch_dice`` (the group's global batch unless ``over_group`` is
    False): [C] or [B, C].  fp = sum(p) - tp, fn = sum(gt) - tp."""
    return _tp_fp_fn(probs, one_hot_last(labels, probs.shape[-1]),
                     batch_dice, over_group)


def _tp_fp_fn(probs: torch.Tensor, gt: torch.Tensor, batch_dice: bool,
              over_group: bool):
    dims = (0, 1, 2) if batch_dice else (1, 2)
    tp = (probs * gt).sum(dim=dims)
    ps, gs = probs.sum(dim=dims), gt.sum(dim=dims)
    if batch_dice and over_group:
        tp, ps, gs = batch_sums(tp, ps, gs)
    elif not batch_dice:
        # per-image sums over H*W: the space group's under a space axis
        tp, ps, gs = space_sum(torch.stack([tp, ps, gs])).unbind(0)
    return tp, ps - tp, gs - tp


def soft_dice_loss(logits: torch.Tensor, labels: torch.Tensor,
                   batch_dice: bool = True, smooth: float = 1e-5,
                   over_group: bool = True) -> torch.Tensor:
    """Softmax, tp/fp/fn, background channel excluded, 1 - mean dice."""
    probs = torch.softmax(acc(logits), dim=-1)
    tp, fp, fn = get_tp_fp_fn(probs, labels, batch_dice, over_group)
    dc = (2.0 * tp + smooth) / (2.0 * tp + fp + fn + smooth + 1e-8)
    dc = dc[1:] if batch_dice else dc[:, 1:]
    return 1.0 - dc.mean()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights: Optional[torch.Tensor] = None,
                       reduce: bool = True) -> torch.Tensor:
    """nn.CrossEntropyLoss over [B,H,W,C] logits and [B,H,W] labels; with
    ``class_weights`` the mean over the global batch is weighted by the
    per-pixel class weight."""
    logp = torch.log_softmax(acc(logits), dim=-1)
    gt = one_hot_last(labels, logits.shape[-1])
    nll = -(logp * gt).sum(dim=-1)
    if class_weights is not None:
        w = gt @ torch.as_tensor(class_weights, dtype=torch.float32,
                                 device=gt.device)
        if not reduce:
            return nll * w
        num, den = batch_sums((nll * w).sum(), w.sum())
        return num / torch.clamp(den, min=1e-8)
    return nll.mean() if reduce else nll


def dice_and_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                     weight_dc: float = 0.5, weight_ce: float = 0.5,
                     batch_dice: bool = True,
                     over_group: bool = True) -> torch.Tensor:
    """weight_dc * SoftDice + weight_ce * CE.  With both weights active the
    two share one stabilised softmax: probs = e/s and logp = (x - m) -
    log(s) from the same (m = max, detached; e = exp(x - m); s = sum e).
    The batch Dice sums over the group's global batch unless
    ``over_group`` is False (a loss of the rank's own rows: the eval
    sweep's per-batch loss)."""
    if weight_dc == 0 or weight_ce == 0:
        dc = (soft_dice_loss(logits, labels, batch_dice,
                             over_group=over_group) if weight_dc else 0.0)
        ce = cross_entropy_loss(logits, labels) if weight_ce else 0.0
        return weight_dc * dc + weight_ce * ce
    x = acc(logits)
    m = x.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(x - m)
    s = e.sum(dim=-1, keepdim=True)
    probs = e / s
    gt = one_hot_last(labels, x.shape[-1])
    tp, fp, fn = _tp_fp_fn(probs, gt, batch_dice, over_group)
    dcv = (2.0 * tp + 1e-5) / (2.0 * tp + fp + fn + 1e-5 + 1e-8)
    dcv = dcv[1:] if batch_dice else dcv[:, 1:]
    dc = 1.0 - dcv.mean()
    nll = -((x * gt).sum(dim=-1) - m[..., 0] - torch.log(s[..., 0]))
    return weight_dc * dc + weight_ce * nll.mean()


def argmax_consistency_loss(source_logits: torch.Tensor,
                            target_logits: torch.Tensor,
                            weight_dc: float = 0.5,
                            weight_ce: float = 0.5) -> torch.Tensor:
    """SMSUT consistency: Dice+CE (batch dice) of the source logits against
    the argmax of the target logits, which carries no gradient."""
    target = torch.argmax(target_logits.detach(), dim=-1)
    return dice_and_ce_loss(source_logits, target, weight_dc, weight_ce,
                            batch_dice=True)


def patch_nce_in_groups(feat_q: torch.Tensor, feat_k: torch.Tensor,
                        keys: torch.Tensor, own: torch.Tensor,
                        temperature: float = 0.07) -> torch.Tensor:
    """PatchNCE's per-patch loss of M images' L2-normalised query pools
    (``feat_q`` [M*P, C], image-major): each patch's positive is its own
    image's key at the same patch (``feat_k`` [M*P, C]), its negatives the
    keys of its image's group (``keys`` [M, G*P, C], in the group's
    order), its own masked (``own`` bool [M, P, G*P]).  The reference
    takes the negatives within groups of ``batch_size`` images' pools even
    for a pool from a 2x batch (the group quirk, kept); a rank's images
    whose groups span ranks (the keys gathered) take the loss one process
    takes at the global batch.  The keys are detached.  [M*P]."""
    feat_q = acc(feat_q)
    feat_k = acc(feat_k.detach())
    keys = acc(keys.detach())
    m, gp, dim = keys.shape
    l_pos = (feat_q * feat_k).sum(dim=1, keepdim=True)
    l_neg = torch.bmm(feat_q.reshape(m, -1, dim), keys.transpose(1, 2))
    l_neg = l_neg.masked_fill(own, -10.0).reshape(-1, gp)
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    return -torch.log_softmax(logits, dim=1)[:, 0]


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (acc(a) - acc(b)).abs().mean()


def softmax_ce_with_logits(logits: torch.Tensor,
                           target_index: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over [B, C] classifier logits (the discriminator's
    modality head)."""
    logp = torch.log_softmax(acc(logits), dim=-1)
    return -(logp * one_hot_last(target_index, logits.shape[-1])).sum(
        dim=-1).mean()


def softmax_mse_consistency(student_logits: torch.Tensor,
                            teacher_logits: torch.Tensor) -> torch.Tensor:
    """Mean Teacher's consistency: the mean squared difference of the two
    softmaxes over the last axis."""
    ps = torch.softmax(acc(student_logits), dim=-1)
    pt = torch.softmax(acc(teacher_logits), dim=-1)
    return (ps - pt).square().mean()


def soft_cross_entropy(logits: torch.Tensor,
                       target_probs: torch.Tensor) -> torch.Tensor:
    """nn.CrossEntropyLoss with probability targets over the last axis:
    -mean over pixels of sum(target * log_softmax(logits))."""
    logp = torch.log_softmax(acc(logits), dim=-1)
    return -(target_probs * logp).sum(dim=-1).mean()


# ---------------------------------------------------------------------------
# CoraNet: one shared background logit and three heads of n_label channels
# (normal, conservative, radical), NHWC
# ---------------------------------------------------------------------------

def coranet_weights(n_label: int, device: Union[str, torch.device] = "cpu"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chaos variant's class weights of the conservative and radical
    heads' CE: [1, 5, ..., 5] over-weighs the organs, [5, 1, ..., 1] the
    background (a quirk of the reference's configuration, kept)."""
    w_con = torch.tensor([1.0] + [5.0] * n_label, device=device)
    w_rad = torch.tensor([5.0] + [1.0] * n_label, device=device)
    return w_con, w_rad


def split_heads(out: torch.Tensor, n_label: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[..., 3 n_label + 1] -> the three heads' (1 + n_label)-channel
    logits, each led by the shared background channel."""
    back = out[..., :1]
    return tuple(torch.cat([back, out[..., 1 + k * n_label:
                                      1 + (k + 1) * n_label]], dim=-1)
                 for k in range(3))


def three_head_losses(out: torch.Tensor, msk: torch.Tensor,
                      w_con: torch.Tensor, w_rad: torch.Tensor,
                      n_label: int, weight_dc: float, weight_ce: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cedc, con, rad): Dice+CE (batch dice) of head 0, and the class-
    weighted CE of heads 1 and 2."""
    h0, h1, h2 = split_heads(out, n_label)
    cedc = dice_and_ce_loss(h0, msk, weight_dc, weight_ce, batch_dice=True)
    return (cedc, cross_entropy_loss(h1, msk, w_con),
            cross_entropy_loss(h2, msk, w_rad))


def masked_certain_loss(h0: torch.Tensor, labels: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """CoraNet's certain term on pseudo-labels: (CE of head 0 over the
    global batch's pixels where ``mask`` is 1, and its per-image soft
    Dice) / 2."""
    nll = cross_entropy_loss(h0, labels, reduce=False)
    mask = mask.to(nll.dtype)
    num, den = batch_sums((nll * mask).sum(), mask.sum())
    ce = num / (den + 1e-16)
    return (ce + soft_dice_loss(h0, labels, batch_dice=False)) / 2.0


def masked_head_mse(student: torch.Tensor, teacher: torch.Tensor,
                    n_label: int, umask: torch.Tensor) -> torch.Tensor:
    """CoraNet's uncertain term before its weight: the squared difference
    of the student's and the teacher's softmaxes, summed over the three
    heads' channels and the global batch's pixels where ``umask`` is 1,
    over the count of those pixels, over 3."""
    umask = umask.to(acc(student).dtype)
    dist = 0.0
    for s, t in zip(split_heads(student, n_label),
                    split_heads(teacher.detach(), n_label)):
        d = (torch.softmax(acc(s), dim=-1)
             - torch.softmax(acc(t), dim=-1)).square().sum(dim=-1)
        dist = dist + (d * umask).sum()
    dist, count = batch_sums(dist, umask.sum())
    return dist / (count + 1e-16) / 3.0


# ---------------------------------------------------------------- packed


def pack_labels(labels: torch.Tensor) -> torch.Tensor:
    """[B, 2H, 2W] labels -> [B, H, W, 4] in space_to_depth's subpixel
    order (dy*2 + dx)."""
    b, h2, w2 = labels.shape
    lab = labels.reshape(b, h2 // 2, 2, w2 // 2, 2).permute(0, 1, 3, 2, 4)
    return lab.reshape(b, h2 // 2, w2 // 2, 4)


def _view(logits_p: torch.Tensor) -> torch.Tensor:
    """Packed logits [B, H, W, 4C] -> the per-pixel view [B, H, 4W, C]."""
    b, h, w, c4 = logits_p.shape
    return logits_p.reshape(b, h, 4 * w, c4 // 4)


def _view_labels(labels4: torch.Tensor) -> torch.Tensor:
    b, h, w, _ = labels4.shape
    return labels4.reshape(b, h, 4 * w)


def argmax_packed(logits_p: torch.Tensor) -> torch.Tensor:
    """Per-subpixel-group argmax: [B, H, W, 4C] -> [B, H, W, 4] int64,
    equal to ``pack_labels(argmax(depth_to_space(logits_p)))``."""
    b, h, w, c4 = logits_p.shape
    return acc(logits_p).reshape(b, h, w, 4, c4 // 4).argmax(dim=-1)


def dice_and_ce_loss_packed4(logits_p: torch.Tensor, labels4: torch.Tensor,
                             weight_dc: float = 0.5,
                             weight_ce: float = 0.5) -> torch.Tensor:
    """:func:`dice_and_ce_loss` (batch Dice) of packed logits against packed
    [B, H, W, 4] labels (:func:`pack_labels`, :func:`argmax_packed`)."""
    return dice_and_ce_loss(_view(logits_p), _view_labels(labels4),
                            weight_dc, weight_ce, batch_dice=True)


def dice_and_ce_loss_packed(logits_p: torch.Tensor, labels: torch.Tensor,
                            weight_dc: float = 0.5,
                            weight_ce: float = 0.5) -> torch.Tensor:
    """:func:`dice_and_ce_loss` (batch Dice) of packed logits against the
    unpacked [B, 2H, 2W] labels: the loss of ``depth_to_space(logits_p)``."""
    return dice_and_ce_loss_packed4(logits_p, pack_labels(labels), weight_dc,
                                    weight_ce)


def softmax_mse_consistency_packed(student_p: torch.Tensor,
                                   teacher_p: torch.Tensor) -> torch.Tensor:
    """:func:`softmax_mse_consistency` of packed logits: the same elements,
    the same mean."""
    return softmax_mse_consistency(_view(student_p), _view(teacher_p))
