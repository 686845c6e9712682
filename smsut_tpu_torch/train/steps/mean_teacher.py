# -*- coding: utf-8 -*-
"""Mean Teacher: ``smsut_tpu/train/steps/mean_teacher.py`` ``MeanTeacher``.

One iteration, as the JAX step runs it:

- the teacher (the EMA parameters, no gradient) sees the unlabelled batch
  plus ``clip(0.01 * N(0, 1), -0.02, 0.02)`` noise;
- the student sees the labelled and unlabelled batches at once (16 images
  at batch 8): Dice+CE on the labelled half, and the softmax MSE against
  the teacher on the unlabelled half, gated off for the first 100
  iterations and weighted by ``lambda_semi`` (1 with a 30-epoch sigmoid
  rampup, a per-epoch scalar);
- SGD under the poly LR, then the EMA update with alpha 0 for the first
  100 iterations and min(1 - 1/(t + 1), 0.99) after, t the count before
  the update.

The gate and alpha are read from the state's device count, so a CUDA graph
of the step replays them right (train/graphs.py).  The noise is an input of
:meth:`MeanTeacher.step` (``noise``; the tests feed the JAX package's
draw).  Without it the step draws it on the device from the count and
``cfg.seed`` (:func:`teacher_noise`, a counter-based hash): a replay draws
the count's noise, T staged iterations each their own, and a resumed run
the noise the uninterrupted run drew.  The JAX package draws it with
``jax.random`` from a per-epoch host key, a stream the port does not
reproduce.

Under a process group (``parallel/``) a rank holds its contiguous rows of
both batches and draws its rows of the global batch's noise (the hash
runs over element indices of the global batch), so two ranks see the
noise of one process; the batch Dice sums over the global batch
(``ops/losses.py``) and the gradients are averaged (``train/state.py``).
Under a space axis a rank holds its rows of every image of its data
coordinate's batch rows and draws those elements of the global noise;
the consistency's mean over equal shards stays exact.  Under a model axis
(``parallel/mesh.py`` ``make_mesh_2d``) the student and the EMA teacher
run on the rank's output-channel shards, the EMA updates shard by shard,
and the noise's rows follow the data coordinate, so the model ranks of
one data coordinate draw the same noise.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from smsut_tpu_torch.ops.losses import (softmax_mse_consistency,
                                        softmax_mse_consistency_packed)
from smsut_tpu_torch.ops.schedules import ema_alpha, gate, sigmoid_rampup
from smsut_tpu_torch.parallel import distributed, mesh
from smsut_tpu_torch.train.state import TrainState, make_sgd
from smsut_tpu_torch.train.steps import loss_weight
from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

Params = Dict[str, torch.Tensor]

_M32 = 0xFFFFFFFF


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of int64 values in [0, 2^32); every product
    stays below 2^63."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def element_ids(shape, rows: Optional[Sequence[slice]], device,
                hrows: Optional[slice] = None) -> torch.Tensor:
    """int64 flat indices, in a tensor of ``shape``, of the elements of
    ``rows`` (slices of its first axis, in turn) and of ``hrows`` (a
    slice of its second axis: a space rank's rows of each image), in
    that order; every index of an axis where its selection is None."""
    n = math.prod(shape)
    if hrows is None or (hrows.start, hrows.stop) == (0, shape[1]):
        # every row of each image: contiguous runs of whole images
        if rows is None:
            return torch.arange(n, device=device)
        per = n // shape[0]
        ids = [torch.arange(s.start * per, s.stop * per, device=device)
               for s in rows]
        return ids[0] if len(ids) == 1 else torch.cat(ids)
    b = (torch.arange(shape[0], device=device) if rows is None else
         torch.cat([torch.arange(s.start, s.stop, device=device)
                    for s in rows]))
    h = torch.arange(hrows.start, hrows.stop, device=device)
    per = math.prod(shape[2:])
    first = (b[:, None] * shape[1] + h[None, :]) * per
    return (first[..., None]
            + torch.arange(per, device=device)).reshape(-1)


def selected_shape(shape, rows: Optional[Sequence[slice]],
                   hrows: Optional[slice] = None) -> tuple:
    """The shape of :func:`element_ids`' selection of a tensor of
    ``shape``."""
    b = shape[0] if rows is None else sum(s.stop - s.start for s in rows)
    h = shape[1] if hrows is None else hrows.stop - hrows.start
    return (b, h, *shape[2:])


def teacher_noise(count: torch.Tensor, shape, seed: int,
                  rows: Optional[Sequence[slice]] = None,
                  hrows: Optional[slice] = None) -> torch.Tensor:
    """float32 ``clip(0.01 * z, -0.02, 0.02)`` of ``shape`` on the count's
    device, z standard normal by Box-Muller from a hash of (``seed``,
    ``count``, element): a function of the device count, no host value.
    Box-Muller pairs element i with element n + i of the n in ``shape``.
    With ``rows`` (slices of the first axis) and ``hrows`` (a slice of
    the second) only those elements of that draw, to the bit: a rank's
    rows of the global batch's noise, and a space rank's rows of each
    image."""
    n = math.prod(shape)
    key = mix32((count.to(torch.int64) * 0x2545F491
                  + seed * 0x9E3779B1 + 0x632BE5AB) & _M32)
    ids = element_ids(shape, rows, count.device, hrows)
    u = [((mix32(mix32(i) ^ key) >> 8).to(torch.float32) + 0.5)
         * (1.0 / (1 << 24)) for i in (ids, ids + n)]
    z = torch.sqrt(-2.0 * torch.log(u[0])) * torch.cos(2.0 * math.pi * u[1])
    return torch.clamp(0.01 * z, -0.02, 0.02).view(
        selected_shape(shape, rows, hrows))


def global_shape(x: torch.Tensor) -> tuple:
    """The shape of the global batch of which ``x`` holds the rank's rows
    of the batch (its data coordinate's) and, under a space axis, of
    every image."""
    return (x.shape[0] * distributed.data_count(),
            x.shape[1] * distributed.space_count(), *x.shape[2:])


class MeanTeacher(SupervisedUNet):
    """The student ``UNet(n_class, base_width)`` and its EMA teacher, on
    the card unless ``device`` names another."""

    rematerialises = False
    packed_tails = True

    name = "meanTeacher"
    uses_unlabeled = True
    lambda_semi = 1.0
    ema_decay = 0.99
    epoch_rampup = 30
    log_step = 50
    # the count from which the consistency term counts, and below which
    # the EMA copies the student
    gate_step = 100

    def state_from_params(self, params: Mapping[str, torch.Tensor],
                          ema_params: Optional[Mapping] = None
                          ) -> TrainState:
        """A fresh train state (step 0, zero momentum) holding float32
        copies of ``params`` and of the teacher's ``ema_params`` (a copy
        of ``params`` unless given)."""
        return TrainState.create(
            self.eval_params(params), make_sgd(self.cfg),
            ema_params=self.eval_params(
                params if ema_params is None else ema_params))

    def inputs(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """:meth:`step`'s tensors of ``batch = {"img", "msk", "ul_img"}``
        (and ``noise`` [B,H,W,1] where given) on the device."""
        inp = super().inputs(batch)
        for k in ("ul_img", "noise"):
            if k in batch:
                inp[k] = torch.as_tensor(batch[k], dtype=torch.float32,
                                         device=self.device)
        return inp

    def step(self, state: TrainState, inp: Mapping[str, torch.Tensor],
             scalars: Mapping) -> Dict[str, torch.Tensor]:
        """The iteration on the device: the teacher forward, the student's
        losses and gradients, SGD at the device count, the count advanced,
        the EMA update.  ``scalars["lambda_semi"]``: a number or a 0-d
        device tensor."""
        self.check_state(state)
        cfg = self.cfg
        ul = inp["ul_img"]
        bs = inp["img"].shape[0]   # the rank's rows: batch_size / N
        noise = inp.get("noise")
        if noise is None:
            # the rank's batch rows and image rows of the global draw
            g = global_shape(ul)
            noise = teacher_noise(state.count, g, cfg.seed,
                                  [distributed.local_batch_slice(g[0])],
                                  mesh.space_slice(g[1]))
        on = gate(state.count, self.gate_step)
        with torch.no_grad():
            teacher = self.train_logits(state.ema_params, ul + noise)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        logits = self.train_logits(leaves, torch.cat([inp["img"], ul]))
        sup = self.seg_loss(logits[:bs], inp["msk"])
        consistency = (softmax_mse_consistency_packed
                       if logits.shape[-1] != cfg.n_class
                       else softmax_mse_consistency)
        semi = consistency(logits[bs:], teacher) * on
        total = sup + loss_weight(scalars["lambda_semi"]) * semi
        grads = torch.autograd.grad(total, list(leaves.values()))
        state.update(dict(zip(leaves, grads)))
        alpha = ema_alpha(state.count - 1, self.ema_decay)
        state.ema_update_(alpha)
        return {"loss": sup.detach(), "semi_loss": semi.detach(),
                "alpha": alpha}

    def epoch_scalars(self, epoch: int) -> Dict[str, np.float32]:
        lam = self.lambda_semi * sigmoid_rampup(epoch, self.epoch_rampup)
        return {"lambda_semi": np.float32(lam)}
