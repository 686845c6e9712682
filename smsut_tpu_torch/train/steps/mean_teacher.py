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
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from smsut_tpu_torch.ops.losses import (dice_and_ce_loss,
                                        softmax_mse_consistency)
from smsut_tpu_torch.ops.schedules import ema_alpha, gate, sigmoid_rampup
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


def teacher_noise(count: torch.Tensor, shape, seed: int) -> torch.Tensor:
    """float32 ``clip(0.01 * z, -0.02, 0.02)`` of ``shape`` on the count's
    device, z standard normal by Box-Muller from a hash of (``seed``,
    ``count``, element): a function of the device count, no host value."""
    n = math.prod(shape)
    key = mix32((count.to(torch.int64) * 0x2545F491
                  + seed * 0x9E3779B1 + 0x632BE5AB) & _M32)
    h = mix32(mix32(torch.arange(2 * n, device=count.device)) ^ key)
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    z = torch.sqrt(-2.0 * torch.log(u[:n])) * torch.cos(2.0 * math.pi * u[n:])
    return torch.clamp(0.01 * z, -0.02, 0.02).view(shape)


class MeanTeacher(SupervisedUNet):
    """The student ``UNet(n_class, base_width)`` and its EMA teacher, on
    the card unless ``device`` names another."""

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
        cfg = self.cfg
        bs = cfg.batch_size
        ul = inp["ul_img"]
        noise = inp.get("noise")
        if noise is None:
            noise = teacher_noise(state.count, tuple(ul.shape), cfg.seed)
        on = gate(state.count, self.gate_step)
        with torch.no_grad():
            teacher = torch.func.functional_call(self.net, state.ema_params,
                                                 (ul + noise,))
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        logits = torch.func.functional_call(
            self.net, leaves, (torch.cat([inp["img"], ul]),))
        sup = dice_and_ce_loss(logits[:bs], inp["msk"], cfg.weight_dc,
                               cfg.weight_ce, batch_dice=True)
        semi = softmax_mse_consistency(logits[bs:], teacher) * on
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
