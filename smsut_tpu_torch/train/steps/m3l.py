# -*- coding: utf-8 -*-
"""M3L, masked-consistency mean teacher over a SegFormer:
``smsut_tpu/train/steps/m3l.py`` ``M3L``.

One iteration, as the JAX step runs it:

- the greyscale images are repeated to three channels;
- the EMA teacher (no gradient) runs unmasked over all 2B images (the head's
  batch norm takes its statistics over the whole batch, so the teacher's
  forward is not cut to the unlabelled half), and its float32 softmax is
  the target;
- the student runs over the same 2B images with the stem's tokens of rows
  [B, 2B) masked by a Bernoulli(0.5) grid of 16 x 16-pixel cells
  (``models/segformer.py``): cross-entropy alone on the labelled half,
  and the soft cross-entropy of the unlabelled half against the teacher,
  weighted by ``lambda_semi`` (1 with a 30-epoch sigmoid rampup, a
  per-epoch scalar);
- Adam under the poly LR, then the EMA update with alpha 0 below count
  100 and min(1 - 1/(t + 1), 0.99) after, t the count before the update.

The mask grid is an input of :meth:`M3L.step` (``mask``, [2B, H/16,
W/16]; the tests feed the JAX package's draw).  Without it the step draws
it on the device from the count and ``cfg.seed`` (:func:`mask_grid`, a
counter-based hash as Mean Teacher's noise is drawn): a CUDA graph's
replay draws the count's mask, T staged iterations each their own, and a
resumed run the mask the uninterrupted run drew.  The JAX package draws it
with ``jax.random`` from a key per step, a stream the port does not
reproduce.  No kernel of the port runs here: the JAX step reaches no
Pallas kernel either.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from smsut_tpu_torch.models.segformer import (
    LinearFusionMaskedConsistencyMixBatch)
from smsut_tpu_torch.ops.losses import cross_entropy_loss, soft_cross_entropy
from smsut_tpu_torch.ops.schedules import ema_alpha, sigmoid_rampup
from smsut_tpu_torch.train.state import TrainState, make_adam
from smsut_tpu_torch.train.steps import loss_weight
from smsut_tpu_torch.train.steps.mean_teacher import mix32
from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

Params = Dict[str, torch.Tensor]

_M32 = 0xFFFFFFFF


def mask_grid(count: torch.Tensor, shape, seed: int) -> torch.Tensor:
    """float32 Bernoulli(0.5) grid (the JAX model's ``mask_ratio``) of
    ``shape`` on the count's device, from a hash of (``seed``, ``count``,
    element): a function of the device count, no host value."""
    n = math.prod(shape)
    key = mix32((count.to(torch.int64) * 0x2545F491
                 + seed * 0x9E3779B1 + 0x3C6EF372) & _M32)
    h = mix32(mix32(torch.arange(n, device=count.device)) ^ key)
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return (u < 0.5).to(torch.float32).view(shape)


def rgb(img: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 1] -> [B, H, W, 3], the channel repeated."""
    return torch.cat([img, img, img], dim=-1)


class M3L(SupervisedUNet):
    """The student ``LinearFusionMaskedConsistencyMixBatch(n_class)`` and
    its EMA teacher, on the card unless ``device`` names another."""

    name = "M3L"
    uses_unlabeled = True
    lambda_semi = 1.0
    ema_decay = 0.99
    epoch_rampup = 30
    log_step = 50

    def _build(self, seed: int) -> LinearFusionMaskedConsistencyMixBatch:
        return LinearFusionMaskedConsistencyMixBatch(
            self.cfg.n_class, compute_dtype=self.dtype, device=self.device,
            seed=seed)

    def state_from_params(self, params: Mapping[str, torch.Tensor],
                          ema_params: Optional[Mapping] = None
                          ) -> TrainState:
        """A fresh train state (step 0, Adam's moments and count at 0)
        holding float32 copies of ``params`` and of the teacher's
        ``ema_params`` (a copy of ``params`` unless given)."""
        return TrainState.create(
            self.eval_params(params), make_adam(self.cfg),
            ema_params=self.eval_params(
                params if ema_params is None else ema_params))

    def grid_shape(self, b: int, h: int, w: int) -> Tuple[int, int, int]:
        """The mask grid's shape for ``b`` images of h x w: the JAX
        model's (b, H/4 // (patch/4), W/4 // (patch/4)), each at least 1."""
        p = max(self.net.mask_patch // 4, 1)
        return b, max(1, (h // 4) // p), max(1, (w // 4) // p)

    def inputs(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """:meth:`step`'s tensors of ``batch = {"img", "msk", "ul_img"}``
        (and the ``mask`` grid where given) on the device."""
        inp = super().inputs(batch)
        for k in ("ul_img", "mask"):
            if k in batch:
                inp[k] = torch.as_tensor(batch[k], dtype=torch.float32,
                                         device=self.device)
        return inp

    def step(self, state: TrainState, inp: Mapping[str, torch.Tensor],
             scalars: Mapping) -> Dict[str, torch.Tensor]:
        """The iteration on the device: the teacher forward, the masked
        student's losses and gradients, Adam at its device count, the
        count advanced, the EMA update.  ``scalars["lambda_semi"]``: a
        number or a 0-d device tensor."""
        cfg = self.cfg
        bs = cfg.batch_size
        img = rgb(torch.cat([inp["img"], inp["ul_img"]]))
        grid = inp.get("mask")
        if grid is None:
            grid = mask_grid(state.count, self.grid_shape(*img.shape[:3]),
                             cfg.seed)
        with torch.no_grad():
            teacher = torch.func.functional_call(self.net, state.ema_params,
                                                 (img,))
            probs = torch.softmax(teacher, dim=-1)
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        logits = torch.func.functional_call(
            self.net, leaves, (img,),
            {"mask_grid": grid, "mask_range": (bs, 2 * bs)})
        sup = cross_entropy_loss(logits[:bs], inp["msk"])
        semi = soft_cross_entropy(logits[bs:], probs[bs:])
        total = sup + loss_weight(scalars["lambda_semi"]) * semi
        grads = torch.autograd.grad(total, list(leaves.values()))
        state.update(dict(zip(leaves, grads)))
        alpha = ema_alpha(state.count - 1, self.ema_decay)
        state.ema_update_(alpha)
        return {"loss": sup.detach(), "semi_loss": semi.detach(),
                "alpha": alpha}

    @torch.inference_mode()
    def eval_fn(self, params: Params,
                img: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """float32 seg logits [B, H, W, n_class] of greyscale NHWC ``img``,
        unmasked (the head's batch norm over this batch)."""
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        return torch.func.functional_call(self.net, params, (rgb(img),))

    def epoch_scalars(self, epoch: int) -> Dict[str, np.float32]:
        lam = self.lambda_semi * sigmoid_rampup(epoch, self.epoch_rampup)
        return {"lambda_semi": np.float32(lam)}
