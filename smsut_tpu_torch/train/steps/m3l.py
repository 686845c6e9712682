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

Under a process group (``parallel/``) a rank holds its contiguous rows of
both batches, draws its rows of the global batch's mask grid (the hash
runs over element indices of the global grid, labelled rows then
unlabelled), and the head's batch norm takes its statistics over the
group's global batch (``models/layers.py`` ``batch_norm``), in the
teacher's forward and the student's; the gradients are averaged
(``train/state.py``).  Under a space axis a rank holds its rows of every
image, draws its rows of each image's mask grid too, and the SegFormer's
layers meet over the space group (``models/segformer.py``): its
attention reads the whole image's keys and values.  Under a model axis
(``parallel/mesh.py`` ``make_mesh_2d``) the SegFormer's layers run on
their weights' output-channel shards and gather them
(``models/segformer.py``), Adam's moments are sharded with the
parameters, and the mask grid's rows follow the data coordinate, so the
model ranks of one data coordinate draw the same grid.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from smsut_tpu_torch.models.layers import local_batch_stats
from smsut_tpu_torch.models.segformer import (
    LinearFusionMaskedConsistencyMixBatch, check_rows)
from smsut_tpu_torch.ops.losses import cross_entropy_loss, soft_cross_entropy
from smsut_tpu_torch.ops.schedules import ema_alpha, sigmoid_rampup
from smsut_tpu_torch.parallel import distributed, mesh
from smsut_tpu_torch.train.state import TrainState, make_adam
from smsut_tpu_torch.train.steps import loss_weight
from smsut_tpu_torch.train.steps.mean_teacher import (element_ids, mix32,
                                                      selected_shape)
from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

Params = Dict[str, torch.Tensor]

_M32 = 0xFFFFFFFF


def mask_grid(count: torch.Tensor, shape, seed: int,
              rows: Optional[Sequence[slice]] = None,
              hrows: Optional[slice] = None) -> torch.Tensor:
    """float32 Bernoulli(0.5) grid (the JAX model's ``mask_ratio``) of
    ``shape`` on the count's device, from a hash of (``seed``, ``count``,
    element): a function of the device count, no host value.  With
    ``rows`` (slices of the first axis) only those rows of that grid, to
    the bit, in turn, and with ``hrows`` (a slice of the second) only
    those rows of each image's grid: a space rank's."""
    key = mix32((count.to(torch.int64) * 0x2545F491
                 + seed * 0x9E3779B1 + 0x3C6EF372) & _M32)
    h = mix32(mix32(element_ids(shape, rows, count.device, hrows)) ^ key)
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return (u < 0.5).to(torch.float32).view(
        selected_shape(shape, rows, hrows))


def rgb(img: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 1] -> [B, H, W, 3], the channel repeated."""
    return torch.cat([img, img, img], dim=-1)


class M3L(SupervisedUNet):
    """The student ``LinearFusionMaskedConsistencyMixBatch(n_class)`` and
    its EMA teacher, on the card unless ``device`` names another."""

    space_maps = staticmethod(check_rows)

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
        self.check_state(state)
        cfg = self.cfg
        bs = inp["img"].shape[0]   # the rank's rows: batch_size / N
        img = rgb(torch.cat([inp["img"], inp["ul_img"]]))
        grid = inp.get("mask")
        if grid is None:
            # the rank's labelled and unlabelled rows of the global grid,
            # and under a space axis its rows of each image's grid
            n = bs * distributed.data_count()
            sl = distributed.local_batch_slice(n)
            shape = self.grid_shape(2 * n, img.shape[1]
                                    * distributed.space_count(),
                                    img.shape[2])
            grid = mask_grid(state.count, shape, cfg.seed,
                             [sl, slice(n + sl.start, n + sl.stop)],
                             mesh.space_slice(shape[1]))
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
        unmasked (the head's batch norm over this batch alone, also under
        a group, whose data ranks sweep different batches; under a space
        axis ``img`` is the rank's rows, and the statistics the space
        group's)."""
        mesh.check_shards(self.name, self.shapes, params)
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        with local_batch_stats():
            return torch.func.functional_call(self.net, params, (rgb(img),))

    def epoch_scalars(self, epoch: int) -> Dict[str, np.float32]:
        lam = self.lambda_semi * sigmoid_rampup(epoch, self.epoch_rampup)
        return {"lambda_semi": np.float32(lam)}
