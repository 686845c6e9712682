# -*- coding: utf-8 -*-
"""Cross-pseudo supervision (CPS):
``smsut_tpu/train/steps/cross_pseudo.py`` ``CrossPseudo``.

Two U-Nets of independent inits (``params``, ``params2``) see the labelled
and unlabelled batches at once (16 images each at batch 8).  Each is
supervised (Dice+CE) on the labelled half and trained against the other's
detached argmax on the unlabelled half (Dice+CE), weighted by
``lambda_semi = 0.1 * sigmoid_rampup(epoch, max_epoch)``; both SGD updates
run at the one shared device count, which advances once per iteration.
The eval forward serves net 1.

``pair_towers`` (the JAX package's tower pairing of the two nets) is a TPU
layout knob and does nothing here (config.py).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from smsut_tpu_torch.ops.losses import dice_and_ce_loss
from smsut_tpu_torch.ops.schedules import sigmoid_rampup
from smsut_tpu_torch.train.state import TrainState, make_sgd
from smsut_tpu_torch.train.steps import loss_weight
from smsut_tpu_torch.train.steps.supervised import SupervisedUNet


class CrossPseudo(SupervisedUNet):
    """Two ``UNet(n_class, base_width)``s, on the card unless ``device``
    names another."""

    name = "crossPse"
    uses_unlabeled = True
    lambda_semi = 0.1
    log_step = 50

    def init_state(self, seed: int) -> TrainState:
        """Net 1 drawn from ``seed``, net 2 from ``seed + 1``; zero
        momentum, step 0."""
        return self.state_from_params(self.init_params(seed),
                                      self.init_params(seed + 1))

    def state_from_params(self, params: Mapping[str, torch.Tensor],
                          params2: Optional[Mapping] = None) -> TrainState:
        """A fresh train state (step 0, zero momentum for both nets)
        holding float32 copies of both nets' parameters."""
        if params2 is None:
            raise ValueError("cross-pseudo supervision needs both nets' "
                             "parameters")
        return TrainState.create(self.eval_params(params), make_sgd(self.cfg),
                                 params2=self.eval_params(params2))

    def inputs(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """:meth:`step`'s tensors of ``batch = {"img", "msk", "ul_img"}``
        on the device."""
        inp = super().inputs(batch)
        inp["ul_img"] = torch.as_tensor(batch["ul_img"], dtype=torch.float32,
                                        device=self.device)
        return inp

    def step(self, state: TrainState, inp: Mapping[str, torch.Tensor],
             scalars: Mapping) -> Dict[str, torch.Tensor]:
        """The iteration on the device: both nets' forwards on the 2B
        images, the four losses, one backward, both SGD updates at the
        device count, the count advanced once.  ``scalars["lambda_semi"]``:
        a number or a 0-d device tensor."""
        cfg = self.cfg
        bs = cfg.batch_size
        img = torch.cat([inp["img"], inp["ul_img"]])
        lam = loss_weight(scalars["lambda_semi"])
        leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                  for p in (state.params, state.params2)]
        out1, out2 = (torch.func.functional_call(self.net, p, (img,))
                      for p in leaves)
        loss = lambda logits, labels: dice_and_ce_loss(
            logits, labels, cfg.weight_dc, cfg.weight_ce, batch_dice=True)
        sup1, sup2 = loss(out1[:bs], inp["msk"]), loss(out2[:bs], inp["msk"])
        pred1 = torch.argmax(out1[bs:].detach(), dim=-1)
        pred2 = torch.argmax(out2[bs:].detach(), dim=-1)
        semi1, semi2 = loss(out1[bs:], pred2), loss(out2[bs:], pred1)
        total = sup1 + sup2 + lam * semi1 + lam * semi2
        flat = list(leaves[0].values()) + list(leaves[1].values())
        grads = torch.autograd.grad(total, flat)
        n = len(leaves[0])
        state.update(dict(zip(leaves[0], grads[:n])),
                     dict(zip(leaves[1], grads[n:])))
        return {k: v.detach() for k, v in (
            ("loss", sup1), ("loss2", sup2), ("crossPse1_loss", semi1),
            ("crossPse2_loss", semi2))}

    def epoch_scalars(self, epoch: int) -> Dict[str, np.float32]:
        lam = self.lambda_semi * sigmoid_rampup(epoch, self.cfg.max_epoch)
        return {"lambda_semi": np.float32(lam)}
