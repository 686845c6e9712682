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

Under a process group (``parallel/``) a rank holds its contiguous rows of
both batches; every Dice+CE's batch Dice sums over the global batch
(``ops/losses.py``) and the gradients are averaged (``train/state.py``).
Under a model axis (``parallel/mesh.py`` ``make_mesh_2d``) both nets and
their momentum hold the rank's output-channel shards, each net's
gradients reduced with the state's shard keys.

With ``pack_levels`` the two nets run packed in ``pack_mode`` and, under
"hw" with ``pair_towers`` (None: on, the JAX rule), as one tower-paired
program (``models/unet.py`` ``UNetPair``); W-packed nets are never paired,
even with ``pair_towers=True`` (the JAX rule).  Under "hw"
``packed_loss_tails`` (None: on) keeps all four losses on the packed
logits; the W nets' logits are unpacked.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from smsut_tpu_torch.models.unet import UNetPair
from smsut_tpu_torch.ops.losses import (argmax_packed,
                                        dice_and_ce_loss_packed4)
from smsut_tpu_torch.ops.schedules import sigmoid_rampup
from smsut_tpu_torch.train.state import TrainState, make_sgd
from smsut_tpu_torch.train.steps import loss_weight
from smsut_tpu_torch.train.steps.supervised import SupervisedUNet


class CrossPseudo(SupervisedUNet):
    """Two ``UNet(n_class, base_width)``s, on the card unless ``device``
    names another."""

    rematerialises = False
    packed_tails = True

    name = "crossPse"
    uses_unlabeled = True
    lambda_semi = 0.1
    log_step = 50

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        pair = cfg.pair_towers
        # auto: paired wherever the nets run hw-packed; never under "w"
        self.pair = (self.pack_levels >= 1 and self.packing.mode == "hw"
                     and (pair is None or bool(pair)))
        # the paired program over both nets' parameters, "n1.<key>" and
        # "n2.<key>" (functional_call)
        self.pair_net = (UNetPair(self.net, self._build(seed=1)) if self.pair
                         else None)

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
        self.check_state(state)
        cfg = self.cfg
        bs = inp["img"].shape[0]   # the rank's rows: batch_size / N
        img = torch.cat([inp["img"], inp["ul_img"]])
        lam = loss_weight(scalars["lambda_semi"])
        leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
                  for p in (state.params, state.params2)]
        if self.pair:
            both = {f"n{i + 1}.{k}": v for i, p in enumerate(leaves)
                    for k, v in p.items()}
            out1, out2 = torch.func.functional_call(
                self.pair_net, both, (img,), {"packed_out": self.packed_out})
        else:
            out1, out2 = (self.train_logits(p, img) for p in leaves)
        sup1 = self.seg_loss(out1[:bs], inp["msk"])
        sup2 = self.seg_loss(out2[:bs], inp["msk"])
        if out1.shape[-1] != cfg.n_class:
            pred1 = argmax_packed(out1[bs:].detach())
            pred2 = argmax_packed(out2[bs:].detach())
            loss = lambda logits, labels: dice_and_ce_loss_packed4(
                logits, labels, cfg.weight_dc, cfg.weight_ce)
        else:
            pred1 = torch.argmax(out1[bs:].detach(), dim=-1)
            pred2 = torch.argmax(out2[bs:].detach(), dim=-1)
            loss = self.seg_loss
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
