# -*- coding: utf-8 -*-
"""Supervised U-Net algorithm: ``smsut_tpu/train/steps/supervised.py``
``SupervisedUNet``.

One training iteration is forward, Dice+CE loss, backward and the SGD +
poly-LR update.  On the card the backward runs the backward kernels: K4
for every instance norm, K2 (dx) and K5 (dw) for every 3x3 conv, or K6 for
every residual block with ``block_pallas``.  The eval forward serves
(``serve.py``).

:meth:`SupervisedUNet.step` is the iteration's device part alone: it reads
its tensors and the state's, and updates the state in place, with the LR
read on the device at the state's device count, so the fit loop replays
it as a CUDA graph (``train/graphs.py``).  :meth:`train_step` is
:meth:`inputs`, :meth:`step` and the host step mirror advanced.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.device import resolve_device
from smsut_tpu_torch.models import UNet
from smsut_tpu_torch.ops.losses import dice_and_ce_loss
from smsut_tpu_torch.train.state import TrainState, make_sgd
from smsut_tpu_torch.train.steps import setup_compute

Params = Dict[str, torch.Tensor]


class SupervisedUNet:
    """``UNet(out_ch=n_class, width=base_width)``, instance norm, leaky
    ReLU, on the card unless ``device`` names another."""

    name = "unet"
    uses_unlabeled = False

    def __init__(self, cfg: Config,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = setup_compute(cfg)
        self.net = self._build(seed=0)

    def _build(self, seed: int) -> UNet:
        cfg = self.cfg
        return UNet(cfg.n_class, cfg.base_width, cfg.img_channels, self.dtype,
                    block_fused=cfg.block_pallas, device=self.device,
                    seed=seed)

    def init_params(self, seed: int) -> Params:
        """Freshly initialised parameters, drawn from ``seed``."""
        return {k: v.detach() for k, v in self._build(seed).state_dict().items()}

    def init_state(self, seed: int) -> TrainState:
        """Parameters drawn from ``seed``, zero momentum, step 0."""
        return self.state_from_params(self.init_params(seed))

    def state_from_params(self, params: Mapping[str, torch.Tensor]
                          ) -> TrainState:
        """A fresh train state (step 0, zero momentum) holding float32
        copies of ``params`` on the algorithm's device."""
        return TrainState.create(self.eval_params(params), make_sgd(self.cfg))

    def value_and_grad(self, params: Params, batch: Mapping
                       ) -> Tuple[torch.Tensor, Params]:
        """Dice+CE loss (batch dice) of ``batch = {"img", "msk"}`` and its
        gradient with respect to every parameter."""
        cfg = self.cfg
        img = torch.as_tensor(batch["img"], dtype=torch.float32,
                              device=self.device)
        msk = torch.as_tensor(batch["msk"], device=self.device).long()
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        logits = torch.func.functional_call(self.net, leaves, (img,))
        loss = dice_and_ce_loss(logits, msk, cfg.weight_dc, cfg.weight_ce,
                                batch_dice=True)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def inputs(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """:meth:`step`'s tensors of ``batch = {"img", "msk"}`` on the
        device: ``img`` float32 [B,H,W,1], ``msk`` int64 [B,H,W]."""
        return {"img": torch.as_tensor(batch["img"], dtype=torch.float32,
                                       device=self.device),
                "msk": torch.as_tensor(batch["msk"],
                                       device=self.device).long()}

    def step(self, state: TrainState, inp: Mapping[str, torch.Tensor],
             scalars: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
        """The iteration on the device: Dice+CE loss, gradients, SGD at the
        state's device count, the count advanced (not the host ``step``).
        ``scalars`` is unused here, as in the JAX step."""
        loss, grads = self.value_and_grad(state.params, inp)
        state.update(grads)
        return {"loss": loss}

    def train_step(self, state: TrainState, batch: Mapping,
                   scalars: Optional[Mapping] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One iteration: :meth:`inputs`, :meth:`step` (with ``scalars``,
        :meth:`epoch_scalars`), the host step advanced.  The state passed
        in is consumed (updated in place)."""
        metrics = self.step(state, self.inputs(batch), scalars)
        state.step += 1
        return state, metrics

    def eval_params(self, state: Union[TrainState, Mapping[str, torch.Tensor]]
                    ) -> Params:
        """The float32 parameters the eval forward runs with, on the
        algorithm's device, from a train state or a parameter mapping."""
        params = state.params if isinstance(state, TrainState) else state
        return {k: v.detach().to(self.device, torch.float32, copy=True)
                for k, v in params.items()}

    @torch.inference_mode()
    def eval_fn(self, params: Params,
                img: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """float32 seg logits [B, H, W, n_class] of NHWC ``img``."""
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        return torch.func.functional_call(self.net, params, (img,))

    def eval_logits(self, state: TrainState,
                    img: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """``eval_fn`` with the state's own parameters."""
        return self.eval_fn(state.params, img)

    def epoch_scalars(self, epoch: int) -> Dict[str, float]:
        """The per-epoch inputs of ``train_step``: none for this step."""
        return {}
