# -*- coding: utf-8 -*-
"""Supervised U-Net algorithm: the serving half of
``smsut_tpu/train/steps/supervised.py`` ``SupervisedUNet``.

This slice ports what serving needs: ``init_params``, ``eval_params`` and
``eval_fn``.  The training step (Dice+CE loss, SGD with poly-LR, and the
backward kernels) comes with the training slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.device import resolve_device
from smsut_tpu_torch.models import UNet
from smsut_tpu_torch.train.steps import setup_compute

Params = Dict[str, torch.Tensor]


class SupervisedUNet:
    """``UNet(out_ch=n_class, width=base_width)``, instance norm, leaky
    ReLU, on the card unless ``device`` names another."""

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

    def eval_params(self, params: Params) -> Params:
        """The float32 parameters the eval forward runs with, on the
        algorithm's device."""
        return {k: v.detach().to(self.device, torch.float32)
                for k, v in params.items()}

    @torch.inference_mode()
    def eval_fn(self, params: Params,
                img: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """float32 seg logits [B, H, W, n_class] of NHWC ``img``."""
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        return torch.func.functional_call(self.net, params, (img,))
