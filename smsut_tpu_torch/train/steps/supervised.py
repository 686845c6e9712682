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
it as a CUDA graph (``train/graphs.py``).

With ``Config.pack_levels`` the U-Net runs its outer levels packed in
``Config.pack_mode``: "hw" on the space-to-depth grid
(``models/packed.py``), "w" W-only from ``pack_w0``
(``models/packed_w.py``); under "hw" ``packed_loss_tails`` (None: the JAX
step's rule, off here, on for Mean Teacher and CPS) hands the packed
logits to the packed losses (:meth:`SupervisedUNet.seg_loss`, which tells
them by their channels), while the W route's logits are unpacked, as in
the JAX package.  The eval forward returns unpacked logits either way.

Under a space axis (``Config.spatial_parallel``, ``parallel/mesh.py``) the
step takes the rank's rows of its data coordinate's images: the model's
layers meet their neighbours, the batch Dice sums over the whole group
and the CE's mean over equal shards is exact once the group averages the
gradients.  The zoo built on this class runs there too (Mean Teacher,
CPS, CoraNet, M3L), and under a model axis.

Under a model axis (``parallel/mesh.py`` ``make_mesh_2d``) the state is
sharded with ``shard_params_channelwise(mesh, state)``: ``functional_call``
runs the net on the rank's shards, whose layers gather their output
channels (``models/layers.py``), so the logits and the loss are whole and
the same on every model rank; a state any of whose trees (the student,
the EMA teacher, CPS's second net, the optimizer's) does not hold the
mesh's shards raises (:meth:`SupervisedUNet.check_state`).  The zoo's
steps run the same way: every tree of the state holds the same keys as
shards.  :meth:`train_step` is :meth:`inputs`, :meth:`step` and the host
step mirror advanced.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.device import resolve_device
from smsut_tpu_torch.models import UNet
from smsut_tpu_torch.ops.losses import (dice_and_ce_loss,
                                         dice_and_ce_loss_packed)
from smsut_tpu_torch.parallel import mesh
from smsut_tpu_torch.train.state import TrainState, make_sgd
from smsut_tpu_torch.train.steps import pack_levels, pool_fused, setup_compute

Params = Dict[str, torch.Tensor]


class SupervisedUNet:
    """``UNet(out_ch=n_class, width=base_width)``, instance norm, leaky
    ReLU, on the card unless ``device`` names another."""

    name = "unet"
    uses_unlabeled = False
    # the model's rule for its maps' rows under a space axis (mesh.
    # check_config); None: the U-Net's
    space_maps = None
    # whether Config.remat_unet rematerialises the U-Net's towers: this
    # algorithm's alone, as in the JAX package (the zoo's build theirs
    # without it)
    rematerialises = True
    # the JAX step's packed_loss_tails when the Config leaves it None
    packed_tails = False

    def __init__(self, cfg: Config,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = setup_compute(cfg)
        self.packing = pack_levels(cfg)
        self.pack_levels = self.packing.levels
        tails = cfg.packed_loss_tails
        # train forwards return hw-packed logits for the packed losses
        self.packed_out = (self.pack_levels > 0
                           and self.packing.mode == "hw" and (
                               self.packed_tails if tails is None
                               else bool(tails)))
        self.net = self._build(seed=0)
        # the parameters' whole shapes, which a sharded tree must match
        self.shapes = {k: tuple(v.shape)
                       for k, v in self.net.state_dict().items()}

    def _build(self, seed: int) -> UNet:
        cfg = self.cfg
        return UNet(cfg.n_class, cfg.base_width, cfg.img_channels, self.dtype,
                    block_fused=cfg.block_pallas, device=self.device,
                    seed=seed, remat=cfg.remat_unet and self.rematerialises,
                    pool_fused=pool_fused(cfg), **self.packing.model_kw())

    def train_logits(self, params: Params, img: torch.Tensor
                     ) -> torch.Tensor:
        """The net's logits of ``img`` for the train losses: packed
        [B, H/2, W/2, 4 n_class] under ``packed_out``."""
        return torch.func.functional_call(self.net, params, (img,),
                                          {"packed_out": self.packed_out})

    def seg_loss(self, logits: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        """Dice+CE (batch Dice) of unpacked or packed logits against the
        unpacked labels."""
        cfg = self.cfg
        if logits.shape[-1] != cfg.n_class:
            return dice_and_ce_loss_packed(logits, labels, cfg.weight_dc,
                                           cfg.weight_ce)
        return dice_and_ce_loss(logits, labels, cfg.weight_dc, cfg.weight_ce,
                                batch_dice=True)

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
        img = torch.as_tensor(batch["img"], dtype=torch.float32,
                              device=self.device)
        msk = torch.as_tensor(batch["msk"], device=self.device).long()
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = self.seg_loss(self.train_logits(leaves, img), msk)
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
        self.check_state(state)
        loss, grads = self.value_and_grad(state.params, inp)
        state.update(grads)
        return {"loss": loss}

    def check_state(self, state: TrainState) -> None:
        """Raise where a tree of ``state`` does not hold the model axis's
        shards of the parameters' whole shapes, its recorded keys
        (``mesh.check_shards``)."""
        for tree in state.trees():
            mesh.check_shards(self.name, self.shapes, tree, state.shards)

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
        mesh.check_shards(self.name, self.shapes, params)
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        return torch.func.functional_call(self.net, params, (img,))

    def eval_logits(self, state: TrainState,
                    img: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        """``eval_fn`` with the state's own parameters."""
        return self.eval_fn(state.params, img)

    def epoch_scalars(self, epoch: int) -> Dict[str, float]:
        """The per-epoch inputs of ``train_step``: none for this step."""
        return {}
