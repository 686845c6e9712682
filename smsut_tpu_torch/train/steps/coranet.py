# -*- coding: utf-8 -*-
"""CoraNet, conservative-radical three-head semi-supervision:
``smsut_tpu/train/steps/coranet.py`` ``CoraNet``.

The model is a U-Net with ``3 n_label + 1`` output channels: one shared
background logit and three heads of ``n_label`` channels (normal,
conservative, radical; ``ops/losses.py`` ``split_heads``).  The class
weights of the conservative and radical heads' CE are the chaos variant's
``[1, 5, 5, 5, 5]`` and ``[5, 1, 1, 1, 1]`` (a quirk of the reference's
configuration, kept).  Two stages:

- stage A (``stage="pre"``, ``pre_epoch`` epochs): ``(cedc + con + rad) /
  4`` on the labelled batch, SGD at the constant ``cfg.lr``, the EMA
  tracked; checkpoints ``pre_best``/``pre_last``;
- stage B (``stage="cora"``, ``cora_epoch`` epochs, from stage A's
  ``pre_best``: :meth:`CoraNet.load_pretrained`): every ``pred_step``
  epochs the pseudo-labels are made anew by a batch-1 augmented sweep over
  the unlabelled set (:meth:`CoraNet.pred_unlabel`: head 0's argmax, and
  the certainty mask where heads 1 and 2 agree); an iteration adds, from
  device count 1000 on, the certain term (masked CE + per-image Dice on
  the pseudo-labels, over 2) and 0.1 x the uncertain term (the masked
  softmax MSE against the EMA teacher over the three heads, over 3, times
  ``lambda_semi``) to the supervised loss; SGD under the poly LR over
  ``cora_epoch * num_iter_per_epoch`` iterations.  The two student applies
  (labelled batch, pseudo batch) stay separate, as the JAX step keeps
  them.

The gate and the EMA's alpha are read from the state's device count, so a
CUDA graph of the step replays them right.  The pseudo batch (``pse_img``,
``pse_lab``, ``pse_mask``) is drawn on the host by
:meth:`CoraNet.make_extra_batch` from its own ``random.Random(2020)`` and
is an input of the replayed iteration; that host draw pins
``steps_per_dispatch`` to 1, as in the JAX package.  The sweep reads the
Trainer's ``pseudo_sweep_rng`` (its loader order and augmentation draws,
both in the loader's producer thread) and runs its forwards as replays of
one graph (train/graphs.py).  Under a process group every rank sweeps the
global unlabelled stream (its loader is not sharded) and makes the same
pseudo set, draws the same global pseudo batch and keeps its contiguous
rows, as the JAX package does on a multi-host run; the masked means and
the class-weighted CE sum over the global batch (ops/losses.py), each
pixel once.  Under a space axis the sweep's forwards run on the rank's
rows of each chunk and gather the pseudo-labels and agreement masks
whole (``mesh.space_gather``), so that every rank holds the one
process's pseudo set, and each rank keeps its rows of the pseudo batch's
images (:meth:`CoraNet.host_inputs`).  Under a model axis
(``parallel/mesh.py`` ``make_mesh_2d``) the student and the EMA run on
the rank's output-channel shards; every model rank of a data coordinate
sweeps the same stream with its shards, whose layers gather whole
logits, so it makes the same pseudo set and keeps the same rows of each
pseudo batch.
"""
from __future__ import annotations

import os
import random
from typing import Dict, Iterable, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.models import UNet
from smsut_tpu_torch.ops.losses import (coranet_weights, masked_certain_loss,
                                        masked_head_mse, split_heads,
                                        three_head_losses)
from smsut_tpu_torch.ops.metrics import dice_coefficient
from smsut_tpu_torch.ops.schedules import (ema_alpha, gate, poly_lr_host,
                                           sigmoid_rampup)
from smsut_tpu_torch.parallel import distributed, mesh
from smsut_tpu_torch.train.graphs import Replay
from smsut_tpu_torch.train.state import (TrainState, make_constant_sgd,
                                         make_sgd)
from smsut_tpu_torch.train.steps import loss_weight, pool_fused
from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

Params = Dict[str, torch.Tensor]


class CoraNet(SupervisedUNet):
    """``UNet(3 n_label + 1, base_width)`` and its EMA, on the card unless
    ``device`` names another; ``stage`` is ``"pre"`` (A) or ``"cora"``
    (B)."""

    name = "coraNet"
    # the step reads no unlabelled batch (the sweep has its own loader)
    uses_unlabeled = False
    lambda_semi = 1.0
    ema_decay = 0.99
    epoch_rampup = 30
    log_step = 50
    gate_step = 1000

    def __init__(self, cfg: Config,
                 device: Optional[Union[str, torch.device]] = None,
                 stage: str = "pre"):
        if stage not in ("pre", "cora"):
            raise ValueError(f"stage {stage!r} is not 'pre' or 'cora'")
        self.stage = stage
        self._pseudo: Optional[Dict[str, np.ndarray]] = None
        self._pseudo_order: List[int] = []
        self._pseudo_rng = random.Random(2020)
        self._infer_replay: Optional[Replay] = None
        self._infer_params: Optional[Params] = None
        super().__init__(cfg, device)
        self.w_con, self.w_rad = coranet_weights(cfg.n_label, self.device)

    def _build(self, seed: int) -> UNet:
        cfg = self.cfg
        return UNet(cfg.n_label * 3 + 1, cfg.base_width, cfg.img_channels,
                    self.dtype, block_fused=cfg.block_pallas,
                    device=self.device, seed=seed,
                    pool_fused=pool_fused(cfg), **self.packing.model_kw())

    # ---------------------------------------------------------- schedules
    @property
    def max_epoch(self) -> int:
        return self.cfg.pre_epoch if self.stage == "pre" else \
            self.cfg.cora_epoch

    @property
    def cora_iters(self) -> int:
        return self.cfg.cora_epoch * self.cfg.num_iter_per_epoch

    def lr_at(self, step: int) -> float:
        """The LR the optimizer took at host step ``step``: constant in
        stage A, the poly over stage B's iterations there."""
        if self.stage == "pre":
            return self.cfg.lr
        return poly_lr_host(self.cfg.lr, step, self.cora_iters)

    def make_tx(self):
        if self.stage == "pre":
            return make_constant_sgd(self.cfg)
        return make_sgd(self.cfg, total_iters=self.cora_iters)

    @property
    def best_prefix(self) -> str:
        return "pre_best" if self.stage == "pre" else "best"

    @property
    def last_prefix(self) -> str:
        return "pre_last" if self.stage == "pre" else "last"

    # -------------------------------------------------------------- state
    def state_from_params(self, params: Mapping[str, torch.Tensor],
                          ema_params: Optional[Mapping] = None
                          ) -> TrainState:
        """A fresh train state (step 0, zero momentum, the stage's
        optimizer) holding float32 copies of ``params`` and of
        ``ema_params`` (a copy of ``params`` unless given)."""
        return TrainState.create(
            self.eval_params(params), self.make_tx(),
            ema_params=self.eval_params(
                params if ema_params is None else ema_params))

    def load_pretrained(self, trainer, model_idx: str) -> None:
        """Stage B's start: the parameters and the EMA of stage A's
        ``pre_best`` of run ``model_idx``, copied into the Trainer's fresh
        state (optimizer and count untouched)."""
        from smsut_tpu_torch.train import checkpoints

        ckpt_root = os.path.join(trainer.exp.expr_root, model_idx, "ckpt")
        raw = checkpoints.load_raw(ckpt_root, "pre_best")
        st = trainer.state
        for name in ("params", "ema_params"):
            tree = getattr(st, name)
            if raw[name].keys() != tree.keys():
                raise KeyError(f"{name}: pre_best's keys differ from the "
                               f"state's")
            with torch.no_grad():
                for k, t in tree.items():
                    t.copy_(raw[name][k])
        trainer.info(f"Load pre_best params+EMA from {ckpt_root}.")

    # ------------------------------------------------------------- inputs
    def inputs(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """:meth:`step`'s tensors of ``batch = {"img", "msk"}`` (and in
        stage B the pseudo batch's ``pse_img``, ``pse_lab``, ``pse_mask``)
        on the device."""
        inp = super().inputs(batch)
        inp.update({k: v.to(self.device)
                    for k, v in self.host_inputs(batch).items()})
        return inp

    def host_inputs(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """The pseudo batch of ``batch`` (whole images, as
        :meth:`make_extra_batch` draws them) as CPU tensors, under a
        space axis the rank's rows of each (none in stage A): ``pse_img``
        float32 [B,H,W,1], ``pse_lab`` int64 [B,H,W] and ``pse_mask``
        float32 [B,H,W]."""
        if "pse_img" not in batch:
            return {}
        rows = lambda t: mesh.space_rows(t).contiguous()
        return {"pse_img": rows(torch.as_tensor(batch["pse_img"],
                                                dtype=torch.float32)),
                "pse_lab": rows(torch.as_tensor(batch["pse_lab"]).long()),
                "pse_mask": rows(torch.as_tensor(batch["pse_mask"],
                                                 dtype=torch.float32))}

    # --------------------------------------------------------------- step
    def _apply(self, params: Params, img: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.net, params, (img,))

    def _supervised(self, params: Params, img: torch.Tensor,
                    msk: torch.Tensor):
        cfg = self.cfg
        cedc, con, rad = three_head_losses(
            self._apply(params, img), msk, self.w_con, self.w_rad,
            cfg.n_label, cfg.weight_dc, cfg.weight_ce)
        return (cedc + con + rad) / 4.0, (cedc, con, rad)

    def _update(self, state: TrainState, total: torch.Tensor,
                leaves: Params) -> None:
        """SGD at the device count, the count advanced, then the EMA at
        the alpha of the count before the update."""
        grads = torch.autograd.grad(total, list(leaves.values()))
        state.update(dict(zip(leaves, grads)))
        state.ema_update_(ema_alpha(state.count - 1, self.ema_decay))

    def _pre_step(self, state: TrainState, inp: Mapping
                  ) -> Dict[str, torch.Tensor]:
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        total, (cedc, con, rad) = self._supervised(leaves, inp["img"],
                                                   inp["msk"])
        self._update(state, total, leaves)
        return {"loss": total, "cedc_loss": cedc, "loss_con": con,
                "loss_rad": rad}

    def _cora_step(self, state: TrainState, inp: Mapping, scalars: Mapping
                   ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        on = gate(state.count, self.gate_step)
        mask = inp["pse_mask"]
        with torch.no_grad():
            teacher = self._apply(state.ema_params, inp["pse_img"])
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        supervised, _ = self._supervised(leaves, inp["img"], inp["msk"])
        out_p = self._apply(leaves, inp["pse_img"])
        certain = masked_certain_loss(split_heads(out_p, cfg.n_label)[0],
                                      inp["pse_lab"], mask)
        uncertain = loss_weight(scalars["lambda_semi"]) * masked_head_mse(
            out_p, teacher, cfg.n_label, 1.0 - mask)
        total = supervised + on * certain + on * uncertain * 0.1
        self._update(state, total, leaves)
        return {"loss": total, "supervised_loss": supervised,
                "certain_loss": on * certain,
                "uncertain_loss": on * uncertain}

    def step(self, state: TrainState, inp: Mapping[str, torch.Tensor],
             scalars: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
        """The stage's iteration on the device (the count advanced, not
        the host ``step``); stage B reads ``scalars["lambda_semi"]``, a
        number or a 0-d device tensor."""
        self.check_state(state)
        if self.stage == "pre":
            out = self._pre_step(state, inp)
        else:
            out = self._cora_step(state, inp, scalars)
        return {k: v.detach() for k, v in out.items()}

    def epoch_scalars(self, epoch: int) -> Dict[str, np.float32]:
        lam = self.lambda_semi * sigmoid_rampup(epoch, self.epoch_rampup)
        return {"lambda_semi": np.float32(lam)}

    # ------------------------------------------------------------- eval
    @torch.inference_mode()
    def eval_fn(self, params: Params, img) -> torch.Tensor:
        """float32 head-0 logits [B, H, W, n_class] of NHWC ``img``."""
        mesh.check_shards(self.name, self.shapes, params)
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        return split_heads(self._apply(params, img), self.cfg.n_label)[0]

    # ------------------------------------------------------ pseudo labels
    @torch.inference_mode()
    def _infer(self, inp: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """Head 0's argmax and where heads 1 and 2 agree, int64
        [B, H, W], of the graph's parameter buffers."""
        h0, h1, h2 = split_heads(self._apply(self._infer_params, inp["img"]),
                                 self.cfg.n_label)
        return {"plab": torch.argmax(h0, dim=-1),
                "agree": (torch.argmax(h1, dim=-1)
                          == torch.argmax(h2, dim=-1)).long()}

    def pred_unlabel(self, state: TrainState,
                     samples: Iterable[Tuple[object, object, int]],
                     capture: bool = True
                     ) -> Tuple[Dict[str, np.ndarray], float]:
        """Pseudo-labels of a stream of ``(img [H,W,1], lab [H,W], mdl)``
        samples (arrays or device tensors), in ``batch_size`` chunks, the
        last padded with copies of its last image, each chunk one replay
        of the inference graph on the card (``capture=False``: eager).
        Returns the host arrays ``img`` float32 [N,H,W,1], ``plab``,
        ``mask`` (1 where heads 1 and 2 agree), ``lab`` and ``mdl``, and
        the mean pseudo-label Dice (foreground against foreground; 0 for a
        sample where both are empty)."""
        bs = self.cfg.batch_size
        fresh = self.eval_params(state)
        if self._infer_replay is None:
            self._infer_params = fresh
            self._infer_replay = Replay(self._infer, self.device, capture)
        else:   # the graph reads these buffers
            torch._foreach_copy_(list(self._infer_params.values()),
                                 [fresh[k] for k in self._infer_params])
        dev = lambda a: torch.as_tensor(a, device=self.device)
        imgs, labs, mdls, plabs, masks, buf = [], [], [], [], [], []

        def flush():
            n = len(buf)
            x = torch.stack(buf + buf[-1:] * (bs - n)).float()
            # under a space axis the forward of the rank's rows, whole
            # again: every rank of the group holds the one pseudo set
            out = self._infer_replay({"img": mesh.space_rows(x).contiguous()})
            imgs.append(x[:n])
            plabs.append(mesh.space_gather(out["plab"])[:n].clone())
            masks.append(mesh.space_gather(out["agree"])[:n].clone())
            buf.clear()

        for img, lab, mdl in samples:
            buf.append(dev(img))
            labs.append(dev(lab))
            mdls.append(int(mdl))
            if len(buf) == bs:
                flush()
        if buf:
            flush()
        if not labs:
            raise ValueError("the unlabelled stream is empty")
        data = {"img": torch.cat(imgs).cpu().numpy(),
                "plab": torch.cat(plabs).cpu().numpy(),
                "mask": torch.cat(masks).cpu().numpy(),
                "lab": torch.stack(labs).long().cpu().numpy(),
                "mdl": np.asarray(mdls, np.int64)}
        dice = float(np.mean([
            dice_coefficient(p > 0, l > 0) if (p > 0).any() or (l > 0).any()
            else 0.0 for p, l in zip(data["plab"], data["lab"])]))
        return data, dice

    def _sweep_loader(self, trainer):
        """(loader, device augmentation or None) of one in-turn batch-1
        pass over the unlabelled set with the training augmentation, drawn
        from ``trainer.pseudo_sweep_rng``: the loader's order and, with
        ``device_augment``, the warp's parameters in the loader's producer
        thread (one thread, so the draws keep their order)."""
        from smsut_tpu_torch.data.dataset import get_loader
        from smsut_tpu_torch.data.device_augment import DeviceAugment

        cfg = self.cfg
        rng = trainer.pseudo_sweep_rng
        raw = bool(cfg.device_augment)
        # one pass over the global stream on every rank: not sharded
        loader = get_loader(cfg.base_root, "val", trainer.fold, 1,
                            cfg.data_aug, cfg=cfg, rng=rng, raw=raw,
                            num_shards=1, shard_id=0)
        if not raw:
            return loader, None
        da = DeviceAugment(cfg, rng, self.device)
        loader.post = lambda b: (b, da.sample_params_packed(
            b.batch_size, *b.img.shape[1:3]))
        return loader, da

    def _unlabeled_stream(self, trainer):
        """The sweep's samples (:meth:`_sweep_loader`), the warp run on
        the device."""
        loader, da = self._sweep_loader(trainer)
        if da is None:
            for b in loader:
                yield b.img[0], b.msk[0], int(b.mdl[0])
            return
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        for b, params in loader:
            img, msk = da.apply(dev(b.img), dev(b.msk), dev(params))
            yield img[0], msk[0], int(b.mdl[0])

    def _skip_epochs(self, trainer, epochs: int) -> None:
        """A resumed stage-B run: the draws of the ``epochs`` done (each
        sweep's loader order and augmentation, each pseudo batch's
        indices), made again without the sweeps' warps and forwards."""
        n = 0
        for epoch in range(epochs):
            if epoch % self.cfg.pred_step == 0:
                n = sum(1 for _ in self._sweep_loader(trainer)[0])
                self._pseudo_order = []
            for _ in range(self.cfg.num_iter_per_epoch):
                self._pseudo_indices(n)

    def on_epoch_start(self, trainer, epoch: int) -> None:
        """Stage B: the pseudo-labels made anew every ``pred_step`` epochs
        (and at a run's first epoch), their Dice logged.  A run resumed at
        epoch ``e`` first skips the draws of the epochs done, so that
        where ``pred_step`` divides ``e`` it goes on with the
        uninterrupted run's pseudo-labels and batches; elsewhere it makes
        its pseudo-labels from the resumed state, as the JAX package's
        resumed run does (the checkpoint holds no pseudo-labels)."""
        if self.stage != "cora":
            return
        if self._pseudo is None and epoch:
            self._skip_epochs(trainer, epoch)
        if epoch % self.cfg.pred_step == 0 or self._pseudo is None:
            self._pseudo, plab_dice = self.pred_unlabel(
                trainer.state, self._unlabeled_stream(trainer),
                trainer.capture)
            self._pseudo_order = []
            trainer.info(f"Pseudo label dice : {plab_dice}")
            trainer.exp.scalar("acc/plab_dice", plab_dice, epoch)

    def make_extra_batch(self) -> Dict[str, np.ndarray]:
        """Stage B: the next pseudo batch, the reference's in-memory loader
        with shuffle and drop-last (a fresh shuffle of every index when
        fewer than ``batch_size`` are left); nothing in stage A."""
        if self.stage != "cora":
            return {}
        idx = self._pseudo_indices(self._pseudo["img"].shape[0])
        return {"pse_img": self._pseudo["img"][idx],
                "pse_lab": self._pseudo["plab"][idx],
                "pse_mask": self._pseudo["mask"][idx]}

    def _pseudo_indices(self, n: int) -> List[int]:
        """The next pseudo batch's indices into ``n`` pseudo samples: the
        rank's contiguous rows of the global batch's."""
        bs = self.cfg.batch_size
        if len(self._pseudo_order) < bs:
            self._pseudo_order = list(range(n))
            self._pseudo_rng.shuffle(self._pseudo_order)
        idx = [self._pseudo_order.pop() for _ in range(bs)]
        return idx[distributed.local_batch_slice(bs)]
