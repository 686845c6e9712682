# -*- coding: utf-8 -*-
"""The UGAN family: a StarGAN-style translation GAN + supervised
segmentation; ``uganConsis`` is the paper's method (SMSUT).

Port of ``smsut_tpu/train/steps/gan.py`` (its unpacked path).  One
iteration is:

1. the translation ``x_fake0`` of the real batch to a target modality,
   without gradients;
2. the D step: one batched D apply on real + fake, the WGAN-GP term on
   ``x_hat = alpha x_real + (1 - alpha) x_fake0`` (alpha drawn from a
   normal, the reference's quirk, kept) through
   ``torch.autograd.grad(..., create_graph=True)``, then the gradient of
   the D loss with respect to the D parameters (the GP's double backward
   runs K2/K5 and K1/K4 on the card: ``ops/conv3x3.py``,
   ``ops/instnorm.py``), then Adam;
3. the G step against the updated D: the translate pass, the
   reconstruct pass, the adversarial, class, L1, Dice+CE and, per
   variant, shape, consistency (gated at ``consis_gate_step``, weighted
   by ``lambda_semi``) and PatchNCE losses, then SGD.

The random draws (target modality ``mj``, the GP's ``alpha``, the
PatchNCE ``patch_ids``) are inputs of the step, in the batch:
:meth:`UGANBase.make_extra_batch` draws them from the algorithm's own CPU
``torch.Generator`` (seeded from ``cfg.seed``), so a test can feed it the
JAX package's draws instead.  Nothing in the step waits on the card: the
modality vectors and labels are built on the host from ``mdl`` and ``mj``
(:meth:`UGANBase.host_inputs`) and copied from pinned memory.

:meth:`UGANBase.step` is the iteration's device part alone, so the fit loop
replays it as a CUDA graph (``train/graphs.py``): the consistency gate is
taken from the state's device step count, ``lambda_semi`` and
``lambda_shp`` may be device tensors that the loop sets per epoch, the LRs
and Adam's bias corrections are read on the device (train/state.py), and
the step advances the device count; the host ``step`` is the caller's.

``d_concat_hat``, ``packed_loss_tails`` and ``remat`` are accepted and do
nothing (config.py).
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.device import resolve_device
from smsut_tpu_torch.models.ugan import (UGAN, Discriminator, UGANnce,
                                         sample_patch_ids)
from smsut_tpu_torch.ops.losses import (argmax_consistency_loss,
                                        dice_and_ce_loss, l1_loss,
                                        nce_loss_over_layers,
                                        softmax_ce_with_logits)
from smsut_tpu_torch.ops.schedules import sigmoid_rampup
from smsut_tpu_torch.train.state import GANTrainState
from smsut_tpu_torch.train.steps import loss_weight, setup_compute
from smsut_tpu_torch.utils.io import imwrite_gray

Params = Dict[str, torch.Tensor]


def label2onehot(mdl, n_modal: int) -> np.ndarray:
    """float32 one-hot rows of the host labels ``mdl``."""
    return np.eye(n_modal, dtype=np.float32)[np.asarray(mdl)]


def _grads(loss: torch.Tensor, leaves: Params) -> Params:
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


class UGANBase:
    """Shared machinery of the three variants, on the card unless
    ``device`` names another."""

    variant = "ugan"
    uses_unlabeled = False
    lambda_cls = 1.0
    lambda_rec = 10.0
    lambda_gp = 10.0
    lambda_seg = 10.0
    lambda_shp = 10.0
    lambda_shp_lazy = 20.0
    lambda_semi = 10.0
    n_critic = 1
    log_step = 50
    beta1 = 0.9
    beta2 = 0.999

    def __init__(self, cfg: Config,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = setup_compute(cfg)
        self.with_nce = self.variant in ("uganShp0", "uganConsis")
        # the fixed batch of the per-epoch translation grid (host arrays)
        self._fixed: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._draws = torch.Generator().manual_seed(cfg.seed)
        # the bottleneck's positions for patch sampling, (input / 2^4)^2
        self.bottleneck_hw = (cfg.input_size // 16) ** 2
        self.net, self.D = self._build(seed=0)

    def _build(self, seed: int):
        cfg = self.cfg
        kw = dict(compute_dtype=self.dtype, device=self.device)
        if self.with_nce:
            net = UGANnce(cfg.n_class, cfg.n_modal, cfg.base_width,
                          cfg.netF_nc, cfg.img_channels,
                          block_fused=cfg.block_pallas, seed=seed, **kw)
        else:
            net = UGAN(cfg.n_class, cfg.n_modal, cfg.base_width,
                       cfg.img_channels, block_fused=cfg.block_pallas,
                       seed=seed, **kw)
        d = Discriminator(cfg.input_size, cfg.n_modal, cfg.base_width,
                          256 if cfg.base_width == 16 else 512,
                          cfg.img_channels, seed=seed + 1, **kw)
        return net, d

    # ---------------------------------------------------------------- state
    def init_state(self, seed: int) -> GANTrainState:
        """G and D drawn from ``seed``, zero optimizer state, step 0."""
        net, d = self._build(seed)
        return self.state_from_params(net.state_dict(), d.state_dict())

    def state_from_params(self, g_params: Mapping[str, torch.Tensor],
                          d_params: Mapping[str, torch.Tensor]
                          ) -> GANTrainState:
        """A fresh train state holding float32 copies of the parameters on
        the algorithm's device."""
        return GANTrainState.create(self.eval_params(g_params),
                                    self.eval_params(d_params), self.cfg,
                                    self.beta1, self.beta2)

    @property
    def total_batch(self) -> int:
        return self.cfg.batch_size * (2 if self.uses_unlabeled else 1)

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        """A small host array on the device, copied from pinned memory so
        that the host does not wait."""
        t = torch.as_tensor(a if isinstance(a, torch.Tensor)
                            else np.array(a), dtype=dtype)
        if t.device.type == "cpu" and self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _draw(self) -> Tuple[int, torch.Tensor, torch.Tensor]:
        g = self._draws
        mj = int(torch.randint(self.cfg.n_modal, (1,), generator=g))
        alpha = torch.randn((self.total_batch, 1, 1, 1), generator=g)
        return mj, alpha, sample_patch_ids(g, self.bottleneck_hw,
                                           self.cfg.nce_patches)

    def make_extra_batch(self) -> Dict[str, object]:
        """The step's random draws from the algorithm's generator, on the
        host: the target modality ``mj`` (an int), the GP's ``alpha``
        [n,1,1,1] from a normal, and ``patch_ids`` [nce_patches]."""
        mj, alpha, ids = self._draw()
        return {"mj": mj, "alpha": alpha, "patch_ids": ids}

    def skip_draws(self, n: int) -> None:
        """Advance the generator past ``n`` steps' draws (a resumed run
        takes the draws the uninterrupted run would)."""
        for _ in range(n):
            self._draw()

    # ------------------------------------------------------------- forwards
    def _g_forward(self, params: Params, x: torch.Tensor, m: torch.Tensor,
                   patch_ids: Optional[torch.Tensor]):
        """(seg, tsl, feature pool or None); no pool with ``patch_ids``
        None."""
        if self.with_nce and patch_ids is not None:
            return torch.func.functional_call(self.net, params,
                                              (x, m, patch_ids))
        args = (x, m, None, True) if self.with_nce else (x, m)
        seg, tsl = torch.func.functional_call(self.net, params, args)
        return seg, tsl, None

    def _d(self, params: Params, x: torch.Tensor):
        return torch.func.functional_call(self.D, params, (x,))

    # ------------------------------------------------------------ the step
    def d_loss(self, d_params: Params, x_real: torch.Tensor,
               x_fake: torch.Tensor, alpha: torch.Tensor,
               mdl: torch.Tensor):
        """The D loss, differentiable in ``d_params``: (total, (D_real,
        D_fake, D_cls, D_gp), dydx).  Real and fake go through one D apply;
        the GP's ``dydx`` is the gradient of D's patch output at
        ``x_hat = alpha x_real + (1 - alpha) x_fake`` taken with
        ``create_graph=True``, so the total's gradient carries the
        grad-of-grad."""
        n = x_real.shape[0]
        x_hat = (alpha * x_real + (1.0 - alpha) * x_fake).requires_grad_()
        src_cat, cls_cat = self._d(d_params, torch.cat([x_real, x_fake]))
        src_h, _ = self._d(d_params, x_hat)
        dydx, = torch.autograd.grad(src_h.sum(), x_hat, create_graph=True)
        d_real = -src_cat[:n].mean()
        d_fake = src_cat[n:].mean()
        d_cls = softmax_ce_with_logits(cls_cat[:n], mdl)
        norms = dydx.reshape(n, -1).square().sum(dim=1).sqrt()
        d_gp = (norms - 1.0).square().mean()
        total = (d_real + d_fake + self.lambda_cls * d_cls
                 + self.lambda_gp * d_gp)
        return total, (d_real, d_fake, d_cls, d_gp), dydx

    def host_inputs(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """The step's small inputs as CPU tensors, built on the host from
        ``batch``'s ``mdl`` (with ``uses_unlabeled`` and ``ul_mdl``) and
        the draws ``mj``, ``alpha`` and ``patch_ids``
        (:meth:`make_extra_batch`): the modality vectors ``vec_ot`` and
        ``vec_to``, the labels ``mdl`` and ``modal_trg``, ``alpha``
        [n,1,1,1] and, for the PatchNCE variants, ``patch_ids``."""
        cfg = self.cfg
        mdl = np.asarray(batch["mdl"])
        if self.uses_unlabeled:
            mdl = np.concatenate([mdl, np.asarray(batch["ul_mdl"])])
        n = mdl.shape[0]
        mj = int(batch["mj"])
        vec_org = label2onehot(mdl, cfg.n_modal)
        vec_trg = label2onehot(np.full(n, mj), cfg.n_modal)
        out = {"vec_ot": torch.from_numpy(vec_trg - vec_org),
               "vec_to": torch.from_numpy(vec_org - vec_trg),
               "mdl": torch.from_numpy(mdl.astype(np.int64)),
               "modal_trg": torch.full((n,), mj, dtype=torch.int64),
               "alpha": torch.as_tensor(np.array(batch["alpha"],
                                                 np.float32)).reshape(
                                                     n, 1, 1, 1)}
        if self.with_nce:
            out["patch_ids"] = torch.as_tensor(
                np.array(batch["patch_ids"])).long()
        return out

    def inputs(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """:meth:`step`'s tensors on the device from ``batch``: ``img``
        [bs,H,W,1] and ``msk``, with ``uses_unlabeled`` ``ul_img``, and
        :meth:`host_inputs` copied from pinned memory."""
        inp = {k: self._to_device(v)
               for k, v in self.host_inputs(batch).items()}
        inp["img"] = self._to_device(batch["img"], torch.float32)
        inp["msk"] = self._to_device(batch["msk"]).long()
        if self.uses_unlabeled:
            inp["ul_img"] = self._to_device(batch["ul_img"], torch.float32)
        return inp

    def step_inputs(self, inp: Mapping[str, torch.Tensor]
                    ) -> Dict[str, Optional[torch.Tensor]]:
        """:meth:`d_step`'s and :meth:`g_step`'s view of :meth:`step`'s
        tensors: ``x_real`` (labelled, then unlabelled images), ``y_real``
        and ``patch_ids`` None without PatchNCE."""
        x_real = inp["img"]
        if self.uses_unlabeled:
            x_real = torch.cat([x_real, inp["ul_img"]])
        out = {k: inp[k] for k in ("vec_ot", "vec_to", "mdl", "modal_trg",
                                   "alpha")}
        out.update(x_real=x_real, y_real=inp["msk"],
                   patch_ids=inp.get("patch_ids"))
        return out

    def d_step(self, state: GANTrainState, inp: Mapping
               ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        """The translation ``x_fake0`` without gradients, the D loss and
        its gradient (grad-of-grad included), and the Adam update."""
        with torch.no_grad():
            _, x_fake0, _ = self._g_forward(state.g_params, inp["x_real"],
                                            inp["vec_ot"], None)
        d_leaves = {k: v.detach().requires_grad_()
                    for k, v in state.d_params.items()}
        total, (d_real, d_fake, d_cls, d_gp), _ = self.d_loss(
            d_leaves, inp["x_real"], x_fake0, inp["alpha"], inp["mdl"])
        state = state.apply_d_gradients(_grads(total, d_leaves))
        return state, {"D_real": d_real, "D_fake": d_fake, "D_cls": d_cls,
                       "D_gp": d_gp}

    def g_step(self, state: GANTrainState, inp: Mapping, scalars: Mapping
               ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        """The G losses against the (updated) D, their gradient in the G
        parameters only, and the SGD update."""
        cfg = self.cfg
        bs = cfg.batch_size
        x_real, y_real, patch_ids = inp["x_real"], inp["y_real"], \
            inp["patch_ids"]
        # on the device, from the device count: a replayed graph of the
        # step opens the gate at its step
        gate = (state.count >= cfg.consis_gate_step).to(x_real.dtype)
        g_leaves = {k: v.detach().requires_grad_()
                    for k, v in state.g_params.items()}
        y_fake, x_fake, feat_x = self._g_forward(g_leaves, x_real,
                                                 inp["vec_ot"], patch_ids)
        src, cls = self._d(state.d_params, x_fake)
        g_fake = -src.mean()
        g_cls = softmax_ce_with_logits(cls, inp["modal_trg"])
        g_seg = dice_and_ce_loss(y_fake[:bs], y_real, cfg.weight_dc,
                                 cfg.weight_ce, batch_dice=True)
        y_rec, x_rec, feat_f = self._g_forward(g_leaves, x_fake,
                                               inp["vec_to"], patch_ids)
        g_rec = l1_loss(x_real, x_rec)
        total = (g_fake + self.lambda_rec * g_rec + self.lambda_cls * g_cls
                 + self.lambda_seg * g_seg)
        metrics = {"G_fake": g_fake, "G_rec": g_rec, "G_cls": g_cls,
                   "G_seg": g_seg, "loss": g_seg}
        if self.variant == "ugan":
            g_shp = dice_and_ce_loss(y_rec, y_real, cfg.weight_dc,
                                     cfg.weight_ce, batch_dice=True)
            total = total + loss_weight(scalars["lambda_shp"]) * g_shp
            metrics["G_shp"] = g_shp
        if self.variant == "uganConsis":
            g_semi = argmax_consistency_loss(y_rec, y_fake, cfg.weight_dc,
                                             cfg.weight_ce) * gate
            total = total + loss_weight(scalars["lambda_semi"]) * g_semi
            metrics["G_semi"] = g_semi
        if self.with_nce:
            g_nce = nce_loss_over_layers([feat_x], [feat_f], bs,
                                         cfg.nce_temperature)
            total = total + 1.0 * g_nce
            metrics["G_nce"] = g_nce
        return state.apply_g_gradients(_grads(total, g_leaves)), metrics

    def step(self, state: GANTrainState, inp: Mapping[str, torch.Tensor],
             scalars: Mapping) -> Dict[str, torch.Tensor]:
        """The iteration on the device (:meth:`d_step`, :meth:`g_step`,
        the device count advanced; not the host ``step``) on
        :meth:`inputs`' tensors; ``scalars``: :meth:`epoch_scalars`, as
        numbers or 0-d device tensors."""
        inp = self.step_inputs(inp)
        state, d_metrics = self.d_step(state, inp)
        state, g_metrics = self.g_step(state, inp, scalars)
        state.count.add_(1)
        return {k: v.detach() for k, v in {**d_metrics, **g_metrics}.items()}

    def train_step(self, state: GANTrainState, batch: Mapping,
                   scalars: Mapping) -> Tuple[GANTrainState,
                                              Dict[str, torch.Tensor]]:
        """One iteration (:meth:`inputs`, :meth:`step`, the host step
        advanced); ``scalars``: :meth:`epoch_scalars`.  The state passed
        in is consumed (updated in place)."""
        metrics = self.step(state, self.inputs(batch), scalars)
        state.step += 1
        return state, metrics

    # -------------------------------------------------------------- public
    @torch.inference_mode()
    def _translate(self, g_params: Params, x, vec
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(seg logits, translation) of ``x`` with the modality vector
        ``vec``, float32."""
        x = self._to_device(x, torch.float32)
        seg, tsl, _ = self._g_forward(g_params, x,
                                      self._to_device(vec, torch.float32),
                                      None)
        return seg, tsl

    @torch.inference_mode()
    def eval_fn(self, params: Params, img) -> torch.Tensor:
        """float32 seg logits [B, H, W, n_class] of NHWC ``img`` (no
        modality vector)."""
        img = self._to_device(img, torch.float32)
        return self._g_forward(params, img, None, None)[0]

    def eval_params(self, state: Union[GANTrainState,
                                       Mapping[str, torch.Tensor]]) -> Params:
        """The generator's float32 parameters on the algorithm's device,
        from a train state or a parameter mapping."""
        params = state.g_params if isinstance(state, GANTrainState) else state
        return {k: v.detach().to(self.device, torch.float32, copy=True)
                for k, v in params.items()}

    def epoch_scalars(self, epoch: int) -> Dict[str, np.float32]:
        out = {}
        if self.variant == "ugan":
            lam = min(epoch * (self.lambda_shp / self.lambda_shp_lazy),
                      self.lambda_seg)
            out["lambda_shp"] = np.float32(lam)
        if self.variant == "uganConsis":
            lam = self.lambda_semi * sigmoid_rampup(epoch, self.cfg.max_epoch)
            out["lambda_semi"] = np.float32(lam)
        return out

    # ------------------------------------------------------ sample grids
    def on_epoch_end(self, trainer, epoch: int) -> None:
        """The fixed batch's translation grid, one row per image: the
        image, then its translation to each modality, ``[-1, 1]`` mapped
        to grey levels; ``sample/train-{epoch + 1}-images.png`` (the JAX
        package writes a JPEG through PIL; the port has its own PNG
        codec)."""
        if trainer.exp.sample_root is None or self._fixed is None:
            return
        x_fixed, vec_org = self._fixed
        params = self.eval_params(trainer.state)
        cols = [x_fixed]
        eye = np.eye(self.cfg.n_modal, dtype=np.float32)
        for target in range(self.cfg.n_modal):
            _, tsl = self._translate(params, x_fixed, eye[target] - vec_org)
            cols.append(tsl.cpu().numpy())
        grid = np.clip((np.concatenate(cols, axis=2) + 1.0) / 2.0, 0, 1)
        rows = np.concatenate(list(grid[..., 0]), axis=0)
        imwrite_gray(os.path.join(trainer.exp.sample_root,
                                  f"train-{epoch + 1}-images.png"),
                     (rows * 255).astype(np.uint8))

    def set_fixed_batch(self, x_fixed, mdl) -> None:
        self._fixed = (np.asarray(x_fixed, np.float32),
                       label2onehot(mdl, self.cfg.n_modal))


class UGANTrainerAlgo(UGANBase):
    """UGAN + the shape loss (``trainer/uganTrainer.py``)."""

    name = "ugan"
    variant = "ugan"
    uses_unlabeled = False


class UGANShp0Algo(UGANBase):
    """UGANnce + PatchNCE, no shape loss (``trainer/uganShp0Trainer.py``)."""

    name = "uganShp0"
    variant = "uganShp0"
    uses_unlabeled = False


class UGANConsisAlgo(UGANBase):
    """The paper's method, SMSUT: labelled + unlabelled batches,
    consistency, PatchNCE (``trainer/uganConsisTrainer.py``)."""

    name = "uganConsis"
    variant = "uganConsis"
    uses_unlabeled = True
