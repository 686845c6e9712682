# -*- coding: utf-8 -*-
"""The fit / validate / test harness.

Port of ``smsut_tpu/train/loop.py`` ``Trainer``: one generic epoch loop
drives an algorithm object (``SupervisedUNet``, the GAN algorithms of
``train/steps/gan.py``) while the host keeps the
reference's semantics -- in-turn loaders, per-modality loss metering, the
slice->volume scatter for evaluation, mean-Dice model selection, best/last
checkpoints, and the trois CSV in the test phase.

With ``Config.device_augment`` (the default) an iteration is
``DeviceAugment.apply`` on the card followed by ``algo.train_step``, the
counterpart of the JAX package's fused augment+step.  The producer threads
draw the augmentation's parameters (their own ``random.Random(seed + 101)``
stream) and pin the batch, and the training thread waits on the card
nowhere within an epoch: batches are copied from pinned memory without
blocking, ``mdl`` stays on the host, and the losses are read once, at the
epoch's end.  The eval sweep keeps its uint8 predictions on the card until
it ends.

Not ported: chunked dispatch (``steps_per_dispatch``), the scanned eval
sweep (``eval_scan``), the mesh and multi-host runs, and ``profile_dir``
tracing; those knobs are accepted and do nothing (config.py).
"""
from __future__ import annotations

import random
import time
from os.path import join as pjoin
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from smsut_tpu_torch.config import Config, Modality
from smsut_tpu_torch.data.dataset import (Batch, BatchLoader, get_label_npys,
                                          get_loader)
from smsut_tpu_torch.data.device_augment import DeviceAugment
from smsut_tpu_torch.ops.losses import dice_and_ce_loss
from smsut_tpu_torch.ops.metrics import (get_all_matrix, get_mo_matrix,
                                         matrix_to_csv)
from smsut_tpu_torch.ops.schedules import poly_lr_host
from smsut_tpu_torch.train import checkpoints
from smsut_tpu_torch.train.experiment import Experiment
from smsut_tpu_torch.utils.io import count_param_number
from smsut_tpu_torch.utils.meter import Meter


class _Cycler:
    """next()-with-restart iteration (the reference's try/except
    StopIteration pattern), backed by the loader's single persistent
    cycling producer when it has one."""

    def __init__(self, loader):
        self.loader = loader
        if hasattr(loader, "iter_cycle"):
            self.itr = loader.iter_cycle()
        else:
            self.itr = iter(loader)

    def next(self) -> Batch:
        try:
            return next(self.itr)
        except StopIteration:
            self.itr = iter(self.loader)
            return next(self.itr)


def _split(item) -> Tuple[Batch, Optional[torch.Tensor]]:
    """A loader item: a Batch, or (Batch, packed augment params) from the
    Trainer's producer hook."""
    return item if isinstance(item, tuple) else (item, None)


class Trainer:
    def __init__(self, algo, cfg: Config, phase: str, args=None,
                 experiment: Optional[Experiment] = None):
        self.algo = algo
        self.cfg = cfg
        self.phase = phase
        self.args = args
        self.device = algo.device
        self.fold = 0 if args is None else getattr(args, "fold", 0)
        expr_name = None
        if args is not None and getattr(args, "expr_name", None):
            expr_name = args.expr_name
        self.expr_name = expr_name or algo.__class__.__name__
        self.exp = experiment or Experiment(cfg.expr_root, self.expr_name,
                                            phase)
        self.epoch = 0
        self.device_aug: Optional[DeviceAugment] = None
        self.state = algo.init_state(cfg.seed)
        self._log_param_counts()

    def _log_param_counts(self) -> None:
        """The reference's startup parameter-count log line, per network."""
        for label, attr in (("net", "params"), ("G", "g_params"),
                            ("D", "d_params")):
            tree = getattr(self.state, attr, None)
            if tree is not None:
                n = count_param_number(tree)
                self.info(f"[{label}] Number of parameters: {n} "
                          f"({n / 1e6:.4f}M)")

    # ------------------------------------------------------------------ utils
    def info(self, s):
        self.exp.info(s)

    def _pin(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a tensor, in pinned memory when the algorithm
        runs on the card (so that its copy does not block the host)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _to_device(self, a) -> torch.Tensor:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        return t.to(self.device, non_blocking=True)

    @torch.inference_mode()
    def _eval_step(self, params, img: torch.Tensor, msk: torch.Tensor):
        logits = self.algo.eval_fn(params, img)
        loss = dice_and_ce_loss(logits, msk, self.cfg.weight_dc,
                                self.cfg.weight_ce, batch_dice=True)
        # uint8 predictions: n_label <= 255 and the volumes are uint8
        return loss, torch.argmax(logits, dim=-1).to(torch.uint8)

    # ------------------------------------------------------------------- fit
    def fit(self, loader_type: str = "inTurn") -> None:
        cfg = self.cfg
        tic = time.time()
        data_rng = random.Random(cfg.seed)
        raw = bool(cfg.device_augment)
        self.device_aug = (DeviceAugment(cfg, data_rng, self.device)
                           if raw else None)
        if loader_type not in ("inTurn", "balance"):
            raise NotImplementedError(loader_type)
        lb_loader = get_loader(cfg.base_root, "train", self.fold, cfg.batch_size,
                               cfg.data_aug, cfg=cfg, rng=data_rng, raw=raw,
                               loader_type=loader_type)
        ul_loader = get_loader(cfg.base_root, "val", self.fold, cfg.batch_size,
                               cfg.data_aug, cfg=cfg, rng=data_rng, raw=raw,
                               loader_type=loader_type)
        test_loader = get_loader(cfg.base_root, "test", 0, cfg.batch_size, cfg=cfg)
        # the producer threads draw the augmentation's parameters, from
        # their own streams (deterministic whatever the threads' timing),
        # and pin the batch, so that the training thread only dispatches
        lb_loader.post = self._producer_hook(
            DeviceAugment(cfg, random.Random(cfg.seed + 101), self.device)
            if raw else None)
        ul_loader.post = self._producer_hook(
            DeviceAugment(cfg, random.Random(cfg.seed + 202), self.device)
            if raw else None)

        self.info(f"train labeled images: {len(lb_loader.dataset)}")
        self.info(f"train unlabel images: {len(ul_loader.dataset)}")
        self.info(f"test  images: {len(test_loader.dataset)}")

        n_tst_slic, tst_npys = get_label_npys(cfg.base_root, "test", cfg.split_yaml)
        self.info("Load data cost %.4fs." % (time.time() - tic))
        tic = time.time()

        min_keys = [f"loss_{i}" for i in range(cfg.n_modal)] + ["loss"]
        max_keys = [f"dice_{i}" for i in range(cfg.n_modal)] + ["dice"]
        train_meter = Meter(min_keys, [], alpha=cfg.exp_alpha)
        test_meter = Meter(min_keys, max_keys, alpha=1.0)
        best_epoch = -1

        self._ul_loader = ul_loader  # algorithms with host-side pseudo-labels
        lb_itr, ul_itr = _Cycler(lb_loader), _Cycler(ul_loader)
        if hasattr(self.algo, "set_fixed_batch"):
            self._set_fixed_batch(lb_itr, ul_itr, raw)
        max_epoch = (self.algo.max_epoch if hasattr(self.algo, "max_epoch")
                     else cfg.max_epoch)
        best_prefix = getattr(self.algo, "best_prefix", "best")
        last_prefix = getattr(self.algo, "last_prefix", "last")
        if self.epoch:
            # a resumed run takes the batches (and random draws) the
            # uninterrupted run would: the streams are advanced past the
            # epochs done
            self.info(f"Resuming at epoch {self.epoch} (step "
                      f"{int(self.state.step)}).")
            done = self.epoch * self._iters_per_epoch()
            for _ in range(done):
                lb_itr.next()
                if getattr(self.algo, "uses_unlabeled", False):
                    ul_itr.next()
            if hasattr(self.algo, "skip_draws"):
                self.algo.skip_draws(done)
        for epoch in range(self.epoch, max_epoch):
            if hasattr(self.algo, "on_epoch_start"):
                self.algo.on_epoch_start(self, epoch)
            train_meter.reset_cur()
            self.train_epoch(lb_itr, ul_itr, train_meter)
            self.epoch += 1
            train_meter.update_cur()

            # the logged LR comes from the algorithm when its schedule is
            # not the default poly
            if hasattr(self.algo, "lr_at"):
                lr = self.algo.lr_at(int(self.state.step))
            else:
                lr = poly_lr_host(cfg.lr, int(self.state.step),
                                  cfg.total_iters)
            self.info("")
            self.info(f"lr: {lr}.")
            self.info("[TRN] Epoch: %d(%d)/%d, elapsed: %.2fs," %
                      (epoch, best_epoch, max_epoch, time.time() - tic)
                      + str(train_meter))
            self._write_scalars("train", train_meter, epoch)
            self.exp.scalar("train/lr", lr, epoch)
            tic = time.time()

            # eval_every > 1 skips eval and checkpoints on off-epochs
            if (epoch + 1) % max(1, cfg.eval_every) and epoch != max_epoch - 1:
                continue

            test_meter.reset_cur()
            n_prd_slic, prd_npys = self.validate_epoch(test_loader, tst_npys, test_meter)
            assert n_prd_slic == n_tst_slic
            v = self.validate_dice(prd_npys, tst_npys)
            test_meter.accumulate(v, {k: 1.0 for k in v.keys()})
            test_meter.update_cur()
            self.info("[TST] Epoch: %d/%d, elapsed: %.2fs," %
                      (epoch, max_epoch, time.time() - tic) + str(test_meter))
            self._write_scalars("test", test_meter, epoch)
            tic = time.time()

            if test_meter.cur_values["dice"] >= test_meter.best_values["dice"]:
                self.save_model(best_prefix)
                best_epoch = epoch

            if hasattr(self.algo, "on_epoch_end"):
                self.algo.on_epoch_end(self, epoch)

        self.save_model(last_prefix)

    def _set_fixed_batch(self, lb_itr: _Cycler, ul_itr: _Cycler,
                         raw: bool) -> None:
        """The fixed images of the per-epoch translation grid: the first
        labelled batch and, for an algorithm that uses them, the first
        unlabelled one, as host arrays normalised to [-1, 1] (the
        augmentation's mapping, without the warp)."""
        b = _split(lb_itr.next())[0]
        img, mdl = np.asarray(b.img), np.asarray(b.mdl)
        if getattr(self.algo, "uses_unlabeled", False):
            u = _split(ul_itr.next())[0]
            img = np.concatenate([img, np.asarray(u.img)])
            mdl = np.concatenate([mdl, np.asarray(u.mdl)])
        if raw:  # uint8 [B,H,W] batches
            img = (img.astype(np.float32) / 255.0 - 0.5)[..., None] / 0.5
        self.algo.set_fixed_batch(img, mdl)

    def _producer_hook(self, da: Optional[DeviceAugment]):
        """Loader hook, run in the producer thread: Batch -> (Batch with
        pinned arrays, pinned packed augment params or None)."""
        def post(b: Batch):
            params = None
            if da is not None:
                h, w = b.img.shape[1:3]
                params = self._pin(da.sample_params_packed(b.batch_size, h, w))
            return Batch(self._pin(b.img), self._pin(b.msk), b.mdl,
                         b.names), params

        return post

    def _iters_per_epoch(self) -> int:
        return self.cfg.num_iter_per_epoch * getattr(self.algo, "n_critic", 1)

    def _write_scalars(self, prefix: str, meter: Meter, epoch: int) -> None:
        for k, v in meter.cur_values.items():
            if "_" in k:
                typ, m = k.split("_")
                new_k = f"{typ}_{Modality(int(m)).name}"
            else:
                new_k = k
            self.exp.scalar(f"{prefix}/{new_k}", v, epoch)

    # ----------------------------------------------------------- train epoch
    def _augmented(self, item, da: DeviceAugment) -> Dict:
        b, params = _split(item)
        if params is None:
            h, w = b.img.shape[1:3]
            params = da.sample_params_packed(b.batch_size, h, w)
        img, msk = da.apply(self._to_device(b.img), self._to_device(b.msk),
                            self._to_device(params))
        return {"img": img, "msk": msk, "mdl": b.mdl}

    def train_epoch(self, lb_itr: _Cycler, ul_itr: _Cycler, meter: Meter) -> None:
        """``num_iter_per_epoch`` iterations; the losses stay on the card
        until the epoch ends, then are read at once (one wait), and a
        non-finite loss raises with its iteration."""
        scalars = self.algo.epoch_scalars(self.epoch)
        pending = []  # (device metrics, modality, n)
        log_step = getattr(self.algo, "log_step", 0)
        tic = time.time()
        n_iters = self._iters_per_epoch()
        uses_ul = getattr(self.algo, "uses_unlabeled", False)
        for i in range(n_iters):
            item = lb_itr.next()
            lb = _split(item)[0]
            m = int(lb.mdl[0])
            if self.device_aug is not None:
                batch = self._augmented(item, self.device_aug)
                if uses_ul:
                    ul = self._augmented(ul_itr.next(), self.device_aug)
                    batch.update(ul_img=ul["img"], ul_mdl=ul["mdl"])
            else:
                batch = {"img": self._to_device(lb.img),
                         "msk": self._to_device(lb.msk), "mdl": lb.mdl}
                if uses_ul:
                    ul = _split(ul_itr.next())[0]
                    batch.update(ul_img=self._to_device(ul.img), ul_mdl=ul.mdl)
            if hasattr(self.algo, "make_extra_batch"):
                batch.update(self.algo.make_extra_batch())
            self.state, metrics = self.algo.train_step(self.state, batch,
                                                       scalars)
            pending.append((metrics, m, lb.batch_size))
            if log_step and (i + 1) % log_step == 0:
                last = {k: float(v) for k, v in metrics.items()}
                msg = "Iter: %d/%d(%d), elapsed: %.2fs," % (
                    i, n_iters, int(self.state.step), time.time() - tic)
                tic = time.time()
                for k, v in last.items():
                    msg += " %s: %.4f," % (k, v)
                self.info(msg)
        self._drain(pending, meter)

    def _drain(self, pending, meter: Meter) -> None:
        if not pending:
            return
        keys = [k for k in ("loss", "loss2") if k in pending[0][0]]
        host = {k: torch.stack([m[k].detach().reshape(())
                                for m, _, _ in pending]).cpu().tolist()
                for k in keys}
        for it, (metrics, m, n) in enumerate(pending):
            loss = host["loss"][it]
            if not np.isfinite(loss):
                diag = {k: host[k][it] for k in keys}
                raise FloatingPointError(
                    f"non-finite loss at epoch {self.epoch} iter {it}: {diag}")
            v, cnt = Meter.collect_loss_by(loss, m, n)
            meter.accumulate(v, cnt)
            if "loss2" in host:  # cross-pseudo meters both nets
                v, cnt = Meter.collect_loss_by(host["loss2"][it], m, n)
                meter.accumulate(v, cnt)

    # ------------------------------------------------------------ validation
    def validate_epoch(self, loader: BatchLoader, npys: Dict[str, np.ndarray],
                       meter: Optional[Meter] = None
                       ) -> Tuple[int, Dict[str, np.ndarray]]:
        """Per batch, partial batches zero-padded to ``batch_size`` (one
        shape for every call); the losses and uint8 predictions stay on the
        card until the sweep ends."""
        cfg = self.cfg
        prd_npys = {k: np.zeros(v.shape, dtype=v.dtype) for k, v in npys.items()}
        n_prd_slic = 0
        params = self.algo.eval_params(self.state)
        losses, preds, batches = [], [], []
        for batch in loader:
            b = batch.batch_size
            img, msk = batch.img, batch.msk
            if b != cfg.batch_size:
                pad = cfg.batch_size - b
                img = np.concatenate([img, np.zeros((pad,) + img.shape[1:],
                                                    img.dtype)])
                msk = np.concatenate([msk, np.zeros((pad,) + msk.shape[1:],
                                                    msk.dtype)])
            assert len(np.unique(batch.mdl)) == 1
            loss, pred = self._eval_step(params, self._to_device(img),
                                         self._to_device(msk))
            losses.append(loss)
            preds.append(pred[:b])
            batches.append(batch)
        if not batches:
            return 0, prd_npys
        losses = torch.stack(losses).cpu().tolist()
        preds = torch.cat(preds).cpu().numpy()
        row = 0
        for loss, batch in zip(losses, batches):
            b = batch.batch_size
            if meter is not None:
                v, n = Meter.collect_loss_by(loss, int(batch.mdl[0]), b)
                meter.accumulate(v, n)
            for i in range(b):
                m, pid, z = batch.names[i].split("_")
                prd_npys[f"{m}_{pid}"][int(z)] = preds[row + i]
                n_prd_slic += 1
            row += b
        return n_prd_slic, prd_npys

    def validate_dice(self, prd_npys, gt_npys) -> Dict[str, float]:
        mo = get_mo_matrix(prd_npys, gt_npys, self.cfg)
        dices = {f"dice_{i}": mo[i, -1] for i in range(self.cfg.n_modal)}
        dices["dice"] = mo[-1, -1]
        return dices

    # ------------------------------------------------------------------ test
    def test(self, loader_type: str, expr_root: str) -> str:
        cfg = self.cfg
        test_loader = get_loader(cfg.base_root, "test", 0, cfg.batch_size, cfg=cfg)
        n_gt_slic, gt_npys = get_label_npys(cfg.base_root, "test", cfg.split_yaml)
        n_prd_slic, prd_npys = self.validate_epoch(test_loader, gt_npys, None)
        assert n_prd_slic == n_gt_slic
        tic = time.time()
        matrix = get_mo_matrix(prd_npys, gt_npys, cfg)
        dc_matrix, hd_matrix, assd_matrix = get_all_matrix(prd_npys, gt_npys, cfg)
        self.info("Test metrics cost %.4fs." % (time.time() - tic))
        log = matrix_to_csv(matrix, assd_matrix)
        save_path = pjoin(expr_root, "all_trois_matrix.csv")
        with open(save_path, "w") as f:
            f.write(log)
        self.info(log)
        return save_path

    # ------------------------------------------------------------ checkpoint
    def save_model(self, prefix: str) -> None:
        path = checkpoints.save_state(self.state, self.exp.ckpt_root, prefix)
        self.info(f"Save model to {path}.")

    def load_model(self, model_idx: Optional[str], which_ckpt: str = "last") -> None:
        ckpt_root = pjoin(self.exp.expr_root, model_idx or self.exp.model_idx, "ckpt")
        self.state = checkpoints.load_state(self.state, ckpt_root, which_ckpt)
        self.info(f"Load model from {ckpt_root}/{which_ckpt}.ckpt.")
