# -*- coding: utf-8 -*-
"""The fit / validate / test harness.

Port of ``smsut_tpu/train/loop.py`` ``Trainer``: one generic epoch loop
drives an algorithm object (``SupervisedUNet``, ``MeanTeacher``,
``CrossPseudo``, ``CoraNet``, the GAN algorithms of ``train/steps/gan.py``)
while the host keeps the
reference's semantics -- in-turn loaders, per-modality loss metering, the
slice->volume scatter for evaluation, mean-Dice model selection, best/last
checkpoints, and the trois CSV in the test phase.

With ``Config.device_augment`` (the default) an iteration is
``DeviceAugment.apply`` on the card followed by the algorithm's device
step (``algo.step``), the counterpart of the JAX package's fused
augment+step, and on the card the whole iteration is one CUDA graph
(train/graphs.py ``Replay``), as the JAX iteration is one ``jit`` program:
its inputs go into the graph's fixed buffers, its metrics into a device
ring at the row of the state's device step count, and the host advances
its mirror of the count.  The producer threads draw the augmentation's
parameters (their own ``random.Random(seed + 101)`` stream) and pin the
batch, and the training thread waits on the card nowhere within an epoch:
``mdl`` stays on the host, and the ring is read once, at the epoch's end.

``steps_per_dispatch`` T > 1, where the JAX package takes it (device
augmentation, no per-step host draws), stages T batches and their packed
parameters in one pinned copy each and runs T replays; the remainder runs
one iteration at a time.  ``eval_scan`` keeps the test set on the card as
uint8 stacks and replays one graph of the eval forward per batch;
``eval_scan=False`` runs the per-batch eager sweep.  ``Trainer(...,
capture=False)`` runs the same iterations and sweep eagerly.

Each stream of host draws has its own generator (ROADMAP C: the JAX
package shares one between both loaders, whose producer threads then draw
from it in an order that follows their timing): the labelled loader's
order and host augmentation ``labeled_loader_rng`` (``random.Random(seed)``,
the JAX package's stream for a run that draws one loader), the unlabelled
loader's ``unlabeled_loader_rng`` (seed + 303), and CoraNet's pseudo-label
sweep ``pseudo_sweep_rng`` (seed + 404), each made when ``fit`` starts.

Not ported: the mesh and multi-host runs, and ``profile_dir`` tracing;
those knobs are accepted and do nothing (config.py).
"""
from __future__ import annotations

import random
import time
from os.path import join as pjoin
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from smsut_tpu_torch.config import Config, Modality
from smsut_tpu_torch.data.augment import normalize_img
from smsut_tpu_torch.data.dataset import (Batch, BatchLoader, get_label_npys,
                                          get_loader)
from smsut_tpu_torch.data.device_augment import DeviceAugment
from smsut_tpu_torch.ops.losses import dice_and_ce_loss
from smsut_tpu_torch.ops.metrics import (get_all_matrix, get_mo_matrix,
                                         matrix_to_csv)
from smsut_tpu_torch.ops.schedules import poly_lr_host
from smsut_tpu_torch.train import checkpoints
from smsut_tpu_torch.train.experiment import Experiment
from smsut_tpu_torch.train.graphs import Replay
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


# the inputs of an iteration that the device augmentation consumes
_AUG_KEYS = ("params", "ul_msk", "ul_params")


class Trainer:
    def __init__(self, algo, cfg: Config, phase: str, args=None,
                 experiment: Optional[Experiment] = None,
                 capture: bool = True):
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
        # on the card, iterations and eval batches replay CUDA graphs
        self.capture = capture
        # chunked dispatch: the JAX package's eligibility (device
        # augmentation, and no host draws per step, which pin T to 1)
        self._chunk_T = int(getattr(cfg, "steps_per_dispatch", 1) or 1)
        if (self._chunk_T < 2 or hasattr(algo, "make_extra_batch")
                or not cfg.device_augment):
            self._chunk_T = 1
        self._iterate: Optional[Replay] = None   # one fit's iterations
        self._ring: Optional[torch.Tensor] = None  # [iters, metrics]
        self._ring_keys = []
        self._scalars: Dict[str, torch.Tensor] = {}  # epoch scalars
        self._eval_replay: Optional[Replay] = None
        self._eval_params = None   # the eval graph's parameter buffers
        self._eval_cache = None    # (loader, host stacks, metas)
        self._eval_dev = None      # (loader, device stacks)
        self._eval_lut: Optional[torch.Tensor] = None
        self.state = algo.init_state(cfg.seed)
        self._log_param_counts()

    def _log_param_counts(self) -> None:
        """The reference's startup parameter-count log line, per network."""
        for label, attr in (("net", "params"), ("net2", "params2"),
                            ("G", "g_params"), ("D", "d_params")):
            tree = getattr(self.state, attr, None)
            if tree is not None:
                n = count_param_number(tree)
                self.info(f"[{label}] Number of parameters: {n} "
                          f"({n / 1e6:.4f}M)")

    # ------------------------------------------------------------------ utils
    def info(self, s):
        self.exp.info(s)

    def _pinned(self, a) -> torch.Tensor:
        """A host array or tensor, pinned when the algorithm runs on the
        card (a copy from pageable memory waits for the stream)."""
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        if self.device.type == "cuda" and not t.is_pinned():
            t = t.pin_memory()
        return t

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
        self.labeled_loader_rng = random.Random(cfg.seed)
        self.unlabeled_loader_rng = random.Random(cfg.seed + 303)
        self.pseudo_sweep_rng = random.Random(cfg.seed + 404)
        raw = bool(cfg.device_augment)
        self.device_aug = (DeviceAugment(cfg, self.labeled_loader_rng,
                                         self.device) if raw else None)
        if loader_type not in ("inTurn", "balance"):
            raise NotImplementedError(loader_type)
        if self._chunk_T > 1:
            # a chunk takes T batches at once: keep the producers ahead
            cfg = cfg.replace(prefetch_depth=max(cfg.prefetch_depth,
                                                 2 * self._chunk_T))
        lb_loader = get_loader(cfg.base_root, "train", self.fold, cfg.batch_size,
                               cfg.data_aug, cfg=cfg,
                               rng=self.labeled_loader_rng, raw=raw,
                               loader_type=loader_type)
        ul_loader = get_loader(cfg.base_root, "val", self.fold, cfg.batch_size,
                               cfg.data_aug, cfg=cfg,
                               rng=self.unlabeled_loader_rng, raw=raw,
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
        self._iterate = Replay(self._iteration, self.device, self.capture)
        self._ring = None
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

        self._iterate = None   # its graphs hold this fit's state and pool
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
                params = self._pinned(
                    da.sample_params_packed(b.batch_size, h, w))
            return Batch(self._pinned(b.img), self._pinned(b.msk), b.mdl,
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
    def _fetch(self, lb_itr: _Cycler, ul_itr: _Cycler
               ) -> Tuple[Dict[str, torch.Tensor], int, int]:
        """One iteration's inputs as host tensors (pinned on the card): the
        labelled batch, with device augmentation its packed parameters,
        the unlabelled batch for an algorithm that uses it, and the
        algorithm's per-step host inputs; and its modality and size."""
        lb, params = _split(lb_itr.next())
        inp = {"img": self._pinned(lb.img), "msk": self._pinned(lb.msk)}
        da = self.device_aug
        if da is not None:
            if params is None:
                h, w = lb.img.shape[1:3]
                params = da.sample_params_packed(lb.batch_size, h, w)
            inp["params"] = self._pinned(params)
        batch = {"mdl": lb.mdl}
        if getattr(self.algo, "uses_unlabeled", False):
            ul, ul_params = _split(ul_itr.next())
            inp["ul_img"] = self._pinned(ul.img)
            if da is not None:
                if ul_params is None:
                    h, w = ul.img.shape[1:3]
                    ul_params = da.sample_params_packed(ul.batch_size, h, w)
                inp["ul_msk"] = self._pinned(ul.msk)
                inp["ul_params"] = self._pinned(ul_params)
            batch["ul_mdl"] = ul.mdl
        if hasattr(self.algo, "make_extra_batch"):
            batch.update(self.algo.make_extra_batch())
            inp.update({k: self._pinned(v) for k, v in
                        self.algo.host_inputs(batch).items()})
        return inp, int(lb.mdl[0]), lb.batch_size

    def _stage(self, items) -> list:
        """T iterations' inputs on the device: each input's T host tensors
        stacked into one pinned buffer and copied at once."""
        stacked = {}
        for k, v in items[0].items():
            buf = torch.empty((len(items),) + tuple(v.shape), dtype=v.dtype,
                              pin_memory=self.device.type == "cuda")
            torch.stack([torch.as_tensor(it[k]) for it in items], out=buf)
            stacked[k] = buf.to(self.device, non_blocking=True)
        return [{k: v[j] for k, v in stacked.items()}
                for j in range(len(items))]

    def _iteration(self, inp: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One iteration on the device, replayed as a CUDA graph on the
        card: the device augmentation, the algorithm's step (which
        advances the state's device count), and its metrics written to
        the ring's row of the count before the step."""
        rows = self._iters_per_epoch()
        slot = torch.remainder(self.state.count, rows).reshape(1)
        batch = {k: v for k, v in inp.items() if k not in _AUG_KEYS}
        da = self.device_aug
        if da is not None:
            batch["img"], batch["msk"] = da.apply(inp["img"], inp["msk"],
                                                  inp["params"])
            if "ul_img" in inp:
                batch["ul_img"] = da.apply(inp["ul_img"], inp["ul_msk"],
                                           inp["ul_params"])[0]
        else:
            batch["msk"] = inp["msk"].long()
        metrics = self.algo.step(self.state, batch, self._scalars)
        if self._ring is None:
            self._ring_keys = list(metrics)
            self._ring = torch.zeros((rows, len(metrics)),
                                     dtype=torch.float32, device=self.device)
        vals = torch.stack([metrics[k].detach().reshape(()).float()
                            for k in self._ring_keys])
        self._ring.index_copy_(0, slot, vals[None])
        return {}

    def _set_scalars(self, scalars: Dict) -> None:
        """The epoch's scalars into the 0-d device tensors the step reads."""
        for k, v in scalars.items():
            t = self._scalars.get(k)
            if t is None:
                t = self._scalars[k] = torch.zeros((), dtype=torch.float32,
                                                   device=self.device)
            t.fill_(float(v))

    def train_epoch(self, lb_itr: _Cycler, ul_itr: _Cycler, meter: Meter) -> None:
        """``num_iter_per_epoch`` iterations, in chunks of
        ``steps_per_dispatch`` where it applies; the metrics stay on the
        card until the epoch ends, then are read at once (one wait), and a
        non-finite loss raises with its iteration."""
        self._set_scalars(self.algo.epoch_scalars(self.epoch))
        first = self.state.step
        rows = []  # (modality, n) per iteration
        log_step = getattr(self.algo, "log_step", 0)
        tic = time.time()
        n_iters = self._iters_per_epoch()
        T = self._chunk_T
        done = 0
        while done < n_iters:
            t = T if n_iters - done >= T else 1
            items = [self._fetch(lb_itr, ul_itr) for _ in range(t)]
            staged = (self._stage([it[0] for it in items]) if t > 1
                      else [items[0][0]])
            for inp in staged:
                self._iterate(inp)
                self.state.step += 1
            rows += [(m, n) for _, m, n in items]
            done += t
            if log_step and done % log_step < t:
                last = dict(zip(self._ring_keys, self._ring[
                    (self.state.step - 1) % n_iters].tolist()))
                msg = "Iter: %d/%d(%d), elapsed: %.2fs," % (
                    done - 1, n_iters, self.state.step, time.time() - tic)
                tic = time.time()
                for k, v in last.items():
                    msg += " %s: %.4f," % (k, v)
                self.info(msg)
        self._drain(rows, first, meter)

    def _drain(self, rows, first: int, meter: Meter) -> None:
        """Meter the epoch's iterations from the ring (one read); row
        ``(first + it) % rows`` holds iteration ``it``, ``first`` being the
        step count when the epoch began."""
        if not rows:
            return
        ring = self._ring.cpu().tolist()
        keys = self._ring_keys
        for it, (m, n) in enumerate(rows):
            got = dict(zip(keys, ring[(first + it) % len(ring)]))
            loss = got["loss"]
            if not np.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite loss at epoch {self.epoch} iter {it}: {got}")
            v, cnt = Meter.collect_loss_by(loss, m, n)
            meter.accumulate(v, cnt)
            if "loss2" in got:  # cross-pseudo meters both nets
                v, cnt = Meter.collect_loss_by(got["loss2"], m, n)
                meter.accumulate(v, cnt)

    # ------------------------------------------------------------ validation
    def validate_epoch(self, loader: BatchLoader, npys: Dict[str, np.ndarray],
                       meter: Optional[Meter] = None
                       ) -> Tuple[int, Dict[str, np.ndarray]]:
        """The eval sweep: with ``eval_scan`` from the test set kept on the
        card (:meth:`_validate_epoch_scan`), else per batch, partial
        batches zero-padded to ``batch_size`` (one shape for every call);
        either way the losses and uint8 predictions stay on the card until
        the sweep ends."""
        if self.cfg.eval_scan:
            return self._validate_epoch_scan(loader, npys, meter)
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
        metas = [(b.batch_size, int(b.mdl[0]), b.names) for b in batches]
        return self._scatter(losses, preds, metas, prd_npys, meter)

    @staticmethod
    def _scatter(losses, preds, metas, prd_npys, meter):
        """Meter the sweep's losses and put its predictions (the valid rows
        of every batch, in order) into the volumes."""
        n_prd_slic, row = 0, 0
        for loss, (b, mdl, names) in zip(losses, metas):
            if meter is not None:
                v, n = Meter.collect_loss_by(loss, mdl, b)
                meter.accumulate(v, n)
            for i in range(b):
                m, pid, z = names[i].split("_")
                prd_npys[f"{m}_{pid}"][int(z)] = preds[row + i]
                n_prd_slic += 1
            row += b
        return n_prd_slic, prd_npys

    def _eval_stack(self, loader: BatchLoader):
        """The test batches stacked once per loader (the sweep never
        changes): uint8 images and masks [N,B,H,W], partial batches
        zero-padded, float32 row validity [N,B], and per batch (valid
        rows, modality, names)."""
        cached = self._eval_cache
        if cached is not None and cached[0] is loader:
            return cached[1], cached[2]
        B = self.cfg.batch_size
        ds = loader.dataset
        imgs, msks, valid, metas = [], [], [], []
        for idxs in loader.sampler:
            fast = ds.gather_batch_u8(idxs)
            if fast is not None:
                img, msk = fast
            else:
                raws = [ds.get_raw(i) for i in idxs]
                img = np.stack([r[0] for r in raws])
                msk = np.stack([r[1] for r in raws])
            mdl = int(ds.samples[idxs[0]][2])
            assert all(ds.samples[i][2] == mdl for i in idxs)
            b = len(idxs)
            pad = ((0, B - b), (0, 0), (0, 0))
            imgs.append(np.pad(img, pad))
            msks.append(np.pad(msk, pad))
            valid.append((np.arange(B) < b).astype(np.float32))
            metas.append((b, mdl, [ds.samples[i][3] for i in idxs]))
        stack = tuple(np.stack(a) if a else None
                      for a in (imgs, msks, valid))
        self._eval_cache = (loader, stack, metas)
        return stack, metas

    def _eval_batch(self, inp: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """One stacked test batch on the device, replayed as a CUDA graph
        on the card: uint8 -> [-1, 1] through the host normalisation's
        table (so the values are the per-batch path's to the bit), padded
        rows exactly 0, then the eval forward, loss and uint8 argmax."""
        img8 = inp["img"]
        img = self._eval_lut.index_select(0, img8.reshape(-1).long()).view(
            img8.shape)
        img = torch.where(inp["valid"][:, None, None] > 0, img, 0.0)
        loss, pred = self._eval_step(self._eval_params, img[..., None],
                                     inp["msk"].long())
        return {"loss": loss, "pred": pred}

    def _validate_epoch_scan(self, loader: BatchLoader,
                             npys: Dict[str, np.ndarray],
                             meter: Optional[Meter] = None
                             ) -> Tuple[int, Dict[str, np.ndarray]]:
        """Port of the JAX ``_validate_epoch_scan``: the stacked test set
        lives on the card for the run (copied once per loader), each batch
        is one replay of the eval graph, and the losses and predictions
        are read once."""
        (imgs, msks, valid), metas = self._eval_stack(loader)
        prd_npys = {k: np.zeros(v.shape, dtype=v.dtype)
                    for k, v in npys.items()}
        if not metas:
            return 0, prd_npys
        dev = self._eval_dev
        if dev is None or dev[0] is not loader:
            dev = self._eval_dev = (loader, [
                torch.from_numpy(a).to(self.device)
                for a in (imgs, msks, valid)])
        imgs, msks, valid = dev[1]
        fresh = self.algo.eval_params(self.state)
        if self._eval_params is None:
            self._eval_params = fresh
            self._eval_lut = torch.from_numpy(normalize_img(
                np.arange(256, dtype=np.uint8))).to(self.device)
            self._eval_replay = Replay(self._eval_batch, self.device,
                                       self.capture)
        else:   # the graph reads these buffers
            torch._foreach_copy_(list(self._eval_params.values()),
                                 [fresh[k] for k in self._eval_params])
        n = imgs.shape[0]
        losses = torch.empty(n, dtype=torch.float32, device=self.device)
        preds = torch.empty(imgs.shape, dtype=torch.uint8, device=self.device)
        for j in range(n):
            out = self._eval_replay({"img": imgs[j], "msk": msks[j],
                                     "valid": valid[j]})
            losses[j].copy_(out["loss"])
            preds[j].copy_(out["pred"])
        losses = losses.cpu().tolist()
        preds = preds.cpu().numpy()
        rows = np.concatenate([preds[j, :b] for j, (b, _, _) in
                               enumerate(metas)])
        return self._scatter(losses, rows, metas, prd_npys, meter)

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
