# -*- coding: utf-8 -*-
"""PNG slice dataset and batch loaders.

Port of ``smsut_tpu/data/dataset.py``.  The on-disk tree is
``{root}/{modality}/{pid}/{images,labels}/{modality}_{pid}_{zzz}.png`` plus
a 3-D ``{modality}_{pid}.npy`` label volume per patient; batches carry
(img [B,H,W,1] float32 in [-1,1], msk [B,H,W] int32, mdl [B] int32, names),
or with ``raw`` the uint8 [B,H,W] image and mask for the device
augmentation.

Decoding and host augmentation run in a thread pool with a prefetch queue
of ``prefetch_depth`` batches.  In RAM mode every image set and every label
set is one contiguous uint8 array, decoded once, so that a batch gather is
one numpy take (the JAX package does this with ``native/slicecache.cpp``).
"""
from __future__ import annotations

import concurrent.futures as futures
import os
import queue
import random
import threading
from dataclasses import dataclass, field
from os.path import join as pjoin
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from smsut_tpu_torch.config import Config, MODALITIES, Modality
from smsut_tpu_torch.data.augment import JointAugment, normalize_img
from smsut_tpu_torch.data.samplers import (
    InTurnTestBatchSampler,
    InTurnTrainBatchSampler,
    ModalityBalanceBatchSampler,
    ShardedBatchSampler,
)
from smsut_tpu_torch.parallel import distributed
from smsut_tpu_torch.utils.io import imread_gray, read_yaml


@dataclass
class Batch:
    img: np.ndarray            # [B, H, W, 1] float32 in [-1, 1]
    msk: np.ndarray            # [B, H, W] int32
    mdl: np.ndarray            # [B] int32
    names: List[str] = field(default_factory=list)  # '{modal}_{pid}_{zzz}'

    @property
    def batch_size(self) -> int:
        return self.img.shape[0]


class SliceDataset:
    """Flat list of (img, msk, modality_id, name) slices from the split
    file."""

    def __init__(self, data_root: str, phase: str, fold: int = 0,
                 load_in_ram: bool = True, split_yaml: str = "semi-1910.yaml"):
        self.data_root = data_root
        self.phase = phase
        self.fold = fold
        self.load_in_ram = load_in_ram
        self.samples: List[Tuple] = []
        self.modal_sample_ids: List[List[int]] = [[] for _ in MODALITIES]
        split = read_yaml(pjoin(data_root, split_yaml))
        n = 0
        for m in MODALITIES:
            if m not in split:
                continue
            part = split[m][phase] if phase == "test" else split[m][phase][fold]
            for pid in part:
                pid_root = pjoin(data_root, m, str(pid), "images")
                for png in sorted(os.listdir(pid_root)):
                    img_p = pjoin(pid_root, png)
                    msk_p = img_p.replace("images", "labels")
                    self.samples.append((img_p, msk_p, Modality[m].value,
                                         png.replace(".png", "")))
                    self.modal_sample_ids[Modality[m].value].append(n)
                    n += 1
        self.n = n
        self._img = self._msk = None
        if load_in_ram and n:
            # [N, H, W] uint8 each; np.stack refuses slices of other sizes
            self._img = np.stack([imread_gray(s[0]) for s in self.samples])
            self._msk = np.stack([imread_gray(s[1]) for s in self.samples])

    def __len__(self) -> int:
        return self.n

    def get_raw(self, i: int) -> Tuple[np.ndarray, np.ndarray, int, str]:
        img_p, msk_p, mdl, name = self.samples[i]
        if self._img is not None:
            return self._img[i], self._msk[i], mdl, name
        return imread_gray(img_p), imread_gray(msk_p), mdl, name

    def gather_batch_u8(self, idxs: Sequence[int]):
        """RAM mode: the uint8 [B,H,W] image and mask blocks of ``idxs``;
        None otherwise."""
        if self._img is None:
            return None
        idxs = np.asarray(idxs, np.int64)
        return np.take(self._img, idxs, 0), np.take(self._msk, idxs, 0)

    def __repr__(self) -> str:
        return (f"{self.__class__.__name__}(samples={self.n}, "
                f"phase={self.phase} {self.fold})")


class BatchLoader:
    """Sampler + augmentation + collation with threaded prefetch."""

    def __init__(self, dataset: SliceDataset, sampler, augment: Optional[JointAugment],
                 num_workers: int = 6, prefetch_depth: int = 2, raw: bool = False):
        self.dataset = dataset
        self.sampler = sampler
        self.augment = augment
        self.raw = raw  # yield uint8 [B,H,W] pairs for the device augmentation
        self.num_workers = max(1, num_workers)
        self.prefetch_depth = prefetch_depth
        # optional producer-thread hook: Batch -> item yielded by __iter__
        # (the Trainer draws the device augmentation's parameters and pins
        # the batch here, so that the training thread only dispatches)
        self.post = None
        self._pool = futures.ThreadPoolExecutor(max_workers=self.num_workers)
        self._cycle_q = None

    def _make_sample(self, i: int) -> Tuple[np.ndarray, np.ndarray, int, str]:
        img, msk, mdl, name = self.dataset.get_raw(i)
        if self.raw:
            return img, msk, mdl, name
        if self.augment is not None:
            img, msk = self.augment(img, msk)
        return normalize_img(img), msk.astype(np.int32), mdl, name

    def _collate(self, idxs: Sequence[int]) -> Batch:
        if self.raw:
            fast = self.dataset.gather_batch_u8(idxs)
            if fast is not None:
                img, msk = fast
                mdl = np.asarray([self.dataset.samples[i][2] for i in idxs],
                                 np.int32)
                names = [self.dataset.samples[i][3] for i in idxs]
                return Batch(img, msk, mdl, names)
        parts = list(self._pool.map(self._make_sample, idxs))
        img = np.stack([p[0] for p in parts])
        if not self.raw:
            img = img[..., None]
        msk = np.stack([p[1] for p in parts])
        if not self.raw:
            msk = msk.astype(np.int32)
        mdl = np.asarray([p[2] for p in parts], np.int32)
        names = [p[3] for p in parts]
        return Batch(img, msk, mdl, names)

    def _item(self, idxs: Sequence[int]):
        item = self._collate(idxs)
        return item if self.post is None else self.post(item)

    def __iter__(self) -> Iterator[Batch]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = object()

        def producer():
            try:
                for idxs in self.sampler:
                    q.put(self._item(idxs))
            except Exception as e:  # handed to the consumer, re-raised
                q.put(e)
            finally:
                q.put(stop)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item

    def iter_cycle(self) -> Iterator[Batch]:
        """Endless stream from ONE persistent producer thread: training
        pulls ``num_iter_per_epoch`` batches whatever the sampler's length,
        and restarting ``__iter__`` at every wraparound would leave a
        blocked producer thread behind each time."""
        if self._cycle_q is None:
            q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)

            def producer():
                try:
                    while True:
                        for idxs in self.sampler:
                            q.put(self._item(idxs))
                except Exception as e:  # handed to the consumer
                    q.put(e)

            threading.Thread(target=producer, daemon=True).start()
            self._cycle_q = q
        while True:
            item = self._cycle_q.get()
            if isinstance(item, BaseException):
                raise item
            yield item

    def __len__(self) -> int:
        return len(self.sampler)


def get_loader(data_root: str, phase: str, fold: int, batch_size: int,
               data_aug: Optional[Dict] = None, load_in_ram: bool = True,
               cfg: Optional[Config] = None, loader_type: str = "inTurn",
               rng: Optional[random.Random] = None,
               raw: bool = False, num_shards: Optional[int] = None,
               shard_id: Optional[int] = None) -> BatchLoader:
    """The in-turn loader (single-modality batches); ``loader_type=
    'balance'`` selects the modality-balanced sampler.  Test loaders walk
    each modality in order, with a partial last batch.

    Train and val samplers keep a rank's contiguous rows of every global
    batch (:class:`ShardedBatchSampler`); ``num_shards``/``shard_id``
    default to the process group's data axis (``parallel.distributed``:
    the ranks of a space group take the same rows).
    Test loaders stay global.  The host augmentation (``raw`` False)
    draws for the rank's rows only (ROADMAP C5)."""
    cfg = cfg or Config()
    rng = rng or random.Random()
    dataset = SliceDataset(data_root, phase, fold, load_in_ram, cfg.split_yaml)
    if phase in ("train", "val"):
        augment = JointAugment(data_aug, rng) if data_aug else None
        if loader_type == "inTurn":
            sampler = InTurnTrainBatchSampler(dataset.modal_sample_ids, batch_size,
                                              shuffle=False, rng=rng)
        elif loader_type == "balance":
            sampler = ModalityBalanceBatchSampler(dataset.modal_sample_ids,
                                                  batch_size, rng=rng)
        else:
            raise NotImplementedError(loader_type)
        if num_shards is None:
            num_shards = distributed.data_count()
            shard_id = distributed.data_index()
        if num_shards > 1:
            sampler = ShardedBatchSampler(sampler, num_shards, shard_id or 0)
    else:
        augment = None
        sampler = InTurnTestBatchSampler(dataset.modal_sample_ids, batch_size)
    return BatchLoader(dataset, sampler, None if raw else augment,
                       cfg.num_workers, cfg.prefetch_depth, raw=raw)


def get_label_npys(data_root: str, phase: str,
                   split_yaml: str = "semi-1910.yaml") -> Tuple[int, Dict[str, np.ndarray]]:
    """Ground-truth 3-D label volumes keyed '{modal}_{pid}', and their
    total slice count."""
    retn, n = {}, 0
    split = read_yaml(pjoin(data_root, split_yaml))
    for m in MODALITIES:
        if m not in split:
            continue
        for p in split[m][phase]:
            npy = np.load(pjoin(data_root, m, str(p), f"{m}_{p}.npy"))
            n += npy.shape[0]
            retn[f"{m}_{p}"] = npy
    return n, retn
