# -*- coding: utf-8 -*-
"""Synthetic dataset generator for tests and the card's smoke run.

A copy of ``smsut_tpu/data/synthetic.py`` that writes its PNGs with the
port's codec (``utils/io.py``): one seed gives the same pixels, labels,
volumes and split file as the JAX package's.  It writes a PNG tree with the
exact on-disk layout the loaders expect
(`{root}/{modality}/{pid}/{images,labels}/{modality}_{pid}_{zzz}.png` +
per-patient 3-D label npy + split yaml), with blob-shaped organs so dice
improves measurably during smoke training."""
from __future__ import annotations

from os.path import join as pjoin
from typing import Dict, List

import numpy as np

from smsut_tpu_torch.config import MODALITIES
from smsut_tpu_torch.utils.io import imwrite_gray, maybe_mkdir, write_yaml


def _make_volume(rng: np.random.Generator, n_slice: int, size: int,
                 n_label: int) -> (np.ndarray, np.ndarray):
    """A volume of images with bright disk 'organs'; labels mark the disks."""
    imgs = np.zeros((n_slice, size, size), np.uint8)
    lbls = np.zeros((n_slice, size, size), np.uint8)
    yy, xx = np.mgrid[:size, :size]
    for z in range(n_slice):
        base = rng.integers(20, 60)
        img = np.full((size, size), base, np.float32)
        img += rng.normal(0, 5, (size, size))
        for organ in range(1, n_label + 1):
            cy = rng.integers(size // 4, 3 * size // 4)
            cx = rng.integers(size // 4, 3 * size // 4)
            r = rng.integers(max(2, size // 12), max(3, size // 6))
            mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2
            img[mask] = 80 + 40 * organ + rng.normal(0, 3)
            lbls[z][mask] = organ
        imgs[z] = np.clip(img, 0, 255).astype(np.uint8)
    return imgs, lbls


def make_synthetic_dataset(root: str, n_patients_per_modality: int = 3,
                           n_slice: int = 4, size: int = 64, n_label: int = 4,
                           split_yaml: str = "semi-1910.yaml", n_fold: int = 5,
                           seed: int = 2020) -> str:
    rng = np.random.default_rng(seed)
    split: Dict = {}
    for m in MODALITIES:
        pids: List[str] = []
        for p in range(n_patients_per_modality):
            pid = str(p + 1).rjust(3, "0")
            pids.append(pid)
            img_dir = pjoin(root, m, pid, "images")
            lbl_dir = pjoin(root, m, pid, "labels")
            maybe_mkdir(img_dir, lbl_dir)
            imgs, lbls = _make_volume(rng, n_slice, size, n_label)
            for z in range(n_slice):
                name = f"{m}_{pid}_{str(z).rjust(3, '0')}.png"
                imwrite_gray(pjoin(img_dir, name), imgs[z])
                imwrite_gray(pjoin(lbl_dir, name), lbls[z])
            np.save(pjoin(root, m, pid, f"{m}_{pid}.npy"), lbls)
        # simple split: first pid train, second val, third test (per fold same)
        n_tr = max(1, n_patients_per_modality // 3)
        n_va = max(1, (n_patients_per_modality - n_tr) // 2)
        split[m] = {
            "train": [pids[:n_tr] for _ in range(n_fold)],
            "val": [pids[n_tr:n_tr + n_va] for _ in range(n_fold)],
            "test": pids[n_tr + n_va:] or pids[-1:],
        }
    write_yaml(split, pjoin(root, split_yaml))
    return root
