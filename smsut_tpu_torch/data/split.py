# -*- coding: utf-8 -*-
"""Split files: reading, writing and 5-fold semi-supervised split
generation.  A copy of ``smsut_tpu/data/split.py``: ratios (1, 9, 10), i.e.
5% labelled train / 45% unlabelled val / 50% test per modality, rotating
folds, t1in and t1out sharing patient splits."""
from __future__ import annotations

import random
from typing import Dict, List, Sequence

from smsut_tpu_torch.config import MODALITIES
from smsut_tpu_torch.utils.io import read_yaml, write_yaml


def make_semi_split(pids_per_modality: Dict[str, List[str]],
                    ratios: Sequence[int] = (1, 9, 10), n_fold: int = 5,
                    seed: int = 2020) -> Dict:
    """Build the split dict {modality: {train: {fold: [pid]}, val: {...},
    test: [pid]}}.  t1in and t1out are forced to share patient splits."""
    rng = random.Random(seed)
    total = sum(ratios)
    split: Dict = {}
    shared_order: Dict[str, List[int]] = {}

    for modality in MODALITIES:
        pids = sorted(pids_per_modality.get(modality, []))
        n = len(pids)
        if n == 0:
            continue
        if modality in ("t1in", "t1out") and "t1" in shared_order and \
                len(shared_order["t1"]) == n:
            order = shared_order["t1"]
        else:
            order = list(range(n))
            rng.shuffle(order)
            if modality in ("t1in", "t1out"):
                shared_order["t1"] = order
        shuffled = [pids[i] for i in order]

        n_test = max(1, round(n * ratios[2] / total))
        test = shuffled[:n_test]
        pool = shuffled[n_test:]
        n_train = max(1, round(len(pool) * ratios[0] / (ratios[0] + ratios[1])))

        # train/val are n_fold-element lists indexed by fold
        train_folds, val_folds = [], []
        for fold in range(n_fold):
            rot = pool[fold * n_train % len(pool):] + pool[: fold * n_train % len(pool)]
            train_folds.append(rot[:n_train])
            val_folds.append(rot[n_train:])
        split[modality] = {"train": train_folds, "val": val_folds, "test": test}
        _check_split_modality(modality, split[modality], pids, n_fold)

    return split


def _check_split_modality(modality: str, s: Dict, volumes: Sequence[str],
                          n_fold: int) -> None:
    """Every volume appears EXACTLY once per fold across train/val/test —
    completeness (no volume dropped) AND uniqueness."""
    for fold in range(n_fold):
        counts = {v: 0 for v in volumes}
        for k in list(s["test"]) + list(s["train"][fold]) + list(s["val"][fold]):
            assert k in counts, f"unknown pid {k!r} in {modality} fold {fold}"
            counts[k] += 1
        for k, v in counts.items():
            assert v == 1, \
                f"pid {k!r} appears {v}x in {modality} fold {fold}"


def load_split(path: str) -> Dict:
    return read_yaml(path)


def save_split(split: Dict, path: str) -> None:
    write_yaml(split, path)
