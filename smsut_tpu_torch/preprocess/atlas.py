# -*- coding: utf-8 -*-
"""Multi-Atlas (BTCV) CT -> ``ct/{images,labels}/ct_{pid}.nii.gz``: a copy
of ``smsut_tpu/preprocess/atlas.py``.

BTCV label ids {6, 2, 3, 1} become {1, 2, 3, 4} (liver, right kidney, left
kidney, spleen); the z range is cut to the labelled slices; the y axis is
flipped; then the resample and centre crop of the CHAOS preparation."""
from __future__ import annotations

import os
from os.path import join as pjoin
from typing import Dict, Tuple

import numpy as np

from smsut_tpu_torch.preprocess.niftio import Volume, read_nifti, write_nifti
from smsut_tpu_torch.preprocess.resample import resample_and_crop
from smsut_tpu_torch.utils.io import maybe_mkdir

BTCV_LABELS = (0, 6, 2, 3, 1)  # index == ours, value == BTCV id


def remap_labels(label: np.ndarray) -> np.ndarray:
    mask = np.zeros(label.shape, np.uint8)
    for i, origin in enumerate(BTCV_LABELS):
        if i == 0:
            continue
        mask[label == origin] = i
    return mask


class AtlasPreparation:
    def __init__(self, root: str):
        self.root = root

    def collect(self, new_spacing, crop_size: int) -> Dict[str, Tuple[Volume, Volume]]:
        out = {}
        img_root = pjoin(self.root, "Training", "img")
        lbl_root = pjoin(self.root, "Training", "label")
        for name in sorted(os.listdir(img_root)):
            image = read_nifti(pjoin(img_root, name))
            label = read_nifti(pjoin(lbl_root, name.replace("img", "label")))
            mask = remap_labels(label.data)

            has_label = np.any(mask != 0, axis=(1, 2))
            idx = np.where(has_label)[0]
            if idx.size == 0 or idx[0] >= idx[-1]:
                continue
            start, end = int(idx[0]), int(idx[-1])
            mask = mask[start: end + 1]
            img_data = image.data[start: end + 1]

            # the y-axis flip of the original preparation
            img_data = img_data[:, ::-1, :].copy()
            mask = mask[:, ::-1, :].copy()

            orig_spacing = image.spacing
            image = resample_and_crop(Volume(img_data, orig_spacing),
                                      new_spacing, crop_size, False)
            label = resample_and_crop(Volume(mask, orig_spacing),
                                      new_spacing, crop_size, True)
            out[f"ct_{name[4:7]}"] = (image, label)
        return out

    def run(self, save_root: str, new_spacing, crop_size: int) -> None:
        modality_root = pjoin(save_root, "ct")
        img_root = pjoin(modality_root, "images")
        lbl_root = pjoin(modality_root, "labels")
        maybe_mkdir(save_root, modality_root, img_root, lbl_root)
        for pid, (image, label) in self.collect(new_spacing, crop_size).items():
            write_nifti(image, pjoin(img_root, f"{pid}.nii.gz"))
            write_nifti(label, pjoin(lbl_root, f"{pid}.nii.gz"))
