# -*- coding: utf-8 -*-
"""CHAOS MR -> ``{modality}/{images,labels}/{modality}_{pid}.nii.gz``: the
port of ``smsut_tpu/preprocess/chaos.py``.

Per modality (t1in, t1out, t2): the DICOM series (each modality's own
directory), the ground-truth PNGs decoded to label ids by the liver,
kidney and spleen intensity windows, the image resampled to
``new_spacing`` by B-spline and the label by nearest neighbour (x and y
at least the crop size), the centre crop.  The ground-truth PNGs are read
with the port's own codec (``utils/io.py`` ``imread_gray``: 8-bit
greyscale, non-interlaced, every row filter), where the JAX package calls
OpenCV's ``imread(..., IMREAD_GRAYSCALE)``; any other PNG raises with its
file's name instead of being converted."""
from __future__ import annotations

import os
from os.path import join as pjoin
from typing import Dict, Tuple

import numpy as np

from smsut_tpu_torch.preprocess.dicom_lite import read_dicom_series
from smsut_tpu_torch.preprocess.niftio import Volume, write_nifti
from smsut_tpu_torch.preprocess.resample import resample_and_crop
from smsut_tpu_torch.utils.io import imread_gray, maybe_mkdir

LABEL_RANGE = ((0, 0),        # background
               (55, 70),      # liver
               (110, 135),    # right kidney
               (175, 200),    # left kidney
               (240, 255))    # spleen


def decode_label_png(label: np.ndarray) -> np.ndarray:
    mask = np.zeros(label.shape, np.int8)
    for i, (mi, ma) in enumerate(LABEL_RANGE):
        if i == 0:
            continue
        mask[(label >= mi) & (label <= ma)] = i
    return mask


class ChaosPreparation:
    def __init__(self, root: str, modality: str):
        assert modality in ("t1in", "t1out", "t2")
        self.root = root
        self.modality = modality

    def _paths(self, pid: str) -> Tuple[str, str]:
        if self.modality == "t1in":
            return (pjoin(self.root, "MR", pid, "T1DUAL", "DICOM_anon", "InPhase"),
                    pjoin(self.root, "MR", pid, "T1DUAL", "Ground"))
        if self.modality == "t1out":
            return (pjoin(self.root, "MR", pid, "T1DUAL", "DICOM_anon", "OutPhase"),
                    pjoin(self.root, "MR", pid, "T1DUAL", "Ground"))
        return (pjoin(self.root, "MR", pid, "T2SPIR", "DICOM_anon"),
                pjoin(self.root, "MR", pid, "T2SPIR", "Ground"))

    def collect(self, new_spacing, crop_size: int) -> Dict[str, Tuple[Volume, Volume]]:
        out = {}
        for pid in sorted(os.listdir(pjoin(self.root, "MR"))):
            img_root, lbl_root = self._paths(pid)
            image = read_dicom_series(img_root)
            lbls = [imread_gray(pjoin(lbl_root, png))
                    for png in sorted(os.listdir(lbl_root))]
            label = Volume(decode_label_png(np.array(lbls)), image.spacing)
            image = resample_and_crop(image, new_spacing, crop_size, False)
            label = resample_and_crop(label, new_spacing, crop_size, True)
            out[f"{self.modality}_{pid.rjust(3, '0')}"] = (image, label)
        return out

    def run(self, save_root: str, new_spacing, crop_size: int) -> None:
        modality_root = pjoin(save_root, self.modality)
        img_root = pjoin(modality_root, "images")
        lbl_root = pjoin(modality_root, "labels")
        maybe_mkdir(save_root, modality_root, img_root, lbl_root)
        for pid, (image, label) in self.collect(new_spacing, crop_size).items():
            write_nifti(image, pjoin(img_root, f"{pid}.nii.gz"))
            write_nifti(label, pjoin(lbl_root, f"{pid}.nii.gz"))
