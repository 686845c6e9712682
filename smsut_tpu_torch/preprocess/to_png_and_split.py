# -*- coding: utf-8 -*-
"""nii.gz volumes -> per-slice PNGs, the 3-D label ``.npy`` and the
semi-supervised split YAML: the port of
``smsut_tpu/preprocess/to_png_and_split.py``.

:func:`to_png`, per volume: the intensity clip (CT the fixed window
[-1000, 400], MR the percentiles [0.05, 99.5]), min-max to [0, 255], the
8-bit slices ``{modality}_{pid}_{zzz}.png`` under
``{modality}/{pid}/{images,labels}/`` written by the port's own PNG codec
(``utils/io.py`` ``imwrite_gray``, where the JAX package calls OpenCV's
``imwrite``: other bytes, the same pixels), and the whole label volume as
``{modality}_{pid}.npy``.

:func:`split_train_val_test`: ``data/split.py`` ``make_semi_split`` with
the (1, 9, 10) ratios (5% labelled train, 45% unlabelled, 50% test per
modality, 5 rotating folds, t1in and t1out sharing patients) over the
four modality names."""
from __future__ import annotations

import os
from os.path import join as pjoin
from typing import Dict, List

import numpy as np

from smsut_tpu_torch.config import MODALITIES, Config
from smsut_tpu_torch.data.split import make_semi_split, save_split
from smsut_tpu_torch.preprocess.niftio import read_nifti
from smsut_tpu_torch.utils.io import imwrite_gray, maybe_mkdir


def to_png(src: str, dst: str) -> None:
    maybe_mkdir(dst)
    for modality in sorted(os.listdir(src)):
        if not os.path.isdir(pjoin(src, modality)):
            continue
        dst_modal_root = pjoin(dst, modality)
        maybe_mkdir(dst_modal_root)
        src_img_root = pjoin(src, modality, "images")
        for name in sorted(os.listdir(src_img_root)):
            image = read_nifti(pjoin(src_img_root, name)).data.astype(np.float32)
            label = read_nifti(pjoin(src_img_root, name)
                               .replace("images", "labels")).data

            if modality == "ct":
                mi, ma = -1000.0, 400.0
            else:
                mi, ma = np.percentile(image, 0.05), np.percentile(image, 99.5)
            image = np.clip(image, mi, ma)
            image = (image - image.min()) / max(image.max() - image.min(), 1e-8) * 255

            pid = name.split("_")[1][:3]
            pid_root = pjoin(dst_modal_root, pid)
            img_root = pjoin(pid_root, "images")
            lbl_root = pjoin(pid_root, "labels")
            maybe_mkdir(pid_root, img_root, lbl_root)
            np.save(pjoin(pid_root, name.replace(".nii.gz", ".npy")),
                    label.astype(np.uint8))
            for z in range(image.shape[0]):
                png = f"{modality}_{pid}_{str(z).rjust(3, '0')}.png"
                imwrite_gray(pjoin(img_root, png), image[z].astype(np.uint8))
                imwrite_gray(pjoin(lbl_root, png), label[z].astype(np.uint8))


def split_train_val_test(data_root: str, save_root: str = "",
                         cfg: Config = None) -> Dict:
    cfg = cfg or Config()
    pids: Dict[str, List[str]] = {}
    for modality in MODALITIES:
        mroot = pjoin(data_root, modality)
        if not os.path.isdir(mroot):
            continue
        pids[modality] = [p for p in os.listdir(mroot)
                          if os.path.isdir(pjoin(mroot, p))]
    split = make_semi_split(pids, ratios=(1, 9, 10), n_fold=5, seed=cfg.seed)
    save_split(split, pjoin(save_root or data_root, cfg.split_yaml))
    return split
