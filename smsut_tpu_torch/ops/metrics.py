# -*- coding: utf-8 -*-
"""Evaluation metrics on the host: a copy of the host part of
``smsut_tpu/ops/metrics.py`` on numpy and scipy.

Volume Dice and ASSD with ``medpy.metric.dc``/``assd`` semantics, the
Hausdorff distance, the connected-component filtering, and the
modality x organ matrices of the test phase with their CSV form.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
from scipy import ndimage

from smsut_tpu_torch.config import Config, Modality


# ---------------------------------------------------------------------------
# host-side: medpy-equivalent dc / assd
# ---------------------------------------------------------------------------

def dice_coefficient(pred: np.ndarray, gt: np.ndarray) -> float:
    """medpy.metric.dc semantics: 2|P∧G|/(|P|+|G|), 0.0 when both empty."""
    pred = np.asarray(pred, dtype=bool)
    gt = np.asarray(gt, dtype=bool)
    denom = pred.sum() + gt.sum()
    if denom == 0:
        return 0.0
    return 2.0 * np.logical_and(pred, gt).sum() / float(denom)


def _surface_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distances from a's border voxels to b's border (medpy
    `__surface_distances`, connectivity-1 footprint, unit spacing)."""
    a = np.atleast_1d(a.astype(bool))
    b = np.atleast_1d(b.astype(bool))
    footprint = ndimage.generate_binary_structure(a.ndim, 1)
    if a.sum() == 0 or b.sum() == 0:
        raise RuntimeError("surface distance of empty structure")
    a_border = a ^ ndimage.binary_erosion(a, structure=footprint, iterations=1)
    b_border = b ^ ndimage.binary_erosion(b, structure=footprint, iterations=1)
    dt = ndimage.distance_transform_edt(~b_border)
    return dt[a_border]


def assd_metric(pred: np.ndarray, gt: np.ndarray) -> float:
    """medpy.metric.assd: mean of all symmetric surface distances."""
    sds = np.concatenate([_surface_distances(pred, gt),
                          _surface_distances(gt, pred)])
    return float(sds.mean())


def hd_metric(pred: np.ndarray, gt: np.ndarray) -> float:
    """medpy.metric.hd: max of the two directed Hausdorff distances.  The
    genuine metric the paper reports; the reference fills its HD slot with
    dice, and so does ``get_all_matrix`` unless ``Config.real_hd``."""
    return float(max(_surface_distances(pred, gt).max(),
                     _surface_distances(gt, pred).max()))


def connected_components(pred: np.ndarray, n_label: int = 4) -> np.ndarray:
    """Drop per-class components smaller than 10% of the class's foreground
    (connectivity=2 == full neighbourhood)."""
    out = np.zeros_like(pred, dtype=np.uint8)
    structure = ndimage.generate_binary_structure(pred.ndim, 2)
    for i in range(n_label):
        cls = (pred == i + 1)
        labels, n_comp = ndimage.label(cls, structure=structure)
        if n_comp == 0:
            continue
        threshold = 0.1 * cls.sum()
        keep = np.zeros_like(cls)
        counts = np.bincount(labels.ravel())
        for j in range(1, n_comp + 1):
            if counts[j] > threshold:
                keep |= labels == j
        out[keep] = i + 1
    return out


# ---------------------------------------------------------------------------
# host-side: modality x organ matrices
# ---------------------------------------------------------------------------

def get_mo_matrix(prd_npys: Dict[str, np.ndarray], gt_npys: Dict[str, np.ndarray],
                  cfg: Config) -> np.ndarray:
    """(n_modal+1) x (n_label+1) mean-Dice matrix with mean row/col."""
    matrix = np.zeros((cfg.n_modal, cfg.n_label))
    n = np.zeros((cfg.n_modal, 1))
    for k in gt_npys.keys():
        m = Modality[k.split("_")[0]].value
        p, g = prd_npys[k], gt_npys[k]
        for i in range(cfg.n_label):
            matrix[m][i] += dice_coefficient(p == i + 1, g == i + 1)
        n[m] += 1
    n[n == 0] += 1e-8
    matrix /= n
    return _with_means(matrix, cfg)


def get_all_matrix(prd_npys: Dict[str, np.ndarray], gt_npys: Dict[str, np.ndarray],
                   cfg: Config) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dice / HD / ASSD matrices after connected-component filtering applied
    per-volume then per-slice.  The reference fills its HD slot with dice;
    kept for output parity (``Config.real_hd`` takes the real distance)."""
    dc_m = np.zeros((cfg.n_modal, cfg.n_label))
    hd_m = np.zeros((cfg.n_modal, cfg.n_label))
    assd_m = np.zeros((cfg.n_modal, cfg.n_label))
    n = np.zeros((cfg.n_modal, 1))
    for k in gt_npys.keys():
        m = Modality[k.split("_")[0]].value
        p, g = prd_npys[k], gt_npys[k]
        p1 = connected_components(p, cfg.n_label)
        for i in range(p1.shape[0]):
            p1[i] = connected_components(p1[i], cfg.n_label)
        max_assd = 0.0
        max_hd = 0.0
        real_hd = bool(getattr(cfg, "real_hd", False))
        for i in range(cfg.n_label):
            predx = (p1 == i + 1)
            gx = (g == i + 1)
            s = dice_coefficient(predx, gx)
            if predx.max() == 0:
                r = max_assd
                h = max_hd
            else:
                r = assd_metric(predx, gx)
                h = hd_metric(predx, gx) if real_hd else s
            max_assd = max(max_assd, r)
            max_hd = max(max_hd, h)
            dc_m[m][i] += s
            # reference quirk: HD slot == dice; Config.real_hd swaps in the
            # genuine Hausdorff distance
            hd_m[m][i] += h if real_hd else s
            assd_m[m][i] += r
        n[m] += 1
    n[n == 0] += 1e-8
    dc_m /= n
    hd_m /= n
    assd_m /= n
    return _with_means(dc_m, cfg), _with_means(hd_m, cfg), _with_means(assd_m, cfg)


def _with_means(matrix: np.ndarray, cfg: Config) -> np.ndarray:
    out = np.zeros((cfg.n_modal + 1, cfg.n_label + 1))
    out[: cfg.n_modal, : cfg.n_label] = matrix
    out[-1, :] = np.mean(out[0: cfg.n_modal], axis=0)
    out[:, -1] = np.mean(out[:, 0: cfg.n_label], axis=1)
    return out


def matrix_to_csv(*matrices: np.ndarray) -> str:
    """Serialize matrices as the reference's test phase writes them."""
    parts = []
    for mat in matrices:
        rows = [",".join("%.4f" % v for v in row) for row in mat]
        parts.append("\n".join(rows) + "\n")
    return "\n".join(parts)
