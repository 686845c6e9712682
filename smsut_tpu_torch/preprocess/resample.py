# -*- coding: utf-8 -*-
"""Spacing resample and centre crop: a copy of
``smsut_tpu/preprocess/resample.py``, SimpleITK's recipe of the original
CHAOS preparation.  The new size from the spacing ratio (truncated), x and
y at least ``crop_size``, the spacing recomputed from the integer size,
B-spline (order 3) for images and nearest (order 0) for labels
(``scipy.ndimage.zoom``), then the centre crop in x and y."""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage

from smsut_tpu_torch.preprocess.niftio import Volume


def resample_to_spacing(vol: Volume, new_spacing: Tuple[float, float, float],
                        crop_size: int, is_label: bool) -> Volume:
    nx, ny, nz = vol.size
    sx, sy, sz = vol.spacing
    new_size = [int(nx * sx / new_spacing[0]), int(ny * sy / new_spacing[1]),
                int(nz * sz / new_spacing[2])]
    for i in range(2):
        new_size[i] = max(crop_size, new_size[i])
    round_spacing = (sx * nx / new_size[0], sy * ny / new_size[1],
                     sz * nz / new_size[2])
    zoom = (new_size[2] / nz, new_size[1] / ny, new_size[0] / nx)  # z,y,x
    order = 0 if is_label else 3
    data = ndimage.zoom(vol.data.astype(vol.data.dtype if is_label
                                        else np.float32),
                        zoom, order=order, mode="nearest", grid_mode=False)
    # zoom can round sizes; force exact target shape
    data = _fix_shape(data, (new_size[2], new_size[1], new_size[0]))
    return Volume(data, round_spacing)


def center_crop_xy(vol: Volume, crop_size: int) -> Volume:
    nz, ny, nx = vol.data.shape
    dx = (nx - crop_size) // 2
    dy = (ny - crop_size) // 2
    return Volume(vol.data[:, dy: dy + crop_size, dx: dx + crop_size],
                  vol.spacing)


def resample_and_crop(vol: Volume, new_spacing, crop_size: int,
                      is_label: bool) -> Volume:
    return center_crop_xy(resample_to_spacing(vol, new_spacing, crop_size,
                                              is_label), crop_size)


def _fix_shape(data: np.ndarray, shape) -> np.ndarray:
    slices = tuple(slice(0, min(a, b)) for a, b in zip(data.shape, shape))
    out = np.zeros(shape, data.dtype)
    out[slices] = data[slices]
    return out
