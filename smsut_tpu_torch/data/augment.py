# -*- coding: utf-8 -*-
"""Host-side joint (image, mask) augmentations.

A copy of ``smsut_tpu/data/augment.py`` on numpy and scipy: rotate
(bilinear image, nearest mask), elastic grid deformation (p = 0.5, order 0
for both), random resized crop (scale 0.6-1.0, torchvision parameter
sampling), optional colour jitter and gamma.  Masks always use nearest.

The JAX package rotates and resizes with OpenCV; here the same arithmetic
is written out in numpy:
- ``rotate_pair``: ``cv2.getRotationMatrix2D`` + ``cv2.warpAffine`` as
  OpenCV 5 computes them for uint8 -- the inverse map in float32, each
  source coordinate ``fma(m0, x, m1 * y + m2)``, bilinear weights in
  float32, rounded half to even; zero outside the image.
- ``resized_crop_pair``: ``cv2.resize`` -- bilinear in fixed point (11-bit
  weights, its vector rounding), source columns clamped with their weight,
  rows clamped after the weights are taken; nearest takes
  ``floor(dst * (1 / (dsize / ssize)))``.
``tests/test_torch_data.py`` holds both against OpenCV.

All transforms consume/produce uint8 arrays; randomness comes from an
explicit ``random.Random`` so samplers and augmentations share one seeding
discipline.
"""
from __future__ import annotations

import math
import random
from typing import Dict, Optional, Tuple

import numpy as np
from scipy import ndimage


def rotation_matrix(center: Tuple[float, float], angle: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, 1.0)``: counter-clockwise
    in degrees about ``center`` = (x, y)."""
    a = angle * (math.pi / 180.0)
    al, be = math.cos(a), math.sin(a)
    cx, cy = center
    return np.array([[al, be, (1 - al) * cx - be * cy],
                     [-be, al, be * cx + (1 - al) * cy]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform``, in float64."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def _fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding of the sum (the product of two
    float32 values is exact in float64)."""
    return (np.float64(a) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def _taps(src: np.ndarray, yi: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """src[yi, xi] as float32, 0 outside the image."""
    h, w = src.shape
    inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    v = src[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
    return np.where(inside, v, 0).astype(np.float32)


def warp_affine(src: np.ndarray, m: np.ndarray, nearest: bool) -> np.ndarray:
    """``cv2.warpAffine(src, m, (w, h), INTER_LINEAR or INTER_NEAREST,
    BORDER_CONSTANT, 0)`` of a 2-D uint8 image."""
    h, w = src.shape
    inv = _invert_affine(m).astype(np.float32)
    xs = np.arange(w, dtype=np.float32)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    sx = _fma32(inv[0, 0], xs, inv[0, 1] * ys + inv[0, 2])
    sy = _fma32(inv[1, 0], xs, inv[1, 1] * ys + inv[1, 2])
    if nearest:
        return _taps(src, np.rint(sy).astype(np.int64),
                     np.rint(sx).astype(np.int64)).astype(src.dtype)
    x0, y0 = np.floor(sx), np.floor(sy)
    ax, ay = sx - x0, sy - y0
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    p00, p01 = _taps(src, y0, x0), _taps(src, y0, x0 + 1)
    p10, p11 = _taps(src, y0 + 1, x0), _taps(src, y0 + 1, x0 + 1)
    v0 = p00 + ax * (p01 - p00)
    v1 = p10 + ax * (p11 - p10)
    return np.clip(np.rint(v0 + ay * (v1 - v0)), 0, 255).astype(np.uint8)


def rotate_pair(img: np.ndarray, msk: np.ndarray, angle: float) -> Tuple[np.ndarray, np.ndarray]:
    """Centre rotation, expand=False, zero fill."""
    h, w = img.shape
    mat = rotation_matrix((w / 2.0, h / 2.0), angle)
    return warp_affine(img, mat, False), warp_affine(msk, mat, True)


def elastic_deform_pair(img: np.ndarray, msk: np.ndarray, sigma: float,
                        points: int, rng: random.Random) -> Tuple[np.ndarray, np.ndarray]:
    """elasticdeform.deform_random_grid equivalent: a (2, points, points)
    normal(0, sigma) displacement grid, B-spline-interpolated over the image,
    order-0 resampling for both tensors."""
    h, w = img.shape
    np_rng = np.random.default_rng(rng.getrandbits(63))
    disp = np_rng.normal(0.0, sigma, size=(2, points, points))
    # cubic-spline upsample of the control grid to the full image
    zoom = (h / points, w / points)
    dy = ndimage.zoom(disp[0], zoom, order=3, mode="nearest")
    dx = ndimage.zoom(disp[1], zoom, order=3, mode="nearest")
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    coords = np.stack([yy + dy, xx + dx])
    img_d = ndimage.map_coordinates(img, coords, order=0, mode="constant")
    msk_d = ndimage.map_coordinates(msk, coords, order=0, mode="constant")
    return img_d, msk_d


def resized_crop_params(h: int, w: int, scale: Tuple[float, float],
                        ratio: Tuple[float, float], rng: random.Random
                        ) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params: 10 attempts of
    (area, log-uniform ratio) sampling, then center-crop fallback."""
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = rng.randint(0, h - ch)
            j = rng.randint(0, w - cw)
            return i, j, ch, cw
    # fallback: center crop at a clamped aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw = w
        ch = int(round(cw / ratio[0]))
    elif in_ratio > ratio[1]:
        ch = h
        cw = int(round(ch * ratio[1]))
    else:
        cw, ch = w, h
    i = (h - ch) // 2
    j = (w - cw) // 2
    return i, j, ch, cw


def _linear_taps(sn: int, dn: int):
    """cv2.resize's source index and float32 weight of the second tap per
    output index (half-pixel centres)."""
    f = ((np.arange(dn) + 0.5) * (1.0 / (dn / sn)) - 0.5).astype(np.float32)
    s = np.floor(f)
    return s.astype(np.int64), (f - s).astype(np.float32)


def _coef(f: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    one, scale = np.float32(1), np.float32(2048)
    return (np.rint((one - f) * scale).astype(np.int64),
            np.rint(f * scale).astype(np.int64))


def resize_linear(src: np.ndarray, size: int) -> np.ndarray:
    """``cv2.resize(src, (size, size), interpolation=INTER_LINEAR)`` of a
    2-D uint8 image."""
    h, w = src.shape
    if (h, w) == (size, size):
        return src.copy()
    sx, fx = _linear_taps(w, size)
    low, high = sx < 0, sx >= w - 1      # columns: clamped with the weight
    fx = np.where(low | high, np.float32(0), fx)
    sx = np.clip(sx, 0, w - 1)
    ax0, ax1 = _coef(fx)
    s = src.astype(np.int64)
    rows = s[:, sx] * ax0 + s[:, np.minimum(sx + 1, w - 1)] * ax1
    sy, fy = _linear_taps(h, size)        # rows: clamped after the weights
    by0, by1 = _coef(fy)
    r0 = rows[np.clip(sy, 0, h - 1)] >> 4
    r1 = rows[np.clip(sy + 1, 0, h - 1)] >> 4
    out = (((by0[:, None] * r0) >> 16) + ((by1[:, None] * r1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_nearest(src: np.ndarray, size: int) -> np.ndarray:
    """``cv2.resize(src, (size, size), interpolation=INTER_NEAREST)``."""
    h, w = src.shape
    ys = np.floor(np.arange(size) * (1.0 / (size / h))).astype(np.int64)
    xs = np.floor(np.arange(size) * (1.0 / (size / w))).astype(np.int64)
    return src[np.minimum(ys, h - 1)][:, np.minimum(xs, w - 1)]


def resized_crop_pair(img: np.ndarray, msk: np.ndarray, i: int, j: int, ch: int,
                      cw: int, size: int) -> Tuple[np.ndarray, np.ndarray]:
    img_c = img[i:i + ch, j:j + cw]
    msk_c = msk[i:i + ch, j:j + cw]
    return resize_linear(img_c, size), resize_nearest(msk_c, size)


def gamma_correct(img: np.ndarray, gamma: float) -> np.ndarray:
    """torchvision adjust_gamma on uint8: 255 * (x/255)^gamma."""
    x = img.astype(np.float32) / 255.0
    return np.clip(np.power(x, gamma) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def color_jitter(img: np.ndarray, brightness: float, contrast: float,
                 rng: random.Random) -> np.ndarray:
    """torchvision ColorJitter for grayscale: brightness/contrast factors
    drawn from U(max(0, 1-x), 1+x); saturation/hue are no-ops on L images
    (brightness=contrast=0.4 in ``JointAugment``)."""
    ops = []
    if brightness > 0:
        b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda x: x * b)
    if contrast > 0:
        c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda x: (x - x.mean()) * c + x.mean())
    rng.shuffle(ops)
    x = img.astype(np.float32)
    for op in ops:
        x = op(x)
    return np.clip(x + 0.5, 0, 255).astype(np.uint8)


class JointAugment:
    """Composed train-time augmentation pipeline: rotate -> elastic ->
    resizedCrop on the joint pair, then optional image-only colour jitter
    and gamma."""

    def __init__(self, data_aug: Optional[Dict], rng: Optional[random.Random] = None):
        self.cfg = data_aug or {}
        self.rng = rng or random.Random()

    def __call__(self, img: np.ndarray, msk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        cfg, rng = self.cfg, self.rng
        if not cfg:
            return img, msk
        if cfg.get("rotate"):
            deg = cfg["rotate_degrees"]
            angle = rng.uniform(-deg, deg)
            img, msk = rotate_pair(img, msk, angle)
        if cfg.get("elasticDeform"):
            sigma = rng.uniform(*cfg["elasticDeform_sigmas"])
            if rng.random() < 0.5:
                img, msk = elastic_deform_pair(img, msk, sigma,
                                               cfg["elasticDeform_points"], rng)
        if cfg.get("resizeCrop"):
            size = cfg["resizeCrop_size"]
            i, j, ch, cw = resized_crop_params(img.shape[0], img.shape[1],
                                               (0.6, 1.0), (3.0 / 4.0, 4.0 / 3.0), rng)
            img, msk = resized_crop_pair(img, msk, i, j, ch, cw, size)
        if cfg.get("colorJitter"):
            img = color_jitter(img, 0.4, 0.4, rng)
        if cfg.get("gammaCorrect"):
            gamma = rng.uniform(*cfg["gammaCorrect_gammas"])
            if rng.random() < 0.5:
                img = gamma_correct(img, gamma)
        return img, msk


def normalize_img(img: np.ndarray) -> np.ndarray:
    """ToTensor + Normalize(0.5, 0.5): uint8 -> float32 in [-1, 1]."""
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5
