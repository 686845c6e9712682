# -*- coding: utf-8 -*-
"""Joint augmentation on the card: rotate + elastic + random resized crop
composed into ONE warp and ONE gather per output pixel.

Port of ``smsut_tpu/data/device_augment.py``.  The host side
(``sample_params``, ``pack_params``, ``sample_params_packed``) is a copy:
one ``random.Random`` stream gives bit-identical packed parameters in both
packages.  The device side is a batch of plain torch ops on the tensors'
device, where the JAX package vmaps one sample's warp; it is not a
hand-written kernel (in JAX it is ``jax.jit`` of plain ops, not Pallas).

Composition (inverse maps, output -> source):
  crop-resize (bilinear, scale 0.6-1.0, torchvision parameter sampling)
  -> + elastic displacement (3x3 normal(0, sigma) control grid, Keys cubic
       upsample, p = 0.5)
  -> inverse rotation (U(-deg, deg) around the centre, zero fill)
then one bilinear gather for the image and nearest for the mask, brightness,
contrast, gamma, and the ToTensor+Normalize(0.5, 0.5) mapping to [-1, 1].

What the translation keeps of JAX's arithmetic:
- the cubic upsampling of the control grid is ``jax.image.resize(...,
  "cubic")``: Keys' kernel with a = -0.5 over the taps inside the input,
  weights renormalised -- not ``F.interpolate(mode="bicubic")`` (a = -0.75,
  edges clamped).  The weight matrices are built on the host the same way
  and applied as two small contractions, at the rows and columns the
  crop samples;
- ``torch.round`` rounds half to even, like ``jnp.round``;
- the 2x2 neighbourhood and the mask's four taps are packed into 8-wide
  rows over a 1-padded grid, fetched by one flat index per output pixel,
  with the boundary band handled as in JAX;
- the contrast mean is taken per image.
"""
from __future__ import annotations

import math
import random
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.data.augment import resized_crop_params
from smsut_tpu_torch.device import resolve_device


def cubic_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """The [n_in, n_out] float32 weight matrix of ``jax.image.resize`` with
    method "cubic" along one axis (``compute_weight_mat`` with Keys' cubic
    kernel, no translation)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) - f32(0.5))
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
         / kernel_scale)
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x
                   + f32(2.0), out)
    w = np.where(x >= 2.0, f32(0.0), out).astype(f32)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


class DeviceAugment:
    """Host-side parameter sampling + a batched warp on ``device`` (the
    card unless the caller names another)."""

    def __init__(self, cfg: Config, rng: Optional[random.Random] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.cfg = cfg
        self.aug = cfg.data_aug or {}
        self.rng = rng or random.Random()
        self.size = int(self.aug.get("resizeCrop_size", cfg.input_size))
        self.device = resolve_device(device)
        self._weights: Dict[Tuple, torch.Tensor] = {}

    # ------------------------------------------------------------ host side
    def sample_params(self, batch: int, h: int, w: int) -> Dict[str, np.ndarray]:
        rng, aug = self.rng, self.aug
        deg = float(aug.get("rotate_degrees", 0))
        angles = np.array([rng.uniform(-deg, deg) if aug.get("rotate") else 0.0
                           for _ in range(batch)], np.float32)

        do_el, sigmas, disps = [], [], []
        points = int(aug.get("elasticDeform_points", 3))
        for _ in range(batch):
            sig = rng.uniform(*aug.get("elasticDeform_sigmas", (9.0, 13.0)))
            on = aug.get("elasticDeform") and rng.random() < 0.5
            np_rng = np.random.default_rng(rng.getrandbits(63))
            disps.append(np_rng.normal(0.0, sig, (2, points, points))
                         .astype(np.float32))
            do_el.append(1.0 if on else 0.0)
            sigmas.append(sig)

        crops = []
        for _ in range(batch):
            if aug.get("resizeCrop"):
                i, j, ch, cw = resized_crop_params(h, w, (0.6, 1.0),
                                                   (3.0 / 4.0, 4.0 / 3.0), rng)
            else:
                i, j, ch, cw = 0, 0, h, w
            crops.append((i, j, ch, cw))

        gammas = np.ones(batch, np.float32)
        if aug.get("gammaCorrect"):
            lo, hi = aug.get("gammaCorrect_gammas", (0.7, 1.5))
            for b in range(batch):
                if self.rng.random() < 0.5:
                    gammas[b] = self.rng.uniform(lo, hi)

        bright = np.ones(batch, np.float32)
        contrast = np.ones(batch, np.float32)
        if aug.get("colorJitter"):
            for b in range(batch):
                bright[b] = rng.uniform(0.6, 1.4)
                contrast[b] = rng.uniform(0.6, 1.4)

        return {
            "angle": angles,
            "do_elastic": np.asarray(do_el, np.float32),
            "disp": np.stack(disps),                       # [B, 2, P, P]
            "crop": np.asarray(crops, np.float32),          # [B, 4] i,j,ch,cw
            "gamma": gammas,
            "bright": bright,
            "contrast": contrast,
        }

    # every scalar knob and the elastic grid ride in a single
    # [B, 9 + 2*P*P] float32 row: one host-to-device copy per batch
    def pack_params(self, params: Dict[str, np.ndarray]) -> np.ndarray:
        b = params["angle"].shape[0]
        return np.concatenate([
            params["angle"][:, None], params["do_elastic"][:, None],
            params["crop"], params["gamma"][:, None],
            params["bright"][:, None], params["contrast"][:, None],
            params["disp"].reshape(b, -1),
        ], axis=1).astype(np.float32)

    def sample_params_packed(self, batch: int, h: int, w: int) -> np.ndarray:
        return self.pack_params(self.sample_params(batch, h, w))

    # ---------------------------------------------------------- device side
    def _cubic(self, n_in: int, n_out: int, device) -> torch.Tensor:
        """[n_out, n_in] cubic weights on ``device``, built once."""
        key = (n_in, n_out, str(device))
        if key not in self._weights:
            self._weights[key] = torch.from_numpy(
                cubic_resize_weights(n_in, n_out).T.copy()).to(device)
        return self._weights[key]

    def source_coords(self, packed: torch.Tensor, h: int, w: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The composed inverse map: for each output pixel of each sample,
        its source row and column ([B,S,S] float32 each) in the [h, w]
        input, on ``packed``'s device."""
        b, s, dev = packed.shape[0], self.size, packed.device
        points = int(self.aug.get("elasticDeform_points", 3))
        packed = packed.to(torch.float32)
        angle, do_el = packed[:, 0], packed[:, 1].view(b, 1, 1)
        i0, j0, ch, cw = (packed[:, k].view(b, 1) for k in range(2, 6))
        disp = packed[:, 9:].reshape(b, 2, points, points)

        ar = torch.arange(s, dtype=torch.float32, device=dev)
        # crop-resize inverse (half-pixel centres); separable: rows depend
        # on the output row only, columns on the output column
        cy1 = i0 + (ar + 0.5) * ch / s - 0.5                  # [B, s]
        cx1 = j0 + (ar + 0.5) * cw / s - 0.5

        # the elastic field, upsampled to [h, w], read at the crop's
        # nearest pixels: only those rows and columns are formed
        iy = torch.clamp(torch.round(cy1), 0, h - 1).long()
        ix = torch.clamp(torch.round(cx1), 0, w - 1).long()
        wy = self._cubic(points, h, dev)[iy]                  # [B, s, P]
        wx = self._cubic(points, w, dev)[ix]

        def field(d):                                         # d [B, P, P]
            t = (wy[:, :, :, None] * d[:, None, :, :]).sum(2)  # [B, s, P]
            return (t[:, :, None, :] * wx[:, None, :, :]).sum(-1)

        cy = cy1[:, :, None] + do_el * field(disp[:, 0])      # [B, s, s]
        cx = cx1[:, None, :] + do_el * field(disp[:, 1])

        # inverse rotation about the image centre (cv2's convention: centre
        # (w/2, h/2), +angle counter-clockwise, so the source map uses -angle)
        theta = (-angle * math.pi / 180.0).view(b, 1, 1)
        cth, sth = torch.cos(theta), torch.sin(theta)
        oy, ox = h / 2.0, w / 2.0
        ry, rx = cy - oy, cx - ox
        return oy + (-sth * rx + cth * ry), ox + (cth * rx + sth * ry)

    def apply(self, img_u8: torch.Tensor, msk_u8: torch.Tensor,
              packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[B,H,W] uint8 image and mask and [B, 9 + 2P^2] packed parameters,
        on one device -> ([B,S,S,1] float32 in [-1, 1], [B,S,S] int64)."""
        b, h, w = img_u8.shape
        s, dev = self.size, img_u8.device
        packed = packed.to(torch.float32)
        gamma, bright, contrast = (packed[:, k].view(b, 1, 1)
                                   for k in (6, 7, 8))
        sy, sx = self.source_coords(packed, h, w)

        # one packed gather: rows of (v00, v01, v10, v11, m00, m01, m10, m11)
        # for every base corner (y0, x0) in [-1, h-1] x [-1, w-1], over a
        # zero-padded grid, so that each tap of a corner on the boundary
        # band is the correctly clipped pixel (a corner at -1 must read row
        # or column 0 for its +1 taps, not 1)
        ip = F.pad(img_u8.float(), (1, 1, 1, 1))
        mp = F.pad(msk_u8.float(), (1, 1, 1, 1))
        gh, gw = h + 1, w + 1
        taps = torch.stack([
            ip[:, :gh, :gw], ip[:, :gh, 1:], ip[:, 1:, :gw], ip[:, 1:, 1:],
            mp[:, :gh, :gw], mp[:, :gh, 1:], mp[:, 1:, :gw], mp[:, 1:, 1:],
        ], dim=-1).reshape(b, gh * gw, 8)

        y0, x0 = torch.floor(sy), torch.floor(sx)
        fy, fx = sy - y0, sx - x0
        y0c = (torch.clamp(y0, -1, h - 1) + 1).long()         # [0, h]
        x0c = (torch.clamp(x0, -1, w - 1) + 1).long()         # [0, w]
        rows = torch.arange(b, device=dev).view(b, 1)
        g = taps[rows, (y0c * gw + x0c).view(b, -1)].view(b, s, s, 8)

        def inb(yi, xi):
            return ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).float()

        m00, m01 = inb(y0, x0), inb(y0, x0 + 1)
        m10, m11 = inb(y0 + 1, x0), inb(y0 + 1, x0 + 1)
        v00, v01 = g[..., 0] * m00, g[..., 1] * m01
        v10, v11 = g[..., 2] * m10, g[..., 3] * m11
        img = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
               + fy * ((1 - fx) * v10 + fx * v11))

        # nearest for the mask: the corner round() selects (half to even)
        ys = torch.round(sy) > y0
        xs = torch.round(sx) > x0
        msk = torch.where(
            ys, torch.where(xs, g[..., 7] * m11, g[..., 6] * m10),
            torch.where(xs, g[..., 5] * m01, g[..., 4] * m00)).long()

        img = img * bright
        mean = img.mean(dim=(1, 2), keepdim=True)             # per image
        img = (img - mean) * contrast + mean
        img = torch.pow(torch.clamp(img / 255.0, 0.0, 1.0), gamma)
        img = (img - 0.5) / 0.5
        return img[..., None], msk

    def __call__(self, img_u8, msk_u8) -> Tuple[torch.Tensor, torch.Tensor]:
        """img/msk: [B, H, W] uint8 arrays -> ([B,S,S,1] float32 in [-1,1],
        [B,S,S] int64) on the augmentation's device, with fresh
        parameters."""
        b, h, w = img_u8.shape
        packed = self.sample_params_packed(b, h, w)
        put = lambda a: torch.as_tensor(a).to(self.device)
        return self.apply(put(img_u8), put(msk_u8), put(packed))
