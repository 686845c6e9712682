# -*- coding: utf-8 -*-
"""Shared low-level layers, NHWC.

Port of the parts of ``smsut_tpu/models/layers.py`` that the U-Net, the
UGAN towers, the discriminator and the dual-task U-Net (``models/dtc.py``)
use: the convs, ``NormAct`` with instance norm or training-mode batch norm
(``BatchNorm``) and leaky ReLU or ReLU, the pools, and the bilinear
resize (the UGAN decoders' 2x upsample, the SegFormer head's) as two
products with fixed interpolation matrices, whose backward adds in a
fixed order.  Activations flow in the compute dtype (bfloat16 by default); parameters
and normalisation statistics stay float32.  Conv weights are stored HWIO
[k, k, Cin, Cout], the layout the kernels read and the flax layout.

On a CUDA tensor every instance norm runs kernel K1 forward and K4
backward, and every 3x3 conv that the kernels take (``conv3x3.takes``)
kernel K2 forward, K2 (dx) and K5 (dw) backward.  A 3x3 conv they do not
take, such as the first block's at ``base_width=8``, goes to
:func:`conv_plain` by its shape alone and is counted in
``conv3x3.conv3x3.routed``, as the JAX package sends the shapes its Pallas
conv does not take to XLA (``conv_pallas.enabled_for``).  The weights are
cast to the activation dtype per call, and the gradient comes back through
that cast to the float32 parameter.  The other convs (5x5 stem, 1x1 head
and shortcut) and the pooling stay plain PyTorch with autograd, as XLA
computed them in the JAX package.  Every op here is twice
differentiable, for the discriminator's gradient penalty.

Under a space axis (``parallel/mesh.py``: each rank holds rows of every
map) a k x k conv takes ``k // 2`` rows from each neighbour
(``mesh.halo_rows``): K2 runs SAME on the haloed rows and the middle rows
are kept, so its backward is K2 (dx) and K5 (dw) on the cotangent padded
with zero rows, whose halo rows go back to the neighbours; ``conv_plain``
runs VALID in H on them.  The 1x1 convs and the pools are local (a rank's
rows are even, ``mesh.check_spatial``), and the bilinear upsample
takes a one-row halo (:func:`resize_bilinear`).  :func:`batch_norm` sums
its statistics over the group, each pixel once.

Under a model axis (``parallel/mesh.py`` ``make_mesh_2d``) a conv whose
weight is this rank's output-channel shard (``shard_params_channelwise``)
computes those channels from the whole input, K2 and K5 on the shard
``[3, 3, Cin, Cout/tp]`` (a shard they do not take, Cout 8 and the like,
routed as any such shape), and gathers the model group's shards right
after (``mesh.gather_channels``, whose backward sums the cotangent over
the group and keeps the rank's channels), before the bias: activations
stay whole, and every norm runs on whole maps with its replicated
parameters.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Dict, Optional

import numpy as np

import torch
import torch.nn.functional as F
from torch import nn

from smsut_tpu_torch.ops import acc
from smsut_tpu_torch.ops import conv3x3 as k2
from smsut_tpu_torch.ops.conv3x3 import conv3x3
from smsut_tpu_torch.ops.instnorm import instance_norm, lrelu
from smsut_tpu_torch.parallel import distributed, mesh

# torch.nn.init.calculate_gain('leaky_relu') uses negative_slope=0.01.
_LRELU_GAIN2 = 2.0 / (1.0 + 0.01 ** 2)
BN_EPS = 1e-5


def kaiming_normal_fan_out(shape, fan_out: int,
                           generator: Optional[torch.Generator],
                           act_type: Optional[str] = "lrelu") -> torch.Tensor:
    """Kaiming-normal, mode='fan_out', with the gain of ``act_type`` (2 for
    ReLU, the leaky-ReLU gain otherwise: the JAX package's
    ``kaiming_normal_fan_out``), float32 on the CPU."""
    gain2 = 2.0 if act_type == "relu" else _LRELU_GAIN2
    return torch.randn(shape, generator=generator) * math.sqrt(gain2 / fan_out)


def activation(act_type: Optional[str]) -> Callable[[torch.Tensor],
                                                     torch.Tensor]:
    """``"relu"``, ``"lrelu"`` (slope 0.01) or ``None`` (identity): the
    JAX package's ``get_act``."""
    if act_type == "relu":
        return torch.relu
    if act_type == "lrelu":
        return lrelu
    if act_type is None:
        return lambda y: y
    raise NotImplementedError(act_type)


_LOCAL_STATS = [False]


@contextlib.contextmanager
def local_batch_stats():
    """Within it, :func:`batch_norm` takes its statistics over this rank's
    batch alone, also under a process group: for forwards whose data
    ranks hold different batches (the sharded eval sweep), not rows of
    one.  Under a space axis the batch's images are split over the space
    group, whose sums it still takes."""
    prev, _LOCAL_STATS[0] = _LOCAL_STATS[0], True
    try:
        yield
    finally:
        _LOCAL_STATS[0] = prev


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = BN_EPS) -> torch.Tensor:
    """Training-mode BatchNorm2d over NHWC ``x``: statistics over (B, H, W)
    in float32 (float64 for float64 ``x``), var = E[x^2] - E[x]^2, no
    running averages; the result in ``x``'s dtype.

    Under a group of more than one process ``x`` is the rank's rows of the
    global batch (and under a space axis its rows of their images), and
    the statistics are the global batch's, as the JAX package takes them
    under GSPMD: the sums of x and x^2 and the count over the group
    (``parallel.mesh.batch_sums``, whose backward sums the cotangent over
    the group), each pixel counted once.  Within :func:`local_batch_stats`
    the sums are the space group's (``parallel.mesh.space_sum``): the
    rank's batch, whole."""
    xf = acc(x)
    local = _LOCAL_STATS[0]
    if distributed.process_count() > 1 and (
            not local or distributed.space_count() > 1):
        s1 = xf.sum(dim=(0, 1, 2))
        s2 = (xf * xf).sum(dim=(0, 1, 2))
        n = torch.full_like(s1, x.shape[0] * x.shape[1] * x.shape[2])
        if local:
            s1, s2, n = mesh.space_sum(torch.stack([s1, s2, n])).unbind(0)
        else:
            s1, s2, n = mesh.batch_sums(s1, s2, n)
        mean = s1 / n
        var = s2 / n - mean * mean
    else:
        mean = xf.mean(dim=(0, 1, 2))
        var = (xf * xf).mean(dim=(0, 1, 2)) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps) * scale + bias
    return y.to(x.dtype)


def conv_plain(x: torch.Tensor, w: torch.Tensor,
               valid_h: bool = False) -> torch.Tensor:
    """SAME conv with HWIO ``w`` [kh, kw, Cin, Cout] where no kernel of the
    port applies: a matmul for 1x1, ``F.conv2d`` on the channels-last view
    otherwise, padded ``kh // 2`` in H and ``kw // 2`` in W (odd sizes:
    SAME; the W-packed stem's [5, 3] kernel; a 2x2 kernel gives the padded
    VALID conv of ``models/packed.py``'s v2k3 lowering); with ``valid_h``
    unpadded in H (``x`` holds its halo rows)."""
    k, kw = w.shape[0], w.shape[1]
    if k == kw == 1:
        return x @ w[0, 0]
    # a contiguous weight: the CPU's float64 conv (slow_conv2d) refuses a
    # strided one in its double backward
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous(),
                 padding=(0 if valid_h else k // 2, kw // 2))
    return y.permute(0, 2, 3, 1).contiguous()


def space_conv(x: torch.Tensor, w: torch.Tensor, kernel: bool
               ) -> torch.Tensor:
    """A k x k SAME conv (k > 1) of a space rank's rows: the rows with
    their ``k // 2``-row halos, then K2 (``kernel``) SAME on them with the
    middle rows kept, or :func:`conv_plain` VALID in H."""
    r = w.shape[0] // 2
    xp = mesh.halo_rows(x, r)
    if kernel:
        return conv3x3(xp, w)[:, r:r + x.shape[1]].contiguous()
    return conv_plain(xp, w, valid_h=True)


class Conv(nn.Module):
    """SAME conv, torch Conv2d(k, padding=k//2) semantics; with
    ``use_bias`` a float32 bias (zeros at init, flax's default) added
    after the conv in the activation dtype, as flax adds it."""

    def __init__(self, cin: int, features: int, kernel: int,
                 generator: Optional[torch.Generator] = None,
                 use_bias: bool = False, act_type: Optional[str] = "lrelu"):
        super().__init__()
        self.features = features
        self.weight = nn.Parameter(kaiming_normal_fan_out(
            (kernel, kernel, cin, features), kernel * kernel * features,
            generator, act_type))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        k = w.shape[0]
        kernel = k == 3 and k2.takes(x.shape, w.shape[-1], x.dtype)
        if k == 3 and not kernel:
            conv3x3.routed += 1
        if k > 1 and distributed.space_count() > 1:
            y = space_conv(x, w, kernel)
        else:
            y = conv3x3(x, w) if kernel else conv_plain(x, w)
        y = mesh.gather_channels(y, self.features)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class NormAct(nn.Module):
    """A norm with f32 statistics and eps 1e-5, then ``act_type`` (None,
    ``"lrelu"`` or ``"relu"``).  ``norm_type`` ``"instance"``:
    InstanceNorm2d(affine=True), kernel K1 (with the leaky ReLU fused);
    ``"batch"``: training-mode batch norm (:func:`batch_norm`)."""

    def __init__(self, features: int, act_type: Optional[str] = None,
                 norm_type: str = "instance"):
        super().__init__()
        if norm_type not in ("instance", "batch"):
            raise NotImplementedError(norm_type)
        self.norm_type = norm_type
        self.act_type = act_type
        self.act = activation(act_type)
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_type == "batch":
            return self.act(batch_norm(x, self.weight, self.bias))
        if self.act_type == "lrelu":
            return instance_norm(x, self.weight, self.bias, True)
        return self.act(instance_norm(x, self.weight, self.bias, False))


def _local_rows(x: torch.Tensor) -> None:
    """A 2x2 pool of a space rank's rows is local where they are even
    (``mesh.check_spatial`` refuses the rest)."""
    if distributed.space_count() > 1 and x.shape[1] % 2:
        raise ValueError(f"a 2x2 pool of {x.shape[1]} rows a rank: "
                         f"spatial_parallel needs an even count")


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool, NHWC (odd edges dropped, as VALID pooling)."""
    _local_rows(x)
    b, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool, NHWC, VALID (odd edges dropped)."""
    _local_rows(x)
    b, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


@functools.lru_cache(maxsize=None)
def _interp_host(n_in: int, n_out: int) -> np.ndarray:
    """float64 [n_out, n_in]: ``jax.image.resize``'s bilinear weights for
    one axis (a triangle kernel at half-pixel centres, each row
    renormalised over the taps inside the input)."""
    s = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    a = np.maximum(0.0, 1.0 - np.abs(s[:, None] - np.arange(n_in)[None]))
    return a / a.sum(axis=1, keepdims=True)


_INTERP: Dict[tuple, torch.Tensor] = {}


def interp_matrix(n_in: int, n_out: int, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    """:func:`_interp_host` on ``device`` in ``dtype``, made once per key
    (so that a CUDA graph's capture finds it made by the warm-up), and
    outside inference mode, so that a training step may save it."""
    key = (n_in, n_out, device, dtype)
    t = _INTERP.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _INTERP[key] = torch.from_numpy(
                _interp_host(n_in, n_out)).to(device, dtype)
    return t


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC ``x`` resized to h x w as ``jax.image.resize(..., "bilinear")``
    resizes up: two products with fixed interpolation matrices, whose
    backward is two products too, so it adds in a fixed order on the card
    (``F.interpolate``'s CUDA backward adds with atomics).

    Under a space axis ``x`` holds rows ``[s*hi, (s+1)*hi)`` of an image
    of ``sp*hi`` rows and ``h`` is the rank's share of the ``sp*h`` rows
    out, ``h >= hi``: output rows ``[s*h, (s+1)*h)`` read input rows
    ``s*hi - 1`` to ``(s+1)*hi`` (a half-pixel upsample's taps lie within
    one row of its rank's), so the rows with a one-row halo (zeros beyond
    the image, where the whole-image matrix has no weight) times the
    rank's rows of the whole image's H matrix over those columns."""
    sp = distributed.space_count()
    if sp == 1:
        ah = interp_matrix(x.shape[1], h, x.device, x.dtype)
    else:
        ah = _space_interp(sp * x.shape[1], sp * h,
                           distributed.space_index(), x.device, x.dtype)
        x = mesh.halo_rows(x, 1)
    aw = interp_matrix(x.shape[2], w, x.device, x.dtype)
    y = torch.einsum("Hh,bhwc->bHwc", ah, x)
    return torch.einsum("Ww,bHwc->bHWc", aw, y)


def upsample_bilinear2(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with half-pixel centres, NHWC: the JAX
    package's ``jax.image.resize(..., "bilinear")`` at x2, the edge rows
    and columns copies of the input's (their weights renormalised), as
    :func:`resize_bilinear` (under a space axis the rank's rows, through a
    one-row halo)."""
    return resize_bilinear(x, 2 * x.shape[1], 2 * x.shape[2])


def _space_interp(n_in: int, n_out: int, s: int, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    """[n_out/sp, n_in/sp + 2]: space rank ``s``'s rows of the ``n_in ->
    n_out`` matrix over input rows ``s*hi - 1 .. (s+1)*hi`` (``hi =
    n_in/sp``, a zero column beyond the image), made once per key, as
    :func:`interp_matrix`.  Raises where a weight falls outside those
    columns (a downsample)."""
    sp = distributed.space_count()
    key = ("space", n_in, n_out, sp, s, device, dtype)
    t = _INTERP.get(key)
    if t is None:
        hi, ho = n_in // sp, n_out // sp
        a = np.pad(_interp_host(n_in, n_out), ((0, 0), (1, 1)))
        rows = a[s * ho:(s + 1) * ho]
        mine = rows[:, s * hi:s * hi + hi + 2]
        if np.count_nonzero(mine) != np.count_nonzero(rows):
            raise ValueError(f"a resize of {n_in} rows to {n_out} reads "
                             f"beyond a one-row halo of each rank's "
                             f"{hi}: spatial_parallel takes upsamples")
        with torch.inference_mode(False):
            t = _INTERP[key] = torch.from_numpy(
                np.ascontiguousarray(mine)).to(device, dtype)
    return t
