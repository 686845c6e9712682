# -*- coding: utf-8 -*-
"""SegFormer-lite with input-patch masking, NHWC at module boundaries (port
of ``smsut_tpu/models/segformer.py``): the MiT-b0-style encoder -- four
stages of overlapping patch embeddings, efficient self-attention with
spatial reduction of the keys and values, and the Mix-FFN (Dense, 3x3
depthwise conv, GELU, Dense) -- and the all-MLP head, which projects every
stage to ``embed_dim``, upsamples to the 1/4 scale, fuses with a 1x1 conv,
a training-mode batch norm and ReLU, and predicts at the input size.

Module and parameter names mirror the flax tree (``models/transplant.py``
maps one onto the other): Dense kernels [in, out], conv kernels HWIO (the
depthwise kernel (3, 3, 1, C), the spatial-reduction conv (sr, sr, C, C)),
LayerNorm ``scale`` as ``weight``; ``backbone.mask_token``,
``fuse_scale`` and ``fuse_bias`` keep their names.

The math is the JAX package's, op for op:

- flax's LayerNorm: eps 1e-6 and the fast variance max(0, E[x^2] -
  E[x]^2), statistics in float32;
- GELU in its tanh form (``jax.nn.gelu``'s default);
- attention as the plain product, a float32 softmax cast back to the
  compute dtype, and the product with the values;
- the spatial-reduction conv, whose kernel equals its stride, with flax's
  ``SAME`` padding (none where the map divides by the ratio), computed as
  a product of the patches with the kernel;
- ``jax.image.resize(..., "bilinear")`` as products with fixed [out, in]
  interpolation matrices along H and W (``models/layers.py``
  :func:`resize_bilinear`: half-pixel
  centres, edge weights renormalised), whose backward is a product too and
  so adds in a fixed order on the card, where ``F.interpolate``'s backward
  adds with atomics;
- the head's batch norm in training mode in every forward (the teacher's,
  the eval sweep's and serving's too), so each image's logits depend on
  the rest of its batch.

The mask (M3L's masked consistency) is a Bernoulli grid [B, H/16, W/16]
given by the caller (``mask_grid``), repeated 4x4 at the stem's 1/4 scale,
and applied to the rows ``mask_range`` = [lo, hi) alone: there the stem's
tokens are replaced by the learned ``mask_token``.  The JAX model draws
the grid itself from a key; the port's step passes it in
(``train/steps/m3l.py``).  No kernel of the port runs here: the JAX model
reaches no Pallas kernel either.

Under a space axis (``parallel/mesh.py``) each rank holds rows of every
map, the stages' rows multiples of their strides and reduction ratios
(:func:`check_rows`): the patch convs and the depthwise conv read their
neighbours' rows through a halo, the spatial reduction, the LayerNorms
and the Dense layers are local, the attention's keys and values are the
whole image's (:class:`EfficientAttention`), the head's resizes produce
the rank's rows (``models/layers.py`` :func:`resize_bilinear`), and its
batch norm sums over the group.

Under a model axis (``parallel/mesh.py`` ``make_mesh_2d``, the state
sharded by ``shard_params_channelwise``) every kernel the JAX rule shards
(each Dense [in, out], the 1x1 convs, the patch convs, the spatial
reduction's conv, the depthwise kernel (3, 3, 1, C); the classifier's 5
outputs do not divide) is the rank's output-channel shard: the layer
computes those channels from the whole input, the depthwise conv from the
same channels of its input alone (its groups), and gathers the model
group's shards before its bias (``mesh.gather_channels``, whose backward
sums the cotangent over the group and keeps the rank's channels).
Activations stay whole: the LayerNorms, the attention over whole heads,
the mask token and the head's batch norm run as in one process.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from smsut_tpu_torch.device import resolve_device
from smsut_tpu_torch.models.layers import batch_norm, resize_bilinear
from smsut_tpu_torch.ops import acc
from smsut_tpu_torch.parallel import distributed, mesh

LN_EPS = 1e-6   # flax.linen.LayerNorm's default
# flax's lecun_normal: a normal truncated at 2 sigma, rescaled to unit
# variance
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, fan_in: int,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's default kernel init, variance_scaling(1, "fan_in",
    "truncated_normal"), float32 on the CPU."""
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ weight + bias`` in the activation dtype,
    ``weight`` [in, out] float32 (under a model axis its output shard,
    gathered before the bias)."""

    def __init__(self, cin: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features = features
        self.weight = nn.Parameter(lecun_normal((cin, features), cin,
                                                generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = mesh.gather_channels(x @ self.weight.to(x.dtype), self.features)
        return y + self.bias.to(x.dtype)


class Conv1x1(nn.Module):
    """flax ``nn.Conv`` with a (1, 1) kernel, ``weight`` (1, 1, in, out)."""

    def __init__(self, cin: int, features: int,
                 generator: Optional[torch.Generator] = None,
                 use_bias: bool = True):
        super().__init__()
        self.features = features
        self.weight = nn.Parameter(lecun_normal((1, 1, cin, features), cin,
                                                generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = mesh.gather_channels(x @ self.weight[0, 0].to(x.dtype),
                                 self.features)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: eps 1e-6, float32
    statistics, var = max(0, E[x^2] - E[x]^2); the result in ``x``'s
    dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = acc(x)
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + LN_EPS) * self.weight)
        return (y + self.bias).to(x.dtype)


def conv_rows(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
              groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` of NHWC ``x`` with the OIHW kernel ``w`` (k odd),
    padding k // 2 and ``stride``; NCHW out.  Under a space axis ``x`` is
    a rank's rows, a multiple of ``stride``: the rows with k // 2 of each
    neighbour's (``mesh.halo_rows``), then the conv unpadded in H, whose
    output rows are the rank's, starting on the stride."""
    r = w.shape[-1] // 2
    if distributed.space_count() == 1:
        return F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=r,
                        groups=groups)
    if x.shape[1] % stride:
        raise ValueError(f"a stride-{stride} conv of {x.shape[1]} rows a "
                         f"rank: spatial_parallel needs a multiple of "
                         f"{stride}")
    return F.conv2d(mesh.halo_rows(x, r).permute(0, 3, 1, 2), w,
                    stride=stride, padding=(0, r), groups=groups)


class PatchConv(nn.Module):
    """flax ``nn.Conv(k, stride, padding=k // 2)`` with a bias, NHWC in
    and out; ``weight`` HWIO.  Under a space axis on a rank's rows
    (:func:`conv_rows`)."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.features = stride, features
        self.weight = nn.Parameter(lecun_normal(
            (kernel, kernel, cin, features), kernel * kernel * cin,
            generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype).permute(3, 2, 0, 1).contiguous()
        y = mesh.gather_channels(conv_rows(x, w, self.stride).permute(
            0, 2, 3, 1), self.features)
        return y + self.bias.to(y.dtype)


class SpatialReduction(nn.Module):
    """flax ``nn.Conv(C, (sr, sr), strides=sr)`` (``SAME``, with a bias)
    on the tokens [B, h*w, C] of an h x w map: the patches of the padded
    map times the kernel reshaped to [sr*sr*C, C]; returns [B, h'*w', C].
    Local on a space rank's rows, a multiple of ``sr`` (no padding in
    H)."""

    def __init__(self, dim: int, ratio: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ratio = ratio
        self.weight = nn.Parameter(lecun_normal(
            (ratio, ratio, dim, dim), ratio * ratio * dim, generator))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, _, c = x.shape
        s = self.ratio
        xr = x.reshape(b, h, w, c)
        ph, pw = (-h) % s, (-w) % s   # SAME with kernel == stride
        if ph and distributed.space_count() > 1:
            raise ValueError(f"a {s}x{s} spatial reduction of {h} rows a "
                             f"rank: spatial_parallel needs a multiple of "
                             f"{s}")
        if ph or pw:
            xr = F.pad(xr, (0, 0, pw // 2, pw - pw // 2, ph // 2,
                            ph - ph // 2))
        hs, ws = (h + ph) // s, (w + pw) // s
        p = xr.reshape(b, hs, s, ws, s, c).permute(0, 1, 3, 2, 4, 5)
        p = p.reshape(b, hs * ws, s * s * c)
        wt = self.weight.to(x.dtype).reshape(s * s * c, -1)
        return mesh.gather_channels(p @ wt, c) + self.bias.to(x.dtype)


class DepthwiseConv3x3(nn.Module):
    """flax ``nn.Conv(C, (3, 3), padding="SAME", feature_group_count=C)``
    with a bias, NHWC; ``weight`` (3, 3, 1, C).  Under a space axis on a
    rank's rows (:func:`conv_rows`); under a model axis ``weight`` is the
    rank's (3, 3, 1, C/tp), which convolves the rank's C/tp channels of
    the input, then gathered."""

    def __init__(self, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal((3, 3, 1, features), 9,
                                                generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype).permute(3, 2, 0, 1).contiguous()
        c, full = w.shape[0], x.shape[-1]
        if c != full:   # a model rank's channels
            x = x.narrow(-1, distributed.model_index() * c, c)
        y = conv_rows(x, w, groups=c).permute(0, 2, 3, 1)
        return mesh.gather_channels(y, full) + self.bias.to(y.dtype)


class EfficientAttention(nn.Module):
    """Self-attention with the keys and values from the map reduced by
    ``sr_ratio`` (a strided conv and a LayerNorm) when it exceeds 1.
    Under a space axis the queries are a rank's tokens and the keys and
    values the whole image's: the space group's reduced tokens gathered
    (``mesh.space_gather``, whose backward sums the cotangent over the
    group), so the softmax runs over every key."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.sr_ratio = num_heads, sr_ratio
        self.q = Dense(dim, dim, generator)
        if sr_ratio > 1:
            self.sr = SpatialReduction(dim, sr_ratio, generator)
            self.sr_norm = LayerNorm(dim)
        self.k = Dense(dim, dim, generator)
        self.v = Dense(dim, dim, generator)
        self.proj = Dense(dim, dim, generator)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.heads
        q = self.q(x)
        kv = mesh.space_gather(self.sr_norm(self.sr(x, h, w))
                               if self.sr_ratio > 1 else x)
        split = lambda t: t.reshape(b, -1, self.heads, d).transpose(1, 2)
        att = split(q) @ split(self.k(kv)).transpose(-1, -2) / math.sqrt(d)
        att = torch.softmax(att.to(torch.promote_types(att.dtype,
                                                       torch.float32)),
                            dim=-1).to(x.dtype)
        out = (att @ split(self.v(kv))).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class MixFFN(nn.Module):
    """Dense to ``expand`` x ``dim``, 3x3 depthwise conv, GELU (tanh
    form), Dense back to ``dim``."""

    def __init__(self, dim: int, expand: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        hidden = dim * expand
        self.fc1 = Dense(dim, hidden, generator)
        self.dwconv = DepthwiseConv3x3(hidden, generator)
        self.fc2 = Dense(hidden, dim, generator)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, n, _ = x.shape
        y = self.fc1(x)
        hidden = y.shape[-1]
        y = self.dwconv(y.reshape(b, h, w, hidden)).reshape(b, n, hidden)
        return self.fc2(F.gelu(y, approximate="tanh"))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio, generator)
        self.norm2 = LayerNorm(dim)
        self.ffn = MixFFN(dim, generator=generator)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), h, w)
        return x + self.ffn(self.norm2(x), h, w)


class OverlapPatchEmbed(nn.Module):
    """A k x k conv of stride ``stride`` and padding k // 2, then a
    LayerNorm over the tokens; returns (tokens [B, h*w, C], h, w)."""

    def __init__(self, cin: int, dim: int, patch: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = PatchConv(cin, dim, patch, stride, generator)
        self.norm = LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        x = self.proj(x)
        b, h, w, c = x.shape
        return self.norm(x.reshape(b, h * w, c)), h, w


# the stages' patch embeddings (kernel, stride) and attention reduction
# ratios
PATCHES = ((7, 4), (3, 2), (3, 2), (3, 2))
SR_RATIOS = (8, 4, 2, 1)


def check_rows(size: int, sp: int) -> None:
    """Raise a ValueError naming ``spatial_parallel`` where a stage's map
    of input ``size`` does not split into whole rows a rank over ``sp``
    ranks, a multiple of that stage's reduction ratio (the reduction is
    then local, and each patch conv's output rows start on its stride).
    Every map is read with a one-row halo (the depthwise 3x3, the next
    stage's patch conv, the head's resize) and the input with 3 (the
    stem), which whole rows at each stage imply, as they imply whole rows
    of M3L's mask grid (16-pixel cells)."""
    h, left = divmod(size, sp)
    stride = 1
    for (_, s), sr in zip(PATCHES, SR_RATIOS):
        stride *= s
        if left or h % (stride * sr):
            raise ValueError(
                f"spatial_parallel={sp}: the SegFormer's {size // stride}x"
                f"{size // stride} map of input_size {size} does not split "
                f"into whole rows, a multiple of {sr}, per rank")


class MixVisionTransformer(nn.Module):
    """MiT-b0-style encoder: widths (32, 64, 160, 256), depths (2, 2, 2, 2),
    heads (1, 2, 5, 8), reduction ratios :data:`SR_RATIOS`, patch
    embeddings :data:`PATCHES`; returns the four stages' maps, NHWC."""

    def __init__(self, cin: int = 3, dims: Sequence[int] = (32, 64, 160, 256),
                 depths: Sequence[int] = (2, 2, 2, 2),
                 heads: Sequence[int] = (1, 2, 5, 8),
                 sr_ratios: Sequence[int] = SR_RATIOS,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dims, self.depths = tuple(dims), tuple(depths)
        prev = cin
        for s in range(4):
            patch, stride = PATCHES[s]
            setattr(self, f"embed{s + 1}", OverlapPatchEmbed(
                prev, dims[s], patch, stride, generator))
            for blk in range(depths[s]):
                setattr(self, f"stage{s + 1}_block{blk}", TransformerBlock(
                    dims[s], heads[s], sr_ratios[s], generator))
            setattr(self, f"norm{s + 1}", LayerNorm(dims[s]))
            prev = dims[s]
        # the learned mask token, normal(0.02) as flax draws it
        self.mask_token = nn.Parameter(
            torch.randn(dims[0], generator=generator) * 0.02)

    def forward(self, x: torch.Tensor,
                mask_map: Optional[torch.Tensor] = None
                ) -> List[torch.Tensor]:
        """``mask_map`` [B, h1, w1] (1 where the stem's token is masked)."""
        feats = []
        for s in range(4):
            x, h, w = getattr(self, f"embed{s + 1}")(x)
            if s == 0 and mask_map is not None:
                m = mask_map.reshape(x.shape[0], -1, 1).to(x.dtype)
                x = x * (1.0 - m) + self.mask_token.to(x.dtype) * m
            for blk in range(self.depths[s]):
                x = getattr(self, f"stage{s + 1}_block{blk}")(x, h, w)
            x = getattr(self, f"norm{s + 1}")(x)
            x = x.reshape(x.shape[0], h, w, self.dims[s])
            feats.append(x)
        return feats


class LinearFusionMaskedConsistencyMixBatch(nn.Module):
    """The SegFormer with its all-MLP head and batch-range input masking:
    ``forward(x, mask_grid=None, mask_range=None)`` -> float32 logits
    [B, H, W, num_classes] of NHWC ``x`` (3 channels).

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``,
    then moved to ``device``: the card unless ``device`` names another (no
    CUDA and no device raises)."""

    def __init__(self, num_classes: int, embed_dim: int = 256,
                 mask_patch: int = 16, in_ch: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.mask_patch = mask_patch
        g = torch.Generator().manual_seed(seed)
        self.backbone = MixVisionTransformer(in_ch, generator=g)
        for i, d in enumerate(self.backbone.dims):
            setattr(self, f"linear_c{i + 1}", Dense(d, embed_dim, g))
        n = len(self.backbone.dims)
        self.linear_fuse = Conv1x1(n * embed_dim, embed_dim, g,
                                   use_bias=False)
        self.fuse_scale = nn.Parameter(torch.ones(embed_dim))
        self.fuse_bias = nn.Parameter(torch.zeros(embed_dim))
        self.linear_pred = Conv1x1(embed_dim, num_classes, g)
        self.to(device)

    def mask_map(self, grid: torch.Tensor, mask_range: Sequence[int],
                 h: int, w: int) -> torch.Tensor:
        """float32 [B, H/4, W/4]: the Bernoulli ``grid`` [B, gh, gw]
        repeated over ``mask_patch / 4`` square cells at the stem's scale,
        zero outside rows [lo, hi)."""
        b, gh, gw = grid.shape
        p = max(self.mask_patch // 4, 1)
        m = grid.to(torch.float32)[:, :, None, :, None].expand(b, gh, p, gw, p)
        m = m.reshape(b, gh * p, gw * p)[:, : h // 4, : w // 4]
        lo, hi = mask_range
        rows = torch.arange(b, device=grid.device)
        return m * ((rows >= lo) & (rows < hi)).to(torch.float32)[:, None,
                                                                   None]

    def forward(self, x: torch.Tensor,
                mask_grid: Optional[torch.Tensor] = None,
                mask_range: Optional[Sequence[int]] = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        x = x.to(self.compute_dtype)
        mask = (self.mask_map(mask_grid, mask_range, h, w)
                if mask_grid is not None and mask_range is not None
                else None)
        feats = self.backbone(x, mask)
        h0, w0 = feats[0].shape[1:3]
        fused = []
        for i, f in enumerate(feats):
            y = getattr(self, f"linear_c{i + 1}")(f)
            if f.shape[1] != h0:
                y = resize_bilinear(y, h0, w0)
            fused.append(y)
        y = self.linear_fuse(torch.cat(fused[::-1], dim=-1))
        y = torch.relu(batch_norm(y, self.fuse_scale, self.fuse_bias))
        y = self.linear_pred(y)
        return resize_bilinear(acc(y), h, w)
