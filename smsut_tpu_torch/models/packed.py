# -*- coding: utf-8 -*-
"""Space-to-depth ("hw") packed execution of the first ``pack_levels``
levels, NHWC.

Port of ``smsut_tpu/models/packed.py`` (its default ``v1`` lowering,
and ``SMSUT_PACKED_IMPL`` v2/v2k3, :func:`packed_conv`): a level runs on the 2x2 space-to-depth grid
``[B, H/2, W/2, 4C]`` with packed channel ``s*C + c`` (subpixel ``s =
dy*2 + dx``), the same arithmetic as the unpacked level, term for term:

* a SAME conv (odd k) is a 3-tap (k 3, 5) or 1-tap (k 1) conv whose packed
  kernel ``[kp, kp, 4Cin, 4Cout]`` is built in each forward from the
  original ``[k, k, Cin, Cout]`` parameter by one 0/1 placement product
  (:func:`pack_kernel`): its backward is a contraction too, adding in a
  fixed order (no scatter, no atomics);
* instance norm pools each original channel over (H', W', s): kernel K1 on
  the free view ``[B, H', 4W', C]`` of the packed map, whose byte order
  ``(b, h', w', s, c)`` makes it exactly that reduction;
* the 2x2 max pool is a max over the 4 subpixels (a ``torch.maximum``
  chain in the JAX order, which splits a tie's gradient in half at each
  link, as ``jnp.maximum`` does);
* the 2x2 stride-2 transposed conv is a 1x1 product giving all four
  subpixels; the bilinear 2x upsample is shifts and pads;
* the discriminator's 4x4 stride-2 stem is a stride-1 3x3 conv on the
  packed grid with an unpacked output (:func:`pack_kernel_stride2`).

Everything here is a function on the tensors and on the ``nn.Parameter``s
the unpacked modules of ``models/blocks.py``, ``models/layers.py`` and
``models/ugan.py`` hold, so the parameter tree (and every checkpoint) is
the same at every ``pack_levels``.  A packed 3x3 kernel goes to K2
(``ops/conv3x3.py``) where ``conv3x3.takes`` accepts the packed shape,
else to ``layers.conv_plain`` counted in ``conv3x3.conv3x3.routed``; a
packed block goes to K3/K6 with ``groups=4`` where ``block.takes``
accepts it (``Config.block_pallas``), else to the unfused packed chain
counted in ``block.basic_block.routed``.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from smsut_tpu_torch.models.layers import conv_plain
from smsut_tpu_torch.ops import block as k3
from smsut_tpu_torch.ops import conv3x3 as k2
from smsut_tpu_torch.ops.conv3x3 import conv3x3
from smsut_tpu_torch.ops.instnorm import instance_norm, lrelu
from smsut_tpu_torch.parallel import distributed


def check_unsharded(what: str) -> None:
    """The packed levels of either packing (hw here, W in
    ``models/packed_w.py``) run on whole maps and whole weights: a space
    axis (a packed hw row is two image rows) or a model axis (channel
    shards of a packed layout) raises, naming ROADMAP A13c."""
    if distributed.space_count() > 1 or distributed.model_count() > 1:
        raise ValueError(f"{what}: pack_levels > 0 runs on the data axis "
                         f"alone; the packed levels on the space or model "
                         f"axis are ROADMAP A13c (set pack_levels=0)")


# ---------------------------------------------------------------- reshapes
def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, 2H, 2W, C] -> [B, H, W, 4C], packed channel (dy*2+dx)*C + c."""
    b, h2, w2, c = x.shape
    x = x.reshape(b, h2 // 2, 2, w2 // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h2 // 2, w2 // 2, 4 * c)


def depth_to_space(x: torch.Tensor, c: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    b, h, w, _ = x.shape
    x = x.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, 2 * h, 2 * w, c)


# ----------------------------------------------------------- packed kernels
@functools.lru_cache(maxsize=None)
def _placement(k: int) -> np.ndarray:
    """P[u, v, ku, kv, s_in, s_out] (0/1): output subpixel (dy, dx)'s tap
    (u, v) of a SAME k x k conv reads packed tap (ty, tx), input subpixel
    (ay, ax), with (ty, ay) = divmod(dy - k//2 + u, 2); each packed slot
    receives at most one original tap."""
    pad = k // 2
    offs = sorted({(d - pad + u) // 2 for d in (0, 1) for u in range(k)})
    kp = offs[-1] - offs[0] + 1
    p = np.zeros((k, k, kp, kp, 4, 4), np.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            for u in range(k):
                ty, ay = divmod(dy - pad + u, 2)
                for v in range(k):
                    tx, ax = divmod(dx - pad + v, 2)
                    p[u, v, ty - offs[0], tx - offs[0], ay * 2 + ax,
                      dy * 2 + dx] = 1.0
    return p


@functools.lru_cache(maxsize=None)
def _placement_stride2(k: int) -> np.ndarray:
    """P[u, v, ku, kv, s_in] for the stride-2 stem: output row i taps
    original row 2i - 1 + u = packed row i + (u-1)//2, subpixel (u-1)%2."""
    offs = sorted({(u - 1) // 2 for u in range(k)})
    kp = offs[-1] - offs[0] + 1
    p = np.zeros((k, k, kp, kp, 4), np.float32)
    for u in range(k):
        ty, ay = divmod(u - 1, 2)
        for v in range(k):
            tx, ax = divmod(v - 1, 2)
            p[u, v, ty - offs[0], tx - offs[0], ay * 2 + ax] = 1.0
    return p


_PLACED: Dict[tuple, torch.Tensor] = {}


def _on(p_host, key, device: torch.device) -> torch.Tensor:
    """A placement tensor on ``device`` in float32, made once per key (so
    that a CUDA graph's capture finds it made by the warm-up) and outside
    inference mode (a training step saves it)."""
    t = _PLACED.get((key, device))
    if t is None:
        with torch.inference_mode(False):
            t = _PLACED[(key, device)] = torch.from_numpy(p_host).to(device)
    return t


def pack_kernel(w: torch.Tensor, in_segments: Sequence[int]) -> torch.Tensor:
    """The packed kernel [kp, kp, 4 sum(segs), 4 Cout] of an original SAME
    kernel ``w`` [k, k, Cin, Cout] (odd k) for the concatenation of packed
    inputs of ``in_segments`` channels each (each laid out ``s*Cseg +
    c``): one placement product per segment, in ``w``'s dtype (float32
    for a parameter: cast the result to the compute dtype)."""
    k, _, cin, cout = w.shape
    if k % 2 == 0 or sum(in_segments) != cin:
        raise ValueError(f"pack_kernel: kernel {tuple(w.shape)} and "
                         f"segments {tuple(in_segments)}")
    p = _on(_placement(k), ("same", k), w.device).to(w.dtype)
    kp = p.shape[2]
    parts, c0 = [], 0
    for c in in_segments:
        seg = torch.einsum("uvio,uvabst->absito", w[:, :, c0:c0 + c], p)
        parts.append(seg.reshape(kp, kp, 4 * c, 4 * cout))
        c0 += c
    return parts[0] if len(parts) == 1 else torch.cat(parts, 2)


def pack_kernel_stride2(w: torch.Tensor) -> torch.Tensor:
    """The 4x4 stride-2 (pad 1) stem's kernel on the packed grid: [3, 3,
    4Cin, Cout] of a stride-1 SAME conv with an unpacked output."""
    k, _, cin, cout = w.shape
    if k != 4:
        raise ValueError(f"pack_kernel_stride2: kernel {tuple(w.shape)}")
    p = _on(_placement_stride2(k), ("stride2", k), w.device).to(w.dtype)
    kp = p.shape[2]
    return torch.einsum("uvio,uvabs->absio", w, p).reshape(kp, kp, 4 * cin,
                                                           cout)


def conv_packed_kernel(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """SAME conv of ``x`` with an already packed kernel in x's dtype: a
    product for 1x1, K2 for a 3x3 it takes, else ``conv_plain`` counted in
    ``conv3x3.conv3x3.routed``."""
    kp = wp.shape[0]
    if kp == 1:
        return x @ wp[0, 0]
    if k2.takes(x.shape, wp.shape[-1], x.dtype):
        return conv3x3(x, wp)
    conv3x3.routed += 1
    return conv_plain(x, wp)


# The unfused packed conv's lowering, as the JAX package selects it
# (``SMSUT_PACKED_IMPL``): "v1" the packed SAME conv above; "v2k3" a 3x3 as
# a padded VALID 2x2 conv and four shifted slices (9 of 16 kernel slots
# live, against 9 of 36); "v2" that and a 1x1 as the dense per-subpixel
# product.  The same values in every mode; the fused block (``packed_block``
# under ``block_pallas``) and ``models/paired.py`` keep v1, as in the JAX
# package.
IMPLS = ("v1", "v2", "v2k3")
CONV_IMPL = os.environ.get("SMSUT_PACKED_IMPL", "v1")


@functools.lru_cache(maxsize=None)
def _placement_v2_k3() -> np.ndarray:
    """P[u, v, tr, tc, s_in, s_out] (0/1) of the v2k3 kernel: output
    subpixel (dy, dx)'s packed window slot (tr, ay) holds original tap u =
    2 tr + dy + ay - 1 (where 0 <= u < 3), columns alike."""
    p = np.zeros((3, 3, 2, 2, 4, 4), np.float32)
    for dy in (0, 1):
        for dx in (0, 1):
            for tr in (0, 1):
                for ay in (0, 1):
                    u = 2 * tr + dy + ay - 1
                    for tc in (0, 1):
                        for ax in (0, 1):
                            v = 2 * tc + dx + ax - 1
                            if 0 <= u < 3 and 0 <= v < 3:
                                p[u, v, tr, tc, ay * 2 + ax,
                                  dy * 2 + dx] = 1.0
    return p


def pack_kernel_v2_k3(w: torch.Tensor,
                      in_segments: Sequence[int]) -> torch.Tensor:
    """[3, 3, Cin, Cout] -> [2, 2, 4 sum(segs), 4 Cout], the kernel of the
    padded VALID formulation (the JAX ``pack_kernel_v2_k3``), one placement
    product per segment."""
    if tuple(w.shape[:2]) != (3, 3) or sum(in_segments) != w.shape[2]:
        raise ValueError(f"pack_kernel_v2_k3: kernel {tuple(w.shape)} and "
                         f"segments {tuple(in_segments)}")
    p = _on(_placement_v2_k3(), ("v2k3",), w.device).to(w.dtype)
    cout = w.shape[-1]
    parts, c0 = [], 0
    for c in in_segments:
        seg = torch.einsum("uvio,uvabst->absito", w[:, :, c0:c0 + c], p)
        parts.append(seg.reshape(2, 2, 4 * c, 4 * cout))
        c0 += c
    return parts[0] if len(parts) == 1 else torch.cat(parts, 2)


def _packed_conv_v2_k3(x: torch.Tensor, w: torch.Tensor,
                       in_segments: Sequence[int]) -> torch.Tensor:
    """v2k3: one 2x2 conv over the 1-padded packed grid ([B, H'+1, W'+1,
    4 Cout], ``conv_plain``: not a 3x3 for K2, counted in
    ``conv3x3.conv3x3.routed``), output subpixel (dy, dx) its slice at
    (dy, dx)."""
    conv3x3.routed += 1
    full = conv_plain(x, pack_kernel_v2_k3(w, in_segments).to(x.dtype))
    h, wd, cout = x.shape[1], x.shape[2], w.shape[-1]
    return torch.cat([full[:, dy:dy + h, dx:dx + wd,
                           (dy * 2 + dx) * cout:(dy * 2 + dx + 1) * cout]
                      for dy in (0, 1) for dx in (0, 1)], -1)


def _packed_conv_v2_k1(x: torch.Tensor, w: torch.Tensor,
                       in_segments: Sequence[int]) -> torch.Tensor:
    """v2's 1x1: the channels regrouped subpixel-major ([seg][s][c] ->
    [s][seg][c], slices, no index), then the dense product on the
    [..., 4, Cin] view, with no structured zeros."""
    if len(in_segments) > 1:
        offs = np.cumsum((0,) + tuple(4 * c for c in in_segments))
        x = torch.cat([x[..., o + s * c:o + (s + 1) * c]
                       for s in range(4)
                       for c, o in zip(in_segments, offs)], -1)
    b, h, wd, _ = x.shape
    y = x.reshape(b, h, wd, 4, w.shape[2]) @ w[0, 0].to(x.dtype)
    return y.reshape(b, h, wd, 4 * w.shape[-1])


def packed_conv(x: torch.Tensor, w: torch.Tensor,
                in_segments: Sequence[int],
                bias: Optional[torch.Tensor] = None,
                impl: Optional[str] = None) -> torch.Tensor:
    """The packed equivalent of the SAME conv with original kernel ``w``
    (a float32 parameter, packed in float32, then cast to x's dtype), with
    the bias at each subpixel, lowered by ``impl`` (default
    :data:`CONV_IMPL`)."""
    impl = CONV_IMPL if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"SMSUT_PACKED_IMPL {impl!r} is not one of {IMPLS}")
    k = w.shape[0]
    if impl in ("v2", "v2k3") and k == 3:
        y = _packed_conv_v2_k3(x, w, in_segments)
    elif impl == "v2" and k == 1:
        y = _packed_conv_v2_k1(x, w, in_segments)
    else:
        y = conv_packed_kernel(x, pack_kernel(w, in_segments).to(x.dtype))
    return y if bias is None else y + tile_c(bias).to(y.dtype)


def tile_c(v: torch.Tensor) -> torch.Tensor:
    """[..., C] -> [..., 4C] matching the ``s*C + c`` layout."""
    return torch.cat([v] * 4, -1)


# ------------------------------------------------------------- packed norm
def packed_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    act: bool, s: int = 4) -> torch.Tensor:
    """Instance norm (affine, eps 1e-5) of the packed ``x`` [B, H, W, s*C]
    (``s`` subpixels a pixel: 4 here, the pack factor in
    ``models/packed_w.py``) per original channel over (H, W, s), then lrelu
    with ``act``: K1 (K4 backward) on the free view [B, H, s*W, C]."""
    b, h, w, sc = x.shape
    y = instance_norm(x.reshape(b, h, s * w, sc // s), scale, bias, act)
    return y.reshape(b, h, w, sc)


def norm_act(mod, x: torch.Tensor, s: int = 4) -> torch.Tensor:
    """``models/layers.py`` ``NormAct`` ``mod`` (instance norm, with its
    activation) on a packed map of ``s`` subpixels a pixel."""
    if mod.norm_type != "instance" or mod.act_type not in (None, "lrelu"):
        raise ValueError("the packed levels take instance norm and leaky "
                         "ReLU")
    return packed_norm_act(x, mod.weight, mod.bias, mod.act_type == "lrelu",
                           s)


# ------------------------------------------------------------- pool / up
def packed_max_pool_to_unpacked(x: torch.Tensor, c: int) -> torch.Tensor:
    """The 2x2 stride-2 max pool of the unpacked map, [B,H,W,4C] ->
    [B,H,W,C]: a ``torch.maximum`` chain over the 4 subpixels."""
    m = x[..., :c]
    for s in range(1, 4):
        m = torch.maximum(m, x[..., s * c:(s + 1) * c])
    return m


def packed_max_pool_to_packed(x: torch.Tensor, c: int) -> torch.Tensor:
    """``space_to_depth(packed_max_pool_to_unpacked(x, c))`` without the
    narrow pooled map: space_to_depth commutes with the subpixel max."""
    m = space_to_depth(x[..., :c])
    for s in range(1, 4):
        m = torch.maximum(m, space_to_depth(x[..., s * c:(s + 1) * c]))
    return m


def pool_to_next_level(x: torch.Tensor, c: int, last: bool,
                       fused: bool = False) -> torch.Tensor:
    """The packed encoder's level transition: the max pool, then
    space_to_depth for the next packed level, or unpacked after the
    ``last`` one; ``fused`` (``Config.pool_pack_fused``) pools and packs
    in one (:func:`packed_max_pool_to_packed`)."""
    if last:
        return packed_max_pool_to_unpacked(x, c)
    if fused:
        return packed_max_pool_to_packed(x, c)
    return space_to_depth(packed_max_pool_to_unpacked(x, c))


def packed_up_concat(up, x: torch.Tensor,
                     skip_packed: torch.Tensor) -> torch.Tensor:
    """``models/blocks.py`` ``UpSampleAndConcat`` ``up`` into packed space
    with the packed skip: the transposed 2x2 conv is the product x @ weight
    [Cin, 2*2*Cout], all four subpixels at once (``up.up``); the bilinear
    form (``up.up_conv``) runs its 1x1 conv first, at the low resolution
    (it commutes with the interpolation), then
    :func:`packed_upsample_bilinear2`."""
    if hasattr(up, "up"):
        w = up.up.weight
        y = x @ w.to(x.dtype).reshape(w.shape[0], -1)
    else:
        y = packed_upsample_bilinear2(x @ up.up_conv.weight[0, 0].to(x.dtype))
    return torch.cat([y, skip_packed.to(y.dtype)], -1)


def _shift_m(a: torch.Tensor, dim: int) -> torch.Tensor:
    """a[i-1] along ``dim``, the first row repeated."""
    return torch.cat([a.narrow(dim, 0, 1), a.narrow(dim, 0, a.shape[dim] - 1)],
                     dim)


def _shift_p(a: torch.Tensor, dim: int) -> torch.Tensor:
    """a[i+1] along ``dim``, the last row repeated."""
    n = a.shape[dim]
    return torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 1, 1)], dim)


def packed_upsample_bilinear2(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample (half-pixel centres, edges clamped) emitted in
    packed layout, [B,H,W,C] -> [B,H,W,4C]: subpixel dy samples
    0.25 x[i-1] + 0.75 x[i] (dy 0) and 0.75 x[i] + 0.25 x[i+1] (dy 1),
    rows then columns, in x's dtype."""
    r0 = 0.25 * _shift_m(x, 1) + 0.75 * x
    r1 = 0.75 * x + 0.25 * _shift_p(x, 1)
    out = []
    for r in (r0, r1):
        out.append(0.25 * _shift_m(r, 2) + 0.75 * r)
        out.append(0.75 * r + 0.25 * _shift_p(r, 2))
    return torch.cat(out, -1).to(x.dtype)


def packed_stride2_conv(stem, x_packed: torch.Tensor) -> torch.Tensor:
    """The discriminator's 4x4 stride-2 stem (``models/ugan.py``
    ``_StemConv`` ``stem``, with its bias) on the packed input: the
    unpacked half-resolution output."""
    check_unsharded("the packed discriminator stem")
    wp = pack_kernel_stride2(stem.weight).to(x_packed.dtype)
    return conv_packed_kernel(x_packed, wp) + stem.bias.to(x_packed.dtype)


# ------------------------------------------------------------ packed block
def packed_block(blk, x: torch.Tensor,
                 in_segments: Sequence[int]) -> torch.Tensor:
    """``models/blocks.py`` ``BasicBlock`` ``blk`` on the packed ``x``
    (``in_segments``: the channels of its concatenated packed inputs).
    With ``blk.fused`` K3/K6 with ``groups=4`` where ``block.takes`` accepts
    the packed shape (the packed kernels built outside the kernel, as in
    the JAX package's ``PackedBasicBlock``), else the unfused packed chain
    (counted in ``block.basic_block.routed``)."""
    f = blk.conv1.features
    segs = tuple(in_segments)
    short = blk.has_shortcut
    dt = x.dtype
    if blk.fused:
        if k3.takes(x.shape, 4 * f, short, dt):
            pk = lambda w, s: pack_kernel(w, s).to(dt)
            sc = ((pk(blk.shortcut1.weight, segs), blk.shortcut2.weight,
                   blk.shortcut2.bias) if short else ())
            return k3.basic_block(x, pk(blk.conv1.weight, segs),
                                  blk.bn1.weight, blk.bn1.bias,
                                  pk(blk.conv2.weight, (f,)), blk.bn2.weight,
                                  blk.bn2.bias, *sc, groups=4)
        k3.basic_block.routed += 1
    y = norm_act(blk.bn1, packed_conv(x, blk.conv1.weight, segs))
    y = norm_act(blk.bn2, packed_conv(y, blk.conv2.weight, (f,)))
    idn = x
    if short:
        idn = norm_act(blk.shortcut2,
                       packed_conv(x, blk.shortcut1.weight, segs))
    return lrelu(y + idn)


def pack_stem(conv, bn, x: torch.Tensor) -> torch.Tensor:
    """An encoder's stem on the unpacked input: space_to_depth, the 5x5
    conv ``conv`` packed, the norm ``bn`` with its activation."""
    check_unsharded("the packed encoder")
    return norm_act(bn, packed_conv(space_to_depth(x), conv.weight,
                                    (x.shape[-1],)))

