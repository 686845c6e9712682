# -*- coding: utf-8 -*-
"""W-only packed execution ("w" mode) of the first ``pack_levels`` levels,
NHWC.

Port of ``smsut_tpu/models/packed_w.py``: a level runs on ``[B, H, W/p,
p*C]``, packed channel ``dx*C + c`` holding original column ``p*j + dx``.
In a C-minor NHWC tensor (dx, c) of ``w = p*j + dx`` is already contiguous,
so packing, unpacking and repacking are free ``reshape``s of a contiguous
map (no copy), and the arithmetic is the unpacked level's, term for term:

* a SAME conv (odd k) is a conv whose packed kernel ``[k, kp, p*Cin,
  p*Cout]`` is built each forward from the original ``[k, k, Cin, Cout]``
  parameter by one 0/1 placement product (:func:`pack_kernel_w`); a 3x3
  goes to K2 where ``conv3x3.takes`` accepts the packed shape (its dx K2,
  its dw K5), else to ``layers.conv_plain`` counted in
  ``conv3x3.conv3x3.routed``; the 5x5 stem's ``[5, 3, ...]`` kernel is not
  square and goes to ``conv_plain``; a 1x1 is the dense per-subpixel
  product on the ``[..., p, C]`` view, with no structured zeros;
* instance norm pools each original channel over (H, J, dx): kernel K1 (K4
  backward) on the free view ``[B, H, J*p, C]``, which is the unpacked map
  itself (``packed.norm_act`` with ``s = p``);
* the 2x2 max pool is an H max then a subpixel-pair max (``torch.amax``,
  whose gradient splits a tie evenly, as ``jnp.max``'s does), emitted on
  the same column grid (pack p/2) or regrouped (pack p), both free;
* the bilinear 2x upsample runs its stencil on the free unpacked view, the
  2x2 stride-2 transposed conv is one product then a repack;
* the discriminator's 4x4 stride-2 stem is a stride-(2, 1) conv on the
  packed grid (plain ``F.conv2d``, twice differentiable), pack p to p/2.

Everything is a function of the tensors, the pack factors and the
``nn.Parameter``s the unpacked modules of ``models/blocks.py``,
``models/layers.py`` and ``models/ugan.py`` hold, so the parameter tree
(and every checkpoint) is the same in every layout.  W levels never run
the fused block K3/K6 (the JAX package's ``PackedBasicBlockW`` has no
fused form): with ``block_pallas`` they run the unfused chain.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from smsut_tpu_torch.models import packed
from smsut_tpu_torch.models.layers import conv_plain
from smsut_tpu_torch.ops.instnorm import lrelu

_MULTS = (1, 2, 4, 8)


# ---------------------------------------------------------------- reshapes
def pack_w(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H, W/p, p*C], channel dx*C + c (a view of a
    contiguous ``x``)."""
    b, h, w, c = x.shape
    if w % p:
        raise ValueError(f"pack_w: width {w} is not a multiple of {p}")
    return x.reshape(b, h, w // p, p * c)


def unpack_w(x: torch.Tensor, p: int) -> torch.Tensor:
    """Inverse of :func:`pack_w`."""
    b, h, j, pc = x.shape
    if pc % p:
        raise ValueError(f"unpack_w: {pc} channels are not {p} subpixels")
    return x.reshape(b, h, j * p, pc // p)


def repack_w(x: torch.Tensor, p_from: int, p_to: int) -> torch.Tensor:
    """Change the pack factor (a reshape either way)."""
    return pack_w(unpack_w(x, p_from), p_to)


# ------------------------------------------------------------ packed convs
@functools.lru_cache(maxsize=None)
def _placement_w(k: int, p: int) -> np.ndarray:
    """P[v, kv, ax, dx] (0/1): output subpixel dx's W-tap v of a SAME k x k
    conv reads packed column offset kv (from the window's first), input
    subpixel ax, with (t, ax) = divmod(dx - k//2 + v, p); H taps are
    ordinary."""
    pad = k // 2
    offs = sorted({(d - pad + v) // p for d in (0, p - 1) for v in range(k)})
    kp = offs[-1] - offs[0] + 1
    pm = np.zeros((k, kp, p, p), np.float32)
    for dx in range(p):
        for v in range(k):
            t, ax = divmod(dx - pad + v, p)
            pm[v, t - offs[0], ax, dx] = 1.0
    return pm


@functools.lru_cache(maxsize=None)
def _placement_w_stride2(k: int, p: int):
    """(P[v, kv, ax, dxo], the first column offset) for the stride-2 stem:
    output subpixel dxo (of p/2) reads original column 2*dxo - 1 + v of
    the packed column's p."""
    q = p // 2
    offs = sorted({(2 * d - 1 + v) // p for d in (0, q - 1)
                   for v in range(k)})
    kp = offs[-1] - offs[0] + 1
    pm = np.zeros((k, kp, p, q), np.float32)
    for dxo in range(q):
        for v in range(k):
            t, ax = divmod(2 * dxo - 1 + v, p)
            pm[v, t - offs[0], ax, dxo] = 1.0
    return pm, offs[0]


def pack_kernel_w(w: torch.Tensor, p: int,
                  in_segments: Sequence[int]) -> torch.Tensor:
    """The W-packed kernel [k, kp, p sum(segs), p Cout] of an original SAME
    kernel ``w`` [k, k, Cin, Cout] (odd k) for the concatenation of packed
    inputs of ``in_segments`` channels each (each laid out ``dx*Cseg +
    c``): one placement product per segment, in ``w``'s dtype,
    contiguous."""
    k, _, cin, cout = w.shape
    if k % 2 == 0 or sum(in_segments) != cin:
        raise ValueError(f"pack_kernel_w: kernel {tuple(w.shape)} and "
                         f"segments {tuple(in_segments)}")
    pm = packed._on(_placement_w(k, p), ("w", k, p), w.device).to(w.dtype)
    kp = pm.shape[1]
    parts, c0 = [], 0
    for c in in_segments:
        seg = torch.einsum("uvio,vkad->ukaido", w[:, :, c0:c0 + c], pm)
        parts.append(seg.reshape(k, kp, p * c, p * cout))
        c0 += c
    # contiguous for K2 (einsum may hand back a permuted view, at p = 1)
    return (parts[0] if len(parts) == 1 else torch.cat(parts, 2)).contiguous()


def pack_kernel_w_stride2(w: torch.Tensor, p: int):
    """(The stem's kernel [4, kp, p Cin, (p/2) Cout] on the packed grid,
    its first column offset) for the 4x4 stride-2 pad-1 conv: input pack
    p, output pack p/2 on the same column grid."""
    k, _, cin, cout = w.shape
    if k != 4 or p % 2:
        raise ValueError(f"pack_kernel_w_stride2: kernel {tuple(w.shape)} "
                         f"at pack {p} (an even pack_w0)")
    pm_host, off0 = _placement_w_stride2(k, p)
    pm = packed._on(pm_host, ("w_stride2", k, p), w.device).to(w.dtype)
    kp = pm.shape[1]
    wp = torch.einsum("uvio,vkad->ukaido", w, pm)
    return wp.reshape(k, kp, p * cin, (p // 2) * cout), off0


def tile_c_w(v: torch.Tensor, p: int) -> torch.Tensor:
    """[..., C] -> [..., p*C] matching the ``dx*C + c`` layout."""
    return torch.cat([v] * p, -1)


def conv_w(x: torch.Tensor, w: torch.Tensor, p: int,
           in_segments: Sequence[int],
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The W-packed equivalent of the SAME conv with original kernel ``w``
    (a float32 parameter, packed in float32, then cast to x's dtype), with
    the bias at each subpixel: 1x1 the dense per-subpixel product, 3x3
    through ``packed.conv_packed_kernel`` (K2 or ``conv_plain``, counted),
    5x5 ``conv_plain`` on its [5, kp] kernel."""
    packed.check_unsharded("the W-packed levels")
    k, dt = w.shape[0], x.dtype
    if k == 1:
        b, h, j, _ = x.shape
        y, c0, off = None, 0, 0
        for c in in_segments:
            xs = x[..., off:off + p * c].reshape(b, h, j, p, c)
            t = xs @ w[0, 0, c0:c0 + c].to(dt)
            y = t if y is None else y + t
            c0 += c
            off += p * c
        y = y.reshape(b, h, j, p * w.shape[-1])
    else:
        wp = pack_kernel_w(w, p, in_segments).to(dt)
        y = (packed.conv_packed_kernel(x, wp) if wp.shape[0] == wp.shape[1]
             else conv_plain(x, wp))
    return y if bias is None else y + tile_c_w(bias, p).to(y.dtype)


def stem_conv_w(x: torch.Tensor, w: torch.Tensor, p: int,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 4x4 stride-2 pad-1 stem with original kernel ``w`` on a W-packed
    input: [B, H, J, p Cin] -> [B, H/2, J, (p/2) Cout], as plain
    ``F.conv2d`` with stride (2, 1) and W padding (-off0, kp - 1 + off0),
    twice differentiable; the bias at each of the p/2 subpixels."""
    packed.check_unsharded("the W-packed discriminator stem")
    wp, off0 = pack_kernel_w_stride2(w, p)
    # a contiguous weight, as in layers.conv_plain; the W padding (-off0,
    # kp - 1 + off0) is (1, 1) at every even pack
    wt = wp.to(x.dtype).permute(3, 2, 0, 1).contiguous()
    y = F.conv2d(x.permute(0, 3, 1, 2), wt, stride=(2, 1),
                 padding=(1, -off0)).permute(0, 2, 3, 1)
    return y if bias is None else y + tile_c_w(bias, p // 2).to(y.dtype)


# ------------------------------------------------------------ norm / pools
def pool_w(x: torch.Tensor, p: int, c: int, out_pack: int) -> torch.Tensor:
    """The 2x2 stride-2 max pool of the unpacked map, W-packed: an H max,
    then the subpixel pairs' max (``torch.amax``: a tie's gradient split
    evenly), emitted with pack p/2 on the same column grid or, with
    ``out_pack`` p, column pairs regrouped (a reshape)."""
    b, h, j, pc = x.shape
    if pc != p * c or h % 2:
        raise ValueError(f"pool_w: {tuple(x.shape)} at pack {p}, {c} "
                         f"channels")
    m = x.reshape(b, h // 2, 2, j, pc).amax(2)
    m = m.reshape(b, h // 2, j, p // 2, 2, c).amax(4)
    return _regroup(m.reshape(b, h // 2, j, (p // 2) * c), p, out_pack)


def avg_pool_w(x: torch.Tensor, p: int, c: int,
               out_pack: int) -> torch.Tensor:
    """The 2x2 stride-2 average pool (the discriminator block's stride
    path) in :func:`pool_w`'s form."""
    b, h, j, pc = x.shape
    if pc != p * c or h % 2:
        raise ValueError(f"avg_pool_w: {tuple(x.shape)} at pack {p}, {c} "
                         f"channels")
    m = x.reshape(b, h // 2, 2, j, pc).mean(2)
    m = m.reshape(b, h // 2, j, p // 2, 2, c).mean(4)
    return _regroup(m.reshape(b, h // 2, j, (p // 2) * c), p, out_pack)


def _regroup(m: torch.Tensor, p: int, out_pack: int) -> torch.Tensor:
    """A pooled map of pack p/2 as is, or with ``out_pack`` p its column
    pairs as one (a reshape)."""
    if out_pack == p // 2:
        return m
    b, h, j, qc = m.shape
    if out_pack != p or j % 2:
        raise ValueError(f"pool at pack {p}: out_pack {out_pack} on {j} "
                         f"columns")
    return m.reshape(b, h, j // 2, 2 * qc)


def upsample_bilinear2_w(x: torch.Tensor, p: int,
                         out_pack: int) -> torch.Tensor:
    """2x bilinear upsample (half-pixel centres, edges clamped) of a
    W-packed map: [B, H, J, p C] -> [B, 2H, 2Jp/out_pack, out_pack C], the
    0.25/0.75 stencil on the free unpacked view, columns then rows, in x's
    dtype."""
    b, h, j, pc = x.shape
    c = pc // p
    xf = x.reshape(b, h, j * p, c)
    r0 = 0.25 * packed._shift_m(xf, 2) + 0.75 * xf
    r1 = 0.75 * xf + 0.25 * packed._shift_p(xf, 2)
    xw = torch.stack([r0, r1], 3).reshape(b, h, 2 * j * p, c)
    s0 = 0.25 * packed._shift_m(xw, 1) + 0.75 * xw
    s1 = 0.75 * xw + 0.25 * packed._shift_p(xw, 1)
    y = torch.stack([s0, s1], 2).reshape(b, 2 * h, 2 * j * p, c)
    return pack_w(y.to(x.dtype), out_pack)


def up_transposed_w(x: torch.Tensor, weight: torch.Tensor, p: int,
                    out_pack: int) -> torch.Tensor:
    """The 2x2 stride-2 transposed conv (``ConvTranspose2x2.weight`` [Cin,
    2, 2, Cout], y[2i+dy, 2j+dx] = x[i, j] @ weight[:, dy, dx]) on a
    W-packed input of pack ``p`` (1: unpacked): one product for all four
    taps, then the output subpixels in order (2*dx_in + dx) and a repack:
    [B, H, J, p Cin] -> [B, 2H, 2Jp/out_pack, out_pack Cout]."""
    b, h, j, pc = x.shape
    cin, cout = pc // p, weight.shape[-1]
    y = x.reshape(b, h, j, p, cin) @ weight.to(x.dtype).reshape(cin,
                                                               4 * cout)
    y = y.reshape(b, h, j, p, 2, 2, cout).permute(0, 1, 4, 2, 3, 5, 6)
    return repack_w(y.reshape(b, 2 * h, j, 2 * p * cout), 2 * p, out_pack)


# --------------------------------------------------------------- schedules
def level_pack(p0: int, channels: int) -> int:
    """A level's pack factor filling 128 lanes where it can, never above
    the input's ``p0`` and never below 2."""
    return max(2, min(p0, 128 // max(channels, 1)))


def w_pack_schedule(p0: int, width: int, n_levels: int) -> List[int]:
    """Each packed level's pack factor: level i+1 keeps level i's (the pool
    regroups column pairs) while ``p * C_next`` fits 128, else halves it
    (the pool's own output), never below 2."""
    ps, p = [], p0
    for i in range(n_levels):
        ps.append(p)
        c_next = _MULTS[i + 1] * width if i + 1 < 4 else 16 * width
        if p * c_next > 128:
            p = max(p // 2, 2)
    return ps


# ------------------------------------------------------------------ blocks
def basic_block_w(blk, x: torch.Tensor, in_segments: Sequence[int],
                  p: int) -> torch.Tensor:
    """``models/blocks.py`` ``BasicBlock`` ``blk`` on the W-packed ``x`` of
    pack ``p`` (``in_segments``: the channels of its concatenated inputs),
    the unfused chain whatever ``blk.fused``."""
    f = blk.conv1.features
    segs = tuple(in_segments)
    y = packed.norm_act(blk.bn1, conv_w(x, blk.conv1.weight, p, segs), p)
    y = packed.norm_act(blk.bn2, conv_w(y, blk.conv2.weight, p, (f,)), p)
    idn = x
    if blk.has_shortcut:
        idn = packed.norm_act(blk.shortcut2,
                         conv_w(x, blk.shortcut1.weight, p, segs), p)
    return blk.act(y + idn)


def bottle_block_w(blk, x: torch.Tensor, p: int) -> torch.Tensor:
    """``models/blocks.py`` ``BottleBlock`` ``blk`` on the W-packed ``x`` of
    pack ``p``; stride 2 emits pack p/2 on the same column grid."""
    f, cin = blk.conv1.features, blk.conv1.weight.shape[2]
    p_out = p // 2 if blk.stride == 2 else p
    y = packed.norm_act(blk.bn1, conv_w(x, blk.conv1.weight, p, (cin,)), p)
    idn = x
    if blk.stride == 2:
        y, idn = avg_pool_w(y, p, f, p_out), avg_pool_w(x, p, cin, p_out)
    y = packed.norm_act(blk.bn2, conv_w(y, blk.conv2.weight, p_out, (f,)), p_out)
    if blk.has_shortcut:
        idn = packed.norm_act(blk.short_norm,
                         conv_w(idn, blk.short_conv.weight, p_out, (cin,)),
                         p_out)
    return lrelu(y + idn)


def up_concat_w(up, x: torch.Tensor, skip_packed: torch.Tensor, p: int,
                out_pack: int) -> torch.Tensor:
    """``models/blocks.py`` ``UpSampleAndConcat`` ``up`` from an input of
    pack ``p`` (1: unpacked) into W-packed space of ``out_pack``, with the
    packed skip: the transposed conv (``up.up``) by
    :func:`up_transposed_w`, or the bilinear form's 1x1 (``up.up_conv``)
    first, at the low resolution (it commutes with the interpolation), then
    :func:`upsample_bilinear2_w`."""
    if hasattr(up, "up"):
        y = up_transposed_w(x, up.up.weight, p, out_pack)
    else:
        w = up.up_conv.weight
        y = upsample_bilinear2_w(conv_w(x, w, p, (w.shape[2],)), p,
                                 out_pack)
    return torch.cat([y, skip_packed.to(y.dtype)], -1)
