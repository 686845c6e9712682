# -*- coding: utf-8 -*-
"""Residual blocks and the 5-level encoder/decoder pair, NHWC.

Port of ``smsut_tpu/models/blocks.py``: 5x5 stem,
residual BasicBlocks with a 1x1+norm shortcut on channel change, max-pool
downsampling, 2x2 stride-2 transposed-conv (or bilinear + 1x1)
upsampling with skip concat, widths w/2, w .. 16w; and the
discriminator's BottleBlock.  ``norm_type`` (``"instance"`` or
``"batch"``) and ``act_type`` (``"lrelu"`` or ``"relu"``) pass down from
the Encoder and Decoder to every block and norm, as in the JAX package;
the U-Net and the UGAN towers keep instance norm and leaky ReLU, the
dual-task U-Net (``models/dtc.py``) defaults to batch norm and ReLU.
Module and parameter names mirror the flax tree (models/transplant.py
maps one onto the other).

``pack_levels`` N (1 or 2) runs the encoder's first N levels and the
decoder's last N packed, on the same parameters, in the JAX package's
``pack_mode``: "hw" on the 2x2 space-to-depth grid (``models/packed.py``):
the skips of those levels are packed maps, the encoder's level transitions
pool and repack, and the decoder's head emits packed logits, unpacked
unless ``packed_out``; "w" W-only (``models/packed_w.py``), level i at the
pack of :func:`packed_w.w_pack_schedule` from ``pack_w0``, the encoder's
stem at ``pack_w0``, the decoder's head unpacking its logits whatever
``packed_out`` (as the JAX W decoder does).  The JAX package's
``EncoderSplit``/``DecoderSplit`` (level 0 staged out for tower pairing,
hw only, ``models/paired.py``) are routes of these modules:
:meth:`Encoder.levels` from a level on and :meth:`Decoder.head`, with the
level-0 parameters read from the modules themselves.

Under a model axis (``parallel/mesh.py``) the transposed conv computes
the output channels of its weight shard and gathers them, as the convs
do (``models/layers.py``), so the skip concat joins whole tensors in the
whole tensor's channel order; a fused block gathers its weight shards and
runs K3 and K6 on the whole weights on every model rank, each rank
keeping its slice of K6's weight gradients (the JAX package gathers the
operands of its ``pallas_call``, which GSPMD does not partition), counted
in ``block.basic_block.tp_gathered``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from smsut_tpu_torch.models import packed
from smsut_tpu_torch.models import packed_w as pw
from smsut_tpu_torch.models.layers import (
    Conv,
    NormAct,
    activation,
    avg_pool2,
    kaiming_normal_fan_out,
    max_pool2,
    upsample_bilinear2,
)
from smsut_tpu_torch.ops import block as k3
from smsut_tpu_torch.ops.block import basic_block
from smsut_tpu_torch.ops.instnorm import lrelu
from smsut_tpu_torch.parallel import mesh


class BasicBlock(nn.Module):
    """2x(conv3x3 + norm), 1x1(+norm) shortcut when channels change, the
    activation after the sum.  ``fused`` runs the whole block as one call
    of kernel K3 forward and K6 backward (``Config.block_pallas``) instead
    of K2 + K1 (K4, K2, K5 backward) per layer, where those kernels take
    the block's shape (``block.takes``); a block they do not take runs the
    unfused chain and is counted in ``block.basic_block.routed``, as the
    JAX package sends such shapes to XLA (``block_pallas.enabled_for``).
    K3 and K6 compute instance norm and leaky ReLU, so another
    ``norm_type`` or ``act_type`` runs the unfused chain by its
    configuration, uncounted.  Under a space group K3 and K6 run split at
    their statistics on the rank's rows (``ops/block.py``
    ``split_block_fwd``)."""

    def __init__(self, cin: int, features: int, fused: bool = False,
                 generator: Optional[torch.Generator] = None,
                 norm_type: str = "instance", act_type: str = "lrelu"):
        super().__init__()
        self.fused = fused and (norm_type, act_type) == ("instance", "lrelu")
        self.act = activation(act_type)
        conv = lambda ci, k: Conv(ci, features, k, generator,
                                  act_type=act_type)
        self.conv1 = conv(cin, 3)
        self.bn1 = NormAct(features, act_type, norm_type)
        self.conv2 = conv(features, 3)
        self.bn2 = NormAct(features, None, norm_type)
        self.has_shortcut = cin != features
        if self.has_shortcut:
            self.shortcut1 = conv(cin, 1)
            self.shortcut2 = NormAct(features, None, norm_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            dt = x.dtype
            cout = self.conv1.features
            if not k3.takes(x.shape, cout, self.has_shortcut, dt):
                basic_block.routed += 1
            else:
                w = lambda conv: mesh.gather_channels(conv.weight.to(dt),
                                                      cout)
                if self.conv1.weight.shape[-1] != cout:
                    basic_block.tp_gathered += 1
                short = ((w(self.shortcut1), self.shortcut2.weight,
                          self.shortcut2.bias) if self.has_shortcut else ())
                return basic_block(x, w(self.conv1), self.bn1.weight,
                                   self.bn1.bias, w(self.conv2),
                                   self.bn2.weight, self.bn2.bias, *short)
        y = self.bn2(self.conv2(self.bn1(self.conv1(x))))
        idn = self.shortcut2(self.shortcut1(x)) if self.has_shortcut else x
        return self.act(y + idn)


class ConvTranspose2x2(nn.Module):
    """2x2 stride-2 transposed conv, bias-free.  ``weight`` [Cin, 2, 2, Cout]
    holds the tap that lands on output subpixel (dy, dx):
    y[2i+dy, 2j+dx] = x[i, j] @ weight[:, dy, dx].  (flax's ConvTranspose
    kernel is the same array flipped in space: models/transplant.py.)"""

    def __init__(self, cin: int, features: int,
                 generator: Optional[torch.Generator] = None,
                 act_type: str = "lrelu"):
        super().__init__()
        self.features = features
        # fan_out of the flax kernel [2, 2, Cin, Cout] is 4*Cout
        self.weight = nn.Parameter(kaiming_normal_fan_out(
            (cin, 2, 2, features), 4 * features, generator, act_type))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, cin = x.shape
        cout = self.weight.shape[-1]
        y = x @ self.weight.to(x.dtype).reshape(cin, 4 * cout)
        y = y.reshape(b, h, w, 2, 2, cout).permute(0, 1, 3, 2, 4, 5)
        return mesh.gather_channels(y.reshape(b, 2 * h, 2 * w, cout),
                                    self.features)


class UpSampleAndConcat(nn.Module):
    """2x upsample, then channel concat with the skip: a 2x2 stride-2
    transposed conv (``up``), or with ``transposed=False`` half-pixel
    bilinear then a 1x1 conv (``up_conv``)."""

    def __init__(self, cin: int, features: int,
                 generator: Optional[torch.Generator] = None,
                 transposed: bool = True, act_type: str = "lrelu"):
        super().__init__()
        if transposed:
            self.up = ConvTranspose2x2(cin, features, generator, act_type)
        else:
            self.up_conv = Conv(cin, features, 1, generator,
                                act_type=act_type)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "up"):
            y = self.up(x)
        else:
            y = self.up_conv(upsample_bilinear2(x))
        return torch.cat([y, skip.to(y.dtype)], dim=-1)


class BottleBlock(nn.Module):
    """The discriminator's residual block: conv3x3 + norm + lrelu, a 2x2
    average pool with ``stride`` 2, conv3x3 + norm; the shortcut is the
    pooled input, through a 1x1 conv + norm (``short_conv``,
    ``short_norm``) when channels change; lrelu after the sum.  Its 3x3
    convs and norms run K2/K5 and K1/K4, twice differentiable (the
    gradient penalty)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stride not in (1, 2):
            raise ValueError(f"BottleBlock: stride {stride} is not 1 or 2")
        self.stride = stride
        self.conv1 = Conv(cin, features, 3, generator)
        self.bn1 = NormAct(features, "lrelu")
        self.conv2 = Conv(features, features, 3, generator)
        self.bn2 = NormAct(features, None)
        self.has_shortcut = cin != features
        if self.has_shortcut:
            self.short_conv = Conv(cin, features, 1, generator)
            self.short_norm = NormAct(features, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn1(self.conv1(x))
        idn = x
        if self.stride == 2:
            y, idn = avg_pool2(y), avg_pool2(x)
        y = self.bn2(self.conv2(y))
        if self.has_shortcut:
            idn = self.short_norm(self.short_conv(idn))
        return lrelu(y + idn)


_MULTS = (1, 2, 4, 8)


PACK_MODES = ("hw", "w")


def check_pack_levels(pack_levels: int, pack_mode: str = "hw") -> int:
    """The packed levels the towers take: 0, 1 or 2, in a ``pack_mode``
    of :data:`PACK_MODES`."""
    if pack_levels not in (0, 1, 2):
        raise ValueError(f"pack_levels {pack_levels} is not 0, 1 or 2")
    if pack_mode not in PACK_MODES:
        raise ValueError(f"pack_mode {pack_mode!r} is not 'hw' or 'w'")
    return pack_levels


class PackedTower:
    """The packing of a tower's outer levels: ``pack_levels``, and under
    ``pack_mode`` "w" the levels' packs (``pack_ps``, from ``pack_w0``
    and the tower's ``width``)."""

    def _packing(self, pack_levels: int, pack_mode: str, pack_w0: int,
                 width: int) -> None:
        self.pack_levels = check_pack_levels(pack_levels, pack_mode)
        self.pack_mode = pack_mode
        self.pack_w0 = pack_w0
        self.pack_ps = pw.w_pack_schedule(pack_w0, width, pack_levels)

    @property
    def w_packed(self) -> bool:
        return bool(self.pack_levels) and self.pack_mode == "w"


def encoder_w(enc, x: torch.Tensor, prefix: str
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """An encoder's W route (``enc.w_packed``): the stem at ``pack_w0``,
    then its ``pack_levels`` first levels (blocks ``<prefix>1`` ..) at
    their packs, each pooled to the next level's pack, the last to the
    unpacked map.  Returns that map and the levels' W-packed skips."""
    p0, ps = enc.pack_w0, enc.pack_ps
    x = pw.pack_w(x, p0)
    x = packed.norm_act(enc.pre_bn, pw.conv_w(
        x, enc.pre_conv.weight, p0, (enc.pre_conv.weight.shape[2],)), p0)
    skips = []
    for i in range(enc.pack_levels):
        blk = getattr(enc, f"{prefix}{i + 1}")
        f = blk.conv1.features
        x = pw.basic_block_w(blk, x, (blk.conv1.weight.shape[2],), ps[i])
        skips.append(x)
        if i + 1 < enc.pack_levels:
            x = pw.pool_w(x, ps[i], f, ps[i + 1])
        else:
            x = pw.unpack_w(pw.pool_w(x, ps[i], f, ps[i] // 2), ps[i] // 2)
    return x, skips


def decoder_w(dec, x: torch.Tensor, skip, prefix: str) -> torch.Tensor:
    """A decoder's levels under ``dec.w_packed`` (``up<i>`` and
    ``<prefix><i>``, the skip of level i ``skip(i)``): the unpacked ones,
    then the ``pack_levels`` last W-packed, the bottleneck's side entering
    unpacked (pack 1).  Returns level 1's output at its pack."""
    p_cur, ps = 1, dec.pack_ps
    for i in (4, 3, 2, 1):
        up, blk = getattr(dec, f"up{i}"), getattr(dec, f"{prefix}{i}")
        if i > dec.pack_levels:
            x = blk(up(x, skip(i)))
            continue
        f = blk.conv1.features
        x = pw.basic_block_w(blk, pw.up_concat_w(up, x, skip(i), p_cur,
                                                 ps[i - 1]), (f, f),
                             ps[i - 1])
        p_cur = ps[i - 1]
    return x


def encoder_levels(enc, x: torch.Tensor, start: int, prefix: str
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Levels ``start`` .. 3 of an encoder's four (blocks ``<prefix>1`` ..
    ``<prefix>4``), each followed by its pool; the first ``pack_levels``
    run packed and pool to the next level's layout.  Returns the pooled
    output and the levels' skips in forward order."""
    p = enc.pack_levels
    skips = []
    for i in range(start, len(_MULTS)):
        blk = getattr(enc, f"{prefix}{i + 1}")
        if i < p:
            cin = blk.conv1.weight.shape[2]
            x = packed.packed_block(blk, x, (cin,))
            skips.append(x)
            x = packed.pool_to_next_level(x, blk.conv1.features,
                                          last=i + 1 >= p,
                                          fused=enc.pool_fused)
        else:
            x = blk(x)
            skips.append(x)
            x = max_pool2(x)
    return x, skips


class Encoder(PackedTower, nn.Module):
    """5x5 stem to w/2, then 4x(BasicBlock + maxpool) and a bottleneck
    block; widths w .. 16w.  Returns (bottleneck, skips).  With
    ``pack_levels`` the stem and the first levels run packed in
    ``pack_mode`` (module docstring); ``pool_fused`` pools and repacks in
    one between two hw-packed levels (``Config.pool_pack_fused``)."""

    def __init__(self, width: int, cin: int = 1, fused: bool = False,
                 generator: Optional[torch.Generator] = None,
                 norm_type: str = "instance", act_type: str = "lrelu",
                 pack_levels: int = 0, pool_fused: bool = False,
                 pack_mode: str = "hw", pack_w0: int = 8):
        super().__init__()
        self._packing(pack_levels, pack_mode, pack_w0, width)
        self.pool_fused = pool_fused
        w = width
        block = lambda ci, co: BasicBlock(ci, co, fused, generator,
                                          norm_type, act_type)
        self.pre_conv = Conv(cin, w // 2, 5, generator, act_type=act_type)
        self.pre_bn = NormAct(w // 2, act_type, norm_type)
        prev = w // 2
        for i, mult in enumerate(_MULTS):
            setattr(self, f"layer{i + 1}", block(prev, mult * w))
            prev = mult * w
        self.layer5 = block(prev, 16 * w)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        if self.w_packed:
            x, skips = encoder_w(self, x, "layer")
            h, rest = self.levels(x, self.pack_levels)
            return h, skips + rest
        if self.pack_levels:
            x = packed.pack_stem(self.pre_conv, self.pre_bn, x)
        else:
            x = self.pre_bn(self.pre_conv(x))
        return self.levels(x, 0)

    def levels(self, x: torch.Tensor, start: int
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Levels ``start`` .. 3 and the bottleneck block, from the stem's
        output (``start`` 0) or from a level's pooled output: (bottleneck,
        those levels' skips)."""
        x, skips = encoder_levels(self, x, start, "layer")
        return self.layer5(x), skips


def decoder_head(dec, x: torch.Tensor, skip, prefix: str) -> torch.Tensor:
    """A decoder's levels 4 .. 2 (``up<i>`` and ``<prefix><i>``, the skip
    of level i ``skip(i)``), the packed ones (i <= ``pack_levels``) each
    unpacked after its block: the input of level 1 on the level-1 grid."""
    p = dec.pack_levels
    for i in (4, 3, 2):
        up, blk = getattr(dec, f"up{i}"), getattr(dec, f"{prefix}{i}")
        if i > p:
            x = blk(up(x, skip(i)))
        else:
            x = packed_level(up, blk, x, skip(i))
            x = packed.depth_to_space(x, blk.conv1.features)
    return x


def packed_level(up, blk, x: torch.Tensor, skip: torch.Tensor
                 ) -> torch.Tensor:
    """A packed decoder level: up + concat into packed space, the block
    on the two packed segments."""
    f = blk.conv1.features
    return packed.packed_block(blk, packed.packed_up_concat(up, x, skip),
                               (f, f))


class Decoder(PackedTower, nn.Module):
    """4-level decoder: transposed-conv up + concat, BasicBlock, then a
    1x1 head.  With ``pack_levels`` its last levels and the head run packed
    in ``pack_mode`` against the encoder's packed skips (module
    docstring)."""

    def __init__(self, out_ch: int, width: int, fused: bool = False,
                 generator: Optional[torch.Generator] = None,
                 norm_type: str = "instance", act_type: str = "lrelu",
                 pack_levels: int = 0, pack_mode: str = "hw",
                 pack_w0: int = 8):
        super().__init__()
        self._packing(pack_levels, pack_mode, pack_w0, width)
        w = width
        for i in (4, 3, 2, 1):
            mult = _MULTS[i - 1]
            setattr(self, f"up{i}", UpSampleAndConcat(
                2 * mult * w, mult * w, generator, act_type=act_type))
            setattr(self, f"layer{i}", BasicBlock(
                2 * mult * w, mult * w, fused, generator, norm_type,
                act_type))
        self.heads(out_ch, w, generator, act_type)

    def heads(self, out_ch: int, width: int,
              generator: Optional[torch.Generator], act_type: str) -> None:
        """The 1x1 head ``fc``."""
        self.fc = Conv(width, out_ch, 1, generator, act_type=act_type)

    def head(self, x: torch.Tensor,
             skips: Sequence[torch.Tensor]) -> torch.Tensor:
        """Levels 4 .. 2: the input of level 1, unpacked."""
        return decoder_head(self, x, lambda i: skips[i - 1], "layer")

    def levels(self, x: torch.Tensor,
               skips: Sequence[torch.Tensor]) -> torch.Tensor:
        """The four up + concat + block levels, without the head (level
        1's output packed with ``pack_levels``)."""
        if self.w_packed:
            return decoder_w(self, x, lambda i: skips[i - 1], "layer")
        x = self.head(x, skips)
        if self.pack_levels:
            return packed_level(self.up1, self.layer1, x, skips[0])
        return self.layer1(self.up1(x, skips[0]))

    def fc_apply(self, y: torch.Tensor, packed_out: bool = False
                 ) -> torch.Tensor:
        """The 1x1 head on level 1's output; packed logits unpacked
        unless ``packed_out`` (W-packed ones always)."""
        if not self.pack_levels:
            return self.fc(y)
        if self.w_packed:
            p = self.pack_ps[0]
            return pw.unpack_w(pw.conv_w(y, self.fc.weight, p,
                                         (y.shape[-1] // p,)), p)
        y = packed.packed_conv(y, self.fc.weight, (y.shape[-1] // 4,))
        return y if packed_out else packed.depth_to_space(
            y, self.fc.features)

    def forward(self, x: torch.Tensor, skips: Sequence[torch.Tensor],
                packed_out: bool = False) -> torch.Tensor:
        return self.fc_apply(self.levels(x, skips), packed_out)
