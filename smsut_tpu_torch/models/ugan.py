# -*- coding: utf-8 -*-
"""The UGAN family, NHWC: a StarGAN-style translator + segmenter and its
PatchGAN discriminator.

Port of ``smsut_tpu/models/ugan.py``: ``tile_modality_vec``,
``UGANEncoder``, ``UGANDecoder``, ``_UGANCore``, ``UGAN``,
``PatchSampleF``, ``UGANnce``, ``sample_patch_ids`` and
``Discriminator``.  Module and parameter names mirror the flax tree
(models/transplant.py maps one onto the other).

``pack_levels`` runs the towers' outer levels packed in ``pack_mode``: "hw"
on the space-to-depth grid (``models/packed.py``), "w" W-only from
``pack_w0`` (``models/packed_w.py``).  The discriminator packs in its own
mode (the JAX package's ``d_pack_mode``): its stem on the space-to-depth
grid, or W-packed from ``pack_w0`` with, under ``pack_deep`` (the JAX
``d_pack_deep``), its stride-2 blocks W-packed while their pack is 2 or
more.  ``pair_towers`` runs both hw-packed towers' level 0 (stems, first
encoder blocks, last decoder blocks) as one tower-paired program
(``models/paired.py``), the JAX ``UGANEncoderSplit``/``UGANDecoderSplit``
being routes of the same modules; ``packed_seg`` returns the hw-packed
segmentation logits (the W decoder's are unpacked whatever it says).  The
parameter tree is the same in every layout.

Under a space axis (``parallel/mesh.py``) each rank holds rows of every
map: the towers' convs, pools and upsamples meet their neighbours in
``models/layers.py``; here the discriminator's stem takes a one-row halo,
its class head contracts the rank's rows against its rows of the kernel
and sums over the space group, and ``PatchSampleF`` takes the features at
the patch positions in the rank's rows and sums the pool over the group.

Under a model axis (``parallel/mesh.py`` ``make_mesh_2d``) the sharded
weights' layers gather their output channels (``models/layers.py``): here
the discriminator's stem and the projector's Dense layers, each before its
bias, so the towers' concats, the projector's L2 norm and the heads see
whole tensors; the D's ``conv_src`` (one channel) and ``conv_cls``
(``n_modal``) stay whole under the JAX rule.

Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``,
then moved to ``device``: the card unless ``device`` names another (no
CUDA and no device raises).  Outputs are float32 (float64 in a float64
model); activations flow in the compute dtype.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from smsut_tpu_torch.device import resolve_device
from smsut_tpu_torch.models import packed, paired
from smsut_tpu_torch.models import packed_w as pw
from smsut_tpu_torch.models.blocks import (BasicBlock, BottleBlock,
                                           UpSampleAndConcat, PackedTower,
                                           check_pack_levels, decoder_head,
                                           decoder_w, encoder_levels,
                                           encoder_w, packed_level)
from smsut_tpu_torch.models.layers import (Conv, NormAct,
                                           kaiming_normal_fan_out)
from smsut_tpu_torch.ops import acc
from smsut_tpu_torch.ops.instnorm import lrelu
from smsut_tpu_torch.parallel import distributed, mesh

Device = Optional[Union[str, torch.device]]
_MULTS = (1, 2, 4, 8)


def tile_modality_vec(x: torch.Tensor, m: Optional[torch.Tensor],
                      n_modal: int) -> torch.Tensor:
    """The per-sample modality vector concatenated as constant channels
    (zeros when ``m`` is None)."""
    b, h, w, _ = x.shape
    if m is None:
        m = x.new_zeros((b, n_modal))
    m_map = m.to(x.dtype)[:, None, None, :].expand(b, h, w, n_modal)
    return torch.cat([x, m_map], dim=-1)


class UGANEncoder(PackedTower, nn.Module):
    """5x5 stem to w/2, then 4x(BasicBlock + max pool), widths w .. 8w.
    Returns the pooled bottleneck input and the skips [e4, e3, e2, e1];
    the first ``pack_levels`` levels packed in ``pack_mode``."""

    def __init__(self, width: int, cin: int, fused: bool = False,
                 generator: Optional[torch.Generator] = None,
                 pack_levels: int = 0, pool_fused: bool = False,
                 pack_mode: str = "hw", pack_w0: int = 8):
        super().__init__()
        self._packing(pack_levels, pack_mode, pack_w0, width)
        self.pool_fused = pool_fused
        w = width
        self.pre_conv = Conv(cin, w // 2, 5, generator)
        self.pre_bn = NormAct(w // 2, "lrelu")
        prev = w // 2
        for i, mult in enumerate(_MULTS):
            setattr(self, f"enc{i + 1}",
                    BasicBlock(prev, mult * w, fused, generator))
            prev = mult * w

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        if self.w_packed:
            x, skips = encoder_w(self, x, "enc")
            x, rest = self.levels(x, self.pack_levels)
            skips += rest
        else:
            if self.pack_levels:
                x = packed.pack_stem(self.pre_conv, self.pre_bn, x)
            else:
                x = self.pre_bn(self.pre_conv(x))
            x, skips = self.levels(x, 0)
        skips.reverse()
        return x, skips

    def levels(self, x: torch.Tensor, start: int
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Levels ``start`` .. 3 with their pools: (the pooled output,
        those levels' skips in forward order)."""
        return encoder_levels(self, x, start, "enc")


class UGANDecoder(PackedTower, nn.Module):
    """4-level decoder: up + concat and a BasicBlock per level, then a 1x1
    head with a bias, tanh'd with ``use_tanh``.  The translation head
    upsamples bilinearly (``transposed=False``), the segmentation head by
    transposed convs; the last ``pack_levels`` levels packed in
    ``pack_mode``."""

    def __init__(self, out_ch: int, width: int, transposed: bool = True,
                 use_tanh: bool = False, fused: bool = False,
                 generator: Optional[torch.Generator] = None,
                 pack_levels: int = 0, pack_mode: str = "hw",
                 pack_w0: int = 8):
        super().__init__()
        self._packing(pack_levels, pack_mode, pack_w0, width)
        w = width
        self.use_tanh = use_tanh
        for i in (4, 3, 2, 1):
            mult = _MULTS[i - 1]
            setattr(self, f"up{i}", UpSampleAndConcat(
                2 * mult * w, mult * w, generator, transposed))
            setattr(self, f"dec{i}",
                    BasicBlock(2 * mult * w, mult * w, fused, generator))
        self.fc = Conv(w, out_ch, 1, generator, use_bias=True)

    def head(self, x: torch.Tensor,
             skips: Sequence[torch.Tensor]) -> torch.Tensor:
        """Levels 4 .. 2 (skips [e4, e3, e2, e1]): level 1's input."""
        return decoder_head(self, x, lambda i: skips[4 - i], "dec")

    def fc_apply(self, y: torch.Tensor, packed_out: bool = False
                 ) -> torch.Tensor:
        """The 1x1 head with its bias (tanh'd with ``use_tanh``) on level
        1's output; hw-packed outputs unpacked unless ``packed_out``,
        W-packed ones always."""
        if self.w_packed:
            p = self.pack_ps[0]
            y = pw.conv_w(y, self.fc.weight, p, (y.shape[-1] // p,),
                          self.fc.bias)
            return pw.unpack_w(torch.tanh(y) if self.use_tanh else y, p)
        if self.pack_levels:
            y = packed.packed_conv(y, self.fc.weight, (y.shape[-1] // 4,),
                                   self.fc.bias)
        else:
            y = self.fc(y)
        if self.use_tanh:
            y = torch.tanh(y)
        if self.pack_levels and not packed_out:
            y = packed.depth_to_space(y, self.fc.features)
        return y

    def forward(self, x: torch.Tensor, skips: Sequence[torch.Tensor],
                packed_out: bool = False) -> torch.Tensor:
        if self.w_packed:
            return self.fc_apply(decoder_w(self, x, lambda i: skips[4 - i],
                                           "dec"))
        x = self.head(x, skips)
        if self.pack_levels:
            x = packed_level(self.up1, self.dec1, x, skips[3])
        else:
            x = self.dec1(self.up1(x, skips[3]))
        return self.fc_apply(x, packed_out)


class _UGANCore(nn.Module):
    """The twin towers: a translation encoder on the image and the
    modality vector, a segmentation encoder on the image, one shared
    bottleneck block ``enc5`` applied once to both towers' concat
    (instance norm is per sample, so this is two applies), and the two
    decoders.  Returns (seg, tsl, the translation bottleneck).  With
    ``pack_levels`` the towers' outer levels run packed in ``pack_mode``,
    and with ``pair_towers`` under "hw" their level 0 as one paired
    program (the JAX rule: "w" towers are never paired)."""

    def __init__(self, out_ch: int, n_modal: int, width: int, cin: int = 1,
                 fused: bool = False,
                 generator: Optional[torch.Generator] = None,
                 pack_levels: int = 0, pair_towers: bool = False,
                 pool_fused: bool = False, pack_mode: str = "hw",
                 pack_w0: int = 8):
        super().__init__()
        w = width
        self.n_modal = n_modal
        self.pack_levels = pack_levels
        self.pair = (bool(pair_towers) and pack_levels >= 1
                     and pack_mode == "hw")
        pk = dict(pack_levels=pack_levels, pack_mode=pack_mode,
                  pack_w0=pack_w0)
        self.tsl_encoder = UGANEncoder(w, cin + n_modal, fused, generator,
                                       pool_fused=pool_fused, **pk)
        self.seg_encoder = UGANEncoder(w, cin, fused, generator,
                                       pool_fused=pool_fused, **pk)
        self.enc5 = BasicBlock(8 * w, 16 * w, fused, generator)
        self.tsl_decoder = UGANDecoder(1, w, False, True, fused, generator,
                                       **pk)
        self.seg_decoder = UGANDecoder(out_ch, w, True, False, fused,
                                       generator, **pk)

    def _paired_encoders(self, tsl_in: torch.Tensor, x: torch.Tensor):
        """Both encoders, level 0 paired: (tsl_h, tsl_skips, seg_h,
        seg_skips), the skips reversed as the encoders return them."""
        te, se = self.tsl_encoder, self.seg_encoder
        y = paired.paired_conv(
            torch.cat([packed.space_to_depth(tsl_in),
                       packed.space_to_depth(x)], -1),
            te.pre_conv.weight, se.pre_conv.weight, (tsl_in.shape[-1],),
            (x.shape[-1],))
        y = paired.paired_norm_act(y, te.pre_bn, se.pre_bn)
        y = paired.paired_block(y, te.enc1, se.enc1,
                                (te.pre_conv.features,))
        out = []
        w = te.enc1.conv1.features
        for enc, skip in zip((te, se), paired.split2(y)):
            h, rest = enc.levels(packed.pool_to_next_level(
                skip, w, self.pack_levels == 1, enc.pool_fused), 1)
            out += [h, list(reversed([skip] + rest))]
        return out

    def forward(self, x: torch.Tensor, m: Optional[torch.Tensor],
                packed_seg: bool = False):
        tsl_in = tile_modality_vec(x, m, self.n_modal)
        if self.pair:
            packed.check_unsharded("the paired towers")
            tsl_h, tsl_skips, seg_h, seg_skips = self._paired_encoders(
                tsl_in, x)
        else:
            tsl_h, tsl_skips = self.tsl_encoder(tsl_in)
            seg_h, seg_skips = self.seg_encoder(x)
        b = x.shape[0]
        both = self.enc5(torch.cat([tsl_h, seg_h], dim=0))
        tsl_bottleneck, seg_bottleneck = both[:b], both[b:]
        packed_seg = packed_seg and self.pack_levels > 0
        if self.pair:
            td, sd = self.tsl_decoder, self.seg_decoder
            ua = packed.packed_up_concat(
                td.up1, td.head(tsl_bottleneck, tsl_skips), tsl_skips[3])
            ub = packed.packed_up_concat(
                sd.up1, sd.head(seg_bottleneck, seg_skips), seg_skips[3])
            w = td.dec1.conv1.features
            ya, yb = paired.split2(paired.paired_block(
                torch.cat([ua, ub], -1), td.dec1, sd.dec1, (w, w)))
            tsl = td.fc_apply(ya)
            seg = sd.fc_apply(yb, packed_seg)
        else:
            tsl = self.tsl_decoder(tsl_bottleneck, tsl_skips)
            seg = self.seg_decoder(seg_bottleneck, seg_skips, packed_seg)
        return acc(seg), acc(tsl), tsl_bottleneck


class PatchSampleF(nn.Module):
    """The PatchNCE projector: the features at ``patch_ids`` (positions of
    H*W, shared across the batch), Linear-ReLU-Linear, L2-normalised.
    Weights normal(0, 0.02), biases zero; ``weight`` [in, out] as flax's
    Dense kernel."""

    def __init__(self, cin: int, nc: int = 256,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mlp_0_fc1 = _Dense(cin, nc, generator)
        self.mlp_0_fc2 = _Dense(nc, nc, generator)

    def forward(self, feat: torch.Tensor,
                patch_ids: torch.Tensor) -> torch.Tensor:
        b, h, w, c = feat.shape
        flat = feat.reshape(b, h * w, c)
        if distributed.space_count() == 1:
            sample = flat.index_select(1, patch_ids)
        else:
            # the ids index the whole map: this rank's rows hold positions
            # [s*h*w, (s+1)*h*w); the others' come in through the sum
            # (each position is in one rank's rows), whose backward hands
            # each rank the cotangent of its own
            local = patch_ids - distributed.space_index() * h * w
            mine = (local >= 0) & (local < h * w)
            sample = flat.index_select(1, local.clamp(0, h * w - 1))
            sample = mesh.space_sum(acc(sample) * mine[None, :, None]
                                    ).to(feat.dtype)
        y = F.relu(self.mlp_0_fc1(sample.reshape(-1, c)))
        y = acc(self.mlp_0_fc2(y))
        return y / (y.square().sum(dim=1, keepdim=True).sqrt() + 1e-7)


class _Dense(nn.Module):
    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.features = cout
        self.weight = nn.Parameter(
            torch.randn((cin, cout), generator=generator) * 0.02)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = mesh.gather_channels(x @ self.weight.to(x.dtype), self.features)
        return y + self.bias.to(x.dtype)


class _Net(nn.Module):
    """Seeded CPU init, then the move to the device, and the compute
    dtype of the input."""

    def _place(self, compute_dtype: torch.dtype, device: Device) -> None:
        self.compute_dtype = compute_dtype
        self.to(resolve_device(device))


class UGAN(_Net):
    """``UGAN(out_ch, n_modal, width)``: forward(x, m) -> (seg logits,
    translation), both float32 (the seg logits packed with
    ``packed_seg``).  ``block_fused`` runs each BasicBlock through K3 on
    the card; ``pack_levels``, ``pair_towers``, ``pool_fused``,
    ``pack_mode`` and ``pack_w0`` as :class:`_UGANCore`."""

    def __init__(self, out_ch: int, n_modal: int, width: int = 16,
                 in_ch: int = 1, compute_dtype: torch.dtype = torch.bfloat16,
                 block_fused: bool = False, device: Device = None,
                 seed: int = 0, pack_levels: int = 0,
                 pair_towers: bool = False, pool_fused: bool = False,
                 pack_mode: str = "hw", pack_w0: int = 8):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.core = _UGANCore(out_ch, n_modal, width, in_ch, block_fused, g,
                              pack_levels, pair_towers, pool_fused,
                              pack_mode, pack_w0)
        self._place(compute_dtype, device)

    def forward(self, x: torch.Tensor, m: Optional[torch.Tensor] = None,
                packed_seg: bool = False):
        seg, tsl, _ = self.core(x.to(self.compute_dtype), m, packed_seg)
        return seg, tsl


class UGANnce(_Net):
    """UGAN + the PatchNCE projector ``netF`` on the translation
    bottleneck (16w channels).  forward(x, m, patch_ids) -> (seg, tsl,
    feature pool [B*P, netF_nc]); ``val_phase=True`` skips the projector
    and returns (seg, tsl)."""

    def __init__(self, out_ch: int, n_modal: int, width: int = 16,
                 netF_nc: int = 256, in_ch: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 block_fused: bool = False, device: Device = None,
                 seed: int = 0, pack_levels: int = 0,
                 pair_towers: bool = False, pool_fused: bool = False,
                 pack_mode: str = "hw", pack_w0: int = 8):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.core = _UGANCore(out_ch, n_modal, width, in_ch, block_fused, g,
                              pack_levels, pair_towers, pool_fused,
                              pack_mode, pack_w0)
        self.netF = PatchSampleF(16 * width, netF_nc, g)
        self._place(compute_dtype, device)

    def forward(self, x: torch.Tensor, m: Optional[torch.Tensor] = None,
                patch_ids: Optional[torch.Tensor] = None,
                val_phase: bool = False, packed_seg: bool = False):
        seg, tsl, tsl_bottleneck = self.core(x.to(self.compute_dtype), m,
                                             packed_seg)
        if val_phase:
            return seg, tsl
        if patch_ids is None:
            raise ValueError("UGANnce: patch_ids are required outside "
                             "val_phase")
        return seg, tsl, self.netF(tsl_bottleneck, patch_ids)


def sample_patch_ids(generator: torch.Generator, hw: int,
                     num_patches: int) -> torch.Tensor:
    """One permutation of the H*W positions, truncated to
    ``num_patches``, shared across the batch (CPU, int64)."""
    return torch.randperm(hw, generator=generator)[:num_patches]


class _StemConv(nn.Module):
    """4x4 stride-2 conv, padding 1, with a bias: plain ``F.conv2d`` (XLA
    runs it in the JAX package)."""

    def __init__(self, cin: int, features: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.features = features
        self.weight = nn.Parameter(kaiming_normal_fan_out(
            (4, 4, cin, features), 16 * features, generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # under a space axis, output rows [s h/2, (s+1) h/2) read input rows
        # s h - 1 .. (s+1) h: the rank's rows with a one-row halo, unpadded
        # in H
        pad = 1
        if distributed.space_count() > 1:
            x, pad = mesh.halo_rows(x, 1), (0, 1)
        # a contiguous weight, as in layers.conv_plain
        w = self.weight.to(x.dtype).permute(3, 2, 0, 1).contiguous()
        whole = w.shape[0] == self.features
        y = F.conv2d(x.permute(0, 3, 1, 2), w,
                     self.bias.to(x.dtype) if whole else None, stride=2,
                     padding=pad).permute(0, 2, 3, 1)
        if whole:
            return y
        # a model rank's output channels, gathered, then the bias
        return (mesh.gather_channels(y, self.features)
                + self.bias.to(x.dtype))


class _Kernel(nn.Module):
    def __init__(self, shape, fan_out: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.weight = nn.Parameter(kaiming_normal_fan_out(shape, fan_out,
                                                          generator))


class Discriminator(_Net):
    """PatchGAN + modality classifier: the 4x4 stride-2 ``stem`` + lrelu,
    log2(input_size) - 3 stride-2 BottleBlocks (widths doubling from
    ``width`` up to ``max_width``), ``conv_src`` (a 3x3 conv to one
    channel, which the conv kernels do not take: plain PyTorch, counted in
    ``conv3x3.conv3x3.routed``) and ``conv_cls``, the full-kernel class
    head as one contraction.  forward(x) -> (src [B, s, s, 1], cls [B,
    n_modal]), float32.  With ``pack_levels`` > 0 and ``pack_mode`` "hw"
    the stem runs on the space-to-depth grid (``models/packed.py``
    ``packed_stride2_conv``, the JAX ``d_pack_mode="hw"``); with "w" the
    stem runs W-packed from ``pack_w0`` to ``pack_w0 / 2``
    (``models/packed_w.py``) and, under ``pack_deep``, the stride-2 blocks
    after it while their pack is 2 or more, each halving it; the same
    parameters."""

    def __init__(self, input_size: int, n_modal: int, width: int = 16,
                 max_width: int = 512, in_ch: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: Device = None, seed: int = 0, pack_levels: int = 0,
                 pack_mode: str = "hw", pack_w0: int = 8,
                 pack_deep: bool = True):
        super().__init__()
        self.pack_levels = check_pack_levels(pack_levels, pack_mode)
        self.pack_mode, self.pack_w0 = pack_mode, pack_w0
        self.pack_deep = pack_deep
        g = torch.Generator().manual_seed(seed)
        repeat_num = int(math.log2(input_size)) - 2
        self.stem = _StemConv(in_ch, width, g)
        self.n_blocks = repeat_num - 1
        cur = width
        for i in range(1, repeat_num):
            nxt = min(cur * 2, max_width)
            setattr(self, f"block{i}", BottleBlock(cur, nxt, 2, g))
            cur = nxt
        self.conv_src = Conv(cur, 1, 3, g)
        self.n_modal = n_modal
        k = input_size // 2 ** repeat_num
        self.conv_cls = _Kernel((k, k, cur, n_modal), k * k * n_modal, g)
        self._place(compute_dtype, device)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.compute_dtype)
        first = 1
        if self.pack_levels and self.pack_mode == "w":
            p = self.pack_w0
            x = lrelu(pw.stem_conv_w(pw.pack_w(x, p), self.stem.weight, p,
                                      self.stem.bias))
            p //= 2
            while self.pack_deep and p >= 2 and first <= self.n_blocks:
                x = pw.bottle_block_w(getattr(self, f"block{first}"), x, p)
                p //= 2
                first += 1
            x = pw.unpack_w(x, p)
        elif self.pack_levels:
            x = lrelu(packed.packed_stride2_conv(self.stem,
                                                 packed.space_to_depth(x)))
        else:
            x = lrelu(self.stem(x))
        for i in range(first, self.n_blocks + 1):
            x = getattr(self, f"block{i}")(x)
        src = self.conv_src(x)
        # the class head contracts the whole final map: under a space axis
        # the rank's rows against its rows of the kernel, summed over the
        # group
        ck = mesh.space_rows(self.conv_cls.weight, 0).to(x.dtype)
        cls = mesh.gather_channels(
            x.reshape(x.shape[0], -1) @ ck.reshape(-1, ck.shape[-1]),
            self.n_modal)
        return acc(src), mesh.space_sum(acc(cls))
