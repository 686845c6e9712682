# -*- coding: utf-8 -*-
"""The UGAN family, NHWC: a StarGAN-style translator + segmenter and its
PatchGAN discriminator.

Port of the unpacked path of ``smsut_tpu/models/ugan.py``
(``pack_levels=0``, ``pair_towers=False``; the packed and paired
lowerings are TPU layouts, no-ops in the port): ``tile_modality_vec``,
``UGANEncoder``, ``UGANDecoder``, ``_UGANCore``, ``UGAN``,
``PatchSampleF``, ``UGANnce``, ``sample_patch_ids`` and
``Discriminator``.  Module and parameter names mirror the flax tree
(models/transplant.py maps one onto the other).

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
from smsut_tpu_torch.models.blocks import (BasicBlock, BottleBlock,
                                           UpSampleAndConcat)
from smsut_tpu_torch.models.layers import (Conv, NormAct,
                                           kaiming_normal_fan_out, max_pool2)
from smsut_tpu_torch.ops import acc
from smsut_tpu_torch.ops.instnorm import lrelu

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


class UGANEncoder(nn.Module):
    """5x5 stem to w/2, then 4x(BasicBlock + max pool), widths w .. 8w.
    Returns the pooled bottleneck input and the skips [e4, e3, e2, e1]."""

    def __init__(self, width: int, cin: int, fused: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
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
        x = self.pre_bn(self.pre_conv(x))
        skips = []
        for i in range(len(_MULTS)):
            x = getattr(self, f"enc{i + 1}")(x)
            skips.append(x)
            x = max_pool2(x)
        skips.reverse()
        return x, skips


class UGANDecoder(nn.Module):
    """4-level decoder: up + concat and a BasicBlock per level, then a 1x1
    head with a bias, tanh'd with ``use_tanh``.  The translation head
    upsamples bilinearly (``transposed=False``), the segmentation head by
    transposed convs."""

    def __init__(self, out_ch: int, width: int, transposed: bool = True,
                 use_tanh: bool = False, fused: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = width
        self.use_tanh = use_tanh
        for i in (4, 3, 2, 1):
            mult = _MULTS[i - 1]
            setattr(self, f"up{i}", UpSampleAndConcat(
                2 * mult * w, mult * w, generator, transposed))
            setattr(self, f"dec{i}",
                    BasicBlock(2 * mult * w, mult * w, fused, generator))
        self.fc = Conv(w, out_ch, 1, generator, use_bias=True)

    def forward(self, x: torch.Tensor,
                skips: Sequence[torch.Tensor]) -> torch.Tensor:
        for i in (4, 3, 2, 1):
            x = getattr(self, f"up{i}")(x, skips[4 - i])
            x = getattr(self, f"dec{i}")(x)
        x = self.fc(x)
        return torch.tanh(x) if self.use_tanh else x


class _UGANCore(nn.Module):
    """The twin towers: a translation encoder on the image and the
    modality vector, a segmentation encoder on the image, one shared
    bottleneck block ``enc5`` applied once to both towers' concat
    (instance norm is per sample, so this is two applies), and the two
    decoders.  Returns (seg, tsl, the translation bottleneck)."""

    def __init__(self, out_ch: int, n_modal: int, width: int, cin: int = 1,
                 fused: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = width
        self.n_modal = n_modal
        self.tsl_encoder = UGANEncoder(w, cin + n_modal, fused, generator)
        self.seg_encoder = UGANEncoder(w, cin, fused, generator)
        self.enc5 = BasicBlock(8 * w, 16 * w, fused, generator)
        self.tsl_decoder = UGANDecoder(1, w, False, True, fused, generator)
        self.seg_decoder = UGANDecoder(out_ch, w, True, False, fused,
                                       generator)

    def forward(self, x: torch.Tensor, m: Optional[torch.Tensor]):
        tsl_h, tsl_skips = self.tsl_encoder(
            tile_modality_vec(x, m, self.n_modal))
        seg_h, seg_skips = self.seg_encoder(x)
        b = x.shape[0]
        both = self.enc5(torch.cat([tsl_h, seg_h], dim=0))
        tsl_bottleneck, seg_bottleneck = both[:b], both[b:]
        tsl = self.tsl_decoder(tsl_bottleneck, tsl_skips)
        seg = self.seg_decoder(seg_bottleneck, seg_skips)
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
        sample = feat.reshape(b, h * w, c).index_select(1, patch_ids)
        y = F.relu(self.mlp_0_fc1(sample.reshape(-1, c)))
        y = acc(self.mlp_0_fc2(y))
        return y / (y.square().sum(dim=1, keepdim=True).sqrt() + 1e-7)


class _Dense(nn.Module):
    def __init__(self, cin: int, cout: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.weight = nn.Parameter(
            torch.randn((cin, cout), generator=generator) * 0.02)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.weight.to(x.dtype) + self.bias.to(x.dtype)


class _Net(nn.Module):
    """Seeded CPU init, then the move to the device, and the compute
    dtype of the input."""

    def _place(self, compute_dtype: torch.dtype, device: Device) -> None:
        self.compute_dtype = compute_dtype
        self.to(resolve_device(device))


class UGAN(_Net):
    """``UGAN(out_ch, n_modal, width)``: forward(x, m) -> (seg logits,
    translation), both float32.  ``block_fused`` runs each BasicBlock
    through K3 on the card."""

    def __init__(self, out_ch: int, n_modal: int, width: int = 16,
                 in_ch: int = 1, compute_dtype: torch.dtype = torch.bfloat16,
                 block_fused: bool = False, device: Device = None,
                 seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.core = _UGANCore(out_ch, n_modal, width, in_ch, block_fused, g)
        self._place(compute_dtype, device)

    def forward(self, x: torch.Tensor, m: Optional[torch.Tensor] = None):
        seg, tsl, _ = self.core(x.to(self.compute_dtype), m)
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
                 seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.core = _UGANCore(out_ch, n_modal, width, in_ch, block_fused, g)
        self.netF = PatchSampleF(16 * width, netF_nc, g)
        self._place(compute_dtype, device)

    def forward(self, x: torch.Tensor, m: Optional[torch.Tensor] = None,
                patch_ids: Optional[torch.Tensor] = None,
                val_phase: bool = False):
        seg, tsl, tsl_bottleneck = self.core(x.to(self.compute_dtype), m)
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
        self.weight = nn.Parameter(kaiming_normal_fan_out(
            (4, 4, cin, features), 16 * features, generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # a contiguous weight, as in layers.conv_plain
        y = F.conv2d(x.permute(0, 3, 1, 2),
                     self.weight.to(x.dtype).permute(3, 2, 0, 1).contiguous(),
                     self.bias.to(x.dtype), stride=2, padding=1)
        return y.permute(0, 2, 3, 1)


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
    n_modal]), float32."""

    def __init__(self, input_size: int, n_modal: int, width: int = 16,
                 max_width: int = 512, in_ch: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device: Device = None, seed: int = 0):
        super().__init__()
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
        k = input_size // 2 ** repeat_num
        self.conv_cls = _Kernel((k, k, cur, n_modal), k * k * n_modal, g)
        self._place(compute_dtype, device)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = lrelu(self.stem(x.to(self.compute_dtype)))
        for i in range(1, self.n_blocks + 1):
            x = getattr(self, f"block{i}")(x)
        src = self.conv_src(x)
        ck = self.conv_cls.weight.to(x.dtype)
        cls = x.reshape(x.shape[0], -1) @ ck.reshape(-1, ck.shape[-1])
        return acc(src), acc(cls)
