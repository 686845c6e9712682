# -*- coding: utf-8 -*-
"""Segmentation U-Net, NHWC (port of ``smsut_tpu/models/unet.py`` ``UNet``
and ``UNetPair``, instance norm, leaky ReLU).

``pack_levels`` N runs the first N levels of the encoder and the last N of
the decoder packed, on the same parameters (``models/blocks.py``), in
``pack_mode`` "hw" on the space-to-depth grid (``models/packed.py``) or
"w" W-only from ``pack_w0`` (``models/packed_w.py``); ``packed_out``
returns the hw-packed logits [B, H/2, W/2, 4 out_ch] for the packed losses
(``ops/losses.py``), the W route's logits unpacked whatever it says, as
the JAX W decoder returns them.  The U-Net is instance-normed, so it packs
wherever asked (the JAX ``UNet`` does not pack under batch norm).
:class:`UNetPair` runs two hw-packed U-Nets on one input with their
level-0 stages tower-paired (``models/paired.py``).

Logits are returned in float32 so that losses and argmax stay
full-precision under bfloat16 compute.

``remat`` rematerialises the encoder and the decoder in the backward, as
the JAX package's ``nn.remat(Encoder)`` and ``nn.remat(Decoder)`` do: each
runs under its own checkpoint (:func:`rematerialised`), which keeps only
its inputs and runs it again in the backward (the fused blocks' K3
included, and under a space group their halos and sums, in the forward's
order).  The same function on another schedule: less activation memory
for one more forward of the towers.  Only under grad; serving does not
change.
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from smsut_tpu_torch.device import resolve_device
from smsut_tpu_torch.models import packed, paired
from smsut_tpu_torch.models.blocks import Decoder, Encoder


def rematerialised(mod: nn.Module, *args,
                   params: Optional[Mapping[str, torch.Tensor]] = None):
    """``mod(*args)`` under ``torch.utils.checkpoint``, non-reentrant and
    keeping no RNG state (the port's forwards draw nothing: their draws
    are inputs; and a CUDA graph's capture may not read the RNG state).
    ``mod``'s parameters (``params``, or those it holds now: the leaves of
    an enclosing ``torch.func.functional_call``) are inputs of the
    checkpointed function, so that the backward's second forward runs on
    the same tensors after ``functional_call`` has put the module's own
    back."""
    p = dict(mod.named_parameters()) if params is None else dict(params)
    return checkpoint(lambda p, *a: torch.func.functional_call(mod, p, a),
                      p, *args, use_reentrant=False,
                      preserve_rng_state=False)


class UNet(nn.Module):
    """``UNet(out_ch, width)``: the trainers build ``UNet(5, 16)``.

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    (so a seed gives the same weights on every device), then moved to
    ``device``: the card unless ``device`` names another (no CUDA and no
    device raises).  ``block_fused`` runs each BasicBlock through kernel
    K3 on the card; ``remat`` rematerialises the encoder and the decoder
    under grad (module docstring); ``pack_levels``, ``pool_fused``,
    ``pack_mode`` and ``pack_w0`` as ``models/blocks.py`` ``Encoder``."""

    def __init__(self, out_ch: int, width: int = 16, in_ch: int = 1,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 block_fused: bool = False,
                 device: Optional[Union[str, torch.device]] = None,
                 seed: int = 0, remat: bool = False, pack_levels: int = 0,
                 pool_fused: bool = False, pack_mode: str = "hw",
                 pack_w0: int = 8):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.pack_levels = pack_levels
        self.pack_mode = pack_mode
        g = torch.Generator().manual_seed(seed)
        pk = dict(pack_levels=pack_levels, pack_mode=pack_mode,
                  pack_w0=pack_w0)
        self.encoder = Encoder(width, in_ch, block_fused, g,
                               pool_fused=pool_fused, **pk)
        self.decoder = Decoder(out_ch, width, block_fused, g, **pk)
        self.to(device)

    def forward(self, x: torch.Tensor,
                packed_out: bool = False) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        packed_out = packed_out and self.pack_levels > 0
        if self.remat and torch.is_grad_enabled():
            h, skips = rematerialised(self.encoder, x)
            return rematerialised(self.decoder, h, skips,
                                  packed_out).float()
        h, skips = self.encoder(x)
        return self.decoder(h, skips, packed_out).float()


class UNetPair(nn.Module):
    """Two U-Nets ``n1`` and ``n2`` (each a :class:`UNet` of its own
    parameters, ``pack_levels`` >= 1) on the same input as one
    tower-paired program: both nets' level-0 stages (the stem, the first
    encoder block, the last decoder block) run as block-diagonal convs over
    the channel-concatenated activations (``models/paired.py``), the rest
    net by net.  The same function as the two U-Nets.  Built from two
    U-Nets (or, with ``torch.func.functional_call``, over the parameters
    ``n1.<key>``, ``n2.<key>``)."""

    def __init__(self, n1: UNet, n2: UNet):
        super().__init__()
        if (not n1.pack_levels or n1.pack_levels != n2.pack_levels
                or "hw" != n1.pack_mode or "hw" != n2.pack_mode):
            raise ValueError("UNetPair: both nets hw-packed alike, "
                             "pack_levels >= 1")
        self.n1, self.n2 = n1, n2

    def forward(self, x: torch.Tensor, packed_out: bool = False):
        packed.check_unsharded("UNetPair")
        n1, n2 = self.n1, self.n2
        x = x.to(n1.compute_dtype)
        e1, e2 = n1.encoder, n2.encoder
        xp = packed.space_to_depth(x)
        cin = (x.shape[-1],)
        y = paired.paired_conv(torch.cat([xp, xp], -1), e1.pre_conv.weight,
                               e2.pre_conv.weight, cin, cin)
        y = paired.paired_norm_act(y, e1.pre_bn, e2.pre_bn)
        w2 = e1.pre_conv.features
        y = paired.paired_block(y, e1.layer1, e2.layer1, (w2,))
        skip_a, skip_b = paired.split2(y)
        w = e1.layer1.conv1.features
        last = n1.pack_levels == 1
        h1, rest1 = e1.levels(packed.pool_to_next_level(
            skip_a, w, last, e1.pool_fused), 1)
        h2, rest2 = e2.levels(packed.pool_to_next_level(
            skip_b, w, last, e2.pool_fused), 1)
        sk1, sk2 = [skip_a] + rest1, [skip_b] + rest2
        d1, d2 = n1.decoder, n2.decoder
        u1 = packed.packed_up_concat(d1.up1, d1.head(h1, sk1), sk1[0])
        u2 = packed.packed_up_concat(d2.up1, d2.head(h2, sk2), sk2[0])
        yd = paired.paired_block(torch.cat([u1, u2], -1), d1.layer1,
                                 d2.layer1, (w, w))
        ya, yb = paired.split2(yd)
        return (d1.fc_apply(ya, packed_out).float(),
                d2.fc_apply(yb, packed_out).float())
