# -*- coding: utf-8 -*-
"""Tower-paired level-0 execution: two towers of the same shapes and
different parameters (the UGAN's translation and segmentation towers, CPS's
two U-Nets) run their packed level-0 stages as one program over the
channel-concatenated activations ``[tower_A, tower_B]``, each tower block
in the packed ``s*C + c`` layout of ``models/packed.py``.

Port of ``smsut_tpu/models/paired.py``: each twin conv pair is one conv
with the block-diagonal kernel :func:`blockdiag2` of the two packed
kernels, which doubles the executed multiply-adds of dx (the off-diagonal
products are against structural zeros, so the values are the two towers'
own).  Its weight gradient is selected as in the JAX package
(``SMSUT_PAIRED_DW``, or ``dw=`` of :func:`paired_conv`): "dense" (the
default) differentiates the dense conv, whose dw's off-diagonal half is
dropped by :func:`blockdiag2`'s backward, a slice; "block" computes the
two diagonal blocks' dw alone (:class:`_BlockDw`), half the dw's work.  A
paired 3x3 goes to K2 where ``conv3x3.takes``
accepts its ``2 * 4 * Cin`` channels, as any packed conv
(``packed.conv_packed_kernel``).  The norms stay per tower and per
original channel (K1 on each tower's packed view); the blocks run the
unfused chain, as the JAX package's ``paired_block`` does.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch

from smsut_tpu_torch.models import packed
from smsut_tpu_torch.ops import acc, on_card
from smsut_tpu_torch.ops import conv3x3 as k2
from smsut_tpu_torch.ops.instnorm import lrelu

# the paired conv's weight gradient, as the JAX package selects it
DW_IMPLS = ("dense", "block")
DW_IMPL = os.environ.get("SMSUT_PAIRED_DW", "dense")


def blockdiag2(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """[k,k,ia,oa] + [k,k,ib,ob] -> [k,k,ia+ib,oa+ob] block-diagonal."""
    k = wa.shape[0]
    if wb.shape[:2] != wa.shape[:2]:
        raise ValueError(f"blockdiag2: {tuple(wa.shape)} and "
                         f"{tuple(wb.shape)}")
    ia, oa = wa.shape[2], wa.shape[3]
    ib, ob = wb.shape[2], wb.shape[3]
    top = torch.cat([wa, wa.new_zeros((k, k, ia, ob))], 3)
    bot = torch.cat([wb.new_zeros((k, k, ib, oa)), wb], 3)
    return torch.cat([top, bot], 2)


def _routes(x: torch.Tensor, cout: int) -> bool:
    """Whether a 3x3 of ``x`` to ``cout`` channels runs K2 (its dx K2, its
    dw K5): ``packed.conv_packed_kernel``'s choice."""
    return on_card(x) and k2.takes(x.shape, cout, x.dtype)


def _dw(x: torch.Tensor, g: torch.Tensor, kp: int) -> torch.Tensor:
    """The float32 weight gradient [kp, kp, Cin, Cout] of a SAME conv of
    ``x`` for the output cotangent ``g``: K5 (or its plain version, as the
    forward's route) for a 3x3, a product for a 1x1."""
    if kp == 1:
        return (acc(x).reshape(-1, x.shape[-1]).T
                @ acc(g).reshape(-1, g.shape[-1]))[None, None]
    return k2._dw(x, g, _routes(x, g.shape[-1]))


class _BlockDw(torch.autograd.Function):
    """The paired conv with the block weight gradient (the JAX
    ``_paired_conv_blockdw``): forward and dx the dense block-diagonal conv
    (K2 as dx where it took the forward), dw one weight gradient per
    diagonal block on ``x[..., :ca]`` and ``g[..., :oa]`` (and the rest),
    the unpaired towers' own shapes.  The backward is made of
    differentiable ops."""

    @staticmethod
    def forward(ctx, x, wpa, wpb):
        ctx.save_for_backward(x, wpa, wpb)
        return packed.conv_packed_kernel(x, blockdiag2(wpa, wpb))

    @staticmethod
    def backward(ctx, g):
        x, wpa, wpb = ctx.saved_tensors
        g = g.contiguous()
        kp, ca, oa = wpa.shape[0], wpa.shape[2], wpa.shape[3]
        wp = blockdiag2(wpa, wpb)
        dx = dwa = dwb = None
        if ctx.needs_input_grad[0]:
            dx = (g @ wp[0, 0].T if kp == 1 else
                  k2._conv(g, k2.flip_io(wp), _routes(x, wp.shape[-1])))
        if ctx.needs_input_grad[1]:
            dwa = _dw(x[..., :ca].contiguous(), g[..., :oa].contiguous(),
                      kp).to(wpa.dtype)
        if ctx.needs_input_grad[2]:
            dwb = _dw(x[..., ca:].contiguous(), g[..., oa:].contiguous(),
                      kp).to(wpb.dtype)
        return dx, dwa, dwb


def paired_conv(x: torch.Tensor, wa: torch.Tensor, wb: torch.Tensor,
                segs_a: Sequence[int], segs_b: Sequence[int],
                dw: Optional[str] = None) -> torch.Tensor:
    """One conv == tower A's packed conv with original kernel ``wa`` on
    x[..., :4 sum(segs_a)] stacked with tower B's with ``wb`` on the rest;
    the kernels packed in float32, then cast to x's dtype; ``dw`` the
    weight gradient's form (default :data:`DW_IMPL`)."""
    dw = DW_IMPL if dw is None else dw
    if dw not in DW_IMPLS:
        raise ValueError(f"SMSUT_PAIRED_DW {dw!r} is not one of {DW_IMPLS}")
    dt = x.dtype
    wpa = packed.pack_kernel(wa, tuple(segs_a)).to(dt)
    wpb = packed.pack_kernel(wb, tuple(segs_b)).to(dt)
    if dw == "block":
        return _BlockDw.apply(x, wpa, wpb)
    return packed.conv_packed_kernel(x, blockdiag2(wpa, wpb))


def split2(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Undo the tower concat: [..., 8C] -> two [..., 4C] halves."""
    h = x.shape[-1] // 2
    return x[..., :h], x[..., h:]


def paired_norm_act(x: torch.Tensor, na, nb) -> torch.Tensor:
    """Each tower's ``NormAct`` (``na``, ``nb``: instance norm, their
    activation) on its half of the paired map: statistics per tower and
    per original channel over (H', W', s)."""
    a, b = split2(x)
    return torch.cat([packed.norm_act(na, a), packed.norm_act(nb, b)], -1)


def paired_block(x: torch.Tensor, blk_a, blk_b,
                 in_segments: Sequence[int]) -> torch.Tensor:
    """Two ``models/blocks.py`` ``BasicBlock``s of the same shapes on a
    paired packed map (each tower's input of ``in_segments`` packed
    channels): the unfused packed chain, every conv paired."""
    f = blk_a.conv1.features
    segs = tuple(in_segments)
    conv = lambda y, name, s: paired_conv(
        y, getattr(blk_a, name).weight, getattr(blk_b, name).weight, s, s)
    y = paired_norm_act(conv(x, "conv1", segs), blk_a.bn1, blk_b.bn1)
    y = paired_norm_act(conv(y, "conv2", (f,)), blk_a.bn2, blk_b.bn2)
    idn = x
    if blk_a.has_shortcut:
        idn = paired_norm_act(conv(x, "shortcut1", segs), blk_a.shortcut2,
                              blk_b.shortcut2)
    return lrelu(y + idn)
