# -*- coding: utf-8 -*-
"""K2 and K5: 3x3 stride-1 SAME convolution, NHWC, HWIO weights, forward
and weight gradient.

Port of ``smsut_tpu/ops/conv_pallas.py`` (public ``conv_same_pallas``): K2
replaces ``_conv_fwd``, K5 ``_conv_dw``.  On a CUDA tensor
:func:`conv3x3_fwd` and :func:`conv3x3_dw` launch the kernels of
``csrc/conv3x3.cu`` and ``csrc/conv3x3_dw.cu``, which route by dtype:
bfloat16 to the tensor-core kernels (``conv3x3_tc.cuh``,
``conv3x3_dw_tc.cuh``), float32 to the CUDA-core tiles (``conv_tile.cuh``,
``conv_dw.cuh``), the parity path; on a CPU tensor they run
:func:`conv3x3_plain` (the nine taps as shifted views times the
[Cin, Cout] tap weight, summed in float32, rounded once to the input's
dtype) and :func:`conv3x3_dw_plain`.  :func:`conv3x3` is the differentiable
op, wired as ``_vjp_bwd`` wires the TPU kernels: dx is K2 itself on the
cotangent with the kernel flipped in space and IO-transposed, dw is K5.
It is twice differentiable (the discriminator's gradient penalty): the
second order is K2 and K5 again (:class:`_Conv3x3Dw`).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from smsut_tpu_torch.ops import (DTYPES, acc, counter, on_card, require,
                                 require_like)
from smsut_tpu_torch.ops._build import I, L, P, bind, check, stream_of


def conv_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME conv of NHWC ``x`` with odd-k HWIO ``w`` [k,k,Cin,Cout],
    accumulated tap by tap in float32 (float32 result)."""
    k = w.shape[0]
    b, h, wd, _ = x.shape
    xf, wf = acc(x), acc(w)
    r = k // 2
    xp = F.pad(xf, (0, 0, r, r, r, r)) if r else xf
    y = None
    for u in range(k):
        for v in range(k):
            t = xp[:, u:u + h, v:v + wd, :] @ wf[u, v]
            y = t if y is None else y + t
    return y


def dw_f32(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """Weight gradient of the SAME conv with an odd k x k kernel, float32
    [k,k,Cin,Cout]: dw[u,v] = sum over b,i,j of the (u,v)-shifted x (zero
    padded) times g, the batch-accumulated correlation."""
    b, h, wd, cin = x.shape
    r = k // 2
    xf = acc(x)
    xp = F.pad(xf, (0, 0, r, r, r, r)) if r else xf
    gf = acc(g).reshape(-1, g.shape[-1])
    taps = [xp[:, u:u + h, v:v + wd, :].reshape(-1, cin).T @ gf
            for u in range(k) for v in range(k)]
    return torch.stack(taps).reshape(k, k, cin, g.shape[-1])


def flip_io(w: torch.Tensor) -> torch.Tensor:
    """The kernel of the transposed conv: flipped in space, IO-swapped."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K2."""
    return conv_f32(x, w).to(x.dtype)


def conv3x3_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 (float32)."""
    return dw_f32(x, g, 3)


# what the C entry points refuse beyond the wrappers' own checks
_TAKES = ("the kernel needs a 16-byte aligned weight (cotangent for dw) and "
          "a block that fits the device's shared memory")
# K2 takes output channels in multiples of K2_MULT: Cout in the forward,
# Cin in the dx (K2 from Cout to Cin); K5 takes Cout in multiples of
# K5_COUT_MULT
K2_MULT, K5_COUT_MULT = 8, 16


def takes(x_shape, cout: int, dtype: torch.dtype) -> bool:
    """Whether the kernels take the whole differentiable op for an input of
    ``x_shape`` (NHWC) and ``cout`` output channels: the forward (K2), the
    dx (K2 from Cout to Cin) and the dw (K5).  A shape alone decides, in the
    manner of the JAX package's ``conv_pallas.enabled_for``, so the dx and
    dw rules hold for a forward with no gradient too (a serving conv with
    Cout 8 goes to plain PyTorch, as it would in training); the model layer
    sends the rest to plain PyTorch (``models/layers.py`` ``Conv``), since
    autograd fixes the backward's path when the forward runs.  Under a
    second order the dx's own dw (Cout = this Cin) runs plain PyTorch
    where K5 does not take it (:func:`_dw`)."""
    cin = x_shape[-1]
    return (dtype in DTYPES and len(x_shape) == 4
            and cout % K2_MULT == 0 and cin % K2_MULT == 0
            and cout % K5_COUT_MULT == 0)


@functools.lru_cache(maxsize=None)
def _kernel():
    return bind("conv3x3", "smsut_conv3x3_fwd", [P] * 3 + [I] * 6 + [P])


@functools.lru_cache(maxsize=None)
def _dw_kernel():
    return bind("conv3x3_dw", "smsut_conv3x3_dw", [P] * 4 + [I] * 6 + [P])


@functools.lru_cache(maxsize=None)
def _dw_scratch():
    return bind("conv3x3_dw", "smsut_conv3x3_dw_scratch", [I] * 5, L)


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y = conv(x, w)``, SAME zero padding; ``w`` [3,3,Cin,Cout] in x's
    dtype.  Float32 accumulation, output in x's dtype.  On the card Cout
    must be a multiple of 8."""
    if not on_card(x):
        return conv3x3_plain(x, w)
    dt = require(x, "conv3x3")
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    require_like(w, "conv3x3 weight", (3, 3, cin, cout), x.dtype, x.device)
    if cout % K2_MULT:
        raise ValueError(f"conv3x3: Cout {cout} is not a multiple of "
                         f"{K2_MULT}")
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    check(_kernel()(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h, wd, cin,
                    cout, dt, stream_of(x)), "conv3x3", _TAKES)
    conv3x3_fwd.launches += 1
    return y


counter(conv3x3_fwd)


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Float32 weight gradient [3,3,Cin,Cout] of ``conv3x3_fwd(x, w)`` for
    the output cotangent ``g``.  On the card Cout must be a multiple of
    16."""
    if not on_card(g):
        return conv3x3_dw_plain(x, g)
    dt = require(x, "conv3x3_dw")
    require(g, "conv3x3_dw cotangent")
    b, h, wd, cin = x.shape
    cout = g.shape[-1]
    if tuple(g.shape[:3]) != (b, h, wd) or g.dtype != x.dtype \
            or g.device != x.device:
        raise ValueError(f"conv3x3_dw: cotangent {g.dtype} "
                         f"{tuple(g.shape)} does not match x {x.dtype} "
                         f"{tuple(x.shape)}")
    if cout % K5_COUT_MULT:
        raise ValueError(f"conv3x3_dw: Cout {cout} is not a multiple of "
                         f"{K5_COUT_MULT}")
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=x.device)
    part = torch.empty(_dw_scratch()(b, h, wd, cin, cout),
                       dtype=torch.float32, device=x.device)
    check(_dw_kernel()(x.data_ptr(), g.data_ptr(), dw.data_ptr(),
                       part.data_ptr(), b, h, wd, cin, cout, dt,
                       stream_of(x)), "conv3x3_dw", _TAKES)
    conv3x3_dw.launches += 1
    return dw


counter(conv3x3_dw)


class _Conv3x3(torch.autograd.Function):
    """K2 forward; backward dx = K2(g, flip_io(w)), dw = K5(x, g) cast to
    w's dtype (``conv_pallas._vjp_bwd``).  ``kernel`` fixes the path of the
    forward and of every derivative: autograd runs a CUDA backward on its
    own thread, which does not see ``ops.plain()``.  The backward is made
    of the differentiable ops :func:`_conv` and :class:`_Conv3x3Dw`, so
    under ``create_graph=True`` autograd records it, and the second order
    runs on K2 and K5 too; without it, each derivative is one K2 or K5
    call."""

    @staticmethod
    def forward(ctx, x, w, kernel):
        ctx.kernel = kernel
        ctx.save_for_backward(x, w)
        return (conv3x3_fwd if kernel else conv3x3_plain)(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _conv(g, flip_io(w), ctx.kernel)
        if ctx.needs_input_grad[1]:
            dw = _dw(x, g, ctx.kernel).to(w.dtype)
        return dx, dw, None


class _Conv3x3Dw(torch.autograd.Function):
    """K5 as a differentiable op: float32 dw [3,3,Cin,Cout] of x and the
    output cotangent g.  dw is bilinear in (x, g), so for a cotangent H of
    dw: dg = conv(x, H) and dx = conv(g, flip_io(H)), K2 at the shapes of
    the forward conv and of its dx."""

    @staticmethod
    def forward(ctx, x, g, kernel):
        ctx.kernel = kernel
        ctx.save_for_backward(x, g)
        return (conv3x3_dw if kernel else conv3x3_dw_plain)(x, g)

    @staticmethod
    def backward(ctx, h):
        x, g = ctx.saved_tensors
        h = h.to(x.dtype).contiguous()
        dx = dg = None
        if ctx.needs_input_grad[0]:
            dx = _conv(g, flip_io(h), ctx.kernel)
        if ctx.needs_input_grad[1]:
            dg = _conv(x, h, ctx.kernel)
        return dx, dg, None


def _needs_graph(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _conv(x: torch.Tensor, w: torch.Tensor, kernel: bool) -> torch.Tensor:
    if _needs_graph(x, w):
        return _Conv3x3.apply(x, w, kernel)
    return (conv3x3_fwd if kernel else conv3x3_plain)(x, w)


def _dw(x: torch.Tensor, g: torch.Tensor, kernel: bool) -> torch.Tensor:
    if kernel and g.shape[-1] % K5_COUT_MULT:
        # the second order's dw of a conv's dx (Cout = the conv's Cin,
        # which :func:`takes` holds to K2_MULT only): K5 does not take it
        conv3x3.routed += 1
        kernel = False
    if _needs_graph(x, g):
        return _Conv3x3Dw.apply(x, g, kernel)
    return (conv3x3_dw if kernel else conv3x3_dw_plain)(x, g)


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The differentiable op, twice differentiable.  Without autograd it is
    one K2 call."""
    return _conv(x, w, on_card(x))


# 3x3 convs the model layer sent to plain PyTorch (not :func:`takes`), and
# second-order weight gradients K5 does not take (:func:`_dw`)
counter(conv3x3, "routed")
