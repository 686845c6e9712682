# -*- coding: utf-8 -*-
"""K1 and K4: instance norm (+ LeakyReLU 0.01), NHWC, forward and backward.

Port of ``smsut_tpu/ops/instnorm_pallas.py`` (public ``instance_norm_lrelu``
/ ``instance_norm_affine``): K1 replaces ``_fwd_call``, K4 ``_bwd_call``.
On a CUDA tensor :func:`instance_norm_fwd` and :func:`instance_norm_bwd`
launch the kernels of ``csrc/instnorm.cu`` and ``csrc/instnorm_bwd.cu``,
for any number of channels, in one launch or two by the :func:`plan` the
shape gets (decided once per shape, dtype and device), with the stream's
:func:`tickets`; on a CPU tensor they run :func:`instance_norm_plain` and
:func:`instance_norm_bwd_plain`, the same math in PyTorch.
:func:`instance_norm` is the differentiable op: K1 forward, K4 backward,
and twice differentiable (the discriminator's gradient penalty): the
second order is K4's forward again plus plain PyTorch terms
(:class:`_InstanceNormBwd`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from smsut_tpu_torch.ops import (DTYPES, acc, counter, on_card, require,
                                 require_like)
from smsut_tpu_torch.ops._build import I, L, P, bind, check, stream_of

NEG_SLOPE = 0.01
EPS = 1e-5


def lrelu(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y >= 0, y, NEG_SLOPE * y)


def stats(yf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd) [B, C] of a float32 NHWC map over H*W, with the JAX
    reference's var = E[x^2] - mean^2 (not ``torch.var``)."""
    n = yf.shape[1] * yf.shape[2]
    mean = yf.sum(dim=(1, 2)) / n
    var = (yf * yf).sum(dim=(1, 2)) / n - mean * mean
    return mean, torch.rsqrt(var + EPS)


def instance_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, act: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K1: (out in x's dtype, mean [B,C], rstd [B,C])."""
    xf = acc(x)
    mean, rstd = stats(xf)
    y = (xf - mean[:, None, None]) * rstd[:, None, None] * scale + bias
    return (lrelu(y) if act else y).to(x.dtype), mean, rstd


def norm_bwd_terms(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, act: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """(d, xhat, S_d, S_dxhat) in float32: the cotangent after the lrelu
    mask of ``_make_bwd_kernel`` (``y >= 0``), xhat, and their per-(sample,
    channel) sums over H*W."""
    xhat = (acc(x) - mean[:, None, None]) * rstd[:, None, None]
    d = acc(g)
    if act:
        d = torch.where(xhat * scale + bias >= 0, d, NEG_SLOPE * d)
    return d, xhat, d.sum(dim=(1, 2)), (d * xhat).sum(dim=(1, 2))


def norm_bwd_dx(d: torch.Tensor, xhat: torch.Tensor, sd: torch.Tensor,
                sdx: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor
                ) -> torch.Tensor:
    """dx = scale*rstd * (d - mean(d) - xhat*mean(d*xhat)), float32."""
    n = d.shape[1] * d.shape[2]
    a = (scale * rstd)[:, None, None]
    return a * (d - (sd / n)[:, None, None] - xhat * (sdx / n)[:, None, None])


def instance_norm_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                            mean: torch.Tensor, rstd: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor,
                            act: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of K4: (dx in x's dtype, dscale, dbias float32 [C])."""
    d, xhat, sd, sdx = norm_bwd_terms(x, g, mean, rstd, scale, bias, act)
    dx = norm_bwd_dx(d, xhat, sd, sdx, scale, rstd)
    return dx.to(x.dtype), sdx.sum(0), sd.sum(0)


@functools.lru_cache(maxsize=None)
def _kernel():
    return bind("instnorm", "smsut_instnorm_fwd", [P] * 9 + [I] * 5 + [P])


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    return bind("instnorm_bwd", "smsut_instnorm_bwd",
                [P] * 11 + [I] * 5 + [P])


@functools.lru_cache(maxsize=None)
def _plan_fn(kind: str):
    return bind(f"instnorm{'' if kind == 'fwd' else '_bwd'}",
                f"smsut_instnorm_{kind}_plan", [I] * 4 + [P], L)


PLAN_FIELDS = ("resident", "vec", "ng", "G", "U", "nsplit", "rows", "smem")


@functools.lru_cache(maxsize=None)
def _plan(kind: str, b: int, hw: int, c: int, dtype: torch.dtype,
          device: int):
    """(the plan's words, which the kernel entry points take back, and the
    float32 elements of scratch it needs)."""
    out = (ctypes.c_int * len(PLAN_FIELDS))()
    with torch.cuda.device(device):
        n = _plan_fn(kind)(b, hw, c, DTYPES[dtype], ctypes.addressof(out))
    if n < 0:
        raise ValueError(f"instance norm {kind}: no plan for [{b}, {hw}, "
                         f"{c}] {dtype}")
    return out, n


def plan(kind: str, b: int, hw: int, c: int, dtype: torch.dtype,
         device: int = 0) -> dict:
    """The plan K1 (``kind`` "fwd") or K4 ("bwd") takes on the card for a
    map of ``b`` samples, ``hw`` pixels and ``c`` channels: ``resident``
    (one launch, a thread-block cluster of ``nsplit`` blocks of ``rows``
    pixels per sample and channel group, the map held in shared memory; K1
    only) or two passes (``nsplit`` blocks of ``rows`` pixels per sample
    and group), ``ng`` groups of ``G`` channels, ``U`` units of 16 bytes
    (``vec``) or one element per pixel, ``smem`` bytes of shared memory per
    block; and ``scratch``, the float32 elements of scratch the call needs.
    Decided by shape and by what the card holds (csrc/instnorm.cuh
    ``in_fwd_plan``, instnorm_bwd.cuh ``in_bwd_plan``)."""
    out, n = _plan(kind, b, hw, c, dtype, device)
    return {**dict(zip(PLAN_FIELDS, out)), "scratch": n}


def _plan_and_scratch(kind: str, x: torch.Tensor
                      ) -> Tuple[int, torch.Tensor]:
    """(the address of x's plan words, an empty scratch for the call)."""
    b, h, w, c = x.shape
    words, n = _plan(kind, b, h * w, c, x.dtype, x.device.index or 0)
    return (ctypes.addressof(words),
            torch.empty(n, dtype=torch.float32, device=x.device))


# csrc/instnorm.cuh kNormTicketWords: the integer tickets that elect the
# last block of the norm sums passes (K1 and K4 two-pass, K6's norm sums)
TICKET_WORDS = 4097
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def tickets(x: torch.Tensor) -> torch.Tensor:
    """The norm sums' tickets for x's device and current stream: zero
    between calls, since the block that takes a ticket last resets it and
    the calls on one stream run one after another.  Calls on two streams at
    once take two arrays.  A CUDA graph takes the array of the stream it
    was captured on, made by the eager warm-up on that stream
    (train/graphs.py), and its replays leave it zero as calls do."""
    key = (x.device.index or 0, stream_of(x))
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros(TICKET_WORDS, dtype=torch.int32,
                                        device=x.device)
    return t


def _check_params(x: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, what: str) -> None:
    for name, t in (("scale", scale), ("bias", bias)):
        require_like(t, f"{what} {name}", (x.shape[-1],), torch.float32,
                     x.device)


def instance_norm_fwd(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, act: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """InstanceNorm2d(affine, eps 1e-5) over H*W of NHWC ``x``, then
    LeakyReLU(0.01) when ``act``.  Returns (out, mean, rstd); statistics
    are float32 whatever the dtype of ``x``."""
    if not on_card(x):
        return instance_norm_plain(x, scale, bias, act)
    dt = require(x, "instance_norm")
    b, h, w, c = x.shape
    _check_params(x, scale, bias, "instance_norm")
    out = torch.empty_like(x)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    words, scratch = _plan_and_scratch("fwd", x)
    check(_kernel()(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), mean.data_ptr(), rstd.data_ptr(), words,
                    scratch.data_ptr(), tickets(x).data_ptr(), b, h * w, c,
                    dt, int(act), stream_of(x)), "instance_norm")
    instance_norm_fwd.launches += 1
    return out, mean, rstd


counter(instance_norm_fwd)


def instance_norm_bwd(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                      rstd: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, act: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`instance_norm_fwd` from its input ``x``, its
    statistics and the cotangent ``g`` of its output: (dx in x's dtype,
    dscale, dbias float32, summed over the batch)."""
    if not on_card(g):
        return instance_norm_bwd_plain(x, g, mean, rstd, scale, bias, act)
    dt = require(x, "instance_norm_bwd")
    require_like(g, "instance_norm_bwd cotangent", x.shape, x.dtype, x.device)
    b, h, w, c = x.shape
    _check_params(x, scale, bias, "instance_norm_bwd")
    for name, t in (("mean", mean), ("rstd", rstd)):
        require_like(t, f"instance_norm_bwd {name}", (b, c), torch.float32,
                     x.device)
    dx = torch.empty_like(x)
    dsb = torch.empty((2, c), dtype=torch.float32, device=x.device)
    words, scratch = _plan_and_scratch("bwd", x)
    check(_bwd_kernel()(x.data_ptr(), g.data_ptr(), mean.data_ptr(),
                        rstd.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                        dx.data_ptr(), dsb.data_ptr(), words,
                        scratch.data_ptr(), tickets(x).data_ptr(), b, h * w,
                        c, dt, int(act), stream_of(x)), "instance_norm_bwd")
    instance_norm_bwd.launches += 1
    return dx, dsb[1], dsb[0]


counter(instance_norm_bwd)


class _InstanceNorm(torch.autograd.Function):
    """K1 forward, K4 backward.  ``kernel`` fixes the path (kernel or
    plain) of the backward and of the second order when the forward runs:
    autograd runs a CUDA backward on its own thread, which does not see
    ``ops.plain()``.  The backward is :class:`_InstanceNormBwd`, itself
    differentiable, so that ``create_graph=True`` records it."""

    @staticmethod
    def forward(ctx, x, scale, bias, act, kernel):
        ctx.kernel, ctx.act = kernel, act
        fwd = instance_norm_fwd if kernel else instance_norm_plain
        out, mean, rstd = fwd(x, scale, bias, act)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        args = (x, g.contiguous(), mean, rstd, scale, bias, ctx.act)
        if torch.is_grad_enabled():
            dx, dscale, dbias = _InstanceNormBwd.apply(*args, ctx.kernel)
        else:
            dx, dscale, dbias = (instance_norm_bwd if ctx.kernel
                                 else instance_norm_bwd_plain)(*args)
        return dx, dscale, dbias, None, None


class _InstanceNormBwd(torch.autograd.Function):
    """K4 as a differentiable op of (x, g, scale, bias): its forward is K4
    (or its plain version), its backward the second-order terms.  No TPU
    kernel computes those (XLA does, in the JAX package's gradient
    penalty), so they are plain PyTorch: autograd through
    :func:`instance_norm_bwd_plain`'s math, recomputed from x, g, scale and
    bias with the statistics taken again from x, so that their dependence
    on x is differentiated.  The lrelu mask is piecewise constant: it
    contributes nothing in x, scale or bias, and the term in g is the
    forward's JVP along the cotangent."""

    @staticmethod
    def forward(ctx, x, g, mean, rstd, scale, bias, act, kernel):
        ctx.act = act
        ctx.save_for_backward(x, g, scale, bias)
        bwd = instance_norm_bwd if kernel else instance_norm_bwd_plain
        return bwd(x, g, mean, rstd, scale, bias, act)

    @staticmethod
    def backward(ctx, hdx, hdscale, hdbias):
        instance_norm.double_backward += 1
        saved = ctx.saved_tensors
        need = [ctx.needs_input_grad[i] for i in (0, 1, 4, 5)]
        with torch.enable_grad():
            x, g, scale, bias = [t.detach().requires_grad_(n)
                                 for t, n in zip(saved, need)]
            mean, rstd = stats(acc(x))
            outs = instance_norm_bwd_plain(x, g, mean, rstd, scale, bias,
                                           ctx.act)
            pairs = [(o, h) for o, h in zip(outs, (hdx, hdscale, hdbias))
                     if o.requires_grad]
            wrt = [t for t, n in zip((x, g, scale, bias), need) if n]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [h for _, h in pairs],
                allow_unused=True))
        dx, dg, dscale, dbias = [next(got) if n else None for n in need]
        return dx, dg, None, None, dscale, dbias, None, None


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  act: bool) -> torch.Tensor:
    """The differentiable op, twice differentiable.  Without autograd
    (serving, no_grad) it is one K1 call that saves nothing."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _InstanceNorm.apply(x, scale, bias, act, on_card(x))
    return instance_norm_fwd(x, scale, bias, act)[0]


# calls of the second-order terms (:class:`_InstanceNormBwd`'s backward)
counter(instance_norm, "double_backward")
