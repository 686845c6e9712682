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

Under a space group (``parallel/``: each rank holds rows of every image)
the statistics run over the whole image.  K1 and K4 then split at their
sums: :func:`instance_norm_fwd_sums` (K1's sums pass over the rank's
rows), the sums added over the group, :func:`instance_norm_fwd_apply`
(K1's apply pass with the image's pixel count); and likewise
:func:`instance_norm_bwd_sums` and :func:`instance_norm_bwd_apply` for K4.
dscale and dbias are the rank's own sums (its share of the gradient,
which the group's gradient all-reduce adds); dx takes the group's.  The
second order adds its plain sums over the group too.  Without a space
group nothing of this runs: the same plans and launches as before.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from smsut_tpu_torch.ops import (DTYPES, acc, counter, on_card, require,
                                 require_like)
from smsut_tpu_torch.ops._build import I, L, P, bind, check, stream_of
from smsut_tpu_torch.parallel import distributed, mesh

NEG_SLOPE = 0.01
EPS = 1e-5


def lrelu(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y >= 0, y, NEG_SLOPE * y)


def stats(yf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd) [B, C] of a float32 NHWC map over H*W, with the JAX
    reference's var = E[x^2] - mean^2 (not ``torch.var``)."""
    return stats_of(map_sums(yf), yf.shape[1] * yf.shape[2])


def map_sums(yf: torch.Tensor) -> torch.Tensor:
    """[B, 2, C]: the sums of ``yf`` and ``yf^2`` over H*W."""
    return torch.stack([yf.sum(dim=(1, 2)), (yf * yf).sum(dim=(1, 2))], 1)


def stats_of(sums: torch.Tensor, n: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, rstd) from the sums [B, 2, C] of x and x^2 over n pixels."""
    mean = sums[:, 0] / n
    var = sums[:, 1] / n - mean * mean
    return mean, torch.rsqrt(var + EPS)


def image_pixels(x: torch.Tensor) -> int:
    """The pixels of one image of which NHWC ``x`` holds this rank's rows:
    H*W, times the space group's size under a space axis."""
    return x.shape[1] * x.shape[2] * distributed.space_count()


def instance_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, act: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K1: (out in x's dtype, mean [B,C], rstd [B,C])."""
    xf = acc(x)
    return _apply_plain(x, xf, *stats(xf), scale, bias, act)


def _apply_plain(x, xf, mean, rstd, scale, bias, act):
    y = (xf - mean[:, None, None]) * rstd[:, None, None] * scale + bias
    return (lrelu(y) if act else y).to(x.dtype), mean, rstd


def instance_norm_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1's split sums pass: [B, 2, C] float32 (float64
    for float64 ``x``), the sums of x and x^2 over the rank's rows."""
    return map_sums(acc(x))


def instance_norm_apply_plain(x: torch.Tensor, sums: torch.Tensor, n: int,
                              scale: torch.Tensor, bias: torch.Tensor,
                              act: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain version of K1's split apply pass: :func:`instance_norm_plain`
    with the statistics of ``sums`` [B, 2, C] over ``n`` pixels."""
    return _apply_plain(x, acc(x), *stats_of(sums, n), scale, bias, act)


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
                sdx: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor,
                n: int = 0) -> torch.Tensor:
    """dx = scale*rstd * (d - mean(d) - xhat*mean(d*xhat)), float32; the
    means over ``n`` pixels (0: the map's H*W)."""
    n = n or d.shape[1] * d.shape[2]
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


def instance_norm_bwd_sums_plain(x: torch.Tensor, g: torch.Tensor,
                                 mean: torch.Tensor, rstd: torch.Tensor,
                                 scale: torch.Tensor, bias: torch.Tensor,
                                 act: bool
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4's split sums pass: ([B, 2, C] = (S_d, S_dxhat)
    over the rank's rows, [2, C] = their sums over the batch: the rank's
    (dbias, dscale))."""
    _, _, sd, sdx = norm_bwd_terms(x, g, mean, rstd, scale, bias, act)
    sums = torch.stack([sd, sdx], 1)
    return sums, sums.sum(0)


def instance_norm_bwd_apply_plain(x: torch.Tensor, g: torch.Tensor,
                                  mean: torch.Tensor, rstd: torch.Tensor,
                                  scale: torch.Tensor, bias: torch.Tensor,
                                  sums: torch.Tensor, n: int, act: bool
                                  ) -> torch.Tensor:
    """Plain version of K4's split dx pass: dx in x's dtype from the sums
    [B, 2, C] over ``n`` pixels."""
    d, xhat, _, _ = norm_bwd_terms(x, g, mean, rstd, scale, bias, act)
    return norm_bwd_dx(d, xhat, sums[:, 0], sums[:, 1], scale, rstd,
                       n).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    return bind("instnorm", "smsut_instnorm_fwd", [P] * 9 + [I] * 5 + [P])


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    return bind("instnorm_bwd", "smsut_instnorm_bwd",
                [P] * 11 + [I] * 5 + [P])


@functools.lru_cache(maxsize=None)
def _split_kernels():
    """K1's and K4's split entry points: (fwd sums, fwd apply, bwd sums,
    bwd apply)."""
    return (bind("instnorm", "smsut_instnorm_fwd_sums",
                 [P] * 5 + [I] * 4 + [P]),
            bind("instnorm", "smsut_instnorm_fwd_apply",
                 [P] * 8 + [I] * 6 + [P]),
            bind("instnorm_bwd", "smsut_instnorm_bwd_sums",
                 [P] * 11 + [I] * 5 + [P]),
            bind("instnorm_bwd", "smsut_instnorm_bwd_apply",
                 [P] * 9 + [I] * 6 + [P]))


@functools.lru_cache(maxsize=None)
def _plan_fn(kind: str):
    return bind(f"instnorm{'_bwd' if kind == 'bwd' else ''}",
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
    """The plan K1 (``kind`` "fwd"; "split" for its split form, always two
    passes, whose ``scratch`` is the sums pass's partials) or K4 ("bwd",
    its split form's too) takes on the card for a
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


def _check_bwd(x, g, mean, rstd, scale, bias, what: str) -> int:
    dt = require(x, what)
    require_like(g, f"{what} cotangent", x.shape, x.dtype, x.device)
    _check_params(x, scale, bias, what)
    for name, t in (("mean", mean), ("rstd", rstd)):
        require_like(t, f"{what} {name}", (x.shape[0], x.shape[-1]),
                     torch.float32, x.device)
    return dt


def instance_norm_bwd(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
                      rstd: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, act: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`instance_norm_fwd` from its input ``x``, its
    statistics and the cotangent ``g`` of its output: (dx in x's dtype,
    dscale, dbias float32, summed over the batch)."""
    if not on_card(g):
        return instance_norm_bwd_plain(x, g, mean, rstd, scale, bias, act)
    dt = _check_bwd(x, g, mean, rstd, scale, bias, "instance_norm_bwd")
    b, h, w, c = x.shape
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


def instance_norm_fwd_sums(x: torch.Tensor) -> torch.Tensor:
    """K1's sums pass over the rank's rows of NHWC ``x``: [B, 2, C]
    float32, the sums of x and x^2 over its H*W pixels."""
    if not on_card(x):
        return instance_norm_sums_plain(x)
    dt = require(x, "instance_norm_fwd_sums")
    b, h, w, c = x.shape
    words, scratch = _plan_and_scratch("split", x)
    sums = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    check(_split_kernels()[0](x.data_ptr(), words, sums.data_ptr(),
                              scratch.data_ptr(), tickets(x).data_ptr(), b,
                              h * w, c, dt, stream_of(x)),
          "instance_norm_fwd_sums")
    instance_norm_fwd_sums.launches += 1
    return sums


counter(instance_norm_fwd_sums)


def instance_norm_fwd_apply(x: torch.Tensor, sums: torch.Tensor, n: int,
                            scale: torch.Tensor, bias: torch.Tensor,
                            act: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """K1's apply pass: (out, mean, rstd) of :func:`instance_norm_fwd`
    with the statistics of ``sums`` [B, 2, C] (the group's) over ``n``
    pixels (the image's)."""
    if not on_card(x):
        return instance_norm_apply_plain(x, sums, n, scale, bias, act)
    dt = require(x, "instance_norm_fwd_apply")
    b, h, w, c = x.shape
    _check_params(x, scale, bias, "instance_norm_fwd_apply")
    require_like(sums, "instance_norm_fwd_apply sums", (b, 2, c),
                 torch.float32, x.device)
    out = torch.empty_like(x)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    words, _ = _plan("split", b, h * w, c, x.dtype, x.device.index or 0)
    check(_split_kernels()[1](x.data_ptr(), scale.data_ptr(),
                              bias.data_ptr(), out.data_ptr(),
                              mean.data_ptr(), rstd.data_ptr(),
                              ctypes.addressof(words), sums.data_ptr(), b,
                              h * w, n, c, dt, int(act), stream_of(x)),
          "instance_norm_fwd_apply")
    instance_norm_fwd_apply.launches += 1
    return out, mean, rstd


counter(instance_norm_fwd_apply)


def instance_norm_bwd_sums(x: torch.Tensor, g: torch.Tensor,
                           mean: torch.Tensor, rstd: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor,
                           act: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's sums pass over the rank's rows: ([B, 2, C] = (S_d, S_dxhat),
    [2, C] = (dbias, dscale) of the rank's rows), float32."""
    if not on_card(g):
        return instance_norm_bwd_sums_plain(x, g, mean, rstd, scale, bias,
                                            act)
    dt = _check_bwd(x, g, mean, rstd, scale, bias, "instance_norm_bwd_sums")
    b, h, w, c = x.shape
    words, scratch = _plan_and_scratch("bwd", x)
    sums = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    dsb = torch.empty((2, c), dtype=torch.float32, device=x.device)
    check(_split_kernels()[2](x.data_ptr(), g.data_ptr(), mean.data_ptr(),
                              rstd.data_ptr(), scale.data_ptr(),
                              bias.data_ptr(), sums.data_ptr(),
                              dsb.data_ptr(), words, scratch.data_ptr(),
                              tickets(x).data_ptr(), b, h * w, c, dt,
                              int(act), stream_of(x)),
          "instance_norm_bwd_sums")
    instance_norm_bwd_sums.launches += 1
    return sums, dsb


counter(instance_norm_bwd_sums)


def instance_norm_bwd_apply(x: torch.Tensor, g: torch.Tensor,
                            mean: torch.Tensor, rstd: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor,
                            sums: torch.Tensor, n: int, act: bool
                            ) -> torch.Tensor:
    """K4's dx pass: dx in x's dtype from ``sums`` [B, 2, C] (the
    group's) over ``n`` pixels (the image's)."""
    if not on_card(g):
        return instance_norm_bwd_apply_plain(x, g, mean, rstd, scale, bias,
                                             sums, n, act)
    dt = _check_bwd(x, g, mean, rstd, scale, bias, "instance_norm_bwd_apply")
    b, h, w, c = x.shape
    require_like(sums, "instance_norm_bwd_apply sums", (b, 2, c),
                 torch.float32, x.device)
    dx = torch.empty_like(x)
    words, _ = _plan("bwd", b, h * w, c, x.dtype, x.device.index or 0)
    check(_split_kernels()[3](x.data_ptr(), g.data_ptr(), mean.data_ptr(),
                              rstd.data_ptr(), scale.data_ptr(),
                              bias.data_ptr(), dx.data_ptr(),
                              ctypes.addressof(words), sums.data_ptr(), b,
                              h * w, n, c, dt, int(act), stream_of(x)),
          "instance_norm_bwd_apply")
    instance_norm_bwd_apply.launches += 1
    return dx


counter(instance_norm_bwd_apply)


def split_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              act: bool, kernel: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 over a space group: the rank's sums, added over the group (in
    place, not differentiable: the callers are the autograd functions'
    own passes), then the apply with the image's pixel count (the plain
    versions without ``kernel``)."""
    fs, fa = ((instance_norm_fwd_sums, instance_norm_fwd_apply) if kernel
              else (instance_norm_sums_plain, instance_norm_apply_plain))
    return fa(x, mesh.space_all_reduce_(fs(x)), image_pixels(x), scale,
              bias, act)


def split_bwd(x: torch.Tensor, g: torch.Tensor, mean: torch.Tensor,
              rstd: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              act: bool, kernel: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 over a space group: (dx from the group's sums, the rank's dscale
    and dbias)."""
    bs, ba = ((instance_norm_bwd_sums, instance_norm_bwd_apply) if kernel
              else (instance_norm_bwd_sums_plain,
                    instance_norm_bwd_apply_plain))
    sums, dsb = bs(x, g, mean, rstd, scale, bias, act)
    dx = ba(x, g, mean, rstd, scale, bias, mesh.space_all_reduce_(sums),
            image_pixels(x), act)
    return dx, dsb[1], dsb[0]


class _InstanceNorm(torch.autograd.Function):
    """K1 forward, K4 backward.  ``kernel`` fixes the path (kernel or
    plain) of the backward and of the second order when the forward runs:
    autograd runs a CUDA backward on its own thread, which does not see
    ``ops.plain()``.  The backward is :class:`_InstanceNormBwd`, itself
    differentiable, so that ``create_graph=True`` records it."""

    @staticmethod
    def forward(ctx, x, scale, bias, act, kernel):
        ctx.kernel, ctx.act = kernel, act
        ctx.split = distributed.space_count() > 1
        if ctx.split:
            out, mean, rstd = split_fwd(x, scale, bias, act, kernel)
        else:
            fwd = instance_norm_fwd if kernel else instance_norm_plain
            out, mean, rstd = fwd(x, scale, bias, act)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        args = (x, g.contiguous(), mean, rstd, scale, bias, ctx.act)
        if torch.is_grad_enabled():
            dx, dscale, dbias = _InstanceNormBwd.apply(*args, ctx.kernel,
                                                       ctx.split)
        else:
            dx, dscale, dbias = _bwd(*args, ctx.kernel, ctx.split)
        return dx, dscale, dbias, None, None


def _bwd(x, g, mean, rstd, scale, bias, act, kernel, split):
    """K4 (or its plain version), split over the space group with
    ``split``."""
    if split:
        return split_bwd(x, g, mean, rstd, scale, bias, act, kernel)
    return (instance_norm_bwd if kernel
            else instance_norm_bwd_plain)(x, g, mean, rstd, scale, bias, act)


class _InstanceNormBwd(torch.autograd.Function):
    """K4 as a differentiable op of (x, g, scale, bias): its forward is K4
    (or its plain version), its backward the second-order terms.  No TPU
    kernel computes those (XLA does, in the JAX package's gradient
    penalty), so they are plain PyTorch: autograd through
    :func:`instance_norm_bwd_plain`'s math, recomputed from x, g, scale and
    bias with the statistics taken again from x, so that their dependence
    on x is differentiated.  The lrelu mask is piecewise constant: it
    contributes nothing in x, scale or bias, and the term in g is the
    forward's JVP along the cotangent.  Under a space group the sums over
    H*W in that math are the group's (:func:`parallel.mesh.space_sum`,
    differentiable), and dscale and dbias the rank's own."""

    @staticmethod
    def forward(ctx, x, g, mean, rstd, scale, bias, act, kernel, split):
        ctx.act, ctx.split = act, split
        ctx.save_for_backward(x, g, scale, bias)
        return _bwd(x, g, mean, rstd, scale, bias, act, kernel, split)

    @staticmethod
    def backward(ctx, hdx, hdscale, hdbias):
        instance_norm.double_backward += 1
        saved = ctx.saved_tensors
        need = [ctx.needs_input_grad[i] for i in (0, 1, 4, 5)]
        with torch.enable_grad():
            x, g, scale, bias = [t.detach().requires_grad_(n)
                                 for t, n in zip(saved, need)]
            outs = _second_order_terms(x, g, scale, bias, ctx.act,
                                       ctx.split)
            pairs = [(o, h) for o, h in zip(outs, (hdx, hdscale, hdbias))
                     if o.requires_grad]
            wrt = [t for t, n in zip((x, g, scale, bias), need) if n]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [h for _, h in pairs],
                allow_unused=True))
        dx, dg, dscale, dbias = [next(got) if n else None for n in need]
        return dx, dg, None, None, dscale, dbias, None, None, None


def _second_order_terms(x, g, scale, bias, act, split):
    """K4's outputs (dx, dscale, dbias) as a plain function of x, g, scale
    and bias, the statistics taken again from x, for autograd to
    differentiate; the sums over H*W the space group's with ``split``."""
    if not split:
        mean, rstd = stats(acc(x))
        return instance_norm_bwd_plain(x, g, mean, rstd, scale, bias, act)
    n = image_pixels(x)
    mean, rstd = stats_of(mesh.space_sum(map_sums(acc(x))), n)
    d, xhat, sd, sdx = norm_bwd_terms(x, g, mean, rstd, scale, bias, act)
    tot = mesh.space_sum(torch.stack([sd, sdx]))
    dx = norm_bwd_dx(d, xhat, tot[0], tot[1], scale, rstd, n)
    return dx.to(x.dtype), sdx.sum(0), sd.sum(0)


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  act: bool) -> torch.Tensor:
    """The differentiable op, twice differentiable.  Without autograd
    (serving, no_grad) it is one K1 call that saves nothing."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _InstanceNorm.apply(x, scale, bias, act, on_card(x))
    if distributed.space_count() > 1:
        return split_fwd(x, scale, bias, act, on_card(x))[0]
    return instance_norm_fwd(x, scale, bias, act)[0]


# calls of the second-order terms (:class:`_InstanceNormBwd`'s backward)
counter(instance_norm, "double_backward")
