# -*- coding: utf-8 -*-
"""K3 and K6: fused residual BasicBlock, NHWC, identity and 1x1-shortcut
forms, forward and backward.

Port of ``smsut_tpu/ops/block_pallas.py`` (public ``fused_block``,
``fused_block_short``, ``fused_block_fwd``, ``apply_fused_block``), on the
unpacked NHWC map: K3 replaces ``_fwd_call``, K6 ``_bwd_call``.  On a CUDA
tensor :func:`basic_block_fwd` and :func:`basic_block_bwd` launch the
chains of ``csrc/block.cu`` and ``csrc/block_bwd.cu``; on a CPU tensor they
run :func:`basic_block_plain` and :func:`basic_block_bwd_plain`.
:func:`basic_block` is the differentiable op.

Both directions follow the TPU kernels' rounding: statistics from the
float32 conv accumulators, normalisation applied to the stored
(dtype-rounded) conv outputs, the pre-activation sum in float32; in the
backward dy2, dy1 and du are rounded to the activation dtype before they
enter a conv, and the lrelu' mask is ``v > 0 ? 1 : slope``.  In float32
the forward equals the unfused K2 + K1 chain up to summation order; in
bfloat16 the unfused chain takes its statistics from the rounded conv
outputs instead, so the two differ by bfloat16 rounding.

Residuals.  The TPU forward saves z1 and the pre-activation.  Here the
forward keeps what it computes anyway, the rounded conv outputs y1, y2, u
and each norm's (g, h) per sample, plus each norm's (mean, rstd); the
backward rebuilds z1 and the pre-activation from them with the forward's
rounding.  That costs no extra write of a map in the forward.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from smsut_tpu_torch.ops import (DTYPES, counter, on_card, require,
                                 require_like)
from smsut_tpu_torch.ops._build import I, L, P, bind, check, stream_of
from smsut_tpu_torch.ops.conv3x3 import conv_f32, dw_f32, flip_io
from smsut_tpu_torch.ops.instnorm import (
    NEG_SLOPE,
    lrelu,
    norm_bwd_dx,
    norm_bwd_terms,
    stats,
    tickets,
)


class Residuals(NamedTuple):
    """What the backward needs of the forward besides its inputs: the
    rounded conv outputs y1, y2, u (None in the identity form), ``gh``
    [3, B, 2, C] = per-sample (g, h) of norms 1, 2, s with norm(y)*scale +
    bias == y*g + h, and ``st`` [3, 2, B, C] = their (mean, rstd)."""
    y1: torch.Tensor
    y2: torch.Tensor
    u: Optional[torch.Tensor]
    gh: torch.Tensor
    st: torch.Tensor


def _bc(t: torch.Tensor) -> torch.Tensor:
    """[B, C] -> [B, 1, 1, C]"""
    return t[:, None, None]


def lrelu_grad(v: torch.Tensor) -> torch.Tensor:
    """``_lrelu_mask``: 1 where v > 0, else the slope (v == 0 included)."""
    return torch.where(v > 0, 1.0, NEG_SLOPE)


def basic_block_plain(x, w1, s1, b1, w2, s2, b2, ws=None, ss=None, bs=None,
                      save: bool = False):
    """Plain version of K3: out, or (out, Residuals) with ``save``."""
    dt = x.dtype
    gh = torch.zeros((3, x.shape[0], 2, w1.shape[-1]), device=x.device)
    st = torch.zeros((3, 2, x.shape[0], w1.shape[-1]), device=x.device)

    def norm(k, yf, scale, bias):
        """stored y, and y*g + h in float32 on it"""
        mean, rstd = stats(yf)
        g = scale * rstd
        gh[k, :, 0], gh[k, :, 1] = g, bias - mean * g
        st[k, 0], st[k, 1] = mean, rstd
        y = yf.to(dt)
        return y, y.float() * _bc(gh[k, :, 0]) + _bc(gh[k, :, 1])

    y1, n1 = norm(0, conv_f32(x, w1), s1, b1)
    z1 = lrelu(n1).to(dt)
    y2, pre = norm(1, conv_f32(z1, w2), s2, b2)
    u = None
    if ws is None:
        pre = pre + x.float()
    else:
        u, ns = norm(2, conv_f32(x, ws), ss, bs)
        pre = pre + ns
    out = lrelu(pre).to(dt)
    return (out, Residuals(y1, y2, u, gh, st)) if save else out


def basic_block_bwd_plain(g, x, w1, s1, w2, s2, ws, ss, res: Residuals):
    """Plain version of K6, the arithmetic of ``_bwd_kernel`` on the
    unpacked map: (dx in x's dtype, dw1, dw2, dws or None, and the float32
    gradients of s1, b1, s2, b2, ss, bs as a [6, C] tensor)."""
    dt = x.dtype
    n = x.shape[1] * x.shape[2]
    y1, y2, u, gh, st = res
    G = lambda k, j: _bc(gh[k, :, j])
    M = lambda k, j: _bc(st[k, j])
    y2f = y2.float()
    pre = y2f * G(1, 0) + G(1, 1)
    if u is None:
        pre = pre + x.float()
    else:
        uf = u.float()
        pre = pre + (uf * G(2, 0) + G(2, 1))
    gp = g.float() * lrelu_grad(pre)
    xh2 = (y2f - M(1, 0)) * M(1, 1)
    sd2, sdx2 = gp.sum(dim=(1, 2)), (gp * xh2).sum(dim=(1, 2))
    # dy2 from gp rounded as the TPU kernel stores it (gb), du from gp
    dy2 = norm_bwd_dx(gp.to(dt).float(), xh2, sd2, sdx2, s2, st[1, 1])
    dy2 = dy2.to(dt)
    z1 = lrelu(y1.float() * G(0, 0) + G(0, 1)).to(dt)
    dw2 = dw_f32(z1, dy2, 3)
    dn1 = (conv_f32(dy2, flip_io(w2)) * lrelu_grad(z1.float())).to(dt)
    d1, xh1, sd1, sdx1 = norm_bwd_terms(y1, dn1, st[0, 0], st[0, 1], s1,
                                        None, False)
    dy1 = norm_bwd_dx(d1, xh1, sd1, sdx1, s1, st[0, 1]).to(dt)
    dw1 = dw_f32(x, dy1, 3)
    dx = conv_f32(dy1, flip_io(w1))
    dws = None
    sdxs = torch.zeros_like(sd2)
    if u is None:
        dx = dx + gp
    else:
        xhs = (uf - M(2, 0)) * M(2, 1)
        sdxs = (gp * xhs).sum(dim=(1, 2))
        du = norm_bwd_dx(gp, xhs, sd2, sdxs, ss, st[2, 1]).to(dt)
        dws = dw_f32(x, du, 1)
        dx = dx + du.float() @ ws[0, 0].float().T
    dsb = torch.stack([sdx1.sum(0), sd1.sum(0), sdx2.sum(0), sd2.sum(0),
                       sdxs.sum(0), sd2.sum(0)])
    return dx.to(dt), dw1, dw2, dws, dsb


@functools.lru_cache(maxsize=None)
def _kernel():
    return bind("block", "smsut_block_fwd", [P] * 17 + [I] * 6 + [P])


@functools.lru_cache(maxsize=None)
def _ntiles_fn():
    return bind("block", "smsut_block_ntiles", [I] * 6)


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    return bind("block_bwd", "smsut_block_bwd", [P] * 20 + [I] * 6 + [P])


@functools.lru_cache(maxsize=None)
def _bwd_scratch():
    return bind("block_bwd", "smsut_block_bwd_scratch", [I] * 7, L)


# what the C entry points refuse beyond the checks here: in bfloat16 a
# shape or weight the tensor-core kernels do not take (nothing is launched;
# there is no fallback to the CUDA-core convs)
REFUSED_SHAPE = ("the tensor-core convs do not take this shape (weights not "
                 "16-byte aligned, or no tile that fits shared memory)")


# what K3 and K6 take: Cout a multiple of 16 (both), Cin of 8 (K6)
_COUT_MULT, _CIN_MULT = 16, 8


def takes(x_shape, cout: int, shortcut: bool, dtype: torch.dtype) -> bool:
    """Whether K3 and K6 take the whole block for an input of ``x_shape``
    (NHWC), ``cout`` output channels and the shortcut form or the identity
    form (which needs Cin == Cout).  A shape alone decides, in the manner of
    the JAX package's ``block_pallas.enabled_for``; the model layer runs the
    rest as the unfused chain (``models/blocks.py`` ``BasicBlock``)."""
    cin = x_shape[-1]
    return (dtype in DTYPES and len(x_shape) == 4
            and cout % _COUT_MULT == 0 and cin % _CIN_MULT == 0
            and (shortcut or cin == cout))


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_block(x, w1, w2, ws, params, what) -> Tuple[int, int]:
    b, h, wd, ci = x.shape
    co = w1.shape[-1]
    dev = x.device
    require_like(w1, f"{what} w1", (3, 3, ci, co), x.dtype, dev)
    require_like(w2, f"{what} w2", (3, 3, co, co), x.dtype, dev)
    if ws is not None:
        require_like(ws, f"{what} ws", (1, 1, ci, co), x.dtype, dev)
    elif ci != co:
        raise ValueError(f"{what}: identity form needs Cin == Cout, got "
                         f"{ci} -> {co}")
    for name, t in params:
        require_like(t, f"{what} {name}", (co,), torch.float32, dev)
    if co % _COUT_MULT:
        raise ValueError(f"{what}: Cout {co} is not a multiple of "
                         f"{_COUT_MULT}")
    return ci, co


def basic_block_fwd(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                    b1: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
                    b2: torch.Tensor, ws: Optional[torch.Tensor] = None,
                    ss: Optional[torch.Tensor] = None,
                    bs: Optional[torch.Tensor] = None, save: bool = False):
    """lrelu(IN(conv3(lrelu(IN(conv3(x, w1))), w2)) + idn), idn = x or
    IN(conv1x1(x, ws)).  Conv weights HWIO in x's dtype (``ws``
    [1,1,Cin,Cout]); norm parameters [Cout] float32.  Returns out, or
    (out, Residuals) with ``save``.  On the card Cout must be a multiple of
    16."""
    if not on_card(x):
        return basic_block_plain(x, w1, s1, b1, w2, s2, b2, ws, ss, bs, save)
    dt = require(x, "basic_block")
    params = [("s1", s1), ("b1", b1), ("s2", s2), ("b2", b2)]
    if ws is not None:
        params += [("ss", ss), ("bs", bs)]
    _, co = _check_block(x, w1, w2, ws, params, "basic_block")
    b, h, wd, _ = x.shape
    dev = x.device
    out = torch.empty((b, h, wd, co), dtype=x.dtype, device=dev)
    y1 = torch.empty_like(out)
    y2 = torch.empty_like(out)
    u = torch.empty_like(out) if ws is not None else None
    # the statistics' partials per sample: the most of the chain's convs,
    # each by its own plan (the tensor-core plan in bfloat16)
    nt = _ntiles_fn()(b, h, wd, x.shape[-1], co, dt)
    part = torch.empty((b, max(nt, 1), 2, co), dtype=torch.float32,
                       device=dev)
    gh = torch.empty((3, b, 2, co), dtype=torch.float32, device=dev)
    st = (torch.empty((3, 2, b, co), dtype=torch.float32, device=dev)
          if save else None)
    check(_kernel()(x.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
                    w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), _ptr(ws),
                    _ptr(ss), _ptr(bs), out.data_ptr(), y1.data_ptr(),
                    y2.data_ptr(), _ptr(u), part.data_ptr(), gh.data_ptr(),
                    _ptr(st), b, h, wd, x.shape[-1], co, dt, stream_of(x)),
          "basic_block", REFUSED_SHAPE)
    basic_block_fwd.launches += 1
    return (out, Residuals(y1, y2, u, gh, st)) if save else out


counter(basic_block_fwd)


def basic_block_bwd(g: torch.Tensor, x: torch.Tensor, w1: torch.Tensor,
                    s1: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
                    ws: Optional[torch.Tensor], ss: Optional[torch.Tensor],
                    res: Residuals):
    """Backward of :func:`basic_block_fwd` for the cotangent ``g`` of its
    output: (dx in x's dtype, dw1, dw2, dws (None in the identity form)
    float32, and [6, C] float32 gradients of (s1, b1, s2, b2, ss, bs))."""
    if not on_card(g):
        return basic_block_bwd_plain(g, x, w1, s1, w2, s2, ws, ss, res)
    dt = require(x, "basic_block_bwd")
    params = [("s1", s1), ("s2", s2)] + ([("ss", ss)] if ws is not None
                                         else [])
    ci, co = _check_block(x, w1, w2, ws, params, "basic_block_bwd")
    if ci % _CIN_MULT:
        raise ValueError(f"basic_block_bwd: Cin {ci} is not a multiple of "
                         f"{_CIN_MULT}")
    b, h, wd, _ = x.shape
    dev = x.device
    maps = [("cotangent", g), ("y1", res.y1), ("y2", res.y2)]
    if ws is not None:
        maps.append(("u", res.u))
    for name, t in maps:
        require_like(t, f"basic_block_bwd {name}", (b, h, wd, co), x.dtype,
                     dev)
    require_like(res.gh, "basic_block_bwd gh", (3, b, 2, co), torch.float32,
                 dev)
    require_like(res.st, "basic_block_bwd stats", (3, 2, b, co),
                 torch.float32, dev)
    w1t, w2t = flip_io(w1), flip_io(w2)
    wst = None if ws is None else ws[0, 0].T.contiguous()
    dx = torch.empty_like(x)
    dw1 = torch.empty((3, 3, ci, co), dtype=torch.float32, device=dev)
    dw2 = torch.empty((3, 3, co, co), dtype=torch.float32, device=dev)
    dws = (torch.empty((1, 1, ci, co), dtype=torch.float32, device=dev)
           if ws is not None else None)
    # zeros: the identity form leaves the shortcut's row unwritten
    dsb = torch.zeros((5, co), dtype=torch.float32, device=dev)
    scratch = torch.empty(_bwd_scratch()(b, h, wd, ci, co, int(ws is not None),
                                         dt), dtype=torch.uint8, device=dev)
    check(_bwd_kernel()(g.data_ptr(), x.data_ptr(), res.y1.data_ptr(),
                        res.y2.data_ptr(), _ptr(res.u), res.gh.data_ptr(),
                        res.st.data_ptr(), w1t.data_ptr(), w2t.data_ptr(),
                        _ptr(wst), s1.data_ptr(), s2.data_ptr(), _ptr(ss),
                        dx.data_ptr(), dw1.data_ptr(), dw2.data_ptr(),
                        _ptr(dws), dsb.data_ptr(), scratch.data_ptr(),
                        tickets(x).data_ptr(), b, h, wd, ci, co, dt,
                        stream_of(x)), "basic_block_bwd", REFUSED_SHAPE)
    basic_block_bwd.launches += 1
    # (dbias1, dscale1, dbias2, dscale2, dscale_s) -> (s1, b1, s2, b2, ss, bs)
    # by rows: an index list would be copied to the card and the host would
    # wait for the stream
    dsb = torch.stack((dsb[1], dsb[0], dsb[3], dsb[2], dsb[4], dsb[2]))
    return dx, dw1, dw2, dws, dsb


counter(basic_block_bwd)


class _BasicBlock(torch.autograd.Function):
    """K3 forward (keeping its residuals), K6 backward.  The backward takes
    the path the forward took, fixed when the forward ran."""

    @staticmethod
    def forward(ctx, x, w1, s1, b1, w2, s2, b2, ws, ss, bs):
        ctx.kernel = on_card(x)
        out, res = basic_block_fwd(x, w1, s1, b1, w2, s2, b2, ws, ss, bs,
                                   save=True)
        ctx.save_for_backward(x, w1, s1, w2, s2, ws, ss, *res)
        return out

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise RuntimeError(
                "basic_block (K3/K6) is once differentiable: a create_graph "
                "backward through a fused block is not supported (nothing "
                "takes a second derivative through the generator's blocks; "
                "block_pallas=False runs the twice-differentiable chain)")
        x, w1, s1, w2, s2, ws, ss, *res = ctx.saved_tensors
        bwd = basic_block_bwd if ctx.kernel else basic_block_bwd_plain
        dx, dw1, dw2, dws, dsb = bwd(g.contiguous(), x, w1, s1, w2, s2, ws,
                                     ss, Residuals(*res))
        grads = [dx, dw1.to(w1.dtype), dsb[0], dsb[1], dw2.to(w2.dtype),
                 dsb[2], dsb[3]]
        if ws is None:
            return (*grads, None, None, None)
        return (*grads, dws.to(ws.dtype), dsb[4], dsb[5])


def basic_block(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                b1: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
                b2: torch.Tensor, ws: Optional[torch.Tensor] = None,
                ss: Optional[torch.Tensor] = None,
                bs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The differentiable op.  Without autograd (serving, no_grad) it is
    one K3 call that keeps no residuals."""
    ins = (x, w1, s1, b1, w2, s2, b2, ws, ss, bs)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ins):
        return _BasicBlock.apply(*ins)
    return basic_block_fwd(*ins)


# blocks the model layer ran as the unfused chain (not :func:`takes`)
counter(basic_block, "routed")
