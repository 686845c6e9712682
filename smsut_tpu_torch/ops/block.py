# -*- coding: utf-8 -*-
"""K3 and K6: fused residual BasicBlock, NHWC, identity and 1x1-shortcut
forms, forward and backward.

Port of ``smsut_tpu/ops/block_pallas.py`` (public ``fused_block``,
``fused_block_short``, ``fused_block_fwd``, ``apply_fused_block``): K3
replaces ``_fwd_call``, K6 ``_bwd_call``.  ``groups`` 1 runs them on the
unpacked NHWC map; ``groups`` 4 on the TPU kernels' own space-to-depth
packed map ``[B, H/2, W/2, 4C]`` (channel ``s*C + c``, ``models/packed.py``),
where each norm's statistics pool an original channel's 4 subpixel groups
in the order s = 0..3 over ``4*H*W`` pixels (``_group_affine``, and the
group-norm backward of ``_bwd_kernel``), the norm parameters and their
gradients are ``[C]``, and the residuals' (g, h), mean and rstd stand at
every packed channel of their group.  On a CUDA
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

Under a space group (``parallel/``: each rank holds rows of every image)
the block's three norms take their statistics over the whole image, which
a rank does not hold.  K3 and K6 then split at those points, as K1 and K4
do (``ops/instnorm.py``): :func:`split_block_fwd` runs K3's phases
(``csrc/block_split.cu``: :func:`block_fwd_conv`, :func:`block_fwd_finalize`,
:func:`block_fwd_out`) with the space group's sums between them, and
:func:`split_block_bwd` K6's (``csrc/block_bwd_split.cu``:
:func:`block_bwd_out_sums`, :func:`block_bwd_dy2`, :func:`block_bwd_conv`,
:func:`block_bwd_dw`, :func:`block_bwd_norm1_sums`, :func:`block_bwd_dy1`);
each phase has its plain twin beside it (``*_plain``), and the plain
versions of the whole block, :func:`basic_block_plain` and
:func:`basic_block_bwd_plain`, are those twins chained.  Where it can go
wrong (the two C files say how each is met):

1. statistics partials must cover the rank's own rows only: the convs read
   the rows with their halos through a row window (``Hin`` input rows,
   ``Hout`` output rows, an offset), and sum over the output rows alone;
2. the norm applied while staging (PRO) turns a zero row into
   ``lrelu(h1)``: y1's halo is one-sided, only the neighbours' rows that
   exist (``mesh.inner_halo_rows``), so rows beyond the image stay the
   window's zero padding;
3. the cotangents dy2 and dy1 cross ranks: their halos are taken (zero
   beyond the image, as a cotangent is), and dn1 and dx computed on the
   rank's own rows;
4. who sums what: dx takes the group's sums; dscale, dbias and dw1, dw2,
   dws are the rank's own, which the group's gradient reduction adds once;
5. every rank issues the collectives in one order.  Forward: the halo of
   x, the sums of conv1 and of the shortcut in one all-reduce, the halo of
   y1, the sums of conv2.  Backward: the sums of the output's cotangent,
   the halo of dy2, norm 1's sums, the halo of dy1.  A rematerialised
   block runs the forward's again in its backward, on every rank alike.

Without a space group nothing of this runs: :func:`basic_block_fwd` and
:func:`basic_block_bwd` launch the one chain each, with today's plans.
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
    image_pixels,
    lrelu,
    map_sums,
    norm_bwd_dx,
    norm_bwd_terms,
    stats_of,
    tickets,
)
from smsut_tpu_torch.parallel import distributed, mesh


class Residuals(NamedTuple):
    """What the backward needs of the forward besides its inputs: the
    rounded conv outputs y1, y2, u (None in the identity form), ``gh``
    [3, B, 2, C] = per-sample (g, h) of norms 1, 2, s with norm(y)*scale +
    bias == y*g + h, and ``st`` [3, 2, B, C] = their (mean, rstd).  The
    split chain also keeps the inputs its convs read with their halos:
    ``xh``, x with a row of each neighbour (zeros beyond the image), and
    ``y1h``, y1 with the rows of the neighbours that exist; None where the
    unsplit chain ran (the backward takes them again)."""
    y1: torch.Tensor
    y2: torch.Tensor
    u: Optional[torch.Tensor]
    gh: torch.Tensor
    st: torch.Tensor
    xh: Optional[torch.Tensor] = None
    y1h: Optional[torch.Tensor] = None


def _bc(t: torch.Tensor) -> torch.Tensor:
    """[B, C] -> [B, 1, 1, C]"""
    return t[:, None, None]


def lrelu_grad(v: torch.Tensor) -> torch.Tensor:
    """``_lrelu_mask``: 1 where v > 0, else the slope (v == 0 included)."""
    return torch.where(v > 0, 1.0, NEG_SLOPE)


def norm_act(y: torch.Tensor, gh: torch.Tensor) -> torch.Tensor:
    """round(lrelu(y*g + h)) per sample, ``gh`` [B, 2, C]: a stored
    normalised activation, as K3's PRO stages it."""
    return lrelu(y.float() * _bc(gh[:, 0]) + _bc(gh[:, 1])).to(y.dtype)


# ---------------------------------------------------------- plain twins

def block_fwd_conv_plain(k: int, x: torch.Tensor, w: torch.Tensor,
                         pro_gh: Optional[torch.Tensor], hout: int,
                         off: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`block_fwd_conv`: (y in x's dtype, [B, 2, C]
    sums of y and y^2 over its rows from the float32 accumulators)."""
    z = x if pro_gh is None else norm_act(x, pro_gh)
    yf = conv_f32(z, w, hout, off)
    return yf.to(x.dtype), map_sums(yf)


def fold_groups(t: torch.Tensor, groups: int) -> torch.Tensor:
    """[..., G*C] per packed channel -> [..., C]: each original channel's
    G subpixel groups added in the order s = 0 .. G-1."""
    if groups == 1:
        return t
    parts = t.unflatten(-1, (groups, -1)).unbind(-2)
    tot = parts[0]
    for q in parts[1:]:
        tot = tot + q
    return tot


def tile_groups(t: torch.Tensor, groups: int) -> torch.Tensor:
    """[..., C] -> [..., G*C]: a value per original channel at each of its
    packed channels ``s*C + c``."""
    return t if groups == 1 else torch.cat([t] * groups, -1)


def pool_groups(t: torch.Tensor, groups: int) -> torch.Tensor:
    """Per-packed-channel sums -> their group's sum at every member."""
    return tile_groups(fold_groups(t, groups), groups)


def block_fwd_finalize_plain(sums: torch.Tensor, n: int, scale: torch.Tensor,
                             bias: torch.Tensor, keep: bool = True,
                             groups: int = 1
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain twin of :func:`block_fwd_finalize`: (gh [B, 2, C] with
    norm(y)*scale + bias == y*g + h, mean, rstd [B, C]).  With ``groups``
    4 the statistics pool each original channel's subpixel groups over
    ``4n`` pixels (``scale``, ``bias`` [C/4]) and stand at every member."""
    mean, rstd = stats_of(fold_groups(sums, groups), n * groups)
    g = scale * rstd
    return (tile_groups(torch.stack([g, bias - mean * g], 1), groups),
            tile_groups(mean, groups), tile_groups(rstd, groups))


def block_fwd_out_plain(y2: torch.Tensor, gh2: torch.Tensor,
                        idn: torch.Tensor,
                        ghs: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain twin of :func:`block_fwd_out`: lrelu(y2*g2 + h2 + (x |
    u*gs + hs)) in y2's dtype."""
    pre = y2.float() * _bc(gh2[:, 0]) + _bc(gh2[:, 1])
    if ghs is None:
        pre = pre + idn.float()
    else:
        pre = pre + (idn.float() * _bc(ghs[:, 0]) + _bc(ghs[:, 1]))
    return lrelu(pre).to(y2.dtype)


def _out_terms(g, y2, idn, gh, st, short):
    """gp, xh2 and xhs (None in the identity form), float32."""
    G = lambda k, j: _bc(gh[k, :, j])
    M = lambda k, j: _bc(st[k, j])
    y2f = y2.float()
    pre = y2f * G(1, 0) + G(1, 1)
    xhs = None
    if short:
        uf = idn.float()
        pre = pre + (uf * G(2, 0) + G(2, 1))
        xhs = (uf - M(2, 0)) * M(2, 1)
    else:
        pre = pre + idn.float()
    gp = g.float() * lrelu_grad(pre)
    return gp, (y2f - M(1, 0)) * M(1, 1), xhs


def block_bwd_out_sums_plain(g, y2, idn, gh, st, short: bool, scratch=None,
                             groups: int = 1
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`block_bwd_out_sums`: ([B, NS, C] = the sums of
    gp, gp*xh2 (, gp*xhs) over the rank's rows, pooled over the subpixel
    groups with ``groups`` 4, [NS, C] their batch sums per packed
    channel)."""
    gp, xh2, xhs = _out_terms(g, y2, idn, gh, st, short)
    terms = [gp, gp * xh2] + ([gp * xhs] if short else [])
    sums = torch.stack([t.sum(dim=(1, 2)) for t in terms], 1)
    return pool_groups(sums, groups), sums.sum(0)


def block_bwd_dy2_plain(g, y2, idn, gh, st, s2, ss, sums, n: int,
                        groups: int = 1
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`block_bwd_dy2`: (dy2, du) in the activation
    dtype, or (dy2, gp float32) in the identity form, from the sums over
    ``n`` pixels (``n * groups`` on the packed map, the scales [C/4]).
    dy2 from gp rounded as the TPU kernel stores it (gb), du from gp."""
    dt = y2.dtype
    short = ss is not None
    n, s2 = n * groups, tile_groups(s2, groups)
    ss = None if ss is None else tile_groups(ss, groups)
    gp, xh2, xhs = _out_terms(g, y2, idn, gh, st, short)
    dy2 = norm_bwd_dx(gp.to(dt).float(), xh2, sums[:, 0], sums[:, 1], s2,
                      st[1, 1], n).to(dt)
    if not short:
        return dy2, gp
    return dy2, norm_bwd_dx(gp, xhs, sums[:, 0], sums[:, 2], ss, st[2, 1],
                            n).to(dt)


def block_bwd_conv_plain(k: int, x, w, hout: int, off: int, epi=None,
                         epi_gh=None) -> torch.Tensor:
    """Plain twin of :func:`block_bwd_conv`: dn1 = round(conv(x, w) *
    lrelu'(norm_act(epi))) (k 0), the float32 1x1 term x @ w (k 1), dx =
    round(conv(x, w) + epi) (k 2), x read through the row window."""
    y = conv_f32(x, w, hout, off)
    if k == 1:
        return y
    if k == 0:
        return (y * lrelu_grad(norm_act(epi, epi_gh).float())).to(x.dtype)
    return (y + epi).to(x.dtype)


def block_bwd_dw_plain(k: int, x, g, pro_gh, off: int,
                       scratch=None) -> torch.Tensor:
    """Plain twin of :func:`block_bwd_dw`: dw2 (k 0, x = y1 normalised
    and activated with ``pro_gh``), dw1 (k 1), dws (k 2, 1x1), float32."""
    if k == 0:
        x = norm_act(x, pro_gh)
    return dw_f32(x, g, 1 if k == 2 else 3, off)


def block_bwd_norm1_sums_plain(y1, dn1, st, s1, scratch=None,
                               groups: int = 1
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of :func:`block_bwd_norm1_sums`: ([B, 2, C] = (S_dn1,
    S_dn1*xh1) over the rank's rows, pooled over the subpixel groups with
    ``groups`` 4, [2, C] their batch sums per packed channel, the rank's
    (dbias1, dscale1))."""
    s1 = tile_groups(s1, groups)
    _, _, sd, sdx = norm_bwd_terms(y1, dn1, st[0, 0], st[0, 1], s1, None,
                                   False)
    sums = torch.stack([sd, sdx], 1)
    return pool_groups(sums, groups), sums.sum(0)


def block_bwd_dy1_plain(y1, dn1, st, s1, sums, n: int,
                        groups: int = 1) -> torch.Tensor:
    """Plain twin of :func:`block_bwd_dy1`: dy1 in y1's dtype from the sums
    over ``n`` pixels (``n * groups`` on the packed map)."""
    s1 = tile_groups(s1, groups)
    d, xh, _, _ = norm_bwd_terms(y1, dn1, st[0, 0], st[0, 1], s1, None,
                                 False)
    return norm_bwd_dx(d, xh, sums[:, 0], sums[:, 1], s1, st[0, 1],
                       n * groups).to(y1.dtype)


def basic_block_plain(x, w1, s1, b1, w2, s2, b2, ws=None, ss=None, bs=None,
                      save: bool = False, groups: int = 1):
    """Plain version of K3: out, or (out, Residuals) with ``save``; the
    plain twins of the split chain (:func:`split_block_fwd`), which on
    whole images is the block of the JAX package."""
    return split_block_fwd(x, w1, s1, b1, w2, s2, b2, ws, ss, bs, save,
                           kernel=False, groups=groups)


def basic_block_bwd_plain(g, x, w1, s1, w2, s2, ws, ss, res: Residuals,
                          groups: int = 1):
    """Plain version of K6, the arithmetic of ``_bwd_kernel``: (dx in x's
    dtype, dw1, dw2, dws or None, and the float32 gradients of s1, b1, s2,
    b2, ss, bs as a [6, C / groups] tensor); the plain twins of the split
    chain (:func:`split_block_bwd`)."""
    return split_block_bwd(g, x, w1, s1, w2, s2, ws, ss, res, kernel=False,
                           groups=groups)


@functools.lru_cache(maxsize=None)
def _kernel():
    return bind("block", "smsut_block_fwd", [P] * 17 + [I] * 7 + [P])


@functools.lru_cache(maxsize=None)
def _ntiles_fn():
    return bind("block", "smsut_block_ntiles", [I] * 6)


@functools.lru_cache(maxsize=None)
def _bwd_kernel():
    return bind("block_bwd", "smsut_block_bwd", [P] * 20 + [I] * 7 + [P])


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


def _check_block(x, w1, w2, ws, params, what, groups: int = 1
                 ) -> Tuple[int, int]:
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
    if groups not in (1, 4):
        raise ValueError(f"{what}: groups {groups} is not 1 or 4")
    for name, t in params:
        require_like(t, f"{what} {name}", (co // groups,), torch.float32, dev)
    if co % _COUT_MULT:
        raise ValueError(f"{what}: Cout {co} is not a multiple of "
                         f"{_COUT_MULT}")
    return ci, co


def basic_block_fwd(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                    b1: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
                    b2: torch.Tensor, ws: Optional[torch.Tensor] = None,
                    ss: Optional[torch.Tensor] = None,
                    bs: Optional[torch.Tensor] = None, save: bool = False,
                    groups: int = 1):
    """lrelu(IN(conv3(lrelu(IN(conv3(x, w1))), w2)) + idn), idn = x or
    IN(conv1x1(x, ws)).  Conv weights HWIO in x's dtype (``ws``
    [1,1,Cin,Cout]); norm parameters [Cout / groups] float32, ``groups`` 4
    on the packed map (module docstring).  Returns out, or (out,
    Residuals) with ``save``.  On the card Cout must be a multiple of
    16."""
    if not on_card(x):
        return basic_block_plain(x, w1, s1, b1, w2, s2, b2, ws, ss, bs, save,
                                 groups)
    dt = require(x, "basic_block")
    params = [("s1", s1), ("b1", b1), ("s2", s2), ("b2", b2)]
    if ws is not None:
        params += [("ss", ss), ("bs", bs)]
    _, co = _check_block(x, w1, w2, ws, params, "basic_block", groups)
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
                    _ptr(st), b, h, wd, x.shape[-1], co, groups, dt,
                    stream_of(x)),
          "basic_block", REFUSED_SHAPE)
    basic_block_fwd.launches += 1
    basic_block_fwd.grouped += groups != 1
    return (out, Residuals(y1, y2, u, gh, st)) if save else out


counter(basic_block_fwd)
# of those, the launches on the packed map (groups 4)
counter(basic_block_fwd, "grouped")


def basic_block_bwd(g: torch.Tensor, x: torch.Tensor, w1: torch.Tensor,
                    s1: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
                    ws: Optional[torch.Tensor], ss: Optional[torch.Tensor],
                    res: Residuals, groups: int = 1):
    """Backward of :func:`basic_block_fwd` for the cotangent ``g`` of its
    output: (dx in x's dtype, dw1, dw2, dws (None in the identity form)
    float32, and [6, C / groups] float32 gradients of (s1, b1, s2, b2, ss,
    bs))."""
    if not on_card(g):
        return basic_block_bwd_plain(g, x, w1, s1, w2, s2, ws, ss, res,
                                     groups)
    dt = require(x, "basic_block_bwd")
    params = [("s1", s1), ("s2", s2)] + ([("ss", ss)] if ws is not None
                                         else [])
    ci, co = _check_block(x, w1, w2, ws, params, "basic_block_bwd", groups)
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
    # the kernel reads a scale per packed channel
    s1, s2 = tile_groups(s1, groups), tile_groups(s2, groups)
    ss = None if ss is None else tile_groups(ss, groups)
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
                        tickets(x).data_ptr(), b, h, wd, ci, co, groups, dt,
                        stream_of(x)), "basic_block_bwd", REFUSED_SHAPE)
    basic_block_bwd.launches += 1
    basic_block_bwd.grouped += groups != 1
    # (dbias1, dscale1, dbias2, dscale2, dscale_s) -> (s1, b1, s2, b2, ss, bs)
    # by rows: an index list would be copied to the card and the host would
    # wait for the stream
    dsb = torch.stack((dsb[1], dsb[0], dsb[3], dsb[2], dsb[4], dsb[2]))
    return dx, dw1, dw2, dws, fold_groups(dsb, groups)


counter(basic_block_bwd)
counter(basic_block_bwd, "grouped")


# ------------------------------------------------ K3 and K6 split phases

@functools.lru_cache(maxsize=None)
def _split_fns():
    """The split phases' C entry points (csrc/block_split.cu,
    block_bwd_split.cu)."""
    return {
        "part": bind("block_split", "smsut_block_split_part", [I] * 6, L),
        "conv": bind("block_split", "smsut_block_fwd_conv",
                     [I] + [P] * 6 + [I] * 8 + [P]),
        "finalize": bind("block_split", "smsut_block_fwd_finalize",
                         [P] * 6 + [I] * 3 + [P]),
        "out": bind("block_split", "smsut_block_fwd_out",
                    [P] * 5 + [I] * 5 + [P]),
        "scratch": bind("block_bwd_split", "smsut_block_bwd_split_scratch",
                        [I] * 7, L),
        "out_sums": bind("block_bwd_split", "smsut_block_bwd_out_sums",
                         [P] * 9 + [I] * 6 + [P]),
        "dy2": bind("block_bwd_split", "smsut_block_bwd_dy2",
                    [P] * 10 + [I] * 7 + [P]),
        "bconv": bind("block_bwd_split", "smsut_block_bwd_conv",
                      [I] + [P] * 5 + [I] * 8 + [P]),
        "dw": bind("block_bwd_split", "smsut_block_bwd_dw",
                   [I] + [P] * 5 + [I] * 8 + [P]),
        "n1_sums": bind("block_bwd_split", "smsut_block_bwd_norm1_sums",
                        [P] * 8 + [I] * 5 + [P]),
        "dy1": bind("block_bwd_split", "smsut_block_bwd_dy1",
                    [P] * 6 + [I] * 6 + [P])}


def _f32(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=like.device)


def block_fwd_conv(k: int, x: torch.Tensor, w: torch.Tensor,
                   pro_gh: Optional[torch.Tensor], hout: int,
                   off: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's conv ``k`` (0 conv1, 1 conv2 with ``pro_gh`` [B, 2, C], norm
    1's (g, h), applied while staging, 2 the 1x1 shortcut) of ``hout``
    output rows, ``x`` read through the row window (output row i takes
    tap u from x's row i + u - 1 + ``off``; the shortcut SAME): (y in x's
    dtype, [B, 2, Cout] float32 sums of y and y^2 over its rows)."""
    if not on_card(x):
        return block_fwd_conv_plain(k, x, w, pro_gh, hout, off)
    dt = require(x, "block_fwd_conv")
    b, hin, wd, c = x.shape
    co = w.shape[-1]
    require_like(w, "block_fwd_conv w", (w.shape[0], w.shape[0], c, co),
                 x.dtype, x.device)
    if pro_gh is not None:
        require_like(pro_gh, "block_fwd_conv gh", (b, 2, c), torch.float32,
                     x.device)
    y = torch.empty((b, hout, wd, co), dtype=x.dtype, device=x.device)
    sums = _f32((b, 2, co), x)
    n = _split_fns()["part"](b, hout, wd, c, co, dt)
    if n < 1:
        raise ValueError(f"block_fwd_conv: {REFUSED_SHAPE}")
    part = _f32(n, x)
    check(_split_fns()["conv"](k, x.data_ptr(), w.data_ptr(), _ptr(pro_gh),
                               y.data_ptr(), part.data_ptr(),
                               sums.data_ptr(), b, hin, hout, off, wd, c, co,
                               dt, stream_of(x)),
          "block_fwd_conv", REFUSED_SHAPE)
    block_fwd_conv.launches += 1
    return y, sums


counter(block_fwd_conv)


def block_fwd_finalize(sums: torch.Tensor, n: int, scale: torch.Tensor,
                       bias: torch.Tensor, keep: bool = True
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """K3's finalize step from ``sums`` [B, 2, C] (the group's) over ``n``
    pixels (the image's): (gh [B, 2, C], and with ``keep`` the mean and
    rstd [B, C], else None)."""
    if not on_card(sums):
        return block_fwd_finalize_plain(sums, n, scale, bias)
    b, _, c = sums.shape
    gh = _f32((b, 2, c), sums)
    mean, rstd = (_f32((b, c), sums), _f32((b, c), sums)) if keep else (
        None, None)
    check(_split_fns()["finalize"](sums.data_ptr(), scale.data_ptr(),
                                   bias.data_ptr(), _ptr(mean), _ptr(rstd),
                                   gh.data_ptr(), b, c, n,
                                   stream_of(sums)), "block_fwd_finalize")
    block_fwd_finalize.launches += 1
    return gh, mean, rstd


counter(block_fwd_finalize)


def block_fwd_out(y2: torch.Tensor, gh2: torch.Tensor, idn: torch.Tensor,
                  ghs: Optional[torch.Tensor]) -> torch.Tensor:
    """K3's out pass: lrelu(y2*g2 + h2 + (x | u*gs + hs)), ``ghs`` None in
    the identity form."""
    if not on_card(y2):
        return block_fwd_out_plain(y2, gh2, idn, ghs)
    dt = require(y2, "block_fwd_out")
    b, h, wd, c = y2.shape
    require_like(idn, "block_fwd_out identity", y2.shape, y2.dtype,
                 y2.device)
    out = torch.empty_like(y2)
    check(_split_fns()["out"](y2.data_ptr(), gh2.data_ptr(), idn.data_ptr(),
                              _ptr(ghs), out.data_ptr(), b, h, wd, c, dt,
                              stream_of(y2)), "block_fwd_out", REFUSED_SHAPE)
    block_fwd_out.launches += 1
    return out


counter(block_fwd_out)


@functools.lru_cache(maxsize=None)
def _bwd_split_floats(b, h, wd, ci, co, short, dt) -> int:
    return _split_fns()["scratch"](b, h, wd, ci, co, short, dt)


def bwd_split_scratch(x: torch.Tensor, co: int, short: bool
                      ) -> Optional[torch.Tensor]:
    """The scratch K6's split phases take on a rank's rows ``x``
    [B, H, W, Cin] (None off the card)."""
    if not on_card(x):
        return None
    b, h, wd, ci = x.shape
    return _f32(_bwd_split_floats(b, h, wd, ci, co, int(short),
                                  DTYPES[x.dtype]), x)


def block_bwd_out_sums(g, y2, idn, gh, st, short: bool,
                       scratch: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's sums pass over the block's output on the rank's rows: ([B, NS,
    C] = the sums of gp, gp*xh2 (, gp*xhs), [NS, C] their batch sums, the
    rank's (dbias2, dscale2 (, dscale_s))), float32."""
    if not on_card(g):
        return block_bwd_out_sums_plain(g, y2, idn, gh, st, short)
    dt = require(g, "block_bwd_out_sums")
    b, h, wd, c = g.shape
    ns = 3 if short else 2
    sums, dsb = _f32((b, ns, c), g), _f32((ns, c), g)
    check(_split_fns()["out_sums"](g.data_ptr(), y2.data_ptr(),
                                   idn.data_ptr(), gh.data_ptr(),
                                   st.data_ptr(), sums.data_ptr(),
                                   dsb.data_ptr(), scratch.data_ptr(),
                                   tickets(g).data_ptr(), b, h, wd, c,
                                   int(short), dt, stream_of(g)),
          "block_bwd_out_sums")
    block_bwd_out_sums.launches += 1
    return sums, dsb


counter(block_bwd_out_sums)


def block_bwd_dy2(g, y2, idn, gh, st, s2, ss, sums, n: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's dy2 pass from ``sums`` (the group's) over ``n`` pixels: (dy2,
    du) in the activation dtype, or (dy2, gp float32) in the identity form
    (``ss`` None)."""
    if not on_card(g):
        return block_bwd_dy2_plain(g, y2, idn, gh, st, s2, ss, sums, n)
    dt = require(g, "block_bwd_dy2")
    b, h, wd, c = g.shape
    short = ss is not None
    dy2 = torch.empty_like(g)
    dq = torch.empty_like(g) if short else torch.empty_like(g,
                                                           dtype=torch.float32)
    check(_split_fns()["dy2"](g.data_ptr(), y2.data_ptr(), idn.data_ptr(),
                              gh.data_ptr(), st.data_ptr(), s2.data_ptr(),
                              _ptr(ss), sums.data_ptr(), dy2.data_ptr(),
                              dq.data_ptr(), b, h, wd, c, n, int(short), dt,
                              stream_of(g)), "block_bwd_dy2")
    block_bwd_dy2.launches += 1
    return dy2, dq


counter(block_bwd_dy2)


def block_bwd_conv(k: int, x, w, hout: int, off: int, epi=None,
                   epi_gh=None) -> torch.Tensor:
    """K6's conv ``k`` on the rank's ``hout`` rows, ``x`` through the row
    window, ``w`` the flipped, IO-transposed kernel: dn1 masked by
    lrelu'(z1) (k 0; ``epi`` y1, ``epi_gh`` norm 1's (g, h)), the float32
    1x1 term du @ ws^T (k 1), dx plus the float32 map ``epi`` (k 2)."""
    if not on_card(x):
        return block_bwd_conv_plain(k, x, w, hout, off, epi, epi_gh)
    dt = require(x, "block_bwd_conv")
    b, hin, wd, c = x.shape
    co = w.shape[-1]
    y = torch.empty((b, hout, wd, co), device=x.device,
                    dtype=torch.float32 if k == 1 else x.dtype)
    check(_split_fns()["bconv"](k, x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                _ptr(epi), _ptr(epi_gh), b, hin, hout, off,
                                wd, c, co, dt, stream_of(x)),
          "block_bwd_conv", REFUSED_SHAPE)
    block_bwd_conv.launches += 1
    return y


counter(block_bwd_conv)


def block_bwd_dw(k: int, x, g, pro_gh, off: int,
                 scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6's weight gradient ``k`` over the rank's rows of ``g``, ``x``
    through the row window: dw2 (k 0, x = y1 with the neighbours' rows,
    normalised and activated with ``pro_gh`` while staging), dw1 (k 1),
    dws (k 2, 1x1); float32, the rank's partial."""
    if not on_card(g):
        return block_bwd_dw_plain(k, x, g, pro_gh, off)
    dt = require(g, "block_bwd_dw")
    b, hout, wd, co = g.shape
    hin, c = x.shape[1], x.shape[-1]
    ks = 1 if k == 2 else 3
    dw = _f32((ks, ks, c, co), g)
    check(_split_fns()["dw"](k, x.data_ptr(), g.data_ptr(), _ptr(pro_gh),
                             scratch.data_ptr(), dw.data_ptr(), b, hin, hout,
                             off, wd, c, co, dt, stream_of(g)),
          "block_bwd_dw", REFUSED_SHAPE)
    block_bwd_dw.launches += 1
    return dw


counter(block_bwd_dw)


def block_bwd_norm1_sums(y1, dn1, st, s1,
                         scratch: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's sums pass of norm 1 over the rank's rows: ([B, 2, C] = (S_dn1,
    S_dn1*xh1), [2, C] their batch sums, the rank's (dbias1, dscale1))."""
    if not on_card(y1):
        return block_bwd_norm1_sums_plain(y1, dn1, st, s1)
    dt = require(y1, "block_bwd_norm1_sums")
    b, h, wd, c = y1.shape
    sums, dsb = _f32((b, 2, c), y1), _f32((2, c), y1)
    check(_split_fns()["n1_sums"](y1.data_ptr(), dn1.data_ptr(),
                                  st.data_ptr(), s1.data_ptr(),
                                  sums.data_ptr(), dsb.data_ptr(),
                                  scratch.data_ptr(), tickets(y1).data_ptr(),
                                  b, h, wd, c, dt, stream_of(y1)),
          "block_bwd_norm1_sums")
    block_bwd_norm1_sums.launches += 1
    return sums, dsb


counter(block_bwd_norm1_sums)


def block_bwd_dy1(y1, dn1, st, s1, sums, n: int) -> torch.Tensor:
    """K6's dy1 pass from ``sums`` (the group's) over ``n`` pixels."""
    if not on_card(y1):
        return block_bwd_dy1_plain(y1, dn1, st, s1, sums, n)
    dt = require(y1, "block_bwd_dy1")
    b, h, wd, c = y1.shape
    dy1 = torch.empty_like(y1)
    check(_split_fns()["dy1"](y1.data_ptr(), dn1.data_ptr(), st.data_ptr(),
                              s1.data_ptr(), sums.data_ptr(), dy1.data_ptr(),
                              b, h, wd, c, n, dt, stream_of(y1)),
          "block_bwd_dy1")
    block_bwd_dy1.launches += 1
    return dy1


counter(block_bwd_dy1)

# the split phases' wrappers, forward then backward (their launch counters)
SPLIT_FWD = (block_fwd_conv, block_fwd_finalize, block_fwd_out)
SPLIT_BWD = (block_bwd_out_sums, block_bwd_dy2, block_bwd_conv, block_bwd_dw,
             block_bwd_norm1_sums, block_bwd_dy1)
_TWINS = {block_fwd_conv: block_fwd_conv_plain,
          block_fwd_finalize: block_fwd_finalize_plain,
          block_fwd_out: block_fwd_out_plain,
          block_bwd_out_sums: block_bwd_out_sums_plain,
          block_bwd_dy2: block_bwd_dy2_plain,
          block_bwd_conv: block_bwd_conv_plain,
          block_bwd_dw: block_bwd_dw_plain,
          block_bwd_norm1_sums: block_bwd_norm1_sums_plain,
          block_bwd_dy1: block_bwd_dy1_plain}


def _phases(kernel: bool, fns):
    """The phase wrappers, or their plain twins without ``kernel``."""
    return fns if kernel else tuple(_TWINS[f] for f in fns)


def _split_groups(kernel: bool, groups: int, what: str) -> None:
    """The split phases on the card take the unpacked map alone."""
    if kernel and groups != 1:
        raise ValueError(f"{what}: the split phases of K3/K6 take groups 1; "
                         f"the packed map on the space axis is ROADMAP "
                         f"A13c")


def split_block_fwd(x, w1, s1, b1, w2, s2, b2, ws=None, ss=None, bs=None,
                    save: bool = False, kernel: Optional[bool] = None,
                    groups: int = 1):
    """K3 split at its statistics (the phases, or their plain twins
    without ``kernel``) on a space rank's rows ``x`` of every image, the
    norms' sums added over the space group between the phases: out, or
    (out, Residuals) with ``save``.  Without a space group it is the
    block on whole images (the halos zero, the sums the image's).
    ``groups`` 4 (the packed map) is the plain twins' alone."""
    if kernel is None:
        kernel = on_card(x)
    _split_groups(kernel, groups, "split_block_fwd")
    conv, finalize, out = _phases(kernel, SPLIT_FWD)
    fin = ((lambda *a: finalize(*a, groups=groups)) if groups != 1
           else finalize)
    h = x.shape[1]
    n = image_pixels(x)
    short = ws is not None
    xh = mesh.halo_rows(x, 1)
    y1, sums = conv(0, xh, w1, None, h, 1)
    u = None
    if short:
        u, sums_s = conv(2, x, ws, None, h, 0)
        sums = torch.stack([sums, sums_s])
    mesh.space_all_reduce_(sums)
    if short:
        sums, sums_s = sums[0], sums[1]
    gh1, m1, r1 = fin(sums, n, s1, b1, save)
    y1h, off = mesh.inner_halo_rows(y1, 1)
    y2, sums2 = conv(1, y1h, w2, gh1, h, off)
    mesh.space_all_reduce_(sums2)
    gh2, m2, r2 = fin(sums2, n, s2, b2, save)
    ghs, ms, rs = (fin(sums_s, n, ss, bs, save) if short
                   else (None, None, None))
    o = out(y2, gh2, u if short else x, ghs)
    if not save:
        return o
    # the identity form's shortcut rows stay zero, as the unsplit chain's
    gh = torch.stack([gh1, gh2, gh1.new_zeros(gh1.shape) if ghs is None
                      else ghs])
    st = torch.stack([torch.stack(t) for t in (
        (m1, r1), (m2, r2), (m1.new_zeros(m1.shape),) * 2 if ms is None
        else (ms, rs))])
    return o, Residuals(y1, y2, u, gh, st, xh, y1h)


def split_block_bwd(g, x, w1, s1, w2, s2, ws, ss, res: Residuals,
                    kernel: Optional[bool] = None, groups: int = 1):
    """K6 split at its norm sums (the phases, or their plain twins without
    ``kernel``) on a space rank's rows: (dx, dw1, dw2, dws or None, the
    [6, C / groups] gradients of (s1, b1, s2, b2, ss, bs)), dx from the
    group's sums and the cotangents' halos, the rest the rank's own.
    Without a space group, K6 on whole images.  ``groups`` 4 (the packed
    map) is the plain twins' alone."""
    if kernel is None:
        kernel = on_card(g)
    _split_groups(kernel, groups, "split_block_bwd")
    out_sums, dy2_pass, bconv, bdw, n1_sums, dy1_pass = _phases(kernel,
                                                                SPLIT_BWD)
    gk = {"groups": groups} if groups != 1 else {}
    h = x.shape[1]
    n = image_pixels(x)
    short = ws is not None
    y1, y2, u, gh, st, xh, y1h = res
    idn = u if short else x
    scratch = bwd_split_scratch(x, w1.shape[-1], short) if kernel else None
    sums_o, dsb_o = out_sums(g, y2, idn, gh, st, short, scratch, **gk)
    mesh.space_all_reduce_(sums_o)
    dy2, dq = dy2_pass(g, y2, idn, gh, st, s2, ss, sums_o, n, **gk)
    dn1 = bconv(0, mesh.halo_rows(dy2, 1), flip_io(w2), h, 1, y1, gh[0])
    if y1h is None:
        y1h = mesh.inner_halo_rows(y1, 1)[0]
    off = mesh.inner_halo_offset(1)
    dw2 = bdw(0, y1h, dy2, gh[0], off, scratch)
    sums1, dsb1 = n1_sums(y1, dn1, st, s1, scratch, **gk)
    mesh.space_all_reduce_(sums1)
    dy1 = dy1_pass(y1, dn1, st, s1, sums1, n, **gk)
    dw1 = bdw(1, mesh.halo_rows(x, 1) if xh is None else xh, dy1, None, 1,
              scratch)
    dws = None
    side = dq
    if short:
        dws = bdw(2, x, dq, None, 0, scratch)
        side = bconv(1, dq, flip_io(ws), h, 0)
    dx = bconv(2, mesh.halo_rows(dy1, 1), flip_io(w1), h, 1, side)
    dss = dsb_o[2] if short else torch.zeros_like(dsb_o[0])
    dsb = torch.stack((dsb1[1], dsb1[0], dsb_o[1], dsb_o[0], dss, dsb_o[0]))
    return dx, dw1, dw2, dws, fold_groups(dsb, groups)


class _BasicBlock(torch.autograd.Function):
    """K3 forward (keeping its residuals), K6 backward; both split at
    their statistics under a space group.  The backward takes the path the
    forward took (kernel or plain, split or not), fixed when the forward
    ran."""

    @staticmethod
    def forward(ctx, x, w1, s1, b1, w2, s2, b2, ws, ss, bs, groups):
        ctx.kernel = on_card(x)
        ctx.split = distributed.space_count() > 1
        ctx.groups = groups
        args = (x, w1, s1, b1, w2, s2, b2, ws, ss, bs)
        if ctx.split:
            out, res = split_block_fwd(*args, save=True, kernel=ctx.kernel,
                                       groups=groups)
        else:
            # whole images: the halos are zero rows, which the backward
            # pads again rather than keeps
            out, res = basic_block_fwd(*args, save=True, groups=groups)
            res = res[:5]
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
        args = (g.contiguous(), x, w1, s1, w2, s2, ws, ss, Residuals(*res))
        if ctx.split:
            dx, dw1, dw2, dws, dsb = split_block_bwd(
                *args, kernel=ctx.kernel, groups=ctx.groups)
        else:
            bwd = basic_block_bwd if ctx.kernel else basic_block_bwd_plain
            dx, dw1, dw2, dws, dsb = bwd(*args, groups=ctx.groups)
        grads = [dx, dw1.to(w1.dtype), dsb[0], dsb[1], dw2.to(w2.dtype),
                 dsb[2], dsb[3]]
        if ws is None:
            return (*grads, None, None, None, None)
        return (*grads, dws.to(ws.dtype), dsb[4], dsb[5], None)


def basic_block(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                b1: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
                b2: torch.Tensor, ws: Optional[torch.Tensor] = None,
                ss: Optional[torch.Tensor] = None,
                bs: Optional[torch.Tensor] = None,
                groups: int = 1) -> torch.Tensor:
    """The differentiable op, ``groups`` 4 on the packed map.  Without
    autograd (serving, no_grad) it is one K3 call that keeps no residuals
    (its split phases under a space group)."""
    ins = (x, w1, s1, b1, w2, s2, b2, ws, ss, bs)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ins):
        return _BasicBlock.apply(*ins, groups)
    if distributed.space_count() > 1:
        return split_block_fwd(*ins, groups=groups)
    return basic_block_fwd(*ins, groups=groups)


# blocks the model layer ran as the unfused chain (not :func:`takes`), and
# fused blocks that ran K3/K6 on weights gathered from their model group's
# shards (``models/blocks.py``)
counter(basic_block, "routed")
counter(basic_block, "tp_gathered")
