# -*- coding: utf-8 -*-
"""The W-only packed levels of the port (smsut_tpu_torch/models/packed_w.py
and the W routes of models/blocks.py, unet.py, ugan.py), the hw conv's
v2/v2k3 lowerings (models/packed.py) and the paired conv's block weight
gradient (models/paired.py) against the JAX package's
(smsut_tpu/models/packed_w.py, packed.py, paired.py and their users), the
same numpy-seeded inputs and transplanted weights (the W models are in
tests/test_torch_packed_w_models.py, the steps in
tests/test_torch_packed_w_steps.py):

- ``pack_kernel_w`` (k 1, 3, 5 at packs 2, 4, 8, with segments),
  ``pack_kernel_w_stride2`` and ``pack_kernel_v2_k3``, bit for bit;
- ``conv_w`` with bias, the stride-2 stem (with its grad-of-grad), the
  norm-act, ``pool_w`` at every (p, out_pack) with the gradient on planted
  ties (bit for bit), ``avg_pool_w``, ``upsample_bilinear2_w``, the up
  concats (``up_transposed_w`` from p = 1 too), the schedules;
- the hw conv under v1, v2 and v2k3 against ``packed_conv_apply`` under
  each ``CONV_IMPL`` (set on the JAX module and restored), and the paired
  conv's block dw against ``paired_conv(dw="block")``.

The JAX package's W mode is module state (``packed_w.set_pack_mode``); each
test sets it for its JAX calls and restores it (:func:`jax_pack`).

Bounds: tests/test_torch_packed.py's: rtol/atol 1e-4 for the layers
(gradients of kernels scaled by their largest entry within 1e-5, as
tests/test_torch_paired.py's)."""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.models import packed as jpk
from smsut_tpu.models import packed_w as jpw
from smsut_tpu.models import paired as jpr
from smsut_tpu_torch.models import packed as pk
from smsut_tpu_torch.models import packed_w as pw
from smsut_tpu_torch.models import paired as pr
from smsut_tpu_torch.models.blocks import UpSampleAndConcat
from smsut_tpu_torch.models.layers import NormAct, upsample_bilinear2
from smsut_tpu_torch.models.transplant import from_flax
from smsut_tpu_torch.models.ugan import _StemConv
from torch_port_helpers import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

TOL = dict(rtol=1e-4, atol=1e-4)


def _x(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False, dtype=torch.float32):
    t = torch.from_numpy(np.array(a)).to(dtype)
    return t.requires_grad_() if grad else t


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(kw or TOL))


def _scaled(got, want, atol, what=""):
    w = np.asarray(want, np.float64)
    scale = np.abs(w).max() + 1e-12
    np.testing.assert_allclose(got.detach().double().numpy() / scale,
                               w / scale, rtol=0, atol=atol, err_msg=what)


@contextlib.contextmanager
def jax_pack(mode, w0=8, deep=True, d_mode=""):
    """The JAX package's packing mode for the block's JAX calls (traced
    inside it), the previous one restored after."""
    saved = (jpw._PACK_MODE, jpw._PACK_W0, jpw._D_PACK_DEEP, jpw._D_PACK_MODE)
    jpw.set_pack_mode(mode, w0, deep, d_mode)
    try:
        yield
    finally:
        jpw.set_pack_mode(*saved)


# ------------------------------------------------------------------ kernels
@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_pack_kernel_w_is_the_jax_kernel(k, p):
    segs = (3, 5) if k != 5 else (4,)
    w = _x(np.random.default_rng(10 * k + p), (k, k, sum(segs), 6))
    got = pw.pack_kernel_w(_t(w), p, segs)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpw.pack_kernel_w(w, p, segs)))


def test_stride2_and_v2k3_kernels_are_the_jax_kernels():
    rng = np.random.default_rng(1)
    w4 = _x(rng, (4, 4, 3, 6))
    for p in (2, 4, 8):
        got, off = pw.pack_kernel_w_stride2(_t(w4), p)
        want, woff = jpw.pack_kernel_w_stride2(w4, p)
        assert off == woff
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    w3 = _x(rng, (3, 3, 10, 6))
    for segs in ((10,), (4, 6)):
        np.testing.assert_array_equal(
            pk.pack_kernel_v2_k3(_t(w3), segs).numpy(),
            np.asarray(jpk.pack_kernel_v2_k3(w3, segs)))


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("k,p,segs,bias", [(1, 8, (3, 5), True),
                                           (3, 4, (6,), True),
                                           (3, 8, (3, 5), False),
                                           (5, 8, (1,), False),
                                           (5, 2, (5,), True)])
def test_conv_w_matches_jax(k, p, segs, bias):
    """``conv_w`` (the 1x1 product, K2's plain version on the packed 3x3,
    ``conv_plain`` on the [5, kp] stem kernel) and its gradients against
    ``PackedConvW``."""
    rng = np.random.default_rng(3)
    x = _x(rng, (2, 6, 4, p * sum(segs)))
    jmod = jpw.PackedConvW(8, k, segs, p, use_bias=bias)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), x)["params"])
    if bias:
        params["bias"] = _x(rng, (8,))
    g = _x(rng, (2, 6, 4, p * 8))
    jx = jax.jit(jax.grad(lambda q, a: jnp.sum(
        jmod.apply({"params": q}, a) * g), argnums=(0, 1)))(params, x)
    xt, w = _t(x, True), _t(params["kernel"], True)
    b = _t(params["bias"], True) if bias else None
    y = pw.conv_w(xt, w, p, segs, b)
    _close(y, jmod.apply({"params": params}, x))
    (y * _t(g)).sum().backward()
    _close(xt.grad, jx[1])
    _scaled(w.grad, jx[0]["kernel"], 1e-5, "kernel")
    if bias:
        _scaled(b.grad, jx[0]["bias"], 1e-5, "bias")


@pytest.mark.parametrize("p", [2, 8])
def test_stem_conv_w_and_its_second_order_match_jax(p):
    """The W stem (plain ``F.conv2d``, stride (2, 1)) against
    ``PackedStride2ConvW`` and the unpacked 4x4 stride-2 stem at the same
    weights, and the gradient of a GP-like term (the squared input
    gradient) in the kernel and bias, a grad-of-grad."""
    rng = np.random.default_rng(8)
    x = _x(rng, (2, 8, 16, 3))
    xp = np.asarray(jpw.pack_w(x, p))
    jmod = jpw.PackedStride2ConvW(8, p, use_bias=True)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(2), xp)["params"])
    params["bias"] = _x(rng, (8,))
    g = _x(rng, (2, 4, 16 // p, (p // 2) * 8))

    def jgp(q):
        dx = jax.grad(lambda a: jnp.sum(jnp.tanh(
            jmod.apply({"params": q}, a)) * g))(xp)
        return jnp.sum(jnp.square(dx))

    jg = jax.jit(jax.grad(jgp))(params)
    stem = _StemConv(3, 8, None)
    stem.load_state_dict(from_flax(params))
    y = pw.stem_conv_w(pw.pack_w(_t(x), p), stem.weight, p, stem.bias)
    _close(y, jmod.apply({"params": params}, xp))
    _close(pw.unpack_w(y, p // 2), stem(_t(x)).detach())
    xt = _t(xp, True)
    dx, = torch.autograd.grad(
        (torch.tanh(pw.stem_conv_w(xt, stem.weight, p, stem.bias))
         * _t(g)).sum(), xt,
        create_graph=True)
    dx.square().sum().backward()
    _scaled(stem.weight.grad, jg["kernel"], 1e-5, "kernel")
    _scaled(stem.bias.grad, jg["bias"], 1e-5, "bias")


@pytest.mark.parametrize("act", [None, "lrelu"])
def test_norm_act_w_matches_jax(act):
    """K1's plain version on the free view [B, H, J*p, C] against
    ``PackedNormActW`` (statistics per original channel over H, J and the
    subpixels)."""
    rng = np.random.default_rng(4)
    x = _x(rng, (2, 6, 4, 8 * 5), 2.0) + 0.5
    jmod = jpw.PackedNormActW("instance", act, 5, 8)
    params = {"scale": _x(rng, (5,)) + 1, "bias": _x(rng, (5,))}
    mod = NormAct(5, act)
    mod.load_state_dict({"weight": _t(params["scale"]),
                         "bias": _t(params["bias"])})
    _close(pk.norm_act(mod, _t(x), 8), jmod.apply({"params": params}, x))


@pytest.mark.parametrize("p,out_pack", [(4, 2), (4, 4), (8, 4), (8, 8)])
def test_pool_w_and_the_tie_gradient_match_jax(p, out_pack):
    """``pool_w`` bit for bit, values and gradient, on an input with
    planted ties (row pairs equal, column pairs equal, whole 2x2 windows
    equal): ``torch.amax`` splits a tie's gradient evenly, as ``jnp.max``
    does."""
    rng = np.random.default_rng(5)
    c = 3
    u = np.round(_x(rng, (2, 8, 16, c)), 1)
    u[:, 1::2][:, :2] = u[:, 0::2][:, :2]          # H ties
    u[:, :, 1::2][:, 4:6] = u[:, :, 0::2][:, 4:6]  # W ties
    u[:, 6:8, 8:10] = u[:, 6:7, 8:9]               # four-way ties
    x = np.asarray(jpw.pack_w(u, p))
    y = pw.pool_w(_t(x, True), p, c, out_pack)
    want = jpw.pool_w(x, p, c, out_pack)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
    g = _x(rng, y.shape)
    xt = _t(x, True)
    (pw.pool_w(xt, p, c, out_pack) * _t(g)).sum().backward()
    jg = jax.grad(lambda a: jnp.sum(jpw.pool_w(a, p, c, out_pack) * g))(x)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("p,out_pack", [(4, 2), (8, 8)])
def test_avg_pool_w_matches_jax(p, out_pack):
    rng = np.random.default_rng(6)
    x = _x(rng, (2, 8, 2, p * 3))
    xt = _t(x, True)
    y = pw.avg_pool_w(xt, p, 3, out_pack)
    _close(y, jpw.avg_pool_w(x, p, 3, out_pack), rtol=1e-6, atol=1e-6)
    g = _x(rng, y.shape)
    (y * _t(g)).sum().backward()
    jg = jax.grad(lambda a: jnp.sum(jpw.avg_pool_w(a, p, 3, out_pack)
                                    * g))(x)
    _close(xt.grad, jg, rtol=1e-6, atol=1e-6)


def test_upsample_bilinear2_w_matches_jax_and_the_unpacked_upsample():
    x = _x(np.random.default_rng(7), (2, 5, 3, 4 * 3))
    for out_pack in (4, 8):
        y = pw.upsample_bilinear2_w(_t(x), 4, out_pack)
        _close(y, jpw.upsample_bilinear2_w(x, 4, out_pack), rtol=1e-6,
               atol=1e-6)
        _close(pw.unpack_w(y, out_pack),
               upsample_bilinear2(pw.unpack_w(_t(x), 4)), rtol=1e-6,
               atol=1e-6)


@pytest.mark.parametrize("transposed,p,out_pack", [(True, 1, 4),
                                                   (True, 4, 8),
                                                   (True, 8, 8),
                                                   (False, 1, 4),
                                                   (False, 4, 8)])
def test_up_concat_w_matches_jax(transposed, p, out_pack):
    """``PackedUpConcatW`` (the transposed conv as one product and a
    repack, from an unpacked input at p = 1) and
    ``PackedUpBilinearConcatW`` (1x1 first, then the W upsample), with the
    packed skip, forward and gradients, from the flax tree through the
    transplant."""
    rng = np.random.default_rng(9)
    j = 8 // p
    x = _x(rng, (2, 3, j, p * 6))
    jo = 2 * j * p // out_pack
    skip = _x(rng, (2, 6, jo, out_pack * 4))
    cls = jpw.PackedUpConcatW if transposed else jpw.PackedUpBilinearConcatW
    jmod = cls(4, p, out_pack)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(1), x, skip)
                            ["params"])
    mod = UpSampleAndConcat(6, 4, transposed=transposed)
    mod.load_state_dict(from_flax(params))
    g = _x(rng, (2, 6, jo, out_pack * 8))
    want = jax.grad(lambda a, s: jnp.sum(
        jmod.apply({"params": params}, a, s) * g), argnums=(0, 1))(x, skip)
    xt, st = _t(x, True), _t(skip, True)
    y = pw.up_concat_w(mod, xt, st, p, out_pack)
    _close(y, jmod.apply({"params": params}, x, skip))
    (y * _t(g)).sum().backward()
    _close(xt.grad, want[0])
    _close(st.grad, want[1])


def test_schedules_match_jax():
    for p0 in (2, 4, 8, 16):
        for width in (4, 8, 16, 32):
            for n in (1, 2):
                assert pw.w_pack_schedule(p0, width, n) == \
                    jpw.w_pack_schedule(p0, width, n)
            for c in (1, 8, 16, 64, 256):
                assert pw.level_pack(p0, c) == jpw.level_pack(p0, c)
    # at w16 from 8 the level-1 pool halves the pack; at w8 it regroups
    assert pw.w_pack_schedule(8, 16, 2) == [8, 4]
    assert pw.w_pack_schedule(8, 8, 2) == [8, 8]


def test_views_are_free():
    """pack, unpack and repack of a contiguous map are views."""
    x = torch.randn(2, 4, 16, 3)
    for y in (pw.pack_w(x, 8), pw.unpack_w(pw.pack_w(x, 8), 8),
              pw.repack_w(pw.pack_w(x, 8), 8, 4)):
        assert y.data_ptr() == x.data_ptr()
    np.testing.assert_array_equal(pw.repack_w(pw.pack_w(x, 8), 8, 4).numpy(),
                                  pw.pack_w(x, 4).numpy())


# ---------------------------------------------- hw lowerings and block dw
@pytest.mark.parametrize("impl", ["v1", "v2", "v2k3"])
@pytest.mark.parametrize("k,segs", [(3, (6,)), (3, (4, 6)), (1, (6,)),
                                    (1, (4, 6))])
def test_hw_conv_lowerings_match_jax(impl, k, segs):
    """``packed.packed_conv(impl=...)`` against the JAX
    ``packed_conv_apply`` under the same ``CONV_IMPL`` (set on the JAX
    module for the call, then restored), forward and gradients, and
    against the port's v1."""
    rng = np.random.default_rng(14)
    x = _x(rng, (2, 6, 5, 4 * sum(segs)))
    w = _x(rng, (k, k, sum(segs), 8), 0.3)
    g = _x(rng, (2, 6, 5, 32))
    old, jpk.CONV_IMPL = jpk.CONV_IMPL, impl
    try:
        jy = jpk.packed_conv_apply(x, w, segs, jnp.float32)
        jx = jax.grad(lambda a, b: jnp.sum(
            jpk.packed_conv_apply(a, b, segs, jnp.float32) * g),
            argnums=(0, 1))(x, w)
    finally:
        jpk.CONV_IMPL = old
    xt, wt = _t(x, True), _t(w, True)
    y = pk.packed_conv(xt, wt, segs, impl=impl)
    _close(y, jy)
    _close(y, pk.packed_conv(_t(x), _t(w), segs, impl="v1"))
    (y * _t(g)).sum().backward()
    _close(xt.grad, jx[0])
    _scaled(wt.grad, jx[1], 1e-5, "kernel")


@pytest.mark.parametrize("k,segs", [(3, (4,)), (1, (4,)), (3, (4, 8))])
def test_paired_block_dw_matches_jax(k, segs):
    """``paired_conv(dw="block")`` (dx from the dense block-diagonal conv,
    dw per diagonal block) against the JAX ``paired_conv(dw="block")``,
    and against the port's dense dw: forward and the gradients of x and
    both kernels."""
    rng = np.random.default_rng(15)
    cin = sum(segs)
    wa, wb = _x(rng, (k, k, cin, 8)), _x(rng, (k, k, cin, 8))
    x = _x(rng, (2, 8, 8, 8 * cin))
    g = _x(rng, (2, 8, 8, 64))
    want = jax.grad(lambda a, b, c: jnp.sum(jpr.paired_conv(
        a, b, c, segs, segs, jnp.float32, dw="block") * g),
        argnums=(0, 1, 2))(x, wa, wb)
    grads = {}
    for dw in ("block", "dense"):
        args = [_t(v, True) for v in (x, wa, wb)]
        y = pr.paired_conv(*args, segs, segs, dw=dw)
        _close(y, jpr.paired_conv(x, wa, wb, segs, segs, jnp.float32))
        (y * _t(g)).sum().backward()
        grads[dw] = [a.grad for a in args]
    for got, dense, w, name in zip(grads["block"], grads["dense"], want,
                                   ("x", "wa", "wb")):
        _scaled(got, w, 1e-5, name)
        _scaled(got, dense.numpy(), 1e-5, name)
