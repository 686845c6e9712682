# -*- coding: utf-8 -*-
"""The W-only packed models of the port (the W routes of models/blocks.py,
unet.py and ugan.py on models/packed_w.py) against the JAX package's in
its W mode, the same numpy-seeded inputs and transplanted weights:

- the U-Net at 1 and 2 levels, ``pack_w0`` 4 and 8, widths 8 and 16,
  forward and gradients, against the JAX U-Net and the port's unpacked
  one;
- ``UGANnce`` in W (never paired), its gradients in float64 as
  tests/test_torch_packed.py holds the hw towers;
- the discriminator W-packed with ``d_pack_deep`` on and off, and hw under
  a W generator's override, with the GP's grad-of-grad;
- the same state dict in every layout (the tests above load JAX W-packed
  trees strictly).

The layers are in tests/test_torch_packed_w.py, the steps in
tests/test_torch_packed_w_steps.py.  The JAX package's W mode is module
state (``packed_w.set_pack_mode``); each test sets it for its JAX calls
and restores it (``jax_pack``).

Bounds: tests/test_torch_packed.py's: rtol 1e-3 / atol 1e-4 for whole
models (the translation's atol 5e-4), their gradients scaled by each one's
largest entry within 1e-3 in float32; in float64 within 1e-4, because the
JAX W blocks compute in float32 in a float64 model (see
:func:`test_ugan_towers_w_match_jax`); the GP's gradients within 2e-3 of
each one's largest entry (at least 1), tests/test_torch_gan.py's bound."""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.models import layers as jlayers
from smsut_tpu.models import packed_w as jpw
from smsut_tpu.models import ugan as jugan
from smsut_tpu.models.unet import UNet as JUNet
from smsut_tpu_torch.models.transplant import from_flax
from smsut_tpu_torch.models.ugan import Discriminator, UGANnce
from smsut_tpu_torch.models.unet import UNet
from torch_port_helpers import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

MODEL = dict(rtol=1e-3, atol=1e-4)


def _x(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False, dtype=torch.float32):
    t = torch.from_numpy(np.array(a)).to(dtype)
    return t.requires_grad_() if grad else t


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **kw)


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


@contextlib.contextmanager
def jax_f64():
    """x64 on and the JAX norms' statistics in the activations' dtype
    (``norm_stats='native'``), as the JAX package's own float64
    equivalence tests run; restored after."""
    jlayers.set_norm_stats("native")
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jlayers.set_norm_stats("reduce")


def _grads_close(mod, jgrads, what, atol=1e-3):
    want = from_flax(jgrads)
    for k, p in mod.named_parameters():
        _scaled(p.grad, want[k].numpy(), atol, f"{what} {k}")


@pytest.mark.parametrize("pack,w0,width,fused", [(1, 4, 8, True),
                                                 (2, 8, 16, False)])
def test_unet_w_matches_jax_and_unpacked(pack, w0, width, fused):
    """``UNet(pack_mode="w")`` against the JAX ``UNet`` in W mode at the
    same weights (logits, the logits under ``packed_out``, which the W
    decoder leaves unpacked, and every parameter's gradient), and against
    the port's unpacked U-Net; with ``block_fused`` the W levels run the
    unfused chain and the unpacked ones K3/K6's plain versions.  w16 from
    8 takes ``pool_w``'s halving branch between its two W levels (the
    regrouping one, w8 from 8: tests/test_torch_packed_w_steps.py)."""
    rng = np.random.default_rng(10 + pack)
    x = _x(rng, (2, 32, 32, 1))
    tgt = _x(rng, (2, 32, 32, 5))
    with jax_pack("w", w0):
        jnet = JUNet(5, width, "instance", "lrelu", pack_levels=pack)
        params = jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(3),
                                                   x)["params"])
        jgrads = jax.jit(jax.grad(lambda p: jnp.sum(
            jnet.apply({"params": p}, x) * tgt)))(params)
        jy = jax.jit(lambda p: jnet.apply({"params": p}, x))(params)
    flat = UNet(5, width, compute_dtype=torch.float32, device="cpu")
    flat.load_state_dict(from_flax(params))
    net = UNet(5, width, compute_dtype=torch.float32, device="cpu",
               block_fused=fused, pack_levels=pack, pack_mode="w",
               pack_w0=w0)
    net.load_state_dict(from_flax(params))
    y = net(_t(x))
    _close(y, jy, **MODEL)
    _close(y, flat(_t(x)).detach(), **MODEL)
    np.testing.assert_array_equal(net(_t(x), packed_out=True).detach(),
                                  y.detach())
    (y * _t(tgt)).sum().backward()
    _grads_close(net, jgrads, f"w0={w0} width={width}")


def test_ugan_towers_w_match_jax():
    """``UGANnce(pack_mode="w")`` (never paired, even with
    ``pair_towers``): seg, translation and feature pool in float32 against
    the JAX W towers, and every gradient in float64 (the translation
    stem's float32 gradient is ill-conditioned, tests/test_torch_packed.py
    on the hw towers).  The JAX ``PackedBasicBlockW`` passes no dtype to
    its convs and norms (smsut_tpu/models/packed_w.py:347-356), so the JAX
    W blocks compute in float32 in a float64 model: the float64 gradients
    are held within 1e-4 of each one's largest entry, ten times tighter
    than the float32 models' bound, not 1e-6."""
    rng = np.random.default_rng(12)
    x = _x(rng, (2, 32, 32, 1))
    m = np.eye(4, dtype=np.float32)[[0, 2]]
    ids = np.arange(4, dtype=np.int32)
    tgt = _x(rng, (2, 32, 32, 5))
    with jax_pack("w", 8, True, "hw"):
        jnet = jugan.UGANnce(5, 4, 8, netF_nc=32, pack_levels=2,
                             pair_towers=True)
        params = jax.device_get(jax.jit(jnet.init)(
            jax.random.PRNGKey(4), x, m, ids)["params"])
        jout = jax.jit(lambda p: jnet.apply({"params": p}, x, m, ids))(
            params)
        with jax_f64():
            j64 = jugan.UGANnce(5, 4, 8, netF_nc=32, dtype=jnp.float64,
                                pack_levels=2, pair_towers=True)
            p64 = jax.tree_util.tree_map(
                lambda a: np.asarray(a, np.float64), params)

            def jloss(p):
                seg, tsl, f = j64.apply({"params": p}, x.astype(np.float64),
                                        m.astype(np.float64), ids)
                return jnp.sum(seg * tgt) + jnp.sum(tsl) + jnp.sum(f)

            jgrads = jax.device_get(jax.jit(jax.grad(jloss))(p64))
    net = UGANnce(5, 4, 8, 32, compute_dtype=torch.float32, device="cpu",
                  pack_levels=2, pair_towers=True, pack_mode="w")
    assert not net.core.pair
    net.load_state_dict(from_flax(params))
    idt = torch.from_numpy(ids).long()
    seg, tsl, f = net(_t(x), _t(m), idt)
    _close(seg, jout[0], **MODEL)
    _close(tsl, jout[1], rtol=1e-3, atol=5e-4)
    _close(f, jout[2], **MODEL)
    net.double().compute_dtype = torch.float64
    seg, tsl, f = net(_t(x, dtype=torch.float64), _t(m, dtype=torch.float64),
                      idt)
    ((seg * _t(tgt, dtype=torch.float64)).sum() + tsl.sum()
     + f.sum()).backward()
    _grads_close(net, jgrads, "UGANnce", atol=1e-4)


def _j_gp_loss(jd, p, x, x_hat, c):
    src, cls = jd.apply({"params": p}, x)
    dydx = jax.grad(lambda a: jnp.sum(jd.apply({"params": p}, a)[0]))(x_hat)
    norms = jnp.sqrt(jnp.sum(jnp.square(dydx.reshape(x.shape[0], -1)), 1))
    return (jnp.sum(src) + jnp.sum(cls * c)
            + 10.0 * jnp.mean(jnp.square(norms - 1.0)))


@pytest.mark.parametrize("g_mode,d_mode,deep", [("hw", "w", True),
                                                ("hw", "w", False),
                                                ("w", "hw", True)])
def test_discriminator_and_gp_second_order_match_jax(g_mode, d_mode, deep):
    """The discriminator under the JAX override ``d_pack_mode`` against a
    generator of the other mode (the JAX ``Config()``'s hw G with a W D,
    deep and not, and a W G with an hw D): its outputs, and a D loss with
    the gradient penalty, whose gradient in every D parameter is a
    grad-of-grad through the W stem, ``avg_pool_w``, the packed 3x3s and
    the norms on W views."""
    rng = np.random.default_rng(13)
    x = _x(rng, (2, 32, 32, 1))
    x_hat = _x(rng, (2, 32, 32, 1))
    c = _x(rng, (2, 4))
    with jax_pack(g_mode, 8, deep, d_mode):
        jd = jugan.Discriminator(32, 4, 8, 64, pack_levels=2)
        dp = jax.device_get(jax.jit(jd.init)(jax.random.PRNGKey(5), x)
                            ["params"])
        want = jax.jit(lambda p: jd.apply({"params": p}, x))(dp)
        jg = jax.jit(jax.grad(lambda p: _j_gp_loss(jd, p, x, x_hat, c)))(dp)
    d = Discriminator(32, 4, 8, 64, compute_dtype=torch.float32,
                      device="cpu", pack_levels=2, pack_mode=d_mode,
                      pack_deep=deep)
    d.load_state_dict(from_flax(dp))
    src, cls = d(_t(x))
    _close(src, want[0], **MODEL)
    _close(cls, want[1], **MODEL)
    xh = _t(x_hat, True)
    dydx, = torch.autograd.grad(d(xh)[0].sum(), xh, create_graph=True)
    norms = dydx.reshape(2, -1).square().sum(1).sqrt()
    loss = (src.sum() + (cls * _t(c)).sum()
            + 10.0 * (norms - 1.0).square().mean())
    loss.backward()
    want = from_flax(jax.device_get(jg))
    for k, p in d.named_parameters():
        w = want[k].numpy()
        scale = max(1.0, float(np.abs(w).max()))
        assert np.abs(p.grad.numpy() - w).max() <= 2e-3 * scale, k


def test_state_dicts_are_the_same_in_every_layout():
    """The W routes keep the unpacked parameter tree: the same keys and
    shapes under hw and W, ``pack_w0`` 4 and 8, the discriminator deep and
    not (the model tests above load JAX trees built W-packed strictly)."""
    shapes = lambda m: {k: tuple(v.shape) for k, v in m.state_dict().items()}
    u = [shapes(UNet(5, 8, device="cpu", pack_levels=p, pack_mode=mode,
                     pack_w0=w0))
         for p, mode, w0 in ((0, "hw", 8), (2, "hw", 8), (1, "w", 4),
                             (2, "w", 8))]
    assert all(s == u[0] for s in u)
    g = [shapes(UGANnce(5, 4, 8, 32, device="cpu", pack_levels=p,
                        pair_towers=True, pack_mode=mode))
         for p, mode in ((0, "hw"), (2, "hw"), (2, "w"))]
    assert all(s == g[0] for s in g)
    d = [shapes(Discriminator(32, 4, 8, 64, device="cpu", pack_levels=p,
                              pack_mode=mode, pack_deep=deep))
         for p, mode, deep in ((0, "hw", True), (2, "hw", True),
                               (2, "w", True), (2, "w", False))]
    assert all(s == d[0] for s in d)
