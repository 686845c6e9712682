# -*- coding: utf-8 -*-
"""The tower-paired level 0 of the port (smsut_tpu_torch/models/paired.py,
the paired routes of models/ugan.py ``_UGANCore`` and models/unet.py
``UNetPair``) against the JAX package's (smsut_tpu/models/paired.py and
its users), from the same numpy-seeded inputs and transplanted weights:
``blockdiag2``, ``paired_conv`` with the dense weight gradient (forward
and gradients), ``paired_block``, and the UGAN generator and two U-Nets
paired; the whole models in float64 (x64 on, the JAX norms' statistics
``native``), as the JAX package's own ``test_exact_equivalence_f64``
runs them, and the port's paired route against its unpaired one.

Bounds: float32 layers rtol/atol 1e-4 (tests/test_packed.py); float64
models within 1e-6 of each output's and gradient's largest entry (the
JAX outputs are cast to float32 at the model's end); the port paired
against unpaired in float64 within 1e-10 (exact accumulation ignores the
structural zeros)."""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.models import layers as jlayers
from smsut_tpu.models import paired as jpr
from smsut_tpu.models import ugan as jugan
from smsut_tpu.models.unet import UNetPair as JUNetPair
from smsut_tpu_torch.models import paired as pr
from smsut_tpu_torch.models.blocks import BasicBlock
from smsut_tpu_torch.models.transplant import from_flax
from smsut_tpu_torch.models.ugan import UGANnce
from smsut_tpu_torch.models.unet import UNet, UNetPair
from torch_port_helpers import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

TOL = dict(rtol=1e-4, atol=1e-4)


def _x(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a, grad=False, dtype=torch.float32):
    t = torch.from_numpy(np.array(a)).to(dtype)
    return t.requires_grad_() if grad else t


@contextlib.contextmanager
def jax_f64():
    jlayers.set_norm_stats("native")
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jlayers.set_norm_stats("reduce")


def test_blockdiag2_matches_jax_and_its_gradient_is_a_slice():
    rng = np.random.default_rng(0)
    wa, wb = _x(rng, (3, 3, 4, 6)), _x(rng, (3, 3, 5, 7))
    got = pr.blockdiag2(_t(wa), _t(wb))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpr.blockdiag2(wa, wb)))
    ta, tb = _t(wa, True), _t(wb, True)
    g = _x(rng, got.shape)
    (pr.blockdiag2(ta, tb) * _t(g)).sum().backward()
    np.testing.assert_array_equal(ta.grad.numpy(), g[:, :, :4, :6])
    np.testing.assert_array_equal(tb.grad.numpy(), g[:, :, 4:, 6:])


@pytest.mark.parametrize("k,segs", [(3, (4,)), (1, (4,)), (3, (4, 8)),
                                    (5, (1,))])
def test_paired_conv_matches_jax(k, segs):
    """``paired_conv`` (the dense weight gradient, the JAX default) against
    the JAX one, forward and the gradients of x and both kernels."""
    rng = np.random.default_rng(1)
    cin = sum(segs)
    wa, wb = _x(rng, (k, k, cin, 8)), _x(rng, (k, k, cin, 8))
    x = _x(rng, (2, 8, 8, 8 * cin))
    g = _x(rng, (2, 8, 8, 64))

    def jloss(x, a, b):
        return jnp.sum(jpr.paired_conv(x, a, b, segs, segs, jnp.float32,
                                       dw="dense") * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(x, wa, wb)
    args = [_t(v, True) for v in (x, wa, wb)]
    y = pr.paired_conv(*args, segs, segs)
    np.testing.assert_allclose(
        y.detach().numpy(),
        np.asarray(jpr.paired_conv(x, wa, wb, segs, segs, jnp.float32)),
        **TOL)
    (y * _t(g)).sum().backward()
    for a, w, name in zip(args, want, ("x", "wa", "wb")):
        scale = np.abs(np.asarray(w)).max()
        np.testing.assert_allclose(a.grad.numpy() / scale,
                                   np.asarray(w) / scale, rtol=0, atol=1e-5,
                                   err_msg=name)


def _block_dict(blk):
    """A port BasicBlock's parameters as the JAX ``_BlockParams`` dict."""
    n = lambda m: (m.weight.detach().numpy(), m.bias.detach().numpy())
    p = {"conv1": blk.conv1.weight.detach().numpy(), "bn1": n(blk.bn1),
         "conv2": blk.conv2.weight.detach().numpy(), "bn2": n(blk.bn2)}
    if blk.has_shortcut:
        p["shortcut1"] = blk.shortcut1.weight.detach().numpy()
        p["shortcut2"] = n(blk.shortcut2)
    return p


@pytest.mark.parametrize("segs,f", [((8,), 16), ((16, 16), 16),
                                    ((16,), 16)])
def test_paired_block_matches_jax(segs, f):
    """``paired_block`` (the unfused chain with every conv paired, the
    norms per tower) against the JAX ``paired_block`` on the same two
    blocks' parameters (norm parameters drawn away from 1 and 0)."""
    rng = np.random.default_rng(2)
    cin = sum(segs)
    blocks = [BasicBlock(cin, f, generator=torch.Generator().manual_seed(s))
              for s in (0, 1)]
    with torch.no_grad():
        for b in blocks:
            for name, p in b.named_parameters():
                if p.dim() == 1:
                    p.copy_(torch.from_numpy(_x(rng, p.shape, 0.2))
                            + (1.0 if name.endswith("weight") else 0.0))
    x = _x(rng, (2, 6, 6, 8 * cin))
    want = jpr.paired_block(x, _block_dict(blocks[0]), _block_dict(blocks[1]),
                            segs, f, "lrelu", jnp.float32)
    with torch.no_grad():
        got = pr.paired_block(_t(x), blocks[0], blocks[1], segs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _scaled_close(got, want, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=atol,
                               err_msg=what)


def _f64_grads(net):
    return {k: p.grad.detach().clone() for k, p in net.named_parameters()}


def test_ugan_paired_towers_match_jax_f64():
    """``UGANnce(pack_levels=2, pair_towers=True)``: seg, translation and
    feature pool and every generator gradient against the JAX paired
    ``UGANnce`` in float64, and against the port's unpaired towers."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 32, 1))
    m = np.eye(4)[[0, 1]]
    ids = np.arange(4, dtype=np.int32)
    tgt = rng.standard_normal((2, 32, 32, 5))
    jnet32 = jugan.UGANnce(5, 4, 8, netF_nc=32, pack_levels=2,
                           pair_towers=False)
    params = jax.device_get(jnet32.init(
        jax.random.PRNGKey(1), x.astype(np.float32), m.astype(np.float32),
        ids)["params"])
    with jax_f64():
        jnet = jugan.UGANnce(5, 4, 8, netF_nc=32, dtype=jnp.float64,
                             pack_levels=2, pair_towers=True)
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     params)

        def jloss(p):
            seg, tsl, f = jnet.apply({"params": p}, x, m, ids)
            return jnp.sum(seg * tgt) + jnp.sum(tsl) + jnp.sum(f), (seg, tsl,
                                                                     f)

        (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            p64)
        jout, jgrads = jax.device_get((jout, jgrads))
    ids_t = torch.from_numpy(ids).long()
    grads = []
    for pair in (True, False):
        net = UGANnce(5, 4, 8, 32, compute_dtype=torch.float64, device="cpu",
                      pack_levels=2, pair_towers=pair).double()
        net.load_state_dict(from_flax(params))
        out = net(_t(x, dtype=torch.float64), _t(m, dtype=torch.float64),
                  ids_t)
        ((out[0] * _t(tgt, dtype=torch.float64)).sum() + out[1].sum()
         + out[2].sum()).backward()
        grads.append(_f64_grads(net))
        if pair:
            for a, w, name in zip(out, jout, ("seg", "tsl", "pool")):
                _scaled_close(a.detach(), w, 1e-6, name)
            want = from_flax(jgrads)
            for k, g in grads[0].items():
                _scaled_close(g, want[k].numpy(), 1e-6, k)
    for k in grads[0]:
        _scaled_close(grads[0][k], grads[1][k].numpy(), 1e-10, k)


def test_unet_pair_matches_jax_f64():
    """``UNetPair`` (both U-Nets' level 0 paired; the packed logits of
    ``packed_out`` too) against the JAX ``UNetPair`` in float64 and against
    the two U-Nets applied one by one; every gradient of both nets."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, 32, 1))
    tgt = rng.standard_normal((2, 32, 32, 5))
    jpair32 = JUNetPair(5, 8, pack_levels=2)
    params = jax.device_get(jpair32.init(jax.random.PRNGKey(2),
                                         x.astype(np.float32))["params"])
    with jax_f64():
        jpair = JUNetPair(5, 8, dtype=jnp.float64, pack_levels=2)
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     params)

        def jloss(p):
            a, b = jpair.apply({"params": p}, x)
            return jnp.sum(a * tgt) + jnp.sum(jnp.tanh(b)), (a, b)

        (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            p64)
        jpacked = jpair.apply({"params": p64}, x, packed_out=True)
        jout, jgrads, jpacked = jax.device_get((jout, jgrads, jpacked))
    nets = [UNet(5, 8, compute_dtype=torch.float64, device="cpu",
                 pack_levels=2).double() for _ in range(2)]
    for n, name in zip(nets, ("n1", "n2")):
        n.load_state_dict(from_flax(params[name]))
    pair = UNetPair(*nets)
    xt = _t(x, dtype=torch.float64)
    a, b = pair(xt)
    # the model casts its logits to float32, as the JAX model does
    for got, want in zip((a, b), jout):
        _scaled_close(got.detach(), want, 1e-6, "logits")
    for got, want in zip(pair(xt, packed_out=True), jpacked):
        _scaled_close(got.detach(), want, 1e-6, "packed logits")
    ((a * _t(tgt)).sum() + torch.tanh(b).sum()).backward()
    for n, name in zip(nets, ("n1", "n2")):
        want = from_flax(jgrads[name])
        for k, p in n.named_parameters():
            _scaled_close(p.grad, want[k].numpy(), 1e-6, f"{name} {k}")
        n.zero_grad()
    # the two nets one by one: the same function
    for n, got in zip(nets, (a, b)):
        _scaled_close(n(xt).detach(), got.detach(), 1e-7, "one by one")
