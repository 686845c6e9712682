# -*- coding: utf-8 -*-
"""The space-to-depth packed levels of the port
(smsut_tpu_torch/models/packed.py, the packed routes of models/blocks.py,
unet.py, ugan.py, the packed losses of ops/losses.py) against the JAX
package's (smsut_tpu/models/packed.py and its users), float32, the same
numpy-seeded inputs and transplanted weights:

- ``pack_kernel`` (with segments) and ``pack_kernel_stride2``, bit for
  bit;
- the packed conv, norm-act, pools (a tie case for the gradient), up
  concats, bilinear upsample and stride-2 stem against the JAX modules;
- the packed losses against ``smsut_tpu/ops/losses.py``'s;
- ``UNet``, ``UGANnce`` and ``Discriminator`` packed, forward and
  gradients, against the JAX modules at the same weights and against the
  port's own ``pack_levels=0``;
- state dicts the same at every ``pack_levels``, and a JAX packed tree
  loading with no missing key.

The steps at ``pack_levels=2`` are in tests/test_torch_packed_steps.py.

Bounds: rtol/atol 1e-4 for the layers (tests/test_packed.py), the models'
of tests/test_torch_ugan.py (rtol 1e-3, atol 1e-4; the translation's atol
5e-4), a whole model's gradients scaled by each one's largest entry
within 1e-3 (summation order through some twenty norms; the trees after a
step are held to 5e-3 in tests/test_torch_train.py)."""
import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.models import layers as jlayers
from smsut_tpu.models import packed as jpk
from smsut_tpu.models import ugan as jugan
from smsut_tpu.models.unet import UNet as JUNet
from smsut_tpu.ops import losses as jlosses
from smsut_tpu_torch.models import packed as pk
from smsut_tpu_torch.models.blocks import UpSampleAndConcat
from smsut_tpu_torch.models.layers import NormAct
from smsut_tpu_torch.models.transplant import from_flax, to_flax
from smsut_tpu_torch.models.ugan import Discriminator, UGANnce, _StemConv
from smsut_tpu_torch.models.unet import UNet
from smsut_tpu_torch.ops import losses
from torch_port_helpers import few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.requires_grad_() if grad else t


def _x(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(kw or TOL))


@pytest.mark.parametrize("k,segs", [(1, (6,)), (3, (6,)), (5, (6,)),
                                    (3, (4, 6)), (1, (4, 6))])
def test_pack_kernel_is_the_jax_kernel(k, segs):
    w = _x(np.random.default_rng(k), (k, k, sum(segs), 10))
    got = pk.pack_kernel(_t(w), segs)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpk.pack_kernel(w, segs)))


def test_pack_kernel_stride2_is_the_jax_kernel():
    w = _x(np.random.default_rng(0), (4, 4, 3, 8))
    np.testing.assert_array_equal(pk.pack_kernel_stride2(_t(w)).numpy(),
                                  np.asarray(jpk.pack_kernel_stride2(w)))


@pytest.mark.parametrize("k,segs,bias", [(1, (6,), False), (3, (8,), False),
                                         (5, (1,), False), (3, (4, 6), True),
                                         (1, (8,), True)])
def test_packed_conv_matches_jax(k, segs, bias):
    """The packed conv (K2's plain version, ``conv_plain`` or the 1x1
    product) and its gradients against ``PackedConv``."""
    rng = np.random.default_rng(3)
    x = _x(rng, (2, 8, 8, 4 * sum(segs)))
    jmod = jpk.PackedConv(8, k, segs, use_bias=bias)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), x)["params"])
    if bias:
        params["bias"] = _x(rng, (8,))
    g = _x(rng, (2, 8, 8, 32))

    def jloss(p, x):
        return jnp.sum(jmod.apply({"params": p}, x) * g)

    jx = jax.grad(jloss, argnums=(0, 1))(params, x)
    xt, w = _t(x, True), _t(params["kernel"], True)
    b = _t(params["bias"], True) if bias else None
    y = pk.packed_conv(xt, w, segs, b)
    _close(y, jmod.apply({"params": params}, x))
    (y * _t(g)).sum().backward()
    _close(w.grad, jx[0]["kernel"], rtol=1e-4, atol=1e-3)
    _close(xt.grad, jx[1])
    if bias:
        _close(b.grad, jx[0]["bias"], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("act", [None, "lrelu"])
def test_packed_norm_act_matches_jax(act):
    """K1's plain version on the free view [B, H, 4W, C] against
    ``PackedNormAct`` (statistics per original channel over H, W and the
    4 subpixels)."""
    rng = np.random.default_rng(4)
    x = _x(rng, (2, 6, 5, 4 * 8), 2.0) + 0.5
    jmod = jpk.PackedNormAct("instance", act, 8)
    params = {"scale": _x(rng, (8,)) + 1, "bias": _x(rng, (8,))}
    mod = NormAct(8, act)
    mod.load_state_dict({"weight": _t(params["scale"]),
                         "bias": _t(params["bias"])})
    _close(pk.norm_act(mod, _t(x)), jmod.apply({"params": params}, x))


def test_packed_pools_and_the_tie_gradient_match_jax():
    """The subpixel max (to the unpacked and to the next packed level): a
    ``torch.maximum`` chain whose gradient splits ties in half at each
    link, as ``jnp.maximum``'s does; the input holds ties (whole pixels of
    equal subpixels, and two of four equal)."""
    rng = np.random.default_rng(5)
    c = 3
    x = np.round(_x(rng, (2, 8, 8, 4 * c)), 1)
    x[:, :2, :, c:2 * c] = x[:, :2, :, :c]            # two-way ties
    x[:, 6:, 6:, :] = np.tile(x[:, 6:, 6:, :c], 4)    # four-way ties
    g = _x(rng, (2, 8, 8, c))
    g2 = _x(rng, (2, 4, 4, 4 * c))
    for fn, jfn, gg in ((pk.packed_max_pool_to_unpacked,
                         jpk.packed_max_pool_to_unpacked, g),
                        (pk.packed_max_pool_to_packed,
                         jpk.packed_max_pool_to_packed, g2)):
        xt = _t(x, True)
        y = fn(xt, c)
        np.testing.assert_array_equal(y.detach().numpy(),
                                      np.asarray(jfn(x, c)))
        (y * _t(gg)).sum().backward()
        want = jax.grad(lambda a: jnp.sum(jfn(a, c) * gg))(x)
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    # pooling then packing, or both at once: the same values
    np.testing.assert_array_equal(
        pk.pool_to_next_level(_t(x), c, False, True).numpy(),
        pk.pool_to_next_level(_t(x), c, False, False).numpy())


@pytest.mark.parametrize("transposed", [True, False])
def test_packed_up_concat_matches_jax(transposed):
    """``PackedUpConcat`` (the 2x2 transposed conv as one product) and
    ``PackedUpBilinearConcat`` (1x1 first, then the packed bilinear
    upsample), with the packed skip, forward and gradients, from the
    flax tree of ``UpSampleAndConcat`` through the transplant."""
    rng = np.random.default_rng(6)
    x = _x(rng, (2, 5, 6, 16))
    skip = _x(rng, (2, 5, 6, 4 * 8))
    cls = jpk.PackedUpConcat if transposed else jpk.PackedUpBilinearConcat
    jmod = cls(8)
    params = jax.device_get(jmod.init(jax.random.PRNGKey(1), x, skip)
                            ["params"])
    mod = UpSampleAndConcat(16, 8, transposed=transposed)
    mod.load_state_dict(from_flax(params))
    g = _x(rng, (2, 5, 6, 4 * 16))
    want = jax.grad(lambda a, s: jnp.sum(
        jmod.apply({"params": params}, a, s) * g), argnums=(0, 1))(x, skip)
    xt, st = _t(x, True), _t(skip, True)
    y = pk.packed_up_concat(mod, xt, st)
    _close(y, jmod.apply({"params": params}, x, skip))
    (y * _t(g)).sum().backward()
    _close(xt.grad, want[0])
    _close(st.grad, want[1])


def test_packed_upsample_bilinear2_matches_jax():
    x = _x(np.random.default_rng(7), (2, 5, 7, 3))
    y = pk.packed_upsample_bilinear2(_t(x))
    np.testing.assert_allclose(y.numpy(),
                               np.asarray(jpk.packed_upsample_bilinear2(x)),
                               rtol=1e-6, atol=1e-6)
    # the packed form of the unpacked half-pixel upsample
    from smsut_tpu_torch.models.layers import upsample_bilinear2

    np.testing.assert_allclose(
        pk.depth_to_space(y, 3).numpy(),
        upsample_bilinear2(_t(x)).numpy(), rtol=1e-6, atol=1e-6)


def test_packed_stride2_stem_matches_jax():
    """The discriminator's packed stem against ``PackedStride2Conv`` and
    against the unpacked 4x4 stride-2 conv at the same weights."""
    rng = np.random.default_rng(8)
    x = _x(rng, (2, 16, 16, 1))
    jmod = jpk.PackedStride2Conv(8, use_bias=True)
    xp = np.asarray(jpk.space_to_depth(x))
    params = jax.device_get(jmod.init(jax.random.PRNGKey(2), xp)["params"])
    params["bias"] = _x(rng, (8,))
    stem = _StemConv(1, 8, None)
    stem.load_state_dict(from_flax(params))
    y = pk.packed_stride2_conv(stem, pk.space_to_depth(_t(x)))
    _close(y, jmod.apply({"params": params}, xp))
    _close(y, stem(_t(x)).detach())


def test_packed_losses_match_jax():
    """``pack_labels``, ``argmax_packed`` and the packed Dice+CE (packed and
    unpacked labels) and consistency against ``smsut_tpu/ops/losses.py``,
    with a subpixel group far above its neighbours (each group's softmax
    takes its own max)."""
    rng = np.random.default_rng(9)
    logits = _x(rng, (2, 4, 5, 4 * 5), 3.0)
    logits[..., 5:10] += 120.0
    teacher = _x(rng, (2, 4, 5, 4 * 5), 3.0)
    labels = rng.integers(0, 5, size=(2, 8, 10))
    np.testing.assert_array_equal(
        losses.pack_labels(torch.from_numpy(labels)).numpy(),
        np.asarray(jlosses.pack_labels(labels)))
    am = losses.argmax_packed(_t(logits))
    np.testing.assert_array_equal(am.numpy(),
                                  np.asarray(jlosses.argmax_packed(logits)))
    lab4 = np.asarray(jlosses.argmax_packed(teacher))
    for fn, jfn, lab in (
            (losses.dice_and_ce_loss_packed, jlosses.dice_and_ce_loss_packed,
             labels),
            (losses.dice_and_ce_loss_packed4,
             jlosses.dice_and_ce_loss_packed4, lab4)):
        lt = _t(logits, True)
        got = fn(lt, torch.from_numpy(np.asarray(lab)), 0.5, 0.5)
        got.backward()
        want, wg = jax.value_and_grad(lambda a: jfn(a, lab, 0.5, 0.5))(
            logits)
        np.testing.assert_allclose(float(got), float(want), **TOL)
        _close(lt.grad, wg, rtol=1e-4, atol=1e-6)
    got = losses.softmax_mse_consistency_packed(_t(logits), _t(teacher))
    want = jlosses.softmax_mse_consistency_packed(logits, teacher)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def _grads_close(mod, jgrads, what, atol=1e-3):
    want = from_flax(jgrads)
    for k, p in mod.named_parameters():
        w = want[k].numpy()
        scale = np.abs(w).max() + 1e-9
        np.testing.assert_allclose(p.grad.double().numpy() / scale,
                                   w / scale, rtol=0, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("pack", [1, 2])
def test_unet_packed_matches_jax_and_unpacked(pack):
    """``UNet(pack_levels)`` against the JAX ``UNet(pack_levels)`` at the
    same weights (logits, the packed logits of ``packed_out`` and every
    parameter's gradient), and against the port's unpacked U-Net; the
    fused blocks' plain K3/K6 with groups 4 too."""
    rng = np.random.default_rng(10 + pack)
    x = _x(rng, (2, 32, 32, 1))
    tgt = _x(rng, (2, 32, 32, 5))
    jnet = JUNet(5, 8, "instance", "lrelu", pack_levels=pack)
    params = jax.device_get(jnet.init(jax.random.PRNGKey(3), x)["params"])

    def jloss(p):
        return jnp.sum(jnet.apply({"params": p}, x) * tgt)

    jgrads = jax.jit(jax.grad(jloss))(params)
    jpacked = jax.jit(lambda p: jnet.apply({"params": p}, x,
                                           packed_out=True))(params)
    jfwd = jax.jit(lambda p: jnet.apply({"params": p}, x))
    flat = UNet(5, 8, compute_dtype=torch.float32, device="cpu")
    flat.load_state_dict(from_flax(params))
    ref = flat(_t(x))
    for fused in (False, True):
        net = UNet(5, 8, compute_dtype=torch.float32, device="cpu",
                   block_fused=fused, pack_levels=pack)
        net.load_state_dict(from_flax(params))
        y = net(_t(x))
        _close(y, jfwd(params))
        _close(y, ref.detach())
        _close(net(_t(x), packed_out=True), jpacked)
        (y * _t(tgt)).sum().backward()
        _grads_close(net, jgrads, f"fused={fused}")


def test_state_dicts_are_the_same_at_every_pack_level():
    """The packed and paired routes keep the unpacked parameter tree: the
    same keys and shapes at pack_levels 0, 1, 2 and with pairing, and a
    JAX tree built packed loads with no missing key."""
    shapes = lambda m: {k: tuple(v.shape) for k, v in m.state_dict().items()}
    u = [shapes(UNet(5, 8, device="cpu", pack_levels=p)) for p in (0, 1, 2)]
    assert u[0] == u[1] == u[2]
    g = [shapes(UGANnce(5, 4, 8, 32, device="cpu", pack_levels=p,
                        pair_towers=pair))
         for p, pair in ((0, False), (1, False), (2, True))]
    assert g[0] == g[1] == g[2]
    d = [shapes(Discriminator(32, 4, 8, 64, device="cpu", pack_levels=p))
         for p in (0, 2)]
    assert d[0] == d[1]
    x = np.zeros((1, 32, 32, 1), np.float32)
    jtree = jax.device_get(JUNet(5, 8, "instance", "lrelu", pack_levels=2)
                           .init(jax.random.PRNGKey(0), x)["params"])
    net = UNet(5, 8, device="cpu", pack_levels=2)
    missing, unexpected = net.load_state_dict(from_flax(jtree))
    assert not missing and not unexpected
    assert to_flax(net).keys() == jtree.keys()


@contextlib.contextmanager
def jax_f64():
    """x64 on and the JAX norms' statistics in the activations' dtype
    (``norm_stats='native'``), as the JAX package's own float64
    equivalence test (tests/test_paired.py) runs; restored after."""
    jlayers.set_norm_stats("native")
    try:
        with jax.enable_x64(True):
            yield
    finally:
        jlayers.set_norm_stats("reduce")


def test_ugan_and_discriminator_packed_match_jax():
    """``UGANnce(pack_levels=2)`` unpaired (seg, packed seg, translation and
    feature pool in float32; the generator's gradients in float64, since
    the translation tower's stem gradient is ill-conditioned in float32:
    the JAX package's own packed and unpacked towers differ by 1.5% there)
    and the discriminator with its packed stem (outputs and the input
    gradient) against the JAX modules at the same weights.  float64
    gradients scaled by each one's largest entry within 1e-6."""
    rng = np.random.default_rng(12)
    x = _x(rng, (2, 32, 32, 1))
    m = np.eye(4, dtype=np.float32)[[0, 2]]
    ids = np.arange(4, dtype=np.int32)
    jnet = jugan.UGANnce(5, 4, 8, netF_nc=32, pack_levels=2,
                         pair_towers=False)
    params = jax.device_get(jnet.init(jax.random.PRNGKey(4), x, m, ids)
                            ["params"])
    tgt = _x(rng, (2, 32, 32, 5))
    jout = jax.jit(lambda p: jnet.apply({"params": p}, x, m, ids))(params)
    jseg_p = jax.jit(lambda p: jnet.apply({"params": p}, x, m, ids,
                                          packed_seg=True)[0])(params)
    net = UGANnce(5, 4, 8, 32, compute_dtype=torch.float32, device="cpu",
                  pack_levels=2)
    net.load_state_dict(from_flax(params))
    idt = torch.from_numpy(ids).long()
    seg, tsl, f = net(_t(x), _t(m), idt)
    _close(seg, jout[0], rtol=1e-3, atol=1e-4)
    _close(tsl, jout[1], rtol=1e-3, atol=5e-4)
    _close(f, jout[2], rtol=1e-3, atol=1e-4)
    _close(net(_t(x), _t(m), idt, packed_seg=True)[0], jseg_p, rtol=1e-3,
           atol=1e-4)

    with jax_f64():
        j64 = jugan.UGANnce(5, 4, 8, netF_nc=32, dtype=jnp.float64,
                            pack_levels=2, pair_towers=False)
        p64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     params)

        def jloss(p):
            seg, tsl, f = j64.apply({"params": p}, x.astype(np.float64),
                                    m.astype(np.float64), ids)
            return jnp.sum(seg * tgt) + jnp.sum(tsl) + jnp.sum(f)

        jgrads = jax.device_get(jax.jit(jax.grad(jloss))(p64))
    net.double().compute_dtype = torch.float64
    seg, tsl, f = net(_t(x).double(), _t(m).double(), idt)
    ((seg * _t(tgt).double()).sum() + tsl.sum() + f.sum()).backward()
    _grads_close(net, jgrads, "UGANnce", atol=1e-6)

    jd = jugan.Discriminator(32, 4, 8, 64, pack_levels=2)
    dparams = jax.device_get(jd.init(jax.random.PRNGKey(5), x)["params"])
    want = jd.apply({"params": dparams}, x)
    wdx = jax.grad(lambda a: jnp.sum(jd.apply({"params": dparams}, a)[0]))(x)
    d = Discriminator(32, 4, 8, 64, compute_dtype=torch.float32,
                      device="cpu", pack_levels=2)
    d.load_state_dict(from_flax(dparams))
    xt = _t(x, True)
    src, cls = d(xt)
    _close(src, want[0], rtol=1e-3, atol=1e-4)
    _close(cls, want[1], rtol=1e-3, atol=1e-4)
    src.sum().backward()
    _close(xt.grad, wdx, rtol=1e-3, atol=1e-4)


def test_w_packing_and_sharded_packing_raise_naming_the_roadmap(
        monkeypatch):
    """Packing in either mode (hw or W, the discriminator's too) under a
    space or a model group raises naming ROADMAP A13c; an unknown
    ``pack_mode``/``d_pack_mode``, a ``pack_w0`` whose packs do not divide
    the maps (an odd one for the W stem's stride 2) and ``layout_pin`` with
    a W discriminator (the JAX package's message) raise; nothing raises
    unpacked, nor in the JAX ``Config()``'s layout."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.parallel import distributed
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    small = dict(input_size=32, base_width=8, batch_size=2, nce_patches=4)
    for bad in (dict(pack_mode="x"), dict(d_pack_mode="hx")):
        with pytest.raises(ValueError, match="is not"):
            UGANConsisAlgo(Config(**small, pack_levels=2, **bad),
                           device="cpu")
    with pytest.raises(ValueError, match="pack_w0=3"):
        SupervisedUNet(Config(**small, pack_levels=2, pack_mode="w",
                              pack_w0=3), device="cpu")
    with pytest.raises(ValueError, match="pack_w0=3"):
        UGANConsisAlgo(Config(**small, pack_levels=2, pack_w0=3),
                       device="cpu")
    with pytest.raises(ValueError, match="layout_pin='cmin' cannot be"):
        SupervisedUNet(Config(**small, layout_pin="cmin"), device="cpu")
    UGANConsisAlgo(Config(**small), device="cpu")   # unpacked
    UGANConsisAlgo(Config(**small, pack_levels=2), device="cpu")
    x = torch.zeros((1, 32, 32, 1))
    nets = [UNet(5, 8, compute_dtype=torch.float32, device="cpu",
                 pack_levels=2, pack_mode=mode) for mode in ("hw", "w")]
    nets.append(Discriminator(32, 4, 8, 64, compute_dtype=torch.float32,
                              device="cpu", pack_levels=2, pack_mode="w"))
    for name in ("space_count", "model_count"):
        for net in nets:
            with monkeypatch.context() as m:
                m.setattr(distributed, name, lambda: 2)
                with pytest.raises(ValueError, match="A13c"):
                    net(x)


def test_serving_carries_the_packed_layout(tmp_path):
    """``export_eval`` writes the layout (``pack_levels``, ``pack_mode``,
    ``d_pack_mode``, ``pair_towers``) into the manifest and
    ``load_serving`` rebuilds the forward in it: the served logits of a
    packed ``uganConsis`` are its packed ``eval_fn``'s to the bit."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.serve import export_eval, load_serving
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    cfg = Config(input_size=32, base_width=8, batch_size=2, nce_patches=4,
                 compute_dtype="float32", pack_levels=2, d_pack_mode="hw")
    algo = UGANConsisAlgo(cfg, device="cpu")
    params = algo.eval_params(algo.init_state(0))
    export_eval(algo, params, cfg, str(tmp_path))
    predict, manifest = load_serving(str(tmp_path), device="cpu")
    assert manifest["model"]["pack_levels"] == 2
    x = _x(np.random.default_rng(21), (2, 32, 32, 1))
    np.testing.assert_array_equal(predict(x).numpy(),
                                  algo.eval_fn(params, x).numpy())
