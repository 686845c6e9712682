# -*- coding: utf-8 -*-
"""One step of each algorithm of the port in a W-packed layout against the
JAX package's step, in its strict-parity mode otherwise (float32, reduced
statistics, host augmentation, one step a dispatch), the JAX rules for
``pair_towers`` and ``packed_loss_tails``:

- the supervised U-Net, Mean Teacher (from count 100, the gate open, the
  JAX noise fed in; its packed tails asked for, which the W decoder
  ignores), CPS with ``pair_towers=True`` (W nets are never paired) and
  CoraNet's stage A, each at ``pack_levels=2``, ``pack_mode="w"``, w8 from
  ``pack_w0`` 8 (the schedule [8, 8]: the pool between the two W levels
  regroups column pairs);

The GAN steps are in tests/test_torch_packed_w_gan.py (a file of their own
so that each file stays near a minute on one worker).

Bounds: tests/test_torch_packed_steps.py's: the supervised loss rtol 2e-4
/ atol 2e-5 and its parameters rtol 1e-3 / atol 1e-5; the semi-supervised
losses rtol 2e-3 / atol 2e-4 and trees rtol 5e-3 / atol 5e-4."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from smsut_tpu.config import Config as JConfig
from smsut_tpu.models import packed_w as jpw
from smsut_tpu.train.steps import coranet as jcora
from smsut_tpu.train.steps.cross_pseudo import CrossPseudo as JCrossPseudo
from smsut_tpu.train.steps.mean_teacher import MeanTeacher as JMeanTeacher
from smsut_tpu.train.steps.supervised import SupervisedUNet as JSupervised
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.models.transplant import (from_flax,
                                               state_trees_from_flax, to_flax)
from smsut_tpu_torch.train.steps.coranet import CoraNet
from smsut_tpu_torch.train.steps.cross_pseudo import CrossPseudo
from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher
from smsut_tpu_torch.train.steps.supervised import SupervisedUNet
from torch_port_helpers import (STRICT, assert_trees_close, at_count,
                                few_torch_threads)  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads", "jax_pack_restored")

_STEP = dict(input_size=32, base_width=8, batch_size=2,
             num_iter_per_epoch=10, max_epoch=20)
_W = dict(STRICT, pack_levels=2, pack_mode="w", pair_towers=None,
          packed_loss_tails=None)


@pytest.fixture
def jax_pack_restored():
    """The JAX steps arm the JAX package's packing mode (module state) from
    their Config; it is put back after each test."""
    saved = (jpw._PACK_MODE, jpw._PACK_W0, jpw._D_PACK_DEEP, jpw._D_PACK_MODE)
    yield
    jpw.set_pack_mode(*saved)


def _x(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _semi_batch(rng):
    return {"img": _x(rng, (2, 32, 32, 1)),
            "msk": rng.integers(0, 5, size=(2, 32, 32)).astype(np.int32),
            "ul_img": _x(rng, (2, 32, 32, 1))}


def test_supervised_step_w_matches_jax():
    rng = np.random.default_rng(31)
    cfg = dict(_STEP, **_W)
    jalgo = JSupervised(JConfig(**cfg))
    state = jalgo.init_state(jax.random.PRNGKey(0))
    init = jax.device_get(state.params)
    b = {"img": _x(rng, (2, 32, 32, 1)),
         "msk": rng.integers(0, 5, size=(2, 32, 32)).astype(np.int32)}
    state, m = jalgo.train_step(state, b, {})
    algo = SupervisedUNet(Config(**cfg), device="cpu")
    assert algo.net.encoder.pack_ps == [8, 8] and not algo.packed_out
    st = algo.state_from_params(from_flax(init))
    st, got = algo.train_step(st, b)
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=2e-4, atol=2e-5)
    want = from_flax(jax.device_get(state.params))
    for k, v in st.params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def test_mean_teacher_step_w_matches_jax():
    rng = np.random.default_rng(32)
    cfg = dict(_STEP, **_W)
    jalgo = JMeanTeacher(JConfig(**cfg))
    state = at_count(jalgo.init_state(jax.random.PRNGKey(0)), 100)
    init = jax.device_get(state)
    b = _semi_batch(rng)
    key = jax.random.PRNGKey(42)
    noise = np.array(jnp.clip(0.01 * jax.random.normal(
        key, b["ul_img"].shape), -0.02, 0.02))
    state, want = jalgo.train_step(state, b, dict(jalgo.epoch_scalars(7),
                                                  rng=key))
    algo = MeanTeacher(Config(**cfg), device="cpu")
    st = algo.state_from_params(**state_trees_from_flax(init))
    st.step = 100
    st.count.fill_(100)
    st, got = algo.train_step(st, dict(b, noise=noise),
                              algo.epoch_scalars(7))
    for k in ("loss", "semi_loss", "alpha"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-3,
                                   atol=2e-4, err_msg=k)
    assert float(got["semi_loss"]) > 0
    assert_trees_close(to_flax(st.params), jax.device_get(state.params),
                       "params")
    assert_trees_close(to_flax(st.ema_params),
                       jax.device_get(state.ema_params), "ema_params")


def test_cross_pseudo_step_w_unpaired_matches_jax():
    rng = np.random.default_rng(33)
    cfg = dict(_STEP, **dict(_W, pair_towers=True))
    jalgo = JCrossPseudo(JConfig(**cfg))
    assert not jalgo._pair
    state = jalgo.init_state(jax.random.PRNGKey(0))
    init = jax.device_get(state)
    b = _semi_batch(rng)
    state, want = jalgo.train_step(state, b, jalgo.epoch_scalars(9))
    algo = CrossPseudo(Config(**cfg), device="cpu")
    assert not algo.pair and algo.pair_net is None
    st = algo.state_from_params(**state_trees_from_flax(init))
    st, got = algo.train_step(st, b, algo.epoch_scalars(9))
    for k in ("loss", "loss2", "crossPse1_loss", "crossPse2_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-3,
                                   atol=2e-4, err_msg=k)
    assert_trees_close(to_flax(st.params), jax.device_get(state.params),
                       "params")
    assert_trees_close(to_flax(st.params2), jax.device_get(state.params2),
                       "params2")


def test_coranet_stage_a_step_w_matches_jax():
    rng = np.random.default_rng(34)
    cfg = dict(_STEP, **_W, pre_epoch=30, cora_epoch=200)
    jalgo = jcora.CoraNet(JConfig(**cfg), stage="pre")
    state = at_count(jalgo.init_state(jax.random.PRNGKey(0)), 99)
    init = jax.device_get(state)
    b = {"img": _x(rng, (2, 32, 32, 1)),
         "msk": rng.integers(0, 5, size=(2, 32, 32)).astype(np.int32)}
    state, want = jalgo.train_step(state, b, jalgo.epoch_scalars(11))
    algo = CoraNet(Config(**cfg), device="cpu", stage="pre")
    st = algo.state_from_params(**state_trees_from_flax(init))
    st.step = 99
    st.count.fill_(99)
    st, got = algo.train_step(st, b, algo.epoch_scalars(11))
    for k in ("loss", "cedc_loss", "loss_con", "loss_rad"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-3,
                                   atol=2e-4, err_msg=k)
    assert_trees_close(to_flax(st.params), jax.device_get(state.params),
                       "params")


@pytest.mark.parametrize("name,layout", [
    ("uganConsis", dict(pack_levels=2)),
    ("unet", dict(pack_levels=2, pack_mode="w", pack_w0=4))])
def test_serving_carries_the_w_layout(tmp_path, name, layout):
    """``export_eval`` writes the W layout (``pack_mode``, ``d_pack_mode``,
    ``pack_w0``, ``d_pack_deep``) into the manifest and ``load_serving``
    rebuilds the forward in it: the served logits are the algorithm's
    ``eval_fn``'s to the bit (``uganConsis`` in the JAX ``Config()``'s
    layout, the U-Net all-W from ``pack_w0`` 4)."""
    from smsut_tpu_torch.serve import export_eval, load_serving
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    cfg = Config(input_size=32, base_width=8, batch_size=2, nce_patches=4,
                 compute_dtype="float32", **layout)
    algo = (UGANConsisAlgo if name == "uganConsis" else SupervisedUNet)(
        cfg, device="cpu")
    params = algo.eval_params(algo.init_state(0))
    export_eval(algo, params, cfg, str(tmp_path))
    predict, manifest = load_serving(str(tmp_path), device="cpu")
    for k in ("pack_levels", "pack_mode", "d_pack_mode", "pack_w0",
              "d_pack_deep"):
        assert manifest["model"][k] == getattr(cfg, k)
    x = _x(np.random.default_rng(36), (2, 32, 32, 1))
    np.testing.assert_array_equal(predict(x).numpy(),
                                  algo.eval_fn(params, x).numpy())
