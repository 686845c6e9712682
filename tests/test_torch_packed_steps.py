# -*- coding: utf-8 -*-
"""One step of each packed algorithm of the port at ``pack_levels=2``
against the JAX package's step, in its strict-parity mode otherwise
(float32, reduced statistics, host augmentation, one step a dispatch),
with the JAX rules for ``pair_towers`` and ``packed_loss_tails`` (None):
the supervised U-Net (tails off, and on), Mean Teacher (tails on, from
count 99 so that the consistency gate opens, the JAX noise fed in), CPS
(the two nets paired, tails on) and ``uganConsis`` (towers paired, tails
off, the discriminator's stem packed under ``d_pack_mode="hw"``; fed the
JAX draws); and ``d_concat_hat`` on and off equal.

Bounds: tests/test_torch_train.py's for the losses (rtol 2e-4 / atol
2e-5, here 2e-3 / 2e-4 for the semi-supervised steps as in their own
files) and parameters after the update (rtol 1e-3 / atol 1e-5, the
semi-supervised trees tests/test_torch_train.py's 5e-3 / 5e-4);
tests/test_torch_gan.py's step-0 losses (rtol 5e-3 / atol 2e-3); the D
loss and its gradients with and without ``d_concat_hat`` within 1e-5 of
each gradient's largest entry (float32 summation order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.config import Config as JConfig
from smsut_tpu.train.steps.cross_pseudo import CrossPseudo as JCrossPseudo
from smsut_tpu.train.steps.gan import UGANConsisAlgo as JConsis
from smsut_tpu.train.steps.mean_teacher import MeanTeacher as JMeanTeacher
from smsut_tpu.train.steps.supervised import SupervisedUNet as JSupervised
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.models.transplant import (from_flax,
                                               state_trees_from_flax, to_flax)
from smsut_tpu_torch.train.steps.cross_pseudo import CrossPseudo
from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher
from smsut_tpu_torch.train.steps.supervised import SupervisedUNet
from torch_port_helpers import (STRICT, assert_trees_close, at_count,
                                few_torch_threads)  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def _x(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


_STEP = dict(input_size=32, base_width=8, batch_size=2,
             num_iter_per_epoch=10, max_epoch=20)
_PACKED = dict(STRICT, pack_levels=2, pair_towers=None,
               packed_loss_tails=None, d_pack_mode="hw")


@pytest.mark.parametrize("tails", [None, True])
def test_supervised_step_packed_matches_jax(tails):
    """One supervised step at pack_levels 2 (the packed loss tail off, the
    JAX rule, and on) against the JAX step: the loss and every parameter
    after the SGD update."""
    rng = np.random.default_rng(13)
    cfg = dict(_STEP, **dict(_PACKED, packed_loss_tails=tails))
    jalgo = JSupervised(JConfig(**cfg))
    state = jalgo.init_state(jax.random.PRNGKey(0))
    init = jax.device_get(state.params)
    b = {"img": _x(rng, (2, 32, 32, 1)),
         "msk": rng.integers(0, 5, size=(2, 32, 32)).astype(np.int32)}
    state, m = jalgo.train_step(state, b, {})
    algo = SupervisedUNet(Config(**cfg), device="cpu")
    assert algo.packed_out == bool(tails)
    st = algo.state_from_params(from_flax(init))
    st, got = algo.train_step(st, b)
    np.testing.assert_allclose(float(got["loss"]), float(m["loss"]),
                               rtol=2e-4, atol=2e-5)
    want = from_flax(jax.device_get(state.params))
    for k, v in st.params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=k)


def _gan_draws(key, n, hw, patches):
    r_mj, r_alpha, r_patch = jax.random.split(key, 3)
    return {"mj": int(jax.random.randint(r_mj, (), 0, 4, jnp.int32)),
            "alpha": np.asarray(jax.random.normal(r_alpha, (n, 1, 1, 1))),
            "patch_ids": np.asarray(jax.random.permutation(r_patch, hw)
                                    [:patches])}


def _gan_batch(rng):
    return {"img": _x(rng, (2, 32, 32, 1), 0.5),
            "msk": rng.integers(0, 5, size=(2, 32, 32)).astype(np.int32),
            "mdl": np.zeros(2, np.int32),
            "ul_img": _x(rng, (2, 32, 32, 1), 0.5),
            "ul_mdl": np.ones(2, np.int32)}


def test_consis_step_packed_matches_jax():
    """One ``uganConsis`` step at pack_levels 2 with the JAX rules (towers
    paired, packed tails off, the D stem packed) against the JAX step fed
    the same draws: every D and G metric of step 0."""
    rng = np.random.default_rng(14)
    cfg = dict(_STEP, **_PACKED, nce_patches=4, consis_gate_step=0,
               max_epoch=2)
    jalgo = JConsis(JConfig(**cfg))
    state = jax.jit(jalgo.init_state)(jax.random.PRNGKey(0))
    g0, d0 = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                    (state.g_params, state.d_params))
    b = _gan_batch(rng)
    key = jax.random.PRNGKey(100)
    draws = _gan_draws(key, 4, jalgo.bottleneck_hw, 4)
    _, want = jalgo.train_step(state, {k: jnp.asarray(v)
                                       for k, v in b.items()},
                               dict(jalgo.epoch_scalars(1), rng=key))
    algo = UGANConsisAlgo(Config(**cfg), device="cpu")
    assert algo.pair and not algo.packed_seg
    st = algo.state_from_params(from_flax(g0), from_flax(d0))
    _, got = algo.train_step(st, dict(b, **draws), algo.epoch_scalars(1))
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=5e-3,
                                   atol=2e-3, err_msg=k)


def test_d_concat_hat_on_and_off_equal():
    """``d_concat_hat`` (real, fake and x_hat in one D apply, the GP's
    input gradient its x_hat slice) gives the D loss and the D gradients
    of the two applies, with the packed stem."""
    outs = []
    for concat in (False, True):
        cfg = Config(**_STEP, pack_levels=2, d_pack_mode="hw",
                     compute_dtype="float32", nce_patches=4,
                     d_concat_hat=concat)
        algo = UGANConsisAlgo(cfg, device="cpu")
        d = {k: v.detach().requires_grad_()
             for k, v in algo.D.state_dict().items()}
        x_real = _t(_x(np.random.default_rng(16), (4, 32, 32, 1)))
        x_fake = _t(_x(np.random.default_rng(17), (4, 32, 32, 1)))
        alpha = _t(_x(np.random.default_rng(18), (4, 1, 1, 1)))
        total, aux, _ = algo.d_loss(d, x_real, x_fake, alpha,
                                    torch.tensor([0, 1, 2, 3]))
        grads = torch.autograd.grad(total, list(d.values()))
        outs.append(([float(a) for a in aux], grads))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-6)
    # float32 summation order apart: each gradient scaled by its largest
    for a, b in zip(outs[0][1], outs[1][1]):
        scale = float(b.abs().max()) + 1e-12
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale,
                                   rtol=0, atol=1e-5)


def _semi_batch(rng):
    return {"img": _x(rng, (2, 32, 32, 1)),
            "msk": rng.integers(0, 5, size=(2, 32, 32)).astype(np.int32),
            "ul_img": _x(rng, (2, 32, 32, 1))}


def test_cross_pseudo_step_packed_matches_jax():
    """One CPS step at pack_levels 2, the two nets tower-paired
    (``UNetPair``) and all four losses on the packed logits, against the
    JAX step: the losses and both nets after the update."""
    rng = np.random.default_rng(19)
    cfg = dict(_STEP, **_PACKED)
    jalgo = JCrossPseudo(JConfig(**cfg))
    state = jalgo.init_state(jax.random.PRNGKey(0))
    init = jax.device_get(state)
    b = _semi_batch(rng)
    state, want = jalgo.train_step(state, b, jalgo.epoch_scalars(9))
    algo = CrossPseudo(Config(**cfg), device="cpu")
    assert algo.pair and algo.packed_out
    st = algo.state_from_params(**state_trees_from_flax(init))
    st, got = algo.train_step(st, b, algo.epoch_scalars(9))
    for k in ("loss", "loss2", "crossPse1_loss", "crossPse2_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=2e-3,
                                   atol=2e-4, err_msg=k)
    assert_trees_close(to_flax(st.params), jax.device_get(state.params),
                       "params")
    assert_trees_close(to_flax(st.params2), jax.device_get(state.params2),
                       "params2")


def test_mean_teacher_step_packed_matches_jax():
    """One Mean Teacher step at pack_levels 2 with the packed tails (the
    teacher's and the student's packed logits, the packed consistency)
    from count 100, the gate open, the JAX noise fed in: the losses, the
    student and the teacher after the step."""
    rng = np.random.default_rng(20)
    cfg = dict(_STEP, **_PACKED)
    jalgo = JMeanTeacher(JConfig(**cfg))
    state = at_count(jalgo.init_state(jax.random.PRNGKey(0)), 100)
    init = jax.device_get(state)
    b = _semi_batch(rng)
    key = jax.random.PRNGKey(41)
    noise = np.array(jnp.clip(0.01 * jax.random.normal(
        key, b["ul_img"].shape), -0.02, 0.02))
    state, want = jalgo.train_step(state, b, dict(jalgo.epoch_scalars(7),
                                                  rng=key))
    algo = MeanTeacher(Config(**cfg), device="cpu")
    assert algo.packed_out
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
