# -*- coding: utf-8 -*-
"""One GAN step of the port in a W-packed layout against the JAX package's
step fed the same draws, in its strict-parity mode otherwise (float32,
reduced statistics, host augmentation): every D and G metric of step 0 of
``uganConsis`` in the JAX ``Config()``'s layout (``pack_levels=2`` and
every packing knob at its default: hw towers, paired, with a deep W
discriminator) and of ``ugan`` all-W (towers unpaired).  The other
algorithms' W steps are in tests/test_torch_packed_w_steps.py.

Bounds: tests/test_torch_packed_steps.py's for the GAN's step-0 metrics,
rtol 5e-3 / atol 2e-3."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from smsut_tpu.config import Config as JConfig
from smsut_tpu.models import packed_w as jpw
from smsut_tpu.train.steps.gan import UGANConsisAlgo as JConsis
from smsut_tpu.train.steps.gan import UGANTrainerAlgo as JUGAN
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.models.transplant import from_flax
from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo, UGANTrainerAlgo
from torch_port_helpers import STRICT, few_torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("few_torch_threads", "jax_pack_restored")

_STEP = dict(input_size=32, base_width=8, batch_size=2,
             num_iter_per_epoch=10, max_epoch=2)


@pytest.fixture
def jax_pack_restored():
    """The JAX steps arm the JAX package's packing mode (module state) from
    their Config; it is put back after each test."""
    saved = (jpw._PACK_MODE, jpw._PACK_W0, jpw._D_PACK_DEEP, jpw._D_PACK_MODE)
    yield
    jpw.set_pack_mode(*saved)


def _x(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _gan_draws(key, n, hw, patches):
    r_mj, r_alpha, r_patch = jax.random.split(key, 3)
    return {"mj": int(jax.random.randint(r_mj, (), 0, 4, jnp.int32)),
            "alpha": np.asarray(jax.random.normal(r_alpha, (n, 1, 1, 1))),
            "patch_ids": np.asarray(jax.random.permutation(r_patch, hw)
                                    [:patches])}


def _gan_batch(rng, unlabeled):
    b = {"img": _x(rng, (2, 32, 32, 1), 0.5),
         "msk": rng.integers(0, 5, size=(2, 32, 32)).astype(np.int32),
         "mdl": np.zeros(2, np.int32)}
    if unlabeled:
        b.update(ul_img=_x(rng, (2, 32, 32, 1), 0.5),
                 ul_mdl=np.ones(2, np.int32))
    return b


@pytest.mark.parametrize("variant,layout", [
    ("uganConsis", dict(pack_levels=2)),
    ("ugan", dict(pack_levels=2, pack_mode="w", d_pack_mode=""))])
def test_gan_step_w_matches_jax(variant, layout):
    """One GAN step fed the JAX draws, every D and G metric of step 0:
    ``uganConsis`` in the JAX ``Config()``'s layout (the towers hw and
    paired, the D W-packed deep) and ``ugan`` all-W (towers unpaired)."""
    rng = np.random.default_rng(35)
    cfg = dict(_STEP, **STRICT, nce_patches=4, consis_gate_step=0)
    cfg.update(layout, pair_towers=None, packed_loss_tails=None)
    jcls, cls = ((JConsis, UGANConsisAlgo) if variant == "uganConsis"
                 else (JUGAN, UGANTrainerAlgo))
    jalgo = jcls(JConfig(**cfg))
    state = jax.jit(jalgo.init_state)(jax.random.PRNGKey(0))
    g0, d0 = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                    (state.g_params, state.d_params))
    b = _gan_batch(rng, jalgo.uses_unlabeled)
    key = jax.random.PRNGKey(100)
    draws = _gan_draws(key, jalgo.total_batch, jalgo.bottleneck_hw, 4)
    epoch = 1 if variant == "uganConsis" else 3   # ugan's shape loss live
    _, want = jalgo.train_step(state, {k: jnp.asarray(v)
                                       for k, v in b.items()},
                               dict(jalgo.epoch_scalars(epoch), rng=key))
    algo = cls(Config(**cfg), device="cpu")
    assert algo.packing.d_mode == "w" and algo.D.pack_deep
    assert algo.pair == (variant == "uganConsis")
    st = algo.state_from_params(from_flax(g0), from_flax(d0))
    _, got = algo.train_step(st, dict(b, **draws), algo.epoch_scalars(epoch))
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=5e-3,
                                   atol=2e-3, err_msg=k)
