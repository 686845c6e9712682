# -*- coding: utf-8 -*-
"""CoraNet in the port (smsut_tpu_torch/train/steps/coranet.py) against
the JAX package's CoraNet in its strict-parity mode: three steps of each
stage from the same transplanted 13-channel U-Net and EMA, batches and
pseudo batches, stage A from count 99 (the EMA's alpha leaves 0) and stage
B from count 999 (the certain and uncertain terms open at 1000), in both
block modes; the three-head losses against the JAX fused tail and
``split_heads``; the pseudo-label sweep against the JAX ``pred_unlabel``
(``_infer_impl``'s labels and mask, the Dice); the pseudo batches' index
sequence; the LR of both stages past their ends."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.config import Config as JConfig
from smsut_tpu.train.steps import coranet as jcora
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.models.transplant import state_trees_from_flax, to_flax
from smsut_tpu_torch.ops.losses import (coranet_weights, split_heads,
                                        three_head_losses)
from smsut_tpu_torch.train.steps.coranet import CoraNet
from torch_port_helpers import (STRICT, assert_trees_close, at_count,
                                few_torch_threads)

STEPS = 3
START = {"pre": 99, "cora": 999}
_CFG = dict(input_size=32, base_width=8, batch_size=2, num_iter_per_epoch=10,
            max_epoch=20, pre_epoch=30, cora_epoch=200)
EPOCH = 11
NAMES = {"pre": ("loss", "cedc_loss", "loss_con", "loss_rad"),
         "cora": ("loss", "supervised_loss", "certain_loss",
                  "uncertain_loss")}

pytestmark = pytest.mark.usefixtures("few_torch_threads")


def _batches(rng, stage):
    out = []
    for _ in range(STEPS):
        b = {"img": rng.normal(size=(2, 32, 32, 1)).astype(np.float32),
             "msk": rng.integers(0, 5, size=(2, 32, 32)).astype(np.int32)}
        if stage == "cora":
            b.update(pse_img=rng.normal(size=(2, 32, 32, 1)).astype(
                         np.float32),
                     pse_lab=rng.integers(0, 5, size=(2, 32, 32)).astype(
                         np.int32),
                     pse_mask=rng.integers(0, 2, size=(2, 32, 32)).astype(
                         np.int32))
        out.append(b)
    return out


@pytest.fixture(scope="module", params=["pre", "cora"])
def reference(request):
    stage = request.param
    rng = np.random.default_rng(7)
    jalgo = jcora.CoraNet(JConfig(**_CFG, **STRICT), stage=stage)
    state = at_count(jalgo.init_state(jax.random.PRNGKey(0)), START[stage])
    init = jax.device_get(state)
    batches = _batches(rng, stage)
    metrics, trees = [], []
    for b in batches:
        state, m = jalgo.train_step(state, b, jalgo.epoch_scalars(EPOCH))
        metrics.append({k: float(v) for k, v in m.items()})
        trees.append(jax.device_get((state.params, state.ema_params)))
    return stage, jalgo, init, batches, metrics, trees


@pytest.mark.parametrize("block_pallas", [False, True])
def test_steps_match_jax_across_the_gates(reference, block_pallas):
    stage, _, init, batches, want, trees = reference
    algo = CoraNet(Config(**_CFG, block_pallas=block_pallas,
                          compute_dtype="float32"), device="cpu", stage=stage)
    state = algo.state_from_params(**state_trees_from_flax(init))
    state.step = START[stage]
    state.count.fill_(START[stage])
    for k, b in enumerate(batches):
        state, m = algo.train_step(state, b, algo.epoch_scalars(EPOCH))
        for name in NAMES[stage]:
            np.testing.assert_allclose(float(m[name]), want[k][name],
                                       rtol=2e-3, atol=2e-4,
                                       err_msg=f"{stage} {name} {k}")
        assert_trees_close(to_flax(state.params), trees[k][0],
                           f"{stage} params after step {k}")
        assert_trees_close(to_flax(state.ema_params), trees[k][1],
                           f"{stage} ema_params after step {k}")
    if stage == "cora":   # the gate opens at count 1000
        assert want[0]["certain_loss"] == want[0]["uncertain_loss"] == 0.0
        assert want[1]["certain_loss"] > 0 and want[1]["uncertain_loss"] > 0


def test_three_head_losses_match_jax(rng):
    out = rng.normal(size=(2, 16, 16, 13)).astype(np.float32) * 2
    msk = rng.integers(0, 5, size=(2, 16, 16)).astype(np.int32)
    jw = jcora.coranet_weights(4)
    want = jcora.three_head_losses(jnp.asarray(out), jnp.asarray(msk), *jw,
                                   4, 0.5, 0.5)
    w_con, w_rad = coranet_weights(4)
    np.testing.assert_array_equal(w_con.numpy(), np.asarray(jw[0]))
    np.testing.assert_array_equal(w_rad.numpy(), np.asarray(jw[1]))
    got = three_head_losses(torch.from_numpy(out), torch.from_numpy(msk),
                            w_con, w_rad, 4, 0.5, 0.5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-6)
    for g, w in zip(split_heads(torch.from_numpy(out), 4),
                    jcora.split_heads(jnp.asarray(out), 4)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("block_pallas", [False, True])
def test_pseudo_labels_match_jax(rng, block_pallas):
    """Five samples in chunks of two (the last padded): labels, mask and
    the mean pseudo-label Dice against the JAX sweep on the same weights;
    the arrays match to the bit where the JAX argmax has no near-tie."""
    cfg = dict(_CFG, batch_size=2)
    jalgo = jcora.CoraNet(JConfig(**cfg, **STRICT), stage="cora")
    jstate = jalgo.init_state(jax.random.PRNGKey(1))
    samples = [(rng.normal(size=(32, 32, 1)).astype(np.float32),
                rng.integers(0, 5, size=(32, 32)).astype(np.int32),
                int(rng.integers(0, 4))) for _ in range(5)]
    want, want_dice = jalgo.pred_unlabel(jstate, iter(samples))
    algo = CoraNet(Config(**cfg, block_pallas=block_pallas,
                          compute_dtype="float32"), device="cpu",
                   stage="cora")
    state = algo.state_from_params(**state_trees_from_flax(
        jax.device_get(jstate)))
    got, dice = algo.pred_unlabel(state, iter(samples), capture=False)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["img"], want["img"])
    np.testing.assert_array_equal(got["lab"], want["lab"])
    np.testing.assert_array_equal(got["mdl"], want["mdl"])
    for k in ("plab", "mask"):
        assert got[k].shape == want[k].shape
        assert (got[k] == want[k]).mean() > 0.999, k
    assert dice == pytest.approx(want_dice, abs=2e-3)


def test_pseudo_batches_draw_the_jax_index_sequence():
    """Shuffle + drop-last from random.Random(2020): seven draws of two
    over five samples (a reshuffle whenever fewer than two are left)."""
    n = 5
    pseudo = {"img": np.arange(n, dtype=np.float32).reshape(n, 1, 1, 1),
              "plab": np.arange(n).reshape(n, 1, 1),
              "mask": np.arange(n).reshape(n, 1, 1)}
    jalgo = jcora.CoraNet(JConfig(**_CFG, **STRICT), stage="cora")
    algo = CoraNet(Config(**_CFG), device="cpu", stage="cora")
    jalgo._pseudo, algo._pseudo = pseudo, pseudo
    for _ in range(7):
        want, got = jalgo.make_extra_batch(), algo.make_extra_batch()
        for k in ("pse_img", "pse_lab", "pse_mask"):
            np.testing.assert_array_equal(got[k], want[k])
    assert CoraNet(Config(**_CFG), "cpu", "pre").make_extra_batch() == {}


def test_lr_of_both_stages_past_their_ends():
    cfg = Config(**_CFG)
    jcfg = JConfig(**_CFG, **STRICT)
    total = cfg.cora_epoch * cfg.num_iter_per_epoch
    for stage in ("pre", "cora"):
        algo = CoraNet(cfg, "cpu", stage)
        jalgo = jcora.CoraNet(jcfg, stage)
        for step in (0, 1, 2, total // 2, total, total + 1, total + 99,
                     10_000):
            assert algo.lr_at(step) == jalgo.lr_at(step), (stage, step)
        # the device table the optimizer reads: constant in stage A, the
        # poly clamped to 0 past the end in stage B
        tx = algo.make_tx()
        at = lambda c: float(tx.tables.at("lr", torch.tensor(c),
                                          torch.float64))
        for step in (0, 5, total + 1, 10_000):
            assert at(step) == pytest.approx(algo.lr_at(step), abs=0), step
    assert CoraNet(cfg, "cpu", "pre").lr_at(10_000) == cfg.lr
    assert CoraNet(cfg, "cpu", "cora").lr_at(total + 99) == 0.0
    with pytest.raises(ValueError):
        CoraNet(cfg, "cpu", "B")
