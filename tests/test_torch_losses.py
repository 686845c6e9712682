# -*- coding: utf-8 -*-
"""The port's losses (smsut_tpu_torch/ops/losses.py), poly-LR schedule
(ops/schedules.py) and SGD train state (train/state.py) against the JAX
package's losses, schedules and optax chain."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from smsut_tpu.config import Config as JConfig
from smsut_tpu.ops import losses as jl
from smsut_tpu.ops import schedules as js
from smsut_tpu.train.state import make_sgd as jmake_sgd
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.ops import losses as tl
from smsut_tpu_torch.ops import schedules as ts
from smsut_tpu_torch.train.state import TrainState, make_sgd
from torch_port_helpers import t


def _logits_labels(rng, b=2, hw=8, c=5):
    x = (3 * rng.normal(size=(b, hw, hw, c))).astype(np.float32)
    y = rng.integers(0, c, size=(b, hw, hw))
    return x, y


@pytest.mark.parametrize("wdc,wce", [(0.5, 0.5), (0.0, 1.0), (1.0, 0.0)])
def test_dice_and_ce_matches_jax_with_gradient(rng, wdc, wce):
    """The loss and its gradient in the logits (shared-softmax form when
    both weights are on, the separate losses otherwise)."""
    x, y = _logits_labels(rng)
    jf = lambda v: jl.dice_and_ce_loss(v, jnp.asarray(y), wdc, wce, True)
    want, want_g = jax.value_and_grad(jf)(jnp.asarray(x))
    xt = t(x).requires_grad_()
    got = tl.dice_and_ce_loss(xt, torch.from_numpy(y), wdc, wce, True)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("batch_dice", [True, False])
def test_dice_parts_match_jax(rng, batch_dice):
    x, y = _logits_labels(rng)
    probs = jax.nn.softmax(jnp.asarray(x), axis=-1)
    want = jl.get_tp_fp_fn(probs, jnp.asarray(y), batch_dice)
    got = tl.get_tp_fp_fn(torch.softmax(t(x), -1), torch.from_numpy(y),
                          batch_dice)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        tl.soft_dice_loss(t(x), torch.from_numpy(y), batch_dice).item(),
        float(jl.soft_dice_loss(jnp.asarray(x), jnp.asarray(y), batch_dice)),
        rtol=1e-6, atol=1e-6)


def test_weighted_cross_entropy_matches_jax(rng):
    x, y = _logits_labels(rng)
    w = np.array([0.5, 1.0, 2.0, 1.0, 3.0], np.float32)
    for reduce in (True, False):
        want = np.asarray(jl.cross_entropy_loss(jnp.asarray(x), jnp.asarray(y),
                                                jnp.asarray(w), reduce))
        got = tl.cross_entropy_loss(t(x), torch.from_numpy(y), t(w), reduce)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_poly_lr_matches_jax():
    """The one-step lag and the clamp at 0 past total_iters."""
    sched = js.poly_lr_schedule(0.01, 20)
    mine = ts.poly_lr_schedule(0.01, 20)
    for count in (0, 1, 2, 7, 19, 20, 21, 40):
        np.testing.assert_allclose(mine(count), float(sched(jnp.asarray(count))),
                                   rtol=1e-6)
        assert ts.poly_lr_host(0.01, count, 20) == js.poly_lr_host(0.01, count,
                                                                   20)
    assert mine(0) == mine(1) == 0.01 and mine(21) == mine(40) == 0.0


def test_sgd_matches_optax_chain(rng):
    """Coupled weight decay before the momentum trace, first trace = the
    gradient, lr = poly(max(step - 1, 0)): four updates against optax's
    add_decayed_weights -> trace -> scale_by_learning_rate."""
    kw = dict(num_iter_per_epoch=2, max_epoch=3, lr=0.05, weight_decay=1e-2)
    tx = jmake_sgd(JConfig(**kw))
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt = tx.init(jp)
    state = TrainState.create({k: t(v) for k, v in params.items()},
                              make_sgd(Config(**kw)))
    for _ in range(4):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in params.items()}
        upd, opt = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                             opt, jp)
        jp = optax.apply_updates(jp, upd)
        state = state.apply_gradients({k: t(g) for k, g in grads.items()})
    assert state.step == 4
    for k in params:
        np.testing.assert_allclose(state.params[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
