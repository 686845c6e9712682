# -*- coding: utf-8 -*-
"""Mean Teacher in the port (smsut_tpu_torch/train/steps/mean_teacher.py)
against the JAX package's MeanTeacher in its strict-parity mode: three
steps from the same transplanted weights, batches and teacher noise (the
JAX draw, fed to the port as the step's ``noise`` input), from device count
99, so that the consistency gate opens and the EMA's alpha leaves 0 inside
the run; the losses, the student and the teacher after each step, in both
block modes.  And the port's own noise: a function of the count."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.config import Config as JConfig
from smsut_tpu.ops.schedules import mean_teacher_alpha as j_alpha
from smsut_tpu.train.steps.mean_teacher import MeanTeacher as JMeanTeacher
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.models.transplant import state_trees_from_flax, to_flax
from smsut_tpu_torch.ops.schedules import ema_alpha, mean_teacher_alpha
from smsut_tpu_torch.train.steps.mean_teacher import (MeanTeacher,
                                                      teacher_noise)
from torch_port_helpers import (STRICT, assert_trees_close, at_count,
                                few_torch_threads)

STEPS, START = 3, 99
_CFG = dict(input_size=32, base_width=8, batch_size=2, num_iter_per_epoch=10,
            max_epoch=20)
EPOCH = 7   # lambda_semi's rampup inside (0, 1)

pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.fixture(scope="module")
def reference():
    """The JAX steps from PRNGKey(0) at count 99: the initial trees, the
    batches with the noise each step drew, the metrics and the trees after
    each step."""
    rng = np.random.default_rng(5)
    jalgo = JMeanTeacher(JConfig(**_CFG, **STRICT))
    state = jalgo.init_state(jax.random.PRNGKey(0))
    state = at_count(state, START)
    init = jax.device_get(state)
    batches, metrics, trees = [], [], []
    for k in range(STEPS):
        b = {"img": rng.normal(size=(2, 32, 32, 1)).astype(np.float32),
             "msk": rng.integers(0, 5, size=(2, 32, 32)).astype(np.int32),
             "ul_img": rng.normal(size=(2, 32, 32, 1)).astype(np.float32)}
        key = jax.random.PRNGKey(40 + k)
        scalars = dict(jalgo.epoch_scalars(EPOCH), rng=key)
        b["noise"] = np.array(jnp.clip(0.01 * jax.random.normal(
            key, b["ul_img"].shape), -0.02, 0.02))
        state, m = jalgo.train_step(
            state, {k2: v for k2, v in b.items() if k2 != "noise"}, scalars)
        batches.append(b)
        metrics.append({k2: float(v) for k2, v in m.items()})
        trees.append(jax.device_get((state.params, state.ema_params)))
    return init, batches, metrics, trees


@pytest.mark.parametrize("block_pallas", [False, True])
def test_steps_match_jax_across_the_gates(reference, block_pallas):
    init, batches, want, trees = reference
    algo = MeanTeacher(Config(**_CFG, block_pallas=block_pallas,
                              compute_dtype="float32"), device="cpu")
    state = algo.state_from_params(**state_trees_from_flax(init))
    state.step = START
    state.count.fill_(START)
    for k, b in enumerate(batches):
        state, m = algo.train_step(state, b, algo.epoch_scalars(EPOCH))
        got = {k2: float(v) for k2, v in m.items()}
        for name in ("loss", "semi_loss", "alpha"):
            np.testing.assert_allclose(got[name], want[k][name], rtol=2e-3,
                                       atol=2e-4, err_msg=f"{name} {k}")
        assert_trees_close(to_flax(state.params), trees[k][0],
                           f"params after step {k}")
        assert_trees_close(to_flax(state.ema_params), trees[k][1],
                           f"ema_params after step {k}")
    # the gate opens at count 100 and the EMA leaves the student there
    assert want[0]["semi_loss"] == 0.0 and want[1]["semi_loss"] > 0
    assert want[0]["alpha"] == 0.0 and want[1]["alpha"] == pytest.approx(0.99)
    assert state.step == START + STEPS and int(state.count) == START + STEPS


@pytest.mark.parametrize("it", [0, 99, 100, 101, 150, 5000])
def test_alpha_matches_jax(it):
    want = j_alpha(it)
    assert mean_teacher_alpha(it) == want
    got = float(ema_alpha(torch.tensor(it)))
    assert got == pytest.approx(want, rel=1e-6)


def test_port_noise_is_a_function_of_the_count():
    """The step's own draw: clipped at 2 sigma, about N(0, 0.01^2) inside,
    the same for a count on every call, another for the next count."""
    shape = (4, 32, 32, 1)
    a = teacher_noise(torch.tensor(7), shape, 2020)
    assert a.shape == shape and a.dtype == torch.float32
    assert torch.equal(a, teacher_noise(torch.tensor(7), shape, 2020))
    b = teacher_noise(torch.tensor(8), shape, 2020)
    assert not torch.equal(a, b)
    assert not torch.equal(a, teacher_noise(torch.tensor(7), shape, 1))
    x = torch.cat([a.flatten(), b.flatten()])
    assert float(x.abs().max()) <= 0.02
    assert abs(float(x.mean())) < 1e-3
    assert float((x.abs() == 0.02).float().mean()) == pytest.approx(
        0.0455, abs=0.01)   # P(|z| >= 2)
    inner = x[x.abs() < 0.01]
    assert float(inner.numel()) / x.numel() == pytest.approx(0.6827, abs=0.01)
