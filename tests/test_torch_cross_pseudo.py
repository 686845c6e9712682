# -*- coding: utf-8 -*-
"""Cross-pseudo supervision in the port
(smsut_tpu_torch/train/steps/cross_pseudo.py) against the JAX package's
CrossPseudo in its strict-parity mode: three steps from the same two
transplanted nets and batches; the four losses and both nets after each
step, in both block modes; the shared count; the eval forward serves net
1."""
import numpy as np
import pytest
import torch

import jax

from smsut_tpu.config import Config as JConfig
from smsut_tpu.train.steps.cross_pseudo import CrossPseudo as JCrossPseudo
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.models.transplant import state_trees_from_flax, to_flax
from smsut_tpu_torch.train.steps.cross_pseudo import CrossPseudo
from torch_port_helpers import STRICT, assert_trees_close, few_torch_threads

STEPS = 3
_CFG = dict(input_size=32, base_width=8, batch_size=2, num_iter_per_epoch=10,
            max_epoch=20)
EPOCH = 9   # lambda_semi's rampup inside (0, 0.1)
NAMES = ("loss", "loss2", "crossPse1_loss", "crossPse2_loss")

pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.fixture(scope="module")
def reference():
    rng = np.random.default_rng(6)
    jalgo = JCrossPseudo(JConfig(**_CFG, **STRICT))
    state = jalgo.init_state(jax.random.PRNGKey(0))
    init = jax.device_get(state)
    batches, metrics, trees = [], [], []
    for _ in range(STEPS):
        b = {"img": rng.normal(size=(2, 32, 32, 1)).astype(np.float32),
             "msk": rng.integers(0, 5, size=(2, 32, 32)).astype(np.int32),
             "ul_img": rng.normal(size=(2, 32, 32, 1)).astype(np.float32)}
        state, m = jalgo.train_step(state, b, jalgo.epoch_scalars(EPOCH))
        batches.append(b)
        metrics.append({k: float(v) for k, v in m.items()})
        trees.append(jax.device_get((state.params, state.params2)))
    return jalgo, init, batches, metrics, trees


@pytest.mark.parametrize("block_pallas", [False, True])
def test_steps_match_jax(reference, block_pallas):
    jalgo, init, batches, want, trees = reference
    algo = CrossPseudo(Config(**_CFG, block_pallas=block_pallas,
                              compute_dtype="float32"), device="cpu")
    state = algo.state_from_params(**state_trees_from_flax(init))
    for k, b in enumerate(batches):
        state, m = algo.train_step(state, b, algo.epoch_scalars(EPOCH))
        for name in NAMES:
            np.testing.assert_allclose(float(m[name]), want[k][name],
                                       rtol=2e-3, atol=2e-4,
                                       err_msg=f"{name} {k}")
        assert_trees_close(to_flax(state.params), trees[k][0],
                           f"params after step {k}")
        assert_trees_close(to_flax(state.params2), trees[k][1],
                           f"params2 after step {k}")
    assert state.step == STEPS and int(state.count) == STEPS
    # net 1 serves
    img = batches[0]["img"]
    np.testing.assert_allclose(
        algo.eval_fn(algo.eval_params(state), img).numpy(),
        np.asarray(jalgo.eval_fn(trees[-1][0], img)), rtol=1e-3, atol=5e-4)


def test_nets_start_apart_and_lambda_matches_jax(reference):
    jalgo = reference[0]
    algo = CrossPseudo(Config(**_CFG), device="cpu")
    st = algo.init_state(0)
    assert st.params.keys() == st.params2.keys()
    assert not all(torch.equal(st.params[k], st.params2[k])
                   for k in st.params)
    for e in (0, 5, 20, 30):
        assert algo.epoch_scalars(e) == jalgo.epoch_scalars(e)
    with pytest.raises(ValueError):
        algo.state_from_params(st.params)
