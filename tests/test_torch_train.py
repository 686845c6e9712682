# -*- coding: utf-8 -*-
"""The training slice: the port's SupervisedUNet.train_step against the JAX
SupervisedUNet.train_step in strict-parity mode (float32, unpacked, f32
statistics), from the same weights (models/transplant.py) and batches, in
both block modes.  On the CPU the port's steps run the plain versions of
the six kernels, forward and backward (the backward formulas of K4, K5, K6
and K2 as dx)."""
import numpy as np
import pytest
import torch

import jax

from smsut_tpu.config import Config as JConfig
from smsut_tpu.train.steps.supervised import SupervisedUNet as JSupervisedUNet
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.models.transplant import from_flax, to_flax
from smsut_tpu_torch.ops import block, conv3x3, instnorm
from smsut_tpu_torch.train.state import TrainState
from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

STEPS = 4
_CFG = dict(input_size=64, base_width=8, batch_size=2,
            compute_dtype="float32", num_iter_per_epoch=10, max_epoch=2)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's CPU steps share the process with XLA's thread pool; with
    torch's default of one thread per core the two oversubscribe the host
    and a step can take 50x longer.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """4 JAX steps from PRNGKey(0) on 4 seeded batches: the initial
    parameters, the batches, the losses and the final parameters."""
    rng = np.random.default_rng(11)
    batches = [{"img": rng.normal(size=(2, 64, 64, 1)).astype(np.float32),
                "msk": rng.integers(0, 5, size=(2, 64, 64)).astype(np.int32)}
               for _ in range(STEPS)]
    jalgo = JSupervisedUNet(JConfig(**_CFG, pack_levels=0,
                                    norm_stats="reduce"))
    state = jalgo.init_state(jax.random.PRNGKey(0))
    init = jax.device_get(state.params)
    losses = []
    for bt in batches:
        state, m = jalgo.train_step(state, bt, {})
        losses.append(float(m["loss"]))
    return init, batches, losses, dict(_flat(jax.device_get(state.params)))


@pytest.mark.parametrize("block_pallas", [False, True])
def test_train_steps_match_jax(reference, block_pallas):
    init, batches, want_losses, want = reference
    algo = SupervisedUNet(Config(**_CFG, block_pallas=block_pallas),
                          device="cpu")
    state = algo.state_from_params(from_flax(init))
    losses = []
    for bt in batches:
        state, m = algo.train_step(state, bt, {})
        losses.append(m["loss"].item())
    assert isinstance(state, TrainState) and state.step == STEPS
    np.testing.assert_allclose(losses, want_losses, rtol=2e-3, atol=2e-4)
    got = dict(_flat(to_flax(state.params)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=5e-3, atol=5e-4,
                                   err_msg=k)


def test_every_parameter_gets_a_gradient_without_a_launch():
    """One step's gradient reaches every parameter through the autograd
    ops; on the CPU no kernel is launched."""
    algo = SupervisedUNet(Config(**_CFG), device="cpu")
    counters = (instnorm.instance_norm_fwd, instnorm.instance_norm_bwd,
                conv3x3.conv3x3_fwd, conv3x3.conv3x3_dw,
                block.basic_block_fwd, block.basic_block_bwd)
    before = [c.launches for c in counters]
    rng = np.random.default_rng(3)
    batch = {"img": rng.normal(size=(2, 32, 32, 1)).astype(np.float32),
             "msk": rng.integers(0, 5, size=(2, 32, 32))}
    params = algo.init_params(seed=1)
    loss, grads = algo.value_and_grad(params, batch)
    assert grads.keys() == params.keys()
    for k, g in grads.items():
        assert g is not None and g.shape == params[k].shape, k
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, k
    assert [c.launches for c in counters] == before
    assert bool(torch.isfinite(loss))
