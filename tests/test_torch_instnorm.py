# -*- coding: utf-8 -*-
"""K1 (smsut_tpu_torch/ops/instnorm.py): the plain version against the JAX
Pallas kernel (ops/instnorm_pallas.py, interpret mode).  The CUDA kernel is
held against the plain version on the card in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smsut_tpu.ops import instnorm_pallas as inp
from smsut_tpu_torch.ops import instnorm
from torch_port_helpers import norm_params, t


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _inputs(rng, b=2, h=8, w=8, c=16):
    x = (rng.normal(size=(b, h, w, c)) * 2 + 0.3).astype(np.float32)
    return (x, *norm_params(rng, c))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.05)])
@pytest.mark.parametrize("act", [True, False])
def test_plain_matches_pallas(rng, act, dtype, tol):
    x, s, b = _inputs(rng)
    jfn = inp.instance_norm_lrelu if act else inp.instance_norm_affine
    want = np.asarray(jfn(jnp.asarray(x).astype(dtype), jnp.asarray(s),
                          jnp.asarray(b)).astype(jnp.float32))
    got = instnorm.instance_norm(t(x, getattr(torch, dtype)), t(s), t(b), act)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_statistics_match_pallas(rng):
    """mean and rstd, the residuals the TPU kernel emits for its backward."""
    x, s, b = _inputs(rng, c=8)
    _, jm, jr = inp._fwd_call(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    _, mean, rstd = instnorm.instance_norm_fwd(t(x), t(s), t(b), True)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm)[:, 0],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jr)[:, 0],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw,c", [(65536, 16), (65536, 8), (256, 256),
                                  (1024, 128), (16, 512), (7, 4)])
def test_splits_cover_every_row(hw, c):
    nsplit, rows = instnorm.splits(hw, c)
    assert 1 <= nsplit <= 256
    assert nsplit * rows >= hw > (nsplit - 1) * rows


def test_cpu_tensor_takes_plain_path_without_launch(rng):
    x, s, b = _inputs(rng)
    before = instnorm.instance_norm_fwd.launches
    instnorm.instance_norm(t(x), t(s), t(b), True)
    assert instnorm.instance_norm_fwd.launches == before

