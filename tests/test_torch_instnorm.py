# -*- coding: utf-8 -*-
"""K1 and K4 (smsut_tpu_torch/ops/instnorm.py): the plain forward and the
plain backward (run by the autograd op on a CPU tensor) against the JAX
Pallas kernels (ops/instnorm_pallas.py, interpret mode).  The CUDA kernels
are held against the plain versions on the card in
tests/test_torch_cuda.py."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.ops import instnorm_pallas as inp
from smsut_tpu_torch.ops import block, instnorm
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


@pytest.fixture(scope="module")
def plan_binary(tmp_path_factory):
    from test_torch_cuda_emu import _build

    return _build(tmp_path_factory, "instnorm")


@pytest.mark.parametrize("hw,c", [(65536, 16), (65536, 8), (256, 256),
                                  (1024, 128), (16, 512), (7, 4)])
def test_splits_cover_every_row(plan_binary, hw, c):
    """The plans the card would take (csrc/instnorm.cuh ``norm_plan``: K1,
    K4 and K6's two sums passes, float32 and bfloat16, batch 1 and 8, at the
    card's fill) cut a map of ``hw`` pixels and ``c`` channels into blocks
    that cover every pixel and channel once, compiled for the CPU with
    tests/cuda_emu (tests/test_torch_norm_emu.py runs the kernels)."""
    from test_torch_cuda_emu import _run

    lines = _run(plan_binary, {"EMU_PLAN": f"{hw},{c}"})
    assert sum(" covers 1" in l for l in lines) == 12


def test_ticket_words_match_the_kernels():
    """The tickets the wrapper keeps per stream (``tickets``) are as many
    words as the sums passes index: csrc/instnorm.cuh kNormTickets + 1."""
    src = (Path(__file__).resolve().parents[1] / "smsut_tpu_torch" / "csrc"
           / "instnorm.cuh").read_text()
    n = re.search(r"constexpr int kNormTickets = (\d+);", src)
    assert n and instnorm.TICKET_WORDS == int(n.group(1)) + 1


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 0.05)])
@pytest.mark.parametrize("c", [3, 12])
def test_plain_matches_fwd_call_at_any_channels(rng, c, dtype, tol):
    """K1's plain version at channel counts the vector path does not take
    (the scalar path on the card) against the Pallas ``_fwd_call``: y, and
    mean and rstd in float32."""
    x, s, b = _inputs(rng, b=2, h=6, w=5, c=c)
    jy, jm, jr = inp._fwd_call(jnp.asarray(x).astype(dtype), jnp.asarray(s),
                               jnp.asarray(b))
    y, mean, rstd = instnorm.instance_norm_plain(t(x, getattr(torch, dtype)),
                                                 t(s), t(b), True)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm)[:, 0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jr)[:, 0], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.05)])
@pytest.mark.parametrize("c", [3, 12])
def test_plain_bwd_matches_bwd_call_at_any_channels(rng, c, dtype, tol):
    """K4's plain version against the Pallas ``_bwd_call`` from the same
    residuals, with the leaky ReLU: dx in x's dtype, dscale and dbias."""
    x, s, b = _inputs(rng, b=2, h=6, w=5, c=c)
    g = rng.normal(size=x.shape).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    _, jm, jr = inp._fwd_call(jx, jnp.asarray(s), jnp.asarray(b))
    want = inp._bwd_call((jx, jnp.asarray(s), jnp.asarray(b), jm, jr),
                         jnp.asarray(g).astype(dtype), inp.NEG_SLOPE)
    tdt = getattr(torch, dtype)
    got = instnorm.instance_norm_bwd_plain(
        t(x, tdt), t(g, tdt), torch.from_numpy(np.array(jm)[:, 0]),
        torch.from_numpy(np.array(jr)[:, 0]), t(s), t(b), True)
    assert got[0].dtype == tdt
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("act", [True, False])
def test_backward_matches_pallas_vjp(rng, act):
    """dx, dscale, dbias of the autograd op (K4's plain formula on the CPU)
    against jax.vjp of the Pallas op (``_bwd_call``), float32."""
    x, s, b = _inputs(rng, c=8)
    g = rng.normal(size=x.shape).astype(np.float32)
    jfn = inp.instance_norm_lrelu if act else inp.instance_norm_affine
    _, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    xt, st, bt = (t(a).requires_grad_() for a in (x, s, b))
    instnorm.instance_norm(xt, st, bt, act).backward(t(g))
    for got, w in zip((xt.grad, st.grad, bt.grad), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-5)


def test_double_backward_raises(rng):
    """A gradient of a gradient (the discriminator's WGAN-GP penalty)
    through the instance norm agrees with JAX's; the op that raises on it
    is the fused block (K3/K6, once differentiable), not the norm."""
    x, s, b = _inputs(rng)
    xt = t(x).requires_grad_()
    out = instnorm.instance_norm(xt, t(s), t(b), True)
    (gx,) = torch.autograd.grad((out * out).sum(), xt, create_graph=True)
    gx.sum().backward()

    def jgrad_sum(xj):
        f = lambda a: jnp.sum(jnp.square(inp.instance_norm_lrelu_reference(
            a, jnp.asarray(s), jnp.asarray(b))))
        return jnp.sum(jax.grad(f)(xj))

    want = np.asarray(jax.grad(jgrad_sum)(jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    w1, w2, ws = (t(0.1 * rng.normal(size=(k, k, ci, 16)).astype(
        np.float32)).requires_grad_() for k, ci in ((3, 8), (3, 16), (1, 8)))
    ones, zeros = torch.ones(16), torch.zeros(16)
    y = block.basic_block(t(rng.normal(size=(1, 4, 4, 8)).astype(np.float32)),
                          w1, ones, zeros, w2, ones, zeros, ws, ones, zeros)
    with pytest.raises(RuntimeError, match="once differentiable"):
        torch.autograd.grad(y.sum(), w1, create_graph=True)


def test_cpu_tensor_takes_plain_path_without_launch(rng):
    x, s, b = _inputs(rng)
    counters = (instnorm.instance_norm_fwd, instnorm.instance_norm_bwd)
    before = [c.launches for c in counters]
    xt = t(x).requires_grad_()
    instnorm.instance_norm(xt, t(s), t(b), True).sum().backward()
    assert [c.launches for c in counters] == before

