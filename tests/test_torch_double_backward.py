# -*- coding: utf-8 -*-
"""The second order of the port's autograd ops, on the CPU: ``conv3x3``
(``_Conv3x3`` with ``_Conv3x3Dw``) and ``instance_norm``
(``_InstanceNorm`` with ``_InstanceNormBwd``), with and without the
fused lrelu, against JAX's ``jax.grad`` of a gradient norm through
``lax.conv_general_dilated`` and ``instance_norm_lrelu_reference`` (XLA
computes the discriminator's gradient penalty in the JAX package; no
Pallas kernel does).  Bound: rtol 1e-4, atol 1e-5 of max(1, max |want|)
per tensor.  And
``torch.autograd.gradgradcheck`` in float64 on the plain versions, which
accumulate float64 in float64.

The penalty is sum(dx^2) (+ sum(dw^2), + the norm parameters' gradients)
of the first-order gradients of sum(sin(f(x)) * c), so that every
second-order term is non-zero."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.ops.instnorm_pallas import EPS
from smsut_tpu.ops.instnorm_pallas import (
    instance_norm_lrelu_reference as j_norm_lrelu)
from smsut_tpu_torch.ops.conv3x3 import conv3x3
from smsut_tpu_torch.ops.instnorm import instance_norm
from torch_port_helpers import conv_w, norm_params

RTOL, ATOL = 1e-4, 1e-5


def j_conv(x, w):
    return jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST)


def j_norm(x, scale, bias, act):
    if act:
        return j_norm_lrelu(x, scale, bias)
    mean = jnp.mean(x, axis=(1, 2), keepdims=True)
    var = jnp.mean(jnp.square(x), axis=(1, 2), keepdims=True) - mean ** 2
    return (x - mean) * jax.lax.rsqrt(var + EPS) * scale + bias


def j_penalty_grads(f, args, c):
    """jax.grad of the squared norm of the first-order gradients of
    sum(sin(f(*args)) * c) in every argument."""
    n = len(args)
    first = jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a)) * c),
                     argnums=tuple(range(n)))
    pen = lambda *a: sum(jnp.sum(jnp.square(g)) for g in first(*a))
    return jax.grad(pen, argnums=tuple(range(n)))(*args)


def t_penalty_grads(f, args, c):
    leaves = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    y = f(*leaves)
    first = torch.autograd.grad((torch.sin(y) * torch.from_numpy(c)).sum(),
                                leaves, create_graph=True)
    pen = sum(g.square().sum() for g in first)
    return torch.autograd.grad(pen, leaves)


def _check(got, want):
    """|got - want| <= RTOL |want| + ATOL max(1, max |want|) per tensor:
    the second-order sums reach 1e2 here, and float32 summation order
    moves an element near zero by a few 1e-6 of the tensor's scale."""
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("shape,cout", [((2, 8, 8, 4), 8),
                                        ((1, 6, 10, 16), 16)])
def test_conv3x3_second_order_matches_jax(shape, cout):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    w = conv_w(rng, 3, shape[-1], cout, std=0.3)
    c = rng.standard_normal(shape[:3] + (cout,)).astype(np.float32)
    got = t_penalty_grads(conv3x3, (x, w), c)
    want = j_penalty_grads(j_conv, (x, w), c)
    _check(got, want)


@pytest.mark.parametrize("act", [False, True])
def test_instance_norm_second_order_matches_jax(act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 7, 5)).astype(np.float32)
    s, b = norm_params(rng, 5)
    c = rng.standard_normal(x.shape).astype(np.float32)
    before = instance_norm.double_backward
    got = t_penalty_grads(lambda x, s, b: instance_norm(x, s, b, act),
                          (x, s, b), c)
    assert instance_norm.double_backward == before + 1
    want = j_penalty_grads(lambda x, s, b: j_norm(x, s, b, act), (x, s, b),
                           c)
    _check(got, want)


@pytest.mark.parametrize("which", ["conv", "norm", "norm_lrelu"])
def test_gradgradcheck_float64(which):
    """gradgradcheck of the plain versions (on the CPU the ops run them);
    the norm's check holds its inputs away from the lrelu's kink."""
    g = torch.Generator().manual_seed(0)
    if which == "conv":
        fn = conv3x3
        args = (torch.randn((2, 5, 6, 3), generator=g, dtype=torch.float64),
                torch.randn((3, 3, 3, 4), generator=g, dtype=torch.float64))
    else:
        act = which == "norm_lrelu"
        fn = lambda x, s, b: instance_norm(x, s, b, act)
        args = (torch.randn((2, 5, 6, 4), generator=g, dtype=torch.float64),
                1 + 0.1 * torch.randn(4, generator=g, dtype=torch.float64),
                0.1 * torch.randn(4, generator=g, dtype=torch.float64))
    args = tuple(a.requires_grad_() for a in args)
    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)

