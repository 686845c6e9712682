# -*- coding: utf-8 -*-
"""K2 and K5 (smsut_tpu_torch/ops/conv3x3.py): the plain forward, and the
backward of the autograd op (dx by K2 on the flipped kernel, dw by K5's
plain formula on the CPU), against the JAX Pallas conv (ops/conv_pallas.py,
interpret mode on the CPU) and XLA's conv.
The convs no kernel covers (5x5 stem, 1x1) are held against XLA's conv
too.  The CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda.py."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from smsut_tpu.ops import conv_pallas as cp
from smsut_tpu_torch.models.layers import conv_plain
from smsut_tpu_torch.ops import conv3x3
from torch_port_helpers import conv_w, t


def _xla_conv(x, w):
    k = w.shape[0]
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1), [(k // 2, k // 2)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC")))


def test_plain_matches_pallas(rng):
    x = rng.normal(size=(2, 16, 16, 64)).astype(np.float32)
    w = conv_w(rng, 3, 64, 64)
    want = np.asarray(cp.conv_same_pallas(jnp.asarray(x), jnp.asarray(w)))
    got = conv3x3.conv3x3(t(x), t(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("cin", [8, 16])
def test_backward_matches_pallas_vjp(rng, cin):
    """dx and dw against jax.vjp of ``conv_same_pallas`` (``_vjp_bwd``:
    ``_conv_fwd`` on the flipped kernel, ``_conv_dw``), float32."""
    x = rng.normal(size=(2, 12, 10, cin)).astype(np.float32)
    w = conv_w(rng, 3, cin, 16)
    g = rng.normal(size=(2, 12, 10, 16)).astype(np.float32)
    _, vjp = jax.vjp(cp.conv_same_pallas, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    xt, wt = t(x).requires_grad_(), t(w).requires_grad_()
    conv3x3.conv3x3(xt, wt).backward(t(g))
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), want_dw, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape,cout", [((2, 16, 16, 8), 16),
                                        ((1, 9, 7, 8), 32)])
def test_plain_matches_xla(rng, shape, cout):
    x = rng.normal(size=shape).astype(np.float32)
    w = conv_w(rng, 3, shape[-1], cout)
    np.testing.assert_allclose(conv3x3.conv3x3(t(x), t(w)).numpy(),
                               _xla_conv(x, w), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("k,cin,cout", [(5, 1, 8), (1, 16, 5)])
def test_library_convs_match_xla(rng, k, cin, cout):
    """The stem and 1x1 convs stay plain PyTorch (no TPU kernel either)."""
    x = rng.normal(size=(2, 12, 12, cin)).astype(np.float32)
    w = conv_w(rng, k, cin, cout)
    np.testing.assert_allclose(conv_plain(t(x), t(w)).numpy(),
                               _xla_conv(x, w), rtol=2e-4, atol=2e-4)

