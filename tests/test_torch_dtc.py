# -*- coding: utf-8 -*-
"""The port's dual-task U-Net (smsut_tpu_torch/models/dtc.py) against the
JAX package's ``DTCUNet`` on the CPU, from the same weights
(models/transplant.py) and seeded numpy inputs: width 8, input 32, batch
2, in both configurations (batch norm with ReLU, the model's default, and
instance norm with leaky ReLU, also with ``block_fused``), the two heads'
outputs and every parameter's gradient of a loss over both heads.  Also
``batch_norm`` and ``NormAct("batch", "relu")`` alone against the flax
``BatchNorm`` and ``NormAct``, and ReLU's init gain."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.models import layers as jlayers
from smsut_tpu.models.dtc import DTCUNet as JDTCUNet
from smsut_tpu_torch.models import layers
from smsut_tpu_torch.models.dtc import DTCUNet
from smsut_tpu_torch.models.transplant import from_flax, to_flax
from torch_port_helpers import few_torch_threads, flat, rel_err, t

W, SIZE, BS = 8, 32, 2
# float32 forward: max |port - JAX| / max(1, max |JAX|); the gradient of
# each leaf the same against its own scale
FWD_TOL, GRAD_TOL = 1e-4, 1e-3
CONFIGS = [("batch", "relu", False), ("instance", "lrelu", False),
           ("instance", "lrelu", True)]

pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(BS, SIZE, SIZE, 1)).astype(np.float32)
    cot = [rng.normal(size=(BS, SIZE, SIZE, 2)).astype(np.float32)
           for _ in range(2)]
    return x, cot


@pytest.fixture(scope="module")
def reference(inputs):
    """Per (norm, act): the JAX params, both heads and the gradient of
    sum(out1 * c1) + sum(out2 * c2)."""
    x, (c1, c2) = inputs
    out = {}
    for norm, act in {(n, a) for n, a, _ in CONFIGS}:
        net = JDTCUNet(out_ch=2, width=W, norm_type=norm, act_type=act)
        p = jax.device_get(jax.jit(net.init)(jax.random.PRNGKey(0),
                                             jnp.asarray(x))["params"])

        def loss(p):
            o1, o2 = net.apply({"params": p}, jnp.asarray(x))
            return jnp.sum(o1 * c1) + jnp.sum(o2 * c2), (o1, o2)

        (_, heads), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(p)
        out[norm, act] = (p, jax.device_get(heads), jax.device_get(grads))
    return out


@pytest.mark.parametrize("norm,act,fused", CONFIGS)
def test_forward_and_gradient_match_jax(inputs, reference, norm, act, fused):
    x, (c1, c2) = inputs
    p, heads, grads = reference[norm, act]
    net = DTCUNet(2, W, norm_type=norm, act_type=act,
                  compute_dtype=torch.float32, block_fused=fused,
                  device="cpu")
    net.load_state_dict(from_flax(p))
    o1, o2 = net(t(x))
    assert o1.dtype == o2.dtype == torch.float32
    assert float(o1.abs().max()) <= 1.0   # the tanh head
    for g, w, name in ((o1, heads[0], "fc1"), (o2, heads[1], "fc2")):
        assert tuple(g.shape) == w.shape == (BS, SIZE, SIZE, 2)
        assert rel_err(g.detach(), t(w)) <= FWD_TOL, name
    ((o1 * t(c1)).sum() + (o2 * t(c2)).sum()).backward()
    got = dict(flat(to_flax({k: v.grad for k, v in net.named_parameters()})))
    want = dict(flat(grads))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert rel_err(t(got[k]), t(w)) <= GRAD_TOL, k


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_batch_norm_matches_flax(dt, rng):
    x = (1.5 + rng.normal(size=(2, 8, 8, 16))).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dt == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    scale = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    bias = (0.1 * rng.normal(size=16)).astype(np.float32)
    params = {"params": {"scale": scale, "bias": bias}}
    want = jlayers.BatchNorm(dtype=jdt).apply(params, jnp.asarray(x, jdt))
    got = layers.batch_norm(t(x, tdt), t(scale), t(bias))
    assert got.dtype == tdt
    assert rel_err(got, t(np.asarray(want, np.float32))) <= (
        1e-5 if dt == "float32" else 0.02)
    want = jlayers.NormAct("batch", "relu", jdt).apply(params,
                                                       jnp.asarray(x, jdt))
    mod = layers.NormAct(16, "relu", "batch")
    mod.load_state_dict({"weight": t(scale), "bias": t(bias)})
    got = mod(t(x, tdt))
    assert float(got.min()) == 0.0
    assert rel_err(got, t(np.asarray(want, np.float32))) <= (
        1e-5 if dt == "float32" else 0.02)


def test_norm_act_instance_relu_is_the_plain_math(rng):
    """Instance norm + ReLU: K1 without activation, then the ReLU (the
    JAX package's plain path for the pair)."""
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    params = {"params": {"scale": np.ones(16, np.float32),
                         "bias": np.full(16, 0.1, np.float32)}}
    want = jlayers.NormAct("instance", "relu").apply(params, jnp.asarray(x))
    mod = layers.NormAct(16, "relu", "instance")
    mod.load_state_dict({"weight": torch.ones(16),
                         "bias": torch.full((16,), 0.1)})
    assert rel_err(mod(t(x)), t(np.asarray(want))) <= 1e-5


def test_relu_init_gain():
    """Kaiming fan_out with ReLU's gain 2 (the leaky ReLU's is 2/1.0001)."""
    net = DTCUNet(2, W, device="cpu", seed=1)
    k = net.encoder.layer4.conv1.weight.detach()   # [3, 3, 4W, 8W]
    assert abs(float(k.std()) / np.sqrt(2.0 / (9 * 8 * W)) - 1) < 0.05
    tree = to_flax(net)
    assert {"fc1", "fc2"} <= tree["decoder"].keys()
    assert "fc" not in tree["decoder"]
