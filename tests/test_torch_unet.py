# -*- coding: utf-8 -*-
"""The port's U-Net (smsut_tpu_torch/models/unet.py) against the JAX UNet
with the same weights carried across (models/transplant.py), and the exact
flax <-> torch parameter round trip."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.models import UNet as JUNet
from smsut_tpu_torch.models import UNet
from smsut_tpu_torch.models.transplant import from_flax, to_flax

W = 8


@pytest.fixture(scope="module")
def reference():
    """Strict-parity JAX UNet: unpacked, float32, f32 'reduce' statistics
    (the conftest fixture resets the statistics mode)."""
    net = JUNet(out_ch=5, width=W, norm_type="instance", act_type="lrelu",
                dtype=jnp.float32, pack_levels=0)
    x = np.random.default_rng(7).normal(size=(2, 64, 64, 1)).astype(np.float32)
    params = jax.device_get(net.init(jax.random.PRNGKey(0),
                                     jnp.asarray(x))["params"])
    return x, params, np.asarray(net.apply({"params": params}, jnp.asarray(x)))


@pytest.mark.parametrize("block_fused", [False, True])
def test_forward_matches_jax(reference, block_fused):
    x, params, want = reference
    net = UNet(5, W, compute_dtype=torch.float32, block_fused=block_fused,
               device="cpu")
    net.load_state_dict(from_flax(params))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-4)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_flax_round_trip_is_exact(reference):
    _, params, _ = reference
    back = dict(_flat(to_flax(from_flax(params))))
    orig = dict(_flat(params))
    assert back.keys() == orig.keys()
    for k, v in orig.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


def test_torch_round_trip_is_exact():
    net = UNet(5, W, compute_dtype=torch.float32, device="cpu", seed=3)
    state = net.state_dict()
    back = from_flax(to_flax(net))
    assert back.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(back[k], v), k


def test_init_matches_flax_tree_and_scale(reference):
    """The port's seeded init has the flax tree's paths and shapes, and the
    kaiming fan_out scale of its conv kernels."""
    _, params, _ = reference
    mine = dict(_flat(to_flax(UNet(5, W, device="cpu", seed=1))))
    ref = dict(_flat(params))
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in ref.items()}
    k = ("encoder", "layer4", "conv1", "kernel")   # [3, 3, 4W, 8W]
    std = np.sqrt(2.0 / (1 + 0.01 ** 2) / (9 * 8 * W))
    assert abs(mine[k].std() / std - 1) < 0.05
    assert abs(ref[k].std() / std - 1) < 0.05


def test_constructor_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UNet(5, W)
