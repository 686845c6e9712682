# -*- coding: utf-8 -*-
"""The port's SegFormer (smsut_tpu_torch/models/segformer.py) against the
flax modules of smsut_tpu/models/segformer.py on the CPU, from the same
weights (models/transplant.py) and seeded numpy inputs: the attention at
reduction ratios 8 (down to one key at input 32; a 12 x 12 map, which
flax's ``SAME`` pads) and 1, the Mix-FFN, the
patch embedding, the MiT encoder, and the whole net with and without a
mask (the JAX grid fed to the port), at inputs 32 and 64.  Bounds: float32
within 1e-5 of max(1, max |y|), bfloat16 within 0.05.  Also: a mask
changes only the rows in its range, the bilinear resize equals
``jax.image.resize``, and the transplant's round trip is exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.models import segformer as jseg
from smsut_tpu_torch.models import segformer as seg
from smsut_tpu_torch.models.transplant import from_flax, to_flax
from torch_port_helpers import flat, rel_err, t

F32_TOL, BF16_TOL = 1e-5, 0.05
DTYPES = {"float32": (jnp.float32, torch.float32, F32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _port(module, params):
    """``module`` holding the flax ``params``."""
    module.load_state_dict(from_flax(params))
    return module


def _check(got, want, tol, what=""):
    err = rel_err(got, torch.from_numpy(np.asarray(want, np.float32)))
    assert err <= tol, (what, err)


@pytest.mark.parametrize("sr,hw,heads", [(8, 8, 1), (8, 16, 1), (8, 12, 1),
                                         (1, 4, 2)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_attention(sr, hw, heads, dt, rng):
    jdt, tdt, tol = DTYPES[dt]
    dim = 32
    x = rng.normal(size=(2, hw * hw, dim)).astype(np.float32)
    m = jseg.EfficientAttention(dim, heads, sr, dtype=jdt)
    p = m.init(jax.random.PRNGKey(0), jnp.asarray(x, jdt), hw, hw)["params"]
    want = m.apply({"params": p}, jnp.asarray(x, jdt), hw, hw)
    port = _port(seg.EfficientAttention(dim, heads, sr), p)
    got = port(t(x, tdt), hw, hw)
    assert got.dtype == tdt
    _check(got, want.astype(jnp.float32), tol, f"sr {sr} hw {hw}")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mix_ffn(dt, rng):
    jdt, tdt, tol = DTYPES[dt]
    x = rng.normal(size=(2, 64, 32)).astype(np.float32)
    m = jseg.MixFFN(32, dtype=jdt)
    p = m.init(jax.random.PRNGKey(1), jnp.asarray(x, jdt), 8, 8)["params"]
    want = m.apply({"params": p}, jnp.asarray(x, jdt), 8, 8)
    got = _port(seg.MixFFN(32), p)(t(x, tdt), 8, 8)
    _check(got, want.astype(jnp.float32), tol)


@pytest.mark.parametrize("patch,stride", [(7, 4), (3, 2)])
def test_patch_embed(patch, stride, rng):
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    m = jseg.OverlapPatchEmbed(32, patch, stride)
    p = m.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    want, h, w = m.apply({"params": p}, jnp.asarray(x))
    got, gh, gw = _port(seg.OverlapPatchEmbed(3, 32, patch, stride), p)(t(x))
    assert (gh, gw) == (h, w)
    _check(got, want, F32_TOL)


@pytest.mark.parametrize("size", [64])
def test_mit_encoder(size, rng):
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    m = jseg.MixVisionTransformer()
    p = jax.jit(m.init)(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    want = jax.jit(m.apply)({"params": p}, jnp.asarray(x))
    got = _port(seg.MixVisionTransformer(), p)(t(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for k, (g, w) in enumerate(zip(got, want)):
        _check(g, w, F32_TOL, f"stage {k + 1}")


@pytest.fixture(scope="module")
def jparams():
    """The JAX net's parameters (float32 whatever the compute dtype, and
    the same at every input size), initialised once."""
    jnet = jseg.LinearFusionMaskedConsistencyMixBatch(num_classes=5)
    return jax.device_get(jax.jit(jnet.init)(jax.random.PRNGKey(4),
                                             jnp.zeros((1, 32, 32, 3)))
                          ["params"])


def _net(dt, params):
    """The JAX net's ``apply`` (jitted) and the port's net, in ``dt``."""
    jdt, tdt, _ = DTYPES[dt]
    jnet = jseg.LinearFusionMaskedConsistencyMixBatch(num_classes=5,
                                                      dtype=jdt)
    net = seg.LinearFusionMaskedConsistencyMixBatch(5, compute_dtype=tdt,
                                                    device="cpu")
    return (jax.jit(jnet.apply, static_argnames=(
        "mask", "range_batches_to_mask")), _port(net, params))


def _grid(key, b, size):
    """The JAX model's mask draw (its ``mask_rng`` use), on the host."""
    return np.asarray(jax.random.bernoulli(key, 0.5,
                                           (b, size // 16, size // 16)))


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_whole_net(size, dt, masked, rng, jparams):
    _, _, tol = DTYPES[dt]
    apply, net = _net(dt, jparams)
    x = rng.normal(size=(4, size, size, 3)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    if masked:
        want = apply({"params": jparams}, jnp.asarray(x), mask=True,
                     range_batches_to_mask=(2, 4), mask_rng=key)
        got = net(t(x), torch.from_numpy(_grid(key, 4, size)), (2, 4))
    else:
        want = apply({"params": jparams}, jnp.asarray(x))
        got = net(t(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _check(got, want, tol, f"{size} {dt} masked={masked}")


def test_mask_changes_only_the_rows_in_range(rng, jparams):
    _, net = _net("float32", jparams)
    x = t(rng.normal(size=(4, 64, 64, 3)).astype(np.float32))
    grid = torch.ones(4, 4, 4)
    plain = net.backbone(x)
    masked = net.backbone(x, net.mask_map(grid, (2, 4), 64, 64))
    for a, b in zip(plain, masked):
        assert torch.equal(a[:2], b[:2])
        assert not torch.allclose(a[2:], b[2:])
    m = net.mask_map(torch.from_numpy(_grid(jax.random.PRNGKey(0), 4, 64)),
                     (2, 4), 64, 64)
    assert m.shape == (4, 16, 16) and float(m[:2].abs().sum()) == 0.0
    assert 0 < float(m[2:].mean()) < 1


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_resize_matches_jax(factor, rng):
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = jax.image.resize(x, (2, 5 * factor, 7 * factor, 3), "bilinear")
    got = seg.resize_bilinear(t(x), 5 * factor, 7 * factor)
    _check(got, want, 1e-6)


def test_transplant_round_trip_is_exact(jparams):
    p = jparams
    _, net = _net("float32", p)
    tree = to_flax(net)
    want, got = dict(flat(p)), dict(flat(tree))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape and np.array_equal(got[k], w), k
    assert tree["backbone"]["stage1_block0"]["ffn"]["dwconv"]["kernel"] \
        .shape == (3, 3, 1, 128)
    assert tree["backbone"]["stage1_block0"]["attn"]["sr"]["kernel"].shape \
        == (8, 8, 32, 32)
    assert {"mask_token"} <= tree["backbone"].keys()
    assert {"fuse_scale", "fuse_bias"} <= tree.keys()
    assert net.state_dict().keys() == from_flax(tree).keys()
