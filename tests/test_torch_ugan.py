# -*- coding: utf-8 -*-
"""The GAN's layers, blocks and models against the JAX package's modules
(float32, unpacked), from the same weights (models/transplant.py):
``avg_pool2``, ``upsample_bilinear2`` (``jax.image.resize`` at x2, edges
included), ``Conv`` with a bias, ``BottleBlock``, the bilinear
``UpSampleAndConcat``, ``UGAN``, ``UGANnce`` (``netF`` with given
``patch_ids``) and ``Discriminator``; and the transplant's round trip.
Bounds from tests/test_ugan_parity.py and
tests/test_discriminator_parity.py: rtol 1e-3, atol 1e-4 (the
translation output atol 5e-4)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.models import blocks as jblocks
from smsut_tpu.models import layers as jlayers
from smsut_tpu.models import ugan as jugan
from smsut_tpu_torch.models.blocks import BottleBlock, UpSampleAndConcat
from smsut_tpu_torch.models.layers import Conv, avg_pool2, upsample_bilinear2
from smsut_tpu_torch.models.transplant import from_flax, to_flax
from smsut_tpu_torch.models.ugan import (UGAN, Discriminator, UGANnce,
                                         sample_patch_ids)

RTOL, ATOL, TSL_ATOL = 1e-3, 1e-4, 5e-4
F32 = torch.float32


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """XLA's thread pool shares the host; see tests/test_torch_train.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _init(module, *args):
    return jax.device_get(jax.jit(module.init)(jax.random.PRNGKey(0),
                                               *args)["params"])


def _load(module, params):
    state = from_flax(params)
    assert state.keys() == module.state_dict().keys()
    module.load_state_dict(state)
    return module


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=atol)


@pytest.mark.parametrize("shape", [(2, 6, 8, 3), (1, 7, 5, 2)])
def test_pool_and_upsample_match_jax(shape):
    x = _x(np.random.default_rng(0), shape)
    _close(avg_pool2(torch.from_numpy(x)), jlayers.avg_pool2(x))
    up = upsample_bilinear2(torch.from_numpy(x))
    assert up.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[3])
    _close(up, jlayers.upsample_bilinear2(x), atol=1e-6)


def test_conv_with_bias_matches_flax():
    rng = np.random.default_rng(1)
    x = _x(rng, (2, 5, 5, 8))
    jmod = jlayers.conv1x1(3, use_bias=True)
    params = _init(jmod, x)
    params["bias"] = _x(rng, (3,))
    mod = _load(Conv(8, 3, 1, use_bias=True), params)
    _close(mod(torch.from_numpy(x)), jmod.apply({"params": params}, x))


@pytest.mark.parametrize("cin,features,stride", [(8, 16, 2), (16, 16, 2),
                                                 (8, 16, 1)])
def test_bottle_block_matches_jax(cin, features, stride):
    x = _x(np.random.default_rng(2), (2, 8, 8, cin))
    jmod = jblocks.BottleBlock(features, "instance", "lrelu", stride=stride)
    params = _init(jmod, x)
    mod = _load(BottleBlock(cin, features, stride), params)
    _close(mod(torch.from_numpy(x)), jmod.apply({"params": params}, x))


def test_bilinear_up_and_concat_matches_jax():
    rng = np.random.default_rng(3)
    x, skip = _x(rng, (2, 4, 4, 16)), _x(rng, (2, 8, 8, 8))
    jmod = jblocks.UpSampleAndConcat(8, transposed=False)
    params = _init(jmod, x, skip)
    mod = _load(UpSampleAndConcat(16, 8, transposed=False), params)
    _close(mod(torch.from_numpy(x), torch.from_numpy(skip)),
           jmod.apply({"params": params}, x, skip))


@pytest.fixture(scope="module")
def ugan_case():
    rng = np.random.default_rng(4)
    x = _x(rng, (2, 32, 32, 1))
    m = np.eye(4, dtype=np.float32)[[1, 3]] - np.eye(4, dtype=np.float32)[0]
    ids = rng.permutation(4)[:3].astype(np.int32)
    jmod = jugan.UGANnce(out_ch=5, n_modal=4, width=8, netF_nc=16)
    params = _init(jmod, x, m, ids)
    return x, m, ids, jmod, params


def test_ugan_nce_matches_jax(ugan_case):
    x, m, ids, jmod, params = ugan_case
    seg_j, tsl_j, feat_j = jmod.apply({"params": params}, x, m, ids)
    mod = _load(UGANnce(5, 4, 8, 16, compute_dtype=F32, device="cpu"),
                params)
    with torch.no_grad():
        seg, tsl, feat = mod(torch.from_numpy(x), torch.from_numpy(m),
                             torch.from_numpy(ids).long())
        seg_v, tsl_v = mod(torch.from_numpy(x), val_phase=True)
    _close(seg, seg_j)
    _close(tsl, tsl_j, atol=TSL_ATOL)
    _close(feat, feat_j)
    seg_vj, tsl_vj = jmod.apply({"params": params}, x, val_phase=True)
    _close(seg_v, seg_vj)
    _close(tsl_v, tsl_vj, atol=TSL_ATOL)


def test_ugan_matches_jax(ugan_case):
    """UGAN is UGANnce's core: the same tree without netF."""
    x, m, _, _, params = ugan_case
    jmod = jugan.UGAN(out_ch=5, n_modal=4, width=8)
    core = {"core": params["core"]}
    seg_j, tsl_j = jmod.apply({"params": core}, x, m)
    mod = _load(UGAN(5, 4, 8, compute_dtype=F32, device="cpu"), core)
    with torch.no_grad():
        seg, tsl = mod(torch.from_numpy(x), torch.from_numpy(m))
    _close(seg, seg_j)
    _close(tsl, tsl_j, atol=TSL_ATOL)


@pytest.mark.parametrize("size,width,max_width", [(32, 8, 512),
                                                  (64, 16, 32)])
def test_discriminator_matches_jax(size, width, max_width):
    x = _x(np.random.default_rng(5), (3, size, size, 1))
    jmod = jugan.Discriminator(input_size=size, n_modal=4, width=width,
                               max_width=max_width)
    params = _init(jmod, x)
    params["stem"]["bias"] = 0.1 * _x(np.random.default_rng(6),
                                      (width,))
    src_j, cls_j = jmod.apply({"params": params}, x)
    mod = _load(Discriminator(size, 4, width, max_width, compute_dtype=F32,
                              device="cpu"), params)
    with torch.no_grad():
        src, cls = mod(torch.from_numpy(x))
    _close(src, src_j)
    _close(cls, cls_j)


def test_transplant_round_trip(ugan_case):
    _, _, _, _, params = ugan_case
    flat = lambda tree: dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    back = to_flax(from_flax(params))
    want, got = flat(params), flat(back)
    assert want.keys() == got.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v))


def test_sample_patch_ids():
    g = torch.Generator().manual_seed(0)
    ids = sample_patch_ids(g, 16, 5)
    assert ids.dtype == torch.int64 and len(set(ids.tolist())) == 5
    assert 0 <= int(ids.min()) and int(ids.max()) < 16
