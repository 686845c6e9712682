# -*- coding: utf-8 -*-
"""The port's DeviceAugment against the JAX package's: the packed
parameters bit for bit from one seed, and the warp (here on the CPU) against
``DeviceAugment._apply_impl`` on the same packed parameters -- image within
2e-3 (the bound of tests/test_device_augment.py's border test, on [-1, 1]),
masks equal (no exact rounding tie falls on these inputs; measured: image
within 3.4e-6, no mask pixel off)."""
import math
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.config import Config as JConfig
from smsut_tpu.data.device_augment import DeviceAugment as JDeviceAugment
from smsut_tpu.data.device_augment import _bilinear_gather, _nearest_gather
from smsut_tpu.data.synthetic import _make_volume
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.data.device_augment import (DeviceAugment,
                                                 cubic_resize_weights)

IMG_TOL = 2e-3

CASES = {
    "rotation": dict(elasticDeform=False, resizeCrop=False),
    "elastic": dict(rotate=False, resizeCrop=False),
    "crop": dict(rotate=False, elasticDeform=False),
    "all": dict(),
    "colour_gamma": dict(colorJitter=True, gammaCorrect=True),
    "identity": dict(rotate=False, elasticDeform=False, resizeCrop=False),
}


def _aug(size, **over):
    return dict(JConfig().data_aug, resizeCrop_size=size, **over)


def _pair(case, seed, size=64, out=48):
    aug = _aug(out, **CASES[case])
    j = JDeviceAugment(JConfig(input_size=size, data_aug=aug),
                       random.Random(seed))
    p = DeviceAugment(Config(input_size=size, data_aug=aug),
                      random.Random(seed), device="cpu")
    return j, p


def _batch(size=64, n=4):
    imgs, lbls = _make_volume(np.random.default_rng(1), n, size, 4)
    return imgs, lbls


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_params_bit_equal(case, seed):
    j, p = _pair(case, seed)
    for _ in range(3):
        want = j.sample_params_packed(4, 64, 64)
        got = p.sample_params_packed(4, 64, 64)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert p.rng.getstate() == j.rng.getstate()


@pytest.mark.parametrize("case", sorted(CASES))
def test_warp_matches_jax(case):
    imgs, lbls = _batch()
    j, p = _pair(case, 3)
    for _ in range(2):
        packed = j.sample_params_packed(4, 64, 64)
        p.sample_params_packed(4, 64, 64)          # keep the streams paired
        wi, wm = j._apply_impl(jnp.asarray(imgs), jnp.asarray(lbls),
                               jnp.asarray(packed))
        gi, gm = p.apply(torch.from_numpy(imgs), torch.from_numpy(lbls),
                         torch.from_numpy(packed))
        assert gi.shape == wi.shape == (4, 48, 48, 1)
        assert gi.dtype == torch.float32 and gm.dtype == torch.int64
        assert float(np.abs(gi.numpy() - np.asarray(wi)).max()) <= IMG_TOL
        assert np.array_equal(gm.numpy(), np.asarray(wm))
    if case == "identity":   # uint8 -> [-1, 1] only, resized 64 -> 48
        assert float(gi.min()) >= -1.0 and float(gi.max()) <= 1.0


def test_identity_at_full_size_is_the_normalisation():
    imgs, lbls = _batch(32)
    aug = _aug(32, **CASES["identity"])
    p = DeviceAugment(Config(input_size=32, data_aug=aug),
                      random.Random(0), device="cpu")
    gi, gm = p(imgs, lbls)
    want = (imgs.astype(np.float32) / 255.0 - 0.5) / 0.5
    np.testing.assert_allclose(gi[..., 0].numpy(), want, atol=1e-5)
    assert np.array_equal(gm.numpy(), lbls)


def test_border_band_matches_tapwise_gathers():
    """The packed gather against the JAX package's tap-wise gathers on the
    whole image, boundary band included (tests/test_device_augment.py's
    border test): identity crop, no elastic, three angles whose source
    corners reach row and column -1."""
    h = w = 32
    rng = np.random.default_rng(2020)
    img = (rng.random((h, w)) * 255).astype(np.uint8)
    msk = rng.integers(0, 5, (h, w)).astype(np.uint8)
    aug = _aug(32, **CASES["rotation"])
    p = DeviceAugment(Config(input_size=32, data_aug=aug), random.Random(0),
                      device="cpu")
    angles = (27.3, -63.0, 118.5)
    packed = np.zeros((3, 9 + 18), np.float32)
    packed[:, 0] = angles
    packed[:, 2:6] = (0.0, 0.0, h, w)
    packed[:, 6:9] = 1.0
    gi, gm = p.apply(torch.from_numpy(np.stack([img] * 3)),
                     torch.from_numpy(np.stack([msk] * 3)),
                     torch.from_numpy(packed))
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    for k, angle in enumerate(angles):
        theta = -angle * math.pi / 180.0
        cth, sth = math.cos(theta), math.sin(theta)
        ry, rx = yy - h / 2.0, xx - w / 2.0
        sy = h / 2.0 + (-sth * rx + cth * ry)
        sx = w / 2.0 + (cth * rx + sth * ry)
        want_i = np.asarray(_bilinear_gather(
            jnp.asarray(img, jnp.float32), jnp.asarray(sy), jnp.asarray(sx)))
        want_m = np.asarray(_nearest_gather(jnp.asarray(msk),
                                            jnp.asarray(sy), jnp.asarray(sx)))
        got_i = (gi[k, ..., 0].numpy() * 0.5 + 0.5) * 255.0
        np.testing.assert_allclose(got_i, want_i, atol=IMG_TOL)
        assert np.array_equal(gm[k].numpy(), want_m)


@pytest.mark.parametrize("n_in,n_out", [(3, 256), (3, 64), (4, 7)])
def test_cubic_weights_match_jax_resize(n_in, n_out):
    """The cubic weight matrix applied to a grid equals jax.image.resize
    (method "cubic") of it."""
    grid = np.random.default_rng(n_out).normal(size=(n_in, n_in)).astype(
        np.float32)
    wts = cubic_resize_weights(n_in, n_out)
    got = wts.T @ grid @ wts
    want = np.asarray(jax.image.resize(jnp.asarray(grid), (n_out, n_out),
                                       method="cubic"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
