# -*- coding: utf-8 -*-
"""The port's host metrics against the JAX package's: volume Dice, ASSD,
Hausdorff distance, connected components, the modality x organ matrices
(with the "HD slot = dice" quirk and with ``real_hd``) and their CSV --
exactly equal, on the golden fixture and on random volumes."""
import os

import numpy as np
import pytest

from smsut_tpu.config import Config as JConfig
from smsut_tpu.ops import metrics as jm
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.ops import metrics as pm


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                "metric_golden.npz"))


def test_volume_metrics_match_jax_on_golden(golden):
    cases = sorted({k.rsplit("__", 1)[0] for k in golden.files})
    for name in cases:
        p, g = golden[f"{name}__pred"], golden[f"{name}__gt"]
        assert pm.dice_coefficient(p, g) == jm.dice_coefficient(p, g), name
        assert pm.dice_coefficient(p, g) == pytest.approx(
            float(golden[f"{name}__dc"]), abs=1e-9)
        if p.any() and g.any():
            assert pm.assd_metric(p, g) == jm.assd_metric(p, g), name
            assert pm.hd_metric(p, g) == jm.hd_metric(p, g), name


def _volumes(seed, n_vol=3, shape=(6, 24, 24)):
    """Blobby label volumes and noisy predictions of them, per modality."""
    rng = np.random.default_rng(seed)
    gts, prds = {}, {}
    for m in ("ct", "t1in", "t1out", "t2"):
        for v in range(n_vol):
            z, y, x = np.mgrid[:shape[0], :shape[1], :shape[2]]
            g = np.zeros(shape, np.uint8)
            for organ in range(1, 5):
                c = rng.integers(4, 20, 2)
                r = rng.integers(3, 7)
                g[(y - c[0]) ** 2 + (x - c[1]) ** 2 < r ** 2] = organ
            p = g.copy()
            flip = rng.random(shape) < 0.08
            p[flip] = rng.integers(0, 5, int(flip.sum()))
            if v == 1:
                p[p == 3] = 0          # a class the prediction misses
            key = f"{m}_{str(v + 1).rjust(3, '0')}"
            gts[key], prds[key] = g, p
    return prds, gts


def test_connected_components_match_jax():
    prds, _ = _volumes(1)
    for k, p in prds.items():
        assert np.array_equal(pm.connected_components(p, 4),
                              jm.connected_components(p, 4)), k


@pytest.mark.parametrize("real_hd", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_matrices_and_csv_match_jax(seed, real_hd):
    prds, gts = _volumes(seed)
    pcfg, jcfg = Config(real_hd=real_hd), JConfig(real_hd=real_hd)
    mo_p, mo_j = pm.get_mo_matrix(prds, gts, pcfg), jm.get_mo_matrix(prds, gts,
                                                                     jcfg)
    assert mo_p.shape == (5, 5) and np.array_equal(mo_p, mo_j)
    allp = pm.get_all_matrix(prds, gts, pcfg)
    allj = jm.get_all_matrix(prds, gts, jcfg)
    for a, b in zip(allp, allj):
        assert np.array_equal(a, b)
    if not real_hd:   # the reference's quirk: its HD slot holds the dice
        assert np.array_equal(allp[1], allp[0])
    assert pm.matrix_to_csv(mo_p, allp[2]) == jm.matrix_to_csv(mo_j, allj[2])
