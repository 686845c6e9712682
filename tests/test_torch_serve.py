# -*- coding: utf-8 -*-
"""Serving in the port (smsut_tpu_torch/serve.py): export -> load ->
predict against the JAX SupervisedUNet's eval_fn on the same weights, the
manifest's contract, and the refusal to run on the CPU unasked."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.config import Config as JConfig
from smsut_tpu.train.steps.supervised import SupervisedUNet as JSupervisedUNet
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.models.transplant import unet_from_flax
from smsut_tpu_torch.serve import MANIFEST, export_eval, load_serving
from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

_CFG = dict(input_size=32, base_width=4, batch_size=2, compute_dtype="float32")
# the fields of the JAX package's manifest (smsut_tpu/serve.py)
_JAX_FIELDS = {"artifact", "input", "output", "n_class", "modalities", "algo",
               "platforms"}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The JAX algorithm (its default config: packed levels, as trained)
    and its weights carried into a port export."""
    jalgo = JSupervisedUNet(JConfig(**_CFG))
    params = jax.device_get(jalgo.eval_params(
        jalgo.init_state(jax.random.PRNGKey(0))))
    cfg = Config(**_CFG)
    out = str(tmp_path_factory.mktemp("serving"))
    export_eval(SupervisedUNet(cfg, device="cpu"), unet_from_flax(params),
                cfg, out)
    return jalgo, params, cfg, out


def test_predict_matches_jax_eval(exported, rng):
    jalgo, params, _, out = exported
    predict, _ = load_serving(out, device="cpu")
    img = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    want = np.asarray(jalgo.eval_fn(params, jnp.asarray(img)))
    got = predict(img)
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-4)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.999


def test_manifest_keeps_the_jax_contract(exported):
    _, _, cfg, out = exported
    with open(os.path.join(out, MANIFEST)) as f:
        m = json.load(f)
    assert _JAX_FIELDS <= m.keys()
    assert m["input"] == {"name": "img", "shape": [2, 32, 32, 1],
                          "dtype": "float32",
                          "normalize": "(uint8/255 - 0.5) / 0.5"}
    assert m["output"] == {"name": "seg_logits", "shape": [2, 32, 32, 5],
                           "dtype": "float32", "postprocess": "argmax(-1)"}
    assert m["n_class"] == cfg.n_class
    assert m["modalities"] == ["ct", "t1in", "t1out", "t2"]
    assert m["algo"] == "SupervisedUNet"
    assert m["platforms"] == ["cuda", "cpu"]
    assert os.path.exists(os.path.join(out, m["artifact"]))


def test_predict_refuses_another_shape(exported):
    predict, _ = load_serving(exported[3], device="cpu")
    with pytest.raises(ValueError):
        predict(np.zeros((1, 32, 32, 1), np.float32))


def test_entry_points_raise_without_cuda(exported, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_serving(exported[3])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SupervisedUNet(exported[2])


def test_block_pallas_export_matches_unfused(exported, tmp_path, rng):
    """On the CPU both block modes run plain versions of the same math."""
    _, params, _, out = exported
    cfg = Config(**_CFG, block_pallas=True)
    export_eval(SupervisedUNet(cfg, device="cpu"), unet_from_flax(params),
                cfg, str(tmp_path))
    img = rng.normal(size=(2, 32, 32, 1)).astype(np.float32)
    fused = load_serving(str(tmp_path), device="cpu")[0](img)
    plain = load_serving(out, device="cpu")[0](img)
    torch.testing.assert_close(fused, plain, rtol=1e-4, atol=1e-5)
