# -*- coding: utf-8 -*-
"""Serving export: save a model's eval parameters with a manifest, and load
them back as a ``predict`` function.

The manifest keeps the I/O contract of the JAX package's ``serve.py``.
Input: ``img`` float32 [B, input_size, input_size, 1], already
ToTensor+Normalize(0.5, 0.5) normalised to [-1, 1].  Output: float32 seg
logits [B, H, W, n_class] (argmax -> label map).

Unlike the JAX package's StableHLO artifact, which runs without the model
code, this artifact is the parameter file plus the manifest: ``load_serving``
rebuilds the model from the manifest, so serving it needs this package.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional, Tuple, Union

import torch

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.device import resolve_device

ARTIFACT = "params.pt"
MANIFEST = "manifest.json"
PLATFORMS = ("cuda", "cpu")


def export_eval(algo, params: Any, cfg: Config, out_dir: str,
                batch_size: int = 0) -> str:
    """Write ``params`` and the manifest to ``out_dir``; return the
    parameter file's path.  ``batch_size`` defaults to cfg.batch_size."""
    if type(algo).__name__ != "SupervisedUNet":
        raise NotImplementedError(f"serving {type(algo).__name__} is not "
                                  f"ported yet")
    bs = batch_size or cfg.batch_size
    hw = cfg.input_size
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, ARTIFACT)
    torch.save({k: v.detach().float().cpu() for k, v in params.items()}, path)
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump({
            "artifact": ARTIFACT,
            "input": {"name": "img", "shape": [bs, hw, hw, cfg.img_channels],
                      "dtype": "float32",
                      "normalize": "(uint8/255 - 0.5) / 0.5"},
            "output": {"name": "seg_logits",
                       "shape": [bs, hw, hw, cfg.n_class],
                       "dtype": "float32", "postprocess": "argmax(-1)"},
            "n_class": cfg.n_class,
            "modalities": list(cfg.mod_type),
            "algo": type(algo).__name__,
            "platforms": list(PLATFORMS),
            "model": {"base_width": cfg.base_width,
                      "img_channels": cfg.img_channels,
                      "compute_dtype": cfg.compute_dtype,
                      "block_pallas": bool(cfg.block_pallas)},
        }, f, indent=2)
    return path


def load_serving(out_dir: str,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Tuple[Callable, dict]:
    """Load an exported model; returns (predict, manifest).

    ``predict(img) -> seg logits`` takes a float32 array or tensor of the
    manifest's input shape and returns a float32 tensor on ``device``: the
    card unless ``device`` names another (no CUDA and no device raises)."""
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    device = resolve_device(device)
    with open(os.path.join(out_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["algo"] != "SupervisedUNet":
        raise NotImplementedError(f"serving {manifest['algo']} is not "
                                  f"ported yet")
    shape = manifest["input"]["shape"]
    m = manifest["model"]
    cfg = Config(input_size=shape[1], batch_size=shape[0],
                 img_channels=m["img_channels"], base_width=m["base_width"],
                 n_label=manifest["n_class"] - 1,
                 compute_dtype=m["compute_dtype"],
                 block_pallas=m["block_pallas"])
    algo = SupervisedUNet(cfg, device)
    params = algo.eval_params(torch.load(
        os.path.join(out_dir, manifest["artifact"]), map_location="cpu",
        weights_only=True))

    def predict(img) -> torch.Tensor:
        if list(img.shape) != shape:
            raise ValueError(f"input shape {list(img.shape)} != the "
                             f"manifest's {shape}")
        return algo.eval_fn(params, img)

    return predict, manifest
