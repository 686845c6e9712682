# -*- coding: utf-8 -*-
"""Serving export: save a model's eval parameters with a manifest, and load
them back as a ``predict`` function, for every algorithm of the port
(:func:`factories`: the U-Net, Mean Teacher's student, cross-pseudo
supervision's net 1, CoraNet's head 0, M3L's SegFormer student, the UGAN
family's segmentation logits; :func:`_seg_logits_fn` as in the JAX
package's ``serve.py``).

The manifest keeps the I/O contract of the JAX package's ``serve.py``,
``algo`` the algorithm's class name.
Input: ``img`` float32 [B, input_size, input_size, 1], already
ToTensor+Normalize(0.5, 0.5) normalised to [-1, 1].  Output: float32 seg
logits [B, H, W, n_class] (argmax -> label map).

Unlike the JAX package's StableHLO artifact, which runs without the model
code, this artifact is the parameter file plus the manifest: ``load_serving``
rebuilds the model from the manifest, so serving it needs this package.
On the card ``predict`` replays a CUDA graph of the forward at the
manifest's one input shape (train/graphs.py ``Replay``; the first request
warms it, the second captures it); ``load_serving(..., capture=False)``
runs the forward eagerly.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.device import resolve_device
from smsut_tpu_torch.train.graphs import Replay

ARTIFACT = "params.pt"
MANIFEST = "manifest.json"
PLATFORMS = ("cuda", "cpu")


def factories() -> Dict[str, Tuple[str, Callable]]:
    """Zoo name (tools/export_serving.py's MODEL) -> (the class name,
    which the manifest holds as ``algo``, and ``factory(cfg, device)``) of
    every servable algorithm (CoraNet's stage B reads head 0, as its test
    phase does)."""
    from smsut_tpu_torch.train.steps.coranet import CoraNet
    from smsut_tpu_torch.train.steps.cross_pseudo import CrossPseudo
    from smsut_tpu_torch.train.steps.gan import (UGANConsisAlgo, UGANShp0Algo,
                                                 UGANTrainerAlgo)
    from smsut_tpu_torch.train.steps.m3l import M3L
    from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    out = {name: (c.__name__, c) for name, c in (
        ("unet", SupervisedUNet), ("meanTeacher", MeanTeacher),
        ("crossPse", CrossPseudo), ("M3L", M3L), ("ugan", UGANTrainerAlgo),
        ("uganShp0", UGANShp0Algo), ("uganConsis", UGANConsisAlgo))}
    out["coraNet"] = ("CoraNet", lambda cfg, device: CoraNet(
        cfg, device, stage="cora"))
    return out


def _by_class() -> Dict[str, Callable]:
    """Class name -> factory, of :func:`factories`."""
    return dict(factories().values())


def _seg_logits_fn(algo) -> Callable:
    """The algorithm's eval forward reduced to bare segmentation logits
    (an eval_fn that returns a tuple serves its first element)."""

    def fn(params, img):
        out = algo.eval_fn(params, img)
        return out[0] if isinstance(out, tuple) else out

    return fn


# the Config knobs of the forward's layout a manifest carries
_LAYOUT = ("pack_levels", "pack_mode", "d_pack_mode", "pair_towers",
           "pack_w0", "d_pack_deep")


def export_eval(algo, params: Any, cfg: Config, out_dir: str,
                batch_size: int = 0) -> str:
    """Write ``params`` (the algorithm's ``eval_params``) and the manifest
    to ``out_dir``; return the parameter file's path.  ``batch_size``
    defaults to cfg.batch_size."""
    if type(algo).__name__ not in _by_class():
        raise NotImplementedError(f"serving {type(algo).__name__}: not one "
                                  f"of {sorted(_by_class())}")
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
                      "block_pallas": bool(cfg.block_pallas),
                      "n_modal": cfg.n_modal, "netF_nc": cfg.netF_nc,
                      # the layout the forward runs in (the same weights
                      # at any): the packed levels, their packing and the
                      # tower pairing
                      **{k: getattr(cfg, k) for k in _LAYOUT}},
        }, f, indent=2)
    return path


def load_serving(out_dir: str,
                 device: Optional[Union[str, torch.device]] = None,
                 capture: bool = True) -> Tuple[Callable, dict]:
    """Load an exported model; returns (predict, manifest).

    ``predict(img) -> seg logits`` takes a float32 array or tensor of the
    manifest's input shape and returns a float32 tensor on ``device``: the
    card unless ``device`` names another (no CUDA and no device raises).
    ``capture=False`` runs the forward eagerly on the card."""
    device = resolve_device(device)
    with open(os.path.join(out_dir, MANIFEST)) as f:
        manifest = json.load(f)
    factory = _by_class().get(manifest["algo"])
    if factory is None:
        raise NotImplementedError(f"serving {manifest['algo']}: not one of "
                                  f"{sorted(_by_class())}")
    shape = manifest["input"]["shape"]
    m = manifest["model"]
    cfg = Config(input_size=shape[1], batch_size=shape[0],
                 img_channels=m["img_channels"], base_width=m["base_width"],
                 n_label=manifest["n_class"] - 1,
                 compute_dtype=m["compute_dtype"],
                 block_pallas=m["block_pallas"],
                 **{k: m[k] for k in ("n_modal", "netF_nc", *_LAYOUT)
                    if k in m})
    algo = factory(cfg, device)
    params = algo.eval_params(torch.load(
        os.path.join(out_dir, manifest["artifact"]), map_location="cpu",
        weights_only=True))
    seg = _seg_logits_fn(algo)

    forward = Replay(lambda inp: {"logits": seg(params, inp["img"])},
                     device, capture)

    def predict(img) -> torch.Tensor:
        if list(img.shape) != shape:
            raise ValueError(f"input shape {list(img.shape)} != the "
                             f"manifest's {shape}")
        logits = forward({"img": torch.as_tensor(img, dtype=torch.float32)})
        # a replay's output is the graph's buffer, which the next overwrites
        return logits["logits"].clone() if forward.captures else \
            logits["logits"]

    return predict, manifest
