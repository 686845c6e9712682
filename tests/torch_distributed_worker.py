# -*- coding: utf-8 -*-
"""One rank of the port's data-parallel tests (tests/test_torch_distributed.py).

Joins a gloo group on the CPU from the ``SMSUT_*`` contract, runs every
mode of ``SMSUT_MODES`` in turn and writes ``{mode}.{rank}.json`` into
``SMSUT_DIST_DIR``, where the parent also left its inputs (``gan.npz``,
the synthetic tree ``data/``).  Imports the port only, never JAX.

Modes (the parent holds each against one process):

- ``step``: 5 steps of ``SupervisedUNet`` (w4, 64x64, global batch 8) on
  the rank's rows, a checkpoint after step 3 (rank 0 writes);
- ``gan``: one ``uganConsis`` step on the parent's batch and draws;
- ``fit``: the Trainer's fit at ``steps_per_dispatch=2`` with device
  augmentation on the synthetic tree, through the sharded loaders;
- ``pseudo``: CoraNet's pseudo set and three pseudo batches;
- ``eval``: the eval sweep, scanned and per batch;
- ``refuse``: the knobs a group of 2 refuses, and what it once refused
  (the space axis with the fused block kernels, algorithms).
"""
import hashlib
import json
import os
import random
import sys
import traceback

import numpy as np
import torch

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.parallel import distributed

OUT = os.environ.get("SMSUT_DIST_DIR", "")
AUG32 = dict(Config().data_aug, resizeCrop_size=32)


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def tree_sha(tree) -> str:
    return sha(*(tree[k].detach().cpu().numpy() for k in sorted(tree)))


def checksum(tree) -> float:
    return float(sum(float(v.detach().abs().sum()) for v in tree.values()))


def step_batch(global_batch: int = 8, size: int = 64, n_class: int = 5):
    """A seeded batch whose second half holds no label 1 or 2, so that
    the batch Dice of either half alone differs from the whole batch's."""
    rng = np.random.default_rng(0)
    img = rng.normal(size=(global_batch, size, size, 1)).astype(np.float32)
    msk = rng.integers(0, n_class, size=(global_batch, size, size)
                       ).astype(np.int32)
    return img, halves_differ(msk)


def halves_differ(msk: np.ndarray) -> np.ndarray:
    """``msk`` with labels 1 and 2 cleared in its second half of rows."""
    half = msk[msk.shape[0] // 2:]
    half[(half == 1) | (half == 2)] = 0
    return msk


def step_cfg(**kw) -> Config:
    return Config(input_size=64, base_width=4, batch_size=8,
                  compute_dtype="float32", **kw)


def run_step(n_steps: int = 5, save_after: int = 3) -> dict:
    from smsut_tpu_torch.train import checkpoints
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    cfg = step_cfg()
    algo = SupervisedUNet(cfg, device="cpu")
    state = algo.init_state(0)
    img, msk = step_batch()
    sl = distributed.local_batch_slice(cfg.batch_size)
    batch = {"img": img[sl], "msk": msk[sl]}
    out = {"losses": [], "checksums": [], "shas": []}
    for k in range(n_steps):
        state, m = algo.train_step(state, batch)
        out["losses"].append(float(distributed_mean(m["loss"])))
        out["checksums"].append(checksum(state.params))
        out["shas"].append(tree_sha(state.params))
        if k + 1 == save_after:
            checkpoints.save_state(state, OUT, "elastic")
    return out


def distributed_mean(x: torch.Tensor) -> torch.Tensor:
    from smsut_tpu_torch.parallel.mesh import mean_over_ranks

    return mean_over_ranks(x.detach().reshape(()))


def run_gan() -> dict:
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    raw = np.load(os.path.join(OUT, "gan.npz"))
    cfg = Config(**json.loads(str(raw["cfg"])))
    algo = UGANConsisAlgo(cfg, device="cpu")
    state = algo.init_state(0)
    sl = distributed.local_batch_slice(cfg.batch_size)
    batch = {k: raw[k][sl] for k in ("img", "msk", "mdl", "ul_img",
                                      "ul_mdl")}
    batch.update(mj=int(raw["mj"]), alpha=raw["alpha"],
                 patch_ids=raw["patch_ids"])
    state, m = algo.train_step(state, batch, algo.epoch_scalars(1))
    return {"metrics": {k: float(distributed_mean(v)) for k, v in m.items()},
            "g_checksum": checksum(state.g_params),
            "d_checksum": checksum(state.d_params),
            "g_sha": tree_sha(state.g_params),
            "d_sha": tree_sha(state.d_params)}


def fit_cfg(data: str, expr: str, **kw) -> Config:
    return Config(base_root=data, expr_root=expr, input_size=32,
                  base_width=4, batch_size=4, num_iter_per_epoch=4,
                  max_epoch=1, num_workers=1, compute_dtype="float32",
                  steps_per_dispatch=2, data_aug=AUG32, **kw)


def record_scalars(trainer) -> dict:
    seen = {}
    trainer.exp.scalar = lambda tag, v, e: seen.setdefault(
        tag, {}).__setitem__(str(e), float(v))
    return seen


def run_fit() -> dict:
    from smsut_tpu_torch.train.loop import Trainer
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    cfg = fit_cfg(os.path.join(OUT, "data"), os.path.join(OUT, "fit"))
    trainer = Trainer(SupervisedUNet(cfg, device="cpu"), cfg, "train")
    seen = record_scalars(trainer)
    assert trainer._chunk_T == 2
    trainer.fit("inTurn")
    trainer.exp.close()
    return {"scalars": seen, "checksum": checksum(trainer.state.params),
            "sha": tree_sha(trainer.state.params),
            "spectator": trainer.exp.spectator,
            "model_root": trainer.exp.model_root}


def pseudo_cfg(data: str) -> Config:
    return Config(base_root=data, input_size=32, base_width=4, batch_size=4,
                  device_augment=False, compute_dtype="float32",
                  num_workers=1, data_aug=AUG32)


class SweepHost:
    """What CoraNet's sweep reads of its Trainer."""
    fold = 0

    def __init__(self):
        self.pseudo_sweep_rng = random.Random(2020)


def run_pseudo() -> dict:
    from smsut_tpu_torch.train.steps.coranet import CoraNet

    cfg = pseudo_cfg(os.path.join(OUT, "data"))
    algo = CoraNet(cfg, device="cpu", stage="cora")
    state = algo.init_state(0)
    algo._pseudo, dice = algo.pred_unlabel(
        state, algo._unlabeled_stream(SweepHost()))
    algo._pseudo_order = []
    draws = []
    for _ in range(3):
        b = algo.make_extra_batch()
        draws.append(sha(b["pse_img"], b["pse_lab"], b["pse_mask"]))
    return {"pseudo_sha": sha(*(algo._pseudo[k] for k in
                                sorted(algo._pseudo))),
            "draws": draws, "plab_dice": dice}


def eval_cfg(data: str, expr: str, scan: bool) -> Config:
    return Config(base_root=data, expr_root=expr, input_size=32,
                  base_width=4, batch_size=4, compute_dtype="float32",
                  eval_scan=scan, num_workers=1)


def sweep(cfg):
    """(n slices, sha of the volumes, meter values) of the eval sweep of a
    fresh Trainer (test phase) on ``cfg``."""
    from smsut_tpu_torch.data.dataset import get_label_npys, get_loader
    from smsut_tpu_torch.train.loop import Trainer
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet
    from smsut_tpu_torch.utils.meter import Meter

    trainer = Trainer(SupervisedUNet(cfg, device="cpu"), cfg, "test")
    loader = get_loader(cfg.base_root, "test", 0, cfg.batch_size, cfg=cfg)
    _, gt = get_label_npys(cfg.base_root, "test")
    meter = Meter([f"loss_{i}" for i in range(4)] + ["loss"], [], alpha=1.0)
    meter.reset_cur()
    n, prd = trainer.validate_epoch(loader, gt, meter)
    meter.update_cur()
    return {"n": n, "sha": sha(*(prd[k] for k in sorted(prd))),
            "meter": {k: float(v) for k, v in meter.cur_values.items()}}


def run_eval() -> dict:
    data, expr = os.path.join(OUT, "data"), os.path.join(OUT, "eval")
    return {str(scan): sweep(eval_cfg(data, expr, scan))
            for scan in (True, False)}


def refused(fn) -> str:
    """The class and message of what ``fn`` raises; '' if it returns."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def run_refuse() -> dict:
    from smsut_tpu_torch.train.loop import Trainer
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    expr = os.path.join(OUT, "refuse")
    trainer = lambda **kw: Trainer(SupervisedUNet(step_cfg(), device="cpu"),
                                   step_cfg(expr_root=expr, **kw), "test")
    gan = dict(input_size=32, base_width=8, nce_patches=4)
    return {
        "spatial_parallel=2": refused(lambda: trainer(spatial_parallel=2,
                                                      block_pallas=True)),
        "data_parallel=3": refused(lambda: trainer(data_parallel=3)),
        "data_parallel=2": refused(lambda: trainer(data_parallel=2)),
        "meanTeacher": refused(lambda: MeanTeacher(step_cfg(),
                                                   device="cpu")),
        "uganConsis B/N odd": refused(lambda: UGANConsisAlgo(
            Config(batch_size=6, **gan), device="cpu")),
        "uganConsis B/N even": refused(lambda: UGANConsisAlgo(
            Config(batch_size=4, **gan), device="cpu")),
    }


MODES = {"step": run_step, "gan": run_gan, "fit": run_fit,
         "pseudo": run_pseudo, "eval": run_eval, "refuse": run_refuse}


def main() -> int:
    torch.set_num_threads(2)
    os.environ["SMSUT_NO_TB"] = "1"
    assert distributed.initialize(device="cpu", timeout_s=120), \
        "SMSUT_* variables must be set"
    rank = distributed.process_index()
    for mode in os.environ["SMSUT_MODES"].split(","):
        try:
            out = MODES[mode]()
        except Exception:
            traceback.print_exc()
            out = {"error": traceback.format_exc()}
            with open(os.path.join(OUT, f"{mode}.{rank}.json"), "w") as f:
                json.dump(out, f)
            return 1   # the other rank may wait in a collective: stop
        out["rank"] = rank
        out["world"] = distributed.process_count()
        out["backend"] = distributed.backend()
        with open(os.path.join(OUT, f"{mode}.{rank}.json"), "w") as f:
            json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
