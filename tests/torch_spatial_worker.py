# -*- coding: utf-8 -*-
"""One rank of the port's space-axis tests (tests/test_torch_spatial.py).

Joins a gloo group on the CPU from the ``SMSUT_*`` contract, lays it out
as ``dp x sp`` (``SMSUT_SPACE``), runs every mode of ``SMSUT_MODES`` in
turn and writes ``{mode}.{rank}.json`` (and rank 0's parameters as
``{mode}.npz``) into ``SMSUT_DIST_DIR``, where the parent also left its
inputs (``gan.npz``, the synthetic tree ``data/``).  Imports the port
only, never JAX.

Modes (the parent holds each against one process):

- ``ops``: the layers that meet their neighbours (the halo convs: 3x3 on
  the conv kernel's path, 5x5, the Cout-1 3x3 and the discriminator's 4x4
  stride-2 stem; the 2x bilinear upsample; the split instance norm with
  and without its leaky ReLU) on the rank's rows against the same layer
  on whole images in this process: the forward, the gradient of a
  square's sum in the input taken with ``create_graph`` (the GP's form),
  and the gradient of that gradient's weighted square in the input and
  the parameters;
- ``step``: one ``SupervisedUNet`` step (w4, 64x64, global batch 4);
- ``gan``: one ``uganConsis`` step on the parent's batch and draws, in
  float32 (its metrics) and in float64 (its parameters);
- ``fit``: ``unetTrainer -p train --set spatial_parallel=S`` through
  ``run_main``, one epoch of two iterations;
- ``refuse``: what the space axis refuses, and that it takes the fused
  block kernels (``block_pallas``: K3/K6 split at their statistics).
"""
import hashlib
import json
import os
import sys
import traceback

import numpy as np
import torch

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.parallel import distributed, mesh

OUT = os.environ.get("SMSUT_DIST_DIR", "")
SP = int(os.environ.get("SMSUT_SPACE", "2"))
AUG64 = dict(Config().data_aug, resizeCrop_size=64)


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def tree_sha(tree) -> str:
    return sha(*(tree[k].detach().cpu().numpy() for k in sorted(tree)))


def save_tree(name: str, tree) -> None:
    if distributed.is_primary():
        np.savez(os.path.join(OUT, f"{name}.npz"),
                 **{k: v.detach().cpu().numpy() for k, v in tree.items()})


def mean(x: torch.Tensor) -> float:
    return float(mesh.mean_over_ranks(x.detach().reshape(())))


def step_cfg(**kw) -> Config:
    return Config(input_size=64, base_width=4, batch_size=4,
                  compute_dtype="float32", **kw)


def step_batch(global_batch: int = 4, size: int = 64, n_class: int = 5):
    """A seeded batch whose images hold no label 1 or 2 in their lower
    half of rows, so that the Dice of either half alone differs from the
    whole image's."""
    rng = np.random.default_rng(0)
    img = rng.normal(size=(global_batch, size, size, 1)).astype(np.float32)
    msk = rng.integers(0, n_class, size=(global_batch, size, size)
                       ).astype(np.int32)
    low = msk[:, size // 2:]
    low[(low == 1) | (low == 2)] = 0
    return img, msk


def local(a: np.ndarray, global_batch: int) -> np.ndarray:
    """The rank's rows of the batch and, of each image, its rows."""
    a = a[distributed.local_batch_slice(global_batch)]
    h = a.shape[1] // distributed.space_count()
    return a[:, distributed.space_index() * h:][:, :h]


# ------------------------------------------------------------------- ops

def op_cases():
    """name -> (module, or None for the upsample; input channels)."""
    from smsut_tpu_torch.models.layers import Conv, NormAct
    from smsut_tpu_torch.models.ugan import _StemConv

    g = torch.Generator().manual_seed(3)
    return {"conv3x3": (Conv(8, 16, 3, g), 8),
            "conv5x5": (Conv(4, 8, 5, g), 4),
            "conv3x3_cout1": (Conv(8, 1, 3, g), 8),
            "stem4x4": (_StemConv(4, 8, g), 4),
            "upsample": (None, 8),
            "norm_lrelu": (NormAct(8, "lrelu"), 8),
            "norm": (NormAct(8, None), 8)}


def op_run(mod, x: torch.Tensor, c_full: np.ndarray, e_full: np.ndarray,
           split: bool):
    """(y, dy^2.c/dx, and the gradients of that gradient's square
    weighted by e in x and in the parameters), on the rank's rows with
    ``split``, else on whole images."""
    from smsut_tpu_torch.models.layers import upsample_bilinear2

    leaves = ({k: v.detach().clone().requires_grad_()
               for k, v in mod.named_parameters()} if mod is not None else {})
    x = x.detach().clone().requires_grad_()
    if mod is None:
        y = upsample_bilinear2(x)
    else:
        y = torch.func.functional_call(mod, leaves, (x,))
    rows = (lambda a: torch.from_numpy(np.ascontiguousarray(
        local(a, a.shape[0])))) if split else torch.from_numpy
    s = (y * y * rows(c_full)).sum()
    gx, = torch.autograd.grad(s, x, create_graph=True)
    loss = (gx * gx * rows(e_full)).sum()
    got = torch.autograd.grad(loss, [x] + list(leaves.values()))
    grads = {k: mesh.space_sum(v.detach()) if split else v.detach()
             for k, v in zip(leaves, got[1:])}
    return y.detach(), gx.detach(), got[0].detach(), grads


def run_ops() -> dict:
    from smsut_tpu_torch.models.layers import upsample_bilinear2

    assert distributed.space_count() == SP == distributed.process_count()
    rng = np.random.default_rng(11)
    out = {}
    for name, (mod, cin) in op_cases().items():
        x = rng.normal(size=(2, 16, 8, cin)).astype(np.float32)
        with distributed.no_space(), torch.no_grad():
            y0 = (mod or upsample_bilinear2)(torch.from_numpy(x))
        c = rng.normal(size=y0.shape).astype(np.float32)
        e = rng.normal(size=x.shape).astype(np.float32)
        with distributed.no_space():
            want = op_run(mod, torch.from_numpy(x), c, e, False)
        got = op_run(mod, torch.from_numpy(np.ascontiguousarray(
            local(x, 2))), c, e, True)
        errs = {}
        for what, a, b in (("y", got[0], want[0]), ("dx", got[1], want[1]),
                           ("ddx", got[2], want[2])):
            b = torch.from_numpy(np.ascontiguousarray(local(b.numpy(), 2)))
            errs[what] = float((a - b).abs().max() / b.abs().max())
        for k, v in want[3].items():
            errs[k] = float((got[3][k] - v).abs().max() / v.abs().max())
        out[name] = errs
    return out


# ------------------------------------------------------------ steps, fit

def run_step() -> dict:
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    cfg = step_cfg(spatial_parallel=SP)
    mesh.check_config(cfg)
    algo = SupervisedUNet(cfg, device="cpu")
    state = algo.init_state(0)
    img, msk = step_batch()
    state, m = algo.train_step(state, {"img": local(img, 4),
                                       "msk": local(msk, 4)})
    save_tree("step", state.params)
    return {"loss": mean(m["loss"]), "sha": tree_sha(state.params)}


def gan_cfg(**kw) -> Config:
    return Config(input_size=64, base_width=4, batch_size=4, nce_patches=8,
                  compute_dtype="float32", consis_gate_step=0, **kw)


def gan_step(batch: dict, float64: bool):
    """One uganConsis step from the initial weights (in float64 with
    ``float64``, as tests/test_torch_gan.py's ``exact_run``): (the
    state after it, the metrics)."""
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    cfg = gan_cfg(spatial_parallel=distributed.space_count())
    algo = UGANConsisAlgo(cfg, device="cpu")
    state = algo.init_state(0)
    if float64:
        f64 = torch.float64
        algo.net.double().compute_dtype = f64
        algo.D.double().compute_dtype = f64
        for tree in (state.g_params, state.g_opt_state, state.d_params,
                     state.d_opt_state.mu, state.d_opt_state.nu):
            tree.update({k: v.double() for k, v in tree.items()})
    return algo.train_step(state, batch, algo.epoch_scalars(1))


def run_gan() -> dict:
    raw = np.load(os.path.join(OUT, "gan.npz"))
    mesh.check_config(gan_cfg(spatial_parallel=SP), gan=True)
    batch = {k: local(raw[k], 4) for k in ("img", "msk", "ul_img")}
    sl = distributed.local_batch_slice(4)
    batch.update(mdl=raw["mdl"][sl], ul_mdl=raw["ul_mdl"][sl],
                 mj=int(raw["mj"]), alpha=raw["alpha"],
                 patch_ids=raw["patch_ids"])
    state, m = gan_step(batch, False)
    out = {"metrics": {k: mean(v) for k, v in m.items()},
           "g_sha": tree_sha(state.g_params),
           "d_sha": tree_sha(state.d_params)}
    state, _ = gan_step(batch, True)
    save_tree("gan_g", state.g_params)
    save_tree("gan_d", state.d_params)
    return out


def fit_args(data: str, expr: str, sp: int):
    from smsut_tpu_torch.train.cli import make_parser

    sets = [f"{k}={v}" for k, v in dict(
        input_size=64, base_width=4, batch_size=4, num_iter_per_epoch=2,
        max_epoch=1, num_workers=1, compute_dtype="float32",
        spatial_parallel=sp, data_aug=AUG64).items()]
    argv = ["-p", "train", "--device", "cpu", "--data_root", data,
            "--expr_root", expr]
    for s in sets:
        argv += ["--set", s]
    return make_parser().parse_args(argv)


def fit(data: str, expr: str, sp: int) -> dict:
    """``unetTrainer -p train`` through ``run_main``: the scalars it
    logged (unrounded) and its last checkpoint's parameters."""
    from smsut_tpu_torch.train import checkpoints
    from smsut_tpu_torch.train.cli import run_main
    from smsut_tpu_torch.train.experiment import Experiment
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    seen = {}
    orig = Experiment.scalar
    Experiment.scalar = lambda self, tag, v, e: seen.setdefault(
        tag, {}).__setitem__(str(e), float(v))
    try:
        run_main(SupervisedUNet, fit_args(data, expr, sp))
    finally:
        Experiment.scalar = orig
    raw = checkpoints.load_raw(os.path.join(expr, "SupervisedUNet", "000",
                                            "ckpt"), "last")
    return seen, raw


def run_fit() -> dict:
    seen, raw = fit(os.path.join(OUT, "data"), os.path.join(OUT, "fit"), SP)
    params = raw["params"] if "params" in raw else raw
    return {"scalars": seen,
            "checksum": float(sum(float(np.abs(np.asarray(v)).sum())
                                  for v in params.values()))}


# --------------------------------------------------------------- refusals

def refused(fn) -> str:
    """The class and message of what ``fn`` raises; '' if it returns."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def ran(fn) -> str:
    """'ok: ' and what ``fn`` returns, or the class and message of what it
    raises."""
    try:
        out = fn()
    except Exception as e:
        return f"{type(e).__name__}: {e}"
    return f"ok: {out}"


def run_refuse() -> dict:
    from smsut_tpu_torch.models.unet import UNet
    from smsut_tpu_torch.train.loop import Trainer
    from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    expr = os.path.join(OUT, "refuse")
    trainer = lambda cfg: Trainer(SupervisedUNet(cfg, device="cpu"),
                                  cfg.replace(expr_root=expr), "test")

    def fused_block():
        from smsut_tpu_torch.ops import block

        net = UNet(5, 16, compute_dtype=torch.float32, block_fused=True,
                   device="cpu")
        routed = block.basic_block.routed
        y = net(torch.zeros(1, 64 // SP, 64, 1))
        return [list(y.shape), block.basic_block.routed - routed]

    return {
        "input_size=32": refused(lambda: trainer(Config(
            input_size=32, base_width=4, batch_size=4,
            spatial_parallel=SP))),
        "block_pallas": ran(lambda: trainer(step_cfg(
            spatial_parallel=SP, block_pallas=True)).cfg.block_pallas),
        "fused block": ran(fused_block),
        "meanTeacher": ran(lambda: Trainer(MeanTeacher(step_cfg(
            spatial_parallel=SP, block_pallas=True), device="cpu"),
            step_cfg(spatial_parallel=SP, block_pallas=True,
                     expr_root=expr), "test").cfg.block_pallas),
        "make_mesh_2d": refused(lambda: mesh.make_mesh_2d(1, 2)),
    }


MODES = {"ops": run_ops, "step": run_step, "gan": run_gan, "fit": run_fit,
         "refuse": run_refuse}


def main() -> int:
    torch.set_num_threads(1)
    os.environ["SMSUT_NO_TB"] = "1"
    assert distributed.initialize(device="cpu", timeout_s=120), \
        "SMSUT_* variables must be set"
    mesh.set_spatial(SP)
    rank = distributed.process_index()
    for mode in os.environ["SMSUT_MODES"].split(","):
        try:
            out = MODES[mode]()
        except Exception:
            traceback.print_exc()
            out = {"error": traceback.format_exc()}
            with open(os.path.join(OUT, f"{mode}.{rank}.json"), "w") as f:
                json.dump(out, f)
            return 1   # the others may wait in a collective: stop
        out["rank"] = rank
        out["world"] = distributed.process_count()
        out["space"] = distributed.space_count()
        with open(os.path.join(OUT, f"{mode}.{rank}.json"), "w") as f:
            json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
