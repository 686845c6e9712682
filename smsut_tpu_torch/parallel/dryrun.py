# -*- coding: utf-8 -*-
"""The multi-process dry run: the counterpart of ``__graft_entry__.py``
``dryrun_multichip``, for the port's process groups.

    python -m torch.distributed.run --standalone --nproc_per_node 4 \\
        -m smsut_tpu_torch.parallel.dryrun [--device cpu]

Each rank first runs the real training steps in one process (no group
yet), then joins the group and runs them again on two layouts of it,
``world / 2`` data coordinates by 2 (by 1 at an odd world):

- ``dpxtp``: the ``('data', 'model')`` mesh, every eligible weight and
  its optimizer state sharded on its output channels
  (``parallel/mesh.py`` ``make_mesh_2d``, ``shard_params_channelwise``);
- ``dpxsp``: the ``('data', 'space')`` layout, each rank holding half the
  rows of every image (``spatial_parallel``).

Both hold each layout against the one process on the same inputs, with
the JAX dry run's bounds: the supervised U-Net's step (the loss within
1e-5, every parameter within 1e-4, the update's cosine above 1 - 1e-5),
and the ``uganConsis`` step at ``lr`` 1e-4 (every metric within 1e-3 of
``1 + |value|``; the discriminator after Adam, whose first update is
about ``lr`` times a sign, within 2.1 ``lr`` everywhere, with under 1% of
its entries more than 1.5 ``lr`` apart).  The size is the JAX dry run's:
``input_size`` 64, ``base_width`` 4, a global batch of ``max(2, dp)``
(+ as many unlabelled), float32.
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import Dict, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.parallel import distributed, mesh

Device = Optional[Union[str, torch.device]]
GAN_LR = 1e-4


def _configs(world: int):
    half = 2 if world % 2 == 0 else 1
    dp = world // half
    cfg = Config(input_size=64, base_width=4, batch_size=max(2, dp),
                 compute_dtype="float32")
    return half, dp, cfg


def _batch(cfg: Config) -> Dict[str, np.ndarray]:
    """The JAX dry run's host batch, from ``default_rng(0)``."""
    bs, hw = cfg.batch_size, cfg.input_size
    rng = np.random.default_rng(0)
    return {
        "img": rng.standard_normal((bs, hw, hw, 1)).astype(np.float32) * .3,
        "msk": rng.integers(0, cfg.n_class, (bs, hw, hw)).astype(np.int64),
        "mdl": (np.arange(bs) % cfg.n_modal).astype(np.int64),
        "ul_img": rng.standard_normal((bs, hw, hw, 1)).astype(np.float32)
        * .3,
        "ul_mdl": ((np.arange(bs) + 1) % cfg.n_modal).astype(np.int64)}


def _local(batch: Dict[str, np.ndarray], global_batch: int
           ) -> Dict[str, np.ndarray]:
    """The rank's rows of the batch and, under a space axis, of each image
    its rows."""
    out = {}
    for k, v in batch.items():
        v = v[distributed.local_batch_slice(global_batch)]
        if v.ndim >= 3:
            v = mesh.space_rows(torch.from_numpy(v)).contiguous().numpy()
        out[k] = v
    return out


def _whole(tree, shards) -> Dict[str, np.ndarray]:
    return {k: v.detach().double().cpu().numpy()
            for k, v in mesh.gather_tree(tree, shards).items()}


def _steps(cfg: Config, batch, device: Device, layout=None):
    """One U-Net step and one ``uganConsis`` step from seed 0 on the rank's
    part of ``batch``, the state sharded over ``layout`` (a mesh) if given:
    (U-Net loss, its parameters whole, GAN metrics, D whole), the loss and
    metrics averaged over the group."""
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    shard = ((lambda st: mesh.shard_params_channelwise(layout, st))
             if layout is not None else (lambda st: st))
    mean = lambda v: float(mesh.mean_over_ranks(v.detach().reshape(())))
    local = _local(batch, cfg.batch_size)
    unet = SupervisedUNet(cfg, device=device)
    st, m = unet.train_step(shard(unet.init_state(0)),
                            {"img": local["img"], "msk": local["msk"]})
    params = _whole(st.params, st.shards)
    gan = UGANConsisAlgo(cfg.replace(lr=GAN_LR), device=device)
    gst, gm = gan.train_step(shard(gan.init_state(0)),
                             dict(local, **gan.make_extra_batch()),
                             gan.epoch_scalars(1))
    return (mean(m["loss"]), params, {k: mean(v) for k, v in gm.items()},
            _whole(gst.d_params, gst.d_shards))


def _init_params(cfg: Config, device: Device) -> Dict[str, np.ndarray]:
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    return {k: v.double().cpu().numpy() for k, v in
            SupervisedUNet(cfg, device=device).init_params(0).items()}


def _flat(tree: Dict[str, np.ndarray]) -> np.ndarray:
    return np.concatenate([tree[k].ravel() for k in sorted(tree)])


def _bound(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _against(name: str, got, want, init) -> str:
    """Hold ``got`` to the JAX dry run's bounds against ``want``; the
    report's part for layout ``name``."""
    loss, params, metrics, d = got
    loss1, params1, metrics1, d1 = want
    loss_dev = abs(loss - loss1)
    param_dev = max(float(np.max(np.abs(params[k] - params1[k])))
                    for k in params1)
    u, u1 = _flat(params) - _flat(init), _flat(params1) - _flat(init)
    cos = float(np.dot(u, u1) / (np.linalg.norm(u) * np.linalg.norm(u1)))
    _bound(loss_dev < 1e-5,
           f"[{name}] unet loss deviates {loss_dev:.2e} from one process")
    _bound(param_dev < 1e-4,
           f"[{name}] unet params deviate {param_dev:.2e} from one process")
    _bound(cos > 1 - 1e-5,
           f"[{name}] unet update cosine {cos:.8f} vs one process")
    metric_dev = 0.0
    for k, v in metrics1.items():
        dev = abs(metrics[k] - v) / (1.0 + abs(v))
        metric_dev = max(metric_dev, dev)
        _bound(math.isfinite(metrics[k]) and dev < 1e-3,
               f"[{name}] metric {k} {metrics[k]} deviates {dev:.2e} from "
               f"one process")
    devs = [np.abs(d[k] - d1[k]) for k in d1]
    d_dev = max(float(x.max()) for x in devs)
    flips = sum(int(np.sum(x > 1.5 * GAN_LR)) for x in devs) / sum(
        x.size for x in devs)
    _bound(d_dev <= 2.1 * GAN_LR,
           f"[{name}] d_params deviate {d_dev:.2e} > 2.1*lr")
    _bound(flips < 0.01, f"[{name}] {flips:.2%} of d_params flipped (>1%)")
    return (f"{name}: unet param dev {param_dev:.1e} cos {1 - cos:.1e}, "
            f"gan metric dev {metric_dev:.1e} d_flips {flips:.2%}")


def dryrun_multichip(world: int, device: Device = None) -> str:
    """The dry run on a group of ``world`` processes, which this process
    joins (``distributed.initialize``: the ``SMSUT_*`` variables or
    ``torch.distributed.run``'s) after its one-process steps; every rank
    calls it.  Raises where a layout leaves the bounds; returns the
    report line (rank 0 prints it).  The group stays, laid out as plain
    data parallel."""
    if dist.is_initialized():
        raise RuntimeError("dryrun_multichip runs its one-process steps "
                           "before it joins the group: call it first")
    half, dp, cfg = _configs(world)
    batch = _batch(cfg)
    init = _init_params(cfg, device)
    one = _steps(cfg, batch, device)
    distributed.initialize(device=device)
    if distributed.process_count() != world:
        raise ValueError(f"dryrun_multichip({world}) in a group of "
                         f"{distributed.process_count()} processes")
    report = []
    for name in ("dpxtp", "dpxsp"):
        if name == "dpxtp":
            layout, run_cfg = mesh.make_mesh_2d(dp, half), cfg
        else:
            layout, run_cfg = None, cfg.replace(spatial_parallel=half)
            mesh.check_config(run_cfg, gan=True)
        try:
            got = _steps(run_cfg, batch, device, layout)
        finally:
            mesh.make_mesh_2d(world, 1)
            mesh.set_spatial(1)
        report.append(_against(name, got, one, init))
    line = (f"dryrun_multichip({world}): ok, mesh==1-process within bounds "
            f"(1e-4 / 1e-3 / 1%) | " + " | ".join(report))
    if distributed.is_primary():
        print(line, flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    world = distributed._env_int("SMSUT_NUM_PROCESSES", "WORLD_SIZE") or 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dryrun_multichip(world, args.device)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
