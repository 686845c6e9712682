# -*- coding: utf-8 -*-
"""One rank of the port's tensor-parallel tests
(tests/test_torch_tensor_parallel.py).

Joins a gloo group on the CPU from the ``SMSUT_*`` contract, lays it out
as ``dp x tp`` (``SMSUT_TP``, ``parallel/mesh.py`` ``make_mesh_2d``), runs
every mode of ``SMSUT_MODES`` in turn and writes ``{mode}.{rank}.json``
(and rank 0's whole trees as ``{name}.npz``) into ``SMSUT_DIST_DIR``,
where the parent also left its inputs (``gan.npz``).  Imports the port
only, never JAX.

Modes (the parent holds each against the JAX package or one process):

- ``dryrun``: ``parallel/dryrun.py`` ``dryrun_multichip`` on the group,
  which this process joins there (it runs its one-process steps first);
- ``step``: two ``SupervisedUNet`` steps (w8, 32x32, global batch 4) on
  the sharded state, ``block_pallas`` off and on;
- ``save``: two steps, ``save_state``, then a third step, and the third
  step again from the checkpoint loaded into a sharded template;
- ``eval``: ``eval_fn`` on the sharded parameters;
- ``gan``: one ``uganConsis`` step (w8, 64x64, 4 + 4) on the parent's
  batch and draws, float32;
- ``variants``: one float64 step of ``ugan`` and of ``uganShp0`` there;
- ``load``: the checkpoint of ``save`` (another group's, in
  ``SMSUT_CKPT_DIR``) loaded into this layout, and one step from it;
- ``refuse``: what the model axis refuses (last: it changes the layout).
"""
import hashlib
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.parallel import distributed, mesh
from smsut_tpu_torch.parallel.dryrun import dryrun_multichip

OUT = os.environ.get("SMSUT_DIST_DIR", "")
TP = int(os.environ.get("SMSUT_TP", "2"))
CKPT = os.environ.get("SMSUT_CKPT_DIR", "")
STEPS = 2


def tree_sha(tree) -> str:
    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(np.ascontiguousarray(tree[k].detach().cpu().numpy())
                 .tobytes())
    return h.hexdigest()


def save_tree(name: str, tree) -> None:
    if distributed.is_primary():
        np.savez(os.path.join(OUT, f"{name}.npz"),
                 **{k: v.detach().cpu().numpy() for k, v in tree.items()})


def mean(x: torch.Tensor) -> float:
    return float(mesh.mean_over_ranks(x.detach().reshape(())))


def step_cfg(**kw) -> Config:
    return Config(input_size=32, base_width=8, batch_size=4,
                  compute_dtype="float32", **kw)


def step_batch(global_batch: int = 4, size: int = 32):
    rng = np.random.default_rng(0)
    img = rng.normal(size=(global_batch, size, size, 1)).astype(np.float32)
    msk = rng.integers(0, 5, size=(global_batch, size, size)
                       ).astype(np.int64)
    return img, msk


def local_batch():
    img, msk = step_batch()
    sl = distributed.local_batch_slice(4)
    return {"img": img[sl], "msk": msk[sl]}


def gan_cfg(**kw) -> Config:
    return Config(input_size=64, base_width=8, batch_size=4, nce_patches=8,
                  compute_dtype="float32", consis_gate_step=0, lr=1e-4, **kw)


def numel(*trees) -> int:
    return sum(v.numel() for t in trees for v in t.values())


# ------------------------------------------------------------------ modes

def run_step(layout) -> dict:
    from smsut_tpu_torch.ops import block, conv3x3
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    out = {}
    for fused in (False, True):
        algo = SupervisedUNet(step_cfg(block_pallas=fused), device="cpu")
        whole = algo.init_state(0)
        state = mesh.shard_params_channelwise(layout, whole)
        conv3x3.conv3x3.routed = block.basic_block.routed = 0
        block.basic_block.tp_gathered = 0
        losses = []
        for _ in range(STEPS):
            state, m = algo.train_step(state, local_batch())
            losses.append(mean(m["loss"]))
        params = mesh.gather_tree(state.params, state.shards)
        save_tree(f"step_{int(fused)}", params)
        out[str(fused)] = {
            "losses": losses, "sha": tree_sha(params),
            "whole_sha": tree_sha({k: v for k, v in state.params.items()
                                   if k not in state.shards}),
            "shards": sorted(state.shards),
            "numel": numel(state.params, state.opt_state),
            "whole_numel": numel(whole.params, whole.opt_state),
            "sharded_numel": numel(
                {k: state.params[k] for k in state.shards},
                {k: state.opt_state[k] for k in state.shards}),
            "sharded_whole": numel(
                {k: whole.params[k] for k in state.shards},
                {k: whole.opt_state[k] for k in state.shards}),
            "tp_gathered": block.basic_block.tp_gathered // STEPS,
            "routed": [conv3x3.conv3x3.routed // STEPS,
                       block.basic_block.routed // STEPS]}
    return out


def run_save(layout) -> dict:
    from smsut_tpu_torch.train import checkpoints
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    algo = SupervisedUNet(step_cfg(), device="cpu")
    state = mesh.shard_params_channelwise(layout, algo.init_state(0))
    for _ in range(STEPS):
        state, _ = algo.train_step(state, local_batch())
    checkpoints.save_state(state, CKPT, "tp")
    saved = tree_sha(mesh.gather_tree(state.params, state.shards))
    state, m_a = algo.train_step(state, local_batch())
    template = mesh.shard_params_channelwise(layout, algo.init_state(1))
    restored = checkpoints.load_state(template, CKPT, "tp")
    step = restored.step
    restored, m_b = algo.train_step(restored, local_batch())
    return {"restored_step": step, "saved_sha": saved,
            "loss": [float(m_a["loss"]), float(m_b["loss"])],
            "sha": [tree_sha(state.params), tree_sha(restored.params)],
            "trees": [tree_sha(state.opt_state), tree_sha(restored.opt_state)]}


def run_eval(layout) -> dict:
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    algo = SupervisedUNet(step_cfg(), device="cpu")
    params = mesh.shard_params_channelwise(layout, algo.init_params(0))
    logits = algo.eval_fn(params, step_batch()[0])
    save_tree("eval", {"logits": logits})
    return {"sha": tree_sha({"logits": logits})}


def run_gan(layout) -> dict:
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    algo = UGANConsisAlgo(gan_cfg(), device="cpu")
    state = mesh.shard_params_channelwise(layout, algo.init_state(0))
    state, m = algo.train_step(state, gan_batch(), algo.epoch_scalars(1))
    d = mesh.gather_tree(state.d_params, state.d_shards)
    save_tree("gan_d", d)
    return {"metrics": {k: mean(v) for k, v in m.items()},
            "g_sha": tree_sha(mesh.gather_tree(state.g_params,
                                               state.g_shards)),
            "d_sha": tree_sha(d),
            "shards": [len(state.g_shards), len(state.d_shards)]}


VARIANTS = {"ugan": "UGANTrainerAlgo", "uganShp0": "UGANShp0Algo"}


def variant_step(name: str, batch: dict, layout=None):
    """One float64 step of the GAN variant ``name`` from the initial
    weights, on the state sharded over ``layout`` if given: (the metrics,
    G and D whole)."""
    from smsut_tpu_torch.train.steps import gan

    algo = getattr(gan, VARIANTS[name])(gan_cfg(), device="cpu")
    for net in (algo.net, algo.D):
        net.double().compute_dtype = torch.float64
    state = algo.init_state(0)
    for tree in (state.g_params, state.g_opt_state, state.d_params,
                 state.d_opt_state.mu, state.d_opt_state.nu):
        tree.update({k: v.double() for k, v in tree.items()})
    if layout is not None:
        state = mesh.shard_params_channelwise(layout, state)
    # no unlabelled half: the GP's draw for the labelled rows alone
    batch = dict(batch, alpha=np.asarray(batch["alpha"]).reshape(-1)[
        :algo.total_batch])
    state, m = algo.train_step(state, batch, algo.epoch_scalars(1))
    return ({k: mean(v) for k, v in m.items()},
            mesh.gather_tree(state.g_params, state.g_shards),
            mesh.gather_tree(state.d_params, state.d_shards))


def gan_batch():
    """The rank's rows of the parent's GAN batch, and its draws."""
    raw = np.load(os.path.join(OUT, "gan.npz"))
    sl = distributed.local_batch_slice(4)
    batch = {k: raw[k][sl] for k in ("img", "msk", "mdl", "ul_img",
                                     "ul_mdl")}
    batch.update(mj=int(raw["mj"]), alpha=raw["alpha"],
                 patch_ids=raw["patch_ids"])
    return batch


def run_variants(layout) -> dict:
    out = {}
    for name in VARIANTS:
        metrics, g, d = variant_step(name, gan_batch(), layout)
        save_tree(f"{name}_g", g)
        save_tree(f"{name}_d", d)
        out[name] = {"metrics": metrics, "sha": tree_sha(g) + tree_sha(d)}
    return out


def run_load(layout) -> dict:
    from smsut_tpu_torch.train import checkpoints
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    path = os.path.join(CKPT, "tp.ckpt")
    t0 = time.time()
    while not os.path.exists(path + ".done"):
        if time.time() - t0 > 180:
            raise TimeoutError(f"no {path}")
        time.sleep(0.2)
    algo = SupervisedUNet(step_cfg(), device="cpu")
    template = mesh.shard_params_channelwise(layout, algo.init_state(1))
    state = checkpoints.load_state(template, CKPT, "tp")
    step = state.step
    state, m = algo.train_step(state, local_batch())
    params = mesh.gather_tree(state.params, state.shards)
    save_tree("load", params)
    return {"restored_step": step, "loss": mean(m["loss"]),
            "sha": tree_sha(params)}


def refused(fn) -> str:
    """The class and message of what ``fn`` raises; '' if it returns."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def run_refuse(layout) -> dict:
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    world = distributed.process_count()
    algo = SupervisedUNet(step_cfg(), device="cpu")
    out = {
        "whole state": refused(lambda: algo.train_step(
            algo.init_state(0), local_batch())),
        "make_mesh_2d": refused(lambda: mesh.make_mesh_2d(world, world)),
        "spatial_parallel": refused(lambda: mesh.check_config(Config(
            input_size=64, batch_size=4, spatial_parallel=TP))),
    }
    mesh.make_mesh_2d(world, 1)
    mesh.set_spatial(TP)
    out["tp x sp"] = refused(lambda: mesh.make_mesh_2d(world // TP, TP))
    out["shard under sp"] = refused(lambda: mesh.shard_params_channelwise(
        layout, algo.init_params(0)))
    mesh.set_spatial(1)
    mesh.make_mesh_2d(world // TP, TP)
    return out


MODES = {"step": run_step, "save": run_save, "eval": run_eval,
         "gan": run_gan, "variants": run_variants, "load": run_load,
         "refuse": run_refuse}


def write(mode: str, out: dict) -> None:
    rank = distributed.process_index()
    out.update(rank=rank, world=distributed.process_count(),
               model=distributed.model_count())
    with open(os.path.join(OUT, f"{mode}.{rank}.json"), "w") as f:
        json.dump(out, f)


def main() -> int:
    torch.set_num_threads(1)
    modes = os.environ["SMSUT_MODES"].split(",")
    world = int(os.environ["SMSUT_NUM_PROCESSES"])
    for mode in modes:
        try:
            if mode == "dryrun":
                out = {"line": dryrun_multichip(world, "cpu")}
            elif not distributed.initialize(device="cpu", timeout_s=120):
                raise AssertionError("SMSUT_* variables must be set")
            layout = mesh.make_mesh_2d(world // TP, TP)
            if mode != "dryrun":
                out = MODES[mode](layout)
        except Exception:
            traceback.print_exc()
            with open(os.path.join(OUT, f"{mode}.{distributed.process_index()}"
                                   ".json"), "w") as f:
                json.dump({"error": traceback.format_exc()}, f)
            return 1   # the others may wait in a collective: stop
        write(mode, out)
        if mode == "save" and distributed.is_primary():
            open(os.path.join(CKPT, "tp.ckpt.done"), "w").close()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
