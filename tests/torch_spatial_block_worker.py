# -*- coding: utf-8 -*-
"""One rank of the fused block's space-axis tests
(tests/test_torch_spatial_block.py).

Joins a gloo group on the CPU from the ``SMSUT_*`` contract, lays it out
as ``dp x sp`` (``SMSUT_SPACE``), runs every mode of ``SMSUT_MODES`` in
turn and writes ``{mode}.{rank}.json`` (and rank 0's tensors as
``{mode}.npz``) into ``SMSUT_DIST_DIR``, where the parent also left the
GAN's batch and draws (``gan.npz``).  Imports the port only, never JAX.
Each mode but ``ops`` is a function of the rank's part of every input;
the parent runs it in one process, where that part is the whole:

- ``ops``: the fused block (K3 forward, K6 backward through
  ``block.basic_block``) on the rank's rows against the block on whole
  images in this process, identity and shortcut forms, with norm 1's bias
  far from 0 (a zero row of y1's halo would be staged as lrelu(b1));
- ``step``: one ``SupervisedUNet`` step with ``block_pallas``;
- ``remat``: the same with ``remat_unet`` too;
- ``gan``: one ``uganConsis`` step with ``block_pallas`` on the parent's
  batch and draws;
- ``meanTeacher``: three Mean Teacher steps with ``block_pallas`` from
  count 99.
"""
import json
import os
import sys
import traceback

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_spatial_worker as sw  # noqa: E402
import torch_spatial_zoo_worker as zw  # noqa: E402

from smsut_tpu_torch.parallel import distributed, mesh  # noqa: E402

OUT = os.environ.get("SMSUT_DIST_DIR", "")
SP = int(os.environ.get("SMSUT_SPACE", "2"))
# (Cin, Cout) of the op cases; norm 1's bias about B1_MEAN
BLOCK_FORMS = {"identity": (16, 16), "shortcut": (8, 16)}
B1_MEAN = 3.0


def _save(name: str, tree) -> None:
    sw.OUT = OUT
    sw.save_tree(name, tree)


# ------------------------------------------------------------------- ops

def block_inputs(form: str, seed: int = 7) -> dict:
    """Seeded whole-image inputs of one fused block: x [2, 16, 8, Cin],
    its parameters (``b1`` about B1_MEAN) and an output weight ``c``."""
    ci, co = BLOCK_FORMS[form]
    rng = np.random.default_rng(seed)
    f = lambda *s, std=1.0, mean=0.0: torch.from_numpy(
        (mean + std * rng.normal(size=s)).astype(np.float32))
    a = {"x": f(2, 16, 8, ci), "w1": f(3, 3, ci, co, std=0.3),
         "s1": f(co, std=0.2, mean=1.0), "b1": f(co, std=0.5, mean=B1_MEAN),
         "w2": f(3, 3, co, co, std=0.3), "s2": f(co, std=0.2, mean=1.0),
         "b2": f(co, std=0.3), "c": f(2, 16, 8, co)}
    if ci != co:
        a.update(ws=f(1, 1, ci, co, std=0.3), ss=f(co, std=0.2, mean=1.0),
                 bs=f(co, std=0.3))
    return a


PARAMS = ("w1", "s1", "b1", "w2", "s2", "b2", "ws", "ss", "bs")


def block_run(a: dict, split: bool):
    """(out, dx, the parameters' gradients) of sum(block(x) * c), through
    ``block.basic_block``'s autograd, on the rank's rows with ``split``
    (the parameters' gradients summed over the space group), else on
    whole images."""
    from smsut_tpu_torch.ops import block

    rows = (lambda t: torch.from_numpy(np.ascontiguousarray(
        zw.local(t.numpy(), t.shape[0])))) if split else torch.clone
    x = rows(a["x"]).requires_grad_()
    leaves = {k: a[k].clone().requires_grad_() for k in PARAMS if k in a}
    out = block.basic_block(x, *(leaves.get(k) for k in PARAMS))
    (out * rows(a["c"])).sum().backward()
    grads = {k: mesh.space_sum(v.grad) if split else v.grad
             for k, v in leaves.items()}
    return out.detach(), x.grad, grads


def run_ops() -> dict:
    assert distributed.space_count() == SP == distributed.process_count()
    out = {}
    for form in BLOCK_FORMS:
        a = block_inputs(form)
        with distributed.no_space():
            want = block_run(a, False)
        got = block_run(a, True)
        errs = {}
        for what, g, w in (("out", got[0], want[0]), ("dx", got[1], want[1])):
            w = torch.from_numpy(np.ascontiguousarray(
                zw.local(w.numpy(), w.shape[0])))
            errs[what] = float((g - w).abs().max() / w.abs().max())
        # the parameters' gradients against the largest of them all
        top = max(float(w.abs().max()) for w in want[2].values())
        for k, w in want[2].items():
            errs[k] = float((got[2][k] - w).abs().max()) / top
        out[form] = errs
    return out


# ------------------------------------------------------------ the steps

def run_unet(remat: bool) -> dict:
    """One U-Net step (w4, 64^2, global batch 4, float32) with
    ``block_pallas`` (and ``remat_unet`` with ``remat``) on the rank's
    part of tests/torch_spatial_worker.py's batch."""
    from smsut_tpu_torch.ops import block
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    cfg = sw.step_cfg(spatial_parallel=distributed.space_count(),
                      block_pallas=True, remat_unet=remat)
    mesh.check_config(cfg)
    algo = SupervisedUNet(cfg, device="cpu")
    state = algo.init_state(0)
    img, msk = sw.step_batch()
    routed = block.basic_block.routed
    state, m = algo.train_step(state, {"img": zw.local(img),
                                       "msk": zw.local(msk)})
    _save("remat" if remat else "step", state.params)
    return {"loss": sw.mean(m["loss"]), "sha": sw.tree_sha(state.params),
            "checksum": zw.checksum(state.params),
            "routed": block.basic_block.routed - routed}


def run_gan() -> dict:
    """One ``uganConsis`` step with ``block_pallas`` on the rank's part of
    the parent's batch, fed the parent's draws (the JAX step's)."""
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    raw = np.load(os.path.join(OUT, "gan.npz"))
    cfg = sw.gan_cfg(spatial_parallel=distributed.space_count(),
                     block_pallas=True)
    mesh.check_config(cfg, gan=True)
    batch = {k: zw.local(raw[k]) for k in ("img", "msk", "ul_img")}
    sl = distributed.local_batch_slice(4)
    batch.update(mdl=raw["mdl"][sl], ul_mdl=raw["ul_mdl"][sl],
                 mj=int(raw["mj"]), alpha=raw["alpha"],
                 patch_ids=raw["patch_ids"])
    algo = UGANConsisAlgo(cfg, device="cpu")
    state, m = algo.train_step(algo.init_state(0), batch,
                               algo.epoch_scalars(1))
    return {"metrics": {k: sw.mean(v) for k, v in m.items()},
            "g_sha": sw.tree_sha(state.g_params),
            "d_sha": sw.tree_sha(state.d_params)}


def run_mean_teacher() -> dict:
    """Three Mean Teacher steps with ``block_pallas`` from count 99 (the
    consistency's gate opens inside), tests/torch_spatial_zoo_worker.py's
    batches."""
    from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher

    zw.OUT = OUT
    algo = MeanTeacher(zw.cfg(block_pallas=True), device="cpu")
    out = {}
    zw.steps(algo, zw.at_count(algo, zw.START["meanTeacher"]), zw.batches(),
             out)
    del out["step1"]
    return out


MODES = {"ops": run_ops, "step": lambda: run_unet(False),
         "remat": lambda: run_unet(True), "gan": run_gan,
         "meanTeacher": run_mean_teacher}


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
            with open(os.path.join(OUT, f"{mode}.{rank}.json"), "w") as f:
                json.dump({"error": traceback.format_exc()}, f)
            return 1   # the others may wait in a collective: stop
        out.update(rank=rank, world=distributed.process_count(),
                   space=distributed.space_count())
        with open(os.path.join(OUT, f"{mode}.{rank}.json"), "w") as f:
            json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
