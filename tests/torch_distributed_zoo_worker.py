# -*- coding: utf-8 -*-
"""One rank of the zoo's data-parallel tests
(tests/test_torch_distributed_zoo.py).

Joins a gloo group on the CPU from the ``SMSUT_*`` contract, runs every
mode of ``SMSUT_MODES`` in turn and writes ``{mode}.{rank}.json`` into
``SMSUT_DIST_DIR``.  Imports the port only, never JAX.  Each mode is a
function of the rank's rows (``rows``); the parent runs the same function
in one process at the global batch (all rows, no group):

- ``meanTeacher``, ``crossPse``, ``M3L``: :data:`STEPS` steps of the
  algorithm on the rank's rows of seeded global batches, the draws made
  inside the step (Mean Teacher's noise, M3L's mask grid), Mean Teacher
  from count 99 so that its gate opens inside the run;
- ``bn``: ``batch_norm`` alone in float64, forward and gradient;
- ``dtc``: :data:`STEPS` SGD steps of ``DTCUNet`` (batch norm, ReLU)
  on a loss over both heads;
- ``uganConsis``: one step at a global batch of 2 + 2, one labelled and
  one unlabelled row a rank, so that every PatchNCE group straddles the
  two ranks.
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
STEPS = 3
START = 99          # Mean Teacher's count: the gate opens at 100
EPOCH = 7           # lambda_semi's rampup inside (0, 1)
SIZE, BATCH = 32, 4
GAN_CFG = dict(input_size=32, base_width=8, batch_size=2, nce_patches=4,
               compute_dtype="float32", num_iter_per_epoch=10, max_epoch=2,
               consis_gate_step=0)


def tree_sha(tree) -> str:
    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(np.ascontiguousarray(tree[k].detach().numpy()).tobytes())
    return h.hexdigest()


def checksum(tree) -> float:
    return float(sum(float(v.detach().abs().sum()) for v in tree.values()))


def distributed_mean(x: torch.Tensor) -> torch.Tensor:
    return mesh.mean_over_ranks(x.detach().reshape(()))


def halves_differ(msk: np.ndarray) -> np.ndarray:
    """``msk`` with labels 1 and 2 cleared in its second half of rows."""
    half = msk[msk.shape[0] // 2:]
    half[(half == 1) | (half == 2)] = 0
    return msk


def zoo_cfg(**kw) -> Config:
    return Config(input_size=SIZE, base_width=8, batch_size=BATCH,
                  num_iter_per_epoch=10, max_epoch=20,
                  compute_dtype="float32", **kw)


def batches(n: int = STEPS, b: int = BATCH, seed: int = 3) -> list:
    """Seeded global batches; labels 1 and 2 cleared in each batch's
    second half of rows, so that a rank's Dice alone differs from the
    global one."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append({
            "img": rng.normal(size=(b, SIZE, SIZE, 1)).astype(np.float32),
            "msk": halves_differ(rng.integers(0, 5, size=(b, SIZE, SIZE))
                                 .astype(np.int32)),
            "ul_img": rng.normal(size=(b, SIZE, SIZE, 1)).astype(np.float32)})
    return out


def rows() -> slice:
    """This rank's rows of the global batch (all of them in one
    process)."""
    return distributed.local_batch_slice(BATCH)


def trees(name: str, state) -> dict:
    return {"params": state.params, **({"ema": state.ema_params}
                                       if state.ema_params is not None
                                       else {}),
            **({"params2": state.params2} if state.params2 is not None
               else {})}


def run_algo(name: str) -> dict:
    """:data:`STEPS` steps of the zoo algorithm ``name`` on this process's
    rows: :func:`record` of each step, and what the step drew (Mean
    Teacher's noise, M3L's mask grid; as lists)."""
    from smsut_tpu_torch.serve import factories
    from smsut_tpu_torch.train.steps import m3l, mean_teacher

    algo = factories()[name][1](zoo_cfg(), "cpu")
    state = algo.init_state(0)
    if name == "meanTeacher":
        state.step = START
        state.count.fill_(START)
    sl = rows()
    out = {"metrics": [], "checksums": [], "shas": [], "drawn": []}
    # the draws the step makes: Mean Teacher's noise, M3L's mask grid
    mod, fn = {"meanTeacher": (mean_teacher, "teacher_noise"),
               "M3L": (m3l, "mask_grid")}.get(name, (None, None))
    real = mod and getattr(mod, fn)
    if mod:
        def drawing(*a):
            out["drawn"].append(real(*a))
            return out["drawn"][-1]
        setattr(mod, fn, drawing)
    try:
        for b in batches():
            b = {k: v[sl] for k, v in b.items()}
            state, m = algo.train_step(state, b, algo.epoch_scalars(EPOCH))
            record(out, name, state, m)
    finally:
        if mod:
            setattr(mod, fn, real)
    out["drawn"] = [d.tolist() for d in out["drawn"]]
    return out


def record(out: dict, name: str, state, m) -> None:
    """A step's metrics (averaged over the group), the checksum and sha of
    each parameter tree, and the student's parameters after the first."""
    out["metrics"].append({k: float(distributed_mean(v))
                           for k, v in m.items()})
    t = trees(name, state)
    out["checksums"].append({k: checksum(v) for k, v in t.items()})
    out["shas"].append({k: tree_sha(v) for k, v in t.items()})
    if "params" not in out:
        out["params"] = {k: v.tolist() for k, v in state.params.items()}


def bn_inputs():
    rng = np.random.default_rng(9)
    x = 1.5 + rng.normal(size=(BATCH, 6, 6, 8))
    cot = rng.normal(size=(BATCH, 6, 6, 8))
    return x, cot, 1 + 0.1 * rng.normal(size=8), 0.1 * rng.normal(size=8)


def run_bn() -> dict:
    """``batch_norm`` in float64 on this process's rows: its output rows,
    the gradient of sum(y * cot) in those rows, and the scale's and bias's
    gradients summed over the group."""
    from smsut_tpu_torch.models.layers import batch_norm

    x, cot, scale, bias = (torch.from_numpy(a) for a in bn_inputs())
    sl = rows()
    x = x[sl].clone().requires_grad_()
    scale, bias = scale.requires_grad_(), bias.requires_grad_()
    y = batch_norm(x, scale, bias)
    (y * cot[sl]).sum().backward()
    sums = mesh.batch_sums(scale.grad, bias.grad)
    return {"y": y.tolist(), "dx": x.grad.tolist(),
            "dscale": sums[0].tolist(), "dbias": sums[1].tolist()}


def sign_map(msk: torch.Tensor, n: int) -> torch.Tensor:
    """The tanh head's target, DTC's signed map at its coarsest: +1 inside
    each class's region, -1 outside, per class channel."""
    return 2.0 * torch.nn.functional.one_hot(msk, n).to(torch.float32) - 1.0


def run_dtc() -> dict:
    """:data:`STEPS` SGD steps (lr 0.01, the gradients averaged over the
    group) of ``DTCUNet(5, 8)`` with batch norm and ReLU on the Dice+CE
    of its logits plus the squared error of its tanh head against
    :func:`sign_map`: the loss (averaged over the group), checksum and sha
    after each step."""
    from smsut_tpu_torch.models.dtc import DTCUNet
    from smsut_tpu_torch.ops.losses import dice_and_ce_loss

    net = DTCUNet(5, 8, compute_dtype=torch.float32, device="cpu")
    params = {k: v.detach().clone() for k, v in net.named_parameters()}
    sl = rows()
    out = {"losses": [], "checksums": [], "shas": []}
    for b in batches():
        x = torch.from_numpy(b["img"][sl])
        msk = torch.from_numpy(b["msk"][sl]).long()
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        tanh, logits = torch.func.functional_call(net, leaves, (x,))
        loss = (dice_and_ce_loss(logits, msk)
                + (tanh - sign_map(msk, tanh.shape[-1])).square().mean())
        grads = mesh.reduce_gradients_(dict(zip(
            leaves, torch.autograd.grad(loss, list(leaves.values())))))
        params = {k: (v - 0.01 * grads[k]).detach()
                  for k, v in leaves.items()}
        out["losses"].append(float(distributed_mean(loss)))
        out["checksums"].append(checksum(params))
        out["shas"].append(tree_sha(params))
    return out


def gan_batch() -> dict:
    rng = np.random.default_rng(5)
    b, s = GAN_CFG["batch_size"], GAN_CFG["input_size"]
    return {"img": (0.5 * rng.normal(size=(b, s, s, 1))).astype(np.float32),
            "msk": rng.integers(0, 5, size=(b, s, s)).astype(np.int32),
            "mdl": np.full(b, 1, np.int32),
            "ul_img": (0.5 * rng.normal(size=(b, s, s, 1))).astype(
                np.float32),
            "ul_mdl": np.full(b, 2, np.int32)}


def run_gan() -> dict:
    """One uganConsis step at a global batch of 2 + 2 on this process's
    rows, the draws from the algorithm's own generator (the same on every
    rank and in one process): the metrics (averaged over the group) and
    the G and D checksums and shas."""
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    cfg = Config(**GAN_CFG)
    algo = UGANConsisAlgo(cfg, device="cpu")
    state = algo.init_state(0)
    sl = distributed.local_batch_slice(cfg.batch_size)
    batch = {k: v[sl] for k, v in gan_batch().items()}
    batch.update(algo.make_extra_batch())
    state, m = algo.train_step(state, batch, algo.epoch_scalars(1))
    return {"metrics": {k: float(distributed_mean(v)) for k, v in m.items()},
            "g_checksum": checksum(state.g_params),
            "d_checksum": checksum(state.d_params),
            "g_sha": tree_sha(state.g_params),
            "d_sha": tree_sha(state.d_params)}


MODES = {"meanTeacher": lambda: run_algo("meanTeacher"),
         "crossPse": lambda: run_algo("crossPse"),
         "M3L": lambda: run_algo("M3L"), "bn": run_bn, "dtc": run_dtc,
         "uganConsis": run_gan}


def main() -> int:
    torch.set_num_threads(2)
    assert distributed.initialize(device="cpu", timeout_s=120), \
        "SMSUT_* variables must be set"
    rank = distributed.process_index()
    for mode in os.environ["SMSUT_MODES"].split(","):
        try:
            out = MODES[mode]()
        except Exception:
            traceback.print_exc()
            with open(os.path.join(OUT, f"{mode}.{rank}.json"), "w") as f:
                json.dump({"error": traceback.format_exc()}, f)
            return 1   # the other rank may wait in a collective: stop
        out.update(rank=rank, world=distributed.process_count(),
                   backend=distributed.backend())
        with open(os.path.join(OUT, f"{mode}.{rank}.json"), "w") as f:
            json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
