# -*- coding: utf-8 -*-
"""One rank of the zoo's model-axis tests
(tests/test_torch_tensor_parallel_zoo.py).

Joins a gloo group on the CPU from the ``SMSUT_*`` contract, lays it out
as ``dp x tp`` (``SMSUT_TP``, ``parallel/mesh.py`` ``make_mesh_2d``), runs
every mode of ``SMSUT_MODES`` in turn and writes ``{mode}.{rank}.json``
(and rank 0's whole trees, gathered over the model group, as
``{name}.npz``) into ``SMSUT_DIST_DIR``, where the parent also left its
inputs (``draws.npz``: the JAX steps' teacher noise and mask grids).
Imports the port only, never JAX.  Each mode is a function of the rank's
rows of every global batch (its data coordinate's) and of the state
sharded over the layout (:func:`shard`); the parent runs the same
function in one process, where the rows are the whole batch and nothing
is sharded:

- ``meanTeacher``: one step from count 100 fed the parent's noise (the
  JAX step's), and :data:`STEPS` steps from count 99 drawing the noise in
  the step; ``crossPse``: :data:`STEPS` steps;
- ``coraNet``: :data:`STEPS` steps of stage A from count 0 and of stage
  B from count 999 on seeded pseudo batches, and the pseudo-label sweep;
- ``M3L``: the eval forward of the initial weights, :data:`STEPS` float32
  steps drawing the mask grid in the step (the first step's gradient
  recovered from Adam's first moment), and :data:`STEPS` float64 steps
  fed the parent's grids (the JAX step's);
- ``dtc``: :data:`STEPS` SGD steps of ``DTCUNet(5, 8)`` with batch norm;
- ``eval``: each algorithm's ``eval_fn`` on the initial weights;
- ``save``: CPS (float32) and M3L (float64) one step, ``save_state``,
  one more step; ``load``: those files (another group's, in
  ``SMSUT_CKPT_DIR``) loaded into this layout, one step from each.
"""
import contextlib
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

OUT = os.environ.get("SMSUT_DIST_DIR", "")
TP = int(os.environ.get("SMSUT_TP", "2"))
CKPT = os.environ.get("SMSUT_CKPT_DIR", "")
SIZE, WIDTH, BATCH = 32, 8, 4
M3L_BATCH = 2        # the SegFormer at its own widths: 2 + 2 images
STEPS = 2
EPOCH = 7            # lambda_semi's rampup inside (0, 1)
START = {"meanTeacher": 99, "crossPse": 0, "pre": 0, "cora": 999}
MT_JAX_COUNT = 100   # the JAX comparison's count: the consistency is live
TREES = ("params", "ema_params", "params2")
# this process's layout: None in one process (nothing sharded)
LAYOUT = [None]


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def tree_sha(tree) -> str:
    return sha(*(tree[k].detach().cpu().numpy() for k in sorted(tree)))


def save(name: str, **arrays) -> None:
    """Rank 0's (or the one process's) arrays as ``{name}.npz``."""
    if distributed.is_primary():
        np.savez(os.path.join(OUT, f"{name}.npz"), **{
            k: v.detach().cpu().numpy() if torch.is_tensor(v) else v
            for k, v in arrays.items()})


def mean(x: torch.Tensor) -> float:
    return float(mesh.mean_over_ranks(x.detach().reshape(())))


def cfg(**kw) -> Config:
    return Config(**dict(dict(
        input_size=SIZE, base_width=WIDTH, batch_size=BATCH,
        num_iter_per_epoch=10, max_epoch=20, pre_epoch=30, cora_epoch=200,
        compute_dtype="float32"), **kw))


def shard(tree):
    """``tree`` (a train state or a parameter mapping) sharded over this
    process's layout; as it is in one process."""
    return tree if LAYOUT[0] is None else mesh.shard_params_channelwise(
        LAYOUT[0], tree)


def whole(state) -> dict:
    """The state's parameter trees gathered whole, by ``tree/key``
    (every rank takes part)."""
    out = {}
    for t in TREES:
        if getattr(state, t) is not None:
            g = mesh.gather_tree(getattr(state, t), state.shards)
            out.update({f"{t}/{k}": v for k, v in g.items()})
    return out


def batches(n: int = STEPS, seed: int = 3, pseudo: bool = False,
            b: int = BATCH) -> list:
    """Seeded global batches of ``b`` + ``b`` images; with ``pseudo``
    CoraNet's pseudo batch too (images, labels, a 0/1 mask)."""
    rng = np.random.default_rng(seed)
    img = lambda: rng.normal(size=(b, SIZE, SIZE, 1)).astype(np.float32)
    lab = lambda: rng.integers(0, 5, size=(b, SIZE, SIZE)).astype(np.int32)
    out = []
    for _ in range(n):
        x = {"img": img(), "msk": lab(), "ul_img": img()}
        if pseudo:
            x.update(pse_img=img(), pse_lab=lab(),
                     pse_mask=rng.integers(0, 2, size=(b, SIZE, SIZE))
                     .astype(np.float32))
        out.append(x)
    return out


def local(batch: dict, b: int = BATCH) -> dict:
    """The rank's rows of each array of a global batch: its data
    coordinate's (the whole in one process)."""
    sl = distributed.local_batch_slice(b)
    return {k: v[sl] for k, v in batch.items()}


def draws() -> dict:
    with np.load(os.path.join(OUT, "draws.npz")) as z:
        return {k: z[k] for k in z.files}


def at_count(algo, count: int):
    state = algo.init_state(0)
    state.step = count
    state.count.fill_(count)
    return state


@contextlib.contextmanager
def drawing(module, fn: str, drawn: list):
    """Within it ``module.fn`` (a draw the step makes) records what it
    returns in ``drawn``."""
    real = getattr(module, fn)

    def record(*a):
        drawn.append(real(*a))
        return drawn[-1]

    setattr(module, fn, record)
    try:
        yield
    finally:
        setattr(module, fn, real)


def steps(algo, state, data: list, out: dict, b: int = BATCH,
          feed: list = ()) -> object:
    """The steps of ``algo`` on the rank's rows of each batch of ``data``
    (step k fed ``feed[k]`` where given): per step the metrics (averaged
    over the group) and the sha of the state's whole trees; the state
    after the last."""
    for k, x in enumerate(data):
        x = local(x, b)
        if k < len(feed):
            x.update(feed[k])
        state, m = algo.train_step(state, x, algo.epoch_scalars(EPOCH))
        out.setdefault("metrics", []).append(
            {n: mean(v) for n, v in m.items()})
        out.setdefault("shas", []).append(tree_sha(whole(state)))
    return state


# ------------------------------------------------------------------ modes

def run_mean_teacher() -> dict:
    from smsut_tpu_torch.train.steps import mean_teacher
    from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher

    algo = MeanTeacher(cfg(), device="cpu")
    # one step from the JAX comparison's count, fed the JAX step's noise
    b = batches(1, seed=4)[0]
    noise = draws()["noise"]
    state, m = algo.train_step(
        shard(at_count(algo, MT_JAX_COUNT)),
        dict(local(b), noise=noise[distributed.local_batch_slice(BATCH)]),
        algo.epoch_scalars(EPOCH))
    out = {"jax_step": {k: mean(v) for k, v in m.items()}}
    save("meanTeacher_jax", **whole(state))
    drawn = []
    with drawing(mean_teacher, "teacher_noise", drawn):
        state = steps(algo, shard(at_count(algo, START["meanTeacher"])),
                      batches(), out)
    out["drawn"] = [sha(d.numpy()) for d in drawn]
    save("meanTeacher", **whole(state))
    return out


def run_cross_pseudo() -> dict:
    from smsut_tpu_torch.train.steps.cross_pseudo import CrossPseudo

    algo = CrossPseudo(cfg(), device="cpu")
    out = {}
    state = steps(algo, shard(algo.init_state(0)), batches(), out)
    save("crossPse", **whole(state))
    return out


def pseudo_samples(n: int = 6, seed: int = 8) -> list:
    """Seeded whole samples ``(img [H,W,1], lab [H,W], mdl)`` of the
    pseudo-label sweep (two chunks of :data:`BATCH`, the last padded)."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(SIZE, SIZE, 1)).astype(np.float32),
             rng.integers(0, 5, size=(SIZE, SIZE)).astype(np.int64), 1)
            for _ in range(n)]


def run_coranet() -> dict:
    from smsut_tpu_torch.train.steps.coranet import CoraNet

    out = {}
    for stage in ("pre", "cora"):
        algo = CoraNet(cfg(), device="cpu", stage=stage)
        r = out[stage] = {}
        state = steps(algo, shard(at_count(algo, START[stage])),
                      batches(seed=5, pseudo=stage == "cora"), r)
        save(f"coraNet_{stage}", **whole(state))
    algo = CoraNet(cfg(), device="cpu", stage="cora")
    data, dice = algo.pred_unlabel(shard(algo.init_state(0)),
                                   iter(pseudo_samples()), capture=False)
    out["sweep"] = {"dice": dice, "sha": sha(*(data[k] for k in sorted(data)))}
    save("coraNet_sweep", **data)
    return out


def m3l_algo(dtype: torch.dtype = torch.float32):
    """M3L at :data:`M3L_BATCH` + :data:`M3L_BATCH` (its net and fresh
    states in ``dtype``)."""
    from smsut_tpu_torch.train.steps.m3l import M3L

    algo = M3L(cfg(batch_size=M3L_BATCH), device="cpu")
    if dtype == torch.float64:
        algo.net.double().compute_dtype = torch.float64
        make = algo.state_from_params

        def wide(params, ema_params=None):
            st = make(params, ema_params)
            for tree in st.trees():
                tree.update({k: v.double() for k, v in tree.items()})
            return st
        algo.state_from_params = wide
    return algo


def first_gradient(state, p0) -> dict:
    """The gradient Adam's first update of ``state`` took (averaged over
    the group), whole, from its first moment ``(1 - b1) (g + wd p0)``,
    ``p0`` the whole parameters before the update."""
    tx = state.tx
    mu = mesh.gather_tree(state.opt_state.mu, state.shards)
    return {k: m / (1.0 - tx.b1) - tx.weight_decay * p0[k]
            for k, m in mu.items()}


def run_m3l() -> dict:
    from smsut_tpu_torch.train.steps import m3l

    out = {}
    algo = m3l_algo()
    state = shard(algo.init_state(0))
    data = batches(seed=7, b=M3L_BATCH)
    logits = algo.eval_fn(algo.eval_params(state), data[0]["img"])
    out["eval_sha"] = sha(logits.numpy())
    save("M3L_eval", logits=logits)
    p0 = {k: v.clone() for k, v in
          mesh.gather_tree(state.params, state.shards).items()}
    drawn, r = [], out.setdefault("f32", {})
    with drawing(m3l, "mask_grid", drawn):
        state = steps(algo, state, data[:1], r, M3L_BATCH)
        save("M3L_step1", **whole(state))
        save("M3L_grad1", **first_gradient(state, p0))
        state = steps(algo, state, data[1:], r, M3L_BATCH)
    out["drawn"] = [sha(d.numpy()) for d in drawn]
    save("M3L", **whole(state))
    # float64, fed the JAX step's grids: the JAX comparisons' run
    algo = m3l_algo(torch.float64)
    grids = draws()
    r = out.setdefault("f64", {})
    state = steps(algo, shard(algo.init_state(0)), data[:1], r, M3L_BATCH,
                  [{"mask": grids["grid0"]}])
    save("M3L64_step1", **whole(state))
    state = steps(algo, state, data[1:], r, M3L_BATCH,
                  [{"mask": grids["grid1"]}])
    save("M3L64", **whole(state))
    return out


def sign_map(msk: torch.Tensor, n: int) -> torch.Tensor:
    """The tanh head's target, DTC's signed map at its coarsest: +1 inside
    each class's region, -1 outside, per class channel."""
    return 2.0 * torch.nn.functional.one_hot(msk, n).to(torch.float32) - 1.0


def run_dtc() -> dict:
    """:data:`STEPS` SGD steps (lr 0.01, the gradients reduced over the
    group with the shards' keys) of ``DTCUNet(5, 8)`` with batch norm and
    ReLU on the Dice+CE of its logits plus the squared error of its tanh
    head against :func:`sign_map`."""
    from smsut_tpu_torch.models.dtc import DTCUNet
    from smsut_tpu_torch.ops.losses import dice_and_ce_loss

    net = DTCUNet(5, WIDTH, compute_dtype=torch.float32, device="cpu")
    params = {k: v.detach().clone() for k, v in net.named_parameters()}
    shards = (frozenset() if LAYOUT[0] is None else mesh.sharded_keys(
        {k: v.shape for k, v in params.items()}, TP))
    params = shard(params)
    out = {"metrics": [], "shas": [], "shards": len(shards)}
    for b in batches(seed=6):
        b = local(b)
        x, msk = torch.from_numpy(b["img"]), torch.from_numpy(b["msk"]).long()
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        tanh, logits = torch.func.functional_call(net, leaves, (x,))
        loss = (dice_and_ce_loss(logits, msk)
                + (tanh - sign_map(msk, tanh.shape[-1])).square().mean())
        grads = mesh.reduce_gradients_(dict(zip(
            leaves, torch.autograd.grad(loss, list(leaves.values())))),
            shards)
        params = {k: (v - 0.01 * grads[k]).detach()
                  for k, v in leaves.items()}
        out["metrics"].append({"loss": mean(loss)})
        full = mesh.gather_tree(params, shards)
        out["shas"].append(tree_sha(full))
    save("dtc", **full)
    return out


def zoo_algo(name: str):
    from smsut_tpu_torch.train.steps.coranet import CoraNet
    from smsut_tpu_torch.train.steps.cross_pseudo import CrossPseudo
    from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher

    if name == "M3L":
        return m3l_algo()
    if name == "coraNet":
        return CoraNet(cfg(), device="cpu", stage="cora")
    return {"meanTeacher": MeanTeacher,
            "crossPse": CrossPseudo}[name](cfg(), device="cpu")


EVAL = ("meanTeacher", "crossPse", "coraNet", "M3L")


def run_eval() -> dict:
    out = {}
    img = batches(1, seed=9)[0]["img"]
    for name in EVAL:
        algo = zoo_algo(name)
        logits = algo.eval_fn(shard(algo.init_params(0)), img)
        out[name] = sha(logits.numpy())
        save(f"eval_{name}", logits=logits)
    return out


# the checkpoints across layouts: (algorithm, dtype)
SAVED = {"crossPse": torch.float32, "M3L": torch.float64}


def ckpt_algo(name: str):
    from smsut_tpu_torch.train.steps.cross_pseudo import CrossPseudo

    if name == "M3L":
        return m3l_algo(SAVED[name]), M3L_BATCH
    return CrossPseudo(cfg(), device="cpu"), BATCH


def run_save() -> dict:
    from smsut_tpu_torch.train import checkpoints

    out = {}
    for name in SAVED:
        algo, b = ckpt_algo(name)
        data = batches(seed=10, b=b)
        r = out[name] = {}
        state = steps(algo, shard(algo.init_state(0)), data[:1], r, b)
        checkpoints.save_state(state, CKPT, name)
        r["saved_sha"] = tree_sha(whole(state))
        steps(algo, state, data[1:], r, b)
    if distributed.is_primary():
        open(os.path.join(CKPT, "zoo.done"), "w").close()
    return out


def run_load() -> dict:
    from smsut_tpu_torch.train import checkpoints

    t0 = time.time()
    while not os.path.exists(os.path.join(CKPT, "zoo.done")):
        if time.time() - t0 > 180:
            raise TimeoutError("no zoo checkpoints")
        time.sleep(0.2)
    out = {}
    for name in SAVED:
        algo, b = ckpt_algo(name)
        template = shard(algo.init_state(1))
        state = checkpoints.load_state(template, CKPT, name)
        r = out[name] = {"restored_step": state.step,
                         "loaded_sha": tree_sha(whole(state))}
        state = steps(algo, state, batches(seed=10, b=b)[1:], r, b)
        save(f"load_{name}", **whole(state))
    return out


MODES = {"meanTeacher": run_mean_teacher, "crossPse": run_cross_pseudo,
         "coraNet": run_coranet, "M3L": run_m3l, "dtc": run_dtc,
         "eval": run_eval, "save": run_save, "load": run_load}


def main() -> int:
    torch.set_num_threads(1)
    world = int(os.environ["SMSUT_NUM_PROCESSES"])
    rank = int(os.environ["SMSUT_PROCESS_ID"])
    for mode in os.environ["SMSUT_MODES"].split(","):
        try:
            if not distributed.initialize(device="cpu", timeout_s=120):
                raise AssertionError("SMSUT_* variables must be set")
            LAYOUT[0] = mesh.make_mesh_2d(world // TP, TP)
            out = MODES[mode]()
        except Exception:
            traceback.print_exc()
            with open(os.path.join(OUT, f"{mode}.{rank}.json"), "w") as f:
                json.dump({"error": traceback.format_exc()}, f)
            return 1   # the others may wait in a collective: stop
        out.update(rank=rank, world=distributed.process_count(),
                   model=distributed.model_count())
        with open(os.path.join(OUT, f"{mode}.{rank}.json"), "w") as f:
            json.dump(out, f)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
