# -*- coding: utf-8 -*-
"""One rank of the zoo's space-axis tests (tests/test_torch_spatial_zoo.py).

Joins a gloo group on the CPU from the ``SMSUT_*`` contract, lays it out
as ``dp x sp`` (``SMSUT_SPACE``), runs every mode of ``SMSUT_MODES`` in
turn and writes ``{mode}.{rank}.json`` (and rank 0's tensors as
``{mode}.npz``) into ``SMSUT_DIST_DIR``, where the parent also left its
inputs (``draws.npz``: the JAX step's teacher noise; the synthetic tree
``data/``).  Imports the port only, never JAX.  Each mode is a function
of the rank's part of every input (:func:`local`: its data coordinate's
batch rows, its space coordinate's image rows); the parent runs the same
function in one process, where that part is the whole:

- ``ops``: the SegFormer's layers that meet their neighbours (the 7x7
  stride-4 and 3x3 stride-2 patch convs, the depthwise 3x3, attention
  with its keys and values reduced and gathered, and at ratio 1, the
  head's resizes by 2, 4 and 8) and the row gather itself, on the rank's
  rows against the same layer on whole images in this process: the
  forward, the gradient of a weighted square's sum in the input taken
  with ``create_graph``, and that gradient's own gradient in the input
  and the parameters;
- ``meanTeacher``: one step from count 100 fed the parent's noise (the
  JAX step's), and :data:`STEPS` steps from count 99 drawing the noise in
  the step; ``crossPse``: :data:`STEPS` steps;
- ``coraNet``: :data:`STEPS` steps of stage A from count 0 and of stage
  B from count 999 on seeded pseudo batches, and the pseudo-label sweep;
- ``dtc``: :data:`STEPS` SGD steps of ``DTCUNet(5, 8)`` with batch norm;
- ``M3L``: the eval forward's logits of the initial weights, then
  :data:`STEPS` steps drawing the mask grid in the step (the first
  step's gradient recovered from Adam's first moment);
- ``fit``: ``coraNetTrainer -p train`` through both stages;
- ``refuse``: what the space axis still refuses, and the fused block
  kernels it now takes.
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
SIZE, BATCH = 64, 4
STEPS = 3
EPOCH = 7            # lambda_semi's rampup inside (0, 1)
START = {"meanTeacher": 99, "crossPse": 0, "pre": 0, "cora": 999, "M3L": 0}
MT_JAX_COUNT = 100   # the JAX comparison's count: the consistency is live
AUG64 = dict(Config().data_aug, resizeCrop_size=SIZE)


def sha(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def tree_sha(tree) -> str:
    return sha(*(tree[k].detach().cpu().numpy() for k in sorted(tree)))


def checksum(tree) -> float:
    return float(sum(float(v.detach().double().abs().sum())
                     for v in tree.values()))


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
        input_size=SIZE, base_width=4, batch_size=BATCH,
        num_iter_per_epoch=10, max_epoch=20, pre_epoch=30, cora_epoch=200,
        compute_dtype="float32",
        spatial_parallel=distributed.space_count()), **kw))


def lower_half_cleared(msk: np.ndarray) -> np.ndarray:
    """``msk`` [B, H, W] with labels 1 and 2 cleared in the lower half of
    each image's rows, so that one rank's Dice alone differs from the
    whole image's."""
    low = msk[:, msk.shape[1] // 2:]
    low[(low == 1) | (low == 2)] = 0
    return msk


def batches(n: int = STEPS, seed: int = 3, pseudo: bool = False) -> list:
    """Seeded global batches of :data:`BATCH` + :data:`BATCH` images; with
    ``pseudo`` CoraNet's pseudo batch too (images, labels, a 0/1 mask)."""
    rng = np.random.default_rng(seed)
    img = lambda: rng.normal(size=(BATCH, SIZE, SIZE, 1)).astype(np.float32)
    lab = lambda: lower_half_cleared(rng.integers(
        0, 5, size=(BATCH, SIZE, SIZE)).astype(np.int32))
    out = []
    for _ in range(n):
        b = {"img": img(), "msk": lab(), "ul_img": img()}
        if pseudo:
            b.update(pse_img=img(), pse_lab=lab(),
                     pse_mask=rng.integers(0, 2, size=(BATCH, SIZE, SIZE))
                     .astype(np.float32))
        out.append(b)
    return out


def local(a, global_batch: int = BATCH):
    """The rank's part of a whole-image array or tensor: its data
    coordinate's rows of the batch and, of each image, its space
    coordinate's rows (the whole in one process)."""
    a = a[distributed.local_batch_slice(global_batch)]
    return a[:, mesh.space_slice(a.shape[1])]


def rows_t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(local(a)))


# ------------------------------------------------------------------- ops

class _Attention(torch.nn.Module):
    """``EfficientAttention`` on an NHWC map (its tokens, row-major)."""

    def __init__(self, dim: int, sr: int, g):
        super().__init__()
        from smsut_tpu_torch.models.segformer import EfficientAttention

        self.attn = EfficientAttention(dim, 2, sr, g)

    def forward(self, x):
        b, h, w, c = x.shape
        return self.attn(x.reshape(b, h * w, c), h, w).reshape(b, h, w, c)


class _Resize(torch.nn.Module):
    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x):
        from smsut_tpu_torch.models.layers import resize_bilinear

        return resize_bilinear(x, self.factor * x.shape[1],
                               self.factor * x.shape[2])


class _Gather(torch.nn.Module):
    """The row gather: whole images out on every rank of the group."""

    def forward(self, x):
        return mesh.space_gather(x)


def op_cases():
    """name -> (module, whole input shape [B, H, W, C])."""
    from smsut_tpu_torch.models.segformer import DepthwiseConv3x3, PatchConv

    g = torch.Generator().manual_seed(3)
    return {"patch7s4": (PatchConv(3, 8, 7, 4, g), (2, 16, 8, 3)),
            "patch3s2": (PatchConv(8, 16, 3, 2, g), (2, 8, 4, 8)),
            "dwconv": (DepthwiseConv3x3(8, g), (2, 8, 4, 8)),
            "attention_sr2": (_Attention(8, 2, g), (2, 8, 4, 8)),
            "attention_sr1": (_Attention(8, 1, g), (2, 4, 4, 8)),
            "resize2": (_Resize(2), (2, 4, 4, 8)),
            "resize4": (_Resize(4), (2, 4, 4, 8)),
            "resize8": (_Resize(8), (2, 4, 4, 8)),
            "gather": (_Gather(), (2, 4, 4, 8))}


def op_run(mod, x, c, e, split: bool, whole_out: bool):
    """(y, d(y^2.c)/dx with create_graph, and the gradients of that
    gradient's square weighted by e in x and in the parameters, the
    latter summed over the space group), on the rank's rows with
    ``split``, else on whole images.  ``whole_out``: the op's output is
    whole on every rank (the gather), so rank r weighs it by ``(1 + r) c``
    and one process by the sum of those weights."""
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in mod.named_parameters()}
    x = x.detach().clone().requires_grad_()
    y = torch.func.functional_call(mod, leaves, (x,))
    sp = distributed.space_count()
    if whole_out:
        c = torch.from_numpy(c) * (1 + distributed.space_index() if split
                                   else SP * (SP + 1) / 2)
    else:
        c = rows_t(c) if split else torch.from_numpy(c)
    s = (y * y * c).sum()
    gx, = torch.autograd.grad(s, x, create_graph=True)
    loss = (gx * gx * (rows_t(e) if split else torch.from_numpy(e))).sum()
    got = torch.autograd.grad(loss, [x] + list(leaves.values()))
    grads = {k: mesh.space_sum(v.detach()) if split and sp > 1
             else v.detach() for k, v in zip(leaves, got[1:])}
    return y.detach(), gx.detach(), got[0].detach(), grads


def run_ops() -> dict:
    assert distributed.space_count() == SP == distributed.process_count()
    rng = np.random.default_rng(11)
    out = {}
    for name, (mod, shape) in op_cases().items():
        whole_out = name == "gather"
        x = rng.normal(size=shape).astype(np.float32)
        with distributed.no_space(), torch.no_grad():
            y0 = mod(torch.from_numpy(x))
        c = rng.normal(size=y0.shape).astype(np.float32)
        e = rng.normal(size=x.shape).astype(np.float32)
        with distributed.no_space():
            want = op_run(mod, torch.from_numpy(x), c, e, False, whole_out)
        got = op_run(mod, rows_t(x), c, e, True, whole_out)
        errs = {}
        for what, a, b in (("y", got[0], want[0]), ("dx", got[1], want[1]),
                           ("ddx", got[2], want[2])):
            if not (whole_out and what == "y"):
                b = torch.from_numpy(np.ascontiguousarray(local(b.numpy())))
            errs[what] = float((a - b).abs().max() / b.abs().max())
        # the parameters' gradients against the largest of them all (the
        # keys' bias has none: a shift of every key moves no softmax)
        top = max((float(v.abs().max()) for v in want[3].values()),
                  default=1.0)
        for k, v in want[3].items():
            errs[k] = float((got[3][k] - v).abs().max()) / top
        out[name] = errs
    return out


# ------------------------------------------------------- the zoo's steps

def drawing(module, fn: str, drawn: list):
    """A context in which ``module.fn`` (a draw the step makes) records
    what it returns in ``drawn``."""
    import contextlib

    real = getattr(module, fn)

    def record(*a):
        drawn.append(real(*a))
        return drawn[-1]

    @contextlib.contextmanager
    def ctx():
        setattr(module, fn, record)
        try:
            yield
        finally:
            setattr(module, fn, real)
    return ctx()


def at_count(algo, count: int):
    state = algo.init_state(0)
    state.step = count
    state.count.fill_(count)
    return state


def trees(state) -> dict:
    return {k: getattr(state, k) for k in ("params", "ema_params", "params2")
            if getattr(state, k) is not None}


def first_gradient(state, p0) -> dict:
    """The gradient Adam's first update of ``state`` took (averaged over
    the group), from its first moment ``(1 - b1) (g + wd p0)``, ``p0`` the
    parameters before the update."""
    tx = state.tx
    return {k: m / (1.0 - tx.b1) - tx.weight_decay * p0[k]
            for k, m in state.opt_state.mu.items()}


def steps(algo, state, data: list, out: dict) -> None:
    """The steps of ``algo`` on the rank's part of each batch of ``data``:
    per step the metrics (averaged over the group), each tree's checksum
    and sha; the student after the first step as ``out["step1"]``, and
    under Adam the first step's gradient as ``out["grad1"]``."""
    adam = hasattr(state.opt_state, "mu")
    p0 = {k: v.detach().clone() for k, v in state.params.items()}
    for b in data:
        b = {k: local(v) if not k.startswith("pse_") else
             v[distributed.local_batch_slice(BATCH)] for k, v in b.items()}
        state, m = algo.train_step(state, b, algo.epoch_scalars(EPOCH))
        out.setdefault("metrics", []).append(
            {k: mean(v) for k, v in m.items()})
        t = trees(state)
        out.setdefault("checksums", []).append(
            {k: checksum(v) for k, v in t.items()})
        out.setdefault("shas", []).append({k: tree_sha(v)
                                           for k, v in t.items()})
        if "step1" not in out:
            out["step1"] = {k: v.detach().clone()
                            for k, v in state.params.items()}
            if adam:
                out["grad1"] = first_gradient(state, p0)


def run_mean_teacher() -> dict:
    from smsut_tpu_torch.train.steps import mean_teacher
    from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher

    algo = MeanTeacher(cfg(), device="cpu")
    # step 1 from the JAX comparison's count, fed the JAX step's noise
    b = batches(1, seed=4)[0]
    noise = np.load(os.path.join(OUT, "draws.npz"))["noise"]
    state, m = algo.train_step(at_count(algo, MT_JAX_COUNT),
                               dict({k: local(v) for k, v in b.items()},
                                    noise=local(noise)),
                               algo.epoch_scalars(EPOCH))
    out = {"jax_step": {k: mean(v) for k, v in m.items()},
           "jax_step_sha": tree_sha(state.params)}
    save("meanTeacher_jax", **state.params,
         **{f"ema:{k}": v for k, v in state.ema_params.items()})
    drawn = []
    with drawing(mean_teacher, "teacher_noise", drawn):
        steps(algo, at_count(algo, START["meanTeacher"]), batches(), out)
    out["drawn"] = [sha(d.numpy()) for d in drawn]
    save("meanTeacher_drawn", **{str(k): d for k, d in enumerate(drawn)})
    del out["step1"]
    return out


def run_cross_pseudo() -> dict:
    from smsut_tpu_torch.train.steps.cross_pseudo import CrossPseudo

    algo = CrossPseudo(cfg(), device="cpu")
    state = algo.init_state(0)
    out = {}
    steps(algo, state, batches(), out)
    save("crossPse_step1", **out.pop("step1"))
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
        steps(algo, at_count(algo, START[stage]),
              batches(seed=5, pseudo=stage == "cora"), r)
        del r["step1"]
    algo = CoraNet(cfg(), device="cpu", stage="cora")
    data, dice = algo.pred_unlabel(algo.init_state(0), iter(pseudo_samples()),
                                   capture=False)
    out["sweep"] = {"dice": dice, "sha": sha(*(data[k] for k in sorted(data)))}
    save("coraNet_sweep", **data)
    return out


def sign_map(msk: torch.Tensor, n: int) -> torch.Tensor:
    """The tanh head's target, DTC's signed map at its coarsest: +1 inside
    each class's region, -1 outside, per class channel."""
    return 2.0 * torch.nn.functional.one_hot(msk, n).to(torch.float32) - 1.0


def run_dtc() -> dict:
    """:data:`STEPS` SGD steps (lr 0.01, the gradients averaged over the
    group) of ``DTCUNet(5, 8)`` with batch norm and ReLU on the Dice+CE
    of its logits plus the squared error of its tanh head against
    :func:`sign_map`."""
    from smsut_tpu_torch.models.dtc import DTCUNet
    from smsut_tpu_torch.ops.losses import dice_and_ce_loss

    net = DTCUNet(5, 8, compute_dtype=torch.float32, device="cpu")
    params = {k: v.detach().clone() for k, v in net.named_parameters()}
    out = {"metrics": [], "checksums": [], "shas": []}
    for b in batches(seed=6):
        x, msk = rows_t(b["img"]), rows_t(b["msk"]).long()
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        tanh, logits = torch.func.functional_call(net, leaves, (x,))
        loss = (dice_and_ce_loss(logits, msk)
                + (tanh - sign_map(msk, tanh.shape[-1])).square().mean())
        grads = mesh.reduce_gradients_(dict(zip(
            leaves, torch.autograd.grad(loss, list(leaves.values())))))
        params = {k: (v - 0.01 * grads[k]).detach()
                  for k, v in leaves.items()}
        out["metrics"].append({"loss": mean(loss)})
        out["checksums"].append({"params": checksum(params)})
        out["shas"].append({"params": tree_sha(params)})
    return out


def run_m3l() -> dict:
    from smsut_tpu_torch.train.steps import m3l
    from smsut_tpu_torch.train.steps.m3l import M3L

    algo = M3L(cfg(), device="cpu")
    out, drawn = {}, []
    state = algo.init_state(0)
    data = batches(seed=7)
    # the eval forward of the initial weights on the rank's rows, whole
    logits = mesh.space_gather(algo.eval_fn(
        algo.eval_params(state), rows_t(data[0]["img"])))
    out["eval_sha"] = sha(logits.numpy())
    save("M3L_eval", logits=logits)
    with drawing(m3l, "mask_grid", drawn):
        steps(algo, state, data, out)
    save("M3L_step1", **out.pop("step1"))
    save("M3L_grad1", **out.pop("grad1"))
    save("M3L_drawn", **{str(k): d for k, d in enumerate(drawn)})
    return out


# -------------------------------------------------------------------- fit

def fit_args(data: str, expr: str, sp: int, *extra: str):
    from smsut_tpu_torch.train.cli import make_parser

    sets = [f"{k}={v}" for k, v in dict(
        input_size=SIZE, base_width=4, batch_size=BATCH,
        num_iter_per_epoch=2, pre_epoch=1, cora_epoch=1, pred_step=1,
        num_workers=1, compute_dtype="float32", spatial_parallel=sp,
        data_aug=AUG64).items()]
    argv = ["-p", "train", "--device", "cpu", "--data_root", data,
            "--expr_root", expr, *extra]
    for s in sets:
        argv += ["--set", s]
    return make_parser().parse_args(argv)


def fit(data: str, expr: str, sp: int) -> dict:
    """``coraNetTrainer -p train`` (stage A, run 000), then ``-p train -i
    000`` (stage B, run 001): per stage the scalars it logged (unrounded)
    and the checksum of its last checkpoint's parameters."""
    from smsut_tpu_torch.train import checkpoints
    from smsut_tpu_torch.train.experiment import Experiment
    from smsut_tpu_torch.trainer import coraNetTrainer

    out = {}
    orig = Experiment.scalar
    try:
        for stage, idx, extra, last in (("pre", "000", (), "pre_last"),
                                        ("cora", "001", ("-i", "000"),
                                         "last")):
            seen = out.setdefault(stage, {"scalars": {}})["scalars"]
            Experiment.scalar = lambda self, tag, v, e, seen=seen: \
                seen.setdefault(tag, {}).__setitem__(str(e), float(v))
            coraNetTrainer.main(fit_args(data, expr, sp, *extra))
            raw = checkpoints.load_raw(os.path.join(
                expr, "CoraNet", idx, "ckpt"), last)
            out[stage]["checksum"] = float(sum(
                float(np.abs(np.asarray(v, np.float64)).sum())
                for v in raw["params"].values()))
    finally:
        Experiment.scalar = orig
    return out


def run_fit() -> dict:
    return fit(os.path.join(OUT, "data"), os.path.join(OUT, "fit"), SP)


# --------------------------------------------------------------- refusals

def refused(fn) -> str:
    """The class and message of what ``fn`` raises; '' if it returns."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def taken(fn) -> str:
    """'ok: ' and what ``fn`` returns, or the class and message of what it
    raises."""
    try:
        out = fn()
    except Exception as e:
        return f"{type(e).__name__}: {e}"
    return f"ok: {out}"


def run_refuse() -> dict:
    from smsut_tpu_torch.models.dtc import DTCUNet
    from smsut_tpu_torch.train.loop import Trainer
    from smsut_tpu_torch.train.steps.m3l import M3L
    from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher

    expr = os.path.join(OUT, "refuse")
    trainer = lambda algo, c: Trainer(algo(c, device="cpu"),
                                      c.replace(expr_root=expr), "test")
    dtc = DTCUNet(5, 8, compute_dtype=torch.float32, device="cpu")
    return {
        "segformer": refused(lambda: trainer(M3L, cfg(input_size=96))),
        "block_pallas": taken(lambda: trainer(MeanTeacher, cfg(
            block_pallas=True)).cfg.block_pallas),
        "dtc_rows": refused(lambda: dtc(torch.zeros(1, 40 // SP, 40, 1))),
        "make_mesh_2d": refused(lambda: mesh.make_mesh_2d(1, 2)),
    }


MODES = {"ops": run_ops, "meanTeacher": run_mean_teacher,
         "crossPse": run_cross_pseudo, "coraNet": run_coranet,
         "dtc": run_dtc, "M3L": run_m3l, "fit": run_fit,
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
