# -*- coding: utf-8 -*-
"""The semi-supervised zoo under the model axis on the CPU (gloo): Mean
Teacher, CPS, CoraNet's two stages, M3L's SegFormer and DTC with every
eligible weight, the EMA teacher's, the second net's and the optimizer
state's held as output-channel shards (``parallel/mesh.py``
``make_mesh_2d``, ``shard_params_channelwise``).

Ranks of ``tests/torch_tp_zoo_worker.py`` start once for the module: a
group of two (dp x tp = 1 x 2) that runs every algorithm's steps, the
sweep, the eval forwards and the zoo's checkpoints' save, and a group of
four (2 x 2) that runs DTC and loads those checkpoints; each process
under its own timeout, so that a hung collective fails the tests instead
of hanging the run.  Input 32, U-Nets of width 8 at 4 + 4 images, M3L's
SegFormer at its own widths at 2 + 2.  While they run, this process
computes the references: the worker's own functions in one process at
the global batch, and the JAX steps:

- the sharded set: the port's rule against the JAX
  ``shard_params_channelwise`` for CoraNet's, DTC's and the SegFormer's
  trees (the depthwise kernels included);
- every algorithm against one process: the losses to rtol 1e-5, every
  parameter of every tree to rtol 1e-4 / atol 1e-5
  (tests/test_tensor_parallel.py's bounds), the ranks equal to the bit;
  M3L's float32 parameters after Adam's first update (about lr * sign(g),
  so a float32 rounding difference flips a near-zero gradient's whole
  2 lr step) are held by the flip-aware rule, and its gradient and its
  float64 steps by those bounds;
- Mean Teacher against the JAX single-device step (strict parity:
  float32, unpacked, reduced statistics, host augmentation, no tower
  pairing), M3L in float64 (the JAX step under tests/test_torch_m3l.py's
  ``jax_float64``) against the JAX single-device step and against the JAX
  step with its state sharded by ``smsut_tpu.parallel.mesh
  .shard_params_channelwise`` on a 1 x 2 mesh of the CPU devices;
- the checkpoints: saved at 1 x 2, loaded in one process and at 2 x 2.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu_torch.models.transplant import to_flax
from smsut_tpu_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tp_zoo_worker.py")
# group -> (ranks, model axis, modes)
GROUPS = {"1x2": (2, 2, ("meanTeacher", "crossPse", "coraNet", "M3L", "dtc",
                         "eval", "save")),
          "2x2": (4, 2, ("dtc", "load"))}
WORKER_TIMEOUT_S = 240
LOSS_RTOL, RTOL, ATOL = 1e-5, 1e-4, 1e-5
# M3L's float32 parameters after Adam's first update (chip_smoke 10b's
# rule): every element within 2.1 lr, under 1% beyond lr
FLIP_DEV, FLIP_SHARE = 2.1, 0.01
# CoraNet's sweep: labels compared where one process's top two logits
# differ by more than this (float32 reassociation moves a near tie)
MARGIN = 1e-4
JAX_KEY = 40        # the JAX steps' key (Mean Teacher's noise, M3L's grid)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tp_zoo_worker as worker  # noqa: E402
from torch_port_helpers import STRICT, at_count  # noqa: E402


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _draws() -> dict:
    """The JAX Mean Teacher step's teacher noise for ``PRNGKey(JAX_KEY)``
    at the global unlabelled batch (tests/test_torch_mean_teacher.py) and
    the JAX M3L model's mask grids for keys JAX_KEY and JAX_KEY + 1 at its
    2B images, drawn in float64 as the float64 M3L step draws them
    (tests/test_torch_m3l.py)."""
    from test_torch_m3l import jax_float64

    b, s = worker.BATCH, worker.SIZE
    noise = np.array(jnp.clip(0.01 * jax.random.normal(
        jax.random.PRNGKey(JAX_KEY), (b, s, s, 1)), -0.02, 0.02))
    shape = (2 * worker.M3L_BATCH, s // 16, s // 16)
    with jax_float64():
        grids = {f"grid{k}": np.asarray(jax.random.bernoulli(
            jax.random.PRNGKey(JAX_KEY + k), 0.5, shape), np.float32)
            for k in range(2)}
    return dict(grids, noise=noise)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The groups' ranks, started; their directories; one process's
    directory for the references, with the same inputs."""
    out = tmp_path_factory.mktemp("tp_zoo")
    np.savez(out / "draws.npz", **_draws())
    (out / "ckpt").mkdir()
    procs = {}
    for name, (world, tp, modes) in GROUPS.items():
        d = out / name
        d.mkdir()
        os.symlink(out / "draws.npz", d / "draws.npz")
        port = _free_port()
        procs[name] = []
        for rank in range(world):
            env = dict(os.environ, SMSUT_COORDINATOR=f"127.0.0.1:{port}",
                       SMSUT_NUM_PROCESSES=str(world),
                       SMSUT_PROCESS_ID=str(rank), SMSUT_TP=str(tp),
                       SMSUT_MODES=",".join(modes), SMSUT_DIST_DIR=str(d),
                       SMSUT_CKPT_DIR=str(out / "ckpt"), OMP_NUM_THREADS="1",
                       PYTHONPATH=REPO + os.pathsep + os.environ.get(
                           "PYTHONPATH", ""))
            procs[name].append(subprocess.Popen(
                [sys.executable, WORKER], env=env, cwd=str(d),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    one = out / "one"
    one.mkdir()
    os.symlink(out / "draws.npz", one / "draws.npz")
    state = {"procs": procs, "out": out, "one": one, "t0": time.time(),
             "results": {}, "refs": {}}
    yield state
    for group in procs.values():
        for p in group:
            if p.poll() is None:
                p.kill()
                p.wait()


def ranks(run, group: str, mode: str):
    """Every rank's result of ``mode`` in ``group``, after waiting for the
    group's ranks (each within WORKER_TIMEOUT_S of their start); a rank
    that failed fails here with its error output."""
    world, tp, modes = GROUPS[group]
    if group not in run["results"]:
        errs = []
        for p in run["procs"][group]:
            left = max(1.0, WORKER_TIMEOUT_S - (time.time() - run["t0"]))
            try:
                _, err = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                for q in run["procs"][group]:
                    q.kill()
                raise AssertionError("a rank did not finish within "
                                     f"{WORKER_TIMEOUT_S} s")
            errs.append((p.returncode, err))
        got = {}
        for m in modes:
            got[m] = []
            for rank in range(world):
                path = run["out"] / group / f"{m}.{rank}.json"
                got[m].append(json.loads(path.read_text())
                              if path.exists() else None)
        run["results"][group] = (got, errs)
    got, errs = run["results"][group]
    res = got[mode]
    if any(r is None or "error" in r for r in res):
        raise AssertionError(f"{group} {mode} failed: "
                             + "\n".join(f"rank rc {rc}:\n{e[-3000:]}"
                                         for rc, e in errs)
                             + "\n" + "\n".join(str(r) for r in res))
    assert [r["rank"] for r in res] == list(range(world))
    assert all(r["world"] == world and r["model"] == tp for r in res)
    return res


def one_process(run, mode: str):
    """The worker's function of ``mode`` run here, in one process at the
    global batch (its files in the one-process directory), once."""
    if mode not in run["refs"]:
        worker.OUT = str(run["one"])
        worker.LAYOUT[0] = None
        run["refs"][mode] = worker.MODES[mode]()
    return run["refs"][mode]


def npz(run, name: str, group: str = "1x2") -> dict:
    d = run["one"] if group == "one" else run["out"] / group
    with np.load(d / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


def _close(got: dict, want: dict, rtol: float = RTOL,
           atol: float = ATOL) -> None:
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


def _metrics_close(got: list, want: list, names=None) -> None:
    """Each step's metrics: the loss to rtol LOSS_RTOL, every other term
    to LOSS_RTOL of itself or of the step's loss, whichever is larger (a
    consistency term is a mean of squared differences of two nearly equal
    softmaxes, whose float32 summation order moves it by more of itself,
    as chip_smoke 9b holds it)."""
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        for m in names or w:
            atol = 0.0 if m == "loss" else LOSS_RTOL * abs(w["loss"])
            np.testing.assert_allclose(g[m], w[m], rtol=LOSS_RTOL, atol=atol,
                                       err_msg=f"step {k + 1} {m}")


def _ranks_equal(res: list, key: str = "shas") -> None:
    assert all(r[key] == res[0][key] for r in res), key


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ one process

def _port_tree(name: str) -> dict:
    """The port's whole parameter tree ``name`` (``<model>_w<width>``)."""
    from smsut_tpu_torch.models.dtc import DTCUNet
    from smsut_tpu_torch.train.steps.coranet import CoraNet

    model, _, width = name.partition("_w")
    if model == "segformer":
        return worker.m3l_algo().init_params(0)
    if model == "coraNet":
        return CoraNet(worker.cfg(base_width=int(width)),
                       device="cpu").init_params(0)
    return DTCUNet(5, int(width), compute_dtype=torch.float32,
                   device="cpu").state_dict()


def _flat_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


@pytest.mark.usefixtures("run")   # the ranks start meanwhile
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", ["coraNet_w4", "coraNet_w8", "dtc_w8",
                                  "dtc_w64", "segformer"])
def test_sharded_set_matches_jax(name, tp):
    """The port shards exactly the leaves of CoraNet's, DTC's and the
    SegFormer's trees to which the JAX ``shard_params_channelwise`` gives
    a 'model' spec (the flax tree of the same weights), its shards are
    ``C/tp`` of the output channels; the SegFormer's depthwise kernels
    (3, 3, 1, C) are among them, its classifier (5 outputs) is not."""
    from smsut_tpu.parallel.mesh import (
        make_mesh_2d as jax_mesh_2d,
        shard_params_channelwise as jax_shard,
    )

    tree = _port_tree(name)
    keys = mesh.sharded_keys({k: v.shape for k, v in tree.items()}, tp)
    marks = {k: torch.full_like(v, float(k in keys)) for k, v in tree.items()}
    jtree = jax_shard(jax_mesh_2d(1, tp), jax.tree_util.tree_map(
        jnp.asarray, to_flax(tree)))
    want = {k: "model" in str(v.sharding.spec)
            for k, v in _flat_leaves(jtree)}
    got = {k: bool(np.asarray(v).all())
           for k, v in _flat_leaves(to_flax(marks))}
    assert got == want
    assert keys, "nothing sharded"
    for k in keys:
        s = mesh.shard_shape(tree[k].shape, tp)
        assert s[-1] * tp == tree[k].shape[-1] and s[-1] >= 4, (k, s)
    if name == "segformer":
        dw = {k for k in tree if k.endswith("dwconv.weight")}
        assert len(dw) == 8 and dw <= keys
        assert "linear_pred.weight" not in keys


# ------------------------------------------------------------- the groups

def _trees(state) -> dict:
    """A JAX state's parameter trees by the worker's ``tree/key`` names."""
    from smsut_tpu_torch.models.transplant import from_flax

    out = {}
    for t in worker.TREES:
        tree = getattr(state, t, None)
        if tree is not None:
            out.update({f"{t}/{k}": v.numpy() for k, v in
                        from_flax(jax.device_get(tree)).items()})
    return out


def _jax_mt():
    """One JAX Mean Teacher step on one device at the global batch from
    the port's initial weights at count 100, its noise from
    ``PRNGKey(JAX_KEY)``: the metrics and the trees."""
    from smsut_tpu.config import Config as JConfig
    from smsut_tpu.train.steps.mean_teacher import MeanTeacher as JMT
    from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher

    cfg = worker.cfg()
    jalgo = JMT(JConfig(**{k: getattr(cfg, k) for k in (
        "input_size", "base_width", "batch_size", "num_iter_per_epoch",
        "max_epoch")}, **STRICT))
    port = MeanTeacher(cfg, device="cpu").init_state(0)
    to = lambda t: jax.tree_util.tree_map(jnp.asarray, to_flax(t))
    state = jalgo.init_state(jax.random.PRNGKey(0))
    state = at_count(state.replace(params=to(port.params),
                                   ema_params=to(port.ema_params)),
                     worker.MT_JAX_COUNT)
    scalars = dict(jalgo.epoch_scalars(worker.EPOCH),
                   rng=jax.random.PRNGKey(JAX_KEY))
    state, m = jalgo.train_step(state, worker.batches(1, seed=4)[0], scalars)
    return {k: float(v) for k, v in m.items()}, _trees(state)


@pytest.fixture(scope="module")
def jax_refs(run):
    """The JAX references, computed while the ranks run: Mean Teacher's
    step (``mt``) and M3L's (``m3l``)."""
    return {"mt": _jax_mt(), "m3l": _jax_m3l()}


def test_mean_teacher_step_matches_jax_single_device(run, jax_refs):
    """One Mean Teacher step at 1 x 2 from count 100 (the consistency
    live), fed the JAX step's noise, against the JAX step on one device at
    the global batch: the metrics to rtol 1e-5, the student and the EMA
    teacher to rtol 1e-4 / atol 1e-5."""
    want, trees = jax_refs["mt"]
    res = ranks(run, "1x2", "meanTeacher")
    assert res[0]["jax_step"] == res[1]["jax_step"]
    assert want["semi_loss"] > 0
    _metrics_close([res[0]["jax_step"]], [want],
                   ("loss", "semi_loss", "alpha"))
    _close(npz(run, "meanTeacher_jax"), trees)


def test_mean_teacher_steps_match_one_process(run):
    """Mean Teacher at 1 x 2 from count 99 (its gate opens inside the
    run), the noise drawn in the step: the model ranks drew the same
    noise, one process's; the losses to rtol 1e-5 after each step, the
    student and the EMA teacher to rtol 1e-4 / atol 1e-5; the ranks equal
    to the bit."""
    res = ranks(run, "1x2", "meanTeacher")
    want = one_process(run, "meanTeacher")
    _ranks_equal(res)
    _ranks_equal(res, "drawn")
    assert res[0]["drawn"] == want["drawn"]
    _metrics_close(res[0]["metrics"], want["metrics"])
    assert want["metrics"][0]["semi_loss"] == 0
    assert want["metrics"][-1]["semi_loss"] > 0
    _close(npz(run, "meanTeacher"), npz(run, "meanTeacher", "one"))


def test_cross_pseudo_steps_match_one_process(run):
    """CPS at 1 x 2, both nets and their momentum on shards: the four
    losses to rtol 1e-5 after each step, both nets to rtol 1e-4 / atol
    1e-5; the ranks equal to the bit."""
    res = ranks(run, "1x2", "crossPse")
    want = one_process(run, "crossPse")
    _ranks_equal(res)
    _metrics_close(res[0]["metrics"], want["metrics"])
    got = npz(run, "crossPse")
    assert any(k.startswith("params2/") for k in got)
    _close(got, npz(run, "crossPse", "one"))


@pytest.mark.parametrize("stage", ["pre", "cora"])
def test_coranet_steps_match_one_process(run, stage):
    """CoraNet's stage A from count 0 and stage B from count 999 (its
    certain and uncertain terms open at 1000, on the pseudo batch's rows)
    at 1 x 2: the losses to rtol 1e-5, the student and the EMA to rtol
    1e-4 / atol 1e-5; the ranks equal to the bit."""
    res = [r[stage] for r in ranks(run, "1x2", "coraNet")]
    want = one_process(run, "coraNet")[stage]
    _ranks_equal(res)
    _metrics_close(res[0]["metrics"], want["metrics"])
    if stage == "cora":
        assert want["metrics"][0]["certain_loss"] == 0
        assert want["metrics"][-1]["certain_loss"] > 0
    _close(npz(run, f"coraNet_{stage}"), npz(run, f"coraNet_{stage}", "one"))


def test_coranet_sweep_matches_one_process(run):
    """Stage B's pseudo-label sweep at 1 x 2 (each model rank's forward on
    its shards, the logits gathered whole) against one process: both
    ranks hold the same pseudo set; the images equal; head 0's labels
    equal wherever one process's top two head-0 logits differ by more
    than 1e-4, the agreement mask wherever heads 1's and 2's do; the
    logged Dice within 1e-6."""
    from smsut_tpu_torch.ops.losses import split_heads
    from smsut_tpu_torch.train.steps.coranet import CoraNet

    r0, r1 = ranks(run, "1x2", "coraNet")
    assert r0["sweep"] == r1["sweep"]
    want_dice = one_process(run, "coraNet")["sweep"]["dice"]
    got, want = npz(run, "coraNet_sweep"), npz(run, "coraNet_sweep", "one")
    np.testing.assert_array_equal(got["img"], want["img"])
    np.testing.assert_array_equal(got["lab"], want["lab"])
    algo = CoraNet(worker.cfg(), device="cpu", stage="cora")
    with torch.no_grad():
        heads = split_heads(algo._apply(
            algo.eval_params(algo.init_state(0)),
            torch.from_numpy(want["img"])), worker.cfg().n_label)
    clear = []
    for h in heads:
        top2 = torch.topk(h, 2, dim=-1).values
        clear.append((top2[..., 0] - top2[..., 1] > MARGIN).numpy())
    for key, where in (("plab", clear[0]), ("mask", clear[1] & clear[2])):
        assert where.mean() > 0.9, (key, where.mean())
        np.testing.assert_array_equal(got[key][where], want[key][where],
                                      err_msg=key)
    assert abs(r0["sweep"]["dice"] - want_dice) <= 1e-6


def test_m3l_float32_steps_match_one_process(run):
    """M3L at 1 x 2 in float32 (the SegFormer's layers on their shards,
    the depthwise convs on their channels, Adam's moments sharded), the
    mask grid drawn in the step: the model ranks drew one process's grid;
    step 1's losses to rtol 1e-5 and its gradient (from Adam's first
    moment, which scales with it) to rtol 1e-4 / atol 1e-5; the student
    after Adam's first update by the flip-aware rule; the ranks equal to
    the bit after each step."""
    res = ranks(run, "1x2", "M3L")
    want = one_process(run, "M3L")
    _ranks_equal([r["f32"] for r in res])
    _ranks_equal(res, "drawn")
    assert res[0]["drawn"] == want["drawn"]
    _metrics_close(res[0]["f32"]["metrics"][:1], want["f32"]["metrics"][:1],
                   ("loss", "semi_loss"))
    assert all(np.isfinite(list(m.values())).all()
               for m in res[0]["f32"]["metrics"])
    _close(npz(run, "M3L_grad1"), npz(run, "M3L_grad1", "one"))
    lr = worker.cfg().lr
    got, ref = npz(run, "M3L_step1"), npz(run, "M3L_step1", "one")
    assert got.keys() == ref.keys()
    dev = np.concatenate([np.abs(got[k] - v).ravel() for k, v in ref.items()])
    assert dev.max() <= FLIP_DEV * lr, dev.max()
    assert (dev > lr).mean() < FLIP_SHARE


def test_m3l_float64_steps_match_one_process(run):
    """M3L at 1 x 2 in float64, fed the JAX step's grids, where Adam's
    sign step has no float32 flips: the losses to rtol 1e-5 after each
    step, the student and the EMA teacher to rtol 1e-4 / atol 1e-5 after
    each; the ranks equal to the bit."""
    res = ranks(run, "1x2", "M3L")
    want = one_process(run, "M3L")
    _ranks_equal([r["f64"] for r in res])
    _metrics_close(res[0]["f64"]["metrics"], want["f64"]["metrics"])
    for name in ("M3L64_step1", "M3L64"):
        _close(npz(run, name), npz(run, name, "one"))


def _jax_m3l():
    """The JAX M3L step in float64 (``jax_float64``) from the port's
    initial weights, its grid from ``PRNGKey(JAX_KEY)``, on one device and
    with its state sharded by the JAX ``shard_params_channelwise`` on a
    1 x 2 mesh: per run the metrics, the trees and the leaves sharded."""
    from smsut_tpu.config import Config as JConfig
    from smsut_tpu.parallel.mesh import (
        make_mesh_2d as jax_mesh_2d,
        shard_params_channelwise as jax_shard,
    )
    from smsut_tpu.train.state import TrainState as JTrainState
    from smsut_tpu.train.state import make_adam as j_make_adam
    from smsut_tpu.train.steps.m3l import M3L as JM3L
    from test_torch_m3l import jax_float64

    cfg = worker.cfg(batch_size=worker.M3L_BATCH)
    jcfg = JConfig(**{k: getattr(cfg, k) for k in (
        "input_size", "batch_size", "num_iter_per_epoch", "max_epoch")},
        **STRICT)
    init = to_flax(worker.m3l_algo().init_params(0))
    batch = worker.batches(1, seed=7, b=worker.M3L_BATCH)[0]
    out = {}
    with jax_float64():
        jalgo = JM3L(jcfg)
        wide = lambda: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), init)
        scalars = dict(jalgo.epoch_scalars(worker.EPOCH),
                       rng=jax.random.PRNGKey(JAX_KEY))
        b64 = {k: jnp.asarray(v.astype(np.float64) if v.dtype == np.float32
                              else v) for k, v in batch.items()}
        for layout in ("single", "mesh"):
            state = JTrainState.create(wide(), j_make_adam(jcfg),
                                       ema_params=wide())
            sharded = 0
            if layout == "mesh":
                m = jax_mesh_2d(1, 2)
                state = state.replace(
                    params=jax_shard(m, state.params),
                    ema_params=jax_shard(m, state.ema_params),
                    opt_state=jax_shard(m, state.opt_state))
                sharded = sum("model" in str(v.sharding.spec) for v in
                              jax.tree_util.tree_leaves(state.params))
            state, met = jalgo.train_step(state, b64, scalars)
            out[layout] = ({k: float(v) for k, v in met.items()},
                           _trees(state), sharded)
    return out


def test_m3l_step_matches_jax_single_device(run, jax_refs):
    """M3L's first step at 1 x 2 in float64 against the JAX step on one
    device (float64, fed the same grid) from the same weights: the
    metrics to rtol 1e-5, the student and the EMA teacher to rtol 1e-4 /
    atol 1e-5."""
    want, trees, _ = jax_refs["m3l"]["single"]
    res = ranks(run, "1x2", "M3L")
    _metrics_close(res[0]["f64"]["metrics"][:1], [want],
                   ("loss", "semi_loss", "alpha"))
    _close(npz(run, "M3L64_step1"), trees)


def test_jax_m3l_on_a_model_mesh_matches_port_ranks(run, jax_refs):
    """The JAX package computes this layout too: its M3L step (float64)
    with the state sharded by its ``shard_params_channelwise`` on a 1 x 2
    mesh of the CPU devices (GSPMD partitions the jitted step) agrees with
    the port's ranks at 1 x 2 (the metrics to rtol 1e-5, the trees to
    rtol 1e-4 / atol 1e-5) and with its own single-device step."""
    want, trees, sharded = jax_refs["m3l"]["mesh"]
    assert sharded > 0
    res = ranks(run, "1x2", "M3L")
    _metrics_close(res[0]["f64"]["metrics"][:1], [want],
                   ("loss", "semi_loss", "alpha"))
    _close(npz(run, "M3L64_step1"), trees)
    _close(trees, jax_refs["m3l"]["single"][1])


@pytest.mark.parametrize("group", ["1x2", "2x2"])
def test_dtc_steps_match_one_process(run, group):
    """DTC w8 with batch norm and ReLU, its convs and heads on shards, two
    SGD steps at dp x tp = 1 x 2 and 2 x 2 (there the batch norm's sums
    over the data group alone, whose model ranks hold the same rows)
    against one process: the loss to rtol 1e-5, the parameters to rtol
    1e-4 / atol 1e-5; the ranks equal to the bit."""
    res = ranks(run, group, "dtc")
    want = one_process(run, "dtc")
    _ranks_equal(res)
    assert res[0]["shards"] > 0 and want["shards"] == 0
    _metrics_close(res[0]["metrics"], want["metrics"])
    _close(npz(run, "dtc", group), npz(run, "dtc", "one"))


@pytest.mark.parametrize("name", list(worker.EVAL))
def test_eval_fn_matches_one_process(run, name):
    """Each algorithm's ``eval_fn`` on the shards of its initial weights
    at 1 x 2 (CPS's net 1, CoraNet's head 0, M3L's SegFormer with its
    batch norm over the rank's batch) against one process: the logits to
    1e-5 of the largest, both ranks equal to the bit."""
    res = ranks(run, "1x2", "eval")
    one_process(run, "eval")
    assert res[0][name] == res[1][name]
    want = npz(run, f"eval_{name}", "one")["logits"]
    got = npz(run, f"eval_{name}")["logits"]
    assert got.shape == want.shape == (worker.BATCH, worker.SIZE,
                                       worker.SIZE, 5)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", list(worker.SAVED))
def test_zoo_checkpoint_across_layouts(run, name, tmp_path):
    """CPS (its second net and momentum) and M3L (its EMA teacher, Adam's
    moments and count; float64) saved at 1 x 2 after a step: the file holds
    the whole trees (a one-process save's keys and shapes) and loads into
    one process and into a sharded 2 x 2 template equal to the bit; the
    next step at 2 x 2 against one process's from the same file: the
    losses to rtol 1e-5, every tree to rtol 1e-4 / atol 1e-5."""
    from smsut_tpu_torch.train import checkpoints

    saved = ranks(run, "1x2", "save")
    loaded = ranks(run, "2x2", "load")
    assert all(r[name]["saved_sha"] == saved[0][name]["saved_sha"]
               for r in saved)
    algo, b = worker.ckpt_algo(name)
    ckpt = str(run["out"] / "ckpt")
    one = algo.init_state(0)
    checkpoints.save_state(one, str(tmp_path), "one")
    raw, ref = (checkpoints.load_raw(d, p) for d, p in ((ckpt, name),
                                                      (str(tmp_path), "one")))
    assert raw.keys() == ref.keys()
    for t, tree in ref.items():
        if isinstance(tree, dict):
            assert {k: v.shape for k, v in raw[t].items()} == \
                {k: v.shape for k, v in tree.items()}, t
    state = checkpoints.load_state(algo.init_state(1), ckpt, name)
    assert state.step == 1
    if name == "crossPse":   # float32: the file is the state to the bit
        assert worker.tree_sha(worker.whole(state)) == \
            saved[0][name]["saved_sha"]
    assert all(r[name]["restored_step"] == 1 for r in loaded)
    assert all(r[name]["loaded_sha"] == worker.tree_sha(worker.whole(state))
               for r in loaded)
    _ranks_equal([r[name] for r in loaded])
    data = worker.batches(seed=10, b=b)[1]
    state, m = algo.train_step(state, data, algo.epoch_scalars(worker.EPOCH))
    _metrics_close(loaded[0][name]["metrics"],
                   [{k: float(v) for k, v in m.items()}])
    _close(npz(run, f"load_{name}", "2x2"),
           {k: v.numpy() for k, v in worker.whole(state).items()})
