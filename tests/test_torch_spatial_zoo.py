# -*- coding: utf-8 -*-
"""The rest of the zoo under the space axis on the CPU (gloo): Mean
Teacher, CPS, CoraNet's two stages, DTC and M3L's SegFormer with each
rank holding rows of every image (``Config.spatial_parallel``,
``parallel/mesh.py``).

Two ranks of ``tests/torch_spatial_zoo_worker.py`` (dp x sp = 1 x 2)
start once for the module and run every mode in turn, each process under
its own timeout, so that a hung collective fails the tests instead of
hanging the run.  Input 64, widths 4-8, float32 (the JAX package's
strict-parity settings), labels 1 and 2 cleared in the lower half of
each image, so that one rank's Dice alone differs from the whole
image's.  While the ranks run, this process computes the references: the
worker's own functions in one process at the global batch, and the JAX
steps on one device:

- ``ops``: the SegFormer's layers on rows against whole images, forward,
  backward and double backward, to 1e-6 of the largest element, and the
  row gather's double backward;
- the draws: a rank's rows of Mean Teacher's noise and M3L's mask grid,
  joined, equal the global draw to the bit;
- Mean Teacher (from count 99, so its gate opens) and CPS: 3 steps, the
  losses within 1e-4 and the parameter checksums within 1e-5 relative of
  one process (tests/test_torch_distributed_zoo.py's bounds); a step at
  the global batch against the JAX step on one device fed the JAX draws,
  within tests/test_torch_mean_teacher.py's and
  tests/test_torch_cross_pseudo.py's bounds;
- CoraNet A and B (from count 999, so the certain and uncertain terms
  open): 3 steps under those bounds; the pseudo-label sweep against one
  process (labels and agreement where one process's top two logits
  differ by more than 1e-4, the logged Dice within 1e-6);
- DTC w8 with batch norm: 3 SGD steps under those bounds;
- M3L: step 1 under chip_smoke 10b's float32 rules against one process
  and its gradient's checksums within 1e-5 relative, its eval forward's
  logits within 1e-5, 3 steps with both ranks' trees equal to the bit;
- ``coraNetTrainer -p train`` through both stages against one process
  (tests/test_torch_distributed.py's fit rules);
- the refusals that stay.
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

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.parallel import mesh
from smsut_tpu_torch.models.segformer import check_rows
from smsut_tpu_torch.train.steps.m3l import M3L, mask_grid
from smsut_tpu_torch.train.steps.mean_teacher import teacher_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_spatial_zoo_worker.py")
MODES = ("ops", "meanTeacher", "crossPse", "coraNet", "dtc", "M3L", "fit",
         "refuse")
# one process's limit: the modes take about 30 s on one CPU thread
WORKER_TIMEOUT_S = 240
LOSS_TOL, SUM_TOL = 1e-4, 1e-5
# M3L's float32 rules on step 1 (chip_smoke 10b): the losses within 1e-4
# relative; after Adam's first update (about lr * sign(g)) every parameter
# within 2.1 lr, under 1% beyond lr
M3L_LOSS_TOL, FLIP_DEV, FLIP_SHARE = 1e-4, 2.1, 0.01
# CoraNet's sweep: labels compared where one process's top two logits
# differ by more than this (float32 reassociation on the halo rows moves a
# near tie)
MARGIN = 1e-4
JAX_KEY = 40        # the JAX Mean Teacher step's key (its teacher noise)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_spatial_zoo_worker as worker  # noqa: E402
from torch_port_helpers import STRICT, assert_trees_close  # noqa: E402


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_noise() -> np.ndarray:
    """The JAX Mean Teacher step's teacher noise for ``PRNGKey(JAX_KEY)``
    at the global unlabelled batch (tests/test_torch_mean_teacher.py)."""
    shape = (worker.BATCH, worker.SIZE, worker.SIZE, 1)
    return np.array(jnp.clip(0.01 * jax.random.normal(
        jax.random.PRNGKey(JAX_KEY), shape), -0.02, 0.02))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks, started once; their directory; one process's
    directory for the references, with the same inputs."""
    from smsut_tpu_torch.data.synthetic import make_synthetic_dataset

    out = tmp_path_factory.mktemp("space_zoo")
    make_synthetic_dataset(str(out / "data"), n_patients_per_modality=2,
                           n_slice=4, size=worker.SIZE)
    np.savez(out / "draws.npz", noise=_jax_noise())
    one = out / "one"
    one.mkdir()
    for name in ("data", "draws.npz"):
        os.symlink(out / name, one / name)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, SMSUT_COORDINATOR=f"127.0.0.1:{port}",
                   SMSUT_NUM_PROCESSES="2", SMSUT_PROCESS_ID=str(rank),
                   SMSUT_SPACE="2", SMSUT_MODES=",".join(MODES),
                   SMSUT_DIST_DIR=str(out), SMSUT_NO_TB="1",
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        env.pop("SMSUT_DATA_ROOT", None)
        env.pop("SMSUT_EXPR_ROOT", None)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], env=env, cwd=str(out),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    state = {"procs": procs, "out": out, "one": one, "t0": time.time(),
             "results": None, "refs": {}}
    yield state
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def ranks(run, mode: str):
    """Both ranks' results of ``mode``, after waiting for them (each within
    WORKER_TIMEOUT_S of their start); a rank that failed fails here with
    its error output."""
    if run["results"] is None:
        errs = []
        for p in run["procs"]:
            left = max(1.0, WORKER_TIMEOUT_S - (time.time() - run["t0"]))
            try:
                _, err = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                for q in run["procs"]:
                    q.kill()
                raise AssertionError("a rank did not finish within "
                                     f"{WORKER_TIMEOUT_S} s")
            errs.append((p.returncode, err))
        got = {m: [json.loads(path.read_text()) if path.exists() else None
                   for path in (run["out"] / f"{m}.{r}.json"
                                for r in range(2))] for m in MODES}
        run["results"] = (got, errs)
    got, errs = run["results"]
    res = got[mode]
    if any(r is None or "error" in r for r in res):
        raise AssertionError(f"{mode} failed: "
                             + "\n".join(f"rank rc {rc}:\n{e[-3000:]}"
                                         for rc, e in errs)
                             + "\n" + "\n".join(str(r) for r in res))
    assert [r["rank"] for r in res] == [0, 1]
    assert all(r["world"] == 2 and r["space"] == 2 for r in res)
    return res


def one_process(run, mode: str):
    """The worker's function of ``mode`` run here, in one process at the
    global batch (its files in the one-process directory), once."""
    if mode not in run["refs"]:
        worker.OUT = str(run["one"])
        run["refs"][mode] = worker.MODES[mode]()
    return run["refs"][mode]


def npz(run, name: str, one: bool = False) -> dict:
    with np.load((run["one"] if one else run["out"]) / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1.0)


def _steps_match(r0: dict, r1: dict, want: dict) -> None:
    """The ranks equal to the bit after every step; every metric within
    LOSS_TOL of one process's after each step, each tree's checksum within
    SUM_TOL relative after the last."""
    assert r0["shas"] == r1["shas"] and r0["metrics"] == r1["metrics"]
    assert len(r0["metrics"]) == len(want["metrics"]) == worker.STEPS
    for k, (got, w) in enumerate(zip(r0["metrics"], want["metrics"])):
        for m, v in w.items():
            assert abs(got[m] - v) < LOSS_TOL, (k, m, got, w)
    for tree, v in want["checksums"][-1].items():
        assert _rel(r0["checksums"][-1][tree], v) < SUM_TOL, (tree, r0, want)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- one process

@pytest.mark.parametrize("dp, sp", [(1, 2), (2, 2), (1, 4)])
@pytest.mark.parametrize("what", ["noise", "mask"])
def test_draw_parts_are_the_global_draw(what, dp, sp):
    """At every coordinate of a dp x sp layout, the part of Mean Teacher's
    noise (a data coordinate's batch rows, a space coordinate's image
    rows) and of M3L's mask grid (its labelled and unlabelled batch rows,
    its rows of each image's grid) that the rank draws equals that part
    of the global draw to the bit, and the parts joined are the whole."""
    c = torch.tensor(1234)
    if what == "noise":
        shape = (4, 16, 8, 1)
        draw = lambda rows, hrows: teacher_noise(c, shape, 2020, rows, hrows)
    else:
        shape = (8, 8, 4)      # 2B rows at B = 4: labelled, then unlabelled
        draw = lambda rows, hrows: mask_grid(c, shape, 2020, rows, hrows)
    whole = draw(None, None)
    b, h = shape[0] // (1 if what == "noise" else 2), shape[1]
    parts = []
    for d in range(dp):
        bs = slice(d * b // dp, (d + 1) * b // dp)
        rows = [bs] if what == "noise" else [bs, slice(b + bs.start,
                                                       b + bs.stop)]
        want = torch.cat([whole[r] for r in rows])
        joined = []
        for s in range(sp):
            hs = slice(s * h // sp, (s + 1) * h // sp)
            got = draw(rows, hs)
            assert torch.equal(got, want[:, hs]), (d, s)
            joined.append(got)
        parts.append(torch.cat(joined, dim=1))
    if what == "noise":
        assert torch.equal(torch.cat(parts), whole)
    # a rank's rows drawn as images of their own give another draw
    alone = (teacher_noise if what == "noise" else mask_grid)(
        c, (shape[0], h // sp, *shape[2:]), 2020)
    assert not torch.equal(alone, whole[:, : h // sp])


@pytest.mark.parametrize("kw, net, match", [
    (dict(input_size=96, spatial_parallel=2), "segformer", "24x24"),
    (dict(input_size=64, spatial_parallel=4), "segformer", "16x16"),
    (dict(input_size=32, spatial_parallel=2), "segformer",
     "input_size >= 64")])
def test_check_spatial_refuses_the_zoos_maps(kw, net, match):
    """The SegFormer's maps that do not split into whole rows, a multiple
    of their attention's reduction ratio (96 on 2 ranks: 12 stage-1 rows
    a rank, not a multiple of 8; 64 on 4; the model's rule, which M3L
    hands the check) and the JAX guard: each message names
    spatial_parallel.  The U-Net's maps take 96 on 2 and 64 on 4, the
    SegFormer's 64 on 2."""
    cfg = Config(**kw)
    maps = M3L.space_maps if net == "segformer" else None
    with pytest.raises((ValueError, NotImplementedError),
                       match="spatial_parallel") as e:
        mesh.check_spatial(cfg, cfg.spatial_parallel, maps=maps)
    assert match in str(e.value)
    if net == "segformer" and cfg.input_size // 16 >= max(
            4, cfg.spatial_parallel):
        mesh.check_spatial(cfg, cfg.spatial_parallel)
    check_rows(64, 2)


def test_check_spatial_takes_block_pallas_for_the_zoos_unets():
    """The fused block kernels run split at their statistics on the space
    axis: the check takes ``block_pallas`` with a U-Net algorithm's maps
    (the zoo's Mean Teacher, CPS, CoraNet) at 64 on 2 ranks."""
    cfg = Config(input_size=64, spatial_parallel=2, block_pallas=True)
    mesh.check_spatial(cfg, cfg.spatial_parallel)


# ----------------------------------------------------------- two ranks

@pytest.mark.parametrize("op", list(worker.op_cases()))
def test_segformer_op_on_rows_matches_whole_images(run, op):
    """Each SegFormer layer on a rank's rows (its halos and the gathered
    keys and values from the neighbour) equals the layer on whole images:
    the forward, the gradient with create_graph, and that gradient's own
    gradient in the input and the parameters, to 1e-6 of the largest
    element, on both ranks; the row gather's too (its backward a
    reduce-scatter, twice differentiable)."""
    for r in ranks(run, "ops"):
        errs = r[op]
        assert all(v <= 1e-6 for v in errs.values()), (r["rank"], errs)


@pytest.mark.parametrize("name, module", [("meanTeacher", "noise"),
                                          ("M3L", "mask")])
def test_ranks_draw_their_rows_of_one_process(run, name, module):
    """The draws each rank's step made (Mean Teacher's noise, M3L's mask
    grid) are its rows of each image of one process's draw, to the bit."""
    r0, r1 = ranks(run, name)
    one_process(run, name)
    want = npz(run, f"{name}_drawn", one=True)
    got = npz(run, f"{name}_drawn")
    assert sorted(want) == sorted(got) and len(want) == worker.STEPS
    for k, whole in want.items():
        h = whole.shape[1] // 2
        np.testing.assert_array_equal(got[k], whole[:, :h])
    assert r0["shas"] == r1["shas"]


@pytest.mark.parametrize("name", ["meanTeacher", "crossPse"])
def test_zoo_steps_match_one_process(run, name):
    """Two ranks of 32 rows a row of 4 + 4 images against one process at
    4 + 4: every metric within 1e-4 after each step, each tree's checksum
    within 1e-5 relative after 3 steps, the ranks' trees equal to the bit
    after every step; Mean Teacher's gate opened inside the run."""
    r0, r1 = ranks(run, name)
    want = one_process(run, name)
    _steps_match(r0, r1, want)
    if name == "meanTeacher":
        assert want["metrics"][0]["semi_loss"] == 0
        assert want["metrics"][-1]["semi_loss"] > 0


def _jax_state(jalgo, port_state, count: int):
    from smsut_tpu_torch.models.transplant import to_flax
    from torch_port_helpers import at_count

    state = jalgo.init_state(jax.random.PRNGKey(0))
    to = lambda t: jax.tree_util.tree_map(jnp.asarray, to_flax(t))
    kw = {k: to(getattr(port_state, k)) for k in ("params", "ema_params",
                                                  "params2")
          if getattr(port_state, k) is not None}
    return at_count(state.replace(**kw), count)


def test_mean_teacher_step_matches_jax_single_device(run):
    """One Mean Teacher step at 1 x 2 from count 100 (the consistency
    live), fed the JAX step's teacher noise (each rank its rows), against
    the JAX step on one device at the global batch from the port's
    initial weights: the metrics to rtol 2e-3 / atol 2e-4, the student and
    the teacher to tests/test_torch_train.py's bounds."""
    from smsut_tpu.config import Config as JConfig
    from smsut_tpu.train.steps.mean_teacher import MeanTeacher as JMT
    from smsut_tpu_torch.models.transplant import to_flax
    from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher

    r0, r1 = ranks(run, "meanTeacher")
    assert r0["jax_step_sha"] == r1["jax_step_sha"]
    cfg = worker.cfg()
    jalgo = JMT(JConfig(**{k: getattr(cfg, k) for k in (
        "input_size", "base_width", "batch_size", "num_iter_per_epoch",
        "max_epoch")}, **STRICT))
    port = MeanTeacher(cfg, device="cpu").init_state(0)
    state = _jax_state(jalgo, port, worker.MT_JAX_COUNT)
    b = worker.batches(1, seed=4)[0]
    scalars = dict(jalgo.epoch_scalars(worker.EPOCH),
                   rng=jax.random.PRNGKey(JAX_KEY))
    state, m = jalgo.train_step(state, b, scalars)
    for k in ("loss", "semi_loss", "alpha"):
        np.testing.assert_allclose(r0["jax_step"][k], float(m[k]),
                                   rtol=2e-3, atol=2e-4, err_msg=k)
    assert float(m["semi_loss"]) > 0
    got = npz(run, "meanTeacher_jax")
    for tree, prefix in (("params", ""), ("ema_params", "ema:")):
        t = {k[len(prefix):]: torch.from_numpy(v) for k, v in got.items()
             if k.startswith(prefix) and (prefix or ":" not in k)}
        assert_trees_close(to_flax(t), jax.device_get(getattr(state, tree)),
                           tree)


def test_cross_pseudo_step_matches_jax_single_device(run):
    """CPS's first step at 1 x 2 against the JAX step on one device at the
    global batch from the port's two initial nets: the four losses to
    rtol 2e-3 / atol 2e-4, net 1 to tests/test_torch_train.py's
    bounds."""
    from smsut_tpu.config import Config as JConfig
    from smsut_tpu.train.steps.cross_pseudo import CrossPseudo as JCPS
    from smsut_tpu_torch.models.transplant import to_flax
    from smsut_tpu_torch.train.steps.cross_pseudo import CrossPseudo

    r0, _ = ranks(run, "crossPse")
    cfg = worker.cfg()
    jalgo = JCPS(JConfig(**{k: getattr(cfg, k) for k in (
        "input_size", "base_width", "batch_size", "num_iter_per_epoch",
        "max_epoch")}, **STRICT))
    state = _jax_state(jalgo, CrossPseudo(cfg, device="cpu").init_state(0),
                       0)
    b = worker.batches()[0]
    state, m = jalgo.train_step(state, b, jalgo.epoch_scalars(worker.EPOCH))
    for k in ("loss", "loss2", "crossPse1_loss", "crossPse2_loss"):
        np.testing.assert_allclose(r0["metrics"][0][k], float(m[k]),
                                   rtol=2e-3, atol=2e-4, err_msg=k)
    got = {k: torch.from_numpy(v) for k, v in
           npz(run, "crossPse_step1").items()}
    assert_trees_close(to_flax(got), jax.device_get(state.params), "net 1")


@pytest.mark.parametrize("stage", ["pre", "cora"])
def test_coranet_steps_match_one_process(run, stage):
    """CoraNet's stage A from count 0 and stage B from count 999 (its
    certain and uncertain terms open at 1000), each rank its rows of the
    images and of the pseudo batch: the bounds of the zoo's steps."""
    r0, r1 = ranks(run, "coraNet")
    want = one_process(run, "coraNet")[stage]
    _steps_match(r0[stage], r1[stage], want)
    if stage == "cora":
        assert want["metrics"][0]["certain_loss"] == 0
        assert want["metrics"][-1]["certain_loss"] > 0


def test_coranet_sweep_matches_one_process(run):
    """The pseudo-label sweep at 1 x 2 (each rank's forward of its rows,
    the labels and masks gathered whole) against one process: both
    ranks hold the same pseudo set; the images equal; head 0's labels
    equal wherever one process's top two head-0 logits differ by more
    than 1e-4, the agreement mask wherever heads 1's and 2's do; the
    logged Dice within 1e-6."""
    from smsut_tpu_torch.ops.losses import split_heads
    from smsut_tpu_torch.train.steps.coranet import CoraNet

    r0, r1 = ranks(run, "coraNet")
    assert r0["sweep"] == r1["sweep"]
    want_dice = one_process(run, "coraNet")["sweep"]["dice"]
    got, want = npz(run, "coraNet_sweep"), npz(run, "coraNet_sweep",
                                               one=True)
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


def test_dtc_batch_norm_steps_match_one_process(run):
    """DTC w8 with batch norm and ReLU, each rank 32 rows of 4 images,
    against one process: the bounds of the zoo's steps (the batch norm's
    pixel count over the group, each pixel once)."""
    r0, r1 = ranks(run, "dtc")
    _steps_match(r0, r1, one_process(run, "dtc"))


def test_m3l_steps_match_one_process(run):
    """M3L at 1 x 2 (the SegFormer on rows: halo patch convs, the keys and
    values gathered, the head's resizes on rows, its batch norm over the
    group) against one process: 10b's float32 rules on step 1 (the losses
    within 1e-4 relative; every parameter of the student within 2.1 lr,
    under 1% beyond lr); the ranks' trees equal to the bit after each of
    3 steps."""
    r0, r1 = ranks(run, "M3L")
    want = one_process(run, "M3L")
    assert r0["shas"] == r1["shas"] and len(r0["shas"]) == worker.STEPS
    for m in ("loss", "semi_loss"):
        assert _rel(r0["metrics"][0][m], want["metrics"][0][m]) \
            < M3L_LOSS_TOL, (m, r0["metrics"], want["metrics"])
    lr = worker.cfg().lr
    got, ref = npz(run, "M3L_step1"), npz(run, "M3L_step1", one=True)
    dev = np.concatenate([np.abs(got[k] - v).ravel() for k, v in ref.items()])
    assert dev.max() <= FLIP_DEV * lr, dev.max()
    assert (dev > lr).mean() < FLIP_SHARE


def test_m3l_step1_gradient_matches_one_process(run):
    """M3L's first gradient at 1 x 2, averaged over the group (recovered
    from Adam's first moment, which unlike Adam's update scales with it),
    against one process's: the tree's checksum within 1e-5 relative, the
    zoo's SGD bound, and so each leaf's, relative to the tree's, so that a
    gradient scaled on some leaves (the gathered keys' and values')
    shows."""
    ranks(run, "M3L")
    one_process(run, "M3L")
    got, ref = npz(run, "M3L_grad1"), npz(run, "M3L_grad1", one=True)
    assert sorted(got) == sorted(ref)
    total = sum(np.abs(v.astype(np.float64)).sum() for v in ref.values())
    sums = {k: (np.abs(got[k].astype(np.float64)).sum(),
                np.abs(v.astype(np.float64)).sum()) for k, v in ref.items()}
    assert total > 0
    assert abs(sum(a for a, _ in sums.values()) - total) / total < SUM_TOL
    worst = max(sums, key=lambda k: abs(sums[k][0] - sums[k][1]))
    assert abs(sums[worst][0] - sums[worst][1]) / total < SUM_TOL, \
        (worst, sums[worst], total)


def test_m3l_eval_forward_on_rows_matches_one_process(run):
    """M3L's eval forward at 1 x 2 from the initial weights (its head's
    batch norm over the space group, which holds the batch's images
    whole): the rows' logits, gathered, within 1e-5 of one process's
    (relative to max(1, max |logit|)); both ranks hold the same."""
    r0, r1 = ranks(run, "M3L")
    assert r0["eval_sha"] == r1["eval_sha"]
    got = npz(run, "M3L_eval")["logits"]
    one_process(run, "M3L")
    ref = npz(run, "M3L_eval", one=True)["logits"]
    assert got.shape == ref.shape == (worker.BATCH, worker.SIZE,
                                      worker.SIZE, 5)
    err = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    assert err <= 1e-5, err


def test_coranet_cli_fit_matches_one_process(run, tmp_path):
    """``coraNetTrainer -p train --set spatial_parallel=2`` through both
    stages (A, then B from A's pre_best, its pseudo-label sweep each
    epoch) on two ranks against one process on the same tree: every
    scalar within 1e-4, a Dice (the [TST] Dice, the pseudo-labels') within
    3e-3, each stage's last checkpoint's checksum within 1e-5 relative;
    rank 0 alone made the runs."""
    r0, r1 = ranks(run, "fit")
    assert sorted(os.listdir(run["out"] / "fit" / "CoraNet")) == ["000",
                                                                  "001"]
    want = worker.fit(str(run["out"] / "data"), str(tmp_path), 1)
    for stage in ("pre", "cora"):
        seen, got = want[stage]["scalars"], r0[stage]["scalars"]
        assert got.keys() == seen.keys() == r1[stage]["scalars"].keys()
        assert "acc/plab_dice" in seen or stage == "pre"
        for tag, v in seen.items():
            bound = 3e-3 if "dice" in tag else LOSS_TOL
            for e, x in v.items():
                assert abs(got[tag][e] - x) <= bound, (stage, tag, got[tag],
                                                       v)
        assert _rel(r0[stage]["checksum"], want[stage]["checksum"]) \
            < SUM_TOL, stage


@pytest.mark.parametrize("what, error, names", [
    ("segformer", "ValueError", "24x24"),
    ("dtc_rows", "ValueError", "10x10"),
    ("make_mesh_2d", "ValueError", "spatial parallelism")])
def test_space_axis_refusals_in_a_group(run, what, error, names):
    """Under a group of 1 x 2 the Trainer refuses M3L at input 96 (the
    SegFormer's stage-1 rows); DTC refuses rows whose maps do not split;
    a model axis beside the space axis raises (the JAX package's tp x sp
    guard): each names what, and the first two spatial_parallel."""
    for r in ranks(run, "refuse"):
        assert r[what].startswith(error + ":"), r[what]
        assert names in r[what], r[what]
        if what != "make_mesh_2d":
            assert "spatial_parallel=2" in r[what], r[what]


def test_space_axis_takes_block_pallas_in_a_group(run):
    """Under a group of 1 x 2 the Trainer takes Mean Teacher with
    ``block_pallas``: K3 and K6 run split at their statistics on the
    rank's rows (tests/test_torch_spatial_block.py holds its steps
    against one process)."""
    for r in ranks(run, "refuse"):
        assert r["block_pallas"] == "ok: True", r["block_pallas"]
