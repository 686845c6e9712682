# -*- coding: utf-8 -*-
"""The zoo under a process group, on the CPU (gloo): Mean Teacher, CPS,
M3L, DTC's batch norm and ``uganConsis`` at one row per rank.

Two ranks of ``tests/torch_distributed_zoo_worker.py`` start once for the
module and run every mode in turn (each process under its own timeout, so
that a hung collective fails the tests instead of hanging the run); while
they run, this process runs each mode's function of the worker in one
process at the global batch, the reference:

- Mean Teacher (from count 99: its gate opens in the run) and CPS: the
  loss within 1e-4 and the parameter checksums within 1e-5 relative after
  3 steps (tests/test_distributed.py's bounds); the draws made inside the
  step (Mean Teacher's teacher noise);
- M3L, its mask grid drawn inside the step and its head's batch norm over
  the group: chip_smoke 10b's float32 rules on step 1 (the losses within
  1e-4 relative, the student after Adam's first update flip-aware), and
  3 steps with the ranks equal;
- ``batch_norm`` alone in float64: its output and gradients, and against
  the JAX package's ``BatchNorm`` (float64, x64 on, the norms' native
  statistics);
- DTC (batch norm, ReLU): 3 SGD steps, the loss and checksum bounds;
- ``uganConsis`` at a global batch of 2 + 2, one labelled and one
  unlabelled row a rank, so that every PatchNCE group straddles the ranks:
  tests/test_torch_distributed.py's GAN bounds.

In every training mode the two ranks' parameters are equal to the bit
after every step.
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

from smsut_tpu_torch.train.steps.m3l import mask_grid
from smsut_tpu_torch.train.steps.mean_teacher import teacher_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_distributed_zoo_worker.py")
MODES = ("meanTeacher", "crossPse", "M3L", "bn", "dtc", "uganConsis")
# one process's limit: the modes take about 40 s on two CPU threads each
WORKER_TIMEOUT_S = 180
# M3L's float32 rules on step 1 (chip_smoke 10b): the losses within 1e-4
# relative; after Adam's first update (about lr * sign(g)) every parameter
# within 2.1 lr, under 1% beyond lr
M3L_LOSS_TOL, FLIP_DEV, FLIP_SHARE = 1e-4, 2.1, 0.01

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_distributed_zoo_worker as worker  # noqa: E402


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks, started once; their results read by :func:`ranks`."""
    out = tmp_path_factory.mktemp("dist_zoo")
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, SMSUT_COORDINATOR=f"127.0.0.1:{port}",
                   SMSUT_NUM_PROCESSES="2", SMSUT_PROCESS_ID=str(rank),
                   SMSUT_MODES=",".join(MODES), SMSUT_DIST_DIR=str(out),
                   OMP_NUM_THREADS="2",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], env=env, cwd=str(out),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    state = {"procs": procs, "out": out, "t0": time.time(), "errs": None}
    yield state
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def ranks(run, mode: str):
    """Both ranks' results of ``mode``, after both ranks ended (within
    WORKER_TIMEOUT_S of their start); a rank that failed fails here with
    its error output."""
    if run["errs"] is None:
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
        run["errs"] = errs
    pair = []
    for rank in range(2):
        path = run["out"] / f"{mode}.{rank}.json"
        pair.append(json.loads(path.read_text()) if path.exists() else None)
    if any(r is None or "error" in r for r in pair):
        raise AssertionError(f"mode {mode} failed: "
                             + "\n".join(f"rank rc {rc}:\n{e[-3000:]}"
                                         for rc, e in run["errs"])
                             + "\n" + "\n".join(str(r) for r in pair))
    assert [r["rank"] for r in pair] == [0, 1]
    assert all(r["world"] == 2 and r["backend"] == "gloo" for r in pair)
    return pair


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1.0)


# ----------------------------------------------------------- one process

@pytest.mark.parametrize("count", [0, 99, 1234])
def test_teacher_noise_rows_are_the_global_draw(count):
    """A rank's rows of Mean Teacher's noise equal the global draw's rows
    to the bit: the hash runs over element indices of the global batch,
    and Box-Muller pairs element i with element n + i of the global n."""
    shape = (4, 8, 8, 1)
    c = torch.tensor(count)
    whole = teacher_noise(c, shape, 2020)
    for sl in (slice(0, 2), slice(2, 4), slice(1, 2)):
        part = teacher_noise(c, shape, 2020, [sl])
        assert part.shape == (sl.stop - sl.start, 8, 8, 1)
        assert torch.equal(part, whole[sl])
    # a rank's rows drawn as a batch of their own give other noise
    assert not torch.equal(teacher_noise(c, (2, 8, 8, 1), 2020), whole[2:])


@pytest.mark.parametrize("count", [0, 7])
def test_mask_grid_rows_are_the_global_draw(count):
    """A rank's labelled and unlabelled rows of M3L's mask grid equal the
    global grid's rows to the bit."""
    shape = (8, 2, 2)   # 2B rows at B = 4: labelled, then unlabelled
    c = torch.tensor(count)
    whole = mask_grid(c, shape, 2020)
    for r in range(2):
        sl = slice(2 * r, 2 * r + 2)
        got = mask_grid(c, shape, 2020, [sl, slice(4 + sl.start,
                                                    4 + sl.stop)])
        assert torch.equal(got, torch.cat([whole[sl], whole[4:][sl]]))


def test_batch_norm_one_process_matches_jax_float64():
    """The port's ``batch_norm`` in one process against the JAX package's
    ``BatchNorm`` in float64 (x64 on, native statistics): the output and
    the gradients of sum(y * cot) in x, scale and bias, within 1e-12."""
    from smsut_tpu.models import layers as jlayers

    x, cot, scale, bias = worker.bn_inputs()
    got = worker.run_bn()
    mode = jlayers._STATS_MODE
    jlayers.set_norm_stats("native")
    try:
        with jax.enable_x64(True):
            bn = jlayers.BatchNorm(dtype=jnp.float64)

            def loss(x, scale, bias):
                y = bn.apply({"params": {"scale": scale, "bias": bias}}, x)
                return jnp.sum(y * cot), y

            (_, y), grads = jax.value_and_grad(loss, (0, 1, 2), has_aux=True)(
                jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
            assert y.dtype == jnp.float64
            want = [np.asarray(v) for v in (y, *grads)]
    finally:
        jlayers.set_norm_stats(mode)
    for k, w in zip(("y", "dx", "dscale", "dbias"), want):
        np.testing.assert_allclose(np.array(got[k]), w, rtol=0, atol=1e-12,
                                   err_msg=k)


# --------------------------------------------------------------- two ranks

def test_batch_norm_two_ranks_match_one_process(run):
    """Each rank's output and x-gradient rows, and the scale's and bias's
    gradients summed over the group, equal one process's within 1e-12
    (float64); both ranks hold the same summed gradients."""
    want = worker.run_bn()
    r0, r1 = ranks(run, "bn")
    for k in ("y", "dx"):
        got = np.concatenate([np.array(r0[k]), np.array(r1[k])])
        np.testing.assert_allclose(got, np.array(want[k]), rtol=0,
                                   atol=1e-12, err_msg=k)
    for k in ("dscale", "dbias"):
        assert r0[k] == r1[k], k
        np.testing.assert_allclose(np.array(r0[k]), np.array(want[k]),
                                   rtol=0, atol=1e-12, err_msg=k)


def _drawn_rows(r0, r1, want, rows_of):
    """The draws each rank's step made are its rows of one process's, to
    the bit."""
    assert len(want["drawn"]) == worker.STEPS
    for k, whole in enumerate(want["drawn"]):
        whole = np.array(whole)
        for r, got in enumerate((r0, r1)):
            np.testing.assert_array_equal(np.array(got["drawn"][k]),
                                          whole[rows_of(r)])


@pytest.mark.parametrize("name", ["meanTeacher", "crossPse"])
def test_zoo_steps_match_one_process(run, name):
    """Two ranks of 2 + 2 rows against one process at 4 + 4: every
    metric within 1e-4 after each step, the checksum of each parameter
    tree within 1e-5 relative after 3 steps; the ranks' trees equal to
    the bit after every step; Mean Teacher's noise, drawn in each rank's
    step, the rank's rows of one process's."""
    want = worker.run_algo(name)
    r0, r1 = ranks(run, name)
    if name == "meanTeacher":
        _drawn_rows(r0, r1, want, lambda r: slice(2 * r, 2 * r + 2))
    assert r0["shas"] == r1["shas"]
    assert r0["metrics"] == r1["metrics"]
    for k in range(worker.STEPS):
        for m, v in want["metrics"][k].items():
            assert abs(r0["metrics"][k][m] - v) < 1e-4, (k, m, r0, want)
    if name == "meanTeacher":   # the gate opened inside the run
        assert want["metrics"][0]["semi_loss"] == 0
        assert want["metrics"][-1]["semi_loss"] > 0
    for tree, v in want["checksums"][-1].items():
        assert _rel(r0["checksums"][-1][tree], v) < 1e-5, (tree, r0, want)


def test_m3l_steps_match_one_process(run):
    """M3L on two ranks of 2 + 2 rows against one process at 4 + 4, its
    mask grid drawn in the step and its head's batch norm over the group:
    10b's float32 rules on step 1 (the losses within 1e-4 relative; every
    parameter of the student within 2.1 lr, under 1% beyond lr); the
    ranks' trees equal to the bit after each of 3 steps; the mask grid
    each rank's step drew its rows of one process's."""
    want = worker.run_algo("M3L")
    r0, r1 = ranks(run, "M3L")
    # the mask grid's rows: the rank's labelled, then its unlabelled
    _drawn_rows(r0, r1, want, lambda r: [2 * r, 2 * r + 1, 4 + 2 * r,
                                         5 + 2 * r])
    assert r0["shas"] == r1["shas"]
    assert len(r0["shas"]) == worker.STEPS
    for m in ("loss", "semi_loss"):
        assert _rel(r0["metrics"][0][m], want["metrics"][0][m]) \
            < M3L_LOSS_TOL, (m, r0["metrics"], want["metrics"])
    lr = worker.zoo_cfg().lr
    dev = np.concatenate([np.abs(np.array(r0["params"][k])
                                 - np.array(v)).ravel()
                          for k, v in want["params"].items()])
    assert dev.max() <= FLIP_DEV * lr, dev.max()
    assert (dev > lr).mean() < FLIP_SHARE


def test_dtc_batch_norm_steps_match_one_process(run):
    """DTC w8 with batch norm on two ranks of 2 rows against one process
    at 4: the loss within 1e-4 after each step, the checksum within 1e-5
    relative after 3 steps; the ranks equal to the bit after every
    step."""
    want = worker.run_dtc()
    r0, r1 = ranks(run, "dtc")
    assert r0["shas"] == r1["shas"]
    for k in range(worker.STEPS):
        assert abs(r0["losses"][k] - want["losses"][k]) < 1e-4, (r0, want)
    assert _rel(r0["checksums"][-1], want["checksums"][-1]) < 1e-5


def test_gan_one_row_per_rank_matches_one_process(run):
    """One uganConsis step, one labelled and one unlabelled row a rank,
    against one process at 2 + 2 with the same draws: the metrics within
    1e-4 relative (G_cls and G_fake, through the updated D, within 5e-3),
    the G checksum within 1e-5 and the D checksum within 1e-4 relative;
    the ranks' G and D equal to the bit."""
    want = worker.run_gan()
    r0, r1 = ranks(run, "uganConsis")
    assert (r0["g_sha"], r0["d_sha"]) == (r1["g_sha"], r1["d_sha"])
    m, w = r0["metrics"], want["metrics"]
    assert w["G_nce"] > 0 and w["G_semi"] > 0
    for k in ("loss", "D_cls", "D_real", "D_fake", "D_gp", "G_nce", "G_rec",
              "G_seg", "G_semi"):
        assert abs(m[k] - w[k]) <= 1e-4 * max(abs(w[k]), 1.0), (k, m, w)
    for k in ("G_cls", "G_fake"):
        assert abs(m[k] - w[k]) < 5e-3, (k, m[k], w[k])
    assert _rel(r0["g_checksum"], want["g_checksum"]) < 1e-5
    assert _rel(r0["d_checksum"], want["d_checksum"]) < 1e-4
