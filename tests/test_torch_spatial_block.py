# -*- coding: utf-8 -*-
"""The fused block kernels K3/K6 on the space axis of the port, on the CPU
(gloo): each rank holds rows of every image (``Config.spatial_parallel``)
and the blocks run split at their statistics (``ops/block.py``
``split_block_fwd``, ``split_block_bwd``; on the CPU their plain twins).

Two ranks of ``tests/torch_spatial_block_worker.py`` (dp x sp = 1 x 2)
start once for the module, each under its own timeout; while they run,
this process computes the references:

- ``ops``: the block on a rank's rows against whole images, identity and
  shortcut forms, float32, forward and backward, to 1e-6 of the largest
  element (norm 1's bias far from 0: a y1 halo row beyond the image
  padded with zeros instead of left out fails it);
- ``step``: the JAX package's ``SupervisedUNet`` step on one device
  (strict parity; the JAX step runs the unfused blocks, which in float32
  differ from K3/K6 by summation order alone), loss to rtol 1e-4, every
  parameter to rtol 1e-4 / atol 1e-5;
- ``gan``: the JAX ``uganConsis`` step on one device fed the same draws,
  every metric to rtol 2e-3 / atol 5e-5;
- ``meanTeacher``: three Mean Teacher steps in one process (this one),
  tests/test_torch_spatial_zoo.py's bounds;
- ``remat``: the U-Net step with ``remat_unet`` and ``block_pallas`` in one
  process.

And in this process alone: the plain convs' row window against the SAME
conv and weight gradient on the rows it stands for.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_spatial_block_worker.py")
MODES = ("ops", "step", "remat", "gan", "meanTeacher")
WORKER_TIMEOUT_S = 240
LOSS_TOL, SUM_TOL = 1e-4, 1e-5

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_spatial_block_worker as worker  # noqa: E402
import torch_spatial_worker as sw  # noqa: E402
from test_torch_spatial import JAX_STRICT, _close_trees, _free_port, \
    _gan_inputs  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks, started; their directory; the GAN's inputs."""
    out = tmp_path_factory.mktemp("space_block")
    gan = _gan_inputs(str(out / "gan.npz"))
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
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], env=env, cwd=str(out),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    one = out / "one"
    one.mkdir()
    np.savez(one / "gan.npz", **{k: np.asarray(v) for k, v in gan.items()})
    state = {"procs": procs, "out": out, "one": one, "gan": gan,
             "t0": time.time(), "results": None, "refs": {}}
    yield state
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def ranks(run, mode: str):
    """Both ranks' results of ``mode``, after waiting for them (each
    within WORKER_TIMEOUT_S of their start)."""
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
    global batch, once."""
    if mode not in run["refs"]:
        worker.OUT = str(run["one"])
        run["refs"][mode] = worker.MODES[mode]()
    return run["refs"][mode]


def _npz(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------------------ one process alone

@pytest.mark.parametrize("k, hin, off", [(3, 10, 1), (3, 9, 0), (3, 9, 1),
                                         (1, 8, 0)])
def test_row_window_matches_same_conv(k, hin, off):
    """The plain convs' row window (8 output rows of an input of ``hin``
    rows at offset ``off``: both neighbours' rows, the row below only, the
    row above only, the 1x1) equals the SAME conv and weight gradient on
    the whole map whose rows 4-11 the output is, zero rows standing for
    what lies beyond the input."""
    from smsut_tpu_torch.ops.conv3x3 import conv_f32, dw_f32

    rng = np.random.default_rng(5)
    whole = torch.from_numpy(rng.normal(size=(2, 16, 6, 8)).astype(
        np.float32))
    w = torch.from_numpy(rng.normal(size=(k, k, 8, 16)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(2, 8, 6, 16)).astype(np.float32))
    first = 4 - off                        # the whole map's row of x's row 0
    x = whole[:, first:first + hin]
    masked = torch.zeros_like(whole)
    masked[:, first:first + hin] = x
    torch.testing.assert_close(conv_f32(x, w, 8, off),
                               conv_f32(masked, w)[:, 4:12], rtol=0,
                               atol=1e-5)
    gfull = torch.zeros(2, 16, 6, 16)
    gfull[:, 4:12] = g
    torch.testing.assert_close(dw_f32(x, g, k, off),
                               dw_f32(masked, gfull, k), rtol=1e-5,
                               atol=1e-4)


# ------------------------------------------------------------ two ranks

@pytest.mark.parametrize("form", list(worker.BLOCK_FORMS))
def test_split_block_on_rows_matches_whole_images(run, form):
    """The fused block (K3 forward, K6 backward, split at their statistics)
    on a rank's rows equals the block on whole images: the output and dx
    on the rank's rows, every parameter's gradient summed over the group,
    to 1e-6 of the largest element, on both ranks."""
    for r in ranks(run, "ops"):
        errs = r[form]
        assert all(v <= 1e-6 for v in errs.values()), (r["rank"], errs)


def jax_unet_step(remat: bool = False):
    """One JAX ``SupervisedUNet`` step at the global batch on one device,
    from the port's initial weights: (loss, parameters)."""
    from smsut_tpu.config import Config as JConfig
    from smsut_tpu.train.steps.supervised import SupervisedUNet as JAlgo
    from smsut_tpu_torch.models.transplant import to_flax
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    port = SupervisedUNet(sw.step_cfg(), device="cpu").init_state(0)
    jalgo = JAlgo(JConfig(input_size=64, base_width=4, batch_size=4,
                          compute_dtype="float32", remat_unet=remat,
                          **JAX_STRICT))
    state = jalgo.init_state(jax.random.PRNGKey(0))
    state = state.replace(params=jax.tree_util.tree_map(
        jnp.asarray, to_flax(port.params)))
    img, msk = sw.step_batch()
    state, m = jalgo.train_step(state, {"img": img, "msk": msk}, {})
    return float(m["loss"]), jax.device_get(state.params)


def test_fused_unet_step_on_rows_matches_jax_single_device(run):
    """One U-Net step at 1 x 2 with ``block_pallas`` (the fused blocks
    that take their shape at w4, the others routed, counted) against the
    JAX step on one device: the loss to rtol 1e-4, every parameter to
    rtol 1e-4 / atol 1e-5; the ranks equal to the bit."""
    from smsut_tpu_torch.models.transplant import to_flax

    r0, r1 = ranks(run, "step")
    assert r0["sha"] == r1["sha"] and r0["loss"] == r1["loss"]
    assert r0["routed"] == 4, r0   # 2 -> 4 and 8 -> 4 (Cout 4), both ways
    loss, params = jax_unet_step()
    np.testing.assert_allclose(r0["loss"], loss, rtol=1e-4)
    got = {k: torch.from_numpy(v)
           for k, v in _npz(run["out"] / "step.npz").items()}
    _close_trees(to_flax(got), params, 1e-4, 1e-5)


def test_fused_gan_step_on_rows_matches_jax_single_device(run):
    """One ``uganConsis`` step at 1 x 2 with ``block_pallas`` against the
    JAX step on one device fed the same draws: every metric to rtol 2e-3
    / atol 5e-5 (tests/test_spatial_parallel.py's bounds); the ranks' G
    and D equal to the bit."""
    from smsut_tpu.config import Config as JConfig
    from smsut_tpu.train.steps.gan import UGANConsisAlgo as JConsis
    from smsut_tpu_torch.models.transplant import disc_to_flax, ugan_to_flax
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    r0, r1 = ranks(run, "gan")
    assert (r0["g_sha"], r0["d_sha"]) == (r1["g_sha"], r1["d_sha"])
    cfg = sw.gan_cfg()
    port = UGANConsisAlgo(cfg, device="cpu").init_state(0)
    jalgo = JConsis(JConfig(**{k: getattr(cfg, k) for k in (
        "input_size", "base_width", "batch_size", "nce_patches",
        "compute_dtype", "consis_gate_step")}, **JAX_STRICT))
    state = jax.jit(jalgo.init_state)(jax.random.PRNGKey(0))
    to = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    state = state.replace(g_params=to(ugan_to_flax(port.g_params)),
                          d_params=to(disc_to_flax(port.d_params)))
    g = run["gan"]
    batch = {k: jnp.asarray(g[k]) for k in ("img", "msk", "mdl", "ul_img",
                                             "ul_mdl")}
    scalars = dict(jalgo.epoch_scalars(1), rng=jax.random.PRNGKey(100))
    _, m = jalgo.train_step(state, batch, scalars)
    got = r0["metrics"]
    assert got["G_semi"] > 0 and got["G_nce"] > 0
    for k, v in m.items():
        if k != "rng":
            np.testing.assert_allclose(got[k], float(v), rtol=2e-3,
                                       atol=5e-5, err_msg=k)


def _steps_match(r0: dict, r1: dict, want: dict) -> None:
    assert r0["shas"] == r1["shas"] and r0["metrics"] == r1["metrics"]
    assert len(r0["metrics"]) == len(want["metrics"]) == 3
    for k, (got, w) in enumerate(zip(r0["metrics"], want["metrics"])):
        for m, v in w.items():
            assert abs(got[m] - v) < LOSS_TOL, (k, m, got, w)
    for tree, v in want["checksums"][-1].items():
        got = r0["checksums"][-1][tree]
        assert abs(got - v) / max(abs(v), 1.0) < SUM_TOL, (tree, got, v)


def test_fused_mean_teacher_on_rows_matches_one_process(run):
    """Three Mean Teacher steps with ``block_pallas`` (the student's and
    the teacher's fused blocks split at their statistics) at 1 x 2 against
    one process: every metric within 1e-4 after each step, each tree's
    checksum within 1e-5 relative after the last, the ranks equal to the
    bit; the consistency's gate opened inside the run."""
    r0, r1 = ranks(run, "meanTeacher")
    want = one_process(run, "meanTeacher")
    _steps_match(r0, r1, want)
    assert want["metrics"][0]["semi_loss"] == 0
    assert want["metrics"][-1]["semi_loss"] > 0


def test_remat_fused_step_on_rows_matches_one_process(run):
    """The U-Net step with ``remat_unet`` and ``block_pallas`` at 1 x 2 (the
    towers' second forward repeating the split blocks' halos and sums in
    the backward) against the same step in one process: the loss within
    1e-4, the parameters' checksum within 1e-5 relative, every parameter
    to rtol 1e-4 / atol 1e-5; the ranks equal to the bit, and equal to
    the same step without remat (``step``) to the bit."""
    r0, r1 = ranks(run, "remat")
    s0 = ranks(run, "step")[0]
    assert r0["sha"] == r1["sha"] == s0["sha"]
    want = one_process(run, "remat")
    assert abs(r0["loss"] - want["loss"]) < LOSS_TOL
    assert abs(r0["checksum"] - want["checksum"]) / want["checksum"] \
        < SUM_TOL
    _close_trees(_npz(run["out"] / "remat.npz"),
                 _npz(run["one"] / "remat.npz"), 1e-4, 1e-5)
