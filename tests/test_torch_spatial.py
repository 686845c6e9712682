# -*- coding: utf-8 -*-
"""The space axis of the port on the CPU (gloo): each rank holds rows of
every image (``Config.spatial_parallel``, ``parallel/mesh.py``).

Ranks of ``tests/torch_spatial_worker.py`` start once for the module: a
group of two (dp x sp = 1 x 2) that runs every mode in turn, and a group
of four (2 x 2) that runs the U-Net step; each process under its own
timeout, so that a hung collective fails the tests instead of hanging the
run.  While they run, this process computes the references:

- ``ops``: each layer that meets its neighbours, on the rank's rows
  against whole images in the rank itself, through a double backward (the
  gradient penalty's path), to 1e-6 of the largest element;
- ``step``: the JAX package's ``SupervisedUNet`` step at the global batch
  on one device (strict parity: float32, unpacked, reduced statistics)
  from the port's initial weights, with tests/test_spatial_parallel.py's
  bounds: the loss to rtol 1e-4, every parameter to rtol 1e-4 / atol
  1e-5;
- ``gan``: the JAX ``uganConsis`` step on one device fed the same draws,
  the metrics to rtol 2e-3 / atol 5e-5 (that file's bounds); the
  parameters after the step against the port's one-process step to the
  U-Net's bounds;
- ``fit``: ``unetTrainer -p train`` through ``run_main`` in one process,
  held with tests/test_torch_distributed.py's fit rules;
- the refusals, and the fused block kernels taken (``block_pallas``).
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_spatial_worker.py")
# group -> (ranks, space axis, modes)
GROUPS = {"1x2": (2, 2, ("ops", "step", "gan", "fit", "refuse")),
          "2x2": (4, 2, ("step",))}
# one process's limit: the modes take about 30 s on one CPU thread each
WORKER_TIMEOUT_S = 240
JAX_STRICT = dict(pack_levels=0, norm_stats="reduce", device_augment=False,
                  pair_towers=False)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_spatial_worker as worker  # noqa: E402


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _gan_inputs(path: str) -> dict:
    """The GAN mode's global batch and the JAX step's draws for
    ``PRNGKey(100)`` (tests/test_torch_gan.py), written for the ranks."""
    from test_torch_gan import jax_draws

    rng = np.random.default_rng(5)
    b, s = 4, 64
    img = lambda: (0.5 * rng.normal(size=(b, s, s, 1))).astype(np.float32)
    batch = {"img": img(), "msk": worker.step_batch(b, s)[1],
             "mdl": np.full(b, 1, np.int32), "ul_img": img(),
             "ul_mdl": np.full(b, 2, np.int32)}
    draws = jax_draws(jax.random.PRNGKey(100), 2 * b, (s // 16) ** 2,
                      worker.gan_cfg().nce_patches)
    np.savez(path, **batch, **draws)
    return dict(batch, **draws)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The groups' ranks, started; their run directories; the GAN mode's
    inputs."""
    from smsut_tpu_torch.data.synthetic import make_synthetic_dataset

    out = tmp_path_factory.mktemp("space")
    make_synthetic_dataset(str(out / "data"), n_patients_per_modality=2,
                           n_slice=4, size=64)
    gan = _gan_inputs(str(out / "gan.npz"))
    procs = {}
    for name, (world, sp, modes) in GROUPS.items():
        d = out / name
        d.mkdir()
        os.symlink(out / "data", d / "data")
        os.symlink(out / "gan.npz", d / "gan.npz")
        port = _free_port()
        procs[name] = []
        for rank in range(world):
            env = dict(os.environ, SMSUT_COORDINATOR=f"127.0.0.1:{port}",
                       SMSUT_NUM_PROCESSES=str(world),
                       SMSUT_PROCESS_ID=str(rank), SMSUT_SPACE=str(sp),
                       SMSUT_MODES=",".join(modes), SMSUT_DIST_DIR=str(d),
                       SMSUT_NO_TB="1", OMP_NUM_THREADS="1",
                       PYTHONPATH=REPO + os.pathsep + os.environ.get(
                           "PYTHONPATH", ""))
            env.pop("SMSUT_DATA_ROOT", None)
            env.pop("SMSUT_EXPR_ROOT", None)
            procs[name].append(subprocess.Popen(
                [sys.executable, WORKER], env=env, cwd=str(d),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    state = {"procs": procs, "out": out, "gan": gan, "t0": time.time(),
             "results": {}}
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
    world, sp, modes = GROUPS[group]
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
    assert all(r["world"] == world and r["space"] == sp for r in res)
    return res


def _npz(run, group: str, name: str) -> dict:
    with np.load(run["out"] / group / f"{name}.npz") as z:
        return {k: z[k] for k in z.files}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _close_trees(got: dict, want: dict, rtol: float, atol: float) -> None:
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- one process

@pytest.mark.parametrize("kw, match", [
    (dict(input_size=32, spatial_parallel=4), "input_size >= 64"),
    (dict(input_size=64, spatial_parallel=3), "whole rows"),
    (dict(input_size=128, spatial_parallel=8), "whole rows")])
def test_check_spatial_refuses(kw, match):
    """The JAX Trainer's guard (input_size // 16 >= max(4, sp)) and maps
    that do not split into whole rows (3 ranks of a 64 image; the
    discriminator's 8x8 map over 8 ranks, one odd row before its pool):
    each message names spatial_parallel."""
    cfg = Config(**kw)
    with pytest.raises((ValueError, NotImplementedError),
                       match="spatial_parallel"):
        mesh.check_spatial(cfg, cfg.spatial_parallel, gan=True)
    with pytest.raises((ValueError, NotImplementedError), match=match):
        mesh.check_spatial(cfg, cfg.spatial_parallel, gan=True)


def test_check_spatial_takes_block_pallas():
    """The fused block kernels run split at their statistics on the space
    axis (ops/block.py): the check takes ``block_pallas`` with the U-Net's
    and the GAN's maps."""
    cfg = Config(input_size=64, spatial_parallel=2, block_pallas=True)
    mesh.check_spatial(cfg, cfg.spatial_parallel, gan=True)


def test_single_process_refuses_space_axis():
    with pytest.raises(ValueError, match="spatial_parallel=2 in a single "
                                         "process"):
        mesh.check_config(Config(spatial_parallel=2))


# ----------------------------------------------------------- the groups

@pytest.mark.parametrize("op", list(worker.op_cases()))
def test_op_on_rows_matches_whole_images(run, op):
    """Each layer on a rank's rows (its halos from the neighbours, its
    statistics over the group) equals the layer on whole images: the
    forward, the gradient with create_graph, and that gradient's own
    gradient in the input and the parameters, to 1e-6 of the largest
    element, on both ranks."""
    for r in ranks(run, "1x2", "ops"):
        errs = r[op]
        assert all(v <= 1e-6 for v in errs.values()), (r["rank"], errs)


@pytest.fixture(scope="module")
def jax_step():
    """One JAX step at the global batch from the port's initial weights:
    the loss and the parameters."""
    from smsut_tpu.config import Config as JConfig
    from smsut_tpu.train.steps.supervised import SupervisedUNet as JAlgo
    from smsut_tpu_torch.models.transplant import to_flax
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    port = SupervisedUNet(worker.step_cfg(), device="cpu").init_state(0)
    jalgo = JAlgo(JConfig(input_size=64, base_width=4, batch_size=4,
                          compute_dtype="float32", **JAX_STRICT))
    state = jalgo.init_state(jax.random.PRNGKey(0))
    state = state.replace(params=jax.tree_util.tree_map(
        jnp.asarray, to_flax(port.params)))
    img, msk = worker.step_batch()
    state, m = jalgo.train_step(state, {"img": img, "msk": msk}, {})
    return float(m["loss"]), jax.device_get(state.params)


@pytest.mark.parametrize("group", list(GROUPS))
def test_unet_step_matches_jax_single_device(run, jax_step, group):
    """One U-Net step at dp x sp against the JAX step on one device: the
    loss to rtol 1e-4, every parameter to rtol 1e-4 / atol 1e-5
    (tests/test_spatial_parallel.py); the ranks' parameters equal to the
    bit."""
    from smsut_tpu_torch.models.transplant import to_flax

    res = ranks(run, group, "step")
    assert len({r["sha"] for r in res}) == 1
    assert len({r["loss"] for r in res}) == 1
    loss, params = jax_step
    np.testing.assert_allclose(res[0]["loss"], loss, rtol=1e-4)
    got = {k: torch.from_numpy(v) for k, v in _npz(run, group,
                                                     "step").items()}
    _close_trees(to_flax(got), params, 1e-4, 1e-5)


@pytest.fixture(scope="module")
def gan_refs(run):
    """One uganConsis step at the global batch with the ranks' draws: the
    JAX step's metrics (from the port's initial weights), and the port's
    one-process parameters after its float64 step."""
    from smsut_tpu.config import Config as JConfig
    from smsut_tpu.train.steps.gan import UGANConsisAlgo as JConsis
    from smsut_tpu_torch.models.transplant import disc_to_flax, ugan_to_flax
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    cfg = worker.gan_cfg()
    algo = UGANConsisAlgo(cfg, device="cpu")
    port = algo.init_state(0)
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
    port, _ = worker.gan_step({k: g[k] for k in (
        "img", "msk", "mdl", "ul_img", "ul_mdl", "mj", "alpha",
        "patch_ids")}, True)
    return ({k: float(v) for k, v in m.items() if k != "rng"},
            port.g_params, port.d_params)


def test_gan_step_matches_jax_single_device(run, gan_refs):
    """One uganConsis step at 1 x 2 (4 + 4 images, 32 rows a rank) against
    the JAX step on one device fed the same draws: every metric of the
    float32 step to rtol 2e-3 / atol 5e-5 (tests/test_spatial_parallel.py);
    the ranks' G and D equal to the bit.  G and D after the step against
    the port's one-process step to rtol 1e-4 / atol 1e-5, both in float64:
    in float32 the translation's second pass amplifies the reassociation
    of the split sums (the two forwards' x_rec differ by ~8e-4 in float32,
    ~2e-12 in float64), and the L1 and Dice gradients through it move by
    up to 8% of a tensor's largest element on both sides of any exact
    split, as the JAX file's docstring measures for GSPMD."""
    r0, r1 = ranks(run, "1x2", "gan")
    assert (r0["g_sha"], r0["d_sha"]) == (r1["g_sha"], r1["d_sha"])
    want, g_params, d_params = gan_refs
    m = r0["metrics"]
    assert m["G_semi"] > 0 and m["G_nce"] > 0
    for k, v in want.items():
        np.testing.assert_allclose(m[k], v, rtol=2e-3, atol=5e-5,
                                   err_msg=k)
    for name, tree in (("gan_g", g_params), ("gan_d", d_params)):
        _close_trees(_npz(run, "1x2", name),
                     {k: v.numpy() for k, v in tree.items()}, 1e-4, 1e-5)


def test_cli_fit_matches_one_process(run, tmp_path):
    """``unetTrainer -p train --set spatial_parallel=2`` through
    ``run_main`` on two ranks against one process on the same tree: the
    [TRN] and [TST] scalars within 1e-4, the [TST] Dice within 3e-3, the
    last checkpoint's parameter checksum within 1e-5 relative; rank 0
    alone made the run directory."""
    r0, r1 = ranks(run, "1x2", "fit")
    runs = os.listdir(run["out"] / "1x2" / "fit" / "SupervisedUNet")
    assert runs == ["000"], runs
    seen, raw = worker.fit(str(run["out"] / "data"), str(tmp_path), 1)
    cksum = float(sum(float(np.abs(np.asarray(v)).sum())
                      for v in raw["params"].values()))
    for r in (r0, r1):
        assert r["scalars"].keys() == seen.keys()
    got = r0["scalars"]
    for tag, v in seen.items():
        bound = 3e-3 if tag.startswith("test/dice") else 1e-4
        assert abs(got[tag]["0"] - v["0"]) <= bound, (tag, got[tag], v)
    assert abs(r0["checksum"] - cksum) / max(abs(cksum), 1.0) < 1e-5


@pytest.mark.parametrize("what, error", [
    ("input_size=32", "ValueError"),
    ("make_mesh_2d", "ValueError")])
def test_space_axis_refusals(run, what, error):
    """Under a group of 1 x 2: the JAX guard's size and a model axis
    beside the space axis (the JAX package's tp x sp guard) raise, naming
    what."""
    names = {"input_size=32": "spatial_parallel",
             "make_mesh_2d": "spatial parallelism"}
    for r in ranks(run, "1x2", "refuse"):
        assert r[what].startswith(error + ":"), r[what]
        assert names[what] in r[what], r[what]


@pytest.mark.parametrize("what, want", [
    ("block_pallas", "ok: True"), ("fused block", "ok: [[1, 32, 64, 5], 0]"),
    ("meanTeacher", "ok: True")])
def test_space_axis_takes_block_pallas(run, what, want):
    """Under a group of 1 x 2 the fused block kernels run split at their
    statistics: the Trainer takes ``block_pallas`` for the U-Net and for
    the zoo's Mean Teacher, and a fused w16 U-Net runs on a rank's 32 rows
    with all nine blocks fused (none routed to the unfused chain)."""
    for r in ranks(run, "1x2", "refuse"):
        assert r[what] == want, r[what]
