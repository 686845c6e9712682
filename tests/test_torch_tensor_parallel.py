# -*- coding: utf-8 -*-
"""The model axis of the port on the CPU (gloo): channel-wise tensor
parallelism (``parallel/mesh.py`` ``make_mesh_2d``,
``shard_params_channelwise``) against the JAX package.

Ranks of ``tests/torch_tp_worker.py`` start once for the module: a group
of four (dp x tp = 2 x 2) that runs the port's ``dryrun_multichip(4)``,
the U-Net step in both block modes and the checkpoint's save, and a group
of two (1 x 2) that runs ``eval_fn``, the ``uganConsis`` step, the
``ugan`` and ``uganShp0`` steps, the checkpoint's load and the refusals; each process under its own timeout,
so that a hung collective fails the tests instead of hanging the run.
While they run, this process computes the references:

- the sharded set: the port's rule against the JAX
  ``shard_params_channelwise`` on a CPU mesh, for the U-Net's and the
  GAN's trees;
- ``step``: two JAX ``SupervisedUNet`` steps at the global batch on one
  device (strict parity: float32, unpacked, reduced statistics; with
  ``block_pallas`` its Pallas kernels in interpret mode) from the port's
  initial weights, with tests/test_tensor_parallel.py's bounds: the loss
  to rtol 1e-5, every parameter to rtol 1e-4 / atol 1e-5;
- ``gan``: the JAX ``uganConsis`` step on one device fed the same draws,
  with ``__graft_entry__.dryrun_multichip``'s bounds;
- ``eval``, the variants (in float64) and the checkpoint: the port in
  one process.
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

from smsut_tpu_torch.models.transplant import (disc_from_flax, to_flax,
                                               ugan_to_flax)
from smsut_tpu_torch.parallel import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tp_worker.py")
# group -> (ranks, model axis, modes)
GROUPS = {"2x2": (4, 2, ("dryrun", "step", "save")),
          "1x2": (2, 2, ("eval", "gan", "variants", "load", "refuse"))}
WORKER_TIMEOUT_S = 240
JAX_STRICT = dict(pack_levels=0, norm_stats="reduce", device_augment=False,
                  pair_towers=False)
GAN_LR = 1e-4

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_tp_worker as worker  # noqa: E402


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
    batch = {"img": img(), "msk": rng.integers(0, 5, size=(b, s, s)
                                               ).astype(np.int32),
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
    out = tmp_path_factory.mktemp("tp")
    gan = _gan_inputs(str(out / "gan.npz"))
    (out / "ckpt").mkdir()
    procs = {}
    for name, (world, tp, modes) in GROUPS.items():
        d = out / name
        d.mkdir()
        os.symlink(out / "gan.npz", d / "gan.npz")
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


# ------------------------------------------------------------ one process

def _port_trees(name: str, width: int) -> dict:
    """The port's whole parameter tree ``name`` at ``width``."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    cfg = Config(input_size=64, base_width=width, batch_size=2,
                 compute_dtype="float32")
    if name == "unet":
        return SupervisedUNet(cfg, device="cpu").init_params(0)
    gan = UGANConsisAlgo(cfg, device="cpu")
    return (gan.net if name == "gan_g" else gan.D).state_dict()


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("name", ["unet", "gan_g", "gan_d"])
def test_sharded_set_matches_jax(name, width, tp):
    """The port shards exactly the leaves to which the JAX
    ``shard_params_channelwise`` gives a 'model' spec (the flax tree of
    the same weights, models/transplant.py), its shards are ``C/tp`` of
    the output channels, and a train state's optimizer trees shard the
    same keys."""
    from smsut_tpu.parallel.mesh import (
        make_mesh_2d as jax_mesh_2d,
        shard_params_channelwise as jax_shard,
    )

    tree = _port_trees(name, width)
    keys = mesh.sharded_keys({k: v.shape for k, v in tree.items()}, tp)
    marks = {k: torch.full_like(v, float(k in keys)) for k, v in tree.items()}
    jtree = jax_shard(jax_mesh_2d(1, tp), jax.tree_util.tree_map(
        jnp.asarray, to_flax(tree)))
    want = {k: "model" in str(v.sharding.spec)
            for k, v in _flat_leaves(jtree)}
    got = {k: bool(v.all()) for k, v in _flat(to_flax(marks))}
    assert got == want
    assert keys, "nothing sharded"
    for k in keys:
        s = mesh.shard_shape(tree[k].shape, tp)
        assert s[-1] * tp == tree[k].shape[-1] and s[-1] >= 4, (k, s)


def _flat_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def test_optimizer_trees_shard_as_params():
    """``shard_params_channelwise`` on a whole train state (one process,
    a mesh of 1 x 1 and the rule at tp 2) keeps the optimizer trees'
    keys with the parameters': SGD's traces, Adam's moments."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    gan = UGANConsisAlgo(Config(input_size=64, base_width=8, batch_size=2,
                                compute_dtype="float32"), device="cpu")
    st = gan.init_state(0)
    d = mesh.sharded_keys({k: v.shape for k, v in st.d_params.items()}, 2)
    shards = {k: mesh.shard_tensor(v, 2, 1) for k, v in
              st.d_opt_state.mu.items()}
    assert {k for k, v in shards.items()
            if v.shape != st.d_opt_state.mu[k].shape} == d
    whole = mesh.shard_params_channelwise(mesh.make_mesh_2d(1, 1), st)
    assert not whole.g_shards and not whole.d_shards
    assert all(torch.equal(whole.d_opt_state.nu[k], v)
               for k, v in st.d_opt_state.nu.items())


# ----------------------------------------------------------- the groups

@pytest.fixture(scope="module")
def jax_steps():
    """Two JAX U-Net steps at the global batch from the port's initial
    weights, per block mode: the losses and the parameters."""
    from smsut_tpu.config import Config as JConfig
    from smsut_tpu.train.steps.supervised import SupervisedUNet as JAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    init = to_flax(SupervisedUNet(worker.step_cfg(), device="cpu")
                   .init_params(0))
    img, msk = worker.step_batch()
    out = {}
    for fused in (False, True):
        jalgo = JAlgo(JConfig(input_size=32, base_width=8, batch_size=4,
                              compute_dtype="float32", block_pallas=fused,
                              **JAX_STRICT))
        state = jalgo.init_state(jax.random.PRNGKey(0))
        state = state.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                            init))
        losses = []
        for _ in range(worker.STEPS):
            state, m = jalgo.train_step(
                state, {"img": img, "msk": msk.astype(np.int32)}, {})
            losses.append(float(m["loss"]))
        out[fused] = (losses, jax.device_get(state.params))
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_unet_step_matches_jax_single_device(run, jax_steps, fused):
    """Two U-Net steps at dp x tp = 2 x 2 against the JAX steps on one
    device: every loss to rtol 1e-5, every parameter to rtol 1e-4 / atol
    1e-5 (tests/test_tensor_parallel.py); the ranks of a model group hold
    the replicated parameters equal to the bit and each its own shards,
    a rank's parameters and momentum half the sharded tensors' whole
    size.  Routed per step at w8: unfused, the 3x3 convs of levels 1 and
    2, whose shards' Cout of 4 and 8 K5 does not take (8); fused, the two
    level-1 blocks, which K3 does not take at w8 in one process either,
    run unfused (their 4 convs routed) and the other 7 run K3/K6's path on
    their gathered weights."""
    res = [r[str(fused)] for r in ranks(run, "2x2", "step")]
    assert len({r["sha"] for r in res}) == 1
    assert len({(r["whole_sha"], str(r["losses"])) for r in res}) == 1
    r = res[0]
    assert r["sharded_numel"] * 2 == r["sharded_whole"]
    assert r["numel"] == r["whole_numel"] - r["sharded_numel"]
    assert r["tp_gathered"] == (7 if fused else 0)
    assert r["routed"] == ([4, 2] if fused else [8, 0]), r["routed"]
    losses, params = jax_steps[fused]
    np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
    got = {k: torch.from_numpy(v) for k, v in
           _npz(run, "2x2", f"step_{int(fused)}").items()}
    _close_trees(to_flax(got), params, 1e-4, 1e-5)


def test_eval_fn_matches_one_process(run):
    """``eval_fn`` on the shards at 1 x 2 against one process from the
    same weights: the logits to 1e-5 of the largest, both ranks equal to
    the bit."""
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    r0, r1 = ranks(run, "1x2", "eval")
    assert r0["sha"] == r1["sha"]
    algo = SupervisedUNet(worker.step_cfg(), device="cpu")
    want = algo.eval_fn(algo.init_params(0), worker.step_batch()[0]).numpy()
    got = _npz(run, "1x2", "eval")["logits"]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def jax_gan(run):
    """The JAX ``uganConsis`` step at the global batch from the port's
    initial weights and the ranks' draws: its metrics and D."""
    from smsut_tpu.config import Config as JConfig
    from smsut_tpu.train.steps.gan import UGANConsisAlgo as JConsis
    from smsut_tpu_torch.models.transplant import disc_to_flax
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    cfg = worker.gan_cfg()
    port = UGANConsisAlgo(cfg, device="cpu").init_state(0)
    jalgo = JConsis(JConfig(**{k: getattr(cfg, k) for k in (
        "input_size", "base_width", "batch_size", "nce_patches", "lr",
        "compute_dtype", "consis_gate_step")}, **JAX_STRICT))
    state = jax.jit(jalgo.init_state)(jax.random.PRNGKey(0))
    to = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    state = state.replace(g_params=to(ugan_to_flax(port.g_params)),
                          d_params=to(disc_to_flax(port.d_params)))
    g = run["gan"]
    batch = {k: jnp.asarray(g[k]) for k in ("img", "msk", "mdl", "ul_img",
                                             "ul_mdl")}
    scalars = dict(jalgo.epoch_scalars(1), rng=jax.random.PRNGKey(100))
    state, m = jalgo.train_step(state, batch, scalars)
    return ({k: float(v) for k, v in m.items() if k != "rng"},
            disc_from_flax(jax.device_get(state.d_params)))


def test_gan_step_matches_jax_single_device(run, jax_gan):
    """One uganConsis step at 1 x 2 (w8, 64x64, 4 + 4, lr 1e-4) against
    the JAX step on one device fed the same draws, with the JAX dry run's
    bounds: every metric within 1e-3 of 1 + |value|; D after Adam within
    2.1 lr everywhere, under 1% of it more than 1.5 lr apart; both ranks'
    G and D equal to the bit, both towers and D sharded."""
    r0, r1 = ranks(run, "1x2", "gan")
    assert (r0["g_sha"], r0["d_sha"]) == (r1["g_sha"], r1["d_sha"])
    assert min(r0["shards"]) > 0
    want, d_want = jax_gan
    m = r0["metrics"]
    assert m["G_semi"] > 0 and m["G_nce"] > 0
    for k, v in want.items():
        dev = abs(m[k] - v) / (1.0 + abs(v))
        assert dev < 1e-3, (k, m[k], v)
    got = _npz(run, "1x2", "gan_d")
    assert got.keys() == d_want.keys()
    devs = [np.abs(got[k].astype(np.float64) - d_want[k].numpy())
            for k in d_want]
    assert max(float(x.max()) for x in devs) <= 2.1 * GAN_LR
    flips = sum(int((x > 1.5 * GAN_LR).sum()) for x in devs)
    assert flips < 0.01 * sum(x.size for x in devs)


@pytest.mark.parametrize("name", list(worker.VARIANTS))
def test_gan_variant_matches_one_process(run, name):
    """``ugan`` and ``uganShp0`` at 1 x 2, one float64 step from the same
    weights and draws, against the port's one process: the metrics, G and
    D within 1e-9 relative (float64 leaves only the reassociation of the
    channel sums); both ranks equal to the bit."""
    r0, r1 = ranks(run, "1x2", "variants")
    assert r0[name]["sha"] == r1[name]["sha"]
    g = run["gan"]
    batch = {k: g[k] for k in ("img", "msk", "mdl", "ul_img", "ul_mdl",
                               "mj", "alpha", "patch_ids")}
    metrics, g_want, d_want = worker.variant_step(name, batch)
    for k, v in metrics.items():
        np.testing.assert_allclose(r0[name]["metrics"][k], v, rtol=1e-9,
                                   err_msg=k)
    for part, want in (("g", g_want), ("d", d_want)):
        _close_trees(_npz(run, "1x2", f"{name}_{part}"),
                     {k: v.numpy() for k, v in want.items()}, 1e-9, 1e-12)


def test_checkpoint_round_trip_and_mesh_change(run, tmp_path):
    """Saved at 2 x 2 after two steps: the file holds the whole trees (a
    one-process save's keys and shapes), loads into one process equal to
    the gathered trees to the bit, and into a sharded 2 x 2 template whose
    next step equals the uninterrupted run's to the bit; loaded at 1 x 2,
    its next step meets the U-Net's bounds against one process's step
    from the same file."""
    from smsut_tpu_torch.train import checkpoints
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    res = ranks(run, "2x2", "save")
    assert all(r["restored_step"] == 2 for r in res)
    assert len({r["saved_sha"] for r in res}) == 1
    for r in res:
        assert r["sha"][0] == r["sha"][1] and r["trees"][0] == r["trees"][1]
        assert r["loss"][0] == r["loss"][1]
    ckpt = str(run["out"] / "ckpt")
    algo = SupervisedUNet(worker.step_cfg(), device="cpu")
    one = algo.init_state(0)
    checkpoints.save_state(one, str(tmp_path), "one")
    raw, ref = (checkpoints.load_raw(d, p) for d, p in ((ckpt, "tp"),
                                                      (str(tmp_path), "one")))
    assert raw.keys() == ref.keys()
    for t in ("params", "opt_state"):
        assert {k: v.shape for k, v in raw[t].items()} == \
            {k: v.shape for k, v in ref[t].items()}
    state = checkpoints.load_state(algo.init_state(1), ckpt, "tp")
    assert worker.tree_sha(state.params) == res[0]["saved_sha"]
    loaded = ranks(run, "1x2", "load")
    assert all(r["restored_step"] == 2 for r in loaded)
    assert loaded[0]["sha"] == loaded[1]["sha"]
    img, msk = worker.step_batch()
    state, m = algo.train_step(state, {"img": img, "msk": msk})
    np.testing.assert_allclose(loaded[0]["loss"], float(m["loss"]),
                               rtol=1e-5)
    _close_trees(_npz(run, "1x2", "load"),
                 {k: v.numpy() for k, v in state.params.items()}, 1e-4, 1e-5)


@pytest.mark.parametrize("what, error, name", [
    ("whole state", "ValueError", "shards do not match"),
    ("make_mesh_2d", "ValueError", "dp=2, tp=2"),
    ("spatial_parallel", "ValueError", "spatial parallelism"),
    ("tp x sp", "ValueError", "spatial parallelism"),
    ("shard under sp", "ValueError", "spatial parallelism")])
def test_model_axis_refusals(run, what, error, name):
    """At 1 x 2: a state whose trees are not the mesh's shards, a layout
    whose size is not the group's, and the JAX package's tp x sp guard,
    whichever axis comes second, raise (the zoo runs on the model axis:
    tests/test_torch_tensor_parallel_zoo.py)."""
    for r in ranks(run, "1x2", "refuse"):
        assert r[what].startswith(error + ":"), r[what]
        assert name in r[what], r[what]


def test_dryrun_multichip_four_ranks(run):
    """The port's ``dryrun_multichip(4)``: both layouts (2 x 2 on the
    model axis and on the space axis) within the JAX dry run's bounds
    against one process, the same report on every rank."""
    res = ranks(run, "2x2", "dryrun")
    lines = {r["line"] for r in res}
    assert len(lines) == 1
    line = lines.pop()
    assert line.startswith("dryrun_multichip(4): ok") and "dpxtp" in line \
        and "dpxsp" in line, line
