# -*- coding: utf-8 -*-
"""Data parallelism of the port across processes, on the CPU (gloo).

Two ranks of ``tests/torch_distributed_worker.py`` start once for the
module and run every mode in turn (each process under its own timeout, so
that a hung collective fails the tests instead of hanging the run); while
they run, this process computes each mode's one-process reference at the
global batch:

- ``step``: the JAX package's ``SupervisedUNet`` in strict-parity mode
  (float32, unpacked, reduced statistics) at batch 8 from the port's
  initial weights (models/transplant.py), held with
  tests/test_distributed.py's bounds (loss 1e-4, parameter checksum 1e-5
  relative); ``elastic``: the checkpoint the two ranks wrote after 3 of 5
  steps, resumed here in one process, ends where the two ranks ended;
- ``gan``: one JAX ``uganConsis`` step (strict parity) with its draws fed
  to the port, with tests/test_distributed.py's GAN bounds;
- ``fit``: the port's Trainer at ``steps_per_dispatch=2`` with device
  augmentation through the sharded loaders, against the one-process
  Trainer (which tests/test_torch_dispatch.py holds against the JAX
  Trainer);
- ``pseudo``, ``eval``: CoraNet's pseudo set and batches, and the eval
  sweep's gathered predictions, against one process of the port, as
  tests/test_distributed.py holds the JAX package against itself;
- the refusals under a group of 2 (the zoo, which no longer refuses, is
  held to one process in tests/test_torch_distributed_zoo.py).

In every training mode the two ranks' parameters are equal to the bit
after every step.
"""
import hashlib
import json
import os
import random
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
from smsut_tpu_torch.parallel import distributed, mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_distributed_worker.py")
MODES = ("step", "gan", "fit", "pseudo", "eval", "refuse")
# one process's limit: the modes take about 30 s on two CPU threads each
WORKER_TIMEOUT_S = 180
GAN_CFG = dict(input_size=32, base_width=8, batch_size=4, nce_patches=4,
               compute_dtype="float32", num_iter_per_epoch=10, max_epoch=2,
               consis_gate_step=0)
JAX_STRICT = dict(pack_levels=0, norm_stats="reduce", device_augment=False,
                  pair_towers=False)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_distributed_worker as worker  # noqa: E402


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _jchecksum(tree) -> float:
    return float(sum(float(np.abs(v).sum()) for _, v in _flat(
        jax.device_get(tree))))


def _gan_inputs(path: str) -> dict:
    """The GAN mode's global batch and the JAX step's draws for
    ``PRNGKey(100)`` (tests/test_torch_gan.py), written for the ranks."""
    from test_torch_gan import jax_draws

    rng = np.random.default_rng(5)
    b, s = GAN_CFG["batch_size"], GAN_CFG["input_size"]
    batch = {"img": (0.5 * rng.normal(size=(b, s, s, 1))).astype(np.float32),
             "msk": worker.halves_differ(
                 rng.integers(0, 5, size=(b, s, s)).astype(np.int32)),
             "mdl": np.full(b, 1, np.int32),
             "ul_img": (0.5 * rng.normal(size=(b, s, s, 1))
                        ).astype(np.float32),
             "ul_mdl": np.full(b, 2, np.int32)}
    draws = jax_draws(jax.random.PRNGKey(100), 2 * b, (s // 16) ** 2,
                      GAN_CFG["nce_patches"])
    np.savez(path, cfg=json.dumps(GAN_CFG), **batch, **draws)
    return dict(batch, **draws)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The two ranks' results by mode ({mode: [rank 0's, rank 1's]}), the
    run directory and the GAN mode's inputs."""
    from smsut_tpu_torch.data.synthetic import make_synthetic_dataset

    out = tmp_path_factory.mktemp("dist")
    make_synthetic_dataset(str(out / "data"), n_patients_per_modality=3,
                           n_slice=8, size=32)
    gan = _gan_inputs(str(out / "gan.npz"))
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, SMSUT_COORDINATOR=f"127.0.0.1:{port}",
                   SMSUT_NUM_PROCESSES="2", SMSUT_PROCESS_ID=str(rank),
                   SMSUT_MODES=",".join(MODES), SMSUT_DIST_DIR=str(out),
                   SMSUT_NO_TB="1", OMP_NUM_THREADS="2",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        env.pop("SMSUT_DATA_ROOT", None)
        env.pop("SMSUT_EXPR_ROOT", None)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], env=env, cwd=str(out),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    state = {"procs": procs, "out": out, "gan": gan, "t0": time.time(),
             "results": None}
    yield state
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def results(run) -> dict:
    """Wait for the two ranks (each within WORKER_TIMEOUT_S of their
    start) and read every mode's JSON; a rank that failed fails here with
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
        got = {}
        for mode in MODES:
            got[mode] = []
            for rank in range(2):
                path = run["out"] / f"{mode}.{rank}.json"
                got[mode].append(json.loads(path.read_text())
                                 if path.exists() else None)
        run["results"] = (got, errs)
    got, errs = run["results"]
    return got, errs


def ranks(run, mode: str):
    got, errs = results(run)
    pair = got[mode]
    if any(r is None or "error" in r for r in pair):
        raise AssertionError(f"mode {mode} failed: "
                             + "\n".join(f"rank rc {rc}:\n{e[-3000:]}"
                                         for rc, e in errs)
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


# ----------------------------------------------------------- one process

def test_sharded_sampler_matches_jax():
    """The port's ShardedBatchSampler over its InTurnTrainBatchSampler
    gives the JAX package's rows for the same seed: contiguous slices of
    the global batches, in order."""
    from smsut_tpu.data.samplers import InTurnTrainBatchSampler as JInTurn
    from smsut_tpu.data.samplers import ShardedBatchSampler as JSharded
    from smsut_tpu_torch.data.samplers import (InTurnTrainBatchSampler,
                                               ShardedBatchSampler)

    samples = [list(range(i * 100, i * 100 + 40)) for i in range(4)]
    base = lambda cls: cls([list(s) for s in samples], 8,
                           rng=random.Random(7))
    glob = list(base(InTurnTrainBatchSampler))
    for sid in range(2):
        mine = list(ShardedBatchSampler(base(InTurnTrainBatchSampler), 2,
                                        sid))
        theirs = list(JSharded(base(JInTurn), 2, sid))
        assert mine == theirs
        assert [b[sid * 4:(sid + 1) * 4] for b in glob] == mine


def test_local_batch_slice_rejects_indivisible(monkeypatch):
    monkeypatch.setattr(distributed, "process_count", lambda: 3)
    monkeypatch.setattr(distributed, "process_index", lambda: 1)
    assert distributed.local_batch_slice(9) == slice(3, 6)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.local_batch_slice(8)


def test_get_loader_explicit_shards(tmp_path):
    """The two shards' batches concatenate to the one-process batch."""
    from smsut_tpu_torch.data.dataset import get_loader
    from smsut_tpu_torch.data.synthetic import make_synthetic_dataset

    root = str(tmp_path)
    make_synthetic_dataset(root, n_patients_per_modality=2, n_slice=8,
                           size=32)
    cfg = Config(num_workers=1)
    load = lambda n, i: get_loader(root, "train", 0, 4, cfg=cfg,
                                   rng=random.Random(3), num_shards=n,
                                   shard_id=i)
    count = 0
    for bf, b0, b1 in zip(load(1, 0), load(2, 0), load(2, 1)):
        assert b0.batch_size == b1.batch_size == 2
        np.testing.assert_array_equal(np.concatenate([b0.img, b1.img]),
                                      bf.img)
        np.testing.assert_array_equal(np.concatenate([b0.msk, b1.msk]),
                                      bf.msk)
        assert b0.names + b1.names == bf.names
        count += 1
    assert count > 0


@pytest.mark.parametrize("kw, exc, match", [
    (dict(spatial_parallel=2), ValueError, "launch a multiple of 2"),
    (dict(data_parallel=2), ValueError, "launch 2 processes"),
    (dict(batch_size=8, data_parallel=1), None, None)])
def test_single_process_knobs(kw, exc, match):
    """In one process ``data_parallel`` above 1 and ``spatial_parallel``
    above 1 raise, asking for the processes they need; they are not
    ignored."""
    cfg = Config(**kw)
    if exc is None:
        assert mesh.check_config(cfg) == 1
        return
    with pytest.raises(exc, match=match):
        mesh.check_config(cfg)


def test_tensor_parallel_refused():
    """``make_mesh_2d`` lays one process out as dp x tp = 1 x 1 (nothing
    sharded, every tensor copied), and refuses sizes whose product is not
    the group's, naming both."""
    m = mesh.make_mesh_2d(1, 1)
    assert m.shape == {"data": 1, "model": 1}
    tree = {"k": torch.arange(24.0).reshape(1, 1, 3, 8), "b": torch.ones(8)}
    got = mesh.shard_params_channelwise(m, tree)
    assert all(torch.equal(got[k], v) and got[k] is not v
               for k, v in tree.items())
    for dp, tp in ((2, 2), (1, 2), (2, 1)):
        with pytest.raises(ValueError, match=f"dp={dp}, tp={tp}"):
            mesh.make_mesh_2d(dp, tp)


def test_collectives_are_identities_without_a_group():
    x = torch.arange(6.0).reshape(2, 3)
    assert not torch.distributed.is_initialized()
    assert mesh.global_sum(x) is x
    assert mesh.all_gather_rows(x) is x
    grads = {"a": x}
    assert mesh.reduce_gradients_(grads)["a"] is x


# --------------------------------------------------------------- two ranks

@pytest.fixture(scope="module")
def jax_step():
    """Five JAX steps at the global batch from the port's initial weights:
    the losses and parameter checksums after each."""
    from smsut_tpu.config import Config as JConfig
    from smsut_tpu.train.steps.supervised import SupervisedUNet as JAlgo
    from smsut_tpu_torch.models.transplant import to_flax
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    cfg = worker.step_cfg()
    port = SupervisedUNet(cfg, device="cpu").init_state(0)
    jalgo = JAlgo(JConfig(input_size=64, base_width=4, batch_size=8,
                          compute_dtype="float32", **JAX_STRICT))
    state = jalgo.init_state(jax.random.PRNGKey(0))
    state = state.replace(params=jax.tree_util.tree_map(
        jnp.asarray, to_flax(port.params)))
    img, msk = worker.step_batch()
    losses, sums = [], []
    for _ in range(5):
        state, m = jalgo.train_step(state, {"img": img, "msk": msk}, {})
        losses.append(float(m["loss"]))
        sums.append(_jchecksum(state.params))
    return losses, sums


def test_step_matches_jax_one_process(run, jax_step):
    """Two ranks of 4 rows against the JAX step at 8: the loss within
    1e-4 and the parameter checksum within 1e-5 relative after 3 steps
    (tests/test_distributed.py), and after 5; the ranks' parameters equal
    to the bit after every step."""
    r0, r1 = ranks(run, "step")
    assert r0["shas"] == r1["shas"]
    assert r0["losses"] == r1["losses"]
    losses, sums = jax_step
    for k in (2, 4):
        assert abs(r0["losses"][k] - losses[k]) < 1e-4, (k, r0, losses)
        assert abs(r0["checksums"][k] - sums[k]) / max(abs(sums[k]), 1.0) \
            < 1e-5, (k, r0["checksums"], sums)


def test_elastic_resume_two_ranks_to_one_process(run):
    """The two ranks' checkpoint after 3 of 5 steps, resumed in one
    process for the last 2 steps at the global batch, ends where the two
    ranks ended (1e-4 / 1e-5)."""
    from smsut_tpu_torch.train import checkpoints
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    r0, _ = ranks(run, "step")
    algo = SupervisedUNet(worker.step_cfg(), device="cpu")
    state = checkpoints.load_state(algo.init_state(1), str(run["out"]),
                                   "elastic")
    assert state.step == 3 and int(state.count) == 3
    img, msk = worker.step_batch()
    for _ in range(2):
        state, m = algo.train_step(state, {"img": img, "msk": msk})
    cksum = worker.checksum(state.params)
    assert abs(r0["losses"][-1] - float(m["loss"])) < 1e-4
    assert abs(r0["checksums"][-1] - cksum) / max(abs(cksum), 1.0) < 1e-5


@pytest.fixture(scope="module")
def jax_gan(run):
    """One JAX uganConsis step at the global batch from the port's initial
    weights, with the draws the ranks were fed: the metrics and the G and
    D checksums."""
    from smsut_tpu.config import Config as JConfig
    from smsut_tpu.train.steps.gan import UGANConsisAlgo as JConsis
    from smsut_tpu_torch.models.transplant import disc_to_flax, ugan_to_flax
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    port = UGANConsisAlgo(Config(**GAN_CFG), device="cpu").init_state(0)
    jalgo = JConsis(JConfig(**GAN_CFG, **JAX_STRICT))
    state = jax.jit(jalgo.init_state)(jax.random.PRNGKey(0))
    to = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    state = state.replace(g_params=to(ugan_to_flax(port.g_params)),
                          d_params=to(disc_to_flax(port.d_params)))
    batch = {k: jnp.asarray(v) for k, v in run["gan"].items()
             if k in ("img", "msk", "mdl", "ul_img", "ul_mdl")}
    scalars = dict(jalgo.epoch_scalars(1), rng=jax.random.PRNGKey(100))
    state, m = jalgo.train_step(state, batch, scalars)
    return ({k: float(v) for k, v in m.items()},
            _jchecksum(state.g_params), _jchecksum(state.d_params))


def test_gan_step_matches_jax_one_process(run, jax_gan):
    """One uganConsis step on two ranks of 2 + 2 rows against the JAX
    step at 4 + 4 fed the same draws, with tests/test_distributed.py's
    bounds: the metrics of the pre-update parameters within 1e-4
    relative, G_cls and G_fake (through the updated D) within 5e-3, the
    G checksum within 1e-5 and the D checksum within 1e-4 relative; the
    ranks' G and D equal to the bit."""
    r0, r1 = ranks(run, "gan")
    assert (r0["g_sha"], r0["d_sha"]) == (r1["g_sha"], r1["d_sha"])
    want, g_sum, d_sum = jax_gan
    m = r0["metrics"]
    assert m["G_semi"] > 0
    for k in ("loss", "D_cls", "D_real", "D_fake", "D_gp", "G_nce", "G_rec",
              "G_seg", "G_semi"):
        assert abs(m[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1.0), \
            (k, m[k], want[k])
    for k in ("G_cls", "G_fake"):
        assert abs(m[k] - want[k]) < 5e-3, (k, m[k], want[k])
    assert abs(r0["g_checksum"] - g_sum) / max(abs(g_sum), 1.0) < 1e-5
    assert abs(r0["d_checksum"] - d_sum) / max(abs(d_sum), 1.0) < 1e-4


def test_fit_chunked_matches_one_process(run, tmp_path):
    """The Trainer at steps_per_dispatch 2 with device augmentation, two
    ranks against one process on the same tree: the [TRN] and [TST]
    losses within 1e-4, the [TST] Dice within 3e-3 (a reduction order
    moves an argmax near a tie), the parameter checksum within 1e-5
    relative; the ranks' parameters equal to the bit; rank 0 alone made
    the run directory and its log."""
    from smsut_tpu_torch.train.loop import Trainer
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    r0, r1 = ranks(run, "fit")
    assert r0["sha"] == r1["sha"]
    assert (r0["spectator"], r1["spectator"]) == (False, True)
    assert r1["model_root"] is None
    runs = os.listdir(run["out"] / "fit" / "SupervisedUNet")
    assert runs == ["000"], runs
    assert (run["out"] / "fit" / "SupervisedUNet" / "000" /
            "train.log").exists()
    cfg = worker.fit_cfg(str(run["out"] / "data"), str(tmp_path))
    trainer = Trainer(SupervisedUNet(cfg, device="cpu"), cfg, "train")
    seen = worker.record_scalars(trainer)
    trainer.fit("inTurn")
    trainer.exp.close()
    got = r0["scalars"]
    assert got.keys() == seen.keys()
    for tag, v in seen.items():
        bound = 3e-3 if tag.startswith("test/dice") else 1e-4
        assert abs(got[tag]["0"] - v["0"]) <= bound, (tag, got[tag], v)
    cksum = worker.checksum(trainer.state.params)
    assert abs(r0["checksum"] - cksum) / max(abs(cksum), 1.0) < 1e-5


def test_pseudo_matches_one_process(run):
    """CoraNet's pseudo set is equal on both ranks and to one process's;
    each rank's pseudo batches are its contiguous half of the one-process
    batch."""
    from smsut_tpu_torch.train.steps.coranet import CoraNet

    r0, r1 = ranks(run, "pseudo")
    assert r0["pseudo_sha"] == r1["pseudo_sha"]
    algo = CoraNet(worker.pseudo_cfg(str(run["out"] / "data")), device="cpu",
                   stage="cora")
    state = algo.init_state(0)
    algo._pseudo, dice = algo.pred_unlabel(
        state, algo._unlabeled_stream(worker.SweepHost()))
    algo._pseudo_order = []
    assert r0["pseudo_sha"] == worker.sha(*(algo._pseudo[k] for k in
                                            sorted(algo._pseudo)))
    assert abs(r0["plab_dice"] - dice) < 1e-6
    for d in range(3):
        b = algo.make_extra_batch()
        half = lambda sl: worker.sha(b["pse_img"][sl], b["pse_lab"][sl],
                                     b["pse_mask"][sl])
        assert r0["draws"][d] == half(slice(0, 2))
        assert r1["draws"][d] == half(slice(2, 4))


@pytest.mark.parametrize("scan", [True, False])
def test_eval_sweep_matches_one_process(run, tmp_path, scan):
    """The sweep cut into per-rank runs of batches (the last padded) and
    gathered: both ranks hold the one-process volumes (sha256) and meter
    losses within 1e-5."""
    r0, r1 = ranks(run, "eval")
    a, b = r0[str(scan)], r1[str(scan)]
    assert a["sha"] == b["sha"] and a["n"] == b["n"]
    want = worker.sweep(worker.eval_cfg(str(run["out"] / "data"),
                                        str(tmp_path), scan))
    assert a["n"] == want["n"] and a["sha"] == want["sha"]
    for k, v in want["meter"].items():
        assert abs(a["meter"][k] - v) < 1e-5, (k, a["meter"][k], v)


@pytest.mark.parametrize("n, world, want", [
    (8, 1, [list(range(8))]), (8, 2, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (3, 2, [[0, 1], [2, 2]]), (1, 2, [[0], [0]]),
    (5, 3, [[0, 1], [2, 3], [4, 4]])])
def test_eval_sweep_shares(monkeypatch, n, world, want):
    """The eval sweep's runs of batches per rank: contiguous,
    ceil(n / world) each, the last padded with the last batch (as the JAX
    package pads its per-process slices)."""
    from smsut_tpu_torch.train.loop import Trainer

    trainer = Trainer.__new__(Trainer)
    trainer._world = world
    got = []
    for r in range(world):
        monkeypatch.setattr(distributed, "process_index", lambda r=r: r)
        got.append(trainer._share(n))
    assert got == want


@pytest.mark.parametrize("what, error", [
    ("spatial_parallel=2", None),
    ("data_parallel=3", "ValueError"),
    ("meanTeacher", None),
    ("uganConsis B/N odd", None)])
def test_group_refusals(run, what, error):
    """Under a group of 2: a data_parallel that is not the group's size
    raises; the spatial axis with the fused block kernels (K3/K6 split at
    their statistics; tests/test_torch_spatial_block.py runs them), Mean
    Teacher and a uganConsis whose PatchNCE groups straddle the ranks (3
    rows a rank) construct (tests/test_torch_distributed_zoo.py holds the
    last two to one process)."""
    for r in ranks(run, "refuse"):
        if error is None:
            assert r[what] == "", r[what]
        else:
            assert r[what].startswith(error + ":"), r[what]
        assert r["data_parallel=2"] == ""
        assert r["uganConsis B/N even"] == ""
