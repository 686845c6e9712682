# -*- coding: utf-8 -*-
"""The fit loop: the port's trainer CLI end to end on the CPU, a resumed
run against an uninterrupted one, and a replay of the JAX ``Trainer``'s
recorded batch stream through the port's ``Trainer`` from the same initial
weights (strict parity: float32, host augmentation, f32 statistics)."""
import os
import subprocess
import sys
from os.path import join as pjoin

import numpy as np
import pytest
import torch

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.data.dataset import Batch
from smsut_tpu_torch.data.synthetic import make_synthetic_dataset
from smsut_tpu_torch.models.transplant import from_flax
from smsut_tpu_torch.train import experiment as port_experiment
from smsut_tpu_torch.train import loop as port_loop
from smsut_tpu_torch.train.cli import make_parser, run_main
from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUG = ("data_aug={'rotate':True,'rotate_degrees':15,'resizeCrop':True,"
       "'resizeCrop_size':32,'elasticDeform':True,'elasticDeform_sigmas':"
       "(9.0,13.0),'elasticDeform_points':3,'colorJitter':False,"
       "'gammaCorrect':False,'gammaCorrect_gammas':(0.7,1.5)}")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's CPU steps share the process with XLA's thread pool; two
    torch threads keep the host from being oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setenv("SMSUT_NO_TB", "1")


@pytest.fixture
def scalars(monkeypatch):
    """Every Experiment.scalar call of the port, by model dir:
    {model_idx: {tag: {epoch: value}}}."""
    seen = {}

    def capture(self, tag, value, step):
        seen.setdefault(self.model_idx, {}).setdefault(tag, {})[step] = \
            float(value)

    monkeypatch.setattr(port_experiment.Experiment, "scalar", capture)
    return seen


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    make_synthetic_dataset(root, n_patients_per_modality=3, n_slice=4,
                           size=32)
    return root


def _args(data_root, expr_root, *extra, epochs=2):
    return (["--data_root", data_root, "--expr_root", expr_root,
             "--device", "cpu", "--set", "input_size=32",
             "--set", "base_width=4", "--set", "batch_size=4",
             "--set", "num_iter_per_epoch=4", "--set", f"max_epoch={epochs}",
             "--set", "num_workers=2", "--set", "compute_dtype=float32",
             "--set", AUG] + list(extra))


class _OneEpoch(SupervisedUNet):
    """A run cut after its first epoch: the fit loop ends at the
    algorithm's ``max_epoch`` and saves ``last``, while the config (and so
    the LR schedule) is the full run's."""
    max_epoch = 1


def test_cli_train_test_and_resume(data_root, tmp_path, scalars):
    """(a) ``-p train`` then ``-p test -i 000 -wh best`` (the module CLI,
    in a subprocess) on the CPU: train.log with [TRN] and [TST] lines,
    best and last checkpoints, expriments.log and a 2x5-row CSV.  Then a
    run cut after epoch 0 and resumed with ``--resume 001:last`` gives the
    uninterrupted run's epoch-1 losses and Dice (same CPU ops on the same
    batches: equal to 1e-6)."""
    expr = str(tmp_path / "expr")
    run_main(SupervisedUNet, make_parser().parse_args(
        ["-p", "train"] + _args(data_root, expr)))
    model = pjoin(expr, "SupervisedUNet", "000")
    log = open(pjoin(model, "train.log")).read()
    assert log.count("[TRN]") == 2 and log.count("[TST]") == 2
    for tag in ("best", "last"):
        assert os.path.isfile(pjoin(model, "ckpt", f"{tag}.ckpt"))
    assert "SupervisedUNet" in open(pjoin(expr, "expriments.log")).read()
    assert not os.path.exists(pjoin(model, "code", "build"))

    out = subprocess.run(
        [sys.executable, "-m", "smsut_tpu_torch.trainer.unetTrainer", "-p",
         "test", "-i", "000", "-wh", "best"] + _args(data_root, expr),
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, SMSUT_NO_TB="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [r for r in open(pjoin(model, "all_trois_matrix.csv")).read()
            .strip().split("\n") if r]
    assert len(rows) == 2 * 5
    assert all(np.isfinite([float(v) for v in r.split(",")]).all()
               for r in rows)

    run_main(_OneEpoch, make_parser().parse_args(
        ["-p", "train", "-nm", "SupervisedUNet"] + _args(data_root, expr)))
    run_main(SupervisedUNet, make_parser().parse_args(
        ["-p", "train", "--resume", "001:last"] + _args(data_root, expr)))
    whole, cut, resumed = scalars["000"], scalars["001"], scalars["002"]
    assert sorted(cut["train/loss"]) == [0] and sorted(
        resumed["train/loss"]) == [1]
    assert cut["train/loss"][0] == whole["train/loss"][0]
    for tag in ("train/loss", "train/loss_ct", "test/dice", "test/loss"):
        np.testing.assert_allclose(resumed[tag][1], whole[tag][1],
                                   rtol=1e-6, err_msg=tag)
    assert "Resuming at epoch 1" in open(
        pjoin(expr, "SupervisedUNet", "002", "train.log")).read()


def test_cli_refusals(data_root, tmp_path):
    with pytest.raises(SystemExit):
        run_main(SupervisedUNet, make_parser().parse_args(
            ["-p", "test"] + _args(data_root, str(tmp_path))))
    with pytest.raises(SystemExit):
        run_main(SupervisedUNet, make_parser().parse_args(
            ["-p", "pseudo"] + _args(data_root, str(tmp_path))))
    with pytest.raises(SystemExit):
        run_main(SupervisedUNet, make_parser().parse_args(
            ["-p", "train", "--set", "no_such_knob=1"]
            + _args(data_root, str(tmp_path))))


# ------------------------------------------------------ replay vs the JAX loop

# The JAX Trainer's run and the port's replay of its stream, at the
# strict-parity config of tools/rehearse_parity.py (plus pack_levels=0 and
# norm_stats="reduce"), 3 epochs of 4 iterations at 32^2, width 4.
# Measured (this test's inputs): [TRN] losses within 3e-5 relative; [TST]
# Dice within 9.3e-4 overall and 3.7e-3 per modality, the test phase's mo
# matrix within 0.0145 and its assd matrix within 0.044.  The Dice of a net
# this young (about 0.03) moves with the argmax of near-tied logits, so the
# drift of float32 summation order grows there; tools/rehearse_parity.py
# measured the same kind of envelope for the JAX loop against a torch
# re-derivation.  Bounds: losses rtol 2e-3 / atol 2e-4 (the training
# slice's step bounds, tests/test_torch_train.py); Dice, mo and assd at
# about 3x the measured drift; the best epoch equal.  The eval path itself
# is held tighter, on one set of weights (test_eval_on_one_set_of_weights).
EPOCHS, ITERS, SIZE, WIDTH, BATCH = 3, 4, 32, 4, 4
DICE_TOL = 3e-3
DICE_MODALITY_TOL = 1e-2
MO_TOL = 0.05
ASSD_TOL = 0.15


class _Replay:
    """A loader that hands the port's Trainer a recorded stream."""

    def __init__(self, loader, stream):
        self.dataset = loader.dataset
        self.post = None
        self._stream = stream

    def iter_cycle(self):
        for img, msk, mdl in self._stream:
            yield Batch(img, msk, mdl, [])
        raise AssertionError("the replay ran past the recorded stream")


def _best_epoch(dice):
    best, at = -np.inf, -1
    for e in sorted(dice):
        if dice[e] >= best:
            best, at = dice[e], e
    return at


def _csv(path):
    rows = [r for r in open(path).read().split("\n")]
    blocks, cur = [], []
    for r in rows:
        if r:
            cur.append([float(v) for v in r.split(",")])
        elif cur:
            blocks.append(np.array(cur))
            cur = []
    return blocks


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    from tools.rehearse_parity import _strict_cfg, run_jax

    data = str(tmp_path_factory.mktemp("replay_data"))
    from smsut_tpu.data.synthetic import make_synthetic_dataset as j_synth

    j_synth(data, n_patients_per_modality=3, n_slice=4, size=SIZE)
    cfg = _strict_cfg(data, str(tmp_path_factory.mktemp("jax_expr")), EPOCHS,
                      ITERS, SIZE, WIDTH, BATCH).replace(
        pack_levels=0, norm_stats="reduce")
    init, stream, scal, csv_path = run_jax(cfg)
    return data, init, stream, scal, csv_path, cfg


def test_replay_matches_jax_trainer(jax_run, tmp_path, monkeypatch, scalars):
    """(b) The port's Trainer.fit on the JAX Trainer's recorded training
    stream, from its initial weights: per-epoch [TRN] losses, [TST] Dice,
    the best epoch and the test phase's matrices."""
    data, init, stream, want, csv_path, _ = jax_run
    assert len(stream) == EPOCHS * ITERS
    cfg = Config(base_root=data, expr_root=str(tmp_path), input_size=SIZE,
                 base_width=WIDTH, batch_size=BATCH, num_iter_per_epoch=ITERS,
                 max_epoch=EPOCHS, num_workers=1, prefetch_depth=1,
                 device_augment=False, compute_dtype="float32",
                 data_aug=dict(Config().data_aug, resizeCrop_size=SIZE))
    algo = SupervisedUNet(cfg, device="cpu")
    trainer = port_loop.Trainer(algo, cfg, "train")
    trainer.state = algo.state_from_params(from_flax(init))
    real = port_loop.get_loader

    def replaying(root, phase, fold, bs, *a, **kw):
        loader = real(root, phase, fold, bs, *a, **kw)
        return _Replay(loader, stream) if phase == "train" else loader

    monkeypatch.setattr(port_loop, "get_loader", replaying)
    trainer.fit("inTurn")
    monkeypatch.setattr(port_loop, "get_loader", real)
    trainer.load_model(trainer.exp.model_idx, "best")
    got_csv = trainer.test("inTurn", trainer.exp.model_root)
    trainer.exp.close()
    got = scalars[trainer.exp.model_idx]

    mods = ("ct", "t1in", "t1out", "t2")
    for tag in ["train/loss"] + [f"train/loss_{m}" for m in mods]:
        assert sorted(got[tag]) == sorted(want[tag]) == list(range(EPOCHS))
        np.testing.assert_allclose(
            [got[tag][e] for e in range(EPOCHS)],
            [want[tag][e] for e in range(EPOCHS)], rtol=2e-3, atol=2e-4,
            err_msg=tag)
    for tag in ["test/dice"] + [f"test/dice_{m}" for m in mods]:
        np.testing.assert_allclose(
            [got[tag][e] for e in range(EPOCHS)],
            [want[tag][e] for e in range(EPOCHS)], rtol=0,
            atol=DICE_TOL if tag == "test/dice" else DICE_MODALITY_TOL,
            err_msg=tag)
    assert _best_epoch(got["test/dice"]) == _best_epoch(want["test/dice"])
    (mo_p, assd_p), (mo_j, assd_j) = _csv(got_csv), _csv(csv_path)
    assert mo_p.shape == mo_j.shape == (5, 5)
    np.testing.assert_allclose(mo_p, mo_j, rtol=0, atol=MO_TOL)
    np.testing.assert_allclose(assd_p, assd_j, rtol=0, atol=ASSD_TOL)


def test_eval_on_one_set_of_weights(jax_run, tmp_path):
    """The port's eval sweep (padded batches, slice->volume scatter) and
    the JAX package's eval forward + volume metrics on the same weights:
    the predicted volumes agree on all but a few voxels and the mo and
    assd matrices agree.  Measured: all voxels equal, matrices equal.
    Bounds: 1e-4 of the voxels; mo within 1e-3, assd within 1e-2."""
    import jax
    import jax.numpy as jnp

    from smsut_tpu.data.dataset import get_loader as j_get_loader
    from smsut_tpu.ops import metrics as jm
    from smsut_tpu.train.steps.supervised import SupervisedUNet as JAlgo
    from smsut_tpu_torch.data.dataset import get_label_npys, get_loader
    from smsut_tpu_torch.models.transplant import to_flax
    from smsut_tpu_torch.ops import metrics as pm

    data, init, _, _, _, jcfg = jax_run
    cfg = Config(base_root=data, expr_root=str(tmp_path), input_size=SIZE,
                 base_width=WIDTH, batch_size=BATCH, num_workers=1,
                 compute_dtype="float32")
    algo = SupervisedUNet(cfg, device="cpu")
    trainer = port_loop.Trainer(algo, cfg, "train")
    trainer.state = algo.state_from_params(from_flax(init))
    _, gt = get_label_npys(data, "test")
    _, got = trainer.validate_epoch(get_loader(data, "test", 0, BATCH, cfg=cfg),
                                    gt)
    trainer.exp.close()

    jalgo = JAlgo(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    to_flax(trainer.state.params))
    fwd = jax.jit(jalgo.eval_fn)
    want = {k: np.zeros_like(v) for k, v in gt.items()}
    for b in j_get_loader(data, "test", 0, BATCH, cfg=jcfg):
        pred = np.asarray(jnp.argmax(fwd(params, b.img), -1))
        for i, name in enumerate(b.names):
            m, pid, z = name.split("_")
            want[f"{m}_{pid}"][int(z)] = pred[i]
    off = sum(int((got[k] != want[k]).sum()) for k in gt)
    assert off <= 1e-4 * sum(v.size for v in gt.values()), off
    np.testing.assert_allclose(pm.get_mo_matrix(got, gt, cfg),
                               jm.get_mo_matrix(want, gt, jcfg), atol=1e-3)
    np.testing.assert_allclose(pm.get_all_matrix(got, gt, cfg)[2],
                               jm.get_all_matrix(want, gt, jcfg)[2],
                               atol=1e-2)
