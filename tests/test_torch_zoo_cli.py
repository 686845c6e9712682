# -*- coding: utf-8 -*-
"""The semi-supervised trainers' CLIs on the CPU (``--device cpu``, a tiny
synthetic tree): Mean Teacher, cross-pseudo supervision, M3L and CoraNet's
two stages train, test (the trois CSV), resume and write the ``-p pseudo``
dumps (PNG, read back with PIL), and the GAN's ``-p pseudo`` its
translation strips.  With each stream of host draws on its own generator
(the Trainer's ``labeled_loader_rng``, ``unlabeled_loader_rng``,
``pseudo_sweep_rng``), a run cut after its first epoch and resumed takes
the uninterrupted run's second epoch, and two fresh runs log the same
losses in every epoch, for Mean Teacher and ``uganConsis``, which draw
both loaders, and for CoraNet's stage B, which also draws the sweep and
the pseudo batches."""
import os
import subprocess
import sys
from os.path import join as pjoin

import numpy as np
import pytest
from PIL import Image

from smsut_tpu_torch.data.synthetic import make_synthetic_dataset
from smsut_tpu_torch.train import checkpoints, experiment
from smsut_tpu_torch.train.cli import make_parser, run_main
from smsut_tpu_torch.train.steps.coranet import CoraNet
from smsut_tpu_torch.train.steps.cross_pseudo import CrossPseudo
from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
from smsut_tpu_torch.train.steps.m3l import M3L
from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher
from smsut_tpu_torch.trainer import coraNetTrainer
from torch_port_helpers import few_torch_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUG = ("data_aug={'rotate':True,'rotate_degrees':15,'resizeCrop':True,"
       "'resizeCrop_size':32,'elasticDeform':True,"
       "'elasticDeform_sigmas':(9.0,13.0),'elasticDeform_points':3,"
       "'colorJitter':False,'gammaCorrect':False,"
       "'gammaCorrect_gammas':(0.7,1.5)}")
BS, ITERS = 2, 3
# the test split of the synthetic tree: 1 patient per modality, 4 slices
TEST_SLICES = 4 * 4

pytestmark = pytest.mark.usefixtures("few_torch_threads")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    make_synthetic_dataset(root, n_patients_per_modality=3, n_slice=4,
                           size=32)
    return root


@pytest.fixture
def scalars(monkeypatch):
    """Every scalar the runs log, by experiment index, tag and epoch."""
    seen = {}

    def capture(self, tag, value, step):
        idx = os.path.basename(self.model_root)
        seen.setdefault(idx, {}).setdefault(tag, {})[step] = float(value)

    monkeypatch.setattr(experiment.Experiment, "scalar", capture)
    return seen


def _args(data_root, expr_root, *extra):
    return (["--data_root", data_root, "--expr_root", expr_root,
             "--device", "cpu", "--set", "input_size=32",
             "--set", "base_width=8", "--set", f"batch_size={BS}",
             "--set", "nce_patches=4", "--set", f"num_iter_per_epoch={ITERS}",
             "--set", "max_epoch=2", "--set", "num_workers=2",
             "--set", "compute_dtype=float32", "--set", AUG] + list(extra))


def _run(cls, *argv):
    run_main(cls, make_parser().parse_args(list(argv)))


def _cut(cls):
    """``cls`` with a run cut after its first epoch (the config, and so
    the schedules, are the full run's)."""
    return type(cls.__name__, (cls,), {"max_epoch": 1})


def _check_pseudo(model: str, gan: bool = False) -> None:
    root = pjoin(model, "pseudo")
    names = sorted(os.listdir(root))
    kinds = ("pse", "gt", "ori") + (("fk",) if gan else ())
    slices = {n[:-len(k) - 4] for n in names for k in kinds
              if n.endswith(k + ".png")}
    assert len(slices) == TEST_SLICES, names
    for s in slices:
        for k in kinds:
            img = np.asarray(Image.open(pjoin(root, f"{s}{k}.png")))
            want = (32, 32 * 5) if k == "fk" else (32, 32, 3)
            assert img.shape == want, (s, k, img.shape)
    gt = np.asarray(Image.open(pjoin(root, f"{sorted(slices)[1]}gt.png")))
    assert gt.max() == 255   # a coloured organ


def _check_test(model: str) -> None:
    rows = [r for r in open(pjoin(model, "all_trois_matrix.csv")).read()
            .strip().split("\n") if r]
    assert len(rows) == 2 * 5
    assert all(np.isfinite([float(v) for v in r.split(",")]).all()
               for r in rows)


def _resume_equal(cls, data_root, expr, scalars, whole: str, name: str,
                  cut: str):
    """A run of ``cls`` cut after epoch 1 (index ``cut``), then resumed:
    the cut run's epoch equals the uninterrupted run ``whole``'s first,
    the resumed run's its second (1e-6)."""
    _run(_cut(cls), "-p", "train", "-nm", name, *_args(data_root, expr))
    _run(cls, "-p", "train", "--resume", f"{cut}:last",
         *_args(data_root, expr))
    resumed = f"{int(cut) + 1:03d}"
    w, c, r = (scalars[k]["train/loss"] for k in (whole, cut, resumed))
    assert sorted(c) == [0] and sorted(r) == [1]
    np.testing.assert_allclose(c[0], w[0], rtol=1e-6)
    np.testing.assert_allclose(r[1], w[1], rtol=1e-6)
    assert "Resuming at epoch 1 (step 3)" in open(
        pjoin(expr, name, resumed, "train.log")).read()


@pytest.mark.parametrize("cls", [MeanTeacher, CrossPseudo, M3L])
def test_cli_train_test_resume_pseudo(cls, data_root, tmp_path, scalars):
    expr = str(tmp_path / "expr")
    name = cls.__name__
    _run(cls, "-p", "train", *_args(data_root, expr))
    model = pjoin(expr, name, "000")
    log = open(pjoin(model, "train.log")).read()
    assert log.count("[TRN]") == 2 and log.count("[TST]") == 2
    if cls is CrossPseudo:
        assert "[net2] Number of parameters" in log
    raw = checkpoints.load_raw(pjoin(model, "ckpt"), "last")
    assert raw["step"] == 2 * ITERS
    # M3L's Adam keeps its moments and its own count
    opt = ({"opt_mu", "opt_nu", "opt_count"} if cls is M3L
           else {"opt_state"})
    assert {"params"} | opt < raw.keys()
    if cls is M3L:
        assert raw["opt_count"] == 2 * ITERS
    assert ("ema_params" in raw) == (cls in (MeanTeacher, M3L))
    assert ("params2" in raw) == ("opt_state2" in raw) == (cls is CrossPseudo)

    module = {MeanTeacher: "meanTeacherTrainer",
              CrossPseudo: "crossPseTrainer", M3L: "M3LTrainer"}[cls]
    out = subprocess.run(
        [sys.executable, "-m", f"smsut_tpu_torch.trainer.{module}",
         "-p", "test", "-i", "000", "-wh", "best"] + _args(data_root, expr),
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, SMSUT_NO_TB="1", OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    _check_test(model)
    _run(cls, "-p", "pseudo", "-i", "000", "-wh", "best",
         *_args(data_root, expr))
    _check_pseudo(model)
    _resume_equal(cls, data_root, expr, scalars, "000", name, "001")


def test_coranet_two_stages(data_root, tmp_path, scalars, monkeypatch):
    expr = str(tmp_path / "expr")
    stage = ("--set", "pre_epoch=2", "--set", "cora_epoch=2",
             "--set", "pred_step=1")
    # stage B's pseudo terms live from count 0, so that its losses read
    # the pseudo batches
    monkeypatch.setattr(CoraNet, "gate_step", 0)
    main = lambda *a: coraNetTrainer.main(make_parser().parse_args(list(a)))
    main("-p", "train", *_args(data_root, expr, *stage))
    a = pjoin(expr, "CoraNet", "000")
    for tag in ("pre_best", "pre_last"):
        raw = checkpoints.load_raw(pjoin(a, "ckpt"), tag)
        assert "ema_params" in raw
        assert raw["params"]["decoder.fc.weight"].shape[-1] == 13
    assert checkpoints.load_raw(pjoin(a, "ckpt"), "pre_last")["step"] == 6
    main("-p", "train", "-i", "000", *_args(data_root, expr, *stage))
    b = pjoin(expr, "CoraNet", "001")
    log = open(pjoin(b, "train.log")).read()
    assert "Load pre_best params+EMA" in log
    # pred_step 1: the pseudo-labels are made at both epochs
    assert log.count("Pseudo label dice") == 2
    assert sorted(scalars["001"]["acc/plab_dice"]) == [0, 1]
    assert all(0 <= v <= 1 for v in scalars["001"]["acc/plab_dice"].values())
    raw = checkpoints.load_raw(pjoin(b, "ckpt"), "last")
    assert raw["step"] == 6
    main("-p", "test", "-i", "001", "-wh", "best",
         *_args(data_root, expr, *stage))
    _check_test(b)
    main("-p", "pseudo", "-i", "001", "-wh", "best",
         *_args(data_root, expr, *stage))
    _check_pseudo(b)
    # stage A resumed from its pre_last
    main("-p", "train", "--resume", "000", *_args(
        data_root, expr, "--set", "pre_epoch=3", *stage[2:]))
    raw = checkpoints.load_raw(pjoin(expr, "CoraNet", "002", "ckpt"),
                               "pre_last")
    assert raw["step"] == 9
    # stage B cut after its first epoch (003), then resumed (004): the
    # uninterrupted run 001's losses and pseudo-label Dice in each epoch
    with monkeypatch.context() as m:
        m.setattr(CoraNet, "max_epoch", 1)
        main("-p", "train", "-i", "000", *_args(data_root, expr, *stage))
    main("-p", "train", "-i", "000", "--resume", "003",
         *_args(data_root, expr, *stage))
    assert "Resuming at epoch 1 (step 3)" in open(
        pjoin(expr, "CoraNet", "004", "train.log")).read()
    for tag in ("train/loss", "acc/plab_dice"):
        w, c, r = (scalars[k][tag] for k in ("001", "003", "004"))
        assert sorted(c) == [0] and sorted(r) == [1], tag
        np.testing.assert_allclose([c[0], r[1]], [w[0], w[1]], rtol=1e-6,
                                   err_msg=tag)


def test_gan_resume_fresh_runs_and_pseudo(data_root, tmp_path, scalars):
    expr = str(tmp_path / "expr")
    _run(UGANConsisAlgo, "-p", "train", *_args(data_root, expr))
    _run(UGANConsisAlgo, "-p", "train", *_args(data_root, expr))
    a, b = scalars["000"], scalars["001"]
    assert a["train/loss"] == b["train/loss"] and sorted(a["train/loss"]) \
        == [0, 1]
    _resume_equal(UGANConsisAlgo, data_root, expr, scalars, "000",
                  "UGANConsisAlgo", "002")
    _run(UGANConsisAlgo, "-p", "pseudo", "-i", "000", "-wh", "best",
         *_args(data_root, expr))
    _check_pseudo(pjoin(expr, "UGANConsisAlgo", "000"), gan=True)


def test_two_fresh_mean_teacher_runs_agree(data_root, tmp_path, scalars):
    expr = str(tmp_path / "expr")
    for _ in range(2):
        _run(MeanTeacher, "-p", "train", *_args(data_root, expr))
    a, b = scalars["000"], scalars["001"]
    for tag in ("train/loss", "test/dice"):
        assert a[tag] == b[tag] and sorted(a[tag]) == [0, 1], tag
