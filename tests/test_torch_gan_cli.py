# -*- coding: utf-8 -*-
"""The ``uganConsis`` trainer CLI on the CPU (``--device cpu``, a tiny
synthetic tree): ``-p train`` writes train.log, best and last
checkpoints of the whole GAN state and the per-epoch translation grids
``sample/train-{e}-images.png``; ``-p test -i 000 -wh best`` through
``python -m smsut_tpu_torch.trainer.uganConsisTrainer`` writes the trois
CSV; a run cut after its first epoch resumes with ``--resume 001:last``
at its second, the uninterrupted run's (the checkpoint holds the step,
both parameter trees, the SGD traces and Adam's moments and count,
restored exactly).  And the GAN
algorithms raise without a device on a host with no CUDA."""
import os
import subprocess
import sys
from os.path import join as pjoin

import numpy as np
import pytest
import torch

from smsut_tpu_torch.config import Config
from smsut_tpu_torch.data.synthetic import make_synthetic_dataset
from smsut_tpu_torch.train import checkpoints, experiment
from smsut_tpu_torch.train.cli import make_parser, run_main
from smsut_tpu_torch.train.steps.gan import (UGANConsisAlgo, UGANShp0Algo,
                                             UGANTrainerAlgo)
from smsut_tpu_torch.utils.io import imread_gray

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUG = ("data_aug={'rotate':True,'rotate_degrees':15,'resizeCrop':True,"
       "'resizeCrop_size':32,'elasticDeform':True,"
       "'elasticDeform_sigmas':(9.0,13.0),'elasticDeform_points':3,"
       "'colorJitter':False,'gammaCorrect':False,"
       "'gammaCorrect_gammas':(0.7,1.5)}")
BS = 2


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The suite runs several workers at once; with torch's default of one
    thread per core each, a CPU training run oversubscribes the host (see
    tests/test_torch_train.py).  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


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
             "--set", "nce_patches=4", "--set", "num_iter_per_epoch=3",
             "--set", "max_epoch=2", "--set", "num_workers=2",
             "--set", "compute_dtype=float32", "--set", AUG]
            + list(extra))


class _OneEpoch(UGANConsisAlgo):
    """A run cut after its first epoch (the config, and so the schedules,
    are the full run's)."""
    max_epoch = 1


def test_cli_train_test_and_resume(data_root, tmp_path, scalars):
    expr = str(tmp_path / "expr")
    run_main(UGANConsisAlgo, make_parser().parse_args(
        ["-p", "train"] + _args(data_root, expr)))
    model = pjoin(expr, "UGANConsisAlgo", "000")
    log = open(pjoin(model, "train.log")).read()
    assert log.count("[TRN]") == 2 and log.count("[TST]") == 2
    assert "[G] Number of parameters" in log and "[D] Number" in log
    for tag in ("best", "last"):
        assert os.path.isfile(pjoin(model, "ckpt", f"{tag}.ckpt"))
    raw = checkpoints.load_raw(pjoin(model, "ckpt"), "last")
    assert raw["step"] == 6 and raw["d_opt_count"] == 6
    for e in (1, 2):
        grid = imread_gray(pjoin(model, "sample", f"train-{e}-images.png"))
        # the fixed batch (labelled + unlabelled) by rows; the image and
        # its translation to each of the 4 modalities by columns
        assert grid.shape == (2 * BS * 32, 5 * 32) and grid.std() > 0

    out = subprocess.run(
        [sys.executable, "-m", "smsut_tpu_torch.trainer.uganConsisTrainer",
         "-p", "test", "-i", "000", "-wh", "best"] + _args(data_root, expr),
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, SMSUT_NO_TB="1", OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    rows = [r for r in open(pjoin(model, "all_trois_matrix.csv")).read()
            .strip().split("\n") if r]
    assert len(rows) == 2 * 5
    assert all(np.isfinite([float(v) for v in r.split(",")]).all()
               for r in rows)

    run_main(_OneEpoch, make_parser().parse_args(
        ["-p", "train", "-nm", "UGANConsisAlgo"] + _args(data_root, expr)))
    run_main(UGANConsisAlgo, make_parser().parse_args(
        ["-p", "train", "--resume", "001:last"] + _args(data_root, expr)))
    whole, cut, resumed = scalars["000"], scalars["001"], scalars["002"]
    assert sorted(cut["train/loss"]) == [0]
    assert cut["train/loss"][0] == whole["train/loss"][0]
    # each loader draws from its own generator, so the resumed second
    # epoch takes the uninterrupted run's batches
    assert sorted(resumed["train/loss"]) == [1]
    np.testing.assert_allclose(resumed["train/loss"][1],
                               whole["train/loss"][1], rtol=1e-6)
    assert "Resuming at epoch 1 (step 3)" in open(
        pjoin(expr, "UGANConsisAlgo", "002", "train.log")).read()


def test_gan_state_checkpoint_round_trip(tmp_path):
    """save_state / load_state of a GANTrainState after a step: the step,
    both parameter trees, the SGD traces, Adam's moments and count, all
    exact; a state of the other kind does not load."""
    cfg = Config(input_size=32, base_width=8, batch_size=BS, nce_patches=4,
                 compute_dtype="float32")
    algo = UGANConsisAlgo(cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"img": rng.normal(size=(BS, 32, 32, 1)).astype(np.float32),
             "msk": rng.integers(0, 5, (BS, 32, 32)), "mdl": np.ones(BS, int),
             "ul_img": rng.normal(size=(BS, 32, 32, 1)).astype(np.float32),
             "ul_mdl": np.full(BS, 2)}
    state, _ = algo.train_step(algo.init_state(0),
                               dict(batch, **algo.make_extra_batch()),
                               algo.epoch_scalars(0))
    checkpoints.save_state(state, str(tmp_path), "last")
    got = checkpoints.load_state(algo.init_state(1), str(tmp_path), "last")
    assert got.step == state.step == 1 and got.d_opt_state.count == 1
    for a, b in ((got.g_params, state.g_params),
                 (got.g_opt_state, state.g_opt_state),
                 (got.d_params, state.d_params),
                 (got.d_opt_state.mu, state.d_opt_state.mu),
                 (got.d_opt_state.nu, state.d_opt_state.nu)):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(state.d_opt_state.nu["stem.weight"].abs().max()) > 0
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet
    with pytest.raises(KeyError):
        checkpoints.load_state(SupervisedUNet(cfg, "cpu").init_state(0),
                               str(tmp_path), "last")


@pytest.mark.parametrize("cls", [UGANConsisAlgo, UGANTrainerAlgo,
                                 UGANShp0Algo])
def test_gan_algorithms_need_a_device_or_cuda(cls):
    if torch.cuda.is_available():
        pytest.skip("a host with CUDA runs the algorithm on the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(Config(input_size=32, base_width=8))
