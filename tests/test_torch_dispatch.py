# -*- coding: utf-8 -*-
"""The fit loop's dispatch (``steps_per_dispatch``, ``eval_scan``) and the
static step forms it replays, on the CPU, against the port itself and the
JAX package:

- the port's Trainer at T = 3 against T = 1 (7 iterations: two chunks and
  a remainder), and against the JAX Trainer at T = 3, on the batches and
  augmentation parameters the JAX run drew (recorded, so that the loaders'
  threads play no part) and its initial weights;
- the device LR table and Adam's bias corrections against the host values
  the optimizers took before, bit for bit in float32;
- the GAN's static step across ``consis_gate_step`` and across an epoch
  change of ``lambda_semi``, fed the JAX draws, against the JAX
  ``UGANConsisAlgo`` step, both in float64 (tests/test_torch_gan.py's
  ``jax_float64``), where the two are held to 1e-6;
- the ``eval_scan`` sweep against the per-batch sweep, and against the JAX
  ``_validate_epoch_scan`` on the same weights.

On the CPU the Trainer calls its step directly (train/graphs.py
``Replay``), so these runs check the static forms and the staging; the
card tests (tests/test_torch_cuda.py) hold the replays against eager.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.config import Config as JConfig
from smsut_tpu.train.state import GANTrainState as JGANTrainState
from smsut_tpu.train.steps.gan import UGANConsisAlgo as JConsis
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.data.dataset import Batch
from smsut_tpu_torch.models.transplant import (disc_from_flax, disc_to_flax,
                                               from_flax, to_flax,
                                               ugan_from_flax, ugan_to_flax)
from smsut_tpu_torch.ops.schedules import poly_lr_host, poly_lr_table
from smsut_tpu_torch.train import experiment as port_experiment
from smsut_tpu_torch.train import loop as port_loop
from smsut_tpu_torch.train.graphs import Replay
from smsut_tpu_torch.train.state import ADAM_ROWS, make_adam, make_sgd
from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
from smsut_tpu_torch.train.steps.supervised import SupervisedUNet
from test_torch_gan import _flat, gan_batches, host, jax_draws, jax_float64

SIZE, WIDTH, BATCH, ITERS, T = 32, 4, 2, 7, 3
AUG = dict(Config().data_aug, resizeCrop_size=SIZE)
MODS = ("ct", "t1in", "t1out", "t2")


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """XLA's thread pool shares the host; see tests/test_torch_train.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setenv("SMSUT_NO_TB", "1")


class _Recording:
    """The JAX loader's items as its Trainer consumes them: (uint8 image,
    mask, modality, packed augmentation parameters)."""

    def __init__(self, loader, log):
        self._loader, self._log = loader, log

    def __setattr__(self, name, value):
        # the Trainer's producer hook goes to the loader it wraps
        if name == "post":
            self._loader.post = value
        else:
            super().__setattr__(name, value)

    def iter_cycle(self):
        for b, params in self._loader.iter_cycle():
            self._log.append((b.img.copy(), b.msk.copy(), b.mdl.copy(),
                              np.asarray(params).copy()))
            yield b, params

    def __getattr__(self, name):
        return getattr(self._loader, name)


class _Replay:
    """A loader that hands the port's Trainer a recorded stream, with its
    augmentation parameters."""

    def __init__(self, loader, stream):
        self.dataset, self.post, self._stream = loader.dataset, None, stream

    def iter_cycle(self):
        for img, msk, mdl, params in self._stream:
            yield Batch(img, msk, mdl, []), torch.from_numpy(params)
        raise AssertionError("the replay ran past the recorded stream")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from smsut_tpu.data.synthetic import make_synthetic_dataset

    root = str(tmp_path_factory.mktemp("dispatch_data"))
    make_synthetic_dataset(root, n_patients_per_modality=3, n_slice=4,
                           size=SIZE)
    return root


@pytest.fixture(scope="module")
def jax_run(data_root, tmp_path_factory):
    """The JAX Trainer at T = 3 with device augmentation (strict parity:
    float32, unpacked, f32 statistics), one epoch of 7 iterations: its
    Trainer, initial and final weights, recorded stream and scalars."""
    from smsut_tpu.train import loop as jloop
    from smsut_tpu.train.steps.supervised import SupervisedUNet as JAlgo

    cfg = JConfig(base_root=data_root,
                  expr_root=str(tmp_path_factory.mktemp("jax_expr")),
                  input_size=SIZE, base_width=WIDTH, batch_size=BATCH,
                  num_iter_per_epoch=ITERS, max_epoch=1, num_workers=1,
                  compute_dtype="float32", steps_per_dispatch=T,
                  device_augment=True, data_aug=AUG, pack_levels=0,
                  norm_stats="reduce")
    stream, scalars = [], {}
    real = jloop.get_loader

    def recording(root, phase, fold, bs, *a, **kw):
        loader = real(root, phase, fold, bs, *a, **kw)
        return _Recording(loader, stream) if phase == "train" else loader

    trainer = jloop.Trainer(JAlgo(cfg), cfg, "train")
    init = jax.tree_util.tree_map(np.asarray, trainer.state.params)
    trainer.exp.scalar = lambda tag, v, e: scalars.setdefault(
        tag, {}).__setitem__(e, float(v))
    jloop.get_loader = recording
    try:
        trainer.fit("inTurn")
    finally:
        jloop.get_loader = real
    final = jax.tree_util.tree_map(np.asarray, trainer.state.params)
    return trainer, init, final, stream[:ITERS], scalars


def _port_fit(data_root, tmp_path, monkeypatch, init, stream, spd):
    """The port's Trainer from ``init`` on the recorded ``stream``: its
    Trainer and the scalars it logged."""
    seen = {}
    monkeypatch.setattr(port_experiment.Experiment, "scalar",
                        lambda self, tag, v, e: seen.setdefault(
                            tag, {}).__setitem__(e, float(v)))
    cfg = Config(base_root=data_root, expr_root=str(tmp_path),
                 input_size=SIZE, base_width=WIDTH, batch_size=BATCH,
                 num_iter_per_epoch=ITERS, max_epoch=1, num_workers=1,
                 compute_dtype="float32", steps_per_dispatch=spd,
                 data_aug=AUG)
    algo = SupervisedUNet(cfg, device="cpu")
    trainer = port_loop.Trainer(algo, cfg, "train")
    assert trainer._chunk_T == spd
    trainer.state = algo.state_from_params(from_flax(init))
    real = port_loop.get_loader

    def replaying(root, phase, fold, bs, *a, **kw):
        loader = real(root, phase, fold, bs, *a, **kw)
        if phase == "test":
            return loader
        return _Replay(loader, stream if phase == "train" else [])

    monkeypatch.setattr(port_loop, "get_loader", replaying)
    trainer.fit("inTurn")
    monkeypatch.setattr(port_loop, "get_loader", real)
    trainer.exp.close()
    return trainer, seen


@pytest.fixture(scope="module")
def port_runs(jax_run, data_root, tmp_path_factory):
    _, init, _, stream, _ = jax_run
    mp = pytest.MonkeyPatch()
    try:
        return {spd: _port_fit(data_root, tmp_path_factory.mktemp(f"p{spd}"),
                               mp, init, stream, spd) for spd in (1, T)}
    finally:
        mp.undo()


def test_chunked_equals_per_iteration(port_runs):
    """T = 3 (two chunks of 3, then a remainder of 1) against T = 1 on one
    stream: the same iterations, so the same parameters and every logged
    value, to the bit."""
    (t1, s1), (t3, s3) = port_runs[1], port_runs[T]
    assert t1.state.step == t3.state.step == ITERS
    assert int(t3.state.count) == ITERS
    for k, v in t1.state.params.items():
        assert torch.equal(v, t3.state.params[k]), k
    assert s1 == s3
    assert sorted(s3["train/loss"]) == [0]


def test_chunked_matches_the_jax_trainer(jax_run, port_runs):
    """The port at T = 3 against the JAX Trainer at T = 3 on its own
    stream and weights: the [TRN] losses with tests/test_torch_fit.py's
    bounds (rtol 2e-3, atol 2e-4; measured 9.4e-7), and the parameters
    after the 7 SGD steps within 1e-5 of max(1, max |leaf|) (measured
    2.3e-6)."""
    _, _, final, _, want = jax_run
    trainer, got = port_runs[T]
    for tag in ["train/loss"] + [f"train/loss_{m}" for m in MODS]:
        np.testing.assert_allclose(got[tag][0], want[tag][0], rtol=2e-3,
                                   atol=2e-4, err_msg=tag)
    mine = dict(_flat(to_flax(trainer.state.params)))
    theirs = dict(_flat(final))
    assert mine.keys() == theirs.keys()
    for k, w in theirs.items():
        assert np.abs(mine[k] - w).max() <= 1e-5 * max(
            1.0, np.abs(w).max()), k


def test_eval_scan_matches_per_batch_and_jax(jax_run, port_runs, data_root):
    """The port's scanned sweep against its per-batch sweep on the trained
    weights (predictions equal, losses within 1e-6), and against the JAX
    ``_validate_epoch_scan`` on the same weights (all but 1e-4 of the
    voxels equal, losses within 1e-5)."""
    from smsut_tpu.data.dataset import get_loader as j_get_loader
    from smsut_tpu.utils.meter import Meter as JMeter
    from smsut_tpu_torch.data.dataset import get_label_npys, get_loader
    from smsut_tpu_torch.utils.meter import Meter

    jtrainer = jax_run[0]
    trainer, _ = port_runs[T]
    _, gt = get_label_npys(data_root, "test")
    keys = [f"loss_{i}" for i in range(4)] + ["loss"]
    loader = get_loader(data_root, "test", 0, BATCH, cfg=trainer.cfg)
    out = {}
    for scan in (True, False):
        trainer.cfg = trainer.cfg.replace(eval_scan=scan)
        meter = Meter(keys, [], alpha=1.0)
        n, vols = trainer.validate_epoch(loader, gt, meter)
        meter.update_cur()
        out[scan] = (n, vols, dict(meter.cur_values))
    (n1, v1, m1), (n0, v0, m0) = out[True], out[False]
    assert n1 == n0 == sum(v.shape[0] for v in gt.values())
    for k in gt:
        assert np.array_equal(v1[k], v0[k]), k
    for k in keys:
        np.testing.assert_allclose(m1[k], m0[k], rtol=1e-6, err_msg=k)

    jtrainer.state = jtrainer.state.replace(params=jax.tree_util.tree_map(
        jnp.asarray, to_flax(trainer.state.params)))
    jmeter = JMeter(keys, [], alpha=1.0)
    jn, jvols = jtrainer._validate_epoch_scan(
        j_get_loader(data_root, "test", 0, BATCH, cfg=jtrainer.cfg), gt,
        jmeter)
    jmeter.update_cur()
    assert jn == n1
    off = sum(int((jvols[k] != v1[k]).sum()) for k in gt)
    assert off <= 1e-4 * sum(v.size for v in gt.values()), off
    for k in keys:
        np.testing.assert_allclose(m1[k], jmeter.cur_values[k], rtol=1e-5,
                                   err_msg=k)


def test_device_lr_and_bias_corrections_are_the_host_values():
    """Every count's LR from the device table against ``poly_lr_host``,
    past the schedule's end too, and Adam's device bias corrections
    against ``1 - b^k`` as the host computed them, bit for bit in
    float32."""
    cfg = Config(num_iter_per_epoch=5, max_epoch=3, lr=1e-2)
    sgd, adam = make_sgd(cfg), make_adam(cfg)
    assert np.array_equal(poly_lr_table(cfg.lr, cfg.total_iters),
                          [poly_lr_host(cfg.lr, k, cfg.total_iters)
                           for k in range(cfg.total_iters + 2)])
    for k in range(cfg.total_iters + 5):
        c = torch.tensor(k)
        want = np.float32(poly_lr_host(cfg.lr, k, cfg.total_iters))
        for tables in (sgd.tables, adam.tables):
            got = tables.at("lr", c, torch.float32)
            assert got.dtype == torch.float32 and got.numpy() == want, k
    for k in list(range(1, 40)) + [ADAM_ROWS - 1, ADAM_ROWS, 10 ** 6]:
        c = torch.tensor(k)
        for name, b in (("c1", adam.b1), ("c2", adam.b2)):
            got = adam.tables.at(name, c, torch.float32).numpy()
            assert got == np.float32(1.0 - b ** k), (name, k)


# the GAN: gate at step 1, epochs 0, 0, 1, 1 (lambda_semi changes at step 2)
GAN_CFG = dict(input_size=SIZE, base_width=8, batch_size=BATCH,
               nce_patches=4, compute_dtype="float32", num_iter_per_epoch=2,
               max_epoch=2, consis_gate_step=1)
GAN_EPOCHS = (0, 0, 1, 1)
GAN_NAMES = ("D_real", "D_fake", "D_cls", "D_gp", "G_fake", "G_rec",
             "G_cls", "G_seg", "G_semi", "G_nce")


def test_static_gan_step_across_gate_and_epochs():
    """``UGANConsisAlgo.step`` as the fit loop drives it (through
    ``Replay``, device epoch scalars set per epoch, the host step advanced
    by the caller) against the JAX step, both in float64, from one init and
    the JAX draws: 4 steps, the gate opening at step 1 and ``lambda_semi``
    changing at step 2 (epoch 1), the losses at every step within rtol
    1e-6 (tests/test_torch_gan.py ``check_float64``) and the final G and D
    within 1e-6 of max(1, max |leaf|) (Adam's early sign steps amplify
    float64 rounding: 2.4e-7 at most, measured).  A gate or a weight
    frozen at its first value would move G_semi at step 1 and the losses
    of step 3 and the trees far outside these bounds."""
    jalgo = JConsis(JConfig(**GAN_CFG, pack_levels=0, norm_stats="reduce",
                            device_augment=False, pair_towers=False))
    algo = UGANConsisAlgo(Config(**GAN_CFG), device="cpu")
    init = algo.init_state(0)
    g0, d0 = ugan_to_flax(init.g_params), disc_to_flax(init.d_params)
    batches = gan_batches(5, len(GAN_EPOCHS), True)
    draws = [jax_draws(jax.random.PRNGKey(100 + k), jalgo.total_batch,
                       jalgo.bottleneck_hw, GAN_CFG["nce_patches"])
             for k in range(len(GAN_EPOCHS))]
    with jax_float64():
        j64 = JConsis(jalgo.cfg)
        wide = lambda tree: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree)
        js = JGANTrainState.create(wide(g0), wide(d0), j64.cfg, j64.beta1,
                                   j64.beta2)
        want = []
        for k, (b, e) in enumerate(zip(batches, GAN_EPOCHS)):
            b64 = {k2: jnp.asarray(v, jnp.float64 if v.dtype == np.float32
                                   else v.dtype) for k2, v in b.items()}
            js, m = j64.train_step(js, b64, dict(
                j64.epoch_scalars(e), rng=jax.random.PRNGKey(100 + k)))
            want.append({k2: float(v) for k2, v in m.items()})
        want_g, want_d = host((js.g_params, js.d_params))

    f64 = torch.float64
    algo.net.double().compute_dtype = f64
    algo.D.double().compute_dtype = f64
    st = algo.state_from_params(ugan_from_flax(g0), disc_from_flax(d0))
    for tree in (st.g_params, st.g_opt_state, st.d_params,
                 st.d_opt_state.mu, st.d_opt_state.nu):
        tree.update({k: v.double() for k, v in tree.items()})
    scalars = {"lambda_semi": torch.zeros((), dtype=torch.float32)}
    step = Replay(lambda inp: algo.step(st, inp, scalars), algo.device)
    got = []
    for b, dr, e in zip(batches, draws, GAN_EPOCHS):
        scalars["lambda_semi"].fill_(float(
            algo.epoch_scalars(e)["lambda_semi"]))
        inp = {k: v for k, v in algo.inputs(dict(b, **dr)).items()}
        got.append({k: float(v) for k, v in step(inp).items()})
        st.step += 1
    assert st.step == int(st.count) == int(st.d_opt_state.count) == 4
    assert got[0]["G_semi"] == 0.0 and got[1]["G_semi"] > 0.0
    assert algo.epoch_scalars(0) != algo.epoch_scalars(1)
    for k, (w, g) in enumerate(zip(want, got)):
        for name in GAN_NAMES:
            np.testing.assert_allclose(g[name], w[name], rtol=1e-6,
                                       atol=1e-8, err_msg=f"{name} at {k}")
    for w_tree, g_tree in ((want_g, ugan_to_flax(st.g_params)),
                           (want_d, disc_to_flax(st.d_params))):
        wt, gt = dict(_flat(w_tree)), dict(_flat(g_tree))
        assert wt.keys() == gt.keys()
        for key, w in wt.items():
            assert (np.abs(gt[key] - w).max()
                    <= 1e-6 * max(1.0, np.abs(w).max())), key
