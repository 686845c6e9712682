# -*- coding: utf-8 -*-
"""M3L in the port (smsut_tpu_torch/train/steps/m3l.py) against the JAX
package's M3L step on the CPU: three steps from the same transplanted
weights, batches and mask grids (the JAX step's draw from its key, fed to
the port as the step's ``mask`` input), from counts 0 and 99, so that the
EMA's alpha leaves 0 inside the second run.

In float32 the step-0 losses agree within rtol 1e-5; after that Adam's
first update, about lr * sign(g), moves a parameter whose float32 gradient
differs in sign between the two packages by 2 lr, so the trees after step
0 are held flip-aware (every element within 2.1 lr, under 1% beyond lr).
Both packages also run the same steps in float64 (the JAX step under
:func:`jax_float64`, which reads the step modules' ``jnp.float32`` as
float64 and edits nothing), where that chaos is gone: the losses agree
within rtol 1e-6 at every step, and every leaf of the student and the
teacher within 1e-9 of max(1, max |leaf|) after step 0 (as
tests/test_torch_gan.py's ``check_float64``).  Not after later steps: the
gradients of the biases whose constant the head's batch norm removes
(``linear_c1..4/bias``, ``backbone/norm4/bias``) are 0 in exact
arithmetic, and Adam, from zero moments, turns their float64 rounding
noise into steps of up to 3e-6 (measured) that differ between the
packages.

Also: ``soft_cross_entropy``, ``eval_fn`` and the port's own mask draw."""
import contextlib
import importlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smsut_tpu.config import Config as JConfig
from smsut_tpu.train.state import TrainState as JTrainState
from smsut_tpu.train.state import make_adam as j_make_adam
from smsut_tpu.train.steps.m3l import M3L as JM3L
from smsut_tpu.train.steps.m3l import soft_cross_entropy as j_soft_ce
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.models.transplant import state_trees_from_flax, to_flax
from smsut_tpu_torch.ops.losses import soft_cross_entropy
from smsut_tpu_torch.train.state import AdamState, TrainState
from smsut_tpu_torch.train.steps.m3l import M3L, mask_grid
from torch_port_helpers import STRICT, at_count, flat, few_torch_threads

SIZE, BS, STEPS = 32, 2, 3
STARTS = (0, 99)
_CFG = dict(input_size=SIZE, batch_size=BS, num_iter_per_epoch=10,
            max_epoch=20)
EPOCH = 7   # lambda_semi's rampup inside (0, 1)
NAMES = ("loss", "semi_loss", "alpha")
# the modules of the JAX M3L step that name jnp.float32
_JNP_USERS = ("smsut_tpu.models.segformer", "smsut_tpu.ops.losses",
              "smsut_tpu.ops.schedules", "smsut_tpu.train.steps",
              "smsut_tpu.train.steps.m3l")

pytestmark = pytest.mark.usefixtures("few_torch_threads")


class _Alias(types.ModuleType):
    """The module ``base`` with some of its attributes replaced."""

    def __init__(self, base, **replace):
        super().__init__(base.__name__)
        self._base = base
        self.__dict__.update(replace)

    def __getattr__(self, name):
        return getattr(self._base, name)


@contextlib.contextmanager
def jax_float64():
    """x64 on, and every ``jnp.float32`` that the step's modules name read
    as float64, for the context's length (the modules' ``jnp`` names are
    swapped; the package is not edited)."""
    saved = []
    jnp64 = _Alias(jnp, float32=jnp.float64)
    for name in _JNP_USERS:
        mod = importlib.import_module(name)
        saved.append((mod, mod.jnp))
        mod.jnp = jnp64
    try:
        with jax.enable_x64(True):
            yield
    finally:
        for mod, value in saved:
            mod.jnp = value


def _grid(key):
    """The JAX model's mask grid for the step's 2B images (its
    ``mask_rng`` use), on the host."""
    shape = (2 * BS, SIZE // 16, SIZE // 16)
    return np.asarray(jax.random.bernoulli(key, 0.5, shape), np.float32)


def _batches():
    rng = np.random.default_rng(5)
    return [{"img": rng.normal(size=(BS, SIZE, SIZE, 1)).astype(np.float32),
             "msk": rng.integers(0, 5, size=(BS, SIZE, SIZE)).astype(np.int32),
             "ul_img": rng.normal(size=(BS, SIZE, SIZE, 1)).astype(np.float32)}
            for _ in range(STEPS)]


def host(tree):
    """Numpy copies (the step donates its state)."""
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _run_jax(jalgo, state, batches):
    """The JAX steps from ``state``: per step the mask grid drawn, the
    metrics and the (params, ema_params) trees after it."""
    grids, metrics, trees = [], [], []
    for k, b in enumerate(batches):
        key = jax.random.PRNGKey(40 + k)
        grids.append(_grid(key))
        scalars = dict(jalgo.epoch_scalars(EPOCH), rng=key)
        state, m = jalgo.train_step(state, {k2: jnp.asarray(v)
                                            for k2, v in b.items()}, scalars)
        metrics.append({k2: float(v) for k2, v in m.items()})
        trees.append(host((state.params, state.ema_params)))
    return grids, metrics, trees


@pytest.fixture(scope="module")
def reference(few_torch_threads):
    """The JAX runs from PRNGKey(0)'s init at each start count, in float32
    and in float64: (init, batches, {start: (grids, metrics, trees)} per
    dtype)."""
    cfg = JConfig(**_CFG, **STRICT)
    jalgo = JM3L(cfg)
    init = host(jax.jit(jalgo.init_state)(jax.random.PRNGKey(0)))
    batches = _batches()
    f32 = {s: _run_jax(jalgo, at_count(jax.tree_util.tree_map(
        jnp.asarray, init), s), batches) for s in STARTS}
    f64 = {}
    with jax_float64():
        jalgo64 = JM3L(cfg)
        wide = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), t)
        for s in STARTS:
            state = JTrainState.create(wide(init.params), j_make_adam(cfg),
                                       ema_params=wide(init.ema_params))
            b64 = [{k: (v.astype(np.float64) if v.dtype == np.float32
                        else v) for k, v in b.items()} for b in batches]
            f64[s] = _run_jax(jalgo64, at_count(state, s), b64)
    return init, batches, f32, f64


def _port_run(init, batches, grids, start, f64):
    algo = M3L(Config(**_CFG, compute_dtype="float32"), device="cpu")
    state = algo.state_from_params(**state_trees_from_flax(init))
    if f64:
        algo.net.double().compute_dtype = torch.float64
        for tree in (state.params, state.ema_params, state.opt_state.mu,
                     state.opt_state.nu):
            tree.update({k: v.double() for k, v in tree.items()})
    state.step = start
    state.count.fill_(start)
    state.opt_state.count.fill_(start)
    metrics, trees = [], []
    for b, g in zip(batches, grids):
        state, m = algo.train_step(state, dict(b, mask=g),
                                   algo.epoch_scalars(EPOCH))
        metrics.append({k: float(v) for k, v in m.items()})
        trees.append((to_flax(state.params), to_flax(state.ema_params)))
    return state, metrics, trees


@pytest.mark.parametrize("start", STARTS)
def test_steps_match_jax(reference, start):
    init, batches, f32, f64 = reference
    grids, want, wtrees = f32[start]
    state, got, gtrees = _port_run(init, batches, grids, start, False)
    assert isinstance(state, TrainState)
    assert isinstance(state.opt_state, AdamState)
    assert state.step == start + STEPS and int(state.count) == start + STEPS
    assert int(state.opt_state.count) == start + STEPS
    for name in ("loss", "semi_loss"):
        np.testing.assert_allclose(got[0][name], want[0][name], rtol=1e-5,
                                   err_msg=name)
    for k in range(STEPS):
        assert np.isfinite([got[k][n] for n in NAMES]).all()
        np.testing.assert_allclose(got[k]["alpha"], want[k]["alpha"],
                                   rtol=1e-6)
    lr = Config().lr
    for what, w, g in zip(("params", "ema_params"), wtrees[0], gtrees[0]):
        w, g = dict(flat(w)), dict(flat(g))
        assert w.keys() == g.keys(), what
        dev = np.concatenate([np.abs(g[k] - w[k]).ravel() for k in w])
        assert dev.max() <= 2.1 * lr, (what, dev.max())
        assert np.mean(dev > lr) < 0.01, (what, np.mean(dev > lr))
    # float64: the chaos of Adam's sign step is gone
    grids64, want64, wtrees64 = f64[start]
    _, got64, gtrees64 = _port_run(init, batches, grids64, start, True)
    for k, (w, g) in enumerate(zip(want64, got64)):
        for name in NAMES:
            np.testing.assert_allclose(g[name], w[name], rtol=1e-6,
                                       atol=1e-12,
                                       err_msg=f"float64 {name} step {k}")
    for wt, gt in zip(wtrees64[0], gtrees64[0]):
        wt, gt = dict(flat(wt)), dict(flat(gt))
        assert wt.keys() == gt.keys()
        for key, a in wt.items():
            assert gt[key].dtype == a.dtype == np.float64, key
            assert (np.abs(gt[key] - a).max()
                    <= 1e-9 * max(1.0, np.abs(a).max())), key
    alphas = [w["alpha"] for w in want]
    if start == 99:   # the EMA copies the student up to count 100
        assert alphas[0] == 0.0 and alphas[1] == pytest.approx(0.99)
    else:
        assert alphas == [0.0] * STEPS


def test_soft_cross_entropy_matches_jax(rng):
    logits = rng.normal(size=(2, 8, 8, 5)).astype(np.float32)
    probs = rng.random(size=(2, 8, 8, 5)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    want = float(j_soft_ce(jnp.asarray(logits), jnp.asarray(probs)))
    got = float(soft_cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(probs)))
    assert got == pytest.approx(want, rel=1e-6)


def test_eval_fn_matches_jax(reference, rng):
    init = reference[0]
    jalgo = JM3L(JConfig(**_CFG, **STRICT))
    algo = M3L(Config(**_CFG, compute_dtype="float32"), device="cpu")
    params = algo.eval_params(state_trees_from_flax(init)["params"])
    img = rng.normal(size=(BS, SIZE, SIZE, 1)).astype(np.float32)
    want = np.asarray(jax.jit(jalgo.eval_fn)(init.params, jnp.asarray(img)))
    got = algo.eval_fn(params, img)
    assert got.shape == want.shape == (BS, SIZE, SIZE, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_port_mask_is_a_function_of_the_count():
    """The step's own draw: Bernoulli(0.5) cells, the same for a count on
    every call, another for the next count or seed."""
    shape = (16, 16, 16)
    a = mask_grid(torch.tensor(7), shape, 2020)
    assert a.shape == shape and a.dtype == torch.float32
    assert set(a.unique().tolist()) == {0.0, 1.0}
    assert torch.equal(a, mask_grid(torch.tensor(7), shape, 2020))
    assert not torch.equal(a, mask_grid(torch.tensor(8), shape, 2020))
    assert not torch.equal(a, mask_grid(torch.tensor(7), shape, 1))
    assert float(a.mean()) == pytest.approx(0.5, abs=0.05)
