# -*- coding: utf-8 -*-
"""Rematerialisation in the port (``Config.remat_unet``, ``Config.remat``),
on the CPU.

``remat_unet`` checkpoints the supervised U-Net's encoder and decoder
(``models/unet.py`` ``rematerialised``), as the JAX package's
``nn.remat(Encoder)`` / ``nn.remat(Decoder)``; ``remat`` the UGAN family's
generator forward (``train/steps/gan.py`` ``_g_forward``), as its
``jax.checkpoint(fwd)``.  Both change the schedule and nothing else:

- against the JAX package with the same knob, one step: the U-Net under
  strict parity (loss rtol 1e-4, parameters rtol 1e-4 / atol 1e-5), the
  ``uganConsis`` step fed the JAX step's draws (metrics rtol 2e-3 / atol
  5e-5);
- against the port with the knob off, bit for bit in float32, with the
  wrapped towers run twice a step (a forward hook counts their calls);
- only under grad: the eval forward runs each tower once, equal to the
  bit;
- the zoo's U-Nets (Mean Teacher, CPS) are built without it, as the JAX
  package builds them.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_spatial_worker as sw  # noqa: E402
from test_torch_spatial import JAX_STRICT, _close_trees, \
    _gan_inputs  # noqa: E402
from test_torch_spatial_block import jax_unet_step  # noqa: E402

from smsut_tpu_torch.models.transplant import (disc_to_flax,  # noqa: E402
                                               to_flax, ugan_to_flax)
from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo  # noqa: E402
from smsut_tpu_torch.train.steps.supervised import \
    SupervisedUNet  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gan_inputs(tmp_path_factory):
    """tests/test_torch_spatial.py's GAN batch (4 + 4 at 64^2) and the JAX
    step's draws for PRNGKey(100)."""
    return _gan_inputs(str(tmp_path_factory.mktemp("remat") / "gan.npz"))


def _calls(net, names):
    """A count of the forward calls of ``net``'s submodules ``names``
    (their ``forward`` wrapped: the checkpoint's second forward runs no
    forward hooks)."""
    seen = {n: 0 for n in names}

    def counted(name, fwd):
        def forward(*a, **k):
            seen[name] += 1
            return fwd(*a, **k)
        return forward
    for n in names:
        mod = net.get_submodule(n)
        mod.forward = counted(n, mod.forward)
    return seen


def unet_step(remat: bool, block_pallas: bool = False):
    """One port U-Net step (w4, 64^2, batch 4, float32): (loss, the
    parameters after, the towers' forward calls)."""
    algo = SupervisedUNet(sw.step_cfg(remat_unet=remat,
                                      block_pallas=block_pallas),
                          device="cpu")
    seen = _calls(algo.net, ("encoder", "decoder"))
    img, msk = sw.step_batch()
    state, m = algo.train_step(algo.init_state(0), {"img": img, "msk": msk})
    return float(m["loss"]), state.params, seen


def gan_step(remat: bool, inputs: dict):
    """One port ``uganConsis`` step fed the JAX step's draws: (metrics, G,
    D, the generator's forward calls)."""
    algo = UGANConsisAlgo(sw.gan_cfg(remat=remat), device="cpu")
    seen = _calls(algo.net, ("core",))
    batch = {k: inputs[k] for k in ("img", "msk", "mdl", "ul_img", "ul_mdl",
                                     "mj", "alpha", "patch_ids")}
    state, m = algo.train_step(algo.init_state(0), batch,
                               algo.epoch_scalars(1))
    return ({k: float(v) for k, v in m.items()}, state.g_params,
            state.d_params, seen)


def test_remat_unet_step_matches_jax():
    """``remat_unet`` in the port against the JAX ``SupervisedUNet`` with
    ``remat_unet``, one step from the port's weights: the loss to rtol
    1e-4, every parameter to rtol 1e-4 / atol 1e-5."""
    loss, params, seen = unet_step(True)
    assert seen == {"encoder": 2, "decoder": 2}
    want_loss, want = jax_unet_step(remat=True)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    _close_trees(to_flax(params), want, 1e-4, 1e-5)


def test_remat_gan_step_matches_jax(gan_inputs):
    """``remat`` ``uganConsis`` in the port against the JAX step with
    ``remat``, fed the same draws: every metric to rtol 2e-3 / atol 5e-5."""
    from smsut_tpu.config import Config as JConfig
    from smsut_tpu.train.steps.gan import UGANConsisAlgo as JConsis

    got, _, _, seen = gan_step(True, gan_inputs)
    assert seen["core"] > 0
    cfg = sw.gan_cfg()
    port = UGANConsisAlgo(cfg, device="cpu").init_state(0)
    jalgo = JConsis(JConfig(**{k: getattr(cfg, k) for k in (
        "input_size", "base_width", "batch_size", "nce_patches",
        "compute_dtype", "consis_gate_step")}, remat=True, **JAX_STRICT))
    state = jax.jit(jalgo.init_state)(jax.random.PRNGKey(0))
    to = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    state = state.replace(g_params=to(ugan_to_flax(port.g_params)),
                          d_params=to(disc_to_flax(port.d_params)))
    batch = {k: jnp.asarray(gan_inputs[k]) for k in (
        "img", "msk", "mdl", "ul_img", "ul_mdl")}
    scalars = dict(jalgo.epoch_scalars(1), rng=jax.random.PRNGKey(100))
    _, m = jalgo.train_step(state, batch, scalars)
    assert got["G_semi"] > 0 and got["G_nce"] > 0
    for k, v in m.items():
        if k != "rng":
            np.testing.assert_allclose(got[k], float(v), rtol=2e-3,
                                       atol=5e-5, err_msg=k)


def _equal_trees(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("model", ["unet", "unet_fused", "uganConsis"])
def test_remat_on_equals_off_to_the_bit(model, gan_inputs):
    """Remat on against off in the port, float32 on the CPU: the losses
    and the trees after one step equal to the bit (the U-Net also with
    ``block_pallas``, whose fused blocks' K3 runs again in the backward);
    the wrapped towers run twice a step with remat, once without."""
    if model == "uganConsis":
        m0, g0, d0, seen0 = gan_step(False, gan_inputs)
        m1, g1, d1, seen1 = gan_step(True, gan_inputs)
        assert m0 == m1
        _equal_trees(g0, g1)
        _equal_trees(d0, d1)
        # each generator forward under grad once more in the backward
        assert seen1["core"] > seen0["core"] > 0
        return
    fused = model == "unet_fused"
    l0, p0, seen0 = unet_step(False, fused)
    l1, p1, seen1 = unet_step(True, fused)
    assert l0 == l1
    _equal_trees(p0, p1)
    assert seen0 == {"encoder": 1, "decoder": 1}
    assert seen1 == {"encoder": 2, "decoder": 2}


def test_remat_only_under_grad():
    """The eval forward of a ``remat_unet`` U-Net runs each tower once and
    equals the forward without remat to the bit."""
    on = SupervisedUNet(sw.step_cfg(remat_unet=True), device="cpu")
    off = SupervisedUNet(sw.step_cfg(), device="cpu")
    assert on.net.remat and not off.net.remat
    seen = _calls(on.net, ("encoder", "decoder"))
    params = on.init_state(0).params
    img = torch.from_numpy(sw.step_batch()[0])
    a = on.eval_fn(params, img)
    b = off.eval_fn(params, img)
    assert seen == {"encoder": 1, "decoder": 1}
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("algo", ["meanTeacher", "crossPse"])
def test_zoo_builds_its_unets_without_remat(algo):
    """As in the JAX package, ``remat_unet`` rematerialises the supervised
    U-Net alone: Mean Teacher's and CPS's U-Nets are built without it."""
    from smsut_tpu_torch.train.steps.cross_pseudo import CrossPseudo
    from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher

    cls = MeanTeacher if algo == "meanTeacher" else CrossPseudo
    net = cls(sw.step_cfg(remat_unet=True), device="cpu").net
    assert net.remat is False
