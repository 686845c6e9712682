# -*- coding: utf-8 -*-
"""The other two GAN variants against the JAX package, as
tests/test_torch_gan.py holds ``uganConsis``: ``ugan`` (UGAN, labelled
only, the shape loss at ``lambda_shp`` of epoch 3) and ``uganShp0``
(UGANnce + PatchNCE, labelled only), three steps each from the same
weights, batches and draws, with the same bounds, in float32 and in
float64."""
import pytest

from smsut_tpu.config import Config as JConfig
from smsut_tpu.train.steps.gan import UGANShp0Algo as JShp0
from smsut_tpu.train.steps.gan import UGANTrainerAlgo as JUgan
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.train.steps.gan import UGANShp0Algo, UGANTrainerAlgo
from test_torch_gan import (CFG, JAX_CFG, STEPS, _few_torch_threads,  # noqa: F401
                            check_run, gan_batches, run_jax)

BASE = ("D_real", "D_fake", "D_cls", "D_gp", "G_fake", "G_rec", "G_cls",
        "G_seg")


@pytest.mark.parametrize("jcls,cls,epoch,names", [
    (JUgan, UGANTrainerAlgo, 3, BASE + ("G_shp",)),
    (JShp0, UGANShp0Algo, 1, BASE + ("G_nce",))])
def test_variant_steps_match_jax(jcls, cls, epoch, names):
    jalgo = jcls(JConfig(**JAX_CFG))
    batches = gan_batches(6, STEPS, False)
    ref = run_jax(jalgo, batches, epoch)
    algo = cls(Config(**CFG), device="cpu")
    assert algo.epoch_scalars(epoch) == jalgo.epoch_scalars(epoch)
    state, got = check_run(jalgo, algo, batches, ref, epoch, names)
    assert state.step == STEPS and set(got[0]) == set(ref[3][0])
