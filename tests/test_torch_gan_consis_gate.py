# -*- coding: utf-8 -*-
"""``uganConsis`` with the consistency gate open from the first step
(``consis_gate_step=0``, as the full-width step on the card runs it):
``G_semi``, the paper's consistency loss, and its gradient into the
segmentation tower are held against the JAX package at step 0's bounds,
in float32 and in float64, as tests/test_torch_gan.py holds the rest of
the step."""
from smsut_tpu.config import Config as JConfig
from smsut_tpu.train.steps.gan import UGANConsisAlgo as JConsis
from smsut_tpu_torch.config import Config
from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
from test_torch_gan import (CFG, JAX_CFG, NAMES, STEPS,  # noqa: F401
                            _few_torch_threads, check_run, gan_batches,
                            run_jax)


def test_consis_gate_open_at_step0_matches_jax():
    jalgo = JConsis(JConfig(**dict(JAX_CFG, consis_gate_step=0)))
    batches = gan_batches(5, STEPS, True)
    ref = run_jax(jalgo, batches, 1)
    algo = UGANConsisAlgo(Config(**dict(CFG, consis_gate_step=0)),
                          device="cpu")
    state, got = check_run(jalgo, algo, batches, ref, 1, NAMES)
    assert state.step == STEPS
    assert got[0]["G_semi"] > 0.0 and ref[3][0]["G_semi"] > 0.0
