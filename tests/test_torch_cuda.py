# -*- coding: utf-8 -*-
"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Each test skips on a host without an NVIDIA GPU.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances are max |kernel - plain| / max(1, max |plain|): float32 with TF32
off differs only in summation order; bfloat16 also in which values round
up or down (a one-unit flip is 2^-8 of the value, and in K3 a flip in the
normalised activation feeds the second conv).
"""
import numpy as np
import pytest
import torch

from smsut_tpu_torch import ops
from smsut_tpu_torch.ops import block, conv3x3, instnorm
from torch_port_helpers import conv_w, cuda_device, norm_params, rel_err, t  # noqa: F401

pytestmark = pytest.mark.cuda

F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture
def rng():
    return np.random.default_rng(2020)


def _held_against_plain(fn, counter, args, tol):
    before = counter.launches
    got = fn(*args)
    assert counter.launches == before + 1
    with ops.plain():
        want = fn(*args)
    assert counter.launches == before + 1
    err = rel_err(got, want)
    assert err <= tol, err


@pytest.mark.parametrize("dtype,tol", [(F32, 1e-4), (BF16, 0.05)])
@pytest.mark.parametrize("shape,act", [((8, 256, 256, 16), True),
                                       ((8, 16, 16, 256), False),
                                       ((2, 7, 5, 12), True)])
def test_instnorm(rng, cuda_device, shape, act, dtype, tol):
    x = (rng.normal(size=shape) * 2 + 0.3).astype(np.float32)
    s, b = norm_params(rng, shape[-1])
    args = (t(x, dtype, cuda_device), t(s, device=cuda_device),
            t(b, device=cuda_device), act)
    _held_against_plain(instnorm.instance_norm, instnorm.instance_norm_fwd,
                        args, tol)
    _, mean, rstd = instnorm.instance_norm_fwd(*args)
    with ops.plain():
        _, wm, wr = instnorm.instance_norm_fwd(*args)
    assert rel_err(mean, wm) <= 1e-5 and rel_err(rstd, wr) <= 1e-4


@pytest.mark.parametrize("dtype,tol", [(F32, 1e-4), (BF16, 0.02)])
@pytest.mark.parametrize("shape,cout", [((8, 256, 256, 32), 16),
                                        ((8, 256, 256, 8), 16),
                                        ((8, 32, 32, 256), 128),
                                        ((8, 16, 16, 128), 256),
                                        ((2, 9, 13, 20), 48)])
def test_conv3x3(rng, cuda_device, shape, cout, dtype, tol):
    x = t(rng.normal(size=shape).astype(np.float32), dtype, cuda_device)
    w = t(conv_w(rng, 3, shape[-1], cout), dtype, cuda_device)
    _held_against_plain(conv3x3.conv3x3, conv3x3.conv3x3, (x, w), tol)


@pytest.mark.parametrize("dtype,tol", [(F32, 1e-3), (BF16, 0.05)])
@pytest.mark.parametrize("ci,co,hw", [(32, 16, 256), (128, 256, 16),
                                      (64, 64, 64), (24, 48, 13)])
def test_block(rng, cuda_device, ci, co, hw, dtype, tol):
    x = rng.standard_normal((8, hw, hw, ci)).astype(np.float32)
    args = [t(x, dtype, cuda_device), t(conv_w(rng, 3, ci, co), dtype,
                                        cuda_device)]
    args += [t(a, device=cuda_device) for a in norm_params(rng, co)]
    args += [t(conv_w(rng, 3, co, co), dtype, cuda_device)]
    args += [t(a, device=cuda_device) for a in norm_params(rng, co)]
    if ci != co:
        args += [t(conv_w(rng, 1, ci, co, std=0.3), dtype, cuda_device)]
        args += [t(a, device=cuda_device) for a in norm_params(rng, co)]
    _held_against_plain(block.basic_block, block.basic_block, args, tol)


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.zeros((1, 8, 8, 16), device=cuda_device)
    w16 = torch.zeros((3, 3, 16, 16), device=cuda_device)
    one = torch.ones(16, device=cuda_device)
    with pytest.raises(ValueError):          # Cout not a multiple of 16
        conv3x3.conv3x3(x, torch.zeros((3, 3, 16, 5), device=cuda_device))
    with pytest.raises(TypeError):           # float16 is not taken
        conv3x3.conv3x3(x.half(), w16.half())
    with pytest.raises(ValueError):          # weight dtype differs
        conv3x3.conv3x3(x, w16.to(BF16))
    with pytest.raises(ValueError):          # not contiguous
        instnorm.instance_norm(x.transpose(1, 2), one, one, True)
    with pytest.raises(ValueError):          # channels not a multiple of 4
        instnorm.instance_norm(x[..., :6].contiguous(), one[:6], one[:6],
                               True)
    with pytest.raises(ValueError):          # identity form needs Cin == Cout
        block.basic_block(torch.zeros((1, 8, 8, 8), device=cuda_device),
                          torch.zeros((3, 3, 8, 16), device=cuda_device),
                          one, one, w16, one, one)


def test_unet_forward_counts_launches(cuda_device):
    """Every norm and 3x3 conv of the U-Net forward goes through a kernel:
    28 K1 + 18 K2 unfused, 9 K3 + 1 K1 (the stem's norm) fused."""
    from smsut_tpu_torch.models import UNet

    x = torch.randn((2, 64, 64, 1), device=cuda_device)
    for fused, want in ((False, (28, 18, 0)), (True, (1, 0, 9))):
        net = UNet(5, 16, compute_dtype=BF16, block_fused=fused,
                   device=cuda_device)
        counters = (instnorm.instance_norm_fwd, conv3x3.conv3x3,
                    block.basic_block)
        before = [c.launches for c in counters]
        with torch.inference_mode():
            y = net(x)
        assert tuple(c.launches - b for c, b in zip(counters, before)) == want
        assert y.dtype == F32 and bool(torch.isfinite(y).all())
