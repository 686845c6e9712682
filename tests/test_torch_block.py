# -*- coding: utf-8 -*-
"""K3 (smsut_tpu_torch/ops/block.py): the plain fused block against the JAX
Pallas block kernel (ops/block_pallas.py, interpret mode on the CPU).

The TPU kernel runs on the space-to-depth packed layout; on the unpacked
map its statistics pooled over the 4 subpixel groups are the full-H*W
statistics, so the reference is ``depth_to_space(fused_block_fwd(
space_to_depth(x), pack_kernel(w), ...))``.  Also: the plain K3 equals the
unfused K2 + K1 chain.  The CUDA kernel is held against the plain version
on the card in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smsut_tpu.models import packed as pk
from smsut_tpu.ops import block_pallas as bp
from smsut_tpu_torch.models.blocks import BasicBlock
from smsut_tpu_torch.ops import block
from torch_port_helpers import conv_w, norm_params, rel_err, t


def _case(rng, ci, co, b=2, hw=32):
    x = rng.standard_normal((b, hw, hw, ci)).astype(np.float32)
    a = dict(w1=conv_w(rng, 3, ci, co), w2=conv_w(rng, 3, co, co))
    a["s1"], a["b1"] = norm_params(rng, co)
    a["s2"], a["b2"] = norm_params(rng, co)
    if ci != co:
        a["ws"] = conv_w(rng, 1, ci, co, std=0.3)
        a["ss"], a["bs"] = norm_params(rng, co)
    return x, a


_ORDER = ("w1", "s1", "b1", "w2", "s2", "b2", "ws", "ss", "bs")


def _torch_args(x, a, dtype=torch.float32, device="cpu"):
    conv = lambda k: k in ("w1", "w2", "ws")
    return [t(x, dtype, device)] + [
        t(a[k], dtype if conv(k) else torch.float32, device)
        for k in _ORDER if k in a]


@pytest.mark.parametrize("ci,co", [(16, 16), (8, 16)])
def test_plain_matches_pallas(rng, ci, co):
    x, a = _case(rng, ci, co)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    short = "ws" in a
    out, _, _ = bp.fused_block_fwd(
        pk.space_to_depth(jnp.asarray(x)),
        pk.pack_kernel(j["w1"], (ci,)), j["s1"], j["b1"],
        pk.pack_kernel(j["w2"], (co,)), j["s2"], j["b2"],
        pk.pack_kernel(j["ws"], (ci,)) if short else None,
        j.get("ss"), j.get("bs"))
    want = np.asarray(pk.depth_to_space(out, co))
    got = block.basic_block(*_torch_args(x, a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _block_module(a, ci, co, fused):
    m = BasicBlock(ci, co, fused=fused)
    names = {"w1": "conv1.weight", "s1": "bn1.weight", "b1": "bn1.bias",
             "w2": "conv2.weight", "s2": "bn2.weight", "b2": "bn2.bias",
             "ws": "shortcut1.weight", "ss": "shortcut2.weight",
             "bs": "shortcut2.bias"}
    m.load_state_dict({names[k]: t(v) for k, v in a.items()})
    return m


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("ci,co", [(16, 16), (8, 16)])
def test_plain_fused_equals_unfused_chain(rng, ci, co, dtype, tol):
    """In float32 the fused block and the K2 + K1 chain differ only in
    summation order.  In bfloat16 the chain takes its statistics from the
    rounded conv outputs and adds in bfloat16, the fused block from the
    float32 accumulators: they differ by bfloat16 rounding."""
    x, a = _case(rng, ci, co)
    xt = t(x, dtype)
    with torch.no_grad():
        fused = _block_module(a, ci, co, True)(xt)
        chain = _block_module(a, ci, co, False)(xt)
    assert fused.dtype == chain.dtype == dtype
    assert rel_err(fused, chain) <= tol

