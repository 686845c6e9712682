# -*- coding: utf-8 -*-
"""K3 and K6 (smsut_tpu_torch/ops/block.py): the plain fused block and the
backward of the autograd op (K6's plain formula on the CPU) against the JAX
Pallas block kernels (ops/block_pallas.py, interpret mode on the CPU).

The TPU kernel runs on the space-to-depth packed layout; on the unpacked
map its statistics pooled over the 4 subpixel groups are the full-H*W
statistics, so the reference is ``depth_to_space(fused_block_fwd(
space_to_depth(x), pack_kernel(w), ...))``.  Also: the plain K3 equals the
unfused K2 + K1 chain.  The CUDA kernel is held against the plain version
on the card in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
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


@pytest.mark.parametrize("ci,co", [(16, 16), (8, 16)])
def test_backward_matches_pallas_grad(rng, ci, co):
    """Every gradient of the autograd op against jax.grad through
    space_to_depth -> apply_fused_block (``_bwd_call``) -> depth_to_space,
    taken with respect to the unpacked x, kernels and norm parameters;
    float32, errors scaled by each gradient's largest entry."""
    x, a = _case(rng, ci, co, hw=16)
    tgt = rng.standard_normal((2, 16, 16, co)).astype(np.float32)
    names = ["x"] + [k for k in _ORDER if k in a]
    vals = [x] + [a[k] for k in names[1:]]

    def loss(x, w1, s1, b1, w2, s2, b2, ws=None, ss=None, bs=None):
        out = bp.apply_fused_block(
            pk.space_to_depth(x), pk.pack_kernel(w1, (ci,)), s1, b1,
            pk.pack_kernel(w2, (co,)), s2, b2,
            None if ws is None else pk.pack_kernel(ws, (ci,)), ss, bs)
        return jnp.sum(pk.depth_to_space(out, co) * tgt)

    want = jax.grad(loss, argnums=tuple(range(len(vals))))(
        *[jnp.asarray(v) for v in vals])
    args = [t(v).requires_grad_() for v in vals]
    block.basic_block(*args).backward(t(tgt))
    for name, got, w in zip(names, args, want):
        w = np.asarray(w)
        scale = np.abs(w).max() + 1e-9
        np.testing.assert_allclose(got.grad.numpy() / scale, w / scale,
                                   rtol=0, atol=1e-4, err_msg=name)


def test_without_autograd_nothing_is_saved(rng):
    """Serving (inference mode) takes the forward alone: no autograd node
    and no residuals; with autograd the op keeps the residuals."""
    x, a = _case(rng, 8, 16, hw=8)
    args = [a2.requires_grad_() if a2.dtype == torch.float32 else a2
            for a2 in _torch_args(x, a)]
    with torch.inference_mode():
        out = block.basic_block(*args)
    assert out.grad_fn is None
    out = block.basic_block(*args)
    assert type(out.grad_fn).__name__ == "_BasicBlockBackward"
    assert len(out.grad_fn.saved_tensors) == 12


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



def _packed_case(rng, segs, co, b=2, hw=8):
    """A packed input [B, hw, hw, 4*sum(segs)] (channel s*C + c per
    segment) and the packed kernels of ``models/packed.py``
    ``pack_kernel``, as numpy: the TPU kernels' own operands."""
    ci = sum(segs)
    x, a = _case(rng, ci, co, b, 2 * hw)
    xp = np.asarray(pk.space_to_depth(jnp.asarray(x)))
    if len(segs) > 1:   # a decoder's concat: each segment packed alone
        parts, c0 = [], 0
        for c in segs:
            parts.append(np.asarray(pk.space_to_depth(
                jnp.asarray(x[..., c0:c0 + c]))))
            c0 += c
        xp = np.concatenate(parts, -1)
    pa = dict(a)
    pa["w1"] = np.asarray(pk.pack_kernel(jnp.asarray(a["w1"]), segs))
    pa["w2"] = np.asarray(pk.pack_kernel(jnp.asarray(a["w2"]), (co,)))
    if "ws" in a:
        pa["ws"] = np.asarray(pk.pack_kernel(jnp.asarray(a["ws"]), segs))
    return xp, pa


_PACKED = [((16,), 16), ((8,), 16), ((16, 16), 16)]


@pytest.mark.parametrize("segs,co", _PACKED)
def test_plain_groups4_matches_pallas_packed(rng, segs, co):
    """K3's plain version with groups 4 on the packed map itself against
    ``fused_block_fwd`` (interpret mode) on the same packed operands, no
    space_to_depth around either: the statistics pool the 4 subpixel
    groups of each original channel.  float32, rtol/atol 1e-4 (the
    tolerance of tests/test_packed.py)."""
    xp, a = _packed_case(rng, segs, co)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    out, _, _ = bp.fused_block_fwd(jnp.asarray(xp), j["w1"], j["s1"],
                                   j["b1"], j["w2"], j["s2"], j["b2"],
                                   j.get("ws"), j.get("ss"), j.get("bs"))
    got = block.basic_block(*_torch_args(xp, a), groups=4).numpy()
    np.testing.assert_allclose(got, np.asarray(out), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("segs,co", _PACKED)
def test_backward_groups4_matches_pallas_vjp(rng, segs, co):
    """Every gradient of the autograd op with groups 4 (K6's plain
    formula: the norm sums pooled over the subpixel groups, N = 4*H*W, the
    norm parameters' gradients [C]) against ``apply_fused_block``'s VJP
    (``_bwd_call``, interpret mode) with respect to the packed input, the
    packed kernels and the [C] norm parameters; float32, errors scaled by
    each gradient's largest entry, atol 1e-4 as the unpacked case."""
    xp, a = _packed_case(rng, segs, co)
    tgt = rng.standard_normal(xp.shape[:3] + (4 * co,)).astype(np.float32)
    names = ["x"] + [k for k in _ORDER if k in a]
    vals = [xp] + [a[k] for k in names[1:]]

    def loss(*args):
        return jnp.sum(bp.apply_fused_block(*args) * tgt)

    want = jax.grad(loss, argnums=tuple(range(len(vals))))(
        *[jnp.asarray(v) for v in vals])
    args = [t(v).requires_grad_() for v in vals]
    block.basic_block(*args, groups=4).backward(t(tgt))
    for name, got, w in zip(names, args, want):
        w = np.asarray(w)
        assert got.grad.shape == w.shape, name
        scale = np.abs(w).max() + 1e-9
        np.testing.assert_allclose(got.grad.numpy() / scale, w / scale,
                                   rtol=0, atol=1e-4, err_msg=name)
