# -*- coding: utf-8 -*-
"""The port's CUDA kernels against their plain PyTorch versions, on the
card: K1-K3 forward, K4-K6 backward (and K2 as the dx of a conv), K2's and
K5's tensor-core paths at every 3x3 conv of the training step, K3's and
K6's at the U-Net's nine blocks, their routing by dtype and their runs bit
for bit, the launch counts of the U-Net's serving and training
steps, and its gradients against the plain path; the three tensor-core conv
kernels of the conv microbench (dots, im2col, im2col2: at the emulation's
shapes, bit for bit across runs and strips, and dots' route by shape)
and the microbench itself; the semi-supervised zoo's and M3L's
iterations replayed against eager, and the dual-task U-Net's launches
and gradients in its three norm and activation configurations; K3 and K6
with the packed map's subpixel groups (``groups=4``) against their plain
versions, groups 1 as the default to the bit, and the packed U-Net's
launches; K2, K2 as dx and K5 with W-packed kernels and K1/K4 on W views
at the W layouts' shapes (``-k wpack``); ``tools/profile_step.py``'s
device rows against the profiler's ``key_averages``.  Each test skips on
a host without an NVIDIA GPU.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances are max |kernel - plain| / max(1, max |plain|): float32 with TF32
off differs only in summation order; bfloat16 also in which values round
up or down (a one-unit flip is 2^-8 of the value, and in K3 a flip in the
normalised activation feeds the second conv).
"""
import contextlib

import numpy as np
import pytest
import torch

from smsut_tpu_torch import ops
from smsut_tpu_torch.ops import block, conv3x3, conv_mma, instnorm
from torch_port_helpers import conv_w, cuda_device, norm_params, rel_err, t  # noqa: F401

pytestmark = pytest.mark.cuda

F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture
def rng():
    return np.random.default_rng(2020)


@pytest.fixture(scope="module", autouse=True)
def _kernels_built():
    """Every kernel library built before the first test, in a child
    process, where there is a card.  Built inside this process, the whole
    file's run left ``test_conv_mma_dots_route``'s profiler session, which
    holds one launch, without its kernel record; with the libraries built
    before the run it passes (ROADMAP C3)."""
    if torch.cuda.is_available():
        import os
        import subprocess
        import sys

        subprocess.run([sys.executable, "-c", "from smsut_tpu_torch.ops "
                        "import _build; _build.build()"], check=True,
                       cwd=os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__))))


def _held_against_plain(fn, counter, args, tol):
    before = counter.launches
    got = fn(*args)
    assert counter.launches == before + 1
    with ops.plain():
        want = fn(*args)
    assert counter.launches == before + 1
    err = rel_err(got, want)
    assert err <= tol, err


# the distinct (map, channels) of the U-Net's 28 norm sites (width 16,
# 256^2, batch 8: the stem's norm at 8 channels, then three per block), each
# with the activation of one of its sites; and C 3 and 12, the scalar path
NORM_SHAPES = (((8, 256, 256, 16), True), ((8, 16, 16, 256), False),
               ((2, 7, 5, 12), True), ((8, 256, 256, 8), True),
               ((8, 128, 128, 32), False), ((8, 64, 64, 64), True),
               ((8, 32, 32, 128), False), ((8, 16, 16, 256), True),
               ((8, 256, 256, 16), False), ((3, 11, 9, 3), True),
               ((8, 64, 64, 12), False))


@pytest.mark.parametrize("dtype,tol", [(F32, 1e-4), (BF16, 0.05)])
@pytest.mark.parametrize("shape,act", NORM_SHAPES)
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
    _held_against_plain(conv3x3.conv3x3_fwd, conv3x3.conv3x3_fwd, (x, w),
                        tol)


# the U-Net's nine BasicBlocks (width 16, 256^2), all of the shortcut
# form: (Cin, Cout, map side)
UNET_BLOCKS = ((8, 16, 256), (32, 16, 256), (16, 32, 128), (64, 32, 128),
               (32, 64, 64), (128, 64, 64), (64, 128, 32), (256, 128, 32),
               (128, 256, 16))
# float32 (the parity path, CUDA-core convs) at its earlier shapes; bfloat16
# (the tensor cores) at the nine blocks, the identity form and a ragged map
BLOCK_F32 = ((32, 16, 256), (128, 256, 16), (64, 64, 64), (24, 48, 13))
BLOCK_CASES = ([(F32, 1e-3, *c) for c in BLOCK_F32]
               + [(BF16, 0.05, *c) for c in UNET_BLOCKS
                  + ((64, 64, 64), (24, 48, 13))])


def _block_args(rng, device, ci, co, hw, dtype, batch=8):
    x = rng.standard_normal((batch, hw, hw, ci)).astype(np.float32)
    args = [t(x, dtype, device), t(conv_w(rng, 3, ci, co), dtype, device)]
    args += [t(a, device=device) for a in norm_params(rng, co)]
    args += [t(conv_w(rng, 3, co, co), dtype, device)]
    args += [t(a, device=device) for a in norm_params(rng, co)]
    if ci != co:
        args += [t(conv_w(rng, 1, ci, co, std=0.3), dtype, device)]
        args += [t(a, device=device) for a in norm_params(rng, co)]
    else:
        args += [None, None, None]
    return args


@pytest.mark.parametrize("dtype,tol,ci,co,hw", BLOCK_CASES)
def test_block(rng, cuda_device, ci, co, hw, dtype, tol):
    args = _block_args(rng, cuda_device, ci, co, hw, dtype)
    _held_against_plain(block.basic_block_fwd, block.basic_block_fwd, args,
                        tol)


def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.zeros((1, 8, 8, 16), device=cuda_device)
    w16 = torch.zeros((3, 3, 16, 16), device=cuda_device)
    one = torch.ones(16, device=cuda_device)
    with pytest.raises(ValueError):          # Cout not a multiple of 8
        conv3x3.conv3x3(x, torch.zeros((3, 3, 16, 5), device=cuda_device))
    with pytest.raises(ValueError):          # dw needs Cout % 16 == 0
        conv3x3.conv3x3_dw(x, torch.zeros((1, 8, 8, 8), device=cuda_device))
    with pytest.raises(TypeError):           # float16 is not taken
        conv3x3.conv3x3(x.half(), w16.half())
    with pytest.raises(ValueError):          # weight dtype differs
        conv3x3.conv3x3(x, w16.to(BF16))
    with pytest.raises(ValueError):          # not contiguous
        instnorm.instance_norm(x.transpose(1, 2), one, one, True)
    with pytest.raises(ValueError):          # identity form needs Cin == Cout
        block.basic_block(torch.zeros((1, 8, 8, 8), device=cuda_device),
                          torch.zeros((3, 3, 8, 16), device=cuda_device),
                          one, one, w16, one, one)


COUNTERS = (instnorm.instance_norm_fwd, conv3x3.conv3x3_fwd,
            block.basic_block_fwd, instnorm.instance_norm_bwd,
            conv3x3.conv3x3_dw, block.basic_block_bwd)


def _launches(fn):
    before = [c.launches for c in COUNTERS]
    out = fn()
    return out, tuple(c.launches - b for c, b in zip(COUNTERS, before))


def test_unet_forward_counts_launches(cuda_device):
    """Every norm and 3x3 conv of the U-Net forward goes through a kernel:
    28 K1 + 18 K2 unfused, 9 K3 + 1 K1 (the stem's norm) fused; serving
    launches no backward kernel."""
    from smsut_tpu_torch.models import UNet

    x = torch.randn((2, 64, 64, 1), device=cuda_device)
    for fused, want in ((False, (28, 18, 0, 0, 0, 0)),
                        (True, (1, 0, 9, 0, 0, 0))):
        net = UNet(5, 16, compute_dtype=BF16, block_fused=fused,
                   device=cuda_device)
        with torch.inference_mode():
            y, counts = _launches(lambda: net(x))
        assert counts == want
        assert y.dtype == F32 and bool(torch.isfinite(y).all())


@pytest.mark.parametrize("dtype,tol", [(F32, 1e-4), (BF16, 0.05)])
@pytest.mark.parametrize("shape,act", NORM_SHAPES)
def test_instnorm_bwd(rng, cuda_device, shape, act, dtype, tol):
    x = t((rng.normal(size=shape) * 2 + 0.3).astype(np.float32), dtype,
          cuda_device)
    g = t(rng.normal(size=shape).astype(np.float32), dtype, cuda_device)
    s, b = (t(a, device=cuda_device) for a in norm_params(rng, shape[-1]))
    _, mean, rstd = instnorm.instance_norm_fwd(x, s, b, act)
    args = (x, g, mean, rstd, s, b, act)
    got, counts = _launches(lambda: instnorm.instance_norm_bwd(*args))
    assert counts == (0, 0, 0, 1, 0, 0)
    with ops.plain():
        want = instnorm.instance_norm_bwd(*args)
    assert got[0].dtype == dtype
    for a, w in zip(got, want):
        assert rel_err(a, w) <= tol


def test_instnorm_plans_cover_the_norm_shapes(cuda_device):
    """The plan K1 and K4 take on this card at each norm shape, in both
    dtypes, cuts the map into blocks that cover every pixel and channel
    once: resident (K1 only), clusters of at most 16 blocks; two-pass, no
    empty block.  Over these shapes K1 takes both plans."""
    seen = set()
    for kind in ("fwd", "bwd"):
        for (b, h, w, c), _ in NORM_SHAPES:
            for dt in (F32, BF16):
                q = instnorm.plan(kind, b, h * w, c, dt)
                seen.add(q["resident"])
                assert kind == "fwd" or not q["resident"], q
                assert q["ng"] * q["G"] == c, q
                assert q["nsplit"] * q["rows"] >= h * w, q
                if q["resident"]:
                    assert q["nsplit"] <= 16, q
                else:
                    assert (q["nsplit"] - 1) * q["rows"] < h * w, q
    assert seen == {0, 1}, seen


@pytest.mark.parametrize("shape,dtype", [((8, 256, 256, 16), BF16),
                                         ((8, 256, 256, 16), F32),
                                         ((8, 64, 64, 64), BF16),
                                         ((3, 11, 9, 3), BF16)])
def test_instnorm_bit_for_bit(rng, cuda_device, shape, dtype):
    """K1 and K4 add their partials in a fixed order, with no float
    atomics: two runs agree bit for bit, in each plan."""
    x = t((rng.normal(size=shape) * 2 + 0.3).astype(np.float32), dtype,
          cuda_device)
    g = t(rng.normal(size=shape).astype(np.float32), dtype, cuda_device)
    s, b = (t(a, device=cuda_device) for a in norm_params(rng, shape[-1]))
    runs = []
    for _ in range(2):
        y, mean, rstd = instnorm.instance_norm_fwd(x, s, b, True)
        runs.append([y, mean, rstd, *instnorm.instance_norm_bwd(
            x, g, mean, rstd, s, b, True)])
    for a, w in zip(*runs):
        assert torch.equal(a, w)


# two (shape, dtype) that K1 and K4 both take in two passes, with
# different splits
TWO_PASS = (((8, 256, 256, 16), BF16), ((8, 128, 128, 32), F32))


@pytest.mark.parametrize("cases", [TWO_PASS, TWO_PASS[::-1]])
def test_instnorm_on_two_streams(rng, cuda_device, cases):
    """Calls on two streams at once take their own tickets: K1 and K4 on two
    streams, one shape each, each stream held by a sleep kernel until both
    are full and then running side by side, agree bit for bit with the same
    calls on one stream.  Both shapes are two-pass, so every call elects
    its last blocks by tickets, and they differ in splits, so arrivals of
    one stream counted at the other's tickets would elect the wrong block.
    Every call has inputs of its own."""
    for (b, h, w, c), dt in cases:
        for kind in ("fwd", "bwd"):
            assert not instnorm.plan(kind, b, h * w, c, dt)["resident"]

    def inputs(shape, dt):
        x = t((rng.normal(size=shape) * 2 + 0.3).astype(np.float32), dt,
              cuda_device)
        g = t(rng.normal(size=shape).astype(np.float32), dt, cuda_device)
        s, b = (t(a, device=cuda_device) for a in norm_params(rng, shape[-1]))
        return x, g, s, b

    def fwd(x, g, s, b):
        return instnorm.instance_norm_fwd(x, s, b, True)

    def bwd(x, g, s, b, y, mean, rstd):
        return instnorm.instance_norm_bwd(x, g, mean, rstd, s, b, True)

    def both(a):
        f = fwd(*a)
        return (*f, *bwd(*a, *f))

    ins = [[inputs(*case) for _ in range(5)] for case in cases]
    want = [[both(a) for a in row] for row in ins]
    streams = [torch.cuda.Stream(cuda_device) for _ in cases]
    torch.cuda.synchronize(cuda_device)
    for st in streams:
        with torch.cuda.stream(st):
            torch.cuda._sleep(20_000_000)
    # all K1 calls, then all K4 calls, in turns between the streams: the
    # two streams then run the same kernels side by side
    got = [[], []]
    for k in range(5):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[i].append(fwd(*ins[i][k]))
    for k in range(5):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[i][k] = (*got[i][k], *bwd(*ins[i][k], *got[i][k]))
    torch.cuda.synchronize(cuda_device)
    for i in range(2):
        for run, ref in zip(got[i], want[i]):
            assert len(run) == len(ref) == 6
            for a, w in zip(run, ref):
                assert torch.equal(a, w)


@pytest.mark.parametrize("dtype,tol", [(F32, 1e-4), (BF16, 0.02)])
@pytest.mark.parametrize("shape,cout", [((8, 256, 256, 32), 16),
                                        ((8, 256, 256, 8), 16),
                                        ((8, 16, 16, 128), 256),
                                        ((2, 9, 13, 20), 48)])
def test_conv3x3_dw(rng, cuda_device, shape, cout, dtype, tol):
    x = t(rng.normal(size=shape).astype(np.float32), dtype, cuda_device)
    g = t(rng.normal(size=shape[:3] + (cout,)).astype(np.float32), dtype,
          cuda_device)
    got, counts = _launches(lambda: conv3x3.conv3x3_dw(x, g))
    assert counts == (0, 0, 0, 0, 1, 0) and got.dtype == F32
    with ops.plain():
        want = conv3x3.conv3x3_dw(x, g)
    assert rel_err(got, want) <= tol


@pytest.mark.parametrize("dtype,tol", [(F32, 1e-4), (BF16, 0.02)])
def test_conv3x3_dx_with_eight_channels(rng, cuda_device, dtype, tol):
    """The dx of the U-Net's first block conv (8 -> 16): K2 with Cout = 8,
    through the autograd op, against the plain path."""
    x = t(rng.normal(size=(8, 256, 256, 8)).astype(np.float32), dtype,
          cuda_device).requires_grad_()
    w = t(conv_w(rng, 3, 8, 16), dtype, cuda_device).requires_grad_()
    g = t(rng.normal(size=(8, 256, 256, 16)).astype(np.float32), dtype,
          cuda_device)
    got, counts = _launches(lambda: torch.autograd.grad(
        conv3x3.conv3x3(x, w), (x, w), g))
    assert counts == (0, 2, 0, 0, 1, 0)
    with ops.plain():
        want = torch.autograd.grad(conv3x3.conv3x3(x, w), (x, w), g)
    for a, b in zip(got, want):
        assert a.dtype == dtype and rel_err(a, b) <= tol


BLOCK_BWD_F32 = ((32, 16, 256), (8, 16, 256), (64, 64, 64), (24, 48, 13))
BLOCK_BWD_CASES = ([(F32, 1e-3, *c) for c in BLOCK_BWD_F32]
                   + [(BF16, 0.05, *c) for c in UNET_BLOCKS
                      + ((64, 64, 64), (24, 48, 13))])


@pytest.mark.parametrize("dtype,tol,ci,co,hw", BLOCK_BWD_CASES)
def test_block_bwd(rng, cuda_device, ci, co, hw, dtype, tol):
    args = _block_args(rng, cuda_device, ci, co, hw, dtype)
    _, res = block.basic_block_fwd(*args, save=True)
    x_, w1, s1, _, w2, s2, _, ws, ss, _ = args
    g = t(rng.standard_normal((8, hw, hw, co)).astype(np.float32), dtype,
          cuda_device)
    bargs = (g, x_, w1, s1, w2, s2, ws, ss, res)
    got, counts = _launches(lambda: block.basic_block_bwd(*bargs))
    assert counts == (0, 0, 0, 0, 0, 1)
    with ops.plain():
        want = block.basic_block_bwd(*bargs)
    assert got[0].dtype == dtype
    for a, w in zip(got, want):
        assert (a is None) == (w is None)
        if a is not None:
            assert rel_err(a, w) <= tol


# the 3x3 convs of the U-Net's training step (width 16, 256^2): map side,
# forward Cin and Cout.  The dx of each is K2 on the flipped kernel (Cout ->
# Cin), its dw K5.
STEP_CONVS = ((256, 8, 16), (256, 16, 16), (256, 32, 16), (128, 16, 32),
              (128, 32, 32), (128, 64, 32), (64, 32, 64), (64, 64, 64),
              (64, 128, 64), (32, 64, 128), (32, 128, 128), (32, 256, 128),
              (16, 128, 256), (16, 256, 256))


def _step_conv(rng, device, hw, ci, co):
    """bf16 x [2,hw,hw,ci], w [3,3,ci,co] and a cotangent g [2,hw,hw,co]."""
    x = t(rng.normal(size=(2, hw, hw, ci)).astype(np.float32), BF16, device)
    w = t(conv_w(rng, 3, ci, co), BF16, device)
    g = t(rng.normal(size=(2, hw, hw, co)).astype(np.float32), BF16, device)
    return x, w, g


@pytest.mark.parametrize("hw,ci,co", STEP_CONVS)
def test_conv3x3_tensor_cores_at_step_shapes(rng, cuda_device, hw, ci, co):
    """K2's tensor-core path, forward and as dx, and K5's, against their
    plain versions at every 3x3 conv of the training step (batch 2), with
    chip_smoke.py's bf16 tolerances."""
    x, w, g = _step_conv(rng, cuda_device, hw, ci, co)
    _held_against_plain(conv3x3.conv3x3_fwd, conv3x3.conv3x3_fwd, (x, w),
                        0.02)
    _held_against_plain(conv3x3.conv3x3_fwd, conv3x3.conv3x3_fwd,
                        (g, conv3x3.flip_io(w)), 0.02)
    _held_against_plain(conv3x3.conv3x3_dw, conv3x3.conv3x3_dw, (x, g), 0.05)


def _kernel_names(fn):
    """Names of the device kernels ``fn`` launches (torch.profiler).  ``fn``
    runs twice under the profiler: a profile can miss the first kernel it
    sees."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.parametrize("dtype,fwd,dw", [
    (BF16, "conv3x3_tc_kernel", "conv3x3_dw_tc_kernel"),
    (F32, "conv_tile_kernel", "dw_partial_kernel")])
def test_conv3x3_routes_by_dtype(rng, cuda_device, dtype, fwd, dw):
    """bfloat16 runs the tensor-core kernels, float32 the CUDA-core tiles
    (the parity path), and neither the other's."""
    x, w, g = (a.to(dtype) for a in _step_conv(rng, cuda_device, 64, 32, 64))
    names = _kernel_names(lambda: (conv3x3.conv3x3_fwd(x, w),
                                   conv3x3.conv3x3_dw(x, g)))
    other = {"conv3x3_tc_kernel", "conv3x3_dw_tc_kernel", "conv_tile_kernel",
             "dw_partial_kernel"} - {fwd, dw}
    assert any(fwd in n for n in names) and any(dw in n for n in names), names
    assert not any(o in n for n in names for o in other), names


@pytest.mark.parametrize("dtype,conv,other", [
    (BF16, ("conv3x3_tc_kernel", "conv3x3_dw_tc_kernel"),
     ("conv_tile_kernel", "dw_partial_kernel", "dw_reduce_kernel")),
    (F32, ("conv_tile_kernel", "dw_partial_kernel"),
     ("conv3x3_tc_kernel", "conv3x3_dw_tc_kernel"))])
def test_block_routes_by_dtype(rng, cuda_device, dtype, conv, other):
    """K3 and K6 in bfloat16 run every conv on the tensor cores and none on
    the CUDA-core tiles; float32 (the parity path) the other way round."""
    args = _block_args(rng, cuda_device, 32, 16, 64, dtype, batch=2)
    x, w1, s1, _, w2, s2, _, ws, ss, _ = args
    g = torch.randn((2, 64, 64, 16), device=cuda_device).to(dtype)

    def run():
        _, res = block.basic_block_fwd(*args, save=True)
        block.basic_block_bwd(g, x, w1, s1, w2, s2, ws, ss, res)
    names = _kernel_names(run)
    assert all(any(c in n for n in names) for c in conv), names
    assert not any(o in n for n in names for o in other), names


@pytest.mark.parametrize("ci,co,hw", [(32, 16, 256), (64, 64, 64)])
def test_block_tensor_cores_bit_for_bit(rng, cuda_device, ci, co, hw):
    """K3's and K6's bfloat16 chains add their partials in a fixed order,
    with no atomics: two runs agree bit for bit (level 0, many statistics
    tiles and dw splits; the identity form)."""
    args = _block_args(rng, cuda_device, ci, co, hw, BF16)
    x, w1, s1, _, w2, s2, _, ws, ss, _ = args
    g = t(rng.standard_normal((8, hw, hw, co)).astype(np.float32), BF16,
          cuda_device)
    # the (g, h) and (mean, rstd) rows the chain writes: the shortcut
    # norm's row only in the shortcut form
    norms = 3 if ws is not None else 2
    runs = []
    for _ in range(2):
        out, res = block.basic_block_fwd(*args, save=True)
        grads = block.basic_block_bwd(g, x, w1, s1, w2, s2, ws, ss, res)
        runs.append([out, res.y1, res.y2, res.u, res.gh[:norms],
                     res.st[:norms], *grads])
    for a, b in zip(*runs):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def test_conv3x3_dw_tensor_cores_bit_for_bit(rng, cuda_device):
    """K5's bf16 path adds its partials in a fixed order, with no atomics:
    two runs agree bit for bit (the step's widest level-0 shape, several
    splits)."""
    x, _, g = _step_conv(rng, cuda_device, 256, 32, 16)
    a = conv3x3.conv3x3_dw(x, g)
    b = conv3x3.conv3x3_dw(x, g)
    assert torch.equal(a, b)


def test_dw_then_block_bwd_each_opt_in(rng, cuda_device):
    """K5 and K6's dw1 at 32 -> 64 on 64^2 launch the same instantiation of
    conv3x3_dw_tc_kernel, over 48 KB of shared memory, each from its own
    library: each library's copy must be opted in to its shared memory,
    whichever ran first, so both launch here in one test."""
    x, _, g = _step_conv(rng, cuda_device, 64, 32, 64)
    got, counts = _launches(lambda: conv3x3.conv3x3_dw(x, g))
    assert counts == (0, 0, 0, 0, 1, 0)
    with ops.plain():
        assert rel_err(got, conv3x3.conv3x3_dw(x, g)) <= 0.05
    args = _block_args(rng, cuda_device, 32, 64, 64, BF16, batch=2)
    x_, w1, s1, _, w2, s2, _, ws, ss, _ = args
    _, res = block.basic_block_fwd(*args, save=True)
    gy = t(rng.standard_normal((2, 64, 64, 64)).astype(np.float32), BF16,
           cuda_device)
    bargs = (gy, x_, w1, s1, w2, s2, ws, ss, res)
    got, counts = _launches(lambda: block.basic_block_bwd(*bargs))
    assert counts == (0, 0, 0, 0, 0, 1)
    with ops.plain():
        want = block.basic_block_bwd(*bargs)
    for a, w in zip(got, want):
        if w is not None:
            assert rel_err(a, w) <= 0.05


def test_conv3x3_tensor_cores_refuse_what_they_do_not_take(cuda_device):
    """A bf16 shape the kernels do not take raises ValueError: Cout not a
    multiple of 8 (the wrapper), a weight that is contiguous but not 16-byte
    aligned (refused by the C entry point, nothing launched)."""
    x = torch.zeros((1, 8, 8, 16), dtype=BF16, device=cuda_device)
    with pytest.raises(ValueError):
        conv3x3.conv3x3_fwd(x, torch.zeros((3, 3, 16, 12), dtype=BF16,
                                           device=cuda_device))
    flat = torch.zeros(9 * 16 * 16 + 1, dtype=BF16, device=cuda_device)
    w = flat[1:].view(3, 3, 16, 16)
    before = conv3x3.conv3x3_fwd.launches
    with pytest.raises(ValueError):
        conv3x3.conv3x3_fwd(x, w)
    assert conv3x3.conv3x3_fwd.launches == before
    with pytest.raises(ValueError):      # dw needs Cout % 16 == 0
        conv3x3.conv3x3_dw(x, torch.zeros((1, 8, 8, 8), dtype=BF16,
                                          device=cuda_device))


def _unet_grads(fused, dtype, device):
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    cfg = Config(input_size=64, base_width=16, batch_size=2,
                 compute_dtype=str(dtype).split(".")[-1], block_pallas=fused)
    algo = SupervisedUNet(cfg, device)
    rng = np.random.default_rng(5)
    batch = {"img": rng.normal(size=(2, 64, 64, 1)).astype(np.float32),
             "msk": rng.integers(0, 5, size=(2, 64, 64))}
    params = algo.init_params(seed=0)
    (_, got), counts = _launches(lambda: algo.value_and_grad(params, batch))
    with ops.plain():
        _, want = algo.value_and_grad(params, batch)
    return got, want, counts


@pytest.mark.parametrize("fused,want_counts", [
    (False, (28, 36, 0, 28, 18, 0)), (True, (1, 0, 9, 1, 0, 9))])
def test_unet_training_step_counts_launches(cuda_device, fused, want_counts):
    """One forward and backward of the U-Net: off, 28 K1 + 18 K2 forward,
    28 K4 + 18 K2 (dx) + 18 K5 backward; on, 9 K3 + 1 K1 forward, 9 K6 +
    1 K4 backward.  Every parameter gets a gradient."""
    got, _, counts = _unet_grads(fused, BF16, cuda_device)
    assert counts == want_counts
    assert all(g is not None and bool(torch.isfinite(g).all())
               for g in got.values())


@pytest.mark.parametrize("fused", [False, True])
def test_unet_gradients_match_plain(cuda_device, fused):
    """Every parameter's gradient from the kernels against the plain path
    on the card, float32 with TF32 off: a kernel path whose backward left a
    parameter without its gradient fails here.  The bound is on
    ||got - want|| / ||want|| per tensor: where a pre-activation lies
    within float32 rounding of 0, the two forwards may take different
    leaky-ReLU branches, and one such element moves a level-0 weight
    gradient by about 1/sqrt(pixels) / sqrt(channels), 3e-3 at 2x64x64."""
    got, want, _ = _unet_grads(fused, F32, cuda_device)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k] is not None, k
        err = float((got[k] - w).norm() / w.norm())
        assert err <= 1e-2, (k, err)


# base_width 8: the 3x3 convs and blocks at 8 channels go to plain PyTorch
# (conv3x3.takes, block.takes).  One forward and backward, unfused: 4
# routed convs (the first and last blocks' two each), 28 K1, 14 K2 forward
# + 14 dx, 28 K4, 14 K5; fused: those two blocks routed to the unfused
# chain (whose 4 convs route too), 7 K3 + their 6 norms and the stem's K1,
# 7 K6 + 7 K4.  Counters: K1, K2, K3, K4, K5, K6, conv routed, block routed.
W8_COUNTS = {False: (28, 28, 0, 28, 14, 0, 4, 0),
             True: (7, 0, 7, 7, 0, 7, 4, 2)}


@pytest.mark.parametrize("fused", [False, True])
def test_train_step_base_width_8(cuda_device, fused):
    """The width the kernels partly refuse trains on the card: one step's
    float32 gradients against the plain path under chip_smoke.py phase 4's
    rules (per tensor max |diff| / max(1, max |plain|) and L2 over all at
    most 1e-3, cosine at least 0.9999), and the routed counts."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    algo = SupervisedUNet(Config(input_size=64, base_width=8, batch_size=2,
                                 compute_dtype="float32", block_pallas=fused),
                          cuda_device)
    rng = np.random.default_rng(8)
    batch = {"img": rng.normal(size=(2, 64, 64, 1)).astype(np.float32),
             "msk": rng.integers(0, 5, size=(2, 64, 64))}
    params = algo.init_params(seed=0)
    routed = (conv3x3.conv3x3, block.basic_block)
    before = [c.routed for c in routed]
    (_, got), counts = _launches(lambda: algo.value_and_grad(params, batch))
    counts += tuple(c.routed - b for c, b in zip(routed, before))
    assert counts == W8_COUNTS[fused]
    with ops.plain():
        _, want = algo.value_and_grad(params, batch)
    assert got.keys() == want.keys()
    diff2 = norm2 = 0.0
    for k, w in want.items():
        g = got[k].double()
        w = w.double()
        assert rel_err(g, w) <= 1e-3, k
        cos = float((g * w).sum() / (g.norm() * w.norm()))
        assert cos >= 0.9999, (k, cos)
        diff2 += float(((g - w) ** 2).sum())
        norm2 += float((w * w).sum())
    assert (diff2 / norm2) ** 0.5 <= 1e-3


MMA = {"dots": conv_mma.conv3x3_dots, "im2col": conv_mma.conv3x3_im2col,
       "im2col2": conv_mma.conv3x3_im2col2}


@pytest.mark.parametrize("strip", [16, 32])
@pytest.mark.parametrize("shape,cout", [((16, 128, 128, 64), 64),
                                        ((4, 64, 64, 32), 32),
                                        ((2, 32, 20, 48), 16)])
@pytest.mark.parametrize("name", list(MMA))
def test_conv_mma(rng, cuda_device, name, shape, cout, strip):
    """The microbench's shape, a narrower one, and one whose W is not a
    multiple of 16 (Cout 16, C 48): bf16, one rounding of the f32 sum in
    both, so within one bf16 unit of max |plain| (2^-7 of it)."""
    x = t((0.1 * rng.normal(size=shape)).astype(np.float32), BF16,
          cuda_device)
    w = t(conv_w(rng, 3, shape[-1], cout, std=0.05), BF16, cuda_device)
    fn = MMA[name]
    before = fn.launches
    got = fn(x, w, strip).float()
    assert fn.launches == before + 1
    with ops.plain():
        want = fn(x, w, strip).float()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 8e-3, err


# the shapes of tests/cuda_emu/conv3x3_mma_check.cpp: B, H, W, C, Cout,
# strip (W 20, 130, 3, 72 and 200 ragged against 16- and 64-pixel tiles,
# 200 in two column segments; Cout 16-128; C 16-128)
EMU_SHAPES = ((2, 8, 20, 16, 16, 4), (1, 8, 16, 32, 48, 8),
              (1, 4, 16, 64, 64, 2), (1, 16, 24, 48, 32, 16),
              (1, 4, 130, 16, 16, 2), (1, 4, 16, 16, 128, 4),
              (1, 2, 3, 16, 32, 1), (1, 3, 72, 32, 64, 1),
              (1, 2, 200, 16, 32, 2), (1, 4, 16, 128, 64, 4))


@pytest.mark.parametrize("shape", EMU_SHAPES)
@pytest.mark.parametrize("name", list(MMA))
def test_conv_mma_at_the_emulation_shapes(rng, cuda_device, name, shape):
    """Every shape the emulation runs; the im2col pair refuses C over 64
    (its weight slab of 9C x 64 beside the ring of rows would not fit a
    block's shared memory), as the emulation's check expects."""
    b, h, w, c, cout, strip = shape
    x = t(rng.normal(size=(b, h, w, c)).astype(np.float32), BF16,
          cuda_device)
    wt = t(conv_w(rng, 3, c, cout, std=0.1), BF16, cuda_device)
    if name != "dots" and c > 64:
        with pytest.raises(ValueError):
            MMA[name](x, wt, strip)
        return
    got = MMA[name](x, wt, strip).float()
    with ops.plain():
        want = MMA[name](x, wt, strip).float()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 8e-3, err


@pytest.mark.parametrize("shape,cout", [((16, 128, 128, 64), 64),
                                        ((4, 64, 64, 32), 32),
                                        ((2, 32, 20, 48), 16)])
@pytest.mark.parametrize("name", list(MMA))
def test_conv_mma_im2col_bit_for_bit(rng, cuda_device, name, shape, cout):
    """K7, K8 and K9 use no atomics, and `strip` does not change their
    math (K7 on its Hopper kernel at these shapes, which ignores it): two
    runs, and strip 16 against strip 32, give the same bits."""
    x = t((0.1 * rng.normal(size=shape)).astype(np.float32), BF16,
          cuda_device)
    w = t(conv_w(rng, 3, shape[-1], cout, std=0.05), BF16, cuda_device)
    fn = MMA[name]
    first = fn(x, w, 16)
    assert torch.equal(first, fn(x, w, 16))
    assert torch.equal(first, fn(x, w, 32))


@pytest.mark.parametrize("shape,cout,kernel", [
    ((16, 128, 128, 64), 64, "conv_dots_sm90_kernel"),
    ((4, 64, 64, 32), 32, "conv_dots_sm90_kernel"),
    ((1, 4, 16, 128), 64, "conv_dots_kernel")])
def test_conv_mma_dots_route(cuda_device, shape, cout, kernel):
    """K7 runs its Hopper kernel at the microbench's shape and at C 32, and
    the mma.sync kernel at C 128 (an emulation shape): by the route
    function, and by the name of the one kernel the profiler sees."""
    from torch.profiler import ProfilerActivity, profile

    assert conv_mma.dots_route(*shape, cout) == kernel
    x = torch.randn(shape, device=cuda_device).to(BF16)
    w = (0.05 * torch.randn((3, 3, shape[-1], cout),
                            device=cuda_device)).to(BF16)
    conv_mma.conv3x3_dots(x, w, 4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        conv_mma.conv3x3_dots(x, w, 4)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if "conv_dots" in e.key and e.self_device_time_total > 0]
    assert len(names) == 1 and kernel + ("(" if "sm90" in kernel else "<") \
        in names[0], names


def test_conv_mma_counts_launches(cuda_device):
    x = torch.randn((2, 32, 32, 32), device=cuda_device).to(BF16)
    w = (0.05 * torch.randn((3, 3, 32, 32), device=cuda_device)).to(BF16)
    before = [f.launches for f in MMA.values()]
    for f in MMA.values():
        f(x, w)
        f(x, w, strip=32)
        with ops.plain():
            f(x, w)
    assert [f.launches - b for f, b in zip(MMA.values(), before)] == [2] * 3


def test_conv_mma_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros((1, 32, 16, 16), dtype=BF16, device=cuda_device)
    w = torch.zeros((3, 3, 16, 16), dtype=BF16, device=cuda_device)
    for f in MMA.values():
        with pytest.raises(TypeError):       # float32 is not taken
            f(x.float(), w.float())
        with pytest.raises(ValueError):      # Cout 8
            f(x, torch.zeros((3, 3, 16, 8), dtype=BF16, device=cuda_device))
        with pytest.raises(ValueError):      # C 8
            f(x[..., :8].contiguous(), w[:, :, :8].contiguous())
        with pytest.raises(ValueError):      # H % strip != 0
            f(x, w, strip=12)
        with pytest.raises(ValueError):      # weight dtype differs
            f(x, w.float())


def test_microbench_runs_on_the_card(cuda_device):
    from smsut_tpu_torch.tools import microbench_conv

    rows = microbench_conv.main(["1", "2"])
    assert [r["name"] for r in rows] == [n for n, _ in
                                         microbench_conv.candidates()]
    assert all(r["rel_err"] <= microbench_conv.REL_TOL and r["us"] > 0
               for r in rows)


def _second_order(fn, inputs, plain):
    """Gradients in ``inputs`` of the squared norm of fn's input gradient
    (a gradient penalty): the double backward, kernel path or plain."""
    leaves = [x.detach().clone().requires_grad_() for x in inputs]
    with ops.plain() if plain else contextlib.nullcontext():
        y = fn(*leaves)
        g, = torch.autograd.grad((y.float() * y.float().sin()).sum(),
                                 leaves[0], create_graph=True)
        return torch.autograd.grad(g.float().square().sum(), leaves)


@pytest.mark.parametrize("dtype,tol", [(F32, 1e-4), (BF16, 0.03)])
def test_conv3x3_double_backward(rng, cuda_device, dtype, tol):
    """The second order of the 3x3 conv runs K2 and K5 and agrees with the
    plain path."""
    x = t(rng.standard_normal((2, 32, 32, 16)), dtype, cuda_device)
    w = t(conv_w(rng, 3, 16, 32), dtype, cuda_device)
    before = (conv3x3.conv3x3_fwd.launches, conv3x3.conv3x3_dw.launches)
    got = _second_order(conv3x3.conv3x3, (x, w), False)
    assert (conv3x3.conv3x3_fwd.launches - before[0] >= 4
            and conv3x3.conv3x3_dw.launches - before[1] >= 2)
    want = _second_order(conv3x3.conv3x3, (x, w), True)
    for a, b in zip(got, want):
        assert rel_err(a, b) <= tol


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("dtype,tol", [(F32, 1e-4), (BF16, 0.05)])
def test_instnorm_double_backward(rng, cuda_device, act, dtype, tol):
    """The second order of the instance norm: K1 and K4 at first order,
    the plain terms of ``_InstanceNormBwd`` at second, against the plain
    path."""
    x = t(rng.standard_normal((2, 32, 32, 16)), dtype, cuda_device)
    s, b = (t(a, F32, cuda_device) for a in norm_params(rng, 16))
    fn = lambda x, s, b: instnorm.instance_norm(x, s, b, act)
    before = (instnorm.instance_norm_fwd.launches,
              instnorm.instance_norm_bwd.launches,
              instnorm.instance_norm.double_backward)
    got = _second_order(fn, (x, s, b), False)
    assert (instnorm.instance_norm_fwd.launches > before[0]
            and instnorm.instance_norm_bwd.launches > before[1]
            and instnorm.instance_norm.double_backward > before[2])
    want = _second_order(fn, (x, s, b), True)
    for a, w in zip(got, want):
        assert rel_err(a, w) <= tol


def test_discriminator_gradient_penalty(cuda_device):
    """The GP's D-parameter gradients of a w16 discriminator at 64^2,
    float32, kernels against the plain path; every 3x3 conv but
    ``conv_src`` is taken."""
    from smsut_tpu_torch.models.ugan import Discriminator

    D = Discriminator(64, 4, 16, 256, compute_dtype=F32, device=cuda_device,
                      seed=3)
    x = torch.randn((4, 64, 64, 1), device=cuda_device)
    runs = []
    for plain in (False, True):
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in D.state_dict().items()}
        xh = x.clone().requires_grad_()
        routed = conv3x3.conv3x3.routed
        with ops.plain() if plain else contextlib.nullcontext():
            src, _ = torch.func.functional_call(D, params, (xh,))
            g, = torch.autograd.grad(src.sum(), xh, create_graph=True)
            gp = (g.reshape(4, -1).norm(dim=1) - 1).square().mean()
            # the class head and the stem's bias do not reach g
            runs.append(torch.autograd.grad(gp, list(params.values()),
                                            allow_unused=True))
        assert conv3x3.conv3x3.routed - routed == 1
    for a, b in zip(*runs):
        assert (a is None) == (b is None)
        assert a is None or rel_err(a, b) <= 1e-3


def test_gradient_penalty_base_width_8(cuda_device):
    """The GP's second order at base_width 8 (ROADMAP C4): a conv whose
    Cin is 8 and Cout 16 is taken by the kernels, and its dx's own weight
    gradient (Cout 8) is one K5 does not take, so it runs plain PyTorch,
    counted as routed, instead of raising; the D-parameter gradients
    against the plain path as at width 16."""
    from smsut_tpu_torch.models.ugan import Discriminator

    D = Discriminator(64, 4, 8, 512, compute_dtype=F32, device=cuda_device,
                      seed=3)
    x = torch.randn((4, 64, 64, 1), device=cuda_device)
    runs, routed = [], []
    for plain in (False, True):
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in D.state_dict().items()}
        xh = x.clone().requires_grad_()
        before = conv3x3.conv3x3.routed
        with ops.plain() if plain else contextlib.nullcontext():
            src, _ = torch.func.functional_call(D, params, (xh,))
            g, = torch.autograd.grad(src.sum(), xh, create_graph=True)
            gp = (g.reshape(4, -1).norm(dim=1) - 1).square().mean()
            runs.append(torch.autograd.grad(gp, list(params.values()),
                                            allow_unused=True))
        routed.append(conv3x3.conv3x3.routed - before)
    assert routed[0] > routed[1] >= 1
    for a, b in zip(*runs):
        assert (a is None) == (b is None)
        assert a is None or rel_err(a, b) <= 1e-3


# ------------------------------------------------- CUDA graphs of the dispatch
# train/graphs.py Replay: one replay against the eager call, per path


def _ellipses(rng, b, hw):
    """Labelled ellipses and their noisy image: a batch the loss falls on."""
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    msk = np.zeros((b, hw, hw), np.int64)
    for i in range(b):
        for lab in range(1, 5):
            cy, cx = rng.uniform(0.2, 0.8, 2) * hw
            ry, rx = rng.uniform(0.1, 0.2, 2) * hw
            msk[i][((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = lab
    img = msk * 0.2 - 0.5 + rng.normal(0, 0.1, msk.shape)
    return {"img": img[..., None].astype(np.float32), "msk": msk}


@pytest.mark.parametrize("fused", [False, True])
def test_unet_iteration_replays_as_eager(rng, cuda_device, fused):
    """Five float32 iterations of the U-Net (w16, 64^2, batch 2) replayed
    as a CUDA graph against five eager ones from one init: the same losses
    and parameters (the same kernels on the same inputs), and the replays'
    launches counted as the eager iterations' (the capture counts nothing,
    each replay adds what the capture saw)."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.tools.profile_step import iteration
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    algo = SupervisedUNet(Config(input_size=64, base_width=16, batch_size=2,
                                 compute_dtype="float32", block_pallas=fused),
                          cuda_device)
    inp = algo.inputs(_ellipses(rng, 2, 64))
    states = [algo.init_state(0), algo.init_state(0)]
    losses, counts = [], []
    for st, capture in zip(states, (False, True)):
        run = iteration(algo, st, inp, capture=capture)
        before = ops.counts()
        losses.append([float(run()["loss"]) for _ in range(5)])
        counts.append([a - b for a, b in zip(ops.counts(), before)])
    assert losses[0] == losses[1] and losses[1][-1] < losses[1][0]
    assert counts[0] == counts[1] and any(counts[1])
    for k, v in states[0].params.items():
        assert torch.allclose(states[1].params[k], v, rtol=1e-5,
                              atol=1e-6), k
    assert states[1].step == int(states[1].count) == 5


def _clone_gan_state(st):
    import dataclasses

    from smsut_tpu_torch.train.state import AdamState

    tree = lambda t: {k: v.clone() for k, v in t.items()}
    return dataclasses.replace(
        st, g_params=tree(st.g_params), g_opt_state=tree(st.g_opt_state),
        d_params=tree(st.d_params), count=st.count.clone(),
        d_opt_state=AdamState(st.d_opt_state.count.clone(),
                              tree(st.d_opt_state.mu),
                              tree(st.d_opt_state.nu)))


def test_gan_iteration_replays_as_eager(cuda_device):
    """Four float32 uganConsis iterations (w8, 64^2, 2 + 2) replayed, each
    against an eager step on a copy of the state before it (float32 chaos
    would part two free runs): the losses within chip_smoke.py 7b's rtol
    5e-3 / atol 2e-3.  The consistency gate opens at step 2 on the device
    count, so G_semi is 0, 0, then positive; ``lambda_semi`` changes at
    step 2 in the device scalar the replay reads, so there the replayed
    generator lies at least 10x nearer the eager step with the new weight
    than the one with the old."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.graphs import Replay
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    cfg = Config(input_size=64, base_width=8, batch_size=2, nce_patches=4,
                 compute_dtype="float32", consis_gate_step=2)
    algo = UGANConsisAlgo(cfg, cuda_device)
    r = np.random.default_rng(3)
    batch = {"img": r.normal(size=(2, 64, 64, 1)).astype(np.float32),
             "msk": r.integers(0, 5, (2, 64, 64)), "mdl": np.ones(2, int),
             "ul_img": r.normal(size=(2, 64, 64, 1)).astype(np.float32),
             "ul_mdl": np.full(2, 2)}
    inps = [algo.inputs(dict(batch, **algo.make_extra_batch()))
            for _ in range(4)]
    st = algo.init_state(0)
    scal = {"lambda_semi": torch.zeros((), device=cuda_device)}
    step = Replay(lambda x: algo.step(st, x, scal), cuda_device)
    host = lambda m: {k: float(v) for k, v in m.items()}

    def eager(state, inp, lam):
        return host(algo.step(state, inp, {"lambda_semi": torch.tensor(
            lam, device=cuda_device)}))

    gate = []
    for i, inp in enumerate(inps):
        lam = 1.0 if i < 2 else 10.0
        before, old = _clone_gan_state(st), _clone_gan_state(st)
        scal["lambda_semi"].fill_(lam)
        got = host(step(inp))
        want = eager(before, inp, lam)
        gate.append(got["G_semi"])
        for k in want:
            assert abs(got[k] - want[k]) <= 2e-3 + 5e-3 * abs(want[k]), (i, k)
        if i == 2:
            eager(old, inp, 1.0)
            near = max(rel_err(st.g_params[k], v)
                       for k, v in before.g_params.items())
            far = max(rel_err(st.g_params[k], v)
                      for k, v in old.g_params.items())
            assert far >= 10 * max(near, 1e-7), (near, far)
    assert gate[:2] == [0.0, 0.0] and all(g > 0 for g in gate[2:])


def test_gan_replays_are_bitwise_under_deterministic_cudnn(cuda_device):
    """Two runs of four float32 uganConsis iterations (w8, 64^2, 2 + 2),
    each replayed from its own graph from one init under
    ``cudnn.deterministic``: the metrics, G and D equal to the bit.  The
    decoders' bilinear upsample is two fixed interpolation products
    (models/layers.py ``upsample_bilinear2``), whose backward adds in a
    fixed order where ``F.interpolate``'s adds with atomics."""
    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.graphs import Replay
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    cfg = Config(input_size=64, base_width=8, batch_size=2, nce_patches=4,
                 compute_dtype="float32", consis_gate_step=0)
    r = np.random.default_rng(4)
    batch = {"img": r.normal(size=(2, 64, 64, 1)).astype(np.float32),
             "msk": r.integers(0, 5, (2, 64, 64)), "mdl": np.ones(2, int),
             "ul_img": r.normal(size=(2, 64, 64, 1)).astype(np.float32),
             "ul_mdl": np.full(2, 2)}
    det = cudnn.deterministic
    cudnn.deterministic = True
    try:
        runs = []
        for _ in range(2):
            algo = UGANConsisAlgo(cfg, cuda_device)
            inp = algo.inputs(dict(batch, **algo.make_extra_batch()))
            st = algo.init_state(0)
            scal = {"lambda_semi": torch.ones((), device=cuda_device)}
            step = Replay(lambda x: algo.step(st, x, scal), cuda_device)
            ms = [{k: float(v) for k, v in step(inp).items()}
                  for _ in range(4)]
            runs.append((ms, st))
    finally:
        cudnn.deterministic = det
    (m0, s0), (m1, s1) = runs
    assert m0 == m1
    for t in ("g_params", "d_params"):
        a, b = getattr(s0, t), getattr(s1, t)
        assert all(torch.equal(a[k], b[k]) for k in a), t


def test_eval_sweep_and_predict_replay_as_eager(cuda_device, tmp_path):
    """The eval sweep from the test set kept on the card, replayed, against
    the eager per-batch sweep (predictions equal, losses within 1e-5), and
    ``predict`` replayed against eager (logits equal)."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.data.dataset import get_label_npys, get_loader
    from smsut_tpu_torch.data.synthetic import make_synthetic_dataset
    from smsut_tpu_torch.serve import export_eval, load_serving
    from smsut_tpu_torch.train.experiment import Experiment
    from smsut_tpu_torch.train.loop import Trainer
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet
    from smsut_tpu_torch.utils.meter import Meter

    root = str(tmp_path / "data")
    make_synthetic_dataset(root, n_patients_per_modality=3, n_slice=5,
                           size=64)
    cfg = Config(base_root=root, expr_root=str(tmp_path / "expr"),
                 input_size=64, base_width=16, batch_size=2, num_workers=1)
    _, gt = get_label_npys(root, "test")
    keys = [f"loss_{i}" for i in range(4)] + ["loss"]
    out = []
    for capture in (False, True):
        trainer = Trainer(SupervisedUNet(cfg, cuda_device),
                          cfg.replace(eval_scan=capture), "train",
                          experiment=Experiment(cfg.expr_root,
                                                f"e{int(capture)}"),
                          capture=capture)
        loader = get_loader(root, "test", 0, 2, cfg=cfg)
        for _ in range(3):   # warm-up, capture, replay
            meter = Meter(keys, [], alpha=1.0)
            _, vols = trainer.validate_epoch(loader, gt, meter)
        meter.update_cur()
        out.append((vols, dict(meter.cur_values)))
        trainer.exp.close()
    assert trainer._eval_replay.graphs == 1
    for k in gt:
        assert np.array_equal(out[0][0][k], out[1][0][k]), k
    for k in keys:
        assert out[1][1][k] == pytest.approx(out[0][1][k], rel=1e-5), k

    algo = SupervisedUNet(cfg.replace(compute_dtype="bfloat16"), cuda_device)
    export_eval(algo, algo.init_params(seed=0), algo.cfg, str(tmp_path / "s"))
    replayed, _ = load_serving(str(tmp_path / "s"), cuda_device)
    eager, _ = load_serving(str(tmp_path / "s"), cuda_device, capture=False)
    x = torch.randn((2, 64, 64, 1), device=cuda_device)
    first = [replayed(x + i) for i in range(3)]
    for i, y in enumerate(first):
        assert torch.equal(y, eager(x + i)), i


def test_failed_capture_raises(cuda_device):
    """A step that waits on the card cannot be captured: the replay's
    capture raises (the last test of the file: the capture stream's state
    after a refused capture is not relied on)."""
    from smsut_tpu_torch.train.graphs import Replay

    def waits(inp):
        x = inp["x"] * 2
        return {"n": torch.tensor(float(x.sum()), device=cuda_device)}

    step = Replay(waits, cuda_device)
    x = torch.ones(4, device=cuda_device)
    step({"x": x})                      # the eager warm-up
    with pytest.raises(RuntimeError):
        step({"x": x})                  # the capture


# ------------------------------------------------- the semi-supervised zoo
# Mean Teacher, cross-pseudo supervision and CoraNet's two stages: each
# iteration replayed against eager, and one step against the plain path

ZOO = ("meanTeacher", "crossPse", "coraPre", "coraCora")
# the device count each starts at: Mean Teacher's gate and EMA alpha flip
# at 100, CoraNet stage B's gate at 1000, inside five iterations
ZOO_START = {"meanTeacher": 98, "crossPse": 0, "coraPre": 98,
             "coraCora": 998}


def _zoo(name, device, fused=False, dtype="float32", hw=64, bs=2):
    """(algorithm, step inputs on the card, epoch scalars as 0-d device
    tensors) at w16: labelled and unlabelled ellipses, and for CoraNet's
    stage B a pseudo batch with a random certainty mask.  Mean Teacher
    draws its teacher noise on the card from the count."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.steps.coranet import CoraNet
    from smsut_tpu_torch.train.steps.cross_pseudo import CrossPseudo
    from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher

    cfg = Config(input_size=hw, base_width=16, batch_size=bs,
                 compute_dtype=dtype, block_pallas=fused)
    algo = {"meanTeacher": lambda: MeanTeacher(cfg, device),
            "crossPse": lambda: CrossPseudo(cfg, device),
            "coraPre": lambda: CoraNet(cfg, device, stage="pre"),
            "coraCora": lambda: CoraNet(cfg, device, stage="cora")}[name]()
    rng = np.random.default_rng(4)
    batch = dict(_ellipses(rng, bs, hw), ul_img=_ellipses(rng, bs, hw)["img"])
    if name == "coraCora":
        p = _ellipses(rng, bs, hw)
        batch.update(pse_img=p["img"], pse_lab=p["msk"],
                     pse_mask=(rng.random((bs, hw, hw)) < 0.7).astype(
                         np.float32))
    scalars = {k: torch.tensor(float(v), device=device)
               for k, v in algo.epoch_scalars(3).items()}
    return algo, algo.inputs(batch), scalars


def _at(state, count):
    state.step = count
    state.count.fill_(count)
    return state


_TREES = ("params", "ema_params", "params2")


@pytest.mark.parametrize("name", ZOO)
def test_zoo_iteration_replays_as_eager(cuda_device, name):
    """Five float32 iterations (w16, 64^2, 2 + 2) replayed as a CUDA graph
    against five eager ones from one init, across the gates: the same
    metrics, the parameters (and EMA, and net 2) within 1e-5, the replays'
    launches counted as the eager iterations'."""
    from smsut_tpu_torch.tools.profile_step import iteration

    algo, inp, scal = _zoo(name, cuda_device)
    states = [_at(algo.init_state(0), ZOO_START[name]) for _ in range(2)]
    metrics, counts = [], []
    for st, capture in zip(states, (False, True)):
        run = iteration(algo, st, inp, scal, capture=capture)
        before = ops.counts()
        metrics.append([{k: float(v) for k, v in run().items()}
                        for _ in range(5)])
        counts.append([a - b for a, b in zip(ops.counts(), before)])
    assert metrics[0] == metrics[1]
    assert counts[0] == counts[1] and any(counts[1])
    for tree in _TREES:
        a, b = getattr(states[0], tree), getattr(states[1], tree)
        assert (a is None) == (b is None)
        for k, v in (a or {}).items():
            assert torch.allclose(b[k], v, rtol=1e-5, atol=1e-6), (tree, k)
    if name == "meanTeacher":   # the gate opens and alpha leaves 0 at 100
        semi = [m["semi_loss"] for m in metrics[1]]
        assert semi[:2] == [0.0, 0.0] and all(s > 0 for s in semi[2:])
        assert metrics[1][1]["alpha"] == 0 and metrics[1][2]["alpha"] > 0.98
    if name == "coraCora":
        cert = [m["certain_loss"] for m in metrics[1]]
        assert cert[:2] == [0.0, 0.0] and all(c > 0 for c in cert[2:])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", ZOO)
def test_zoo_step_matches_plain(cuda_device, name, fused):
    """One float32 step past the gates, kernels against the plain path on
    the card from one state: the metrics within 1e-3, and every tensor's
    update (the SGD step, so the gradient) within 1e-2 of its L2 norm, as
    test_unet_gradients_match_plain holds the U-Net's gradients."""
    algo, inp, scal = _zoo(name, cuda_device, fused)
    runs = []
    for plain in (False, True):
        st = _at(algo.init_state(0), max(ZOO_START[name] + 2, 0))
        before = {k: v.clone() for k, v in st.params.items()}
        with ops.plain() if plain else contextlib.nullcontext():
            m = algo.step(st, inp, scal)
        runs.append(({k: float(v) for k, v in m.items()},
                     {k: st.params[k] - v for k, v in before.items()}))
    (mk, dk), (mp, dp) = runs
    for k, w in mp.items():
        assert abs(mk[k] - w) <= 1e-3 * max(1.0, abs(w)), (k, mk[k], w)
    for k, w in dp.items():
        err = float((dk[k] - w).norm() / max(float(w.norm()), 1e-30))
        assert err <= 1e-2, (k, err)


# ------------------------------------------ the dual-task U-Net and M3L
# DTCUNet runs K1-K6 (K2 and K5 under batch norm too); M3L's SegFormer
# runs none of the port's kernels, and is held against the CPU and its
# own eager path

DTC_CONFIGS = [("batch", "relu", False), ("instance", "lrelu", False),
               ("instance", "lrelu", True)]


def _dtc_launches(norm, fused):
    """K1, K2, K3, K4, K5, K6 launches of one forward and one backward."""
    if norm == "instance" and fused:
        return (1, 0, 9, 0, 0, 0), (0, 0, 0, 1, 0, 9)
    k1 = 28 if norm == "instance" else 0
    return (k1, 18, 0, 0, 0, 0), (0, 18, 0, k1, 18, 0)


def _dtc_pass(net, x, cots, plain):
    counters = (instnorm.instance_norm_fwd, conv3x3.conv3x3_fwd,
                block.basic_block_fwd, instnorm.instance_norm_bwd,
                conv3x3.conv3x3_dw, block.basic_block_bwd)
    count = lambda: tuple(c.launches for c in counters)
    params = dict(net.named_parameters())
    with ops.plain() if plain else contextlib.nullcontext():
        c0 = count()
        o1, o2 = net(x)
        c1 = count()
        loss = ((o1 * cots[0].to(o1.dtype)).sum()
                + (o2 * cots[1].to(o2.dtype)).sum())
        grads = torch.autograd.grad(loss, list(params.values()))
        c2 = count()
    fwd = tuple(b - a for a, b in zip(c0, c1))
    bwd = tuple(b - a for a, b in zip(c1, c2))
    return (o1, o2), dict(zip(params, grads)), fwd, bwd


@pytest.mark.parametrize("norm,act,fused", DTC_CONFIGS)
def test_dtc_launches_and_gradients_match_plain(cuda_device, norm, act,
                                                fused):
    """DTCUNet at w16, 64^2, batch 2, float32: the launches of a forward
    and a backward over both heads, the heads within 1e-3 of the plain
    path, and the gradients held as chip_smoke.py 10a holds them: per
    tensor cosine against the plain path at least 0.9999, and over all
    tensors no further from a float64 plain run than 2x the float32 plain
    path's distance + 1e-3 (ReLU's gate makes a pre-activation within
    rounding of 0 a flip of its element's gradient)."""
    from smsut_tpu_torch.models.dtc import DTCUNet

    rng = np.random.default_rng(12)
    x = t(rng.normal(size=(2, 64, 64, 1)), device=cuda_device)
    cots = [t(rng.normal(size=(2, 64, 64, 3)), device=cuda_device)
            for _ in range(2)]
    make = lambda dt: DTCUNet(3, 16, norm_type=norm, act_type=act,
                              compute_dtype=dt, block_fused=fused,
                              device=cuda_device, seed=0)
    net = make(F32)
    kern = _dtc_pass(net, x, cots, False)
    plain = _dtc_pass(net, x, cots, True)
    exact = _dtc_pass(make(torch.float64).double(), x.double(), cots, True)
    assert (kern[2], kern[3]) == _dtc_launches(norm, fused)
    for a, w in zip(kern[0], plain[0]):
        assert rel_err(a, w) <= 1e-3
    dist = lambda g: sum(float(((g[k].double() - v) ** 2).sum())
                         for k, v in exact[1].items()) ** 0.5
    ref = sum(float((v ** 2).sum()) for v in exact[1].values()) ** 0.5
    assert dist(kern[1]) <= 2 * dist(plain[1]) + 1e-3 * ref
    for k, w in plain[1].items():
        g = kern[1][k]
        cos = float((g.double() * w.double()).sum()
                    / (g.double().norm() * w.double().norm()))
        assert cos >= 0.9999, (k, cos)


def _m3l(device, hw=64, bs=2):
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.steps.m3l import M3L

    algo = M3L(Config(input_size=hw, batch_size=bs, compute_dtype="float32"),
               device)
    rng = np.random.default_rng(4)
    batch = dict(_ellipses(rng, bs, hw), ul_img=_ellipses(rng, bs, hw)["img"])
    return algo, batch


def test_m3l_iteration_replays_as_eager(cuda_device):
    """Five float32 M3L iterations (64^2, 2 + 2, the mask drawn on the card
    from the count) replayed as a CUDA graph against five eager ones from
    one init at count 98, under deterministic cuDNN: the metrics, the
    student and the teacher to the bit; the EMA's alpha leaves 0 at 100;
    no launch of the port's kernels."""
    from smsut_tpu_torch.tools.profile_step import iteration

    algo, batch = _m3l(cuda_device)
    inp = algo.inputs(batch)
    scal = {k: torch.tensor(float(v), device=cuda_device)
            for k, v in algo.epoch_scalars(3).items()}
    states = [_at(algo.init_state(0), 98) for _ in range(2)]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        metrics, counts = [], []
        for st, capture in zip(states, (False, True)):
            run = iteration(algo, st, inp, scal, capture=capture)
            before = ops.counts()
            metrics.append([{k: float(v) for k, v in run().items()}
                            for _ in range(5)])
            counts.append([a - b for a, b in zip(ops.counts(), before)])
    finally:
        torch.backends.cudnn.deterministic = det
    assert metrics[0] == metrics[1]
    assert not any(counts[0]) and not any(counts[1])
    for tree in ("params", "ema_params"):
        for k, v in getattr(states[0], tree).items():
            assert torch.equal(getattr(states[1], tree)[k], v), (tree, k)
    alpha = [m["alpha"] for m in metrics[1]]
    assert alpha[:2] == [0.0, 0.0] and alpha[2] == pytest.approx(0.99)


def test_m3l_step_card_matches_cpu(cuda_device):
    """One float32 M3L step (64^2, 2 + 2) on the card and on the CPU from
    the same weights, batch and mask grid, TF32 off: the losses within
    1e-4 relative; the student after Adam's first update, about lr *
    sign(g), flip-aware (within 2.1 lr, under 1% beyond lr)."""
    from smsut_tpu_torch.train.steps.m3l import mask_grid

    card, batch = _m3l(cuda_device)
    cpu, _ = _m3l("cpu")
    params = {k: v.cpu() for k, v in card.init_params(0).items()}
    batch["mask"] = mask_grid(torch.tensor(0), card.grid_shape(4, 64, 64),
                              0).numpy()
    out = []
    for algo in (card, cpu):
        st = algo.state_from_params(params)
        m = algo.step(st, algo.inputs(batch), algo.epoch_scalars(3))
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.cpu() for k, v in st.params.items()}))
    (mg, pg), (mc, pc) = out
    for k in ("loss", "semi_loss"):
        assert abs(mg[k] - mc[k]) <= 1e-4 * abs(mc[k]), (k, mg[k], mc[k])
    lr = card.cfg.lr
    dev = torch.cat([(pg[k] - pc[k]).abs().flatten() for k in pc])
    assert float(dev.max()) <= 2.1 * lr
    assert float((dev > lr).float().mean()) < 0.01


# ------------------------------------------------------------ data parallel
# each rank runs in a child process (``_dp_child``), so that no process
# group outlives its test in this one

def _dp_unet(dtn="float32", size=64, batch=8):
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    cfg = Config(input_size=size, base_width=16, batch_size=batch,
                 compute_dtype=dtn)
    g = np.random.default_rng(7)
    img = g.normal(size=(batch, size, size, 1)).astype(np.float32)
    msk = g.integers(0, cfg.n_class, size=(batch, size, size))
    # no label 1 or 2 in the second half: a rank's Dice alone differs
    half = msk[batch // 2:]
    half[(half == 1) | (half == 2)] = 0
    return SupervisedUNet(cfg), img, msk


def _dp_sha(tree):
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(tree[k].float().cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_child():
    """One child of the data-parallel card tests; prints one JSON line.
    ``SMSUT_DP_MODE=world1``: five replays of the float32 U-Net iteration
    with no group, then in a group of one over NCCL, the parameters'
    sha256 of each; ``ranks``: this rank's three eager steps on its rows
    (gloo, the group from the SMSUT_* variables)."""
    import json
    import os
    import socket

    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.parallel import distributed
    from smsut_tpu_torch.parallel.mesh import mean_over_ranks
    from smsut_tpu_torch.tools.profile_step import iteration

    cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    algo, img, msk = _dp_unet()
    out = {}
    if os.environ["SMSUT_DP_MODE"] == "world1":
        inp = algo.inputs({"img": img, "msk": msk})
        for name in ("alone", "grouped"):
            if name == "grouped":
                with socket.socket() as s:
                    s.bind(("127.0.0.1", 0))
                    port = s.getsockname()[1]
                distributed.initialize(f"localhost:{port}", 1, 0)
                out["backend"] = distributed.backend()
            state = algo.init_state(0)
            run = iteration(algo, state, inp)
            for _ in range(7):
                run()
            out[name] = _dp_sha(state.params)
    else:
        distributed.initialize()
        sl = distributed.local_batch_slice(algo.cfg.batch_size)
        state = algo.init_state(0)
        batch = {"img": img[sl], "msk": msk[sl]}
        losses = []
        for _ in range(3):
            state, m = algo.train_step(state, batch)
            losses.append(float(mean_over_ranks(m["loss"])))
        out = {"backend": distributed.backend(), "losses": losses,
               "sha": _dp_sha(state.params),
               "checksum": float(sum(float(v.double().abs().sum())
                                     for v in state.params.values()))}
    print("DP " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


def _dp_run(envs, child="_dp_child"):
    import json
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import test_torch_cuda as t; t.{child}()"],
        cwd=here, env=dict(os.environ, PYTHONPATH=os.path.dirname(here),
                           **env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for env in envs]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads([x for x in out.splitlines()
                                if x.startswith("DP ")][-1][3:]))
    return outs


def test_dp_world1_replays_equal_no_group(cuda_device):
    """chip_smoke.py 11a at 64^2: five float32 replays of the U-Net
    iteration in a group of one over NCCL (the gradient all-reduce and
    the batch Dice's sums captured in the graph) leave the parameters of
    the run with no group, to the bit."""
    out, = _dp_run([{"SMSUT_DP_MODE": "world1"}])
    assert out["backend"] == "nccl"
    assert out["grouped"] == out["alone"]


def test_dp_two_ranks_unet_matches_one_process(cuda_device):
    """chip_smoke.py 11b's U-Net case at 64^2: two ranks of 4 rows sharing
    the card over gloo, three eager float32 steps, against one process at
    the global batch of 8: the loss within 1e-4, the parameter checksum
    within 1e-5 relative, both ranks' parameters equal to the bit."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    r0, r1 = _dp_run([{"SMSUT_DP_MODE": "ranks",
                       "SMSUT_COORDINATOR": f"127.0.0.1:{port}",
                       "SMSUT_NUM_PROCESSES": "2",
                       "SMSUT_PROCESS_ID": str(r)} for r in range(2)])
    assert r0["backend"] == r1["backend"] == "gloo"
    assert r0["sha"] == r1["sha"] and r0["losses"] == r1["losses"]
    algo, img, msk = _dp_unet()
    state = algo.init_state(0)
    for _ in range(3):
        state, m = algo.train_step(state, {"img": img, "msk": msk})
    cksum = float(sum(float(v.double().abs().sum())
                      for v in state.params.values()))
    assert abs(r0["losses"][-1] - float(m["loss"])) < 1e-4
    assert abs(r0["checksum"] - cksum) / max(abs(cksum), 1.0) < 1e-5


# ------------------------------------------------- the zoo on the model axis
# chip_smoke.py 17a at 64^2: each rank of a 1 x 2 group runs in a child
# process (``_tp_zoo_child``), so that no process group outlives its test

TP_ZOO = ("meanTeacher", "crossPse", "coraPre", "coraCora", "M3L", "dtc")


def _tp_zoo_run(name, device, shard=lambda t: t, shards=frozenset()):
    """Two float32 eager steps of zoo run ``name`` at 64^2 (U-Nets w16 at
    4 + 4 from ZOO_START's counts, M3L at its defaults at 2 + 2, one
    step; DTC w16 with batch norm at batch 4, SGD) on the state made by
    ``shard``: the losses, the whole trees' checksum and sha, M3L's step-1
    gradient's checksum (from Adam's first moment), and this process's
    launches of the port's kernels."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.parallel import mesh
    from smsut_tpu_torch.parallel.mesh import mean_over_ranks

    counters = (instnorm.instance_norm_fwd, instnorm.instance_norm_bwd,
                conv3x3.conv3x3_fwd, conv3x3.conv3x3_dw,
                block.basic_block_fwd, block.basic_block_bwd)
    for c in counters:
        c.launches = 0
    rng = np.random.default_rng(4)
    losses, trees = [], []
    out = {}
    if name == "dtc":
        from smsut_tpu_torch.models.dtc import DTCUNet
        from smsut_tpu_torch.ops.losses import dice_and_ce_loss

        net = DTCUNet(5, 16, compute_dtype=F32, device=device)
        params = shard({k: v.detach().clone()
                        for k, v in net.named_parameters()})
        b = _ellipses(rng, 4, 64)
        x = torch.from_numpy(b["img"]).to(device)
        msk = torch.from_numpy(b["msk"]).to(device)
        for _ in range(2):
            leaves = {k: v.requires_grad_() for k, v in params.items()}
            tanh, logits = torch.func.functional_call(net, leaves, (x,))
            target = 2.0 * torch.nn.functional.one_hot(msk, 5).float() - 1.0
            loss = dice_and_ce_loss(logits, msk) + (tanh - target).square(
            ).mean()
            grads = mesh.reduce_gradients_(dict(zip(
                leaves, torch.autograd.grad(loss, list(leaves.values())))),
                shards)
            params = {k: (v - 0.01 * grads[k]).detach()
                      for k, v in leaves.items()}
            losses.append(float(mean_over_ranks(loss.detach())))
        trees = [mesh.gather_tree(params, shards)]
    else:
        if name == "M3L":
            from smsut_tpu_torch.train.steps.m3l import M3L

            algo = M3L(Config(input_size=64, batch_size=2,
                              compute_dtype="float32"), device)
            batch = dict(_ellipses(rng, 2, 64),
                         ul_img=_ellipses(rng, 2, 64)["img"])
            inp, scal, start, steps = algo.inputs(batch), \
                algo.epoch_scalars(3), 98, 1
        else:
            algo, inp, scal = _zoo(name, device, bs=4)
            start, steps = ZOO_START[name], 2
        state = shard(_at(algo.init_state(0), start))
        for _ in range(steps):
            state, m = algo.train_step(state, inp, scal)
            losses.append({k: float(mean_over_ranks(v.detach()))
                           for k, v in m.items()})
        trees = [mesh.gather_tree(getattr(state, t), state.shards)
                 for t in _TREES if getattr(state, t) is not None]
        if name == "M3L":
            mu = mesh.gather_tree(state.opt_state.mu, state.shards)
            out["grad_sum"] = float(sum(float(v.double().abs().sum())
                                        for v in mu.values())) / (
                1.0 - state.tx.b1)
    out.update(losses=losses, sha=[_dp_sha(t) for t in trees],
               checksum=float(sum(float(v.double().abs().sum())
                                  for t in trees for v in t.values())),
               launches=[c.launches for c in counters])
    return out


def _tp_zoo_child():
    """One rank of the zoo's model-axis card tests (the group from the
    SMSUT_* variables, laid out as 1 x 2): :func:`_tp_zoo_run` of
    ``SMSUT_TP_ZOO`` on the sharded state; prints one JSON line."""
    import json
    import os

    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.parallel import distributed, mesh

    cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    distributed.initialize()
    layout = mesh.make_mesh_2d(1, 2)
    name = os.environ["SMSUT_TP_ZOO"]
    shards = frozenset()
    if name == "dtc":
        from smsut_tpu_torch.models.dtc import DTCUNet

        shards = mesh.sharded_keys({k: v.shape for k, v in DTCUNet(
            5, 16, device="cpu").named_parameters()}, 2)
    out = _tp_zoo_run(name, "cuda",
                      lambda t: mesh.shard_params_channelwise(layout, t),
                      shards)
    out.update(backend=distributed.backend(),
               model=distributed.model_count(), shards=len(shards))
    print("DP " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("name", TP_ZOO)
def test_tp_zoo_two_ranks_match_one_process(cuda_device, name):
    """chip_smoke.py 17a at 64^2: two ranks sharing the card over gloo at
    dp x tp = 1 x 2, each holding the output-channel shards of every
    eligible weight and of its EMA, second net and optimizer state, two
    eager float32 steps (M3L one) against one process at the global batch
    under deterministic cuDNN: every metric within 1e-4 (M3L's losses
    relative) and the checksum of the whole trees within 1e-5 relative
    (M3L: its step-1 gradient's, Adam's sign step flipping near-zero
    gradients); both ranks' trees equal to the bit; a rank launched the
    port's norm and conv kernels (DTC with batch norm the convs alone, M3L
    none)."""
    import socket

    import torch.backends.cudnn as cudnn

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    r0, r1 = _dp_run([{"SMSUT_TP_ZOO": name,
                       "SMSUT_COORDINATOR": f"127.0.0.1:{port}",
                       "SMSUT_NUM_PROCESSES": "2",
                       "SMSUT_PROCESS_ID": str(r)} for r in range(2)],
                     "_tp_zoo_child")
    assert r0["backend"] == r1["backend"] == "gloo" and r0["model"] == 2
    assert r0["sha"] == r1["sha"] and r0["losses"] == r1["losses"]
    assert r0["launches"] == r1["launches"]
    det = cudnn.deterministic
    cudnn.deterministic = True
    try:
        want = _tp_zoo_run(name, cuda_device)
    finally:
        cudnn.deterministic = det
    if name == "M3L":
        for k in ("loss", "semi_loss"):
            g, w = r0["losses"][0][k], want["losses"][0][k]
            assert abs(g - w) <= 1e-4 * abs(w), (k, g, w)
        assert abs(r0["grad_sum"] - want["grad_sum"]) <= 1e-5 * abs(
            want["grad_sum"])
        assert not any(r0["launches"])
        return
    got_l, want_l = r0["losses"], want["losses"]
    if name == "dtc":
        got_l, want_l = [{"loss": x} for x in got_l], \
            [{"loss": x} for x in want_l]
        assert r0["shards"] > 0
        assert r0["launches"][2] > 0 and r0["launches"][3] > 0
    else:
        assert min(r0["launches"][:4]) > 0
    for g, w in zip(got_l, want_l):
        for k, v in w.items():
            assert abs(g[k] - v) <= 1e-4, (k, g, w)
    assert abs(r0["checksum"] - want["checksum"]) <= 1e-5 * max(
        abs(want["checksum"]), 1.0)


# K3 and K6 on the space-to-depth packed map (groups 4): (packed Cin,
# packed Cout, packed side) of the w16 packed level-1 encoder block and the
# identity form, batch 8; the norm parameters are [Cout / 4]
PACKED_BLOCKS = ((64, 128, 32), (64, 64, 64))


def _packed_block_args(rng, device, ci, co, hw, dtype):
    args = _block_args(rng, device, ci, co, hw, dtype)
    c = co // 4
    for i in (2, 3, 5, 6) + ((8, 9) if ci != co else ()):
        args[i] = args[i][:c].contiguous()
    return args


@pytest.mark.parametrize("dtype,tol", [(F32, 1e-3), (BF16, 0.05)])
@pytest.mark.parametrize("ci,co,hw", PACKED_BLOCKS)
def test_block_groups4(rng, cuda_device, ci, co, hw, dtype, tol):
    """K3 and K6 with groups 4 (the statistics pooled over each original
    channel's 4 subpixel groups) against their plain versions; each
    launch counted as grouped."""
    args = _packed_block_args(rng, cuda_device, ci, co, hw, dtype)
    fwd = lambda *a: block.basic_block_fwd(*a, save=True, groups=4)
    before = block.basic_block_fwd.grouped
    got, res = fwd(*args)
    assert block.basic_block_fwd.grouped == before + 1
    with ops.plain():
        want, res_p = fwd(*args)
    assert rel_err(got, want) <= tol
    x_, w1, s1, _, w2, s2, _, ws, ss, _ = args
    g = t(rng.standard_normal((8, hw, hw, co)).astype(np.float32), dtype,
          cuda_device)
    bargs = (g, x_, w1, s1, w2, s2, ws, ss, res)
    gb = block.basic_block_bwd.grouped
    got = block.basic_block_bwd(*bargs, groups=4)
    assert block.basic_block_bwd.grouped == gb + 1
    assert got[4].shape == (6, co // 4)
    with ops.plain():
        want = block.basic_block_bwd(*bargs, groups=4)
    for a, w in zip(got, want):
        assert (a is None) == (w is None)
        if a is not None:
            assert rel_err(a, w) <= tol


@pytest.mark.parametrize("ci,co,hw", [(32, 16, 256), (64, 64, 64)])
def test_block_groups1_is_the_default_bit_for_bit(rng, cuda_device, ci, co,
                                                  hw):
    """groups 1 is the unpacked chain: the same bits as a call without the
    argument, and it launches nothing grouped."""
    args = _block_args(rng, cuda_device, ci, co, hw, BF16)
    before = block.basic_block_fwd.grouped
    a, ra = block.basic_block_fwd(*args, save=True)
    b, rb = block.basic_block_fwd(*args, save=True, groups=1)
    # the shortcut norm's rows only in the shortcut form
    norms = 3 if ci != co else 2
    assert torch.equal(a, b) and torch.equal(ra.gh[:norms], rb.gh[:norms])
    x, w1, s1, _, w2, s2, _, ws, ss, _ = args
    g = t(rng.standard_normal((8, hw, hw, co)).astype(np.float32), BF16,
          cuda_device)
    ga = block.basic_block_bwd(g, x, w1, s1, w2, s2, ws, ss, ra)
    gb = block.basic_block_bwd(g, x, w1, s1, w2, s2, ws, ss, ra, groups=1)
    for u, v in zip(ga, gb):
        assert (u is None and v is None) or torch.equal(u, v)
    assert block.basic_block_fwd.grouped == before


def test_packed_unet_forward_counts_launches(cuda_device):
    """The w16 U-Net at pack_levels 2, served at 64^2: K2 on every packed
    3x3 conv it takes (the 5x5 stem on one channel packs to Cin 4 and is
    routed), K1 on the packed norms' free view, and with the fused blocks
    K3 with groups 4 at the four packed blocks."""
    from smsut_tpu_torch.models import UNet

    x = torch.zeros((2, 64, 64, 1), device=cuda_device)
    for fused in (False, True):
        net = UNet(5, 16, block_fused=fused, device=cuda_device,
                   pack_levels=2)
        r0 = conv3x3.conv3x3.routed
        g0 = block.basic_block_fwd.grouped
        with torch.inference_mode():
            out, counts = _launches(lambda: net(x))
        assert out.shape == (2, 64, 64, 5)
        assert conv3x3.conv3x3.routed - r0 == 1
        if fused:
            assert block.basic_block_fwd.grouped - g0 == 4
            assert counts == (1, 0, 9, 0, 0, 0)
        else:
            assert counts == (28, 18, 0, 0, 0, 0)


# K2, K2 as dx and K5 with W-packed kernels (models/packed_w.py) at the w16
# W layouts' shapes: ([B, H, J], pack, original input segments, original
# Cout): the U-Net's level-0 conv2, its level-1 decoder conv1 on two
# segments, the discriminator's second W block's conv1
WPACK_CONVS = (((8, 256, 32), 8, (16,), 16), ((8, 128, 32), 4, (32, 32), 32),
               ((16, 64, 32), 2, (32,), 64))
# K1 and K4 on the W views [B, H, J*p, C]: ([B, H, J], pack, C, act)
WPACK_NORMS = (((8, 256, 32), 8, 16, True), ((16, 128, 32), 4, 32, False))


@pytest.mark.parametrize("dtype,tol", [(F32, 1e-4), (BF16, 0.02)])
@pytest.mark.parametrize("bhj,p,segs,co0", WPACK_CONVS)
def test_wpack_conv3x3_fwd_dx_dw(rng, cuda_device, bhj, p, segs, co0, dtype,
                                 tol):
    """K2 on the W-packed kernel, K2 as its dx (the kernel flipped and
    IO-swapped) and K5, each one launch, against their plain versions."""
    from smsut_tpu_torch.models.packed_w import pack_kernel_w

    ci, co = p * sum(segs), p * co0
    w = t(conv_w(rng, 3, sum(segs), co0), F32, cuda_device)
    wp = pack_kernel_w(w, p, segs).to(dtype)
    x = t(rng.normal(size=bhj + (ci,)).astype(np.float32), dtype, cuda_device)
    g = t(rng.normal(size=bhj + (co,)).astype(np.float32), dtype, cuda_device)
    _held_against_plain(conv3x3.conv3x3_fwd, conv3x3.conv3x3_fwd, (x, wp),
                        tol)
    _held_against_plain(conv3x3.conv3x3_fwd, conv3x3.conv3x3_fwd,
                        (g, conv3x3.flip_io(wp)), tol)
    _held_against_plain(conv3x3.conv3x3_dw, conv3x3.conv3x3_dw, (x, g), tol)


@pytest.mark.parametrize("dtype,tol", [(F32, 1e-4), (BF16, 0.05)])
@pytest.mark.parametrize("bhj,p,c,act", WPACK_NORMS)
def test_wpack_instnorm_on_the_w_view(rng, cuda_device, bhj, p, c, act,
                                      dtype, tol):
    """K1 and K4 on the free W view of a W-packed map (no copy), against
    their plain versions."""
    b, h, j = bhj
    xw = t((rng.normal(size=(b, h, j, p * c)) * 2 + 0.3).astype(np.float32),
           dtype, cuda_device)
    x = xw.reshape(b, h, j * p, c)
    assert x.data_ptr() == xw.data_ptr()
    s, bb = (t(a, device=cuda_device) for a in norm_params(rng, c))
    _held_against_plain(instnorm.instance_norm, instnorm.instance_norm_fwd,
                        (x, s, bb, act), tol)
    g = t(rng.normal(size=x.shape).astype(np.float32), dtype, cuda_device)
    _, mean, rstd = instnorm.instance_norm_fwd(x, s, bb, act)
    args = (x, g, mean, rstd, s, bb, act)
    got, counts = _launches(lambda: instnorm.instance_norm_bwd(*args))
    assert counts == (0, 0, 0, 1, 0, 0)
    with ops.plain():
        want = instnorm.instance_norm_bwd(*args)
    for a, w in zip(got, want):
        assert rel_err(a, w) <= tol


def test_device_rows_match_key_averages(cuda_device):
    """``tools/profile_step.py`` ``device_rows`` sums the profiler's raw
    device events: the same keys, launches and device ms per call as
    ``key_averages()``'s device entries, on two steps of the w16 U-Net
    (hundreds of kernels each)."""
    from torch.autograd import DeviceType

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.tools import profile_step
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    algo = SupervisedUNet(Config(input_size=128, base_width=16,
                                 batch_size=2, compute_dtype="bfloat16"))
    state = algo.init_state(0)
    rng = np.random.default_rng(3)
    batch = {"img": torch.from_numpy(rng.normal(size=(2, 128, 128, 1))
                                     .astype(np.float32)).to(cuda_device),
             "msk": torch.from_numpy(rng.integers(0, 5, (2, 128, 128))
                                     .astype(np.int32)).to(cuda_device)}
    step = lambda: algo.train_step(state, batch)
    step()
    torch.cuda.synchronize()
    seen = []
    real = torch.profiler.profile.__exit__

    def keep(prof, *a):
        out = real(prof, *a)
        seen.append(prof)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler.profile, "__exit__", keep)
        rows, _ = profile_step.device_rows(torch, step, 2)
    want = sorted(((e.key, e.self_device_time_total / 1e3 / 2, e.count // 2)
                   for e in seen[0].key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    assert len(rows) > 10
    assert sorted(r[0] for r in rows) == sorted(r[0] for r in want)
    got = {k: (ms, n) for k, ms, n in rows}
    for k, ms, n in want:
        assert got[k][1] == n
        assert got[k][0] == pytest.approx(ms, rel=1e-9, abs=1e-12)
