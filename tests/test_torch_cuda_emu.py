# -*- coding: utf-8 -*-
"""The port's tensor-core kernels on the CPU: their source, compiled with
the host C++ compiler against an emulation of the CUDA runtime and of the
PTX primitives they use (tests/cuda_emu: ldmatrix .x4/.x2/.trans, mma.sync
m16n8k16 bf16, cp.async; and Hopper's mbarriers, TMA tiled loads from a
tensor map, wgmma with A in registers or shared memory, and setmaxnreg,
sm90_prims.h; one thread per
CUDA thread), is run and held against a float64 reference by one check
program per source:

- ``csrc/conv3x3_mma.cu``, the three conv candidates of the microbench
  (im2col and im2col2, K8 and K9, on TMA, mbarriers and wgmma,
  ``csrc/conv3x3_im2col_sm90.cuh``; dots, K7, on the same ring with its
  weights in registers and setmaxnreg, ``csrc/conv3x3_dots_sm90.cuh``,
  where C <= 64 and that ring fits, else on mma.sync: each shape's route
  checked), within one bf16 unit
  (tests/cuda_emu/conv3x3_mma_check.cpp), also on three SMs, where each
  Hopper block walks several units and its ring of rows wraps;
- ``csrc/sm90.cuh``'s helpers with the Hopper emulation, unit case by unit
  case against dense references (tests/cuda_emu/sm90_check.cpp), and four
  misuses the emulation must catch (a wait that cannot complete, a wgmma
  without its fence, a setmaxnreg that one warp skips, an inc that no dec
  pays for);
- ``csrc/conv3x3_tc.cuh``, K2's bfloat16 path, at every block shape of
  each case's channel width, within one bf16 unit
  (tests/cuda_emu/conv3x3_tc_check.cpp), and the options that K3's and
  K6's bfloat16 chains use (``EMU_OPTS``): the statistics' partials
  against float64 sums, the norm applied while staging with its zero
  halo, the mask and add epilogues, a float32 output, the 1x1 conv;
- ``csrc/conv3x3_dw_tc.cuh``, K5's bfloat16 path, within 1e-5 of the sum
  of |x * g| of each element, two runs bit for bit
  (tests/cuda_emu/conv3x3_dw_tc_check.cpp), and K6's options: the 1x1
  weight gradient and the norm applied while staging.

This checks the kernels' own index logic (fragment addressing, halos,
channel chunks, tiles and masks, splits, the host-side refusal of a shape)
and that no ldmatrix phase is bank-conflicted, where no card is present;
the card itself is in tests/test_torch_cuda.py.

A kernel source is used as it is, with textual changes only: the PTX
primitives of mma_tile.cuh give way to tests/cuda_emu/prims.h, the dynamic
shared memory is the emulation's buffer, and a launch is a call of the
emulation's launcher.
"""
import os
import shutil
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "smsut_tpu_torch" / "csrc"
EMU = Path(__file__).resolve().parent / "cuda_emu"

SMEM = ("extern __shared__ __align__(16) unsigned char smem[];",
        "unsigned char* smem = emu_smem;")
INCLUDE_MMA = ('#include "mma_tile.cuh"', '#include "mma_tile_emu.cuh"')

# per check program: the kernel sources it includes, each with its
# generated file and the (old, new, count) changes
NORM = [("instnorm.cuh", "instnorm_emu.cuh",
         [(*INCLUDE_MMA, 1), (*SMEM, 3),
          # three tickets: (sample, group) pairs share them at the checks'
          # batch sizes; the checks set the fill and the smallest resident
          # slice (norm_check.h)
          ("constexpr int kNormTickets = 4096;",
           "constexpr int kNormTickets = 3;", 1),
          ("constexpr int kNormFill = 128;", "inline int kNormFill = 128;",
           1),
          ("constexpr int kNormMinResidentBytes = 16 * 1024;",
           "inline int kNormMinResidentBytes = 16 * 1024;", 1)]),
        ("instnorm_bwd.cuh", "instnorm_bwd_emu.cuh",
         [('#include "instnorm.cuh"', '#include "instnorm_emu.cuh"', 1)])]
SOURCES = {
    "conv3x3_mma": [("conv3x3_mma.cu", "conv3x3_mma_emu.cpp",
                     [(*INCLUDE_MMA, 1), (*SMEM, 1),
                      ('#include "conv3x3_im2col_sm90.cuh"',
                       '#include "conv3x3_im2col_sm90_emu.cuh"', 1),
                      ('#include "conv3x3_dots_sm90.cuh"',
                       '#include "conv3x3_dots_sm90_emu.cuh"', 1)]),
                    ("conv3x3_im2col_sm90.cuh", "conv3x3_im2col_sm90_emu.cuh",
                     [(*SMEM, 1),
                      ('#include "sm90.cuh"', '#include "sm90_emu.cuh"', 1)]),
                    ("conv3x3_dots_sm90.cuh", "conv3x3_dots_sm90_emu.cuh",
                     [(*SMEM, 1),
                      ('#include "conv3x3_im2col_sm90.cuh"',
                       '#include "conv3x3_im2col_sm90_emu.cuh"', 1)])],
    "sm90": [],
    "conv3x3_tc": [("conv3x3_tc.cuh", "conv3x3_tc_emu.cuh",
                    [(*INCLUDE_MMA, 1), (*SMEM, 1)])],
    "conv3x3_dw_tc": [("conv3x3_dw_tc.cuh", "conv3x3_dw_tc_emu.cuh",
                       [(*INCLUDE_MMA, 1), (*SMEM, 1),
                        ("dw_tc_reduce_kernel<<<blocks, 256, 0, s>>>(",
                         "emu_launch(dw_tc_reduce_kernel, blocks, 256, 0, s, ",
                         1)])],
    "instnorm": NORM,
    "instnorm_bwd": NORM,
}


def _replace(text: str, old: str, new: str, count: int) -> str:
    assert text.count(old) == count, f"expected {count} x {old!r} in the source"
    return text.replace(old, new)


def _generate(out: Path, files) -> None:
    """Each ``(source, generated, subs)`` of ``files``: ``source`` of csrc
    with the changes ``subs`` as ``generated``; sm90.cuh with its PTX part
    given to the emulation (tests/cuda_emu/sm90_prims.h) as sm90_emu.cuh;
    mma_tile.cuh with its PTX primitives and launch syntax given to the
    emulation as mma_tile_emu.cuh;
    and the scalar helpers of common.cuh (dtype conversion, the leaky ReLU,
    its mask, ``mul_add_rn``, ``norm_act``, the epilogue kinds) as
    common_emu.cuh, into ``out``."""
    for source, generated, subs in files:
        cu = (CSRC / source).read_text()
        for old, new, count in subs:
            cu = _replace(cu, old, new, count)
        (out / generated).write_text(cu)
    c = (CSRC / "common.cuh").read_text()
    start = c.index("namespace smsut {")
    end = c.index("// 4 consecutive elements")
    (out / "common_emu.cuh").write_text(
        "#pragma once\n" + c[start:end] + "}  // namespace smsut\n")
    h = (CSRC / "sm90.cuh").read_text()
    h = _replace(h, "#include <cuda.h>", '#include "sm90_prims.h"', 1)
    h = _replace(h, *INCLUDE_MMA, 1)
    start = h.index("// ---------------------------------------------------------------- PTX")
    end = h.index("// ------------------------------------------------------------ end of PTX")
    (out / "sm90_emu.cuh").write_text(h[:start] + h[end:])
    h = (CSRC / "mma_tile.cuh").read_text()
    h = _replace(h, '#include "common.cuh"',
                 '#include "shim.h"\n#include "common_emu.cuh"\n'
                 '#include "prims.h"', 1)
    h = _replace(h, "typedef __nv_bfloat16 bf16;", "", 1)
    h = _replace(h, "kernel<<<grid, threads, smem, s>>>(args...);",
                 "emu_launch(kernel, grid, threads, smem, s, args...);", 1)
    start = h.index("__device__ __forceinline__ uint32_t smem_addr(")
    end = h.index("// lane's ldmatrix address of the 16 x 16 A tile")
    (out / "mma_tile_emu.cuh").write_text(h[:start] + h[end:])


def _build(tmp_path_factory, name):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) to build the emulation")
    out = tmp_path_factory.mktemp(name)
    _generate(out, SOURCES[name])
    exe = out / f"{name}_check"
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", f"-I{out}",
                    f"-I{EMU}", "-o", str(exe),
                    str(EMU / f"{name}_check.cpp")],
                   check=True, capture_output=True, text=True, timeout=600)
    return exe


def _run(exe, env):
    run = subprocess.run([str(exe)], env={**os.environ, **env},
                         capture_output=True, text=True, timeout=600)
    lines = run.stdout.splitlines()
    assert run.returncode == 0 and lines[-1] == "OK", run.stdout + run.stderr
    assert "bank-conflicted phases 0" in lines[-2]
    return lines


@pytest.fixture(scope="module")
def check_binary(tmp_path_factory):
    return _build(tmp_path_factory, "conv3x3_mma")


@pytest.fixture(scope="module")
def tc_binary(tmp_path_factory):
    return _build(tmp_path_factory, "conv3x3_tc")


@pytest.fixture(scope="module")
def dw_tc_binary(tmp_path_factory):
    return _build(tmp_path_factory, "conv3x3_dw_tc")


ENVS = {"copies_at_once": {},                    # cp.async lands at once
        "copies_at_wait": {"EMU_DEFER": "1"}}     # cp.async lands at its wait


@pytest.mark.parametrize("env", [
    ENVS["copies_at_once"], ENVS["copies_at_wait"],
    {"EMU_OPTIN": "120000"},   # a smaller block: some shapes refused
    {"EMU_SMS": "3"},          # im2col blocks walk several units each
], ids=["copies_at_once", "copies_at_wait", "small_shared_memory",
        "few_sms"])
def test_conv3x3_mma_kernels_in_emulation(check_binary, env):
    lines = _run(check_binary, env)
    wgmma = lines[-3].split(",")
    assert "maps refused 0" in wgmma[2], lines[-3]
    # dots' route per shape ("B1 H4 W16 C128 Cout64 strip4" -> "1")
    routes = {l.split(" variant")[0]: l.split(", route ")[1][0]
              for l in lines if ", route " in l}
    assert len(routes) == 10, routes
    if "EMU_OPTIN" in env:
        # 120 KB: every im2col shape and dots' Hopper ring refused, the
        # mma.sync dots kernel runs the shapes whose slab fits
        assert any("fits 0 " in l for l in lines)
        assert any("fits 1 " in l for l in lines)
        assert sorted(set(routes.values())) == ["0", "1"], routes
        assert wgmma[3] == " setmaxnreg 0", lines[-3]
    else:
        assert wgmma[0] != "wgmma 0", lines[-3]
        assert wgmma[3] != " setmaxnreg 0", lines[-3]
        # dots on the Hopper kernel at C <= 64, on mma.sync at C 128
        for shape, route in routes.items():
            assert route == ("1" if " C128 " in shape else "2"), (shape, route)


@pytest.fixture(scope="module")
def sm90_binary(tmp_path_factory):
    return _build(tmp_path_factory, "sm90")


@pytest.mark.parametrize("case", ["mbarrier", "tma", "wgmma", "setmaxnreg"])
def test_sm90_primitives_in_emulation(sm90_binary, case):
    run = subprocess.run([str(sm90_binary), case], capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0 and run.stdout.splitlines()[-1] == "OK", \
        run.stdout + run.stderr


@pytest.mark.parametrize("case,what", [
    ("deadlock", "waits on a phase that cannot complete"),
    ("unfenced", "without wgmma.fence"),
    ("nreg_warp", "setmaxnreg: every thread waits"),
    ("nreg_unpaid", "setmaxnreg: every thread waits")])
def test_sm90_emulation_catches_misuse(sm90_binary, case, what):
    run = subprocess.run([str(sm90_binary), case], capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 5 and what in run.stderr, \
        run.stdout + run.stderr


@pytest.mark.parametrize("env", [
    ENVS["copies_at_once"], ENVS["copies_at_wait"],
    # channel chunks in two buffers, cp.async landing at its wait; the
    # tallest tiles refused
    {"EMU_OPTIN": "50000", "EMU_DEFER": "1"},
], ids=["copies_at_once", "copies_at_wait", "channel_chunks"])
def test_conv3x3_tc_kernel_in_emulation(tc_binary, env):
    lines = _run(tc_binary, env)
    if "EMU_OPTIN" in env:
        assert any("fits 0 " in l for l in lines)
        assert any("fits 1 " in l for l in lines)
        assert lines[-3] != "chunked runs 0"


@pytest.mark.parametrize("env", [
    ENVS["copies_at_once"], ENVS["copies_at_wait"],
    # the norm applied to chunks double-buffered by cp.async
    {"EMU_OPTIN": "50000", "EMU_DEFER": "1"},
], ids=["copies_at_once", "copies_at_wait", "channel_chunks"])
def test_conv3x3_tc_block_options_in_emulation(tc_binary, env):
    """K3's and K6's convs on the tensor cores: STATS, PRO, KS 1, the mask
    and add epilogues and a float32 output, each at every block shape."""
    lines = _run(tc_binary, {"EMU_OPTS": "1", **env})
    for what in ("stats", "stats+pro", "ks1+stats", "mask", "add",
                 "ks1+f32"):
        assert any(l.startswith(what + " ") for l in lines), what
    if "EMU_OPTIN" in env:
        assert any(l.startswith("stats+pro ") and " chunks 1 " not in l
                   and "fits 1" in l for l in lines)


@pytest.mark.parametrize("env", list(ENVS.values()), ids=list(ENVS))
def test_conv3x3_dw_tc_block_options_in_emulation(dw_tc_binary, env):
    """K6's weight gradients on the tensor cores: the 1x1 conv's (dws) and
    dw2's, with z1 rebuilt from y1 while staging."""
    lines = _run(dw_tc_binary, {"EMU_OPTS": "1", **env})
    for what in ("ks1", "pro"):
        assert any(l.startswith(what + " ") for l in lines), what
    assert any(l.startswith("pro ") and " of 1 tiles" not in l
               for l in lines)


@pytest.mark.parametrize("env", list(ENVS.values()), ids=list(ENVS))
def test_conv3x3_dw_tc_kernel_in_emulation(dw_tc_binary, env):
    lines = _run(dw_tc_binary, env)
    # one split (the block writes dw) and several (the reduce kernel); a
    # split of several tiles (both stage buffers)
    splits = [l.split("(")[1].split(")")[0] for l in lines if "splits of" in l]
    assert any(", 1 splits" in s for s in splits)
    assert any(", 1 splits" not in s and " of 1 tiles" not in s
               for s in splits), splits
