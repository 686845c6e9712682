# -*- coding: utf-8 -*-
"""The tensor-core conv kernels of smsut_tpu_torch/csrc/conv3x3_mma.cu on the
CPU: their source, compiled with the host C++ compiler against an
emulation of the CUDA runtime and of the PTX primitives they use
(tests/cuda_emu: ldmatrix, mma.sync m16n8k16 bf16, cp.async, one thread
per CUDA thread), is run and held against a float64 reference within one
bf16 unit (tests/cuda_emu/conv3x3_mma_check.cpp).  This checks the
kernels' own index logic (fragment addressing, the dots ring, the halo,
tiles and masks, the host-side refusal of a shape) where no card is
present; the card itself is in tests/test_torch_cuda.py.

The kernel source is used as it is, with three textual changes: the PTX
primitives of mma_tile.cuh give way to tests/cuda_emu/prims.h, the
dynamic shared memory is the emulation's buffer, and a launch is a call
of the emulation's launcher.
"""
import os
import shutil
import subprocess
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "smsut_tpu_torch" / "csrc"
EMU = Path(__file__).resolve().parent / "cuda_emu"


def _replace(text: str, old: str, new: str, count: int) -> str:
    assert text.count(old) == count, f"expected {count} x {old!r} in the source"
    return text.replace(old, new)


def _generate(out: Path) -> None:
    cu = (CSRC / "conv3x3_mma.cu").read_text()
    cu = _replace(cu, '#include "mma_tile.cuh"', '#include "mma_tile_emu.cuh"',
                  1)
    cu = _replace(cu, "extern __shared__ __align__(16) unsigned char smem[];",
                  "unsigned char* smem = emu_smem;", 2)
    cu = _replace(cu, "kernel<<<grid, kThreads, smem, s>>>(",
                  "emu_launch(kernel, grid, kThreads, smem, s, ", 1)
    (out / "conv3x3_mma_emu.cpp").write_text(cu)
    h = (CSRC / "mma_tile.cuh").read_text()
    h = _replace(h, '#include "common.cuh"',
                 '#include "shim.h"\n#include "prims.h"', 1)
    h = _replace(h, "typedef __nv_bfloat16 bf16;", "", 1)
    start = h.index("__device__ __forceinline__ uint32_t smem_addr(")
    end = h.index("// lane's ldmatrix address of the 16 x 16 A tile")
    (out / "mma_tile_emu.cuh").write_text(h[:start] + h[end:])


@pytest.fixture(scope="module")
def check_binary(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) to build the emulation")
    out = tmp_path_factory.mktemp("cuda_emu")
    _generate(out)
    exe = out / "conv3x3_mma_check"
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", f"-I{out}",
                    f"-I{EMU}", "-o", str(exe),
                    str(EMU / "conv3x3_mma_check.cpp")],
                   check=True, capture_output=True, text=True, timeout=600)
    return exe


@pytest.mark.parametrize("env", [
    {},                        # cp.async lands at once
    {"EMU_DEFER": "1"},        # cp.async lands at its wait
    {"EMU_OPTIN": "120000"},   # a smaller block: some shapes refused
], ids=["copies_at_once", "copies_at_wait", "small_shared_memory"])
def test_conv3x3_mma_kernels_in_emulation(check_binary, env):
    run = subprocess.run([str(check_binary)], env={**os.environ, **env},
                         capture_output=True, text=True, timeout=600)
    lines = run.stdout.splitlines()
    assert run.returncode == 0 and lines[-1] == "OK", run.stdout + run.stderr
    assert "bank-conflicted phases 0" in lines[-2]
    if "EMU_OPTIN" in env:
        assert any("fits 0 " in l for l in lines)
        assert any("fits 1 " in l for l in lines)
