# -*- coding: utf-8 -*-
"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``smsut_tpu_torch/csrc/<name>.cu`` compiles by itself, with ``nvcc``
and no PyTorch headers, into ``build/kernels/lib<name>-<hash>.so`` at the
root of the checkout (listed in ``.gitignore``).  The hash covers the
source, the shared headers and the flags, so an edited kernel is rebuilt
and a stale library is never loaded.  Every C entry point takes its
pointers and the stream as ``void*``, launches on that stream, and returns
``cudaGetLastError()`` after each launch; :func:`check` raises on a
non-zero code, because a refused launch never runs and a later
``synchronize()`` does not report it.

Nothing here runs at import: the CPU test host has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("instnorm", "conv3x3", "block", "instnorm_bwd", "conv3x3_dw",
           "block_bwd", "conv3x3_mma")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
L = ctypes.c_longlong

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str] = SOURCES) -> float:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source, all started together.  Returns the wall seconds."""
    t0 = time.perf_counter()
    todo = [(n, lib_path(n)) for n in names if not lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + out.with_suffix(".log").read_text()[-4000:])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output for ``name`` (``-Xptxas -v``: registers, shared memory
    and spills of every kernel)."""
    p = lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def bind(name: str, fn: str, argtypes: Iterable,
         restype=I) -> ctypes._CFuncPtr:
    f = getattr(library(name), fn)
    f.argtypes = list(argtypes)
    f.restype = restype
    return f


# the C entry points' code for a shape the kernel does not take
# (cudaErrorInvalidValue): nothing was launched
REFUSED = 1


def check(rc: int, what: str, refused: str = "") -> None:
    """Raise on a non-zero code: ``ValueError`` where the entry point
    refused the shape (``REFUSED``) and ``refused`` says what it takes,
    ``RuntimeError`` otherwise."""
    if rc == REFUSED and refused:
        raise ValueError(f"{what}: {refused}")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_of(t) -> int:
    """The current stream of t's device: the capturing stream while a CUDA
    graph is captured, so every launch joins the graph.  The entry points'
    other host calls (the shared-memory and cluster opt-ins, the occupancy
    queries, ``cudaGetLastError``) are no stream work, and the one-time
    ones ran at the graph's eager warm-up."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
