#!/usr/bin/env python
# -*- coding: utf-8 -*-
"""Device time of the U-Net's training step, by kernel family.

:func:`step_profile` profiles a training step with ``torch.profiler``: its
device time, idle share, and the device ms per step of each kernel family
of :data:`FAMILIES` and of each of its functions.  ``chip_smoke.py`` phase
4 reads its steps through it.  Kernels are told apart by function name,
the tensor-core convs and the CUDA-core tiles alike, so the same grouping
reads a checkout from before the block chains' convs moved to the tensor
cores.

Run as a tool, it trains the w16 U-Net (256x256, batch 8, bfloat16
compute, parameters drawn from seed 0, one seeded random batch)
:data:`STEPS` steps in each block mode on the card, eagerly and as
replays of a CUDA graph of the iteration (:func:`iteration`, the fit
loop's dispatch), and prints one JSON line per mode: the host times of
those steps and :func:`step_profile` of three more, per replayed
iteration where it replays.  It profiles the ``smsut_tpu_torch`` found first on
``sys.path``; another checkout's package with
``PYTHONPATH=<checkout> python <this file>``.

Usage: python -m smsut_tpu_torch.tools.profile_step
"""
from __future__ import annotations

import json
import re
import statistics
import sys
import time
from typing import Dict, List, Sequence, Tuple

# the conv kernels and the index of their STATS template argument
CONVS = {"conv3x3_tc_kernel": 5, "conv_tile_kernel": 4}
# the norm sums pass, one function for every source of summands: named by
# its source, 'norm_sums_kernel<XSrc>' (K1), '<NormBwdSrc>' (K4, and norm 1
# in K6), '<BlockOutSrc>' (K6)
SOURCED = ("norm_sums_kernel",)
_DW = ("conv3x3_dw_tc_kernel", "dw_tc_reduce_kernel", "dw_partial_kernel",
       "dw_reduce_kernel")
# K1's functions: the resident kernel, the sums pass and the apply pass;
# K4's: the sums pass and the dx pass; and those of a checkout from before
# K1 and K4 took these plans (a stats pass, finalize and batch-sum kernels)
_NORM = ("in_resident_kernel", "norm_sums_kernel<XSrc>", "in_apply_kernel",
         "in_stats_kernel")
_NORM_BWD = ("norm_sums_kernel<NormBwdSrc>", "norm_bwd_apply_kernel",
             "bwd_sums_kernel", "bwd_finalize_kernel", "batch_sum_kernel")
_CONV = tuple(f"{c}{s}" for c in CONVS for s in ("+stats", "-stats"))
# kernel functions of each family, per block mode.  With block_pallas the
# stem's instance norm is K1 and K4; K6's norm-backward functions include
# the stem's K4 launches, and, before these plans, K3's finalize_kernel
# the stem's K1 finalize.
FAMILIES = {
    False: {"K1": (*_NORM, "finalize_kernel"),
            "K2": _CONV, "K4": _NORM_BWD, "K5": _DW},
    True: {"K1": _NORM,
           "K3": ("conv3x3_tc_kernel+stats", "conv_tile_kernel+stats",
                  "finalize_kernel", "block_out_kernel"),
           "K6": ("conv3x3_tc_kernel-stats", "conv_tile_kernel-stats", *_DW,
                  "block_dy2_kernel", "norm_sums_kernel<BlockOutSrc>",
                  *_NORM_BWD)}}
Row = Tuple[str, float, int]
# timed steps per block mode; the first, which warms up, is left out of
# the median
STEPS = 10


def kernel_function(key: str) -> str:
    """The function name of a profiler kernel key: 'void
    smsut::conv3x3_tc_kernel<64, 2, 4, 3, ...>(...)' -> 'conv3x3_tc_kernel',
    the first name followed by a template or parameter list (or the key
    itself).  A conv kernel of :data:`CONVS` gains '+stats' or '-stats' by
    its STATS template argument, a kernel of :data:`SOURCED` the name of
    its first template argument."""
    m = re.search(r"([A-Za-z_]\w*)\s*[<(]", key)
    if m is None:
        return key
    name = m.group(1)
    if name in SOURCED and key[m.end() - 1] == "<":
        src = re.match(r"\s*(?:\w+::)*(\w+)", key[m.end():])
        return f"{name}<{src.group(1)}>" if src else name
    if name in CONVS and key[m.end() - 1] == "<":
        args = [a.strip() for a in key[m.end():].split(",")]
        i = CONVS[name]
        name += "+stats" if len(args) > i and args[i] in ("true", "1") \
            else "-stats"
    return name


def by_function(rows: Sequence[Row], names: Sequence[str]
                ) -> Dict[str, List[float]]:
    """[device ms, launches] per call of each function of ``names``, summed
    over a profile's rows (key, ms, launches)."""
    out = {n: [0.0, 0] for n in names}
    for key, ms, n in rows:
        f = kernel_function(key)
        if f in out:
            out[f][0] += ms
            out[f][1] += n
    return out


def families(rows: Sequence[Row], fused: bool) -> Dict[str, float]:
    """Device ms per call of each family of ``FAMILIES[fused]``."""
    fams = FAMILIES[fused]
    fn = by_function(rows, [n for names in fams.values() for n in names])
    return {k: sum(fn[n][0] for n in names) for k, names in fams.items()}


def device_rows(torch, fn, n: int) -> Tuple[List[Row], float]:
    """(kernel key, device ms per call, launches per call) of ``n`` calls of
    ``fn`` under torch.profiler, device kernels only, the most first; and
    the host's ms per call under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / n, e.count // n)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    return rows, wall


def step_profile(torch, step, fused: bool, step_ms: Sequence[float]
                 ) -> dict:
    """Profile of three calls of ``step`` (one training step each), with
    ``step_ms`` the host ms of the steps timed before them: the median step
    (``step_ms[1:]``), the device ms per step, the idle share (1 - device /
    median), the kernels per step, the device ms per step of each family
    of ``FAMILIES[fused]`` and of the rest, the device ms and launches of
    each of the families' functions, and the 16 heaviest kernels.  With
    ``block_pallas`` K6 holds the stem norm's K4 launches."""
    med = statistics.median(step_ms[1:])
    rows, _ = device_rows(torch, step, 3)
    device = sum(r[1] for r in rows)
    fam = families(rows, fused)
    return {"median_step_ms": med, "device_ms": device,
            "idle_share": 1 - device / med,
            "kernels_per_step": sum(r[2] for r in rows),
            "families_ms": fam, "other_ms": device - sum(fam.values()),
            "functions": by_function(rows, [n for names in
                                            FAMILIES[fused].values()
                                            for n in names]),
            "top": rows[:16]}


def iteration(algo, state, inp, scalars=None, capture: bool = True):
    """One training iteration of ``algo`` on the fixed device inputs
    ``inp`` as a callable: ``algo.step`` replayed as a CUDA graph on the
    card when ``capture`` (train/graphs.py; its first call warms the graph
    up, its second captures it), eager otherwise; the host step advanced.
    A call returns the step's metrics (a replay's: the graph's buffers,
    valid until the next call)."""
    from smsut_tpu_torch.train.graphs import Replay

    scalars = {} if scalars is None else scalars
    step = Replay(lambda x: algo.step(state, x, scalars), algo.device,
                  capture)

    def run():
        out = step(inp)
        state.step += 1
        return out

    return run


def profile_mode(torch, fused: bool, capture: bool) -> dict:
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    cfg = Config(input_size=256, base_width=16, batch_size=8,
                 compute_dtype="bfloat16", block_pallas=fused)
    algo = SupervisedUNet(cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"img": torch.randn((8, 256, 256, 1), generator=g,
                                device="cuda"),
             "msk": torch.randint(0, cfg.n_class, (8, 256, 256), generator=g,
                                  device="cuda")}
    state = algo.init_state(seed=0)
    run = iteration(algo, state, algo.inputs(batch), capture=capture)
    if capture:
        run()   # the graph's warm-up: the timed first call captures it
    step_ms = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return {"block_pallas": fused, "replayed": capture, "step_ms": step_ms,
            **step_profile(torch, run, fused, step_ms)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("profile_step times the card: no CUDA device")
    for fused in (False, True):
        for capture in (False, True):
            print(json.dumps(profile_mode(torch, fused, capture)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
