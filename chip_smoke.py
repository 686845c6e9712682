#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Run the PyTorch/CUDA port (``smsut_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, and builds every kernel from
   ``smsut_tpu_torch/csrc`` (one nvcc per source, in parallel).
2. Holds each kernel (K1 instance norm, K2 3x3 conv, K3 fused block, both
   block forms) against its plain PyTorch version on the card, at the
   U-Net's shapes, in float32 (TF32 off) and bfloat16, and times the
   kernel, the plain version, one PyTorch library call of the same
   function (a yardstick the port never calls) and the card's bound.
3. Serves the full-width U-Net (width 16, 256x256, batch 8, bfloat16,
   seeded random weights) through ``SupervisedUNet`` -> ``export_eval`` ->
   ``load_serving`` -> ``predict``, once with ``block_pallas`` off and once
   on.  Each mode's launch counts must match the U-Net (off: 28 K1 + 18 K2
   per forward; on: 9 K3 + 1 K1), and its logits must agree with the plain
   path on the card in float32 and bfloat16.
4. Prints the ``kernels`` JSON line, then the device line last.

Any failed check raises and the script exits non-zero without the last
line.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and operations/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}

# kernel vs plain on the card, on the relative error
# max |kernel - plain| / max(1, max |plain|)
TOL = {("instnorm", "float32"): 1e-4, ("instnorm", "bfloat16"): 0.05,
       ("conv3x3", "float32"): 1e-4, ("conv3x3", "bfloat16"): 0.02,
       ("block", "float32"): 1e-3, ("block", "bfloat16"): 0.05}
# serving logits, kernel path vs plain path on the card: the error bound,
# the least argmax agreement over all pixels, and over the pixels whose
# plain top-two margin exceeds MARGIN * max(1, max |logit|).  Random-weight
# logits have small margins, so in bfloat16 a rounding difference flips the
# argmax of near-ties; away from ties the two paths must agree.
LOGIT_TOL = {"float32": 1e-3, "bfloat16": 0.1}
ARGMAX_MIN = {"float32": 0.999, "bfloat16": 0.98}
MARGIN = 0.05
ARGMAX_MIN_CLEAR = 0.999

REQUESTS = 20
PER_FORWARD = {False: {"instnorm": 28, "conv3x3": 18, "block": 0},
               True: {"instnorm": 1, "conv3x3": 0, "block": 9}}


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()
                 / max(1.0, float(want.abs().max())))


class Cases:
    """Seeded inputs on the card at the U-Net's shapes."""

    def __init__(self, torch, seed: int = 0):
        self.torch = torch
        self.g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(self, *shape, std=1.0, mean=0.0, dtype=None):
        t = self.torch.randn(shape, generator=self.g, device="cuda") * std + mean
        return t.to(dtype) if dtype is not None else t

    def norm_params(self, c):
        return (self.randn(c, std=0.2, mean=1.0), self.randn(c, std=0.1))

    def conv_w(self, k, ci, co, dtype):
        return self.randn(k, k, ci, co, std=(2.0 / (k * k * co)) ** 0.5,
                          dtype=dtype)


def check_kernels(torch, F, ops, instnorm, conv3x3, block):
    """Phase 2: every kernel against its plain version; returns the rows."""
    rows = []
    cases = Cases(torch)

    def library_block(x, w1, s1, b1, w2, s2, b2, ws=None, ss=None, bs=None):
        dt = x.dtype
        nchw = lambda t: t.permute(0, 3, 1, 2)
        conv = lambda t, w: F.conv2d(t, w.permute(3, 2, 0, 1),
                                     padding=w.shape[0] // 2)
        norm = lambda t, s, b: F.instance_norm(t, weight=s.to(dt),
                                               bias=b.to(dt), eps=1e-5)
        xn = nchw(x)
        y = F.leaky_relu(norm(conv(xn, w1), s1, b1), 0.01)
        y = norm(conv(y, w2), s2, b2)
        idn = xn if ws is None else norm(conv(xn, ws), ss, bs)
        return F.leaky_relu(y + idn, 0.01)

    def record(name, label, dt_name, fn, args, library, flops, nbytes,
               iters):
        with ops.plain():
            want = fn(*args)
        got = fn(*args)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        tol = TOL[(name, dt_name)]
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / PEAK_OPS_S[dt_name] * 1e3
        row = {"name": name, "case": label, "dtype": dt_name,
               "max_abs_err": float((got.float() - want.float()).abs().max()),
               "rel_err": err, "tol": tol,
               "ms": time_ms(lambda: fn(*args), iters),
               "plain_ms": None, "library_ms": None,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        with ops.plain():
            row["plain_ms"] = time_ms(lambda: fn(*args), max(2, iters // 5))
        row["library_ms"] = time_ms(lambda: library(*args), iters)
        rows.append(row)
        print(f"kernel {name} {label} {dt_name}: max abs err "
              f"{row['max_abs_err']:.3g}, rel err {err:.3g} (tol {tol}) "
              f"ms {row['ms']:.4f} plain {row['plain_ms']:.4f} "
              f"library {row['library_ms']:.4f} bound {row['bound_ms']:.4f} "
              f"({row['bound_by']})", flush=True)
        if not err <= tol:
            raise AssertionError(f"{name} {label} {dt_name}: error {err} "
                                 f"above {tol}")

    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[-1]
        isz = torch.tensor([], dtype=dt).element_size()
        # K1: the level-0 norms (256^2 x 16) and the bottleneck (16^2 x 256)
        for shape, act in (((8, 256, 256, 16), True), ((8, 16, 16, 256), False)):
            b, h, w, c = shape
            x = cases.randn(*shape, mean=0.3, dtype=dt)
            s, bb = cases.norm_params(c)
            lib = lambda x, s, bb, act: (
                F.leaky_relu(F.instance_norm(x.permute(0, 3, 1, 2),
                                             weight=s.to(x.dtype),
                                             bias=bb.to(x.dtype), eps=1e-5),
                             0.01) if act else
                F.instance_norm(x.permute(0, 3, 1, 2), weight=s.to(x.dtype),
                                bias=bb.to(x.dtype), eps=1e-5))
            record("instnorm", f"{list(shape)} act={act}", dn,
                   instnorm.instance_norm, (x, s, bb, act), lib,
                   flops=8 * x.numel(),
                   nbytes=2 * x.numel() * isz + 4 * 4 * c + 2 * 4 * b * c,
                   iters=50)
        # K2: decoder level 0 (32 -> 16), stem block (8 -> 16),
        # decoder level 3 (256 -> 128 at 32^2), bottleneck (128 -> 256)
        for (b, h, w, ci, co) in ((8, 256, 256, 32, 16), (8, 256, 256, 8, 16),
                                  (8, 32, 32, 256, 128), (8, 16, 16, 128, 256)):
            x = cases.randn(b, h, w, ci, dtype=dt)
            wt = cases.conv_w(3, ci, co, dt)
            lib = lambda x, wt: F.conv2d(x.permute(0, 3, 1, 2),
                                         wt.permute(3, 2, 0, 1), padding=1)
            record("conv3x3", f"{[b, h, w, ci]}->{co}", dn, conv3x3.conv3x3,
                   (x, wt), lib, flops=2 * b * h * w * 9 * ci * co,
                   nbytes=(b * h * w * (ci + co) + 9 * ci * co) * isz,
                   iters=20)
        # K3: shortcut form at decoder level 0 (32 -> 16) and the
        # bottleneck (128 -> 256 at 16^2); identity form 64 -> 64 at 64^2
        for (b, h, w, ci, co) in ((8, 256, 256, 32, 16), (8, 16, 16, 128, 256),
                                  (8, 64, 64, 64, 64)):
            x = cases.randn(b, h, w, ci, dtype=dt)
            args = [x, cases.conv_w(3, ci, co, dt), *cases.norm_params(co),
                    cases.conv_w(3, co, co, dt), *cases.norm_params(co)]
            if ci != co:
                args += [cases.conv_w(1, ci, co, dt), *cases.norm_params(co)]
            form = "shortcut" if ci != co else "identity"
            macs = 9 * ci * co + 9 * co * co + (ci * co if ci != co else 0)
            record("block", f"{form} {[b, h, w, ci]}->{co}", dn,
                   block.basic_block, tuple(args), library_block,
                   flops=2 * b * h * w * macs,
                   nbytes=(b * h * w * (ci + co) + macs) * isz + 6 * 4 * co,
                   iters=10)
    return rows


def profile_forward(torch, predict, img, n: int = 5) -> dict:
    """Device time per serving forward by kernel (torch.profiler, mean of
    n forwards).  Only device kernels are summed: an operator's entry
    repeats the time of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    predict(img)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            predict(img)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / n, e.count // n)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    return {"profiled_wall_ms": wall,
            "device_ms": sum(r[1] for r in rows), "top": rows[:16]}


def serve_modes(torch, ops, counters):
    """Phase 3: the full-width serving path in both block modes."""
    import numpy as np

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.serve import export_eval, load_serving
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    rng = np.random.default_rng(0)
    reqs = [((rng.integers(0, 256, (8, 256, 256, 1)) / 255.0 - 0.5) / 0.5)
            .astype(np.float32) for _ in range(REQUESTS)]
    results = {}
    for fused in (False, True):
        art = {}
        for dtn in ("bfloat16", "float32"):
            cfg = Config(input_size=256, base_width=16, batch_size=8,
                         compute_dtype=dtn, block_pallas=fused)
            algo = SupervisedUNet(cfg)
            params = algo.init_params(seed=0)
            out = ROOT / "build" / "chip_smoke_serving" / f"{dtn}-{int(fused)}"
            export_eval(algo, params, cfg, str(out))
            art[dtn] = out
        predict, manifest = load_serving(str(art["bfloat16"]))
        if manifest["input"]["shape"] != [8, 256, 256, 1]:
            raise AssertionError(f"manifest input {manifest['input']}")
        imgs = [torch.from_numpy(r).cuda() for r in reqs]
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        lat = []
        logits = []
        for img in imgs:
            t0 = time.perf_counter()
            y = predict(img)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            logits.append(y)
        counts = {k: c.launches for k, c in counters.items()}
        want = {k: v * REQUESTS for k, v in PER_FORWARD[fused].items()}
        q1, med, q3 = statistics.quantiles(lat[1:], n=4)
        print(f"serve block_pallas={fused}: launches {counts} "
              f"(expected {want}); latency per batch of 8: first "
              f"{lat[0]:.3f} ms, then median {med:.3f} ms, quartiles "
              f"{q1:.3f}-{q3:.3f}", flush=True)
        if counts != want:
            raise AssertionError(f"launch counts {counts} != {want}")
        for y in logits:
            if tuple(y.shape) != (8, 256, 256, 5) or y.dtype != torch.float32 \
                    or not bool(torch.isfinite(y).all()):
                raise AssertionError("logits not finite float32 [8,256,256,5]")
        checks = {}
        for dtn in ("bfloat16", "float32"):
            pred, _ = load_serving(str(art[dtn]))
            got = pred(imgs[0])
            with ops.plain():
                want_l = pred(imgs[0])
            err = rel_err(got, want_l)
            same = got.argmax(-1) == want_l.argmax(-1)
            top2 = want_l.topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > MARGIN * max(
                1.0, float(want_l.abs().max()))
            checks[dtn] = {
                "rel_err": err,
                "argmax_agree": float(same.float().mean()),
                "clear_share": float(clear.float().mean()),
                "argmax_agree_clear": float(same[clear].float().mean())}
            c = checks[dtn]
            print(f"serve block_pallas={fused} {dtn}: logits vs plain path "
                  f"rel err {err:.3g} (tol {LOGIT_TOL[dtn]}), argmax agreement "
                  f"{c['argmax_agree']:.6f} (min {ARGMAX_MIN[dtn]}), on the "
                  f"{c['clear_share']:.4f} of pixels with a clear margin "
                  f"{c['argmax_agree_clear']:.6f} (min {ARGMAX_MIN_CLEAR})",
                  flush=True)
            if not (err <= LOGIT_TOL[dtn]
                    and c["argmax_agree"] >= ARGMAX_MIN[dtn]
                    and c["argmax_agree_clear"] >= ARGMAX_MIN_CLEAR):
                raise AssertionError(f"logits disagree: {c}")
        results[fused] = {"launches": counts, "latency_ms": lat,
                          "median_ms": med, "quartiles_ms": [q1, q3],
                          "checks": checks,
                          "profile": profile_forward(torch, predict, imgs[0])}
        p = results[fused]["profile"]
        p["idle_share"] = 1 - p["device_ms"] / results[fused]["median_ms"]
        top = "; ".join(f"{n[:48]} {ms:.3f} ms x{k}" for n, ms, k in p["top"][:4])
        print(f"profile block_pallas={fused}: device busy {p['device_ms']:.3f} "
              f"ms per forward, idle share {p['idle_share']:.3f} of the median "
              f"latency; top: {top}", flush=True)
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from smsut_tpu_torch import ops
    from smsut_tpu_torch.ops import _build, block, conv3x3, instnorm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    build_s = _build.build()
    print(f"kernel build: {build_s:.1f} s", flush=True)
    OUT.mkdir(exist_ok=True)
    for name in _build.SOURCES:
        log = _build.build_log(name)
        (OUT / f"ptxas_{name}.log").write_text(log)
        spills = [ln.strip() for ln in log.splitlines() if "spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        print(f"ptxas {name}: {len(regs)} kernels, registers max "
              f"{max(regs, default=0)}, spilling: {spills or 'none'}")

    rows = check_kernels(torch, F, ops, instnorm, conv3x3, block)
    counters = {"instnorm": instnorm.instance_norm_fwd,
                "conv3x3": conv3x3.conv3x3, "block": block.basic_block}
    serve = serve_modes(torch, ops, counters)

    main_case = {"instnorm": "[8, 256, 256, 16] act=True",
                 "conv3x3": "[8, 256, 256, 32]->16",
                 "block": "shortcut [8, 256, 256, 32]->16"}
    meta = {"instnorm": ("smsut_tpu_torch/csrc/instnorm.cu",
                         "smsut_tpu/ops/instnorm_pallas.py:90"),
            "conv3x3": ("smsut_tpu_torch/csrc/conv3x3.cu",
                        "smsut_tpu/ops/conv_pallas.py:69"),
            "block": ("smsut_tpu_torch/csrc/block.cu",
                      "smsut_tpu/ops/block_pallas.py:185")}
    kernels = []
    for name, case in main_case.items():
        r = next(r for r in rows if r["name"] == name and r["case"] == case
                 and r["dtype"] == "bfloat16")
        kernels.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": sum(s["launches"][name] for s in serve.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    with open(OUT / "chip_smoke.json", "w") as f:
        json.dump({"card": card, "build_s": build_s, "kernel_rows": rows,
                   "serve": {str(k): v for k, v in serve.items()},
                   "kernels": kernels}, f, indent=1)
    shutil.rmtree(ROOT / "build" / "chip_smoke_serving", ignore_errors=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
