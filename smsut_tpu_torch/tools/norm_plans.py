#!/usr/bin/env python
# -*- coding: utf-8 -*-
"""Device time of K1's and K4's plans at each norm shape of the training
step, on the card: builds ``norm_plans.cu`` beside this file with the
kernels' own nvcc flags (into ``build/kernels``) and prints its lines: the
plan K1 picks, its two-pass plan and its resident plan, with each block's
slice bytes and whether its clusters fit the card at once; and K4's plan.
The measurement behind the plan choice of ``csrc/instnorm.cuh``
``in_fwd_plan``.

Usage: python -m smsut_tpu_torch.tools.norm_plans
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from smsut_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().with_name("norm_plans.cu")


def main() -> int:
    exe = _build.BUILD_DIR / "norm_plans"
    exe.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.FLAGS if f not in ("-shared", "-Xcompiler",
                                                   "-fPIC")]
    subprocess.run([_build._nvcc(), *flags, "-I", str(_build.CSRC), "-o",
                    str(exe), str(SOURCE)], check=True, capture_output=True,
                   timeout=600)
    run = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=600)
    print(run.stdout, end="", flush=True)
    return run.returncode


if __name__ == "__main__":
    sys.exit(main())
