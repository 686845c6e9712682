#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Run the PyTorch/CUDA port (``smsut_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, and builds every kernel from
   ``smsut_tpu_torch/csrc`` (one nvcc per source, in parallel); counts the
   tensor-core instructions of every tensor-core kernel instantiation in
   the built code (``cuobjdump -sass``) and fails where one lacks them:
   HMMA (mma.sync) in K2's and K5's, in those of K3's and K6's chains and
   in K7's mma.sync kernel (the dots conv at C over 64); HGMMA (wgmma) and
   UTMALDG (TMA loads), and no HMMA, in K7's Hopper kernel and in K8's
   and K9's (the im2col pair).  Prints K7's Hopper kernel's registers and
   spills from ptxas, and whether ptxas ignored its setmaxnreg (C7508).
2. Holds each forward kernel (K1 instance norm, K2 3x3 conv, K3 fused
   block, both block forms) against its plain PyTorch version on the card,
   at the U-Net's shapes, in float32 (TF32 off) and bfloat16, and times the
   kernel, the plain version, one PyTorch library call of the same
   function (a yardstick the port never calls) and the card's bound.  K1
   runs at the six distinct (map, channels) of the step's 28 norms and at
   3 and 12 channels, in both dtypes, with the plan each shape takes
   (resident in a cluster's shared memory, or two passes; K4 two passes)
   and two runs bit for bit.  In bfloat16 K2 runs at all 14 3x3 convs of the training step,
   K3 at the U-Net's nine blocks and the identity form.
   2b. The same for each backward kernel: K4 (norm backward, at K1's
   shapes), K5 (conv weight gradient) and K2 as the dx of a conv, both in
   bfloat16 at all 14 3x3 convs of the step, and K6 (block backward, both
   forms; bfloat16 at the nine blocks and the identity form).
   2c. The same for the three tensor-core conv kernels (dots, im2col,
   im2col2, the candidates of the conv microbench), bfloat16, at the
   microbench's shape [16,128,128,64] -> 64 and at [4,64,64,32] -> 32,
   and dots alone at the step's [8,32,32,128] -> 128 (C over 64: K8 and
   K9 refuse it), each at strip 16 and 32; each two runs bit for bit, and
   strip 32 bit for bit with strip 16 (strip does not change their math);
   K7's route printed and asserted at each shape: its Hopper kernel at
   C <= 64, its mma.sync kernel at C 128.
3. Serves the full-width U-Net (width 16, 256x256, batch 8, bfloat16,
   seeded random weights) through ``SupervisedUNet`` -> ``export_eval`` ->
   ``load_serving`` -> ``predict``, once with ``block_pallas`` off and once
   on.  Each mode's launch counts must match the U-Net (off: 28 K1 + 18 K2
   per forward; on: 9 K3 + 1 K1; no backward kernel), and its logits must
   agree with the plain path on the card in float32 and bfloat16.
4. Trains the full-width U-Net: ``init_state(seed=0)`` and 10
   ``train_step``s on one seeded batch of 8 slices with filled ellipses
   labelled 1-4, in bfloat16, with ``block_pallas`` off and on.  Checks the
   launches per step (off: 28 K1, 36 K2, 28 K4, 18 K5; on: 1 K1, 9 K3, 1
   K4, 9 K6), every parameter's step-1 gradient against the plain path
   (float32 and bfloat16), a finite and falling loss, and in float32 the
   first 3 losses against the plain path; records the median step time,
   the device idle share and the device time per step of each kernel
   family (``smsut_tpu_torch/tools/profile_step.py`` ``step_profile``),
   and fails if a bfloat16 step ran a CUDA-core conv.  Neither mode routes
   a conv or block to plain PyTorch at width 16 (``conv3x3.conv3x3.routed``
   and ``block.basic_block.routed`` stay 0).  Then trains width 8, whose
   first and last blocks' 3x3 convs the kernels do not take, 3 steps in
   both modes: the launch and routed counts per step, a finite loss, and
   the float32 step-1 gradients against the plain path (phase 4's rules).
5. Runs the port's conv microbench (``smsut_tpu_torch.tools.microbench_conv``)
   at batch 16 with 20 applications per chain: the three tensor-core
   kernels, K2 and the library conv, each checked against the plain
   version and timed; the launch counts must match the tool's calls.
6. Runs the fit loop on a synthetic dataset that the port writes under
   ``build/chip_smoke_fit/`` (3 patients per modality, 8 slices of 256x256
   each; removed at the end):
   6a. ``run_main`` (``-p train``, iterations and eval sweeps replayed as
   CUDA graphs) in this process at ``base_width=16``,
   batch 8, bfloat16, the default ``data_aug`` with ``device_augment``, 2
   epochs of 10 iterations, once per ``block_pallas`` mode, then ``-p test
   -i 000 -wh best`` through ``python -m smsut_tpu_torch.trainer.unetTrainer``
   in a subprocess.  Checks 20 steps, finite losses, the [TRN] and [TST]
   lines, ``best.ckpt`` and ``last.ckpt``, a 2x5-row CSV, and the launch
   counts of the run (20 steps and 8 eval forwards of the mode's kernels;
   no route to plain PyTorch).
   6b. The Trainer twice on one batch stream (float32, no augmentation, 2
   epochs of 4 iterations, eager: ``capture=False``), with the kernels and
   under ``ops.plain()``: the
   per-epoch [TRN] losses within 1e-3 relative, the [TST] Dice per
   modality within 0.01 and overall within 3e-3, the same best epoch.
   6c. ``DeviceAugment`` on the card against the CPU on the same packed
   parameters: the image within 2e-3, the mask equal but at rounding ties
   (their share printed); its device ms per batch.
   6d. Per block mode, a fit of 3 epochs of 30 iterations whose second
   epoch's iterations (not the epoch's final read of the losses) run under
   ``torch.cuda.set_sync_debug_mode("error")``, which raises on any call
   that waits on the card, and whose third runs under the profiler.
   Prints the loop's time per iteration (the second epoch's wall time
   over its iterations) beside phase 4's eager bare ``train_step``
   median, its device time per iteration and
   idle share, the eval sweep's ms per batch and the test phase's
   host-metric seconds.
7. Trains the paper's method, ``uganConsis``, at the ``Config`` widths
   (w16, 256x256, 8 labelled + 8 unlabelled, D max width 256):
   7a. The WGAN-GP term's D-parameter gradients (``create_graph=True``)
   of the w16 discriminator on x_hat [16,256,256,1], float32, with the
   kernels, under ``ops.plain()`` and in float64 (plain): cosine at least
   0.9999 per tensor and L2 of all within 1e-3 against the plain path,
   and per-tensor rel_err within 1e-3 where the two float32 forwards agree
   in the sign of every lrelu input (a flip switches that element's slope
   in the second order; the flips are printed); K2, K5 and K4 launch in
   the second backward, K1 at each of the 14 norms of the forward,
   ``instance_norm.double_backward`` counts 14 and ``conv_src`` is the
   one routed conv.
   7b. ``UGANConsisAlgo`` with ``block_pallas`` off and on: 10 bf16 steps
   on a fixed batch and fixed draws (the launches of every step equal,
   ``conv_src`` routed 3 times a step, finite losses, G_seg falling), the
   median and quartiles of steps 2-10, the profiler's device ms and
   kernels per step, idle share and the D step's share of the device
   time; float32 step 1 against the plain path: the D step from one init
   (losses within rtol 5e-3 / atol 2e-3, D after Adam flip-aware: max
   |dev| <= 2.1 lr, flip share < 1%), then the G step of both paths
   against the kernel path's D (losses with the same bounds, the seg
   tower's fc and pre_conv within rtol 2e-3 / atol 1e-4).
   7c. ``uganConsisTrainer -p train`` through ``run_main`` on phase 6's
   tree (2 epochs of 10 iterations, the default augmentation on the card,
   epoch 2 under ``set_sync_debug_mode("error")``; the launches equal 20
   of 7b's steps and 16 eval or translation forwards; the [TRN] and
   [TST] lines, both translation grids, best and last checkpoints), ``-p
   test -i 000 -wh best`` through ``python -m`` in a subprocess, and
   ``--resume 000:last``.
8. Runs the JAX package's dispatch on the card: each training iteration,
   eval batch and serving forward replayed as a CUDA graph
   (``smsut_tpu_torch/train/graphs.py`` ``Replay``), held against the
   eager path in the same process:
   8a. The w16 U-Net's iteration in both block modes: 10 bfloat16 replays
   (launches counted as 10 eager steps, loss finite and falling), then
   10 float32 replays against 10 eager iterations from one init (phase
   4's loss and parameter rules).  In a child process (a process that
   held large profiler sessions loses records from later ones), one
   replay of each 8a and 8b iteration runs the port's kernels of one
   eager iteration, by the profiler's names and counts, and as many
   device operations.
   8b. ``uganConsis`` (w16, 8 + 8) in both block modes, float32, 10
   replays, each against an eager step from a copy of the state before it
   and the same draws, the consistency gate opening at step 3 and
   ``lambda_semi`` changing at step 5 (7b's float32 rules at every step;
   G_semi 0 before the gate and positive after; at step 5 the replay 10x
   nearer the eager step with the new weight than one with the old).
   8c. The U-Net and uganConsis fits on phase 6's tree at the Config's
   dispatch (``steps_per_dispatch`` 8, ``eval_scan``), float32, epoch 2
   under ``set_sync_debug_mode("error")``, against the eager fit
   (``steps_per_dispatch`` 1, no scan, ``capture=False``) on the same
   recorded batches: 6b's bounds on the [TRN] losses, [TST] Dice and best
   epoch (uganConsis with its bilinear upsampling done by slices, whose
   backward has no atomics; a second eager fit shows the spread left).
   8d. ``predict`` replayed against eager: the logits equal.
   8e. Eager and replayed blocks in turns (6 rounds): the U-Net
   iteration, the uganConsis iteration (bfloat16), the eval sweep per
   batch and the serving latency, each with its median and quartiles,
   device ms, kernels and idle share, printed with the card's name and
   power limit.
9. The semi-supervised zoo at w16, 256x256, 8 + 8: Mean Teacher,
   cross-pseudo supervision and CoraNet's stages A and B.
   9a. Per algorithm and block mode, step 1's gradients with every loss
   term live against the plain path (phase 4's rules, float32 and
   bfloat16), and 10 replayed bfloat16 iterations: the launches per
   iteration (Mean Teacher a student step at 16 images and a teacher
   forward, cross-pseudo supervision two student steps, CoraNet B two
   student applies of 8 and a teacher forward), nothing routed, the loss
   falling.
   9b. Mean Teacher from count 99 and CoraNet B from count 999, float32:
   the consistency gate (and Mean Teacher's EMA alpha) flips inside four
   replayed steps, held against the plain path.
   9c. Five float32 iterations replayed against eager, both block modes,
   to the bit; then eager and replayed bfloat16 blocks in turns (8e's
   rules): ms, device ms, kernels and idle share per iteration.
   9d. ``meanTeacherTrainer``, ``crossPseTrainer`` and ``coraNetTrainer``
   (stage A, then stage B from its ``pre_best``, the pseudo-labels made at
   both epochs) on phase 6's tree, 2 epochs of 10, epoch 1 under
   ``set_sync_debug_mode("error")``, launches asserted; ``-p test`` and
   ``-p pseudo`` of each.
   9e. ``export_eval`` -> ``load_serving`` -> ``predict`` of each and of
   ``uganConsis``, float32: the served logits equal ``eval_fn``'s to the
   bit.
10. M3L's masked-consistency SegFormer and the dual-task U-Net:
   10a. ``DTCUNet`` at its own width 64, 256x256, batch 8, batch norm +
   ReLU and instance norm + leaky ReLU (``block_pallas`` off and on): the
   forward and a backward of a loss over both heads, float32 and
   bfloat16, against the plain path under phase 4's rules, the launches
   of the forward and of the backward, nothing routed; and K1-K6 against
   their plain versions at every distinct DTC w64 shape (channels up to
   1024; bfloat16 at all, float32 at the widest; phase 2's bounds).
   10b. The M3L iteration at the Config defaults (256x256, 8 + 8): 10
   replayed bfloat16 iterations (finite losses, no launch of the port's
   kernels: the JAX M3L reaches no Pallas kernel either), eager and
   replayed blocks in turns (8e's rules: ms, device ms, kernels, idle
   share); float32 step 1 on the card against the port's step on the CPU
   from the same weights and mask (losses within 1e-4 relative, the
   student after Adam flip-aware); five float32 replays against eager
   across the EMA's gate at count 100, to the bit under deterministic
   cuDNN.
   10c. ``M3LTrainer -p train`` through ``run_main`` on phase 6's tree (2
   epochs of 10, epoch 1 under ``set_sync_debug_mode("error")``), then
   ``-p test`` and ``-p pseudo``.
   10d. ``export_eval`` -> ``load_serving`` -> ``predict`` of M3L: the
   served logits equal ``eval_fn``'s at the same batch to the bit.
11. Prints the ``kernels`` JSON line (all nine kernels, launches summed
   over the runs of phases 3-10, replays included, not over the checks
   against the plain path), then the device line last.

Any failed check raises and the script exits non-zero without the last
line.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
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

# the float32 rate of the CUDA cores, for elementwise and reduction math
PEAK_F32_CORES = 67e12

# kernel vs plain on the card, on the relative error
# max |kernel - plain| / max(1, max |plain|), the largest over a kernel's
# outputs; for the tensor-core convs max |kernel - plain| / max |plain|
# (REL_TO_MAX), the microbench's measure
TOL = {("instnorm", "float32"): 1e-4, ("instnorm", "bfloat16"): 0.05,
       ("conv3x3", "float32"): 1e-4, ("conv3x3", "bfloat16"): 0.02,
       ("block", "float32"): 1e-3, ("block", "bfloat16"): 0.05,
       ("instnorm_bwd", "float32"): 1e-4, ("instnorm_bwd", "bfloat16"): 0.05,
       ("conv3x3_dw", "float32"): 1e-4, ("conv3x3_dw", "bfloat16"): 0.05,
       ("conv3x3_dx", "float32"): 1e-4, ("conv3x3_dx", "bfloat16"): 0.02,
       ("block_bwd", "float32"): 1e-3, ("block_bwd", "bfloat16"): 0.05,
       # both round the float32 sum once to bfloat16, so they differ by at
       # most one bf16 unit of an output: 2^-7 of max |plain| at most
       ("conv3x3_dots", "bfloat16"): 8e-3,
       ("conv3x3_im2col", "bfloat16"): 8e-3,
       ("conv3x3_im2col2", "bfloat16"): 8e-3}
REL_TO_MAX = {"conv3x3_dots", "conv3x3_im2col", "conv3x3_im2col2"}
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
# the distinct norm shapes of the training step (w16 U-Net, 256^2, batch
# 8): map side, channels and the activation of one of its sites; then 3
# and 12 channels, the scalar path.  K1 and K4 run at each, in both dtypes.
NORM_SHAPES = ((8, 256, 256, 16, True), (8, 256, 256, 8, True),
               (8, 128, 128, 32, True), (8, 64, 64, 64, True),
               (8, 32, 32, 128, True), (8, 16, 16, 256, False),
               (3, 11, 9, 3, True), (8, 64, 64, 12, False))
# the 3x3 convs of the training step (w16 U-Net, 256^2, batch 8): map
# side, forward Cin and Cout.  The dx of each is K2 on the flipped kernel
# (Cout -> Cin), its weight gradient K5.  bfloat16 runs all of them; the
# float32 parity rows keep the shapes they had before.
STEP_CONVS = ((256, 8, 16), (256, 16, 16), (256, 32, 16), (128, 16, 32),
              (128, 32, 32), (128, 64, 32), (64, 32, 64), (64, 64, 64),
              (64, 128, 64), (32, 64, 128), (32, 128, 128), (32, 256, 128),
              (16, 128, 256), (16, 256, 256))
F32_K2 = ((256, 32, 16), (256, 8, 16), (32, 256, 128), (16, 128, 256))
F32_K5 = ((256, 32, 16), (256, 8, 16), (16, 128, 256))
F32_DX = ((256, 8, 16),)
# the CUDA-core conv kernels, by function name (smsut_tpu_torch/tools/
# profile_step.py, which also groups a step's kernels into K1-K6): a
# bfloat16 step runs none of them
CUDA_CORE_CONVS = ("conv_tile_kernel+stats", "conv_tile_kernel-stats",
                   "dw_partial_kernel", "dw_reduce_kernel")
# the tensor-core kernels in the built code: library, kernel name,
# instantiations, the SASS opcodes each must hold and those it must not
# (K2 and K5; in K3's chain conv1, conv2 with the norm applied while
# staging, the 1x1 shortcut; in K6's dn1 masked, dx plus the side term, the
# float32 side term, and dw2 (norm applied), dw1, dws; K7's mma.sync
# kernel at three NCO and its Hopper kernel; K8 and K9, on wgmma and TMA)
HMMA = (("HMMA",), ())
TC_KERNELS = (("conv3x3", "conv3x3_tc_kernel", 12, *HMMA),
              ("conv3x3_dw", "conv3x3_dw_tc_kernel", 6, *HMMA),
              ("block", "conv3x3_tc_kernel", 36, *HMMA),
              ("block_bwd", "conv3x3_tc_kernel", 36, *HMMA),
              ("block_bwd", "conv3x3_dw_tc_kernel", 18, *HMMA),
              ("conv3x3_mma", "conv_dots_kernel", 3, *HMMA),
              ("conv3x3_mma", "conv_dots_sm90_kernel", 1,
               ("HGMMA", "UTMALDG"), ("HMMA",)),
              ("conv3x3_mma", "conv_im2col_sm90_kernel", 2,
               ("HGMMA", "UTMALDG"), ("HMMA",)))
SASS_OPS = ("HMMA", "HGMMA", "UTMALDG")
# the U-Net's nine BasicBlocks, all of the shortcut form: map side, Cin,
# Cout; bfloat16 runs K3 and K6 at each, float32 at the parity rows
UNET_BLOCKS = ((256, 8, 16), (256, 32, 16), (128, 16, 32), (128, 64, 32),
               (64, 32, 64), (64, 128, 64), (32, 64, 128), (32, 256, 128),
               (16, 128, 256))
F32_K3 = ((256, 32, 16), (16, 128, 256), (64, 64, 64))
F32_K6 = ((256, 32, 16), (256, 8, 16), (64, 64, 64))
KERNELS = ("instnorm", "conv3x3", "block", "instnorm_bwd", "conv3x3_dw",
           "block_bwd", "conv3x3_dots", "conv3x3_im2col", "conv3x3_im2col2")
MMA_VARIANTS = ("dots", "im2col", "im2col2")
# phase 2c's shapes (B, H, W, C, Cout), the kernel K7 runs at each and the
# variants held there: the microbench's, C 32, and the step's C-128 conv,
# where K7 runs mma.sync and K8 and K9 refuse (their slab does not fit)
MMA_SHAPES = (((16, 128, 128, 64, 64), "conv_dots_sm90_kernel", MMA_VARIANTS),
              ((4, 64, 64, 32, 32), "conv_dots_sm90_kernel", MMA_VARIANTS),
              ((8, 32, 32, 128, 128), "conv_dots_kernel", ("dots",)))
PER_FORWARD = {False: {"instnorm": 28, "conv3x3": 18, "block": 0},
               True: {"instnorm": 1, "conv3x3": 0, "block": 9}}
# training: launches per step (forward + backward; K2 runs the forward
# convs and the dx of every 3x3 conv)
PER_STEP = {False: {"instnorm": 28, "conv3x3": 36, "block": 0,
                    "instnorm_bwd": 28, "conv3x3_dw": 18, "block_bwd": 0},
            True: {"instnorm": 1, "conv3x3": 0, "block": 9,
                   "instnorm_bwd": 1, "conv3x3_dw": 0, "block_bwd": 9}}
STEPS = 10
# width 8: launches and routed calls per step (forward + backward); the
# first and last blocks' four 3x3 convs go to plain PyTorch, and with
# block_pallas those two blocks run the unfused chain
W8_STEPS = 3
PER_STEP_W8 = {False: {"instnorm": 28, "conv3x3": 28, "block": 0,
                       "instnorm_bwd": 28, "conv3x3_dw": 14, "block_bwd": 0},
               True: {"instnorm": 7, "conv3x3": 0, "block": 7,
                      "instnorm_bwd": 7, "conv3x3_dw": 0, "block_bwd": 7}}
ROUTED_W8 = {False: {"conv3x3": 4, "block": 0},
             True: {"conv3x3": 4, "block": 2}}
# phase 5: the microbench's applications per chain, and the launches of
# each wrapper: per candidate one checked call, two warm-up applications
# and the chain; im2col and im2col2 are two candidates each (strip 16, 32)
MB_ITERS = 20
MB_CALLS = {"conv3x3": 1, "conv3x3_dots": 1, "conv3x3_im2col": 2,
            "conv3x3_im2col2": 2}
# step-1 gradients, kernel path vs plain path on the card.  float32 (TF32
# off): per tensor rel_err (max |diff| / max(1, max |plain|)) at most
# GRAD_REL, ||diff|| / ||plain|| over all parameters together at most
# GRAD_REL, and per tensor cosine at least GRAD_COS.  Not ||diff|| /
# ||plain|| per tensor: the gradient of a norm bias that feeds the next
# instance norm is the small remainder of terms that nearly cancel, so
# float32 summation order alone moves it by 3e-3 of itself.  bfloat16: per
# tensor the kernel path is no less accurate than the plain path, both
# measured against the float32 plain gradient:
# ||K_bf16 - P_f32|| <= BF16_ACC * ||P_bf16 - P_f32|| + 1e-3 * ||P_f32||.
GRAD_REL = 1e-3
GRAD_COS = 0.9999
BF16_ACC = 2.0
LOSS_TOL = 1e-3   # float32: the first 3 losses, kernel vs plain path


# phase 6: the fit loop on a synthetic dataset (3 patients per modality, 8
# slices each: 1 train, 1 val, 1 test patient; 4 test batches of 8)
FIT_DIR = ROOT / "build" / "chip_smoke_fit"
FIT_EPOCHS, FIT_ITERS = 2, 10
FIT_TEST_BATCHES = 4
PARITY_ITERS = 4                  # 6b: float32, kernels vs plain path
PARITY_DICE_TOL = 0.01            # per modality; overall PARITY_DICE_ALL
PARITY_DICE_ALL = 3e-3
AUG_TOL = 2e-3                    # 6c, tests/test_device_augment.py's bound
TIE_EPS = 1e-3                    # a source coordinate this near k + 1/2
WATCH_ITERS = 30                  # 6d: iterations of the watched epoch

# phase 7: the GAN (uganConsis) at the Config defaults' widths: w16,
# 256^2, 8 labelled + 8 unlabelled, D max width 256
GAN_STEPS = 10
# 7b, float32 (TF32 off), one step, kernels vs plain path on the card:
# tests/test_gan_training_parity.py's step-0 bounds on the losses and on
# the segmentation tower's fc and pre_conv, and the flip-aware D check of
# __graft_entry__.py (Adam's first update is lr * sign(g): a float32
# rounding difference flips a near-zero gradient's whole 2 lr step)
GAN_LOSS_RTOL, GAN_LOSS_ATOL = 5e-3, 2e-3
GAN_SEG_RTOL, GAN_SEG_ATOL = 2e-3, 1e-4
GAN_FLIP_DEV, GAN_FLIP_SHARE = 2.1, 0.01
# the seg tower's parameters held after step 1
GAN_SEG_TOWER = ("core.seg_decoder.fc.weight", "core.seg_decoder.fc.bias",
                 "core.seg_encoder.pre_conv.weight")
GAN_NAMES = ("D_real", "D_fake", "D_cls", "D_gp", "G_fake", "G_rec",
             "G_cls", "G_seg", "G_semi", "G_nce")


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def time_ms(fn, iters: int) -> float:
    """Device ms per call of ``fn``: CUDA events around ``iters`` calls.  A
    sleep kernel holds the stream while the host enqueues them, so that the
    calls run back to back and the events time the device, not the host's
    launch rate (a call of a few tens of us is shorter than its enqueue)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # about 2e9 cycles a second; twice the host's time for the loop
    torch.cuda._sleep(int(min(2 * iters * host_s, 1.0) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want, floor: float = 1.0) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()
                 / max(floor, float(want.abs().max())))


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

    def block_args(self, b, h, w, ci, co, dtype):
        args = [self.randn(b, h, w, ci, dtype=dtype),
                self.conv_w(3, ci, co, dtype), *self.norm_params(co),
                self.conv_w(3, co, co, dtype), *self.norm_params(co)]
        if ci != co:
            args += [self.conv_w(1, ci, co, dtype), *self.norm_params(co)]
        else:
            args += [None, None, None]
        return args


def library_block(F, x, w1, s1, b1, w2, s2, b2, ws=None, ss=None, bs=None):
    """The block as PyTorch's own calls (cuDNN convs, instance_norm)."""
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


def grad_call(torch, fn, inputs, cot):
    """A call that runs one backward of ``fn(*inputs)`` for the cotangent
    ``cot``: the graph is built once, each call only differentiates."""
    leaves = [t.detach().requires_grad_() if t is not None else None
              for t in inputs]
    out = fn(*leaves)
    wrt = [t for t in leaves if t is not None]
    return lambda: torch.autograd.grad(out, wrt, cot, retain_graph=True)


def record(torch, ops, rows, name, label, dt_name, fn, args, library, flops,
           nbytes, iters, peak=None, extra=None):
    """Hold ``fn(*args)`` against its plain version (``ops.plain()``) on the
    card, time the kernel, the plain version and the library call (device
    time, ``time_ms``), and append the row, with ``extra``'s keys."""
    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)
    with ops.plain():
        want = as_tuple(fn(*args))
    got = as_tuple(fn(*args))
    torch.cuda.synchronize()
    pairs = [(a, w) for a, w in zip(got, want) if w is not None]
    if len(pairs) != sum(a is not None for a in got):
        raise AssertionError(f"{name} {label}: outputs differ in kind")
    floor = 1e-30 if name in REL_TO_MAX else 1.0
    err = max(rel_err(a, w, floor) for a, w in pairs)
    tol = TOL[(name, dt_name)]
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / (peak or PEAK_OPS_S[dt_name]) * 1e3
    row = {"name": name, "case": label, "dtype": dt_name,
           "max_abs_err": max(float((a.float() - w.float()).abs().max())
                              for a, w in pairs),
           "rel_err": err, "tol": tol,
           "ms": time_ms(lambda: fn(*args), iters),
           "plain_ms": None, "library_ms": None,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           **(extra or {})}
    with ops.plain():
        row["plain_ms"] = time_ms(lambda: fn(*args), max(2, iters // 5))
    row["library_ms"] = time_ms(library, iters)
    rows.append(row)
    print(f"kernel {name} {label} {dt_name}: max abs err "
          f"{row['max_abs_err']:.3g}, rel err {err:.3g} (tol {tol}) "
          f"ms {row['ms']:.4f} plain {row['plain_ms']:.4f} "
          f"library {row['library_ms']:.4f} bound {row['bound_ms']:.4f} "
          f"({row['bound_by']})"
          + "".join(f" {k} {v}" for k, v in (extra or {}).items()),
          flush=True)
    if not err <= tol:
        raise AssertionError(f"{name} {label} {dt_name}: error {err} "
                             f"above {tol}")


def norm_plan(instnorm, kind: str, shape, dt) -> str:
    """The plan K1 (``kind`` "fwd") or K4 ("bwd") takes at ``shape``."""
    b, h, w, c = shape
    p = instnorm.plan(kind, b, h * w, c, dt)
    how = (f"resident, clusters of {p['nsplit']}" if p["resident"] else
           f"two-pass, {p['nsplit']} splits")
    return (f"{how}, {p['ng']} groups of {p['G']}, "
            f"{'vec' if p['vec'] else 'scalar'}, {p['rows']} pixels per "
            f"block, {p['smem']} B shared")


def same_twice(torch, name, shape, fn, args) -> None:
    """Two calls give the same bits (no float atomics in the sums)."""
    a, b = fn(*args), fn(*args)
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        raise AssertionError(f"{name} {list(shape)}: two runs differ")


def check_kernels(torch, F, ops, instnorm, conv3x3, block):
    """Phase 2: every forward kernel against its plain version; returns
    the rows."""
    rows = []
    cases = Cases(torch)
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[-1]
        isz = torch.tensor([], dtype=dt).element_size()
        # K1: every distinct norm shape of the step, and 3 and 12 channels
        for (b, h, w, c, act) in NORM_SHAPES:
            shape = (b, h, w, c)
            x = cases.randn(*shape, mean=0.3, dtype=dt)
            s, bb = cases.norm_params(c)
            lib = lambda x=x, s=s, bb=bb, act=act: (
                F.leaky_relu(F.instance_norm(x.permute(0, 3, 1, 2),
                                             weight=s.to(x.dtype),
                                             bias=bb.to(x.dtype), eps=1e-5),
                             0.01) if act else
                F.instance_norm(x.permute(0, 3, 1, 2), weight=s.to(x.dtype),
                                bias=bb.to(x.dtype), eps=1e-5))
            same_twice(torch, "instnorm", shape, instnorm.instance_norm_fwd,
                       (x, s, bb, act))
            record(torch, ops, rows, "instnorm", f"{list(shape)} act={act}",
                   dn, lambda *a: instnorm.instance_norm_fwd(*a)[0],
                   (x, s, bb, act), lib, flops=8 * x.numel(),
                   nbytes=2 * x.numel() * isz + 4 * 4 * c + 2 * 4 * b * c,
                   iters=20, extra={"plan": norm_plan(instnorm, "fwd", shape,
                                                      dt)})
        # K2: float32 at decoder level 0 (32 -> 16), the stem block
        # (8 -> 16), decoder level 3 (256 -> 128 at 32^2) and the
        # bottleneck (128 -> 256); bfloat16 at every conv of the step
        for (h, ci, co) in F32_K2 if dt == torch.float32 else STEP_CONVS:
            b, w = 8, h
            x = cases.randn(b, h, w, ci, dtype=dt)
            wt = cases.conv_w(3, ci, co, dt)
            lib = lambda x=x, wt=wt: F.conv2d(x.permute(0, 3, 1, 2),
                                              wt.permute(3, 2, 0, 1),
                                              padding=1)
            record(torch, ops, rows, "conv3x3", f"{[b, h, w, ci]}->{co}", dn,
                   conv3x3.conv3x3_fwd, (x, wt), lib,
                   flops=2 * b * h * w * 9 * ci * co,
                   nbytes=(b * h * w * (ci + co) + 9 * ci * co) * isz,
                   iters=10)
        # K3: float32 at decoder level 0 (32 -> 16), the bottleneck
        # (128 -> 256 at 16^2) and the identity form 64 -> 64 at 64^2;
        # bfloat16 at the nine blocks and the identity form
        for (h, ci, co) in F32_K3 if dt == torch.float32 else (
                *UNET_BLOCKS, (64, 64, 64)):
            b, w = 8, h
            args = cases.block_args(b, h, w, ci, co, dt)
            form = "shortcut" if ci != co else "identity"
            macs = 9 * ci * co + 9 * co * co + (ci * co if ci != co else 0)
            record(torch, ops, rows, "block", f"{form} {[b, h, w, ci]}->{co}",
                   dn, block.basic_block_fwd, tuple(args),
                   lambda args=args: library_block(F, *args),
                   flops=2 * b * h * w * macs,
                   nbytes=(b * h * w * (ci + co) + macs) * isz + 6 * 4 * co,
                   iters=5)
    return rows


def check_backward_kernels(torch, F, ops, instnorm, conv3x3, block):
    """Phase 2b: every backward kernel against its plain version; returns
    the rows.  The library calls are yardsticks the port never calls:
    autograd of F.instance_norm (+ leaky_relu), torch.nn.grad's
    conv2d_weight and conv2d_input, autograd of the block's PyTorch
    calls."""
    rows = []
    cases = Cases(torch, seed=1)
    nchw = lambda t: t.permute(0, 3, 1, 2)
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[-1]
        isz = torch.tensor([], dtype=dt).element_size()
        # K4: at K1's shapes
        for (b, h, w, c, act) in NORM_SHAPES:
            shape = (b, h, w, c)
            x = cases.randn(*shape, mean=0.3, dtype=dt)
            g = cases.randn(*shape, dtype=dt)
            s, bb = cases.norm_params(c)
            _, mean, rstd = instnorm.instance_norm_fwd(x, s, bb, act)

            def lib_fwd(xn, s_, b_, act=act):
                y = F.instance_norm(xn, weight=s_.to(xn.dtype),
                                    bias=b_.to(xn.dtype), eps=1e-5)
                return F.leaky_relu(y, 0.01) if act else y
            same_twice(torch, "instnorm_bwd", shape, instnorm.instance_norm_bwd,
                       (x, g, mean, rstd, s, bb, act))
            record(torch, ops, rows, "instnorm_bwd", f"{list(shape)} act={act}",
                   dn, instnorm.instance_norm_bwd,
                   (x, g, mean, rstd, s, bb, act),
                   grad_call(torch, lib_fwd, (nchw(x), s, bb), nchw(g)),
                   flops=12 * x.numel(),
                   nbytes=3 * x.numel() * isz + 6 * 4 * c + 2 * 4 * b * c,
                   iters=20, peak=PEAK_F32_CORES,
                   extra={"plan": norm_plan(instnorm, "bwd", shape, dt)})
        # K5: float32 at the dw of decoder level 0 (32 -> 16), the first
        # block (8 -> 16) and the bottleneck (128 -> 256 at 16^2);
        # bfloat16 at every conv of the step
        for (h, ci, co) in F32_K5 if dt == torch.float32 else STEP_CONVS:
            b, w = 8, h
            x = cases.randn(b, h, w, ci, dtype=dt)
            g = cases.randn(b, h, w, co, dtype=dt)
            lib = lambda x=x, g=g, ci=ci, co=co: torch.nn.grad.conv2d_weight(
                nchw(x), (co, ci, 3, 3), nchw(g), padding=1)
            record(torch, ops, rows, "conv3x3_dw", f"{[b, h, w, ci]}->{co}",
                   dn, conv3x3.conv3x3_dw, (x, g), lib,
                   flops=2 * b * h * w * 9 * ci * co,
                   nbytes=b * h * w * (ci + co) * isz + 9 * ci * co * 4,
                   iters=10)
        # K2 as dx: float32 at the first block's conv1 (8 -> 16)
        # transposed, 16 -> 8; bfloat16 at every conv of the step
        for (h, ci, co) in F32_DX if dt == torch.float32 else STEP_CONVS:
            b, w = 8, h
            g = cases.randn(b, h, w, co, dtype=dt)
            wf = cases.conv_w(3, ci, co, dt)
            wt = conv3x3.flip_io(wf)
            lib = lambda g=g, wf=wf, b=b, h=h, ci=ci: \
                torch.nn.grad.conv2d_input((b, ci, h, h),
                                           wf.permute(3, 2, 0, 1), nchw(g),
                                           padding=1)
            record(torch, ops, rows, "conv3x3_dx", f"{[b, h, w, co]}->{ci}",
                   dn, conv3x3.conv3x3_fwd, (g, wt), lib,
                   flops=2 * b * h * w * 9 * ci * co,
                   nbytes=(b * h * w * (ci + co) + 9 * ci * co) * isz,
                   iters=10)
        # K6: float32 at decoder level 0 (32 -> 16), the first block
        # (8 -> 16) and the identity form 64 -> 64 at 64^2; bfloat16 at the
        # nine blocks and the identity form
        for (h, ci, co) in F32_K6 if dt == torch.float32 else (
                *UNET_BLOCKS, (64, 64, 64)):
            b, w = 8, h
            args = cases.block_args(b, h, w, ci, co, dt)
            x, w1, s1, _, w2, s2, _, ws, ss, _ = args
            _, res = block.basic_block_fwd(*args, save=True)
            g = cases.randn(b, h, w, co, dtype=dt)
            short = ws is not None
            form = "shortcut" if short else "identity"
            macs = 9 * ci * co + 9 * co * co + (ci * co if short else 0)
            maps = (4 if short else 3) * co + 2 * ci
            record(torch, ops, rows, "block_bwd",
                   f"{form} {[b, h, w, ci]}->{co}", dn, block.basic_block_bwd,
                   (g, x, w1, s1, w2, s2, ws, ss, res),
                   grad_call(torch, lambda *a: library_block(F, *a), args,
                             nchw(g)),
                   flops=4 * b * h * w * macs,
                   nbytes=b * h * w * maps * isz + macs * (isz + 4)
                   + 4 * (6 * co + 12 * b * co), iters=5)
    return rows


def check_mma_kernels(torch, F, ops, conv_mma):
    """Phase 2c: the tensor-core conv kernels against their plain version
    (bfloat16), timed beside cuDNN's conv on the channels-last view; K7, K8
    and K9 (dots, im2col, im2col2) two runs bit for bit at each strip, and
    strip 32 bit for bit with strip 16, at MMA_SHAPES (K7 alone at C 128,
    on its mma.sync kernel); K7's route at each shape."""
    rows = []
    cases = Cases(torch, seed=2)
    for (b, h, w, c, co), kernel, variants in MMA_SHAPES:
        x = cases.randn(b, h, w, c, std=0.1, dtype=torch.bfloat16)
        wt = cases.randn(3, 3, c, co, std=0.05, dtype=torch.bfloat16)
        lib = lambda x=x, wt=wt: F.conv2d(x.permute(0, 3, 1, 2),
                                          wt.permute(3, 2, 0, 1), padding=1)
        route = conv_mma.dots_route(b, h, w, c, co)
        print(f"conv3x3_dots {[b, h, w, c]}->{co}: route {route}", flush=True)
        if route != kernel:
            raise AssertionError(f"conv3x3_dots {[b, h, w, c]}: route {route}")
        for variant in variants:
            fn = getattr(conv_mma, f"conv3x3_{variant}")
            for strip in (16, 32):
                same_twice(torch, f"conv3x3_{variant} strip={strip}",
                           (b, h, w, c, co), lambda a, k: (fn(a, k, strip),),
                           (x, wt))
            if not torch.equal(fn(x, wt, 16), fn(x, wt, 32)):
                raise AssertionError(f"conv3x3_{variant} {[b, h, w, c]}: "
                                     f"strip 16 and 32 differ")
        for strip in (16, 32):
            for variant in variants:
                fn = getattr(conv_mma, f"conv3x3_{variant}")
                record(torch, ops, rows, f"conv3x3_{variant}",
                       f"{[b, h, w, c]}->{co} strip={strip}", "bfloat16",
                       lambda a, k, fn=fn, strip=strip: fn(a, k, strip),
                       (x, wt), lib, flops=2 * b * h * w * 9 * c * co,
                       nbytes=(b * h * w * (c + co) + 9 * c * co) * 2,
                       iters=20)
    return rows


def microbench(torch, counters):
    """Phase 5: the port's conv microbench at batch 16; returns its rows
    and the launch counts of its run."""
    from smsut_tpu_torch.tools import microbench_conv

    torch.cuda.synchronize()
    zero(counters, {})
    rows = microbench_conv.main(["16", str(MB_ITERS)])
    torch.cuda.synchronize()
    counts = {k: c.launches for k, c in counters.items()}
    want = {k: MB_CALLS.get(k, 0) * (MB_ITERS + 3) for k in KERNELS}
    print(f"microbench launches {counts} (expected {want})", flush=True)
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    if [r["name"] for r in rows] != [n for n, _ in
                                     microbench_conv.candidates()]:
        raise AssertionError(f"microbench rows {rows}")
    return {"rows": rows, "launches": counts, "iters": MB_ITERS}


def profile_device(torch, fn, n: int = 5) -> dict:
    """Device time per call of ``fn`` by kernel (torch.profiler, mean of n
    calls).  Only device kernels are summed: an operator's entry repeats
    the time of the kernels it launched."""
    from smsut_tpu_torch.tools.profile_step import device_rows

    fn()
    torch.cuda.synchronize()
    rows, wall = device_rows(torch, fn, n)
    return {"profiled_wall_ms": wall,
            "device_ms": sum(r[1] for r in rows),
            "kernels_per_call": sum(r[2] for r in rows), "top": rows[:16]}


def sass_ops(path: Path) -> dict:
    """Per kernel of a built library, its count of each SASS_OPS opcode
    (HMMA: mma.sync, HGMMA: wgmma, UTMALDG: a TMA load), from
    ``cuobjdump -sass``; None where the tool is missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300).stdout
    counts, fn = {}, None
    op = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    for line in out.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS, 0)
        elif fn is not None:
            for m in op.findall(line):
                counts[fn][m] += 1
    return counts


def ptxas_kernel(log: str, kernel: str) -> dict:
    """ptxas's registers (at the kernel's entry: setmaxnreg moves them
    later), spill stores and loads of the one kernel of a library's
    ``-Xptxas -v`` log whose mangled name holds ``kernel``."""
    blocks = log.split("Compiling entry function")[1:]
    mine = [b for b in blocks if kernel in b.split("\n", 1)[0]]
    if len(mine) != 1:
        raise AssertionError(f"ptxas log: {len(mine)} entries for {kernel}")
    b = mine[0]
    num = lambda pat: int(re.search(pat, b).group(1))
    return {"registers": num(r"Used (\d+) registers"),
            "spill_stores": num(r"(\d+) bytes spill stores"),
            "spill_loads": num(r"(\d+) bytes spill loads")}


def zero(counters, routed) -> None:
    for c in counters.values():
        c.launches = 0
    for c in routed.values():
        c.routed = 0


def routed_counts(routed) -> dict:
    return {k: c.routed for k, c in routed.items()}


def serve_modes(torch, ops, counters, routed):
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
        zero(counters, routed)
        lat = []
        logits = []
        for img in imgs:
            t0 = time.perf_counter()
            y = predict(img)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            logits.append(y)
        counts = {k: c.launches for k, c in counters.items()}
        want = {k: PER_FORWARD[fused].get(k, 0) * REQUESTS for k in KERNELS}
        rc = routed_counts(routed)
        q1, med, q3 = statistics.quantiles(lat[1:], n=4)
        print(f"serve block_pallas={fused}: launches {counts} "
              f"(expected {want}), routed {rc}; latency per batch of 8: first "
              f"{lat[0]:.3f} ms, then median {med:.3f} ms, quartiles "
              f"{q1:.3f}-{q3:.3f}", flush=True)
        if counts != want or any(rc.values()):
            raise AssertionError(f"launch counts {counts} != {want}, or "
                                 f"routed {rc}")
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
        results[fused] = {"launches": counts, "routed": rc, "latency_ms": lat,
                          "median_ms": med, "quartiles_ms": [q1, q3],
                          "checks": checks,
                          "profile": profile_device(
                              torch, lambda: predict(imgs[0]))}
        p = results[fused]["profile"]
        p["idle_share"] = 1 - p["device_ms"] / results[fused]["median_ms"]
        top = "; ".join(f"{n[:48]} {ms:.3f} ms x{k}" for n, ms, k in p["top"][:4])
        print(f"profile block_pallas={fused}: device busy {p['device_ms']:.3f} "
              f"ms per forward, idle share {p['idle_share']:.3f} of the median "
              f"latency; top: {top}", flush=True)
    return results


def ellipse_batch(np, b: int = 8, hw: int = 256, seed: int = 0):
    """A fixed batch the loss can fall on: each slice holds four filled
    ellipses labelled 1-4 on background 0, and its image is the label map's
    intensities plus noise, normalised to [-1, 1].  Not a dataset."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    msk = np.zeros((b, hw, hw), np.int32)
    for i in range(b):
        for lab in range(1, 5):
            cy, cx = rng.uniform(0.2, 0.8, 2) * hw
            ry, rx = rng.uniform(0.06, 0.18, 2) * hw
            msk[i][((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] = lab
    img = msk * 0.2 - 0.5 + rng.normal(0, 0.1, msk.shape)
    return {"img": img[..., None].astype(np.float32), "msk": msk}


def step1_grads(ops, algo, batch):
    """Step-1 gradients of every parameter: kernel path, plain path."""
    params = algo.init_params(seed=0)
    _, got = algo.value_and_grad(params, batch)
    with ops.plain():
        _, want = algo.value_and_grad(params, batch)
    for k, w in want.items():
        if got.get(k) is None or got[k].shape != w.shape:
            raise AssertionError(f"gradient of {k} missing on the kernel path")
    return got, want


def grad_parity(got, want) -> dict:
    """Per tensor rel_err, L2 and cosine, and L2 over all tensors."""
    rel, l2, cos = {}, {}, {}
    diff2 = norm2 = 0.0
    for k, w in want.items():
        rel[k] = rel_err(got[k], w)
        g, w = got[k].double(), w.double()
        d2, w2 = float(((g - w) ** 2).sum()), float((w * w).sum())
        diff2, norm2 = diff2 + d2, norm2 + w2
        l2[k] = (d2 / w2) ** 0.5
        cos[k] = float((g * w).sum() / (g.norm() * w.norm()))
    return {"rel_max": max(rel.values()), "worst_rel": max(rel, key=rel.get),
            "l2_all": (diff2 / norm2) ** 0.5,
            "l2_tensor_max": max(l2.values()), "worst_l2": max(l2, key=l2.get),
            "cos_min": min(cos.values()), "worst_cos": min(cos, key=cos.get),
            "n": len(rel)}


def bf16_accuracy(k16, p16, p32) -> dict:
    """Per tensor, ||K_bf16 - P_f32|| / ||P_f32|| against the plain path's
    ||P_bf16 - P_f32|| / ||P_f32||; the worst margin over the bound."""
    worst, rows = None, {}
    for k, ref in p32.items():
        r = ref.double()
        n = float(r.norm())
        ek = float((k16[k].double() - r).norm()) / n
        ep = float((p16[k].double() - r).norm()) / n
        rows[k] = (ek, ep)
        over = ek - (BF16_ACC * ep + 1e-3)
        if worst is None or over > worst[1]:
            worst = (k, over)
    return {"worst": worst[0], "worst_over": worst[1],
            "kernel_err": rows[worst[0]][0], "plain_err": rows[worst[0]][1],
            "kernel_err_max": max(e for e, _ in rows.values()),
            "plain_err_max": max(e for _, e in rows.values())}


def train_modes(torch, ops, counters, routed):
    """Phase 4: the full-width training step in both block modes."""
    import numpy as np

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.tools.profile_step import step_profile
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    batch = ellipse_batch(np)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    results = {}
    for fused in (False, True):
        cfg = lambda dtn: Config(input_size=256, base_width=16, batch_size=8,
                                 compute_dtype=dtn, block_pallas=fused)
        algo = SupervisedUNet(cfg("bfloat16"))
        state = algo.init_state(seed=0)
        torch.cuda.synchronize()
        zero(counters, routed)
        losses, step_ms = [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            state, m = algo.train_step(state, batch, {})
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {k: c.launches for k, c in counters.items()}
        want = {k: STEPS * PER_STEP[fused].get(k, 0) for k in KERNELS}
        rc = routed_counts(routed)
        med = statistics.median(step_ms[1:])
        q1, _, q3 = statistics.quantiles(step_ms[1:], n=4)
        print(f"train block_pallas={fused}: launches {counts} (expected "
              f"{want}), routed {rc}; losses {[round(x, 5) for x in losses]}; "
              f"step time first {step_ms[0]:.3f} ms, then median {med:.3f} "
              f"ms, quartiles {q1:.3f}-{q3:.3f}", flush=True)
        if counts != want or any(rc.values()):
            raise AssertionError(f"launch counts {counts} != {want}, or "
                                 f"routed {rc}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"loss not finite and falling: {losses}")
        prof = step_profile(
            torch, lambda: algo.train_step(state, batch, {}), fused, step_ms)
        top = "; ".join(f"{n[:48]} {ms:.3f} ms x{k}"
                        for n, ms, k in prof["top"][:5])
        print(f"profile train block_pallas={fused}: device busy "
              f"{prof['device_ms']:.3f} ms per step in "
              f"{prof['kernels_per_step']} kernels, idle share "
              f"{prof['idle_share']:.3f} of the median step; top: {top}",
              flush=True)
        fn = prof["functions"]
        ran = {n: v for n, v in fn.items() if v[1]}
        print(f"profile train block_pallas={fused}: device ms per step "
              "(launches) " + "; ".join(
                  f"{n} {ms:.4f} ({k})" for n, (ms, k) in ran.items())
              + "; " + ", ".join(f"{k} {ms:.4f} ms"
                                 for k, ms in prof["families_ms"].items())
              + (" (K6 holds the stem norm's K4 launches)" if fused else "")
              + f", other {prof['other_ms']:.4f} ms", flush=True)
        if any(fn[n][1] for n in CUDA_CORE_CONVS):
            raise AssertionError(f"bf16 step ran a CUDA-core conv: {fn}")
        k32, p32 = step1_grads(ops, SupervisedUNet(cfg("float32")), batch)
        k16, p16 = step1_grads(ops, SupervisedUNet(cfg("bfloat16")), batch)
        checks = {"float32": grad_parity(k32, p32),
                  "bfloat16": grad_parity(k16, p16),
                  "bfloat16_vs_float32": bf16_accuracy(k16, p16, p32)}
        for dtn in ("float32", "bfloat16"):
            c = checks[dtn]
            print(f"train block_pallas={fused} {dtn}: step-1 gradients of "
                  f"{c['n']} tensors vs the plain path: rel err max "
                  f"{c['rel_max']:.3g} ({c['worst_rel']}), L2 of all "
                  f"{c['l2_all']:.3g}, L2 per tensor max "
                  f"{c['l2_tensor_max']:.3g} ({c['worst_l2']}), cosine min "
                  f"{c['cos_min']:.6f} ({c['worst_cos']})", flush=True)
        a = checks["bfloat16_vs_float32"]
        print(f"train block_pallas={fused} bfloat16 vs the float32 plain "
              f"gradient: kernel path err max {a['kernel_err_max']:.3g}, "
              f"plain path err max {a['plain_err_max']:.3g}; closest to the "
              f"bound {a['worst']}: kernel {a['kernel_err']:.3g} vs plain "
              f"{a['plain_err']:.3g} (bound {BF16_ACC} x plain + 1e-3)",
              flush=True)
        c = checks["float32"]
        if not (c["rel_max"] <= GRAD_REL and c["l2_all"] <= GRAD_REL
                and c["cos_min"] >= GRAD_COS and a["worst_over"] <= 0):
            raise AssertionError(f"gradients disagree: {checks}")
        a32 = SupervisedUNet(cfg("float32"))
        runs = []
        for plain in (False, True):
            st, ls = a32.init_state(seed=0), []
            with ops.plain() if plain else contextlib.nullcontext():
                for _ in range(3):
                    st, m = a32.train_step(st, batch, {})
                    ls.append(float(m["loss"]))
            runs.append(ls)
        lerr = max(abs(a - b) / abs(b) for a, b in zip(*runs))
        print(f"train block_pallas={fused} float32: first 3 losses "
              f"{runs[0]} vs plain {runs[1]}, rel err {lerr:.3g} (tol "
              f"{LOSS_TOL})", flush=True)
        if not lerr <= LOSS_TOL:
            raise AssertionError(f"float32 losses disagree: {runs}")
        results[fused] = {"launches": counts, "routed": rc, "losses": losses,
                          "step_ms": step_ms, "median_ms": med,
                          "quartiles_ms": [q1, q3], "profile": prof,
                          "grad_checks": checks, "f32_losses": runs}
    return results


def train_w8(torch, ops, counters, routed):
    """Phase 4, width 8: the shapes the kernels do not take go to plain
    PyTorch.  W8_STEPS steps in both block modes, their launch and routed
    counts, and the float32 step-1 gradients against the plain path."""
    import numpy as np

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    batch = {k: torch.from_numpy(v).cuda()
             for k, v in ellipse_batch(np).items()}
    results = {}
    for fused in (False, True):
        cfg = lambda dtn: Config(input_size=256, base_width=8, batch_size=8,
                                 compute_dtype=dtn, block_pallas=fused)
        algo = SupervisedUNet(cfg("bfloat16"))
        state = algo.init_state(seed=0)
        torch.cuda.synchronize()
        zero(counters, routed)
        losses = []
        for _ in range(W8_STEPS):
            state, m = algo.train_step(state, batch, {})
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items()}
        want = {k: W8_STEPS * PER_STEP_W8[fused].get(k, 0) for k in KERNELS}
        rc = routed_counts(routed)
        want_rc = {k: W8_STEPS * v for k, v in ROUTED_W8[fused].items()}
        print(f"train w8 block_pallas={fused}: launches {counts} (expected "
              f"{want}), routed {rc} (expected {want_rc}); losses "
              f"{[round(x, 5) for x in losses]}", flush=True)
        if counts != want or rc != want_rc:
            raise AssertionError(f"w8 counts {counts}, {rc}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"w8 loss not finite: {losses}")
        c = grad_parity(*step1_grads(ops, SupervisedUNet(cfg("float32")),
                                     batch))
        print(f"train w8 block_pallas={fused} float32: step-1 gradients of "
              f"{c['n']} tensors vs the plain path: rel err max "
              f"{c['rel_max']:.3g} ({c['worst_rel']}), L2 of all "
              f"{c['l2_all']:.3g}, cosine min {c['cos_min']:.6f} "
              f"({c['worst_cos']})", flush=True)
        if not (c["rel_max"] <= GRAD_REL and c["l2_all"] <= GRAD_REL
                and c["cos_min"] >= GRAD_COS):
            raise AssertionError(f"w8 gradients disagree: {c}")
        results[fused] = {"launches": counts, "routed": rc, "losses": losses,
                          "grad_check": c}
    return results


def fit_args(data: Path, expr: Path, name: str, *sets) -> list:
    """The trainer CLI's arguments for phase 6a's runs."""
    args = ["--data_root", str(data), "--expr_root", str(expr), "-nm", name]
    for kv in ("input_size=256", "base_width=16", "batch_size=8",
               "compute_dtype=bfloat16", f"num_iter_per_epoch={FIT_ITERS}",
               f"max_epoch={FIT_EPOCHS}", "device_augment=True",
               "num_workers=4") + sets:
        args += ["--set", kv]
    return args


@contextlib.contextmanager
def epoch_clock(spans: list):
    """Record the host clock's (start, end) of every ``Trainer.train_epoch``
    call, the epoch's one read of its metrics included: an epoch's wall
    time over its iterations is the loop's time per iteration (with
    ``steps_per_dispatch`` the iterations leave in bursts, so the gaps
    between them say nothing)."""
    from smsut_tpu_torch.train.loop import Trainer

    epoch = Trainer.train_epoch

    def timed(self, *a):
        t0 = time.perf_counter()
        try:
            return epoch(self, *a)
        finally:
            spans.append((t0, time.perf_counter()))

    Trainer.train_epoch = timed
    try:
        yield
    finally:
        Trainer.train_epoch = epoch


def per_iteration_ms(span, iters: int) -> float:
    return (span[1] - span[0]) * 1e3 / iters


def quartiles(xs) -> tuple:
    q1, med, q3 = statistics.quantiles(xs, n=4)
    return statistics.median(xs), q1, q3


def fit_cli(torch, counters, routed, data: Path) -> dict:
    """Phase 6a: train through ``run_main`` in both block modes, then the
    test phase through the module CLI in a subprocess."""
    import numpy as np

    from smsut_tpu_torch.train.cli import make_parser, run_main
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    expr = FIT_DIR / "expr"
    results = {}
    for fused in (False, True):
        name = f"fit_block{int(fused)}"
        args = fit_args(data, expr, name, f"block_pallas={fused}")
        spans = []
        torch.cuda.synchronize()
        zero(counters, routed)
        with epoch_clock(spans):
            run_main(SupervisedUNet,
                     make_parser().parse_args(["-p", "train"] + args))
        torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items()}
        rc = routed_counts(routed)
        steps = FIT_EPOCHS * FIT_ITERS
        fwd = FIT_EPOCHS * FIT_TEST_BATCHES
        want = {k: steps * PER_STEP[fused].get(k, 0)
                + fwd * PER_FORWARD[fused].get(k, 0) for k in KERNELS}
        model = expr / name / "000"
        log = (model / "train.log").read_text()
        losses = [float(x) for x in re.findall(r"\[TRN\].* loss: ([^/]+)/",
                                               log)]
        ckpt = torch.load(model / "ckpt" / "last.ckpt", map_location="cpu",
                          weights_only=True)
        period = per_iteration_ms(spans[1], FIT_ITERS)
        print(f"fit block_pallas={fused}: launches {counts} (expected {want}),"
              f" routed {rc}; steps {ckpt['step']}; [TRN] losses {losses}; "
              f"epoch-1 ms per iteration (its wall time over {FIT_ITERS}) "
              f"{period:.3f}", flush=True)
        if counts != want or any(rc.values()):
            raise AssertionError(f"fit launches {counts} != {want}, or "
                                 f"routed {rc}")
        if (ckpt["step"] != steps or len(losses) != FIT_EPOCHS
                or not np.isfinite(losses).all()
                or log.count("[TST]") != FIT_EPOCHS
                or not (model / "ckpt" / "best.ckpt").is_file()
                or "fit_block" not in (expr / "expriments.log").read_text()):
            raise AssertionError(f"fit artifacts of {model}: step "
                                 f"{ckpt['step']}, losses {losses}")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "smsut_tpu_torch.trainer.unetTrainer",
             "-p", "test", "-i", "000", "-wh", "best"] + args, cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        test_s = time.perf_counter() - t0
        if out.returncode:
            raise AssertionError(f"-p test failed:\n{out.stderr[-3000:]}")
        rows = [r for r in (model / "all_trois_matrix.csv").read_text()
                .split("\n") if r]
        vals = np.array([[float(v) for v in r.split(",")] for r in rows])
        metrics_s = float(re.search(r"Test metrics cost ([0-9.]+)s",
                                    out.stdout).group(1))
        print(f"fit block_pallas={fused}: -p test in {test_s:.1f} s (host "
              f"metrics {metrics_s:.3f} s); CSV {vals.shape}, mean Dice "
              f"{vals[4, 4]:.4f}", flush=True)
        if vals.shape != (10, 5) or not np.isfinite(vals).all():
            raise AssertionError(f"trois CSV {vals.shape}: {rows}")
        results[fused] = {"launches": counts, "routed": rc,
                          "losses": losses, "step": ckpt["step"],
                          "period_ms": period, "test_s": test_s,
                          "test_metrics_s": metrics_s, "csv": vals.tolist()}
    return results


def fit_parity(torch, ops, data: Path) -> dict:
    """Phase 6b: one batch stream through the Trainer with the kernels and
    under ``ops.plain()``, float32."""
    import numpy as np

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.experiment import Experiment
    from smsut_tpu_torch.train.loop import Trainer
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    cfg = Config(base_root=str(data), expr_root=str(FIT_DIR / "expr"),
                 input_size=256, base_width=16, batch_size=8,
                 compute_dtype="float32", num_iter_per_epoch=PARITY_ITERS,
                 max_epoch=FIT_EPOCHS, device_augment=False, data_aug={},
                 num_workers=4)
    runs = {}
    for plain in (False, True):
        algo = SupervisedUNet(cfg)
        sums, scal = [], {}
        step = algo.step

        def recording(state, batch, scalars, step=step, sums=sums):
            sums.append(batch["img"].double().sum())
            return step(state, batch, scalars)

        algo.step = recording
        # eager: the recording reads every iteration's batch
        trainer = Trainer(algo, cfg, "train", experiment=Experiment(
            cfg.expr_root, f"parity_plain{int(plain)}"), capture=False)
        trainer.exp.scalar = (lambda tag, v, e, scal=scal:
                              scal.setdefault(tag, {}).__setitem__(e, float(v)))
        with ops.plain() if plain else contextlib.nullcontext():
            trainer.fit()
        trainer.exp.close()
        runs[plain] = (scal, torch.stack(sums).cpu().tolist())
    (k, ksums), (p, psums) = runs[False], runs[True]
    mods = ("ct", "t1in", "t1out", "t2")
    loss_rel = max(abs(k["train/loss"][e] - p["train/loss"][e])
                   / abs(p["train/loss"][e]) for e in range(FIT_EPOCHS))
    dice = {m: max(abs(k[f"test/dice_{m}"][e] - p[f"test/dice_{m}"][e])
                   for e in range(FIT_EPOCHS)) for m in mods}
    dice_all = max(abs(k["test/dice"][e] - p["test/dice"][e])
                   for e in range(FIT_EPOCHS))
    best = lambda d: max(range(FIT_EPOCHS),
                         key=lambda e: (d["test/dice"][e], e))
    print(f"fit float32 kernels vs plain: [TRN] losses "
          f"{[k['train/loss'][e] for e in range(FIT_EPOCHS)]} vs "
          f"{[p['train/loss'][e] for e in range(FIT_EPOCHS)]}, rel err "
          f"{loss_rel:.3g} (tol {LOSS_TOL}); [TST] Dice err per modality "
          f"{dice} (tol {PARITY_DICE_TOL}), overall {dice_all:.3g} (tol "
          f"{PARITY_DICE_ALL}); best epoch {best(k)} vs {best(p)}; same "
          f"stream {ksums == psums}", flush=True)
    if not (ksums == psums and loss_rel <= LOSS_TOL
            and max(dice.values()) <= PARITY_DICE_TOL
            and dice_all <= PARITY_DICE_ALL and best(k) == best(p)):
        raise AssertionError(f"fit kernels vs plain: {runs}")
    return {"kernels": k, "plain": p, "loss_rel": loss_rel,
            "dice_err": dice, "dice_all_err": dice_all}


def augment_card_vs_cpu(torch, data: Path) -> dict:
    """Phase 6c: DeviceAugment on the card and on the CPU, same packed
    parameters; its device time per batch."""
    import random

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.data.dataset import SliceDataset
    from smsut_tpu_torch.data.device_augment import DeviceAugment

    img, msk = SliceDataset(str(data), "train", 0).gather_batch_u8(range(8))
    cfg = Config()
    card = DeviceAugment(cfg, random.Random(7))
    cpu = DeviceAugment(cfg, device="cpu")
    gimg, gmsk = torch.from_numpy(img).cuda(), torch.from_numpy(msk).cuda()
    cimg, cmsk = torch.from_numpy(img), torch.from_numpy(msk)
    worst, off, ties, total = 0.0, 0, 0, 0
    for _ in range(4):
        packed = torch.from_numpy(card.sample_params_packed(8, 256, 256))
        gi, gm = card.apply(gimg, gmsk, packed.cuda())
        ci, cm = cpu.apply(cimg, cmsk, packed)
        worst = max(worst, float((gi.cpu() - ci).abs().max()))
        sy, sx = cpu.source_coords(packed, 256, 256)
        tie = (((sy - sy.floor() - 0.5).abs() < TIE_EPS)
               | ((sx - sx.floor() - 0.5).abs() < TIE_EPS))
        bad = gm.cpu() != cm
        if bool((bad & ~tie).any()):
            raise AssertionError("DeviceAugment mask differs off a tie")
        off, ties, total = (off + int(bad.sum()), ties + int(tie.sum()),
                            total + bad.numel())
    gpacked = packed.cuda()
    # device time from the profiler: a call is about 90 small launches, so
    # a chain long enough for time_ms would fill the launch queue behind
    # its sleep kernel and time the host instead
    prof = profile_device(torch, lambda: card.apply(gimg, gmsk, gpacked))
    ms = prof["device_ms"]
    print(f"fit DeviceAugment card vs CPU: image max err {worst:.3g} (tol "
          f"{AUG_TOL}); mask pixels off {off} of {total} (share "
          f"{off / total:.3g}), all at ties (share of pixels within "
          f"{TIE_EPS} of a tie {ties / total:.3g}); device "
          f"{ms:.4f} ms per batch of 8 at 256^2 in "
          f"{prof['kernels_per_call']} kernels; top: " + "; ".join(
              f"{n[:40]} {t:.4f} ms x{k}" for n, t, k in prof["top"][:4]),
          flush=True)
    if not worst <= AUG_TOL:
        raise AssertionError(f"DeviceAugment image err {worst}")
    return {"img_err": worst, "mask_off": off, "tie_pixels": ties,
            "pixels": total, "device_ms": ms, "profile": prof}


@contextlib.contextmanager
def sync_checked_epoch(torch, index: int):
    """Run the Trainer's ``index``-th training epoch (not the epoch's final
    read of the losses) under ``set_sync_debug_mode("error")``, which
    raises on any call that waits on the card."""
    from smsut_tpu_torch.train.loop import Trainer

    epoch, drain = Trainer.train_epoch, Trainer._drain

    def watched(self, *a):
        if self.epoch == index:
            torch.cuda.set_sync_debug_mode("error")
        try:
            return epoch(self, *a)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def unwatched_drain(self, *a):
        torch.cuda.set_sync_debug_mode(0)
        return drain(self, *a)

    Trainer.train_epoch, Trainer._drain = watched, unwatched_drain
    try:
        yield
    finally:
        Trainer.train_epoch, Trainer._drain = epoch, drain


def fit_watched(torch, data: Path, fused: bool) -> dict:
    """Phase 6d: a fit of three epochs: the second's iterations run under
    ``set_sync_debug_mode("error")`` (:func:`sync_checked_epoch`) and give
    the loop's time per iteration, the third runs under the profiler and
    gives its device time per iteration; the eval sweep's time."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.tools.profile_step import device_rows
    from smsut_tpu_torch.train.experiment import Experiment
    from smsut_tpu_torch.train.loop import Trainer
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    cfg = Config(base_root=str(data), expr_root=str(FIT_DIR / "expr"),
                 input_size=256, base_width=16, batch_size=8,
                 compute_dtype="bfloat16", num_iter_per_epoch=WATCH_ITERS,
                 max_epoch=3, num_workers=4, block_pallas=fused)
    spans, eval_s, prof = [], [], {}
    trainer = Trainer(SupervisedUNet(cfg), cfg, "train",
                      experiment=Experiment(cfg.expr_root,
                                            f"watched{int(fused)}"))
    validate = trainer.validate_epoch

    def timed_validate(*a):
        t0 = time.perf_counter()
        out = validate(*a)
        eval_s.append(time.perf_counter() - t0)
        return out

    with sync_checked_epoch(torch, 1), epoch_clock(spans):
        epoch = trainer.train_epoch

        def profiled_epoch(*a):
            if trainer.epoch != 2:
                return epoch(*a)
            rows, wall = device_rows(torch, lambda: epoch(*a), 1)
            prof.update(rows=rows[:8], wall_ms=wall,
                        device_ms=sum(r[1] for r in rows),
                        kernels=sum(r[2] for r in rows))
            return None

        trainer.train_epoch = profiled_epoch
        trainer.validate_epoch = timed_validate
        trainer.fit()
    trainer.exp.close()
    per_iter = per_iteration_ms(spans[1], WATCH_ITERS)
    device = prof["device_ms"] / WATCH_ITERS
    return {"ms_per_iter": per_iter,
            "device_ms_per_iter": device,
            "kernels_per_iter": prof["kernels"] / WATCH_ITERS,
            "idle_share": 1 - device / per_iter, "profiled_epoch": prof,
            "eval_ms_per_batch": eval_s[-1] / FIT_TEST_BATCHES * 1e3,
            "eval_s": eval_s}


def fit_loop(torch, ops, counters, routed, train, card) -> dict:
    """Phase 6: the fit loop, 6a-6d."""
    from smsut_tpu_torch.data.synthetic import make_synthetic_dataset

    shutil.rmtree(FIT_DIR, ignore_errors=True)
    data = FIT_DIR / "data"
    make_synthetic_dataset(str(data), n_patients_per_modality=3, n_slice=8,
                           size=256)
    cli = fit_cli(torch, counters, routed, data)
    parity = fit_parity(torch, ops, data)
    aug = augment_card_vs_cpu(torch, data)
    watched = {}
    for fused in (False, True):
        torch.cuda.synchronize()
        zero(counters, routed)
        w = watched[fused] = fit_watched(torch, data, fused)
        torch.cuda.synchronize()
        w["launches"] = {k: c.launches for k, c in counters.items()}
        bare = train[fused]["median_ms"]
        print(f"fit loop on {card}: bfloat16, w16, batch 8, device augment, "
              f"steps_per_dispatch 8 and eval_scan (replayed graphs), "
              f"block_pallas={fused}: {w['ms_per_iter']:.3f} ms per "
              f"iteration (epoch 2's wall time over its {WATCH_ITERS} "
              f"iterations; no host wait: set_sync_debug_mode error passed); "
              f"phase 4's eager bare train_step median {bare:.3f} ms: "
              f"difference {w['ms_per_iter'] - bare:.3f} ms; device "
              f"{w['device_ms_per_iter']:.3f} ms per iteration in "
              f"{w['kernels_per_iter']:.0f} kernels (epoch 3, profiled), "
              f"idle share {w['idle_share']:.3f}; eval sweep "
              f"{w['eval_ms_per_batch']:.3f} ms per batch", flush=True)
    print(f"fit loop on {card}: DeviceAugment {aug['device_ms']:.4f} device "
          f"ms per batch; test phase host metrics {cli[False]['test_metrics_s']:.3f}"
          f" / {cli[True]['test_metrics_s']:.3f} s", flush=True)
    return {"cli": cli, "parity": parity, "augment": aug,
            "watched": {str(k): v for k, v in watched.items()}}


def gan_double_backward(torch, ops, counters, routed) -> dict:
    """Phase 7a: the gradient penalty's D-parameter gradients (through
    ``create_graph=True``) at the discriminator's full width on x_hat
    [16,256,256,1], float32, kernels vs ``ops.plain()``, and both against
    the plain path in float64; the lrelu sign flips between the runs; the
    launches of the D forward and of the second backward."""
    from smsut_tpu_torch.models.blocks import BottleBlock
    from smsut_tpu_torch.models.layers import NormAct
    from smsut_tpu_torch.models.ugan import Discriminator
    from smsut_tpu_torch.ops.instnorm import instance_norm

    D = Discriminator(256, 4, 16, 256, compute_dtype=torch.float32,
                      device="cuda", seed=0)
    params = {k: v.detach() for k, v in D.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    x_hat = torch.randn((16, 256, 256, 1), device="cuda", generator=gen)
    n_norms = sum(1 for m in D.modules() if isinstance(m, NormAct))
    # the lrelu inputs' signs: the stem's, each bn1 (norm + lrelu) and
    # block output
    signs, run = {}, None
    hooks = [m.register_forward_hook(
        lambda mod, i, o, name=name: signs.setdefault(run, {}).__setitem__(
            name, o.detach() >= 0))
        for name, m in D.named_modules()
        if m is D.stem or isinstance(m, BottleBlock)
        or (isinstance(m, NormAct) and m.act)]
    runs = {}
    for run, dt in (("kernel", torch.float32), ("plain", torch.float32),
                    ("exact", torch.float64)):
        D.compute_dtype = dt
        leaves = {k: v.to(dt).requires_grad_() for k, v in params.items()}
        xh = x_hat.to(dt).requires_grad_()
        with (contextlib.nullcontext() if run == "kernel" else ops.plain()):
            torch.cuda.synchronize()
            zero(counters, routed)
            src, _ = torch.func.functional_call(D, leaves, (xh,))
            dydx, = torch.autograd.grad(src.sum(), xh, create_graph=True)
            gp = (dydx.reshape(16, -1).square().sum(1).sqrt() - 1.0
                  ).square().mean()
            torch.cuda.synchronize()
            first = {k: c.launches for k, c in counters.items()}
            rc = routed_counts(routed)
            db = instance_norm.double_backward
            # the class head and the stem's bias do not reach dydx
            grads = torch.autograd.grad(gp, list(leaves.values()),
                                        allow_unused=True)
            torch.cuda.synchronize()
        second = {k: c.launches - first[k] for k, c in counters.items()}
        grads = {k: g for k, g in zip(leaves, grads) if g is not None}
        runs[run] = {"gp": gp.item(), "grads": grads,
                     "forward_and_first": first, "second": second,
                     "routed": rc,
                     "double_backward": instance_norm.double_backward - db}
    for h in hooks:
        h.remove()
    flips = {f"{a}_vs_{b}": {n: int((signs[a][n] != signs[b][n]).sum())
                             for n in signs[b]
                             if bool((signs[a][n] != signs[b][n]).any())}
             for a, b in (("kernel", "plain"), ("kernel", "exact"),
                          ("plain", "exact"))}
    k, p, x = runs["kernel"], runs["plain"], runs["exact"]
    # a norm bias behind a plain affine path reaches dydx only through an
    # lrelu mask: its gradient is zero on every path
    zeros = sorted(n for n, g in x["grads"].items() if not bool(g.any()))
    if (k["grads"].keys() != p["grads"].keys()
            or any(bool(r["grads"][n].any()) for n in zeros for r in (k, p))):
        raise AssertionError(f"GP gradients of {sorted(k['grads'])} vs "
                             f"{sorted(p['grads'])}, zero {zeros}")
    names = [n for n in x["grads"] if n not in zeros]
    c = grad_parity({n: k["grads"][n] for n in names},
                    {n: p["grads"][n] for n in names})
    err = {n: (rel_err(k["grads"][n], x["grads"][n]),
               rel_err(p["grads"][n], x["grads"][n])) for n in names}
    # an lrelu input that float32 rounding moves across 0 switches that
    # element's slope in the second order, a step no summation order
    # smooths: its layer's gradients and those of the layers after it
    # (stem 0, block i, then the heads) are held by cosine and L2 alone,
    # the rest per tensor by rel_err too
    layer = lambda n: (0 if n.startswith("stem") else int(n[5:n.index(".")])
                       if n.startswith("block") else D.n_blocks + 1)
    first_flip = min((layer(f + ".") for f in flips["kernel_vs_plain"]),
                     default=D.n_blocks + 2)
    held = {n: rel_err(k["grads"][n], p["grads"][n]) for n in names
            if layer(n) < first_flip}
    print(f"gan 7a: D w16 on x_hat [16,256,256,1] float32: GP {k['gp']:.6g} "
          f"(plain {p['gp']:.6g}, float64 {x['gp']:.10g}); its D-parameter "
          f"gradients of {c['n']} tensors vs the plain path: rel err max "
          f"{c['rel_max']:.3g} ({c['worst_rel']}), L2 of all "
          f"{c['l2_all']:.3g}, cosine min {c['cos_min']:.8f} "
          f"({c['worst_cos']}); rel err max against float64: kernel path "
          f"{max(e for e, _ in err.values()):.3g}, plain path "
          f"{max(e for _, e in err.values()):.3g}; lrelu sign flips "
          f"{flips}; rel err max of the {len(held)} tensors before the "
          f"first flip {max(held.values(), default=0.0):.3g}; zero on "
          f"every path: {zeros}; launches in the forward "
          f"and first backward {k['forward_and_first']}, in the second "
          f"backward {k['second']}; instance_norm.double_backward "
          f"{k['double_backward']} (norms {n_norms}); routed {k['routed']}",
          flush=True)
    sec, fwd = k["second"], k["forward_and_first"]
    if not (c["cos_min"] >= GRAD_COS and c["l2_all"] <= GRAD_REL
            and all(e <= GRAD_REL for e in held.values())):
        raise AssertionError(f"GP gradients disagree: {c}, {held}, {err}")
    if not (all(sec[n] > 0 for n in ("conv3x3", "conv3x3_dw", "instnorm_bwd"))
            and fwd["instnorm"] == n_norms
            and k["double_backward"] == n_norms == p["double_backward"]
            and k["routed"] == {"conv3x3": 1, "block": 0}
            and not any(p["second"].values())):
        raise AssertionError(f"7a launches {runs}")
    return {"gp": [k["gp"], p["gp"], x["gp"]], "grad_check": c,
            "rel_err_before_first_flip": held,
            "err_vs_float64": err, "sign_flips": flips, "norms": n_norms,
            "zero_grads": zeros,
            **{f"kernel_{n}": k[n] for n in ("forward_and_first", "second",
                                             "routed", "double_backward")}}


def gan_batch(torch, np) -> dict:
    """8 labelled (modality 1) + 8 unlabelled (modality 2) ellipse slices
    on the card."""
    lb, ul = ellipse_batch(np, seed=0), ellipse_batch(np, seed=1)
    return {"img": torch.from_numpy(lb["img"]).cuda(),
            "msk": torch.from_numpy(lb["msk"]).cuda(),
            "mdl": np.full(8, 1), "ul_img": torch.from_numpy(ul["img"]).cuda(),
            "ul_mdl": np.full(8, 2)}


def gan_f32_step(torch, ops, np, cfg, batch) -> dict:
    """7b's float32 check of step 1, kernels vs ``ops.plain()``: the D
    step from one init (its losses, and D after Adam flip-aware), then the
    G step of both paths against one D, the kernel path's updated one (its
    losses and the seg tower after SGD): Adam's sign flips in D would
    otherwise move the G losses taken through it."""
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    algo = UGANConsisAlgo(cfg)
    init = algo.init_state(0)
    g0, d0 = init.g_params, init.d_params
    b = dict(batch, **algo.make_extra_batch())
    scalars = algo.epoch_scalars(1)
    out = {}
    for plain in (False, True):
        with ops.plain() if plain else contextlib.nullcontext():
            st, dm = algo.d_step(algo.state_from_params(g0, d0),
                                 algo.step_inputs(algo.inputs(b)))
        out[plain] = [dm, st.d_params]
    d1 = out[False][1]
    for plain in (False, True):
        with ops.plain() if plain else contextlib.nullcontext():
            st, gm = algo.g_step(algo.state_from_params(g0, d1),
                                 algo.step_inputs(algo.inputs(b)), scalars)
        out[plain][0] = {k: v.item() for k, v in {**out[plain][0],
                                                   **gm}.items()}
        out[plain].append(st.g_params)
    (km, kd, kg), (pm, pd, pg) = out[False], out[True]
    loss_err = {n: abs(km[n] - pm[n]) - GAN_LOSS_RTOL * abs(pm[n])
                for n in GAN_NAMES}
    dev = torch.cat([(kd[k] - pd[k]).abs().flatten() for k in pd])
    seg = {k: float(((kg[k] - pg[k]).abs() - GAN_SEG_RTOL * pg[k].abs()
                     ).max()) for k in GAN_SEG_TOWER}
    return {"losses": km, "plain_losses": pm,
            "loss_over_rtol_max": max(loss_err.values()),
            "worst_loss": max(loss_err, key=loss_err.get),
            "d_dev_max": float(dev.max()),
            "d_flip_share": float((dev > cfg.lr).float().mean()),
            "seg_over_rtol_max": max(seg.values())}


def d_step_ops(torch, fn) -> list:
    """The 3 aten ops of one call of ``fn`` with the most device time of
    their own, with their input shapes, and the device time under the
    double backward of ``F.conv2d`` (the discriminator's stem):
    [(op, ms, shapes), ..., ("aten::_convolution_double_backward", ms)]."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.key.startswith("aten::")]
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:3]
    dd = sum(e.device_time_total for e in evs
             if e.key == "aten::_convolution_double_backward")
    return ([(e.key, e.self_device_time_total / 1e3, str(e.input_shapes))
             for e in top] + [("aten::_convolution_double_backward",
                               dd / 1e3)])


def gan_step_modes(torch, ops, counters, routed) -> dict:
    """Phase 7b: the uganConsis step at full width in both block modes."""
    import numpy as np

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.tools.profile_step import device_rows
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    batch = gan_batch(torch, np)
    results = {}
    for fused in (False, True):
        # the consistency gate open from step 0, so that every term of the
        # loss runs
        cfg = lambda dtn: Config(input_size=256, base_width=16, batch_size=8,
                                 compute_dtype=dtn, block_pallas=fused,
                                 consis_gate_step=0)
        algo = UGANConsisAlgo(cfg("bfloat16"))
        state = algo.init_state(0)
        b = dict(batch, **algo.make_extra_batch())
        scalars = algo.epoch_scalars(1)
        torch.cuda.synchronize()
        zero(counters, routed)
        losses, step_ms, per_step = [], [], None
        for i in range(GAN_STEPS):
            t0 = time.perf_counter()
            state, m = algo.train_step(state, b, scalars)
            losses.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                per_step = {k: c.launches for k, c in counters.items()}
        counts = {k: c.launches for k, c in counters.items()}
        rc = routed_counts(routed)
        med, q1, q3 = quartiles(step_ms[1:])
        seg = [x["G_seg"] for x in losses]
        print(f"gan 7b block_pallas={fused}: launches per step {per_step}, "
              f"routed {rc} in {GAN_STEPS} steps; G_seg "
              f"{[round(x, 5) for x in seg]}; D_gp "
              f"{[round(x['D_gp'], 3) for x in losses]}; step time first "
              f"{step_ms[0]:.3f} ms, then median {med:.3f} ms, quartiles "
              f"{q1:.3f}-{q3:.3f}", flush=True)
        if (counts != {k: GAN_STEPS * v for k, v in per_step.items()}
                or rc != {"conv3x3": 3 * GAN_STEPS, "block": 0}
                or not all(per_step[k] for k in (
                    ("instnorm", "instnorm_bwd", "conv3x3", "conv3x3_dw")
                    + (("block", "block_bwd") if fused else ())))):
            raise AssertionError(f"gan launches {counts}, routed {rc}")
        if not (all(np.isfinite(list(x.values())).all() for x in losses)
                and seg[-1] < seg[0]):
            raise AssertionError(f"gan losses not finite, or G_seg not "
                                 f"falling: {losses}")
        zero(counters, routed)
        algo.eval_fn(algo.eval_params(state), batch["img"])
        torch.cuda.synchronize()
        per_forward = {k: c.launches for k, c in counters.items()}
        step = lambda: algo.train_step(state, b, scalars)
        rows, _ = device_rows(torch, step, 3)
        device = sum(r[1] for r in rows)
        kernels = sum(r[2] for r in rows)
        inp = algo.step_inputs(algo.inputs(b))
        drows, _ = device_rows(torch, lambda: algo.d_step(state, inp), 3)
        d_ms = sum(r[1] for r in drows)
        d_ops = d_step_ops(torch, lambda: algo.d_step(state, inp))
        top = "; ".join(f"{n[:48]} {t:.3f} ms x{c}" for n, t, c in rows[:5])
        print(f"gan 7b block_pallas={fused}: device {device:.3f} ms per step "
              f"in {kernels} kernels, idle share {1 - device / med:.3f} of "
              f"the median step; D step (x_fake, D loss with the GP's "
              f"double backward, Adam) {d_ms:.3f} ms, share "
              f"{d_ms / device:.3f}; eval forward launches {per_forward}; "
              f"top: {top}", flush=True)
        print(f"gan 7b block_pallas={fused}: D step's aten ops by device "
              f"ms (input shapes): {d_ops}", flush=True)
        f32 = gan_f32_step(torch, ops, np, cfg("float32"), batch)
        print(f"gan 7b block_pallas={fused} float32 step 1, kernels vs plain"
              f" (the G step of both against the kernel path's D): losses "
              f"{f32['losses']} vs {f32['plain_losses']}, worst "
              f"{f32['worst_loss']} over rtol by "
              f"{f32['loss_over_rtol_max']:.3g} (atol {GAN_LOSS_ATOL}); D "
              f"after Adam: max |dev| {f32['d_dev_max']:.3g} (bound "
              f"{GAN_FLIP_DEV} lr), flip share {f32['d_flip_share']:.3g} "
              f"(bound {GAN_FLIP_SHARE}); seg tower over rtol by "
              f"{f32['seg_over_rtol_max']:.3g} (atol {GAN_SEG_ATOL})",
              flush=True)
        lr = cfg("float32").lr
        if not (f32["loss_over_rtol_max"] <= GAN_LOSS_ATOL
                and f32["d_dev_max"] <= GAN_FLIP_DEV * lr
                and f32["d_flip_share"] < GAN_FLIP_SHARE
                and f32["seg_over_rtol_max"] <= GAN_SEG_ATOL):
            raise AssertionError(f"gan float32 step disagrees: {f32}")
        results[fused] = {
            "launches": counts, "per_step": per_step, "routed": rc,
            "per_eval_forward": per_forward, "losses": losses,
            "step_ms": step_ms, "median_ms": med, "quartiles_ms": [q1, q3],
            "device_ms": device, "kernels_per_step": kernels,
            "idle_share": 1 - device / med, "d_step_device_ms": d_ms,
            "d_share": d_ms / device, "d_step_ops": d_ops, "top": rows[:16],
            "float32": f32}
    return results


def gan_cli(torch, counters, routed, data: Path, per_step: dict,
            per_forward: dict) -> dict:
    """Phase 7c: ``uganConsisTrainer -p train`` through ``run_main`` on
    phase 6's tree, its second epoch checked for host waits; ``-p test``
    through the module CLI; ``--resume 000:last``."""
    import numpy as np

    from smsut_tpu_torch.train.cli import make_parser, run_main
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.utils.io import imread_gray

    expr = FIT_DIR / "expr_gan"
    args = fit_args(data, expr, "gan")
    spans = []
    torch.cuda.synchronize()
    zero(counters, routed)
    with sync_checked_epoch(torch, 1), epoch_clock(spans):
        run_main(UGANConsisAlgo,
                 make_parser().parse_args(["-p", "train"] + args))
    torch.cuda.synchronize()
    counts = {k: c.launches for k, c in counters.items()}
    steps = FIT_EPOCHS * FIT_ITERS
    # each epoch: the eval sweep and the grid's translation to 4 modalities
    fwd = FIT_EPOCHS * (FIT_TEST_BATCHES + 4)
    want = {k: steps * per_step[k] + fwd * per_forward[k] for k in counts}
    model = expr / "gan" / "000"
    log = (model / "train.log").read_text()
    losses = [float(x) for x in re.findall(r"\[TRN\].* loss: ([^/]+)/", log)]
    ckpt = torch.load(model / "ckpt" / "last.ckpt", map_location="cpu",
                      weights_only=True)
    grids = [imread_gray(str(model / "sample" / f"train-{e}-images.png"))
             for e in range(1, FIT_EPOCHS + 1)]
    period = per_iteration_ms(spans[1], FIT_ITERS)
    print(f"gan 7c: run_main -p train: launches {counts} (expected {want}), "
          f"routed {routed_counts(routed)}; steps {ckpt['step']}; [TRN] "
          f"losses {losses}; grids {[g.shape for g in grids]}; epoch-1 ms "
          f"per iteration (its wall time over {FIT_ITERS}) {period:.3f} (no "
          f"host wait: set_sync_debug_mode error passed)", flush=True)
    if (counts != want or ckpt["step"] != steps or len(losses) != FIT_EPOCHS
            or not np.isfinite(losses).all()
            or log.count("[TST]") != FIT_EPOCHS
            or not (model / "ckpt" / "best.ckpt").is_file()
            or any(g.shape != (16 * 256, 5 * 256) for g in grids)):
        raise AssertionError(f"gan CLI artifacts of {model}: launches "
                             f"{counts}, step {ckpt['step']}, losses {losses}")
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "smsut_tpu_torch.trainer.uganConsisTrainer",
         "-p", "test", "-i", "000", "-wh", "best"] + args, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    test_s = time.perf_counter() - t0
    if out.returncode:
        raise AssertionError(f"gan -p test failed:\n{out.stderr[-3000:]}")
    rows = [r for r in (model / "all_trois_matrix.csv").read_text()
            .split("\n") if r]
    vals = np.array([[float(v) for v in r.split(",")] for r in rows])
    run_main(UGANConsisAlgo, make_parser().parse_args(
        ["-p", "train", "--resume", "000:last"] + args))
    resumed = (expr / "gan" / "001" / "train.log").read_text()
    print(f"gan 7c: -p test in {test_s:.1f} s, CSV {vals.shape}, mean Dice "
          f"{vals[4, 4]:.4f}; --resume 000:last: "
          f"{'Load model from' in resumed}", flush=True)
    if (vals.shape != (10, 5) or not np.isfinite(vals).all()
            or "Load model from" not in resumed
            or f"Resuming at epoch {FIT_EPOCHS}" not in resumed):
        raise AssertionError(f"gan test/resume: {rows}\n{resumed[-2000:]}")
    return {"launches": counts, "expected": want, "losses": losses,
            "step": ckpt["step"], "period_ms": period, "test_s": test_s,
            "csv": vals.tolist()}


def gan_phase(torch, ops, counters, routed) -> dict:
    """Phase 7: 7a, 7b and 7c (on phase 6's tree)."""
    dd = gan_double_backward(torch, ops, counters, routed)
    steps = gan_step_modes(torch, ops, counters, routed)
    cli = gan_cli(torch, counters, routed, FIT_DIR / "data",
                  steps[False]["per_step"], steps[False]["per_eval_forward"])
    return {"double_backward": dd, "steps": steps, "cli": cli}


# phase 8: the JAX package's dispatch on the card, as CUDA graphs
REPLAY_STEPS = 10
GATE_STEP = 3               # 8b: the consistency gate opens in the window
LAMBDA_EPOCHS = (0, 100)    # 8b: lambda_semi's epochs, steps 0-4 and 5-9
TIMING_ROUNDS = 6           # 8e: rounds of eager and replayed blocks
TIMING_UNITS = {"unet": 10, "gan": 5, "eval": 2, "serve": 10}


def kernel_counts(rows) -> dict:
    """{kernel: launches} of (kernel, launches) pairs, copies and fills
    left out."""
    return {k: n for k, n in rows if not k.startswith(("Memcpy", "Memset"))}


def replay_against_eager(torch, eager, replay, inputs: int) -> dict:
    """The profiler's device work of one eager call and of one replay,
    ``inputs`` the copies the replay makes into its graph's buffers: the
    port's kernels (``smsut::``) alike by name and count, and as many
    device operations (kernels, copies and fills) in the graph as the
    eager call launches.  PyTorch may do a step's copy as a kernel in one
    and as a memcpy in the other (a ``torch.cat`` in the GAN step), so
    kernels alone may differ by those.  Each session opens with a short
    sleep kernel, left out of the counts, and each side's count of each
    kernel is the largest of three sessions of one call."""
    from smsut_tpu_torch.tools.profile_step import device_rows

    pad = lambda: torch.cuda._sleep(1000)
    rows, _ = device_rows(torch, lambda: (pad(), pad()), 1)
    pads = {k for k, _, _ in rows}

    def counted(fn):
        out = {}
        for _ in range(3):
            rows, _ = device_rows(torch, lambda: (pad(), fn()), 1)
            for k, _, n in rows:
                if k not in pads:
                    out[k] = max(out.get(k, 0), n)
        return out

    e, r = counted(eager), counted(replay)
    ek, rk = kernel_counts(e.items()), kernel_counts(r.items())
    ours = lambda d: {k: n for k, n in d.items() if k.startswith("void smsut")
                      or k.startswith("smsut")}
    eops, rops = sum(e.values()), sum(r.values()) - inputs
    if ours(ek) != ours(rk) or eops != rops:
        diff = {k: (e.get(k), r.get(k)) for k in set(e) | set(r)
                if e.get(k) != r.get(k)}
        raise AssertionError(f"replay's device work differs from eager: "
                             f"{eops} vs {rops} operations; {diff}")
    return {"kernels": sum(rk.values()), "eager_kernels": sum(ek.values()),
            "operations": rops, "ours": sum(ours(rk).values())}


def replay_kernels() -> dict:
    """One replay against one eager iteration by the profiler
    (:func:`replay_against_eager`), the U-Net (bf16) and uganConsis
    (float32) iterations of 8a and 8b in both block modes.  Run in a
    process of its own (:func:`replay_kernels_clean`): once a process has
    held large profiler sessions, later sessions lose records (ROADMAP
    C3), and phases 6d and 7 hold tens of thousands of kernels."""
    import numpy as np
    import torch

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.tools.profile_step import iteration
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for fused in (False, True):
        cfg = Config(input_size=256, base_width=16, batch_size=8,
                     compute_dtype="bfloat16", block_pallas=fused)
        algo = SupervisedUNet(cfg)
        inp = algo.inputs({k: torch.from_numpy(v).cuda()
                           for k, v in ellipse_batch(np).items()})
        runs = [iteration(algo, algo.init_state(0), inp, capture=c)
                for c in (False, True)]
        for run in runs:
            run()
            run()
        out[f"unet {fused}"] = replay_against_eager(torch, *runs, len(inp))
        gan = UGANConsisAlgo(cfg.replace(compute_dtype="float32"))
        ginp = gan.inputs(dict(gan_batch(torch, np),
                               **gan.make_extra_batch()))
        scal = {"lambda_semi": torch.tensor(1.0, device="cuda")}
        runs = [iteration(gan, gan.init_state(0), ginp, scal, capture=c)
                for c in (False, True)]
        for run in runs:
            run()
            run()
        out[f"gan {fused}"] = replay_against_eager(torch, *runs, len(ginp))
        del runs, gan, algo
        torch.cuda.empty_cache()
    return out


def replay_kernels_clean() -> dict:
    """:func:`replay_kernels` in a child process; its result."""
    code = ("import json, chip_smoke; "
            "print('KERNELS ' + json.dumps(chip_smoke.replay_kernels()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    line = [x for x in out.stdout.splitlines() if x.startswith("KERNELS ")]
    if out.returncode or not line:
        raise AssertionError(f"replay kernels:\n{out.stderr[-3000:]}")
    res = json.loads(line[-1][len("KERNELS "):])
    for k, v in res.items():
        print(f"replay 8a/8b {k.replace(' ', ' block_pallas=')}: one replay "
              f"runs {v['kernels']} kernels ({v['ours']} of the port's) and "
              f"{v['operations']} device operations besides its input "
              f"copies, as the eager iteration ({v['eager_kernels']} "
              f"kernels), by the profiler", flush=True)
    return res


def replay_unet(torch, counters, routed) -> dict:
    """8a: the w16 U-Net's iteration replayed against eager from one init,
    both block modes."""
    import numpy as np

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.tools.profile_step import iteration
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    batch = {k: torch.from_numpy(v).cuda()
             for k, v in ellipse_batch(np).items()}
    out = {}
    for fused in (False, True):
        cfg = lambda dtn: Config(input_size=256, base_width=16, batch_size=8,
                                 compute_dtype=dtn, block_pallas=fused)
        algo = SupervisedUNet(cfg("bfloat16"))
        inp = algo.inputs(batch)
        eager = iteration(algo, algo.init_state(0), inp, capture=False)
        replay = iteration(algo, algo.init_state(0), inp)
        torch.cuda.synchronize()
        zero(counters, routed)
        losses = [float(replay()["loss"]) for _ in range(REPLAY_STEPS)]
        counts = {k: c.launches for k, c in counters.items()}
        want = {k: REPLAY_STEPS * PER_STEP[fused].get(k, 0) for k in KERNELS}
        eager_losses = [float(eager()["loss"]) for _ in range(REPLAY_STEPS)]
        print(f"replay 8a block_pallas={fused} bfloat16: launches {counts} "
              f"(expected {want}); replayed losses "
              f"{[round(x, 5) for x in losses]}, eager "
              f"{[round(x, 5) for x in eager_losses]}", flush=True)
        if counts != want or any(routed_counts(routed).values()):
            raise AssertionError(f"8a replayed launches {counts} != {want}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"replayed loss not finite and falling: "
                                 f"{losses}")
        a32 = SupervisedUNet(cfg("float32"))
        i32 = a32.inputs(batch)
        states = [a32.init_state(0), a32.init_state(0)]
        runs = [iteration(a32, st, i32, capture=c)
                for st, c in zip(states, (False, True))]
        l32 = [[float(r()["loss"]) for _ in range(REPLAY_STEPS)]
               for r in runs]
        lerr = max(abs(a - b) / abs(b) for a, b in zip(l32[1], l32[0]))
        par = grad_parity(states[1].params, states[0].params)
        exact = all(torch.equal(states[1].params[k], v)
                    for k, v in states[0].params.items())
        print(f"replay 8a block_pallas={fused} float32: {REPLAY_STEPS} "
              f"losses replayed vs eager rel err {lerr:.3g} (tol {LOSS_TOL});"
              f" parameters after them rel err max {par['rel_max']:.3g} "
              f"({par['worst_rel']}), L2 of all {par['l2_all']:.3g}, cosine "
              f"min {par['cos_min']:.6f}; equal to the bit: {exact}",
              flush=True)
        if not (lerr <= LOSS_TOL and par["rel_max"] <= GRAD_REL
                and par["l2_all"] <= GRAD_REL and par["cos_min"] >= GRAD_COS):
            raise AssertionError(f"8a float32 replay vs eager: {lerr}, "
                                 f"{par}")
        out[fused] = {"launches": counts, "losses": losses,
                      "eager_losses": eager_losses,
                      "f32_losses": l32, "f32_params": par,
                      "f32_bit_equal": exact}
    return out


def clone_gan_state(torch, st):
    """A deep copy of a GANTrainState's tensors (the optimizers shared)."""
    import dataclasses

    from smsut_tpu_torch.train.state import AdamState

    tree = lambda t: {k: v.clone() for k, v in t.items()}
    return dataclasses.replace(
        st, g_params=tree(st.g_params), g_opt_state=tree(st.g_opt_state),
        d_params=tree(st.d_params), count=st.count.clone(),
        d_opt_state=AdamState(st.d_opt_state.count.clone(),
                              tree(st.d_opt_state.mu),
                              tree(st.d_opt_state.nu)))


def gan_step_against(torch, got, want, lr) -> dict:
    """One step's results, replayed (``got``) against eager (``want``),
    each (metrics, state after): 7b's float32 rules, the losses over rtol,
    D flip-aware, the seg tower over rtol, and G's largest per-tensor
    rel_err."""
    (gm, gs), (wm, ws) = got, want
    dev = torch.cat([(gs.d_params[k] - ws.d_params[k]).abs().flatten()
                     for k in ws.d_params])
    return {
        "loss_over": max(abs(gm[n] - wm[n]) - GAN_LOSS_RTOL * abs(wm[n])
                         for n in GAN_NAMES),
        "d_dev_max": float(dev.max()),
        "d_flip_share": float((dev > lr).float().mean()),
        "seg_over": max(float(((gs.g_params[k] - ws.g_params[k]).abs()
                               - GAN_SEG_RTOL * ws.g_params[k].abs()).max())
                        for k in GAN_SEG_TOWER),
        "g_rel": max(rel_err(gs.g_params[k], v)
                     for k, v in ws.g_params.items())}


def replay_gan(torch, counters, routed) -> dict:
    """8b: the uganConsis iteration (w16, 8 + 8) replayed against eager,
    float32, both block modes, 10 steps in lock step: before each replay
    the state is copied and the eager step runs on the copy with the same
    inputs, so each step is held to 7b's float32 rules from one state
    (float32 chaos, Adam's sign steps and the bilinear upsampling's
    atomic backward, would otherwise part two runs of 10 steps whatever
    the dispatch).  The gate opens at step GATE_STEP (G_semi 0 before,
    positive after, in the replay); ``lambda_semi`` changes at step 5, in
    the device scalar the replay reads: there an eager step that keeps
    the old weight must land at least 10x further from the replay than
    the eager step with the new one."""
    import numpy as np

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.graphs import Replay
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    batch = gan_batch(torch, np)
    out = {}
    for fused in (False, True):
        cfg = Config(input_size=256, base_width=16, batch_size=8,
                     compute_dtype="float32", block_pallas=fused,
                     consis_gate_step=GATE_STEP)
        algo = UGANConsisAlgo(cfg)
        inps = [algo.inputs(dict(batch, **algo.make_extra_batch()))
                for _ in range(REPLAY_STEPS)]
        lams = [float(algo.epoch_scalars(e)["lambda_semi"])
                for e in LAMBDA_EPOCHS]
        state = algo.init_state(0)
        scal = {"lambda_semi": torch.zeros((), device="cuda")}
        step = Replay(lambda x: algo.step(state, x, scal), algo.device)
        eager_scal = {"lambda_semi": torch.zeros((), device="cuda")}
        eager = lambda st, x, lam: (eager_scal["lambda_semi"].fill_(lam),
                                    algo.step(st, x, eager_scal))[1]
        host = lambda m: {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        zero(counters, routed)
        rows, gate, frozen = [], [], None
        for i, inp in enumerate(inps):
            lam = lams[i >= REPLAY_STEPS // 2]
            before = clone_gan_state(torch, state)
            old = (clone_gan_state(torch, state)
                   if i == REPLAY_STEPS // 2 else None)
            scal["lambda_semi"].fill_(lam)
            counts0 = {k: c.launches for k, c in counters.items()}
            got = host(step(inp))
            state.step += 1
            launched = {k: c.launches - counts0[k]
                        for k, c in counters.items()}
            want = host(eager(before, inp, lam))
            rows.append(gan_step_against(torch, (got, state),
                                         (want, before), cfg.lr))
            rows[-1]["launches"] = launched
            gate.append(got["G_semi"])
            if old is not None:
                eager(old, inp, lams[0])
                frozen = gan_step_against(torch, (got, state),
                                          (want, old), cfg.lr)["g_rel"]
        counts = {k: c.launches for k, c in counters.items()}
        worst = {k: max(r[k] for r in rows) for k in
                 ("loss_over", "d_dev_max", "d_flip_share", "seg_over",
                  "g_rel")}
        g5 = rows[REPLAY_STEPS // 2]["g_rel"]
        per_step = rows[0]["launches"]
        print(f"replay 8b block_pallas={fused} float32, {REPLAY_STEPS} "
              f"steps in lock step: launches per replay {per_step} (each "
              f"step alike: {all(r['launches'] == per_step for r in rows)});"
              f" G_semi replayed {[round(x, 5) for x in gate]} (gate at step "
              f"{GATE_STEP}); lambda_semi {lams}; worst over the steps: "
              f"losses over rtol by {worst['loss_over']:.3g} (atol "
              f"{GAN_LOSS_ATOL}), D max |dev| {worst['d_dev_max']:.3g} "
              f"(bound {GAN_FLIP_DEV} lr), flip share "
              f"{worst['d_flip_share']:.3g}, seg tower over rtol by "
              f"{worst['seg_over']:.3g} (atol {GAN_SEG_ATOL}), G rel err "
              f"{worst['g_rel']:.3g}; step 5's G rel err {g5:.3g} against "
              f"{frozen:.3g} for an eager step with the old weight",
              flush=True)
        if (any(r["launches"] != per_step for r in rows)
                or any(gate[:GATE_STEP])
                or not all(g > 0 for g in gate[GATE_STEP:])
                or worst["loss_over"] > GAN_LOSS_ATOL
                or worst["d_dev_max"] > GAN_FLIP_DEV * cfg.lr
                or worst["d_flip_share"] >= GAN_FLIP_SHARE
                or worst["seg_over"] > GAN_SEG_ATOL
                or not frozen >= 10 * max(g5, 1e-7)):
            raise AssertionError(f"8b replay vs eager: {worst}, gate "
                                 f"{gate}, frozen {frozen} vs {g5}")
        out[fused] = {"launches": {k: sum(r["launches"][k] for r in rows)
                                   for k in per_step},
                      "per_step": per_step, "eager_and_replayed": counts,
                      "g_semi": gate, "worst": worst, "steps": rows,
                      "frozen_weight_g_rel": frozen}
        del step, state, inps
        torch.cuda.empty_cache()
    return out


class LoaderTape:
    """A train or val loader whose consumed items are recorded (``items``
    empty) or handed out again: the eager fit of 8c then takes the batches,
    augmentation parameters and order the replayed fit took, whatever the
    producer threads' timing did to the shared sampler stream (ROADMAP
    C2)."""

    def __init__(self, loader, items: list, replay: bool):
        self.__dict__.update(loader=loader, items=items, replay=replay,
                             dataset=loader.dataset)

    def __setattr__(self, name, value):   # the Trainer's producer hook
        setattr(self.loader, name, value)

    def iter_cycle(self):
        if self.replay:
            yield from self.items
            raise AssertionError("the tape ran out")
        for item in self.loader.iter_cycle():
            self.items.append(item)
            yield item


def taped_fit(torch, ops, algo, cfg, name: str, tapes: dict, replay: bool,
              capture: bool, watch: bool) -> dict:
    """A Trainer.fit whose train and val loaders are ``tapes``; its
    logged scalars."""
    from smsut_tpu_torch.train import loop as port_loop
    from smsut_tpu_torch.train.experiment import Experiment
    from smsut_tpu_torch.train.loop import Trainer

    real = port_loop.get_loader

    def taped(root, phase, *a, **kw):
        loader = real(root, phase, *a, **kw)
        if phase not in tapes:
            return loader
        return LoaderTape(loader, tapes[phase], replay)

    scal = {}
    trainer = Trainer(algo, cfg, "train", experiment=Experiment(
        cfg.expr_root, name), capture=capture)
    trainer.exp.scalar = (lambda tag, v, e:
                          scal.setdefault(tag, {}).__setitem__(e, float(v)))
    port_loop.get_loader = taped
    try:
        with sync_checked_epoch(torch, 1) if watch else \
                contextlib.nullcontext():
            trainer.fit()
    finally:
        port_loop.get_loader = real
        trainer.exp.close()
    return scal


def fit_diff(got: dict, want: dict) -> dict:
    """6b's measures between two fits' scalars: the [TRN] losses' largest
    relative error, the [TST] Dice errors per modality and overall, and
    whether the best epochs agree."""
    e = range(FIT_EPOCHS)
    best = lambda d: max(e, key=lambda i: (d["test/dice"][i], i))
    return {"loss_rel": max(abs(got["train/loss"][i] - want["train/loss"][i])
                            / abs(want["train/loss"][i]) for i in e),
            "dice": {m: max(abs(got[f"test/dice_{m}"][i]
                                - want[f"test/dice_{m}"][i]) for i in e)
                     for m in ("ct", "t1in", "t1out", "t2")},
            "dice_all": max(abs(got["test/dice"][i] - want["test/dice"][i])
                            for i in e),
            "best_equal": best(got) == best(want)}


def within_6b(d: dict) -> bool:
    return (d["loss_rel"] <= LOSS_TOL and max(d["dice"].values())
            <= PARITY_DICE_TOL and d["dice_all"] <= PARITY_DICE_ALL
            and d["best_equal"])


def upsample_bilinear2_sliced(x):
    """``models/layers.py`` ``upsample_bilinear2``'s math (2x, half-pixel
    centres, edges clamped), NHWC, from slices and weighted sums: its
    backward accumulates in a fixed order, where ``F.interpolate``'s CUDA
    backward adds with atomics, so two fits through it can be held to each
    other."""
    import torch

    def up(t, dim):
        n = t.shape[dim]
        prev = torch.cat([t.narrow(dim, 0, 1), t.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([t.narrow(dim, 1, n - 1), t.narrow(dim, n - 1, 1)],
                        dim)
        return torch.stack([0.25 * prev + 0.75 * t, 0.75 * t + 0.25 * nxt],
                           dim + 1).flatten(dim, dim + 1)

    return up(up(x, 1), 2)


def replay_fits(torch, ops, counters, routed, data: Path) -> dict:
    """8c: the U-Net and uganConsis fits at the Config's dispatch
    (steps_per_dispatch 8, eval_scan), float32, epoch 2 under
    set_sync_debug_mode("error"), against the eager fit
    (steps_per_dispatch 1, eval_scan off, capture=False) on the same
    recorded batches: 6b's bounds.  The uganConsis fits run the decoders'
    bilinear upsampling as :func:`upsample_bilinear2_sliced` (its
    ``F.interpolate`` backward adds with atomics, and two eager fits
    through it part by about 6b's bounds; 8b holds the step with it), and
    a second eager fit shows what is left to chance."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.models import blocks
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    base = Config(base_root=str(data), expr_root=str(FIT_DIR / "expr8"),
                  input_size=256, base_width=16, batch_size=8,
                  compute_dtype="float32", num_iter_per_epoch=FIT_ITERS,
                  max_epoch=FIT_EPOCHS, num_workers=4)
    eager_cfg = base.replace(steps_per_dispatch=1, eval_scan=False)
    out = {}
    for name, cls in (("unet", SupervisedUNet), ("uganConsis",
                                                   UGANConsisAlgo)):
        tapes = {"train": [], "val": []}
        up = blocks.upsample_bilinear2
        if name == "uganConsis":
            blocks.upsample_bilinear2 = upsample_bilinear2_sliced
        try:
            torch.cuda.synchronize()
            zero(counters, routed)
            got = taped_fit(torch, ops, cls(base), base, f"replay_{name}",
                            tapes, replay=False, capture=True, watch=True)
            torch.cuda.synchronize()
            counts = {k: c.launches for k, c in counters.items()}
            eager = [taped_fit(torch, ops, cls(eager_cfg), eager_cfg,
                               f"eager{k}_{name}", tapes, replay=True,
                               capture=False, watch=False) for k in range(2)]
        finally:
            blocks.upsample_bilinear2 = up
        d, spread = fit_diff(got, eager[0]), fit_diff(eager[1], eager[0])
        print(f"replay 8c {name}: fit at steps_per_dispatch 8 + eval_scan "
              f"(replayed; epoch 2 under set_sync_debug_mode error) vs the "
              f"eager fit on the same batches: [TRN] losses "
              f"{[got['train/loss'][i] for i in range(FIT_EPOCHS)]} vs "
              f"{[eager[0]['train/loss'][i] for i in range(FIT_EPOCHS)]}: "
              f"{d} (6b's bounds: loss {LOSS_TOL}, Dice {PARITY_DICE_TOL} "
              f"per modality, {PARITY_DICE_ALL} overall); a second eager "
              f"fit vs the first: {spread}; launches {counts}", flush=True)
        if not within_6b(d):
            raise AssertionError(f"8c {name}: {d}, eager spread {spread}")
        out[name] = {"replayed": got, "eager": eager, "diff": d,
                     "eager_spread": spread, "launches": counts}
    return out


def replay_predict(torch, counters, routed) -> dict:
    """8d: ``predict`` replayed against eager at the manifest's shape: the
    logits equal."""
    import numpy as np

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.serve import export_eval, load_serving
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    cfg = Config(input_size=256, base_width=16, batch_size=8,
                 compute_dtype="bfloat16")
    algo = SupervisedUNet(cfg)
    art = ROOT / "build" / "chip_smoke_serving" / "replay"
    export_eval(algo, algo.init_params(seed=0), cfg, str(art))
    replayed, _ = load_serving(str(art))
    eager, _ = load_serving(str(art), capture=False)
    rng = np.random.default_rng(1)
    reqs = [torch.from_numpy(((rng.integers(0, 256, (8, 256, 256, 1))
                               / 255.0 - 0.5) / 0.5).astype(np.float32))
            .cuda() for _ in range(5)]
    zero(counters, routed)
    got = [replayed(r) for r in reqs]
    counts = {k: c.launches for k, c in counters.items()}
    want = {k: PER_FORWARD[False].get(k, 0) * len(reqs) for k in KERNELS}
    diff = max(float((g - eager(r)).abs().max()) for g, r in zip(got, reqs))
    print(f"replay 8d: predict replayed vs eager, {len(reqs)} requests: "
          f"logits max |diff| {diff} (must be 0); launches {counts} "
          f"(expected {want})", flush=True)
    if diff != 0 or counts != want:
        raise AssertionError(f"8d: diff {diff}, launches {counts}")
    return {"max_abs_diff": diff, "launches": counts}


def timed_blocks(torch, fns: dict, units: int, rounds: int) -> dict:
    """Host ms per unit of each of ``fns`` ({mode: one unit}): blocks of
    ``units`` calls ended by a synchronise, the modes in turns (their order
    reversed every other round, since the host's pace drifts within a
    process); per mode the median and quartiles over the rounds."""
    samples = {m: [] for m in fns}
    order = list(fns)
    for r in range(rounds):
        for m in (order if r % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(units):
                fns[m]()
            torch.cuda.synchronize()
            samples[m].append((time.perf_counter() - t0) * 1e3 / units)
    return {m: dict(zip(("median_ms", "q1_ms", "q3_ms"), quartiles(v)),
                    samples_ms=v) for m, v in samples.items()}


def replay_timing(torch, card: str, data: Path) -> dict:
    """8e: eager against replayed, in alternating blocks in one process:
    the U-Net iteration, the uganConsis iteration (bfloat16, w16; 8 + 8),
    the eval sweep per batch and the serving latency; each with the
    profiler's device ms and kernels per unit and the idle share."""
    import numpy as np

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.data.dataset import get_label_npys, get_loader
    from smsut_tpu_torch.serve import export_eval, load_serving
    from smsut_tpu_torch.tools.profile_step import device_rows, iteration
    from smsut_tpu_torch.train.experiment import Experiment
    from smsut_tpu_torch.train.loop import Trainer
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    cfg = Config(base_root=str(data), expr_root=str(FIT_DIR / "expr8e"),
                 input_size=256, base_width=16, batch_size=8,
                 compute_dtype="bfloat16", num_workers=4)
    paths = {}
    unet = SupervisedUNet(cfg)
    inp = unet.inputs({k: torch.from_numpy(v).cuda()
                       for k, v in ellipse_batch(np).items()})
    paths["unet"] = {c: iteration(unet, unet.init_state(0), inp, capture=c)
                     for c in (False, True)}
    gan = UGANConsisAlgo(cfg)
    ginp = gan.inputs(dict(gan_batch(torch, np), **gan.make_extra_batch()))
    scal = {k: torch.tensor(float(v), device="cuda")
            for k, v in gan.epoch_scalars(1).items()}
    paths["gan"] = {c: iteration(gan, gan.init_state(0), ginp, scal,
                                 capture=c) for c in (False, True)}
    loader = get_loader(str(data), "test", 0, 8, cfg=cfg)
    _, npys = get_label_npys(str(data), "test")
    trainers = {c: Trainer(SupervisedUNet(cfg), cfg.replace(eval_scan=c),
                           "train", experiment=Experiment(
                               cfg.expr_root, f"timing{int(c)}"), capture=c)
                for c in (False, True)}
    paths["eval"] = {c: (lambda t=t: t.validate_epoch(loader, npys))
                     for c, t in trainers.items()}
    art = ROOT / "build" / "chip_smoke_serving" / "timing"
    export_eval(unet, unet.init_params(seed=0), cfg, str(art))
    req = torch.from_numpy(((np.random.default_rng(2).integers(
        0, 256, (8, 256, 256, 1)) / 255.0 - 0.5) / 0.5).astype(
            np.float32)).cuda()
    preds = {c: load_serving(str(art), capture=c)[0] for c in (False, True)}
    paths["serve"] = {c: (lambda p=p: p(req)) for c, p in preds.items()}
    out = {}
    for name, fns in paths.items():
        for fn in fns.values():   # warm-up; the replays capture here
            fn()
            fn()
        per = FIT_TEST_BATCHES if name == "eval" else 1
        t = timed_blocks(torch, {("replayed" if c else "eager"): f
                                 for c, f in fns.items()},
                         TIMING_UNITS[name], TIMING_ROUNDS)
        for c, f in fns.items():
            mode = "replayed" if c else "eager"
            rows, _ = device_rows(torch, f, 3)
            r = t[mode]
            for k in ("median_ms", "q1_ms", "q3_ms"):
                r[k] /= per
            r["samples_ms"] = [x / per for x in r["samples_ms"]]
            r["device_ms"] = sum(x[1] for x in rows) / per
            r["kernels"] = sum(kernel_counts(
                (k, n) for k, _, n in rows).values()) / per
            r["idle_share"] = 1 - r["device_ms"] / r["median_ms"]
        for mode, r in t.items():
            print(f"replay 8e on {card}: {name} {mode}: median "
                  f"{r['median_ms']:.3f} ms per "
                  f"{'batch' if name == 'eval' else 'unit'}, quartiles "
                  f"{r['q1_ms']:.3f}-{r['q3_ms']:.3f} ({TIMING_ROUNDS} "
                  f"blocks of {TIMING_UNITS[name]}); device "
                  f"{r['device_ms']:.3f} ms in {r['kernels']:.0f} kernels; "
                  f"idle share {r['idle_share']:.3f}", flush=True)
        out[name] = t
    del trainers, paths, preds
    torch.cuda.empty_cache()
    return out


def dispatch_phase(torch, ops, counters, routed, card: str) -> dict:
    """Phase 8: 8a-8e (8c and 8e on phase 6's tree)."""
    import torch.backends.cudnn as cudnn

    # cuDNN (the GAN's routed Cout-1 conv) picks deterministic algorithms
    # here, so that eager and replayed runs can be held to each other
    det = cudnn.deterministic
    cudnn.deterministic = True
    try:
        a = replay_unet(torch, counters, routed)
        b = replay_gan(torch, counters, routed)
        c = replay_fits(torch, ops, counters, routed, FIT_DIR / "data")
    finally:
        cudnn.deterministic = det
    d = replay_predict(torch, counters, routed)
    e = replay_timing(torch, card, FIT_DIR / "data")
    k = replay_kernels_clean()
    return {"unet": a, "gan": b, "fits": c, "predict": d, "timing": e,
            "kernels": k}


# phase 9: the semi-supervised zoo (Mean Teacher, cross-pseudo
# supervision, CoraNet's stages A and B) at the Config's widths: w16,
# 256^2, 8 labelled + 8 unlabelled (CoraNet B: 8 labelled + 8 pseudo)
ZOO = ("meanTeacher", "crossPse", "coraPre", "coraNet")
# the device count from which every loss term is live (Mean Teacher's
# consistency gate and EMA alpha, CoraNet B's certain and uncertain terms)
ZOO_GATE = {"meanTeacher": 100, "crossPse": 0, "coraPre": 0,
            "coraNet": 1000}
ZOO_STEPS = 10
ZOO_TERMS = {"meanTeacher": "semi_loss", "coraNet": "certain_loss"}
# 9b: a consistency term is a mean of squared differences of two nearly
# equal softmaxes, so float32 summation order moves it by more of itself
# than a loss: relative ZOO_TERM_TOL plus ZOO_TERM_ATOL
ZOO_TERM_TOL, ZOO_TERM_ATOL = 1e-2, 1e-6
ZOO_CLI = {"meanTeacher": "meanTeacherTrainer",
           "crossPse": "crossPseTrainer"}


def zoo_algo(name: str, cfg):
    """The algorithm of zoo name ``name`` (serve.py ``factories``; its
    ``coraNet`` is stage B), and CoraNet's stage A for ``coraPre``."""
    from smsut_tpu_torch.serve import factories
    from smsut_tpu_torch.train.steps.coranet import CoraNet

    if name == "coraPre":
        return CoraNet(cfg, stage="pre")
    return factories()[name][1](cfg, None)


def zoo_per_step(name: str, fused: bool) -> dict:
    """Launches per iteration: a student forward and backward at 16
    images counts as one U-Net step; Mean Teacher adds the teacher's
    forward, cross-pseudo supervision runs two students, CoraNet B two
    student applies of 8 and the teacher's forward."""
    s, f = PER_STEP[fused], PER_FORWARD[fused]
    n_step, n_fwd = {"meanTeacher": (1, 1), "crossPse": (2, 0),
                     "coraPre": (1, 0), "coraNet": (2, 1)}[name]
    return {k: n_step * s.get(k, 0) + n_fwd * f.get(k, 0) for k in KERNELS}


def zoo_inputs(torch, np, algo, name: str) -> dict:
    """Fixed step inputs on the card: ellipse batches (labelled, seed 0;
    unlabelled, seed 1; CoraNet B's pseudo batch, seed 2, with a random
    certainty mask of 70% ones)."""
    lb, ul = ellipse_batch(np, seed=0), ellipse_batch(np, seed=1)
    batch = {"img": lb["img"], "msk": lb["msk"], "ul_img": ul["img"]}
    if name == "coraNet":
        p = ellipse_batch(np, seed=2)
        batch.update(pse_img=p["img"], pse_lab=p["msk"], pse_mask=(
            np.random.default_rng(3).random(p["msk"].shape) < 0.7).astype(
                np.float32))
    return algo.inputs({k: torch.from_numpy(v).cuda()
                        for k, v in batch.items()})


def zoo_scalars(torch, algo) -> dict:
    return {k: torch.tensor(float(v), device="cuda")
            for k, v in algo.epoch_scalars(3).items()}


def zoo_state(algo, count: int):
    """``init_state(0)`` at device count ``count``."""
    st = algo.init_state(0)
    st.step = count
    st.count.fill_(count)
    return st


def clone_train_state(st):
    """A deep copy of a TrainState's tensors (the optimizer shared)."""
    import dataclasses

    tree = lambda t: None if t is None else {k: v.clone()
                                             for k, v in t.items()}
    return dataclasses.replace(
        st, params=tree(st.params), opt_state=tree(st.opt_state),
        ema_params=tree(st.ema_params), params2=tree(st.params2),
        opt_state2=tree(st.opt_state2), count=st.count.clone())


def zoo_grads(ops, algo, state, inp, scal, plain: bool):
    """One step's metrics and the gradients it would apply (net 2's keyed
    ``net2.<name>``), the update itself skipped."""
    grads = {}

    def capture(g, g2=None):
        grads.update(g)
        grads.update({f"net2.{k}": v for k, v in (g2 or {}).items()})

    state.update = capture
    with ops.plain() if plain else contextlib.nullcontext():
        m = algo.step(state, inp, scal)
    return {k: float(v) for k, v in m.items()}, grads


def zoo_steps(torch, ops, counters, routed) -> dict:
    """9a: per algorithm and block mode, step 1's gradients with every
    loss term live (float32 and bfloat16) against the plain path under
    phase 4's rules, then 10 replayed bfloat16 iterations: the launches of
    each, nothing routed, the loss finite and falling."""
    import numpy as np

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.tools.profile_step import iteration

    out = {}
    for name in ZOO:
        for fused in (False, True):
            cfg = lambda dtn: Config(input_size=256, base_width=16,
                                     batch_size=8, compute_dtype=dtn,
                                     block_pallas=fused)
            grads, metrics = {}, {}
            for dtn in ("float32", "bfloat16"):
                algo = zoo_algo(name, cfg(dtn))
                inp, scal = zoo_inputs(torch, np, algo, name), \
                    zoo_scalars(torch, algo)
                st = zoo_state(algo, ZOO_GATE[name])
                for plain in (False, True):
                    metrics[dtn, plain], grads[dtn, plain] = zoo_grads(
                        ops, algo, clone_train_state(st), inp, scal, plain)
            c32 = grad_parity(grads["float32", False], grads["float32", True])
            a = bf16_accuracy(grads["bfloat16", False],
                              grads["bfloat16", True], grads["float32", True])
            lerr = abs(metrics["float32", False]["loss"]
                       - metrics["float32", True]["loss"]) / abs(
                           metrics["float32", True]["loss"])
            st = zoo_state(algo, ZOO_GATE[name])   # bfloat16
            run = iteration(algo, st, inp, scal)
            torch.cuda.synchronize()
            zero(counters, routed)
            losses = [float(run()["loss"]) for _ in range(ZOO_STEPS)]
            counts = {k: c.launches for k, c in counters.items()}
            rc = routed_counts(routed)
            want = {k: ZOO_STEPS * v
                    for k, v in zoo_per_step(name, fused).items()}
            print(f"zoo 9a {name} block_pallas={fused}: float32 step-1 "
                  f"gradients of {c32['n']} tensors vs the plain path: rel "
                  f"err max {c32['rel_max']:.3g} ({c32['worst_rel']}), L2 "
                  f"of all {c32['l2_all']:.3g}, cosine min "
                  f"{c32['cos_min']:.6f} ({c32['worst_cos']}); loss rel err "
                  f"{lerr:.3g}; bfloat16 vs the float32 plain gradient: "
                  f"kernel err max {a['kernel_err_max']:.3g}, plain "
                  f"{a['plain_err_max']:.3g}, closest to the bound "
                  f"{a['worst']} ({a['kernel_err']:.3g} vs "
                  f"{a['plain_err']:.3g}); {ZOO_STEPS} replayed bfloat16 "
                  f"steps: launches {counts} (expected {want}), routed "
                  f"{rc}, losses {[round(x, 5) for x in losses]}",
                  flush=True)
            if not (c32["rel_max"] <= GRAD_REL and c32["l2_all"] <= GRAD_REL
                    and c32["cos_min"] >= GRAD_COS and a["worst_over"] <= 0
                    and lerr <= LOSS_TOL):
                raise AssertionError(f"9a {name} {fused}: {c32}, {a}, {lerr}")
            if counts != want or any(rc.values()):
                raise AssertionError(f"9a {name} {fused}: launches {counts} "
                                     f"!= {want}, routed {rc}")
            if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                raise AssertionError(f"9a {name} {fused}: losses {losses}")
            out[f"{name} {fused}"] = {
                "launches": counts, "routed": rc, "losses": losses,
                "f32": c32, "bf16": a, "loss_rel": lerr}
            del run, st, algo, grads
            torch.cuda.empty_cache()
    return out


def zoo_gates(torch, ops) -> dict:
    """9b: Mean Teacher from count 99 and CoraNet B from count 999, float32,
    four replayed steps against four eager steps of the plain path from
    one init: the gated term 0 at the first step and positive after,
    Mean Teacher's alpha 0 and then 0.99; the losses within LOSS_TOL, the
    gated terms within ZOO_TERM_TOL (+ ZOO_TERM_ATOL)."""
    import numpy as np

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.tools.profile_step import iteration

    out = {}
    for name, term in ZOO_TERMS.items():
        cfg = Config(input_size=256, base_width=16, batch_size=8,
                     compute_dtype="float32")
        algo = zoo_algo(name, cfg)
        inp, scal = zoo_inputs(torch, np, algo, name), zoo_scalars(torch,
                                                                   algo)
        start = ZOO_GATE[name] - 1
        runs = []
        for plain in (False, True):
            run = iteration(algo, zoo_state(algo, start), inp, scal,
                            capture=not plain)
            with ops.plain() if plain else contextlib.nullcontext():
                runs.append([{k: float(v) for k, v in run().items()}
                             for _ in range(4)])
        got, want = runs
        over = max(abs(g[k] - w[k]) - (ZOO_TERM_TOL if k != "loss"
                                       else LOSS_TOL) * abs(w[k])
                   for g, w in zip(got, want) for k in w)
        gated = [g[term] for g in got]
        alpha = [g.get("alpha") for g in got]
        print(f"zoo 9b {name} from count {start}, float32, replayed kernels"
              f" vs eager plain: {term} {[f'{x:.4g}' for x in gated]} (plain"
              f" {[round(w[term], 6) for w in want]}); alpha {alpha}; worst "
              f"excess over the bounds {over:.3g} (atol {ZOO_TERM_ATOL})",
              flush=True)
        if (gated[0] != 0 or not all(x > 0 for x in gated[1:])
                or over > ZOO_TERM_ATOL
                or (name == "meanTeacher"
                    and (alpha[0] != 0 or abs(alpha[1] - 0.99) > 1e-6))):
            raise AssertionError(f"9b {name}: {got} vs {want}")
        out[name] = {"replayed": got, "plain": want, "over": over}
        torch.cuda.empty_cache()
    return out


def zoo_replays(torch) -> dict:
    """9c, under deterministic cuDNN: five float32 iterations replayed
    against five eager ones from one init, both block modes: the metrics
    and every tree to the bit."""
    import numpy as np

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.tools.profile_step import iteration

    out = {}
    for name in ZOO:
        for fused in (False, True):
            algo = zoo_algo(name, Config(input_size=256, base_width=16,
                                         batch_size=8, compute_dtype="float32",
                                         block_pallas=fused))
            inp, scal = zoo_inputs(torch, np, algo, name), \
                zoo_scalars(torch, algo)
            states = [zoo_state(algo, ZOO_GATE[name]) for _ in range(2)]
            ms = [[{k: float(v) for k, v in run().items()} for _ in range(5)]
                  for run in (iteration(algo, st, inp, scal, capture=c)
                              for st, c in zip(states, (False, True)))]
            same = ms[0] == ms[1] and all(
                torch.equal(getattr(states[1], t)[k], v)
                for t in ("params", "ema_params", "params2")
                if getattr(states[0], t) is not None
                for k, v in getattr(states[0], t).items())
            print(f"zoo 9c {name} block_pallas={fused} float32: 5 replayed "
                  f"iterations equal eager to the bit: {same}", flush=True)
            if not same:
                raise AssertionError(f"9c {name} {fused}: {ms}")
            out[f"{name} {fused}"] = same
            del states
    return out


def zoo_cudnn(torch, ops) -> dict:
    """9c's cause: Mean Teacher's eager step, four times from one state
    with cuDNN's default algorithm choice and four times deterministic,
    in float32 and bfloat16: the tensors whose gradient differs between
    runs, and the kernels that each setting alone launches (the stem
    conv's weight gradient, Cin 1, the step's one cuDNN op)."""
    import numpy as np
    import torch.backends.cudnn as cudnn
    from torch.profiler import ProfilerActivity, profile

    from smsut_tpu_torch.config import Config

    name = "meanTeacher"
    det = cudnn.deterministic
    out = {}
    try:
        for dtn in ("float32", "bfloat16"):
            algo = zoo_algo(name, Config(input_size=256, base_width=16,
                                         batch_size=8, compute_dtype=dtn))
            inp, scal = zoo_inputs(torch, np, algo, name), \
                zoo_scalars(torch, algo)
            st = zoo_state(algo, ZOO_GATE[name])
            grads = lambda: zoo_grads(ops, algo, clone_train_state(st), inp,
                                      scal, False)[1]
            seen = {}
            for flag in (False, True):
                cudnn.deterministic = flag
                runs = [grads() for _ in range(4)]
                with profile(activities=[ProfilerActivity.CUDA]) as p:
                    grads()
                    torch.cuda.synchronize()
                seen[flag] = (
                    sorted({k for r in runs[1:] for k in r
                            if not torch.equal(r[k], runs[0][k])}),
                    {e.key.split("<")[0].split("(")[0]
                     for e in p.key_averages()
                     if e.device_type.name == "CUDA"})
            only = {flag: sorted(seen[flag][1] - seen[not flag][1])
                    for flag in (False, True)}
            print(f"zoo 9c cuDNN, {name} eager {dtn}: gradients differing "
                  f"across 4 steps, default {seen[False][0]}, deterministic "
                  f"{seen[True][0]}; kernels of the default alone "
                  f"{only[False]}, of deterministic alone {only[True]}",
                  flush=True)
            if seen[True][0]:
                raise AssertionError(f"9c {name} {dtn}: deterministic cuDNN "
                                     f"steps differ in {seen[True][0]}")
            out[dtn] = {"differ": seen[False][0], "default_only": only[False],
                        "deterministic_only": only[True]}
            del algo, st
            torch.cuda.empty_cache()
    finally:
        cudnn.deterministic = det
    return out


def zoo_timing(torch, counters, routed, card: str) -> dict:
    """9c's timing, with cuDNN's default algorithm choice as the Trainer
    runs it (8e's rules): bfloat16 eager and replayed blocks in turns,
    median and quartile ms, the profiler's device ms, kernels and idle
    share per iteration, and the launches counted over one replay."""
    import numpy as np

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.tools.profile_step import device_rows, iteration

    out = {}
    for name in ZOO:
        algo = zoo_algo(name, Config(input_size=256, base_width=16,
                                     batch_size=8, compute_dtype="bfloat16"))
        inp, scal = zoo_inputs(torch, np, algo, name), zoo_scalars(torch,
                                                                   algo)
        fns = {mode: iteration(algo, zoo_state(algo, ZOO_GATE[name]), inp,
                               scal, capture=c)
               for mode, c in (("eager", False), ("replayed", True))}
        for fn in fns.values():
            fn()
            fn()
        torch.cuda.synchronize()
        zero(counters, routed)
        fns["replayed"]()
        torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items() if c.launches}
        t = timed_blocks(torch, fns, TIMING_UNITS["gan"], TIMING_ROUNDS)
        for mode, fn in fns.items():
            rows, _ = device_rows(torch, fn, 3)
            r = t[mode]
            r["device_ms"] = sum(x[1] for x in rows)
            r["kernels"] = sum(kernel_counts(
                (k, n) for k, _, n in rows).values())
            r["idle_share"] = 1 - r["device_ms"] / r["median_ms"]
            print(f"zoo 9c on {card}: {name} {mode} bfloat16: median "
                  f"{r['median_ms']:.3f} ms per iteration, quartiles "
                  f"{r['q1_ms']:.3f}-{r['q3_ms']:.3f} ({TIMING_ROUNDS} "
                  f"blocks of {TIMING_UNITS['gan']}); device "
                  f"{r['device_ms']:.3f} ms in {r['kernels']:.0f} kernels; "
                  f"idle share {r['idle_share']:.3f}; launches counted over "
                  f"one replay {counts}", flush=True)
        if counts != {k: v for k, v in zoo_per_step(name, False).items()
                      if v}:
            raise AssertionError(f"9c {name}: launches of one replay "
                                 f"{counts}")
        t["launches"] = counts
        out[name] = t
        del fns
        torch.cuda.empty_cache()
    return out


def zoo_cli(torch, counters, routed, data: Path) -> dict:
    """9d: the CLIs on phase 6's tree, 2 epochs of 10 iterations each,
    epoch 1 under set_sync_debug_mode("error"): ``meanTeacherTrainer`` and
    ``crossPseTrainer`` through ``run_main``, CoraNet's stage A, then
    stage B from its ``pre_best`` (pred_step 1: the pseudo-labels made at
    both epochs); the launches of each training run; then ``-p test`` (the
    trois CSV) and ``-p pseudo`` (the PNG dumps) of each."""
    import numpy as np

    from smsut_tpu_torch.train.cli import make_parser, run_main
    from smsut_tpu_torch.train.steps.cross_pseudo import CrossPseudo
    from smsut_tpu_torch.train.steps.mean_teacher import MeanTeacher
    from smsut_tpu_torch.trainer import coraNetTrainer

    from smsut_tpu_torch.data.dataset import get_label_npys, get_loader

    expr = FIT_DIR / "expr_zoo"
    slices, _ = get_label_npys(str(data), "test")
    steps = FIT_EPOCHS * FIT_ITERS
    fwd = FIT_EPOCHS * FIT_TEST_BATCHES
    # CoraNet B's sweep: the val slices, in chunks of 8
    sweep = -(-len(get_loader(str(data), "val", 0, 1).dataset) // 8)
    stage = ("pre_epoch=2", "cora_epoch=2", "pred_step=1")
    plan = (("meanTeacher", "mt", (), MeanTeacher, None),
            ("crossPse", "cps", (), CrossPseudo, None),
            ("coraPre", "cora", (), None, stage),
            ("coraNet", "cora", ("-i", "000"), None, stage))
    out = {}
    for name, nm, extra, cls, sets in plan:
        args = fit_args(data, expr, nm, *(sets or ()))
        argv = ["-p", "train", *extra] + args
        spans = []
        torch.cuda.synchronize()
        zero(counters, routed)
        with sync_checked_epoch(torch, 1), epoch_clock(spans):
            if cls is not None:
                run_main(cls, make_parser().parse_args(argv))
            else:
                coraNetTrainer.main(make_parser().parse_args(argv))
        torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items()}
        n_sweep = FIT_EPOCHS * sweep if name == "coraNet" else 0
        want = {k: steps * v + (fwd + n_sweep) * PER_FORWARD[False].get(k, 0)
                for k, v in zoo_per_step(name, False).items()}
        idx = "001" if name == "coraNet" else "000"
        model = expr / nm / idx
        log = (model / "train.log").read_text()
        losses = [float(x) for x in re.findall(r"\[TRN\].* loss: ([^/]+)/",
                                               log)]
        last = "pre_last" if name == "coraPre" else "last"
        ckpt = torch.load(model / "ckpt" / f"{last}.ckpt",
                          map_location="cpu", weights_only=True)
        period = per_iteration_ms(spans[1], FIT_ITERS)
        plab = re.findall(r"Pseudo label dice : ([0-9.e-]+)", log)
        print(f"zoo 9d {name}: -p train launches {counts} (expected {want}),"
              f" routed {routed_counts(routed)}; steps {ckpt['step']}; [TRN] "
              f"losses {losses}; epoch-1 ms per iteration {period:.3f} (no "
              f"host wait: set_sync_debug_mode error passed); pseudo-label "
              f"Dice {plab}", flush=True)
        if (counts != want or any(routed_counts(routed).values())
                or ckpt["step"] != steps or len(losses) != FIT_EPOCHS
                or not np.isfinite(losses).all()
                or log.count("[TST]") != FIT_EPOCHS
                or (name == "coraNet" and len(plab) != FIT_EPOCHS)):
            raise AssertionError(f"9d {name}: launches {counts} vs {want}, "
                                 f"step {ckpt['step']}, losses {losses}")
        out[name] = {"launches": counts, "expected": want, "losses": losses,
                     "period_ms": period, "plab_dice": plab}
        if name == "coraPre":
            continue
        best = "best"
        for phase in ("test", "pseudo"):
            argv = ["-p", phase, "-i", idx, "-wh", best] + args
            t0 = time.perf_counter()
            if cls is not None:
                run_main(cls, make_parser().parse_args(argv))
            else:
                coraNetTrainer.main(make_parser().parse_args(argv))
            out[name][f"{phase}_s"] = time.perf_counter() - t0
        rows = [r for r in (model / "all_trois_matrix.csv").read_text()
                .split("\n") if r]
        vals = np.array([[float(v) for v in r.split(",")] for r in rows])
        dumps = sorted((model / "pseudo").iterdir())
        kinds = {k: sum(p.name.endswith(k + ".png") for p in dumps)
                 for k in ("pse", "gt", "ori")}
        print(f"zoo 9d {name}: -p test {out[name]['test_s']:.1f} s, CSV "
              f"{vals.shape}, mean Dice {vals[4, 4]:.4f}; -p pseudo "
              f"{out[name]['pseudo_s']:.1f} s, dumps {kinds}", flush=True)
        if (vals.shape != (10, 5) or not np.isfinite(vals).all()
                or any(n != slices for n in kinds.values())):
            raise AssertionError(f"9d {name}: CSV {vals.shape}, dumps "
                                 f"{kinds}")
        out[name]["csv"] = vals.tolist()
    return out


def zoo_serving(torch) -> dict:
    """9e: ``export_eval`` -> ``load_serving`` -> ``predict`` of each new
    algorithm and of ``uganConsis``, float32: the served logits equal the
    algorithm's ``eval_fn`` on the same parameters to the bit."""
    import numpy as np

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.serve import export_eval, load_serving

    cfg = Config(input_size=256, base_width=16, batch_size=8,
                 compute_dtype="float32")
    req = torch.from_numpy(ellipse_batch(np, seed=5)["img"]).cuda()
    out = {}
    for name in ("meanTeacher", "crossPse", "coraNet", "uganConsis"):
        algo = zoo_algo(name, cfg)
        params = algo.eval_params(algo.init_state(0))
        art = ROOT / "build" / "chip_smoke_serving" / f"zoo_{name}"
        export_eval(algo, params, cfg, str(art))
        predict, manifest = load_serving(str(art))
        got = [predict(req) for _ in range(3)]
        want = algo.eval_fn(params, req)
        diff = max(float((g - want).abs().max()) for g in got)
        print(f"zoo 9e {manifest['algo']}: served logits {tuple(got[0].shape)}"
              f" vs eval_fn max |diff| {diff} (must be 0)", flush=True)
        if diff != 0 or list(got[0].shape) != manifest["output"]["shape"]:
            raise AssertionError(f"9e {name}: diff {diff}")
        out[manifest["algo"]] = diff
        del predict, algo
        torch.cuda.empty_cache()
    return out


def zoo_phase(torch, ops, counters, routed, card: str) -> dict:
    """Phase 9: 9a-9e (9d on phase 6's tree)."""
    import torch.backends.cudnn as cudnn

    a = zoo_steps(torch, ops, counters, routed)
    b = zoo_gates(torch, ops)
    # cuDNN picks deterministic algorithms for the bit-equality checks
    # alone: its default float32 weight gradient of the stem conv
    # (wgrad_alg0, which adds with atomics) differs from run to run
    n = zoo_cudnn(torch, ops)
    det = cudnn.deterministic
    cudnn.deterministic = True
    try:
        c = zoo_replays(torch)
        e = zoo_serving(torch)
    finally:
        cudnn.deterministic = det
    t = zoo_timing(torch, counters, routed, card)
    d = zoo_cli(torch, counters, routed, FIT_DIR / "data")
    return {"steps": a, "gates": b, "cudnn": n, "replays": c, "timing": t,
            "cli": d, "serving": e}


# phase 10: M3L's masked-consistency SegFormer and the dual-task U-Net.
# 10a: DTCUNet at its own width (64), 256^2, batch 8, in three
# configurations: batch norm + ReLU (the model's default), instance norm +
# leaky ReLU unfused and with block_pallas
DTC_WIDTH, DTC_OUT = 64, 5
DTC_CONFIGS = (("batch", "relu", False), ("instance", "lrelu", False),
               ("instance", "lrelu", True))
# the distinct shapes of DTC w64 at 256^2: its 18 3x3 convs (map side,
# Cin, Cout), its norms (map side, channels) and its nine blocks, all of
# the shortcut form (map side, Cin, Cout); bfloat16 holds K1-K6 at each,
# float32 at the widest rows
DTC_CONVS = ((256, 32, 64), (256, 64, 64), (128, 64, 128), (128, 128, 128),
             (64, 128, 256), (64, 256, 256), (32, 256, 512), (32, 512, 512),
             (16, 512, 1024), (16, 1024, 1024), (32, 1024, 512),
             (64, 512, 256), (128, 256, 128), (256, 128, 64))
DTC_NORMS = ((256, 32), (256, 64), (128, 128), (64, 256), (32, 512),
             (16, 1024))
DTC_BLOCKS = ((256, 32, 64), (128, 64, 128), (64, 128, 256),
              (32, 256, 512), (16, 512, 1024), (32, 1024, 512),
              (64, 512, 256), (128, 256, 128), (256, 128, 64))
F32_DTC_CONVS = ((16, 1024, 1024), (32, 1024, 512))
F32_DTC_NORMS = ((16, 1024),)
F32_DTC_BLOCKS = ((16, 512, 1024), (32, 1024, 512))
# 10b: the M3L iteration at the Config defaults (256^2, 8 + 8)
M3L_STEPS = 10
M3L_LOSS_TOL = 1e-4      # float32 step 1, card vs the port on the CPU
M3L_REPLAYS = 5          # float32 iterations replayed against eager
M3L_GATE = 98            # the EMA's alpha leaves 0 at count 100


def dtc_launches(norm: str, fused: bool) -> dict:
    """The launches of one forward and of one backward of DTCUNet: its
    U-Net's 18 3x3 convs (K2 forward, K2 dx and K5 backward) and, with
    instance norm, its 28 norms (K1, K4); with block_pallas its nine
    blocks (K3, K6) and the stem's norm."""
    inst = norm == "instance"
    if inst and fused:
        return ({"instnorm": 1, "block": 9},
                {"instnorm_bwd": 1, "block_bwd": 9})
    return ({"conv3x3": 18, "instnorm": 28 if inst else 0},
            {"conv3x3": 18, "conv3x3_dw": 18,
             "instnorm_bwd": 28 if inst else 0})


def dtc_run(torch, ops, counters, routed, net, x, cots, plain: bool):
    """One forward and backward of sum(out1 * c1) + sum(out2 * c2): the
    heads, every parameter's gradient, and the forward's and the
    backward's launches and routes."""
    params = dict(net.named_parameters())
    with ops.plain() if plain else contextlib.nullcontext():
        torch.cuda.synchronize()
        zero(counters, routed)
        o1, o2 = net(x)
        torch.cuda.synchronize()
        fwd = {k: c.launches for k, c in counters.items() if c.launches}
        rc = routed_counts(routed)
        zero(counters, routed)
        loss = ((o1 * cots[0].to(o1.dtype)).sum()
                + (o2 * cots[1].to(o2.dtype)).sum())
        grads = torch.autograd.grad(loss, list(params.values()))
        torch.cuda.synchronize()
        bwd = {k: c.launches for k, c in counters.items() if c.launches}
    return ((o1.detach(), o2.detach()), dict(zip(params, grads)), fwd, bwd,
            rc)


def dtc_timing(torch, net, x, cots) -> dict:
    """The kernel path's forward and backward of ``net``: device ms per
    call (CUDA events around 3 calls, a sleep kernel holding the stream),
    and the profiler's device ms, kernels and heaviest kernels."""
    from smsut_tpu_torch.tools.profile_step import device_rows

    params = list(net.parameters())

    def fwd_bwd():
        o1, o2 = net(x)
        loss = (o1 * cots[0]).sum() + (o2 * cots[1]).sum()
        return torch.autograd.grad(loss, params)

    ms = time_ms(fwd_bwd, 3)
    rows, _ = device_rows(torch, fwd_bwd, 2)
    return {"ms": ms, "device_ms": sum(r[1] for r in rows),
            "kernels": sum(r[2] for r in rows),
            "top": [(k.split("(")[0][-48:], round(t, 3)) for k, t, _ in
                    rows[:6]]}


def l2_rel(got: dict, ref: dict) -> float:
    """||got - ref|| / ||ref|| over all tensors of ``ref`` together."""
    d2 = sum(float(((got[k].double() - r.double()) ** 2).sum())
             for k, r in ref.items())
    return (d2 / sum(float((r.double() ** 2).sum())
                     for r in ref.values())) ** 0.5


def dtc_models(torch, ops, counters, routed) -> dict:
    """10a, the model: per configuration the forward and a backward of a
    loss over both heads, float32 (TF32 off) and bfloat16 against
    ops.plain(), with a float64 plain run as the reference; the launches
    of the forward and of the backward, nothing routed.  Phase 4's rules,
    with its float32 L2 and per-tensor rel_err read against float64: at
    width 64 a float32 summation difference moves a pre-activation across
    0, and ReLU (or the leaky slope) then gates that element's gradient
    differently on the two paths (measured: per-tensor rel_err up to 0.049,
    L2 of all 5e-3 with batch norm + ReLU), so the float32 kernel path
    must be no less accurate than the float32 plain path against float64,
    ||K32 - P64|| <= BF16_ACC * ||P32 - P64|| + GRAD_REL * ||P64|| over all
    gradients, with per-tensor cosine (K32, P32) at least GRAD_COS and the
    heads within LOGIT_TOL; bfloat16 as phase 4: per tensor, and for the
    heads, no less accurate than the bfloat16 plain path against the
    float32 plain one."""
    import numpy as np

    from smsut_tpu_torch.models.dtc import DTCUNet

    x = torch.from_numpy(ellipse_batch(np, seed=7)["img"]).cuda()
    g = torch.Generator(device="cuda").manual_seed(7)
    cots = [torch.randn((8, 256, 256, DTC_OUT), generator=g, device="cuda")
            for _ in range(2)]
    out = {}
    for norm, act, fused in DTC_CONFIGS:
        runs = {}
        for dtn, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
            net = DTCUNet(DTC_OUT, DTC_WIDTH, norm_type=norm, act_type=act,
                          compute_dtype=dt, block_fused=fused, seed=0)
            for plain in (False, True):
                runs[dtn, plain] = dtc_run(torch, ops, counters, routed,
                                           net, x, cots, plain)
            if dtn == "bfloat16":
                timing = dtc_timing(torch, net, x, cots)
            del net
        net = DTCUNet(DTC_OUT, DTC_WIDTH, norm_type=norm, act_type=act,
                      compute_dtype=torch.float64, block_fused=fused,
                      seed=0).double()
        exact = dtc_run(torch, ops, counters, routed, net, x.double(), cots,
                        True)
        del net
        want_f, want_b = dtc_launches(norm, fused)
        heads = {k: {"fc1": r[0][0], "fc2": r[0][1]} for k, r in runs.items()}
        head_err = max(rel_err(a, w) for a, w in zip(
            runs["float32", False][0], runs["float32", True][0]))
        ha = bf16_accuracy(heads["bfloat16", False], heads["bfloat16", True],
                           heads["float32", True])
        c32 = grad_parity(runs["float32", False][1], runs["float32", True][1])
        x64 = {"kernel": l2_rel(runs["float32", False][1], exact[1]),
               "plain": l2_rel(runs["float32", True][1], exact[1])}
        a = bf16_accuracy(runs["bfloat16", False][1],
                          runs["bfloat16", True][1],
                          runs["float32", True][1])
        label = f"{norm}/{act} block_pallas={fused}"
        counts = {dtn: runs[dtn, False][2:5] for dtn in ("float32",
                                                          "bfloat16")}
        print(f"dtc 10a {label} w{DTC_WIDTH} [8,256,256,1]: float32 heads "
              f"rel err vs plain {head_err:.3g}; bfloat16 heads vs the "
              f"float32 plain heads: kernel {ha['kernel_err_max']:.3g}, "
              f"plain {ha['plain_err_max']:.3g}; float32 gradients of "
              f"{c32['n']} tensors vs plain: rel err max "
              f"{c32['rel_max']:.3g} ({c32['worst_rel']}), L2 of all "
              f"{c32['l2_all']:.3g}, cosine min {c32['cos_min']:.6f} "
              f"({c32['worst_cos']}); L2 of all vs float64: kernel "
              f"{x64['kernel']:.3g}, plain {x64['plain']:.3g}; bfloat16 vs "
              f"the float32 plain gradient: kernel err max "
              f"{a['kernel_err_max']:.3g}, plain {a['plain_err_max']:.3g}, "
              f"closest to the bound {a['worst']} ({a['kernel_err']:.3g} vs "
              f"{a['plain_err']:.3g}); launches forward "
              f"{counts['bfloat16'][0]} backward {counts['bfloat16'][1]} "
              f"(expected {want_f}, {want_b}), routed "
              f"{counts['bfloat16'][2]}; bfloat16 forward + backward "
              f"{timing['ms']:.3f} ms (CUDA events), device "
              f"{timing['device_ms']:.3f} ms in {timing['kernels']} kernels"
              f" (profiler), heaviest {timing['top'][:3]}", flush=True)
        for dtn, (fwd, bwd, rc) in counts.items():
            if (fwd != {k: v for k, v in want_f.items() if v}
                    or bwd != {k: v for k, v in want_b.items() if v}
                    or any(rc.values())):
                raise AssertionError(f"10a {label} {dtn}: launches {fwd}, "
                                     f"{bwd}, routed {rc}")
        if not (head_err <= LOGIT_TOL["float32"] and ha["worst_over"] <= 0
                and x64["kernel"] <= BF16_ACC * x64["plain"] + GRAD_REL
                and c32["cos_min"] >= GRAD_COS and a["worst_over"] <= 0):
            raise AssertionError(f"10a {label}: heads {head_err}, {ha}, "
                                 f"{c32}, {x64}, {a}")
        launches = {k: sum(c[0].get(k, 0) + c[1].get(k, 0)
                           for c in counts.values()) for k in KERNELS}
        out[label] = {"launches": launches, "heads": head_err,
                      "heads_bf16": ha, "f32": c32, "f64": x64,
                      "bf16": a, "forward": counts["bfloat16"][0],
                      "backward": counts["bfloat16"][1], "timing": timing}
        del runs, exact
        torch.cuda.empty_cache()
    return out


def dtc_kernel_shapes(torch, ops, instnorm, conv3x3, block) -> list:
    """10a, the kernels: K1 and K4 at DTC's norms (both activations; two
    runs bit for bit), K2, K2 as dx and K5 at its 18 convs' 14 distinct
    shapes, K3 and K6 at its nine blocks, in bfloat16, and float32 at the
    widest, each against its plain version under phase 2's bounds (TOL)."""
    cases = Cases(torch, seed=10)
    rows = []

    def hold(name, label, dn, fn, args):
        as_tuple = lambda o: o if isinstance(o, tuple) else (o,)
        with ops.plain():
            want = as_tuple(fn(*args))
        got = as_tuple(fn(*args))
        err = max(rel_err(a, w) for a, w in zip(got, want) if w is not None)
        rows.append({"name": name, "case": label, "dtype": dn,
                     "rel_err": err, "tol": TOL[(name, dn)]})
        if not err <= TOL[(name, dn)]:
            raise AssertionError(f"10a {name} {label} {dn}: error {err}")

    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[-1]
        f32 = dt == torch.float32
        for hw, c in F32_DTC_NORMS if f32 else DTC_NORMS:
            for act in (True, False):
                shape = (8, hw, hw, c)
                x = cases.randn(*shape, mean=0.3, dtype=dt)
                gy = cases.randn(*shape, dtype=dt)
                s, bb = cases.norm_params(c)
                same_twice(torch, "instnorm", shape,
                           instnorm.instance_norm_fwd, (x, s, bb, act))
                hold("instnorm", f"{list(shape)} act={act}", dn,
                     lambda *a: instnorm.instance_norm_fwd(*a)[0],
                     (x, s, bb, act))
                _, mean, rstd = instnorm.instance_norm_fwd(x, s, bb, act)
                same_twice(torch, "instnorm_bwd", shape,
                           instnorm.instance_norm_bwd,
                           (x, gy, mean, rstd, s, bb, act))
                hold("instnorm_bwd", f"{list(shape)} act={act}", dn,
                     instnorm.instance_norm_bwd,
                     (x, gy, mean, rstd, s, bb, act))
        for hw, ci, co in F32_DTC_CONVS if f32 else DTC_CONVS:
            x = cases.randn(8, hw, hw, ci, dtype=dt)
            gy = cases.randn(8, hw, hw, co, dtype=dt)
            w = cases.conv_w(3, ci, co, dt)
            label = f"{[8, hw, hw, ci]}->{co}"
            hold("conv3x3", label, dn, conv3x3.conv3x3_fwd, (x, w))
            hold("conv3x3_dx", f"{[8, hw, hw, co]}->{ci}", dn,
                 conv3x3.conv3x3_fwd, (gy, conv3x3.flip_io(w)))
            hold("conv3x3_dw", label, dn, conv3x3.conv3x3_dw, (x, gy))
        for hw, ci, co in F32_DTC_BLOCKS if f32 else DTC_BLOCKS:
            args = cases.block_args(8, hw, hw, ci, co, dt)
            label = f"shortcut {[8, hw, hw, ci]}->{co}"
            hold("block", label, dn, block.basic_block_fwd, tuple(args))
            x, w1, s1, _, w2, s2, _, ws, ss, _ = args
            _, res = block.basic_block_fwd(*args, save=True)
            gy = cases.randn(8, hw, hw, co, dtype=dt)
            hold("block_bwd", label, dn, block.basic_block_bwd,
                 (gy, x, w1, s1, w2, s2, ws, ss, res))
        torch.cuda.empty_cache()
    worst = {}
    for r in rows:
        k = (r["name"], r["dtype"])
        if k not in worst or r["rel_err"] > worst[k]["rel_err"]:
            worst[k] = r
    print("dtc 10a kernels at the DTC w64 shapes, against their plain "
          f"versions: {len(rows)} checks; worst per kernel and dtype "
          + "; ".join(f"{n} {d} {r['rel_err']:.3g} (tol {r['tol']}) at "
                      f"{r['case']}" for (n, d), r in sorted(worst.items())),
          flush=True)
    return rows


def m3l_algo(dtn: str, device=None):
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.steps.m3l import M3L

    return M3L(Config(input_size=256, batch_size=8, compute_dtype=dtn),
               device)


def m3l_steps(torch, counters, routed, card: str) -> dict:
    """10b: 10 replayed bfloat16 iterations at the Config defaults (256^2,
    8 + 8: student and teacher each see 16 images), finite losses, no
    launch of the port's kernels; then eager and replayed blocks in turns
    (8e's rules): ms, device ms, kernels and idle share per iteration."""
    import numpy as np

    from smsut_tpu_torch.tools.profile_step import device_rows, iteration

    algo = m3l_algo("bfloat16")
    inp = zoo_inputs(torch, np, algo, "M3L")
    scal = zoo_scalars(torch, algo)
    run = iteration(algo, algo.init_state(0), inp, scal)
    torch.cuda.synchronize()
    zero(counters, routed)
    metrics = [{k: float(v) for k, v in run().items()}
               for _ in range(M3L_STEPS)]
    torch.cuda.synchronize()
    counts = {k: c.launches for k, c in counters.items()}
    losses = [m["loss"] for m in metrics]
    semi = [m["semi_loss"] for m in metrics]
    print(f"m3l 10b: {M3L_STEPS} replayed bfloat16 iterations at 256^2, 8 + "
          f"8: losses {[round(x, 5) for x in losses]}, semi "
          f"{[round(x, 5) for x in semi]}; launches {counts} (M3L runs none "
          f"of the port's kernels), routed {routed_counts(routed)}",
          flush=True)
    if (not np.isfinite(losses + semi).all() or any(counts.values())
            or any(routed_counts(routed).values())):
        raise AssertionError(f"10b: {metrics}, {counts}")
    del run
    fns = {mode: iteration(algo, algo.init_state(0), inp, scal, capture=c)
           for mode, c in (("eager", False), ("replayed", True))}
    for fn in fns.values():
        fn()
        fn()
    t = timed_blocks(torch, fns, TIMING_UNITS["gan"], TIMING_ROUNDS)
    for mode, fn in fns.items():
        rows, _ = device_rows(torch, fn, 3)
        r = t[mode]
        r["device_ms"] = sum(x[1] for x in rows)
        r["kernels"] = sum(kernel_counts((k, n) for k, _, n in rows).values())
        r["idle_share"] = 1 - r["device_ms"] / r["median_ms"]
        r["top"] = [(k[:90], ms, n) for k, ms, n in rows[:8]]
        print(f"m3l 10b on {card}: {mode} bfloat16: median "
              f"{r['median_ms']:.3f} ms per iteration, quartiles "
              f"{r['q1_ms']:.3f}-{r['q3_ms']:.3f} ({TIMING_ROUNDS} blocks of "
              f"{TIMING_UNITS['gan']}); device {r['device_ms']:.3f} ms in "
              f"{r['kernels']:.0f} kernels; idle share "
              f"{r['idle_share']:.3f}; heaviest "
              f"{[(k[:60], round(ms, 3)) for k, ms, _ in rows[:4]]}",
              flush=True)
    del fns
    torch.cuda.empty_cache()
    return {"losses": losses, "semi": semi, "launches": counts,
            "timing": t}


def m3l_card_vs_cpu(torch) -> dict:
    """10b: float32 step 1 on the card against the port's step on the CPU
    from the same weights, batch and mask grid (TF32 off): the losses
    within M3L_LOSS_TOL relative, the student after Adam's first update
    flip-aware (every element within 2.1 lr, under 1% beyond lr: the
    first update is about lr * sign(g))."""
    import numpy as np

    from smsut_tpu_torch.train.steps.m3l import mask_grid

    card, cpu = m3l_algo("float32"), m3l_algo("float32", "cpu")
    params = {k: v.cpu() for k, v in card.init_params(0).items()}
    lb, ul = ellipse_batch(np, seed=0), ellipse_batch(np, seed=1)
    grid = mask_grid(torch.tensor(0), card.grid_shape(16, 256, 256),
                     card.cfg.seed)
    batch = {"img": lb["img"], "msk": lb["msk"], "ul_img": ul["img"],
             "mask": grid.numpy()}
    out = []
    for algo in (card, cpu):
        st = algo.state_from_params(params)
        m = algo.step(st, algo.inputs(batch), algo.epoch_scalars(3))
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.cpu() for k, v in st.params.items()}))
    (mg, pg), (mc, pc) = out
    lr = card.cfg.lr
    loss_err = {k: abs(mg[k] - mc[k]) / abs(mc[k])
                for k in ("loss", "semi_loss")}
    dev = torch.cat([(pg[k] - pc[k]).abs().flatten() for k in pc])
    dmax, share = float(dev.max()), float((dev > lr).float().mean())
    print(f"m3l 10b float32 step 1, card vs the port on the CPU: loss "
          f"{mg['loss']:.6f} vs {mc['loss']:.6f}, semi {mg['semi_loss']:.6f}"
          f" vs {mc['semi_loss']:.6f} (rel {loss_err}); student after Adam "
          f"max |dev| {dmax:.3g} (bound {GAN_FLIP_DEV} lr = "
          f"{GAN_FLIP_DEV * lr:.3g}), share beyond lr {share:.3g}",
          flush=True)
    if (max(loss_err.values()) > M3L_LOSS_TOL or dmax > GAN_FLIP_DEV * lr
            or share >= GAN_FLIP_SHARE):
        raise AssertionError(f"10b card vs cpu: {loss_err}, {dmax}, {share}")
    return {"card": mg, "cpu": mc, "loss_rel": loss_err, "dev_max": dmax,
            "flip_share": share}


def m3l_replays(torch) -> dict:
    """10b, under deterministic cuDNN: five float32 iterations replayed
    against five eager ones from one init at count 98 (the EMA's alpha
    leaves 0 at 100), the mask drawn on the card from the count: the
    metrics, the student and the teacher to the bit."""
    import numpy as np

    from smsut_tpu_torch.tools.profile_step import iteration

    algo = m3l_algo("float32")
    inp, scal = zoo_inputs(torch, np, algo, "M3L"), zoo_scalars(torch, algo)
    states = [zoo_state(algo, M3L_GATE) for _ in range(2)]
    ms = [[{k: float(v) for k, v in run().items()}
           for _ in range(M3L_REPLAYS)]
          for run in (iteration(algo, st, inp, scal, capture=c)
                      for st, c in zip(states, (False, True)))]
    same = ms[0] == ms[1] and all(
        torch.equal(getattr(states[1], t)[k], v)
        for t in ("params", "ema_params")
        for k, v in getattr(states[0], t).items())
    alpha = [m["alpha"] for m in ms[1]]
    print(f"m3l 10b float32: {M3L_REPLAYS} replayed iterations equal eager "
          f"to the bit: {same}; alpha {alpha}", flush=True)
    if not same or alpha[1] != 0 or abs(alpha[2] - 0.99) > 1e-6:
        raise AssertionError(f"10b replays: {ms}")
    return {"same": same, "metrics": ms[1]}


def m3l_cli(torch, counters, routed, data: Path) -> dict:
    """10c: ``M3LTrainer -p train`` through ``run_main`` on phase 6's tree,
    2 epochs of 10 (epoch 1 under set_sync_debug_mode("error")), then
    ``-p test`` (the trois CSV) and ``-p pseudo`` (the PNG dumps)."""
    import numpy as np

    from smsut_tpu_torch.data.dataset import get_label_npys
    from smsut_tpu_torch.train.cli import make_parser, run_main
    from smsut_tpu_torch.train.steps.m3l import M3L

    expr = FIT_DIR / "expr_m3l"
    slices, _ = get_label_npys(str(data), "test")
    args = fit_args(data, expr, "m3l")
    spans = []
    torch.cuda.synchronize()
    zero(counters, routed)
    with sync_checked_epoch(torch, 1), epoch_clock(spans):
        run_main(M3L, make_parser().parse_args(["-p", "train"] + args))
    torch.cuda.synchronize()
    counts = {k: c.launches for k, c in counters.items()}
    model = expr / "m3l" / "000"
    log = (model / "train.log").read_text()
    losses = [float(x) for x in re.findall(r"\[TRN\].* loss: ([^/]+)/", log)]
    ckpt = torch.load(model / "ckpt" / "last.ckpt", map_location="cpu",
                      weights_only=True)
    period = per_iteration_ms(spans[1], FIT_ITERS)
    steps = FIT_EPOCHS * FIT_ITERS
    print(f"m3l 10c: -p train launches {counts} (none expected), routed "
          f"{routed_counts(routed)}; steps {ckpt['step']}, Adam count "
          f"{ckpt['opt_count']}; [TRN] losses {losses}; epoch-1 ms per "
          f"iteration {period:.3f} (no host wait: set_sync_debug_mode error "
          f"passed)", flush=True)
    if (any(counts.values()) or ckpt["step"] != steps
            or ckpt["opt_count"] != steps or len(losses) != FIT_EPOCHS
            or not np.isfinite(losses).all()
            or log.count("[TST]") != FIT_EPOCHS):
        raise AssertionError(f"10c: {counts}, {ckpt['step']}, {losses}")
    out = {"launches": counts, "losses": losses, "period_ms": period}
    for phase in ("test", "pseudo"):
        t0 = time.perf_counter()
        run_main(M3L, make_parser().parse_args(
            ["-p", phase, "-i", "000", "-wh", "best"] + args))
        out[f"{phase}_s"] = time.perf_counter() - t0
    rows = [r for r in (model / "all_trois_matrix.csv").read_text()
            .split("\n") if r]
    vals = np.array([[float(v) for v in r.split(",")] for r in rows])
    dumps = sorted((model / "pseudo").iterdir())
    kinds = {k: sum(p.name.endswith(k + ".png") for p in dumps)
             for k in ("pse", "gt", "ori")}
    print(f"m3l 10c: -p test {out['test_s']:.1f} s, CSV {vals.shape}, mean "
          f"Dice {vals[4, 4]:.4f}; -p pseudo {out['pseudo_s']:.1f} s, dumps "
          f"{kinds}", flush=True)
    if (vals.shape != (10, 5) or not np.isfinite(vals).all()
            or any(n != slices for n in kinds.values())):
        raise AssertionError(f"10c: CSV {vals.shape}, dumps {kinds}")
    out["csv"] = vals.tolist()
    return out


def m3l_serving(torch) -> dict:
    """10d: ``export_eval`` -> ``load_serving`` -> ``predict`` of M3L,
    float32 (deterministic cuDNN): the served logits equal ``eval_fn``'s at
    the same batch to the bit (the head's batch norm takes the batch's
    statistics)."""
    import numpy as np

    from smsut_tpu_torch.serve import export_eval, load_serving

    algo = m3l_algo("float32")
    params = algo.eval_params(algo.init_state(0))
    req = torch.from_numpy(ellipse_batch(np, seed=5)["img"]).cuda()
    art = ROOT / "build" / "chip_smoke_serving" / "m3l"
    export_eval(algo, params, algo.cfg, str(art))
    predict, manifest = load_serving(str(art))
    got = [predict(req) for _ in range(3)]
    want = algo.eval_fn(params, req)
    diff = max(float((g - want).abs().max()) for g in got)
    print(f"m3l 10d {manifest['algo']}: served logits {tuple(got[0].shape)} "
          f"vs eval_fn max |diff| {diff} (must be 0)", flush=True)
    if diff != 0 or list(got[0].shape) != manifest["output"]["shape"]:
        raise AssertionError(f"10d: diff {diff}")
    return {"diff": diff}


def m3l_dtc_phase(torch, ops, counters, routed, card: str,
                  instnorm, conv3x3, block) -> dict:
    """Phase 10: 10a-10d (10c on phase 6's tree)."""
    import torch.backends.cudnn as cudnn

    t0 = time.perf_counter()
    a = dtc_models(torch, ops, counters, routed)
    rows = dtc_kernel_shapes(torch, ops, instnorm, conv3x3, block)
    t1 = time.perf_counter()
    b = m3l_steps(torch, counters, routed, card)
    b["card_vs_cpu"] = m3l_card_vs_cpu(torch)
    det = cudnn.deterministic
    cudnn.deterministic = True
    try:
        b["replays"] = m3l_replays(torch)
        d = m3l_serving(torch)
    finally:
        cudnn.deterministic = det
    t2 = time.perf_counter()
    c = m3l_cli(torch, counters, routed, FIT_DIR / "data")
    print(f"phase 10: 10a {t1 - t0:.1f} s, 10b and 10d {t2 - t1:.1f} s, 10c "
          f"{time.perf_counter() - t2:.1f} s", flush=True)
    return {"dtc": a, "dtc_kernels": rows, "m3l": b, "m3l_cli": c,
            "m3l_serving": d}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from smsut_tpu_torch import ops
    from smsut_tpu_torch.ops import _build, block, conv3x3, conv_mma, instnorm

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
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                             log) if int(m)]
        serial = log.count("wgmma.mma_async instructions are serialized")
        print(f"ptxas {name}: {len(regs)} kernels, registers max "
              f"{max(regs, default=0)}, {len(spills)} kernels spill, at most "
              f"{max(spills, default=0)} bytes; {serial} wgmma serialized; "
              f"{log.count('C7508')} setmaxnreg ignored (C7508)")
    ptxas_dots = ptxas_kernel(_build.build_log("conv3x3_mma"),
                              "conv_dots_sm90_kernel")
    print(f"ptxas conv_dots_sm90_kernel: {ptxas_dots}", flush=True)
    sass, libs = {}, {}
    for lib, kernel, count, need, never in TC_KERNELS:
        if lib not in libs:
            libs[lib] = sass_ops(_build.lib_path(lib))
        if libs[lib] is None:
            print(f"sass {lib}: cuobjdump not found, opcodes not counted")
            continue
        tc = {k: v for k, v in libs[lib].items() if kernel in k}
        sass[f"{lib} {kernel}"] = tc
        print(f"sass {lib}: {len(tc)} {kernel} instantiations, "
              + "; ".join(f"{o} per kernel {sorted(v[o] for v in tc.values())}"
                          for o in need + never), flush=True)
        if len(tc) != count or not all(
                all(v[o] for o in need) and not any(v[o] for o in never)
                for v in tc.values()):
            raise AssertionError(f"{lib}: tensor-core kernels {tc}")

    t0 = time.perf_counter()
    rows = check_kernels(torch, F, ops, instnorm, conv3x3, block)
    rows += check_backward_kernels(torch, F, ops, instnorm, conv3x3, block)
    rows += check_mma_kernels(torch, F, ops, conv_mma)
    print(f"phases 2-2c: {time.perf_counter() - t0:.1f} s", flush=True)
    counters = {"instnorm": instnorm.instance_norm_fwd,
                "conv3x3": conv3x3.conv3x3_fwd, "block": block.basic_block_fwd,
                "instnorm_bwd": instnorm.instance_norm_bwd,
                "conv3x3_dw": conv3x3.conv3x3_dw,
                "block_bwd": block.basic_block_bwd}
    counters.update({f"conv3x3_{v}": getattr(conv_mma, f"conv3x3_{v}")
                     for v in MMA_VARIANTS})
    routed = {"conv3x3": conv3x3.conv3x3, "block": block.basic_block}
    t0 = time.perf_counter()
    serve = serve_modes(torch, ops, counters, routed)
    print(f"phase 3: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    train = train_modes(torch, ops, counters, routed)
    w8 = train_w8(torch, ops, counters, routed)
    print(f"phase 4: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    bench = microbench(torch, counters)
    print(f"phase 5: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    fit = fit_loop(torch, ops, counters, routed, train, card)
    print(f"phase 6: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    gan = gan_phase(torch, ops, counters, routed)
    print(f"phase 7: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    dispatch = dispatch_phase(torch, ops, counters, routed, card)
    print(f"phase 8: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    zoo = zoo_phase(torch, ops, counters, routed, card)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    m3l_dtc = m3l_dtc_phase(torch, ops, counters, routed, card, instnorm,
                            conv3x3, block)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(FIT_DIR, ignore_errors=True)

    # (row name, case, source, TPU kernel); K2's row is its forward case,
    # the tensor-core convs' the microbench's shape at strip 16
    main_case = {
        "instnorm": ("instnorm", "[8, 256, 256, 16] act=True",
                     "smsut_tpu_torch/csrc/instnorm.cu",
                     "smsut_tpu/ops/instnorm_pallas.py:90"),
        "conv3x3": ("conv3x3", "[8, 256, 256, 32]->16",
                    "smsut_tpu_torch/csrc/conv3x3.cu",
                    "smsut_tpu/ops/conv_pallas.py:69"),
        "block": ("block", "shortcut [8, 256, 256, 32]->16",
                  "smsut_tpu_torch/csrc/block.cu",
                  "smsut_tpu/ops/block_pallas.py:185"),
        "instnorm_bwd": ("instnorm_bwd", "[8, 256, 256, 16] act=True",
                         "smsut_tpu_torch/csrc/instnorm_bwd.cu",
                         "smsut_tpu/ops/instnorm_pallas.py:135"),
        "conv3x3_dw": ("conv3x3_dw", "[8, 256, 256, 32]->16",
                       "smsut_tpu_torch/csrc/conv3x3_dw.cu",
                       "smsut_tpu/ops/conv_pallas.py:124"),
        "block_bwd": ("block_bwd", "shortcut [8, 256, 256, 32]->16",
                      "smsut_tpu_torch/csrc/block_bwd.cu",
                      "smsut_tpu/ops/block_pallas.py:488")}
    for v, line, src in zip(MMA_VARIANTS, (63, 99, 139),
                            ("conv3x3_dots_sm90.cuh",
                             "conv3x3_im2col_sm90.cuh",
                             "conv3x3_im2col_sm90.cuh")):
        main_case[f"conv3x3_{v}"] = (
            f"conv3x3_{v}", "[16, 128, 128, 64]->64 strip=16",
            f"smsut_tpu_torch/csrc/{src}",
            f"tools/microbench_pallas_conv.py:{line}")
    kernels = []
    for name, (row_name, case, source, replaces) in main_case.items():
        r = next(r for r in rows if r["name"] == row_name
                 and r["case"] == case and r["dtype"] == "bfloat16")
        runs = (*serve.values(), *train.values(), *w8.values(), bench,
                *fit["cli"].values(), *fit["watched"].values(),
                *gan["steps"].values(), gan["cli"],
                *dispatch["unet"].values(), *dispatch["gan"].values(),
                *dispatch["fits"].values(), dispatch["predict"],
                *zoo["steps"].values(), *zoo["cli"].values(),
                *m3l_dtc["dtc"].values(), m3l_dtc["m3l"],
                m3l_dtc["m3l_cli"])
        launches = sum(v["launches"][name] for v in runs)
        if launches < 1:
            raise AssertionError(f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    with open(OUT / "chip_smoke.json", "w") as f:
        json.dump({"card": card, "build_s": build_s, "sass_ops": sass,
                   "ptxas_conv_dots_sm90_kernel": ptxas_dots,
                   "kernel_rows": rows,
                   "serve": {str(k): v for k, v in serve.items()},
                   "train": {str(k): v for k, v in train.items()},
                   "train_w8": {str(k): v for k, v in w8.items()},
                   "microbench": bench, "fit": {
                       "cli": {str(k): v for k, v in fit["cli"].items()},
                       **{k: v for k, v in fit.items() if k != "cli"}},
                   "gan": {"double_backward": gan["double_backward"],
                           "steps": {str(k): v for k, v in
                                     gan["steps"].items()},
                           "cli": gan["cli"]},
                   "dispatch": json.loads(json.dumps(dispatch, default=str)),
                   "zoo": json.loads(json.dumps(zoo, default=str)),
                   "m3l_dtc": json.loads(json.dumps(m3l_dtc, default=str)),
                   "kernels": kernels}, f, indent=1)
    shutil.rmtree(ROOT / "build" / "chip_smoke_serving", ignore_errors=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
