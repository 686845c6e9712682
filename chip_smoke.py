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
   -i 000 -wh best`` of both through ``python -m
   smsut_tpu_torch.trainer.unetTrainer``, two subprocesses side by side.
   Checks 20 steps, finite losses, the [TRN] and [TST] lines,
   ``best.ckpt`` and ``last.ckpt``, a 2x5-row CSV, and the launch
   counts of the run (20 steps and 8 eval forwards of the mode's kernels;
   no route to plain PyTorch).
   6b. The Trainer twice on one batch stream (float32, no augmentation, 2
   epochs of 4 iterations, eager: ``capture=False``, deterministic cuDNN:
   the stem's default float32 weight gradient varies run to run), with
   the kernels and under ``ops.plain()``: the
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
   8a. The w16 U-Net's iteration in both block modes: 6 bfloat16 replays
   (launches counted as 6 eager steps, loss finite and falling), then
   6 float32 replays against 6 eager iterations from one init (phase
   4's loss and parameter rules).  In a child process per block mode,
   the two side by side and beside 8a-8c, collected before 8d-8e's
   timings (a process that held large profiler sessions loses records
   from later ones), one replay of each 8b and 8a iteration runs the
   port's kernels of one eager iteration, by the profiler's names and
   counts, and as many device operations.
   8b. ``uganConsis`` (w16, 8 + 8) in both block modes, float32, 6
   replays, each against an eager step from a copy of the state before it
   and the same draws, the consistency gate opening at step 3 and
   ``lambda_semi`` changing there (7b's float32 rules at every step;
   G_semi 0 before the gate and positive after; at step 3 the replay 10x
   nearer the eager step with the new weight than one with the old).
   8c. The U-Net and uganConsis fits on phase 6's tree at the Config's
   dispatch (``steps_per_dispatch`` 8, ``eval_scan``; 2 epochs of 5
   iterations), float32, epoch 2
   under ``set_sync_debug_mode("error")``, against the eager fit
   (``steps_per_dispatch`` 1, no scan, ``capture=False``) on the same
   recorded batches: 6b's bounds on the [TRN] losses, [TST] Dice and best
   epoch; then two runs of 3
   float32 ``uganConsis`` replays from one init under deterministic cuDNN
   equal to the bit (its decoders' bilinear upsample is two fixed
   interpolation products, whose backward has no atomics).
   8d. ``predict`` replayed against eager: the logits equal.
   8e. Eager and replayed blocks in turns (2 rounds): the U-Net
   iteration, the uganConsis iteration (bfloat16), the eval sweep per
   batch and the serving latency, each with its median and quartiles,
   device ms, kernels and idle share, printed with the card's name and
   power limit; then the U-Net's replayed iteration, float32 and
   bfloat16, under cuDNN's default and deterministic algorithms.
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
   Phases 11-17 run as one block (:func:`group_phases`) in a process of
   their own, started after phase 6 and working beside phases 7-10, 18
   and 19: their time is mostly the host's (process start-ups, eager gloo
   ranks).  Every group's ranks start up first and wait; 11c's, 13c's and
   15b's trainer CLIs run one after another beside the groups, 14c's dry
   run too; 11a's child runs, 13a's and 16b's kernels are timed, then the
   groups' ranks run two groups at a time (11b with 13b, then 14, 15a,
   17a and 16a, each once a group before it is read), and 16c last.  So
   the times of phases 7-19 are taken beside other work on the card and
   the host, and are not for comparisons; phase 2's, whose rows the
   kernels line reports, run alone.
11. Data parallelism across processes (``torch.distributed``), each rank
   a child process (the kernels are built before the children start):
   11a. One rank over NCCL (a group of one), replayed: the U-Net
   iteration (w16, 256x256, batch 8), the ``uganConsis`` iteration (w16,
   8 + 8) and Mean Teacher's, CPS's (w16) and M3L's (the Config
   defaults; 8 + 8, from counts where every term is live), float32, 2
   warm-up calls and 5 replays each under deterministic cuDNN: the
   parameters equal those of the run with no group to the bit; then in
   bfloat16 one replay's device operations in the group, against no group
   for the U-Net and the GAN (the profiler; at one rank NCCL's in-place
   all-reduce launches nothing; 9c and 10b profile the zoo's with no
   group), and the device ms, kernels and idle share of each.
   11b. Two ranks on the one card over gloo, eager, against one process
   at the global batch: U-Net w16, 256x256, global batch 8 (4 a rank),
   float32, 3 steps (the loss within 1e-4, the parameter checksum within
   1e-5 relative, both ranks' parameters equal to the bit; labels 1 and
   2 cleared in the batch's second half, so that a rank's Dice alone
   differs from the global one), one ``block_pallas`` step a rank;
   ``uganConsis`` w16, 8 + 8 (4 + 4 a rank), one float32 step under 7b's
   rules; the launches and routed calls of a rank's step (nothing routed
   at w16 but the D's Cout-1 conv) and its time.  Then the zoo, float32:
   Mean Teacher and CPS (w16) 3 steps on 8 + 8 (the U-Net's bounds), M3L
   3 steps (10b's float32 rules on step 1: its mask drawn for the global
   batch, its head's batch norm over the group), DTC w64 with batch norm
   at its Config batch 8, 3 SGD steps of forward and backward (the
   U-Net's bounds), and ``uganConsis`` at one labelled and one unlabelled
   row a rank (global 2 + 2: PatchNCE's groups straddle the ranks, 7b's
   rules); every rank's trees equal to the bit after every step, and a
   rank's step launching what one process's does.
   11c. ``unetTrainer -p train`` through ``torch.distributed.run``, two
   ranks (gloo: eager, logged) on phase 6's tree, float32, 2 epochs of
   10 with augmentation, deterministic cuDNN, against the one-process fit
   under 6b's rules or, where larger, twice the distance of a fit from
   weights one ulp away (the fit is chaotic); one ``train.log`` and one
   set of checkpoints; then ``-p test`` in one process from the two-rank
   checkpoint.
12. From volumes to a trained model, under ``build/chip_smoke_prep/``
   (removed at the end): synthetic BTCV (NIfTI) and CHAOS (DICOM series
   and ground-truth PNGs) trees of 4 patients each, 10 slices of 288x288
   at 1.4 mm; the port's ``atlasPreparation``, ``chaosPreparation`` and
   ``toPngAndSplit`` as subprocesses of a child process that runs
   beside the kernels' build (host code: numpy, scipy, the port's
   codecs); then ``unetTrainer -p train`` through ``run_main`` on the PNG
   tree they wrote (one epoch of 10 iterations, w16, batch 8, bfloat16,
   on the card) and ``-p test``; each stage's seconds, the 256x256 slices, the split, the log,
   the checkpoints and the Dice matrix.
13. The space axis (``spatial_parallel``, dp x sp = 1 x 2): each rank
   holds half the rows of every image.  13a. K1's and K4's split forms
   (the rank's sums pass, the sums added over the group, the apply pass
   with the image's pixel count) against their plain versions at the
   U-Net's six norm shapes with H halved, float32 and bfloat16, under
   phase 2's rules, each two runs bit for bit, timed beside the unsplit
   K1 and K4 on the same half map.  13b. Two ranks on the one card over
   gloo (eager): the U-Net w16, 256x256, global batch 8, float32, 3
   steps against one process at the global batch under 11b's bounds
   (labels 1 and 2 cleared in the lower half of each image, so that one
   rank's Dice alone differs from the whole image's), both ranks'
   parameters equal to the bit, a rank's launches per step (K1 and K4 as
   split pairs, K2 and K5 as one process's, nothing routed) and its step
   time; ``uganConsis`` w16, 8 + 8, one float32 step under 7b's rules
   against one process.  13c. ``unetTrainer -p train --set
   spatial_parallel=2`` through ``torch.distributed.run`` on phase 6's
   tree, one epoch of 10, then ``-p test`` in one process from its
   checkpoint.
14. The model axis (channel-wise tensor parallelism, dp x tp = 1 x 2:
   ``parallel/mesh.py`` ``make_mesh_2d``, ``shard_params_channelwise``):
   each rank holds the output-channel shards of every eligible weight and
   of its optimizer state, and gathers each sharded layer's output
   channels.  Two ranks on the one card over gloo (eager; NCCL refuses two
   ranks on one card), started with the block.  14a. The U-Net w16,
   256x256, global batch 8, float32, 3 steps, against one process at the
   global batch under 11b's bounds; a rank's launches and routed calls per
   step asserted (K1 and K4 as one process's, on whole maps; K2 and K5 on
   the weight shards, the 256^2 level's shards of Cout 8 routed: width
   8's counts), its step ms, and its bytes of parameters and momentum
   (the sharded tensors' halved); ``uganConsis`` at the Config defaults
   (w16, 8 + 8), 2 float32 steps fed one process's draws, step 1 under
   7b's rules against one process, the launches of both steps equal, K1
   and K4 as one process's.  Both ranks' trees equal to the bit, the
   replicated parameters too.  14b. The same U-Net with ``block_pallas``:
   every block runs K3 and K6 on its gathered weights (9 a step,
   ``block.basic_block.tp_gathered``), under 11b's bounds.  14c.
   ``dryrun_multichip(4)`` (``smsut_tpu_torch/parallel/dryrun.py``)
   through ``torch.distributed.run``: four gloo ranks on the card,
   running beside 14a/b/d, 15a and 17a, the 2 x 2 model and space layouts against one
   process within the JAX dry run's bounds.  14d. The checkpoint rank 0 wrote at 1 x 2 after 14a's
   steps, loaded in one process: its trees equal the ranks' gathered ones
   to the bit, its next step meets 11b's bounds against the ranks' next,
   and two loads' next steps are equal to the bit.
   Phases 2 and 2b also hold K2, K2 as dx and K5, in both dtypes, at a
   model rank's shards of the step's convs (``TP_CONVS``, labelled
   ``tp=2``).
15. The rest of the zoo on the space axis (dp x sp = 1 x 2): each rank
   holds half the rows of every image.  15a. Two ranks on the one card
   over gloo (eager, deterministic cuDNN), started with the block,
   against one process at the global batch: Mean Teacher, CPS, CoraNet A
   and B (w16, 256x256, 8 + 8, from the counts at which every term is
   live; B's pseudo batch whole on every rank, which keeps its rows) and
   DTC w64 with batch norm (batch 8, SGD) 2 float32 steps each under
   11b's bounds, M3L at its defaults under 10b's float32 rules on step 1;
   both ranks' trees equal to the bit after every step; a rank's launches
   per step asserted (K1 and K4 as split pairs, each pass one process's
   count; K2 and K5 as one process's, on halo rows; nothing routed; M3L
   none) and its step ms.  15b. ``coraNetTrainer -p train --set
   spatial_parallel=2`` through ``torch.distributed.run`` on phase 6's
   tree, float32: stage A (one epoch of 2), then stage B from its
   ``pre_best`` (the pseudo-label sweep on rows, gathered; one epoch),
   then ``-p test`` in one process from stage B's checkpoint.
16. The fused block kernels on the space axis, K3 and K6 split at their
   statistics (``ops/block.py`` ``split_block_fwd``/``split_block_bwd``,
   ``csrc/block_split.cu``, ``block_bwd_split.cu``), and
   rematerialisation.  16a. Two ranks on the one card over gloo (eager,
   float32, deterministic cuDNN), started with the block, against one
   process at the global batch, ``block_pallas`` on: the U-Net (w16,
   batch 8) and ``uganConsis`` (8 + 8) 3 steps each; the U-Net under
   13b's bounds, the GAN's step 1 under 7b's rules and steps 2-3 under
   the step-1 bounds of tests/test_gan_training_parity.py; the ranks
   equal to the bit; each step's launches of every split phase asserted
   (``SPB_UNET``; the GAN's from one process's K3 and K6 counts).  16b.
   Each split phase against its plain twin (phase 2's bounds for K3 and
   K6), bfloat16, at [8, 256, 256, 32] -> 16 and [8, 256, 256, 16] -> 16
   on the top rank's 128 rows with its one-sided halos, timed beside its
   bound.  16c. In a child process started with the block and set to
   work after every other group of phases 11-17: the U-Net's
   (``remat_unet``, both block modes) and ``uganConsis``'s (``remat``)
   replayed iterations
   with remat off and on, float32 and bfloat16, under deterministic
   cuDNN: 3 iterations' metrics equal to the bit in float32, the peak
   memory allocated, host ms in interleaved blocks, device ms and kernels
   by the profiler, the port's launches per replay.
17. The zoo on the model axis (dp x tp = 1 x 2): each rank holds the
   output-channel shards of every eligible weight of the student, the EMA
   teacher, CPS's second net and the optimizer state (SGD's traces,
   Adam's moments).  Two ranks on the one card over gloo (eager, float32,
   deterministic cuDNN), started with the block, against one process at the
   global batch.  17a. Mean Teacher, CPS, CoraNet A and B (w16,
   256x256, 8 + 8, from the counts at which every term is live), Mean
   Teacher again with ``block_pallas``, M3L at its defaults (MiT-b0, its
   Dense, patch, reduction and depthwise kernels on shards) and DTC w64
   with batch norm (batch 8, SGD), 2 steps each under 11b's bounds (M3L
   under 10b's float32 rules on step 1 and its step-1 gradient); both
   ranks' trees equal to the bit; a rank's launches and routed calls in
   every step asserted (each student step phase 14's U-Net step, each
   teacher forward its forward: K1/K4 on whole maps, K2/K5 on the Cout/2
   shards with the 256^2 level's Cout-8 shards routed, K3/K6 on gathered
   weights; DTC one process's, nothing routed; M3L none); each
   algorithm's ``eval_fn`` on the shards against one process.  17b.
   CoraNet B's pseudo sweep (12 images in chunks of 8) on the shards
   against one process, and M3L's state saved at 1 x 2 after 17a's steps,
   loaded in one process: its trees the ranks' to the bit, its next step
   against the ranks' next.
18. The space-to-depth packed levels (``pack_levels=2``, the JAX
   package's hw mode: ``models/packed.py``, ``models/paired.py``).  18a.
   K3 and K6 with groups 4 (the norms' statistics pooled over each
   original channel's 4 subpixel groups) at the TPU kernels' own shapes,
   w16 batch 8: the level-0 encoder block [8,128,128,32] -> 64, the
   level-0 decoder block on its two segments [8,128,128,128] -> 64, the
   level-1 encoder block [8,64,64,64] -> 128 (all with the shortcut) and
   the identity form [8,128,128,64] -> 64; K1 and K4 on the packed free
   views [8,128,512,16] and [8,64,256,32]; K2, K2 as dx and K5 with a
   packed [3,3,64,64] kernel at [8,128,128,64]; float32 and bfloat16,
   each against its plain version (phase 2's bounds), timed beside its
   bound and the library call (for the blocks the eager cuDNN chain on
   the same packed input).  18b. The U-Net and ``uganConsis`` (both
   ``block_pallas`` modes; towers paired, the D stem packed under
   ``d_pack_mode=hw``), Mean Teacher (packed loss tails, count 100) and
   CPS (the two nets paired): step 1's gradients with every term live
   (the updates captured) and the eval logits packed against
   ``pack_levels=0`` from the same weights, float32 under phase 4's rules
   (the GAN's on the L2 over all tensors: a tower stem's sums nearly
   cancel) and its losses within phase 4's, 7b's or 9b's bounds, bfloat16
   no less accurate than the unpacked path against the float32 unpacked
   gradient; K3 and K6 launched with groups 4 in the fused runs; two
   float32 packed runs of 3 iterations (warm-up, capture, replay) under
   deterministic cuDNN equal to the bit (U-Net and uganConsis, fused).
   18c. Per configuration, bfloat16, packed and unpacked in one process:
   a replayed iteration's launches and routed convs, the peak memory
   beyond the state, host ms in interleaved blocks, the profiler's
   device ms and kernels; for ``uganConsis`` the D step's conv double
   backward (eager), packed beside unpacked.
19. The W packing (``pack_mode``/``d_pack_mode`` "w",
   ``models/packed_w.py``; the hw conv's v2/v2k3 lowerings and the
   paired conv's block dw).  19a. K2, K2 as dx and K5 with W-packed
   kernels at the w16 U-Net's levels 0 and 1 (encoder and decoder) and
   the D's two W blocks, bfloat16 (two cases float32), and K1/K4 on the
   W views, each against its plain version (phase 2's bounds), timed
   beside its bound and cuDNN's call on the same packed operands.  19b.
   Float32 step 1 against each algorithm's ``pack_levels=0`` step under
   phase 4's and 7b's rules: the U-Net all-W (unfused and
   ``block_pallas``), Mean Teacher and CPS all-W (CPS unpaired with
   ``pair_towers=True``), ``uganConsis`` in the JAX ``Config()``'s layout
   (hw towers paired, a deep W D) and all-W, the U-Net hw under v2 and
   v2k3, CPS hw paired under block dw; two float32 W replays of the U-Net
   and of ``uganConsis`` (JAX default layout) bit for bit.  19c. 18c's
   numbers, W (the JAX default for ``uganConsis``) against unpacked, for
   the U-Net, ``uganConsis``, Mean Teacher and CPS, the D step's stem
   double backward among them, and the hw U-Net under v2.
20. Prints the ``kernels`` JSON line (all nine kernels, launches summed
   over the runs of phases 3-19, replays included, not over the checks
   against the plain path; K1's and K4's split forms' launches beside
   theirs, over phases 13b, 15a and 16a, K3's and K6's split phases'
   beside theirs, over phase 16a, each kernel's launches by phase
   14's rank 0, ``tp_rank_launches``, and by phase 17a's,
   ``tp_zoo_rank_launches``, and per replayed iteration of each packed
   configuration of 18c, ``packed_launches``, and of 19c,
   ``w_packed_launches``), then the device line last.

Any failed check raises and the script exits non-zero without the last
line.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional
from pathlib import Path

START = time.perf_counter()
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
# K1's and K4's split forms (phase 13a): the unsplit kernels' bounds
TOL.update({(f"{k}_split", d): TOL[(k, d)] for k in ("instnorm",
                                                     "instnorm_bwd")
            for d in ("float32", "bfloat16")})
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
# a model rank's shards of those convs at tp = 2 (phase 14: Cout halved,
# Cin whole) that the kernels take, Cout/2 a multiple of 16 (the 256^2
# level's shards of Cout 8 are routed): K2, K2 as dx and K5 at each in
# both dtypes, labelled "tp=2"
TP = 2
TP_CONVS = tuple((h, ci, co // TP) for h, ci, co in STEP_CONVS
                 if (co // TP) % 16 == 0)
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
              ("block_split", "conv3x3_tc_kernel", 36, *HMMA),
              ("block_bwd_split", "conv3x3_tc_kernel", 36, *HMMA),
              ("block_bwd_split", "conv3x3_dw_tc_kernel", 18, *HMMA),
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
    if library is not None:
        row["library_ms"] = time_ms(library, iters)
    rows.append(row)
    lib_ms = ("none" if library is None else
              f"{row['library_ms']:.4f}")
    print(f"kernel {name} {label} {dt_name}: max abs err "
          f"{row['max_abs_err']:.3g}, rel err {err:.3g} (tol {tol}) "
          f"ms {row['ms']:.4f} plain {row['plain_ms']:.4f} "
          f"library {lib_ms} bound {row['bound_ms']:.4f} "
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
        f32 = dt == torch.float32
        for (h, ci, co), tag in [(c, "") for c in (
                F32_K2 if f32 else STEP_CONVS)] + [
                (c, f" tp={TP}") for c in TP_CONVS]:
            b, w = 8, h
            x = cases.randn(b, h, w, ci, dtype=dt)
            wt = cases.conv_w(3, ci, co, dt)
            lib = lambda x=x, wt=wt: F.conv2d(x.permute(0, 3, 1, 2),
                                              wt.permute(3, 2, 0, 1),
                                              padding=1)
            record(torch, ops, rows, "conv3x3",
                   f"{[b, h, w, ci]}->{co}{tag}", dn,
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
        f32 = dt == torch.float32
        for (h, ci, co), tag in [(c, "") for c in (
                F32_K5 if f32 else STEP_CONVS)] + [
                (c, f" tp={TP}") for c in TP_CONVS]:
            b, w = 8, h
            x = cases.randn(b, h, w, ci, dtype=dt)
            g = cases.randn(b, h, w, co, dtype=dt)
            lib = lambda x=x, g=g, ci=ci, co=co: torch.nn.grad.conv2d_weight(
                nchw(x), (co, ci, 3, 3), nchw(g), padding=1)
            record(torch, ops, rows, "conv3x3_dw",
                   f"{[b, h, w, ci]}->{co}{tag}",
                   dn, conv3x3.conv3x3_dw, (x, g), lib,
                   flops=2 * b * h * w * 9 * ci * co,
                   nbytes=b * h * w * (ci + co) * isz + 9 * ci * co * 4,
                   iters=10)
        # K2 as dx: float32 at the first block's conv1 (8 -> 16)
        # transposed, 16 -> 8; bfloat16 at every conv of the step
        for (h, ci, co), tag in [(c, "") for c in (
                F32_DX if f32 else STEP_CONVS)] + [
                (c, f" tp={TP}") for c in TP_CONVS]:
            b, w = 8, h
            g = cases.randn(b, h, w, co, dtype=dt)
            wf = cases.conv_w(3, ci, co, dt)
            wt = conv3x3.flip_io(wf)
            lib = lambda g=g, wf=wf, b=b, h=h, ci=ci: \
                torch.nn.grad.conv2d_input((b, ci, h, h),
                                           wf.permute(3, 2, 0, 1), nchw(g),
                                           padding=1)
            record(torch, ops, rows, "conv3x3_dx",
                   f"{[b, h, w, co]}->{ci}{tag}",
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
    counts = {}
    op = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    # each "Function : <name>" line opens a kernel's listing
    for part in out.split("Function : ")[1:]:
        fn, _, body = part.partition("\n")
        counts[fn.strip()] = n = dict.fromkeys(SASS_OPS, 0)
        for m in op.findall(body):
            n[m] += 1
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


_ELLIPSES: dict = {}


def ellipse_batch(np, b: int = 8, hw: int = 256, seed: int = 0):
    """A fixed batch the loss can fall on: each slice holds four filled
    ellipses labelled 1-4 on background 0, and its image is the label map's
    intensities plus noise, normalised to [-1, 1].  Not a dataset.  Each
    (b, hw, seed) is drawn once; callers get copies."""
    key = (b, hw, seed)
    if key not in _ELLIPSES:
        _ELLIPSES[key] = draw_ellipses(np, b, hw, seed)
    return {k: v.copy() for k, v in _ELLIPSES[key].items()}


def draw_ellipses(np, b: int, hw: int, seed: int) -> dict:
    """:func:`ellipse_batch`'s arrays, drawn."""
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
    test phase of both through the module CLI, in two subprocesses side by
    side."""
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
        results[fused] = {"launches": counts, "routed": rc,
                          "losses": losses, "step": ckpt["step"],
                          "period_ms": period}
    # the test phase of both runs side by side, each through the module
    # CLI in a subprocess
    t0 = time.perf_counter()
    tests = {}
    try:
        for fused in (False, True):
            logs = [open(FIT_DIR / f"test{int(fused)}.{x}", "w+")
                    for x in ("out", "err")]
            tests[fused] = (subprocess.Popen(
                [sys.executable, "-m", "smsut_tpu_torch.trainer.unetTrainer",
                 "-p", "test", "-i", "000", "-wh", "best"]
                + fit_args(data, expr, f"fit_block{int(fused)}",
                           f"block_pallas={fused}"), cwd=ROOT,
                stdout=logs[0], stderr=logs[1], text=True), logs)
        for fused, (proc, logs) in tests.items():
            proc.wait(timeout=300)
            test_s = time.perf_counter() - t0
            stdout, stderr = (f.seek(0) or f.read() for f in logs)
            if proc.returncode:
                raise AssertionError(f"-p test failed:\n{stderr[-3000:]}")
            model = expr / f"fit_block{int(fused)}" / "000"
            rows = [r for r in (model / "all_trois_matrix.csv").read_text()
                    .split("\n") if r]
            vals = np.array([[float(v) for v in r.split(",")] for r in rows])
            metrics_s = float(re.search(r"Test metrics cost ([0-9.]+)s",
                                        stdout).group(1))
            print(f"fit block_pallas={fused}: -p test (both modes side by "
                  f"side) in {test_s:.1f} s (host metrics {metrics_s:.3f} "
                  f"s); CSV {vals.shape}, mean Dice {vals[4, 4]:.4f}",
                  flush=True)
            if vals.shape != (10, 5) or not np.isfinite(vals).all():
                raise AssertionError(f"trois CSV {vals.shape}: {rows}")
            results[fused].update(test_s=test_s, test_metrics_s=metrics_s,
                                  csv=vals.tolist())
    finally:
        for proc, logs in tests.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for f in logs:
                f.close()
    return results


def fit_parity(torch, ops, data: Path) -> dict:
    """Phase 6b: one batch stream through the Trainer with the kernels and
    under ``ops.plain()``, float32, under deterministic cuDNN: with its
    default algorithm the U-Net stem's float32 weight gradient varies run
    to run, and 8 iterations carry that to about 1e-3 of the epoch-2 loss
    in either path alone (PERF.md §7)."""
    import numpy as np
    import torch.backends.cudnn as cudnn

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
        det, cudnn.deterministic = cudnn.deterministic, True
        try:
            with ops.plain() if plain else contextlib.nullcontext():
                trainer.fit()
        finally:
            cudnn.deterministic = det
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
          f"ms per batch; test phase host metrics "
          f"{cli[False]['test_metrics_s']:.3f} s", flush=True)
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
    """Phase 7: 7a, 7b and 7c (on phase 6's tree), each one's seconds
    printed."""
    seconds = {}
    t0 = time.perf_counter()
    dd = gan_double_backward(torch, ops, counters, routed)
    lap(seconds, "7a", t0)
    t0 = time.perf_counter()
    steps = gan_step_modes(torch, ops, counters, routed)
    lap(seconds, "7b", t0)
    t0 = time.perf_counter()
    cli = gan_cli(torch, counters, routed, FIT_DIR / "data",
                  steps[False]["per_step"], steps[False]["per_eval_forward"])
    lap(seconds, "7c", t0)
    return {"double_backward": dd, "steps": steps, "cli": cli,
            "seconds": seconds}


# phase 8: the JAX package's dispatch on the card, as CUDA graphs
REPLAY_STEPS = 6
GATE_STEP = 3               # 8b: the consistency gate opens in the window
LAMBDA_EPOCHS = (0, 100)    # 8b: lambda_semi's epochs, steps 0-2 and 3-5
TIMING_ROUNDS = 2           # 8e: rounds of eager and replayed blocks
GAN_REPLAYS = 3             # 8c: float32 replays of each bitwise run
REPLAY_FIT_ITERS = 5        # 8c: iterations of each fit's 2 epochs
TIMING_UNITS = {"unet": 10, "gan": 5, "eval": 2, "serve": 10, "cudnn": 10}


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


def replay_kernels(fused: bool) -> dict:
    """One replay against one eager iteration by the profiler
    (:func:`replay_against_eager`), the uganConsis (float32) and U-Net
    (bf16) iterations of 8b and 8a in block mode ``fused``.  Run in a
    process of its own per mode (:func:`replay_kernels_clean`), the GAN's
    first: once a process has held large profiler sessions, later
    sessions lose records (ROADMAP C3), and phases 6d and 7 hold tens of
    thousands of kernels, the GAN's sessions thousands."""
    import numpy as np
    import torch

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.tools.profile_step import iteration
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    cfg = Config(input_size=256, base_width=16, batch_size=8,
                 compute_dtype="bfloat16", block_pallas=fused)
    gan = UGANConsisAlgo(cfg.replace(compute_dtype="float32"))
    ginp = gan.inputs(dict(gan_batch(torch, np), **gan.make_extra_batch()))
    scal = {"lambda_semi": torch.tensor(1.0, device="cuda")}
    runs = [iteration(gan, gan.init_state(0), ginp, scal, capture=c)
            for c in (False, True)]
    for run in runs:
        run()
        run()
    out[f"gan {fused}"] = replay_against_eager(torch, *runs, len(ginp))
    del runs, gan
    torch.cuda.empty_cache()
    algo = SupervisedUNet(cfg)
    inp = algo.inputs({k: torch.from_numpy(v).cuda()
                       for k, v in ellipse_batch(np).items()})
    runs = [iteration(algo, algo.init_state(0), inp, capture=c)
            for c in (False, True)]
    for run in runs:
        run()
        run()
    out[f"unet {fused}"] = replay_against_eager(torch, *runs, len(inp))
    return out


def replay_kernels_start() -> list:
    """:func:`replay_kernels` of each block mode in a child process, the
    two side by side (each profiler counts its own process's kernels),
    started; :func:`replay_kernels_clean` collects them."""
    return [subprocess.Popen(
        [sys.executable, "-c", "import json, chip_smoke; print('KERNELS ' "
         f"+ json.dumps(chip_smoke.replay_kernels({fused})))"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for fused in (False, True)]


def replay_kernels_clean(kids: list) -> dict:
    """The children's results (:func:`replay_kernels_start`)."""
    res = {}
    for kid in kids:
        try:
            stdout, stderr = kid.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for k in kids:
                k.kill()
            raise
        line = [x for x in stdout.splitlines() if x.startswith("KERNELS ")]
        if kid.returncode or not line:
            for k in kids:
                k.kill()
            raise AssertionError(f"replay kernels:\n{stderr[-3000:]}")
        res.update(json.loads(line[-1][len("KERNELS "):]))
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
    float32, both block modes, 6 steps in lock step: before each replay
    the state is copied and the eager step runs on the copy with the same
    inputs, so each step is held to 7b's float32 rules from one state
    (float32 chaos, Adam's sign steps and the bilinear upsampling's
    atomic backward, would otherwise part two runs of 6 steps whatever
    the dispatch).  The gate opens at step GATE_STEP (G_semi 0 before,
    positive after, in the replay); ``lambda_semi`` changes at step
    REPLAY_STEPS // 2 (3, with the gate), in
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
              f"{worst['g_rel']:.3g}; step {REPLAY_STEPS // 2}'s G rel err "
              f"{g5:.3g} against "
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


def replay_fits(torch, ops, counters, routed, data: Path) -> dict:
    """8c: the U-Net and uganConsis fits at the Config's dispatch
    (steps_per_dispatch 8, eval_scan), float32, epoch 2 under
    set_sync_debug_mode("error"), against the eager fit
    (steps_per_dispatch 1, eval_scan off, capture=False) on the same
    recorded batches: 6b's bounds.  Then :func:`gan_replays_bitwise`,
    which holds the GAN's replays to each other to the bit."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    base = Config(base_root=str(data), expr_root=str(FIT_DIR / "expr8"),
                  input_size=256, base_width=16, batch_size=8,
                  compute_dtype="float32",
                  num_iter_per_epoch=REPLAY_FIT_ITERS, max_epoch=FIT_EPOCHS,
                  num_workers=4)
    eager_cfg = base.replace(steps_per_dispatch=1, eval_scan=False)
    out = {}
    for name, cls in (("unet", SupervisedUNet), ("uganConsis",
                                                   UGANConsisAlgo)):
        tapes = {"train": [], "val": []}
        torch.cuda.synchronize()
        zero(counters, routed)
        got = taped_fit(torch, ops, cls(base), base, f"replay_{name}",
                        tapes, replay=False, capture=True, watch=True)
        torch.cuda.synchronize()
        counts = {k: c.launches for k, c in counters.items()}
        eager = taped_fit(torch, ops, cls(eager_cfg), eager_cfg,
                          f"eager_{name}", tapes, replay=True,
                          capture=False, watch=False)
        d = fit_diff(got, eager)
        print(f"replay 8c {name}: fit at steps_per_dispatch 8 + eval_scan "
              f"(replayed; epoch 2 under set_sync_debug_mode error) vs the "
              f"eager fit on the same batches: [TRN] losses "
              f"{[got['train/loss'][i] for i in range(FIT_EPOCHS)]} vs "
              f"{[eager['train/loss'][i] for i in range(FIT_EPOCHS)]}: "
              f"{d} (6b's bounds: loss {LOSS_TOL}, Dice {PARITY_DICE_TOL} "
              f"per modality, {PARITY_DICE_ALL} overall); launches "
              f"{counts}", flush=True)
        if not within_6b(d):
            raise AssertionError(f"8c {name}: {d}")
        out[name] = {"replayed": got, "eager": eager, "diff": d,
                     "launches": counts}
    out["gan_bitwise"] = gan_replays_bitwise(torch)
    return out


def gan_replays_bitwise(torch) -> dict:
    """8c, under deterministic cuDNN: two runs of GAN_REPLAYS float32
    uganConsis iterations replayed from one init (w16, 8 + 8, the gate
    open), each its own graph: their metrics, G and D equal to the bit
    (the decoders' upsample is two fixed products, ``models/layers.py``
    ``upsample_bilinear2``, so no backward adds with atomics)."""
    import numpy as np

    from smsut_tpu_torch.tools.profile_step import iteration

    runs = []
    for _ in range(2):
        algo, inp, scal, make = dp_iterations(torch, np, "float32")["gan"]
        state = make()
        run = iteration(algo, state, inp, scal)
        ms = [{k: float(v) for k, v in run().items()}
              for _ in range(GAN_REPLAYS)]
        runs.append((ms, state))
        del algo, run
    (m0, s0), (m1, s1) = runs
    same = m0 == m1 and all(tree_equal(torch, getattr(s0, t), getattr(s1, t))
                            for t in ("g_params", "d_params"))
    print(f"replay 8c uganConsis float32: two runs of {GAN_REPLAYS} replayed "
          f"iterations from one init, deterministic cuDNN, equal to the "
          f"bit: {same}; G_seg {[round(m['G_seg'], 6) for m in m0]}",
          flush=True)
    if not same:
        raise AssertionError(f"8c GAN replays differ: {m0} vs {m1}")
    torch.cuda.empty_cache()
    return {"same": same, "metrics": m0}


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
    profiler's device ms and kernels per unit and the idle share.  Then
    what cuDNN's deterministic algorithms cost the U-Net's replayed
    iteration, float32 and bfloat16: each graph keeps the algorithms of
    its capture, so a deterministic mode sets the flag around its calls."""
    import numpy as np
    import torch.backends.cudnn as cudnn

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

    def deterministic(fn):
        def run():
            det, cudnn.deterministic = cudnn.deterministic, True
            try:
                return fn()
            finally:
                cudnn.deterministic = det
        return run

    paths["cudnn"] = {}
    for dtn in ("float32", "bfloat16"):
        algo = SupervisedUNet(cfg.replace(compute_dtype=dtn))
        ainp = algo.inputs({k: torch.from_numpy(v).cuda()
                            for k, v in ellipse_batch(np).items()})
        for det in (False, True):
            run = iteration(algo, algo.init_state(0), ainp)
            paths["cudnn"][dtn + " deterministic" * det] = (
                deterministic(run) if det else run)
    out = {}
    for name, fns in paths.items():
        fns = {{False: "eager", True: "replayed"}.get(c, c): f
               for c, f in fns.items()}
        for fn in fns.values():   # warm-up; the replays capture here
            fn()
            fn()
        per = FIT_TEST_BATCHES if name == "eval" else 1
        t = timed_blocks(torch, fns, TIMING_UNITS[name], TIMING_ROUNDS)
        for mode, f in fns.items():
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
    seconds = {}
    # the kernel-count children work beside 8a-8c (checks, not timings)
    # and are collected before 8d-8e's timings
    kids = replay_kernels_start()
    try:
        t0 = time.perf_counter()
        a = replay_unet(torch, counters, routed)
        lap(seconds, "8a", t0)
        t0 = time.perf_counter()
        b = replay_gan(torch, counters, routed)
        lap(seconds, "8b", t0)
        t0 = time.perf_counter()
        c = replay_fits(torch, ops, counters, routed, FIT_DIR / "data")
        lap(seconds, "8c", t0)
    except BaseException:
        for kid in kids:
            kid.kill()
        raise
    finally:
        cudnn.deterministic = det
    t0 = time.perf_counter()
    k = replay_kernels_clean(kids)
    lap(seconds, "8a/8b kernels in child processes, the wait after 8c", t0)
    t0 = time.perf_counter()
    d = replay_predict(torch, counters, routed)
    e = replay_timing(torch, card, FIT_DIR / "data")
    lap(seconds, "8d-8e", t0)
    return {"unet": a, "gan": b, "fits": c, "predict": d, "timing": e,
            "kernels": k, "seconds": seconds}


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


# an iteration's student steps (forward and backward) and teacher
# forwards: Mean Teacher adds the teacher's forward, cross-pseudo
# supervision runs two students, CoraNet B two student applies of 8 and
# the teacher's forward
ZOO_APPLIES = {"meanTeacher": (1, 1), "crossPse": (2, 0), "coraPre": (1, 0),
               "coraNet": (2, 1)}


def zoo_per_step(name: str, fused: bool) -> dict:
    """Launches per iteration: a student forward and backward at 16
    images counts as one U-Net step (:data:`ZOO_APPLIES`)."""
    s, f = PER_STEP[fused], PER_FORWARD[fused]
    n_step, n_fwd = ZOO_APPLIES[name]
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


# phase 11: data parallelism across processes (torch.distributed)
DP_DIR = FIT_DIR / "dp"
DP_REPLAYS = 5            # 11a: replays after the warm-up call and capture
DP_STEPS = 3              # 11b: the U-Net's eager steps
DP_LOSS_TOL = 1e-4        # 11b: the U-Net's loss, two ranks vs one process
DP_SUM_TOL = 1e-5         # 11b: its parameter checksum, relative
DP_GLOBAL = 8             # the global batch (11b, 11c)
DP_TIMEOUT_S = 300
GROUP_TIMEOUT_S = 900        # phases 11-17, from their start


def dp_batch(np) -> dict:
    """Phase 4's ellipse batch with labels 1 and 2 cleared in its second
    half, so that either rank's batch Dice alone differs from the global
    one."""
    b = ellipse_batch(np)
    half = b["msk"][DP_GLOBAL // 2:]
    half[(half == 1) | (half == 2)] = 0
    return b


def kernel_counters():
    """({kernel: its counter}, {conv3x3/block: the routing counter})."""
    from smsut_tpu_torch.ops import block, conv3x3, conv_mma, instnorm

    counters = {"instnorm": instnorm.instance_norm_fwd,
                "conv3x3": conv3x3.conv3x3_fwd, "block": block.basic_block_fwd,
                "instnorm_bwd": instnorm.instance_norm_bwd,
                "conv3x3_dw": conv3x3.conv3x3_dw,
                "block_bwd": block.basic_block_bwd}
    counters.update({f"conv3x3_{v}": getattr(conv_mma, f"conv3x3_{v}")
                     for v in MMA_VARIANTS})
    routed = {"conv3x3": conv3x3.conv3x3, "block": block.basic_block}
    return counters, routed


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# processes started to run beside the phases (:func:`background`), each in
# a session of its own; whatever of them still runs when the script ends,
# as it does on a failed check, is killed with all that it started
_BACKGROUND: list = []


def _stop_background() -> None:
    """SIGTERM to each running one's session (:func:`group_main` then
    stops what it started), SIGKILL to what still runs 10 s later."""
    import os
    import signal

    for sig in (signal.SIGTERM, signal.SIGKILL):
        running = [p for p in _BACKGROUND if p.poll() is None]
        for proc in running:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, sig)
        for proc in running:
            with contextlib.suppress(subprocess.TimeoutExpired):
                proc.wait(timeout=10)


atexit.register(_stop_background)


def background(argv: list) -> subprocess.Popen:
    """``argv`` started from the repo's root with its output piped, in a
    session of its own (:data:`_BACKGROUND`)."""
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    _BACKGROUND.append(proc)
    return proc


def background_wait(proc: subprocess.Popen,
                    timeout: float) -> subprocess.CompletedProcess:
    """``proc``'s exit code and output once it has ended; it and all that
    it started are killed if it outlasts ``timeout`` seconds from now."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _stop_background()
        raise AssertionError(f"{proc.args[:6]} did not end within "
                             f"{timeout} s")
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def background_line(proc: subprocess.Popen, tag: str, timeout: float) -> str:
    """The rest of the last line starting with ``tag`` that ``proc``
    printed; raises if it failed or printed none."""
    res = background_wait(proc, timeout)
    line = [x for x in res.stdout.splitlines() if x.startswith(tag)]
    if res.returncode or not line:
        raise AssertionError(f"{proc.args[:6]} failed ({res.returncode}):\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    return line[-1][len(tag):]


class Lane:
    """Commands run one after another beside the phases, in a thread:
    the trainer CLIs that phases 11c, 13c and 15b run through
    ``torch.distributed.run``, whose time is mostly process start-up on
    the host.  :meth:`result` waits for one; a command that fails or
    times out ends the lane."""

    def __init__(self, cmds: list):
        import threading

        self.done, self.events = {}, {name: threading.Event()
                                      for name, _ in cmds}
        self.thread = threading.Thread(target=self._run, args=(cmds,),
                                       daemon=True)
        self.thread.start()

    def _run(self, cmds: list) -> None:
        try:
            for name, argv in cmds:
                t0 = time.perf_counter()
                res = background_wait(background(argv), DP_TIMEOUT_S)
                self.done[name] = (res, time.perf_counter() - t0)
                self.events[name].set()
                if res.returncode:
                    self.done["error"] = f"{name} failed ({res.returncode})"
                    break
        except BaseException as e:   # the waiter raises it
            self.done["error"] = e
        finally:
            for ev in self.events.values():
                ev.set()

    def result(self, name: str) -> tuple:
        """(CompletedProcess, seconds) of command ``name``."""
        self.events[name].wait()
        if name not in self.done:
            raise AssertionError(f"the lane stopped before {name}: "
                                 f"{self.done.get('error')}")
        return self.done[name]


def run_child(fn: str, env: dict = None, timeout: int = DP_TIMEOUT_S):
    """A child process that imports the port, opens the card (the built
    kernels are loaded from ``build/kernels``) and waits for
    :func:`child_result`, which has it run ``chip_smoke.<fn>()`` and
    reads its JSON result; started ahead, its start-up overlaps the
    phases before.  A child whose parent ends without asking exits."""
    import os

    code = ("import json, sys, torch, chip_smoke; torch.cuda.init(); "
            "sys.stdin.readline().strip() == 'go' or sys.exit(3); "
            f"print('DP ' + json.dumps(chip_smoke.{fn}()))")
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            env=dict(os.environ, **(env or {})),
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), timeout


def child_result(child, go: bool = True) -> dict:
    """The child's result, after asking it to run (``go``; False where the
    caller asked it already)."""
    proc, timeout = child
    try:
        out, err = proc.communicate("go\n" if go else None, timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"a child did not end within {timeout} s")
    line = [x for x in out.splitlines() if x.startswith("DP ")]
    if proc.returncode or not line:
        raise AssertionError(f"child failed ({proc.returncode}):\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
    return json.loads(line[-1][3:])


def tree_equal(torch, a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def tree_sha(tree: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(tree[k].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def tree_checksum(tree: dict) -> float:
    return float(sum(float(v.detach().double().abs().sum())
                     for v in tree.values()))


# 11a: the iterations in a group of one; the zoo's from a count at which
# every loss term is live (M3L's EMA from its gate).  The bf16 profile with
# no group, in the same child, for DP_ALONE (9c and 10b profile the zoo's
# with no group)
DP_ITERATIONS = ("unet", "gan", "meanTeacher", "crossPse", "M3L")
DP_ALONE = ("unet", "gan")


def dp_iterations(torch, np, dtn: str, names=DP_ITERATIONS) -> dict:
    """{name: (algo, device inputs, scalars, a fresh state)} of the U-Net
    iteration (w16, 256x256, batch 8), the uganConsis iteration (w16, 8 +
    8, the gate open) and the zoo's (Mean Teacher and CPS at w16, M3L at
    the Config defaults; 8 + 8, phase 9's inputs and scalars)."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    cfg = Config(input_size=256, base_width=16, batch_size=8,
                 compute_dtype=dtn, consis_gate_step=0)
    out = {}
    for name in names:
        if name == "unet":
            unet = SupervisedUNet(cfg)
            out[name] = (unet, unet.inputs({
                k: torch.from_numpy(v).cuda()
                for k, v in ellipse_batch(np).items()}), {},
                lambda a=unet: a.init_state(0))
        elif name == "gan":
            gan = UGANConsisAlgo(cfg)
            out[name] = (gan, gan.inputs(dict(gan_batch(torch, np),
                                              **gan.make_extra_batch())),
                         {k: torch.tensor(float(v), device="cuda")
                          for k, v in gan.epoch_scalars(1).items()},
                         lambda a=gan: a.init_state(0))
        else:
            algo = m3l_algo(dtn) if name == "M3L" else zoo_algo(name, cfg)
            count = M3L_GATE if name == "M3L" else ZOO_GATE[name]
            out[name] = (algo, zoo_inputs(torch, np, algo, name),
                         zoo_scalars(torch, algo),
                         lambda a=algo, c=count: zoo_state(a, c))
    return out


def dp_world1() -> dict:
    """11a, in a child process: each iteration (:data:`DP_ITERATIONS`)
    replayed with no group, then in a group of one over NCCL (the
    gradient all-reduce, the batch Dice's and batch norm's sums captured
    in the graph): float32 under deterministic cuDNN, the parameters
    compared to the bit; and bfloat16 at the defaults, one replay's device
    operations with no group and in the group (profiler), and in the group
    its timing."""
    import numpy as np
    import torch
    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.parallel import distributed
    from smsut_tpu_torch.tools.profile_step import device_rows, iteration

    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = False

    def replayed_f32():
        cudnn.deterministic = True
        try:
            out = {}
            for name in DP_ITERATIONS:
                algo, inp, scal, make = dp_iterations(
                    torch, np, "float32", (name,))[name]
                state = make()
                run = iteration(algo, state, inp, scal)
                for _ in range(2 + DP_REPLAYS):
                    run()
                torch.cuda.synchronize()
                trees = [t for t in ("params", "ema_params", "params2",
                                     "g_params", "d_params")
                         if getattr(state, t, None) is not None]
                out[name] = {t: {k: v.clone() for k, v in
                                 getattr(state, t).items()} for t in trees}
                del algo, inp, run, state
                torch.cuda.empty_cache()
            return out
        finally:
            cudnn.deterministic = False

    def bf16_replay(name):
        algo, inp, scal, make = dp_iterations(torch, np, "bfloat16",
                                              (name,))[name]
        return iteration(algo, make(), inp, scal)

    def device_ops(run):
        run()
        run()
        rows, _ = device_rows(torch, run, 3)
        return {k: [ms, n] for k, ms, n in rows}

    alone = replayed_f32()
    alone_ops = {}
    for name in DP_ALONE:
        alone_ops[name] = device_ops(bf16_replay(name))
        torch.cuda.empty_cache()
    if not distributed.initialize(f"localhost:{free_port()}", 1, 0):
        raise AssertionError("no group")
    out = {"backend": distributed.backend()}
    grouped = replayed_f32()
    out["bit_equal"] = {n: all(tree_equal(torch, alone[n][t], grouped[n][t])
                               for t in alone[n]) for n in alone}
    del alone, grouped
    torch.cuda.empty_cache()
    for name in DP_ITERATIONS:
        run = bf16_replay(name)
        ops_ = device_ops(run)
        t = timed_blocks(torch, {"replayed": run},
                         TIMING_UNITS.get(name, TIMING_UNITS["gan"]),
                         TIMING_ROUNDS)["replayed"]
        device = sum(v[0] for v in ops_.values())
        out[name] = {
            "median_ms": t["median_ms"], "q1_ms": t["q1_ms"],
            "q3_ms": t["q3_ms"], "device_ms": device,
            "kernels": sum(kernel_counts((k, v[1]) for k, v in
                                         ops_.items()).values()),
            "idle_share": 1 - device / t["median_ms"],
            "nccl": {k: v for k, v in ops_.items() if "nccl" in k.lower()}}
        a = alone_ops.get(name)
        if a is not None:
            out[name].update(
                alone_device_ms=sum(v[0] for v in a.values()),
                alone_kernels=sum(kernel_counts((k, v[1]) for k, v in
                                                a.items()).values()),
                added={k: v[1] - a.get(k, [0, 0])[1] for k, v in
                       ops_.items() if v[1] != a.get(k, [0, 0])[1]})
        del run
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    return out


def dp_rank() -> dict:
    """11b, one rank of two on the one card (gloo, eager; the group from
    the SMSUT_* variables): the U-Net's DP_STEPS float32 steps and one
    block_pallas step on the rank's 4 rows, one float32 uganConsis step on
    its 4 + 4, then :func:`dp_zoo`; metrics averaged over the ranks,
    launches and routed calls per step, step times, and the trees after
    (the GAN's and the zoo's held flip-aware written to DP_DIR for the
    parent)."""
    import numpy as np
    import torch
    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.parallel import distributed
    from smsut_tpu_torch.parallel.mesh import mean_over_ranks
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    cudnn.deterministic = True
    if not distributed.initialize():
        raise AssertionError("no group")
    rank = distributed.process_index()
    sl = distributed.local_batch_slice(DP_GLOBAL)
    counters, routed = kernel_counters()
    counts = lambda: {k: c.launches for k, c in counters.items()}
    out = {"rank": rank, "world": distributed.process_count(),
           "backend": distributed.backend()}

    def timed_step(algo, state, batch, scal=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = algo.train_step(state, batch, scal)
        m = {k: float(mean_over_ranks(v)) for k, v in m.items()}
        torch.cuda.synchronize()
        return state, m, (time.perf_counter() - t0) * 1e3

    cfg = Config(input_size=256, base_width=16, batch_size=DP_GLOBAL,
                 compute_dtype="float32", consis_gate_step=0)
    unet = SupervisedUNet(cfg)
    state = unet.init_state(0)
    batch = {k: torch.from_numpy(v[sl]).cuda()
             for k, v in dp_batch(np).items()}
    zero(counters, routed)
    losses, ms = [], []
    for _ in range(DP_STEPS):
        state, m, t = timed_step(unet, state, batch)
        losses.append(m["loss"])
        ms.append(t)
    out["unet"] = {"losses": losses, "step_ms": ms,
                   "launches": {k: v // DP_STEPS for k, v in counts().items()},
                   "routed": routed_counts(routed),
                   "checksum": tree_checksum(state.params),
                   "sha": tree_sha(state.params)}
    fused = SupervisedUNet(cfg.replace(block_pallas=True,
                                       compute_dtype="bfloat16"))
    zero(counters, routed)
    fused.train_step(fused.init_state(0), batch)
    out["unet_block"] = {"launches": counts(),
                         "routed": routed_counts(routed)}
    gan = UGANConsisAlgo(cfg)
    gst = gan.init_state(0)
    full = dict(gan_batch(torch, np),
                msk=torch.from_numpy(dp_batch(np)["msk"]).cuda())
    gb = {k: v[sl] for k, v in full.items()}
    scal = gan.epoch_scalars(1)
    zero(counters, routed)
    gst, gm, t = timed_step(gan, gst, dict(gb, **gan.make_extra_batch()),
                            scal)
    out["gan"] = {"metrics": gm, "launches": counts(),
                  "routed": routed_counts(routed),
                  "g_sha": tree_sha(gst.g_params),
                  "d_sha": tree_sha(gst.d_params), "first_ms": t}
    if rank == 0:
        torch.save({"g_params": {k: v.cpu() for k, v in gst.g_params.items()},
                    "d_params": {k: v.cpu() for k, v in gst.d_params.items()}},
                   DP_DIR / "gan_rank0.pt")
    _, _, out["gan"]["step_ms"] = timed_step(
        gan, gst, dict(gb, **gan.make_extra_batch()), scal)
    del unet, fused, gan, state, gst
    torch.cuda.empty_cache()
    out["zoo"], tensors = dp_zoo(torch, np, counters, routed)
    if rank == 0:
        torch.save(tensors, DP_DIR / "zoo_rank0.pt")
    torch.distributed.destroy_process_group()
    return out


DP_ZOO = ("meanTeacher", "crossPse", "M3L", "dtc", "gan1")
DP_DTC_LR = 0.01          # 11b: DTC's plain SGD steps


def sign_map(msk, n: int):
    """DTC's tanh-head target at its coarsest: +1 inside each class's
    region, -1 outside, per class channel."""
    import torch

    return 2.0 * torch.nn.functional.one_hot(msk, n).to(torch.float32) - 1.0


def dp_zoo(torch, np, counters, routed) -> dict:
    """11b's zoo, float32, eager, on this process's rows of each global
    batch (a rank's under the group, all of them in one process): Mean
    Teacher and CPS (w16) and M3L (the Config defaults) DP_STEPS steps on
    8 + 8 (4 + 4 a rank) from their live counts; DTC w64 with batch norm
    and ReLU at its Config batch 8 (4 a rank), DP_STEPS SGD steps of its
    forward and backward on a loss over both heads; uganConsis one step
    at a global batch of 2 + 2 (one labelled and one unlabelled row a
    rank, so its PatchNCE groups straddle the ranks).  Per run the
    metrics averaged over the group, the launches and routed calls of a
    step, and per step the parameter trees' checksum and sha; the tensors
    the parent holds flip-aware (M3L's student after step 1, the GAN's
    trees) under ``tensors``."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.models.dtc import DTCUNet
    from smsut_tpu_torch.ops.losses import dice_and_ce_loss
    from smsut_tpu_torch.parallel import distributed, mesh
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo

    mean = lambda v: float(mesh.mean_over_ranks(v.detach().reshape(())))
    counts = lambda: {k: c.launches for k, c in counters.items()}
    sl = distributed.local_batch_slice(DP_GLOBAL)
    lb, ul = dp_batch(np), ellipse_batch(np, seed=1)
    host = {"img": lb["img"][sl], "msk": lb["msk"][sl],
            "ul_img": ul["img"][sl]}
    cfg = Config(input_size=256, base_width=16, batch_size=DP_GLOBAL,
                 compute_dtype="float32", consis_gate_step=0)
    out, tensors = {}, {}
    for name in ("meanTeacher", "crossPse", "M3L"):
        algo = m3l_algo("float32") if name == "M3L" else zoo_algo(name, cfg)
        state = zoo_state(algo, M3L_GATE if name == "M3L"
                          else ZOO_GATE[name])
        batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
        r = {"metrics": [], "checksums": [], "shas": []}
        for k in range(DP_STEPS):
            zero(counters, routed)
            t0 = time.perf_counter()
            state, m = algo.train_step(state, batch, algo.epoch_scalars(3))
            r["metrics"].append({n: mean(v) for n, v in m.items()})
            torch.cuda.synchronize()
            r.setdefault("step_ms", []).append(
                (time.perf_counter() - t0) * 1e3)
            r["launches"], r["routed"] = counts(), routed_counts(routed)
            trees = [t for t in ("params", "ema_params", "params2")
                     if getattr(state, t) is not None]
            r["checksums"].append(sum(tree_checksum(getattr(state, t))
                                      for t in trees))
            r["shas"].append([tree_sha(getattr(state, t)) for t in trees])
            if name == "M3L" and k == 0:
                tensors["m3l_step1"] = {n: v.cpu() for n, v in
                                        state.params.items()}
        out[name] = r
        del algo, state
        torch.cuda.empty_cache()
    net = DTCUNet(5, 64, compute_dtype=torch.float32)
    params = {k: v.detach().clone() for k, v in net.named_parameters()}
    x = torch.from_numpy(host["img"]).cuda()
    msk = torch.from_numpy(host["msk"]).cuda().long()
    r = {"losses": [], "checksums": [], "shas": []}
    for _ in range(DP_STEPS):
        zero(counters, routed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        tanh, logits = torch.func.functional_call(net, leaves, (x,))
        loss = (dice_and_ce_loss(logits, msk)
                + (tanh - sign_map(msk, tanh.shape[-1])).square().mean())
        grads = mesh.reduce_gradients_(dict(zip(
            leaves, torch.autograd.grad(loss, list(leaves.values())))))
        params = {k: (v - DP_DTC_LR * grads[k]).detach()
                  for k, v in leaves.items()}
        r["losses"].append(mean(loss))
        torch.cuda.synchronize()
        r.setdefault("step_ms", []).append((time.perf_counter() - t0) * 1e3)
        r["checksums"].append(tree_checksum(params))
        r["shas"].append(tree_sha(params))
        r["launches"], r["routed"] = counts(), routed_counts(routed)
    out["dtc"] = r
    del net, params, leaves, grads, tanh, logits
    torch.cuda.empty_cache()
    gcfg = cfg.replace(batch_size=2)
    gan = UGANConsisAlgo(gcfg)
    gsl = distributed.local_batch_slice(2)
    full = dict(gan_batch(torch, np),
                msk=torch.from_numpy(dp_batch(np)["msk"]).cuda())
    gb = {k: v[:2][gsl] for k, v in full.items()}
    zero(counters, routed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gst, gm = gan.train_step(gan.init_state(0), dict(
        gb, **gan.make_extra_batch()), gan.epoch_scalars(1))
    out["gan1"] = {"step_ms": [(time.perf_counter() - t0) * 1e3],
                   "metrics": {k: mean(v) for k, v in gm.items()},
                   "launches": counts(), "routed": routed_counts(routed),
                   "shas": [tree_sha(gst.g_params), tree_sha(gst.d_params)]}
    tensors["gan1"] = {t: {k: v.cpu() for k, v in getattr(gst, t).items()}
                       for t in ("g_params", "d_params")}
    return out, tensors


def dp_zoo_against(torch, r0: dict, r1: dict, one: dict, saved: dict,
                   mine: dict, lr: float) -> dict:
    """11b's zoo, the two ranks against one process: Mean Teacher, CPS and
    DTC the loss within DP_LOSS_TOL after each step (DTC's relative to
    max(1, |loss|)) and the checksum within DP_SUM_TOL relative after
    DP_STEPS; M3L 10b's float32 rules
    on step 1 (the losses within M3L_LOSS_TOL relative, the student
    flip-aware); uganConsis 7b's rules; the ranks equal to the bit after
    every step.  Raises where one fails."""
    import types

    out = {}
    for name in ("meanTeacher", "crossPse", "dtc"):
        a, b, w = r0[name], r1[name], one[name]
        la = [m["loss"] for m in a["metrics"]] if "metrics" in a \
            else a["losses"]
        lw = [m["loss"] for m in w["metrics"]] if "metrics" in w \
            else w["losses"]
        # DTC's loss (about 7 at init: its tanh head saturates) is held
        # relative to max(1, |loss|), the U-Net's bound at a loss near 1
        scale = (lambda y: max(1.0, abs(y))) if name == "dtc" else \
            (lambda y: 1.0)
        out[name] = {"loss_err": max(abs(x - y) / scale(y)
                                     for x, y in zip(la, lw)),
                     "sum_err": abs(a["checksums"][-1] - w["checksums"][-1])
                     / max(abs(w["checksums"][-1]), 1.0),
                     "ranks_equal": a["shas"] == b["shas"],
                     "losses": la, "one_process": lw}
    a, w = r0["M3L"], one["M3L"]
    dev = torch.cat([(saved["m3l_step1"][k] - v).abs().flatten()
                     for k, v in mine["m3l_step1"].items()])
    out["M3L"] = {"loss_err": max(abs(a["metrics"][0][n] - w["metrics"][0][n])
                                  / abs(w["metrics"][0][n])
                                  for n in ("loss", "semi_loss")),
                  "dev_max": float(dev.max()),
                  "flip_share": float((dev > lr).float().mean()),
                  "ranks_equal": a["shas"] == r1["M3L"]["shas"]}
    ns = lambda t: types.SimpleNamespace(**{k: {n: v.cuda() for n, v in
                                                d.items()}
                                            for k, d in t.items()})
    out["gan1"] = dict(gan_step_against(
        torch, (r0["gan1"]["metrics"], ns(saved["gan1"])),
        (one["gan1"]["metrics"], ns(mine["gan1"])), lr),
        ranks_equal=r0["gan1"]["shas"] == r1["gan1"]["shas"])
    for name, d in out.items():
        print(f"dp 11b {name}: two ranks vs one process: "
              f"{ {k: v for k, v in d.items() if k != 'one_process'} }; "
              f"a rank's step launches {r0[name]['launches']}, routed "
              f"{r0[name]['routed']}; one process "
              f"{one[name]['launches']}; step ms (rank 0, rank 1, one "
              f"process) {[round(x, 1) for x in r0[name]['step_ms']]} "
              f"{[round(x, 1) for x in r1[name]['step_ms']]} "
              f"{[round(x, 1) for x in one[name]['step_ms']]}", flush=True)
    ok = all(out[n]["loss_err"] <= DP_LOSS_TOL
             and out[n]["sum_err"] <= DP_SUM_TOL and out[n]["ranks_equal"]
             for n in ("meanTeacher", "crossPse", "dtc"))
    m, g = out["M3L"], out["gan1"]
    ok = ok and (m["loss_err"] <= M3L_LOSS_TOL and m["ranks_equal"]
                 and m["dev_max"] <= GAN_FLIP_DEV * lr
                 and m["flip_share"] < GAN_FLIP_SHARE)
    ok = ok and (g["ranks_equal"] and g["loss_over"] <= GAN_LOSS_ATOL
                 and g["d_dev_max"] <= GAN_FLIP_DEV * lr
                 and g["d_flip_share"] < GAN_FLIP_SHARE
                 and g["seg_over"] <= GAN_SEG_ATOL)
    for name in DP_ZOO:   # a rank's step launches the one process's
        if r0[name]["launches"] != one[name]["launches"] or \
                r0[name]["routed"] != one[name]["routed"]:
            ok = False
    if not ok:
        raise AssertionError(f"11b zoo, two ranks vs one process: {out}")
    return out


def dp_two_ranks(torch, np, counters, routed, kids) -> dict:
    """11b: the two ranks (``kids``, :func:`dp_spawn`'s) against one
    process at the global batch, here (the zoo: :func:`dp_zoo_against`)."""
    import types

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    r0, r1 = [child_result(k, go=False) for k in kids]   # told by go()
    import torch.backends.cudnn as cudnn

    det = cudnn.deterministic
    cudnn.deterministic = True
    try:
        cfg = Config(input_size=256, base_width=16, batch_size=DP_GLOBAL,
                     compute_dtype="float32", consis_gate_step=0)
        unet = SupervisedUNet(cfg)
        state = unet.init_state(0)
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in dp_batch(np).items()}
        losses = []
        for _ in range(DP_STEPS):
            state, m = unet.train_step(state, batch)
            losses.append(float(m["loss"]))
        cksum = tree_checksum(state.params)
        gan = UGANConsisAlgo(cfg)
        zero(counters, routed)
        gst, gm = gan.train_step(gan.init_state(0), dict(
            gan_batch(torch, np),
            msk=torch.from_numpy(dp_batch(np)["msk"]).cuda(),
            **gan.make_extra_batch()), gan.epoch_scalars(1))
        per_step = {k: c.launches for k, c in counters.items()}
        del unet, state, gan
        torch.cuda.empty_cache()
        zoo_one, zoo_mine = dp_zoo(torch, np, counters, routed)
    finally:
        cudnn.deterministic = det
    saved = torch.load(DP_DIR / "gan_rank0.pt", weights_only=True)
    got = types.SimpleNamespace(**{t: {k: v.cuda() for k, v in
                                       saved[t].items()} for t in saved})
    gan_d = gan_step_against(torch, (r0["gan"]["metrics"], got),
                             ({k: float(v) for k, v in gm.items()}, gst),
                             cfg.lr)
    u0 = r0["unet"]
    loss_err = abs(u0["losses"][-1] - losses[-1])
    sum_err = abs(u0["checksum"] - cksum) / max(abs(cksum), 1.0)
    zoo = dp_zoo_against(torch, r0["zoo"], r1["zoo"], zoo_one, torch.load(
        DP_DIR / "zoo_rank0.pt", weights_only=True), zoo_mine, cfg.lr)
    out = {"ranks": [r0, r1], "one_process": {"losses": losses,
                                              "checksum": cksum,
                                              "gan_per_step": per_step,
                                              "zoo": zoo_one},
           "unet_loss_err": loss_err, "unet_sum_err": sum_err,
           "gan": gan_d, "zoo": zoo}
    print(f"dp 11b: two ranks over {r0['backend']} on the one card, eager: "
          f"U-Net losses {[round(x, 6) for x in u0['losses']]} vs one "
          f"process {[round(x, 6) for x in losses]}: step {DP_STEPS} err "
          f"{loss_err:.3g} (tol {DP_LOSS_TOL}), checksum rel err "
          f"{sum_err:.3g} (tol {DP_SUM_TOL}), ranks equal to the bit "
          f"{u0['sha'] == r1['unet']['sha']}; a rank's step launches "
          f"{u0['launches']}, routed {u0['routed']}, block_pallas step "
          f"{r0['unet_block']['launches']} routed "
          f"{r0['unet_block']['routed']}; step ms {u0['step_ms']} (rank 0)"
          f" {r1['unet']['step_ms']} (rank 1)", flush=True)
    print(f"dp 11b: uganConsis one step, 4 + 4 a rank vs 8 + 8: {gan_d} "
          f"(7b's rules: losses atol {GAN_LOSS_ATOL} over rtol, D max |dev| "
          f"<= {GAN_FLIP_DEV} lr, flips < {GAN_FLIP_SHARE}, seg tower atol "
          f"{GAN_SEG_ATOL}); ranks equal to the bit "
          f"{(r0['gan']['g_sha'], r0['gan']['d_sha']) == (r1['gan']['g_sha'], r1['gan']['d_sha'])}"
          f"; a rank's launches {r0['gan']['launches']} (one process "
          f"{per_step}), routed {r0['gan']['routed']}; step ms "
          f"{r0['gan']['step_ms']:.1f} (rank 0, second step) "
          f"{r1['gan']['step_ms']:.1f} (rank 1)", flush=True)
    want_unet = {k: PER_STEP[False].get(k, 0) for k in KERNELS}
    want_block = {k: PER_STEP[True].get(k, 0) for k in KERNELS}
    for r in (r0, r1):
        if (r["backend"] != "gloo" or r["world"] != 2
                or r["unet"]["launches"] != want_unet
                or r["unet_block"]["launches"] != want_block
                or any(r["unet"]["routed"].values())
                or any(r["unet_block"]["routed"].values())
                or r["gan"]["launches"] != per_step
                or r["gan"]["routed"] != {"conv3x3": 3, "block": 0}):
            raise AssertionError(f"11b rank {r['rank']}: {r}")
    if not (loss_err <= DP_LOSS_TOL and sum_err <= DP_SUM_TOL
            and u0["sha"] == r1["unet"]["sha"]
            and u0["losses"] == r1["unet"]["losses"]
            and r0["gan"]["g_sha"] == r1["gan"]["g_sha"]
            and r0["gan"]["d_sha"] == r1["gan"]["d_sha"]
            and gan_d["loss_over"] <= GAN_LOSS_ATOL
            and gan_d["d_dev_max"] <= GAN_FLIP_DEV * cfg.lr
            and gan_d["d_flip_share"] < GAN_FLIP_SHARE
            and gan_d["seg_over"] <= GAN_SEG_ATOL):
        raise AssertionError(f"11b two ranks vs one process: {out}")
    return out


def log_metrics(text: str) -> dict:
    """{"train/loss": [per epoch], "test/dice_ct": [...], ...} of a
    train.log's [TRN] and [TST] lines (their current values)."""
    out = {}
    for tag, prefix in (("[TRN]", "train"), ("[TST]", "test")):
        for line in text.splitlines():
            if tag not in line:
                continue
            for k, v in re.findall(r" (\w+): ([-0-9.e]+)/", line):
                out.setdefault(f"{prefix}/{k}", []).append(float(v))
    return out


def fit_distance(k: dict, p: dict) -> dict:
    """6b's distances between two fits' logged metrics: the [TRN] loss
    relative, the [TST] Dice per modality and overall absolute, the
    largest over the epochs."""
    mods = ("ct", "t1in", "t1out", "t2")
    return {"loss": max(abs(a - b) / abs(b) for a, b in
                        zip(k["train/loss"], p["train/loss"])),
            "dice": {m: max(abs(a - b) for a, b in
                            zip(k[f"test/dice_{m}"], p[f"test/dice_{m}"]))
                     for m in mods},
            "dice_all": max(abs(a - b) for a, b in
                            zip(k["test/dice"], p["test/dice"]))}


def nudged_unet(cfg, device=None):
    """``SupervisedUNet`` whose initial weights are scaled by 1 + 2^-23
    (each moved by at most one float32 unit in the last place): a fit
    from them shows how far rounding alone parts two fits."""
    import torch

    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    algo = SupervisedUNet(cfg, device)
    init = algo.init_state

    def nudged(seed):
        state = init(seed)
        with torch.no_grad():
            torch._foreach_mul_(list(state.params.values()), 1 + 2.0 ** -23)
        return state

    algo.init_state = nudged
    return algo


# 11c's ranks: the trainer module under deterministic cuDNN (8c's rule)
DETERMINISTIC_UNET = (
    "import runpy, torch; torch.backends.cudnn.deterministic = True; "
    "runpy.run_module('smsut_tpu_torch.trainer.unetTrainer', "
    "run_name='__main__', alter_sys=True)")


def dp_fit_args(data: Path, name: str) -> list:
    """11c's trainer arguments for run ``name``."""
    return fit_args(data, DP_DIR / "expr", name, "compute_dtype=float32",
                    "num_workers=2")


def dp_fit_cmd(data: Path) -> list:
    """11c's two-rank fit, for :class:`Lane`."""
    return ([sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", "--no-python", sys.executable, "-c",
             DETERMINISTIC_UNET, "-p", "train"] + dp_fit_args(data, "dp2"))


def dp_fit(torch, data: Path, lane: Lane) -> dict:
    """11c: ``unetTrainer -p train`` through ``torch.distributed.run``
    (:func:`dp_fit_cmd`, run by ``lane``), two ranks on the one card,
    against the one-process fit here under
    6b's rules; then ``-p test`` here from the two-rank checkpoint.  All
    fits run under deterministic cuDNN, as 8c's: with cuDNN's default
    algorithms two one-process fits of this tree part by up to 1.6e-2 in
    an iteration's loss (measured on one H100).  The augmented fit is
    chaotic even so, so the bounds are 6b's or, where larger, twice the
    distance from the one-process fit of a fit from weights one unit in
    the last place away (:func:`nudged_unet`)."""
    import numpy as np
    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.train.cli import make_parser, run_main
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    expr = DP_DIR / "expr"
    args = lambda name: dp_fit_args(data, name)
    proc, two_s = lane.result("11c")
    if proc.returncode:
        raise AssertionError(f"torch.distributed.run failed:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    det = cudnn.deterministic
    cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        run_main(SupervisedUNet, make_parser().parse_args(
            ["-p", "train"] + args("dp1")))
        one_s = time.perf_counter() - t0
        run_main(nudged_unet, make_parser().parse_args(
            ["-p", "train"] + args("dp1ulp")))
    finally:
        cudnn.deterministic = det
    logs = sorted(p.relative_to(expr / "dp2")
                  for p in (expr / "dp2").rglob("train.log"))
    ckpts = sorted(p.name for p in (expr / "dp2").rglob("*.ckpt"))
    text = {n: (expr / n / "000" / "train.log").read_text()
            for n in ("dp2", "dp1", "dp1ulp")}
    k, p, u = (log_metrics(text[n]) for n in ("dp2", "dp1", "dp1ulp"))
    d, spread = fit_distance(k, p), fit_distance(u, p)
    bound = {"loss": max(LOSS_TOL, 2 * spread["loss"]),
             "dice": {m: max(PARITY_DICE_TOL, 2 * v)
                      for m, v in spread["dice"].items()},
             "dice_all": max(PARITY_DICE_ALL, 2 * spread["dice_all"])}
    best = lambda m: max(range(FIT_EPOCHS),
                         key=lambda e: (m["test/dice"][e], e))
    elapsed = lambda t: [float(x) for x in re.findall(
        r"\[TRN\] Epoch: .*elapsed: ([0-9.]+)s", t)]
    eager = re.findall(r"(\d+) dispatches ran eagerly", text["dp2"])
    t0 = time.perf_counter()
    run_main(SupervisedUNet, make_parser().parse_args(
        ["-p", "test", "-i", "000", "-wh", "best"] + args("dp2")))
    test_s = time.perf_counter() - t0
    csv = np.array([[float(v) for v in r.split(",")] for r in
                    (expr / "dp2" / "000" / "all_trois_matrix.csv")
                    .read_text().split("\n") if r])
    out = {"diff": d, "ulp_spread": spread, "bound": bound,
           "best": [best(k), best(p), best(u)],
           "logs": [str(x) for x in logs], "ckpts": ckpts, "two": k,
           "one": p, "one_ulp": u, "two_ranks_s": two_s,
           "one_process_s": one_s, "test_s": test_s,
           "epoch1_ms_per_iteration": {
               "two_ranks": elapsed(text["dp2"])[1] * 1e3 / FIT_ITERS,
               "one_process": elapsed(text["dp1"])[1] * 1e3 / FIT_ITERS},
           "eager_dispatches": eager, "csv_shape": list(csv.shape)}
    print(f"dp 11c: unetTrainer through torch.distributed.run, 2 ranks "
          f"({two_s:.1f} s) vs one process ({one_s:.1f} s), float32: "
          f"[TRN] losses {k['train/loss']} vs {p['train/loss']} (one ulp "
          f"off: {u['train/loss']}); [TST] Dice {k['test/dice']} vs "
          f"{p['test/dice']} ({u['test/dice']}); distance {d}; one-ulp "
          f"spread {spread}; bounds {bound}; best epoch {best(k)} vs "
          f"{best(p)}; logs {out['logs']}, checkpoints {ckpts}; eager "
          f"dispatches logged by rank 0 {eager}; epoch-1 ms per iteration "
          f"(the log's elapsed over {FIT_ITERS}) "
          f"{out['epoch1_ms_per_iteration']}; -p test from the two-rank "
          f"checkpoint in {test_s:.1f} s, CSV {csv.shape}", flush=True)
    if not (logs == [Path("000") / "train.log"]
            and ckpts == ["best.ckpt", "last.ckpt"]
            and "[distributed] process 0/2, backend gloo" in proc.stdout
            and "cannot be captured" in text["dp2"] and eager
            and d["loss"] <= bound["loss"]
            and all(v <= bound["dice"][m] for m, v in d["dice"].items())
            and d["dice_all"] <= bound["dice_all"] and best(k) == best(p)
            and csv.shape == (10, 5) and np.isfinite(csv).all()):
        raise AssertionError(f"11c: {out}\n{proc.stdout[-2000:]}")
    return out


def dp_spawn() -> dict:
    """Phase 11's children, started ahead of it: 11a's and 11b's two
    ranks (their group's address chosen here)."""
    DP_DIR.mkdir(parents=True, exist_ok=True)
    port = free_port()
    return {"world1": run_child("dp_world1"),
            "ranks": [run_child("dp_rank", {
                "SMSUT_COORDINATOR": f"127.0.0.1:{port}",
                "SMSUT_NUM_PROCESSES": "2", "SMSUT_PROCESS_ID": str(r)})
                for r in range(2)]}


def dp_world1_report(a: dict, timing: dict, card: str) -> None:
    """11a: the result of :func:`dp_spawn`'s ``world1`` child, printed
    beside 8e's ``timing`` and checked."""
    for name in DP_ITERATIONS:
        r, e = a[name], timing.get(name, {}).get("replayed")
        seen = ("" if "added" not in r else
                f"; with no group {r['alone_device_ms']:.3f} ms in "
                f"{r['alone_kernels']} kernels, the group's kernels "
                f"{sum(r['added'].values()):+d} over "
                f"{len(r['added'])} kinds")
        seen += ("" if e is None else
                 f"; 8e (no group, another process): median "
                 f"{e['median_ms']:.3f} ms, device {e['device_ms']:.3f} ms "
                 f"in {e['kernels']:.0f} kernels")
        print(f"dp 11a {name} on {card}: world 1 over {a['backend']}, "
              f"float32 replays equal to the no-group run to the bit: "
              f"{a['bit_equal'][name]}; bfloat16 replay median "
              f"{r['median_ms']:.3f} ms (quartiles {r['q1_ms']:.3f}-"
              f"{r['q3_ms']:.3f}), device {r['device_ms']:.3f} ms in "
              f"{r['kernels']} kernels, idle share {r['idle_share']:.3f}; "
              f"NCCL kernels {len(r['nccl'])}{seen}", flush=True)
    if a["backend"] != "nccl" or not all(a["bit_equal"].values()):
        raise AssertionError(f"11a: {a}")


# phase 13: the space axis (spatial_parallel, dp x sp = 1 x 2): two ranks
# on the one card over gloo, each holding half the rows of every image
SP = 2
SP_DIR = FIT_DIR / "sp"
SP_STEPS = 3              # 13b: the U-Net's eager steps
SP_NORM_SHAPES = tuple((b, h // SP, w, c, act)
                       for b, h, w, c, act in NORM_SHAPES[:6])
SPLIT = ("instance_norm_fwd_sums", "instance_norm_fwd_apply",
         "instance_norm_bwd_sums", "instance_norm_bwd_apply")


def split_counters() -> dict:
    """{name: the split form's wrapper, whose ``launches`` count}."""
    from smsut_tpu_torch.ops import instnorm

    return {k: getattr(instnorm, k) for k in SPLIT}


def halo_share(sp: int = SP) -> float:
    """The extra 3x3-conv work of the space axis at ``sp`` in the U-Net's
    step (w16, 256^2): each of its 18 convs (the nine blocks' two) runs
    K2, K2 as dx and K5 on a rank's h/sp rows plus a halo row on each
    side, against h/sp rows; work counted as rows x W x Cin x Cout."""
    convs = [c for h, ci, co in UNET_BLOCKS for c in ((h, ci, co),
                                                       (h, co, co))]
    rows = sum((h // sp + 2) * h * ci * co for h, ci, co in convs)
    return rows / sum(h // sp * h * ci * co for h, ci, co in convs) - 1


def sp_batch(np) -> dict:
    """Phase 4's ellipse batch with labels 1 and 2 cleared in the lower
    half of each image, so that either rank's Dice alone differs from the
    whole image's."""
    b = ellipse_batch(np)
    low = b["msk"][:, b["msk"].shape[1] // 2:]
    low[(low == 1) | (low == 2)] = 0
    return b


def split_norm_kernels(torch, ops, instnorm) -> list:
    """13a: K1's and K4's split forms at the U-Net's norm shapes with H
    halved, against their plain versions (``record``: phase 2's bounds),
    both dtypes; the timed call is one rank's work (its sums pass, the
    other rank's sums added, its apply pass), beside the unsplit K1 and
    K4 on the same half map.  Returns the rows."""
    rows = []
    cases = Cases(torch, seed=3)
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[-1]
        isz = torch.tensor([], dtype=dt).element_size()
        for (b, h, w, c, act) in SP_NORM_SHAPES:
            shape, n = (b, h, w, c), SP * h * w
            x0, x1 = (cases.randn(*shape, mean=0.3, dtype=dt)
                      for _ in range(2))
            g0, g1 = (cases.randn(*shape, dtype=dt) for _ in range(2))
            s, bb = cases.norm_params(c)
            other = instnorm.instance_norm_fwd_sums(x1)

            def k1(x, other, s, bb, act, n=n):
                tot = instnorm.instance_norm_fwd_sums(x) + other
                return instnorm.instance_norm_fwd_apply(x, tot, n, s, bb,
                                                        act)
            _, mean, rstd = k1(x0, other, s, bb, act)
            _, m1, r1 = k1(x1, instnorm.instance_norm_fwd_sums(x0), s, bb,
                           act)
            other_b = instnorm.instance_norm_bwd_sums(x1, g1, m1, r1, s, bb,
                                                      act)[0]

            def k4(x, g, mean, rstd, s, bb, other, act, n=n):
                sums, dsb = instnorm.instance_norm_bwd_sums(
                    x, g, mean, rstd, s, bb, act)
                return (instnorm.instance_norm_bwd_apply(
                    x, g, mean, rstd, s, bb, sums + other, n, act),
                    dsb[1], dsb[0])
            plan = norm_plan(instnorm, "split", shape, dt)
            a1, a4 = (x0, other, s, bb, act), (x0, g0, mean, rstd, s, bb,
                                               other_b, act)
            same_twice(torch, "instnorm_split", shape, k1, a1)
            same_twice(torch, "instnorm_bwd_split", shape, k4, a4)
            unsplit = {
                "unsplit_ms": time_ms(lambda: instnorm.instance_norm_fwd(
                    x0, s, bb, act), 20),
                "unsplit_bwd_ms": time_ms(lambda: instnorm.instance_norm_bwd(
                    x0, g0, mean, rstd, s, bb, act), 20)}
            record(torch, ops, rows, "instnorm_split",
                   f"{list(shape)} act={act}", dn, k1, a1, None,
                   flops=8 * x0.numel(),
                   nbytes=2 * x0.numel() * isz + 4 * 4 * c + 6 * 4 * b * c,
                   iters=20, extra={"plan": plan,
                                    "unsplit_ms": unsplit["unsplit_ms"]})
            record(torch, ops, rows, "instnorm_bwd_split",
                   f"{list(shape)} act={act}", dn, k4, a4, None,
                   flops=12 * x0.numel(),
                   nbytes=3 * x0.numel() * isz + 6 * 4 * c + 6 * 4 * b * c,
                   iters=20, peak=PEAK_F32_CORES,
                   extra={"plan": norm_plan(instnorm, "bwd", shape, dt),
                          "unsplit_ms": unsplit["unsplit_bwd_ms"]})
    return rows


def sp_rank() -> dict:
    """13b, one rank of two on the one card (gloo, eager; the group from
    the SMSUT_* variables), dp x sp = 1 x 2: the U-Net's SP_STEPS float32
    steps and one float32 uganConsis step on the rank's rows of every
    image; metrics averaged over the ranks, launches and routed calls per
    step, step times, and the trees after (the GAN's written to SP_DIR
    for the parent)."""
    import numpy as np
    import torch
    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.parallel import distributed, mesh
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    cudnn.deterministic = True
    if not distributed.initialize():
        raise AssertionError("no group")
    cfg = Config(input_size=256, base_width=16, batch_size=DP_GLOBAL,
                 compute_dtype="float32", consis_gate_step=0,
                 spatial_parallel=SP)
    mesh.check_config(cfg, gan=True)
    rank = distributed.process_index()
    counters, routed = kernel_counters()
    counters.update(split_counters())
    counts = lambda: {k: c.launches for k, c in counters.items()}
    rows = lambda t: mesh.space_rows(t).contiguous()
    out = {"rank": rank, "world": distributed.process_count(),
           "space": distributed.space_count(),
           "backend": distributed.backend()}

    def timed_step(algo, state, batch, scal=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = algo.train_step(state, batch, scal)
        m = {k: float(mesh.mean_over_ranks(v)) for k, v in m.items()}
        torch.cuda.synchronize()
        return state, m, (time.perf_counter() - t0) * 1e3

    unet = SupervisedUNet(cfg)
    state = unet.init_state(0)
    batch = {k: rows(torch.from_numpy(v).cuda())
             for k, v in sp_batch(np).items()}
    zero(counters, routed)
    losses, ms = [], []
    for _ in range(SP_STEPS):
        state, m, t = timed_step(unet, state, batch)
        losses.append(m["loss"])
        ms.append(t)
    out["unet"] = {"losses": losses, "step_ms": ms,
                   "launches": {k: v // SP_STEPS for k, v in counts().items()},
                   "routed": routed_counts(routed),
                   "checksum": tree_checksum(state.params),
                   "sha": tree_sha(state.params)}
    gan = UGANConsisAlgo(cfg)
    gst = gan.init_state(0)
    gb = {k: rows(v) if torch.is_tensor(v) else v
          for k, v in gan_batch(torch, np).items()}
    zero(counters, routed)
    gst, gm, t = timed_step(gan, gst, dict(gb, **gan.make_extra_batch()),
                            gan.epoch_scalars(1))
    out["gan"] = {"metrics": gm, "launches": counts(),
                  "routed": routed_counts(routed),
                  "g_sha": tree_sha(gst.g_params),
                  "d_sha": tree_sha(gst.d_params), "first_ms": t}
    if rank == 0:
        torch.save({"g_params": {k: v.cpu() for k, v in gst.g_params.items()},
                    "d_params": {k: v.cpu() for k, v in gst.d_params.items()}},
                   SP_DIR / "gan_rank0.pt")
    torch.distributed.destroy_process_group()
    return out


def sp_spawn() -> list:
    """13b's two ranks, started ahead of the phase (their group's address
    chosen here)."""
    SP_DIR.mkdir(parents=True, exist_ok=True)
    port = free_port()
    return [run_child("sp_rank", {
        "SMSUT_COORDINATOR": f"127.0.0.1:{port}",
        "SMSUT_NUM_PROCESSES": str(SP), "SMSUT_PROCESS_ID": str(r)})
        for r in range(SP)]


def sp_two_ranks(torch, np, counters, routed, kids) -> dict:
    """13b: the two ranks against one process at the global batch, here:
    the U-Net under 11b's bounds, the GAN under 7b's rules."""
    import types

    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    r0, r1 = [child_result(k, go=False) for k in kids]   # told by go()
    det = cudnn.deterministic
    cudnn.deterministic = True
    try:
        cfg = Config(input_size=256, base_width=16, batch_size=DP_GLOBAL,
                     compute_dtype="float32", consis_gate_step=0)
        unet = SupervisedUNet(cfg)
        state = unet.init_state(0)
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in sp_batch(np).items()}
        losses, ms = [], []
        for _ in range(SP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = unet.train_step(state, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        cksum = tree_checksum(state.params)
        gan = UGANConsisAlgo(cfg)
        zero(counters, routed)
        gst, gm = gan.train_step(gan.init_state(0), dict(
            gan_batch(torch, np), **gan.make_extra_batch()),
            gan.epoch_scalars(1))
        per_step = {k: c.launches for k, c in counters.items()}
        del unet, state, gan
        torch.cuda.empty_cache()
    finally:
        cudnn.deterministic = det
    saved = torch.load(SP_DIR / "gan_rank0.pt", weights_only=True)
    got = types.SimpleNamespace(**{t: {k: v.cuda() for k, v in
                                       saved[t].items()} for t in saved})
    gan_d = gan_step_against(torch, (r0["gan"]["metrics"], got),
                             ({k: float(v) for k, v in gm.items()}, gst),
                             cfg.lr)
    u0 = r0["unet"]
    loss_err = abs(u0["losses"][-1] - losses[-1])
    sum_err = abs(u0["checksum"] - cksum) / max(abs(cksum), 1.0)
    out = {"ranks": [r0, r1], "one_process": {
        "losses": losses, "checksum": cksum, "step_ms": ms,
        "gan_per_step": per_step},
        "unet_loss_err": loss_err, "unet_sum_err": sum_err, "gan": gan_d,
        "halo_share": halo_share()}
    print(f"sp 13b: two ranks (dp x sp = 1 x {SP}) over {r0['backend']} on "
          f"the one card, eager, 128 rows a rank: U-Net losses "
          f"{[round(x, 6) for x in u0['losses']]} vs one process "
          f"{[round(x, 6) for x in losses]} (3x3 conv work of the halo "
          f"rows: {halo_share():.4f} of a rank's rows'): step {SP_STEPS} err "
          f"{loss_err:.3g} (tol {DP_LOSS_TOL}), checksum rel err "
          f"{sum_err:.3g} (tol {DP_SUM_TOL}), ranks equal to the bit "
          f"{u0['sha'] == r1['unet']['sha']}; a rank's step launches "
          f"{u0['launches']}, routed {u0['routed']}; step ms "
          f"{[round(x, 1) for x in u0['step_ms']]} (rank 0) "
          f"{[round(x, 1) for x in r1['unet']['step_ms']]} (rank 1), one "
          f"process {[round(x, 1) for x in ms]}", flush=True)
    print(f"sp 13b: uganConsis one step, 8 + 8 at 128 rows a rank vs one "
          f"process: {gan_d} (7b's rules); ranks equal to the bit "
          f"{(r0['gan']['g_sha'], r0['gan']['d_sha']) == (r1['gan']['g_sha'], r1['gan']['d_sha'])}"
          f"; a rank's launches {r0['gan']['launches']} (one process "
          f"{per_step}), routed {r0['gan']['routed']}; step ms "
          f"{r0['gan']['first_ms']:.1f} (rank 0, first step)", flush=True)
    want_unet = {k: PER_STEP[False].get(k, 0) for k in KERNELS}
    want_unet.update(instnorm=0, instnorm_bwd=0)
    want_unet.update({k: PER_STEP[False]["instnorm"] for k in SPLIT})
    for r in (r0, r1):
        gl = r["gan"]["launches"]
        if (r["backend"] != "gloo" or r["world"] != SP or r["space"] != SP
                or r["unet"]["launches"] != want_unet
                or any(r["unet"]["routed"].values())
                or gl["instnorm"] or gl["instnorm_bwd"]
                or gl["instance_norm_fwd_sums"] != per_step["instnorm"]
                or gl["instance_norm_fwd_apply"] != per_step["instnorm"]
                or gl["instance_norm_bwd_sums"] != per_step["instnorm_bwd"]
                or gl["instance_norm_bwd_apply"] != per_step["instnorm_bwd"]
                or any(gl[k] != per_step[k] for k in
                       ("conv3x3", "conv3x3_dw"))
                or r["gan"]["routed"] != {"conv3x3": 3, "block": 0}):
            raise AssertionError(f"13b rank {r['rank']}: {r}")
    if not (loss_err <= DP_LOSS_TOL and sum_err <= DP_SUM_TOL
            and u0["sha"] == r1["unet"]["sha"]
            and u0["losses"] == r1["unet"]["losses"]
            and r0["gan"]["g_sha"] == r1["gan"]["g_sha"]
            and r0["gan"]["d_sha"] == r1["gan"]["d_sha"]
            and gan_d["loss_over"] <= GAN_LOSS_ATOL
            and gan_d["d_dev_max"] <= GAN_FLIP_DEV * cfg.lr
            and gan_d["d_flip_share"] < GAN_FLIP_SHARE
            and gan_d["seg_over"] <= GAN_SEG_ATOL):
        raise AssertionError(f"13b two ranks vs one process: {out}")
    return out


def sp_fit_args(data: Path) -> list:
    """13c's trainer arguments."""
    return fit_args(data, SP_DIR / "expr", "sp2", "compute_dtype=float32",
                    "num_workers=2", "max_epoch=1")


def sp_fit_cmd(data: Path) -> list:
    """13c's two-rank fit, for :class:`Lane`."""
    return ([sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(SP), "-m",
             "smsut_tpu_torch.trainer.unetTrainer", "-p", "train"]
            + sp_fit_args(data) + ["--set", f"spatial_parallel={SP}"])


def sp_fit(torch, data: Path, lane: Lane) -> dict:
    """13c: ``unetTrainer -p train --set spatial_parallel=2`` through
    ``torch.distributed.run`` (:func:`sp_fit_cmd`, run by ``lane``), two
    ranks on the one card (gloo, eager), one epoch of FIT_ITERS on phase
    6's tree, float32; then ``-p test`` here, in one process, from its
    checkpoint."""
    import numpy as np

    from smsut_tpu_torch.train.cli import make_parser, run_main
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    expr = SP_DIR / "expr"
    args = sp_fit_args(data)
    proc, train_s = lane.result("13c")
    if proc.returncode:
        raise AssertionError(f"torch.distributed.run failed:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    run = expr / "sp2"
    logs = sorted(str(p.relative_to(run)) for p in run.rglob("train.log"))
    ckpts = sorted(p.name for p in run.rglob("*.ckpt"))
    text = (run / "000" / "train.log").read_text()
    k = log_metrics(text)
    t0 = time.perf_counter()
    run_main(SupervisedUNet, make_parser().parse_args(
        ["-p", "test", "-i", "000", "-wh", "best"] + args))
    test_s = time.perf_counter() - t0
    csv = np.array([[float(v) for v in r.split(",")] for r in
                    (run / "000" / "all_trois_matrix.csv")
                    .read_text().split("\n") if r])
    out = {"metrics": k, "logs": logs, "ckpts": ckpts, "train_s": train_s,
           "test_s": test_s, "csv_shape": list(csv.shape),
           "ms_per_iteration": [float(x) * 1e3 / FIT_ITERS for x in
                                re.findall(r"\[TRN\] Epoch: .*elapsed: "
                                           r"([0-9.]+)s", text)]}
    print(f"sp 13c: unetTrainer -p train --set spatial_parallel={SP} "
          f"through torch.distributed.run ({train_s:.1f} s), float32, one "
          f"epoch of {FIT_ITERS}: [TRN] loss {k['train/loss']}, [TST] Dice "
          f"{k['test/dice']}; logs {logs}, checkpoints {ckpts}; ms per "
          f"iteration (the log's elapsed over {FIT_ITERS}) "
          f"{out['ms_per_iteration']}; -p test in one process from its "
          f"checkpoint in {test_s:.1f} s, CSV {csv.shape}", flush=True)
    if not (logs == ["000/train.log"] and ckpts == ["best.ckpt", "last.ckpt"]
            and f"of each image 1/{SP} of its rows" in text
            and "cannot be captured" in text
            and all(np.isfinite(k["train/loss"]))
            and csv.shape == (10, 5) and np.isfinite(csv).all()):
        raise AssertionError(f"13c: {out}\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-3000:]}")
    return out


# phase 14: the model axis (channel-wise tensor parallelism, dp x tp =
# 1 x 2): two ranks on the one card over gloo, each holding the output-
# channel shards of every eligible weight and of its optimizer state
TP_DIR = FIT_DIR / "tp"
TP_STEPS = 3              # 14a/14b: the U-Net's eager steps
TP_GAN_STEPS = 2          # 14a: uganConsis's eager steps
# a rank's launches and routed calls per U-Net step at w16: the 3x3 convs
# of the 256^2 level run shards of Cout 8, which K5 does not take (routed,
# as width 8's first and last blocks are in one process: phase 4's
# counts); fused, K3/K6 on every block's gathered weights
PER_STEP_TP = {False: dict(PER_STEP_W8[False]),
               True: dict(PER_STEP[True])}
ROUTED_TP = {False: {"conv3x3": 4, "block": 0},
             True: {"conv3x3": 0, "block": 0}}


def tp_bytes(whole, state) -> dict:
    """Bytes of the parameters and the optimizer state on a rank against
    the whole state's, in all and over the sharded tensors alone."""
    size = lambda t, keys: sum(t[k].numel() * t[k].element_size()
                               for k in keys)
    keys, shards = list(whole.params), state.shards
    return {"rank": size(state.params, keys) + size(state.opt_state, keys),
            "whole": size(whole.params, keys) + size(whole.opt_state, keys),
            "rank_sharded": size(state.params, shards)
            + size(state.opt_state, shards),
            "whole_sharded": size(whole.params, shards)
            + size(whole.opt_state, shards)}


def tp_rank() -> dict:
    """14a, 14b and 14d's ranks, one of two on the one card (gloo, eager;
    the group from the SMSUT_* variables) laid out as dp x tp = 1 x 2: the
    w16 U-Net's TP_STEPS float32 steps unfused, a checkpoint and one more
    step (14d), the same fused (14b), and TP_GAN_STEPS float32 uganConsis
    steps; metrics averaged over the ranks, launches and routed calls per
    step, step times, bytes, the trees whole (gathered) and the replicated
    ones' digest, rank 0's GAN after step 1 written to TP_DIR."""
    import numpy as np
    import torch
    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.ops import block
    from smsut_tpu_torch.parallel import distributed, mesh
    from smsut_tpu_torch.train import checkpoints
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    cudnn.deterministic = True
    if not distributed.initialize():
        raise AssertionError("no group")
    layout = mesh.make_mesh_2d(1, TP)
    rank = distributed.process_index()
    counters, routed = kernel_counters()
    counts = lambda: {k: c.launches for k, c in counters.items()}
    out = {"rank": rank, "world": distributed.process_count(),
           "model": distributed.model_count(),
           "backend": distributed.backend()}

    def timed_step(algo, state, batch, scal=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = algo.train_step(state, batch, scal)
        m = {k: float(mesh.mean_over_ranks(v)) for k, v in m.items()}
        torch.cuda.synchronize()
        return state, m, (time.perf_counter() - t0) * 1e3

    def replicated(tree, shards):
        return tree_sha({k: v for k, v in tree.items() if k not in shards})

    batch = {k: torch.from_numpy(v).cuda() for k, v in dp_batch(np).items()}
    for fused in (False, True):
        cfg = Config(input_size=256, base_width=16, batch_size=DP_GLOBAL,
                     compute_dtype="float32", block_pallas=fused)
        unet = SupervisedUNet(cfg)
        whole = unet.init_state(0)
        state = mesh.shard_params_channelwise(layout, whole)
        bytes_ = tp_bytes(whole, state)
        del whole
        zero(counters, routed)
        block.basic_block.tp_gathered = 0
        losses, ms = [], []
        for _ in range(TP_STEPS):
            state, m, t = timed_step(unet, state, batch)
            losses.append(m["loss"])
            ms.append(t)
        params = mesh.gather_tree(state.params, state.shards)
        res = {"losses": losses, "step_ms": ms, "bytes": bytes_,
               "launches": {k: v // TP_STEPS for k, v in counts().items()},
               "routed": {k: v // TP_STEPS
                          for k, v in routed_counts(routed).items()},
               "tp_gathered": block.basic_block.tp_gathered // TP_STEPS,
               "checksum": tree_checksum(params), "sha": tree_sha(params),
               "replicated_sha": replicated(state.params, state.shards),
               "shards": len(state.shards)}
        if not fused:
            # 14d: the whole tree written by rank 0, then one more step
            checkpoints.save_state(state, str(TP_DIR), "tp")
            state, m, _ = timed_step(unet, state, batch)
            res["next"] = {"loss": m["loss"], "checksum": tree_checksum(
                mesh.gather_tree(state.params, state.shards))}
        out[f"unet_{'on' if fused else 'off'}"] = res
        del unet, state, params
        torch.cuda.empty_cache()
    gan = UGANConsisAlgo(Config(input_size=256, base_width=16,
                                batch_size=DP_GLOBAL, compute_dtype="float32",
                                consis_gate_step=0))
    whole = gan.init_state(0)
    gst = mesh.shard_params_channelwise(layout, whole)
    del whole
    gb = gan_batch(torch, np)
    steps = []
    for i in range(TP_GAN_STEPS):
        zero(counters, routed)
        gst, gm, t = timed_step(gan, gst, dict(gb, **gan.make_extra_batch()),
                                gan.epoch_scalars(1))
        g = mesh.gather_tree(gst.g_params, gst.g_shards)
        d = mesh.gather_tree(gst.d_params, gst.d_shards)
        steps.append({"metrics": gm, "ms": t, "launches": counts(),
                      "routed": routed_counts(routed), "g_sha": tree_sha(g),
                      "d_sha": tree_sha(d),
                      "replicated_sha": replicated(gst.g_params, gst.g_shards)
                      + replicated(gst.d_params, gst.d_shards)})
        if i == 0 and rank == 0:
            torch.save({"g_params": {k: v.cpu() for k, v in g.items()},
                        "d_params": {k: v.cpu() for k, v in d.items()}},
                       TP_DIR / "gan_rank0.pt")
    out["gan"] = {"steps": steps, "shards": [len(gst.g_shards),
                                             len(gst.d_shards)]}
    torch.distributed.destroy_process_group()
    return out


def tp_spawn() -> list:
    """14a's two ranks, started ahead of the phase (their group's address
    chosen here)."""
    TP_DIR.mkdir(parents=True, exist_ok=True)
    port = free_port()
    return [run_child("tp_rank", {
        "SMSUT_COORDINATOR": f"127.0.0.1:{port}",
        "SMSUT_NUM_PROCESSES": str(TP), "SMSUT_PROCESS_ID": str(r)})
        for r in range(TP)]


def tp_one_process(torch, np, counters, routed) -> dict:
    """One process at the global batch, float32, deterministic cuDNN: the
    U-Net's TP_STEPS steps in both block modes, the GAN's first step and
    its launches per step; 14d: the ranks' checkpoint loaded twice, each
    copy stepped once."""
    import types

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train import checkpoints
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    batch = {k: torch.from_numpy(v).cuda() for k, v in dp_batch(np).items()}
    out = {}
    for fused in (False, True):
        unet = SupervisedUNet(Config(input_size=256, base_width=16,
                                     batch_size=DP_GLOBAL,
                                     compute_dtype="float32",
                                     block_pallas=fused))
        state, losses, ms = unet.init_state(0), [], []
        for _ in range(TP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = unet.train_step(state, batch)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        out[f"unet_{'on' if fused else 'off'}"] = {
            "losses": losses, "step_ms": ms,
            "checksum": tree_checksum(state.params)}
        if not fused:
            loaded = []
            for _ in range(2):
                st = checkpoints.load_state(unet.init_state(1), str(TP_DIR),
                                            "tp")
                sha = tree_sha(st.params)
                st, m = unet.train_step(st, batch)
                loaded.append({"sha": sha, "step": st.step,
                               "loss": float(m["loss"]),
                               "checksum": tree_checksum(st.params),
                               "next_sha": tree_sha(st.params)})
            out["loaded"] = loaded
        del unet, state
    gan = UGANConsisAlgo(Config(input_size=256, base_width=16,
                                batch_size=DP_GLOBAL, compute_dtype="float32",
                                consis_gate_step=0))
    zero(counters, routed)
    gst, gm = gan.train_step(gan.init_state(0), dict(
        gan_batch(torch, np), **gan.make_extra_batch()), gan.epoch_scalars(1))
    out["gan"] = ({k: float(v) for k, v in gm.items()}, gst)
    out["gan_per_step"] = {k: c.launches for k, c in counters.items()}
    saved = torch.load(TP_DIR / "gan_rank0.pt", weights_only=True)
    out["gan_ranks"] = types.SimpleNamespace(**{
        t: {k: v.cuda() for k, v in saved[t].items()} for t in saved})
    del gan
    torch.cuda.empty_cache()
    return out


def tp_two_ranks(torch, np, counters, routed, kids, card: str) -> dict:
    """14a, 14b, 14d: the two ranks against one process at the global
    batch: the U-Net under 11b's bounds in both block modes, the GAN's
    step 1 under 7b's rules, the checkpoint."""
    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.config import Config

    r0, r1 = [child_result(k, go=False) for k in kids]   # told by go()
    det = cudnn.deterministic
    cudnn.deterministic = True
    try:
        one = tp_one_process(torch, np, counters, routed)
    finally:
        cudnn.deterministic = det
    out = {"ranks": [r0, r1], "checks": {}}
    for mode in ("off", "on"):
        u0, u1, o = r0[f"unet_{mode}"], r1[f"unet_{mode}"], one[f"unet_{mode}"]
        fused = mode == "on"
        loss_err = abs(u0["losses"][-1] - o["losses"][-1])
        sum_err = abs(u0["checksum"] - o["checksum"]) / max(
            abs(o["checksum"]), 1.0)
        want = {k: PER_STEP_TP[fused].get(k, 0) for k in KERNELS}
        out["checks"][mode] = {"loss_err": loss_err, "sum_err": sum_err}
        b = u0["bytes"]
        print(f"tp 14{'b' if fused else 'a'} on {card}: U-Net w16 256^2, "
              f"global batch {DP_GLOBAL}, float32, eager, block_pallas "
              f"{mode}, two ranks (dp x tp = 1 x {TP}) over "
              f"{r0['backend']} on the one card, {u0['shards']} tensors "
              f"sharded: losses {[round(x, 6) for x in u0['losses']]} vs one "
              f"process {[round(x, 6) for x in o['losses']]}: step "
              f"{TP_STEPS} err {loss_err:.3g} (tol {DP_LOSS_TOL}), checksum "
              f"rel err {sum_err:.3g} (tol {DP_SUM_TOL}); ranks' whole "
              f"trees equal {u0['sha'] == u1['sha']}, replicated parameters "
              f"equal to the bit {u0['replicated_sha'] == u1['replicated_sha']}"
              f"; a rank's launches per step {u0['launches']}, routed "
              f"{u0['routed']}, fused blocks on gathered weights "
              f"{u0['tp_gathered']}; step ms "
              f"{[round(x, 1) for x in u0['step_ms']]} (rank 0) "
              f"{[round(x, 1) for x in u1['step_ms']]} (rank 1), one "
              f"process {[round(x, 1) for x in o['step_ms']]}; bytes of "
              f"parameters + momentum a rank {b['rank']} of {b['whole']} "
              f"(sharded tensors {b['rank_sharded']} of "
              f"{b['whole_sharded']})", flush=True)
        for r in (r0, r1):
            u = r[f"unet_{mode}"]
            if (r["backend"] != "gloo" or r["world"] != TP
                    or r["model"] != TP or u["launches"] != want
                    or u["routed"] != ROUTED_TP[fused]
                    or u["tp_gathered"] != (9 if fused else 0)
                    or 2 * u["bytes"]["rank_sharded"]
                    != u["bytes"]["whole_sharded"]):
                raise AssertionError(f"14 rank {r['rank']} {mode}: {u}")
        if not (loss_err <= DP_LOSS_TOL and sum_err <= DP_SUM_TOL
                and u0["sha"] == u1["sha"] and u0["losses"] == u1["losses"]
                and u0["replicated_sha"] == u1["replicated_sha"]):
            raise AssertionError(f"14 U-Net {mode} vs one process: "
                                 f"{out['checks'][mode]}")
    # 14d: the file rank 0 wrote at 1 x 2, in one process
    nxt, (a, b) = r0["unet_off"]["next"], one["loaded"]
    d = {"sha_equal": a["sha"] == r0["unet_off"]["sha"],
         "loss_err": abs(a["loss"] - nxt["loss"]),
         "sum_err": abs(a["checksum"] - nxt["checksum"]) / max(
             abs(nxt["checksum"]), 1.0),
         "resume_equal": a["next_sha"] == b["next_sha"], "step": a["step"]}
    out["checks"]["checkpoint"] = d
    print(f"tp 14d: the checkpoint saved at 1 x {TP} after {TP_STEPS} steps, "
          f"loaded in one process: trees equal to the ranks' gathered ones "
          f"{d['sha_equal']}; its next step against the ranks' next: loss "
          f"err {d['loss_err']:.3g}, checksum rel err {d['sum_err']:.3g}; "
          f"two loads' next steps equal to the bit {d['resume_equal']}",
          flush=True)
    if not (d["sha_equal"] and d["resume_equal"] and d["step"] == TP_STEPS + 1
            and d["loss_err"] <= DP_LOSS_TOL and d["sum_err"] <= DP_SUM_TOL):
        raise AssertionError(f"14d: {d}")
    # the GAN's step 1 against one process's, 7b's rules
    g0, g1 = r0["gan"]["steps"], r1["gan"]["steps"]
    gm, gst = one["gan"]
    lr = Config().lr
    gan_d = gan_step_against(torch, (g0[0]["metrics"], one["gan_ranks"]),
                             (gm, gst), lr)
    out["checks"]["gan"] = gan_d
    per_step = one["gan_per_step"]
    print(f"tp 14a on {card}: uganConsis w16, 8 + 8, float32, eager, "
          f"{TP_GAN_STEPS} steps, sharded G/D tensors {r0['gan']['shards']}: "
          f"step 1 vs one process {gan_d} (7b's rules); ranks equal to the "
          f"bit {[s['g_sha'] + s['d_sha'] for s in g0] == [s['g_sha'] + s['d_sha'] for s in g1]}"
          f"; a rank's launches per step {g0[0]['launches']} (one process "
          f"{per_step}), routed {g0[0]['routed']}; step ms "
          f"{[round(s['ms'], 1) for s in g0]} (rank 0) "
          f"{[round(s['ms'], 1) for s in g1]} (rank 1)", flush=True)
    for s0, s1 in zip(g0, g1):
        if (s0["launches"] != g0[0]["launches"]
                or s1["launches"] != s0["launches"]
                or s0["routed"] != s1["routed"]
                or s0["g_sha"] != s1["g_sha"] or s0["d_sha"] != s1["d_sha"]
                or s0["replicated_sha"] != s1["replicated_sha"]
                or any(s0["launches"][k] != per_step[k]
                       for k in ("instnorm", "instnorm_bwd"))
                or not all(np.isfinite(v) for v in s0["metrics"].values())):
            raise AssertionError(f"14a GAN ranks: {s0} {s1}")
    if not (gan_d["loss_over"] <= GAN_LOSS_ATOL
            and gan_d["d_dev_max"] <= GAN_FLIP_DEV * lr
            and gan_d["d_flip_share"] < GAN_FLIP_SHARE
            and gan_d["seg_over"] <= GAN_SEG_ATOL):
        raise AssertionError(f"14a GAN vs one process: {gan_d}")
    return out


def tp_dryrun_start():
    """14c: ``smsut_tpu_torch.parallel.dryrun`` (``dryrun_multichip(4)``)
    through ``torch.distributed.run``, four gloo ranks on the one card,
    started: (the process, its start)."""
    return background(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", "-m", "smsut_tpu_torch.parallel.dryrun"]
    ), time.perf_counter()


def tp_dryrun(started, card: str) -> dict:
    """14c's report, once the dry run :func:`tp_dryrun_start` started
    ends."""
    proc, t0 = started
    res = background_wait(proc, DP_TIMEOUT_S)
    out, err = res.stdout, res.stderr
    secs = time.perf_counter() - t0
    line = [x for x in out.splitlines()
            if x.startswith("dryrun_multichip(4): ok")]
    print(f"tp 14c on {card}: {line[-1] if line else 'no report'} "
          f"({secs:.1f} s, four ranks over gloo on the one card, beside "
          f"14a/b/d)", flush=True)
    if proc.returncode or len(line) != 1:
        raise AssertionError(f"14c dryrun_multichip(4) failed "
                             f"({proc.returncode}):\n{out[-2000:]}\n"
                             f"{err[-4000:]}")
    return {"line": line[0], "seconds": secs}


# phase 15: the rest of the zoo on the space axis (dp x sp = 1 x 2): two
# ranks on the one card over gloo, each holding half the rows of every
# image of Mean Teacher's, CPS's, CoraNet's, DTC's and M3L's batches
SPZ_DIR = FIT_DIR / "spz"
SPZ_STEPS = 2             # 15a: each algorithm's eager steps
SPZ_FIT_ITERS = 2         # 15b: each stage's one epoch
SPZ_ZOO = ("meanTeacher", "crossPse", "coraPre", "coraNet", "M3L", "dtc")


def spz_zoo(torch, np, counters, routed) -> tuple:
    """15a's runs, float32, eager, on this process's part of each global
    batch (under the group a rank's rows of every image; in one process
    the whole): Mean Teacher, CPS, CoraNet A and B (w16, 8 + 8, from the
    counts at which every term is live; B's pseudo batch whole, as
    ``make_extra_batch`` draws it) and M3L (the Config defaults) SPZ_STEPS
    steps; DTC w64 with batch norm and ReLU at batch 8, SPZ_STEPS SGD
    steps of its forward and backward.  Per run the metrics averaged over
    the group, and per step the launches (K1's and K4's split forms too)
    and routed calls, the ms, the trees' checksum and sha, with the
    launches and routed calls summed over the steps; M3L's student after
    step 1 and that step's gradient (from Adam's first moment) under
    ``tensors``."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.models.dtc import DTCUNet
    from smsut_tpu_torch.ops.losses import dice_and_ce_loss
    from smsut_tpu_torch.parallel import mesh

    counters = dict(counters, **split_counters())
    mean = lambda v: float(mesh.mean_over_ranks(v.detach().reshape(())))
    counts = lambda: {k: c.launches for k, c in counters.items()}
    rows = lambda v: mesh.space_rows(torch.from_numpy(v).cuda()).contiguous()
    lb, ul, ps = sp_batch(np), ellipse_batch(np, seed=1), \
        ellipse_batch(np, seed=2)
    batch = {"img": rows(lb["img"]), "msk": rows(lb["msk"]),
             "ul_img": rows(ul["img"])}
    pseudo = {"pse_img": torch.from_numpy(ps["img"]).cuda(),
              "pse_lab": torch.from_numpy(ps["msk"]).cuda(),
              "pse_mask": torch.from_numpy((np.random.default_rng(3).random(
                  ps["msk"].shape) < 0.7).astype(np.float32)).cuda()}
    cfg = Config(input_size=256, base_width=16, batch_size=DP_GLOBAL,
                 compute_dtype="float32")
    out, tensors = {}, {}

    def record(r, t0, metrics, trees):
        torch.cuda.synchronize()
        r.setdefault("step_ms", []).append((time.perf_counter() - t0) * 1e3)
        r.setdefault("metrics", []).append(metrics)
        for key, now in (("launches", counts()),
                         ("routed", routed_counts(routed))):
            steps = r.setdefault(f"step_{key}", [])
            steps.append(now)
            r[key] = {k: sum(d[k] for d in steps) for k in now}
        r.setdefault("checksums", []).append(
            sum(tree_checksum(t) for t in trees))
        r.setdefault("shas", []).append([tree_sha(t) for t in trees])

    for name in SPZ_ZOO[:-1]:
        algo = m3l_algo("float32") if name == "M3L" else zoo_algo(name, cfg)
        state = zoo_state(algo, M3L_GATE if name == "M3L"
                          else ZOO_GATE[name])
        inp = dict(batch, **pseudo) if name == "coraNet" else batch
        r = out[name] = {}
        p0 = {n: v.detach().clone() for n, v in state.params.items()}
        for k in range(SPZ_STEPS):
            zero(counters, routed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = algo.train_step(state, inp, algo.epoch_scalars(3))
            record(r, t0, {n: mean(v) for n, v in m.items()},
                   [getattr(state, t) for t in ("params", "ema_params",
                                                "params2")
                    if getattr(state, t) is not None])
            if name == "M3L" and k == 0:
                tensors["m3l_step1"] = {n: v.cpu() for n, v in
                                        state.params.items()}
                tx = state.tx   # m = (1 - b1) (g + wd p0)
                tensors["m3l_grad1"] = {
                    n: (m / (1.0 - tx.b1) - tx.weight_decay * p0[n]).cpu()
                    for n, m in state.opt_state.mu.items()}
        del algo, state, p0
        torch.cuda.empty_cache()
    net = DTCUNet(5, DTC_WIDTH, compute_dtype=torch.float32)
    params = {k: v.detach().clone() for k, v in net.named_parameters()}
    msk = batch["msk"].long()
    r = out["dtc"] = {}
    for _ in range(SPZ_STEPS):
        zero(counters, routed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        tanh, logits = torch.func.functional_call(net, leaves,
                                                  (batch["img"],))
        loss = (dice_and_ce_loss(logits, msk)
                + (tanh - sign_map(msk, tanh.shape[-1])).square().mean())
        grads = mesh.reduce_gradients_(dict(zip(
            leaves, torch.autograd.grad(loss, list(leaves.values())))))
        params = {k: (v - DP_DTC_LR * grads[k]).detach()
                  for k, v in leaves.items()}
        record(r, t0, {"loss": mean(loss)}, [params])
    del net, params, leaves, grads, tanh, logits
    torch.cuda.empty_cache()
    return out, tensors


def spz_rank() -> dict:
    """15a, one rank of two on the one card (gloo, eager, deterministic
    cuDNN; the group from the SMSUT_* variables), dp x sp = 1 x 2:
    :func:`spz_zoo` on the rank's rows (M3L's student after step 1
    written to SPZ_DIR for the parent)."""
    import numpy as np
    import torch
    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.models.segformer import check_rows
    from smsut_tpu_torch.parallel import distributed, mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    cudnn.deterministic = True
    if not distributed.initialize():
        raise AssertionError("no group")
    cfg = Config(input_size=256, base_width=16, batch_size=DP_GLOBAL,
                 compute_dtype="float32", spatial_parallel=SP)
    mesh.check_config(cfg, maps=check_rows)
    mesh.check_config(cfg)
    counters, routed = kernel_counters()
    out, tensors = spz_zoo(torch, np, counters, routed)
    out.update(rank=distributed.process_index(),
               world=distributed.process_count(),
               space=distributed.space_count(), backend=distributed.backend())
    if distributed.is_primary():
        torch.save(tensors, SPZ_DIR / "zoo_rank0.pt")
    torch.distributed.destroy_process_group()
    return out


def spz_spawn() -> list:
    """15a's two ranks, started ahead of the phase (their group's address
    chosen here)."""
    SPZ_DIR.mkdir(parents=True, exist_ok=True)
    port = free_port()
    return [run_child("spz_rank", {
        "SMSUT_COORDINATOR": f"127.0.0.1:{port}",
        "SMSUT_NUM_PROCESSES": str(SP), "SMSUT_PROCESS_ID": str(r)})
        for r in range(SP)]


def spz_two_ranks(torch, np, counters, routed, kids, lr: float) -> dict:
    """15a: the two ranks against one process at the global batch, here,
    under deterministic cuDNN: Mean Teacher, CPS, CoraNet A and B and DTC
    every metric within DP_LOSS_TOL after each step (DTC's relative to
    max(1, |loss|)) and the checksum within DP_SUM_TOL relative after the
    last; M3L 10b's float32 rules on step 1, and its step-1 gradient
    (which Adam's update does not scale with) within DP_SUM_TOL of one
    process's in the tree's checksum and in each leaf's, relative to the
    tree's; the ranks equal to the bit after every step; a rank's
    launches in each step: K1 and K4 as split pairs (each pass one
    process's count in that step), K2 and K5 as one process's, nothing
    routed (M3L launches none).  Raises where one fails."""
    import torch.backends.cudnn as cudnn

    r0, r1 = [child_result(k, go=False) for k in kids]   # told by go()
    det = cudnn.deterministic
    cudnn.deterministic = True
    try:
        one, mine = spz_zoo(torch, np, counters, routed)
    finally:
        cudnn.deterministic = det
    saved = torch.load(SPZ_DIR / "zoo_rank0.pt", weights_only=True)
    out, ok = {}, True
    for name in SPZ_ZOO:
        a, b, w = r0[name], r1[name], one[name]
        scale = (lambda y: max(1.0, abs(y))) if name == "dtc" else \
            (lambda y: 1.0)
        d = out[name] = {
            "loss_err": max(abs(x[n] - y[n]) / scale(y[n])
                            for x, y in zip(a["metrics"], w["metrics"])
                            for n in y),
            "sum_err": abs(a["checksums"][-1] - w["checksums"][-1])
            / max(abs(w["checksums"][-1]), 1.0),
            "ranks_equal": a["shas"] == b["shas"]
            and a["metrics"] == b["metrics"],
            "losses": [x["loss"] for x in a["metrics"]],
            "one_process": [y["loss"] for y in w["metrics"]]}
        d["launches_ok"] = (
            len(a["step_launches"]) == len(w["step_launches"]) == SPZ_STEPS
            and b["step_launches"] == a["step_launches"]
            and not any(v for r in (a, b, w) for v in r["routed"].values()))
        for one_step, rank_step in zip(w["step_launches"],
                                       a["step_launches"]):
            want = {k: one_step.get(k, 0) for k in KERNELS}
            want.update(instnorm=0, instnorm_bwd=0)
            for kind, k in (("fwd", "instnorm"), ("bwd", "instnorm_bwd")):
                for p in ("sums", "apply"):
                    want[f"instance_norm_{kind}_{p}"] = one_step[k]
            got = {k: rank_step[k] for k in want}
            d["launches_ok"] = d["launches_ok"] and got == want and (
                name != "M3L" or not any(got.values()))
        if name == "M3L":
            dev = torch.cat([(saved["m3l_step1"][k] - v).abs().flatten()
                             for k, v in mine["m3l_step1"].items()])
            d["loss_err"] = max(abs(a["metrics"][0][n] - w["metrics"][0][n])
                                / abs(w["metrics"][0][n])
                                for n in ("loss", "semi_loss"))
            d.update(dev_max=float(dev.max()),
                     flip_share=float((dev > lr).float().mean()))
            asum = lambda t: float(t.double().abs().sum())
            sums = {k: (asum(saved["m3l_grad1"][k]), asum(v))
                    for k, v in mine["m3l_grad1"].items()}
            total = sum(x for _, x in sums.values())
            d.update(grad_sum_err=abs(sum(x for x, _ in sums.values())
                                      - total) / total,
                     grad_leaf_err=max(abs(x - y) for x, y in sums.values())
                     / total)
            ok = ok and (d["loss_err"] <= M3L_LOSS_TOL
                         and d["dev_max"] <= GAN_FLIP_DEV * lr
                         and d["flip_share"] < GAN_FLIP_SHARE
                         and total > 0
                         and sorted(saved["m3l_grad1"]) == sorted(sums)
                         and d["grad_sum_err"] <= DP_SUM_TOL
                         and d["grad_leaf_err"] <= DP_SUM_TOL)
        else:
            ok = ok and (d["loss_err"] <= DP_LOSS_TOL
                         and d["sum_err"] <= DP_SUM_TOL)
        ok = ok and d["ranks_equal"] and d["launches_ok"]
        print(f"spz 15a {name}: two ranks (dp x sp = 1 x {SP}, 128 rows a "
              f"rank) vs one process: "
              f"{ {k: v for k, v in d.items() if k != 'one_process'} }; "
              f"one process {[round(x, 6) for x in d['one_process']]}; a "
              f"rank's launches in each step {a['step_launches']}, routed "
              f"{a['routed']}; one process {w['step_launches']}; step ms "
              f"(rank 0, rank 1, "
              f"one process) {[round(x, 1) for x in a['step_ms']]} "
              f"{[round(x, 1) for x in b['step_ms']]} "
              f"{[round(x, 1) for x in w['step_ms']]}", flush=True)
    if not (ok and all(r["backend"] == "gloo" and r["world"] == SP
                       and r["space"] == SP for r in (r0, r1))):
        raise AssertionError(f"15a zoo on the space axis vs one process: "
                             f"{out}")
    return {"ranks": [r0, r1], "one_process": one, "diff": out}


def spz_fit_args(data: Path) -> list:
    """15b's trainer arguments."""
    return fit_args(data, SPZ_DIR / "expr", "spz2", "compute_dtype=float32",
                    "num_workers=2", "pre_epoch=1", "cora_epoch=1",
                    "pred_step=1", f"num_iter_per_epoch={SPZ_FIT_ITERS}")


def spz_fit_cmds(data: Path) -> list:
    """15b's two-rank fits, stage A then B, for :class:`Lane`."""
    return [(f"15b {stage}", [
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", str(SP), "-m",
        "smsut_tpu_torch.trainer.coraNetTrainer", "-p", "train"] + extra
        + spz_fit_args(data) + ["--set", f"spatial_parallel={SP}"])
        for stage, extra in (("A", []), ("B", ["-i", "000"]))]


def spz_fit(torch, data: Path, lane: Lane) -> dict:
    """15b: ``coraNetTrainer -p train --set spatial_parallel=2`` through
    ``torch.distributed.run`` (:func:`spz_fit_cmds`, run by ``lane``), two
    ranks on the one card (gloo, eager), on phase 6's tree, float32: stage
    A (one epoch of SPZ_FIT_ITERS, run 000), then stage B from its
    pre_best (its pseudo-label sweep, one epoch, run 001); then ``-p
    test`` of run 001 here, in one process, from its checkpoint."""
    import numpy as np

    from smsut_tpu_torch.train.cli import make_parser
    from smsut_tpu_torch.trainer import coraNetTrainer

    expr = SPZ_DIR / "expr"
    args = spz_fit_args(data)
    seconds, procs = [], []
    for stage in ("A", "B"):
        proc, secs = lane.result(f"15b {stage}")
        seconds.append(secs)
        procs.append(proc)
        if proc.returncode:
            raise AssertionError(f"torch.distributed.run failed:\n"
                                 f"{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
    run = expr / "spz2"
    logs = sorted(str(p.relative_to(run)) for p in run.rglob("train.log"))
    ckpts = sorted(str(p.relative_to(run)) for p in run.rglob("*.ckpt"))
    text = [(run / i / "train.log").read_text() for i in ("000", "001")]
    k = [log_metrics(t) for t in text]
    plab = [float(x) for x in re.findall(r"Pseudo label dice : ([0-9.eE+-]+)",
                                         text[1])]
    t0 = time.perf_counter()
    coraNetTrainer.main(make_parser().parse_args(
        ["-p", "test", "-i", "001", "-wh", "best"] + args))
    test_s = time.perf_counter() - t0
    csv = np.array([[float(v) for v in r.split(",")] for r in
                    (run / "001" / "all_trois_matrix.csv")
                    .read_text().split("\n") if r])
    out = {"stage_a": k[0], "stage_b": k[1], "plab_dice": plab,
           "logs": logs, "ckpts": ckpts, "train_s": seconds,
           "test_s": test_s, "csv_shape": list(csv.shape),
           "ms_per_iteration": [float(x) * 1e3 / SPZ_FIT_ITERS for t in text
                                for x in re.findall(
                                    r"\[TRN\] Epoch: .*elapsed: "
                                    r"([0-9.]+)s", t)]}
    print(f"spz 15b: coraNetTrainer -p train --set spatial_parallel={SP} "
          f"through torch.distributed.run, float32, stage A then B "
          f"({[round(x, 1) for x in seconds]} s): [TRN] loss "
          f"{k[0]['train/loss']} / {k[1]['train/loss']}, [TST] Dice "
          f"{k[0]['test/dice']} / {k[1]['test/dice']}, pseudo-label Dice "
          f"{plab}; logs {logs}, checkpoints {ckpts}; ms per iteration "
          f"(the log's elapsed over {SPZ_FIT_ITERS}, B's with its sweep) "
          f"{out['ms_per_iteration']}"
          f"; -p test in one process from run 001's checkpoint in "
          f"{test_s:.1f} s, CSV {csv.shape}", flush=True)
    if not (logs == ["000/train.log", "001/train.log"]
            and ckpts == ["000/ckpt/pre_best.ckpt", "000/ckpt/pre_last.ckpt",
                          "001/ckpt/best.ckpt", "001/ckpt/last.ckpt"]
            and all(f"of each image 1/{SP} of its rows" in t
                    and "cannot be captured" in t for t in text)
            and len(plab) == 1 and np.isfinite(plab).all()
            and all(np.isfinite(m["train/loss"]).all() for m in k)
            and csv.shape == (10, 5) and np.isfinite(csv).all()):
        raise AssertionError(f"15b: {out}\n{procs[-1].stdout[-2000:]}\n"
                             f"{procs[-1].stderr[-3000:]}")
    return out


# phase 16: the fused block kernels K3/K6 on the space axis (dp x sp =
# 1 x 2), split at their statistics (ops/block.py split_block_fwd,
# split_block_bwd; csrc/block_split.cu, block_bwd_split.cu), and
# rematerialisation (Config.remat, remat_unet)
SPB_DIR = FIT_DIR / "spb"
SPB_STEPS = 3             # 16a: each model's eager steps
# the split phases' wrappers, forward then backward
SPLIT_BLOCK = ("block_fwd_conv", "block_fwd_finalize", "block_fwd_out",
               "block_bwd_out_sums", "block_bwd_dy2", "block_bwd_conv",
               "block_bwd_dw", "block_bwd_norm1_sums", "block_bwd_dy1")
# 16a: a space rank's launches per U-Net step (w16, block_pallas): its nine
# blocks, all of the shortcut form, each forward 3 convs (conv1, the 1x1,
# conv2), 3 finalize steps and the out pass; each backward the sums, dy2,
# norm 1's sums and dy1 once, 3 convs (dn1, the 1x1 term, dx) and 3 weight
# gradients; the stem's norm as K1's and K4's split pairs; nothing else of
# the port's kernels (the unsplit K3 and K6 not at all)
SPB_UNET = dict({k: 0 for k in KERNELS}, block_fwd_conv=27,
                block_fwd_finalize=27, block_fwd_out=9, block_bwd_out_sums=9,
                block_bwd_dy2=9, block_bwd_conv=27, block_bwd_dw=27,
                block_bwd_norm1_sums=9, block_bwd_dy1=9,
                instance_norm_fwd_sums=1, instance_norm_fwd_apply=1,
                instance_norm_bwd_sums=1, instance_norm_bwd_apply=1)
# 16c: rounds of interleaved timing blocks and the iterations in each
SPB_ROUNDS = 2
SPB_UNITS = {"unet": 10, "gan": 3}
TOL.update({("block_split", d): TOL[("block", d)]
            for d in ("float32", "bfloat16")})
TOL.update({("block_bwd_split", d): TOL[("block_bwd", d)]
            for d in ("float32", "bfloat16")})


def spb_counters() -> dict:
    """{name: the split wrapper whose ``launches`` count}: K3's and K6's
    split phases, K1's and K4's."""
    from smsut_tpu_torch.ops import block

    return dict(split_counters(),
                **{k: getattr(block, k) for k in SPLIT_BLOCK})


def gan_state_tensors(st) -> dict:
    """A GANTrainState's tensors and step, on the host."""
    cpu = lambda t: {k: v.cpu() for k, v in t.items()}
    return {"g_params": cpu(st.g_params), "g_opt_state": cpu(st.g_opt_state),
            "d_params": cpu(st.d_params), "d_mu": cpu(st.d_opt_state.mu),
            "d_nu": cpu(st.d_opt_state.nu),
            "d_count": st.d_opt_state.count.cpu(), "count": st.count.cpu(),
            "step": st.step}


def load_gan_state(st, saved: dict) -> None:
    """Copy :func:`gan_state_tensors`'s ``saved`` into the state ``st``."""
    for tree, into in (("g_params", st.g_params),
                       ("g_opt_state", st.g_opt_state),
                       ("d_params", st.d_params),
                       ("d_mu", st.d_opt_state.mu),
                       ("d_nu", st.d_opt_state.nu)):
        for k, v in saved[tree].items():
            into[k].copy_(v)
    st.d_opt_state.count.copy_(saved["d_count"])
    st.count.copy_(saved["count"])
    st.step = saved["step"]


def spb_models(torch, np, counters, routed, gan_from=None) -> tuple:
    """16a's runs, float32, eager, on this process's part of each global
    batch (under the group a rank's rows of every image; in one process
    the whole), ``block_pallas`` on: the U-Net (w16, global batch 8) and
    ``uganConsis`` (8 + 8, the gate open, the draws made once for every
    step, alike on every rank), SPB_STEPS steps each; with ``gan_from``
    (a rank's GAN states after each step) each GAN step after the first
    starts from the rank's state after the step before.  Per step the
    metrics averaged over the group, the launches (the split phases' too)
    and routed calls, the ms, the trees' checksum and sha; the GAN's
    states after each step under ``tensors``."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.parallel import mesh
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    counters = dict(counters, **spb_counters())
    mean = lambda v: float(mesh.mean_over_ranks(v.detach().reshape(())))
    rows = lambda t: mesh.space_rows(t).contiguous()
    cfg = Config(input_size=256, base_width=16, batch_size=DP_GLOBAL,
                 compute_dtype="float32", consis_gate_step=0,
                 block_pallas=True)
    out, tensors = {}, {}

    def steps(name, algo, state, batch, extras, scal):
        r = out[name] = {}
        for k in range(SPB_STEPS):
            if name == "gan" and gan_from is not None and k > 0:
                load_gan_state(state, gan_from[k - 1])
            zero(counters, routed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = algo.train_step(state, dict(batch, **extras[k]),
                                       scal)
            torch.cuda.synchronize()
            r.setdefault("step_ms", []).append(
                (time.perf_counter() - t0) * 1e3)
            r.setdefault("metrics", []).append({n: mean(v)
                                                for n, v in m.items()})
            r.setdefault("step_launches", []).append(
                {n: c.launches for n, c in counters.items()})
            r.setdefault("step_routed", []).append(routed_counts(routed))
            trees = [getattr(state, t) for t in ("params", "g_params",
                                                 "d_params")
                     if getattr(state, t, None) is not None]
            r.setdefault("checksums", []).append(
                sum(tree_checksum(t) for t in trees))
            r.setdefault("shas", []).append([tree_sha(t) for t in trees])
            if name == "gan":
                tensors.setdefault("gan", []).append(
                    gan_state_tensors(state))
        for key in ("launches", "routed"):
            steps_ = r[f"step_{key}"]
            r[key] = {n: sum(s[n] for s in steps_) for n in steps_[0]}
        return state

    unet = SupervisedUNet(cfg)
    batch = {k: rows(torch.from_numpy(v).cuda())
             for k, v in sp_batch(np).items()}
    steps("unet", unet, unet.init_state(0), batch, [{}] * SPB_STEPS, None)
    del unet
    gan = UGANConsisAlgo(cfg)
    gb = {k: rows(v) if torch.is_tensor(v) else v
          for k, v in gan_batch(torch, np).items()}
    extras = [gan.make_extra_batch() for _ in range(SPB_STEPS)]
    steps("gan", gan, gan.init_state(0), gb, extras, gan.epoch_scalars(1))
    del gan
    torch.cuda.empty_cache()
    return out, tensors


def spb_rank() -> dict:
    """16a, one rank of two on the one card (gloo, eager, deterministic
    cuDNN; the group from the SMSUT_* variables), dp x sp = 1 x 2:
    :func:`spb_models` on the rank's rows (the GAN's states after each step
    written to SPB_DIR for the parent)."""
    import numpy as np
    import torch
    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.parallel import distributed, mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    cudnn.deterministic = True
    if not distributed.initialize():
        raise AssertionError("no group")
    mesh.check_config(Config(input_size=256, base_width=16,
                             batch_size=DP_GLOBAL, block_pallas=True,
                             spatial_parallel=SP), gan=True)
    counters, routed = kernel_counters()
    out, tensors = spb_models(torch, np, counters, routed)
    out.update(rank=distributed.process_index(),
               world=distributed.process_count(),
               space=distributed.space_count(), backend=distributed.backend())
    if distributed.is_primary():
        torch.save(tensors["gan"], SPB_DIR / "gan_rank0.pt")
    torch.distributed.destroy_process_group()
    return out


def spb_spawn() -> list:
    """16a's two ranks, started ahead of the phase (their group's address
    chosen here), and 16c's child (:func:`spb_remat`)."""
    SPB_DIR.mkdir(parents=True, exist_ok=True)
    port = free_port()
    return [run_child("spb_rank", {
        "SMSUT_COORDINATOR": f"127.0.0.1:{port}",
        "SMSUT_NUM_PROCESSES": str(SP), "SMSUT_PROCESS_ID": str(r)})
        for r in range(SP)] + [run_child("spb_remat")]


def spb_launches_ok(name: str, got: dict, one: dict) -> bool:
    """A space rank's launches in one step of ``name`` against the
    prediction: the U-Net's SPB_UNET; uganConsis's from one process's
    step (``one``): K3's out pass once per unsplit K3 launch and K6's
    sums, dy2, norm 1's sums and dy1 once per unsplit K6 launch, two or
    three convs and as many finalize steps (weight gradients) a block,
    K1 and K4 as split pairs of one process's counts, K2 and K5 as one
    process's, the unsplit K1-K6 none."""
    if name == "unet":
        return {k: got.get(k, 0) for k in SPB_UNET} == SPB_UNET
    fwd, bwd = one["block"], one["block_bwd"]
    return (fwd > 0 and bwd > 0
            and got["block_fwd_out"] == fwd
            and got["block_fwd_conv"] == got["block_fwd_finalize"]
            and 2 * fwd <= got["block_fwd_conv"] <= 3 * fwd
            and all(got[k] == bwd for k in (
                "block_bwd_out_sums", "block_bwd_dy2",
                "block_bwd_norm1_sums", "block_bwd_dy1"))
            and got["block_bwd_conv"] == got["block_bwd_dw"]
            and 2 * bwd <= got["block_bwd_dw"] <= 3 * bwd
            and all(got[f"instance_norm_{kind}_{p}"] == one[k]
                    for kind, k in (("fwd", "instnorm"),
                                    ("bwd", "instnorm_bwd"))
                    for p in ("sums", "apply"))
            and got["conv3x3"] == one["conv3x3"]
            and got["conv3x3_dw"] == one["conv3x3_dw"]
            and not any(got[k] for k in ("instnorm", "instnorm_bwd",
                                         "block", "block_bwd")))


def spb_two_ranks(torch, np, counters, routed, kids, lr: float) -> dict:
    """16a: the two ranks against one process at the global batch, here,
    under deterministic cuDNN.  The U-Net: every step's loss within
    DP_LOSS_TOL, the checksum within DP_SUM_TOL relative after the last
    (13b's bounds); uganConsis: every step under 7b's rules (D
    flip-aware), each from one state, as 8b holds its steps: the first
    from the init, each later one from rank 0's state after the step
    before (Adam's first sign steps part two float32 runs of D, and the
    parts grow through D's scores, whatever the split); the ranks equal to
    the bit after every step; each step's launches as
    :func:`spb_launches_ok` predicts, the routed calls one process's (the
    U-Net none, the GAN its ``conv_src``).  Raises where one fails."""
    import types

    import torch.backends.cudnn as cudnn

    r0, r1 = [child_result(k, go=False) for k in kids]   # told by go()
    saved = torch.load(SPB_DIR / "gan_rank0.pt", weights_only=True)
    det = cudnn.deterministic
    cudnn.deterministic = True
    try:
        one, mine = spb_models(torch, np, counters, routed, saved)
    finally:
        cudnn.deterministic = det
    ns = lambda t: types.SimpleNamespace(**{k: {n: v.cuda() for n, v in
                                                  t[k].items()}
                                            for k in ("g_params",
                                                      "d_params")})
    out, ok = {}, True
    for name in ("unet", "gan"):
        a, b, w = r0[name], r1[name], one[name]
        d = out[name] = {
            "ranks_equal": a["shas"] == b["shas"]
            and a["metrics"] == b["metrics"],
            "sum_err": abs(a["checksums"][-1] - w["checksums"][-1])
            / max(abs(w["checksums"][-1]), 1.0)}
        d["launches_ok"] = (
            b["step_launches"] == a["step_launches"]
            and all(spb_launches_ok(name, g, o) for g, o in zip(
                a["step_launches"], w["step_launches"]))
            and a["step_routed"] == w["step_routed"]
            and (name == "gan" or not any(a["routed"].values())))
        if name == "unet":
            d["loss_err"] = max(abs(x["loss"] - y["loss"]) for x, y in
                                zip(a["metrics"], w["metrics"]))
            ok = ok and (d["loss_err"] <= DP_LOSS_TOL
                         and d["sum_err"] <= DP_SUM_TOL)
        else:
            d["steps"] = [gan_step_against(torch, (x, ns(sa)), (y, ns(sm)),
                                           lr)
                          for x, y, sa, sm in zip(a["metrics"],
                                                  w["metrics"], saved,
                                                  mine["gan"])]
            ok = ok and len(d["steps"]) == SPB_STEPS and all(
                s1["loss_over"] <= GAN_LOSS_ATOL
                and s1["d_dev_max"] <= GAN_FLIP_DEV * lr
                and s1["d_flip_share"] < GAN_FLIP_SHARE
                and s1["seg_over"] <= GAN_SEG_ATOL for s1 in d["steps"])
        ok = ok and d["ranks_equal"] and d["launches_ok"]
        print(f"spb 16a {name} block_pallas=True: two ranks (dp x sp = 1 x "
              f"{SP}, 128 rows a rank, K3/K6 split at their statistics) vs "
              f"one process: {d}; losses "
              f"{[round(x.get('loss', x.get('G_seg', 0.0)), 6) for x in a['metrics']]}"
              f" vs {[round(y.get('loss', y.get('G_seg', 0.0)), 6) for y in w['metrics']]}"
              f"; a rank's launches per step "
              f"{ {k: v for k, v in a['step_launches'][0].items() if v} }; "
              f"one process per step "
              f"{ {k: v for k, v in w['step_launches'][0].items() if v} }; "
              f"step ms (rank 0, rank 1, one process) "
              f"{[round(x, 1) for x in a['step_ms']]} "
              f"{[round(x, 1) for x in b['step_ms']]} "
              f"{[round(x, 1) for x in w['step_ms']]}", flush=True)
    if not (ok and all(r["backend"] == "gloo" and r["world"] == SP
                       and r["space"] == SP for r in (r0, r1))):
        raise AssertionError(f"16a fused blocks on the space axis vs one "
                             f"process: {out}")
    return {"ranks": [r0, r1], "one_process": one, "diff": out}


def split_block_phases(torch, ops, block) -> list:
    """16b: each split phase of K3 and K6 against its plain twin
    (``record``: phase 2's bounds for K3 and K6), bfloat16, at the
    heaviest shape, [8, 256, 256, 32] -> 16 (shortcut form) and
    [8, 256, 256, 16] -> 16 (identity form), on the top rank's 128 rows of
    two: x with a zero row above (the image's edge) and the next rank's
    first row below, y1 with that rank's row below only (the one-sided
    halo), the cotangents with theirs; the group's sums are the rank's
    twice.  Returns the rows."""
    from smsut_tpu_torch.ops.conv3x3 import flip_io

    rows = []
    cases = Cases(torch, seed=16)
    dt, dn, isz = torch.bfloat16, "bfloat16", 2
    b, h, w = 8, 128, 256
    n = SP * h * w
    for ci, co in ((32, 16), (16, 16)):
        short = ci != co
        form = "shortcut" if short else "identity"
        label = f"{form} {[b, h, w, ci]}->{co}"
        x, w1, s1, b1, w2, s2, b2, ws, ss, bs = cases.block_args(
            b, h, w, ci, co, dt)
        row = lambda c: cases.randn(b, 1, w, c, dtype=dt)
        xh = torch.cat([torch.zeros_like(x[:, :1]), x, row(ci)], 1)
        _, res = block.split_block_fwd(x, w1, s1, b1, w2, s2, b2, ws, ss,
                                       bs, save=True, kernel=True)
        y1h = torch.cat([res.y1, row(co)], 1)
        g = cases.randn(b, h, w, co, dtype=dt)
        idn = res.u if short else x
        sc = block.bwd_split_scratch(x, co, short)
        sums1 = block.block_fwd_conv(0, xh, w1, None, h, 1)[1] * 2
        gh1 = block.block_fwd_finalize(sums1, n, s1, b1)[0]
        sums_o = block.block_bwd_out_sums(g, res.y2, idn, res.gh, res.st,
                                          short, sc)[0] * 2
        dy2, dq = block.block_bwd_dy2(g, res.y2, idn, res.gh, res.st, s2,
                                      ss, sums_o, n)
        halo = lambda t: torch.cat([torch.zeros_like(t[:, :1]), t,
                                    cases.randn(b, 1, w, t.shape[-1],
                                                dtype=dt)], 1)
        dy2h = halo(dy2)
        dn1 = block.block_bwd_conv(0, dy2h, flip_io(w2), h, 1, res.y1,
                                   res.gh[0])
        sums_n1 = block.block_bwd_norm1_sums(res.y1, dn1, res.st, s1,
                                             sc)[0] * 2
        dy1 = block.block_bwd_dy1(res.y1, dn1, res.st, s1, sums_n1, n)
        side = block.block_bwd_conv(1, dq, flip_io(ws), h, 0) if short \
            else dq
        m = b * h * w
        conv = lambda c_in, c_out, k: 2 * m * k * k * c_in * c_out
        maps = lambda *cs: m * sum(cs) * isz
        cores = {"finalize", "out", "out_sums", "dy2", "norm1_sums", "dy1"}
        cases_ = [
            ("block_split", "conv1", block.block_fwd_conv,
             (0, xh, w1, None, h, 1), conv(ci, co, 3), maps(ci, co)),
            ("block_split", "finalize", block.block_fwd_finalize,
             (sums1, n, s1, b1), 4 * b * co, 4 * 8 * b * co),
            ("block_split", "conv2", block.block_fwd_conv,
             (1, y1h, w2, gh1, h, 0), conv(co, co, 3), maps(co, co)),
            ("block_split", "out", block.block_fwd_out,
             (res.y2, res.gh[1], idn, res.gh[2] if short else None),
             6 * m * co, maps(co, co, co)),
            ("block_bwd_split", "out_sums", block.block_bwd_out_sums,
             (g, res.y2, idn, res.gh, res.st, short, sc), 12 * m * co,
             maps(co, co, co)),
            ("block_bwd_split", "dy2", block.block_bwd_dy2,
             (g, res.y2, idn, res.gh, res.st, s2, ss, sums_o, n),
             16 * m * co, maps(co, co, co, co) + (m * co * (isz if short
                                                             else 4))),
            ("block_bwd_split", "dn1", block.block_bwd_conv,
             (0, dy2h, flip_io(w2), h, 1, res.y1, res.gh[0]),
             conv(co, co, 3), maps(co, co, co)),
            ("block_bwd_split", "dw2", block.block_bwd_dw,
             (0, y1h, dy2, res.gh[0], 0, sc), conv(co, co, 3),
             maps(co, co)),
            ("block_bwd_split", "norm1_sums", block.block_bwd_norm1_sums,
             (res.y1, dn1, res.st, s1, sc), 8 * m * co, maps(co, co)),
            ("block_bwd_split", "dy1", block.block_bwd_dy1,
             (res.y1, dn1, res.st, s1, sums_n1, n), 10 * m * co,
             maps(co, co, co)),
            ("block_bwd_split", "dw1", block.block_bwd_dw,
             (1, xh, dy1, None, 1, sc), conv(ci, co, 3), maps(ci, co)),
            ("block_bwd_split", "dx", block.block_bwd_conv,
             (2, halo(dy1), flip_io(w1), h, 1, side), conv(co, ci, 3),
             maps(co, ci) + m * ci * 4)]
        if short:
            cases_ += [
                ("block_split", "shortcut", block.block_fwd_conv,
                 (2, x, ws, None, h, 0), conv(ci, co, 1), maps(ci, co)),
                ("block_bwd_split", "dws", block.block_bwd_dw,
                 (2, x, dq, None, 0, sc), conv(ci, co, 1), maps(ci, co)),
                ("block_bwd_split", "side", block.block_bwd_conv,
                 (1, dq, flip_io(ws), h, 0), conv(co, ci, 1),
                 maps(co) + m * ci * 4)]
        for name, phase, fn, args, flops, nbytes in cases_:
            record(torch, ops, rows, name, f"{phase} {label}", dn, fn, args,
                   None, flops=flops, nbytes=nbytes, iters=10,
                   peak=PEAK_F32_CORES if phase in cores else None,
                   extra={"phase": phase})
    return rows


def spb_remat() -> dict:
    """16c, in a child process of its own (its profiler sessions, and its
    peak memory, its own): the U-Net's (both block modes: fused, K3 runs
    again in the backward) and uganConsis's replayed iterations (w16,
    256^2, batch 8, uganConsis 8 + 8 with the gate open) with remat off
    and on (``remat_unet`` for the U-Net, ``remat`` for the GAN), in
    float32 and bfloat16 under deterministic cuDNN: the metrics
    of 3 iterations from one init, equal to the bit in float32; the peak
    memory allocated over those 3 beyond the state's; host ms per
    iteration, off and on in interleaved blocks (SPB_ROUNDS rounds of
    SPB_UNITS); the profiler's device ms and kernels per iteration; the
    port's launches per replay."""
    import numpy as np
    import torch
    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.tools.profile_step import iteration
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    cudnn.deterministic = True
    counters, routed = kernel_counters()
    out = {}
    for name in ("unet", "unet_fused", "gan"):
        for dtn in ("float32", "bfloat16"):
            runs, res = {}, {}
            for remat in (False, True):
                cfg = Config(input_size=256, base_width=16, batch_size=8,
                             compute_dtype=dtn, consis_gate_step=0,
                             remat=remat, remat_unet=remat,
                             block_pallas=name == "unet_fused")
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                if name != "gan":
                    algo = SupervisedUNet(cfg)
                    inp = algo.inputs({k: torch.from_numpy(v).cuda() for k, v
                                       in ellipse_batch(np).items()})
                    scal = None
                else:
                    algo = UGANConsisAlgo(cfg)
                    inp = algo.inputs(dict(gan_batch(torch, np),
                                           **algo.make_extra_batch()))
                    scal = {"lambda_semi": torch.tensor(1.0, device="cuda")}
                state = algo.init_state(0)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                run = iteration(algo, state, inp, scal, capture=True)
                metrics = []
                for _ in range(3):
                    zero(counters, routed)
                    m = run()
                    metrics.append({k: float(v) for k, v in m.items()})
                launched = {k: c.launches for k, c in counters.items()}
                torch.cuda.synchronize()
                runs[remat] = run
                res[remat] = {"metrics": metrics, "launches": launched,
                              "peak_mib": (torch.cuda.max_memory_allocated()
                                           - base) / 2 ** 20}
            units = SPB_UNITS[name.split("_")[0]]
            t = timed_blocks(torch, runs, units, SPB_ROUNDS)
            for remat in (False, True):
                prof = profile_device(torch, runs[remat],
                                      n=1 if name == "gan" else 2)
                res[remat].update(host=t[remat], device_ms=prof["device_ms"],
                                  kernels=prof["kernels_per_call"])
            res["bitwise"] = res[False]["metrics"] == res[True]["metrics"]
            out[f"{name} {dtn}"] = {str(k): v for k, v in res.items()}
            del runs, algo, state, run
            torch.cuda.empty_cache()
    return out


def spb_remat_check(kid, card: str) -> dict:
    """16c's results from its child, printed and checked: float32 off and
    on equal to the bit, every metric finite, remat lowering the peak
    memory, its replay launching more of the port's kernels (the towers'
    second forward)."""
    import numpy as np

    res = child_result(kid)
    ok = True
    for key, r in res.items():
        off, on = r["False"], r["True"]
        f32 = key.endswith("float32")
        finite = all(np.isfinite(list(m.values())).all()
                     for m in off["metrics"] + on["metrics"])
        more = {k: on["launches"][k] - off["launches"][k]
                for k in off["launches"]
                if on["launches"][k] != off["launches"][k]}
        ok = ok and finite and (r["bitwise"] or not f32) and (
            on["peak_mib"] < off["peak_mib"]) and bool(more) and all(
            v > 0 for v in more.values())
        print(f"spb 16c {key} on {card}: remat off / on, 3 replayed "
              f"iterations from one init: metrics equal to the bit "
              f"{r['bitwise']}; peak memory beyond the state "
              f"{off['peak_mib']:.1f} / {on['peak_mib']:.1f} MiB; host ms "
              f"per iteration (median, quartiles) "
              f"{off['host']['median_ms']:.3f} "
              f"({off['host']['q1_ms']:.3f}-{off['host']['q3_ms']:.3f}) / "
              f"{on['host']['median_ms']:.3f} "
              f"({on['host']['q1_ms']:.3f}-{on['host']['q3_ms']:.3f}); "
              f"device ms {off['device_ms']:.3f} / {on['device_ms']:.3f}; "
              f"kernels {off['kernels']} / {on['kernels']}; the port's "
              f"launches remat adds per iteration {more}", flush=True)
    if not ok:
        raise AssertionError(f"16c remat off vs on: {res}")
    return res


# phase 17: the semi-supervised zoo on the model axis (dp x tp = 1 x 2):
# two ranks on the one card over gloo, each holding the output-channel
# shards of every eligible weight of Mean Teacher's, CPS's, CoraNet's,
# M3L's and DTC's states (the EMA teacher, the second net, the optimizer
# state alike)
TPZ_DIR = FIT_DIR / "tpz"
TPZ_STEPS = 2             # 17a: each algorithm's eager steps
# 17a's runs: the zoo at w16 unfused, Mean Teacher again with
# block_pallas (K3/K6 on every block's gathered weights), M3L at its
# defaults, DTC w64 with batch norm
TPZ_ZOO = ("meanTeacher", "crossPse", "coraPre", "coraNet", "M3L", "dtc",
           "meanTeacherFused")
TPZ_EVAL = ("meanTeacher", "crossPse", "coraNet", "M3L")
# 17a: eval logits, a model rank's against one process's, relative to
# max(1, max |logit|)
TPZ_EVAL_TOL = 1e-4
# 17b: the pseudo sweep's images (two chunks of 8, the second padded), and
# the top-two margin of one process's logits beyond which the ranks'
# labels must equal its own
TPZ_SWEEP, TPZ_MARGIN = 12, 1e-3
# a model rank's forward of the w16 U-Net (phase 14's shards): unfused,
# the 256^2 level's 4 convs of Cout 8 shards routed; fused, K3 on every
# block's gathered weights
PER_FORWARD_TP = {False: {"instnorm": 28, "conv3x3": 14, "block": 0},
                  True: dict(PER_FORWARD[True])}


def tpz_per_step(name: str) -> tuple:
    """A model rank's (launches, routed calls) per iteration of zoo run
    ``name``: each student step one U-Net step of phase 14's, each teacher
    forward a forward (:data:`ZOO_APPLIES`); M3L none (DTC: one process's
    count, checked apart)."""
    fused = name.endswith("Fused")
    base = name[:-len("Fused")] if fused else name
    if base not in ZOO_APPLIES:
        return ({k: 0 for k in KERNELS},
                {k: 0 for k in ROUTED_TP[False]})
    n_step, n_fwd = ZOO_APPLIES[base]
    s, f = PER_STEP_TP[fused], PER_FORWARD_TP[fused]
    return ({k: n_step * s.get(k, 0) + n_fwd * f.get(k, 0) for k in KERNELS},
            {k: (n_step + n_fwd) * v for k, v in ROUTED_TP[fused].items()})


def tpz_zoo(torch, np, counters, routed, layout=None) -> tuple:
    """17a's runs, float32, eager, at the global batch, on the states
    sharded over ``layout`` (whole in one process): each of
    :data:`TPZ_ZOO` TPZ_STEPS steps (Mean Teacher, CPS, CoraNet A and B
    at w16, 8 + 8, from the counts at which every term is live, B's pseudo
    batch on every rank; M3L at the Config defaults; DTC w64 with batch
    norm and ReLU at batch 8, SGD on its forward and backward), then each
    of :data:`TPZ_EVAL`'s ``eval_fn`` on its initial weights.  Per run
    the metrics averaged over the group and per step the launches, routed
    calls, ms, the whole trees' checksum and sha; under ``layout`` M3L's
    state saved after its steps (``save_state``, TPZ_DIR) and one more
    step (``next``).  ``tensors``: M3L's student after step 1 and that
    step's gradient (from Adam's first moment), the eval logits."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.models.dtc import DTCUNet
    from smsut_tpu_torch.ops.losses import dice_and_ce_loss
    from smsut_tpu_torch.parallel import mesh
    from smsut_tpu_torch.train import checkpoints

    shard = ((lambda t: t) if layout is None
             else (lambda t: mesh.shard_params_channelwise(layout, t)))
    mean = lambda v: float(mesh.mean_over_ranks(v.detach().reshape(())))
    counts = lambda: {k: c.launches for k, c in counters.items()}
    cuda = lambda v: torch.from_numpy(v).cuda()
    lb, ul, ps = dp_batch(np), ellipse_batch(np, seed=1), \
        ellipse_batch(np, seed=2)
    batch = {"img": cuda(lb["img"]), "msk": cuda(lb["msk"]),
             "ul_img": cuda(ul["img"])}
    pseudo = {"pse_img": cuda(ps["img"]), "pse_lab": cuda(ps["msk"]),
              "pse_mask": cuda((np.random.default_rng(3).random(
                  ps["msk"].shape) < 0.7).astype(np.float32))}
    out, tensors = {}, {}

    def whole(state) -> list:
        return [mesh.gather_tree(getattr(state, t), state.shards)
                for t in ("params", "ema_params", "params2")
                if getattr(state, t) is not None]

    def record(r, t0, metrics, trees):
        torch.cuda.synchronize()
        r.setdefault("step_ms", []).append((time.perf_counter() - t0) * 1e3)
        r.setdefault("metrics", []).append(metrics)
        r.setdefault("step_launches", []).append(counts())
        r.setdefault("step_routed", []).append(routed_counts(routed))
        r.setdefault("checksums", []).append(
            sum(tree_checksum(t) for t in trees))
        r.setdefault("shas", []).append([tree_sha(t) for t in trees])

    for name in TPZ_ZOO:
        if name == "dtc":
            continue
        fused = name.endswith("Fused")
        base = name[:-len("Fused")] if fused else name
        cfg = Config(input_size=256, base_width=16, batch_size=DP_GLOBAL,
                     compute_dtype="float32", block_pallas=fused)
        algo = m3l_algo("float32") if base == "M3L" else zoo_algo(base, cfg)
        state = shard(zoo_state(algo, M3L_GATE if base == "M3L"
                                else ZOO_GATE[base]))
        inp = dict(batch, **pseudo) if base == "coraNet" else batch
        scal = algo.epoch_scalars(3)
        r = out[name] = {"shards": len(state.shards)}
        p0 = mesh.gather_tree(state.params, state.shards)
        p0 = {n: v.detach().clone() for n, v in p0.items()}
        for k in range(TPZ_STEPS):
            zero(counters, routed)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = algo.train_step(state, inp, scal)
            record(r, t0, {n: mean(v) for n, v in m.items()}, whole(state))
            if base == "M3L" and k == 0:
                tensors["m3l_step1"] = {n: v.cpu() for n, v in
                                        whole(state)[0].items()}
                tx = state.tx   # m = (1 - b1) (g + wd p0)
                mu = mesh.gather_tree(state.opt_state.mu, state.shards)
                tensors["m3l_grad1"] = {
                    n: (v / (1.0 - tx.b1) - tx.weight_decay * p0[n]).cpu()
                    for n, v in mu.items()}
        if base == "M3L" and layout is not None:
            # 17b: the state written whole by rank 0, then one more step
            checkpoints.save_state(state, str(TPZ_DIR), "m3l")
            state, m = algo.train_step(state, inp, scal)
            r["next"] = {n: mean(v) for n, v in m.items()}
        del algo, state, p0
        torch.cuda.empty_cache()
    net = DTCUNet(5, DTC_WIDTH, compute_dtype=torch.float32)
    params = {k: v.detach().clone() for k, v in net.named_parameters()}
    shards = (frozenset() if layout is None else mesh.sharded_keys(
        {k: v.shape for k, v in params.items()}, TP))
    params = shard(params)
    msk = batch["msk"].long()
    r = out["dtc"] = {"shards": len(shards)}
    for _ in range(TPZ_STEPS):
        zero(counters, routed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        leaves = {k: v.requires_grad_() for k, v in params.items()}
        tanh, logits = torch.func.functional_call(net, leaves,
                                                  (batch["img"],))
        loss = (dice_and_ce_loss(logits, msk)
                + (tanh - sign_map(msk, tanh.shape[-1])).square().mean())
        grads = mesh.reduce_gradients_(dict(zip(
            leaves, torch.autograd.grad(loss, list(leaves.values())))),
            shards)
        params = {k: (v - DP_DTC_LR * grads[k]).detach()
                  for k, v in leaves.items()}
        record(r, t0, {"loss": mean(loss)}, [mesh.gather_tree(params,
                                                              shards)])
    del net, params, leaves, grads, tanh, logits
    torch.cuda.empty_cache()
    cfg = Config(input_size=256, base_width=16, batch_size=DP_GLOBAL,
                 compute_dtype="float32")
    for name in TPZ_EVAL:
        algo = m3l_algo("float32") if name == "M3L" else zoo_algo(name, cfg)
        logits = algo.eval_fn(shard(algo.init_params(0)), batch["img"])
        tensors[f"eval_{name}"] = logits.cpu()
        out.setdefault("eval_sha", {})[name] = tree_sha({"l": logits})
        del algo, logits
    torch.cuda.empty_cache()
    return out, tensors


def tpz_sweep_samples(np) -> list:
    """17b's unlabelled stream: TPZ_SWEEP whole ellipse images with their
    labels, ``(img [H,W,1], lab [H,W], mdl)``."""
    b = [ellipse_batch(np, seed=s) for s in (4, 5)]
    img = np.concatenate([x["img"] for x in b])[:TPZ_SWEEP]
    lab = np.concatenate([x["msk"] for x in b])[:TPZ_SWEEP]
    return [(img[i], lab[i].astype(np.int64), 1) for i in range(TPZ_SWEEP)]


def tpz_sweep(torch, np, layout=None) -> tuple:
    """17b: CoraNet B's pseudo-label sweep (``pred_unlabel``, eager, in
    chunks of 8) of :func:`tpz_sweep_samples` with the initial weights
    sharded over ``layout``: (its Dice, the labels and agreement mask)."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.parallel import mesh

    algo = zoo_algo("coraNet", Config(input_size=256, base_width=16,
                                      batch_size=DP_GLOBAL,
                                      compute_dtype="float32"))
    state = algo.init_state(0)
    if layout is not None:
        state = mesh.shard_params_channelwise(layout, state)
    data, dice = algo.pred_unlabel(state, iter(tpz_sweep_samples(np)),
                                   capture=False)
    return dice, {k: torch.from_numpy(data[k]) for k in ("plab", "mask")}


def tpz_rank() -> dict:
    """17a and 17b's ranks, one of two on the one card (gloo, eager,
    deterministic cuDNN; the group from the SMSUT_* variables) laid out as
    dp x tp = 1 x 2: :func:`tpz_zoo` and :func:`tpz_sweep` on the sharded
    states (rank 0's tensors written to TPZ_DIR for the parent)."""
    import numpy as np
    import torch
    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.parallel import distributed, mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    cudnn.allow_tf32 = False
    cudnn.deterministic = True
    if not distributed.initialize():
        raise AssertionError("no group")
    layout = mesh.make_mesh_2d(1, TP)
    counters, routed = kernel_counters()
    out, tensors = tpz_zoo(torch, np, counters, routed, layout)
    t0 = time.perf_counter()
    dice, labels = tpz_sweep(torch, np, layout)
    out["sweep"] = {"dice": dice, "sha": tree_sha(labels),
                    "s": time.perf_counter() - t0}
    out.update(rank=distributed.process_index(),
               world=distributed.process_count(),
               model=distributed.model_count(), backend=distributed.backend())
    if distributed.is_primary():
        torch.save(dict(tensors, sweep=labels), TPZ_DIR / "zoo_rank0.pt")
    torch.distributed.destroy_process_group()
    return out


def tpz_spawn() -> list:
    """17a's two ranks, started ahead of the phase (their group's address
    chosen here)."""
    TPZ_DIR.mkdir(parents=True, exist_ok=True)
    port = free_port()
    return [run_child("tpz_rank", {
        "SMSUT_COORDINATOR": f"127.0.0.1:{port}",
        "SMSUT_NUM_PROCESSES": str(TP), "SMSUT_PROCESS_ID": str(r)})
        for r in range(TP)]


def go(kids: list) -> None:
    """Children of :func:`run_child` told to run, all before any is read
    (a group's ranks wait for each other); their results are read later
    with ``child_result(kid, go=False)``."""
    for proc, _ in kids:
        proc.stdin.write("go\n")
        proc.stdin.flush()


def tpz_collect(kids: list) -> list:
    """The results of 17a's ranks, told to run by :func:`go`."""
    return [child_result(k, go=False) for k in kids]


def tpz_check_run(name: str, a: dict, b: dict, w: dict, mine: dict,
                  saved: dict, lr: float) -> tuple:
    """One of 17a's runs, rank 0 ``a`` and rank 1 ``b`` against one
    process ``w``: (its figures, whether it passes).  11b's bounds (each
    metric within DP_LOSS_TOL, DTC's relative to max(1, |loss|), the
    checksum within DP_SUM_TOL relative after the last step); M3L 10b's
    float32 rules on step 1 and its step-1 gradient within DP_SUM_TOL of
    one process's in the tree's checksum and in each leaf's; the ranks
    equal to the bit after every step; a rank's launches and routed calls
    in each step :func:`tpz_per_step`'s (DTC's one process's, nothing
    routed)."""
    import torch

    scale = (lambda y: max(1.0, abs(y))) if name == "dtc" else \
        (lambda y: 1.0)
    d = {"loss_err": max(abs(x[n] - y[n]) / scale(y[n])
                         for x, y in zip(a["metrics"], w["metrics"])
                         for n in y),
         "sum_err": abs(a["checksums"][-1] - w["checksums"][-1])
         / max(abs(w["checksums"][-1]), 1.0),
         "ranks_equal": a["shas"] == b["shas"]
         and a["metrics"] == b["metrics"],
         "shards": a["shards"],
         "losses": [x["loss"] for x in a["metrics"]],
         "one_process": [y["loss"] for y in w["metrics"]]}
    if name == "dtc":
        want = ({k: w["step_launches"][0].get(k, 0) for k in KERNELS},
                {k: 0 for k in ROUTED_TP[False]})
    else:
        want = tpz_per_step(name)
    d["launches_ok"] = (
        len(a["step_launches"]) == TPZ_STEPS
        and all(s == want[0] for s in a["step_launches"])
        and all(s == want[1] for s in a["step_routed"])
        and b["step_launches"] == a["step_launches"]
        and b["step_routed"] == a["step_routed"] and a["shards"] > 0)
    ok = d["ranks_equal"] and d["launches_ok"]
    if name == "M3L":
        dev = torch.cat([(saved["m3l_step1"][k] - v).abs().flatten()
                         for k, v in mine["m3l_step1"].items()])
        d["loss_err"] = max(abs(a["metrics"][0][n] - w["metrics"][0][n])
                            / abs(w["metrics"][0][n])
                            for n in ("loss", "semi_loss"))
        d.update(dev_max=float(dev.max()),
                 flip_share=float((dev > lr).float().mean()))
        asum = lambda t: float(t.double().abs().sum())
        sums = {k: (asum(saved["m3l_grad1"][k]), asum(v))
                for k, v in mine["m3l_grad1"].items()}
        total = sum(x for _, x in sums.values())
        d.update(grad_sum_err=abs(sum(x for x, _ in sums.values())
                                  - total) / total,
                 grad_leaf_err=max(abs(x - y) for x, y in sums.values())
                 / total)
        ok = ok and (d["loss_err"] <= M3L_LOSS_TOL
                     and d["dev_max"] <= GAN_FLIP_DEV * lr
                     and d["flip_share"] < GAN_FLIP_SHARE and total > 0
                     and sorted(saved["m3l_grad1"]) == sorted(sums)
                     and d["grad_sum_err"] <= DP_SUM_TOL
                     and d["grad_leaf_err"] <= DP_SUM_TOL)
    else:
        ok = ok and (d["loss_err"] <= DP_LOSS_TOL
                     and d["sum_err"] <= DP_SUM_TOL)
    return d, ok


def tpz_two_ranks(torch, np, counters, routed, ranks: list,
                  lr: float) -> dict:
    """17a and 17b: the two ranks against one process at the global batch,
    here, under deterministic cuDNN (:func:`tpz_check_run` per run; each
    eval forward within TPZ_EVAL_TOL; the sweep's labels equal wherever
    one process's top-two margin exceeds TPZ_MARGIN, its Dice within
    1e-3; the M3L checkpoint the ranks wrote loaded here, its trees the
    ranks' to the bit and its next step's losses within M3L_LOSS_TOL of
    the ranks').  Raises where one fails."""
    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.ops.losses import split_heads
    from smsut_tpu_torch.train import checkpoints

    r0, r1 = ranks
    det = cudnn.deterministic
    cudnn.deterministic = True
    try:
        one, mine = tpz_zoo(torch, np, counters, routed)
        dice, labels = tpz_sweep(torch, np)
        # 17b: the ranks' M3L file in one process, and its next step
        algo = m3l_algo("float32")
        st = checkpoints.load_state(algo.init_state(1), str(TPZ_DIR), "m3l")
        loaded_sha = tree_sha(st.params)
        lb, ul = dp_batch(np), ellipse_batch(np, seed=1)
        st, m = algo.train_step(st, {"img": lb["img"], "msk": lb["msk"],
                                     "ul_img": ul["img"]},
                                algo.epoch_scalars(3))
        nxt = {k: float(v) for k, v in m.items()}
        del algo, st
        cora = zoo_algo("coraNet", Config(input_size=256, base_width=16,
                                          batch_size=DP_GLOBAL,
                                          compute_dtype="float32"))
        x = torch.from_numpy(np.stack([s[0] for s in
                                       tpz_sweep_samples(np)])).cuda()
        with torch.no_grad():
            heads = split_heads(cora._apply(cora.eval_params(
                cora.init_state(0)), x), cora.cfg.n_label)
        clear = []
        for h in heads:
            top2 = torch.topk(h, 2, dim=-1).values
            clear.append((top2[..., 0] - top2[..., 1]
                          > TPZ_MARGIN).cpu())
        del cora, heads, x
        torch.cuda.empty_cache()
    finally:
        cudnn.deterministic = det
    saved = torch.load(TPZ_DIR / "zoo_rank0.pt", weights_only=True)
    out, ok = {}, True
    for name in TPZ_ZOO:
        a, b, w = r0[name], r1[name], one[name]
        d, good = tpz_check_run(name, a, b, w, mine, saved, lr)
        out[name] = d
        ok = ok and good
        shown = {k: v for k, v in d.items() if k != "one_process"}
        print(f"tpz 17a {name}: two ranks (dp x tp = 1 x {TP}) vs one "
              f"process: {shown}"
              f"; one process {[round(x, 6) for x in d['one_process']]}; a "
              f"rank's launches in each step {a['step_launches']}, routed "
              f"{a['step_routed']} (expected per step "
              f"{tpz_per_step(name) if name != 'dtc' else 'one process'}); "
              f"one process {w['step_launches']}; step ms (rank 0, rank 1, "
              f"one process) {[round(x, 1) for x in a['step_ms']]} "
              f"{[round(x, 1) for x in b['step_ms']]} "
              f"{[round(x, 1) for x in w['step_ms']]}", flush=True)
    ev = {}
    for name in TPZ_EVAL:
        got, want = saved[f"eval_{name}"], mine[f"eval_{name}"]
        ev[name] = float((got - want).abs().max()
                         / max(1.0, float(want.abs().max())))
    eval_ok = (all(v <= TPZ_EVAL_TOL for v in ev.values())
               and r0["eval_sha"] == r1["eval_sha"])
    out["eval"] = ev
    print(f"tpz 17a eval_fn on the shards of the initial weights, 8 images "
          f"256^2, vs one process (rel err, tol {TPZ_EVAL_TOL}): {ev}; "
          f"ranks equal {r0['eval_sha'] == r1['eval_sha']}", flush=True)
    sw = {"dice_ranks": r0["sweep"]["dice"], "dice_one": dice,
          "ranks_equal": r0["sweep"]["sha"] == r1["sweep"]["sha"],
          "rank_s": r0["sweep"]["s"]}
    for key, where in (("plab", clear[0]), ("mask", clear[1] & clear[2])):
        g, w = saved["sweep"][key], labels[key].cpu()
        sw[f"{key}_clear"] = float(where.float().mean())
        sw[f"{key}_agree"] = float((g == w).float().mean())
        sw[f"{key}_clear_equal"] = bool(torch.equal(g[where], w[where]))
    sweep_ok = (sw["ranks_equal"] and sw["plab_clear_equal"]
                and sw["mask_clear_equal"]
                and abs(sw["dice_ranks"] - dice) <= 1e-3
                and min(sw["plab_clear"], sw["mask_clear"]) > 0.9)
    out["sweep"] = sw
    print(f"tpz 17b CoraNet B's pseudo sweep ({TPZ_SWEEP} images 256^2, "
          f"chunks of {DP_GLOBAL}) on the ranks' shards vs one process: {sw}",
          flush=True)
    m3 = r0["M3L"]
    ck = {"sha_equal": loaded_sha == m3["shas"][-1][0],
          "next_err": max(abs(nxt[n] - m3["next"][n]) / abs(nxt[n])
                          for n in ("loss", "semi_loss")),
          "next": nxt, "ranks_next": m3["next"]}
    ck_ok = ck["sha_equal"] and ck["next_err"] <= M3L_LOSS_TOL
    out["checkpoint"] = ck
    print(f"tpz 17b: M3L's state (Adam's moments and count, the EMA) saved "
          f"at 1 x {TP} after {TPZ_STEPS} steps, loaded in one process: "
          f"{ck}", flush=True)
    if not (ok and eval_ok and sweep_ok and ck_ok
            and all(r["backend"] == "gloo" and r["world"] == TP
                    and r["model"] == TP for r in (r0, r1))):
        raise AssertionError(f"17 the zoo on the model axis vs one "
                             f"process: {out}")
    return {"ranks": [r0, r1], "one_process": one, "diff": out}


def tpz_phase(torch, counters, routed, ranks: list, card: str) -> dict:
    """Phase 17: 17a and 17b against the ranks' results (``ranks`` from
    :func:`tpz_collect`)."""
    import numpy as np

    from smsut_tpu_torch.config import Config

    t0 = time.perf_counter()
    res = tpz_two_ranks(torch, np, counters, routed, ranks, Config().lr)
    secs = time.perf_counter() - t0
    print(f"phase 17 on {card}: 17a/b {secs:.1f} s", flush=True)
    return dict(res, seconds=secs)


# phase 12: from volumes to a trained model: the port's preparation CLIs
# on synthetic BTCV and CHAOS trees, then unetTrainer on the PNG tree they
# write.  4 patients per modality (the split: 2 test, 1 labelled, 1
# unlabelled), PREP_SLICES slices of PREP_SIDE^2 at PREP_PIXEL mm: int(288
# * 1.4 / 1.5) = 268 pixels after the resample, cropped to 256
PREP_DIR = ROOT / "build" / "chip_smoke_prep"
PREP_PATIENTS, PREP_SLICES, PREP_SIDE, PREP_PIXEL = 4, 10, 288, 1.4
PREP_GAP = {"btcv": 5.0, "chaos": 6.0}   # mm between slices
PREP_ITERS = 10                           # the trainer's one short epoch


def organ_slices(np, rng, values) -> "np.ndarray":
    """[PREP_SLICES, side, side] uint8: four discs of ``values`` in every
    slice but the first and the last."""
    side = PREP_SIDE
    yy, xx = np.mgrid[0:side, 0:side]
    out = np.zeros((PREP_SLICES, side, side), np.uint8)
    for z in range(1, PREP_SLICES - 1):
        for v in values:
            cy, cx = rng.uniform(0.3, 0.7, 2) * side
            r = rng.uniform(0.05, 0.12) * side
            out[z][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = v
    return out


def write_dicom(path: Path, pixels, z_mm: float, instance: int) -> None:
    """One uncompressed slice as a part-10 DICOM file, Explicit VR Little
    Endian: signed 16-bit pixels, PREP_PIXEL mm spacing, position z_mm."""
    import struct

    def el(group, elem, vr, value):
        tag = struct.pack("<HH", group, elem)
        if vr in (b"OB", b"OW"):
            return tag + vr + b"\x00\x00" + struct.pack("<I", len(value)) \
                + value
        return tag + vr + struct.pack("<H", len(value)) + value

    def text(v):
        b = str(v).encode()
        return b + b" " if len(b) % 2 else b

    rows, cols = pixels.shape
    body = b"".join([
        el(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1\x00"),
        el(0x0018, 0x0050, b"DS", text(PREP_GAP["chaos"])),
        el(0x0020, 0x0013, b"IS", text(instance)),
        el(0x0020, 0x0032, b"DS", text(f"0\\0\\{z_mm}")),
        el(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        el(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        el(0x0028, 0x0030, b"DS", text(f"{PREP_PIXEL}\\{PREP_PIXEL}")),
        el(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        el(0x0028, 0x0103, b"US", struct.pack("<H", 1)),
        el(0x7FE0, 0x0010, b"OW", pixels.astype("<i2").tobytes())])
    path.write_bytes(b"\x00" * 128 + b"DICM" + body)


def prep_volumes(np) -> None:
    """The synthetic inputs under PREP_DIR: BTCV's layout
    (Training/{img,label}/..., int16 CT in NIfTI, BTCV's label ids) and
    CHAOS's (MR/{pid}/T1DUAL/DICOM_anon/{InPhase,OutPhase},
    MR/{pid}/T2SPIR/DICOM_anon, each study's Ground PNGs with the organs'
    grey levels), PREP_PATIENTS patients each."""
    from smsut_tpu_torch.preprocess.niftio import Volume, write_nifti
    from smsut_tpu_torch.utils.io import imwrite_gray

    rng = np.random.default_rng(12)
    btcv = PREP_DIR / "btcv" / "Training"
    for sub in ("img", "label"):
        (btcv / sub).mkdir(parents=True)
    spacing = (PREP_PIXEL, PREP_PIXEL, PREP_GAP["btcv"])
    for p in range(1, PREP_PATIENTS + 1):
        lab = organ_slices(np, rng, (6, 2, 3, 1))
        img = (lab * 40.0 - 900 + rng.normal(0, 60, lab.shape)).astype(
            np.int16)
        write_nifti(Volume(img, spacing), str(btcv / "img" /
                                              f"img{p:04d}.nii.gz"))
        write_nifti(Volume(lab, spacing), str(btcv / "label" /
                                              f"label{p:04d}.nii.gz"))
    for p in range(1, PREP_PATIENTS + 1):
        pid = PREP_DIR / "chaos" / "MR" / str(p)
        for study, series in (("T1DUAL", ("InPhase", "OutPhase")),
                              ("T2SPIR", ("",))):
            lab = organ_slices(np, rng, (63, 126, 189, 252))
            (pid / study / "Ground").mkdir(parents=True)
            for z in range(PREP_SLICES):
                imwrite_gray(str(pid / study / "Ground" /
                                 f"IMG-0001-{z + 1:05d}.png"), lab[z])
            for s in series:
                d = pid / study / "DICOM_anon" / s
                d.mkdir(parents=True)
                for z in range(PREP_SLICES):
                    write_dicom(d / f"IMG-{PREP_SLICES - z:05d}.dcm",
                                (lab[z] * 3.0 + rng.normal(
                                    200, 30, lab[z].shape)).astype(np.int16),
                                z * PREP_GAP["chaos"], z + 1)


def prep_tree() -> dict:
    """Phase 12's host work: the synthetic volumes and the three
    preparation CLIs (each a subprocess) that write the PNG tree; each
    stage's seconds.  It needs no card and no kernel, so it runs in a
    child process from the script's start (:func:`prep_start`)."""
    import numpy as np

    shutil.rmtree(PREP_DIR, ignore_errors=True)
    nii, png = PREP_DIR / "nii", PREP_DIR / "png"
    t0 = time.perf_counter()
    prep_volumes(np)
    secs = {"volumes": time.perf_counter() - t0}
    stages = (
        ("atlasPreparation", ["--atlas_root", str(PREP_DIR / "btcv"),
                              "--out", str(nii)]),
        ("chaosPreparation", ["--chaos_root", str(PREP_DIR / "chaos"),
                              "--out", str(nii)]),
        ("toPngAndSplit", ["--src", str(nii), "--dst", str(png)]))
    for name, args in stages:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", f"smsut_tpu_torch.data_pprocess.{name}"]
            + args, cwd=ROOT, capture_output=True, text=True, timeout=600)
        secs[name] = time.perf_counter() - t0
        if out.returncode:
            raise AssertionError(f"12 {name} failed:\n{out.stdout[-2000:]}"
                                 f"\n{out.stderr[-4000:]}")
    return secs


def prep_start() -> subprocess.Popen:
    """:func:`prep_tree` in a child process, started."""
    return background(
        [sys.executable, "-c", "import json, chip_smoke; "
         "print('PREP ' + json.dumps(chip_smoke.prep_tree()))"])


def prep_phase(torch, card: str, prep_secs: dict) -> dict:
    """Phase 12: on the PNG tree :func:`prep_start`'s child wrote (its
    stages' seconds ``prep_secs``), ``unetTrainer -p train`` (one epoch of
    PREP_ITERS, w16, batch 8, bfloat16) and ``-p test`` on the card
    (``run_main``); each stage's seconds; the PNG tree (256x256 slices,
    the split YAML), the run's log, checkpoints and Dice matrix
    checked."""
    import numpy as np

    from smsut_tpu_torch.train.cli import make_parser, run_main
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet
    from smsut_tpu_torch.utils.io import imread_gray, read_yaml

    secs = dict(prep_secs)
    png, expr = PREP_DIR / "png", PREP_DIR / "expr"
    sets = ("input_size=256", "base_width=16", "batch_size=8",
            "compute_dtype=bfloat16", f"num_iter_per_epoch={PREP_ITERS}",
            "max_epoch=1", "num_workers=2")
    train = ["--data_root", str(png), "--expr_root", str(expr), "-nm",
             "prep"]
    for kv in sets:
        train += ["--set", kv]
    # the trainer in this process, as a user's run_main call (6a)
    for name, args in (("train", ["-p", "train"]),
                       ("test", ["-p", "test", "-i", "000", "-wh", "best"])):
        t0 = time.perf_counter()
        run_main(SupervisedUNet, make_parser().parse_args(args + train))
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    split = read_yaml(str(png / "semi-1910.yaml"))
    pngs = sorted(png.rglob("*.png"))
    shapes = {imread_gray(str(p)).shape for p in pngs[::25]}
    model = expr / "prep" / "000"
    log = (model / "train.log").read_text()
    losses = [float(x) for x in re.findall(r"\[TRN\].* loss: ([^/]+)/", log)]
    rows = [r for r in (model / "all_trois_matrix.csv").read_text()
            .split("\n") if r]
    vals = np.array([[float(v) for v in r.split(",")] for r in rows])
    res = {"seconds": secs, "pngs": len(pngs), "shapes": sorted(shapes),
           "split": {m: {"test": len(v["test"]), "train": len(v["train"][0]),
                         "val": len(v["val"][0])} for m, v in split.items()},
           "losses": losses, "csv": vals.tolist()}
    print(f"prep 12 on {card}: seconds per stage "
          f"{ {k: round(v, 1) for k, v in secs.items()} }; {len(pngs)} PNGs "
          f"of {sorted(shapes)}; split {res['split']}; [TRN] losses "
          f"{losses}; test CSV {vals.shape}, mean Dice {vals[4, 4]:.4f}",
          flush=True)
    if (shapes != {(256, 256)} or sorted(split) != ["ct", "t1in", "t1out",
                                                    "t2"]
            or len(losses) != 1 or not np.isfinite(losses).all()
            or log.count("[TST]") != 1
            or not (model / "ckpt" / "best.ckpt").is_file()
            or vals.shape != (10, 5) or not np.isfinite(vals).all()):
        raise AssertionError(f"12: {res}")
    shutil.rmtree(PREP_DIR, ignore_errors=True)
    return res


# phase 18: the space-to-depth packed levels (pack_levels=2, the JAX
# package's hw mode).  18a: K3 and K6 with groups 4 at the TPU kernels' own
# shapes, w16 batch 8: (label, packed side, original input segments,
# original Cout): the level-0 encoder block, the level-0 decoder block on
# its two segments, the level-1 encoder block, the identity form
PK_BLOCKS = (("level-0 encoder", 128, (8,), 16),
             ("level-0 decoder", 128, (16, 16), 16),
             ("level-1 encoder", 64, (16,), 32),
             ("identity", 128, (16,), 16))
# K1 and K4 on the packed levels' free views [B, H', 4W', C]: the level-0
# blocks' norms and the level-1 block's
PK_NORMS = ((8, 128, 512, 16, True), (8, 64, 256, 32, False))
# 18b/18c: the configurations (algorithm, block_pallas) driven packed and
# unpacked; replayed units per timed block and rounds
PK_CONFIGS = (("unet", False), ("unet", True), ("uganConsis", False),
              ("uganConsis", True), ("meanTeacher", False),
              ("crossPse", False))
PK_UNITS = {"unet": 10, "uganConsis": 3, "meanTeacher": 5, "crossPse": 5}
PK_ROUNDS = 2
# the D stem's double backward per replayed bf16 uganConsis iteration,
# unpacked, as PERF.md records it (§5)
UNPACKED_STEM_MS = 4.88


def pk_kernels(torch, F, ops, instnorm, conv3x3, block) -> list:
    """18a: K3 and K6 with groups 4 at :data:`PK_BLOCKS`, K1 and K4 on the
    packed views :data:`PK_NORMS`, K2, K2 as dx and K5 with a packed
    [3,3,64,64] kernel at [8,128,128,64], in float32 and bfloat16, each
    held against its plain version (phase 2's bounds) and timed beside
    its bound and the library call (for the blocks the eager cuDNN chain
    on the same packed input, its norms per packed channel); rows as
    phase 2's."""
    from smsut_tpu_torch.models.packed import pack_kernel

    rows = []
    cases = Cases(torch, seed=18)
    nchw = lambda t: t.permute(0, 3, 1, 2)
    for dt in (torch.float32, torch.bfloat16):
        dn = str(dt).split(".")[-1]
        isz = torch.tensor([], dtype=dt).element_size()
        pw = lambda k, segs, co: pack_kernel(
            cases.conv_w(k, sum(segs), co, torch.float32), segs).to(dt)
        for label, h, segs, co0 in PK_BLOCKS:
            ci, co = 4 * sum(segs), 4 * co0
            short = sum(segs) != co0
            x = cases.randn(8, h, h, ci, dtype=dt)
            w1, w2 = pw(3, segs, co0), pw(3, (co0,), co0)
            (s1, b1), (s2, b2) = cases.norm_params(co0), \
                cases.norm_params(co0)
            ws, ss, bs = ((pw(1, segs, co0), *cases.norm_params(co0))
                          if short else (None, None, None))
            args = (x, w1, s1, b1, w2, s2, b2, ws, ss, bs)
            tile = lambda t: None if t is None else t.repeat(4)
            lib = (x, w1, tile(s1), tile(b1), w2, tile(s2), tile(b2), ws,
                   tile(ss), tile(bs))
            form = "shortcut" if short else "identity"
            case = f"groups=4 {form} {[8, h, h, ci]}->{co}"
            macs = 9 * ci * co + 9 * co * co + (ci * co if short else 0)
            record(torch, ops, rows, "block", case, dn,
                   lambda *a: block.basic_block_fwd(*a, groups=4), args,
                   lambda lib=lib: library_block(F, *lib),
                   flops=2 * 8 * h * h * macs,
                   nbytes=(8 * h * h * (ci + co) + macs) * isz + 6 * 4 * co0,
                   iters=5, extra={"packed": label})
            _, res = block.basic_block_fwd(*args, save=True, groups=4)
            g = cases.randn(8, h, h, co, dtype=dt)
            maps = (4 if short else 3) * co + 2 * ci
            record(torch, ops, rows, "block_bwd", case, dn,
                   lambda *a: block.basic_block_bwd(*a, groups=4),
                   (g, x, w1, s1, w2, s2, ws, ss, res),
                   grad_call(torch, lambda *a: library_block(F, *a), lib,
                             nchw(g)),
                   flops=4 * 8 * h * h * macs,
                   nbytes=8 * h * h * maps * isz + macs * (isz + 4)
                   + 4 * (6 * co + 12 * 8 * co), iters=5,
                   extra={"packed": label})
        for (b, h, w, c, act) in PK_NORMS:
            x = cases.randn(b, h, w, c, mean=0.3, dtype=dt)
            gr = cases.randn(b, h, w, c, dtype=dt)
            s, bb = cases.norm_params(c)

            def lib_fwd(xn, s_, b_, act=act):
                y = F.instance_norm(xn, weight=s_.to(xn.dtype),
                                    bias=b_.to(xn.dtype), eps=1e-5)
                return F.leaky_relu(y, 0.01) if act else y
            case = f"packed view {[b, h, w, c]} act={act}"
            record(torch, ops, rows, "instnorm", case, dn,
                   lambda *a: instnorm.instance_norm_fwd(*a)[0],
                   (x, s, bb, act), lambda x=x, s=s, bb=bb: lib_fwd(
                       nchw(x), s, bb), flops=8 * x.numel(),
                   nbytes=2 * x.numel() * isz + 4 * 4 * c + 2 * 4 * b * c,
                   iters=20)
            _, mean, rstd = instnorm.instance_norm_fwd(x, s, bb, act)
            record(torch, ops, rows, "instnorm_bwd", case, dn,
                   instnorm.instance_norm_bwd,
                   (x, gr, mean, rstd, s, bb, act),
                   grad_call(torch, lib_fwd, (nchw(x), s, bb), nchw(gr)),
                   flops=12 * x.numel(),
                   nbytes=3 * x.numel() * isz + 6 * 4 * c + 2 * 4 * b * c,
                   iters=20, peak=PEAK_F32_CORES)
        # K2, K2 as dx and K5 with the packed kernel of a level-0 3x3 conv
        # (16 -> 16 channels packed to 64 -> 64)
        x = cases.randn(8, 128, 128, 64, dtype=dt)
        g = cases.randn(8, 128, 128, 64, dtype=dt)
        wp = pw(3, (16,), 16)
        case = "packed [8, 128, 128, 64]->64"
        flops = 2 * 8 * 128 * 128 * 9 * 64 * 64
        nbytes = (8 * 128 * 128 * 128 + 9 * 64 * 64) * isz
        record(torch, ops, rows, "conv3x3", case, dn, conv3x3.conv3x3_fwd,
               (x, wp), lambda x=x, wp=wp: F.conv2d(
                   nchw(x), wp.permute(3, 2, 0, 1), padding=1),
               flops=flops, nbytes=nbytes, iters=10)
        record(torch, ops, rows, "conv3x3_dx", case, dn, conv3x3.conv3x3_fwd,
               (g, conv3x3.flip_io(wp)),
               lambda g=g, wp=wp: torch.nn.grad.conv2d_input(
                   (8, 64, 128, 128), wp.permute(3, 2, 0, 1), nchw(g),
                   padding=1), flops=flops, nbytes=nbytes, iters=10)
        record(torch, ops, rows, "conv3x3_dw", case, dn, conv3x3.conv3x3_dw,
               (x, g), lambda x=x, g=g: torch.nn.grad.conv2d_weight(
                   nchw(x), (64, 64, 3, 3), nchw(g), padding=1),
               flops=flops, nbytes=8 * 128 * 128 * 128 * isz
               + 9 * 64 * 64 * 4, iters=10)
    return rows


def pk_algo(name: str, dtn: str, fused: bool, pack: int,
            layout: Optional[dict] = None):
    """The algorithm ``name`` at full width (w16, 256^2, batch 8, uganConsis
    8 + 8 with the gate open) in ``dtn``, ``pack_levels`` ``pack`` (the
    JAX rules for pairing and the loss tails; ``d_pack_mode="hw"``), the
    Config's packing knobs updated by ``layout`` (phase 19)."""
    from smsut_tpu_torch.config import Config
    from smsut_tpu_torch.train.steps.gan import UGANConsisAlgo
    from smsut_tpu_torch.train.steps.supervised import SupervisedUNet

    cfg = Config(**dict(dict(
        input_size=256, base_width=16, batch_size=8, compute_dtype=dtn,
        block_pallas=fused, pack_levels=pack, d_pack_mode="hw",
        consis_gate_step=0), **(layout or {})))
    if name == "unet":
        return SupervisedUNet(cfg)
    if name == "uganConsis":
        return UGANConsisAlgo(cfg)
    return zoo_algo(name, cfg)


def pk_setup(torch, np, algo, name: str):
    """(state from seed 0, the step's device inputs, its scalars): the
    ellipse batches; Mean Teacher at count 100 (every term live)."""
    if name == "uganConsis":
        inp = algo.inputs(dict(gan_batch(torch, np),
                               **algo.make_extra_batch()))
        return (algo.init_state(0), inp,
                {"lambda_semi": torch.tensor(1.0, device="cuda")})
    if name == "unet":
        inp = algo.inputs({k: torch.from_numpy(v).cuda()
                           for k, v in ellipse_batch(np).items()})
        return algo.init_state(0), inp, None
    return (zoo_state(algo, ZOO_GATE[name]), zoo_inputs(torch, np, algo, name),
            zoo_scalars(torch, algo))


def pk_grads(ops, algo, name: str, state, inp, scal):
    """One step's metrics and the gradients it would apply, the updates
    captured and skipped.  uganConsis: the D step's and the G step's
    metrics (the G step against the same D), the G step's gradients, and
    the D loss's gradients (its GP's second order through the stem) on
    fixed inputs, real against the real batch reversed, so that the D is
    held apart from the generator that makes its fakes."""
    if name != "uganConsis":
        return zoo_grads(ops, algo, state, inp, scal, plain=False)
    import torch

    grads = {}

    def capture(prefix):
        def apply(g):
            if prefix:
                grads.update({f"{prefix}.{k}": v for k, v in g.items()})
            return state
        return apply

    state.apply_d_gradients = capture(None)
    state.apply_g_gradients = capture("G")
    si = algo.step_inputs(inp)
    _, dm = algo.d_step(state, si)
    _, gm = algo.g_step(state, si, scal)
    d = {k: v.detach().requires_grad_() for k, v in state.d_params.items()}
    total, _, _ = algo.d_loss(d, si["x_real"], si["x_real"].flip(0),
                              si["alpha"], si["mdl"])
    grads.update({f"D.{k}": g for k, g in zip(
        d, torch.autograd.grad(total, list(d.values())))})
    return {k: float(v.detach()) for k, v in {**dm, **gm}.items()}, grads


def pk_parity(torch, np, ops, name: str, fused: bool) -> dict:
    """18b for one configuration: step 1's gradients (every loss term
    live) and the eval logits packed against unpacked from the same
    weights, float32 (phase 4's rules, losses within LOSS_TOL or, for
    uganConsis, phase 7's bounds) and bfloat16 (the packed path no less
    accurate than the unpacked, against the float32 unpacked gradient);
    with ``block_pallas`` K3 and K6 launched with groups 4."""
    from smsut_tpu_torch.ops import block

    res, logits = {}, {}
    for dtn in ("float32", "bfloat16"):
        for pack in (2, 0):
            algo = pk_algo(name, dtn, fused, pack)
            state, inp, scal = pk_setup(torch, np, algo, name)
            g0 = (block.basic_block_fwd.grouped, block.basic_block_bwd.grouped)
            m, g = pk_grads(ops, algo, name, state, inp, scal)
            grouped = (block.basic_block_fwd.grouped - g0[0],
                       block.basic_block_bwd.grouped - g0[1])
            if fused and pack and min(grouped) < 1:
                raise AssertionError(f"18b {name} fused {dtn}: K3/K6 with "
                                     f"groups 4 not launched: {grouped}")
            res[(dtn, pack)] = (m, g, grouped)
            if name in ("unet", "uganConsis"):
                params = (algo.eval_params(state) if name == "unet"
                          else state.g_params)
                img = inp["img"]
                logits[(dtn, pack)] = algo.eval_fn(params, img)
            del algo, state
    (m32, k32, _), (u32, p32, _) = res[("float32", 2)], res[("float32", 0)]
    (m16, k16, grouped), (_, p16, _) = res[("bfloat16", 2)], \
        res[("bfloat16", 0)]
    lg = {dtn: rel_err(logits[(dtn, 2)], logits[(dtn, 0)])
          for dtn in ("float32", "bfloat16") if (dtn, 2) in logits}
    ok, out = step1_parity(name, m32, u32, k32, p32)
    out.update(logits_rel=lg, grouped_bf16=grouped)
    if name == "uganConsis":
        # the generator's other gradients printed, not held: a tower
        # stem's sums nearly cancel (the JAX package's own packed and
        # unpacked towers differ there by 1.5%), and phase 7 holds no
        # bfloat16 gradient (its bf16 steps: finite, 18c)
        part = lambda g: {k: v for k, v in g.items() if k.startswith("G.")}
        out["g"] = grad_parity(part(k32), part(p32))
        ok = ok and all(np.isfinite(list(m16.values())))
        grads = (f"D's {out['d']['n']} gradients: L2 of all "
                 f"{out['d']['l2_all']:.3g}, cosine min "
                 f"{out['d']['cos_min']:.6f} ({out['d']['worst_cos']}); the "
                 f"seg tower's L2 {out['seg_l2']}; G's {out['g']['n']} "
                 f"(printed): L2 of all {out['g']['l2_all']:.3g}, cosine min "
                 f"{out['g']['cos_min']:.6f} ({out['g']['worst_cos']}); "
                 f"bfloat16 losses finite {m16}")
    else:
        f32 = out["float32"]
        acc16 = out["bfloat16_vs_float32"] = bf16_accuracy(k16, p16, p32)
        ok = ok and acc16["worst_over"] <= 0
        grads = (f"step-1 gradients of {f32['n']} tensors: rel err max "
                 f"{f32['rel_max']:.3g} ({f32['worst_rel']}), L2 of all "
                 f"{f32['l2_all']:.3g}, cosine min {f32['cos_min']:.6f} "
                 f"({f32['worst_cos']}); bfloat16 packed err max "
                 f"{acc16['kernel_err_max']:.3g} vs unpacked "
                 f"{acc16['plain_err_max']:.3g} against the float32 "
                 f"unpacked gradient")
    ok = ok and all(v <= LOGIT_TOL[d] for d, v in lg.items())
    print(f"pk 18b {name} block_pallas={fused}: float32 packed vs "
          f"unpacked from one init: losses {m32} vs {u32} (worst "
          f"{out['worst_loss']} over its bound by {out['loss_over_max']:.3g}"
          f"); {grads}; eval logits rel err {lg}; K3/K6 with groups 4 in "
          f"the bf16 packed step {grouped}", flush=True)
    if not ok:
        raise AssertionError(f"18b {name} fused={fused}: {out}")
    return out


def pk_bitwise(torch, np, name: str, layout: Optional[dict] = None) -> bool:
    """Two float32 packed runs of 3 iterations (eager warm-up, capture,
    replay) from one init under deterministic cuDNN, in ``layout``: the
    same bits."""
    import torch.backends.cudnn as cudnn

    from smsut_tpu_torch.tools.profile_step import iteration

    prev, cudnn.deterministic = cudnn.deterministic, True
    try:
        runs = []
        for _ in range(2):
            algo = pk_algo(name, "float32", True, 2, layout)
            state, inp, scal = pk_setup(torch, np, algo, name)
            run = iteration(algo, state, inp, scal, capture=True)
            for _ in range(3):
                m = {k: v.clone() for k, v in run().items()}
            tree = (state.params if name != "uganConsis"
                    else {**state.g_params, **state.d_params})
            runs.append((m, {k: v.clone() for k, v in tree.items()}))
            del algo, state, run
    finally:
        cudnn.deterministic = prev
    (ma, ta), (mb, tb) = runs
    return (all(torch.equal(ma[k], mb[k]) for k in ma)
            and all(torch.equal(ta[k], tb[k]) for k in ta))


def pk_numbers(torch, np, counters, routed, name: str, fused: bool,
               card: str, layout: Optional[dict] = None,
               tag: str = "pk 18c", rounds: int = PK_ROUNDS) -> dict:
    """18c for one configuration (19c with a W ``layout``), bfloat16, packed
    (pack_levels 2) and unpacked in one process: the launches and routed
    convs of one replayed iteration, the peak memory beyond the state over
    3 iterations, host ms per iteration in interleaved blocks, the
    profiler's device ms and kernels per iteration; every metric
    finite."""
    from smsut_tpu_torch.ops import block
    from smsut_tpu_torch.tools.profile_step import iteration

    runs, res = {}, {}
    for pack in (2, 0):
        algo = pk_algo(name, "bfloat16", fused, pack, layout)
        state, inp, scal = pk_setup(torch, np, algo, name)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run = iteration(algo, state, inp, scal, capture=True)
        for _ in range(3):
            m = run()
        zero(counters, routed)
        g0 = (block.basic_block_fwd.grouped, block.basic_block_bwd.grouped)
        m = {k: float(v) for k, v in run().items()}
        torch.cuda.synchronize()
        if not all(np.isfinite(list(m.values()))):
            raise AssertionError(f"{tag} {name} pack={pack}: {m}")
        res[pack] = {"metrics": m,
                     "launches": {k: c.launches for k, c in counters.items()},
                     "routed": routed_counts(routed),
                     "grouped": (block.basic_block_fwd.grouped - g0[0],
                                 block.basic_block_bwd.grouped - g0[1]),
                     "peak_mib": (torch.cuda.max_memory_allocated() - base)
                     / 2 ** 20}
        runs[pack] = run
        if name == "uganConsis":
            # the D step's double backward, eager, its stem's share
            si = algo.step_inputs(inp)
            st = algo.init_state(0)
            st.apply_d_gradients = lambda g, st=st: st
            ops_ = d_step_ops(torch, lambda: algo.d_step(st, si))
            res[pack]["d_double_backward_ms"] = ops_[-1][1]
            res[pack]["d_top_ops"] = ops_[:-1]
    t = timed_blocks(torch, runs, PK_UNITS[name], rounds)
    for pack in (2, 0):
        prof = profile_device(torch, runs[pack], n=2)
        res[pack].update(host=t[pack], device_ms=prof["device_ms"],
                         kernels=prof["kernels_per_call"])
    p, u = res[2], res[0]
    stem = ("" if name != "uganConsis" else
            f"; the D step's conv double backward (eager) "
            f"{p['d_double_backward_ms']:.3f} / "
            f"{u['d_double_backward_ms']:.3f} ms (PERF.md's unpacked "
            f"record: {UNPACKED_STEM_MS} ms a replayed iteration)")
    print(f"{tag} {name} block_pallas={fused} on {card}: packed / "
          f"unpacked, bf16, replayed: device ms {p['device_ms']:.3f} / "
          f"{u['device_ms']:.3f}; kernels per iteration {p['kernels']} / "
          f"{u['kernels']}; host ms (median, quartiles) "
          f"{p['host']['median_ms']:.3f} ({p['host']['q1_ms']:.3f}-"
          f"{p['host']['q3_ms']:.3f}) / {u['host']['median_ms']:.3f} "
          f"({u['host']['q1_ms']:.3f}-{u['host']['q3_ms']:.3f}); peak MiB "
          f"beyond the state {p['peak_mib']:.1f} / {u['peak_mib']:.1f}; "
          f"the port's launches per iteration {p['launches']} / "
          f"{u['launches']}; routed {p['routed']} / {u['routed']}; "
          f"K3/K6 grouped {p['grouped']}{stem}", flush=True)
    if (fused and layout is None and name in ("unet", "uganConsis")
            and min(p["grouped"]) < 1):
        raise AssertionError(f"18c {name}: no grouped K3/K6 launch")
    del runs
    torch.cuda.empty_cache()
    return {str(k): v for k, v in res.items()}


def pk_phase(torch, F, ops, instnorm, conv3x3, counters, routed,
             card: str) -> dict:
    """Phase 18, the packed levels: 18a :func:`pk_kernels`, 18b
    :func:`pk_parity` for each of :data:`PK_CONFIGS` and the float32
    packed replays bit for bit (the U-Net and uganConsis, fused), 18c
    :func:`pk_numbers` for each."""
    import numpy as np

    from smsut_tpu_torch.ops import block

    seconds = {}
    t0 = time.perf_counter()
    rows = pk_kernels(torch, F, ops, instnorm, conv3x3, block)
    lap(seconds, "18a", t0)
    t0 = time.perf_counter()
    parity = {f"{n} {f}": pk_parity(torch, np, ops, n, f)
              for n, f in PK_CONFIGS}
    bitwise = {n: pk_bitwise(torch, np, n) for n in ("unet", "uganConsis")}
    print(f"pk 18b float32 packed replays bit for bit (block_pallas, "
          f"deterministic cuDNN): {bitwise}", flush=True)
    if not all(bitwise.values()):
        raise AssertionError(f"18b packed replays differ: {bitwise}")
    lap(seconds, "18b", t0)
    t0 = time.perf_counter()
    numbers = {f"{n} {f}": pk_numbers(torch, np, counters, routed, n, f,
                                      card) for n, f in PK_CONFIGS}
    lap(seconds, "18c", t0)
    return {"rows": rows, "parity": parity, "bitwise": bitwise,
            "numbers": numbers, "seconds": seconds}


# phase 19: the W packing (pack_mode/d_pack_mode "w", the JAX package's
# models/packed_w.py).  19a: K2, K2 as dx and K5 with W-packed kernels at
# the w16 layouts' W shapes, batch 8 (the D's 16): (label, B, H, J, pack,
# original input segments, original Cout): the U-Net's levels 0 (pack 8)
# and 1 (pack 4), encoder and decoder, and the D's two W blocks (packs 4
# and 2)
WP_CONVS = (("U-Net level-0 enc conv1", 8, 256, 32, 8, (8,), 16),
            ("U-Net level-0 conv2", 8, 256, 32, 8, (16,), 16),
            ("U-Net level-0 dec conv1", 8, 256, 32, 8, (16, 16), 16),
            ("U-Net level-1 enc conv1", 8, 128, 32, 4, (16,), 32),
            ("U-Net level-1 conv2", 8, 128, 32, 4, (32,), 32),
            ("U-Net level-1 dec conv1", 8, 128, 32, 4, (32, 32), 32),
            ("D block1 conv1", 16, 128, 32, 4, (16,), 32),
            ("D block1 conv2", 16, 64, 32, 2, (32,), 32),
            ("D block2 conv1", 16, 64, 32, 2, (32,), 64))
# the float32 (parity path) cases among them
WP_F32 = ("U-Net level-0 conv2", "D block1 conv1")
# K1 and K4 on the W views [B, H, J*p, C] of W-packed maps [B, H, J, p*C]:
# (label, B, H, J, p, C, act)
WP_NORMS = (("U-Net level 0", 8, 256, 32, 8, 16, True),
            ("U-Net level 1", 8, 128, 32, 4, 32, False),
            ("D block1", 16, 128, 32, 4, 32, True),
            ("D block2", 16, 64, 32, 2, 64, True))
# 19b/19c: the W layouts (Config knobs over pk_algo's, which sets
# d_pack_mode "hw"): the JAX Config()'s (hw towers, a deep W D) and all-W
WP_JAX_DEFAULT = {"d_pack_mode": "w"}
WP_ALL_W = {"pack_mode": "w", "d_pack_mode": "w"}
# 19b: (label, algorithm, block_pallas, layout, packed.CONV_IMPL,
# paired.DW_IMPL), each against the algorithm's pack_levels=0 step
WP_PARITY = (("unet W", "unet", False, WP_ALL_W, "v1", "dense"),
             ("unet W block_pallas", "unet", True, WP_ALL_W, "v1", "dense"),
             ("meanTeacher W", "meanTeacher", False, WP_ALL_W, "v1",
              "dense"),
             ("crossPse W pair_towers", "crossPse", False,
              dict(WP_ALL_W, pair_towers=True), "v1", "dense"),
             ("uganConsis JAX default", "uganConsis", False, WP_JAX_DEFAULT,
              "v1", "dense"),
             ("uganConsis W", "uganConsis", False, WP_ALL_W, "v1", "dense"),
             ("unet hw v2", "unet", False, {}, "v2", "dense"),
             ("unet hw v2k3", "unet", False, {}, "v2k3", "dense"),
             ("crossPse hw block dw", "crossPse", False, {}, "v1", "block"))
# 19c: (label, algorithm, layout, packed.CONV_IMPL) replayed packed
# against unpacked: W (the JAX default for uganConsis), and the U-Net hw
# under v2, the lowering with the fewest structured zeros
WP_NUMBERS = (("unet W", "unet", WP_ALL_W, "v1"),
              ("uganConsis default", "uganConsis", WP_JAX_DEFAULT, "v1"),
              ("meanTeacher W", "meanTeacher", WP_ALL_W, "v1"),
              ("crossPse W", "crossPse", WP_ALL_W, "v1"),
              ("unet hw v2", "unet", {}, "v2"))


def wp_kernels(torch, F, ops, instnorm, conv3x3) -> list:
    """19a: K2, K2 as dx and K5 with the W-packed kernel of a 3x3 at each
    of :data:`WP_CONVS` (bfloat16, and float32 at :data:`WP_F32`), K1 and
    K4 on the W views :data:`WP_NORMS`, each held against its plain
    version (phase 2's bounds) and timed beside its bound and cuDNN's
    call on the same packed operands; rows as phase 2's, ``packed`` "w"
    and the layer's label."""
    from smsut_tpu_torch.models.packed_w import pack_kernel_w

    rows = []
    cases = Cases(torch, seed=19)
    nchw = lambda t: t.permute(0, 3, 1, 2)
    for dt in (torch.bfloat16, torch.float32):
        dn = str(dt).split(".")[-1]
        isz = torch.tensor([], dtype=dt).element_size()
        for label, b, h, j, p, segs, co0 in WP_CONVS:
            if dt == torch.float32 and label not in WP_F32:
                continue
            ci, co = p * sum(segs), p * co0
            wp = pack_kernel_w(cases.conv_w(3, sum(segs), co0,
                                            torch.float32), p, segs).to(dt)
            x = cases.randn(b, h, j, ci, dtype=dt)
            g = cases.randn(b, h, j, co, dtype=dt)
            case = f"W p={p} {[b, h, j, ci]}->{co}"
            extra = {"packed": "w", "layer": label}
            flops = 2 * b * h * j * 9 * ci * co
            nbytes = (b * h * j * (ci + co) + 9 * ci * co) * isz
            record(torch, ops, rows, "conv3x3", case, dn,
                   conv3x3.conv3x3_fwd, (x, wp),
                   lambda x=x, wp=wp: F.conv2d(
                       nchw(x), wp.permute(3, 2, 0, 1), padding=1),
                   flops=flops, nbytes=nbytes, iters=10, extra=extra)
            record(torch, ops, rows, "conv3x3_dx", case, dn,
                   conv3x3.conv3x3_fwd, (g, conv3x3.flip_io(wp)),
                   lambda g=g, wp=wp, shape=(b, ci, h, j):
                   torch.nn.grad.conv2d_input(
                       shape, wp.permute(3, 2, 0, 1), nchw(g), padding=1),
                   flops=flops, nbytes=nbytes, iters=10, extra=extra)
            record(torch, ops, rows, "conv3x3_dw", case, dn,
                   conv3x3.conv3x3_dw, (x, g),
                   lambda x=x, g=g, shape=(co, ci, 3, 3):
                   torch.nn.grad.conv2d_weight(nchw(x), shape, nchw(g),
                                               padding=1),
                   flops=flops, nbytes=b * h * j * (ci + co) * isz
                   + 9 * ci * co * 4, iters=10, extra=extra)
        for label, b, h, j, p, c, act in WP_NORMS:
            if dt == torch.float32 and label != "U-Net level 0":
                continue
            xw = cases.randn(b, h, j, p * c, mean=0.3, dtype=dt)
            x = xw.reshape(b, h, j * p, c)   # the W view: no copy
            if x.data_ptr() != xw.data_ptr():
                raise AssertionError("19a: the W view copied")
            gr = cases.randn(b, h, j * p, c, dtype=dt)
            s, bb = cases.norm_params(c)

            def lib_fwd(xn, s_, b_, act=act):
                y = F.instance_norm(xn, weight=s_.to(xn.dtype),
                                    bias=b_.to(xn.dtype), eps=1e-5)
                return F.leaky_relu(y, 0.01) if act else y
            case = f"W view p={p} {[b, h, j * p, c]} act={act}"
            extra = {"packed": "w", "layer": label}
            record(torch, ops, rows, "instnorm", case, dn,
                   lambda *a: instnorm.instance_norm_fwd(*a)[0],
                   (x, s, bb, act), lambda x=x, s=s, bb=bb: lib_fwd(
                       nchw(x), s, bb), flops=8 * x.numel(),
                   nbytes=2 * x.numel() * isz + 4 * 4 * c + 2 * 4 * b * c,
                   iters=10, extra=extra)
            _, mean, rstd = instnorm.instance_norm_fwd(x, s, bb, act)
            record(torch, ops, rows, "instnorm_bwd", case, dn,
                   instnorm.instance_norm_bwd,
                   (x, gr, mean, rstd, s, bb, act),
                   grad_call(torch, lib_fwd, (nchw(x), s, bb), nchw(gr)),
                   flops=12 * x.numel(),
                   nbytes=3 * x.numel() * isz + 6 * 4 * c + 2 * 4 * b * c,
                   iters=10, peak=PEAK_F32_CORES, extra=extra)
    return rows


@contextlib.contextmanager
def lowering(impl: str, dw: str):
    """The hw conv's lowering and the paired conv's dw, as
    ``SMSUT_PACKED_IMPL`` and ``SMSUT_PAIRED_DW`` would set them, for the
    block's calls; restored after."""
    from smsut_tpu_torch.models import packed, paired

    saved = packed.CONV_IMPL, paired.DW_IMPL
    packed.CONV_IMPL, paired.DW_IMPL = impl, dw
    try:
        yield
    finally:
        packed.CONV_IMPL, paired.DW_IMPL = saved


def step1_parity(name: str, m32, u32, k32, p32) -> tuple:
    """18b's and 19b's rules for a packed configuration's float32 step 1
    (metrics ``m32``, gradients ``k32``) against its algorithm's
    pack_levels=0 step (``u32``, ``p32``): phase 4's (losses within
    LOSS_TOL, Mean Teacher's and CoraNet's live term ZOO_TERM_TOL,
    gradients' rel_err, L2 and cosine) or, for uganConsis, phase 7's
    (losses within 7b's bounds, D's gradients on fixed inputs, its GP's
    second order through the packed stem, under 7a's, the seg tower's
    within 7b's rtol in L2) -> (ok, summary)."""
    if name == "uganConsis":
        over = {n: abs(m32[n] - u32[n]) - GAN_LOSS_RTOL * abs(u32[n])
                - GAN_LOSS_ATOL for n in m32}
        part = lambda g, pre: {k: v for k, v in g.items()
                               if k.startswith(pre)}
        d = grad_parity(part(k32, "D."), part(p32, "D."))
        seg = {k: float((k32[f"G.{k}"] - p32[f"G.{k}"]).double().norm()
                        / p32[f"G.{k}"].double().norm())
               for k in GAN_SEG_TOWER}
        ok = (max(over.values()) <= 0 and d["l2_all"] <= GRAD_REL
              and d["cos_min"] >= GRAD_COS
              and max(seg.values()) <= GAN_SEG_RTOL)
        out = {"d": d, "seg_l2": seg}
    else:
        term = ZOO_TERMS.get(name)
        over = {n: abs(m32[n] - u32[n]) - (
            ZOO_TERM_TOL * abs(u32[n]) + ZOO_TERM_ATOL if n == term
            else LOSS_TOL * max(abs(u32[n]), 1e-30)) for n in m32}
        f32 = grad_parity(k32, p32)
        ok = (f32["rel_max"] <= GRAD_REL and f32["l2_all"] <= GRAD_REL
              and f32["cos_min"] >= GRAD_COS and max(over.values()) <= 0)
        out = {"float32": f32}
    out.update(loss_over_max=max(over.values()),
               worst_loss=max(over, key=over.get), losses=m32,
               unpacked_losses=u32)
    return ok, out


def wp_parity(torch, np, ops) -> dict:
    """19b: float32 step 1 (every loss term live) of each of
    :data:`WP_PARITY` against its algorithm's unpacked step from the same
    weights and inputs (:func:`step1_parity`); the eval logits of the U-Net's
    and uganConsis's W forwards against the unpacked ones within
    LOGIT_TOL."""
    refs, res = {}, {}
    for label, name, fused, layout, impl, dw in WP_PARITY:
        if name not in refs:
            algo = pk_algo(name, "float32", False, 0)
            state, inp, scal = pk_setup(torch, np, algo, name)
            m, g = pk_grads(ops, algo, name, state, inp, scal)
            lg = None
            if name in ("unet", "uganConsis"):
                lg = algo.eval_fn(algo.eval_params(state) if name == "unet"
                                  else state.g_params, inp["img"])
            refs[name] = (m, g, lg)
            del algo, state
        with lowering(impl, dw):
            algo = pk_algo(name, "float32", fused, 2, layout)
            state, inp, scal = pk_setup(torch, np, algo, name)
            m, g = pk_grads(ops, algo, name, state, inp, scal)
            u, p, ulg = refs[name]
            ok, out = step1_parity(name, m, u, g, p)
            if ulg is not None:
                lg = algo.eval_fn(algo.eval_params(state) if name == "unet"
                                  else state.g_params, inp["img"])
                out["logits_rel"] = rel_err(lg, ulg)
                ok = ok and out["logits_rel"] <= LOGIT_TOL["float32"]
        res[label] = out
        grads = out.get("float32") or out["d"]
        print(f"wp 19b {label}: float32 step 1 vs pack_levels=0: worst "
              f"loss {out['worst_loss']} over its bound by "
              f"{out['loss_over_max']:.3g}; gradients rel err max "
              f"{grads['rel_max']:.3g} ({grads['worst_rel']}), L2 of all "
              f"{grads['l2_all']:.3g}, cosine min {grads['cos_min']:.6f}"
              + (f"; seg tower L2 {out['seg_l2']}" if "seg_l2" in out
                 else "")
              + (f"; eval logits rel err {out['logits_rel']:.3g}"
                 if "logits_rel" in out else ""), flush=True)
        if not ok:
            raise AssertionError(f"19b {label}: {out}")
        del algo, state
    torch.cuda.empty_cache()
    return res


def wp_phase(torch, F, ops, instnorm, conv3x3, counters, routed,
             card: str) -> dict:
    """Phase 19, the W packing: 19a :func:`wp_kernels`, 19b
    :func:`wp_parity` and the float32 W replays bit for bit (the U-Net
    all-W with block_pallas, uganConsis in the JAX default layout), 19c
    :func:`pk_numbers` for each of :data:`WP_NUMBERS` (with the D step's
    stem double backward, W against unpacked)."""
    import numpy as np

    seconds = {}
    t0 = time.perf_counter()
    rows = wp_kernels(torch, F, ops, instnorm, conv3x3)
    lap(seconds, "19a", t0)
    t0 = time.perf_counter()
    parity = wp_parity(torch, np, ops)
    bitwise = {n: pk_bitwise(torch, np, n, lay) for n, lay in
               (("unet", WP_ALL_W), ("uganConsis", WP_JAX_DEFAULT))}
    print(f"wp 19b float32 W replays bit for bit (deterministic cuDNN): "
          f"{bitwise}", flush=True)
    if not all(bitwise.values()):
        raise AssertionError(f"19b W replays differ: {bitwise}")
    lap(seconds, "19b", t0)
    t0 = time.perf_counter()
    numbers = {}
    for label, name, layout, impl in WP_NUMBERS:
        with lowering(impl, "dense"):
            numbers[label] = pk_numbers(torch, np, counters, routed, name,
                                        False, card, layout,
                                        f"wp 19c {label}:")
    lap(seconds, "19c", t0)
    return {"rows": rows, "parity": parity, "bitwise": bitwise,
            "numbers": numbers, "seconds": seconds}


GROUP_OUT = FIT_DIR / "group_phases.json"


def group_phases(torch, ops, instnorm, block, counters, routed,
                 prep_secs: dict, card: str, seconds: dict) -> dict:
    """Phases 11-17, in a process of their own (:func:`group_main`) that
    works beside the one-process phases 7-10, 18 and 19: their time is
    mostly the host's, process start-ups and eager gloo ranks.  Every
    group's ranks start up first; the trainer CLIs of 11c, 13c and 15b
    run one after another in a :class:`Lane`, 14c's dry run beside; 11a's
    child runs, then 13a's and 16b's kernels are timed here; then the
    groups' ranks two groups at a time, each group told to run
    (:func:`go`) once the group before the one it joins has been read.
    This process runs each group's one-process twin as it reads it, and
    phase 12's trainer on the PNG tree ``prep_secs`` reports.  16c's child
    runs last.  Each part's seconds go into ``seconds``."""
    import numpy as np

    from smsut_tpu_torch.config import Config

    data, lr = FIT_DIR / "data", Config().lr
    t0 = time.perf_counter()
    kids = dp_spawn()
    sp_kids, tp_kids, spz_kids = sp_spawn(), tp_spawn(), spz_spawn()
    spb_kids, tpz_kids = spb_spawn(), tpz_spawn()
    lane = Lane([("11c", dp_fit_cmd(data)), ("13c", sp_fit_cmd(data)),
                 *spz_fit_cmds(data)])
    world1 = child_result(kids["world1"])
    lap(seconds, "11a", t0)
    t0 = time.perf_counter()
    sp_rows = split_norm_kernels(torch, ops, instnorm)
    spb_rows = split_block_phases(torch, ops, block)
    lap(seconds, "13a and 16b", t0)
    t0 = time.perf_counter()
    go(kids["ranks"])
    go(sp_kids)
    dp_b = dp_two_ranks(torch, np, counters, routed, kids["ranks"])
    lap(seconds, "11b", t0)
    go(tp_kids)
    dry = tp_dryrun_start()
    t0 = time.perf_counter()
    dp_c = dp_fit(torch, data, lane)
    lap(seconds, "11c", t0)
    t0 = time.perf_counter()
    prep = prep_phase(torch, card, prep_secs)
    lap(seconds, "phase 12", t0)
    t0 = time.perf_counter()
    sp_b = sp_two_ranks(torch, np, counters, routed, sp_kids)
    lap(seconds, "13b", t0)
    go(spz_kids)
    t0 = time.perf_counter()
    sp_c = sp_fit(torch, data, lane)
    lap(seconds, "13c", t0)
    t0 = time.perf_counter()
    tp_ab = tp_two_ranks(torch, np, counters, routed, tp_kids, card)
    lap(seconds, "14a/b/d", t0)
    go(tpz_kids)
    t0 = time.perf_counter()
    tp_c = tp_dryrun(dry, card)
    lap(seconds, "14c", t0)
    t0 = time.perf_counter()
    spz_a = spz_two_ranks(torch, np, counters, routed, spz_kids, lr)
    lap(seconds, "15a", t0)
    go(spb_kids[:2])
    t0 = time.perf_counter()
    spz_b = spz_fit(torch, data, lane)
    lap(seconds, "15b", t0)
    t0 = time.perf_counter()
    tpz = tpz_phase(torch, counters, routed, tpz_collect(tpz_kids), card)
    lap(seconds, "phase 17", t0)
    t0 = time.perf_counter()
    spb_a = spb_two_ranks(torch, np, counters, routed, spb_kids[:2], lr)
    lap(seconds, "16a", t0)
    t0 = time.perf_counter()
    spb_c = spb_remat_check(spb_kids[2], card)
    lap(seconds, "16c", t0)
    return {"dp": {"world1": world1, "two_ranks": dp_b, "fit": dp_c},
            "prep": prep,
            "sp": {"rows": sp_rows, "two_ranks": sp_b, "fit": sp_c},
            "tp": {"two_ranks": tp_ab, "dryrun": tp_c},
            "spz": {"two_ranks": spz_a, "fit": spz_b},
            "spb": {"two_ranks": spb_a, "rows": spb_rows, "remat": spb_c},
            "tpz": tpz}


def _jsonable(o):
    """A value json cannot write: a numpy or torch scalar as its number,
    anything else as its text."""
    if getattr(o, "ndim", None) == 0 and hasattr(o, "item"):
        return o.item()
    return str(o)


def group_main() -> None:
    """:func:`group_phases` in this process (``sys.argv[1]``: phase 12's
    stage seconds, JSON; ``sys.argv[2]``: the parent's START), its result
    written to GROUP_OUT as JSON.  A SIGTERM ends it as an exception does,
    so that what it started is stopped too."""
    global START
    import signal

    import torch

    from smsut_tpu_torch import ops
    from smsut_tpu_torch.ops import block, instnorm

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    START = float(sys.argv[2])   # the parent's start, on the same clock
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters, routed = kernel_counters()
    seconds = {}
    res = group_phases(torch, ops, instnorm, block, counters, routed,
                       json.loads(sys.argv[1]), smi(), seconds)
    res["seconds"] = seconds
    GROUP_OUT.write_text(json.dumps(res, default=_jsonable))


def group_start(prep_secs: dict) -> subprocess.Popen:
    """:func:`group_main` in a child process, started; its output goes to
    this process's."""
    GROUP_OUT.unlink(missing_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.group_main()",
         json.dumps(prep_secs), repr(START)], cwd=ROOT,
        start_new_session=True)
    _BACKGROUND.append(proc)
    return proc


def group_result(proc: subprocess.Popen) -> dict:
    """The result of :func:`group_start`'s child once it has ended; raises
    if it failed."""
    try:
        rc = proc.wait(timeout=GROUP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _stop_background()
        raise AssertionError(f"phases 11-17 did not end within "
                             f"{GROUP_TIMEOUT_S} s")
    if rc or not GROUP_OUT.exists():
        raise AssertionError(f"phases 11-17 failed ({rc}); their output "
                             f"is above")
    return json.loads(GROUP_OUT.read_text())


def lap(seconds: dict, name: str, t0: float) -> None:
    """A phase's seconds since ``t0``, recorded and printed; on stderr too,
    with the seconds since the script started, so that the end of a cut
    run's stderr says how far it got."""
    seconds[name] = time.perf_counter() - t0
    print(f"{name}: {seconds[name]:.1f} s", flush=True)
    print(f"chip_smoke {name}: {seconds[name]:.1f} s, "
          f"{time.perf_counter() - START:.1f} s since the start",
          file=sys.stderr, flush=True)


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
    # phase 12's host work needs no kernel: it runs beside the build
    prep_kid = prep_start()
    seconds = {}
    t0 = time.perf_counter()
    build_s = _build.build()
    lap(seconds, "kernel build", t0)
    t0 = time.perf_counter()
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
    sass = {}
    # one cuobjdump per library, side by side
    names = list(dict.fromkeys(lib for lib, *_ in TC_KERNELS))
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(
            lambda lib: sass_ops(_build.lib_path(lib)), names)))
    for lib, kernel, count, need, never in TC_KERNELS:
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
    lap(seconds, "tensor-core opcodes", t0)
    t0 = time.perf_counter()
    rows = check_kernels(torch, F, ops, instnorm, conv3x3, block)
    rows += check_backward_kernels(torch, F, ops, instnorm, conv3x3, block)
    rows += check_mma_kernels(torch, F, ops, conv_mma)
    lap(seconds, "phases 2-2c", t0)
    counters, routed = kernel_counters()
    t0 = time.perf_counter()
    serve = serve_modes(torch, ops, counters, routed)
    lap(seconds, "phase 3", t0)
    t0 = time.perf_counter()
    train = train_modes(torch, ops, counters, routed)
    w8 = train_w8(torch, ops, counters, routed)
    lap(seconds, "phase 4", t0)
    t0 = time.perf_counter()
    bench = microbench(torch, counters)
    lap(seconds, "phase 5", t0)
    t0 = time.perf_counter()
    fit = fit_loop(torch, ops, counters, routed, train, card)
    lap(seconds, "phase 6", t0)
    # phases 11-17 in a process of their own, beside 7-10, 18 and 19, on
    # phase 6's tree and phase 12's PNG tree
    group = group_start(json.loads(background_line(prep_kid, "PREP ", 600)))
    t_group = time.perf_counter()
    t0 = time.perf_counter()
    gan = gan_phase(torch, ops, counters, routed)
    lap(seconds, "phase 7", t0)
    t0 = time.perf_counter()
    dispatch = dispatch_phase(torch, ops, counters, routed, card)
    lap(seconds, "phase 8", t0)
    t0 = time.perf_counter()
    zoo = zoo_phase(torch, ops, counters, routed, card)
    lap(seconds, "phase 9", t0)
    t0 = time.perf_counter()
    m3l_dtc = m3l_dtc_phase(torch, ops, counters, routed, card, instnorm,
                            conv3x3, block)
    lap(seconds, "phase 10", t0)
    t0 = time.perf_counter()
    pk = pk_phase(torch, F, ops, instnorm, conv3x3, counters, routed, card)
    lap(seconds, "phase 18", t0)
    t0 = time.perf_counter()
    wp = wp_phase(torch, F, ops, instnorm, conv3x3, counters, routed, card)
    lap(seconds, "phase 19", t0)
    t0 = time.perf_counter()
    groups = group_result(group)
    lap(seconds, "the wait for phases 11-17", t0)
    seconds["phases 11-17"] = time.perf_counter() - t_group
    seconds.update({f"group {k}": v for k, v in groups.pop("seconds").items()})
    dp, prep, sp, tp, spz, spb, tpz = (groups[k] for k in (
        "dp", "prep", "sp", "tp", "spz", "spb", "tpz"))
    dp_world1_report(dp["world1"], dispatch["timing"], card)
    shutil.rmtree(FIT_DIR, ignore_errors=True)
    rows += sp["rows"] + spb["rows"] + pk["rows"] + wp["rows"]
    # phase 18c's and 19c's replayed iterations, packed and unpacked
    pk_runs = tuple(v[p] for v in (*pk["numbers"].values(),
                                   *wp["numbers"].values())
                    for p in ("2", "0"))
    sp_r0 = sp["two_ranks"]["ranks"][0]
    sp_runs = ({"launches": {k: v * SP_STEPS for k, v in
                             sp_r0["unet"]["launches"].items()}},
               sp_r0["gan"])
    # a model rank's runs of phase 14 (rank 0): the U-Net in both block
    # modes, the GAN's steps
    tp_r0 = tp["two_ranks"]["ranks"][0]
    tp_runs = (*({"launches": {k: v * TP_STEPS for k, v in
                               tp_r0[f"unet_{m}"]["launches"].items()}}
                 for m in ("off", "on")), *tp_r0["gan"]["steps"])
    # a space rank's runs of the zoo (phase 15, rank 0): its launches
    # summed over the steps
    spz_runs = tuple(spz["two_ranks"]["ranks"][0][n] for n in SPZ_ZOO)
    # a space rank's runs of the fused blocks (phase 16a, rank 0)
    spb_runs = tuple(spb["two_ranks"]["ranks"][0][n] for n in ("unet", "gan"))
    # a model rank's runs of the zoo (phase 17a, rank 0): its launches
    # summed over the steps
    tpz_runs = tuple({"launches": {k: sum(s[k] for s in r["step_launches"])
                                   for k in KERNELS}}
                     for r in (tpz["ranks"][0][n] for n in TPZ_ZOO))

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
                dispatch["fits"]["unet"], dispatch["fits"]["uganConsis"],
                dispatch["predict"],
                *zoo["steps"].values(), *zoo["cli"].values(),
                *m3l_dtc["dtc"].values(), m3l_dtc["m3l"],
                m3l_dtc["m3l_cli"], *sp_runs, *tp_runs, *spz_runs,
                *spb_runs, *tpz_runs, *pk_runs)
        launches = sum(v["launches"][name] for v in runs)
        if launches < 1:
            raise AssertionError(f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if name in ("instnorm", "instnorm_bwd"):
            # the split form's passes on phase 13b's and 15a's rank 0:
            # its sums and apply launches, each pass's own count
            kind = "fwd" if name == "instnorm" else "bwd"
            split = {p: sum(v["launches"][f"instance_norm_{kind}_{p}"]
                            for v in (*sp_runs, *spz_runs, *spb_runs))
                     for p in ("sums", "apply")}
            if min(split.values()) < 1:
                raise AssertionError(f"{name}'s split form was not "
                                     f"launched on the main path")
            kernels[-1]["split_launches"] = split
        if name in ("block", "block_bwd"):
            # K3's and K6's split phases on phase 16a's rank 0
            phases = SPLIT_BLOCK[:3] if name == "block" else SPLIT_BLOCK[3:]
            split = {p: sum(v["launches"][p] for v in spb_runs)
                     for p in phases}
            if min(split.values()) < 1:
                raise AssertionError(f"{name}'s split phases were not "
                                     f"launched on the main path")
            kernels[-1]["split_launches"] = split
        # a model rank's share of the launches (phase 14, rank 0), and
        # of the zoo's (phase 17a, rank 0)
        kernels[-1]["tp_rank_launches"] = sum(v["launches"][name]
                                              for v in tp_runs)
        kernels[-1]["tp_zoo_rank_launches"] = sum(v["launches"][name]
                                                  for v in tpz_runs)
        # per replayed iteration of each packed configuration (18c)
        kernels[-1]["packed_launches"] = {
            c: v["2"]["launches"][name] for c, v in pk["numbers"].items()}
        # per replayed iteration of each W configuration (19c)
        kernels[-1]["w_packed_launches"] = {
            c: v["2"]["launches"][name] for c, v in wp["numbers"].items()}
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
                   "data_parallel": json.loads(json.dumps(dp, default=str)),
                   "preparation": prep,
                   "spatial": json.loads(json.dumps(
                       {k: v for k, v in sp.items() if k != "rows"},
                       default=str)),
                   "tensor_parallel": json.loads(json.dumps(tp,
                                                            default=str)),
                   "spatial_zoo": json.loads(json.dumps(spz, default=str)),
                   "spatial_block": json.loads(json.dumps(
                       {k: v for k, v in spb.items() if k != "rows"},
                       default=str)),
                   "tensor_parallel_zoo": json.loads(json.dumps(
                       tpz, default=str)),
                   "packed": json.loads(json.dumps(
                       {k: v for k, v in pk.items() if k != "rows"},
                       default=str)),
                   "w_packed": json.loads(json.dumps(
                       {k: v for k, v in wp.items() if k != "rows"},
                       default=str)),
                   "seconds": seconds,
                   "kernels": kernels}, f, indent=1)
    shutil.rmtree(ROOT / "build" / "chip_smoke_serving", ignore_errors=True)
    print(f"seconds by phase: "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
