#!/usr/bin/env python3
"""GPU check of the PyTorch/CUDA port: builds the CUDA kernels, holds each
against its plain PyTorch version at every shape of its model's 256x256
path, then serves batches through the full-width SpectralTransformer and
AST, trains both, runs the training CLI and the evaluation protocol, and
checks where the time and the launches went.

    python3 chip_smoke.py            # needs one CUDA GPU; no arguments
    python3 chip_smoke.py --phase ast    # phases 1 (AST kernels only) and 6
    python3 chip_smoke.py --phase ast-train    # phases 1 (the same) and 7
    python3 chip_smoke.py --phase new    # phases 1 (the same) and 8
    python3 chip_smoke.py --phase new-train    # phases 1 (the same) and 9
    python3 chip_smoke.py --phase run    # phases 1 (Spectral kernels) and 10
    python3 chip_smoke.py --phase eval    # phases 1, 10 and 11
    python3 chip_smoke.py --phase parallel    # phases 1 and 12
    python3 chip_smoke.py --phase context    # phases 1 (AST kernels) and 13
    python3 chip_smoke.py --phase remat    # phases 1 and 14
    python3 chip_smoke.py --phase graph    # phases 1 and 15
    python3 chip_smoke.py --phase graph-parallel    # phases 1 and 16

Phases (any failure exits non-zero; nothing is caught and continued):
1. setup: card name and power limit, kernel build time, the count of
   tensor-core (HMMA) instructions in the SASS of ln_gdfn, ln_mdta,
   ln_leff, ln_leff_bwd, ln_gdfn_bwd, ln_mdta_bwd, window_attn and
   window_attn_bwd (``cuobjdump -sass``; none fails), TF32 off;
2. kernels: ln_gdfn and ln_mdta vs their plain versions at the five block
   shapes and the serving batch (and at two shapes with ragged edge tiles),
   in f32 and in bf16, each against the plain version on the same input, so
   both round at the same points; the error is scaled by the branch
   max|ref - x|, with weights that make the branch O(1); then times of
   kernel and plain version on the same inputs (every time in this script:
   TIMER_WARMUP untimed calls, then TIMER_REPEATS repeats of the timed
   calls between CUDA events, printed as the median of the repeats'
   medians with their spread);
3. model: ``batched_apply`` on a uint8 batch of 8 at 256x256 in bf16 through
   the kernels, launch counts read from a run that starts at zero (each
   block's call as ``fused_mdta.fwd_plan`` and ``fused_gdfn.fwd_launches``
   say: 11 a slice of the batch and one a call; one, or two where the
   hidden width is split over blocks), output
   checked against the plain-version model in f32 and in bf16, with limits
   shown to lie below what a model without its MDTA or GDFN branches
   produces; images/s;
4. backward kernels: ln_gdfn_bwd and ln_mdta_bwd vs autograd through the
   plain versions on the same input, dy and dtype (f32 and bf16), at the
   five block shapes with the train batch and at the two ragged shapes,
   every gradient's max abs error over its max|reference|; then median
   times of the backward launches alone (given the saved residuals) and of
   the plain versions' autograd backward;
5. train step: ``make_train_step`` (L1withColor, Adam lr 3e-4, clip 1.0) on
   the full-width model in bf16 at 256x256, batch 16: (a) launches of every
   kernel in one step, from zero (the forwards as in phase 3; ln_mdta_bwd:
   23 a slice of the batch and one a call, ``fused_mdta.bwd_plan``); (b)
   every used parameter has a
   finite,
   non-zero gradient and the dead ones exact zeros; (c) one step's
   gradients through the kernels vs the plain versions, f32 (TF32 off) and
   bf16, with limits shown to lie below what dropping every MDTA (or GDFN)
   branch moves; (d) three f32 steps' losses, kernels vs plain; (e) two
   backward passes give bit-equal gradients; (f) images/s and peak memory,
   kernels vs plain, in turns;
6. AST serving (AST@256, the JAX bench's second cell, default kwargs):
   (a) ln_leff and window_attn vs their plain versions at every AST@256
   shape, batch 8, f32 and bf16, and at ragged and small shapes, the error
   over max|branch| (ln_leff's y - x, window_attn's whole output), then
   times, and window_attn's dense variant beside one
   ``scaled_dot_product_attention`` call (the library yardstick; the
   sparse mix has none); (b) launches in one forward of the full-width AST
   at 256x256 batch 8 bf16 (18 ln_leff calls of four launches a slice of
   the batch, ``fused_leff.fwd_plan``; 10 window_attn of which 5 masked),
   from zero;
   (c) the model's output, kernels vs plain model, in f32 (TF32
   off) and bf16, with limits shown to lie below a quarter of what dropping
   every LeFF (or attention) branch moves, q projections scaled by 8 so the
   attention is far from uniform; (d) images/s and peak memory, kernels vs
   plain, in turns;
7. AST train step (``make_train_step``, L1withColor, Adam lr 3e-4, clip 1.0,
   DropPath from a seeded generator, bf16, batch 16): (a) ln_leff_bwd vs
   autograd through the plain version at every AST@256 shape (batch 16) and
   at edge shapes (ragged tiles, C = 8, a hidden width that is not a
   multiple of 32, no residual, s with zeros and 1.25), and window_attn_bwd
   vs the plain recompute (``window_attention_bwd``) at every AST@256
   attention shape (batch 16, masked and not) and at the edge shapes, f32
   and bf16, every gradient's max abs error over its max|ref|, then times;
   (b) launches in one step (18 ln_leff calls of four launches a slice of
   the batch, 18 ln_leff_bwd calls of seven, ``fused_leff.fwd_plan`` and
   ``bwd_plan``, 10 window_attn of which 5 masked, 10 window_attn_bwd
   calls of three launches, the plain recompute never called), every
   gradient finite and non-zero;
   (c) one step's gradients through the kernels vs the plain versions with
   the same DropPath draws, f32 and bf16, with limits shown to lie below a
   quarter of what dropping every LeFF branch moves; (d) three f32 steps'
   losses, kernels vs plain; (e) two bf16 backward passes bit-equal; (f)
   images/s and peak memory, kernels vs plain, in turns;
8. New* serving (NewModel@256, embed 32, window 8, 4 heads; the JAX
   bench's NewModel-Wavelet@256 cell and the CLI's default Fourier mode):
   (a) window_attn vs its plain version at every NewModel@256 attention
   shape (batch 8; N = 64, d = 16, 32, 64, 128, 128; f32 and bf16, sparse
   and dense) and at a ragged N = 16, d = 128 window, ln_leff with
   residual=False at the four encoder shapes, then times, the dense
   variant beside one ``scaled_dot_product_attention`` call; (b) launches
   in one bf16 forward of NewModel-Wavelet at batch 8, from zero (9 ln_leff
   calls as ``fused_leff.fwd_plan`` says, 10 window_attn, none masked);
   (c) the model's output, kernels vs plain model, f32 (TF32 off) and bf16
   (within twice the bf16 plain model's own distance from the f32 one),
   Wavelet and Fourier, relative L2, each limit at most a quarter of what
   dropping every token MLP (or attention) branch moves, q projections
   scaled by 2, LayerNorm affines perturbed; (d) images/s and peak memory,
   kernels vs plain, in turns (Wavelet); (e) one forward of
   NewBigModel-Wavelet@512 (batch 2) and of NewBigFRFNModel-Fourier@512
   (batch 1) against the plain model, f32 and bf16 as in (c) (q at the
   reference init's scale; the quarter rule on the f32 check alone), with
   their launch counts;
9. the NewModel-Wavelet@256 train step (bf16, batch 16, DropPath from a
   seeded generator): (a) window_attn_bwd vs the plain recompute at the
   8(a) shapes and the ragged window, ln_leff_bwd with residual=False at
   the encoder shapes, f32 and bf16, then times; (b) launches in one step
   as the planners say, the plain recompute never called, every gradient
   finite and non-zero; (c) one step's gradients, kernels vs plain, same
   DropPath draws, limits below a quarter of what dropping a branch moves;
   (d) three f32 losses; (e) two bf16 backward passes bit-equal; (f)
   images/s and peak memory, kernels vs plain, in turns;
10. the training run: the port's CLI (``cli.main.main``) trains the
   full-width SpectralTransformer at 256x256 (bf16, L1withColor, Adam lr
   3e-4, batch 16 over 40 pairs, so the final batch is padded; validation
   over 16 pairs at batch 8; the trainer sets cuDNN's deterministic mode,
   this script does not): run A
   trains 3 epochs with the watch histograms every 2nd step, run B 2
   epochs and run C resumes B for the third. (a) the launches of C's
   epoch are its steps' (as phase 5 counts a step) and its validation
   forwards' (as phase 3 counts a forward), and no plain version runs;
   (b) A's final parameters, Adam state, loader state and losses are
   bit-equal to B + C's; (c) best/ and latest/ hold the steps the rule
   says, and ``ModelTrainer.evaluate`` on A's best gives the PSNR and SSIM
   logged for that epoch; (d) ``--evaluate`` writes one image a test
   input; (e) metrics.jsonl holds the train and test keys and the 64-bin
   histograms.  Then a probe of the loop's overhead over 128 pairs of
   1280x720 JPEGs (decoded and resized every epoch) with 4 decode threads,
   with 1 and over the decoded cache, against the bare step on one
   preloaded batch, and the 4-thread loop and the bare step again with
   cuDNN's default algorithms (the price of the deterministic mode), in
   turns.  Prints the loop's images/s an epoch beside the bare step's in
   the same call, the validation time and peak memory;
11. the evaluation protocol (``eval.main``): (a) ``pairs`` at the JAX CLI's
   defaults (NewBigModel-Wavelet built for 1024x1024, batch 8, bf16) from a
   checkpoint directory over 16 synthetic JPEG pairs: the memory expected
   from one image's forward and the peak, ln_leff and window_attn launches
   as ``new_launches`` says for each batch and no plain version called,
   one pred/ref PNG pair an input, the printed average PSNR, images/s of
   the command and of the forward alone, two images vs the plain model at
   batch 1 (relative L2: f32 1e-4; bf16 within twice the bf16 plain
   model's own distance from the f32 one), and both kernels at the model's
   1024x1024 shapes vs their plain versions (bf16) and timed; (b) ``infer``
   from phase 10's ``best/`` checkpoint directory; (c) ``ssim-psnr`` (SSIM
   on the card within 1e-5 of the CPU's) and ``uiqm`` over (a)'s pairs;
   (d) every loss name at 256x256, batch 4, f32: value and gradient on the
   card vs the CPU (1e-4 of max|ref|; the perceptual family's gradient in
   relative L2, 1e-2), then ``loss-sanity``; (e) the SpectralTransformer
   train step (batch 16, bf16) with fflMix and ssimFFLCharbonnier in turns
   with L1withColor: launches as phase 5 counts, fflMix's five components
   finite, images/s and peak memory; then a CLI epoch with ``--lossf
   fflMix`` whose metrics.jsonl holds the components;
12. parallelism and export (``parallel_phase``): (a) the 2-rank
   data-parallel train step of the full-width SpectralTransformer@256
   (bf16, global batch 16; two processes sharing the card over gloo, or a
   card a rank over nccl): each rank's launches from zero as the planners
   say for batch 8, loss and gradients vs the one-rank step in bf16 at
   batch 16 and in f32 at batch 4 within phase 5(c)'s gradient and 5(d)'s
   loss limits, images/s and peak memory a rank beside the one-rank
   step's, in turns; (b) FSDP2 over the same ranks: its gradients vs the
   data-parallel step's, its checkpoint (single-device format) loaded
   strict on one device giving the sharded model's forward; (c)
   ``torch.export`` of SpectralTransformer@256, AST@256 and
   NewModel-Wavelet@256 (bf16, symbolic batch): custom-op nodes as the
   planners' kernel calls (24 + 24; 18 + 10; 9 + 10), the program vs the
   eager forward at batch 8 and 3 within 1e-6 with the eager launches,
   reloaded in a fresh process that launches the
   kernels, its images/s beside eager ``batched_apply``'s in turns there;
   (d) Grad-CAM through the kernels and SFCA on the card vs the CPU, f32;
13. context and tensor parallelism (``context_phase``; two processes
   sharing the card over gloo, mesh 1 x 2: correctness and the host's
   round trips, not scaling): (a) the context-parallel train step of
   AST@256 (default kwargs, bf16, batch 16; each rank its band of the
   images' rows): each rank's launches of ln_leff, ln_leff_bwd,
   window_attn and window_attn_bwd from zero as the planners say for its
   band with its halo row (``cp_launches``), no plain version called,
   loss and gradients vs the one-rank step within phase 7's limits (bf16
   at batch 16, f32 at batch 4), images/s and peak memory a rank beside
   one rank's, in turns; (b) the same for NewModel@256 in the Fourier
   (the distributed token FFT, FDFP's ``sharded_fft2``) and Wavelet modes
   within phase 9's limits; (c) ``--shard-params context`` (FSDP2 over the
   context dimension): its gradients vs (a)'s, its checkpoint loaded
   strict on one device giving the sharded model's f32 forward; (d) the
   CLI under ``torchrun --nproc-per-node 2 ... -a AST --mesh-context 2``
   for one epoch over synthetic pairs (f32, TF32 off), its logged
   validation vs a one-process ``evaluate`` of its checkpoint; (e) the
   primitives (halo exchange, roll, the rank's window attention, Ulysses,
   the distributed FFT, a halo'd conv, LN+LeFF on a band) on CUDA tensors
   vs the one-process ops;
14. rematerialization (``remat_phase``; ``init_model(remat=True,
   remat_policy=...)``, bf16, cuDNN's deterministic algorithms): (a) the
   full-width SpectralTransformer at 1024x1024 (the reference's train
   resolution), batch 2 and 8, remat off, full and dots, each run after the
   peak a batch-1 step says it will reach (left out where that does not
   fit): launches from zero as phase 5 counts them (no Spectral block
   recomputes on the kernels; the three UpS do), no plain version, batch 2
   gradients bit-equal to remat off, peak memory and images/s in turns;
   (b) AST@256 and NewModel-Wavelet@256 at batch 16 with DropPath from a
   seeded generator a mode: launches from zero as the planners say, each
   checkpointed block's ln_leff and window_attn once more, no plain
   version, gradients after two steps bit-equal to remat off and the
   generators' states equal, peak memory lower under full, images/s in
   turns; (c) the first train steps of NewBigModel-Wavelet@512 and
   NewBigFRFNModel-Fourier@512 (batch 2), remat off and full: expected and
   measured peaks, gradients finite and bit-equal, images/s; (d) one CLI
   epoch of SpectralTransformer at 1024x1024, batch 2, ``--remat
   --remat-policy dots`` logs the losses of the run without ``--remat``;
15. the K-step dispatch (``graph_phase``; ``make_train_step(k_steps=4)``:
   the first call's steps eager, then one CUDA graph of the step captured
   and replayed; bf16, L1withColor, Adam 3e-4 built capturable, clip 1.0,
   256x256, batch 16, cuDNN deterministic): (a) SpectralTransformer, (b)
   AST with DropPath at its rates, (c) NewModel-Wavelet, (d) AST with
   per-block remat (full): three calls of four steps against twelve eager
   single steps from the same state, losses, grad norms, parameters (and
   generator states; in (d) the gradients) bit-equal, the kernels'
   tallies during the capture equal to one step's launches as the
   planners say and still during the replays, no plain version, images/s,
   host ms a step, peak memory and the capture's seconds of graph and
   eager in turns; (e) the CLI (``-a SpectralTransformer --image-size 256
   --train-batch-size 2 --max-epoch 2 --steps-per-dispatch 4`` over 10
   synthetic pairs: a group and a remainder an epoch, the learning rate
   falling after the first) logs losses within GRAPH_CLI_TOL of the run at
   ``--steps-per-dispatch 1``, with one capture a learning rate;
16. the K-step dispatch over two data ranks (``graph_parallel_phase``; two
   processes sharing the card over gloo, ``make_train_step(parallel=dp,
   k_steps=4)``: the first call eager, then the step captured as CUDA
   graphs cut at its collectives, which run eagerly between the replays;
   bf16, Adam 3e-4 capturable, 256x256, global batch 16): (a)
   SpectralTransformer, L1withColor, (b) AST with DropPath, (c)
   SpectralTransformer with an Adaptive loss (a cut inside the loss):
   three calls against twelve eager two-rank steps from the same state,
   losses, grad norms, parameters and generator bit-equal on each rank and
   equal across the ranks, the capturing call's tallies one step's at
   batch 8, none in the replays, the collectives' tape the same on both
   ranks and one graph more than its collectives; (d) FSDP2 and two
   context ranks at K = 4 against K = 1 (the ``stepwise`` route); (e)
   images/s, host ms a step and peak memory of the cut graphs, the eager
   two-rank steps and one rank's graph at the global batch, in turns; (f)
   the CLI under ``torchrun --nproc-per-node 2 ... --mesh-data 2`` at
   ``--steps-per-dispatch 4`` and 1: logged losses within GRAPH_CLI_TOL,
   route ``segments``, one capture a learning rate.
The last line is the JSON device record; the line before it the kernels'.
"""
import argparse
import collections
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import time

SHAPES = ((16, 256, 256, 1), (32, 128, 128, 2), (64, 64, 64, 4),
          (128, 32, 32, 8), (32, 256, 256, 1))   # (C, H, W, heads)
# SpectralBlocks of the 256x256 model at each shape (encoder, latent,
# decoder and refinement levels): 24 in all
BLOCKS = {(16, 256, 256): 2, (32, 128, 128): 6, (64, 64, 64): 6,
          (128, 32, 32): 4, (32, 256, 256): 6}
# ragged tiles at the bottom and right edges; checked, not timed
EDGE_SHAPES = ((32, 20, 36, 2), (128, 12, 20, 8))
EXPANSION = 2.66
# f32: the kernel and the plain version sum the same products in another
# order (9C-deep contractions, gram sums over up to 65536 pixels); bf16: both
# round to bf16 at the same points, and a sum that lands on the other side of
# a rounding boundary moves y by one bf16 ulp of |y| (1/32 at |y| in [4, 8)).
# Scaled by max|ref - x|, the branch: a kernel that skipped the branch would
# score 1, one that scaled it by 0.95 about 5e-2.  Readings on an H100 at
# these shapes: f32 at most 8.1e-6, bf16 at most 1.16e-2.
KERNEL_TOL = {"float32": 5e-5, "bfloat16": 2e-2}
# model, absolute on the [-1, 1] output: kernels vs the plain model in the
# same dtype through 24 blocks, cuFFT and cuDNN (TF32 off).  Each must be at
# most a quarter of how far the output moves without the MDTA branches, or
# without the GDFN ones (3.4e-2 and 7.8e-2 on an H100).  Readings there:
# f32 5.6e-6, bf16 2.4e-3.
MODEL_TOL = {"float32": 5e-5, "bfloat16": 5e-3}
# attention temperature of every block in the model phase: torch's default
# (1) leaves the softmax near uniform, where dropping every MDTA branch moves
# the output by about as much as bf16 rounding does
MODEL_TEMPERATURE = 16.0
# backward kernels vs autograd through the plain version in the same dtype:
# per gradient tensor, max abs error over max|reference gradient|.
# Weight gradients are sums over up to a million pixels; in bf16 both sides
# round the same cotangents (the gate's, the LN output's, q/k's ...) and a
# rounding that lands on the other side of a boundary moves its whole
# contribution by one bf16 ulp.  A gradient term scaled by 0.95 scores about
# 5e-2.  Readings on an H100 at these shapes: f32 at most 1.75e-5 (dtemp of
# a gram over 65536 pixels), bf16 at most 8.4e-3 (dx; weight gradients at
# most 1.6e-3).
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# train step, one step's gradients through the kernels vs the plain
# versions, ||g - g_ref|| / ||g_ref|| over every parameter; each must be at
# most a quarter of how far the gradients move without the MDTA branches,
# or without the GDFN ones (at least 0.46 and 1.0 on an H100).  Readings
# there over six runs: f32 2.9e-5 to 7.6e-5 (24 blocks of f32 sums in
# another order, through softmaxes at temperature 16), bf16 1.5e-2 to
# 3.4e-2 (bf16 rounding through 24 blocks, both ways).
TRAIN_GRAD_TOL = {"float32": 3e-4, "bfloat16": 8e-2}
# three f32 train steps' losses, kernels vs plain, relative.  Adam's first
# steps move a weight by about lr * sign(g), so a last-bit difference in a
# near-zero gradient moves it by 2 lr.  Readings on an H100 over eight runs
# with cuDNN's default algorithms, whose sums are not bit-reproducible:
# 1.1e-6 to 2.2e-4.  Phase 5 now runs cuDNN deterministic, so the reading
# repeats.
TRAIN_LOSS_TOL = 3e-4
# batch of the gradient and loss comparisons (c, d): the plain versions'
# autograd keeps every intermediate, about 4 GB an image in f32 at 256x256
CHECK_BATCH = 4
LR = 3e-4
# AST@256, default kwargs (embed 32, win 8): LN+LeFF at (C, H = W), hidden
# 4C, two blocks a level; window attention (N = 64 tokens, d = 32) at
# (windows an image, heads), two blocks a level, the second shifted (masked)
LEFF_SHAPES = ((32, 256), (64, 128), (128, 64), (256, 32), (512, 16),
               (512, 32), (256, 64), (128, 128), (64, 256))
ATTN_SHAPES = ((1024, 2), (256, 4), (64, 8), (16, 16), (4, 16))
AST_WIN, AST_HEAD_DIM = 8, 32
# checked, not timed: LN+LeFF at C = 8 on 20x36 (ragged tiles), with and
# without the residual and a per-image scale; window attention at N = 16,
# d = 8 (masked, sparse) and N = 4 (dense): (windows, heads, ws, d)
LEFF_EDGE = (8, 20, 36)
ATTN_EDGE = ((16, 2, 4, 8, True, True), (4, 16, 2, 8, False, False))
# AST kernels vs plain versions, max abs error over max|branch| (y - x for
# ln_leff, the output for window_attn); f32: sums in another order; bf16:
# both round at the same points, a sum on the other side of a rounding
# boundary moves one bf16 ulp.  Readings on an H100: f32 at most 2.0e-6
# (ln_leff) and 1.1e-7 (window_attn), bf16 at most 7.0e-3 and 1.7e-3; a
# copy whose kernel scaled its output by 1.05 in one dtype read 5.0e-2 to
# 5.1e-2 and failed at the first shape.
AST_KERNEL_TOL = {"float32": 5e-5, "bfloat16": 2e-2}
# AST model, absolute on the output (|y| up to ~3.5 with the q scaling
# below), kernels vs plain model in one dtype through 18 blocks; each at
# most a quarter of how far dropping every LeFF (or attention) branch moves
# the output (4.7 and 2.8 on an H100).  Readings there: f32 1.1e-5, bf16
# 6.3e-2 (four bf16 ulps at |y| in [2, 4): one-ulp flips carried through
# the blocks)
AST_MODEL_TOL = {"float32": 1e-4, "bfloat16": 0.25}
# to_q scale in the AST model phase: the reference init (trunc_normal 0.02)
# leaves the window softmax nearly flat, where a wrong attention kernel
# would pass; scaled by 8, the scores have std ~1.6
AST_Q_SCALE = 8.0
# AST train step, one step's gradients through the kernels vs the plain
# versions with the same DropPath draws, ||g - g_ref|| / ||g_ref|| over
# every parameter; each at most a quarter of how far the gradients move
# without the LeFF branches (0.90 on an H100).  Readings there over two
# runs: f32 2.3e-7 (18 blocks of f32 sums in another order), bf16 1.0e-3
# and 1.1e-3 (the kernels and autograd round cotangents at other points).
AST_TRAIN_GRAD_TOL = {"float32": 3e-4, "bfloat16": 1e-2}
# ln_leff_bwd edge shapes, checked, not timed: (C, H, W, hidden, residual,
# s): ragged tiles in both dtypes' tiles, C = 8, hidden 40 (not a multiple
# of the 32-channel padding), no residual, s with zeros and 1.25
LEFF_BWD_EDGE = ((8, 20, 36, 40, True, (1.25, 0.0)),
                 (8, 20, 36, 32, False, (0.0, 1.25)),
                 (256, 12, 20, 1024, False, (1.25, 0.5)),
                 (512, 10, 10, 2048, True, None))
LEFF_GRADS = ("dx", "dscale", "dbias", "dw1", "db1", "dw_dw", "db_dw", "dw2",
              "db2")
AST_PARAMS = 19_919_507  # AST@256 at the default kwargs
# NewModel@256 (embed 32, one block a level, window 8, 4 heads, no shift,
# LeFF): window attention (N = 64) at (windows an image, head width) of
# decoders 0-3 and the bottleneck, a self- and a cross-attention each; its
# LN+LeFF calls at (C, H = W), the encoders' without the residual, the
# decoders' and the bottleneck's with it
NEW_ATTN_SHAPES = ((1024, 16), (256, 32), (64, 64), (16, 128), (4, 128))
NEW_HEADS = 4
NEW_ENC_LEFF = ((32, 256), (64, 128), (128, 64), (256, 32))
NEW_DEC_LEFF = ((64, 256), (128, 128), (256, 64), (512, 32), (512, 16))
# checked, not timed: a ragged window (N = 16) at d = 128, masked, sparse:
# (windows an image, heads, ws, d, masked, sparse)
NEW_ATTN_EDGE = (4, 2, 4, 128, True, True)
NEW_PARAMS = 23_307_647  # NewModel@256 at the default kwargs
# to_q scale in the New* model phases: the reference init (torch's default
# Linears) leaves scores of std about 0.33, a nearly flat softmax; scaled by
# 2 they have std about 0.67 (by 4, the sparse mix's unnormalised relu²
# term sends NewModel's outputs past 1e3 and its bf16 forward 8e-2 to 1.1
# from its f32 one, the big models' past 1).  The LayerNorm affines are
# perturbed too (1 + 0.1 N(0, 1), 0.1 N(0, 1)): at ones and zeros the
# Wavelet branch's channel sum of a LayerNorm output cancels to roundoff
NEW_Q_SCALE = 2.0
# the big models (512x512, two blocks a level) at q scale 2 are chaotic on
# the synthetic images: their bf16 plain forward sits 0.5 from the f32 one
# and their f32 forwards agree only to 7e-5; 8(e) runs them at the
# reference init's scale
NEW_BIG_Q_SCALE = 1.0
# New* models, ||out - ref|| / ||ref|| of the output, kernels vs plain
# model in one dtype; each limit at most a quarter of how far dropping every
# token MLP (or every window attention) branch moves the output.  f32: sums
# in another order (1.0e-6 and 4.0e-6 read on an H100).  bf16: both round
# at their own points and the model carries a flip on (a bf16 LayerNorm
# output moves the Wavelet branch's channel sum, the Fourier branch rounds
# the (L, C)-token FFT's large values), so the kernels' output must stay
# within NEW_BF16_FLOOR times the bf16 plain model's own distance from the
# f32 plain model: the kernels add no more than the model's bf16
# arithmetic does (readings there, kernels vs bf16 plain and bf16 plain vs
# f32 plain: Wavelet 6.5e-3 and 7.8e-3, Fourier 2.7e-2 and 4.2e-2)
NEW_MODEL_TOL = 1e-4
NEW_BF16_FLOOR = 2.0
# NewModel train step, one step's gradients through the kernels vs the
# plain versions with the same DropPath draws, ||g - g_ref|| / ||g_ref||;
# each at most a quarter of how far the gradients move without the LeFF
# (or attention) branches (at least 0.99 on an H100).  Readings there: f32
# 2.2e-6; bf16 2.2e-2 (the LayerNorm biases' gradients, sums of cotangents
# that cancel, lead), the bf16 plain model itself 9.1e-2 from the f32 one
NEW_TRAIN_GRAD_TOL = {"float32": 3e-4, "bfloat16": 8e-2}
HBM_BYTES_PER_S = 3.35e12
# every per-call time: TIMER_WARMUP untimed calls (build, autotune, caches),
# then TIMER_REPEATS repeats of the timed calls; the median of the repeats'
# medians is reported with their spread (least and greatest)
TIMER_WARMUP = 3
TIMER_REPEATS = 3
BF16_PEAK_FLOPS = 989e12  # dense tensor-core peak
REPLACES = {
    "ln_gdfn": "underwater_image_restoration_tpu/ops/fused_gdfn_banded.py:479",
    "ln_mdta": ("underwater_image_restoration_tpu/ops/fused_attn_composed.py:"
                "523; underwater_image_restoration_tpu/ops/"
                "fused_attn_banded.py:648"),
    "ln_gdfn_bwd": ("underwater_image_restoration_tpu/ops/"
                    "fused_gdfn_banded.py:517; underwater_image_restoration"
                    "_tpu/ops/fused_block.py:663"),
    "ln_mdta_bwd": ("underwater_image_restoration_tpu/ops/"
                    "fused_attn_composed.py:574; underwater_image_restoration"
                    "_tpu/ops/fused_attn_banded.py:707; underwater_image_"
                    "restoration_tpu/ops/fused_attn.py:560"),
    "ln_leff": "underwater_image_restoration_tpu/ops/fused_leff.py:301",
    "ln_leff_bwd": "underwater_image_restoration_tpu/ops/fused_leff.py:337",
    "window_attn": "underwater_image_restoration_tpu/ops/pallas.py:110",
    "window_attn_bwd": "underwater_image_restoration_tpu/ops/pallas.py:191",
}
# libraries whose products run on the tensor cores (csrc/mma.cuh,
# csrc/gemm.cuh, csrc/wattn.cuh), and the count of HMMA instructions found
# in each one's SASS by this run
TENSOR_CORE_LIBS = ("ln_gdfn", "ln_mdta", "ln_leff", "ln_leff_bwd",
                    "ln_gdfn_bwd", "ln_mdta_bwd", "window_attn",
                    "window_attn_bwd")
HMMA = {}
GRAD_NAMES = {
    "ln_gdfn": ("dx", "dscale", "dbias", "dw_in", "dw_dw", "dw_out"),
    "ln_mdta": ("dx", "dscale", "dbias", "dw_qkv", "dt_qkv", "dtemp",
                "dw_po", "dw_kv", "dt_kv", "dw_pof"),
}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


class Timing(collections.namedtuple("Timing", "ms lo hi")):
    """A per-call time in ms: the median of TIMER_REPEATS repeats' medians,
    and the least and greatest of those medians (the spread)."""

    def __str__(self):
        return f"{self.ms:.4f} ms [{self.lo:.4f}-{self.hi:.4f}]"


def median_ms(fn, reps=20, warmup=TIMER_WARMUP, repeats=TIMER_REPEATS):
    """CUDA-event time of one call of fn: ``warmup`` untimed calls, then
    ``repeats`` repeats of ``reps`` timed calls, each call between two
    events; the median of each repeat, and their median and spread."""
    import torch

    for _ in range(warmup):
        fn()
    meds = []
    for _ in range(repeats):
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        meds.append(times[len(times) // 2])
    meds.sort()
    return Timing(meds[len(meds) // 2], meds[0], meds[-1])


def timing_row(ms, pms, bms, by, err):
    """A kernel's row: its and the plain version's median times with their
    spreads, its bound and max abs error."""
    return dict(max_abs_err=err, ms=ms.ms, ms_spread=[ms.lo, ms.hi],
                plain_ms=pms.ms, plain_ms_spread=[pms.lo, pms.hi],
                bound_ms=bms, bound_by=by)


def block_inputs(c, h, w, nh, batch, seed):
    """Seeded input and block weights, drawn on the host and moved to the
    card.  x ~ N(0, 1); every 1x1 is N(0, 1/fan_in) and every 3x3 tap
    N(0, 1/9), so each keeps unit variance; LN affine perturbed, temperatures
    about 16 (a peaked softmax) and project_outf times 4: both branches
    y - x are O(1) beside x."""
    import torch

    g = torch.Generator().manual_seed(seed)
    hid = int(c * EXPANSION)

    def n(*shape, fan_in=1):
        return torch.randn(shape, generator=g) / fan_in ** 0.5

    x = n(batch, c, h, w)
    ln = (1 + 0.1 * n(c), 0.1 * n(c))
    mdta = (n(c, 3 * c, fan_in=c), n(3, 3, 3 * c, fan_in=9),
            16 * (1 + 0.2 * n(1, nh, 1, 1)), n(c, c, fan_in=c),
            n(c, 2 * c, fan_in=c), n(3, 3, 2 * c, fan_in=9),
            4 * n(c, c, fan_in=c))
    gdfn = (n(c, 2 * hid, fan_in=c), n(3, 3, 2 * hid, fan_in=9),
            n(hid, c, fan_in=hid))
    return tuple(t.cuda() if torch.is_tensor(t) else tuple(a.cuda() for a in t)
                 for t in (x, ln, mdta, gdfn))


def work(name, c, h, w, nh, batch, itemsize):
    """(bytes, flops) the function needs at least: x read once, y written
    once, weights read once; the multiply-adds of the unfolded chains
    (1x1 then depthwise 3x3, the cheaper order)."""
    px = batch * h * w
    hid = int(c * EXPANSION)
    act = 2 * batch * c * h * w * itemsize
    if name == "ln_gdfn":
        wbytes = 4 * (2 * c + 2 * hid * c + 9 * 2 * hid + hid * c)
        flops = px * (2 * c * 2 * hid + 2 * 9 * 2 * hid + 2 * hid * c)
    else:
        cph = c // nh
        wbytes = 4 * (2 * c + 3 * c * c + 27 * c + nh + c * c + c * c
                      + 9 * c + c * c)
        flops = px * (2 * c * 3 * c + 2 * 9 * 3 * c      # q, k, v
                      + 2 * c * cph + 4 * c              # gram, Sq, Sk
                      + 2 * 2 * c * cph                  # A v, A vf
                      + 2 * c * c + 2 * c * c + 2 * 9 * c  # out, vf
                      + 2 * c * c)                       # project_outf
    return act + wbytes, flops


def work_bwd(name, c, h, w, nh, batch, itemsize):
    """(bytes, flops) the backward needs at least: x and dy read once, dx
    written once, weights read and their gradients written once (f32); the
    multiply-adds of the forward chains it recomputes (q, k, v, out, vf,
    outf; LN+GDFN's project_in and taps) and of the backward chains."""
    px = batch * h * w
    hid = int(c * EXPANSION)
    act = 3 * batch * c * h * w * itemsize
    if name == "ln_gdfn":
        wbytes = 2 * 4 * (2 * c + 2 * hid * c + 9 * 2 * hid + hid * c)
        flops = px * (2 * c * 2 * hid + 2 * 9 * 2 * hid      # recompute t
                      + 2 * hid * c                          # W_out dy
                      + 2 * 9 * 2 * hid + 2 * 9 * 2 * hid    # du, dtaps
                      + 2 * c * 2 * hid + 2 * 2 * hid * c    # dW_in, dLN
                      + 2 * hid * c)                         # dW_out
    else:
        cph = c // nh
        wbytes = 2 * 4 * (2 * c + 3 * c * c + 27 * c + nh + c * c + c * c
                          + 9 * c + c * c)
        fwd = (2 * c * 3 * c + 2 * 9 * 3 * c + 2 * 2 * c * cph
               + 2 * c * c + 2 * c * c + 2 * 9 * c)
        bwd = (4 * 2 * c * c                  # d_outf, d_out, d_outs, dW_pof
               + 2 * 2 * c * c                # dW_kvf, dW_po
               + 6 * 2 * c * cph              # dvf, dA (2), dv, dq, dk
               + 2 * 2 * 9 * c                # d(u_vf), dtaps_vf
               + 2 * 2 * 9 * 3 * c            # d(u_qkv), dtaps_qkv
               + 2 * 2 * c * 3 * c)           # dW_qkv, dLN
        flops = px * (fwd + bwd)
    return act + wbytes, flops


def work_ast(name, shape, batch, itemsize, d=AST_HEAD_DIM):
    """(bytes, flops) the AST kernels' functions need at least: activations
    read once and written once, f32 weights (ln_leff) or bias and mask
    (window_attn) read once; the multiply-adds of fc1, the taps and fc2, or
    of q kᵀ and P v (heads of d channels)."""
    if name == "ln_leff":
        c, h = shape
        hid, px = 4 * c, batch * h * h
        wbytes = 4 * (2 * c * hid + 9 * hid + 2 * hid + 3 * c)
        return (2 * px * c * itemsize + wbytes,
                px * (2 * c * hid + 2 * 9 * hid + 2 * hid * c))
    nw, heads, masked = shape
    n, bq = AST_WIN ** 2, batch * nw
    nbytes = (4 * bq * heads * n * d * itemsize + 4 * heads * n * n
              + (4 * nw * n * n if masked else 0) + 8)
    return nbytes, bq * heads * 4 * n * n * d


def work_attn_bwd(shape, batch, itemsize, d=AST_HEAD_DIM):
    """(bytes, flops) the window attention's backward needs at least: q, k,
    v and dO read once, dq, dk and dv written once, the f32 bias (and mask)
    read once, dbias written once, w and dw; the multiply-adds of its five
    N x N x d products (S, dP, dV, dq, dk): 10 N^2 d a (window, head)."""
    nw, heads, masked = shape
    n, bq = AST_WIN ** 2, batch * nw
    nbytes = (7 * bq * heads * n * d * itemsize + 2 * 4 * heads * n * n
              + (4 * nw * n * n if masked else 0) + 16)
    return nbytes, bq * heads * 10 * n * n * d


def attn_inputs(nw, heads, ws, d, b, masked, sparse, seed, dt):
    """q and kv in the projections' (B', N, heads * d) layout, heads as
    views (the model's layout); bias N(0, 1), mix weights (0.3, -0.4):
    the softmax far from flat."""
    import torch

    from underwater_image_restoration_torch.ops import shift_mask, split_heads

    g = torch.Generator().manual_seed(seed)
    n, bq, c = ws * ws, b * nw, heads * d
    q = torch.randn(bq, n, c, generator=g).cuda().to(dt)
    kv = torch.randn(bq, n, 2 * c, generator=g).cuda().to(dt)
    bias = torch.randn(heads, n, n, generator=g).cuda()
    side = ws * math.isqrt(nw)
    mask = shift_mask(side, side, ws, ws // 2, "cuda") if masked else None
    w = torch.tensor([0.3, -0.4]).cuda() if sparse else None
    return ((split_heads(q, heads), split_heads(kv[..., :c], heads),
             split_heads(kv[..., c:], heads), bias),
            dict(scale=d ** -0.5, sparse_w=w, mask=mask))


def sdpa_dense(args, kw):
    """The dense window attention (``sparse_w`` None) as one
    ``scaled_dot_product_attention`` call, the library yardstick: q, k, v
    laid out as (B' / nW, nW heads, N, d) and attn_mask = bias (+ mask) as
    (1, nW heads, N, N) in q's dtype (made here, outside the timed call).
    Returns the call and a function mapping its result to (B', heads, N,
    d)."""
    import torch

    q, k, v, bias = args
    mask = kw["mask"]
    bq, h, n, d = q.shape
    nw = 1 if mask is None else mask.shape[0]
    add = bias[None] if mask is None else bias[None] + mask[:, None]
    am = add.reshape(1, nw * h, n, n).to(q.dtype)
    qq, kk, vv = (t.reshape(bq // nw, nw * h, n, d).contiguous()
                  for t in (q, k, v))

    def call():
        return torch.nn.functional.scaled_dot_product_attention(
            qq, kk, vv, attn_mask=am, scale=kw["scale"])

    return call, lambda out: out.reshape(bq, h, n, d)


def work_leff_bwd(c, h, batch, itemsize):
    """(bytes, flops) the LN+LeFF backward needs at least: x and dy read
    once, dx written once, the f32 weights read and their gradients written
    once; the multiply-adds of the forward chain it needs (fc1, the taps;
    fc2's output is not needed) and of the backward's (dg2 = W2 dy, dW2,
    the transposed taps, dtaps, dW1, dLN): 10 C hid + 54 hid a pixel."""
    hid, px = 4 * c, batch * h * h
    wbytes = 2 * 4 * (2 * c * hid + 9 * hid + 2 * hid + 3 * c)
    return (3 * px * c * itemsize + wbytes,
            px * (10 * c * hid + 6 * 9 * hid))


def spectral_launches(batch, train=False, blocks=None, split=None,
                      gdfn=None):
    """The Spectral kernels' launches in one bf16 forward of the full-width
    model at ``batch`` (with ``train``, and its backward: ln_gdfn_bwd 2 a
    block, ln_mdta_bwd BWD_LAUNCHES a slice of the batch and one a call), by
    kernel and (C, H, W), as their planners say for ``blocks`` (BLOCKS, the
    whole maps', by default): {(C, H, W): blocks}.  Context parallelism:
    ``split``, {(C, H, W): (blocks, h_max)} of LN+MDTA calls on bands with
    their halo rows, through the split entries (stats and apply; stage 1
    and stage 2 in the slices of the tallest band, h_max rows); ``gdfn``,
    LN+GDFN's calls where they are not ``blocks``."""
    import torch

    from underwater_image_restoration_torch.ops import (
        _kernels,
        fused_gdfn,
        fused_mdta,
    )

    blocks = BLOCKS if blocks is None else blocks
    gdfn = blocks if gdfn is None else gdfn
    split = split or {}
    sms = _kernels.sm_count(torch.device("cuda"))
    out = {
        "ln_gdfn": {k: n * fused_gdfn.fwd_launches(
            batch, k[1], k[2], k[0],
            fused_gdfn.padded_hidden(int(k[0] * EXPANSION)), 2, sms)
            for k, n in gdfn.items()},
        "ln_mdta": {k: n * fused_mdta.fwd_plan(
            batch, k[1], k[2], k[0], 2).launches
            for k, n in blocks.items()}}
    for name, per in (("ln_mdta_stats", fused_mdta.FWD_STATS_LAUNCHES),
                      ("ln_mdta_apply", fused_mdta.FWD_APPLY_LAUNCHES)):
        out[name] = {k: n * (1 + per * fused_mdta.fwd_plan(
            batch, k[1], k[2], k[0], 2).slices)
            for k, (n, _) in split.items()}
    if train:
        out["ln_gdfn_bwd"] = {k: 2 * n for k, n in gdfn.items()}
        out["ln_mdta_bwd"] = {k: n * fused_mdta.bwd_plan(
            batch, k[1], k[2], k[0], 2, sms).launches
            for k, n in blocks.items()}
        for name, per in (("ln_mdta_bwd_stage1",
                           fused_mdta.BWD_STAGE1_LAUNCHES),
                          ("ln_mdta_bwd_stage2",
                           fused_mdta.BWD_STAGE2_LAUNCHES)):
            out[name] = {k: n * per * fused_mdta.bwd_rows_plan(
                batch, k[1], k[2], k[0], 2, sms, hm).slices
                for k, (n, hm) in split.items()}
    return {k: v for k, v in out.items() if v}


def grad_dist(g, r):
    """(||g - r|| / ||r||, max abs / max|r|) over r's parameters."""
    d = sum(float((g[n].float() - r[n].float()).square().sum()) for n in r)
    nr = sum(float(r[n].float().square().sum()) for n in r)
    top = max(float(r[n].abs().max()) for n in r)
    mx = max(float((g[n].float() - r[n].float()).abs().max()) for n in r)
    return (d / nr) ** 0.5, mx / top


def model_without(model, branch):
    """A copy of an AST or New* model with every token MLP's last Linear
    (LeFF's fc2, FRFN's linear2: branch "LeFF") or every window attention's
    output projection zeroed: what kernels that skipped the branch give."""
    from underwater_image_restoration_torch.models.blocks import (
        FRFN,
        LeFF,
        WindowAttentionSparse,
    )

    m = copy.deepcopy(model)
    for mod in m.modules():
        lin = (mod.linear2[0] if branch == "LeFF"
               and isinstance(mod, (LeFF, FRFN))
               else mod.proj if branch == "attention"
               and isinstance(mod, WindowAttentionSparse) else None)
        if lin is not None:
            lin.weight.data.zero_()
            lin.bias.data.zero_()
    return m


def grads_of(model, lossfn, x, y, use_kernels, generator=None):
    """One backward pass of ``lossfn`` on (x, y): every parameter's gradient,
    cloned; ``.grad`` cleared before and after.  With a ``generator`` the
    model runs in training mode, its DropPath drawing from it."""
    model.zero_grad(set_to_none=True)
    kw = {} if generator is None else {"generator": generator}
    was_training = model.training
    model.train(generator is not None)
    lossfn(model(x, use_kernels, **kw).float(), y).backward()
    model.train(was_training)
    out = {n: p.grad.detach().clone() for n, p in model.named_parameters()
           if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return out


def train_turns(model, lossfn, raw, ref, generator=None, steps=5):
    """Train images/s and peak GiB of ``steps`` Adam steps after a warm-up,
    in turns (kernels, plain, plain, kernels); ``generator()`` gives each
    turn's DropPath generator.  Returns ({use_kernels: [rate, rate]},
    {use_kernels: GiB})."""
    import torch

    from underwater_image_restoration_torch.train import (
        get_optimizer,
        make_train_step,
    )

    rates, mem = {True: [], False: []}, {}
    for use in (True, False, False, True):
        st = make_train_step(
            model, lossfn, get_optimizer("adam", model.parameters(), LR),
            use_kernels=use,
            generator=None if generator is None else generator())
        st(raw, ref)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(steps):
            st(raw, ref)
        torch.cuda.synchronize()
        rates[use].append(steps * len(raw) / (time.perf_counter() - t))
        mem[use] = torch.cuda.max_memory_allocated() / 2 ** 30
        del st
        torch.cuda.empty_cache()
    return rates, mem


def kernel_row(label, name, n, row):
    """A kernel's entry of the JSON line: ``row`` (``timing_row``'s, with
    its error) under ``label``, with ``n`` launches on the main path run;
    none fails."""
    if n == 0:
        fail(f"{label} was not launched on its path")
    keys = ("max_abs_err", "ms", "ms_spread", "plain_ms", "plain_ms_spread",
            "bound_ms", "bound_by")
    return {"name": label, "route": "cuda",
            **({"hmma": HMMA[name]} if name in HMMA else {}),
            "source": f"underwater_image_restoration_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": n,
            **{k: row[k] for k in keys}, "library_ms": None,
            **{k: v for k, v in row.items() if k.startswith("dense_")}}


def serve_turns(fns, raw, batch, iters=10):
    """Serving images/s and peak GiB of ``fns[use_kernels](raw)`` over
    ``iters`` batches after a warm-up, in turns (kernels, plain, plain,
    kernels): ({use_kernels: [rate, rate]}, {use_kernels: GiB})."""
    import torch

    rates, mem = {True: [], False: []}, {}
    for use in (True, False, False, True):
        fns[use](raw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(iters):
            fns[use](raw)
        torch.cuda.synchronize()
        rates[use].append(iters * batch / (time.perf_counter() - t))
        mem[use] = torch.cuda.max_memory_allocated() / 2 ** 30
    return rates, mem


def bound(nbytes, flops):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / BF16_PEAK_FLOPS * 1e3
    return max(tb, tf), "bytes" if tb >= tf else "operations"


def kernel_verdict(what, err, scale, dt):
    """Fail unless a kernel's max abs error over max|branch| is within
    AST_KERNEL_TOL for its dtype."""
    tag = str(dt).split(".")[1]
    rel, tol = err / scale, AST_KERNEL_TOL[tag]
    ok = rel <= tol
    print(f"{what} {tag}: max_abs {err:.3e} max|branch| {scale:.3f} "
          f"max_abs/max|branch| {rel:.3e} tol {tol:.0e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{what} {tag} disagrees with its plain version")


def leff_inputs(c, h, w, b, seed):
    """x ~ N(0, 1) tokens; fc1 N(0, 1/C), taps N(0, 1/9), fc2 N(0, 1/hid),
    biases of std 0.1, LN affine perturbed: an O(1) branch."""
    import torch

    g = torch.Generator().manual_seed(seed)
    hid = 4 * c

    def n(*shape, fan_in=1):
        return torch.randn(shape, generator=g) / fan_in ** 0.5

    ws = (1 + 0.1 * n(c), 0.1 * n(c), n(c, hid, fan_in=c), 0.1 * n(hid),
          n(3, 3, hid, fan_in=9), 0.1 * n(hid), n(hid, c, fan_in=hid),
          0.1 * n(c))
    return n(b, h, w, c).cuda(), [t.cuda() for t in ws]


def check_leff(c, h, w, b, seed, s=None, residual=True):
    """ln_leff vs its plain version, f32 then bf16; returns the bf16 input,
    the weights and the worst error."""
    import torch

    from underwater_image_restoration_torch.ops import ln_leff, ln_leff_plain

    x, ws = leff_inputs(c, h, w, b, seed)
    worst = 0.0
    for dt in (torch.float32, torch.bfloat16):
        xin = x.to(dt)
        got = ln_leff(xin, *ws, s=s, residual=residual).float()
        ref = ln_leff_plain(xin, *ws, s=s, residual=residual).float()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            fail(f"ln_leff C={c} {h}x{w}: non-finite output")
        err = (got - ref).abs().max().item()
        branch = (ref - xin.float() if residual else ref).abs().max()
        kernel_verdict(f"ln_leff C={c} {h}x{w} batch {b} residual={residual}"
                       f" s={None if s is None else s.tolist()}", err,
                       branch.item(), dt)
        worst = max(worst, err)
    return x.to(torch.bfloat16), ws, worst


def check_attn(nw, heads, ws, d, b, masked, modes, seed):
    """window_attn vs its plain version, f32 and bf16, sparse and/or dense
    (``modes``): the dense softmax alone shows a fault that the sparse
    mix's relu² term would outweigh.  Returns the worst error."""
    import torch

    from underwater_image_restoration_torch.ops import (
        window_attention,
        window_attention_plain,
    )

    worst = 0.0
    for dt, sparse in ((dt, sp) for dt in (torch.float32, torch.bfloat16)
                       for sp in modes):
        args, kw = attn_inputs(nw, heads, ws, d, b, masked, sparse, seed, dt)
        got = window_attention(*args, **kw).float()
        ref = window_attention_plain(*args, **kw).float()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            fail(f"window_attn N={ws * ws} d={d}: non-finite output")
        err = (got - ref).abs().max().item()
        kernel_verdict(f"window_attn N={ws * ws} d={d} B'={b * nw} "
                       f"heads={heads} masked={masked} sparse={sparse}", err,
                       ref.abs().max().item(), dt)
        worst = max(worst, err)
    return worst


def time_attn(card, nw, heads, d, batch, masked, err, seed):
    """bf16 times of window_attn (sparse) and its plain version at
    (nw windows an image, heads, d), and of the dense variant beside one
    ``scaled_dot_product_attention`` call: the kernel's JSON row."""
    from underwater_image_restoration_torch.ops import (
        window_attention,
        window_attention_plain,
    )

    import torch

    bf16 = torch.bfloat16
    args, kw = attn_inputs(nw, heads, AST_WIN, d, batch, masked, True, seed,
                           bf16)
    ms = median_ms(lambda: window_attention(*args, **kw))
    pms = median_ms(lambda: window_attention_plain(*args, **kw), reps=5)
    bms, by = bound(*work_ast("window_attn", (nw, heads, masked), batch, 2,
                              d))
    row = timing_row(ms, pms, bms, by, err)
    # the dense variant beside the library's one call
    args, kw = attn_inputs(nw, heads, AST_WIN, d, batch, masked, False, seed,
                           bf16)
    dms = median_ms(lambda: window_attention(*args, **kw))
    sdpa, back = sdpa_dense(args, kw)
    lms = median_ms(sdpa)
    ref = window_attention_plain(*args, **kw).float()
    lerr = (back(sdpa()).float() - ref).abs().max().item()
    row.update(dense_ms=dms.ms, dense_ms_spread=[dms.lo, dms.hi],
               dense_library_ms=lms.ms,
               dense_library_ms_spread=[lms.lo, lms.hi])
    print(f"window_attn B'={batch * nw} heads={heads} N=64 d={d} "
          f"masked={masked} bf16: kernel {ms}, plain {pms}, bound "
          f"{bms:.4f} ms ({by}); dense: kernel {dms}, "
          "scaled_dot_product_attention (bias and mask in bf16) "
          f"{lms}, its max_abs vs the plain dense version {lerr:.3e} over "
          f"max|ref| {ref.abs().max().item():.3f} on {card}", flush=True)
    return row


def check_leff_bwd(card, c, h, w, hid, b, seed, s=None, residual=True,
                   timed=False):
    """Every gradient of ln_leff_bwd vs autograd through the plain version
    on the same x, dy, weights and dtype (f32, then bf16); with ``timed``,
    bf16 times of the kernel and of the plain autograd backward (s = None:
    the work does not depend on it, residual as given)."""
    import torch

    from underwater_image_restoration_torch.ops import ln_leff_plain
    from underwater_image_restoration_torch.ops.fused_leff import (
        ln_leff_bwd,
        ln_leff_bwd_plain,
    )

    g = torch.Generator().manual_seed(seed)

    def n(*shape, fan_in=1):
        return (torch.randn(shape, generator=g) / fan_in ** 0.5).cuda()

    x, dy32 = n(b, h, w, c), n(b, h, w, c)
    ws = (1 + 0.1 * n(c), 0.1 * n(c), n(c, hid, fan_in=c), 0.1 * n(hid),
          n(3, 3, hid, fan_in=9), 0.1 * n(hid), n(hid, c, fan_in=hid),
          0.1 * n(c))
    sv = None if s is None else torch.tensor(s).cuda()
    worst, row = 0.0, {}
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).split(".")[1]
        xin, dy = x.to(dt), dy32.to(dt)
        got = ln_leff_bwd(xin, dy, *ws, s=sv, residual=residual)
        ref = ln_leff_bwd_plain(xin, dy, *ws, s=sv, residual=residual)
        torch.cuda.synchronize()
        rels = []
        for gname, a, r in zip(LEFF_GRADS, got, ref):
            a, r = a.float(), r.float()
            if a.shape != r.shape or not bool(torch.isfinite(a).all()):
                fail(f"ln_leff_bwd {gname} at C={c} {h}x{w} {tag}: shape "
                     f"{tuple(a.shape)} vs {tuple(r.shape)} or not finite")
            err = (a - r).abs().max().item()
            rels.append((err / max(r.abs().max().item(), 1e-30), gname))
            worst = max(worst, err)
        rel, gname = max(rels)
        tol = GRAD_TOL[tag]
        print(f"ln_leff_bwd C={c} {h}x{w} hidden {hid} batch {b} "
              f"residual={residual} s={s} {tag}: max_abs/max|ref| " +
              " ".join(f"{nm} {v:.2e}" for v, nm in rels) +
              f"; worst {gname} {rel:.3e} tol {tol:.0e} "
              f"{'ok' if rel <= tol else 'FAIL'}", flush=True)
        if rel > tol:
            fail(f"ln_leff_bwd {gname} disagrees with the plain backward at "
                 f"C={c} {h}x{w} {tag}")
        if timed and dt == torch.bfloat16:
            ms = median_ms(lambda: ln_leff_bwd(xin, dy, *ws,
                                               residual=residual), reps=10)
            ins = [t.detach().requires_grad_() for t in (xin, *ws)]
            y_ref = ln_leff_plain(*ins, residual=residual)
            pms = median_ms(lambda: torch.autograd.grad(
                y_ref, ins, dy, retain_graph=True), reps=5)
            del y_ref, ins
            bms, by = bound(*work_leff_bwd(c, h, b, 2))
            row = timing_row(ms, pms, bms, by, 0.0)
            print(f"ln_leff_bwd C={c} {h}x{w} bf16 batch {b} residual="
                  f"{residual}: kernel {ms}, plain autograd {pms}, bound "
                  f"{bms:.4f} ms ({by}) on {card}", flush=True)
        del got, ref
    torch.cuda.empty_cache()
    row["max_abs_err"] = worst
    return row


def check_attn_bwd(card, nw, heads, ws, d, b, masked, sparse, seed,
                   timed=False):
    """window_attn_bwd vs the plain recompute (autograd through the plain
    version) on the same inputs and cotangent, f32, then bf16: every
    gradient's max abs error over its max|ref| (GRAD_TOL); with ``timed``,
    bf16 times of both."""
    import importlib

    import torch

    wa = importlib.import_module(
        "underwater_image_restoration_torch.ops.window_attention")
    worst, row = 0.0, {}
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).split(".")[1]
        args, kw = attn_inputs(nw, heads, ws, d, b, masked, sparse, seed, dt)
        g = torch.randn(args[0].shape, generator=torch.Generator()
                        .manual_seed(seed + 1)).cuda().to(dt)
        got = wa.window_attn_bwd(g, *args, **kw)
        ref = wa.window_attention_bwd(g, *args, **kw)
        torch.cuda.synchronize()
        rels = []
        for gname, a, r in zip(("dq", "dk", "dv", "dbias", "dw"), got, ref):
            if r is None:
                continue
            a, r = a.float(), r.float()
            if a.shape != r.shape or not bool(torch.isfinite(a).all()):
                fail(f"window_attn_bwd {gname} at N={ws * ws} d={d} {tag}: "
                     f"shape {tuple(a.shape)} vs {tuple(r.shape)} or not "
                     "finite")
            err = (a - r).abs().max().item()
            rels.append((err / max(r.abs().max().item(), 1e-30), gname))
            worst = max(worst, err)
        rel, gname = max(rels)
        tol = GRAD_TOL[tag]
        print(f"window_attn_bwd N={ws * ws} d={d} B'={b * nw} heads={heads} "
              f"masked={masked} sparse={sparse} {tag}: max_abs/max|ref| " +
              " ".join(f"{nm} {v:.2e}" for v, nm in rels) +
              f"; worst {gname} {rel:.3e} tol {tol:.0e} "
              f"{'ok' if rel <= tol else 'FAIL'}", flush=True)
        if rel > tol:
            fail(f"window_attn_bwd {gname} disagrees with the plain "
                 f"recompute at N={ws * ws} d={d} B'={b * nw} {tag}")
        if timed and dt == torch.bfloat16:
            ms = median_ms(lambda: wa.window_attn_bwd(g, *args, **kw),
                           reps=10)
            pms = median_ms(lambda: wa.window_attention_bwd(g, *args, **kw),
                            reps=5)
            bms, by = bound(*work_attn_bwd((nw, heads, masked), b, 2, d))
            row = timing_row(ms, pms, bms, by, 0.0)
            print(f"window_attn_bwd B'={b * nw} heads={heads} N={ws * ws} "
                  f"d={d} masked={masked} bf16: kernel {ms}, plain recompute "
                  f"{pms}, bound {bms:.4f} ms ({by}) on {card}", flush=True)
        del got, ref, args, kw, g
    torch.cuda.empty_cache()
    row["max_abs_err"] = worst
    return row


def ast_phase(card, batch, size):
    """6. AST serving; returns the kernels' JSON rows."""
    import torch

    from underwater_image_restoration_torch.data import synthetic_pair_batch
    from underwater_image_restoration_torch.eval import (
        batched_apply,
        psnr_float_pm1,
    )
    from underwater_image_restoration_torch.models import init_model
    from underwater_image_restoration_torch.models.blocks import (
        WindowAttentionSparse,
    )
    from underwater_image_restoration_torch.ops import fused_leff
    from underwater_image_restoration_torch.ops import (
        ln_leff,
        ln_leff_plain,
        window_attention,
    )

    t_phase = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16

    # ---- (a) kernels vs plain versions
    with torch.no_grad():
        c, h, w = LEFF_EDGE
        check_leff(c, h, w, 2, seed=1)
        check_leff(c, h, w, 2, seed=2, s=torch.tensor([1.25, 0.5]).cuda(),
                   residual=False)
        for nw, heads, ws, d, masked, sparse in ATTN_EDGE:
            check_attn(nw, heads, ws, d, 2, masked, (sparse,), seed=3)
        rows = {}
        for c, h in LEFF_SHAPES:
            xb, ws, err = check_leff(c, h, h, batch, seed=c + h)
            ms = median_ms(lambda: ln_leff(xb, *ws))
            pms = median_ms(lambda: ln_leff_plain(xb, *ws), reps=5)
            bms, by = bound(*work_ast("ln_leff", (c, h), batch, 2))
            rows[("ln_leff", c, h, h)] = timing_row(ms, pms, bms, by, err)
            print(f"ln_leff C={c} {h}x{h} bf16 batch {batch}: kernel "
                  f"{ms}, plain {pms}, bound {bms:.4f} ms ({by}) on {card}",
                  flush=True)
            del xb, ws
        for nw, heads in ATTN_SHAPES:
            for masked in (False, True):
                err = check_attn(nw, heads, AST_WIN, AST_HEAD_DIM, batch,
                                 masked, (True, False), seed=nw + heads)
                rows[("window_attn", batch * nw, heads, masked)] = time_attn(
                    card, nw, heads, AST_HEAD_DIM, batch, masked, err,
                    nw + heads)
    torch.cuda.empty_cache()
    print(f"phase 6(a) took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- (b) launches in one forward of the full-width AST
    model = init_model("AST", seed=0, img_size=size, compute_dtype=bf16)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, WindowAttentionSparse):
                m.qkv.to_q.weight.mul_(AST_Q_SCALE)
    n_params = sum(p.numel() for p in model.parameters())
    raw, _ = synthetic_pair_batch(batch, size, seed=0)
    apply_b, _ = batched_apply(model, batch)
    apply_b(raw)  # warm-up: cuDNN algorithms, masks
    torch.cuda.synchronize()
    ln_leff.launches.clear()
    window_attention.launches.clear()
    y = apply_b(raw)
    torch.cuda.synchronize()
    launches = {"ln_leff": dict(ln_leff.launches),
                "window_attn": dict(window_attention.launches)}
    n_attn = sum(launches["window_attn"].values())
    n_masked = sum(v for k, v in launches["window_attn"].items() if k[4])
    # two ln_leff calls a level, each FWD_LAUNCHES a slice of the batch
    want_leff = {(c, h, h): 2 * fused_leff.fwd_plan(
        batch, h, h, c, 4 * c, 2).launches for c, h in LEFF_SHAPES}
    print(f"(b) AST {size}x{size} ({n_params} parameters), launches in one "
          f"forward: ln_leff {sum(launches['ln_leff'].values())} (18 calls "
          f"of {fused_leff.FWD_LAUNCHES} a slice of the batch), window_attn "
          f"{n_attn} ({n_masked} masked)", flush=True)
    for name in launches:
        for key, n in sorted(launches[name].items()):
            print(f"  {name} {key}: {n}", flush=True)
    if launches["ln_leff"] != want_leff or (n_attn, n_masked) != (10, 5):
        fail(f"expected ln_leff {want_leff} (18 calls) and 10 window_attn "
             "(5 masked) launches")
    counts = {("ln_leff", c, h, h): launches["ln_leff"].get((c, h, h), 0)
              for c, h in LEFF_SHAPES}
    for nw, heads in ATTN_SHAPES:
        for masked in (False, True):
            counts[("window_attn", batch * nw, heads, masked)] = \
                launches["window_attn"].get(
                    (batch * nw, heads, AST_WIN ** 2, AST_HEAD_DIM, masked),
                    0)
    if tuple(y.shape) != (batch, size, size, 3):
        fail(f"AST output shape {tuple(y.shape)}")
    if not bool(torch.isfinite(y).all()):
        fail("AST: non-finite output")

    # ---- (c) the model's output, kernels vs plain model
    def outputs(m, dt, use_kernels):
        m.compute_dtype = dt
        out = batched_apply(m, batch, use_kernels)[0](raw)
        torch.cuda.synchronize()
        return out

    refs = {}
    for dt in (f32, bf16):
        tag = str(dt).split(".")[1]
        refs[tag] = ref = outputs(model, dt, False)
        out = y if dt == bf16 else outputs(model, dt, True)
        err = (out - ref).abs().max().item()
        gone = {b: (outputs(model_without(model, b), dt, False) - ref)
                .abs().max().item() for b in ("LeFF", "attention")}
        tol = AST_MODEL_TOL[tag]
        print(f"(c) AST {tag} kernels vs {tag} plain model: max_abs {err:.3e}"
              f" (max|ref| {ref.abs().max().item():.3f}) tol {tol:.0e}; "
              f"without the LeFF branches the plain model moves "
              f"{gone['LeFF']:.3e}, without attention "
              f"{gone['attention']:.3e}", flush=True)
        if not tol <= min(gone.values()) / 4:
            fail(f"(c) the AST {tag} limit would not see a missing branch")
        if not err <= tol:
            fail(f"(c) AST output ({tag}) disagrees with the plain model")
    err = (y - refs["float32"]).abs().max().item()
    psnr = psnr_float_pm1(refs["float32"].cpu().numpy(), y.cpu().numpy())
    print(f"(c) AST bf16 kernels vs f32 plain model: max_abs {err:.3e}, PSNR "
          f"{psnr:.2f} dB", flush=True)
    del refs
    torch.cuda.empty_cache()

    # ---- (d) serving: images/s and peak memory, in turns
    model.compute_dtype = bf16
    fns = {True: apply_b, False: batched_apply(model, batch, False)[0]}
    rates, mem = serve_turns(fns, raw, batch)
    print(f"(d) serving AST {size}x{size} bf16 batch {batch}: "
          f"{sum(rates[True]) / 2:.2f} images/s with the kernels "
          f"{rates[True]}, {sum(rates[False]) / 2:.2f} with the plain "
          f"versions {rates[False]}; peak memory {mem[True]:.2f} GiB and "
          f"{mem[False]:.2f} GiB; on {card}", flush=True)
    print(f"phase 6 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    kernels = []
    for key, row in rows.items():
        if key[0] == "ln_leff":
            label = f"ln_leff[C={key[1]},{key[2]}x{key[3]}]"
        else:
            label = (f"window_attn[B'={key[1]},heads={key[2]},N=64,d=32,"
                     f"{'masked' if key[3] else 'unmasked'}]")
        kernels.append(kernel_row(label, key[0], counts[key], row))
    return kernels


def ast_train_phase(card, batch, size, check_batch):
    """7. the AST train step; returns ln_leff_bwd's and window_attn_bwd's
    JSON rows."""
    import importlib

    import torch

    from underwater_image_restoration_torch.data import synthetic_pair_batch
    from underwater_image_restoration_torch.losses import LossFunction
    from underwater_image_restoration_torch.models import init_model
    from underwater_image_restoration_torch.models.blocks import (
        WindowAttentionSparse,
    )
    from underwater_image_restoration_torch.ops import (
        ln_leff,
        window_attention,
    )
    from underwater_image_restoration_torch.ops import _kernels, fused_leff
    from underwater_image_restoration_torch.ops.fused_leff import ln_leff_bwd
    from underwater_image_restoration_torch.train import (
        get_optimizer,
        make_train_step,
        normalize_u8,
    )

    # the module (``ops.window_attention`` is also its function's name)
    wa = importlib.import_module(
        "underwater_image_restoration_torch.ops.window_attention")
    t_phase = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    # ---- (a) ln_leff_bwd vs autograd through the plain version
    for i, (c, h, w, hid, residual, s) in enumerate(LEFF_BWD_EDGE):
        check_leff_bwd(card, c, h, w, hid, 2, seed=20 + i, s=s,
                       residual=residual)
    for i, (nw, heads, ws, d, masked, sparse) in enumerate(ATTN_EDGE):
        check_attn_bwd(card, nw, heads, ws, d, 2, masked, sparse,
                       seed=30 + i)
    rows = {}
    for c, h in LEFF_SHAPES:
        rows[("ln_leff_bwd", c, h, h)] = check_leff_bwd(
            card, c, h, h, 4 * c, batch, seed=c + h + 1, timed=True)
    for nw, heads in ATTN_SHAPES:
        for masked in (False, True):
            rows[("window_attn_bwd", batch * nw, heads, masked)] = \
                check_attn_bwd(card, nw, heads, AST_WIN, AST_HEAD_DIM, batch,
                               masked, True, seed=nw + heads + 2, timed=True)
    print(f"phase 7(a) took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- (b) launches in one train step of the full-width AST
    # (b)-(e) run cuDNN's deterministic algorithms, as phase 5
    torch.backends.cudnn.deterministic = True
    lossfn = LossFunction("L1withColor")
    model = init_model("AST", seed=0, img_size=size, compute_dtype=bf16)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, WindowAttentionSparse):
                m.qkv.to_q.weight.mul_(AST_Q_SCALE)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != AST_PARAMS:
        fail(f"AST@{size} has {n_params} parameters, not {AST_PARAMS}")
    raw, ref = synthetic_pair_batch(batch, size, seed=0)
    step = make_train_step(model, lossfn,
                           get_optimizer("adam", model.parameters(), LR),
                           generator=gen(0))
    step(raw, ref)  # warm-up: cuDNN algorithms, masks
    torch.cuda.synchronize()
    counters = {"ln_leff": ln_leff.launches,
                "ln_leff_bwd": ln_leff_bwd.launches,
                "window_attn": window_attention.launches,
                "window_attn_bwd": wa.window_attn_bwd.launches}
    for cnt in counters.values():
        cnt.clear()
    # count calls of the plain recompute: none on the kernels' path
    plain_bwd, recompute_calls = wa.window_attention_bwd, []

    def counted(*a, **k):
        recompute_calls.append(1)
        return plain_bwd(*a, **k)

    wa.window_attention_bwd = counted
    try:
        out = step(raw, ref)
        torch.cuda.synchronize()
    finally:
        wa.window_attention_bwd = plain_bwd
    launches = {k: dict(v) for k, v in counters.items()}
    totals = {k: sum(v.values()) for k, v in launches.items()}
    n_masked = sum(v for k, v in launches["window_attn"].items() if k[4])
    bwd_masked = sum(v for k, v in launches["window_attn_bwd"].items()
                     if k[4])
    # one kernel backward a window attention, each wanting dbias and dw:
    # the kernel, reduce_rows and the dw step
    bwd_each = wa.bwd_plan(batch * 4, 16, 64, d=AST_HEAD_DIM,
                           itemsize=2).launches
    # two ln_leff and ln_leff_bwd calls a level, each FWD_LAUNCHES or
    # BWD_LAUNCHES a slice of the batch
    sms = _kernels.sm_count(torch.device("cuda"))
    want = {"ln_leff": {(c, h, h): 2 * fused_leff.fwd_plan(
                batch, h, h, c, 4 * c, 2).launches for c, h in LEFF_SHAPES},
            "ln_leff_bwd": {(c, h, h): 2 * fused_leff.bwd_plan(
                batch, h, h, c, 4 * c, 2, sms).launches
                for c, h in LEFF_SHAPES}}
    print(f"(b) AST {size}x{size} ({n_params} parameters), launches in one "
          f"train step, batch {batch}: {totals} ({n_masked} window_attn "
          f"masked; ln_leff {fused_leff.FWD_LAUNCHES} a slice of the batch: "
          f"prep, fc1, g2, fc2; ln_leff_bwd {fused_leff.BWD_LAUNCHES} a "
          "slice: prep, fc1, dg2, depthwise, weight gradients, dLN, row "
          f"sums; window_attn_bwd {bwd_each} a call: the kernel, "
          f"reduce_rows, dw), {bwd_masked} window_attn_bwd launches masked, "
          f"{len(recompute_calls)} calls of the plain recompute", flush=True)
    for name in ("ln_leff", "ln_leff_bwd"):
        for (c, h, w), n in sorted(launches[name].items()):
            print(f"  {name} C={c} {h}x{w}: {n} (2 calls of "
                  f"{want[name].get((c, h, w), 0) // 2})", flush=True)
    for key, n in sorted(launches["window_attn_bwd"].items()):
        print(f"  window_attn_bwd {key}: {n}", flush=True)
    if (totals["window_attn"], n_masked) != (10, 5) \
            or launches["ln_leff"] != want["ln_leff"] \
            or launches["ln_leff_bwd"] != want["ln_leff_bwd"] \
            or (totals["window_attn_bwd"], bwd_masked) != (10 * bwd_each,
                                                          5 * bwd_each) \
            or recompute_calls:
        fail(f"expected ln_leff {want['ln_leff']}, ln_leff_bwd "
             f"{want['ln_leff_bwd']} (18 calls each), 10 window_attn (5 "
             f"masked) and 10 window_attn_bwd calls of {bwd_each} launches "
             "(5 masked) in one train step, and no plain recompute")
    loss0 = float(out["loss"])
    print(f"AST train step loss {loss0:.6f} grad_norm "
          f"{float(out['grad_norm']):.6f}", flush=True)
    if not math.isfinite(loss0):
        fail("non-finite AST train loss")
    for name, p in model.named_parameters():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            fail(f"(b) {name}: gradient missing or not finite")
        if not bool(p.grad.any()):
            fail(f"(b) {name}: the gradient is all zero")
    print("(b) gradients: every parameter's present, finite and non-zero",
          flush=True)

    # ---- (c) one step's gradients, kernels vs plain, same DropPath draws
    xc, yc = (normalize_u8(torch.as_tensor(t[:check_batch]).cuda()).permute(
        0, 3, 1, 2).contiguous() for t in (raw, ref))

    for dt in (f32, bf16):
        tag = str(dt).split(".")[1]
        model.compute_dtype = dt
        g_ref = grads_of(model, lossfn, xc, yc, False, gen(1))
        rel, mx = grad_dist(grads_of(model, lossfn, xc, yc, True, gen(1)),
                            g_ref)
        gone = grad_dist(grads_of(model_without(model, "LeFF"), lossfn, xc, yc,
                                  False, gen(1)), g_ref)[0]
        tol = AST_TRAIN_GRAD_TOL[tag]
        print(f"(c) AST gradients {tag}, batch {check_batch}, kernels vs "
              f"plain: ||g - g_ref||/||g_ref|| {rel:.3e} (tol {tol:.0e}), "
              f"max abs/max|g_ref| {mx:.3e}; without the LeFF branches the "
              f"plain gradients move {gone:.3e}", flush=True)
        if not tol <= gone / 4:
            fail(f"(c) the AST {tag} gradient limit would not see a missing "
                 "LeFF branch")
        if not rel <= tol:
            fail(f"(c) AST {tag} gradients disagree with the plain model")
        del g_ref
        torch.cuda.empty_cache()

    # ---- (d) three f32 steps, kernels vs plain
    model.compute_dtype = f32
    losses = {}
    for use in (True, False):
        m = copy.deepcopy(model)
        st = make_train_step(m, lossfn, get_optimizer("adam", m.parameters(),
                                                      LR),
                             use_kernels=use, generator=gen(2))
        losses[use] = [float(st(*synthetic_pair_batch(
            check_batch, size, seed=10 + i))["loss"]) for i in range(3)]
        del m, st
        torch.cuda.empty_cache()
    drift = max(abs(a - b) / abs(b) for a, b in zip(losses[True],
                                                   losses[False]))
    print(f"(d) AST three f32 steps, batch {check_batch}: losses kernels "
          f"{losses[True]} plain {losses[False]}, max relative difference "
          f"{drift:.3e} (tol {TRAIN_LOSS_TOL:.0e})", flush=True)
    if not drift <= TRAIN_LOSS_TOL:
        fail("(d) the AST f32 train losses of the kernels and the plain "
             "versions disagree")

    # ---- (e) two bf16 backward passes, bit-equal
    model.compute_dtype = bf16
    xt, yt = (normalize_u8(torch.as_tensor(t).cuda()).permute(
        0, 3, 1, 2).contiguous() for t in (raw, ref))
    g1 = grads_of(model, lossfn, xt, yt, True, gen(1))
    g2 = grads_of(model, lossfn, xt, yt, True, gen(1))
    torch.backends.cudnn.deterministic = False
    differ = [n for n in g1 if not torch.equal(g1[n], g2[n])]
    print(f"(e) AST two bf16 backward passes, batch {batch}: "
          f"{len(g1) - len(differ)} of {len(g1)} gradients bit-equal",
          flush=True)
    if differ or len(g1) != len(list(model.parameters())):
        fail(f"(e) gradients missing or differing between two passes: "
             f"{differ[:5]}")
    del g1, g2, xt, yt
    torch.cuda.empty_cache()

    # ---- (f) train images/s and peak memory, in turns
    rates, mem = train_turns(model, lossfn, raw, ref, lambda: gen(3))
    print(f"(f) train step AST {size}x{size} bf16 batch {batch}: "
          f"{sum(rates[True]) / 2:.2f} images/s with the kernels "
          f"{rates[True]}, {sum(rates[False]) / 2:.2f} with the plain "
          f"versions {rates[False]}; peak memory {mem[True]:.2f} GiB and "
          f"{mem[False]:.2f} GiB; on {card}", flush=True)
    print(f"phase 7 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    kernels = []
    for key, row in rows.items():
        if key[0] == "ln_leff_bwd":
            n = launches["ln_leff_bwd"].get(key[1:], 0)
            label = f"ln_leff_bwd[C={key[1]},{key[2]}x{key[3]}]"
        else:
            n = launches["window_attn_bwd"].get(
                (key[1], key[2], AST_WIN ** 2, AST_HEAD_DIM, key[3]), 0)
            label = (f"window_attn_bwd[B'={key[1]},heads={key[2]},N=64,"
                     f"d=32,{'masked' if key[3] else 'unmasked'}]")
        kernels.append(kernel_row(label, key[0], n, row))
    return kernels


def new_model(name, use_dwt, dt, size, q_scale=NEW_Q_SCALE):
    """A New* model at full width with its reference init from seed 0, its
    q projections scaled by ``q_scale`` and its LayerNorm affines perturbed
    (seed 1)."""
    import torch

    from underwater_image_restoration_torch.models import init_model
    from underwater_image_restoration_torch.models.blocks import (
        WindowAttentionSparse,
    )
    from underwater_image_restoration_torch.ops.layers import TokenLayerNorm

    model = init_model(name, seed=0, img_size=size, use_dwt=use_dwt,
                       compute_dtype=dt)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, WindowAttentionSparse):
                m.to_qkv.to_q.weight.mul_(q_scale)
            elif isinstance(m, TokenLayerNorm):
                for p, base in ((m.weight, 1.0), (m.bias, 0.0)):
                    p.copy_(base + 0.1 * torch.randn(p.shape, generator=g))
    return model


def new_launches(model, batch, sms=None, remat=False):
    """What the planners say one forward (with ``sms``, one train step) of
    a New* model at ``batch`` in bf16 launches: ln_leff (and ln_leff_bwd)
    by (C, H, W), window_attn (and window_attn_bwd) by (B', heads, N, d,
    masked), from the model's blocks; with ``remat``, the forward of every
    block but the bottleneck runs again in the backward."""
    import importlib

    from underwater_image_restoration_torch.models.new_model import (
        DecoderBlock,
        EncoderBlock,
    )
    from underwater_image_restoration_torch.ops import fused_leff

    wa = importlib.import_module(
        "underwater_image_restoration_torch.ops.window_attention")
    out = {k: collections.Counter() for k in (
        "ln_leff", "ln_leff_bwd", "window_attn", "window_attn_bwd")}
    for name, m in model.named_modules():
        if not isinstance(m, (EncoderBlock, DecoderBlock)):
            continue
        lvl = 4 if name == "bottleneck" else int(name.split("_")[1])
        h, c = model.img_size >> lvl, m.norm2.weight.numel()
        runs = 2 if remat and name != "bottleneck" else 1
        if m.token_mlp == "leff":
            out["ln_leff"][(c, h, h)] += runs * fused_leff.fwd_plan(
                batch, h, h, c, 4 * c, 2).launches
            if sms:
                out["ln_leff_bwd"][(c, h, h)] += fused_leff.bwd_plan(
                    batch, h, h, c, 4 * c, 2, sms).launches
        if isinstance(m, DecoderBlock):
            ws = m.mdassa.win_size
            key = (batch * (h // ws) ** 2, NEW_HEADS, ws * ws, c // NEW_HEADS,
                   False)
            out["window_attn"][key] += 2 * runs
            if sms:
                out["window_attn_bwd"][key] += 2 * wa.bwd_plan(
                    key[0], NEW_HEADS, ws * ws, sms, d=key[3],
                    itemsize=2).launches
    return {k: dict(v) for k, v in out.items() if v}


def new_phase(card, batch, size):
    """8. NewModel serving (and one forward of each big New* model);
    returns the kernels' JSON rows."""
    import torch

    from underwater_image_restoration_torch.data import synthetic_pair_batch
    from underwater_image_restoration_torch.eval import (
        batched_apply,
        psnr_float_pm1,
    )
    from underwater_image_restoration_torch.ops import (
        ln_leff,
        ln_leff_plain,
        window_attention,
    )

    t_phase = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16
    counters = {"ln_leff": ln_leff.launches,
                "window_attn": window_attention.launches}

    # ---- (a) kernels vs plain versions at every NewModel@256 shape
    rows = {}
    with torch.no_grad():
        nw, heads, ws, d, masked, sparse = NEW_ATTN_EDGE
        check_attn(nw, heads, ws, d, 2, masked, (sparse,), seed=40)
        for c, h in NEW_ENC_LEFF:
            xb, wts, err = check_leff(c, h, h, batch, seed=c + h + 3,
                                      residual=False)
            ms = median_ms(lambda: ln_leff(xb, *wts, residual=False))
            pms = median_ms(lambda: ln_leff_plain(xb, *wts, residual=False),
                            reps=5)
            bms, by = bound(*work_ast("ln_leff", (c, h), batch, 2))
            rows[("ln_leff", c, h, h)] = timing_row(ms, pms, bms, by, err)
            print(f"ln_leff C={c} {h}x{h} bf16 batch {batch} residual=False:"
                  f" kernel {ms}, plain {pms}, bound {bms:.4f} ms ({by}) on "
                  f"{card}", flush=True)
            del xb, wts
        for nw, d in NEW_ATTN_SHAPES:
            err = check_attn(nw, NEW_HEADS, AST_WIN, d, batch, False,
                             (True, False), seed=nw + d)
            rows[("window_attn", batch * nw, NEW_HEADS, d)] = time_attn(
                card, nw, NEW_HEADS, d, batch, False, err, nw + d)
    torch.cuda.empty_cache()
    print(f"phase 8(a) took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- (b) launches in one forward of NewModel-Wavelet@256
    model = new_model("NewModel", "Wavelet", bf16, size)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != NEW_PARAMS:
        fail(f"NewModel@{size} has {n_params} parameters, not {NEW_PARAMS}")
    raw, _ = synthetic_pair_batch(batch, size, seed=0)
    apply_b, _ = batched_apply(model, batch)
    apply_b(raw)  # warm-up: cuDNN algorithms, cuFFT plans
    torch.cuda.synchronize()
    for cnt in counters.values():
        cnt.clear()
    y = apply_b(raw)
    torch.cuda.synchronize()
    launches = {k: dict(v) for k, v in counters.items()}
    want = new_launches(model, batch)
    print(f"(b) NewModel-Wavelet {size}x{size} ({n_params} parameters), "
          f"launches in one forward, batch {batch}: "
          f"{ {k: sum(v.values()) for k, v in launches.items()} } (ln_leff "
          "9 calls as fused_leff.fwd_plan says, 4 without the residual; "
          "window_attn 10 calls, none masked)", flush=True)
    for name in launches:
        for key, n in sorted(launches[name].items()):
            print(f"  {name} {key}: {n}", flush=True)
    if launches != want:
        fail(f"expected the launches {want}")
    if tuple(y.shape) != (batch, size, size, 3) or not bool(
            torch.isfinite(y).all()):
        fail(f"NewModel output shape {tuple(y.shape)} or not finite")

    # ---- (c) the model's output, kernels vs plain model, both modes
    def outputs(m, dt, use_kernels, u8=raw, b=batch):
        m.compute_dtype = dt
        out = batched_apply(m, b, use_kernels)[0](u8)
        torch.cuda.synchronize()
        return out

    def dist(a, r):
        return float((a.float() - r.float()).norm() / r.float().norm())

    def held(m, what, dt, use_kernels_out=None, ref32=None, quarter=True,
             **kw):
        """The kernels' output vs the plain model's in dtype dt, relative
        L2: f32 within NEW_MODEL_TOL, bf16 within NEW_BF16_FLOOR times the
        bf16 plain model's distance from ``ref32`` (the f32 plain output),
        each limit (with ``quarter``) within a quarter of what dropping a
        branch moves.  Returns the plain output."""
        tag = str(dt).split(".")[1]
        ref = outputs(m, dt, False, **kw)
        out = (outputs(m, dt, True, **kw) if use_kernels_out is None
               else use_kernels_out)
        err = dist(out, ref)
        mx = (out - ref).abs().max().item() / ref.abs().max().item()
        gone = {b: dist(outputs(model_without(m, b), dt, False, **kw), ref)
                for b in ("LeFF", "attention")}
        tol, beside = NEW_MODEL_TOL, ""
        if dt != f32:
            own = dist(ref, ref32)
            tol = NEW_BF16_FLOOR * own
            beside = (f"; vs the f32 plain model: the kernels "
                      f"{dist(out, ref32):.3e}, the {tag} plain model "
                      f"{own:.3e} (the limit is {NEW_BF16_FLOOR:g} times "
                      "that)")
        print(f"{what} {tag} kernels vs {tag} plain model: ||out - ref||/"
              f"||ref|| {err:.3e} tol {tol:.2e} (max abs/max|ref| {mx:.3e}, "
              f"max|ref| {ref.abs().max().item():.3f}); without the token "
              f"MLP branches the plain model moves {gone['LeFF']:.3e}, "
              f"without attention {gone['attention']:.3e}{beside}",
              flush=True)
        if quarter and not tol <= min(gone.values()) / 4:
            fail(f"{what} the {tag} limit would not see a missing branch")
        if not err <= tol:
            fail(f"{what} output ({tag}) disagrees with the plain model")
        return ref

    for use_dwt in ("Wavelet", "Fourier"):
        m = model if use_dwt == "Wavelet" else new_model(
            "NewModel", use_dwt, bf16, size)
        ref32 = held(m, f"(c) NewModel-{use_dwt}", f32)
        out = y if use_dwt == "Wavelet" else outputs(m, bf16, True)
        held(m, f"(c) NewModel-{use_dwt}", bf16, out, ref32)
        err = (out - ref32).abs().max().item()
        psnr = psnr_float_pm1(ref32.cpu().numpy(), out.cpu().numpy())
        print(f"(c) NewModel-{use_dwt} bf16 kernels vs f32 plain model: "
              f"max_abs {err:.3e}, PSNR {psnr:.2f} dB", flush=True)
        del m, ref32, out
        torch.cuda.empty_cache()

    # ---- (d) serving: images/s and peak memory, in turns
    model.compute_dtype = bf16
    fns = {True: apply_b, False: batched_apply(model, batch, False)[0]}
    rates, mem = serve_turns(fns, raw, batch)
    print(f"(d) serving NewModel-Wavelet {size}x{size} bf16 batch {batch}: "
          f"{sum(rates[True]) / 2:.2f} images/s with the kernels "
          f"{rates[True]}, {sum(rates[False]) / 2:.2f} with the plain "
          f"versions {rates[False]}; peak memory {mem[True]:.2f} GiB and "
          f"{mem[False]:.2f} GiB; on {card}", flush=True)
    del fns, apply_b, model
    torch.cuda.empty_cache()

    # ---- (e) one bf16 forward of each big model at 2 size, vs plain
    for name, use_dwt, b in (("NewBigModel", "Wavelet", 2),
                             ("NewBigFRFNModel", "Fourier", 1)):
        big = new_model(name, use_dwt, bf16, 2 * size, NEW_BIG_Q_SCALE)
        u8, _ = synthetic_pair_batch(b, 2 * size, seed=1)
        outputs(big, bf16, True, u8, b)  # warm-up
        for cnt in counters.values():
            cnt.clear()
        torch.cuda.reset_peak_memory_stats()
        out = outputs(big, bf16, True, u8, b)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = {k: dict(v) for k, v in counters.items() if v}
        want = new_launches(big, b)
        print(f"(e) {name}-{use_dwt} {2 * size}x{2 * size} batch {b} "
              f"({sum(p.numel() for p in big.parameters())} parameters), "
              f"launches in one bf16 forward: "
              f"{ {k: sum(v.values()) for k, v in got.items()} }, peak "
              f"memory {peak:.2f} GiB", flush=True)
        for kname in got:
            for key, n in sorted(got[kname].items()):
                print(f"  {kname} {key}: {n}", flush=True)
        if got != want:
            fail(f"(e) {name}: expected the launches {want}")
        if not bool(torch.isfinite(out).all()):
            fail(f"(e) {name}: non-finite output")
        # the f32 forward sees a missing branch; in bf16 the attention
        # branch of NewBigFRFNModel at this q scale moves the output by
        # about its bf16 rounding (1.0e-2 and 5.3e-3 on an H100)
        ref32 = held(big, f"(e) {name}-{use_dwt}", f32, u8=u8, b=b)
        held(big, f"(e) {name}-{use_dwt}", bf16, out, ref32, quarter=False,
             u8=u8, b=b)
        del ref32
        del big, out
        torch.cuda.empty_cache()
    print(f"phase 8 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    kernels = []
    for key, row in rows.items():
        if key[0] == "ln_leff":
            n = launches["ln_leff"].get(key[1:], 0)
            label = f"ln_leff[C={key[1]},{key[2]}x{key[3]},residual=False]"
        else:
            n = launches["window_attn"].get(
                (key[1], key[2], AST_WIN ** 2, key[3], False), 0)
            label = (f"window_attn[B'={key[1]},heads={key[2]},N=64,"
                     f"d={key[3]},unmasked]")
        kernels.append(kernel_row(label, key[0], n, row))
    return kernels


def new_train_phase(card, batch, size, check_batch):
    """9. the NewModel-Wavelet@256 train step; returns ln_leff_bwd's and
    window_attn_bwd's JSON rows."""
    import importlib

    import torch

    from underwater_image_restoration_torch.data import synthetic_pair_batch
    from underwater_image_restoration_torch.losses import LossFunction
    from underwater_image_restoration_torch.ops import (
        _kernels,
        ln_leff,
        window_attention,
    )
    from underwater_image_restoration_torch.ops.fused_leff import ln_leff_bwd
    from underwater_image_restoration_torch.train import (
        get_optimizer,
        make_train_step,
        normalize_u8,
    )

    wa = importlib.import_module(
        "underwater_image_restoration_torch.ops.window_attention")
    t_phase = time.perf_counter()
    f32, bf16 = torch.float32, torch.bfloat16

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    # ---- (a) the backward kernels vs their plain versions
    nw, heads, ws, d, masked, sparse = NEW_ATTN_EDGE
    check_attn_bwd(card, nw, heads, ws, d, 2, masked, sparse, seed=41)
    rows = {}
    for c, h in NEW_ENC_LEFF:
        rows[("ln_leff_bwd", c, h, h)] = check_leff_bwd(
            card, c, h, h, 4 * c, batch, seed=c + h + 5, residual=False,
            timed=True)
    for nw, d in NEW_ATTN_SHAPES:
        rows[("window_attn_bwd", batch * nw, NEW_HEADS, d)] = check_attn_bwd(
            card, nw, NEW_HEADS, AST_WIN, d, batch, False, True,
            seed=nw + d + 2, timed=True)
    print(f"phase 9(a) took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- (b) launches in one train step; (b)-(e) run cuDNN
    # deterministic, as phases 5 and 7
    torch.backends.cudnn.deterministic = True
    lossfn = LossFunction("L1withColor")
    model = new_model("NewModel", "Wavelet", bf16, size)
    raw, ref = synthetic_pair_batch(batch, size, seed=0)
    step = make_train_step(model, lossfn,
                           get_optimizer("adam", model.parameters(), LR),
                           generator=gen(0))
    step(raw, ref)  # warm-up
    torch.cuda.synchronize()
    counters = {"ln_leff": ln_leff.launches,
                "ln_leff_bwd": ln_leff_bwd.launches,
                "window_attn": window_attention.launches,
                "window_attn_bwd": wa.window_attn_bwd.launches}
    for cnt in counters.values():
        cnt.clear()
    plain_bwd, recompute_calls = wa.window_attention_bwd, []

    def counted(*a, **k):
        recompute_calls.append(1)
        return plain_bwd(*a, **k)

    wa.window_attention_bwd = counted
    try:
        out = step(raw, ref)
        torch.cuda.synchronize()
    finally:
        wa.window_attention_bwd = plain_bwd
    launches = {k: dict(v) for k, v in counters.items()}
    want = new_launches(model, batch, _kernels.sm_count(torch.device("cuda")))
    print(f"(b) NewModel-Wavelet {size}x{size}, launches in one train step, "
          f"batch {batch}: "
          f"{ {k: sum(v.values()) for k, v in launches.items()} } "
          f"(ln_leff_bwd {len(launches['ln_leff_bwd'])} shapes as "
          "fused_leff.bwd_plan walks them; window_attn_bwd 10 calls of "
          "three launches: the kernel, reduce_rows, dw), "
          f"{len(recompute_calls)} calls of the plain recompute", flush=True)
    for name in launches:
        for key, n in sorted(launches[name].items()):
            print(f"  {name} {key}: {n}", flush=True)
    if launches != want or recompute_calls:
        fail(f"expected the launches {want} and no plain recompute")
    loss0 = float(out["loss"])
    print(f"NewModel train step loss {loss0:.6f} grad_norm "
          f"{float(out['grad_norm']):.6f}", flush=True)
    if not math.isfinite(loss0):
        fail("non-finite NewModel train loss")
    for name, p in model.named_parameters():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            fail(f"(b) {name}: gradient missing or not finite")
        if not bool(p.grad.any()):
            fail(f"(b) {name}: the gradient is all zero (Wavelet mode "
                 "leaves no parameter dead)")
    print("(b) gradients: every parameter's present, finite and non-zero "
          "(Wavelet mode leaves none dead)", flush=True)

    # ---- (c) one step's gradients, kernels vs plain, same DropPath draws
    xc, yc = (normalize_u8(torch.as_tensor(t[:check_batch]).cuda()).permute(
        0, 3, 1, 2).contiguous() for t in (raw, ref))
    g32 = None
    for dt in (f32, bf16):
        tag = str(dt).split(".")[1]
        model.compute_dtype = dt
        g_ref = grads_of(model, lossfn, xc, yc, False, gen(1))
        g_k = grads_of(model, lossfn, xc, yc, True, gen(1))
        rel, mx = grad_dist(g_k, g_ref)
        gone = {b: grad_dist(grads_of(model_without(model, b), lossfn, xc,
                                      yc, False, gen(1)), g_ref)[0]
                for b in ("LeFF", "attention")}
        tol = NEW_TRAIN_GRAD_TOL[tag]
        worst = sorted(((float((g_k[n].float() - r.float()).norm())
                         / max(float(r.float().norm()), 1e-30), n)
                        for n, r in g_ref.items()), reverse=True)[:3]
        floor = ("" if g32 is None else
                 f"; vs the f32 plain gradients: the kernels "
                 f"{grad_dist(g_k, g32)[0]:.3e}, the {tag} plain model "
                 f"{grad_dist(g_ref, g32)[0]:.3e}")
        print(f"(c) NewModel gradients {tag}, batch {check_batch}, kernels "
              f"vs plain: ||g - g_ref||/||g_ref|| {rel:.3e} (tol {tol:.0e}),"
              f" max abs/max|g_ref| {mx:.3e}; without the LeFF branches the "
              f"plain gradients move {gone['LeFF']:.3e}, without attention "
              f"{gone['attention']:.3e}{floor}; the parameters whose "
              "gradients differ most, relative: " +
              ", ".join(f"{n} {v:.2e}" for v, n in worst), flush=True)
        if not tol <= min(gone.values()) / 4:
            fail(f"(c) the NewModel {tag} gradient limit would not see a "
                 "missing branch")
        if not rel <= tol:
            fail(f"(c) NewModel {tag} gradients disagree with the plain "
                 "model")
        g32 = g_ref if g32 is None else None
        del g_k, g_ref
        torch.cuda.empty_cache()

    # ---- (d) three f32 steps, kernels vs plain
    model.compute_dtype = f32
    losses = {}
    for use in (True, False):
        m = copy.deepcopy(model)
        st = make_train_step(m, lossfn, get_optimizer("adam", m.parameters(),
                                                      LR),
                             use_kernels=use, generator=gen(2))
        losses[use] = [float(st(*synthetic_pair_batch(
            check_batch, size, seed=10 + i))["loss"]) for i in range(3)]
        del m, st
        torch.cuda.empty_cache()
    drift = max(abs(a - b) / abs(b) for a, b in zip(losses[True],
                                                   losses[False]))
    print(f"(d) NewModel three f32 steps, batch {check_batch}: losses "
          f"kernels {losses[True]} plain {losses[False]}, max relative "
          f"difference {drift:.3e} (tol {TRAIN_LOSS_TOL:.0e})", flush=True)
    if not drift <= TRAIN_LOSS_TOL:
        fail("(d) the NewModel f32 train losses of the kernels and the "
             "plain versions disagree")

    # ---- (e) two bf16 backward passes, bit-equal
    model.compute_dtype = bf16
    xt, yt = (normalize_u8(torch.as_tensor(t).cuda()).permute(
        0, 3, 1, 2).contiguous() for t in (raw, ref))
    g1 = grads_of(model, lossfn, xt, yt, True, gen(1))
    g2 = grads_of(model, lossfn, xt, yt, True, gen(1))
    torch.backends.cudnn.deterministic = False
    differ = [n for n in g1 if not torch.equal(g1[n], g2[n])]
    print(f"(e) NewModel two bf16 backward passes, batch {batch}: "
          f"{len(g1) - len(differ)} of {len(g1)} gradients bit-equal",
          flush=True)
    if differ or len(g1) != len(list(model.parameters())):
        fail(f"(e) gradients missing or differing between two passes: "
             f"{differ[:5]}")
    del g1, g2, xt, yt
    torch.cuda.empty_cache()

    # ---- (f) train images/s and peak memory, in turns
    rates, mem = train_turns(model, lossfn, raw, ref, lambda: gen(3))
    print(f"(f) train step NewModel-Wavelet {size}x{size} bf16 batch "
          f"{batch}: {sum(rates[True]) / 2:.2f} images/s with the kernels "
          f"{rates[True]}, {sum(rates[False]) / 2:.2f} with the plain "
          f"versions {rates[False]}; peak memory {mem[True]:.2f} GiB and "
          f"{mem[False]:.2f} GiB; on {card}", flush=True)
    print(f"phase 9 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    kernels = []
    for key, row in rows.items():
        if key[0] == "ln_leff_bwd":
            n = launches["ln_leff_bwd"].get(key[1:], 0)
            label = (f"ln_leff_bwd[C={key[1]},{key[2]}x{key[3]},"
                     "residual=False]")
        else:
            n = launches["window_attn_bwd"].get(
                (key[1], key[2], AST_WIN ** 2, key[3], False), 0)
            label = (f"window_attn_bwd[B'={key[1]},heads={key[2]},N=64,"
                     f"d={key[3]},unmasked]")
        kernels.append(kernel_row(label, key[0], n, row))
    return kernels


# phase 10: the training run through the CLI (SpectralTransformer at full
# width, bf16): RUN_TRAIN pairs (not a multiple of the batch: the final
# batch is padded), RUN_TEST pairs, validation batch RUN_TEST_BATCH
RUN_TRAIN, RUN_TEST, RUN_TEST_BATCH = 40, 16, 8
RUN_WATCH = 2
# the loop probe's data: PROBE_PAIRS pairs as JPEGs of PROBE_JPEG (width,
# height), which the loader decodes and resizes every epoch
PROBE_PAIRS, PROBE_JPEG = 128, (1280, 720)


def _write_pairs(root, n, size, seed, jpeg=None):
    """``n`` synthetic pairs under root/a and root/b: PNGs of size x size,
    or, given ``jpeg`` = (width, height), JPEGs (quality 90) resized to
    it."""
    from PIL import Image

    from underwater_image_restoration_torch.data import synthetic_pair_batch

    dirs = []
    for sub, arr in zip("ab", synthetic_pair_batch(n, size, seed=seed)):
        d = os.path.join(root, sub)
        os.makedirs(d)
        for i, img in enumerate(arr):
            im = Image.fromarray(img)
            if jpeg is None:
                im.save(os.path.join(d, f"{i:04d}.png"))
            else:
                im.resize(jpeg, Image.BILINEAR).save(
                    os.path.join(d, f"{i:04d}.jpg"), quality=90)
        dirs.append(d)
    return dirs


def _jsonl(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_phase(card, batch, size):
    """10. the training run: ``cli.main.main`` trains the full-width
    SpectralTransformer (bf16, L1withColor, Adam lr 3e-4; the trainer turns
    cuDNN's deterministic mode on, this phase does not) over synthetic
    train/test directories. Run A
    trains 3 epochs watching every RUN_WATCH-th step; run B trains 2
    epochs and run C resumes it for a third, both without the watch.
    (a) the launches of C's one epoch: its steps as phase 5's, its
    validation batches as phase 3's forward, no plain version called;
    (b) A's final parameters, Adam state and loader state bit-equal to
    C's, and C's losses to A's third epoch; (c) best/ and latest/ hold the
    steps the rule says, and ``ModelTrainer.evaluate`` on A's best gives
    the PSNR and SSIM logged for that epoch; (d) ``--evaluate`` writes one
    image a test input; (e) A's metrics.jsonl holds the train and test keys
    and the 64-bin histograms.  Then a probe of where a loop epoch's wall
    time goes (the first batch's wait, the later waits, the step calls,
    the closing synchronise), on a fresh model's ``make_train_step`` over
    PROBE_PAIRS pairs of PROBE_JPEG JPEGs, which the loader decodes and
    resizes every epoch: with 4 decode threads (as the run), with 1, and
    over the decoded cache (``data/cache.py``, no decode once built),
    against as many steps on one preloaded batch (the bare step), and the
    4-thread loop and the bare step with cuDNN's default algorithms (the
    deterministic mode's price), in turns.  Prints the loop's images/s an
    epoch (B and C) beside the bare step's, the validation time and peak
    memory.  Returns (its directory, the train and test directories, A's
    best/ checkpoint directory) for phase 11, which removes the
    directory."""
    import glob
    import re

    import numpy as np
    import torch

    from underwater_image_restoration_torch.cli.main import main as cli
    from underwater_image_restoration_torch.core.config import Config
    from underwater_image_restoration_torch.data import (
        PairedLoader,
        UIEBDataset,
        decode_image,
    )
    from underwater_image_restoration_torch.data.cache import (
        CachedUIEBDataset,
    )
    from underwater_image_restoration_torch.losses import LossFunction
    from underwater_image_restoration_torch.models import init_model
    from underwater_image_restoration_torch.ops import fused_gdfn, fused_mdta
    from underwater_image_restoration_torch.train import (
        CheckpointManager,
        ModelTrainer,
        get_optimizer,
        make_train_step,
    )

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "phase10")
    shutil.rmtree(root, ignore_errors=True)
    train = _write_pairs(os.path.join(root, "data", "train"), RUN_TRAIN, size,
                         seed=100)
    test = _write_pairs(os.path.join(root, "data", "test"), RUN_TEST, size,
                        seed=101)
    nb = -(-RUN_TRAIN // batch)
    common = ["-a", "SpectralTransformer", "--image-size", str(size),
              "--train-batch-size", str(batch), "--test-batch-size",
              str(RUN_TEST_BATCH), "--lossf", "L1withColor", "--optim",
              "adam", "--lr", str(LR), "--compute-dtype", "bfloat16",
              "--use-wandb", "--print-freq", "100", "-j", "4",
              "--train-raw", train[0], "--train-ref", train[1],
              "--test-raw", test[0], "--test-ref", test[1]]
    counters = {"ln_gdfn": fused_gdfn.ln_gdfn, "ln_mdta": fused_mdta.ln_mdta,
                "ln_gdfn_bwd": fused_gdfn.ln_gdfn_bwd,
                "ln_mdta_bwd": fused_mdta.ln_mdta_bwd}
    plain_calls = collections.Counter()

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            plain_calls[name] += 1
            return fn(*a, **k)
        return fn, wrapper

    patched = [(mod, name) + counted(mod, name) for mod, name in (
        (fused_mdta, "ln_mdta_plain"), (fused_gdfn, "ln_gdfn_plain"),
        (fused_mdta, "ln_mdta_bwd_plain"), (fused_gdfn, "ln_gdfn_bwd_plain"))]
    cwd = os.getcwd()
    try:
        for mod, name, _, wrapper in patched:
            setattr(mod, name, wrapper)
        os.chdir(root)  # the CLI's logs/ and Images/ land here

        def train_run(name, extra):
            t = time.perf_counter()
            cli(common + extra)
            torch.cuda.synchronize()
            ckpt = os.path.join(root, name)
            return time.perf_counter() - t, os.path.join(
                ckpt, os.listdir(ckpt)[0]) if os.path.isdir(ckpt) else None

        torch.cuda.reset_peak_memory_stats()
        secs_a, run_a = train_run("A", ["--max-epoch", "3", "--watch-freq",
                                        str(RUN_WATCH), "--checkpoint-dir",
                                        os.path.join(root, "A")])
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        secs_b, run_b = train_run("B", ["--max-epoch", "2", "--watch-freq",
                                        "0", "--checkpoint-dir",
                                        os.path.join(root, "B")])
        for cnt in counters.values():
            cnt.launches.clear()
        plain_calls.clear()
        secs_c, _ = train_run("C", ["--max-epoch", "3", "--watch-freq", "0",
                                    "--resume", run_b])
        got = {k: dict(cnt.launches) for k, cnt in counters.items()}
        print(f"phase 10 runs: A (3 epochs, watch every {RUN_WATCH}) "
              f"{secs_a:.1f} s, B (2 epochs) {secs_b:.1f} s, C (resumes B for "
              f"1) {secs_c:.1f} s; {RUN_TRAIN} train pairs at batch {batch} "
              f"({nb} steps an epoch, the last padded), {RUN_TEST} test "
              f"pairs at batch {RUN_TEST_BATCH}", flush=True)

        # (a) one epoch's launches: nb steps, RUN_TEST / RUN_TEST_BATCH
        # validation forwards, nothing else
        step = spectral_launches(batch, train=True)
        val = spectral_launches(RUN_TEST_BATCH)
        n_val = -(-RUN_TEST // RUN_TEST_BATCH)
        want = {k: {s: nb * n + n_val * val.get(k, {}).get(s, 0)
                    for s, n in v.items()} for k, v in step.items()}
        print(f"(a) launches in C's epoch: "
              f"{ {k: sum(v.values()) for k, v in got.items()} } (want "
              f"{ {k: sum(v.values()) for k, v in want.items()} }: {nb} "
              f"steps as phase 5, {n_val} validation forwards at batch "
              f"{RUN_TEST_BATCH}); plain versions called "
              f"{sum(plain_calls.values())} times", flush=True)
        if got != want:
            fail(f"(a) expected launches {want} in one epoch, got {got}")
        if plain_calls:
            fail(f"(a) plain versions called in the run: {dict(plain_calls)}")

        # (b) resume: A (3 straight, with the watch) == B + C
        a = CheckpointManager(os.path.join(run_a, "latest")).restore()
        c = CheckpointManager(os.path.join(run_b, "latest")).restore()
        differ = [n for n in a["params"]
                  if not torch.equal(a["params"][n], c["params"][n])]
        sa, sc = a["opt_state"]["inner"], c["opt_state"]["inner"]
        differ += [(i, k) for i in sa["state"] for k in sa["state"][i]
                   if not torch.equal(torch.as_tensor(sa["state"][i][k]),
                                      torch.as_tensor(sc["state"][i][k]))]
        rec_a, rec_c = _jsonl(run_a), _jsonl(run_b)
        loss_a = [r["train/loss"] for r in rec_a if "train/loss" in r]
        loss_c = [r["train/loss"] for r in rec_c if "train/loss" in r]
        print(f"(b) resume: {len(a['params'])} parameters and "
              f"{sum(len(v) for v in sa['state'].values())} Adam tensors, "
              f"{len(differ)} differ; loader {a['loader']} vs "
              f"{c['loader']}; epoch-3 losses {loss_a[-nb:]} vs "
              f"{loss_c[-nb:]}", flush=True)
        if (differ or a["loader"] != c["loader"] or a["epoch"] != c["epoch"]
                or sa["param_groups"] != sc["param_groups"]
                or loss_a != loss_c or len(loss_a) != 3 * nb):
            fail(f"(b) the resumed run differs from the straight one: "
                 f"{differ[:5]}")

        # (c) best/latest and evaluate
        for run, rec in ((run_a, rec_a), (run_b, rec_c)):
            val_loss = [r["test/loss"] for r in rec if "test/loss" in r]
            best = min(range(3), key=lambda e: (val_loss[e], -e))
            steps = {w: CheckpointManager(os.path.join(run, w)).all_steps()
                     for w in ("best", "latest")}
            print(f"(c) {os.path.basename(os.path.dirname(run))}: "
                  f"validation losses {val_loss}, best/ {steps['best']}, "
                  f"latest/ {steps['latest']}", flush=True)
            if steps != {"best": [best], "latest": [2]}:
                fail(f"(c) checkpoints {steps}, want best [{best}] and "
                     "latest [2]")
        best_a = CheckpointManager(os.path.join(run_a, "best")).all_steps()[0]
        logged = [r for r in rec_a if "test/PSNR" in r][best_a]
        cfg = Config(image_size=size, test_batch_size=RUN_TEST_BATCH,
                     compute_dtype="bfloat16")
        psnr, ssim = ModelTrainer(*train, *test).evaluate(
            cfg, os.path.join(run_a, "best"))
        print(f"(c) evaluate on A's best (epoch {best_a}): PSNR {psnr!r} "
              f"SSIM {ssim!r}; logged {logged['test/PSNR']!r} "
              f"{logged['test/SSIM']!r}", flush=True)
        if (psnr, ssim) != (logged["test/PSNR"], logged["test/SSIM"]):
            fail("(c) evaluate does not give the logged PSNR and SSIM")

        # (d) the evaluate branch
        out = os.path.join(root, "out")
        cli(["--evaluate", "--load-weights", os.path.join(run_a, "best"),
             "--image-in", test[0], "--image-out", out, "--infer-size",
             str(size), "--compute-dtype", "bfloat16"])
        written = sorted(os.listdir(out))
        print(f"(d) --evaluate wrote {len(written)} images for "
              f"{len(os.listdir(test[0]))} inputs", flush=True)
        if written != sorted(f + ".png" for f in os.listdir(test[0])):
            fail(f"(d) --evaluate wrote {written[:4]}...")

        # (e) the sinks
        keys = {k for r in rec_a for k in r}
        need = {"train/loss", "train/learning_rate", "train/images_per_sec",
                "train/epoch_loss", "test/loss", "test/PSNR", "test/SSIM",
                "test/epochTime"}
        hists = [(r["_step"], k, len(v["counts"])) for r in rec_a
                 for k, v in r.items()
                 if isinstance(v, dict) and v.get("_type") == "histogram"]
        n_params = len(a["params"])
        steps = sorted({h[0] for h in hists})
        print(f"(e) metrics.jsonl: {len(rec_a)} records, keys "
              f"{sorted(need & keys)}; {len(hists)} histograms at steps "
              f"{steps}, {n_params} parameters and as many gradients a "
              "step, bins " + str(sorted({h[2] for h in hists})), flush=True)
        if not need <= keys or steps != list(range(0, 3 * nb, RUN_WATCH)) \
                or {h[2] for h in hists} != {64} \
                or len(hists) != 2 * n_params * len(steps):
            fail("(e) metrics.jsonl lacks keys or histograms")

        # the loop's images/s an epoch (B's and C's, no watch)
        rates = [r["train/images_per_sec"] for r in rec_c
                 if "train/images_per_sec" in r]
        # the tee logs of B (maxEpoch-2) and C (maxEpoch-3, over A's)
        val_secs = []
        for log in sorted(glob.glob(os.path.join(
                root, "logs", "**", "log_train.txt"), recursive=True)):
            with open(log) as f:
                val_secs += [float(v) for v in re.findall(
                    r"Validation Loss: \S+ \((\S+)s\)", f.read())]
    finally:
        os.chdir(cwd)
        for mod, name, fn, _ in patched:
            setattr(mod, name, fn)
    if torch.backends.cudnn.deterministic:
        fail("ModelTrainer.train left cuDNN's deterministic mode on")

    # the probe: a fresh model's step on the run's first batch of pairs
    # (warmed up), and over the probe's JPEGs
    model = init_model("SpectralTransformer", seed=0,
                       compute_dtype=torch.bfloat16)
    raw, ref = (np.stack([decode_image(os.path.join(d, f), size)
                          for f in sorted(os.listdir(d))[:batch]])
                for d in train)
    st = make_train_step(model, LossFunction("L1withColor"),
                         get_optimizer("adam", model.parameters(), LR))
    st(raw, ref)
    torch.cuda.synchronize()

    def probe(batches):
        """One epoch of steps over ``batches``: (images/s, seconds waiting
        for the first batch, for the later ones, in the step calls (the
        host's dispatch), in the closing synchronise)."""
        t0 = time.perf_counter()
        waits, disp = [], 0.0
        it = iter(batches)
        while True:
            t = time.perf_counter()
            b = next(it, None)
            waits.append(time.perf_counter() - t)
            if b is None:
                break
            t = time.perf_counter()
            st(*b)
            disp += time.perf_counter() - t
        t = time.perf_counter()
        torch.cuda.synchronize()
        tail = time.perf_counter() - t
        n = len(waits) - 1
        return (n * batch / (time.perf_counter() - t0), waits[0],
                sum(waits[1:]), disp, tail)

    t = time.perf_counter()
    jpegs = _write_pairs(os.path.join(root, "probe"), PROBE_PAIRS, size,
                         seed=102, jpeg=PROBE_JPEG)
    t_write = time.perf_counter() - t
    t = time.perf_counter()
    cached = CachedUIEBDataset(UIEBDataset(*jpegs, size),
                               os.path.join(root, "cache"))
    t_cache = time.perf_counter() - t
    pb = PROBE_PAIRS // batch

    def threads(n):
        return PairedLoader(UIEBDataset(*jpegs, size), batch, shuffle=True,
                            seed=1, num_workers=n)

    # every kind runs as the trainer does, cuDNN deterministic, but the two
    # "cuDNN default" kinds, which price the flag
    loaders = {
        "4 decode threads": threads(4),
        "1 decode thread": threads(1),
        "decoded cache": PairedLoader(cached, batch, shuffle=True, seed=1,
                                      num_workers=4),
        "bare": None,
        "4 decode threads, cuDNN default": threads(4),
        "bare, cuDNN default": None}
    turns = {kind: [] for kind in loaders}
    try:
        for kind in list(loaders) + list(loaders)[::-1]:
            ld = loaders[kind]
            torch.backends.cudnn.deterministic = "cuDNN default" not in kind
            turns[kind].append(probe([(raw, ref)] * pb if ld is None else
                                     ((b.raw, b.ref) for b in ld)))
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"probe: {PROBE_PAIRS} pairs of {PROBE_JPEG[0]}x{PROBE_JPEG[1]} "
          f"JPEGs (written in {t_write:.1f} s, decoded into the cache in "
          f"{t_cache:.1f} s), {pb} steps an epoch, each kind twice in "
          "turns", flush=True)
    for kind, rows in turns.items():
        print(f"probe, {kind}: " + "; ".join(
            f"{r[0]:.2f} images/s, first batch {r[1]:.3f} s, later waits "
            f"{r[2]:.3f} s, step calls {r[3]:.3f} s, closing synchronise "
            f"{r[4]:.3f} s" for r in rows), flush=True)
    def mean_rate(kind):
        return sum(r[0] for r in turns[kind]) / len(turns[kind])

    bare = mean_rate("bare")
    for kind in ("4 decode threads", "bare"):
        on, off = mean_rate(kind), mean_rate(kind + ", cuDNN default")
        print(f"cuDNN deterministic ({kind}): {on:.2f} images/s against "
              f"{off:.2f} with cuDNN's default algorithms, a cost of "
              f"{100 * (off - on) / off:.1f}% on {card}", flush=True)
    del model, st
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(root, "probe"), ignore_errors=True)
    shutil.rmtree(os.path.join(root, "cache"), ignore_errors=True)
    print(f"train run SpectralTransformer {size}x{size} bf16 batch {batch}: "
          f"loop {rates} images/s an epoch (B's two, C's one; wall clock of "
          f"the epoch's {nb} steps, one padded, and its loader waits), bare "
          f"step {bare:.2f} images/s (the probe's bare turns' mean, "
          f"{pb} steps on one preloaded batch, same call); validation {val_secs} s an epoch "
          f"({RUN_TEST} images at batch {RUN_TEST_BATCH}); peak memory "
          f"{peak:.2f} GiB over run A; on {card}", flush=True)
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return root, train, test, os.path.join(run_a, "best")


# phase 11: the eval CLI's defaults (NewBigModel-Wavelet at 1024x1024, batch
# 8, bf16) over EVAL_PAIRS synthetic pairs of PROBE_JPEG JPEGs (resized to
# 1024x1024 by the command, as UIEB's photographs are); the losses at
# LOSS_SIZE, batch
# LOSS_BATCH, f32, value and gradient on the card vs the CPU
EVAL_SIZE, EVAL_BATCH, EVAL_PAIRS = 1024, 8, 16
LOSS_SIZE, LOSS_BATCH = 256, 4
# the card vs the CPU, one loss in f32 (TF32 off): FFTs, convolutions and
# sums in another order; relative to max|ref|, the value and each gradient
# (readings on an H100: values 1.8e-7, gradients 5.1e-7)
LOSS_TOL = 1e-4
# the perceptual family's gradient is discontinuous (the sign of each L1
# term, the VGG ReLUs): f32 roundoff flips some of those points on either
# device, moving single pixels' gradient by a few percent of max|g|, so it
# is held in relative L2 norm (readings on an H100: 5.5e-5 to 2.6e-3)
PERC_GRAD_TOL = 1e-2
# SSIM of one pair on the card vs the CPU (f32 filters in another order;
# readings on an H100: 4.2e-7 and 6.0e-7)
SSIM_DEVICE_TOL = 1e-5


def _loss_inputs(shape, seed):
    """(pred, truth): NCHW f32 in [-1, 1] on the CPU, seeded."""
    import torch

    g = torch.Generator().manual_seed(seed)
    return tuple(torch.rand(shape, generator=g) * 2 - 1 for _ in range(2))


def loss_on(lossfn, pred, truth):
    """The loss (its first element for fflMix) and its gradient w.r.t.
    pred, on pred's device."""
    import torch

    p = pred.clone().requires_grad_()
    res = lossfn(p, truth)
    loss = res[0] if lossfn.returns_components else res
    (g,) = torch.autograd.grad(loss, p)
    return loss.detach(), g


def eval_phase(card, run, train_batch):
    """11. the evaluation protocol on the card: (a) ``eval pairs`` at the
    JAX CLI's defaults (NewBigModel-Wavelet built for 1024, batch 8, bf16)
    from a checkpoint directory, through ln_leff and window_attn (launches
    as ``new_launches`` says for each batch, no plain version called), two
    images vs the plain versions at batch 1, the dumped pairs and the
    printed average PSNR, images/s and peak memory, and the kernels at the
    model's 1024x1024 shapes vs their plain versions and timed; (b) ``eval
    infer`` from phase 10's ``best/`` checkpoint directory; (c) ``eval
    ssim-psnr`` and ``eval uiqm`` over (a)'s pairs, SSIM on the card vs the
    CPU; (d) every loss name's value and gradient on the card vs the CPU,
    then ``eval loss-sanity`` on the card; (e) the SpectralTransformer train
    step with fflMix (placeholder VGG trunk) and ssimFFLCharbonnier in
    turns with L1withColor, and one CLI epoch with fflMix.  ``run`` is what
    phase 10 returns (its directory, train and test directories and A's
    best checkpoint).  Returns the 1024x1024 kernels' JSON rows."""
    import contextlib
    import io
    import re

    import numpy as np
    import torch

    from underwater_image_restoration_torch.cli.main import main as cli
    from underwater_image_restoration_torch.data import (
        decode_image,
        synthetic_pair_batch,
    )
    from underwater_image_restoration_torch.eval import (
        batched_apply,
        compute_uiqm,
        dir_ssim_psnr,
    )
    from underwater_image_restoration_torch.eval import evaluate as ev
    from underwater_image_restoration_torch.losses import (
        COMPONENTS,
        LOSS_NAMES,
        PERCEPTUAL_FAMILY,
        LossFunction,
    )
    from underwater_image_restoration_torch.losses import perceptual
    from underwater_image_restoration_torch.models import blocks
    from underwater_image_restoration_torch.models import (
        new_model as new_model_module,
    )
    from underwater_image_restoration_torch.models.new_model import (
        DecoderBlock,
        EncoderBlock,
    )
    from underwater_image_restoration_torch.ops import (
        ln_leff,
        ln_leff_plain,
        split_heads,
        window_attention,
        window_attention_plain,
    )
    from underwater_image_restoration_torch.train import (
        CheckpointManager,
        get_optimizer,
        make_train_step,
    )

    t_phase = time.perf_counter()
    root, train, test, best = run
    f32, bf16 = torch.float32, torch.bfloat16
    size, batch = EVAL_SIZE, EVAL_BATCH
    counters = {"ln_leff": ln_leff.launches,
                "window_attn": window_attention.launches}
    plain_calls = collections.Counter()

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            plain_calls[name] += 1
            return fn(*a, **k)
        return fn, wrapper

    patched = [(mod, name) + counted(mod, name) for mod, name in (
        (new_model_module, "ln_leff_plain"),
        (blocks, "window_attention_plain"))]

    def run_cli(argv):
        """``eval.main(argv)``, its printed lines echoed; (result, text)."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = ev.main(argv)
        print(buf.getvalue(), end="", flush=True)
        return res, buf.getvalue()

    # ---- (a) eval pairs at the JAX defaults from a checkpoint directory
    d11 = os.path.join(root, "phase11")
    t = time.perf_counter()
    # UIEB-like inputs: JPEGs that the command decodes and resizes to 1024
    raw_dir, ref_dir = _write_pairs(os.path.join(d11, "pairs"), EVAL_PAIRS,
                                    256, seed=110, jpeg=PROBE_JPEG)
    model = new_model("NewBigModel", "Wavelet", bf16, size, NEW_BIG_Q_SCALE)
    # the LN+LeFF calls at 1024x1024: (C, residual), the encoder's without
    # the residual, the decoder's with it
    leff_1024 = sorted({(m.norm2.weight.numel(), isinstance(m, DecoderBlock))
                        for name, m in model.named_modules()
                        if isinstance(m, (EncoderBlock, DecoderBlock))
                        and name != "bottleneck"
                        and int(name.split("_")[1]) == 0})
    ckpt = os.path.join(d11, "ckpt")
    CheckpointManager(ckpt).save(0, params=model.state_dict(), opt_state={},
                                 epoch=0, val_loss=0.0)
    print(f"(a) {EVAL_PAIRS} pairs of {PROBE_JPEG[0]}x{PROBE_JPEG[1]} JPEGs "
          f"and the checkpoint written in {time.perf_counter() - t:.1f} s",
          flush=True)
    u8 = np.stack([decode_image(os.path.join(raw_dir, f), size)
                   for f in sorted(os.listdir(raw_dir))[:2]])
    apply_1, _ = batched_apply(model, 1)
    apply_1(u8[:1])  # warm-up: cuDNN algorithms, plans
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    apply_1(u8[:1])
    torch.cuda.synchronize()
    one = torch.cuda.max_memory_allocated() - weights
    print(f"(a) memory: weights {weights / 2 ** 30:.2f} GiB, one image's "
          f"forward {one / 2 ** 30:.2f} GiB over them; batch {batch} "
          f"expected {(weights + batch * one) / 2 ** 30:.2f} GiB of the "
          f"card's {torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f}",
          flush=True)
    out_pred, out_ref = (os.path.join(d11, x) for x in ("test", "ref"))
    pairs_argv = ["pairs", "--weights", ckpt, "--test-raw", raw_dir,
                  "--test-ref", ref_dir, "--out-pred", out_pred,
                  "--out-ref", out_ref]
    try:
        for mod, name, _, wrapper in patched:
            setattr(mod, name, wrapper)
        bs = batch
        while True:
            for cnt in counters.values():
                cnt.clear()
            plain_calls.clear()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            try:
                psnrs, text = run_cli(pairs_argv + ["--batch", str(bs)])
                break
            except torch.cuda.OutOfMemoryError as e:
                if bs == 1:
                    raise
                print(f"(a) batch {bs} does not fit ({e}); trying "
                      f"{bs // 2}", flush=True)
                bs //= 2
                torch.cuda.empty_cache()
        secs = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        got = {k: dict(v) for k, v in counters.items()}
    finally:
        for mod, name, fn, _ in patched:
            setattr(mod, name, fn)
    n_batches = -(-EVAL_PAIRS // bs)
    want = {k: {key: n_batches * n for key, n in v.items()}
            for k, v in new_launches(model, bs).items()}
    print(f"(a) eval pairs (NewBigModel-Wavelet {size}x{size}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, batch "
          f"{bs}, bf16; the JAX CLI's defaults): {EVAL_PAIRS} pairs in "
          f"{secs:.2f} s, {EVAL_PAIRS / secs:.2f} images/s (checkpoint load, "
          f"PNG decode and encode included); peak memory {peak:.2f} GiB; "
          f"launches {({k: sum(v.values()) for k, v in got.items()})} "
          f"({n_batches} batches of {bs}); plain versions called "
          f"{sum(plain_calls.values())} times; on {card}", flush=True)
    if got != want:
        fail(f"(a) expected the launches {want}, got {got}")
    if plain_calls:
        fail(f"(a) plain versions called: {dict(plain_calls)}")
    names = sorted(f"{i}.png" for i in range(EVAL_PAIRS))
    if sorted(os.listdir(out_pred)) != names or \
            sorted(os.listdir(out_ref)) != names:
        fail("(a) eval pairs did not dump one pred/ref pair an input")
    avg = re.search(r"Average PSNR: (\S+) dB", text)
    if (len(psnrs) != EVAL_PAIRS or not np.isfinite(psnrs).all() or avg is
            None or avg.group(1) != f"{psnrs.mean():.2f}"):
        fail(f"(a) PSNRs {psnrs} or the printed average {avg}")

    # the forward alone at the batch, kernels, in images/s
    raw8, _ = synthetic_pair_batch(bs, size, seed=111)
    apply_b, _ = batched_apply(model, bs)
    apply_b(raw8)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(3):
        apply_b(raw8)
    torch.cuda.synchronize()
    fwd_rate = 3 * bs / (time.perf_counter() - t)
    print(f"(a) forward alone, batch {bs}: {fwd_rate:.2f} images/s on {card}",
          flush=True)
    del apply_b, raw8

    # two images vs the plain versions at batch 1, relative L2
    def dist(a, r):
        return float((a.float() - r.float()).norm() / r.float().norm())

    for i in range(2):
        outs = {}
        for dt in (f32, bf16):
            model.compute_dtype = dt
            for use in (True, False):
                outs[(dt, use)] = batched_apply(model, 1, use)[0](
                    u8[i:i + 1])
        torch.cuda.synchronize()
        e32 = dist(outs[(f32, True)], outs[(f32, False)])
        e16 = dist(outs[(bf16, True)], outs[(bf16, False)])
        own = dist(outs[(bf16, False)], outs[(f32, False)])
        print(f"(a) image {i} at batch 1, kernels vs plain model, ||out - "
              f"ref||/||ref||: f32 {e32:.3e} (tol {NEW_MODEL_TOL:.0e}), bf16 "
              f"{e16:.3e} (tol {NEW_BF16_FLOOR:g} x the bf16 plain model's "
              f"{own:.3e} from the f32 one)", flush=True)
        if not e32 <= NEW_MODEL_TOL or not e16 <= NEW_BF16_FLOOR * own:
            fail(f"(a) image {i}: the kernels disagree with the plain model")
        del outs
    model.compute_dtype = bf16
    del model
    torch.cuda.empty_cache()

    # the kernels at the model's 1024x1024 shapes, batch bs, bf16 (f32 is
    # held at every 256x256 shape in phases 6 and 8), inputs drawn on the
    # card
    rows = {}
    with torch.no_grad():
        for c, residual in leff_1024:
            _, wts = leff_inputs(c, 1, 1, 1, seed=c + 11)
            xb = torch.randn((bs, size, size, c), device="cuda", dtype=bf16,
                             generator=torch.Generator("cuda").manual_seed(c))
            got_y = ln_leff(xb, *wts, residual=residual).float()
            ref_y = ln_leff_plain(xb, *wts, residual=residual).float()
            err = (got_y - ref_y).abs().max().item()
            branch = (ref_y - xb.float() if residual else ref_y).abs().max()
            kernel_verdict(f"ln_leff C={c} {size}x{size} batch {bs} "
                           f"residual={residual}", err, branch.item(), bf16)
            del got_y, ref_y
            ms = median_ms(lambda: ln_leff(xb, *wts, residual=residual),
                           reps=5)
            pms = median_ms(lambda: ln_leff_plain(xb, *wts,
                                                  residual=residual),
                            reps=1, warmup=1)
            bms, by = bound(*work_ast("ln_leff", (c, size), bs, 2))
            rows[("ln_leff", c, residual)] = timing_row(ms, pms, bms, by,
                                                        err)
            print(f"ln_leff C={c} {size}x{size} bf16 batch {bs} residual="
                  f"{residual}: kernel {ms}, plain {pms}, bound {bms:.4f} "
                  f"ms ({by}) on {card}", flush=True)
            del xb
        for key in sorted(k for k in want["window_attn"]
                          if k[0] == bs * (size // AST_WIN) ** 2):
            bq, heads, n, d, _ = key
            g = torch.Generator("cuda").manual_seed(d)
            q = torch.randn((bq, n, heads * d), device="cuda", dtype=bf16,
                            generator=g)
            kv = torch.randn((bq, n, 2 * heads * d), device="cuda",
                             dtype=bf16, generator=g)
            args = (split_heads(q, heads), split_heads(kv[..., :heads * d],
                                                       heads),
                    split_heads(kv[..., heads * d:], heads),
                    torch.randn((heads, n, n), device="cuda", generator=g))
            kw = dict(scale=d ** -0.5, mask=None,
                      sparse_w=torch.tensor([0.3, -0.4], device="cuda"))
            got_y = window_attention(*args, **kw).float()
            ref_y = window_attention_plain(*args, **kw).float()
            err = (got_y - ref_y).abs().max().item()
            kernel_verdict(f"window_attn N={n} d={d} B'={bq} heads={heads}",
                           err, ref_y.abs().max().item(), bf16)
            del got_y, ref_y
            ms = median_ms(lambda: window_attention(*args, **kw), reps=5)
            pms = median_ms(lambda: window_attention_plain(*args, **kw),
                            reps=1, warmup=1)
            bms, by = bound(*work_ast("window_attn",
                                      (bq // bs, heads, False), bs, 2, d))
            rows[("window_attn", key)] = timing_row(ms, pms, bms, by, err)
            print(f"window_attn B'={bq} heads={heads} N={n} d={d} bf16: "
                  f"kernel {ms}, plain {pms}, bound {bms:.4f} ms ({by}) on "
                  f"{card}", flush=True)
            del q, kv, args
    torch.cuda.empty_cache()
    kernels = []
    for key, row in rows.items():
        if key[0] == "ln_leff":
            _, c, residual = key
            kernels.append(kernel_row(
                f"ln_leff[C={c},{size}x{size},residual={residual},"
                "NewBigModel]", "ln_leff",
                got["ln_leff"].get((c, size, size), 0), row))
        else:
            k = key[1]
            kernels.append(kernel_row(
                f"window_attn[B'={k[0]},heads={k[1]},N=64,d={k[3]},"
                "unmasked,NewBigModel]", "window_attn",
                got["window_attn"].get(k, 0), row))
    print(f"phase 11(a) took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- (b) eval infer from phase 10's best/ checkpoint directory
    out_u = os.path.join(d11, "uTest")
    n, _ = run_cli(["infer", "--weights", best, "-a", "SpectralTransformer",
                    "--use-dwt", "Fourier", "--input", test[0], "--out",
                    out_u, "--size", "256"])
    written = sorted(os.listdir(out_u))
    print(f"(b) eval infer from {best}: {len(written)} images for "
          f"{len(os.listdir(test[0]))} inputs", flush=True)
    if n != len(os.listdir(test[0])) or written != sorted(
            f"{i}.png" for i in range(n)):
        fail(f"(b) eval infer wrote {written[:4]}...")

    # ---- (c) eval ssim-psnr and eval uiqm over (a)'s pairs
    (ssims, gray), _ = run_cli(["ssim-psnr", "--gen", out_pred, "--gt",
                                out_ref])
    cpu_ssims, cpu_gray = dir_ssim_psnr(out_pred, out_ref, device="cpu")
    gap = float(np.abs(ssims - cpu_ssims).max())
    print(f"(c) SSIM on the card vs the CPU: max |diff| {gap:.2e} (tol "
          f"{SSIM_DEVICE_TOL:.0e}); grayscale PSNRs equal: "
          f"{bool(np.array_equal(gray, cpu_gray))}", flush=True)
    if not gap <= SSIM_DEVICE_TOL or not np.array_equal(gray, cpu_gray):
        fail("(c) SSIM or PSNR on the card differ from the CPU's")
    vals, _ = run_cli(["uiqm", "--dir", out_pred])
    parts = np.array([compute_uiqm(decode_image(os.path.join(out_pred, f),
                                                256), emulate_cv2=True)
                      for f in sorted(os.listdir(out_pred))])
    print(f"(c) UIQM {parts[:, 0].mean():.4f} (UICM {parts[:, 1].mean():.4f}"
          f", UISM {parts[:, 2].mean():.4f}, UICONM {parts[:, 3].mean():.4f})"
          f"; trimmed PSNR {np.sort(gray)[4:].mean():.4f} dB over "
          f"{len(gray) - 4} pairs", flush=True)
    if not np.array_equal(vals, parts[:, 0]) or not np.isfinite(parts).all():
        fail("(c) the UIQM sweep disagrees with compute_uiqm")
    print(f"phase 11(a-c) took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- (d) every loss on the card vs the CPU, f32
    shape = (LOSS_BATCH, 3, LOSS_SIZE, LOSS_SIZE)
    worst = {}
    for i, name in enumerate(LOSS_NAMES):
        fn = LossFunction(name, allow_placeholder_vgg=True)
        p, t_ = _loss_inputs(shape, seed=120 + i)
        v_ref, g_ref = loss_on(fn, p, t_)
        v, g = loss_on(fn, p.cuda(), t_.cuda())
        g = g.cpu()
        ev_ = abs(float(v) - float(v_ref)) / abs(float(v_ref))
        if name in PERCEPTUAL_FAMILY:
            eg, tol_g = float((g - g_ref).norm() / g_ref.norm()), PERC_GRAD_TOL
        else:
            eg = float((g - g_ref).abs().max() / g_ref.abs().max())
            tol_g = LOSS_TOL
        worst[name] = (ev_, eg)
        if not (ev_ <= LOSS_TOL and eg <= tol_g and bool(
                torch.isfinite(g).all())):
            fail(f"(d) {name}: value {float(v)!r} vs {float(v_ref)!r} "
                 f"(relative {ev_:.2e}), gradient {eg:.2e} (tol {tol_g:.0e})")
    print(f"(d) the 20 losses at {LOSS_SIZE}x{LOSS_SIZE} batch {LOSS_BATCH} "
          f"f32 on the card vs the CPU, value / gradient (max abs over "
          f"max|ref|; the perceptual family's gradient in relative L2): " +
          ", ".join(f"{k} {a:.1e}/{b:.1e}" for k, (a, b) in worst.items()),
          flush=True)
    floors, _ = run_cli(["loss-sanity"])
    if any(not math.isfinite(v) for v in floors.values()) or len(floors) < 14:
        fail(f"(d) loss-sanity: {floors}")
    print(f"phase 11(d) took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- (e) the train step with the new losses, in turns
    from underwater_image_restoration_torch.models import init_model
    from underwater_image_restoration_torch.ops import fused_gdfn, fused_mdta

    tb = train_batch
    model = init_model("SpectralTransformer", seed=0, compute_dtype=bf16)
    raw, ref = synthetic_pair_batch(tb, 256, seed=121)
    steps = {name: make_train_step(
        model, LossFunction(name, allow_placeholder_vgg=True),
        get_optimizer("adam", model.parameters(), LR))
        for name in ("L1withColor", "fflMix", "ssimFFLCharbonnier")}
    spec = {"ln_gdfn": fused_gdfn.ln_gdfn, "ln_mdta": fused_mdta.ln_mdta,
            "ln_gdfn_bwd": fused_gdfn.ln_gdfn_bwd,
            "ln_mdta_bwd": fused_mdta.ln_mdta_bwd}
    want = spectral_launches(tb, train=True)
    for name, st in steps.items():
        m = st(raw, ref)  # warm-up
        torch.cuda.synchronize()
        for cnt in spec.values():
            cnt.launches.clear()
        m = st(raw, ref)
        torch.cuda.synchronize()
        got = {k: dict(c.launches) for k, c in spec.items()}
        comps = {k: float(m[k]) for k in COMPONENTS if k in m}
        print(f"(e) {name}: loss {float(m['loss']):.6f}, components "
              f"{comps}; launches in one step "
              f"{ {k: sum(v.values()) for k, v in got.items()} }",
              flush=True)
        if got != want:
            fail(f"(e) {name}: the step launched {got}, phase 5 counts {want}")
        if name == "fflMix" and (len(comps) != 5 or not all(
                math.isfinite(v) for v in comps.values())):
            fail(f"(e) fflMix components {comps}")
    rates, mem = {k: [] for k in steps}, {}
    for name in list(steps) + list(steps)[::-1]:
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(3):
            steps[name](raw, ref)
        torch.cuda.synchronize()
        rates[name].append(3 * tb / (time.perf_counter() - t))
        mem[name] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"(e) train step SpectralTransformer 256x256 bf16 batch {tb}, "
          "images/s in turns (3 steps each) and peak memory: " + "; ".join(
              f"{k} {[round(r, 2) for r in v]} ({mem[k]:.2f} GiB)"
              for k, v in rates.items()) + f" on {card}", flush=True)
    del steps, model
    torch.cuda.empty_cache()
    cwd = os.getcwd()
    try:
        os.chdir(root)
        ckpt_e = os.path.join(d11, "fflmix")
        cli(["-a", "SpectralTransformer", "--image-size", "256",
             "--train-batch-size", str(tb), "--test-batch-size",
             str(RUN_TEST_BATCH), "--lossf", "fflMix",
             "--allow-placeholder-vgg", "--optim", "adam", "--lr", str(LR),
             "--compute-dtype", "bfloat16", "--use-wandb", "--print-freq",
             "100", "-j", "4", "--max-epoch", "1", "--watch-freq", "0",
             "--checkpoint-dir", ckpt_e, "--train-raw", train[0],
             "--train-ref", train[1], "--test-raw", test[0], "--test-ref",
             test[1]])
    finally:
        os.chdir(cwd)
    rec = _jsonl(os.path.join(ckpt_e, os.listdir(ckpt_e)[0]))
    keys = {k for r in rec for k in r}
    need = {"train/loss_" + c for c in COMPONENTS} | {"train/loss",
                                                      "test/loss"}
    print(f"(e) a CLI epoch with --lossf fflMix: metrics.jsonl keys "
          f"{sorted(k for k in keys if k.startswith(('train/', 'test/')))}",
          flush=True)
    if not need <= keys:
        fail(f"(e) metrics.jsonl lacks {sorted(need - keys)}")
    shutil.rmtree(root, ignore_errors=True)
    perceptual._trunk.cache_clear()
    torch.cuda.empty_cache()
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return kernels


# ---------------------------------------------------------------------------
# 12. data parallelism, parameter sharding, the exported serving forward,
# Grad-CAM and SFCA

PAR_WORLD = 2
# the rates' windows: train steps a turn (12(a)) and serving batches a rate
# (12(c)), long enough that repeated calls agree
PAR_STEPS = 30
SERVE_BATCHES = 40
# a reloaded program within this much of the eager forward (the same
# kernels on the same inputs)
EXPORT_TOL = 1e-6
EXPORT_BATCHES = (8, 3)
EXPORT_NODES = {"SpectralTransformer": {"ln_mdta": 24, "ln_gdfn": 24},
                "AST": {"ln_leff": 18, "window_attn": 10},
                "NewModel-Wavelet": {"ln_leff": 9, "window_attn": 10}}
# the exported models: (arch, init_model's keyword arguments)
EXPORT_MODELS = {"SpectralTransformer": ("SpectralTransformer", {}),
                 "AST": ("AST", {}),
                 "NewModel-Wavelet": ("NewModel", {"use_dwt": "Wavelet"})}
# Grad-CAM through the kernels vs the CPU's plain versions, f32: the map is
# min-max normalized, its error the gradient's relative error times the
# channels' spread
CAM_TOL = 1e-3
# SFCA on the card vs the CPU, f32, of max|ref|: cuFFT vs pocketfft and
# cuDNN vs oneDNN sums (TF32 off)
SFCA_TOL = 1e-4


def _spectral_for_training(torch, device, dt):
    from underwater_image_restoration_torch.models import init_model
    from underwater_image_restoration_torch.models.spectral_transformer import (
        MDTA,
    )

    model = init_model("SpectralTransformer", seed=0, compute_dtype=dt,
                       device=device)
    with torch.no_grad():
        for blk in model.modules():
            if isinstance(blk, MDTA):
                blk.temperature.fill_(MODEL_TEMPERATURE)
    return model


def _grads_step(torch, model, raw, ref, parallel=None):
    """One ``make_train_step`` step under plain SGD at learning rate 0 and
    no clip: (loss, {name: f32 gradient on the CPU}, the full tensors of a
    sharded model's), the parameters left as they were."""
    from underwater_image_restoration_torch.core import meshes
    from underwater_image_restoration_torch.losses import LossFunction
    from underwater_image_restoration_torch.train import (
        get_optimizer,
        make_train_step,
    )

    opt = get_optimizer("sgd", model.parameters(), 0.0, momentum=0.0,
                        clip_norm=0.0)
    out = make_train_step(model, LossFunction("L1withColor"), opt,
                          parallel=parallel)(raw, ref)
    grads = {n: meshes.full_tensor(p.grad).detach().float().cpu()
             for n, p in model.named_parameters()}
    return float(out["loss"]), grads


def _rate_turn(torch, step, raw, ref, steps=PAR_STEPS):
    """Images/s of ``steps`` steps after one untimed, and the peak GiB."""
    step(raw, ref)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(steps):
        step(raw, ref)
    torch.cuda.synchronize()
    return (steps / (time.perf_counter() - t),
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _parallel_rank(rank, port, out_dir, batch, size, check_batch):
    """A rank of phase 12(a)-(b): the data-parallel step's launches,
    gradients and rate, then FSDP's gradients and checkpoint; results in
    ``out_dir/rank<r>.pt``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(PAR_WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import torch

    from underwater_image_restoration_torch.core import meshes
    from underwater_image_restoration_torch.data import synthetic_pair_batch
    from underwater_image_restoration_torch.losses import LossFunction
    from underwater_image_restoration_torch.ops import ln_gdfn, ln_mdta
    from underwater_image_restoration_torch.ops.fused_gdfn import ln_gdfn_bwd
    from underwater_image_restoration_torch.ops.fused_mdta import ln_mdta_bwd
    from underwater_image_restoration_torch.train import (
        get_optimizer,
        make_train_step,
    )

    def stage(msg):
        print(f"12 rank {rank}: {msg}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    # the ranks share the host's cores (each one's CPU threads spinning
    # against the other's would stall both)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // PAR_WORLD))
    dp = meshes.init_data_parallel(
        PAR_WORLD, rank,
        backend=meshes.default_backend(torch.device("cuda"), PAR_WORLD))
    counters = {"ln_gdfn": ln_gdfn.launches, "ln_mdta": ln_mdta.launches,
                "ln_gdfn_bwd": ln_gdfn_bwd.launches,
                "ln_mdta_bwd": ln_mdta_bwd.launches}
    res = {"device": str(dp.device), "backend": dp.backend}
    stage(f"joined the group on {dp.device} over {dp.backend}")
    raw, ref = synthetic_pair_batch(batch, size, seed=0)
    rows = dp.rows(batch)
    dev = dp.device

    # (a) the step's launches, from zero, and its gradients: bf16 at the
    # global batch, f32 at check_batch
    model = _spectral_for_training(torch, dev, torch.bfloat16)
    _grads_step(torch, model, raw[rows], ref[rows], dp)  # warm-up
    torch.cuda.synchronize()
    stage("warm-up step done")
    for cnt in counters.values():
        cnt.clear()
    res["bf16"] = _grads_step(torch, model, raw[rows], ref[rows], dp)
    torch.cuda.synchronize()
    res["launches"] = {k: dict(v) for k, v in counters.items()}
    model.compute_dtype = torch.float32
    crow = dp.rows(check_batch)
    res["f32"] = _grads_step(torch, model, raw[:check_batch][crow],
                             ref[:check_batch][crow], dp)
    model.compute_dtype = torch.bfloat16

    # images/s and peak memory, in turns: one rank's step at the global
    # batch (rank 0, while rank 1 waits), the two ranks' steps
    lossfn = LossFunction("L1withColor")
    one = copy.deepcopy(model) if dp.is_main else None
    turns = []
    for kind in ("one", "two", "two", "one"):
        dp.barrier()
        if kind == "two":
            st = make_train_step(
                model, lossfn, get_optimizer("adam", model.parameters(), LR),
                parallel=dp)
            rate, mem = _rate_turn(torch, st, raw[rows], ref[rows])
            turns.append((kind, rate * batch, mem))
        elif dp.is_main:
            st = make_train_step(one, lossfn,
                                 get_optimizer("adam", one.parameters(), LR))
            rate, mem = _rate_turn(torch, st, raw, ref)
            turns.append((kind, rate * batch, mem))
        st = None
        torch.cuda.empty_cache()
        dp.barrier()
    res["turns"] = turns
    stage("turns done")
    del one, model
    torch.cuda.empty_cache()

    # (b) FSDP from the same weights: its gradients (gathered), then an Adam
    # step, its checkpoint in the single-device format, and an eval-mode
    # forward of the sharded model on rank 0's rows for the check on one
    # device
    fsdp = meshes.shard_model(
        _spectral_for_training(torch, dev, torch.bfloat16), dp)
    res["fsdp_bf16"] = _grads_step(torch, fsdp, raw[rows], ref[rows], dp)
    opt = get_optimizer("adam", fsdp.parameters(), LR)
    make_train_step(fsdp, lossfn, opt, parallel=dp)(raw[rows], ref[rows])
    params, opt_state = meshes.full_state(fsdp, opt)
    stage("FSDP step and gather done")
    xs = raw[:check_batch]
    fsdp.eval()
    with torch.no_grad():
        x = (torch.as_tensor(xs).to(dev).float() / 255.0 * 2 - 1).permute(
            0, 3, 1, 2).contiguous()
        res["fsdp_out"] = fsdp(x).float().cpu()
    if dp.is_main:
        torch.save({"params": params, "opt_state": opt_state},
                   os.path.join(out_dir, "fsdp_ckpt.pt"))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    del fsdp, opt
    meshes.close_data_parallel(dp)


_RELOAD = r'''
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
# the settings the parent process runs under
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
from underwater_image_restoration_torch.data import synthetic_pair_batch
from underwater_image_restoration_torch.eval import batched_apply
from underwater_image_restoration_torch.models import init_model
from underwater_image_restoration_torch.ops import (
    ln_gdfn, ln_leff, ln_mdta, window_attention)
from underwater_image_restoration_torch.tools.export_model import (
    load_exported)
counters = {"ln_mdta": ln_mdta.launches, "ln_gdfn": ln_gdfn.launches,
            "ln_leff": ln_leff.launches,
            "window_attn": window_attention.launches}
size, n = int(sys.argv[3]), int(sys.argv[4])
models = json.loads(sys.argv[5])


def rate(fn, arg, b):
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn(arg)
    torch.cuda.synchronize()
    return n * b / (time.perf_counter() - t)


out = {}
for arch, (name, kw) in models.items():
    fn = load_exported(f"{sys.argv[2]}/{arch}.pt2")
    x, want = torch.load(f"{sys.argv[2]}/{arch}.io.pt")
    x = x.cuda()
    fn(x)
    torch.cuda.synchronize()
    for c in counters.values():
        c.clear()
    got = fn(x)
    torch.cuda.synchronize()
    launches = {k: sum(v.values()) for k, v in counters.items()}
    err = (got.cpu() - want).abs().max().item()
    # images/s of the program and of the eager batched_apply (the same
    # seeded model, uint8 in), in turns in this one process
    b = x.shape[0]
    apply_b, _ = batched_apply(init_model(name, seed=0, img_size=size,
                                          compute_dtype=torch.bfloat16,
                                          **kw), b)
    u8 = synthetic_pair_batch(b, size, seed=1)[0]
    apply_b(u8)
    turns = {"program": [], "eager": []}
    for kind in ("program", "eager", "eager", "program"):
        turns[kind].append(rate(fn, x, b) if kind == "program"
                           else rate(apply_b, u8, b))
    out[arch] = {"launches": launches, "err": err, **turns}
print(json.dumps(out))
'''


def parallel_phase(card, batch, size, check_batch):
    """Phase 12: (a) the 2-rank data-parallel train step of the full-width
    SpectralTransformer@256 (bf16, global batch ``batch``, rank r its rows
    ``DataParallel.rows``; two processes sharing one card over gloo, over
    nccl where there is a card a rank): each rank's launches as the
    planners say for batch/2, loss and gradients vs the one-rank step
    (bf16 at the global batch, f32 at ``check_batch``) within phase 5(c)'s
    limits and 5(d)'s loss limit, images/s and peak memory a rank beside
    the one-rank step's, in turns; (b) FSDP2 (``shard_model``, the same
    two ranks): its gradients vs the data-parallel ones, and its
    checkpoint (``full_state``) loaded into a model on one device, whose
    forward equals the sharded model's; (c) ``torch.export`` of
    SpectralTransformer@256, AST@256 and NewModel-Wavelet@256 (bf16,
    symbolic batch): custom-op
    nodes as the planners' kernel calls, the program vs the eager forward
    at batch 8 and 3 within EXPORT_TOL with the eager launches, reloaded in
    a fresh process that launches the kernels, its images/s beside eager
    ``batched_apply``'s in turns there; (d) Grad-CAM and SFCA on the card
    vs the CPU.  Returns no kernel rows (every kernel's row is its own phase's)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from underwater_image_restoration_torch.data import synthetic_pair_batch
    from underwater_image_restoration_torch.eval.gradcam import grad_cam
    from underwater_image_restoration_torch.models import init_model
    from underwater_image_restoration_torch.models.spectral_transformer import (
        SFCA,
    )
    from underwater_image_restoration_torch.ops import (
        ln_gdfn,
        ln_leff,
        ln_mdta,
        window_attention,
    )
    from underwater_image_restoration_torch.tools import export_model as em
    from underwater_image_restoration_torch.train import get_optimizer

    t_phase = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="phase12-", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    torch.backends.cudnn.deterministic = True
    raw, ref = synthetic_pair_batch(batch, size, seed=0)

    # ---- (a) the one-rank references, then the two ranks
    model = _spectral_for_training(torch, "cuda", torch.bfloat16)
    ref_bf16 = _grads_step(torch, model, raw, ref)
    model.compute_dtype = torch.float32
    ref_f32 = _grads_step(torch, model, raw[:check_batch], ref[:check_batch])
    del model
    torch.cuda.empty_cache()
    t = time.perf_counter()
    # a rank that dies of a signal prints its Python stack
    os.environ["PYTHONFAULTHANDLER"] = "1"
    mp.spawn(_parallel_rank,
             args=(_free_port(), out_dir, batch, size, check_batch),
             nprocs=PAR_WORLD)
    t_ranks = time.perf_counter() - t
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(PAR_WORLD)]
    print(f"12 ranks: {PAR_WORLD} processes on {[r['device'] for r in ranks]}"
          f" over {ranks[0]['backend']} ({t_ranks:.1f} s with their start)",
          flush=True)
    want = spectral_launches(batch // PAR_WORLD, train=True)
    for r, res in enumerate(ranks):
        totals = {k: sum(v.values()) for k, v in res["launches"].items()}
        print(f"12(a) rank {r} launches in one step: {totals} (the planners "
              f"at batch {batch // PAR_WORLD}: "
              f"{ {k: sum(v.values()) for k, v in want.items()} })",
              flush=True)
        if res["launches"] != want:
            fail(f"12(a) rank {r}: expected launches {want}, got "
                 f"{res['launches']}")
    for tag, (loss, g), (rloss, rg) in (("bfloat16", ranks[0]["bf16"],
                                         ref_bf16),
                                        ("float32", ranks[0]["f32"],
                                         ref_f32)):
        rel, mx = grad_dist(g, rg)
        dl = abs(loss - rloss) / abs(rloss)
        tol = TRAIN_GRAD_TOL[tag]
        nb = batch if tag == "bfloat16" else check_batch
        print(f"12(a) {tag} global batch {nb}, two ranks vs one: loss "
              f"{loss:.6f} vs {rloss:.6f} (relative {dl:.3e}, tol "
              f"{TRAIN_LOSS_TOL:.0e}); ||g - g_ref||/||g_ref|| {rel:.3e} "
              f"(tol {tol:.0e}), max abs/max|g_ref| {mx:.3e}", flush=True)
        if not (rel <= tol and dl <= TRAIN_LOSS_TOL):
            fail(f"12(a) the two-rank {tag} step disagrees with one rank's")
    by = collections.defaultdict(list)
    for r, res in enumerate(ranks):
        for kind, rate, mem in res["turns"]:
            by[kind].append((r, rate, mem))
    one = [rate for _, rate, _ in by["one"]]
    two = [rate for r, rate, _ in by["two"] if r == 0]
    print(f"12(a) train step SpectralTransformer {size}x{size} bf16 global "
          f"batch {batch}: two ranks {sum(two) / 2:.2f} images/s {two} "
          f"(peak memory a rank "
          f"{[round(m, 2) for _, _, m in by['two']]} GiB), one rank "
          f"{sum(one) / 2:.2f} images/s {one} (peak "
          f"{[round(m, 2) for _, _, m in by['one']]} GiB), in turns, over "
          f"{ranks[0]['backend']} on {card}", flush=True)

    # ---- (b) FSDP vs the data-parallel step; its checkpoint on one device
    rel, mx = grad_dist(ranks[0]["fsdp_bf16"][1], ranks[0]["bf16"][1])
    dl = abs(ranks[0]["fsdp_bf16"][0] - ranks[0]["bf16"][0])
    print(f"12(b) FSDP vs data-parallel bf16 step: loss difference {dl:.3e}, "
          f"||g - g_dp||/||g_dp|| {rel:.3e}, max abs/max|g_dp| {mx:.3e} "
          f"(tol {TRAIN_LOSS_TOL:.0e})", flush=True)
    if not (rel <= TRAIN_LOSS_TOL and dl <= TRAIN_LOSS_TOL):
        fail("12(b) FSDP's gradients disagree with the data-parallel step's")
    ckpt = torch.load(os.path.join(out_dir, "fsdp_ckpt.pt"),
                      weights_only=False)
    single = _spectral_for_training(torch, "cuda", torch.bfloat16)
    single.load_state_dict(ckpt["params"], strict=True)
    get_optimizer("adam", single.parameters(), LR).load_state_dict(
        ckpt["opt_state"])
    with torch.no_grad():
        xs = torch.as_tensor(raw[:check_batch]).cuda().float()
        y1 = single((xs / 255.0 * 2 - 1).permute(0, 3, 1, 2).contiguous())
    err = (y1.float().cpu() - ranks[0]["fsdp_out"]).abs().max().item()
    print(f"12(b) the FSDP checkpoint ({len(ckpt['params'])} tensors, Adam "
          f"state of {len(ckpt['opt_state']['inner']['state'])}) loads "
          f"strict on one device; its forward vs the sharded model's: max "
          f"abs {err:.3e} (tol {EXPORT_TOL:.0e})", flush=True)
    if err > EXPORT_TOL:
        fail("12(b) the FSDP checkpoint does not give the sharded model's "
             "forward on one device")
    del single, ckpt, y1
    torch.cuda.empty_cache()

    # ---- (c) the exported serving forward
    counters = {"ln_mdta": ln_mdta.launches, "ln_gdfn": ln_gdfn.launches,
                "ln_leff": ln_leff.launches,
                "window_attn": window_attention.launches}

    def count():
        torch.cuda.synchronize()
        return {k: sum(v.values()) for k, v in counters.items()}

    eager_launches = {}
    for arch, (name, kw) in EXPORT_MODELS.items():
        model = init_model(name, seed=0, compute_dtype=torch.bfloat16,
                           img_size=size, **kw)
        t = time.perf_counter()
        program = em.export_module(model, size)
        t_export = time.perf_counter() - t
        nodes = dict(em.custom_op_counts(program))
        print(f"12(c) {arch}@{size} exported in {t_export:.1f} s: custom-op "
              f"nodes {nodes} (the planners' calls: {EXPORT_NODES[arch]})",
              flush=True)
        if nodes != EXPORT_NODES[arch]:
            fail(f"12(c) {arch}'s program holds {nodes} custom-op nodes")
        eager = em.ServingForward(model)
        for b in EXPORT_BATCHES:
            u8 = synthetic_pair_batch(b, size, seed=b)[0]
            x = torch.as_tensor(u8).cuda().float() / 255.0 * 2 - 1
            with torch.no_grad():
                eager(x)
                for c in counters.values():
                    c.clear()
                want = eager(x)
                n_eager = count()
            got = program.module()(x)
            for c in counters.values():
                c.clear()
            got = program.module()(x)
            n_prog = count()
            err = (got.float() - want.float()).abs().max().item()
            print(f"12(c) {arch} batch {b}: program vs eager max abs "
                  f"{err:.3e} (tol {EXPORT_TOL:.0e}); launches {n_prog} "
                  f"(eager {n_eager})", flush=True)
            if err > EXPORT_TOL or n_prog != n_eager or not any(
                    n_prog.values()):
                fail(f"12(c) {arch}'s program at batch {b} disagrees with "
                     "the eager forward")
            if b == EXPORT_BATCHES[0]:
                eager_launches[arch] = n_eager
                torch.save((x.cpu(), got.float().cpu()),
                           os.path.join(out_dir, f"{arch}.io.pt"))
        torch.export.save(program, os.path.join(out_dir, f"{arch}.pt2"))
        del model, program, eager
        torch.cuda.empty_cache()
    t = time.perf_counter()
    fresh = subprocess.run(
        [sys.executable, "-c", _RELOAD,
         os.path.dirname(os.path.abspath(__file__)), out_dir, str(size),
         str(SERVE_BATCHES), json.dumps(EXPORT_MODELS)],
        capture_output=True, text=True, timeout=600)
    if fresh.returncode != 0:
        fail(f"12(c) the fresh process failed:\n{fresh.stderr[-3000:]}")
    reload = json.loads(fresh.stdout.strip().splitlines()[-1])
    print(f"12(c) fresh process ({time.perf_counter() - t:.1f} s with its "
          f"start): {reload}", flush=True)
    for arch, r in reload.items():
        if r["err"] > EXPORT_TOL or r["launches"] != eager_launches[arch]:
            fail(f"12(c) the reloaded {arch} program disagrees with the "
                 f"eager forward or did not launch the kernels: {r}")
        prog, eager = (sum(r[k]) / len(r[k]) for k in ("program", "eager"))
        print(f"12(c) serving {arch}@{size} bf16 batch {EXPORT_BATCHES[0]} "
              f"in the fresh process, {SERVE_BATCHES} batches a turn, in "
              f"turns: reloaded program {prog:.2f} images/s {r['program']} "
              f"(f32 NHWC in), eager batched_apply {eager:.2f} images/s "
              f"{r['eager']} (uint8 in), program/eager {prog / eager:.3f}, "
              f"on {card}", flush=True)

    # ---- (d) Grad-CAM and SFCA on the card vs the CPU, f32
    cam_model = init_model("SpectralTransformer", seed=0)
    cam_cpu = init_model("SpectralTransformer", seed=0, device="cpu")
    cam_cpu.load_state_dict(cam_model.state_dict())
    u8 = synthetic_pair_batch(1, 64, seed=5)[0]
    x = torch.as_tensor(u8).float().permute(0, 3, 1, 2) / 255.0 * 2 - 1
    for target in ("outputl", "encoders.1.0"):
        cam, act = grad_cam(cam_model, x.cuda(), target)
        cam_ref, act_ref = grad_cam(cam_cpu, x, target)
        err = float(abs(cam - cam_ref).max())
        aerr = float(abs(act - act_ref).max() / abs(act_ref).max())
        print(f"12(d) Grad-CAM at {target}, 64x64, through the kernels vs "
              f"the CPU's plain versions: map max abs {err:.3e} (tol "
              f"{CAM_TOL:.0e}), activation max abs/max|ref| {aerr:.3e}",
              flush=True)
        if err > CAM_TOL or aerr > SFCA_TOL:
            fail(f"12(d) Grad-CAM at {target} disagrees with the CPU")
    sfca = SFCA(16, device="cuda")
    sfca_cpu = SFCA(16)
    sfca_cpu.load_state_dict({k: v.cpu() for k, v in sfca.state_dict()
                              .items()})
    gen = torch.Generator().manual_seed(6)
    xs = torch.randn(2, 16, 64, 64, generator=gen)
    ct = torch.randn(2, 16, 64, 64, generator=gen)
    results = []
    for m, dev in ((sfca, "cuda"), (sfca_cpu, "cpu")):
        xi = xs.to(dev).requires_grad_()
        y = m(xi)
        (y * ct.to(dev)).sum().backward()
        results.append([y.detach().cpu(), xi.grad.cpu()] + [
            p.grad.cpu() for p in m.parameters()])
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(*results))
    print(f"12(d) SFCA(16) 64x64 f32 on the card vs the CPU: output, dx and "
          f"{len(results[0]) - 2} parameter gradients, worst max abs/"
          f"max|ref| {worst:.3e} (tol {SFCA_TOL:.0e})", flush=True)
    if worst > SFCA_TOL:
        fail("12(d) SFCA on the card disagrees with the CPU")
    torch.backends.cudnn.deterministic = False
    shutil.rmtree(out_dir)
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return []


# 13. context and tensor parallelism

CTX_WORLD = 2
# phase 13's models: AST@256 at the default kwargs, NewModel@256 in both
# modes, SpectralTransformer@256 at the full width (13(a)-(b)), with their
# one-step gradient limits
CTX_CASES = (("AST", "AST", {}),
             ("NewModel-Fourier", "NewModel", {"use_dwt": "Fourier"}),
             ("NewModel-Wavelet", "NewModel", {"use_dwt": "Wavelet"}),
             ("Spectral", "SpectralTransformer", {}))
# steps a turn: the Fourier mode's two ranks run at about 3 images/s on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md §6; its distributed FFTs move
# the whole map through gloo's host round trip), so its turns are one
# step; AST's and the Wavelet mode's are 5 so that the phase, with the
# Spectral case's 10, keeps the script within about half its time limit
CTX_STEPS = {"AST": 5, "NewModel-Fourier": 1, "NewModel-Wavelet": 5,
             "Spectral": 10}
# 13(f): the Spectral blocks' kernels on a rank's halo'd band vs the
# whole-map kernel on the whole map, max abs error over max|branch|
# (outputs) or max|reference| (gradients): f32 sums in another order, bf16
# roundings on the other side of a boundary (phase 2's and phase 4's
# readings).  Against the plain version the band is held to the limits
# the whole-map kernels are (KERNEL_TOL; GRAD_TOL, whose f32 dtemp, a
# gram's gradient over the map, reads up to 1.75e-5): the band's LN+GDFN
# output is the whole-map kernel's bit for bit, and at batch 16 that
# kernel reads up to 1.307e-05 from the plain version in f32 on an NVIDIA
# H100 80GB HBM3
CTX_BAND_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the primitives on CUDA tensors (f32) vs the one-process op on the whole
# map in the same process, of max|ref|: data movement is exact, the kernels
# and cuFFT/cuDNN walk a band in another order than the whole map
CTX_PRIM_TOL = 1e-5
# the CLI's logged validation vs a one-process ``evaluate`` of its
# checkpoint (f32, TF32 off in both), relative
CTX_CLI_TOL = 1e-5
CTX_CLI_PAIRS = (32, 8)


def _ctx_tol(name):
    return {"AST": AST_TRAIN_GRAD_TOL, "Spectral": TRAIN_GRAD_TOL}.get(
        name, NEW_TRAIN_GRAD_TOL)


def cp_launches(model, batch, index, n, sms, size=256):
    """What the planners say one train step (forward and backward) of the
    AST or a New* model at ``batch`` in bf16 launches on context rank
    ``index`` of ``n`` (of the SpectralTransformer at ``size``:
    ``spectral_cp_launches``): ln_leff and ln_leff_bwd by (C, rows, W), the rows
    the band's with a halo row to each neighbouring rank on a level the
    model runs on bands (``_level_banded``) and the whole map's elsewhere;
    window_attn and window_attn_bwd by (B', heads, N, d, masked), B' the
    band's windows."""
    import importlib

    from underwater_image_restoration_torch.models.ast import AST
    from underwater_image_restoration_torch.models.new_model import (
        DecoderBlock,
        EncoderBlock,
    )
    from underwater_image_restoration_torch.models.spectral_transformer import (
        SpectralTransformer,
    )
    from underwater_image_restoration_torch.ops import fused_leff

    wa = importlib.import_module(
        "underwater_image_restoration_torch.ops.window_attention")
    out = {k: collections.Counter() for k in (
        "ln_leff", "ln_leff_bwd", "window_attn", "window_attn_bwd")}
    halo = (index > 0) + (index < n - 1)

    def leff(c, side, banded):
        rows = side // n + halo if banded else side
        out["ln_leff"][(c, rows, side)] += fused_leff.fwd_plan(
            batch, rows, side, c, 4 * c, 2).launches
        out["ln_leff_bwd"][(c, rows, side)] += fused_leff.bwd_plan(
            batch, rows, side, c, 4 * c, 2, sms).launches

    def attn(side, banded, ws, heads, c, masked, calls):
        rows = side // n if banded else side
        key = (batch * (rows // ws) * (side // ws), heads, ws * ws,
               c // heads, masked)
        out["window_attn"][key] += calls
        out["window_attn_bwd"][key] += calls * wa.bwd_plan(
            key[0], heads, ws * ws, sms, d=key[3], itemsize=2).launches

    if isinstance(model, SpectralTransformer):
        return spectral_cp_launches(model, batch, index, n, sms, size)
    s = model.img_size
    if isinstance(model, AST):
        layers = ([(getattr(model, f"encoderlayer_{i}"), s >> i)
                   for i in range(4)] + [(model.conv, s >> 4)]
                  + [(getattr(model, f"decoderlayer_{i}"), s >> (3 - i))
                     for i in range(4)])
        for layer, side in layers:
            banded = model._level_banded(layer, side)
            for blk in layer.blocks:
                c = blk.norm2.weight.numel()
                if blk.att:
                    attn(side, banded, blk.win_size, blk.attn.num_heads, c,
                         blk.shift_size > 0, 1)
                leff(c, side, banded)
    else:
        for name, m in model.named_modules():
            if not isinstance(m, (EncoderBlock, DecoderBlock)):
                continue
            lvl = 4 if name == "bottleneck" else int(name.split("_")[1])
            side, c = s >> lvl, m.norm2.weight.numel()
            if isinstance(m, EncoderBlock):
                banded = model._level_banded(side, dim=c)
            else:
                banded = model._level_banded(side, m.mdassa.win_size)
                attn(side, banded, m.mdassa.win_size, NEW_HEADS, c, False, 2)
            if m.token_mlp == "leff":
                leff(c, side, banded)
    return {k: dict(v) for k, v in out.items() if v}


def spectral_block_levels(model):
    """[(block, level)] of a SpectralTransformer: each SpectralBlock and
    the level (0-3, its map the whole one halved that often) it runs at."""
    from underwater_image_restoration_torch.models.spectral_transformer import (
        SpectralBlock,
    )

    level = {"encoders.0": 0, "encoders.1": 1, "encoders.2": 2,
             "encoders.3": 3, "decoders.0": 2, "decoders.1": 1,
             "decoders.2": 0, "refinement": 0}
    return [(m, level[name.rsplit(".", 1)[0]])
            for name, m in model.named_modules()
            if isinstance(m, SpectralBlock)]


def spectral_cp_launches(model, batch, index, n, sms, size=256):
    """``cp_launches`` of the SpectralTransformer at ``size``: on a level
    it runs on bands (``levels_banded``), LN+GDFN on the band with a halo
    row to each neighbouring rank and LN+MDTA through the split entries on
    the band with MDTA_HALO rows to each (``spectral_launches``' split, the
    backward in the slices of the tallest band of any rank); elsewhere both
    on the whole map."""
    from underwater_image_restoration_torch.ops.fused_mdta import MDTA_HALO

    lv, _ = model.levels_banded(size, size)
    sides = (index > 0) + (index < n - 1)
    whole, gdfn, split = (collections.Counter(), collections.Counter(),
                          {})
    for m, i in spectral_block_levels(model):
        c, side = m.norm1.weight.numel(), size >> i
        if not lv[i]:
            whole[(c, side, side)] += 1
            gdfn[(c, side, side)] += 1
            continue
        rows = side // n
        gdfn[(c, rows + sides, side)] += 1
        key = (c, rows + MDTA_HALO * sides, side)
        split[key] = (split.get(key, (0,))[0] + 1,
                      rows + MDTA_HALO * min(2, n - 1))
    return spectral_launches(batch, True, dict(whole), split, dict(gdfn))


def _ctx_model(torch, arch, kw, dt, size, cp=None):
    """A phase-13 model; the SpectralTransformer's attention temperatures
    at MODEL_TEMPERATURE, as phase 5 trains it."""
    from underwater_image_restoration_torch.models import init_model
    from underwater_image_restoration_torch.models.spectral_transformer import (
        MDTA,
    )

    model = init_model(arch, seed=0, img_size=size, compute_dtype=dt, cp=cp,
                       **kw)
    with torch.no_grad():
        for blk in model.modules():
            if isinstance(blk, MDTA):
                blk.temperature.fill_(MODEL_TEMPERATURE)
    return model


def _ctx_grads(torch, model, raw, ref, parallel=None):
    """One ``make_train_step`` step (SGD at learning rate 0, no clip,
    DropPath from a generator seeded 1): (loss, {name: f32 gradient on the
    CPU}), a sharded model's gathered."""
    from underwater_image_restoration_torch.core import meshes
    from underwater_image_restoration_torch.losses import LossFunction
    from underwater_image_restoration_torch.train import (
        get_optimizer,
        make_train_step,
    )

    opt = get_optimizer("sgd", model.parameters(), 0.0, momentum=0.0,
                        clip_norm=0.0)
    out = make_train_step(
        model, LossFunction("L1withColor"), opt, parallel=parallel,
        generator=torch.Generator(device="cuda").manual_seed(1))(raw, ref)
    grads = {n: meshes.full_tensor(p.grad).detach().float().cpu()
             for n, p in model.named_parameters()}
    return float(out["loss"]), grads


def _ctx_primitives(torch, dp):
    """13(e): the primitives on CUDA tensors (f32), each rank's band vs the
    one-process op on the whole map: [(name, max abs error / max|ref|)]."""
    import torch.nn.functional as F

    from underwater_image_restoration_torch.ops import fused_leff
    from underwater_image_restoration_torch.ops.window_attention import (
        window_attention,
    )
    from underwater_image_restoration_torch.ops.windows import (
        shift_window_mask,
    )
    from underwater_image_restoration_torch.parallel import context as C
    from underwater_image_restoration_torch.parallel import cp_ops

    cp = dp.cp
    g = torch.Generator(device="cuda").manual_seed(13)

    def n(*shape, std=1.0):
        return torch.randn(shape, generator=g, device="cuda") * std

    img = n(2, 64, 64, 32)
    band = cp.band(64)
    rows = img[:, band].contiguous()
    mask = torch.from_numpy(shift_window_mask(64, 64, 8, 4)).cuda()
    nw = 64
    q, k, v = (n(2 * nw, 4, 64, 32) for _ in range(3))
    bias, w = n(4, 64, 64, std=0.5), torch.tensor([0.3, -0.4], device="cuda")
    leff = [n(32, std=0.1) + 1, n(32, std=0.1), n(32, 128, std=0.2),
            n(128, std=0.1), n(3, 3, 128, std=0.3), n(128, std=0.1),
            n(128, 32, std=0.1), n(32, std=0.1)]
    conv = n(16, 32, 3, 3, std=0.1), n(16, std=0.1)

    def wins(t):  # the rank's windows of (2 nW, ...) batch-major
        return t.reshape(2, nw, *t.shape[1:])[:, cp.band(nw)].reshape(
            -1, *t.shape[1:])

    checks = {
        "halo_exchange": (C.halo_exchange(rows, 4, cp, "up"),
                          img[:, (band.stop % 64) + torch.arange(4,
                              device="cuda")]),
        "cp_roll2d": (C.cp_roll2d(rows, -4, -4, cp),
                      torch.roll(img, (-4, -4), (1, 2))[:, band]),
        "cp_window_attention_qkv": (
            C.cp_window_attention_qkv(wins(q), wins(k), wins(v), bias,
                                      scale=0.2, cp=cp, n_win_h=8,
                                      sparse_w=w, mask=mask),
            wins(window_attention(q, k, v, bias, scale=0.2, sparse_w=w,
                                  mask=mask))),
        "ulysses_window_attention": (
            C.ulysses_window_attention(q[cp.band(2 * nw)],
                                       k[cp.band(2 * nw)],
                                       v[cp.band(2 * nw)], bias, cp=cp,
                                       scale=0.2, sparse_w=w),
            window_attention(q, k, v, bias, scale=0.2, sparse_w=w)[
                cp.band(2 * nw)]),
        "sharded_fft2": (C.sharded_fft2(rows, cp),
                         torch.fft.fftn(img.to(torch.complex64),
                                        dim=(1, 2))[:, band]),
        "conv2d_3x3": (cp_ops.conv2d(rows.permute(0, 3, 1, 2), *conv, 1, 1,
                                     1, cp),
                       F.conv2d(img.permute(0, 3, 1, 2), *conv,
                                padding=1)[:, :, band]),
        "ln_leff_rows": (fused_leff.ln_leff_rows(rows, *leff, cp=cp),
                         fused_leff.ln_leff(img, *leff)[:, band]),
    }
    out = []
    for name, (got, want) in checks.items():
        err = float((got - want).abs().max() / want.abs().max())
        out.append((name, err))
    return out


def _ctx_band_kernels(torch, dp, batch, size):
    """13(f): the Spectral blocks' kernels on this rank's band, at every
    (C, side, heads) that Spectral@``size`` runs on bands and at the train
    batch (so the split backward runs the slices, the sums of dA and the
    accumulation the main path's step runs), f32 and bf16:
    ``ln_mdta_rows`` (the split entries around the sums over the ranks,
    with autograd: ``LnMdtaRowsFn``) and ``ln_gdfn_rows`` (ln_gdfn,
    ln_gdfn_bwd on the band with a halo row), their outputs and dx on the
    band's rows and their weight gradients summed over the ranks, against
    the whole-map kernels and the plain versions on the whole map (every
    rank computes those alike): [(shape, slices of the split backward,
    what, dtype, err vs the whole-map kernels, err vs the plain
    versions, err of the whole-map kernels vs the plain versions)]."""
    import torch.distributed as dist

    from underwater_image_restoration_torch.models.spectral_transformer import (
        SpectralTransformer,
    )
    from underwater_image_restoration_torch.ops import fused_gdfn, fused_mdta

    cp = dp.cp
    model = SpectralTransformer(device="meta", cp=cp)
    lv, _ = model.levels_banded(size, size)
    shapes = sorted({(m.norm1.weight.numel(), size >> i, m.attn.num_heads)
                     for m, i in spectral_block_levels(model) if lv[i]})
    del model
    out = []

    def err(got, want, scale):
        return float((got.float() - want.float()).abs().max() / scale)

    for c, side, nh in shapes:
        band = cp.band(side)
        x32, ln, mdta, gdfn = block_inputs(c, side, side, nh, batch,
                                           71 + c + side)
        dy32 = torch.randn(x32.shape, generator=torch.Generator(
            ).manual_seed(72 + c + side)).cuda()
        for dt in (torch.float32, torch.bfloat16):
            x, dy = x32.to(dt), dy32.to(dt)
            for what, ws in (("ln_mdta", (*ln, *mdta)),
                             ("ln_gdfn", (*ln, *gdfn))):
                if what == "ln_mdta":
                    def band_fn(t, *w):
                        return fused_mdta.ln_mdta_rows(t, *w, nh, cp=cp)
                    plain = fused_mdta.ln_mdta_plain(x, *ws, nh)
                    whole, stats = fused_mdta.forward_with_stats(x, *ws, nh)
                    g_whole = fused_mdta.ln_mdta_bwd(x, dy, *ws, nh, stats)
                    g_plain = fused_mdta.ln_mdta_bwd_plain(x, dy, *ws, nh)
                    del stats
                else:
                    def band_fn(t, *w):
                        return fused_gdfn.ln_gdfn_rows(t, *w, cp=cp)
                    plain = fused_gdfn.ln_gdfn_plain(x, *ws)
                    whole = fused_gdfn.ln_gdfn(x, *ws)
                    g_whole = fused_gdfn.ln_gdfn_bwd(x, dy, *ws)
                    g_plain = fused_gdfn.ln_gdfn_bwd_plain(x, dy, *ws)
                ins = [t.detach().clone().requires_grad_() for t in
                       (x[:, :, band].contiguous(), *ws)]
                stage1 = sum(fused_mdta.ln_mdta_bwd_stage1.launches.values())
                with torch.enable_grad():
                    y = band_fn(*ins)
                    grads = list(torch.autograd.grad(
                        y, ins, dy[:, :, band].contiguous()))
                slices = (sum(fused_mdta.ln_mdta_bwd_stage1.launches.values())
                          - stage1) // fused_mdta.BWD_STAGE1_LAUNCHES
                for g in grads[1:]:
                    dist.all_reduce(g, group=cp.group)
                torch.cuda.synchronize()
                branch = float((plain - x).float().abs().max())
                tag = "float32" if dt == torch.float32 else "bfloat16"
                shape = (c, side, nh)
                out.append((shape, slices, f"{what} y", tag,
                            err(y, whole[:, :, band], branch),
                            err(y, plain[:, :, band], branch),
                            err(whole, plain, branch)))
                for i, (g, gw, gp) in enumerate(zip(grads, g_whole,
                                                    g_plain)):
                    sl = (slice(None), slice(None), band) if i == 0 else ...
                    scale = float(gp.float().abs().max()) or 1.0
                    out.append((shape, slices, f"{what} grad {i}", tag,
                                err(g, gw[sl], scale), err(g, gp[sl], scale),
                                err(gw, gp, scale)))
                del plain, whole, g_whole, g_plain, ins, y, grads
            del x, dy
            torch.cuda.empty_cache()
    return out


def _context_rank(rank, port, out_dir, batch, size, check_batch):
    """A rank of phase 13(a)-(c), (e): each model's context-parallel step
    (launches, gradients, rate in turns with one rank's step), the
    tensor-parallel AST step and its checkpoint, the primitives; results
    in ``out_dir/rank<r>.pt``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(CTX_WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import importlib

    import torch

    from underwater_image_restoration_torch.core import meshes
    from underwater_image_restoration_torch.data import synthetic_pair_batch
    from underwater_image_restoration_torch.losses import LossFunction
    from underwater_image_restoration_torch.models import ast as ast_model
    from underwater_image_restoration_torch.models import new_model
    from underwater_image_restoration_torch.ops import (
        _kernels,
        fused_gdfn,
        fused_leff,
        fused_mdta,
        ln_leff,
        window_attention,
    )
    from underwater_image_restoration_torch.ops.fused_leff import ln_leff_bwd
    from underwater_image_restoration_torch.parallel import (
        gather_replicated,
        shard_params_tp,
    )
    from underwater_image_restoration_torch.parallel.context import (
        collectives,
        sent_bytes,
    )
    from underwater_image_restoration_torch.train import (
        get_optimizer,
        make_train_step,
    )

    wa = importlib.import_module(
        "underwater_image_restoration_torch.ops.window_attention")

    t0 = time.perf_counter()

    def stage(msg):
        print(f"13 rank {rank}: {msg} ({time.perf_counter() - t0:.1f} s)",
              flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // CTX_WORLD))
    dp = meshes.init_data_parallel(
        CTX_WORLD, rank, mesh_context=CTX_WORLD,
        backend=meshes.default_backend(torch.device("cuda"), CTX_WORLD))
    cp, dev = dp.cp, dp.device
    sms = _kernels.sm_count(dev)
    res = {"device": str(dev), "backend": dp.backend}
    stage(f"joined on {dev} over {dp.backend}, context index {cp.index}")
    counters = {"ln_leff": ln_leff.launches,
                "ln_leff_bwd": ln_leff_bwd.launches,
                "window_attn": window_attention.launches,
                "window_attn_bwd": wa.window_attn_bwd.launches,
                "ln_gdfn": fused_gdfn.ln_gdfn.launches,
                "ln_gdfn_bwd": fused_gdfn.ln_gdfn_bwd.launches,
                "ln_mdta": fused_mdta.ln_mdta.launches,
                "ln_mdta_bwd": fused_mdta.ln_mdta_bwd.launches,
                "ln_mdta_stats": fused_mdta.ln_mdta_stats.launches,
                "ln_mdta_apply": fused_mdta.ln_mdta_apply.launches,
                "ln_mdta_bwd_stage1": fused_mdta.ln_mdta_bwd_stage1.launches,
                "ln_mdta_bwd_stage2": fused_mdta.ln_mdta_bwd_stage2.launches}
    # the plain versions of the path's kernels: none may run
    plain_calls = collections.Counter()
    patched = [(fused_leff, "ln_leff_plain"), (ast_model, "ln_leff_plain"),
               (new_model, "ln_leff_plain"), (wa, "window_attention_core"),
               (wa, "window_attention_bwd"), (fused_mdta, "_plain"),
               (fused_mdta, "ln_mdta_stats_plain"),
               (fused_mdta, "ln_mdta_apply_plain"),
               (fused_mdta, "ln_mdta_bwd_plain"),
               (fused_gdfn, "ln_gdfn_plain"),
               (fused_gdfn, "ln_gdfn_bwd_plain")]
    saved = [getattr(mod, name) for mod, name in patched]

    def counted(name, fn):
        def call(*a, **k):
            plain_calls[name] += 1
            return fn(*a, **k)
        return call

    res["prims"] = _ctx_primitives(torch, dp)
    stage("primitives done")
    res["band"] = _ctx_band_kernels(torch, dp, batch, size)
    stage("band kernels done")
    raw, ref = synthetic_pair_batch(batch, size, seed=0)
    lossfn = LossFunction("L1withColor")
    for name, arch, kw in CTX_CASES:
        model = _ctx_model(torch, arch, kw, torch.bfloat16, size, cp)
        _ctx_grads(torch, model, raw, ref, dp)  # warm-up
        torch.cuda.synchronize()
        for cnt in counters.values():
            cnt.clear()
        sent_bytes.clear()
        collectives.clear()
        for (mod, fn_name), fn in zip(patched, saved):
            setattr(mod, fn_name, counted(fn_name, fn))
        try:
            res[name, "bf16"] = _ctx_grads(torch, model, raw, ref, dp)
            torch.cuda.synchronize()
        finally:
            for (mod, fn_name), fn in zip(patched, saved):
                setattr(mod, fn_name, fn)
        res[name, "launches"] = {k: dict(v) for k, v in counters.items()
                                 if v}
        res[name, "sent"] = dict(sent_bytes)
        res[name, "collectives"] = dict(collectives)
        res[name, "want"] = cp_launches(model, batch, cp.index, cp.size, sms,
                                        size)
        res[name, "plain_calls"] = dict(plain_calls)
        plain_calls.clear()
        model.compute_dtype = torch.float32
        res[name, "f32"] = _ctx_grads(torch, model, raw[:check_batch],
                                      ref[:check_batch], dp)
        model.compute_dtype = torch.bfloat16
        # images/s and peak memory, in turns: one rank's step at the batch
        # (rank 0, while rank 1 waits), the two ranks' context-parallel
        # steps
        one = (_ctx_model(torch, arch, kw, torch.bfloat16, size)
               if dp.is_main else None)
        if one is not None:
            one.load_state_dict(model.state_dict())
        turns = []
        for kind in ("one", "two", "two", "one"):
            dp.barrier()
            m = model if kind == "two" else one
            if m is not None:
                st = make_train_step(
                    m, lossfn, get_optimizer("adam", m.parameters(), LR),
                    parallel=dp if kind == "two" else None,
                    generator=torch.Generator(device="cuda").manual_seed(2))
                rate, mem = _rate_turn(torch, st, raw, ref, CTX_STEPS[name])
                turns.append((kind, rate * batch, mem))
            st = None
            torch.cuda.empty_cache()
            dp.barrier()
        res[name, "turns"] = turns
        stage(f"{name} done")
        del one, model
        torch.cuda.empty_cache()

    # (c) --shard-params context: the Spectral model's gradients; the
    # AST's, then an Adam step, its checkpoint, and an f32 eval-mode
    # forward gathered
    tp = shard_params_tp(_ctx_model(torch, "SpectralTransformer", {},
                                    torch.bfloat16, size, cp), dp)
    res["tp_spectral_bf16"] = _ctx_grads(torch, tp, raw, ref, dp)
    del tp
    torch.cuda.empty_cache()
    tp = shard_params_tp(_ctx_model(torch, "AST", {}, torch.bfloat16, size,
                                    cp), dp)
    res["tp_bf16"] = _ctx_grads(torch, tp, raw, ref, dp)
    opt = get_optimizer("adam", tp.parameters(), LR)
    make_train_step(tp, lossfn, opt, parallel=dp,
                    generator=torch.Generator(device="cuda").manual_seed(3))(
        raw, ref)
    params, opt_state = meshes.full_state(tp, opt)
    tp.eval()
    tp.compute_dtype = torch.float32
    with torch.no_grad():
        x = (torch.as_tensor(raw[:check_batch]).to(dev).float() / 255.0 * 2
             - 1).permute(0, 3, 1, 2)
        res["tp_out"] = gather_replicated(
            tp(x[:, :, cp.band(size)].contiguous()), cp, 2).float().cpu()
    if dp.is_main:
        torch.save({"params": params, "opt_state": opt_state},
                   os.path.join(out_dir, "tp_ckpt.pt"))
    stage("tensor parallel done")
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    del tp, opt
    meshes.close_data_parallel(dp)


def _ctx_cli(torch, card, root, size, batch, archs):
    """13(d): the CLI under ``torchrun --nproc-per-node 2 -a <arch>
    --mesh-context 2`` for one epoch over synthetic pairs (f32, TF32 off),
    the runs of ``archs`` at once (four processes sharing the card: only
    their numbers are checked), then for each a one-process
    ``ModelTrainer.evaluate`` of its best checkpoint against the
    validation it logged."""
    from underwater_image_restoration_torch.core.config import Config
    from underwater_image_restoration_torch.train import trainer

    data = os.path.join(root, "data")
    n_train, n_test = CTX_CLI_PAIRS
    dirs = {}
    for split, n, seed in (("train", n_train, 3), ("test", n_test, 4)):
        dirs[split] = _write_pairs(os.path.join(data, split), n, size, seed)
    env = dict(os.environ, NVIDIA_TF32_OVERRIDE="0", OMP_NUM_THREADS="4",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    runs = {}
    t = time.perf_counter()
    for arch in archs:
        ckpt = os.path.join(root, f"checkpoints-{arch}")
        argv = ["-m", "torch.distributed.run", "--nproc-per-node",
                str(CTX_WORLD), "--master-port", str(_free_port()),
                "-m", "underwater_image_restoration_torch.cli", "-a", arch,
                "--mesh-context", str(CTX_WORLD), "--image-size", str(size),
                "--train-batch-size", str(batch), "--test-batch-size", "8",
                "--max-epoch", "1", "--use-wandb", "--compute-dtype",
                "float32", "--lossf", "L1withColor", "--train-raw",
                dirs["train"][0], "--train-ref", dirs["train"][1],
                "--test-raw", dirs["test"][0], "--test-ref",
                dirs["test"][1], "--checkpoint-dir", ckpt]
        # a working directory each: the CLI writes logs/ and Images/ there
        cwd = os.path.join(root, f"cli-{arch}")
        os.makedirs(cwd)
        log = open(os.path.join(cwd, "out.log"), "w")
        runs[arch] = (subprocess.Popen(
            [sys.executable] + argv, cwd=cwd, env=env, stdout=log,
            stderr=subprocess.STDOUT), log, ckpt)
    for arch, (proc, log, ckpt) in runs.items():
        try:
            rc = proc.wait(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed at 900 s"
        log.close()
        took = time.perf_counter() - t
        if rc != 0:
            with open(log.name) as f:
                fail(f"13(d) the {arch} CLI under torchrun failed ({rc}):\n"
                     f"{f.read()[-3000:]}")
        run_dir = os.path.join(ckpt, os.listdir(ckpt)[0])
        logged = [r for r in _jsonl(run_dir) if "test/PSNR" in r][-1]
        cfg = Config(arch=arch, image_size=size, test_batch_size=8,
                     compute_dtype="float32")
        psnr, ssim = trainer.ModelTrainer(
            dirs["train"][0], dirs["train"][1], dirs["test"][0],
            dirs["test"][1]).evaluate(cfg, os.path.join(run_dir, "best"))
        d_psnr = abs(psnr - logged["test/PSNR"]) / abs(psnr)
        d_ssim = abs(ssim - logged["test/SSIM"]) / abs(ssim)
        print(f"13(d) torchrun --nproc-per-node {CTX_WORLD} cli -a {arch} "
              f"--mesh-context {CTX_WORLD}, one epoch of {n_train} pairs at "
              f"batch {batch}, done {took:.1f} s after the runs' start: "
              f"logged validation PSNR {logged['test/PSNR']:.6f} SSIM "
              f"{logged['test/SSIM']:.6f}; one-process evaluate of its best/"
              f" {psnr:.6f} {ssim:.6f} (relative {d_psnr:.3e}, "
              f"{d_ssim:.3e}; tol {CTX_CLI_TOL:.0e}), on {card}",
              flush=True)
        if not (d_psnr <= CTX_CLI_TOL and d_ssim <= CTX_CLI_TOL):
            fail(f"13(d) the {arch} CLI's logged validation disagrees with "
                 "a one-process evaluate of its checkpoint")


def context_phase(card, batch, size, check_batch):
    """Phase 13: context and tensor parallelism of AST@256, NewModel@256
    (Fourier and Wavelet) and SpectralTransformer@256 over two processes
    sharing the card over gloo (correctness and the host's round trips,
    not scaling): (a)-(b) each rank's launches of its model's kernels in
    one bf16 train step at ``batch``, from zero, as the planners say for
    its band (``cp_launches``), and no plain version called; loss and
    gradients vs the one-rank step (bf16 at ``batch``, f32 at
    ``check_batch``) within phase 5's (Spectral), 7's (AST) and 9's (New*)
    limits; images/s, peak memory and bytes sent a rank beside one rank's,
    in turns; (c) ``--shard-params context``: the Spectral and AST
    gradients vs (a)'s, the AST's checkpoint loaded strict on one device
    giving the sharded model's f32 forward; (d) the CLI under
    ``torchrun``; (e) the primitives on CUDA tensors vs the one-process
    ops; (f) the Spectral blocks' kernels on a halo'd band at every level
    Spectral@``size`` runs on bands, at ``batch``.  Returns no kernel rows
    (every kernel's row is its own phase's)."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from underwater_image_restoration_torch.data import synthetic_pair_batch

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="phase13-", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    torch.backends.cudnn.deterministic = True
    raw, ref = synthetic_pair_batch(batch, size, seed=0)
    refs = {}
    for name, arch, kw in CTX_CASES:
        model = _ctx_model(torch, arch, kw, torch.bfloat16, size)
        refs[name, "bf16"] = _ctx_grads(torch, model, raw, ref)
        model.compute_dtype = torch.float32
        refs[name, "f32"] = _ctx_grads(torch, model, raw[:check_batch],
                                       ref[:check_batch])
        del model
        torch.cuda.empty_cache()
    print(f"13 one-rank references took {time.perf_counter() - t_phase:.1f}"
          " s", flush=True)
    t = time.perf_counter()
    os.environ["PYTHONFAULTHANDLER"] = "1"
    mp.spawn(_context_rank,
             args=(_free_port(), root, batch, size, check_batch),
             nprocs=CTX_WORLD)
    t_ranks = time.perf_counter() - t
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"),
                        weights_only=False) for r in range(CTX_WORLD)]
    print(f"13 ranks: {CTX_WORLD} processes on "
          f"{[r['device'] for r in ranks]} over {ranks[0]['backend']} "
          f"({t_ranks:.1f} s with their start)", flush=True)

    # (e) the primitives
    for r, res in enumerate(ranks):
        for name, err in res["prims"]:
            print(f"13(e) rank {r} {name} on CUDA f32, band vs the whole "
                  f"map: max abs/max|ref| {err:.3e} (tol {CTX_PRIM_TOL:.0e})",
                  flush=True)
            if not err <= CTX_PRIM_TOL:
                fail(f"13(e) {name} on rank {r} disagrees with the "
                     "one-process op")

    # (f) the Spectral blocks' kernels on a band
    bad = []
    for r, res in enumerate(ranks):
        rows = collections.defaultdict(list)
        for shape, slices, what, tag, e_whole, e_plain, e_ref in res["band"]:
            op, part = what.split(" ", 1)
            tol = CTX_BAND_TOL[tag]
            ptol = (GRAD_TOL if part != "y" else KERNEL_TOL)[tag]
            if not (e_whole <= tol and e_plain <= ptol):
                bad.append(f"{what} {tag} of {shape} on rank {r}")
            rows[shape, slices, op, tag, part == "y"].append(
                (e_whole, e_plain, e_ref))
        for (shape, slices, op, tag, out), errs in rows.items():
            split = (f", split backward in {slices} slices"
                     if op == "ln_mdta" else "")
            print(f"13(f) rank {r} {op} {tag} on its halo'd band of (C, "
                  f"side, heads) {shape} at batch {batch}{split}, "
                  f"{'y' if out else f'the {len(errs)} gradients (max)'}: "
                  f"vs the whole-map kernels "
                  f"{max(e[0] for e in errs):.3e} (tol "
                  f"{CTX_BAND_TOL[tag]:.0e}), vs the plain version "
                  f"{max(e[1] for e in errs):.3e} (tol "
                  f"{(KERNEL_TOL if out else GRAD_TOL)[tag]:.0e}; the "
                  f"whole-map kernels' own {max(e[2] for e in errs):.3e})",
                  flush=True)
        if not {shape for shape, *_ in res["band"]} >= {
                (16, size, 1), (32, size // 2, 2), (64, size // 4, 4),
                (128, size // 8, 8), (32, size, 1)}:
            fail(f"13(f) rank {r} missed a banded level of Spectral@{size}")
    if bad:
        fail(f"13(f) the band disagrees: {bad}")

    # (a)-(b) launches, gradients, rates
    for name, arch, kw in CTX_CASES:
        for r, res in enumerate(ranks):
            got, want = res[name, "launches"], res[name, "want"]
            totals = {k: sum(v.values()) for k, v in got.items()}
            sent = {k: f"{v / 2 ** 20:.1f} MiB"
                    for k, v in res[name, "sent"].items()}
            print(f"13(a) {name}@{size} rank {r}, one bf16 step at batch "
                  f"{batch}: launches {totals}; plain calls "
                  f"{res[name, 'plain_calls']}; sent to the other rank "
                  f"{sent} in {res[name, 'collectives']} collectives (the "
                  "gradients' all-reduce apart)", flush=True)
            for kname in sorted(got):
                if kname.startswith("window_attn"):
                    continue
                for key, nl in sorted(got.get(kname, {}).items()):
                    print(f"  {kname} {key}: {nl} (planners "
                          f"{want[kname].get(key, 0)})", flush=True)
            if got != want or res[name, "plain_calls"]:
                fail(f"13(a) {name} rank {r}: expected launches {want} and "
                     f"no plain call, got {got}, "
                     f"{res[name, 'plain_calls']}")
        for tag, nb in (("bf16", batch), ("f32", check_batch)):
            loss, g = ranks[0][name, tag]
            rloss, rg = refs[name, tag]
            rel, mx = grad_dist(g, rg)
            dl = abs(loss - rloss) / abs(rloss)
            tol = _ctx_tol(name)["bfloat16" if tag == "bf16" else "float32"]
            print(f"13(a) {name} {tag} batch {nb}, two context ranks vs one "
                  f"rank: loss {loss:.6f} vs {rloss:.6f} (relative {dl:.3e},"
                  f" tol {TRAIN_LOSS_TOL:.0e}); ||g - g_ref||/||g_ref|| "
                  f"{rel:.3e} (tol {tol:.0e}), max abs/max|g_ref| {mx:.3e}",
                  flush=True)
            if not (rel <= tol and dl <= TRAIN_LOSS_TOL):
                fail(f"13(a) the context-parallel {name} {tag} step "
                     "disagrees with one rank's")
        by = collections.defaultdict(list)
        for r, res in enumerate(ranks):
            for kind, rate, mem in res[name, "turns"]:
                by[kind].append((r, rate, mem))
        one = [rate for _, rate, _ in by["one"]]
        two = [rate for r, rate, _ in by["two"] if r == 0]
        print(f"13(a) train step {name} {size}x{size} bf16 batch {batch}: "
              f"two context ranks {sum(two) / 2:.2f} images/s {two} (peak "
              f"memory a rank {[round(m, 2) for _, _, m in by['two']]} GiB),"
              f" one rank {sum(one) / 2:.2f} images/s {one} (peak "
              f"{[round(m, 2) for _, _, m in by['one']]} GiB), in turns of "
              f"{CTX_STEPS[name]} steps, over {ranks[0]['backend']} on {card}",
              flush=True)

    # (c) --shard-params context
    rel, mx = grad_dist(ranks[0]["tp_spectral_bf16"][1],
                        ranks[0]["Spectral", "bf16"][1])
    dl = abs(ranks[0]["tp_spectral_bf16"][0] - ranks[0]["Spectral", "bf16"][0])
    print(f"13(c) --shard-params context vs the context-parallel Spectral "
          f"bf16 step: loss difference {dl:.3e}, ||g - g_cp||/||g_cp|| "
          f"{rel:.3e}, max abs/max|g_cp| {mx:.3e} (tol "
          f"{TRAIN_LOSS_TOL:.0e})", flush=True)
    if not (rel <= TRAIN_LOSS_TOL and dl <= TRAIN_LOSS_TOL):
        fail("13(c) the tensor-parallel Spectral gradients disagree with "
             "the context-parallel step's")
    rel, mx = grad_dist(ranks[0]["tp_bf16"][1], ranks[0]["AST", "bf16"][1])
    dl = abs(ranks[0]["tp_bf16"][0] - ranks[0]["AST", "bf16"][0])
    print(f"13(c) --shard-params context vs the context-parallel AST bf16 "
          f"step: loss difference {dl:.3e}, ||g - g_cp||/||g_cp|| {rel:.3e}, "
          f"max abs/max|g_cp| {mx:.3e} (tol {TRAIN_LOSS_TOL:.0e})",
          flush=True)
    if not (rel <= TRAIN_LOSS_TOL and dl <= TRAIN_LOSS_TOL):
        fail("13(c) the tensor-parallel gradients disagree with the "
             "context-parallel step's")
    ckpt = torch.load(os.path.join(root, "tp_ckpt.pt"), weights_only=False)
    single = _ctx_model(torch, "AST", {}, torch.float32, size)
    single.load_state_dict(ckpt["params"], strict=True)
    single.eval()
    with torch.no_grad():
        x = (torch.as_tensor(raw[:check_batch]).cuda().float() / 255.0 * 2
             - 1).permute(0, 3, 1, 2).contiguous()
        y1 = single(x).float().cpu()
    want = ranks[0]["tp_out"]
    err = float((y1 - want).abs().max() / y1.abs().max())
    print(f"13(c) the tensor-parallel checkpoint ({len(ckpt['params'])} "
          f"tensors) loads strict on one device; its f32 forward vs the "
          f"sharded model's gathered: max abs/max|ref| {err:.3e} (tol "
          f"{AST_MODEL_TOL['float32']:.0e})", flush=True)
    if err > AST_MODEL_TOL["float32"]:
        fail("13(c) the tensor-parallel checkpoint does not give the "
             "sharded model's forward on one device")
    del single, ckpt
    torch.cuda.empty_cache()

    # (d) the CLI
    _ctx_cli(torch, card, root, size, batch, ("AST", "SpectralTransformer"))
    torch.backends.cudnn.deterministic = False
    shutil.rmtree(root)
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return []


# the rematerialization phase (14): remat off and the two policies
REMAT_MODES = {"off": (False, None), "full": (True, "full"),
               "dots": (True, "dots")}
# SpectralTransformer at the reference's train resolution (the CLI's
# default --image-size), at its train_batch_size and at 8
REMAT_SIZE, REMAT_BATCHES = 1024, (2, 8)
# the New* big models' cell: NewBig*@512 at batch 2
REMAT_BIG_SIZE, REMAT_BIG_BATCH = 512, 2
# timed steps a turn (in turns: off, full, dots, dots, full, off)
REMAT_STEPS = 2
# the share of the card's memory an expected peak may take before the run
# is left out
REMAT_FIT = 0.85
# (d): the CLI's train and test pairs at 1024x1024
REMAT_CLI_PAIRS = (8, 2)


def ast_launches(model, batch, sms=None, remat=False):
    """What the planners say one forward (with ``sms``, one train step) of
    the AST at ``batch`` in bf16 launches: ln_leff (and ln_leff_bwd) by
    (C, H, W), and the window attentions' calls as (all, masked), from the
    model's blocks; with ``remat``, the forward of every block with
    attention runs again in the backward (the encoders' LN+LeFF blocks are
    not checkpointed on the kernels)."""
    from underwater_image_restoration_torch.models.ast import BasicASTLayer
    from underwater_image_restoration_torch.ops import fused_leff

    s = model.img_size
    out = {"ln_leff": collections.Counter(),
           "ln_leff_bwd": collections.Counter()}
    calls = [0, 0]
    for name, layer in model.named_children():
        if not isinstance(layer, BasicASTLayer):
            continue
        i = int(name[-1]) if name[-1].isdigit() else 0
        side = (s >> i if name.startswith("encoder") else s >> 4
                if name == "conv" else s >> (3 - i))
        for blk in layer.blocks:
            c = blk.norm2.weight.numel()
            runs = 2 if remat and blk.att else 1
            out["ln_leff"][(c, side, side)] += runs * fused_leff.fwd_plan(
                batch, side, side, c, 4 * c, 2).launches
            if sms:
                out["ln_leff_bwd"][(c, side, side)] += fused_leff.bwd_plan(
                    batch, side, side, c, 4 * c, 2, sms).launches
            if blk.att:
                calls[0] += runs
                calls[1] += runs * (blk.shift_size > 0)
    return ({k: dict(v) for k, v in out.items() if v}, tuple(calls))


class _PlainCalls:
    """Counts calls of the kernels' plain versions, forward and backward,
    where the models and the wrappers look them up, while active."""

    NAMES = (("ops.fused_leff", "ln_leff_plain"),
             ("ops.fused_leff", "ln_leff_bwd_plain"),
             ("ops.fused_mdta", "ln_mdta_plain"),
             ("ops.fused_mdta", "ln_mdta_bwd_plain"),
             ("ops.fused_gdfn", "ln_gdfn_plain"),
             ("ops.fused_gdfn", "ln_gdfn_bwd_plain"),
             ("ops.window_attention", "window_attention_plain"),
             ("ops.window_attention", "window_attention_bwd"),
             ("models.ast", "ln_leff_plain"),
             ("models.new_model", "ln_leff_plain"),
             ("models.blocks", "window_attention_plain"))

    def __init__(self):
        self.calls = collections.Counter()

    def __enter__(self):
        import importlib

        self.saved = []
        for mod_name, name in self.NAMES:
            mod = importlib.import_module(
                f"underwater_image_restoration_torch.{mod_name}")
            if not hasattr(mod, name):
                continue
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _key=f"{mod_name}.{name}", **k):
                self.calls[_key] += 1
                return _fn(*a, **k)

            self.saved.append((mod, name, fn))
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def remat_phase(card, batch, size):
    """14. per-block rematerialization (``init_model(remat=True,
    remat_policy=...)``) on the card, bf16, L1withColor, Adam lr 3e-4, clip
    1.0, cuDNN's deterministic algorithms: (a) the full-width
    SpectralTransformer at 1024x1024, batch 2 and 8, remat off, full and
    dots: the expected peak from a batch-1 step before each (a run it says
    does not fit is left out and named), launches from zero (the forwards
    as phase 5 counts them: no Spectral block recomputes on the kernels,
    only the three UpS), no plain version, batch 2 gradients of full and
    dots bit-equal to remat off, peak memory and images/s in turns; (b)
    AST@256 and NewModel-Wavelet@256 at batch 16, DropPath at the models'
    rates from one seeded generator a mode: launches from zero as the
    planners say with each checkpointed block's ln_leff and window_attn
    once more, no plain version, gradients after two steps bit-equal to
    remat off and the generators' states equal, peak memory lower under
    full, images/s in turns; (c) NewBigModel-Wavelet@512 and
    NewBigFRFNModel-Fourier@512 at batch 2, remat off and full: expected
    and measured peaks, gradients finite and bit-equal, images/s; (d) one
    CLI epoch of SpectralTransformer at 1024x1024 with ``--remat
    --remat-policy dots`` over synthetic pairs logs the losses of the same
    run without ``--remat``.  Returns no kernel rows (every kernel's row
    is its own phase's)."""
    import torch

    from underwater_image_restoration_torch.cli.main import main as cli
    from underwater_image_restoration_torch.data import synthetic_pair_batch
    from underwater_image_restoration_torch.losses import LossFunction
    from underwater_image_restoration_torch.models import init_model
    from underwater_image_restoration_torch.ops import (
        _kernels,
        ln_gdfn,
        ln_leff,
        ln_mdta,
        window_attention,
    )
    from underwater_image_restoration_torch.ops.fused_gdfn import ln_gdfn_bwd
    from underwater_image_restoration_torch.ops.fused_leff import ln_leff_bwd
    from underwater_image_restoration_torch.ops.fused_mdta import ln_mdta_bwd
    from underwater_image_restoration_torch.ops.window_attention import (
        window_attn_bwd,
    )
    from underwater_image_restoration_torch.train import (
        get_optimizer,
        make_train_step,
    )

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    torch.backends.cudnn.deterministic = True
    lossfn = LossFunction("L1withColor")
    sms = _kernels.sm_count(torch.device("cuda"))
    total = torch.cuda.mem_get_info()[1]
    counters = {"ln_gdfn": ln_gdfn.launches, "ln_mdta": ln_mdta.launches,
                "ln_gdfn_bwd": ln_gdfn_bwd.launches,
                "ln_mdta_bwd": ln_mdta_bwd.launches,
                "ln_leff": ln_leff.launches,
                "ln_leff_bwd": ln_leff_bwd.launches,
                "window_attn": window_attention.launches,
                "window_attn_bwd": window_attn_bwd.launches}
    gib = 2 ** 30

    def counted_step(step, raw, ref):
        """One step from zero counts: (its launches, its plain calls, its
        output, its peak GiB)."""
        for cnt in counters.values():
            cnt.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _PlainCalls() as plain:
            out = step(raw, ref)
            torch.cuda.synchronize()
        got = {k: dict(v) for k, v in counters.items() if v}
        return got, dict(plain.calls), out, \
            torch.cuda.max_memory_allocated() / gib

    def batch1(step, raw1, ref1):
        """(bytes held between steps: parameters, Adam state; the peak of
        a measured batch-1 step), after a batch-1 warm-up step, which makes
        the Adam state."""
        step(raw1, ref1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(raw1, ref1)
        torch.cuda.synchronize()
        return base, torch.cuda.max_memory_allocated()

    def expected(measured, batch):
        """The peak (GiB) a step at ``batch`` is expected to reach: what
        is held between steps plus ``batch`` times what the batch-1 step
        adds to it."""
        base, peak1 = measured
        return (base + batch * (peak1 - base)) / gib

    def turns(steps, raw, ref, modes):
        """images/s of REMAT_STEPS steps a turn, modes in turns (each
        mode's list of two), and each mode's peak GiB over its turns."""
        rates = {m: [] for m in modes}
        peak = {m: 0.0 for m in modes}
        for m in list(modes) + list(reversed(modes)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            for _ in range(REMAT_STEPS):
                steps[m](raw, ref)
            torch.cuda.synchronize()
            rates[m].append(REMAT_STEPS * len(raw) / (time.perf_counter()
                                                      - t))
            peak[m] = max(peak[m], torch.cuda.max_memory_allocated() / gib)
        return rates, peak

    def rate_line(rates, peak):
        return ", ".join(
            f"{m} {sum(r) / len(r):.2f} images/s {[round(v, 2) for v in r]} "
            f"peak {peak[m]:.2f} GiB" for m, r in rates.items())

    def grads(model):
        return {n: p.grad.detach().clone() for n, p in
                model.named_parameters() if p.grad is not None}

    def compare(what, got, want):
        """Remat's gradients against remat off: bit-equal, or (named)
        within phase 5(c)'s bf16 limit."""
        differ = [n for n in want if not torch.equal(got[n], want[n])]
        if sorted(got) != sorted(want):
            fail(f"{what}: gradients of other parameters")
        if not differ:
            return "bit-equal"
        rel = grad_dist(got, want)[0]
        print(f"{what}: {len(differ)} gradients not bit-equal (first "
              f"{differ[:3]}), ||g - g_off||/||g_off|| {rel:.3e}",
              flush=True)
        if not rel <= TRAIN_GRAD_TOL["bfloat16"]:
            fail(f"{what}: gradients beyond phase 5(c)'s bf16 limit")
        return f"within {rel:.3e}"

    def fits(what, expected):
        ok = expected <= REMAT_FIT * total / gib
        print(f"{what}: expected peak {expected:.2f} GiB of the card's "
              f"{total / gib:.2f} GiB: "
              f"{'runs' if ok else 'left out: it does not fit'}",
              flush=True)
        return ok

    # ---- (a) SpectralTransformer@1024
    blocks = {(c, h * REMAT_SIZE // size, w * REMAT_SIZE // size): n
              for (c, h, w), n in BLOCKS.items()}
    models = {m: init_model("SpectralTransformer", seed=0,
                            compute_dtype=bf16, remat=r, remat_policy=p)
              for m, (r, p) in REMAT_MODES.items()}
    steps = {m: make_train_step(model, lossfn, get_optimizer(
        "adam", model.parameters(), LR)) for m, model in models.items()}
    raw1, ref1 = synthetic_pair_batch(1, REMAT_SIZE, seed=140)
    est = {m: batch1(steps[m], raw1, ref1) for m in steps}
    print(f"(a) SpectralTransformer {REMAT_SIZE}x{REMAT_SIZE} bf16: peak of "
          "a batch-1 step " + ", ".join(f"{m} {v[1] / gib:.2f} GiB"
                                        for m, v in est.items()), flush=True)
    for sb in REMAT_BATCHES:
        raw, ref = synthetic_pair_batch(sb, REMAT_SIZE, seed=141 + sb)
        run = [m for m in REMAT_MODES if fits(
            f"(a) batch {sb} remat {m}", expected(est[m], sb))]
        want = spectral_launches(sb, train=True, blocks=blocks)
        for m in run:
            got, plain, out, peak = counted_step(steps[m], raw, ref)
            loss = float(out["loss"])
            print(f"(a) batch {sb} remat {m}: launches "
                  f"{ {k: sum(v.values()) for k, v in got.items()} } (the "
                  f"planners: { {k: sum(v.values()) for k, v in want.items()} }"
                  f"), plain calls {sum(plain.values())}, loss {loss:.6f}, "
                  f"peak {peak:.2f} GiB", flush=True)
            if got != want:
                fail(f"(a) remat {m} batch {sb}: launches {got}, the "
                     f"planners say {want}")
            if plain:
                fail(f"(a) remat {m}: plain versions called: {plain}")
            if not math.isfinite(loss):
                fail(f"(a) remat {m}: non-finite loss")
        if sb == REMAT_BATCHES[0]:
            x = normalize_batch(torch, raw)
            y = normalize_batch(torch, ref)
            g = {m: grads_of(models[m], lossfn, x, y, True) for m in run}
            for m in run[1:]:
                print(f"(a) batch {sb} gradients remat {m} vs off: "
                      f"{compare(f'(a) remat {m}', g[m], g['off'])}",
                      flush=True)
            del g, x, y
        rates, peak = turns(steps, raw, ref, run)
        print(f"(a) SpectralTransformer {REMAT_SIZE}x{REMAT_SIZE} bf16 "
              f"batch {sb} train step: {rate_line(rates, peak)}; on "
              f"{card}", flush=True)
        del raw, ref
    del models, steps
    torch.cuda.empty_cache()
    print(f"phase 14(a) took {time.perf_counter() - t_phase:.1f} s",
          flush=True)

    # ---- (b) AST@256 and NewModel-Wavelet@256, DropPath on
    t_b = time.perf_counter()
    raw, ref = synthetic_pair_batch(batch, size, seed=0)
    for label, arch, kw in (("AST", "AST", {}),
                            ("NewModel-Wavelet", "NewModel",
                             {"use_dwt": "Wavelet"})):
        models = {m: init_model(arch, seed=0, img_size=size,
                                compute_dtype=bf16, remat=r,
                                remat_policy=p, **kw)
                  for m, (r, p) in REMAT_MODES.items()}
        gens = {m: torch.Generator(device="cuda").manual_seed(0)
                for m in models}
        steps = {m: make_train_step(model, lossfn, get_optimizer(
            "adam", model.parameters(), LR), generator=gens[m])
            for m, model in models.items()}
        g, states, losses = {}, {}, {}
        for m, (remat, _) in REMAT_MODES.items():
            got, plain, out, _ = counted_step(steps[m], raw, ref)
            out2 = steps[m](raw, ref)
            torch.cuda.synchronize()
            losses[m] = (float(out["loss"]), float(out2["loss"]))
            g[m], states[m] = grads(models[m]), gens[m].get_state()
            if arch == "AST":
                want, (calls, masked) = ast_launches(models[m], batch,
                                                     sms, remat)
                bwd_each = window_attn_bwd_launches(batch)
                wa_fwd = got.get("window_attn", {})
                have = (sum(wa_fwd.values()),
                        sum(v for k, v in wa_fwd.items() if k[4]),
                        sum(got.get("window_attn_bwd", {}).values()))
                ok = (have == (calls, masked, 10 * bwd_each)
                      and all(got.get(k) == v for k, v in want.items()))
                desc = (f"window_attn {have[:2]} (all, masked; the planners:"
                        f" {(calls, masked)}), window_attn_bwd {have[2]} "
                        f"({10 * bwd_each})")
            else:
                want = new_launches(models[m], batch, sms, remat)
                ok = {k: got.get(k) for k in want} == want
                desc = ""
            print(f"(b) {label} batch {batch} remat {m}: launches "
                  f"{ {k: sum(v.values()) for k, v in got.items()} } "
                  f"{desc}, plain calls {sum(plain.values())}, losses "
                  f"{losses[m]}", flush=True)
            if not ok:
                fail(f"(b) {label} remat {m}: launches {got}, the planners "
                     f"say {want}")
            if plain:
                fail(f"(b) {label} remat {m}: plain versions called: "
                     f"{plain}")
        for m in ("full", "dots"):
            verdict = compare(f"(b) {label} remat {m}", g[m], g["off"])
            same = torch.equal(states[m], states["off"])
            print(f"(b) {label} remat {m} vs off after two steps: losses "
                  f"{'equal' if losses[m] == losses['off'] else 'differ'}, "
                  f"gradients {verdict}, generator state "
                  f"{'equal' if same else 'differs'}", flush=True)
            if not same:
                fail(f"(b) {label} remat {m}: the DropPath generator ends "
                     "elsewhere than remat off's")
        del g
        rates, peak = turns(steps, raw, ref, list(REMAT_MODES))
        print(f"(b) {label} {size}x{size} bf16 batch {batch} train "
              f"step: {rate_line(rates, peak)}; on {card}", flush=True)
        if not peak["full"] < peak["off"]:
            fail(f"(b) {label}: peak memory not lower under remat full")
        del models, steps, gens
        torch.cuda.empty_cache()
    print(f"phase 14(b) took {time.perf_counter() - t_b:.1f} s", flush=True)

    # ---- (c) NewBig*@512, batch 2: their first train steps on the card
    t_c = time.perf_counter()
    raw1, ref1 = synthetic_pair_batch(1, REMAT_BIG_SIZE, seed=150)
    raw, ref = synthetic_pair_batch(REMAT_BIG_BATCH, REMAT_BIG_SIZE,
                                    seed=151)
    for label, arch, use_dwt in (("NewBigModel-Wavelet", "NewBigModel",
                                  "Wavelet"),
                                 ("NewBigFRFNModel-Fourier",
                                  "NewBigFRFNModel", "Fourier")):
        modes = ("off", "full")
        models = {m: init_model(arch, seed=0, img_size=REMAT_BIG_SIZE,
                                compute_dtype=bf16, use_dwt=use_dwt,
                                remat=REMAT_MODES[m][0])
                  for m in modes}
        steps = {m: make_train_step(models[m], lossfn, get_optimizer(
            "adam", models[m].parameters(), LR),
            generator=torch.Generator(device="cuda").manual_seed(0))
            for m in modes}
        g, peaks = {}, {}
        for m in modes:
            want = expected(batch1(steps[m], raw1, ref1), REMAT_BIG_BATCH)
            if not fits(f"(c) {label} batch {REMAT_BIG_BATCH} remat {m}",
                        want):
                fail(f"(c) {label} remat {m} is expected not to fit")
            _, plain, out, peaks[m] = counted_step(steps[m], raw, ref)
            g[m] = grads(models[m])
            bad = [n for n, t in g[m].items()
                   if not bool(torch.isfinite(t).all())]
            print(f"(c) {label} {REMAT_BIG_SIZE}x{REMAT_BIG_SIZE} batch "
                  f"{REMAT_BIG_BATCH} remat {m}: loss "
                  f"{float(out['loss']):.6f}, expected peak {want:.2f} "
                  f"GiB, measured {peaks[m]:.2f} GiB, plain calls "
                  f"{sum(plain.values())}, non-finite gradients {len(bad)}",
                  flush=True)
            if bad or plain:
                fail(f"(c) {label} remat {m}: non-finite gradients {bad[:3]}"
                     f" or plain calls {plain}")
        print(f"(c) {label} gradients remat full vs off: "
              f"{compare(f'(c) {label}', g['full'], g['off'])}", flush=True)
        del g
        rates, peak = turns(steps, raw, ref, list(modes))
        print(f"(c) {label} {REMAT_BIG_SIZE}x{REMAT_BIG_SIZE} bf16 batch "
              f"{REMAT_BIG_BATCH} train step: {rate_line(rates, peak)}; on "
              f"{card}", flush=True)
        del models, steps
        torch.cuda.empty_cache()
    print(f"phase 14(c) took {time.perf_counter() - t_c:.1f} s", flush=True)

    # ---- (d) one CLI epoch at the defaults, with --remat --remat-policy
    # dots and without
    t_d = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "phase14")
    shutil.rmtree(root, ignore_errors=True)
    n_train, n_test = REMAT_CLI_PAIRS
    train = _write_pairs(os.path.join(root, "data", "train"), n_train,
                         REMAT_SIZE, seed=160)
    test = _write_pairs(os.path.join(root, "data", "test"), n_test,
                        REMAT_SIZE, seed=161)
    common = ["-a", "SpectralTransformer", "--image-size", str(REMAT_SIZE),
              "--train-batch-size", str(REMAT_BATCHES[0]),
              "--test-batch-size", "1", "--lossf", "L1withColor",
              "--max-epoch", "1", "--use-wandb", "--watch-freq", "0",
              "-j", "4", "--train-raw", train[0], "--train-ref", train[1],
              "--test-raw", test[0], "--test-ref", test[1]]
    logged = {}
    cwd = os.getcwd()
    try:
        os.chdir(root)  # the CLI's logs/ land here
        for tag, extra in (("plain", []),
                           ("remat", ["--remat", "--remat-policy", "dots"])):
            t = time.perf_counter()
            cli(common + extra + ["--checkpoint-dir",
                                  os.path.join(root, tag)])
            torch.cuda.synchronize()
            run = os.path.join(root, tag, os.listdir(os.path.join(root,
                                                                  tag))[0])
            logged[tag] = [(k, r[k]) for r in _jsonl(run) for k in (
                "train/loss", "test/loss", "test/PSNR", "test/SSIM")
                if k in r]
            print(f"(d) CLI -a SpectralTransformer --image-size "
                  f"{REMAT_SIZE} --train-batch-size {REMAT_BATCHES[0]} "
                  f"{' '.join(extra)}: {time.perf_counter() - t:.1f} s, "
                  f"logged {logged[tag]}", flush=True)
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    if not logged["plain"] or logged["remat"] != logged["plain"]:
        fail("(d) the --remat --remat-policy dots run logs other losses "
             "than the run without --remat")
    print(f"phase 14(d) took {time.perf_counter() - t_d:.1f} s", flush=True)
    torch.backends.cudnn.deterministic = False
    print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return []


# 15: steps a call; calls of the compared run (the first eager, then a
# capture and replays); calls a timed turn
GRAPH_K, GRAPH_CALLS, GRAPH_TURN_CALLS = 4, 3, 2
# (e): train and test pairs, so that an epoch at batch 2 is one group of
# four and a remainder of one
GRAPH_CLI_PAIRS = (10, 2)
# (e): the logged losses' relative distance from the --steps-per-dispatch 1
# run: capturable Adam computes its bias correction on the card in f32
# (the eager step's on the host), about 1e-7 of each update, which the
# bf16 forward may round into a loss a few ulps (4e-3 of a loss in bf16's
# 8 bits) away after some steps; a step at the wrong learning rate or a
# missed one moves a loss much further
GRAPH_CLI_TOL = 1e-3


def graph_launches(arch, model, got, batch, sms, remat):
    """(whether ``got``, the tallies of one train step by kernel, are the
    launches the planners say for ``model``, their description)."""
    if arch == "SpectralTransformer":
        want = spectral_launches(batch, train=True)
        return got == want, f"{ {k: sum(v.values()) for k, v in want.items()} }"
    if arch == "AST":
        want, (calls, masked) = ast_launches(model, batch, sms, remat)
        wa_fwd = got.get("window_attn", {})
        have = (sum(wa_fwd.values()), sum(v for k, v in wa_fwd.items()
                                           if k[4]),
                sum(got.get("window_attn_bwd", {}).values()))
        bwd = 10 * window_attn_bwd_launches(batch)
        ok = (have == (calls, masked, bwd)
              and all(got.get(k) == v for k, v in want.items()))
        return ok, (f"{ {k: sum(v.values()) for k, v in want.items()} }, "
                    f"window_attn {(calls, masked)} (all, masked), "
                    f"window_attn_bwd {bwd}")
    want = new_launches(model, batch, sms, remat)
    return ({k: got.get(k) for k in want} == want,
            f"{ {k: sum(v.values()) for k, v in want.items()} }")


def _kernel_counters():
    """The launch tallies of the eight kernels by name."""
    from underwater_image_restoration_torch.ops import (
        ln_gdfn,
        ln_leff,
        ln_mdta,
        window_attention,
    )
    from underwater_image_restoration_torch.ops.fused_gdfn import ln_gdfn_bwd
    from underwater_image_restoration_torch.ops.fused_leff import ln_leff_bwd
    from underwater_image_restoration_torch.ops.fused_mdta import ln_mdta_bwd
    from underwater_image_restoration_torch.ops.window_attention import (
        window_attn_bwd,
    )

    return {"ln_gdfn": ln_gdfn.launches, "ln_mdta": ln_mdta.launches,
            "ln_gdfn_bwd": ln_gdfn_bwd.launches,
            "ln_mdta_bwd": ln_mdta_bwd.launches,
            "ln_leff": ln_leff.launches, "ln_leff_bwd": ln_leff_bwd.launches,
            "window_attn": window_attention.launches,
            "window_attn_bwd": window_attn_bwd.launches}


def _graph_vs_eager(torch, arch, kw, lossfn, size, raws, refs, counters,
                    parallel=None):
    """GRAPH_CALLS calls of ``make_train_step(k_steps=GRAPH_K)`` against as
    many eager single steps from a copy of one state: ``arch`` at ``size``
    (``init_model`` keyword arguments ``kw``), bf16, Adam lr LR built
    capturable, DropPath from a generator seeded 0, over ``parallel``'s
    ranks (None: one), on the batches ``raws``/``refs`` in turn.  Returns
    the models, generators and steps by name (``eager``, ``graph``), the
    runs' stacked metrics, the kernels' tallies in each graph call, the
    plain calls, the capturing call's allocated peak (GiB) and the
    comparisons: metrics bit-equal by name, the parameters and the last
    gradients that differ, the generators' states equal."""
    import numpy as np

    from underwater_image_restoration_torch.models import init_model
    from underwater_image_restoration_torch.train import (
        get_optimizer,
        make_train_step,
    )

    dev = "cuda" if parallel is None else parallel.device
    models = {"eager": init_model(arch, seed=0, img_size=size,
                                  compute_dtype=torch.bfloat16, **kw)}
    models["graph"] = copy.deepcopy(models["eager"])
    gens = {m: torch.Generator(device=dev).manual_seed(0) for m in models}
    steps = {m: make_train_step(
        models[m], lossfn, get_optimizer("adam", models[m].parameters(), LR,
                                         capturable=True),
        generator=gens[m], parallel=parallel,
        k_steps=GRAPH_K if m == "graph" else 1) for m in models}
    eager = [steps["eager"](raws[j % GRAPH_K], refs[j % GRAPH_K])
             for j in range(GRAPH_CALLS * GRAPH_K)]
    eager = {k: torch.stack([m[k] for m in eager]) for k in eager[0]}
    raw_k, ref_k = np.stack(raws), np.stack(refs)
    torch.cuda.synchronize()
    calls, moved = [], []
    with _PlainCalls() as plain:
        for i in range(GRAPH_CALLS):
            for cnt in counters.values():
                cnt.clear()
            if i == 1:
                torch.cuda.reset_peak_memory_stats()
            calls.append(steps["graph"](raw_k, ref_k))
            torch.cuda.synchronize()
            moved.append({k: dict(v) for k, v in counters.items() if v})
            if i == 1:
                capture_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    graph = {k: torch.cat([c[k] for c in calls]) for k in calls[0]}
    named = dict(models["graph"].named_parameters())
    return {
        "models": models, "gens": gens, "steps": steps, "eager": eager,
        "graph": graph, "moved": moved, "plain": dict(plain.calls),
        "capture_peak": capture_peak,
        "same": {k: torch.equal(eager[k], graph[k]) for k in eager},
        "differ": [n for n, p in models["eager"].named_parameters()
                   if not torch.equal(p, named[n])],
        "grads_differ": [n for n, p in models["eager"].named_parameters()
                         if not torch.equal(p.grad, named[n].grad)],
        "gen_same": torch.equal(gens["eager"].get_state(),
                                gens["graph"].get_state())}


def graph_phase(card, batch, size):
    """15. the K-step dispatch (``make_train_step(k_steps=GRAPH_K)``) on
    the card, bf16, L1withColor, Adam lr 3e-4 built capturable, clip 1.0,
    cuDNN's deterministic algorithms, TF32 off: (a) SpectralTransformer,
    (b) AST (DropPath at its rates from a seeded generator), (c)
    NewModel-Wavelet, (d) AST with per-block remat (full), each at
    ``size``, batch ``batch``: GRAPH_CALLS calls of GRAPH_K steps (the
    first eager, the second capturing the graph) against as many eager
    single steps from a copy of the same state: losses, grad norms and
    parameters bit-equal, and the DropPath generator's state, and in (d)
    the last step's gradients; the kernels' tallies in the capturing call
    one step's launches as the planners say, none in the last call (the
    replays run no Python), no plain version; then images/s, host ms a
    step, peak memory (allocated and reserved; the graph's allocated peak
    is its capture's) of eager and graph in turns, the host ms of one
    replay issued on an idle card, and the capture's seconds; (e) the CLI at ``--steps-per-dispatch 4`` and 1, two epochs
    over synthetic pairs: logged losses within GRAPH_CLI_TOL, the first
    bit-equal, one capture a learning rate.  Returns no kernel rows."""
    import numpy as np
    import torch

    from underwater_image_restoration_torch.cli.main import main as cli
    from underwater_image_restoration_torch.data import synthetic_pair_batch
    from underwater_image_restoration_torch.losses import LossFunction
    from underwater_image_restoration_torch.ops import _kernels
    from underwater_image_restoration_torch.train import trainer

    t_phase = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    lossfn = LossFunction("L1withColor")
    sms = _kernels.sm_count(torch.device("cuda"))
    counters = _kernel_counters()
    gib = 2 ** 30
    pairs = [synthetic_pair_batch(batch, size, seed=170 + i)
             for i in range(GRAPH_K)]
    raws, refs = [r for r, _ in pairs], [f for _, f in pairs]
    raw_k, ref_k = np.stack(raws), np.stack(refs)

    rows = (("a", "SpectralTransformer", "SpectralTransformer", {}),
            ("b", "AST", "AST", {}),
            ("c", "NewModel-Wavelet", "NewModel", {"use_dwt": "Wavelet"}),
            ("d", "AST remat full", "AST", {"remat": True,
                                            "remat_policy": "full"}))
    for tag, label, arch, kw in rows:
        t_row = time.perf_counter()
        remat = bool(kw.get("remat"))
        r = _graph_vs_eager(torch, arch, kw, lossfn, size, raws, refs,
                            counters)
        models, steps, moved = r["models"], r["steps"], r["moved"]
        eager, graph, same = r["eager"], r["graph"], r["same"]
        step_g = steps["graph"]
        ok, want = graph_launches(arch, models["graph"], moved[1], batch,
                                  sms, remat)
        launches = {k: sum(v.values()) for k, v in moved[1].items()}
        print(f"({tag}) {label} {size}x{size} bf16 batch {batch}, "
              f"k_steps={GRAPH_K}: tallies in the capturing call {launches} "
              f"(the planners' one step: {want}), in the replaying call "
              f"{moved[2]}, plain calls {r['plain']}, captures "
              f"{step_g.captures} in {step_g.capture_seconds[0]:.2f} s",
              flush=True)
        if not ok:
            fail(f"({tag}) {label}: the capture's launches {moved[1]} are "
                 "not one step's")
        if moved[2] or r["plain"] or step_g.captures != 1:
            fail(f"({tag}) {label}: launches during the replays {moved[2]}, "
                 f"plain calls {r['plain']} or captures "
                 f"{step_g.captures}")
        print(f"({tag}) {label}: {GRAPH_CALLS * GRAPH_K} steps, graph vs "
              f"eager: losses {eager['loss'].tolist()} "
              f"{'bit-equal' if same['loss'] else 'DIFFER'}, grad norms "
              f"{'bit-equal' if same['grad_norm'] else 'DIFFER'}, "
              f"{len(r['differ'])} of {len(list(models['eager'].parameters()))}"
              f" parameters differ, last gradients differ in "
              f"{len(r['grads_differ'])}, generator state "
              f"{'equal' if r['gen_same'] else 'DIFFERS'}", flush=True)
        if not all(same.values()) or r["differ"] or not r["gen_same"] or \
                not bool(torch.isfinite(graph["loss"]).all()):
            fail(f"({tag}) {label}: the graph's steps are not the eager "
                 f"steps: {same}, parameters {r['differ'][:3]}, generator "
                 f"{r['gen_same']}")
        if remat and r["grads_differ"]:
            fail(f"({tag}) {label}: gradients differ: "
                 f"{r['grads_differ'][:3]}")
        capture_peak = r["capture_peak"]

        rates = {m: [] for m in models}
        host = {m: [] for m in models}
        peak = {m: [0.0, 0.0] for m in models}
        n_steps = GRAPH_TURN_CALLS * GRAPH_K
        for m in ("eager", "graph", "graph", "eager"):
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            if m == "eager":
                for j in range(n_steps):
                    steps[m](raws[j % GRAPH_K], refs[j % GRAPH_K])
            else:
                for _ in range(GRAPH_TURN_CALLS):
                    steps[m](raw_k, ref_k)
            t_host = time.perf_counter() - t
            torch.cuda.synchronize()
            rates[m].append(n_steps * batch / (time.perf_counter() - t))
            host[m].append(1e3 * t_host / n_steps)
            peak[m] = [max(peak[m][0], torch.cuda.max_memory_allocated()
                           / gib),
                       max(peak[m][1], torch.cuda.max_memory_reserved()
                           / gib)]
        # one replay issued on an idle card: the host's own cost, without
        # the wait for room in the card's queue that a run of replays meets
        torch.cuda.synchronize()
        t = time.perf_counter()
        step_g.graph.replay()
        idle_ms = 1e3 * (time.perf_counter() - t)
        torch.cuda.synchronize()
        print(f"({tag}) {label} {size}x{size} bf16 batch {batch} train "
              f"step, turns eager, graph, graph, eager: eager "
              f"{sum(rates['eager']) / 2:.2f} images/s "
              f"{[round(v, 2) for v in rates['eager']]}, host "
              f"{[round(v, 3) for v in host['eager']]} ms a step, peak "
              f"{peak['eager'][0]:.2f} GiB allocated, {peak['eager'][1]:.2f}"
              f" reserved; graph {sum(rates['graph']) / 2:.2f} images/s "
              f"{[round(v, 2) for v in rates['graph']]}, host "
              f"{[round(v, 3) for v in host['graph']]} ms a step (one "
              f"replay on an idle card {idle_ms:.3f} ms), peak "
              f"{capture_peak:.2f} GiB allocated (capture), "
              f"{peak['graph'][0]:.2f} (replays), {peak['graph'][1]:.2f} "
              f"reserved; capture {step_g.capture_seconds[0]:.2f} s; "
              f"row {time.perf_counter() - t_row:.1f} s; on {card}",
              flush=True)
        del r, models, steps, step_g, eager, graph
        torch.cuda.empty_cache()

    # ---- (e) the CLI, --steps-per-dispatch 4 and 1, two epochs
    t_e = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "phase15")
    shutil.rmtree(root, ignore_errors=True)
    n_train, n_test = GRAPH_CLI_PAIRS
    train = _write_pairs(os.path.join(root, "data", "train"), n_train, size,
                         seed=180)
    test = _write_pairs(os.path.join(root, "data", "test"), n_test, size,
                        seed=181)
    common = ["-a", "SpectralTransformer", "--image-size", str(size),
              "--train-batch-size", "2", "--max-epoch", "2", "--use-wandb",
              "--train-raw", train[0], "--train-ref", train[1],
              "--test-raw", test[0], "--test-ref", test[1]]
    logged, made = {}, []
    real = trainer.make_train_step
    cwd = os.getcwd()
    try:
        os.chdir(root)  # the CLI's logs/ land here
        trainer.make_train_step = lambda *a, **k: made.append(
            real(*a, **k)) or made[-1]
        for k in (4, 1):
            t = time.perf_counter()
            cli(common + ["--steps-per-dispatch", str(k),
                          "--checkpoint-dir", os.path.join(root, str(k))])
            torch.cuda.synchronize()
            run = os.path.join(root, str(k), os.listdir(os.path.join(
                root, str(k)))[0])
            logged[k] = [(key, r[key]) for r in _jsonl(run)
                         for key in ("train/loss", "test/loss") if key in r]
            print(f"(e) CLI -a SpectralTransformer --image-size {size} "
                  f"--train-batch-size 2 --max-epoch 2 --steps-per-dispatch "
                  f"{k} over {n_train} pairs: {time.perf_counter() - t:.1f}"
                  f" s, logged {logged[k]}", flush=True)
    finally:
        trainer.make_train_step = real
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    captures = made[0].captures
    keys = [key for key, _ in logged[1]]
    if [key for key, _ in logged[4]] != keys or not keys:
        fail("(e) the two CLI runs logged other records")
    drift = max(abs(a - b) / abs(b) for (_, a), (_, b) in zip(logged[4],
                                                            logged[1]))
    first = logged[4][0][1] == logged[1][0][1]
    print(f"(e) --steps-per-dispatch 4 vs 1: {keys.count('train/loss')} "
          f"train losses, max relative difference of the logged losses "
          f"{drift:.3e} (tol {GRAPH_CLI_TOL:.0e}), the first "
          f"{'bit-equal' if first else 'DIFFERS'}; {captures} captures "
          f"(learning rates {LR}, {LR * 0.25}) in "
          f"{sum(made[0].capture_seconds):.2f} s", flush=True)
    if not drift <= GRAPH_CLI_TOL or not first or captures != 2:
        fail("(e) the CLI's K-step run disagrees with its single steps or "
             "did not capture once a learning rate")
    print(f"phase 15(e) took {time.perf_counter() - t_e:.1f} s", flush=True)
    torch.backends.cudnn.deterministic = False
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return []


# 16: the K-step dispatch over two data ranks sharing the card (gloo)
GP_WORLD = 2
# (a)-(c): the rows, each GRAPH_CALLS calls of GRAPH_K steps against as many
# eager two-rank single steps
GP_ROWS = (("a", "SpectralTransformer", "SpectralTransformer", {},
            "L1withColor"),
           ("b", "AST", "AST", {}, "L1withColor"),
           ("c", "SpectralTransformer Adaptive", "SpectralTransformer", {},
            "AdaptiveLuminanceCharbonnier"))
# (f): train and test pairs of the two-rank CLI runs, so that an epoch at
# global batch 4 is one group of four and a remainder of one
GP_CLI_PAIRS = (20, 2)


def _digest(tensors):
    """SHA-256 of the tensors' bytes in order: equal on two ranks only where
    every tensor is bit-equal."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _gp_turns(torch, dp, steps, raws, refs, raw_k, ref_k, batch, one):
    """16(e) on one rank: images/s (of the global batch), host ms a step and
    peak memory of the two ranks' eager steps and cut graphs, and of one
    rank's graph at the global batch (``one``: rank 0's step and its group,
    while rank 1 waits), in turns."""
    gib = 2 ** 30
    n = GRAPH_TURN_CALLS * GRAPH_K
    out = []
    for kind in ("eager", "graph", "one", "one", "graph", "eager"):
        dp.barrier()
        if kind != "one" or dp.is_main:
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            if kind == "eager":
                for j in range(n):
                    steps["eager"](raws[j % GRAPH_K], refs[j % GRAPH_K])
            else:
                st, rk, fk = ((steps["graph"], raw_k, ref_k)
                              if kind == "graph" else one)
                for _ in range(GRAPH_TURN_CALLS):
                    st(rk, fk)
            t_host = time.perf_counter() - t
            torch.cuda.synchronize()
            out.append((kind, n * batch / (time.perf_counter() - t),
                        1e3 * t_host / n,
                        torch.cuda.max_memory_allocated() / gib,
                        torch.cuda.max_memory_reserved() / gib))
        dp.barrier()
    return out


def _graph_parallel_rank(rank, port, out_dir, batch, size):
    """A rank of phase 16: (a)-(c) the cut graphs against eager steps,
    (d) FSDP2 and two context ranks at K = GRAPH_K against K = 1, (e) the
    turns; results in ``out_dir/rank<r>.pt``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(GP_WORLD),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    import numpy as np
    import torch

    from underwater_image_restoration_torch.core import meshes
    from underwater_image_restoration_torch.data import synthetic_pair_batch
    from underwater_image_restoration_torch.losses import LossFunction
    from underwater_image_restoration_torch.models import init_model
    from underwater_image_restoration_torch.ops import _kernels
    from underwater_image_restoration_torch.train import (
        get_optimizer,
        make_train_step,
    )

    def stage(msg):
        print(f"16 rank {rank}: {msg}\n", end="", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // GP_WORLD))
    dp = meshes.init_data_parallel(
        GP_WORLD, rank,
        backend=meshes.default_backend(torch.device("cuda"), GP_WORLD))
    dev = dp.device
    bf16 = torch.bfloat16
    sms = _kernels.sm_count(dev)
    counters = _kernel_counters()
    pairs = [synthetic_pair_batch(batch, size, seed=190 + i)
             for i in range(GRAPH_K)]
    rows = dp.rows(batch)
    raws, refs = [r[rows] for r, _ in pairs], [f[rows] for _, f in pairs]
    raw_k, ref_k = np.stack(raws), np.stack(refs)
    res = {"device": str(dp.device), "backend": dp.backend, "rows": {}}
    stage(f"joined the group on {dev} over {dp.backend}")

    for tag, label, arch, kw, loss in GP_ROWS:
        t_row = time.perf_counter()
        lossfn = LossFunction(loss)
        r = _graph_vs_eager(torch, arch, kw, lossfn, size, raws, refs,
                            counters, parallel=dp)
        models, steps, moved = r["models"], r["steps"], r["moved"]
        sg = steps["graph"]
        ok, want = graph_launches(arch, models["graph"], moved[1],
                                  batch // GP_WORLD, sms, False)
        params = list(models["graph"].parameters())
        res["rows"][tag] = {
            "label": label, "route": sg.route, "tallies": moved[1],
            "replays": moved[2], "want": want, "ok": ok,
            "plain": r["plain"], "captures": sg.captures,
            "capture_s": sg.capture_seconds[0], "segments": sg.segments,
            "capture_peak": r["capture_peak"], "tape": sg.tape,
            "numel": sum(p.numel() for p in params),
            "same": r["same"], "differ": r["differ"],
            "gen_same": r["gen_same"],
            "losses": r["graph"]["loss"].tolist(),
            "digest": _digest(params + [r["gens"]["graph"].get_state()]),
            "seconds": time.perf_counter() - t_row}
        stage(f"({tag}) {label} done")
        if tag == "a":  # (e): the turns, rank 0 alone at the global batch
            one = None
            if dp.is_main:
                m1 = copy.deepcopy(models["graph"])
                st1 = make_train_step(
                    m1, lossfn, get_optimizer("adam", m1.parameters(), LR,
                                              capturable=True),
                    generator=torch.Generator(device=dev).manual_seed(0),
                    k_steps=GRAPH_K)
                full_k = (np.stack([x for x, _ in pairs]),
                          np.stack([y for _, y in pairs]))
                st1(*full_k)  # eager, then the capture
                st1(*full_k)
                one = (st1, *full_k)
            res["turns"] = _gp_turns(torch, dp, steps, raws, refs, raw_k,
                                     ref_k, batch, one)
            del one
            stage("(e) turns done")
        del r, models, steps, sg, params
        torch.cuda.empty_cache()

    # (d) FSDP2 (SpectralTransformer) and two context ranks (AST) at K =
    # GRAPH_K against K = 1: the stepwise route
    lossfn = LossFunction("L1withColor")

    def k_against_one(make_model, parallel, raw_list, ref_list):
        runs = {}
        for k in (1, GRAPH_K):
            model = make_model()
            gen = torch.Generator(device=dev).manual_seed(0)
            st = make_train_step(model, lossfn, get_optimizer(
                "adam", model.parameters(), LR), generator=gen,
                parallel=parallel, k_steps=k)
            ms = ([st(raw_list[j], ref_list[j]) for j in range(GRAPH_K)]
                  if k == 1 else [st(np.stack(raw_list),
                                     np.stack(ref_list))])
            runs[k] = (torch.cat([torch.atleast_1d(m["loss"]) for m in ms]),
                       [getattr(p, "to_local", p.detach)().clone()
                        for p in model.parameters()], gen.get_state(),
                       getattr(st, "route", None))
        (l1, p1, g1, _), (lk, pk, gk, how) = runs[1], runs[GRAPH_K]
        torch.cuda.empty_cache()
        return {"route": how, "losses": l1.tolist(),
                "same": torch.equal(l1, lk),
                "params_same": all(map(torch.equal, p1, pk)),
                "gen_same": torch.equal(g1, gk)}

    res["fsdp"] = k_against_one(
        lambda: meshes.shard_model(init_model(
            "SpectralTransformer", seed=0, img_size=size,
            compute_dtype=bf16), dp), dp, raws, refs)
    stage("(d) FSDP2 done")
    dpc = meshes.init_data_parallel(GP_WORLD, rank, mesh_context=GP_WORLD)
    res["context"] = k_against_one(
        lambda: init_model("AST", seed=0, img_size=size, compute_dtype=bf16,
                           cp=dpc.cp), dpc,
        [r for r, _ in pairs], [f for _, f in pairs])
    stage("(d) context ranks done")
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    meshes.close_data_parallel(dp)


def _gp_cli(root, size):
    """16(f): the CLI under ``torchrun --nproc-per-node 2 ... --mesh-data
    2`` at ``--steps-per-dispatch`` GRAPH_K and 1, two epochs each (the
    learning rate falling after the first), both at once: (the K = 1 run's
    logged losses, the K run's, the K run's closing line)."""
    data = os.path.join(root, "data")
    n_train, n_test = GP_CLI_PAIRS
    dirs = {}
    for split, n, seed in (("train", n_train, 200), ("test", n_test, 201)):
        dirs[split] = _write_pairs(os.path.join(data, split), n, size, seed)
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    runs = {}
    t = time.perf_counter()
    for k in (GRAPH_K, 1):
        ckpt = os.path.join(root, f"checkpoints-{k}")
        argv = ["-m", "torch.distributed.run", "--nproc-per-node",
                str(GP_WORLD), "--master-port", str(_free_port()),
                "-m", "underwater_image_restoration_torch.cli", "-a",
                "SpectralTransformer", "--mesh-data", str(GP_WORLD),
                "--image-size", str(size), "--train-batch-size", "4",
                "--test-batch-size", "2", "--max-epoch", "2",
                "--use-wandb", "--steps-per-dispatch", str(k),
                "--train-raw", dirs["train"][0], "--train-ref",
                dirs["train"][1], "--test-raw", dirs["test"][0],
                "--test-ref", dirs["test"][1], "--checkpoint-dir", ckpt]
        cwd = os.path.join(root, f"cli-{k}")
        os.makedirs(cwd)
        log = open(os.path.join(cwd, "out.log"), "w")
        runs[k] = (subprocess.Popen(
            [sys.executable] + argv, cwd=cwd, env=env, stdout=log,
            stderr=subprocess.STDOUT), log, ckpt)
    logged, closing = {}, ""
    for k, (proc, log, ckpt) in runs.items():
        try:
            rc = proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "killed at 600 s"
        log.close()
        with open(log.name) as f:
            out = f.read()
        if rc != 0:
            fail(f"16(f) the CLI at --steps-per-dispatch {k} under torchrun "
                 f"failed ({rc}):\n{out[-3000:]}")
        if k == GRAPH_K:
            head = f"steps_per_dispatch {GRAPH_K}: "
            closing = [ln[ln.index(head):] for ln in out.splitlines()
                       if head in ln]
        run_dir = os.path.join(ckpt, os.listdir(ckpt)[0])
        logged[k] = [(key, r[key]) for r in _jsonl(run_dir)
                     for key in ("train/loss", "test/loss") if key in r]
        print(f"16(f) torchrun --nproc-per-node {GP_WORLD} cli -a "
              f"SpectralTransformer --mesh-data {GP_WORLD} --image-size "
              f"{size} --train-batch-size 4 --max-epoch 2 "
              f"--steps-per-dispatch {k} over {n_train} pairs: done "
              f"{time.perf_counter() - t:.1f} s after the runs' start, "
              f"logged {logged[k]}", flush=True)
    return logged[1], logged[GRAPH_K], closing


def graph_parallel_phase(card, batch, size):
    """16. the K-step dispatch over two data ranks (two processes sharing
    the card over gloo; ``make_train_step(parallel=dp, k_steps=GRAPH_K)``:
    the first call's steps eager, then the step captured as CUDA graphs
    cut at its collectives, which run eagerly between the replays), bf16,
    Adam lr 3e-4 built capturable, clip 1.0, ``size``, global batch
    ``batch``, cuDNN deterministic: (a) SpectralTransformer, L1withColor;
    (b) AST with DropPath at its rates; (c) SpectralTransformer with
    AdaptiveLuminanceCharbonnier (a cut inside the loss): GRAPH_CALLS calls
    against as many eager two-rank single steps from a copy of the same
    state, on each rank losses, grad norms, parameters and the generator's
    state bit-equal, and equal across the ranks; the capturing call's
    tallies one step's at the rank's batch as the planners say, none in the
    last call, no plain version; the collectives' tape the same on both
    ranks and ``segments`` one more than its length; (d) FSDP2 (Spectral)
    and two context ranks (AST) at K = GRAPH_K against K = 1: the
    ``stepwise`` route, losses and parameters bit-equal; (e) images/s of
    the global batch, host ms a step and peak memory a rank of the two
    ranks' eager steps and cut graphs, and of one rank's graph at the
    global batch, in turns, and the capture's seconds; (f) the CLI under
    ``torchrun`` at ``--steps-per-dispatch`` GRAPH_K and 1: logged losses
    within GRAPH_CLI_TOL, the first bit-equal, route ``segments`` and one
    capture a learning rate.  Returns no kernel rows."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="phase16-", dir=build)
    os.environ["PYTHONFAULTHANDLER"] = "1"
    t = time.perf_counter()
    mp.spawn(_graph_parallel_rank,
             args=(_free_port(), out_dir, batch, size), nprocs=GP_WORLD)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                        weights_only=False) for r in range(GP_WORLD)]
    print(f"16 ranks: {GP_WORLD} processes on "
          f"{[r['device'] for r in ranks]} over {ranks[0]['backend']} "
          f"({time.perf_counter() - t:.1f} s with their start)", flush=True)
    for tag, label, _, _, loss in GP_ROWS:
        rows = [r["rows"][tag] for r in ranks]
        kinds = ["mean"] * loss.startswith("Adaptive") + ["all_reduce_",
                                                          "sum"]
        for r, row in enumerate(rows):
            launches = {k: sum(v.values()) for k, v in row["tallies"].items()}
            print(f"16({tag}) {label} {size}x{size} bf16 global batch "
                  f"{batch}, rank {r}, k_steps={GRAPH_K}, route "
                  f"{row['route']}: tallies in the capturing call "
                  f"{launches} (the planners' one step at batch "
                  f"{batch // GP_WORLD}: {row['want']}), in the replaying "
                  f"call {row['replays']}, plain calls {row['plain']}; "
                  f"{row['captures']} capture in {row['capture_s']:.2f} s, "
                  f"{row['segments']} graphs a step around the collectives "
                  f"{row['tape']}", flush=True)
            print(f"16({tag}) rank {r}: {GRAPH_CALLS * GRAPH_K} steps, cut "
                  f"graphs vs eager two-rank steps: losses {row['losses']} "
                  f"{'bit-equal' if row['same']['loss'] else 'DIFFER'}, "
                  f"grad norms "
                  f"{'bit-equal' if row['same']['grad_norm'] else 'DIFFER'}"
                  f", {len(row['differ'])} parameters differ, generator "
                  f"{'equal' if row['gen_same'] else 'DIFFERS'}; row "
                  f"{row['seconds']:.1f} s", flush=True)
            if not row["ok"] or row["replays"] or row["plain"] or \
                    row["captures"] != 1:
                fail(f"16({tag}) rank {r}: the capture's launches, the "
                     "replays' launches, a plain call or the captures")
            if row["route"] != "segments" or \
                    row["segments"] != len(row["tape"]) + 1 or \
                    [k for k, _, _ in row["tape"]] != kinds or \
                    row["tape"][-2][2] != row["numel"]:
                fail(f"16({tag}) rank {r}: route {row['route']}, "
                     f"{row['segments']} segments for the tape "
                     f"{row['tape']}")
            if not all(row["same"].values()) or row["differ"] or \
                    not row["gen_same"]:
                fail(f"16({tag}) rank {r}: the cut graphs' steps are not "
                     f"the eager steps: {row['same']}, parameters "
                     f"{row['differ'][:3]}, generator {row['gen_same']}")
        same = (rows[0]["tape"] == rows[1]["tape"]
                and rows[0]["losses"] == rows[1]["losses"]
                and rows[0]["digest"] == rows[1]["digest"])
        print(f"16({tag}) across the ranks: tapes, losses, parameters and "
              f"generator {'equal' if same else 'DIFFER'}", flush=True)
        if not same:
            fail(f"16({tag}) the two ranks disagree")
    for name, what in (("fsdp", "FSDP2 SpectralTransformer"),
                       ("context", "two context ranks AST")):
        for r, res in enumerate(ranks):
            d = res[name]
            ok = (d["route"] == "stepwise" and d["same"]
                  and d["params_same"] and d["gen_same"])
            print(f"16(d) {what} {size}x{size} bf16 batch {batch}, rank "
                  f"{r}: k_steps={GRAPH_K} route {d['route']}, losses "
                  f"{d['losses']} {'bit-equal' if d['same'] else 'DIFFER'} "
                  f"to K = 1, parameters "
                  f"{'bit-equal' if d['params_same'] else 'DIFFER'}, "
                  f"generator {'equal' if d['gen_same'] else 'DIFFERS'}",
                  flush=True)
            if not ok:
                fail(f"16(d) {what} at k_steps={GRAPH_K} is not K = 1")
    by = collections.defaultdict(list)
    for r, res in enumerate(ranks):
        for kind, rate, host, alloc, reserved in res["turns"]:
            by[kind].append((r, rate, host, alloc, reserved))
    summary = {}
    for kind in ("eager", "graph", "one"):
        rates = [v[1] for v in by[kind] if v[0] == 0]
        summary[kind] = sum(rates) / len(rates)
        print(f"16(e) {kind}: {summary[kind]:.2f} images/s "
              f"{[round(v, 2) for v in rates]}, host "
              f"{[(v[0], round(v[2], 3)) for v in by[kind]]} ms a step "
              f"(rank, ms), peak "
              f"{[(v[0], round(v[3], 2), round(v[4], 2)) for v in by[kind]]}"
              f" GiB (rank, allocated, reserved)", flush=True)
    print(f"16(e) SpectralTransformer {size}x{size} bf16 global batch "
          f"{batch}, turns eager, graph, one, one, graph, eager: two ranks' "
          f"cut graphs {summary['graph']:.2f} images/s, their eager steps "
          f"{summary['eager']:.2f} (graph/eager "
          f"{summary['graph'] / summary['eager']:.3f}), one rank's graph "
          f"{summary['one']:.2f} (two ranks' graphs/one "
          f"{summary['graph'] / summary['one']:.3f}); the capturing call's "
          f"allocated peak a rank "
          f"{[round(r['rows']['a']['capture_peak'], 2) for r in ranks]} "
          f"GiB (the replays allocate nothing); capture "
          f"{ranks[0]['rows']['a']['capture_s']:.2f} s; over "
          f"{ranks[0]['backend']} on {card}", flush=True)
    shutil.rmtree(out_dir)

    # ---- (f) the CLI under torchrun, --steps-per-dispatch GRAPH_K and 1
    t_f = time.perf_counter()
    root = os.path.join(build, "phase16")
    shutil.rmtree(root, ignore_errors=True)
    try:
        single, multi, closing = _gp_cli(root, size)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    keys = [key for key, _ in single]
    if [key for key, _ in multi] != keys or not keys:
        fail("16(f) the two CLI runs logged other records")
    drift = max(abs(a - b) / abs(b) for (_, a), (_, b) in zip(multi, single))
    first = multi[0][1] == single[0][1]
    print(f"16(f) --steps-per-dispatch {GRAPH_K} vs 1 over {GP_WORLD} "
          f"ranks: {keys.count('train/loss')} train losses, max relative "
          f"difference of the logged losses {drift:.3e} (tol "
          f"{GRAPH_CLI_TOL:.0e}), the first "
          f"{'bit-equal' if first else 'DIFFERS'}; rank 0's closing line "
          f"{closing}; {time.perf_counter() - t_f:.1f} s", flush=True)
    if not drift <= GRAPH_CLI_TOL or not first or len(closing) != 1 or \
            "route segments" not in closing[0] or \
            not closing[0].startswith(f"steps_per_dispatch {GRAPH_K}: 2 "):
        fail("16(f) the two-rank CLI's K-step run disagrees with its single "
             "steps, or did not capture once a learning rate on the "
             "segments route")
    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return []


def normalize_batch(torch, u8):
    """uint8 NHWC (numpy) -> normalized f32 NCHW on the card."""
    from underwater_image_restoration_torch.train import normalize_u8

    return normalize_u8(torch.as_tensor(u8).cuda()).permute(
        0, 3, 1, 2).contiguous()


def window_attn_bwd_launches(batch):
    """Launches of one AST window attention backward at ``batch`` (the
    kernel, reduce_rows, the dw step), as phase 7 counts them."""
    import importlib

    wa = importlib.import_module(
        "underwater_image_restoration_torch.ops.window_attention")
    return wa.bwd_plan(batch * 4, 16, 64, d=AST_HEAD_DIM,
                       itemsize=2).launches


def _free_port():
    """A free localhost port for the process group."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("all", "ast", "ast-train", "new",
                                        "new-train", "run", "eval",
                                        "parallel", "context", "remat",
                                        "graph", "graph-parallel"),
                    default="all",
                    help="'ast' ('ast-train'): the setup and the AST serving "
                         "(training) phase alone; 'new' ('new-train'): the "
                         "setup and the New* serving (training) phase; "
                         "'run': the setup and the training run (phase 10); "
                         "'eval': the setup, phase 10 and the evaluation "
                         "protocol (phase 11); 'parallel': the setup and "
                         "phase 12 (data parallelism, FSDP, export, "
                         "Grad-CAM, SFCA); 'context': the setup and phase "
                         "13 (context and tensor parallelism); 'remat': the "
                         "setup and phase 14 (rematerialization); 'graph': "
                         "the setup and phase 15 (the K-step dispatch as a "
                         "CUDA graph); 'graph-parallel': the setup and "
                         "phase 16 (the K-step dispatch over two data "
                         "ranks)")
    args = ap.parse_args(argv)
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this check needs "
              "an NVIDIA GPU", flush=True)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from underwater_image_restoration_torch.data import synthetic_pair_batch
    from underwater_image_restoration_torch.eval import (
        batched_apply,
        psnr_float_pm1,
    )
    from underwater_image_restoration_torch.models import init_model
    from underwater_image_restoration_torch.models.spectral_transformer import (
        MDTA,
        SpectralBlock,
    )
    from underwater_image_restoration_torch.losses import LossFunction
    from underwater_image_restoration_torch.ops import (
        _kernels,
        ln_gdfn,
        ln_gdfn_plain,
        ln_mdta,
        ln_mdta_plain,
    )
    from underwater_image_restoration_torch.ops import fused_gdfn, fused_mdta
    from underwater_image_restoration_torch.ops.fused_gdfn import ln_gdfn_bwd
    from underwater_image_restoration_torch.ops.fused_mdta import (
        forward_with_stats,
        ln_mdta_bwd,
    )
    from underwater_image_restoration_torch.tools import (
        profile_serving,
        profile_train,
    )
    from underwater_image_restoration_torch.train import (
        get_optimizer,
        make_train_step,
        normalize_u8,
    )

    # the serving and train cells' shapes, as the profilers trace them
    SERVE_BATCH, SIZE = profile_serving.BATCH, profile_serving.SIZE
    TRAIN_BATCH = profile_train.BATCH
    counters = {"ln_gdfn": ln_gdfn.launches, "ln_mdta": ln_mdta.launches,
                "ln_gdfn_bwd": ln_gdfn_bwd.launches,
                "ln_mdta_bwd": ln_mdta_bwd.launches}

    # ---- 1. setup
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    card = f"{smi} ({torch.cuda.get_device_name(0)})"
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    spectral = ["ln_gdfn", "ln_mdta", "ln_gdfn_bwd", "ln_mdta_bwd"]
    built = _kernels.build_all(
        None if args.phase in ("all", "remat", "graph", "graph-parallel")
        else spectral if args.phase == "run"
        else spectral + ["ln_leff", "window_attn"]
        if args.phase in ("eval", "parallel")
        else ["ln_leff", "ln_leff_bwd", "window_attn", "window_attn_bwd"]
        + (spectral if args.phase == "context" else []))
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln or "entry" in ln]
        print(f"  {name}: {info['path']}", flush=True)
        for ln in regs:
            print(f"    ptxas {ln}", flush=True)
    # the redesigned libraries must run their products on the tensor
    # cores: HMMA instructions in their SASS (cuobjdump -sass)
    for name in TENSOR_CORE_LIBS:
        if name in built:
            HMMA[name] = _kernels.sass_count(name, "HMMA")
            print(f"  {name}: {HMMA[name]} HMMA instructions in the SASS",
                  flush=True)
            if HMMA[name] == 0:
                fail(f"{name} has no tensor-core (HMMA) instruction")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.phase == "ast":
        kernels = ast_phase(card, SERVE_BATCH, SIZE)
        return record(torch, kernels, t_start)
    if args.phase == "ast-train":
        kernels = ast_train_phase(card, TRAIN_BATCH, SIZE, CHECK_BATCH)
        return record(torch, kernels, t_start)
    if args.phase == "new":
        kernels = new_phase(card, SERVE_BATCH, SIZE)
        return record(torch, kernels, t_start)
    if args.phase == "new-train":
        kernels = new_train_phase(card, TRAIN_BATCH, SIZE, CHECK_BATCH)
        return record(torch, kernels, t_start)
    if args.phase == "run":
        shutil.rmtree(run_phase(card, TRAIN_BATCH, SIZE)[0])
        return record(torch, [], t_start)
    if args.phase == "eval":
        kernels = eval_phase(card, run_phase(card, TRAIN_BATCH, SIZE),
                             TRAIN_BATCH)
        return record(torch, kernels, t_start)
    if args.phase == "parallel":
        kernels = parallel_phase(card, TRAIN_BATCH, SIZE, CHECK_BATCH)
        return record(torch, kernels, t_start)
    if args.phase == "context":
        kernels = context_phase(card, TRAIN_BATCH, SIZE, CHECK_BATCH)
        return record(torch, kernels, t_start)
    if args.phase == "remat":
        kernels = remat_phase(card, TRAIN_BATCH, SIZE)
        return record(torch, kernels, t_start)
    if args.phase == "graph":
        kernels = graph_phase(card, TRAIN_BATCH, SIZE)
        return record(torch, kernels, t_start)
    if args.phase == "graph-parallel":
        kernels = graph_parallel_phase(card, TRAIN_BATCH, SIZE)
        return record(torch, kernels, t_start)

    # ---- 2. kernels vs plain versions
    fns = {"ln_gdfn": (ln_gdfn, ln_gdfn_plain),
           "ln_mdta": (ln_mdta, ln_mdta_plain)}

    def call(name, fn, x, ln, mdta, gdfn, nh):
        if name == "ln_gdfn":
            return fn(x, *ln, *gdfn)
        return fn(x, *ln, *mdta, nh)

    def check(name, c, h, w, nh, batch, seed):
        """Kernel vs plain version on the same input, in f32 and in bf16;
        returns the bf16 inputs and the larger max abs error."""
        x, ln, mdta, gdfn = block_inputs(c, h, w, nh, batch, seed)
        kern, plain = fns[name]
        worst = 0.0
        for dt in (torch.float32, torch.bfloat16):
            xin = x.to(dt)
            got = call(name, kern, xin, ln, mdta, gdfn, nh).float()
            ref = call(name, plain, xin, ln, mdta, gdfn, nh).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            branch = (ref - xin.float()).abs().max().item()
            rel = err / branch
            tol = KERNEL_TOL[str(dt).split(".")[1]]
            ok = bool(torch.isfinite(got).all()) and rel <= tol
            print(f"{name} C={c} {h}x{w} heads={nh} batch {batch} {dt}: "
                  f"max_abs {err:.3e} max|branch| {branch:.3f} max_abs/"
                  f"max|branch| {rel:.3e} tol {tol:.0e} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                fail(f"{name} disagrees with its plain version at C={c} "
                     f"{h}x{w} {dt}")
            worst = max(worst, err)
        return (x.to(torch.bfloat16), ln, mdta, gdfn), worst

    for c, h, w, nh in EDGE_SHAPES:
        for name in fns:
            check(name, c, h, w, nh, 2, seed=c + h)
    rows = {}
    for c, h, w, nh in SHAPES:
        for name, (kern, plain) in fns.items():
            (xb, ln, mdta, gdfn), err = check(name, c, h, w, nh, SERVE_BATCH,
                                              seed=c + h)
            # times on the same inputs, in the serving dtype (bf16)
            ms = median_ms(lambda: call(name, kern, xb, ln, mdta, gdfn, nh))
            pms = median_ms(lambda: call(name, plain, xb, ln, mdta, gdfn, nh),
                            reps=5)
            bms, by = bound(*work(name, c, h, w, nh, SERVE_BATCH, 2))
            rows[(name, c, h, w)] = timing_row(ms, pms, bms, by, err)
            print(f"{name} C={c} {h}x{w} bf16 batch {SERVE_BATCH}: kernel "
                  f"{ms}, plain {pms}, bound {bms:.4f} ms ({by}) on {card}",
                  flush=True)
            del xb
    torch.cuda.empty_cache()

    # ---- 3. model: the serving path at full width
    model = init_model("SpectralTransformer", seed=0,
                       compute_dtype=torch.bfloat16)
    with torch.no_grad():
        for blk in model.modules():
            if isinstance(blk, MDTA):
                blk.temperature.fill_(MODEL_TEMPERATURE)
    raw, _ = synthetic_pair_batch(SERVE_BATCH, SIZE, seed=0)
    apply_b, _ = batched_apply(model, SERVE_BATCH)
    apply_b(raw)  # warm-up: cuFFT plans, cuDNN algorithms
    torch.cuda.synchronize()
    ln_gdfn.launches.clear()
    ln_mdta.launches.clear()
    y = apply_b(raw)
    torch.cuda.synchronize()
    n_gdfn = sum(ln_gdfn.launches.values())
    n_mdta = sum(ln_mdta.launches.values())
    launches = {"ln_gdfn": dict(ln_gdfn.launches),
                "ln_mdta": dict(ln_mdta.launches)}
    want_fwd = spectral_launches(SERVE_BATCH)
    print(f"launches in one forward: ln_gdfn {n_gdfn}, ln_mdta {n_mdta} "
          f"(as the planners say for {sum(BLOCKS.values())} blocks: "
          f"{ {k: sum(v.values()) for k, v in want_fwd.items()} })",
          flush=True)
    for name in launches:
        for (c, h, w), n in sorted(launches[name].items()):
            print(f"  {name} C={c} {h}x{w}: {n}", flush=True)
    if launches != want_fwd:
        fail(f"expected forward launches {want_fwd}, got {launches}")
    if tuple(y.shape) != (SERVE_BATCH, SIZE, SIZE, 3):
        fail(f"output shape {tuple(y.shape)}")
    if not bool(torch.isfinite(y).all()):
        fail("non-finite output")

    def outputs(m, dt, use_kernels):
        m.compute_dtype = dt
        out = batched_apply(m, SERVE_BATCH, use_kernels)[0](raw)
        torch.cuda.synchronize()
        return out

    def without(branch):
        """The model with every block's MDTA or GDFN output projection
        zeroed: what kernels that returned x unchanged would give."""
        m = copy.deepcopy(model)
        for blk in m.modules():
            if isinstance(blk, SpectralBlock):
                proj = (blk.attn.project_outf if branch == "MDTA"
                        else blk.ffn.project_out)
                proj.weight.data.zero_()
        return m

    refs = {}
    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).split(".")[1]
        refs[tag] = ref = outputs(model, dt, False)
        out = y if dt == torch.bfloat16 else outputs(model, dt, True)
        err = (out - ref).abs().max().item()
        gone = {b: (outputs(without(b), dt, False) - ref).abs().max().item()
                for b in ("MDTA", "GDFN")}
        tol = MODEL_TOL[tag]
        print(f"model {tag} kernels vs {tag} plain model: max_abs {err:.3e} "
              f"tol {tol:.0e}; without the MDTA branches the plain model "
              f"moves {gone['MDTA']:.3e}, without GDFN {gone['GDFN']:.3e}",
              flush=True)
        if not tol <= min(gone.values()) / 4:
            fail(f"the {tag} model limit would not see a missing branch")
        if not err <= tol:
            fail(f"model output ({tag}) disagrees with the plain model")
    err = (y - refs["float32"]).abs().max().item()
    psnr = psnr_float_pm1(refs["float32"].cpu().numpy(), y.cpu().numpy())
    print(f"model bf16 kernels vs f32 plain model: max_abs {err:.3e}, PSNR "
          f"{psnr:.2f} dB", flush=True)
    model.compute_dtype = torch.bfloat16

    def serve_rate(fn, iters):
        fn(raw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn(raw)
        torch.cuda.synchronize()
        return iters * SERVE_BATCH / (time.perf_counter() - t)

    apply_plain_bf16, _ = batched_apply(model, SERVE_BATCH, use_kernels=False)
    ips = serve_rate(apply_b, 10)
    ips_plain = serve_rate(apply_plain_bf16, 3)
    print(f"serving SpectralTransformer {SIZE}x{SIZE} bf16 batch "
          f"{SERVE_BATCH}: {ips:.2f} images/s with the kernels, "
          f"{ips_plain:.2f} images/s with the plain versions, on {card}",
          flush=True)

    del model, apply_b, apply_plain_bf16, y
    torch.cuda.empty_cache()

    # ---- 4. backward kernels vs autograd through the plain versions
    bwd = {"ln_gdfn": ln_gdfn_bwd, "ln_mdta": ln_mdta_bwd}

    def check_bwd(name, c, h, w, nh, batch, seed, timed):
        """Every gradient of the backward kernel vs autograd through the
        plain version on the same input, dy and dtype (f32, then bf16);
        with ``timed``, bf16 times of the kernel launches given the saved
        residuals and of the plain autograd backward."""
        x, ln, mdta, gdfn = block_inputs(c, h, w, nh, batch, seed)
        gen = torch.Generator().manual_seed(seed + 1)
        dy32 = torch.randn(x.shape, generator=gen).cuda()
        worst, row = 0.0, {}
        for dt in (torch.float32, torch.bfloat16):
            tag = str(dt).split(".")[1]
            xin, dy = x.to(dt), dy32.to(dt)
            ws = (*ln, *gdfn) if name == "ln_gdfn" else (*ln, *mdta)
            ins = [t.detach().requires_grad_() for t in (xin, *ws)]
            if name == "ln_gdfn":
                def kern():
                    return ln_gdfn_bwd(xin, dy, *ws)

                def plain_fwd():
                    return ln_gdfn_plain(*ins)
            else:
                stats = forward_with_stats(xin, *ws, nh)[1]

                def kern():
                    return ln_mdta_bwd(xin, dy, *ws, nh, stats=stats)

                def plain_fwd():
                    return ln_mdta_plain(*ins, nh)
            got = kern()
            ref = torch.autograd.grad(plain_fwd(), ins, dy)
            torch.cuda.synchronize()
            rels = []
            for gname, a, r in zip(GRAD_NAMES[name], got, ref):
                a, r = a.float(), r.float()
                if a.shape != r.shape or not bool(torch.isfinite(a).all()):
                    fail(f"{name}_bwd {gname} at C={c} {h}x{w} {tag}: shape "
                         f"{tuple(a.shape)} vs {tuple(r.shape)} or not "
                         "finite")
                err = (a - r).abs().max().item()
                rels.append((err / max(r.abs().max().item(), 1e-30), gname))
                worst = max(worst, err)
            rel, gname = max(rels)
            tol = GRAD_TOL[tag]
            print(f"{name}_bwd C={c} {h}x{w} heads={nh} batch {batch} {tag}: "
                  "max_abs/max|ref| " + " ".join(
                      f"{n} {v:.2e}" for v, n in rels) +
                  f"; worst {gname} {rel:.3e} tol {tol:.0e} "
                  f"{'ok' if rel <= tol else 'FAIL'}", flush=True)
            if rel > tol:
                fail(f"{name}_bwd {gname} disagrees with the plain backward "
                     f"at C={c} {h}x{w} {tag}")
            if timed and dt == torch.bfloat16:
                ms = median_ms(kern, reps=10)
                y_ref = plain_fwd()
                pms = median_ms(lambda: torch.autograd.grad(
                    y_ref, ins, dy, retain_graph=True), reps=5)
                del y_ref
                bms, by = bound(*work_bwd(name, c, h, w, nh, batch, 2))
                row = timing_row(ms, pms, bms, by, 0.0)
                print(f"{name}_bwd C={c} {h}x{w} bf16 batch {batch}: kernel "
                      f"{ms}, plain autograd {pms}, bound {bms:.4f} ms "
                      f"({by}) on {card}", flush=True)
            del got, ref, ins
        torch.cuda.empty_cache()
        row["max_abs_err"] = worst
        return row

    for c, h, w, nh in EDGE_SHAPES:
        for name in bwd:
            check_bwd(name, c, h, w, nh, 2, seed=c + h + 1, timed=False)
    for c, h, w, nh in SHAPES:
        for name in bwd:
            rows[(name + "_bwd", c, h, w)] = check_bwd(
                name, c, h, w, nh, TRAIN_BATCH, seed=c + h + 1, timed=True)

    # ---- 5. the train step at full width
    # (a)-(e) run cuDNN's deterministic algorithms: (d) starts from the
    # weights the steps of (a) left, so what it reads repeats from run to run
    torch.backends.cudnn.deterministic = True
    lossfn = LossFunction("L1withColor")
    model = init_model("SpectralTransformer", seed=0,
                       compute_dtype=torch.bfloat16)
    with torch.no_grad():
        for blk in model.modules():
            if isinstance(blk, MDTA):
                blk.temperature.fill_(MODEL_TEMPERATURE)
    raw, ref = synthetic_pair_batch(TRAIN_BATCH, SIZE, seed=0)
    step = make_train_step(model, lossfn,
                           get_optimizer("adam", model.parameters(), LR))
    step(raw, ref)  # warm-up: cuFFT plans, cuDNN algorithms
    torch.cuda.synchronize()
    for cnt in counters.values():
        cnt.clear()
    out = step(raw, ref)
    torch.cuda.synchronize()
    train_launches = {k: dict(v) for k, v in counters.items()}
    totals = {k: sum(v.values()) for k, v in train_launches.items()}
    # the forwards as in phase 3; ln_gdfn_bwd 2 a block; ln_mdta_bwd
    # BWD_LAUNCHES a slice of the batch and one a call (fused_mdta.bwd_plan)
    want = spectral_launches(TRAIN_BATCH, train=True)
    print(f"(a) launches in one train step: {totals} (the forwards as the "
          f"planners say, ln_gdfn_bwd 2 a block, ln_mdta_bwd "
          f"{fused_mdta.BWD_LAUNCHES} a slice of the batch and one a call)",
          flush=True)
    for name in counters:
        for (c, h, w), n in sorted(train_launches[name].items()):
            print(f"  {name} C={c} {h}x{w}: {n}", flush=True)
    if train_launches != want:
        fail(f"expected launches {want} in one train step, got "
             f"{train_launches}")
    loss0 = float(out["loss"])
    print(f"train step loss {loss0:.6f} grad_norm "
          f"{float(out['grad_norm']):.6f}", flush=True)
    if not (loss0 == loss0 and abs(loss0) < float("inf")):
        fail("non-finite train loss")

    def dead(name, p):
        """Zero-gradient mask of a parameter (q1X1_1, the kf half of kv
        and kv_conv), or None for a live one."""
        if "q1X1_1" in name:
            return torch.ones_like(p, dtype=torch.bool)
        if ".attn.kv." in name or ".attn.kv_conv." in name:
            m = torch.zeros_like(p, dtype=torch.bool)
            m[:p.shape[0] // 2] = True
            return m
        return None

    n_dead = 0
    for name, p in model.named_parameters():
        g, m = p.grad, dead(name, p)
        if g is None or not bool(torch.isfinite(g).all()):
            fail(f"(b) {name}: gradient missing or not finite")
        live = g if m is None else g[~m]
        if m is not None:
            n_dead += 1
            if bool(g[m].any()):
                fail(f"(b) dead parameter {name} has a non-zero gradient")
        if live.numel() and not bool(live.any()):
            fail(f"(b) {name}: the gradient is all zero")
    print(f"(b) gradients: every parameter's finite and non-zero where it "
          f"is used; {n_dead} parameters with dead parts, exactly zero "
          "there", flush=True)

    xc = normalize_u8(torch.as_tensor(raw[:CHECK_BATCH]).cuda()).permute(
        0, 3, 1, 2).contiguous()
    yc = normalize_u8(torch.as_tensor(ref[:CHECK_BATCH]).cuda()).permute(
        0, 3, 1, 2).contiguous()

    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).split(".")[1]
        model.compute_dtype = dt
        g_ref = grads_of(model, lossfn, xc, yc, False)
        rel, mx = grad_dist(grads_of(model, lossfn, xc, yc, True), g_ref)
        gone = {}
        for b in ("MDTA", "GDFN"):
            gone[b] = grad_dist(grads_of(without(b), lossfn, xc, yc, False),
                                g_ref)[0]
        tol = TRAIN_GRAD_TOL[tag]
        print(f"(c) gradients {tag}, batch {CHECK_BATCH}, kernels vs plain: "
              f"||g - g_ref||/||g_ref|| {rel:.3e} (tol {tol:.0e}), max abs/"
              f"max|g_ref| {mx:.3e}; without the MDTA branches the plain "
              f"gradients move {gone['MDTA']:.3e}, without GDFN "
              f"{gone['GDFN']:.3e}", flush=True)
        if not tol <= min(gone.values()) / 4:
            fail(f"(c) the {tag} gradient limit would not see a missing "
                 "branch")
        if not rel <= tol:
            fail(f"(c) {tag} gradients disagree with the plain model")
        torch.cuda.empty_cache()

    model.compute_dtype = torch.float32
    losses = {}
    for use in (True, False):
        m = copy.deepcopy(model)
        st = make_train_step(m, lossfn, get_optimizer("adam",
                                                      m.parameters(), LR),
                             use_kernels=use)
        losses[use] = [float(st(*synthetic_pair_batch(CHECK_BATCH, SIZE,
                                                      seed=10 + i))["loss"])
                       for i in range(3)]
        del m, st
        torch.cuda.empty_cache()
    drift = max(abs(a - b) / abs(b) for a, b in zip(losses[True],
                                                   losses[False]))
    print(f"(d) three f32 steps, batch {CHECK_BATCH}: losses kernels "
          f"{losses[True]} plain {losses[False]}, max relative difference "
          f"{drift:.3e} (tol {TRAIN_LOSS_TOL:.0e})", flush=True)
    if not drift <= TRAIN_LOSS_TOL:
        fail("(d) the f32 train losses of the kernels and the plain "
             "versions disagree")

    model.compute_dtype = torch.bfloat16
    xt =normalize_u8(torch.as_tensor(raw).cuda()).permute(0, 3, 1, 2)
    yt = normalize_u8(torch.as_tensor(ref).cuda()).permute(0, 3, 1, 2)
    g1 = grads_of(model, lossfn, xt.contiguous(), yt.contiguous(), True)
    g2 = grads_of(model, lossfn, xt.contiguous(), yt.contiguous(), True)
    torch.backends.cudnn.deterministic = False
    differ = [n for n in g1 if not torch.equal(g1[n], g2[n])]
    print(f"(e) two bf16 backward passes, batch {TRAIN_BATCH}: "
          f"{len(g1) - len(differ)} of {len(g1)} gradients bit-equal",
          flush=True)
    if differ:
        fail(f"(e) gradients differ between two passes: {differ[:5]}")
    del g1, g2, xt, yt
    torch.cuda.empty_cache()

    rates, mem = train_turns(model, lossfn, raw, ref)
    print(f"(f) train step SpectralTransformer {SIZE}x{SIZE} bf16 batch "
          f"{TRAIN_BATCH}: {sum(rates[True]) / 2:.2f} images/s with the "
          f"kernels {rates[True]}, {sum(rates[False]) / 2:.2f} with the plain "
          f"versions {rates[False]}; peak memory {mem[True]:.2f} GiB and "
          f"{mem[False]:.2f} GiB; on {card}", flush=True)

    # ---- the record
    counts = {**{k: launches[k] for k in launches},
              "ln_gdfn_bwd": train_launches["ln_gdfn_bwd"],
              "ln_mdta_bwd": train_launches["ln_mdta_bwd"]}
    kernels = [kernel_row(f"{name}[C={c},{h}x{w}]", name,
                          counts[name].get((c, h, w), 0), row)
               for (name, c, h, w), row in rows.items()]
    print(f"phases 1-5 took {time.perf_counter() - t_start:.1f} s",
          flush=True)
    kernels += ast_phase(card, SERVE_BATCH, SIZE)
    kernels += ast_train_phase(card, TRAIN_BATCH, SIZE, CHECK_BATCH)
    kernels += new_phase(card, SERVE_BATCH, SIZE)
    kernels += new_train_phase(card, TRAIN_BATCH, SIZE, CHECK_BATCH)
    kernels += eval_phase(card, run_phase(card, TRAIN_BATCH, SIZE),
                          TRAIN_BATCH)
    kernels += parallel_phase(card, TRAIN_BATCH, SIZE, CHECK_BATCH)
    kernels += context_phase(card, TRAIN_BATCH, SIZE, CHECK_BATCH)
    kernels += remat_phase(card, TRAIN_BATCH, SIZE)
    kernels += graph_phase(card, TRAIN_BATCH, SIZE)
    kernels += graph_parallel_phase(card, TRAIN_BATCH, SIZE)
    return record(torch, kernels, t_start)


def record(torch, kernels, t_start):
    """Print the kernels' JSON line, then the device record, last."""
    print(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
