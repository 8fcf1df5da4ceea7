#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dctn_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and builds every kernel of the serving, int8 serving, training,
   QAT and legacy ConvSBS paths from ``dctn_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once), printing each build time, the compiler's
   register report and the count of tensor-core instructions (HMMA, HGMMA,
   IMMA, IGMMA; ``cuobjdump -sass``) in each library; it fails if the 3xTF32
   sources (``eps_fwd``, ``eps_dcore``, ``eps_dviews_t``, ``logmatmulexp``)
   have no HMMA or HGMMA, or the int8 forward (``eps_fwd_q8``) no IGMMA
   (``wgmma`` on int8).
2. Holds each kernel against its plain PyTorch version at the layer shapes
   of the flagship, the three-EPS ``(2,4),(2,6),(2,12)`` and the deep
   ``(4,4),(3,12),(2,24)`` models at batch 128 and at small shapes (every
   factor in the matmul half; a ragged pixel count), and at the batches
   the deep model's step runs (the forward with and without t and
   ``eps_dcore`` at each layer at 512 and 2048 images, the recompute kernel
   at layer 1 at 2048), with median CUDA-event times of the kernel, the
   plain version and one library call of the same
   products on materialized operands (cuBLAS ``torch.matmul`` in f32,
   ``torch._int_mm`` in int8; the products alone, which the port never
   calls). The int8 forward's saved t must equal the plain version's bit
   for bit.
3. Drives the serving path: saves a seeded flagship ``(4,4),(3,6)`` model,
   runs ``dctn_tpu_torch.cli.predict.run`` on 1024 synthetic FashionMNIST
   images with the latency benchmark, checks that the forward kernel ran
   twice per forward and wrote no t, and checks the logits against the same
   forward on the plain version and, on a small input, against the float64
   reference-layout forward on the CPU. Then the same with
   ``--quantize int8``: only the int8 kernel runs, twice per forward, and its
   logits are as far from the f32 logits as the JAX package's own int8
   logits are on the same images, and within its int8 budget on uniform
   features.
3b. Drives export and serve: ``dctn_tpu_torch.cli.export.run`` writes
   artifacts of the same flagship, f32 and ``--quantize int8``, at batch
   sizes 1 and 128, and of the 2-layer bond-4 ConvSBS model (the legacy
   runner's recipe) at 1 and 100, all on the card; ``load_artifact`` loads
   each. Checks: one ``dctn_tpu_torch::eps_fwd`` (``eps_fwd_q8``) node per
   EPS layer and one ``sbs_fwd`` per string in the graphs, the launches per
   forward (2 K1 without t, 2 K8, the ConvSBS forward's as the eager
   model's), the logits against the eager model's within 1e-6 of the
   largest (the reading and whether the bits are equal printed);
   ``predict.run`` on both flagship artifacts with the latency bench beside
   phase 3's npz numbers, and the artifact against the npz model in turns
   with a host profile of each at batch 128 (host ms per call, and cProfile's
   costliest Python functions); ``serve.make_server`` on a
   free port: 128 images and 300 (chunked, padded) against direct calls, a
   bad body answered 400, the HTTP round trip's p50 at batch 1 and 128 (f32
   and int8), 16 concurrent batch-1 clients with micro-batching (2 ms)
   taking fewer than 16 device calls (K1's counter) with each client's
   logits beside its direct call, and graceful shutdowns. One
   ``export_serve`` JSON line. K1, K8 and K10's entries in the kernels line
   name the operator through which an artifact reaches them.
4. Drives the training path: ``dctn_tpu_torch.bench.run`` takes Adam steps
   of the flagship at batch 128 on the kernels and on the plain path, and
   the script checks the kernels' launches per step, the gradients of one
   step against the plain path's, a 3-step trajectory at batch 4 against the
   float64 step on the CPU, and that the losses are finite. Then the same
   bench with ``qat="int8"`` (int8 forward, straight-through f32 backward):
   launches per step, one step's gradients against the plain QAT path's,
   finite losses. Then the three-EPS model at batch 128, f32 and QAT, whose
   later layers take the recompute backward (2 launches of
   ``eps_dviews_recompute`` per step, no t saved), launches and gradients
   against the plain path. Then the deep model's published step (Adam
   1e-3, composition regularizer 1e-1) at batch 2048, on the kernels only,
   at ``grad_accum_steps`` 1 (its middle layer's t is over the saved-t cap:
   the recompute arm) and 4 (what ``"auto"`` resolves to: every later layer
   saves t), launches per step against the arms, and one step's gradients
   at 1 against those at 4 for the weights of two seeds.
4b. Drives the EPS runner, ``dctn_tpu_torch.cli.runner.run``: the README
   quick start (the flagship at batch 128, Adam 3e-3, the empirical init,
   synthetic data at the runner's default sizes) for 60 iterations with
   evals every 20, checking its launches against the count its steps,
   evals and init make, finite losses and eval lines, its last and best
   checkpoints (the last equal to the final params), the final checkpoint's
   logits against the plain forward, and that a run resumed from the train
   state at iteration 40 ends on the unbroken run's bits; it prints the ms
   per iteration and per eval and the step's device idle share. Then three
   short runs: ``--qat int8`` (K8/K9, the quantized evals), ``--dropout-p
   0.9 --freeze-eps 1`` (layer 1's d_views kernel alone, the frozen core
   unchanged) and ``--ds-type cifar10_rgb`` (Q₀ = 3; logits against the
   plain forward).
4c. The runners' tooling: the quick start for 30 iterations with
   ``--tb-batches --log-intermediate-outputs --profile-dir`` (window 10 5):
   launches exact with the intermediate outputs' K1 launches, the
   metrics.jsonl records of each scheduled iteration, a trace naming K1+t,
   ``eps_dcore`` and the d_views kernel, the ms of each logging hook and of
   the profiled iterations. Then ``--train-backend xla --eval-backend xla``
   for 10 iterations at lr 1e-4: no EPS kernel launched, each parameter's
   move within 1e-2 (L2) of the kernel path's from the same init.
   Then the ConvSBS kernels (phase 2b, before phase 3): the forward and
   the backward (d_views both ways) of the meet-in-the-middle fold (K10,
   K11) and of the sequential fold (K12) against their plain versions at
   both layer shapes of the legacy 2-layer bond-4 model, open strings and
   rings, batch 100 and 512, and every merge position at one shape, with
   kernel, plain and bound times; the forward's route (the register
   kernel for every legacy string) and its library time (one
   ``torch.einsum`` over the string's views and cores; no single library
   call folds the backward: its library column is null); at batch 512 the
   backward gives the same bits on a second run. Then a string outside the
   register route (layer 1's ring with its outputs on two cores, at layer
   1's pixels at batch 100) holds the forward's shared-memory kernel against
   the plain fold, both families, at every merge position. Phase 1 fails if
   an instantiation of the forward's register route spills.
6. Drives the legacy ConvSBS family: ``dctn_tpu_torch.cli.legacy_runner.run``
   on synthetic data (2 layers, bond 4, batch 100, 2 epochs; SGD and RMSprop
   with momentum; open strings and ``--trace-edge`` rings), checking its
   launches (per step three forwards, three backwards of which layer 1's
   writes d_views, three d_core sums) and its best checkpoint; one step's
   gradients (cores and pixels) on the kernels against the plain path at
   batch 100, and 3 SGD steps at batch 4 against the float64 CPU step.
   The runs take the runner's defaults (TB logging at epoch 0, its probe's
   gradients through K10/K11; ``--preempt-save``); then one with
   ``--tb-log-every-n-epochs 1`` (its records at both epochs), one stopped
   mid-epoch with its train state saved, and that state resumed: the
   resumed run ends on the unbroken run's bits.
7. ``dctn_tpu_torch.bench.run_conv_sbs``, the step of
   experiments/conv_sbs_benchmark.py, at batch 100 and 512, open and ring,
   on the kernels and the plain path: launches per step and over the run,
   finite losses. Then the sequential fold's path (K12): the model's layers
   with every string through ``kernels.sbs_kernels.conv_sbs_t(mim=False)``,
   SGD steps at batch 100 on the runner's recipe, open and ring: launches per step, one step's
   gradients against the plain path's, the logits against the model's own
   (meet-in-the-middle) forward.
   Then K13, the fused log-space product (phase 2c, before phase 3),
   against its plain version: a link of the log-matmul chain (256³), the
   log-space classifier's step on its real operands ((256, 98) features ×
   the (98, 490) block-diagonal weights, −inf off the blocks), the large-R
   regime (256, 32768, 256), ragged edges (100, 60, 37), offsets of ±80,
   and rows, columns and entries of −inf (the outputs there exactly −inf,
   no NaN anywhere, the same bits on a second run, the largest share of the
   per-entry limit printed), with kernel, plain, library (``torch.matmul``
   of the materialized exponentials) and bound times; K13's shifts kernel
   equal to ``max_shifts`` bit for bit at every case, and one forward of
   ``logmatmulexp_kernel`` two launches (shifts, product) and two device
   kernels.
8. ``dctn_tpu_torch.bench.run_logmatmulexp``, the chain of
   experiments/logmatmulexp_benchmark.py (6 × 256×256 f32, plain matmul and
   three log-space forms, forward and the gradients of all six): K13 and
   its shifts kernel launched 5 times each per forward and per
   forward+backward of the kernel form; the chain's output and six
   gradients against the plain max-shift form.
9. ``dctn_tpu_torch.bench.run_log_space``, the log-space classifier of
   experiments/log_space_classifier.py at its defaults (600 Adam 3e-2 steps
   at batch 256): K13 and its shifts kernel launched once each per
   ``fused_kernel`` step and once for its accuracy forward; the three forms
   within 0.02 in accuracy, finite weights; one step's gradient against
   ``fused_plain``.
5b. Data parallelism (``dctn_tpu_torch.parallel``) at world size 1 through a
   real ``nccl`` process group: the DP fast step, QAT step and ConvSBS step,
   3 steps each beside the single-device steps from one init, parameters and
   losses bit for bit, with their launches per step; the sharded score; a
   sharded artifact at N = 1 (its device-free program placed on the card at
   load) bit-equal to the eager model, served by ``serve.ArtifactModel`` and
   ``predict.run``. With two or more cards it runs ``python -m
   dctn_tpu_torch.multichip --devices min(4, count)`` and fails with it; on
   one card it prints that it did not run.
5c. Tensor and spatial parallelism and SP x TP (``parallel.tensor_parallel``,
   ``parallel.spatial_parallel``, ``parallel.sp_tp``): (a) K1 ± t,
   ``eps_dcore``, ``eps_dviews_t`` and K8/K9 at the shapes a grid rank gives
   the flagship's layers at batch 128 (layer 1 on the cmt row block of 2
   and 3 model ranks; each layer on the slab of 2 and 4 space ranks; under
   SP x TP layer 1 on the slab of 2 and 4 space ranks at the row block of
   2 model ranks), each against its plain version, with the launch plan
   each takes; (b) on the card, f32 and QAT, each row block's layer output
   against the O-slice of the whole layer and the shards' partial logits
   summed against the one-card logits, each space rank's slab outputs
   against the whole layers' rows and the row-sliced classifier's partial
   logits summed against the one-card logits, and on (space 2, model 2)
   each rank's layer 1 against its rows and O-slice of the whole layer bit
   for bit and the four partial logits summed against the one-card logits;
   (c) the SP x TP, TP-fast and SP-fast steps on a grid of one rank through
   a real ``nccl`` group, f32 and QAT, each in float32 and in bf16
   operands, bit-equal to the single-device steps with their launches;
   (d) the flagship's height-sharded artifact (``export.run
   --space-devices 2`` and ``4``, and with ``--compute-dtype bfloat16`` at
   2): one K1 node per EPS layer, refused by ``load_artifact`` on one
   card, and, every band on this card, one K1 launch (its bf16 mode in the
   bf16 artifact) a band and layer, its logits against one card's artifact
   in the same dtype and each band's layer rows against the whole
   image's. With two or more cards, phase 5b's multichip subprocess
   runs the TP, SP and (from 4 cards) SP x TP paths and the height-sharded
   artifact across them.
10. The autotuners (``dctn_tpu_torch.train.autotune``) on the card: the
   split tuner on the flagship at batch 128 under each objective (training
   f32, QAT, serving f32, serving int8; each candidate's ms, the pick and
   the default printed, the tune's seconds); a repeat of the four tunes
   from a temporary cache measures nothing (the measurer's calls counted)
   and its keys name the card; 3 Adam steps at the training picks against
   3 at the default splits from the same weights, within REL_TOL;
   ``export.run --autotune-splits`` f32 and int8 (serving picks from that
   cache), each artifact's logits against the eager model at its splits
   within 1e-6 of the largest. The accumulation tuner on the deep model at
   batch 2048 (the saved-t cap's pick 4: candidates 4, 8, 16, each step's
   ms printed), and the runner's ``"auto"`` taking its winner. The ConvSBS
   tuner on the legacy recipe (2 layers, bond 4) at batch 100, open and
   ring, training objective (each candidate, the whole-model gate, the
   picks), and 3 SGD steps at the picks against 3 at the heuristics within
   the ConvSBS trajectory tolerance. One ``autotune`` JSON line; the
   tuners' launches count in the kernels line.
11. The bf16 operand mode (``compute_dtype=torch.bfloat16``): (a) each
   kernel's bf16 mode (K1 ± t, ``eps_dcore``, ``eps_dviews_t``,
   ``eps_dviews_recompute``) against its plain bf16 version at both flagship
   layers (the recompute form forced at layer 1) and the three-EPS model's
   layers 1 and 2 at batch 128, within REL_TOL (the saved bf16 t within one
   bf16 step), and against the float32 kernel on the same inputs, which
   must differ by more (the negative control), with kernel, plain, library
   (``torch.matmul`` on bf16 operands) and bound times; the bf16 plans'
   shared memory in Python against the sources' C queries; ``eps_dcore``'s
   bf16 mode over 6 chunks of pixels (its operands' scratch capped small:
   several slices, a short ragged last chunk) against its plain version,
   the same bits twice; (b) ``runner.run``
   with ``--compute-dtype bfloat16`` (the README quick start, 10 iterations,
   launches exact, final logits against the plain bf16 forward), and the
   three-EPS bench step in bf16 (the recompute arm); (c) the deep model's
   step at batch 2048 with ``grad_accum_steps="auto"`` (2 in bf16; its
   layer 1's ``eps_dcore`` in 9 chunks of pixels, counted); (d) a
   bf16 artifact exported, loaded (one K1 node a layer, the bf16 mode's
   launches), its logits the eager bf16 model's bits, ``predict.run`` and
   a served request from it; (e) the flagship's f32 and bf16 step and
   forward p50 in turns (f32, bf16, bf16, f32); (f) K9 storing its t in
   bf16 (the bf16 QAT step's) against its plain version at flagship layer
   1, a TP and an SP shard's layer 1 and a layer only its mma.sync kernel
   takes: t bit-equal to the plain version's and to the float32 K9's t
   rounded, out bit-equal to the float32 K9's, both kernels run, with
   kernel, plain, library (``torch._int_mm``) and bound times and the
   float32 K9 in the same turns; (g) the flagship's bf16 QAT step through
   ``bench.run`` (launches exact), one step's gradients on the kernels
   against the plain bf16 QAT bundle within BF16_QAT_GRAD_TOL, 3 Adam steps
   at 1e-4 against it, its forward logits the float32 QAT forward's bits;
   (h) the flagship QAT step p50, f32 and bf16, in turns. One ``bf16`` JSON
   line (the bf16 QAT numbers under ``qat``).
12. Where the port falls back as the JAX package does: ``runner.run`` with
   ``--epses-specs "(5,4)"`` (a layer outside the kernels' plans) trains 4
   SGD steps at batch 16 on the reference layout, no EPS kernel launched,
   both fallbacks in run_info.txt, its logits the plain path's; then
   ``legacy_runner.run`` at bond 12 (outside the ConvSBS kernels' scope)
   trains an epoch on the plain folds, no ConvSBS kernel launched, the
   fallback in run_info.txt, the trained model's logits on the card within
   REL_TOL of the CPU plain fold's.
12b. With ``--profile DIR`` only: the device-time breakdown (``torch.profiler``)
   of the serving forward (f32 and int8) at batch 1 and 128 and of the
   flagship training step (f32, QAT and bf16) at batch 128, on the kernel and on
   the plain path, and of the deep model's step at batch 2048 (accumulation
   1 and 4) on the kernels, and of the ConvSBS step at batch 100 (open, ring)
   and 512 (open, ring) on the kernel and the plain path, with the device's busy
   share and extra memory; and of the log-matmul chain's forward+backward
   (kernel form, ops form, matmul) and one log-space classifier step
   (fused_kernel, fused_plain, scan), with the device's busy share; the
   full profiler tables go to DIR.
13. Prints one JSON line describing the kernels (each entry's ``timed_by``
   says whether its times are one call between CUDA events, the host's
   work included, or device time per call under torch.profiler; a shape
   whose window shows no device time in PROFILE_TRIES tries is timed by
   CUDA events, and an entry with shapes of both ways says
   ``cuda_events+device_time``), then the result line.

Every count of kernel launches is set to 0 just before a path is driven and
read just after it.

Any failure exits nonzero before the result line; without a CUDA device it
exits nonzero at once. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FLAGSHIP = ((4, 4), (3, 6))
BATCH = 128
SEED = 0
# kernel against plain: both sides are float32 and only the summation order
# differs (sums of 256-1536 terms in the forward and d_views, of up to 80,000
# pixels in d_cmt; the forward, eps_dcore and the d_views kernel multiply in
# 3xTF32 on the tensor cores, which keeps float32 accuracy), far inside 1e-4
# of the largest entry
REL_TOL = 1e-4
# the float32 kernel path against the float64 CPU step, 3 Adam steps at
# batch 4 and lr 1e-4 (at the bench's 3e-3 the randomly initialized
# flagship diverges, loss 36 → 1.5e8 in one step at batch 16, and float32
# and float64 part ways however right the arithmetic is). Adam moves a
# parameter by lr·m/(√v + 1e-8), so one whose gradient is as small as
# Adam's ε, and so relatively imprecise in float32, can take a step up to
# 2·lr away from the float64 one: the parameters are compared in norm,
# ||Δ|| <= 1e-2·||p_64 - p_0|| (room for a few entries of each layer to
# step apart all three times), and the losses to rtol 1e-3 (the random-init
# logits are in the hundreds, so the loss amplifies every small difference).
TRAJ_RTOL = 1e-3
TRAJ_NORM_TOL = 1e-2
TRAJ_LR = 1e-4
TRAIN_STEPS = 20
# the repo's three-EPS QAT family (experiments/qat_value.py:35-37) and the
# deep three-EPS model of experiments/three_epses_benchmark.py, whose step
# is Adam 1e-3 with the composition regularizer at 1e-1
THREE = ((2, 4), (2, 6), (2, 12))
DEEP = ((4, 4), (3, 12), (2, 24))
DEEP_BATCH = 2048
DEEP_LR = 1e-3
DEEP_REG = ("epses_composition", 1e-1)
DEEP_STEPS = 3
# one step's gradients of the deep model at accum 1 against accum 4 (the
# same weights and batch; the sums over pixels in other orders, and layer
# 1's d_views from a recomputed rather than a saved t), for the weights of
# each seed in DEEP_ACCUM_SEEDS. The limit comes from readings of the
# largest max|Δ|/max|ref| over the gradients on an H100 (PERF.md §6): 5.604e-6
# for seed 0 and 4.134e-6 for seed 1, both at the classifier's bias (a mean
# over 2,048 images summed in another order; the EPS cores' gradients
# 6.7e-8 to 2.3e-7), so 3e-5, 5.4 times the largest. The recompute kernel
# itself is held at this shape within REL_TOL in phase 2
# (kernels_at_deep_batch).
DEEP_ACCUM_SEEDS = (0, 1)
DEEP_ACCUM_TOL = 3e-5
# the EPS runner's phase: the README quick start (the flagship, batch 128,
# Adam 3e-3, the empirical init, synthetic data at the runner's default
# sizes) for RUN_ITERS iterations with evals every RUN_EVAL_EVERY, a resume
# from the train state at RUN_RESUME_AT, then three short runs (int8 QAT;
# dropout with layer 1 frozen; colored CIFAR, Q₀ = 3, whose first layer
# takes K1's mma.sync kernel, s = 9) of RUN_SHORT_ITERS iterations on
# RUN_SHORT_SIZES images, evals every RUN_SHORT_EVAL_EVERY. A (4,4) first
# layer on Q₀ = 3 has a 3^16 × 4 core, so the colored run takes (2,4),(3,6).
RUN_ITERS = 60
RUN_EVAL_EVERY = 20
RUN_RESUME_AT = 40
RUN_SIZES = (8192, 2048, 2048)
RUN_SHORT_ITERS = 10
RUN_SHORT_EVAL_EVERY = 5
RUN_SHORT_SIZES = (1024, 256, 256)
RGB_SPECS = ((2, 4), (3, 6))
RUN_PROFILE_STEPS = 10
# the runners' tooling (phase 4c): the README quick start for RUN_TB_ITERS
# iterations with --tb-batches, --log-intermediate-outputs and a profiled
# window of RUN_PROFILE_ITERS, evals every RUN_TB_EVAL_EVERY (so that no
# eval falls inside the window); the intermediate outputs' probe is the
# first RUN_PROBE training images. Then the xla backends against the kernel
# path for RUN_SHORT_ITERS iterations from one theoretical init at TRAJ_LR:
# each parameter's move within TRAJ_NORM_TOL of the kernel path's, in L2
# (float32 sums in other orders; Adam's update is ±lr wherever a gradient's
# sign flips between them, which an L2 share tolerates and max|Δ| would not).
RUN_TB_ITERS = 30
RUN_TB_EVAL_EVERY = 15
RUN_PROFILE_ITERS = (10, 5)
RUN_PROBE = 64
# the 16 records each intermediate-outputs log writes: 5 transforms of
# eps_0, eps_1 and linear, and linear's logits as probabilities
INTERMEDIATE_RECORDS = 16
# K1+t, eps_dcore and the d_views kernel in a runner trace (torch.profiler's
# demangled names)
TRACE_KERNELS = (r"eps_fwd_\w*kernel<true>", r"eps_dcore_kernel", r"eps_dviews_kernel")
# the int8 path against the plain int8 path: a last-bit difference in layer
# 0's f32 sums can move one of layer 1's u/su over a rounding boundary and
# its uq by one step (1/127 of that pixel's scale), so logits are held to
# 1e-3 of the largest
Q8_LOGIT_TOL = 1e-3
# int8 logits against f32 ones, relative L2. On the images predict.run
# serves (the first 128), the JAX package's own int8 forward is Q8_SERVED_REF
# from its f32 forward on the same seeded model
# (tests/test_torch_port_q8.py::test_served_int8_noise_limit_is_the_jax_reading
# holds this constant to that reading); the card's int8 path is held within
# Q8_SERVED_TOL of it, room for the uq steps that a kernel's summation order
# can move (Q8_LOGIT_TOL). On features uniform on [0, 2), the inputs of the
# JAX package's own test (tests/test_quantized.py:134-142), its budget 0.05.
Q8_SERVED_REF = 0.051360
Q8_SERVED_TOL = 1e-3
Q8_BUDGET = 0.05
# an H100 SXM at its 700 W limit (NVIDIA's data sheet): float32 outside the
# tensor cores, dense int8 on the tensor cores, and HBM3. The f32 kernels'
# matrix products are counted at the card's fastest float32-accurate rate,
# 3xTF32 on the tensor cores (three TF32 products per hi/lo split pair,
# csrc/tf32x3.cuh): a third of the 495 TFLOP/s dense TF32 peak; the bf16
# mode's (csrc/bf16.cuh) at the dense bf16 peak, 989. Their elementwise
# float32 work stays at the CUDA cores' 67.
F32_PEAK_FLOPS = 67e12
TF32X3_PEAK_FLOPS = 495e12 / 3
BF16_PEAK_FLOPS = 989e12
INT8_PEAK_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12
KERNELS = {
    "eps_fwd": {
        "route": "cuda", "source": "dctn_tpu_torch/csrc/eps_fwd.cu",
        "replaces": "dctn_tpu/pallas/eps_pallas.py:227",
    },
    "eps_fwd_t": {
        "route": "cuda", "source": "dctn_tpu_torch/csrc/eps_fwd.cu",
        "replaces": "dctn_tpu/pallas/eps_pallas.py:238",
    },
    "eps_dcore": {
        "route": "cuda", "source": "dctn_tpu_torch/csrc/eps_dcore.cu",
        "replaces": "dctn_tpu/pallas/eps_pallas.py:348",
    },
    "eps_dviews_t": {
        "route": "cuda", "source": "dctn_tpu_torch/csrc/eps_dviews_t.cu",
        "replaces": "dctn_tpu/pallas/eps_pallas.py:303",
    },
    "eps_fwd_q8": {
        "route": "cuda", "source": "dctn_tpu_torch/csrc/eps_fwd_q8.cu",
        "replaces": "dctn_tpu/pallas/eps_pallas_q8.py:98",
    },
    "eps_fwd_q8_t": {
        "route": "cuda", "source": "dctn_tpu_torch/csrc/eps_fwd_q8.cu",
        "replaces": "dctn_tpu/pallas/eps_pallas_q8.py:116",
    },
    # K4's d_views half; K6 without t (eps_pallas.py:391) is the same kernel
    "eps_dviews_recompute": {
        "route": "cuda", "source": "dctn_tpu_torch/csrc/eps_dviews_t.cu",
        "replaces": "dctn_tpu/pallas/eps_pallas.py:254",
    },
}
# the legacy ConvSBS family: the 2-layer bond-4 model of
# experiments/conv_sbs_benchmark.py, whose six strings all fold
# meet-in-the-middle at core 4 (_mim_cut); the sequential fold (K12) is
# conv_sbs_t(mim=False) on the same strings
SBS_LAYERS = 2
SBS_BOND = 4
SBS_BATCHES = (100, 512)
SBS_MCUT = 4
SBS_KERNELS = {
    "sbs_fwd_mim": {
        "route": "cuda", "source": "dctn_tpu_torch/csrc/sbs_fwd.cu",
        "replaces": "dctn_tpu/pallas/sbs_pallas.py:430",
    },
    "sbs_fwd_seq": {
        "route": "cuda", "source": "dctn_tpu_torch/csrc/sbs_fwd.cu",
        "replaces": "dctn_tpu/pallas/sbs_pallas.py:256",
    },
    "sbs_bwd_mim": {
        "route": "cuda", "source": "dctn_tpu_torch/csrc/sbs_bwd.cu",
        "replaces": "dctn_tpu/pallas/sbs_pallas.py:471",
    },
    "sbs_bwd_seq": {
        "route": "cuda", "source": "dctn_tpu_torch/csrc/sbs_bwd.cu",
        "replaces": "dctn_tpu/pallas/sbs_pallas.py:281",
    },
}
KERNELS = {**KERNELS, **SBS_KERNELS}
# ConvSBS kernel against plain: both float32, the sums in other orders (per
# pixel over ≤ 160 bond and output terms, through 9 fold steps; in d_cores
# over up to 346,112 pixels). The largest max|Δ|/max|ref| read on an H100
# (PERF.md §6): 3.51e-7 forward, 3.105e-6 backward (a d_core of layer
# 1's ring at batch 512, sequential fold), so 1e-5, 3.2 times the largest
SBS_TOL = 1e-5
# one step's gradients, kernel path against plain path (the d_cores of the
# three strings and the pixels' gradient through layer 0's d_views): largest
# reading 3.04e-6 (open) and 2.55e-6 (ring), so 1e-5
SBS_GRAD_TOL = 1e-5
# the forward's times in phase 2b are its device time per call over this many
# calls under torch.profiler (a register-route launch takes 6–34 µs of device
# time at the legacy shapes on an H100, less than the wrapper's host work)
SBS_FWD_PROFILE_CALLS = 10
# 3 SGD steps (momentum 0.9, lr 1e-2) of the float32 kernel path against
# the float64 plain step on the CPU at batch 4, the runner's recipe
# (sin²/cos², window-std multiplier, layers scaled to unit std): losses and
# every core within this share of the float64 value (of max|p| for a core).
# float32 rounds each state to ~6e-8; the losses read on an H100 agree to
# 1e-7 (PERF.md §6), and plain SGD carries no step-size amplification (unlike
# Adam's 1/√v), so 1e-4 leaves room for the 9-step folds' cancellations
SBS_TRAJ_LR = 1e-2
SBS_TRAJ_RTOL = 1e-4
# the runner phase: synthetic train/val sizes and epochs at batch 100
SBS_RUN_SIZES = (1000, 200)
SBS_RUN_EPOCHS = 2
# the legacy runner's TB logging (on by default every 10 epochs: epoch 0 of
# every run above) forwards and backwards its probe batch (one training
# step's launches) and forwards it once more for the strings' outputs; the
# resume check stops after SBS_STOP_AFTER steps, mid-epoch 1
SBS_STOP_AFTER = 15
# K13, the fused log-space product of the log-matmul chain bench and the
# log-space classifier (experiments/logmatmulexp_benchmark.py,
# experiments/log_space_classifier.py)
LME_KERNELS = {
    "logmatmulexp": {
        "route": "cuda", "source": "dctn_tpu_torch/csrc/logmatmulexp.cu",
        "replaces": "dctn_tpu/pallas/logmatmulexp_pallas.py:32",
    },
    # the shifts `_forward` computes around K13's pallas_call (:53-57)
    "logmatmulexp_shifts": {
        "route": "cuda", "source": "dctn_tpu_torch/csrc/logmatmulexp.cu",
        "replaces": "dctn_tpu/pallas/logmatmulexp_pallas.py:53",
    },
}
KERNELS = {**KERNELS, **LME_KERNELS}
# phase 11: the bf16 operand modes of K1 ± t, eps_dcore and both d_views
# forms, each its own kernel in the source of its float32 mode
BF16_KERNELS = {
    f"{name}_bf16": meta for name, meta in KERNELS.items()
    if name in ("eps_fwd", "eps_fwd_t", "eps_dcore", "eps_dviews_t", "eps_dviews_recompute")
}
# K9 storing its t in bf16: the bf16 QAT step's (eps_pallas_q8.py:297)
BF16_KERNELS["eps_fwd_q8_t_bf16"] = {
    "route": "cuda", "source": "dctn_tpu_torch/csrc/eps_fwd_q8.cu",
    "replaces": "dctn_tpu/pallas/eps_pallas_q8.py:116",
}
KERNELS = {**KERNELS, **BF16_KERNELS}
# a bf16 kernel against its plain bf16 version: both round the same
# float32 operands (formed in the same order) to the same bf16 values, and
# bf16 products are exact in float32, so the two differ only in the order of
# their float32 sums: REL_TOL. K1's saved t is itself stored in bf16,
# rounded from sums in two orders, so an entry may land one bf16 step apart
# (2^-7 of its size at most; REL_TOL of the largest beside). The negative
# control: the float32 (3xTF32) kernel on the same inputs differs from the
# bf16 result by more than REL_TOL of the largest, or the mode did not round.
BF16_STEP = 2.0**-7
# the runner in bf16 (phase 11 b): the README quick start, these many
# iterations, one eval past the first
BF16_RUN_ITERS = 10
# phase 11 (a): the bf16 eps_dcore in chunks at the flagship's layer 1 at
# 127 images (67,183 pixels, no multiple of 64), its operands' scratch
# capped to chunks of 209 steps of 64 pixels: 6 chunks, the last of 303
# pixels (5 steps, so the sixth slice has none of it)
BF16_CHUNK_IMAGES = 127
BF16_CHUNK_STEPS = 209
# and K1 bf16 +- t there in chunks of 100 tiles of 128 pixels (its u's
# scratch capped): 6 chunks, the last of 3,183 pixels (a ragged last tile)
BF16_FWD_CHUNK_TILES = 100
# the f32 and bf16 flagship steps and forwards timed in turns (phase 11 e)
BF16_TURN_STEPS = 20
# phase 11 (f): K9 with a bf16 t at these shapes beside flagship layer 1 at
# batch 128: a TP and an SP shard's layer 1 (``grid_shard_shapes``), layer
# 1's dims at 1,058 pixels (npix % 8 = 2: t copied out of its staging in
# 16-byte units, smem_vec) and at 1,000 (the TMA's last box clipped), a
# layer on the staged route (B2 = 6) and one that only the mma.sync kernel
# takes (A = 676): every store route of the bf16 t (``_q8_plan``'s t_store)
BF16_Q8_SHARDS = ("TP layer 1, O=3 (model 2)", "SP layer 1, 14 rows (space 2)")
BF16_Q8_EDGES = (
    ("layer 1 dims, 1,058 pixels", 9, 4, 5, 6, 2 * 529),
    ("layer 1 dims, 1,000 pixels", 9, 4, 5, 6, 1000),
    ("staged route, B2 = 6", 3, 6, 2, 5, 4000),
)
BF16_Q8_MMA_SYNC = ("mma.sync route, A = 676", 2, 26, 2, 3, 4000)
BF16_Q8_ROUTES = {"tma", "smem_vec", "staged_vec", "mma.sync"}
# the flagship's bf16 QAT step (phase 11 g): its gradients on the kernels
# against the plain bf16 QAT bundle's at batch 128. Both forwards are the
# same int8 products and store the same bf16 t (K9's is the plain
# version's, bit for bit), and the bf16 backward's kernels hold their plain
# versions at REL_TOL (phase 11 a); what can differ more is an operand the
# backward rounds to bf16 after float32 sums taken in other orders (layer
# 0's kr2 = g·v, from layer 1's d_views): one bf16 step (2^-8) in the
# entries that straddle a rounding boundary, averaged over the 80,000
# pixels of layer 0's d_cmt. Predicted before the first card run: within
# 1e-3 of the largest entry (the CPU's flagship at 8 images, whose d_cmt
# sums 200 pixels, reads up to 6e-3, tests/test_torch_port_bf16.py)
BF16_QAT_GRAD_TOL = 1e-3
# the export and serve phase (3b): the seeded flagship exported f32 and int8
# at ART_BATCHES, the ConvSBS model at SBS_ART_BATCHES; a loaded artifact's
# logits against the eager model's on the same weights and images. The same
# kernels run on the same operands behind the same glue ops, so equal bits
# are expected; ART_TOL of the largest logit leaves room only for a glue op
# the traced graph computes otherwise (the reading is printed).
ART_BATCHES = (1, BATCH)
SBS_ART_BATCHES = (1, 100)
ART_TOL = 1e-6
ART_AB_CALLS = 200  # fenced calls of each, eager and artifact in turns
ART_PROFILE_CALLS = 20  # calls timed without a fence (< the launch queue) and profiled
HOST_PROFILE_ROWS = 12
HTTP_CALLS = 30
MICROBATCH_CLIENTS = 16
MICROBATCH_WAIT_MS = 2.0
# a micro-batched client is served by the batch-128 entry and its direct call
# by the batch-1 one: other shapes of the classifier's product (3,174
# features), whose library kernels sum in other orders: the largest reading
# was 4.381e-7 of the direct call's largest logit on an H100 (PERF.md §6),
# 8.9e-7 on a CPU, so 1e-5
MB_TOL = 1e-5
# the kernels an exported artifact reaches through its registered operators
ARTIFACT_OPS = {"eps_fwd": "dctn_tpu_torch::eps_fwd", "eps_fwd_q8": "dctn_tpu_torch::eps_fwd_q8",
                "sbs_fwd_mim": "dctn_tpu_torch::sbs_fwd"}
for _name, _op in ARTIFACT_OPS.items():
    KERNELS[_name]["artifact_op"] = _op
# (label, Θ, R, I, offset of A (B gets its negative), −inf rows, columns and
# entries): a chain link (5 per chain forward), the classifier's step (its
# real operands: features and the block-diagonal weights, −inf off the
# blocks), the large-R regime the JAX kernel was validated at, ragged edges,
# and the extremes
LME_SHAPES = (
    ("chain link", 256, 256, 256, 0.0, False),
    ("classifier step", 256, 98, 490, None, None),
    ("large R", 256, 32768, 256, 0.0, False),
    ("ragged", 100, 60, 37, 0.0, False),
    ("offsets +-80", 256, 256, 256, 80.0, False),
    ("-inf rows, columns, entries", 100, 60, 37, 0.0, True),
    ("-inf and offsets +-80", 256, 98, 490, 80.0, True),
)
# K13 against its plain version, per entry of the log: both float32, the sum
# over R in other orders (the kernel's 32-wide chunks and its split of R
# against cuBLAS's blocking), so log(sum) differs by about √R·2⁻²⁴ (a random
# walk of R roundings, each a relative 2⁻²⁴; the kernel's 3xTF32 products,
# good to about 2⁻²² each, are all ≥ 0 and cancel nothing, so they stay
# inside the walk term at every R ≥ 1), and adding the shifts rounds
# at an ulp of log(sum) + amax and of the output, whose magnitudes |amax| +
# |bmax| and |ref| bound: |Δ| ≤ 16·2⁻²⁴·√R + 8·2⁻²⁴·max(|ref|, |amax| +
# |bmax|), 16 times the walk and 8 half-ulps. −inf only where the plain
# version has it, no NaN.
LME_WALK = 16
LME_ULPS = 8
# gradients, kernel path against the plain max-shift path: both run the same
# torch ops in the backward; only the forward's sums differ, which the chain
# carries through 5 products and the square of its output (and the
# classifier through its 49-factor sum), so 1e-4 of the largest
LME_GRAD_TOL = 1e-4
# K13's calls take a few µs of device time at the entries' shapes, less
# than the host takes to launch them: its times are the device time per call
# over this many calls under torch.profiler (the CUDA-event time of one call,
# the host's launch included, is printed beside them)
LME_PROFILE_CALLS = 20
SOURCES = ("eps_fwd", "eps_dcore", "eps_dviews_t", "eps_fwd_q8", "sbs_fwd", "sbs_bwd",
           "logmatmulexp")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# how the times of a kernel's entry in the kernels line were taken: the
# median of one call between two CUDA events (the wrapper's host work
# included), or device time per call under torch.profiler (the kernels alone)
CUDA_EVENTS = "cuda_events"
DEVICE_TIME = "device_time"


def median_ms(fns, reps: int):
    """Median CUDA-event time of each function, run in turns."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [statistics.median(ts) for ts in times]


def tensor_core_instructions(path) -> dict:
    """The tensor-core instructions in a built library's SASS (``cuobjdump
    -sass`` of the toolkit that built it), per function (its mangled name):
    counts of HMMA (mma.sync on f16/bf16/tf32), HGMMA (wgmma on them), IMMA
    (int8 mma.sync) and IGMMA (int8 wgmma)."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    return {name: count_tensor_core_ops(body)
            for name, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass, re.S)}


def count_tensor_core_ops(sass: str) -> dict:
    ops = re.findall(r"\b(HMMA|HGMMA|IMMA|IGMMA)\b", sass)
    return {op: ops.count(op) for op in ("HMMA", "HGMMA", "IMMA", "IGMMA")}


def summed_ops(per_function: dict, fragment: str = "") -> dict:
    """The tensor-core instructions of the functions whose mangled name
    holds ``fragment`` (every function's where it is empty), summed."""
    return {op: sum(c[op] for name, c in per_function.items() if fragment in name)
            for op in ("HMMA", "HGMMA", "IMMA", "IGMMA")}


# the bf16 forward's product kernels (csrc/eps_fwd.cu, both forms), whose
# own SASS must hold HGMMA: the library also holds the float32 wgmma kernel
BF16_FWD_FUNCTION = "eps_fwd_bf16_kernel"


# the sources whose f32 products run on the tensor cores in 3xTF32
TF32X3_SOURCES = ("eps_fwd", "eps_dcore", "eps_dviews_t", "logmatmulexp")


def build_all(build) -> None:
    """Phase 1: one nvcc per source, all started together; the compiler's
    register report and the tensor-core instructions of each library."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        done = {name: pool.submit(lambda n=name: (build.load_library(n), time.perf_counter() - t0))
                for name in SOURCES}
        for name, fut in done.items():
            print(f"built {name} in {fut.result()[1]:.2f} s")
            log = build.library_path(name).with_suffix(".log")
            if log.exists():
                print(log.read_text().strip())
            per_function = tensor_core_instructions(build.library_path(name))
            counts = summed_ops(per_function)
            print(f"{name}: tensor-core instructions in its SASS {counts}")
            if name == "eps_fwd":
                bf16_fwd = summed_ops(per_function, BF16_FWD_FUNCTION)
                print(f"{name}: in its bf16 product kernels ({BF16_FWD_FUNCTION}) {bf16_fwd}")
                check(bf16_fwd["HGMMA"] > 0 and bf16_fwd["HMMA"] == 0,
                      f"{name}: the bf16 forward's own SASS holds no HGMMA (wgmma)")
            if name in TF32X3_SOURCES:
                check(counts["HMMA"] + counts["HGMMA"] > 0,
                      f"{name}: no HMMA or HGMMA instruction in its SASS")
            if name == "eps_fwd_q8":
                check(counts["IGMMA"] > 0, f"{name}: no IGMMA (int8 wgmma) instruction in its SASS")
            if name == "sbs_fwd":
                spills = register_route_spills(log.read_text())
                print(f"{name}: register route, stack frame and spill bytes (frame, stores, "
                      f"loads) per instantiation {spills}")
                check(len(spills) == REG_INSTANTIATIONS,
                      f"{name}: {len(spills)} register-route kernels in the compiler's report, "
                      f"not {REG_INSTANTIATIONS}")
                check(not any(any(v) for v in spills.values()),
                      f"{name}: a register-route instantiation spills or keeps a stack frame")


# the forward's register route (csrc/sbs_fwd.cu): bond B 4 or 8, ring bond
# B0 1, 2 or 4, q^C within 4 or 16
REG_INSTANTIATIONS = 12


def register_route_spills(report: str) -> dict:
    """(stack frame, spill stores, spill loads) in bytes of each
    instantiation of the register route (``sbs_fwd_reg_kernel<B, B0, KQ>``)
    in a ``-Xptxas -v`` report, keyed by its mangled template arguments."""
    found = re.findall(r"Compiling entry function '\w*sbs_fwd_reg_kernelI(\w+?)EEv\w*'"
                       r"(?:(?!Compiling entry).)*?(\d+) bytes stack frame, (\d+) bytes spill "
                       r"stores, (\d+) bytes spill loads", report, flags=re.S)
    return {args: (int(fr), int(st), int(ld)) for args, fr, st, ld in found}


def layer_dims(specs, image_size=28, q0=2):
    """(n_k, q_k, n1_k, O, h') of each layer of a model at ``image_size``
    (28×28 unless said) on ``q0`` input values."""
    from dctn_tpu_torch.kernels import eps_kernels as K
    from dctn_tpu_torch.models import EPSesPlusLinearConfig, fast_layer_plans

    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=image_size, q0=q0)
    dims, h = [], cfg.image_size
    for p in fast_layer_plans(cfg):
        n_k, q_k, n1_k = K._kernel_dims(p["c"], p["q"], p["kernel_size"], p["n1"], p["merge_pairs"])
        h = h - p["kernel_size"] + 1
        dims.append((n_k, q_k, n1_k, p["out_size"], h))
    return dims


def kernel_shapes():
    """(label, n, q, n1, O, npix): the layers of the flagship, the
    three-EPS and the deep model at batch 128 (the deep model's layer 0 is
    the flagship's; its layer 1 is where the TPU runs d_cmt o-tiled, K5),
    then every factor in u (n2 = 0) and a ragged pixel count."""
    shapes = []
    for model, specs, first in (("flagship", FLAGSHIP, 0), ("three-EPS", THREE, 0), ("deep", DEEP, 1)):
        for i, (n, q, n1, o, h) in enumerate(layer_dims(specs)):
            if i >= first:
                shapes.append((f"{model} layer {i}", n, q, n1, o, BATCH * h * h))
    return shapes + [("n2=0", 4, 3, 4, 5, 1000), ("ragged npix", 6, 2, 3, 3, 777)]


def bound_ms(nbytes: float, flops: float = 0.0, int8_ops: float = 0.0, mm_flops: float = 0.0,
             bf16_flops: float = 0.0):
    """The least time of the work on the card: (ms, what bounds it), the
    operations of each type at that type's peak: ``flops`` elementwise
    float32 on the CUDA cores, ``mm_flops`` float32 matrix products at the
    3xTF32 rate, ``bf16_flops`` bf16 products at the dense bf16 rate and
    ``int8_ops`` at the int8 rate, all three on the tensor cores. The CUDA
    cores and the tensor cores can overlap, so the slower of the two bounds
    the operations."""
    t_ops = max(flops / F32_PEAK_FLOPS,
                mm_flops / TF32X3_PEAK_FLOPS + int8_ops / INT8_PEAK_OPS
                + bf16_flops / BF16_PEAK_FLOPS)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def kernel_vs_plain(K, Q8, dev):
    """Phase 2: each kernel against its plain version. Returns, per kernel,
    the JSON numbers: max |Δ| over every shape it ran at, and its kernel,
    plain, library and bound times summed over the layers it runs at on its
    path at batch 128 (eps_fwd: the flagship's serving forward, both layers
    without t; eps_fwd_t: flagship layer 1, which saves t for training;
    eps_dcore: both flagship layers; eps_dviews_t: flagship layer 1;
    eps_fwd_q8: the flagship's int8 serving forward, both layers;
    eps_fwd_q8_t: flagship layer 1, which saves t in a QAT step;
    eps_dviews_recompute: the three-EPS model's layers 1 and 2, and the deep
    model's layer 1, whose t is over the cap at batch 2048)."""
    on_path = {
        "eps_fwd": ("flagship layer 0", "flagship layer 1"),
        "eps_fwd_t": ("flagship layer 1",),
        "eps_dcore": ("flagship layer 0", "flagship layer 1"),
        "eps_dviews_t": ("flagship layer 1",),
        "eps_fwd_q8": ("flagship layer 0", "flagship layer 1"),
        "eps_fwd_q8_t": ("flagship layer 1",),
        "eps_dviews_recompute": ("three-EPS layer 1", "three-EPS layer 2", "deep layer 1"),
    }
    three = ("three-EPS layer 0", "three-EPS layer 1", "three-EPS layer 2")
    runs = {
        "eps_fwd": ("flagship layer 0", "flagship layer 1", "n2=0", "ragged npix", *three,
                    "deep layer 1", "deep layer 2"),
        "eps_fwd_t": ("flagship layer 0", "flagship layer 1", "ragged npix", "deep layer 1",
                      "deep layer 2"),
        "eps_dcore": ("flagship layer 0", "flagship layer 1", "n2=0", "ragged npix", *three,
                      "deep layer 1", "deep layer 2"),
        "eps_dviews_t": ("flagship layer 0", "flagship layer 1", "n2=0", "ragged npix",
                         "deep layer 1", "deep layer 2"),
        "eps_fwd_q8": ("flagship layer 0", "flagship layer 1", "n2=0", "ragged npix", *three),
        "eps_fwd_q8_t": ("flagship layer 0", "flagship layer 1", "n2=0", "ragged npix"),
        "eps_dviews_recompute": ("flagship layer 1", "n2=0", "ragged npix", *three[1:],
                                 "deep layer 1"),
    }
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "timed_by": CUDA_EVENTS, "bound_ms": 0.0, "flops": 0.0, "int8_ops": 0.0,
               "mm_flops": 0.0, "bytes": 0.0}
           for k in runs}
    g_ = torch.Generator(device=dev).manual_seed(SEED)
    for label, n, q, n1, o, npix in kernel_shapes():
        views = torch.rand((n, q, npix), generator=g_, device=dev)
        cmt = torch.randn((o * q ** (n - n1), q**n1), generator=g_, device=dev) * q ** (-n / 2)
        g = torch.randn((o, npix), generator=g_, device=dev)
        z, a = cmt.shape
        t = K.eps_fwd_reference(views, cmt, n1, o, save_t=True)[1] if n1 < n else None
        u = K._suffix_chain(views, 0, n1)[0]
        kr2 = K._kr2(views, g, n1)
        wq, sw = Q8.quantize_cmt(cmt)
        uq = Q8._quantize_columns(u)[0]
        # torch._int_mm takes more than 16 rows and multiples of 8 otherwise,
        # and cuBLAS refuses Z = 24 (three-EPS layer 1): 32-multiples only
        int_mm = ((lambda: torch._int_mm(wq, uq))
                  if z % 32 == 0 and a % 32 == 0 and npix % 8 == 0 else None)
        f4 = 4.0  # bytes per float32
        gemm = 2.0 * z * a * npix
        q8_bytes = f4 * (views.numel() + z + o * npix) + wq.numel()
        cases = {
            "eps_fwd": (lambda: K.eps_fwd(views, cmt, n1, o),
                        lambda: K.eps_fwd_reference(views, cmt, n1, o),
                        lambda: torch.matmul(cmt, u),
                        (gemm, 2.0 * z * npix), f4 * (views.numel() + cmt.numel() + o * npix)),
            "eps_fwd_t": (lambda: K.eps_fwd(views, cmt, n1, o, save_t=True),
                          lambda: K.eps_fwd_reference(views, cmt, n1, o, save_t=True),
                          lambda: torch.matmul(cmt, u),
                          (gemm, 2.0 * z * npix),
                          f4 * (views.numel() + cmt.numel() + o * npix + z * npix)),
            "eps_dcore": (lambda: K.eps_dcore(views, g, n1, o),
                          lambda: K.eps_dcore_reference(views, g, n1, o),
                          lambda: torch.matmul(kr2, u.T),
                          (gemm, 0.0), f4 * (views.numel() + g.numel() + z * a)),
            "eps_dviews_t": (lambda: K.eps_dviews_t(views, cmt, g, t, n1, o),
                             lambda: K.eps_dviews_t_reference(views, cmt, g, t, n1, o),
                             lambda: torch.matmul(cmt.T, kr2),
                             (gemm, 2.0 * z * npix),
                             f4 * (2 * views.numel() + cmt.numel() + g.numel()
                                   + (0 if t is None else t.numel()))),
            # d_u and t = cmt·u, then the sum over o (2 per t entry)
            "eps_dviews_recompute": (lambda: K.eps_dviews_recompute(views, cmt, g, n1, o),
                                     lambda: K.eps_dviews_recompute_reference(views, cmt, g, n1, o),
                                     lambda: (torch.matmul(cmt.T, kr2), torch.matmul(cmt, u)),
                                     (2 * gemm, 2.0 * z * npix if n1 < n else 0.0),
                                     f4 * (2 * views.numel() + cmt.numel() + g.numel())),
            # int8: the product's operations in int8, dequantizing (2 per t
            # entry) and the sum over b (2) in f32
            "eps_fwd_q8": (lambda: Q8.eps_fwd_q8(views, wq, sw, n1, o),
                           lambda: Q8.eps_fwd_q8_reference(views, wq, sw, n1, o),
                           int_mm, (0.0, 4.0 * z * npix), q8_bytes, gemm),
            "eps_fwd_q8_t": (lambda: Q8.eps_fwd_q8(views, wq, sw, n1, o, save_t=True),
                             lambda: Q8.eps_fwd_q8_reference(views, wq, sw, n1, o, save_t=True),
                             int_mm, (0.0, 4.0 * z * npix), q8_bytes + f4 * z * npix, gemm),
        }
        for name, (kern, plain, lib, (mm_flops, flops), nbytes, *int8_ops) in cases.items():
            if label not in runs[name]:
                continue
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            errs = []
            for which, x, r in zip(("out", "t"), got, ref):
                err, scale = float((x - r).abs().max()), float(r.abs().max())
                check(x.shape == r.shape, f"{name} [{label}]: {which} shape {tuple(x.shape)}")
                check(torch.isfinite(x).all().item(), f"{name} [{label}]: non-finite {which}")
                check(err <= REL_TOL * scale,
                      f"{name} [{label}]: {which} differs from plain by {err} (max|ref| {scale})")
                if name == "eps_fwd_q8_t" and which == "t":
                    check(torch.equal(x, r), f"{name} [{label}]: t is not the plain version's bit for bit")
                errs.append(f"{which} max|d|={err:.3e} tol={REL_TOL * scale:.3e}")
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
            t_k, t_p, *t_l = median_ms([kern, plain] + ([lib] if lib else []), reps=10)
            ops = {"flops": flops, "int8_ops": int8_ops[0] if int8_ops else 0.0,
                   "mm_flops": mm_flops}
            b_ms, _ = bound_ms(nbytes, **ops)
            products = 2 if name == "eps_dviews_recompute" else 1
            print(
                f"{name} vs plain [{label}] n={n} q={q} n1={n1} O={o} npix={npix}: "
                f"{'; '.join(errs)} (1e-4*max|ref|{'; t bit-equal' if name == 'eps_fwd_q8_t' else ''}); "
                f"kernel {t_k:.4f} ms ({products * gemm / t_k / 1e9:.2f} T(FL)OP/s of the products), "
                f"plain {t_p:.4f} ms, library product alone "
                f"{f'{t_l[0]:.4f} ms' if t_l else 'n/a'}, bound {b_ms:.4f} ms"
            )
            if label in on_path[name]:
                r = res[name]
                r["ms"] += t_k
                r["plain_ms"] += t_p
                r["library_ms"] += t_l[0]
                r["bytes"] += nbytes
                for key, v in ops.items():
                    r[key] += v
        del views, cmt, g, t, u, kr2, wq, sw, uq
    for r in res.values():
        r["bound_ms"], r["bound_by"] = bound_ms(r.pop("bytes"), r.pop("flops"), r.pop("int8_ops"),
                                                r.pop("mm_flops"))
    return res


def kernels_at_deep_batch(K, dev, res) -> None:
    """Phase 2 at the largest shapes the deep step runs, each kernel
    against its plain version: the forward without t (``eps_fwd``) and with
    it (``eps_fwd_t``) and ``eps_dcore`` at each of the deep model's layers
    at 512 images (a microbatch at accumulation 4) and at 2048 (up to
    1,280,000 pixels), and the recompute kernel at layer 1 at 2048 (the arm
    that batch takes). The plain versions materialize u, kr2 (and t and
    d_u) there (up to ~36 GB of the card's 80). The tensor cores truncate
    their sums, so a longer sum over pixels is the harder case for
    ``eps_dcore``; the forward's sums run over A (up to 1,728 at layer 2)
    and its t (13.3 GB at layer 1 at 2048) is the largest it writes. Max |Δ|
    joins the kernel's in ``res``; the times are printed, not summed into
    the JSON line (that sums batch 128)."""
    dims = layer_dims(DEEP)
    cases = [(name, layer, batch) for batch in (DEEP_BATCH // 4, DEEP_BATCH)
             for layer in range(len(dims)) for name in ("eps_fwd", "eps_fwd_t", "eps_dcore")]
    cases.append(("eps_dviews_recompute", 1, DEEP_BATCH))
    for name, layer, batch in cases:
        n, q, n1, o, h = dims[layer]
        npix = batch * h * h
        g_ = torch.Generator(device=dev).manual_seed(SEED)
        views = torch.rand((n, q, npix), generator=g_, device=dev)
        cmt = torch.randn((o * q ** (n - n1), q**n1), generator=g_, device=dev) * q ** (-n / 2)
        g = torch.randn((o, npix), generator=g_, device=dev)
        z, a = cmt.shape
        if name in ("eps_fwd", "eps_fwd_t"):
            save_t = name == "eps_fwd_t"

            def kern():
                return K.eps_fwd(views, cmt, n1, o, save_t=save_t)

            def plain():
                return K.eps_fwd_reference(views, cmt, n1, o, save_t=save_t)

            ops = {"nbytes": 4.0 * (views.numel() + cmt.numel() + o * npix
                                    + (z * npix if save_t else 0)),
                   "flops": 2.0 * z * npix, "mm_flops": 2.0 * z * a * npix}
        elif name == "eps_dcore":
            def kern():
                return K.eps_dcore(views, g, n1, o)

            def plain():
                return K.eps_dcore_reference(views, g, n1, o)

            ops = {"nbytes": 4.0 * (views.numel() + g.numel() + z * a),
                   "mm_flops": 2.0 * z * a * npix}
        else:
            def kern():
                return K.eps_dviews_recompute(views, cmt, g, n1, o)

            def plain():
                return K.eps_dviews_recompute_reference(views, cmt, g, n1, o)

            ops = {"nbytes": 4.0 * (2 * views.numel() + cmt.numel() + g.numel()),
                   "flops": 2.0 * z * npix, "mm_flops": 4.0 * z * a * npix}
        torch.cuda.reset_peak_memory_stats(dev)
        label = f"{name} [deep layer {layer} at batch {batch}]"
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        errs, shares = [], []
        for which, x, r in zip(("out", "t"), got, ref):
            err, scale = float((x - r).abs().max()), float(r.abs().max())
            check(x.shape == r.shape, f"{label}: {which} shape {tuple(x.shape)}")
            check(torch.isfinite(x).all().item(), f"{label}: non-finite {which}")
            check(err <= REL_TOL * scale,
                  f"{label}: {which} differs from plain by {err} (max|ref| {scale})")
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
            errs.append(f"{which} max|d|={err:.3e} tol={REL_TOL * scale:.3e}")
            shares.append(err / (REL_TOL * scale))
        del got, ref
        t_k, t_p = median_ms([kern, plain], reps=2)
        b_ms, _ = bound_ms(**ops)
        print(f"{label} n={n} q={q} n1={n1} O={o} npix={npix}: {'; '.join(errs)} "
              f"(1e-4*max|ref|; {max(shares):.1%} of it); "
              f"kernel {t_k:.4f} ms ({ops['mm_flops'] / t_k / 1e9:.2f} TFLOP/s of the products), "
              f"plain {t_p:.4f} ms, bound {b_ms:.4f} ms; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
        del views, cmt, g
        torch.cuda.empty_cache()


# torch.profiler on the card now and then hands back a window without any
# device event; a window that shows none is taken again, at most this many
# times
PROFILE_TRIES = 3
# windows the process's first profile took to show a device event (None
# until then; 0 where none of PROFILE_TRIES did)
_profiler_primed = None


def prime_profiler() -> int:
    """Opens torch.profiler windows over one small device op until one shows
    a device event, at most PROFILE_TRIES, once a process, and prints how
    many it took: on the card, a process's first windows have shown no
    device event at all, three in a row. Returns that count (0: none did)."""
    global _profiler_primed
    if _profiler_primed is not None:
        return _profiler_primed
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1 << 20, device="cuda")
    _profiler_primed = 0
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            x.add_(1.0)
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            _profiler_primed = tries
            break
    print(f"torch.profiler: the process's first device event showed in window "
          f"{_profiler_primed} of at most {PROFILE_TRIES} (0: in none)")
    return _profiler_primed


def device_ms_per_call(fn, calls: int, out_path: str, required: bool = True) -> tuple:
    """torch.profiler over ``calls`` calls of ``fn``: (device ms per call,
    the top device kernels as (name, ms per call)). Writes the whole table
    to ``out_path``. Only the kernels' own rows are summed: a host op's row,
    and a user annotation's such as ``Optimizer.step#Adam.step``, repeat
    the device time of the kernels they launched. Where no window shows
    device time it raises, or with ``required`` False returns (None, [])."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prime_profiler()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        per_kernel = sorted(
            ((e.key, e.self_device_time_total / 1e3 / calls) for e in events
             if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
             and not getattr(e, "is_user_annotation", False)),
            key=lambda kv: -kv[1],
        )
        if per_kernel:
            break
    if not per_kernel and not required:
        return None, []
    check(bool(per_kernel), f"torch.profiler showed no device time in {PROFILE_TRIES} windows")
    with open(out_path, "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    return sum(ms for _, ms in per_kernel), per_kernel[:8]


def device_or_event_ms(fns, calls: int, label: str) -> tuple:
    """Device time per call of each of ``fns`` (``device_ms_per_call``) and
    DEVICE_TIME; where the profiler shows no device time for one of them,
    the median CUDA-event time of one call of each, run in turns ``calls``
    times, and CUDA_EVENTS, so that the times of one shape are taken one
    way."""
    times = [device_ms_per_call(fn, calls, os.devnull, required=False)[0] for fn in fns]
    if None not in times:
        return times, DEVICE_TIME
    print(f"{label}: torch.profiler showed no device time in {PROFILE_TRIES} windows; "
          f"timed by CUDA events instead")
    return median_ms(fns, reps=calls), CUDA_EVENTS


def timed_by_of(ways: set) -> str:
    """The ``timed_by`` of a kernels-line entry whose shapes were timed in
    ``ways``: one of them, or both joined by '+'."""
    return "+".join(sorted(ways))


def profile_serving(paths, x, latency_stats, out_dir: str, tag: str) -> None:
    """Phase 5 (opt-in): where the serving forward's time goes, on each of
    ``paths`` (name → forward: the kernel path and the plain path), at batch
    1 and batch 128. ``tag`` names the model (f32 or int8)."""
    os.makedirs(out_dir, exist_ok=True)
    for bs in (1, BATCH):
        xb = x[:, :bs]
        for name, forward in paths.items():
            stats = latency_stats(forward, x, bs)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            forward(xb)
            torch.cuda.synchronize()
            extra_mib = (torch.cuda.max_memory_allocated() - base) / 2**20
            calls = 10
            t0 = time.perf_counter()
            for _ in range(calls):
                forward(xb)
            host_ms = 1e3 * (time.perf_counter() - t0) / calls
            torch.cuda.synchronize()
            busy_ms, top = device_ms_per_call(
                lambda: forward(xb), calls,
                os.path.join(out_dir, f"profile_{tag}_{name}_bs{bs}.txt"),
            )
            print(json.dumps({
                "metric": "serving_profile", "model": tag, "path": name, "batch_size": bs,
                "p50_ms": stats["p50_ms"], "pipelined_throughput_img_per_s":
                stats["pipelined_throughput_img_per_s"], "device_busy_ms": busy_ms,
                "device_idle_share_at_p50": 1 - busy_ms / stats["p50_ms"],
                "host_enqueue_ms": host_ms, "extra_device_mib": extra_mib,
                "top_device_ops_ms": top,
            }))



def pct(times, q):
    return sorted(times)[int(len(times) * q)]


def interleaved_ms(fns, x, calls: int) -> list:
    """p50 and p90 ms of each of ``fns`` on ``x``, every call fenced, the
    functions in turns (one warm call each first)."""
    times = [[] for _ in fns]
    for fn in fns:
        fn(x)
    torch.cuda.synchronize()
    for _ in range(calls):
        for fn, ts in zip(fns, times):
            t0 = time.perf_counter()
            fn(x)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
    return [{"p50_ms": pct(ts, 0.5), "p90_ms": pct(ts, 0.9)} for ts in times]


def host_profile(fn, x, calls: int) -> dict:
    """Host ms per call of ``fn`` (its launches enqueued, no fence between
    calls) and the Python functions that take most of it: cProfile's own
    and cumulative time per call, the top ``HOST_PROFILE_ROWS`` of each."""
    import cProfile
    import pstats

    fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(x)
    host = 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(calls):
        fn(x)
    prof.disable()
    torch.cuda.synchronize()
    rows = pstats.Stats(prof).stats.items()  # (file, line, name): (cc, nc, own, cum, callers)

    def top(col):
        best = sorted(rows, key=lambda kv: kv[1][col], reverse=True)[:HOST_PROFILE_ROWS]
        return {f"{os.path.basename(f)}:{line}({name})": 1e3 * v[col] / calls
                for (f, line, name), v in best}

    return {"host_ms_per_call": host, "own_ms_per_call": top(2), "cumulative_ms_per_call": top(3)}


def export_serve_phase(bench, CSM, params, cfg, served, dev, tmp) -> dict:
    """Phase 3b: export, load, predict and serve. The seeded flagship of
    phase 3, f32 and int8, and the 2-layer bond-4 ConvSBS model exported on
    the card through ``export.run``; each loaded with ``load_artifact``:
    its operator nodes, launches per forward and logits against the eager
    model; ``predict.run`` on both flagship artifacts beside phase 3's npz
    numbers, and the artifact's latency against the npz model's in turns
    (with a host profile of both); the stdlib server: 128 and 300 images
    against direct calls, a bad body, 16 micro-batched batch-1 clients, the
    HTTP round trip at batch 1 and 128, a graceful shutdown. Returns the
    launch counts of the whole phase."""
    import threading
    import urllib.error
    import urllib.request

    from dctn_tpu_torch.cli import export, predict, serve
    from dctn_tpu_torch.data import io as data_io
    from dctn_tpu_torch.models import ConvSBSModel, EPSesPlusLinear, EPSesPlusLinearQ8
    from dctn_tpu_torch.train import save_conv_sbs_params_npz, save_params_npz

    def counts():
        return {**bench.read_counters(), **bench.read_sbs_counters()}

    def launched(fn, x):
        """fn(x) and the launches it made (the counters' moves)."""
        torch.cuda.synchronize()
        before = counts()
        out = fn(x)
        torch.cuda.synchronize()
        return out, {k: v - before[k] for k, v in counts().items() if v != before[k]}

    def hold(got, want, what):
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        equal = bool(torch.equal(got, want))
        print(f"{what}: max|d|={err:.3e} tol={ART_TOL * scale:.3e} bit-equal {equal}")
        check(torch.isfinite(got).all().item() and err <= ART_TOL * scale,
              f"{what}: the artifact's logits differ from the eager model's")
        return {"max_abs_d": err, "bit_equal": equal}

    out = {}
    bench.zero_counters()
    ckpt = os.path.join(tmp, "flagship.npz")
    save_params_npz(params, ckpt)
    (run_f32, _), (run_q8, _) = served["none"], served["int8"]
    x = run_f32.x[:, :BATCH]
    arts, fns = {}, {}
    eager = {"f32": EPSesPlusLinear.from_reference(params, cfg, device=dev),
             "int8": EPSesPlusLinearQ8.from_reference(params, cfg, device=dev)}
    for name, quantize, op in (("f32", "none", "eps_fwd"), ("int8", "int8", "eps_fwd_q8")):
        arts[name] = os.path.join(tmp, f"{name}.zip")
        report = export.run(checkpoint=ckpt, epses_specs=FLAGSHIP, batch_sizes=ART_BATCHES,
                            device="cuda", quantize=quantize, out=arts[name])
        meta, fns[name] = export.load_artifact(arts[name])
        check(meta["platforms"] == ["cuda"] and meta["quantize"] == quantize, f"{name} meta {meta}")
        rec = out[name] = {"export_s": report["export_s"], "artifact_bytes": report["artifact_bytes"]}
        with torch.inference_mode():
            for bs in ART_BATCHES:
                check(export.op_nodes(fns[name][bs]) == {op: 2},
                      f"{name} bs {bs}: graph nodes {export.op_nodes(fns[name][bs])}")
                got, n_art = launched(fns[name][bs], x[:, :bs])
                want, n_eager = launched(eager[name], x[:, :bs])
                check(n_art == n_eager == {op: 2}, f"{name} bs {bs}: launches per forward "
                      f"artifact {n_art}, eager {n_eager}")
                rec[f"logits_bs{bs}"] = hold(got, want, f"{name} artifact vs eager, batch {bs}")
            rec["launches_per_forward"] = n_art
    try:
        export.load_artifact(arts["f32"], "cuda:1")
        check(False, "an artifact exported on cuda:0 loaded onto cuda:1")
    except ValueError as e:
        check("does not load onto cuda:1" in str(e), f"cuda:1 refusal: {e}")

    # the ConvSBS model on the legacy runner's recipe (unit-std layers)
    images, _ = data_io.synthetic_mnist_like(100, seed=1234)
    xs = torch.as_tensor(images, device=dev)
    scfg = sbs_model_cfg(CSM, xs, False)
    sparams = sbs_recipe_params(CSM, scfg, xs, dev)
    sckpt = os.path.join(tmp, "conv_sbs.npz")
    save_conv_sbs_params_npz(sparams, sckpt)
    arts["conv_sbs"] = os.path.join(tmp, "conv_sbs.zip")
    report = export.run(checkpoint=sckpt, model_family="conv_sbs", num_sbs_layers=SBS_LAYERS,
                        bond_dim=SBS_BOND, cos_sin_squared=True,
                        input_multiplier=scfg.input_multiplier, batch_sizes=SBS_ART_BATCHES,
                        device="cuda", out=arts["conv_sbs"])
    _, fns["conv_sbs"] = export.load_artifact(arts["conv_sbs"])
    smodel = ConvSBSModel(sparams, scfg)
    rec = out["conv_sbs"] = {"export_s": report["export_s"],
                             "artifact_bytes": report["artifact_bytes"]}
    with torch.inference_mode():
        for bs in SBS_ART_BATCHES:
            fn = fns["conv_sbs"][bs]
            check(export.op_nodes(fn) == {"sbs_fwd": 3}, f"conv_sbs nodes {export.op_nodes(fn)}")
            got, n_art = launched(fn, xs[:bs])
            want, n_eager = launched(smodel, xs[:bs])
            check(n_art == n_eager and sum(n_art.values()) == 3,
                  f"conv_sbs bs {bs}: launches per forward artifact {n_art}, eager {n_eager}")
            rec[f"logits_bs{bs}"] = hold(got, want, f"conv_sbs artifact vs eager, batch {bs}")
        rec["launches_per_forward"] = n_art

    # predict.run from the artifacts, beside phase 3's npz numbers; then the
    # artifact against the npz model in turns, and where the host time goes
    for name, npz_run in (("f32", run_f32), ("int8", run_q8)):
        art_run = predict.run(checkpoint=arts[name], ds_type="fashionmnist", ds_path="synthetic",
                              batch_size=BATCH, latency_bench=True, device="cuda",
                              synthetic_sizes=(1024, 256, 1024))
        check(np.array_equal(art_run.preds, npz_run.preds),
              f"predict.run on the {name} artifact predicts otherwise than on the npz")
        rec = out[name]
        rec["predict_latency"] = {
            "artifact": {s["batch_size"]: {k: s[k] for k in ("p50_ms", "p90_ms",
                                                             "pipelined_throughput_img_per_s")}
                         for s in art_run.latency},
            "npz": {s["batch_size"]: {k: s[k] for k in ("p50_ms", "p90_ms",
                                                        "pipelined_throughput_img_per_s")}
                    for s in npz_run.latency},
        }
        with torch.inference_mode():
            for bs in ART_BATCHES:
                e, a = interleaved_ms([eager[name], fns[name][bs]], x[:, :bs], ART_AB_CALLS)
                rec[f"in_turns_bs{bs}"] = {"npz_model": e, "artifact": a,
                                           "ratio_p50": a["p50_ms"] / e["p50_ms"]}
            rec["host_profile_bs128"] = {
                "npz_model": host_profile(eager[name], x, ART_PROFILE_CALLS),
                "artifact": host_profile(fns[name][BATCH], x, ART_PROFILE_CALLS),
            }
        print(json.dumps({"metric": "artifact_latency", "model": name,
                          **{k: rec[k] for k in ("predict_latency", "in_turns_bs1",
                                                 f"in_turns_bs{BATCH}", "host_profile_bs128")}}))

    # the HTTP server on a free port, in a thread
    def post(base, arr, query=""):
        buf = io.BytesIO()
        np.save(buf, arr)
        req = urllib.request.Request(f"{base}/predict{query}", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return np.load(io.BytesIO(resp.read()))

    def start(art, wait_ms=0.0):
        server, model = serve.make_server(art, port=0, microbatch_wait_s=wait_ms / 1e3)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server, model, f"http://127.0.0.1:{server.server_address[1]}"

    def stop(server, model, base):
        server.shutdown()
        server.server_close()
        model.close()
        try:
            post(base, x300[:, :1])
        except urllib.error.URLError:
            return
        check(False, "the server answered after its shutdown")

    x300 = run_f32.x[:, :300].cpu().numpy()
    for name in ("f32", "int8"):
        server, model, base = start(arts[name])
        x128 = x300[:, :BATCH]
        with torch.inference_mode():
            direct = fns[name][BATCH](torch.as_tensor(x128, device=dev)).cpu().numpy()
        check(np.array_equal(post(base, x128), direct), f"{name}: HTTP 128 images != direct call")
        check(np.array_equal(post(base, x300), model.predict(x300)),
              f"{name}: HTTP 300 images (chunked, padded) != direct calls")
        try:
            urllib.request.urlopen(urllib.request.Request(f"{base}/predict", data=b"junk",
                                                          method="POST"), timeout=60)
            check(False, "a bad body was answered")
        except urllib.error.HTTPError as e:
            check(e.code == 400, f"a bad body got HTTP {e.code}")
        http = {}
        for bs in ART_BATCHES:
            xb = x300[:, :bs]
            post(base, xb)
            ts = []
            for _ in range(HTTP_CALLS):
                t0 = time.perf_counter()
                post(base, xb)
                ts.append(1e3 * (time.perf_counter() - t0))
            http[bs] = {"p50_ms": pct(ts, 0.5), "p90_ms": pct(ts, 0.9)}
        out[name]["http_round_trip"] = http
        stop(server, model, base)

    # micro-batching: 16 concurrent batch-1 clients, started together
    server, model, base = start(arts["f32"], MICROBATCH_WAIT_MS)
    gate = threading.Barrier(MICROBATCH_CLIENTS)

    def client(i):
        gate.wait()
        return post(base, x300[:, i : i + 1])

    before = counts()["eps_fwd"]
    with concurrent.futures.ThreadPoolExecutor(MICROBATCH_CLIENTS) as pool:
        got = list(pool.map(client, range(MICROBATCH_CLIENTS)))
    torch.cuda.synchronize()
    calls = (counts()["eps_fwd"] - before) // 2
    stop(server, model, base)
    worst = 0.0
    with torch.inference_mode():
        for i, g in enumerate(got):
            want = fns["f32"][1](torch.as_tensor(x300[:, i : i + 1], device=dev)).cpu().numpy()
            err = float(np.abs(g - want).max())
            worst = max(worst, err / float(np.abs(want).max()))
    print(f"micro-batching ({MICROBATCH_CLIENTS} batch-1 clients, {MICROBATCH_WAIT_MS} ms): "
          f"{calls} device calls; largest max|d|/max|direct| {worst:.3e} (tol {MB_TOL:g})")
    check(calls < MICROBATCH_CLIENTS, f"micro-batching took {calls} device calls")
    check(worst <= MB_TOL, "a micro-batched client's logits differ from its direct call")
    out["microbatch"] = {"clients": MICROBATCH_CLIENTS, "wait_ms": MICROBATCH_WAIT_MS,
                         "device_calls": calls, "max_rel_d": worst}
    print(json.dumps({"export_serve": out}))
    return counts()


def make_trainer(params, cfg, kernels, dev, lr, reg=None, grad_accum_steps=1, plans=None):
    """A model on ``dev`` from ``params`` (at ``plans``' splits; default the
    defaults) and an Adam step at learning rate ``lr`` through ``kernels``
    (a QAT bundle for the QAT step): the bench's (epswise L2 1e-6) unless
    ``reg`` gives (reg_type, reg_coeff)."""
    from dctn_tpu_torch import bench
    from dctn_tpu_torch.models import EPSesPlusLinear
    from dctn_tpu_torch.train import make_fast_train_step, make_optimizer

    model = EPSesPlusLinear.from_reference(params, cfg, device=dev, plans=plans)
    opt = make_optimizer("adam", model.parameters(), lr)
    reg_type, reg_coeff = reg or ("epswise", bench.REG_COEFF)
    step = make_fast_train_step(model, opt, reg_type, reg_coeff, kernels=kernels,
                                grad_accum_steps=grad_accum_steps)
    return model, step


def compare_gradients(grads, tol: float, what: str) -> float:
    """Each gradient of ``grads[0]`` against ``grads[1]``'s within ``tol``
    of the latter's largest entry. Returns the largest max|Δ|/max|ref|."""
    torch.cuda.synchronize()
    worst = 0.0
    for i, (gk, gp) in enumerate(zip(*grads)):
        err, scale = float((gk - gp).abs().max()), float(gp.abs().max())
        print(f"{what}: gradient {i} {tuple(gk.shape)} max|d|={err:.3e} tol={tol * scale:.3e} "
              f"({tol:g}*max|ref|)")
        check(torch.isfinite(gk).all().item(), f"{what}: gradient {i} non-finite")
        check(err <= tol * scale, f"{what}: gradient {i} differs")
        worst = max(worst, err / scale)
    return worst


def check_step_gradients(params, cfg, paths, x, y, dev, qat=None, model_name="flagship") -> None:
    """One step's gradients at batch 128 on the kernel path against the
    plain path's (``paths``: the two ``EPSKernels`` bundles), within
    1e-4 of the largest."""
    from dctn_tpu_torch import bench

    xb, yb = x[:, :BATCH], y[:BATCH]
    grads = []
    for kernels in paths:
        model, step = make_trainer(params, cfg, kernels, dev, bench.LR)
        step(xb, yb)
        grads.append([p.grad for p in model.parameters()])
    compare_gradients(grads, REL_TOL, f"{model_name} {'QAT ' if qat else ''}kernel vs plain")


def launches_per_step(specs, batch, accum, qat, keys, image_size=28, q0=2, frozen=(),
                      bf16=False):
    """The kernel launches of one training step, from each layer's backward
    arm (``plan_backward``) at the microbatch: its forward (writing t on the
    saved-t arm), ``eps_dcore`` (and its slice sum where its tiles are few;
    neither for a ``frozen`` layer), and the arm's d_views kernel (none for
    layer 0); ``accum`` microbatches. ``bf16``: the kernels' bf16 modes
    (their ``*_bf16`` counters, K1's and ``eps_dcore``'s chunks of pixels
    too), t counted at 2 bytes by the saved-t cap;
    under ``qat`` K8/K9's forward, a bf16 t also in ``eps_fwd_q8_t_bf16``."""
    from dctn_tpu_torch.kernels import eps_kernels as K

    fwd = "eps_fwd" if qat is None else "eps_fwd_q8"
    sfx = "_bf16" if bf16 else ""
    fsfx = "" if qat else sfx  # K8/K9 have no bf16 forward: a bf16 t counts apart
    slices = K._dcore_bf16_slices if bf16 else K._dcore_slices
    counts = dict.fromkeys(keys, 0)
    for i, (n, q, n1, o, h) in enumerate(layer_dims(specs, image_size, q0)):
        npix = batch // accum * h * h
        arm = K.plan_backward(i, n, n1, q, o, npix, 2 if bf16 else 4)
        counts[fwd + fsfx] += 1
        counts[f"{fwd}_t{fsfx}"] += arm == "saved_t"
        if bf16 and not qat:  # its chunks of pixels, each the operands kernel then the product
            counts["eps_fwd_chunks_bf16"] += K._fwd_bf16_plan(n, q, n1, o, npix)["chunks"]
        if qat and bf16:
            counts["eps_fwd_q8_t_bf16"] += arm == "saved_t"
        if i not in frozen:
            counts["eps_dcore" + sfx] += 1
            counts["eps_dcore_sum" + sfx] += slices(o * q ** (n - n1), q**n1, npix,
                                                    K._sm_count(torch.device("cuda", 0))) > 1
            if bf16:  # its chunks of pixels, each the operands kernel then the product
                counts["eps_dcore_chunks_bf16"] += -(-npix // K._dcore_bf16_chunk(
                    o * q ** (n - n1), q**n1, npix))
        counts["eps_dviews_t" + sfx] += arm == "saved_t"
        counts["eps_dviews_recompute" + sfx] += arm == "recompute"
    return {k: v * accum for k, v in counts.items()}


def print_train_record(rec, tag: str) -> None:
    share, share16, fwd = rec["f32_peak_share"], rec["bf16_peak_share"], rec["forward_ms_p50"]
    print(f"train step {tag} [{rec['path']}, {rec['compute_dtype']}]: p50 "
          f"{rec['step_ms_p50']:.4f} ms, {rec['images_per_s']:.1f} img/s"
          f"{'' if share is None else f', {share:.4f} of the f32 peak'}"
          f"{'' if share16 is None else f', {share16:.4f} of the bf16 peak'}"
          f"{'' if fwd is None else f', forward p50 {fwd:.4f} ms'}, "
          f"peak extra memory {rec['peak_extra_mib']:.1f} MiB, "
          f"loss {rec['first_loss']:.6f} -> {rec['last_loss']:.6f}")


def check_training(params, cfg, K, x, y, dev) -> None:
    """The training path's output: one step's gradients on the kernels
    against the plain path's at batch 128, and a 3-step trajectory at batch
    4 against the float64 step on the CPU."""
    from dctn_tpu_torch.interop import params_from_numpy, params_to_numpy

    check_step_gradients(params, cfg, (K.KERNELS, K.PLAIN), x, y, dev)
    p64 = params_from_numpy(params_to_numpy(params), "cpu", torch.float64)
    model_k, step_k = make_trainer(params, cfg, K.KERNELS, dev, TRAJ_LR)
    model_64, step_64 = make_trainer(p64, cfg, K.PLAIN, torch.device("cpu"), TRAJ_LR)
    start = [p.detach().clone() for p in model_64.parameters()]
    for i in range(3):
        sl = slice(4 * i, 4 * i + 4)
        mk = step_k(x[:, sl], y[sl])
        m64 = step_64(x[:, sl].cpu().double(), y[sl].cpu())
        for key in ("loss", "ce", "reg_term"):
            a, b = float(mk[key]), float(m64[key])
            print(f"trajectory step {i} {key}: kernel {a:.9g} float64 {b:.9g}")
            check(math.isfinite(a) and abs(a - b) <= TRAJ_RTOL * abs(b),
                  f"step {i} {key} differs from the float64 step")
    for i, (pk, p64_, p0) in enumerate(zip(model_k.parameters(), model_64.parameters(), start)):
        diff = float(torch.linalg.vector_norm(pk.detach().cpu().double() - p64_.detach()))
        moved = float(torch.linalg.vector_norm(p64_.detach() - p0))
        worst = float((pk.detach().cpu().double() - p64_.detach()).abs().max())
        print(f"trajectory parameter {i}: ||kernel - float64|| = {diff:.3e}, moved "
              f"{moved:.3e} (tol {TRAJ_NORM_TOL:g} of it), max|d| = {worst:.3e}")
        check(diff <= TRAJ_NORM_TOL * moved, f"parameter {i} after 3 steps differs from float64")


def profile_training(params, cfg, x, y, dev, out_dir: str, qat=None, paths=None,
                     batch=BATCH, lr=None, reg=None, grad_accum_steps=1, tag=None,
                     warmup=3, calls=5) -> None:
    """Phase 5 (opt-in): where the training step's time goes, by default
    the bench's step at batch 128 on the kernel and the plain path (the QAT
    step with ``qat="int8"``), after ``warmup`` steps, over ``calls`` steps;
    ``paths``, ``batch``, ``lr``, ``reg`` and ``grad_accum_steps`` set
    another step (the deep model's)."""
    from dctn_tpu_torch import bench

    os.makedirs(out_dir, exist_ok=True)
    xb, yb = x[:, :batch], y[:batch]
    tag = tag or ("qat" if qat else "train")
    for name, kernels in paths or bench.PATHS[qat]:
        _, step = make_trainer(params, cfg, kernels, dev, lr or bench.LR, reg, grad_accum_steps)
        for _ in range(warmup):
            step(xb, yb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            step(xb, yb)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / calls
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        busy_ms, top = device_ms_per_call(
            lambda: step(xb, yb), calls, os.path.join(out_dir, f"profile_{tag}_{name}.txt")
        )
        print(json.dumps({
            "metric": "train_profile", "model": tag, "qat": qat, "path": name, "batch_size": batch,
            "grad_accum_steps": grad_accum_steps, "step_wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / wall_ms,
            "extra_device_mib": (torch.cuda.max_memory_allocated(dev) - base) / 2**20,
            "top_device_ops_ms": top,
        }))


# ---------------------------------------------------------------------------
# the EPS runner (phase 4b)


EVAL_LINE = re.compile(r"After (\d+) iters: train/val mean_ce=(\S+)/(\S+) acc=(\S+)%/(\S+)% "
                       r"reg_term=(\S+)")


def runner_init_launches(n_images: int, batch: int, layers: int) -> int:
    """K1 launches of the runner before training: the empirical init pushes
    the init subset through each layer twice (the scale, then the next
    layer's input) in slices of the batch size, and the statistics at start
    once per layer in slices of half the batch."""
    return layers * (2 * math.ceil(n_images / batch) + math.ceil(n_images / (batch // 2)))


def runner_eval_launches(sizes, batch: int, layers: int) -> int:
    """Forward launches of one eval: the train and the val split in batches."""
    return layers * (math.ceil(sizes[0] / batch) + math.ceil(sizes[1] / batch))


def run_runner(trunner, bench, tmp, name, **kw):
    """One ``runner.run`` on the card with the counts set to 0 just before it
    and read just after: (state, counts, out dir)."""
    bench.zero_counters()
    t0 = time.perf_counter()
    state = trunner.run(experiments_dir=os.path.join(tmp, name), device="cuda", **kw)
    counts = bench.read_counters()
    secs = time.perf_counter() - t0
    (sub,) = os.listdir(os.path.join(tmp, name))
    out = os.path.join(tmp, name, sub)
    timing = state.extras["timing"]
    print(f"runner {name}: {secs:.1f} s, stopped {state.stop_reason} at {state.num_iters_done}, "
          f"{timing['iters']} iterations at "
          f"{1e3 * (timing['loop_s'] - timing['hooks_s']) / max(timing['iters'], 1):.4f} ms, "
          f"{timing['evals']} evals at {1e3 * timing['eval_s'] / max(timing['evals'], 1):.4f} ms, "
          f"launches {counts}")
    return state, counts, out


def check_runner_log(out: str, want_iters) -> None:
    """Every eval line of log.log is finite, at the iterations expected."""
    with open(os.path.join(out, "log.log")) as f:
        rows = EVAL_LINE.findall(f.read())
    check([int(r[0]) for r in rows] == list(want_iters), f"eval lines at {[r[0] for r in rows]}")
    check(all(math.isfinite(float(v)) for r in rows for v in r[1:]), "a non-finite eval metric")


def final_reference(state):
    """A copy of a run's params in the reference layout."""
    ref = state.extras["params_view"](state.params)
    return {"epses": tuple(c.detach().clone() for c in ref["epses"]),
            "linear": {k: v.detach().clone() for k, v in ref["linear"].items()}}


def runner_phase(trunner, bench, K, dev) -> list:
    """Phase 4b: the EPS runner through ``runner.run`` on the card (the README
    quick start, a resume, then the QAT, dropout-and-frozen and colored
    short runs), each run's launches against the count its iterations,
    evals and init make, its checkpoints, its logits against the plain
    forward, and the resume bit for bit. Returns the runs' launch counts."""
    from dctn_tpu_torch.models import EPSesPlusLinear
    from dctn_tpu_torch.train import load_params_npz

    base = dict(ds_type="fashionmnist", ds_path="synthetic", batch_size=BATCH,
                optimizer_name="adam", lr=3e-3,
                init_epses_composition_unit_empirical_output_std=True)
    main = dict(base, epses_specs=FLAGSHIP, synthetic_sizes=RUN_SIZES,
                eval_schedule=((None, RUN_EVAL_EVERY),))
    keys = tuple(bench.read_counters())
    per_step = launches_per_step(FLAGSHIP, BATCH, 1, None, keys)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        state, counts, out = run_runner(trunner, bench, tmp, "main", max_num_iters=RUN_ITERS, **main)
        runs.append(counts)
        check(state.stop_reason == "max_iters" and state.num_iters_done == RUN_ITERS,
              f"the runner stopped: {state.stop_reason} at {state.num_iters_done}")
        check(math.isfinite(float(state.device_metrics["loss"])), "non-finite loss")
        evals = RUN_ITERS // RUN_EVAL_EVERY + 1
        check_runner_log(out, range(0, RUN_ITERS + 1, RUN_EVAL_EVERY))
        want = {k: v * RUN_ITERS for k, v in per_step.items()}
        want["eps_fwd"] += (runner_init_launches(RUN_SIZES[0], BATCH, 2)
                            + evals * runner_eval_launches(RUN_SIZES, BATCH, 2))
        check(counts == want, f"runner launches {counts} != {want} (per step {per_step}, "
              f"{evals} evals, the init)")
        files = os.listdir(out)
        last = [f for f in files if f.startswith(f"model_nitd={RUN_ITERS:07}")]
        best = [f for f in files if f.startswith("model_best_")]
        check(len(last) == 1 and len(best) == 4 and "train_state_latest.npz" in files,
              f"checkpoints {sorted(files)}")
        final = final_reference(state)
        for f in last + best:
            loaded = load_params_npz(os.path.join(out, f))
            shapes = [a.shape for a in loaded["epses"]] + [loaded["linear"][k].shape for k in "wb"]
            check(shapes == [tuple(c.shape) for c in final["epses"]]
                  + [tuple(final["linear"][k].shape) for k in "wb"], f"{f}: shapes {shapes}")
            check(all(np.isfinite(a).all() for a in (*loaded["epses"], *loaded["linear"].values())),
                  f"{f}: non-finite")
        loaded = load_params_npz(os.path.join(out, last[0]))
        check(all(np.array_equal(a, b.detach().cpu().numpy()) for a, b in
                  zip((*loaded["epses"], loaded["linear"]["w"], loaded["linear"]["b"]),
                      (*final["epses"], final["linear"]["w"], final["linear"]["b"]))),
              "the last checkpoint is not the final params")
        # the final checkpoint's logits through the kernels against the plain forward
        from dctn_tpu_torch.interop import params_from_numpy

        model = EPSesPlusLinear.from_reference(params_from_numpy(loaded, dev), state.extras["cfg"])
        gather = state.extras["gather"]
        xb, _ = gather(torch.arange(BATCH, device=dev))
        with torch.inference_mode():
            got, ref = model(xb), model(xb, kernels=K.PLAIN)
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        print(f"runner: final checkpoint's logits vs plain forward (batch {BATCH}): max|d|={err:.3e} "
              f"tol={REL_TOL * scale:.3e}")
        check(torch.isfinite(got).all().item() and err <= REL_TOL * scale,
              "the final checkpoint's logits differ from the plain forward")
        # the runner's step alone: device busy time against wall time
        step, gen = state.extras["step"], state.rng
        idx = torch.arange(BATCH, device=dev)
        step(*gather(idx), gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RUN_PROFILE_STEPS):
            step(*gather(idx), gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / RUN_PROFILE_STEPS
        # None where the profiler showed no device time (not measured)
        busy_ms, top = device_ms_per_call(lambda: step(*gather(idx), gen), RUN_PROFILE_STEPS,
                                          os.path.join(tmp, "runner_profile.txt"), required=False)
        timing = state.extras["timing"]
        print(json.dumps({
            "metric": "runner", "epses_specs": [list(s) for s in FLAGSHIP], "batch_size": BATCH,
            "iterations": timing["iters"],
            "ms_per_iteration": 1e3 * (timing["loop_s"] - timing["hooks_s"]) / timing["iters"],
            "evals": timing["evals"], "ms_per_eval": 1e3 * timing["eval_s"] / timing["evals"],
            "scheduled_hooks_s": timing["hooks_s"], "step_wall_ms": wall_ms,
            "step_device_busy_ms": busy_ms,
            "device_idle_share": None if busy_ms is None else 1 - busy_ms / wall_ms,
            "top_device_ops_ms": top,
        }))
        del model, state, gather, step

        # a run to RUN_RESUME_AT, then resumed from its train state to RUN_ITERS
        _, counts_a, out_a = run_runner(trunner, bench, tmp, "to_resume",
                                        max_num_iters=RUN_RESUME_AT, **main)
        state_file = os.path.join(out_a, "train_state_latest.npz")
        with np.load(state_file) as d:
            check(int(d["step"]) == RUN_RESUME_AT, f"train state at {int(d['step'])}")
        resumed, counts_b, _ = run_runner(trunner, bench, tmp, "resumed", max_num_iters=RUN_ITERS,
                                          resume_from=state_file, **main)
        runs += [counts_a, counts_b]
        check(resumed.num_iters_done == RUN_ITERS, "the resumed run stopped early")
        main_final = final
        resumed_final = final_reference(resumed)
        same = all(torch.equal(a, b) for a, b in zip(
            (*main_final["epses"], main_final["linear"]["w"], main_final["linear"]["b"]),
            (*resumed_final["epses"], resumed_final["linear"]["w"], resumed_final["linear"]["b"])))
        print(f"runner: resumed at {RUN_RESUME_AT} to {RUN_ITERS} vs unbroken: bit-equal {same}")
        check(same, "the resumed run does not end on the unbroken run's bits")
        del resumed, final, main_final, resumed_final

        short = dict(base, synthetic_sizes=RUN_SHORT_SIZES, max_num_iters=RUN_SHORT_ITERS,
                     eval_schedule=((None, RUN_SHORT_EVAL_EVERY),))
        short_evals = RUN_SHORT_ITERS // RUN_SHORT_EVAL_EVERY + 1
        for name, extra, specs, q0, image, frozen in (
            ("qat", {"qat": "int8"}, FLAGSHIP, 2, 28, ()),
            ("dropout_frozen", {"dropout_p": 0.9, "freeze_eps": (1,)}, FLAGSHIP, 2, 28, (1,)),
            ("rgb", {"ds_type": "cifar10_rgb"}, RGB_SPECS, 3, 32, ()),
        ):
            qat = extra.get("qat")
            st, counts, out = run_runner(trunner, bench, tmp, name,
                                         **{**short, **extra, "epses_specs": specs})
            runs.append(counts)
            check(st.stop_reason == "max_iters", f"runner {name} stopped: {st.stop_reason}")
            check_runner_log(out, range(0, RUN_SHORT_ITERS + 1, RUN_SHORT_EVAL_EVERY))
            per = launches_per_step(specs, BATCH, 1, qat, keys, image, q0, frozen)
            want = {k: v * RUN_SHORT_ITERS for k, v in per.items()}
            evals_fwd = short_evals * runner_eval_launches(RUN_SHORT_SIZES, BATCH, len(specs))
            want["eps_fwd" if qat is None else "eps_fwd_q8"] += evals_fwd
            want["eps_fwd"] += runner_init_launches(RUN_SHORT_SIZES[0], BATCH, len(specs))
            check(counts == want, f"runner {name} launches {counts} != {want}")
            if frozen:  # the frozen core stayed bit for bit (no weight decay)
                (first,) = [f for f in os.listdir(out) if f.startswith("model_nitd=0000000")]
                start = load_params_npz(os.path.join(out, first))["epses"][1]
                check(np.array_equal(final_reference(st)["epses"][1].detach().cpu().numpy(), start),
                      "the frozen core moved")
            if name == "rgb":  # K1 at Q₀ = 3 (mma.sync) through the model, against plain
                model = st.extras["model"]
                xb, _ = st.extras["gather"](torch.arange(BATCH, device=dev))
                with torch.inference_mode():
                    got, ref = model(xb), model(xb, kernels=K.PLAIN)
                err, scale = float((got - ref).abs().max()), float(ref.abs().max())
                print(f"runner rgb: logits vs plain forward (Q0 = 3, batch {BATCH}): "
                      f"max|d|={err:.3e} tol={REL_TOL * scale:.3e}")
                check(err <= REL_TOL * scale, "colored logits differ from the plain forward")
    return runs


def trace_kernels(path: str) -> dict:
    """Which of TRACE_KERNELS a torch.profiler trace names."""
    with open(path) as f:
        text = f.read()
    return {pat: re.search(pat, text) is not None for pat in TRACE_KERNELS}


def read_metrics(out: str) -> dict:
    """metrics.jsonl's records by step."""
    by_step = {}
    with open(os.path.join(out, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            by_step.setdefault(rec["step"], []).append(rec)
    return by_step


def check_finite_records(records, what: str) -> None:
    check(all(math.isfinite(v) for r in records for v in r.values() if isinstance(v, float)),
          f"{what}: a non-finite number in metrics.jsonl")


def runner_tooling_phase(trunner, bench, K, dev) -> list:
    """Phase 4c: the EPS runner's tooling on the card. The README quick start
    for RUN_TB_ITERS iterations with ``--tb-batches``,
    ``--log-intermediate-outputs`` and ``--profile-dir`` over
    RUN_PROFILE_ITERS: launches exact (the steps, evals and init, and K1
    once per layer per intermediate-outputs log on the probe), the
    metrics.jsonl records of every scheduled iteration, a trace that names
    K1+t, ``eps_dcore`` and the d_views kernel (a trace may drop events: the
    step's window is taken again, at most PROFILE_TRIES in all), and the ms
    of each logging hook and of the profiled window's iterations. Then the
    xla backends (the reference layout through torch.matmul) for
    RUN_SHORT_ITERS iterations at TRAJ_LR: no EPS kernel launched, and each
    parameter's move within TRAJ_NORM_TOL of the kernel path's from the same
    init. Returns the runs' launch counts."""
    from dctn_tpu_torch.train import load_params_npz
    from dctn_tpu_torch.utils.profiling import trace, trace_files

    base = dict(ds_type="fashionmnist", ds_path="synthetic", batch_size=BATCH,
                optimizer_name="adam", epses_specs=FLAGSHIP)
    keys = tuple(bench.read_counters())
    per_step = launches_per_step(FLAGSHIP, BATCH, 1, None, keys)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        prof_dir = os.path.join(tmp, "prof")
        same = dict(max_num_iters=RUN_TB_ITERS, lr=3e-3, synthetic_sizes=RUN_SIZES,
                    init_epses_composition_unit_empirical_output_std=True,
                    eval_schedule=((None, RUN_TB_EVAL_EVERY),), **base)
        logged = list(range(0, RUN_TB_ITERS, RUN_TB_EVAL_EVERY))
        evals = RUN_TB_ITERS // RUN_TB_EVAL_EVERY + 1
        want = {k: v * RUN_TB_ITERS for k, v in per_step.items()}
        want["eps_fwd"] += (runner_init_launches(RUN_SIZES[0], BATCH, 2)
                            + evals * runner_eval_launches(RUN_SIZES, BATCH, 2))
        # the same run without the tooling, for its ms per iteration
        control, counts, _ = run_runner(trunner, bench, tmp, "no_tooling", **same)
        runs.append(counts)
        check(counts == want, f"no_tooling run launches {counts} != {want}")
        control_ms = 1e3 * (control.extras["timing"]["loop_s"]
                            - control.extras["timing"]["hooks_s"]) / RUN_TB_ITERS
        del control
        state, counts, out = run_runner(
            trunner, bench, tmp, "tooling", tb_batches=True, log_intermediate_outputs=True,
            profile_dir=prof_dir, profile_iters=RUN_PROFILE_ITERS, **same)
        runs.append(counts)
        check(state.stop_reason == "max_iters" and state.num_iters_done == RUN_TB_ITERS,
              f"the tooling run stopped: {state.stop_reason} at {state.num_iters_done}")
        check_runner_log(out, range(0, RUN_TB_ITERS + 1, RUN_TB_EVAL_EVERY))
        want["eps_fwd"] += 2 * len(logged)
        check(counts == want, f"tooling run launches {counts} != {want} (per step {per_step}, "
              f"{evals} evals, the init, {len(logged)} intermediate-outputs logs of 2 layers)")
        by_step = read_metrics(out)
        check(sorted(by_step) == logged, f"metrics.jsonl steps {sorted(by_step)} != {logged}")
        for it in logged:
            tags = [r["tag"] for r in by_step[it]]
            inter = [t for t in tags if t.startswith("intermediate_")]
            check(all(tags.count(t) == 1 for t in ("loss", "reg_term", "probs_of_true_class",
                                                   "batch")), f"iteration {it}: records {tags}")
            check(len(inter) == INTERMEDIATE_RECORDS
                  and {t.split("/")[1] for t in inter} == {"eps_0", "eps_1", "linear"},
                  f"iteration {it}: intermediate records {inter}")
            check_finite_records(by_step[it], f"iteration {it}")
        events = [f for f in os.listdir(out) if f.startswith("events.out.tfevents")]
        print(f"runner tooling: TensorBoard event files beside metrics.jsonl: {events} "
              "(written where torch.utils.tensorboard imports)")
        hist = [r for r in by_step[logged[-1]] if r["tag"] == "probs_of_true_class"][0]
        check(0.0 <= hist["hist_min"] <= hist["hist_max"] <= 1.0, f"probabilities {hist}")
        files = trace_files(prof_dir)
        check(len(files) == 1, f"the profiled window wrote {files}")
        found = trace_kernels(files[0])
        tries = 1
        step, gather, gen = state.extras["step"], state.extras["gather"], state.rng
        idx = torch.arange(BATCH, device=dev)
        while not all(found.values()) and tries < PROFILE_TRIES:
            again = os.path.join(tmp, f"prof_{tries}")
            with trace(again):
                for _ in range(RUN_PROFILE_ITERS[1]):
                    step(*gather(idx), gen)
            found = {k: v or trace_kernels(trace_files(again)[0])[k] for k, v in found.items()}
            tries += 1
        print(f"runner tooling: trace {os.path.basename(files[0])} "
              f"({os.path.getsize(files[0])} bytes) names {found} in {tries} window(s)")
        check(all(found.values()), f"the runner's trace lacks kernels: {found}")
        timing = state.extras["timing"]
        window = timing["profile_window"]
        hooks = {name: [1e3 * sec for sec in calls] for name, calls in timing["hook_s"].items()}
        record = {
            "metric": "runner_tooling", "epses_specs": [list(s) for s in FLAGSHIP],
            "batch_size": BATCH, "iterations": timing["iters"],
            "ms_per_iteration": 1e3 * (timing["loop_s"] - timing["hooks_s"]) / timing["iters"],
            "ms_per_iteration_without_tooling": control_ms,
            "tb_batches_ms": hooks["tb_batches"],
            "intermediate_outputs_ms": hooks["intermediate_outputs"],
            "profiler_start_stop_ms": hooks["profiler"],
            "logging_ms_per_iteration": (sum(hooks["tb_batches"])
                                         + sum(hooks["intermediate_outputs"])) / timing["iters"],
            "profiled_window_iterations": window["iterations"],
            "profiled_ms_per_iteration": 1e3 * window["s"] / window["iterations"],
            "trace_export_s": window["export_s"],
        }
        print(json.dumps(record))
        check(window["iterations"] == RUN_PROFILE_ITERS[1] and len(hooks["profiler"]) == 2,
              f"profiled window {window}, its hook's calls {hooks['profiler']}")
        check(len(hooks["tb_batches"]) == len(hooks["intermediate_outputs"]) == len(logged),
              f"logging calls {hooks}")
        del state, step, gather, gen

        # the xla backends against the kernel path from one theoretical init
        short = dict(base, synthetic_sizes=RUN_SHORT_SIZES, max_num_iters=RUN_SHORT_ITERS,
                     eval_schedule=((None, RUN_SHORT_EVAL_EVERY),), lr=TRAJ_LR,
                     init_epses_composition_unit_theoretical_output_std=True)
        short_evals = RUN_SHORT_ITERS // RUN_SHORT_EVAL_EVERY + 1
        st_k, counts_k, out_k = run_runner(trunner, bench, tmp, "kernel_lr", **short)
        st_x, counts_x, out_x = run_runner(trunner, bench, tmp, "xla", train_backend="xla",
                                           eval_backend="xla", **short)
        runs += [counts_k, counts_x]
        want = {k: v * RUN_SHORT_ITERS for k, v in per_step.items()}
        # the statistics at start push the init subset through each layer in
        # slices of half the batch
        want["eps_fwd"] += (short_evals * runner_eval_launches(RUN_SHORT_SIZES, BATCH, 2)
                            + 2 * math.ceil(RUN_SHORT_SIZES[0] / (BATCH // 2)))
        check(counts_k == want, f"kernel_lr launches {counts_k} != {want}")
        check(all(v == 0 for v in counts_x.values()), f"the xla run launched {counts_x}")
        check_runner_log(out_x, range(0, RUN_SHORT_ITERS + 1, RUN_SHORT_EVAL_EVERY))
        (first,) = [f for f in os.listdir(out_k) if f.startswith("model_nitd=0000000")]
        (first_x,) = [f for f in os.listdir(out_x) if f.startswith("model_nitd=0000000")]
        start, start_x = (load_params_npz(os.path.join(o, f)) for o, f in ((out_k, first),
                                                                             (out_x, first_x)))
        fin_k, fin_x = final_reference(st_k), final_reference(st_x)
        leaves = lambda p: (*p["epses"], p["linear"]["w"], p["linear"]["b"])  # noqa: E731
        check(all(np.array_equal(a, b) for a, b in zip(leaves(start), leaves(start_x))),
              "the xla and the kernel run start from other weights")
        worst = 0.0
        for i, (a, b, s0) in enumerate(zip(leaves(fin_x), leaves(fin_k), leaves(start))):
            s0 = torch.as_tensor(s0, device=dev).double()
            move_x, move_k = a.double() - s0, b.double() - s0
            share = float(torch.linalg.vector_norm(move_x - move_k)
                          / torch.linalg.vector_norm(move_k))
            worst = max(worst, share)
            print(f"xla vs kernels after {RUN_SHORT_ITERS} iterations, parameter {i}: "
                  f"||move_x - move_k|| / ||move_k|| = {share:.3e} (tol {TRAJ_NORM_TOL:g}), "
                  f"max|d| = {float((move_x - move_k).abs().max()):.3e}")
            check(share <= TRAJ_NORM_TOL, f"the xla run's parameter {i} moved elsewhere")
        tk, tx = st_k.extras["timing"], st_x.extras["timing"]
        print(json.dumps({
            "metric": "runner_xla", "iterations": RUN_SHORT_ITERS, "worst_move_share": worst,
            "xla_ms_per_iteration": 1e3 * (tx["loop_s"] - tx["hooks_s"]) / tx["iters"],
            "kernel_ms_per_iteration": 1e3 * (tk["loop_s"] - tk["hooks_s"]) / tk["iters"],
        }))
    return runs


# ---------------------------------------------------------------------------
# the legacy ConvSBS family (phases 2b, 6 and 7)


def sbs_case(S, CSM, dev, layer, trace_edge, batch, seed=SEED):
    """One string of the legacy 2-layer bond-4 model at ``batch`` (layer 0:
    q^C = 2, o = 2 on the middle core, 26×26 windows; layer 1: q^C = 4,
    o = 10, 24×24): factors uniform in [0, 1), cores scaled so every m
    element is of order 1/bond, a normal output cotangent."""
    olr, qc = sbs_string(S, CSM, layer, trace_edge)
    side = 28 - 2 * (layer + 1)
    return sbs_operands(dev, olr, qc, batch * side * side, seed)


def sbs_string(S, CSM, layer, trace_edge):
    """The per-core (o, l, r) and q^C of a string of the legacy model's
    ``layer``."""
    spec = CSM.ConvSBSModelConfig(SBS_LAYERS, SBS_BOND, trace_edge=trace_edge).layer_specs()[layer][0]
    olr, qc, ok = S.sbs_supported(spec)
    check(ok, f"legacy layer {layer} outside the kernels' support")
    return olr, qc


def sbs_operands(dev, olr, qc, npix, seed=SEED):
    """``sbs_case``'s operands for the string ``olr`` at q^C ``qc`` over
    ``npix`` pixels."""
    g_ = torch.Generator(device=dev).manual_seed(seed)
    views = torch.rand((len(olr), qc, npix), generator=g_, device=dev)
    scale = 1.0 / (SBS_BOND * (qc / 3) ** 0.5)
    cores = [torch.randn((l * r * o, qc), generator=g_, device=dev) * scale for o, l, r in olr]
    g = torch.randn((math.prod(o for o, _, _ in olr), npix), generator=g_, device=dev)
    return olr, views, cores, g


def sbs_fold_fmas(olr, mcut):
    """FMAs per pixel of one string's forward: every m element once
    (Σ l·r·o·q^C, with q^C folded in by the caller), the prefix and suffix
    folds, and the merge (for the sequential fold, mcut None: the fold of
    every core and the ring trace)."""
    P, b0 = len(olr), olr[0][1]
    cut = P if mcut is None else mcut
    fmas, o_pre = 0, olr[0][0]
    for i in range(1, cut):
        o, l, r = olr[i]
        fmas += b0 * l * r * o_pre * o
        o_pre *= o
    o_suf = 1
    for i in range(P - 1, cut - 1, -1):
        o, l, r = olr[i]
        fmas += l * b0 * r * o * o_suf
        o_suf *= o
    rm = olr[cut][1] if cut < P else b0
    return fmas + b0 * rm * o_pre * o_suf


def sbs_toward_output_fmas(olr, qc, c):
    """FMAs per pixel of the forward's register route beyond the m elements:
    both ends folded toward the output core c (the b0 × bond states), their
    join over b0, and the output core's contraction with q^C views."""
    b0 = olr[0][1]
    fold = sum(b0 * l * r for i, (_, l, r) in enumerate(olr) if i != c)
    oc, lc, rc = olr[c]
    return fold + b0 * lc * rc + oc * qc


def sbs_work(olr, qc, npix, mcut, backward, need_dviews, reg_c=None):
    """(bytes, flops) of one call: each input read once and each output
    written once; the forward's FMAs (m, fold, merge; with ``reg_c`` the
    register route's order, folded toward that output core), and for the
    backward the forward's again (the states it reverses), twice the fold and
    merge (the two transposes of each step) and the d_core (and d_view)
    FMAs."""
    rows = sum(o * l * r for o, l, r in olr)
    m_fmas = rows * qc
    fold = (sbs_fold_fmas(olr, mcut) if reg_c is None or backward
            else sbs_toward_output_fmas(olr, qc, reg_c))
    o_total = math.prod(o for o, _, _ in olr)
    views, cores = len(olr) * qc * npix, rows * qc
    if not backward:
        return 4.0 * (views + cores + o_total * npix), 2.0 * npix * (m_fmas + fold)
    nbytes = 4.0 * (views + 2 * cores + o_total * npix + (views if need_dviews else 0))
    return nbytes, 2.0 * npix * (m_fmas * (2 + need_dviews) + 3 * fold)


def sbs_library_fwd(views, cores, olr):
    """The string's forward as one ``torch.einsum`` over the views and the
    cores (l, r, o, q^C each; the ring bond closes the trace): the library
    call beside ``sbs_fwd``, timed here and used nowhere in the port. It
    contracts its operands from left to right (core 0, view 0, core 1, ...),
    so each intermediate is a (b0, bond, outputs so far, pixels) state; the
    path opt_einsum picks when it is installed multiplies the views together
    first (140 GiB at layer 0 of the legacy model at batch 100 on an H100)."""
    P = len(olr)
    letters = iter("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXY")
    bond = [next(letters) for _ in range(P)]  # bond i: the left bond of core i
    ops, terms, outs = [], [], []
    for i, ((o, l, r), core) in enumerate(zip(olr, cores)):
        j, oo = next(letters), next(letters)
        ops += [core.reshape(l, r, o, -1), views[i]]
        terms += [bond[i] + bond[(i + 1) % P] + oo + j, j + "Z"]
        outs.append(oo)
    with torch.backends.opt_einsum.flags(enabled=False):
        out = torch.einsum(",".join(terms) + "->" + "".join(outs) + "Z", *ops)
    return out.reshape(-1, views.shape[2])


def sbs_fwd_route(S, olr, qc, mcut):
    """The forward's route for the string, and the register route's output
    core (None on the shared-memory route)."""
    route, plan = S._fwd_route(tuple(olr), qc, mcut)
    return route, (plan.c if route == "registers" else None)


def sbs_kernels_vs_plain(S, CSM, dev):
    """Phase 2b: the ConvSBS kernels against their plain versions at both
    legacy layer shapes, open and ring, batch 100 and 512: the forward and
    the backward (with and without d_views) of the meet-in-the-middle fold
    at the model's merge position (K10, K11) and of the sequential fold
    (K12); then every merge position at layer 1, ring, batch 100. Returns
    the JSON numbers of each kernel: max |Δ| over every shape, and its
    kernel, plain and bound times summed over one training step of the
    model at batch 100 with open strings (each of layer 0's two strings
    without d_views, layer 1's with them; the sequential fold's step is
    phase 7's sequential path). The forward's times are device time per
    call (torch.profiler), with its library time (``sbs_library_fwd``); the
    backward's are CUDA-event times of one call."""
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "library_ms": 0.0 if k.startswith("sbs_fwd") else None,
               "timed_by": DEVICE_TIME if k.startswith("sbs_fwd") else CUDA_EVENTS,
               "bytes": 0.0, "flops": 0.0} for k in SBS_KERNELS}
    worst = {}
    fwd_timed_by = {k: set() for k in SBS_KERNELS if k.startswith("sbs_fwd")}

    def held(name, label, got, ref):
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        check(got.shape == ref.shape, f"{name} [{label}]: shape {tuple(got.shape)}")
        check(torch.isfinite(got).all().item(), f"{name} [{label}]: non-finite")
        check(err <= SBS_TOL * scale, f"{name} [{label}]: differs from plain by {err} "
                                      f"(max|ref| {scale})")
        res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
        worst[name] = max(worst.get(name, 0.0), err / scale)
        return f"{err:.3e}/{scale:.3e}"

    for layer in (0, 1):
        for trace_edge in (False, True):
            for batch in SBS_BATCHES:
                olr, views, cores, g = sbs_case(S, CSM, dev, layer, trace_edge, batch)
                qc, npix = views.shape[1], views.shape[2]
                on_path = batch == 100 and not trace_edge
                for fam, mcut in (("mim", SBS_MCUT), ("seq", None)):
                    label = (f"layer {layer} {'ring' if trace_edge else 'open'} batch {batch} "
                             f"{fam} npix={npix}")
                    name = f"sbs_fwd_{fam}"

                    def kern():
                        return S.sbs_fwd(views, cores, olr, mcut)

                    def plain():
                        return S.sbs_fwd_reference(views, cores, olr, mcut)

                    def library():
                        return sbs_library_fwd(views, cores, olr)

                    route, reg_c = sbs_fwd_route(S, olr, qc, mcut)
                    ref = plain()
                    errs = held(name, label, kern(), ref)
                    lib_err = float((library() - ref).abs().max() / ref.abs().max())
                    del ref
                    # device time per call: the kernel's launch takes a few µs of
                    # device time, less than the host's work around it
                    (t_k, t_p, t_l), way = device_or_event_ms(
                        (kern, plain, library), SBS_FWD_PROFILE_CALLS, f"{name} [{label}]")
                    nbytes, flops = sbs_work(olr, qc, npix, mcut, False, False, reg_c)
                    print(f"{name} vs plain [{label}, {route} route]: max|d|/max|ref| {errs} "
                          f"(tol {SBS_TOL:g}*max|ref|); ms per call ({way}): kernel {t_k:.6f}, "
                          f"plain {t_p:.6f}, library (one torch.einsum) {t_l:.6f} (its "
                          f"max|d|/max|ref| {lib_err:.3e}); bound {bound_ms(nbytes, flops)[0]:.6f} ms")
                    if on_path:
                        fwd_timed_by[name].add(way)
                        for _ in range(2 if layer == 0 else 1):
                            r = res[name]
                            r["ms"] += t_k
                            r["plain_ms"] += t_p
                            r["library_ms"] += t_l
                            r["bytes"] += nbytes
                            r["flops"] += flops
                    name = f"sbs_bwd_{fam}"
                    for need in (True, False):

                        def kern():
                            return S.sbs_bwd(views, cores, g, olr, mcut, need)

                        def plain():
                            return S.sbs_bwd_reference(views, cores, g, olr, mcut, need)

                        (dv, dc), (rdv, rdc) = kern(), plain()
                        errs = [held(name, f"{label} d_core {i}", a, b)
                                for i, (a, b) in enumerate(zip(dc, rdc))]
                        if batch == max(SBS_BATCHES):
                            # a fixed number of CTAs, partials added in order
                            dv2, dc2 = kern()
                            check(all(torch.equal(a, b) for a, b in zip(dc2, dc))
                                  and (not need or torch.equal(dv2, dv)),
                                  f"{name} [{label} need_dviews={need}]: a second run gave "
                                  f"other bits")
                            del dv2, dc2
                        check((dv is None) != need, f"{name} [{label}]: d_views with need={need}")
                        if need:
                            errs.append(held(name, f"{label} d_views", dv, rdv))
                        del dv, dc, rdv, rdc
                        t_k, t_p = median_ms([kern, plain], reps=10)
                        nbytes, flops = sbs_work(olr, qc, npix, mcut, True, need)
                        print(f"{name} vs plain [{label} need_dviews={need}]: max|d|/max|ref| "
                              f"worst {max(errs, key=lambda e: float(e.split('/')[0]))} "
                              f"(tol {SBS_TOL:g}*max|ref|); kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                              f"bound {bound_ms(nbytes, flops)[0]:.4f} ms")
                        if on_path and need == (layer == 1):
                            for _ in range(2 if layer == 0 else 1):
                                r = res[name]
                                r["ms"] += t_k
                                r["plain_ms"] += t_p
                                r["bytes"] += nbytes
                                r["flops"] += flops
                del views, cores, g
    olr, views, cores, g = sbs_case(S, CSM, dev, 1, True, 100)
    for mcut in range(1, len(olr)):
        label = f"layer 1 ring batch 100 mcut={mcut}"
        held("sbs_fwd_mim", label, S.sbs_fwd(views, cores, olr, mcut),
             S.sbs_fwd_reference(views, cores, olr, mcut))
        (dv, dc), (rdv, rdc) = (S.sbs_bwd(views, cores, g, olr, mcut, True),
                                S.sbs_bwd_reference(views, cores, g, olr, mcut, True))
        held("sbs_bwd_mim", f"{label} d_views", dv, rdv)
        for i, (a, b) in enumerate(zip(dc, rdc)):
            held("sbs_bwd_mim", f"{label} d_core {i}", a, b)
        print(f"sbs every merge position [{label}]: forward and backward held")
    del views, cores, g, dv, dc, rdv, rdc
    # a string outside the register route: layer 1's ring with its ten
    # outputs on two cores (2 on core 3, 5 on core 4), at layer 1's pixels at
    # batch 100; it holds the shared-memory kernel against the plain fold
    olr, qc = sbs_string(S, CSM, 1, True)
    olr = tuple((2 if i == 3 else 5 if i == 4 else o, l, r) for i, (o, l, r) in enumerate(olr))
    olr, views, cores, _ = sbs_operands(dev, olr, qc, 100 * 24 * 24)
    for mcut in (*range(1, len(olr)), None):
        fam = "seq" if mcut is None else "mim"
        label = f"layer 1 ring, outputs on cores 3 and 4, batch 100 mcut={mcut}"
        route, _ = sbs_fwd_route(S, olr, qc, mcut)
        check(route == "shared", f"sbs_fwd [{label}]: the {route} route, not the shared-memory one")
        held(f"sbs_fwd_{fam}", label, S.sbs_fwd(views, cores, olr, mcut),
             S.sbs_fwd_reference(views, cores, olr, mcut))
        print(f"sbs_fwd_{fam} vs plain [{label}, {route} route]: held")
    del views, cores
    print(f"ConvSBS kernels vs plain, largest max|d|/max|ref| per kernel: {worst} "
          f"(tolerance {SBS_TOL:g})")
    for name, ways in fwd_timed_by.items():
        res[name]["timed_by"] = timed_by_of(ways)
    for r in res.values():
        r["bound_ms"], r["bound_by"] = bound_ms(r.pop("bytes"), r.pop("flops"))
    return res


def lme_operands(LSC, dev, theta, r, i, offset, neg_inf):
    """One case's (log_a, log_b): normal · 3 with the offsets, and with
    ``neg_inf`` a −inf row of A, a −inf column of B and a tenth of the other
    entries −inf; for the classifier's step (offset None) its real
    operands, the features of 256 synthetic images and the block-diagonal
    weights of the seeded init."""
    g_ = torch.Generator(device=dev).manual_seed(SEED)
    if offset is None:
        from dctn_tpu_torch.data import io as data_io

        x = torch.as_tensor(data_io.synthetic_mnist_like(theta, seed=1234)[0], device=dev)
        log_w = LSC.init_log_w(torch.Generator().manual_seed(SEED)).to(dev)
        return LSC.features(x).reshape(theta, r), LSC.block_diagonal(log_w)
    la = torch.randn((theta, r), generator=g_, device=dev) * 3 + offset
    lb = torch.randn((r, i), generator=g_, device=dev) * 3 - offset
    if neg_inf:
        la[3] = -math.inf
        lb[:, 5] = -math.inf
        la[torch.rand((theta, r), generator=g_, device=dev) < 0.1] = -math.inf
        lb[torch.rand((r, i), generator=g_, device=dev) < 0.1] = -math.inf
    return la, lb


def lme_limit_share(got, ref, r, amax, bmax):
    """K13's output against its plain version's, on the entries where the
    plain version is finite: (max |Δ|, the largest share of the per-entry
    limit LME_WALK·2⁻²⁴·√R + LME_ULPS·2⁻²⁴·max(|ref|, |amax| + |bmax|))."""
    fin = torch.isfinite(ref)
    if not bool(fin.any()):
        return 0.0, 0.0
    shift = (amax.abs() + bmax.abs()).expand_as(ref)[fin]
    tol = 2.0**-24 * (LME_WALK * math.sqrt(r) + LME_ULPS * torch.maximum(ref[fin].abs(), shift))
    diff = (got[fin] - ref[fin]).abs()
    return float(diff.max()), float((diff / tol).max())


def lme_forward_kernels(L, la, lb) -> tuple:
    """The device kernels of one forward of ``logmatmulexp_kernel`` (no
    gradient), by name, from torch.profiler, and the forwards run. A window
    with fewer device events than the forward's two (shifts, product) is
    taken again, at most PROFILE_TRIES times: the profiler now and then
    drops an event (a window showed the product alone while both wrappers
    counted their launch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.no_grad():
                L.logmatmulexp_kernel(la, lb)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
        if len(names) >= 2:
            break
    return names, tries


def lme_kernel_vs_plain(L, LSC, max_shifts, dev):
    """Phase 2c: K13 against its plain version at every case of LME_SHAPES,
    with the −inf outputs exact, no NaN, and the same bits on a second run;
    the shifts kernel against ``max_shifts`` bit for bit; one forward of
    ``logmatmulexp_kernel`` is two launches (the shifts and the product) and
    two device kernels. Device times per call (``device_ms_per_call``) and
    median CUDA-event times of one call, of the kernels, their plain versions
    and the product's library call (``torch.matmul`` of the materialized
    exponentials, cuBLAS f32), beside the bound. Returns the JSON numbers of
    both kernels: max |Δ| over every finite output (the shifts: over every
    shift), and times summed over one chain forward (5 links) and one
    classifier step (1 call), K13's work in one iteration of each entry."""
    res = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "timed_by": DEVICE_TIME, "bytes": 0.0, "flops": 0.0}
    res_s = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
             "timed_by": DEVICE_TIME, "bytes": 0.0}
    on_path = {"chain link": 5, "classifier step": 1}
    worst = {}
    ways, s_ways = set(), set()
    for label, theta, r, i, offset, neg_inf in LME_SHAPES:
        la, lb = lme_operands(LSC, dev, theta, r, i, offset, neg_inf)
        theta, r, i = la.shape[0], la.shape[1], lb.shape[1]
        amax, bmax = max_shifts(la, lb)
        ea, eb = torch.exp(la - amax), torch.exp(lb - bmax)
        tag = f"logmatmulexp [{label}] ({theta}, {r}, {i})"
        # the shifts kernel: the same bits as max_shifts, −inf rows and
        # columns included (their shift is 0)
        got_a, got_b = L.logmatmulexp_shifts(la, lb)
        torch.cuda.synchronize()
        check(torch.equal(got_a, amax) and torch.equal(got_b, bmax),
              f"{tag}: the shifts kernel differs from max_shifts")
        res_s["max_abs_err"] = max(res_s["max_abs_err"], float((got_a - amax).abs().max()),
                                   float((got_b - bmax).abs().max()))
        # one forward: the shifts kernel and the product, two launches and
        # two device kernels (no torch op around them), after a first forward
        # (the first on a device also allocates the kernels' persistent zeroed
        # arrival counters, once)
        with torch.no_grad():
            L.logmatmulexp_kernel(la, lb)
        before = (L.logmatmulexp_shifts.launches, L.logmatmulexp_fwd.launches)
        names, forwards = lme_forward_kernels(L, la, lb)
        launched = (L.logmatmulexp_shifts.launches - before[0],
                    L.logmatmulexp_fwd.launches - before[1])
        check(launched == (forwards, forwards) and len(names) == 2,
              f"{tag}: {forwards} forwards launched {launched} (shifts, product), device "
              f"kernels {names}")

        def kern():
            return L.logmatmulexp_fwd(la, lb, amax, bmax)

        def plain():
            return L.logmatmulexp_fwd_reference(la, lb, amax, bmax)

        got, ref = kern(), plain()
        torch.cuda.synchronize()
        check(got.shape == ref.shape, f"{tag}: shape {tuple(got.shape)}")
        check(not torch.isnan(got).any().item(), f"{tag}: NaN in the output")
        check(torch.equal(torch.isneginf(got), torch.isneginf(ref)),
              f"{tag}: -inf outputs differ from the plain version's")
        err, share = lme_limit_share(got, ref, r, amax, bmax)
        check(share <= 1.0, f"{tag}: differs from plain by {err} ({share:.3f} of its limit)")
        check(torch.equal(kern(), got), f"{tag}: a second run gave other bits")
        worst[label] = share
        n_inf = int((~torch.isfinite(ref)).sum())
        res["max_abs_err"] = max(res["max_abs_err"], err)
        fns = [kern, plain, lambda: torch.matmul(ea, eb)]
        call_ms = median_ms(fns, reps=10)
        (t_k, t_p, t_l), way = device_or_event_ms(fns, LME_PROFILE_CALLS, tag)
        (s_k, s_p), s_way = device_or_event_ms(
            (lambda: L.logmatmulexp_shifts(la, lb), lambda: max_shifts(la, lb)),
            LME_PROFILE_CALLS, f"{tag} shifts")
        nbytes, flops = 4.0 * (theta * r + r * i + theta * i), 2.0 * theta * r * i
        s_bytes = 4.0 * (theta * r + r * i + theta + i)
        b_ms, by = bound_ms(nbytes, mm_flops=flops)
        print(f"{tag}: max|d| {err:.3e}, {share:.4f} of the limit ({LME_WALK}*2^-24*sqrt(R) + "
              f"{LME_ULPS}*2^-24*max(|ref|, |amax|+|bmax|) per entry), {n_inf} "
              f"outputs exactly -inf as plain, no NaN, same bits twice; shifts kernel equal to "
              f"max_shifts; a forward: device kernels {names}; ms per call ({way}; the shifts "
              f"{s_way}): "
              f"kernel {t_k:.4f} ms ({flops / t_k / 1e9:.2f} TFLOP/s), plain {t_p:.4f} ms, "
              f"library torch.matmul of the exponentials {t_l:.4f} ms, shifts kernel {s_k:.4f} "
              f"ms, max_shifts {s_p:.4f} ms; one call between CUDA "
              f"events (the host's launch included): kernel {call_ms[0]:.4f} ms, plain "
              f"{call_ms[1]:.4f} ms, library {call_ms[2]:.4f} ms; bound {b_ms:.4f} ms ({by}), "
              f"splits of R {L._splits(theta, r, i)}")
        if label in on_path:
            ways.add(way)
            s_ways.add(s_way)
        for _ in range(on_path.get(label, 0)):
            res["ms"] += t_k
            res["plain_ms"] += t_p
            res["library_ms"] += t_l
            res["bytes"] += nbytes
            res["flops"] += flops
            res_s["ms"] += s_k
            res_s["plain_ms"] += s_p
            res_s["bytes"] += s_bytes
        del la, lb, amax, bmax, ea, eb, got, ref
    print(f"K13 vs plain, largest share of the per-entry limit by case: {worst}")
    res["timed_by"], res_s["timed_by"] = timed_by_of(ways), timed_by_of(s_ways)
    res["bound_ms"], res["bound_by"] = bound_ms(res.pop("bytes"), mm_flops=res.pop("flops"))
    res_s["bound_ms"], res_s["bound_by"] = bound_ms(res_s.pop("bytes"))
    return {"logmatmulexp": res, "logmatmulexp_shifts": res_s}


def lme_chain_phase(bench, dev):
    """Phase 8: ``bench.run_logmatmulexp``, the chain of
    experiments/logmatmulexp_benchmark.py (6 × 256×256 f32): K13 launched 5
    times per forward and per forward+backward of the kernel form, by no
    other form. Then, outside the counted run, the chain's output and its
    six gradients (of sum(out²)) on the kernel form against the plain
    max-shift form. Returns the launches of K13 and of its shifts kernel
    (one per forward) in the run."""
    bench.zero_counters()
    t0 = time.perf_counter()
    recs = bench.run_logmatmulexp(device="cuda")
    launches, shifts = bench.read_lme_launches(), bench.read_lme_shift_launches()
    print(f"logmatmulexp chain bench: {time.perf_counter() - t0:.1f} s, K13 launches {launches}, "
          f"its shifts kernel's {shifts}")
    links = bench.CHAIN - 1
    runs = 0
    for rec in recs:
        want = links if rec["function"] == "logmatmulexp_kernel" else 0
        check(rec["launches_per_forward"] == want and rec["launches_per_forward_backward"] == want,
              f"chain {rec['function']}: K13 launches per forward / forward+backward "
              f"{rec['launches_per_forward']} / {rec['launches_per_forward_backward']} != {want}")
        runs += want * 2 * (rec["warmup"] + rec["num_iterations"])
        print(f"chain {rec['function']}: forward {1e3 * rec['forward_seconds_per_iteration']:.4f} "
              f"ms, forward+backward {1e3 * rec['forward_backward_seconds_per_iteration']:.4f} ms, "
              f"K13 launches {rec['launches_per_forward']} / {rec['launches_per_forward_backward']}")
    check(launches == runs and shifts == runs,
          f"chain bench: K13 launches {launches}, shifts {shifts} != {runs}")
    mats = bench.chain_inputs(dev)
    outs, grads = [], []
    for name in ("logmatmulexp_kernel", "logmatmulexp"):
        leaves = [m.clone().requires_grad_(True) for m in mats]
        out = bench.CHAIN_VARIANTS[name](*leaves)
        grads.append([g.detach() for g in torch.autograd.grad(torch.sum(out**2), leaves)])
        outs.append(out.detach())
    err, scale = float((outs[0] - outs[1]).abs().max()), float(outs[1].abs().max())
    print(f"chain output, kernel vs plain max-shift form: max|d| {err:.3e} (max|ref| {scale:.3e})")
    check(err <= LME_GRAD_TOL * scale, "chain output differs from the plain form's")
    gap = compare_gradients(grads, LME_GRAD_TOL, "chain of 6, kernel vs plain max-shift form")
    print(f"chain gradients: largest max|d|/max|ref| {gap:.3e} (limit {LME_GRAD_TOL:g})")
    return {"logmatmulexp": launches, "logmatmulexp_shifts": shifts}


def log_space_phase(bench, LSC, dev):
    """Phase 9: ``bench.run_log_space`` at its defaults (600 Adam 3e-2
    steps at batch 256, 4096/1024 synthetic images): K13 launched once per
    step of the ``fused_kernel`` form and once for its accuracy forward, by
    no other form; the forms agree within 0.02 in accuracy with finite
    weights (the bench raises otherwise). Then, outside the counted run,
    one step's log_w gradient on the kernel form against ``fused_plain``.
    Returns the launches of K13 and of its shifts kernel (one per forward)
    in the run."""
    bench.zero_counters()
    t0 = time.perf_counter()
    recs = bench.run_log_space(device="cuda")
    launches, shifts = bench.read_lme_launches(), bench.read_lme_shift_launches()
    print(f"log-space classifier bench: {time.perf_counter() - t0:.1f} s, K13 launches {launches}, "
          f"its shifts kernel's {shifts}")
    for rec in recs:
        want = 1 if rec["variant"] == "fused_kernel" else 0
        check(rec["logmatmulexp_launches_per_step"] == want
              and rec["logmatmulexp_launches_accuracy"] == want,
              f"log_space {rec['variant']}: K13 launches per step / accuracy "
              f"{rec['logmatmulexp_launches_per_step']} / {rec['logmatmulexp_launches_accuracy']}")
        check(all(math.isfinite(rec[k]) for k in ("first_loss", "last_loss", "step_ms")),
              f"log_space {rec['variant']}: non-finite metrics")
        print(f"log_space {rec['variant']}: val acc {rec['val_acc']:.4f}, {rec['step_ms']:.4f} "
              f"ms/step, loss {rec['first_loss']:.6f} -> {rec['last_loss']:.6f}")
    check(launches == bench.LOG_SPACE_STEPS + 1 and shifts == launches,
          f"log_space: K13 launches {launches}, shifts {shifts} != {bench.LOG_SPACE_STEPS + 1}")
    lf, y, _, _ = bench.log_space_data(dev)
    rows = torch.as_tensor(
        np.random.default_rng(0).integers(0, lf.shape[0], bench.LOG_SPACE_BATCH), device=dev)
    grads = []
    for name in ("fused_kernel", "fused_plain"):
        log_w = LSC.init_log_w(torch.Generator().manual_seed(SEED)).to(dev).requires_grad_(True)
        loss = torch.nn.functional.cross_entropy(
            bench.LOG_SPACE_VARIANTS[name](log_w, lf[rows]), y[rows])
        grads.append(list(torch.autograd.grad(loss, [log_w])))
    gap = compare_gradients(grads, LME_GRAD_TOL, "log_space first step, fused_kernel vs fused_plain")
    print(f"log_space gradient: max|d|/max|ref| {gap:.3e} (limit {LME_GRAD_TOL:g})")
    return {"logmatmulexp": launches, "logmatmulexp_shifts": shifts}


def sbs_recipe_params(CSM, cfg, x, dev):
    """The legacy runner's recipe on ``x``: Khrulkov-normal cores from the
    seed, each layer scaled to unit output std on the batch (the input
    multiplier already in ``cfg``)."""
    params = CSM.init_conv_sbs_model(torch.Generator().manual_seed(SEED), cfg)
    params = tuple(tuple(tuple(c.to(dev) for c in s) for s in layer) for layer in params)
    return CSM.scale_layers_using_batch(params, cfg, x)


def sbs_model_cfg(CSM, x, trace_edge):
    """The recipe's config: sin²/cos² features and the window-std input
    multiplier from ``x``."""
    std = float(CSM.calc_std_of_coordinates_of_windows(x, 3, True, 1.0))
    return CSM.ConvSBSModelConfig(SBS_LAYERS, SBS_BOND, trace_edge=trace_edge, cos_sin_squared=True,
                                  input_multiplier=std ** (-1.0 / 9.0))


def check_sbs_training(S, CSM, x, y, dev) -> None:
    """Phase 6's output checks: one step's gradients (cores and pixels) on
    the kernels against the plain path's at batch 100, and 3 SGD steps with
    momentum at batch 4 against the float64 plain step on the CPU, open and
    ring."""
    for trace_edge in (False, True):
        xb, yb = x[:100], y[:100]
        cfg = sbs_model_cfg(CSM, xb, trace_edge)
        params = sbs_recipe_params(CSM, cfg, xb, dev)
        grads = []
        for kernels in (S.KERNELS, S.PLAIN):
            model = CSM.ConvSBSModel(params, cfg)
            xg = xb.clone().requires_grad_(True)
            loss = torch.nn.functional.cross_entropy(model(xg, kernels=kernels), yb)
            grads.append([t.detach() for t in torch.autograd.grad(loss, [xg, *model.parameters()])])
        compare_gradients(grads, SBS_GRAD_TOL,
                          f"ConvSBS {'ring' if trace_edge else 'open'} kernel vs plain, batch 100 "
                          "(gradient 0 is the pixels')")
        models = [CSM.ConvSBSModel(params, cfg),
                  CSM.ConvSBSModel(params, cfg, device="cpu", dtype=torch.float64)]
        opts = [torch.optim.SGD(m.parameters(), lr=SBS_TRAJ_LR, momentum=0.9) for m in models]
        start = [p.detach().clone() for p in models[1].parameters()]
        for i in range(3):
            losses = []
            for m, opt, xx, yy in zip(models, opts, (x, x.cpu().double()), (y, y.cpu())):
                opt.zero_grad()
                loss = torch.nn.functional.cross_entropy(m(xx[4 * i : 4 * i + 4]), yy[4 * i : 4 * i + 4])
                loss.backward()
                opt.step()
                losses.append(float(loss))
            print(f"ConvSBS {'ring' if trace_edge else 'open'} trajectory step {i}: loss kernel "
                  f"{losses[0]:.9g} float64 {losses[1]:.9g}")
            check(math.isfinite(losses[0]) and abs(losses[0] - losses[1]) <= SBS_TRAJ_RTOL * abs(losses[1]),
                  f"ConvSBS step {i} loss differs from the float64 step")
        worst = 0.0
        for i, (pk, p64, p0) in enumerate(zip(models[0].parameters(), models[1].parameters(), start)):
            diff = float((pk.detach().cpu().double() - p64.detach()).abs().max())
            moved = float((p64.detach() - p0).abs().max())
            scale = float(p64.detach().abs().max())
            check(moved > 0, f"ConvSBS trajectory: core {i} did not move")
            check(diff <= SBS_TRAJ_RTOL * scale,
                  f"ConvSBS trajectory: core {i} after 3 steps differs from float64 by {diff} "
                  f"(max|p| {scale}, moved {moved})")
            worst = max(worst, diff / scale)
        print(f"ConvSBS {'ring' if trace_edge else 'open'} trajectory: 3 steps within "
              f"{SBS_TRAJ_RTOL:g} of the float64 CPU step (losses, and every core of max|p|: "
              f"largest max|d|/max|p| {worst:.3e})")


def sbs_run_launches(counts, steps, evals, tb_logs):
    """The ConvSBS launches of a legacy run: per step (and per TB log's probe
    gradients) the three strings' forward and backward, layer 0's two
    without d_views, layer 1's with them, and a d_core sum each; a forward
    of each string per evaluation, two per string while scaling the layers,
    and one per TB log's named outputs."""
    want = dict.fromkeys(counts, 0)
    grads = steps + tb_logs
    want.update(sbs_fwd_mim=3 * (grads + evals + 2 + tb_logs), sbs_bwd_mim=3 * grads,
                sbs_bwd_dviews=grads, sbs_bwd_sum=3 * grads)
    return want


def sbs_run(legacy_runner, models_dir, trace_edge=False, opt="rmsprop", **kw):
    return legacy_runner.run(
        ds_path="synthetic", models_dir=models_dir, num_sbs_layers=SBS_LAYERS,
        bond_dim_size=SBS_BOND, trace_edge=trace_edge, batch_size=100,
        epochs=SBS_RUN_EPOCHS, synthetic_sizes=SBS_RUN_SIZES, optimizer_type=opt,
        momentum=0.9, learning_rate=1e-3, warmup_num_epochs=1,
        warmup_initial_multiplier=1e-2, cos_sin_squared=True,
        make_input_window_std_one=True, scale_layers_using_batch=100, seed=SEED,
        device="cuda", **kw,
    )


DP_STEPS = 3
DP_SERVE_IMAGES = 300
MULTICHIP_TIMEOUT_S = 900


def dp_phase(bench, CSM, params, cfg, tx, ty, dev) -> list:
    """Phase 5b: data parallelism at world size 1 on the card, through a
    real ``nccl`` process group (a file store in a temporary directory):
    the DP fast step, the DP QAT step and the DP ConvSBS step, each
    ``DP_STEPS`` steps from one init beside the single-device step, the
    parameters and losses bit-equal (the one all-reduce over one rank is a
    copy, and the mean divides by 1), their launches per step; the sharded
    score against ``make_score_fn`` (the ranks' sum in float64: within
    1e-6); then a sharded artifact at N = 1 (``export_sharded_forward``,
    its device-free program placed on the card at load), its logits
    bit-equal to the eager model's, served by ``ArtifactModel`` and by
    ``predict.run``. With two or more cards, ``python -m
    dctn_tpu_torch.multichip --devices min(4, count)`` runs as a subprocess
    and its failure fails the smoke. Returns the launch counts of the
    driven paths."""
    import torch.distributed as dist

    from dctn_tpu_torch.cli import export, predict, serve
    from dctn_tpu_torch.data import io as data_io
    from dctn_tpu_torch.models import EPSesPlusLinear
    from dctn_tpu_torch.parallel import (
        make_mesh,
        make_parallel_fast_train_step,
        make_parallel_pixel_train_step,
        make_parallel_score_fn,
        shard_split,
    )
    from dctn_tpu_torch.train import make_fast_train_step, make_optimizer, make_score_fn

    counts, record = [], {"metric": "dp_world_size_1", "steps": DP_STEPS}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            mesh = make_mesh(1)
            check(mesh.device == dev and mesh.backend == "nccl", f"mesh {mesh}")
            for qat in (None, "int8"):
                runs = []
                for dp in (True, False):
                    model = EPSesPlusLinear.from_reference(params, cfg, device=dev)
                    opt = make_optimizer("adam", model.parameters(), bench.LR)
                    if dp:
                        step = make_parallel_fast_train_step(model, opt, mesh, "epswise",
                                                             bench.REG_COEFF, qat=qat)
                    else:
                        step = make_fast_train_step(model, opt, "epswise", bench.REG_COEFF, qat=qat)
                    bench.zero_counters()
                    losses = [float(step(tx, ty)["loss"]) for _ in range(DP_STEPS)]
                    torch.cuda.synchronize()
                    launched = bench.read_counters()
                    if dp:
                        counts.append(launched)
                        record[f"launches_per_step_qat={qat}"] = {
                            k: v / DP_STEPS for k, v in launched.items() if v}
                    runs.append((losses, [p.detach().clone() for p in model.parameters()],
                                 launched))
                (l_dp, p_dp, c_dp), (l_one, p_one, c_one) = runs
                check(l_dp == l_one and all(torch.equal(a, b) for a, b in zip(p_dp, p_one)),
                      f"DP step at world size 1 (qat={qat}) is not the single-device step's bits")
                fwd = "eps_fwd" if qat is None else "eps_fwd_q8"
                check(c_dp == c_one and c_dp[fwd] == 2 * DP_STEPS and c_dp["eps_dcore"] > 0,
                      f"DP step (qat={qat}) launches {c_dp}, the single-device step {c_one}")
                record[f"losses_qat={qat}"] = l_dp
            # the sharded score
            score = make_parallel_score_fn(cfg, model.plans, mesh, BATCH)
            got = [float(v) for v in score(model.fast_params(), shard_split(
                mesh, tx.cpu().numpy(), ty.cpu().numpy()))]
            want = [float(v) for v in make_score_fn(cfg, model.plans, BATCH)(
                model.fast_params(), tx, ty)]
            check(abs(got[0] - want[0]) <= 1e-6 * abs(want[0]) and got[1] == want[1],
                  f"sharded score {got} != {want}")
            record["score"] = got
            # the ConvSBS step
            images, labels = (torch.as_tensor(a, device=dev)
                              for a in data_io.synthetic_mnist_like(100, seed=1234))
            scfg = sbs_model_cfg(CSM, images, False)
            sruns = []
            for dp in (True, False):
                smodel = CSM.ConvSBSModel(sbs_recipe_params(CSM, scfg, images, dev), scfg)
                sopt = torch.optim.SGD(smodel.parameters(), lr=SBS_TRAJ_LR)
                if dp:
                    sstep = make_parallel_pixel_train_step(smodel, sopt, mesh)
                else:
                    def sstep(xb, yb, smodel=smodel, sopt=sopt):
                        sopt.zero_grad(set_to_none=True)
                        loss = torch.nn.functional.cross_entropy(smodel(xb), yb)
                        loss.backward()
                        sopt.step()
                        return loss
                bench.zero_counters()
                slosses = [float(sstep(images, labels)) for _ in range(DP_STEPS)]
                torch.cuda.synchronize()
                launched = bench.read_sbs_counters()
                if dp:
                    counts.append(launched)
                    record["conv_sbs_launches_per_step"] = {
                        k: v / DP_STEPS for k, v in launched.items() if v}
                sruns.append((slosses, [p.detach().clone() for p in smodel.parameters()],
                              launched))
            check(sruns[0][0] == sruns[1][0] and all(
                torch.equal(a, b) for a, b in zip(sruns[0][1], sruns[1][1])),
                "DP ConvSBS step at world size 1 is not the single-device step's bits")
            check(sruns[0][2] == sruns[1][2] and sruns[0][2]["sbs_fwd_mim"] == 3 * DP_STEPS
                  and sruns[0][2]["sbs_bwd_mim"] == 3 * DP_STEPS,
                  f"DP ConvSBS launches {sruns[0][2]}, the single-device step {sruns[1][2]}")
            record["conv_sbs_losses"] = sruns[0][0]
        finally:
            dist.destroy_process_group()
        # a sharded artifact at N = 1, served
        host = {"epses": tuple(c.cpu() for c in params["epses"]),
                "linear": {k: v.cpu() for k, v in params["linear"].items()}}
        blobs, _ = export.export_sharded_forward(host, cfg, batch_sizes=(1, BATCH), mesh_devices=1)
        path = os.path.join(tmp, "sharded1.zip")
        export.write_artifact(path, blobs, export.build_meta(
            model_family="eps", image_size=28, batch_sizes=(1, BATCH), backend="pallas",
            mesh_devices=1, platforms=["cuda"], program_device="cpu",
            epses_specs=[list(s_) for s_ in cfg.epses_specs], q0=2, channels=1, num_classes=10))
        meta, fns = export.load_artifact(path)
        eager = EPSesPlusLinear.from_reference(params, cfg, device=dev)
        with torch.inference_mode():
            bench.zero_counters()
            got = fns[BATCH](tx)
            torch.cuda.synchronize()
            launches = bench.read_counters()
            want = eager(tx)
        counts.append(launches)
        check(launches["eps_fwd"] == 2 and launches["eps_fwd_t"] == 0,
              f"sharded artifact at N = 1: launches {launches}")
        check(fns[BATCH].devices == [dev] and torch.equal(got, want),
              "sharded artifact at N = 1: logits differ from the eager model's")
        model = serve.ArtifactModel(path)
        xs = torch.cat([tx] * 3, dim=1)[:, :DP_SERVE_IMAGES].cpu().numpy()
        served = model.predict(xs)
        with torch.inference_mode():
            direct = torch.cat([eager(torch.as_tensor(xs[:, i : i + BATCH], device=dev)).cpu()
                                for i in range(0, xs.shape[1], BATCH)])
        check(served.shape == (xs.shape[1], 10) and bool(np.isfinite(served).all()),
              "served logits")
        gap = float(np.abs(served - direct.numpy()).max())
        check(gap <= ART_TOL * float(direct.abs().max()), f"served logits {gap} from direct")
        bench.zero_counters()
        run = predict.run(checkpoint=path, ds_type="fashionmnist", ds_path="synthetic",
                          batch_size=BATCH, latency_bench=True, device="cuda",
                          synthetic_sizes=(256, 64, 512))
        counts.append(bench.read_counters())
        check(len(run.preds) == 512, "predict from the sharded artifact at N = 1")
        record["sharded_artifact_n1"] = {
            "bit_equal_to_eager": True, "served_max_abs_err": gap,
            "p50_ms": {s_["batch_size"]: s_["p50_ms"] for s_ in run.latency},
        }
    cards = torch.cuda.device_count()
    if cards >= 2:
        n = min(4, cards)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "dctn_tpu_torch.multichip", "--devices",
                               str(n)], capture_output=True, text=True,
                              timeout=MULTICHIP_TIMEOUT_S)
        print(proc.stdout[-4000:])
        check(proc.returncode == 0, f"multichip --devices {n} failed:\n{proc.stderr[-4000:]}")
        record["multichip"] = {"devices": n, "s": time.perf_counter() - t0}
    else:
        print("multichip: not run (it needs 2 or more cards; this machine has 1)")
        record["multichip"] = None
    print(json.dumps(record))
    return counts


# phase 5c: the flagship's layers at the shapes a rank of a grid gives them
# at batch 128 a data rank: under tensor parallelism layer 1 on the cmt row
# block of each of 2 and 3 model ranks (O = 3, 2), under spatial parallelism
# each layer on the slab of Hl + K - 1 rows of each of 2 and 4 space ranks
# (Hl = 14, 7)
GRID_MODEL_AXES = (2, 3)
GRID_SPACE_AXES = (2, 4)
# SP x TP's model axis: layer 1 on each space rank's slab at O / 2 (Z = 768)
SP_TP_MODEL = 2


def grid_shard_shapes():
    """(label, layer, n, q, n1, O, npix) of the flagship's layers at a grid
    rank's shapes: layer 1 at O / model for each model axis, each layer on
    Hl rows for each space axis, and under SP x TP layer 1 on Hl rows at O /
    2 for each space axis (its layer 0 is SP's)."""
    dims = layer_dims(FLAGSHIP)
    n, q, n1, o, h = dims[1]
    shapes = [(f"TP layer 1, O={o // m} (model {m})", 1, n, q, n1, o // m, BATCH * h * h)
              for m in GRID_MODEL_AXES]
    for p in GRID_SPACE_AXES:
        hl = -(-28 // p)
        shapes += [(f"SP layer {i}, {hl} rows (space {p})", i, n_, q_, n1_, o_, BATCH * hl * h_)
                   for i, (n_, q_, n1_, o_, h_) in enumerate(dims)]
    for p in GRID_SPACE_AXES:
        hl = -(-28 // p)
        shapes.append((f"SP x TP layer 1, O={o // SP_TP_MODEL}, {hl} rows (space {p}, model "
                       f"{SP_TP_MODEL})", 1, n, q, n1, o // SP_TP_MODEL, BATCH * hl * h))
    return shapes


def grid_kernels_at_shard_shapes(K, Q8, dev, res) -> None:
    """Phase 5c (a): each kernel of a grid's step (K1 ± t, ``eps_dcore``,
    ``eps_dviews_t``, K8/K9, and their bf16 modes with K9's bf16 t) against
    its plain version at the shard shapes (``grid_shard_shapes``; layer 0
    saves no t and needs no d_views), at REL_TOL (a bf16 t within one bf16
    step) and K9's t bit for bit, as in phases 2 and 11; the launch plan
    each shape takes (K1's and K8's kernel, ``eps_dcore``'s pixel slices)
    and the kernel and plain times are printed; max |Δ| joins the kernel's
    in ``res`` (the bf16 modes' in phase 11's numbers)."""
    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, layer, n, q, n1, o, npix in grid_shard_shapes():
        g_ = torch.Generator(device=dev).manual_seed(SEED)
        views = torch.rand((n, q, npix), generator=g_, device=dev)
        cmt = torch.randn((o * q ** (n - n1), q**n1), generator=g_, device=dev) * q ** (-n / 2)
        g = torch.randn((o, npix), generator=g_, device=dev)
        t = K.eps_fwd_reference(views, cmt, n1, o, save_t=True)[1]
        wq, sw = Q8.quantize_cmt(cmt)
        cb = cmt.to(bf)
        tb = K.eps_fwd_reference(views, cb, n1, o, save_t=True)[1]
        cases = {
            "eps_fwd": (lambda: K.eps_fwd(views, cmt, n1, o),
                        lambda: K.eps_fwd_reference(views, cmt, n1, o)),
            "eps_dcore": (lambda: K.eps_dcore(views, g, n1, o),
                          lambda: K.eps_dcore_reference(views, g, n1, o)),
            "eps_fwd_q8": (lambda: Q8.eps_fwd_q8(views, wq, sw, n1, o),
                           lambda: Q8.eps_fwd_q8_reference(views, wq, sw, n1, o)),
            "eps_fwd_bf16": (lambda: K.eps_fwd(views, cb, n1, o),
                             lambda: K.eps_fwd_reference(views, cb, n1, o)),
            "eps_dcore_bf16": (lambda: K.eps_dcore(views, g, n1, o, mm_dtype=bf),
                               lambda: K.eps_dcore_reference(views, g, n1, o, bf)),
        }
        if layer == 1:
            cases.update({
                "eps_fwd_t_bf16": (lambda: K.eps_fwd(views, cb, n1, o, save_t=True),
                                   lambda: K.eps_fwd_reference(views, cb, n1, o, save_t=True)),
                "eps_dviews_t_bf16": (lambda: K.eps_dviews_t(views, cb, g, tb, n1, o),
                                      lambda: K.eps_dviews_t_reference(views, cb, g, tb, n1, o)),
                "eps_fwd_q8_t_bf16": (
                    lambda: Q8.eps_fwd_q8(views, wq, sw, n1, o, save_t=True, t_dtype=bf),
                    lambda: Q8.eps_fwd_q8_reference(views, wq, sw, n1, o, save_t=True,
                                                    t_dtype=bf)),
            })
        if layer == 1:
            cases.update({
                "eps_fwd_t": (lambda: K.eps_fwd(views, cmt, n1, o, save_t=True),
                              lambda: K.eps_fwd_reference(views, cmt, n1, o, save_t=True)),
                "eps_dviews_t": (lambda: K.eps_dviews_t(views, cmt, g, t, n1, o),
                                 lambda: K.eps_dviews_t_reference(views, cmt, g, t, n1, o)),
                "eps_fwd_q8_t": (lambda: Q8.eps_fwd_q8(views, wq, sw, n1, o, save_t=True),
                                 lambda: Q8.eps_fwd_q8_reference(views, wq, sw, n1, o,
                                                                 save_t=True)),
            })
        z, a = cmt.shape
        fb = K._fwd_bf16_plan(n, q, n1, o, npix)
        print(f"grid shape [{label}] n={n} q={q} n1={n1} O={o} npix={npix}: K1 "
              f"{K._fwd_plan(n, q, n1, o, npix)['kernel']} (bf16: {fb['outputs']} outputs, "
              f"{fb['passes']} passes, {fb['chunks']} chunk(s)), K8 "
              f"{Q8._q8_plan(n, q, n1, o, npix)['form']}, eps_dcore "
              f"{K._dcore_slices(z, a, npix, sms)} pixel slice(s) of {math.ceil(z / 128)} x "
              f"{math.ceil(a / 128)} tiles")
        for name, (kern, plain) in cases.items():
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            errs = []
            for which, x, r in zip(("out", "t"), got, ref):
                check(x.shape == r.shape and x.dtype == r.dtype
                      and torch.isfinite(x.float()).all().item(),
                      f"{name} [{label}]: {which} shape {tuple(x.shape)}, dtype or non-finite")
                if name.startswith("eps_fwd_q8_t") and which == "t":
                    check(torch.equal(x, r), f"{name} [{label}]: t is not the plain version's "
                                             "bit for bit")
                x, r = x.float(), r.float()
                err, scale = float((x - r).abs().max()), float(r.abs().max())
                if which == "t" and name == "eps_fwd_t_bf16":
                    excess = float(((x - r).abs() - BF16_STEP * r.abs()).max())
                    check(excess <= REL_TOL * scale,
                          f"{name} [{label}]: t more than a bf16 step from plain ({excess})")
                else:
                    check(err <= REL_TOL * scale, f"{name} [{label}]: {which} differs from "
                                                  f"plain by {err} (max|ref| {scale})")
                if name in res:
                    res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
                errs.append(f"{which} max|d|={err:.3e} tol={REL_TOL * scale:.3e}")
            del got, ref
            t_k, t_p = median_ms([kern, plain], reps=5)
            print(f"  {name} vs plain [{label}]: {'; '.join(errs)}; kernel {t_k:.4f} ms, "
                  f"plain {t_p:.4f} ms")
            if name.startswith("eps_fwd") and name.endswith("_bf16") and "q8" not in name:
                check(t_k < t_p, f"{name} [{label}]: the kernel ({t_k:.4f} ms) is not faster "
                                 f"than its plain version ({t_p:.4f} ms)")
        del views, cmt, g, t, wq, sw, cb, tb


def grid_shards_vs_whole(K, Q8, params, cfg, x, dev) -> dict:
    """Phase 5c (b), on the card, f32 and then QAT (the W8A8 forward): the
    flagship's layer 1 on each cmt row block of a model axis equals the
    matching O-slice of the whole layer, and the shards' partial logits
    (each its O-slice of the classifier's rows) sum to the one-card logits;
    each space rank's layer outputs on its slab of the bottom-padded image
    (its Hl rows and the next rank's K - 1) equal the whole layers' valid
    rows, and the row-sliced classifier's partial logits sum to the one-card
    logits; under SP x TP on (space 2, model 2) each rank's layer 1 on its
    slab and cmt row block equals its rows and O-slice of the whole layer
    bit for bit, and the four partial logits sum to the one-card logits.
    All within REL_TOL of the largest entry. Returns the largest shares of
    it, the SP x TP shards' equality and the launch counts."""
    from dctn_tpu_torch.bench import read_counters, zero_counters
    from dctn_tpu_torch.models.eps_plus_linear import (
        _transposed_classifier,
        fast_params_from_reference,
    )

    fast, plans = fast_params_from_reference({
        "epses": tuple(c.to(dev) for c in params["epses"]),
        "linear": {k: v.to(dev) for k, v in params["linear"].items()}}, cfg)
    cmts, lin = fast["epses_cmt"], fast["linear"]
    out, exact = {}, {}
    zero_counters()

    def layer(cmt, xT, i, o, kernels):
        p = plans[i]
        return K.eps_apply_t_cmt(cmt, xT, o, p["kernel_size"], p["n1"], p["merge_pairs"],
                                 layer_index=i, kernels=kernels)

    def agree(got, want, what):
        share = float((got - want).abs().max()) / (REL_TOL * float(want.abs().max()))
        check(share <= 1.0, f"{what}: {share:.3f} of REL_TOL from the whole")
        out[what] = share

    with torch.no_grad():
        for tag, kernels in (("f32", K.KERNELS), ("qat", Q8.QAT_KERNELS)):
            xT = x.permute(0, 4, 2, 3, 1)
            whole = [layer(cmts[0], xT, 0, plans[0]["out_size"], kernels)]
            whole.append(layer(cmts[1], whole[0][None], 1, plans[1]["out_size"], kernels))
            logits = _transposed_classifier(whole[1], lin)
            o, hp, wp, b = whole[1].shape
            w3 = lin["w"].reshape(hp * wp, o, -1)
            for m in GRID_MODEL_AXES:
                rows, ol = cmts[1].shape[0] // m, o // m
                total = lin["b"]
                for j in range(m):
                    blk = layer(cmts[1][j * rows : (j + 1) * rows], whole[0][None], 1, ol, kernels)
                    agree(blk, whole[1][j * ol : (j + 1) * ol], f"{tag} TP model {m} rank {j}")
                    total = total + torch.tensordot(blk.reshape(ol, hp * wp, b),
                                                    w3[:, j * ol : (j + 1) * ol], dims=([0, 1], [1, 0]))
                agree(total, logits, f"{tag} TP model {m} logits")
            for p in GRID_SPACE_AXES:
                hl = -(-28 // p)
                cur = torch.nn.functional.pad(xT, (0, 0, 0, 0, 0, p * hl - 28))
                for i in range(2):
                    k = plans[i]["kernel_size"]
                    padded = torch.nn.functional.pad(cur, (0, 0, 0, 0, 0, k - 1))
                    outs = [layer(cmts[i], padded[:, :, d * hl : d * hl + hl + k - 1], i,
                                  plans[i]["out_size"], kernels) for d in range(p)]
                    valid = whole[i].shape[1]
                    for d in range(p):
                        n_valid = max(0, min(hl, valid - d * hl))
                        agree(outs[d][:, :n_valid], whole[i][:, d * hl : d * hl + n_valid],
                              f"{tag} SP space {p} layer {i} rank {d}")
                    cur = torch.cat(outs, dim=1)[None]
                w4 = torch.nn.functional.pad(lin["w"].reshape(hp, wp, o, -1),
                                             (0, 0, 0, 0, 0, 0, 0, p * hl - hp))
                total = lin["b"]
                for d in range(p):
                    total = total + torch.tensordot(
                        cur[0][:, d * hl : (d + 1) * hl].reshape(o, hl * wp, b),
                        w4[d * hl : (d + 1) * hl].reshape(hl * wp, o, -1), dims=([0, 1], [1, 0]))
                agree(total, logits, f"{tag} SP space {p} logits")
            # SP x TP on (space 2, model 2): layer 0 on each slab, layer 1 on
            # each slab with each cmt row block at O / 2
            p, m = GRID_SPACE_AXES[0], SP_TP_MODEL
            hl, rows, ol = -(-28 // p), cmts[1].shape[0] // m, o // m
            k0, k1 = plans[0]["kernel_size"], plans[1]["kernel_size"]
            pad0 = torch.nn.functional.pad(xT, (0, 0, 0, 0, 0, p * hl - 28 + k0 - 1))
            l0 = torch.cat([layer(cmts[0], pad0[:, :, d * hl : d * hl + hl + k0 - 1], 0,
                                  plans[0]["out_size"], kernels) for d in range(p)], dim=1)
            pad1 = torch.nn.functional.pad(l0[None], (0, 0, 0, 0, 0, k1 - 1))
            w4 = torch.nn.functional.pad(lin["w"].reshape(hp, wp, o, -1),
                                         (0, 0, 0, 0, 0, 0, 0, p * hl - hp))
            total = lin["b"]
            for d in range(p):
                n_valid = max(0, min(hl, hp - d * hl))
                for j in range(m):
                    blk = layer(cmts[1][j * rows : (j + 1) * rows],
                                pad1[:, :, d * hl : d * hl + hl + k1 - 1], 1, ol, kernels)
                    what = f"{tag} SP x TP (space {p}, model {m}) rank ({d}, {j})"
                    same = torch.equal(blk[:, :n_valid],
                                       whole[1][j * ol : (j + 1) * ol, d * hl : d * hl + n_valid])
                    check(same, f"{what}: its rows and O-slice are not the whole layer's bit "
                                "for bit")
                    exact[what] = same
                    w_blk = w4[d * hl : (d + 1) * hl, :, j * ol : (j + 1) * ol]
                    total = total + torch.tensordot(blk.reshape(ol, hl * wp, b),
                                                    w_blk.reshape(hl * wp, ol, -1),
                                                    dims=([0, 1], [1, 0]))
            agree(total, logits, f"{tag} SP x TP (space {p}, model {m}) logits")
    torch.cuda.synchronize()
    return {"max_share_of_rel_tol": out, "sp_x_tp_bit_equal": exact, "launches": read_counters()}


def grid_world_size_1(bench, params, cfg, tx, ty, dev) -> tuple:
    """Phase 5c (c): the SP x TP, TP-fast and SP-fast steps on a grid whose
    every axis has one rank, through a real ``nccl`` process group (a file
    store), DP_STEPS Adam steps f32 and QAT, each in float32 and in bf16
    operands, beside the single-device step from one init: losses and
    parameters bit for bit, the same launches per step. Returns (launch
    counts of the grid steps, record)."""
    import dataclasses

    import torch.distributed as dist

    from dctn_tpu_torch.models import EPSesPlusLinear
    from dctn_tpu_torch.models.eps_plus_linear import fast_params_from_reference
    from dctn_tpu_torch.parallel import (TPFastModel, make_grid, make_mesh,
                                         make_sp_fast_train_step, make_sp_tp_fast_train_step,
                                         make_sp_tp_grid, make_tp_fast_params,
                                         make_tp_fast_train_step, merge_tp_fast_params)
    from dctn_tpu_torch.train import make_fast_train_step, make_optimizer

    counts, record = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            mesh = make_mesh(1)
            grids = {"tp": make_grid(mesh, "model", 1, 1), "sp": make_grid(mesh, "space", 1, 1),
                     "sp_tp": make_sp_tp_grid(mesh, 1, 1, 1)}
            for qat, dtype in ((None, None), ("int8", None), (None, torch.bfloat16),
                               ("int8", torch.bfloat16)):
                cfg_d = dataclasses.replace(cfg, compute_dtype=dtype)
                fast, plans = fast_params_from_reference(params, cfg_d)
                tag = f"qat={qat}" + ("" if dtype is None else " bf16")
                runs = {}
                for kind in ("sp_tp", "tp", "sp", "one"):
                    if kind in ("tp", "sp_tp"):
                        model = TPFastModel(make_tp_fast_params(fast, cfg_d, grids[kind]), plans,
                                            cfg_d, grids[kind])
                    else:
                        model = EPSesPlusLinear.from_reference(params, cfg_d, device=dev)
                    opt = make_optimizer("adam", model.parameters(), bench.LR)
                    if kind == "sp_tp":
                        step = make_sp_tp_fast_train_step(model, opt, "epswise", bench.REG_COEFF,
                                                          qat=qat)
                    elif kind == "tp":
                        step = make_tp_fast_train_step(model, opt, "epswise", bench.REG_COEFF,
                                                       qat=qat)
                    elif kind == "sp":
                        step = make_sp_fast_train_step(model, opt, grids["sp"], "epswise",
                                                       bench.REG_COEFF, qat=qat)
                    else:
                        step = make_fast_train_step(model, opt, "epswise", bench.REG_COEFF,
                                                    qat=qat)
                    bench.zero_counters()
                    losses = [float(step(tx, ty)["loss"]) for _ in range(DP_STEPS)]
                    torch.cuda.synchronize()
                    launched = bench.read_counters()
                    if kind != "one":
                        counts.append(launched)
                    final = (merge_tp_fast_params(model.fast_params3(), cfg_d, grids[kind])
                             if kind in ("tp", "sp_tp") else model.fast_params())
                    runs[kind] = (losses, [c.detach().clone() for c in final["epses_cmt"]]
                                  + [final["linear"]["w"].detach().clone(),
                                     final["linear"]["b"].detach().clone()], launched)
                one = runs["one"]
                for kind in ("sp_tp", "tp", "sp"):
                    losses, ps, launched = runs[kind]
                    check(losses == one[0] and all(torch.equal(a, b) for a, b in zip(ps, one[1])),
                          f"{kind} grid at world size 1 ({tag}) is not the single-device "
                          "step's bits")
                    check(launched == one[2], f"{kind} grid ({tag}) launches {launched}, the "
                                              f"single-device step {one[2]}")
                    if dtype is not None:
                        check(sum(v for k, v in launched.items() if k.endswith("_bf16")) > 0,
                              f"{kind} grid ({tag}) launched no bf16 kernel: {launched}")
                    record[f"{kind}_{tag}"] = {
                        "losses": losses, "launches_per_step": {
                            k: v / DP_STEPS for k, v in launched.items() if v}}
        finally:
            dist.destroy_process_group()
    return counts, record


# phase 5c (d): the flagship's height-sharded artifact over these many bands
SPACE_ARTIFACT_BANDS = (2, 4)


def grid_space_artifact(bench, params, cfg, x, dev) -> tuple:
    """Phase 5c (d): the flagship exported by ``export.run --space-devices
    S`` (pallas) for each S of SPACE_ARTIFACT_BANDS, and with
    ``--compute-dtype bfloat16`` for S = 2: its slab program holds one
    ``dctn_tpu_torch::eps_fwd`` node per EPS layer, and ``load_artifact``
    on one card refuses it, naming the count. Then, for the numbers only,
    ``RowShardedForward`` built directly over the artifact's program with
    every band on this card (never through ``load_artifact``): its logits
    within REL_TOL of one card's artifact of the same npz in the same
    dtype, and each band's layer outputs (the eager slab program) equal to
    the whole image's rows, bit for bit; the two timed in turns. Returns
    (launch counts, record)."""
    import dataclasses
    import zipfile

    from dctn_tpu_torch.cli import export
    from dctn_tpu_torch.parallel.replicas import RowShardedForward
    from dctn_tpu_torch.train import save_params_npz

    record = {}
    xb = x[:, :BATCH]
    counts = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "flagship.npz")
        save_params_npz(params, ckpt)
        for dtype, all_bands in (("float32", SPACE_ARTIFACT_BANDS), ("bfloat16", (2,))):
            sfx = "" if dtype == "float32" else "_bf16"
            one_art = os.path.join(tmp, f"one{sfx}.zip")
            export.run(checkpoint=ckpt, epses_specs=FLAGSHIP, batch_sizes=(BATCH,),
                       device="cuda", compute_dtype=dtype, out=one_art)
            one = export.load_artifact(one_art)[1][BATCH]
            cfg_d = dataclasses.replace(cfg, compute_dtype=torch.bfloat16 if sfx else None)
            bench.zero_counters()
            with torch.inference_mode():
                want = one(xb)
                program = export.space_slab_program(params, cfg_d).to(dev)
                whole = program.features(xb)
                for bands in all_bands:
                    art = os.path.join(tmp, f"space{bands}{sfx}.zip")
                    export.run(checkpoint=ckpt, epses_specs=FLAGSHIP, batch_sizes=(BATCH,),
                               space_devices=bands, device="cuda", compute_dtype=dtype, out=art)
                    try:
                        export.load_artifact(art)
                        refused = ""
                    except ValueError as e:
                        refused = str(e)
                    what = f"{bands}-band {dtype} artifact"
                    check(f"{bands} replicas need {bands} CUDA cards; 1 visible" in refused,
                          f"load_artifact of a {what} on one card: {refused!r}")
                    with zipfile.ZipFile(art) as zf:
                        meta = json.loads(zf.read("meta.json"))
                        prog = torch.export.load(
                            io.BytesIO(zf.read(f"forward_bs{BATCH}.pt2"))).module()
                        classifier = torch.load(io.BytesIO(zf.read("classifier.pt")),
                                                weights_only=True)
                    check(meta["compute_dtype"] == dtype, f"{what}: meta {meta['compute_dtype']}")
                    nodes = export.op_nodes(prog)
                    check(nodes == {"eps_fwd": len(FLAGSHIP)}, f"{what}: operator nodes {nodes}")
                    prog = export.place_program(prog, dev)
                    fn = RowShardedForward([prog] * bands, [dev] * bands, list(classifier["w"]),
                                           classifier["b"], meta["space_rows"],
                                           meta["space_halo"])
                    launched = bench.read_counters()[f"eps_fwd{sfx}"]
                    got = fn(xb)
                    torch.cuda.synchronize()
                    moved = bench.read_counters()[f"eps_fwd{sfx}"] - launched
                    check(moved == bands * len(FLAGSHIP),
                          f"{what}: {moved} eps_fwd{sfx} launches, not one a band and layer")
                    share = float((got - want).abs().max()) / (REL_TOL * float(want.abs().max()))
                    check(share <= 1.0, f"{what}: logits {share:.3f} of REL_TOL from one card's "
                                        "artifact")
                    rows, same = meta["space_rows"], []
                    for s_, slab in enumerate(fn.slabs(xb)):
                        band = program.features(slab)
                        n_valid = max(0, min(rows, whole.shape[1] - s_ * rows))
                        same.append(torch.equal(band[:, :n_valid],
                                                whole[:, s_ * rows : s_ * rows + n_valid]))
                    check(all(same), f"{what}: band layer outputs {same} are not the whole "
                                     "image's rows bit for bit")
                    t_band, t_one = median_ms([lambda: fn(xb), lambda: one(xb)], reps=10)
                    record[f"space_{bands}{sfx}"] = {
                        "slab_rows": rows + meta["space_halo"], "share_of_rel_tol": share,
                        "bands_bit_equal": all(same), "op_nodes": nodes,
                        "ms_all_bands_on_one_card": t_band, "one_card_artifact_ms": t_one}
            torch.cuda.synchronize()
            counts.append(bench.read_counters())
    return counts, record


def grid_phase(bench, K, Q8, params, cfg, tx, ty, dev, res) -> list:
    """Phase 5c: tensor and spatial parallelism and SP x TP on the card: (a)
    the kernels at the shard shapes, (b) shards against the whole layers and
    logits, (c) the grid's steps at world size 1 through a real NCCL group,
    (d) the height-sharded artifact. With two or more cards the multichip
    subprocess of phase 5b runs the TP, SP and SP x TP paths across them.
    Returns the launch counts of the driven paths."""
    grid_kernels_at_shard_shapes(K, Q8, dev, res)
    shards = grid_shards_vs_whole(K, Q8, params, cfg, tx, dev)
    counts, record = grid_world_size_1(bench, params, cfg, tx, ty, dev)
    art_counts, art_record = grid_space_artifact(bench, params, cfg, tx, dev)
    print(json.dumps({"metric": "grid_world_size_1", "steps": DP_STEPS, **record,
                      "shards_vs_whole": shards["max_share_of_rel_tol"],
                      "sp_x_tp_bit_equal": shards["sp_x_tp_bit_equal"],
                      "space_artifact": art_record}))
    return counts + art_counts


def sbs_runner_phase(legacy_runner, bench, dev):
    """Phase 6: ``legacy_runner.run`` on the card, 2 layers, bond 4, batch
    100, SBS_RUN_EPOCHS epochs of synthetic data, SGD and RMSprop with
    momentum, open and ``--trace-edge``, at the runner's defaults (TB logging
    at epoch 0, ``--preempt-save``). Checks the launches
    (``sbs_run_launches``) and the best checkpoint. Then RMSprop on open
    strings with ``--tb-log-every-n-epochs 1`` (its metrics.jsonl records at
    both epochs; the probe's gradients through K10/K11), a run stopped
    after SBS_STOP_AFTER steps (mid-epoch 1) with its train state saved,
    and that state resumed to the end: the resumed run ends on the
    unbroken run's bits. Returns each run's counts."""
    n_tr, n_val = SBS_RUN_SIZES
    per_epoch = n_tr // 100
    steps = SBS_RUN_EPOCHS * per_epoch
    runs = []
    for trace_edge in (False, True):
        for opt in ("sgd", "rmsprop"):
            bench.zero_counters()
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                _, best = sbs_run(legacy_runner, tmp, trace_edge, opt)
                ckpts = [f for f in os.listdir(tmp) if f.startswith("dctn_epoch=")]
            counts = bench.read_sbs_counters()
            label = f"legacy_runner {'--trace-edge ' if trace_edge else ''}{opt}"
            print(f"{label}: {time.perf_counter() - t0:.1f} s, best val acc {best:.4f} "
                  f"(synthetic, {SBS_RUN_EPOCHS} epochs), checkpoint {ckpts}, launches {counts}")
            check(len(ckpts) == 1 and ckpts[0].endswith(".npz"), f"{label}: no best checkpoint")
            want = sbs_run_launches(counts, steps, SBS_RUN_EPOCHS, 1)
            check(counts == want, f"{label}: launches {counts} != {want}")
            print(f"{label}: per step sbs_fwd_mim 3, sbs_bwd_mim 3 (d_views 1), sum 3, over "
                  f"{steps} steps, and one TB log")
            runs.append(counts)

    class StopAfter(legacy_runner.PreemptionHandler):
        """Sees a signal after the SBS_STOP_AFTER-th step."""

        def __init__(self):
            super().__init__()
            self.reads = 0

        @property
        def fired(self):
            self.reads += 1
            return "SIGTERM" if self.reads >= SBS_STOP_AFTER else None

        @fired.setter
        def fired(self, value):
            pass

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        bench.zero_counters()
        unbroken, best = sbs_run(legacy_runner, os.path.join(tmp, "tb"), tb_log_every_n_epochs=1)
        counts = bench.read_sbs_counters()
        runs.append(counts)
        want = sbs_run_launches(counts, steps, SBS_RUN_EPOCHS, SBS_RUN_EPOCHS)
        print(f"legacy_runner --tb-log-every-n-epochs 1: {time.perf_counter() - t0:.1f} s, "
              f"launches {counts}")
        check(counts == want, f"legacy TB run: launches {counts} != {want}")
        by_step = read_metrics(os.path.join(tmp, "tb"))
        logged = [per_epoch * (e + 1) for e in range(SBS_RUN_EPOCHS)]
        with open(os.path.join(tmp, "tb", "log.log")) as f:
            tb_ms = [float(m) for m in re.findall(r"TB log at iteration \d+: (\S+) ms", f.read())]
        print(json.dumps({"metric": "legacy_runner_tb", "batch_size": 100, "bond": SBS_BOND,
                          "steps_per_epoch": per_epoch, "tb_log_ms": tb_ms}))
        check(len(tb_ms) == SBS_RUN_EPOCHS, f"legacy TB log times {tb_ms}")
        check(sorted(by_step) == logged, f"legacy metrics.jsonl steps {sorted(by_step)}")
        n_cores = sum(len(spec) for layer in
                      legacy_runner.ConvSBSModelConfig(SBS_LAYERS, SBS_BOND).layer_specs()
                      for spec in layer)
        for it in logged:
            tags = [r["tag"] for r in by_step[it]]
            for prefix in ("weights/", "weights_mean/", "weights_std/", "grads/", "grads_mean/",
                           "grads_std/"):
                check(sum(t.startswith(prefix) for t in tags) == n_cores,
                      f"legacy step {it}: {prefix} records")
            for t in ("lr", "val/acc", "val/mean_ce", "train/last_batch_loss",
                      "layer0.string0/tt_mean", "layer1.string0/tt_std",
                      "intermediate_dumb_mean/layer0.string1", "intermediate_dumb/logits"):
                check(tags.count(t) == 1, f"legacy step {it}: {t} records {tags.count(t)}")
            check_finite_records(by_step[it], f"legacy step {it}")
        saved = legacy_runner.PreemptionHandler
        legacy_runner.PreemptionHandler = StopAfter
        try:
            sbs_run(legacy_runner, os.path.join(tmp, "stopped"), tb_log_every_n_epochs=1)
        finally:
            legacy_runner.PreemptionHandler = saved
        state_file = os.path.join(tmp, "stopped", "train_state_latest.npz")
        with np.load(state_file) as d:
            where = (int(d["epoch"]), int(d["step_in_epoch"]))
        check(where == divmod(SBS_STOP_AFTER, per_epoch), f"the stopped run saved at {where}")
        bench.zero_counters()
        resumed, best_r = sbs_run(legacy_runner, os.path.join(tmp, "resumed"),
                                  tb_log_every_n_epochs=1, resume_from=state_file)
        counts = bench.read_sbs_counters()
        runs.append(counts)
        left = steps - SBS_STOP_AFTER
        want = sbs_run_launches(counts, left, SBS_RUN_EPOCHS - where[0], SBS_RUN_EPOCHS - where[0])
        check(counts == want, f"legacy resumed run: launches {counts} != {want}")
        same = all(torch.equal(a, b) for la, lb in zip(unbroken, resumed) for sa, sb in zip(la, lb)
                   for a, b in zip(sa, sb))
        print(f"legacy_runner: resumed at epoch {where[0]} step {where[1]} (after "
              f"{SBS_STOP_AFTER} steps) to {SBS_RUN_EPOCHS} epochs vs unbroken: bit-equal {same}, "
              f"best val acc {best_r:.4f} vs {best:.4f}")
        check(same and best_r == best, "the resumed legacy run does not end on the unbroken bits")
    return runs


def sbs_bench_phase(bench, dev):
    """Phase 7: ``bench.run_conv_sbs``, the step of
    experiments/conv_sbs_benchmark.py, at batch 100 and 512, open and ring,
    kernel and plain path. Launches per step and over the run. Returns the
    counts and the records."""
    steps_run = 3 + 1 + TRAIN_STEPS
    per_step = {"sbs_fwd_mim": 3, "sbs_bwd_mim": 3, "sbs_bwd_dviews": 1, "sbs_bwd_sum": 3}
    counts, records = [], []
    for batch in SBS_BATCHES:
        for trace_edge in (False, True):
            bench.zero_counters()
            t0 = time.perf_counter()
            recs = bench.run_conv_sbs(device="cuda", steps=TRAIN_STEPS, batch_size=batch,
                                      trace_edge=trace_edge, compare_plain=True)
            got = bench.read_sbs_counters()
            label = f"conv_sbs bench batch {batch} {'ring' if trace_edge else 'open'}"
            print(f"{label}: {time.perf_counter() - t0:.1f} s, launches {got}")
            want = {k: per_step.get(k, 0) for k in got}
            check(recs[0]["launches_per_step"] == {k: float(v) for k, v in want.items()},
                  f"{label}: launches per step {recs[0]['launches_per_step']} != {want}")
            check(got == {k: v * steps_run for k, v in want.items()}, f"{label}: launches {got}")
            for rec in recs:
                check(all(math.isfinite(rec[k]) for k in ("first_loss", "last_loss")),
                      f"{label}: non-finite loss")
                print(f"train step {label} [{rec['path']}]: p50 {rec['step_ms_p50']:.4f} ms, "
                      f"{rec['images_per_s']:.1f} img/s, peak extra memory "
                      f"{rec['peak_extra_mib']:.1f} MiB, loss {rec['first_loss']:.6f} -> "
                      f"{rec['last_loss']:.6f}")
            counts.append(got)
            records.extend(recs)
    return counts, records


def sequential_forward(S, CSM, params, cfg, x, kernels):
    """The model's batch-minor forward with every string on the sequential
    fold: ``conv_sbs_t(mim=False)``, K12."""
    xT = CSM.batch_to_quantum(x, cfg.cos_sin_squared, cfg.input_multiplier).permute(0, 4, 2, 3, 1)
    for layer_spec, layer_params in zip(cfg.layer_specs(), params):
        outs = [S.conv_sbs_t(s, c, xT, mim=False, kernels=kernels)
                for s, c in zip(layer_spec, layer_params)]
        xT = torch.stack(outs, dim=0)
    return outs[0].mean(dim=(1, 2)).T


def sbs_sequential_phase(S, CSM, bench, x, y, dev):
    """Phase 7, the sequential fold's path: the runner's recipe on 100
    synthetic images (``sbs_model_cfg``, ``sbs_recipe_params``), every
    string through ``conv_sbs_t(mim=False)``, SGD 1e-3 steps, open and
    ring. The counts
    are zeroed before the steps and read after them; then, outside that
    window, one step's gradients (cores and pixels) against the plain
    path's and the logits against the model's own forward. Returns the
    counts."""
    steps = 5
    per_step = {"sbs_fwd_seq": 3, "sbs_bwd_seq": 3, "sbs_bwd_dviews": 1, "sbs_bwd_sum": 3}
    counts = []
    for trace_edge in (False, True):
        label = f"sequential path {'ring' if trace_edge else 'open'} batch 100"
        cfg = sbs_model_cfg(CSM, x, trace_edge)
        model = CSM.ConvSBSModel(sbs_recipe_params(CSM, cfg, x, dev), cfg)
        opt = torch.optim.SGD(model.parameters(), lr=1e-3)
        bench.zero_counters()
        losses = []
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = torch.nn.functional.cross_entropy(
                sequential_forward(S, CSM, model.params(), cfg, x, S.KERNELS), y)
            loss.backward()
            opt.step()
            losses.append(float(loss))
        got = bench.read_sbs_counters()
        want = {k: per_step.get(k, 0) * steps for k in got}
        print(f"{label}: {steps} SGD steps, losses {losses}, launches {got}")
        check(got == want, f"{label}: launches {got} != {want}")
        check(all(math.isfinite(v) for v in losses), f"{label}: non-finite loss")
        counts.append(got)
        grads = []
        for kernels in (S.KERNELS, S.PLAIN):
            xg = x.clone().requires_grad_(True)
            loss = torch.nn.functional.cross_entropy(
                sequential_forward(S, CSM, model.params(), cfg, xg, kernels), y)
            grads.append([t.detach() for t in torch.autograd.grad(loss, [xg, *model.parameters()])])
        compare_gradients(grads, SBS_GRAD_TOL, f"{label} kernel vs plain (gradient 0 is the pixels')")
        with torch.no_grad():
            seq, mim = sequential_forward(S, CSM, model.params(), cfg, x, S.KERNELS), model(x)
        err, scale = float((seq - mim).abs().max()), float(mim.abs().max())
        print(f"{label}: logits vs the model's meet-in-the-middle forward max|d| {err:.3e} "
              f"(max|ref| {scale:.3e}, tol {SBS_TOL:g}*max|ref|)")
        check(err <= SBS_TOL * scale, f"{label}: logits differ from the model's forward")
    return counts


def profile_conv_sbs(S, CSM, out_dir, dev) -> None:
    """Phase 10 (opt-in): where the ConvSBS step's time goes, on the kernel
    and the plain path, at batch 100 and 512, open and ring: the bench's
    step (SGD 1e-3) after 3 warm-up steps, over 5."""
    os.makedirs(out_dir, exist_ok=True)
    for batch, trace_edge in ((100, False), (100, True), (512, False), (512, True)):
        cfg = CSM.ConvSBSModelConfig(SBS_LAYERS, SBS_BOND, trace_edge=trace_edge)
        gen = torch.Generator().manual_seed(SEED)
        params = CSM.init_conv_sbs_model(gen, cfg)
        x = torch.rand((batch, 28, 28), generator=gen).to(dev)
        y = torch.randint(0, 10, (batch,), generator=gen).to(dev)
        for name, kernels in (("kernel", S.KERNELS), ("plain", S.PLAIN)):
            model = CSM.ConvSBSModel(params, cfg, device=dev)
            opt = torch.optim.SGD(model.parameters(), lr=1e-3)

            def step():
                opt.zero_grad(set_to_none=True)
                torch.nn.functional.cross_entropy(model(x, kernels=kernels), y).backward()
                opt.step()

            for _ in range(3):
                step()
            torch.cuda.synchronize()
            calls = 5
            t0 = time.perf_counter()
            for _ in range(calls):
                step()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / calls
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            tag = f"conv_sbs_bs{batch}_{'ring' if trace_edge else 'open'}"
            busy_ms, top = device_ms_per_call(step, calls, os.path.join(out_dir, f"profile_{tag}_{name}.txt"))
            print(json.dumps({
                "metric": "train_profile", "model": tag, "path": name, "batch_size": batch,
                "step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "device_idle_share": 1 - busy_ms / wall_ms,
                "extra_device_mib": (torch.cuda.max_memory_allocated(dev) - base) / 2**20,
                "top_device_ops_ms": top,
            }))


def profile_lme(bench, LSC, out_dir, dev) -> None:
    """Phase 10 (opt-in), the log-space entries: where the time of the
    chain's forward+backward (the kernel form, the ops form and plain
    matmul) and of one classifier step at batch 256 (fused_kernel,
    fused_plain, scan) goes, over 5 calls after 3 warm-up calls."""
    from dctn_tpu_torch.train import make_optimizer

    os.makedirs(out_dir, exist_ok=True)
    mats = bench.chain_inputs(dev)

    def chain_step(fn):
        leaves = [m.clone().requires_grad_(True) for m in mats]
        return lambda: torch.autograd.grad(torch.sum(fn(*leaves) ** 2), leaves)

    lf, y, _, _ = bench.log_space_data(dev)
    rows = torch.as_tensor(np.random.default_rng(0).integers(0, lf.shape[0], bench.LOG_SPACE_BATCH),
                           device=dev)

    def classifier_step(joint):
        log_w = LSC.init_log_w(torch.Generator().manual_seed(SEED)).to(dev).requires_grad_(True)
        opt = make_optimizer("adam", [log_w], LSC.LR)

        def step():
            opt.zero_grad(set_to_none=True)
            torch.nn.functional.cross_entropy(joint(log_w, lf[rows]), y[rows]).backward()
            opt.step()

        return step

    cases = [(f"chain_fwd_bwd_{name}", chain_step(bench.CHAIN_VARIANTS[name]))
             for name in ("logmatmulexp_kernel", "logmatmulexp", "matmul")]
    cases += [(f"log_space_step_{name}", classifier_step(bench.LOG_SPACE_VARIANTS[name]))
              for name in ("fused_kernel", "fused_plain", "scan")]
    for tag, fn in cases:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        calls = 5
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / calls
        busy_ms, top = device_ms_per_call(fn, calls, os.path.join(out_dir, f"profile_{tag}.txt"))
        print(json.dumps({
            "metric": "lme_profile", "case": tag, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms, "top_device_ops_ms": top,
        }))


# phase 10: the split tuner's objectives (name, forward only, quantize), and
# the steps that hold tuned against default splits (and ConvSBS picks against
# the heuristics)
AUTOTUNE_OBJECTIVES = (("train", False, None), ("QAT", False, "int8"),
                       ("serve f32", True, None), ("serve int8", True, "int8"))
AUTOTUNE_STEPS = 3
SBS_TUNE_BATCH = 100


def autotune_phase(bench, CSM, params, cfg, tx, ty, dev, tmp) -> tuple:
    """Phase 10: the three tuners on the card (see the module docstring).
    Returns (the phase's launch counts, its record)."""
    import dataclasses

    from dctn_tpu_torch.cli import export
    from dctn_tpu_torch.cli import runner as eps_runner
    from dctn_tpu_torch.data import io as data_io
    from dctn_tpu_torch.kernels import eps_kernels as K
    from dctn_tpu_torch.models import (
        EPSesPlusLinear,
        EPSesPlusLinearConfig,
        EPSesPlusLinearQ8,
        fast_layer_plans,
        reference_params_from_fast,
    )
    from dctn_tpu_torch.train import autotune as at
    from dctn_tpu_torch.train import resolve_auto_grad_accum, save_params_npz

    card = torch.cuda.get_device_name(dev)
    cache = os.path.join(tmp, "autotune.json")
    os.environ[at.CACHE_ENV] = cache  # the runners' and export's default_cache_path()
    record = {"device": card, "splits": {}}
    bench.zero_counters()
    base = fast_layer_plans(cfg)
    defaults = [p["n1"] for p in base]

    def at_splits(picks):
        return tuple({**p, "n1": n1} for p, n1 in zip(base, picks))

    def counting(name):
        """Wraps ``at.<name>`` to count its calls; returns (calls, restore)."""
        real, calls = getattr(at, name), []

        def wrapped(*a, **k):
            calls.append(a)
            return real(*a, **k)

        setattr(at, name, wrapped)
        return calls, lambda: setattr(at, name, real)

    # the split tuner, each objective, into the cache
    for name, forward_only, quantize in AUTOTUNE_OBJECTIVES:
        t0 = time.perf_counter()
        plans, report = at.autotune_splits(cfg, BATCH, device=dev, forward_only=forward_only,
                                           quantize=quantize, cache_path=cache)
        seconds = time.perf_counter() - t0
        picks = [p["n1"] for p in plans]
        rows = [[{k: r[k] for k in ("n1", "ms", "failed") if k in r} for r in layer["candidates"]]
                for layer in report]
        for i, (layer_rows, d) in enumerate(zip(rows, defaults)):
            check(any(r["n1"] == d and "ms" in r for r in layer_rows),
                  f"autotune {name} layer {i}: the default split {d} was not measured")
            print(f"autotune splits flagship batch {BATCH} {name} layer {i}: "
                  + ", ".join(f"n1={r['n1']} " + (f"{r['ms']:.4f} ms" if "ms" in r
                                                   else f"failed ({r['failed']})")
                              for r in layer_rows)
                  + f"; picked {picks[i]} (default {d})")
        print(f"autotune splits flagship batch {BATCH} {name}: picks {picks} (defaults "
              f"{defaults}), {seconds:.1f} s")
        record["splits"][name] = {"picks": picks, "defaults": defaults, "seconds": seconds,
                                  "candidates": rows}
    # a repeat of every tune measures nothing; the cache's keys name the card
    calls, restore = counting("_measure_candidate")
    try:
        t0 = time.perf_counter()
        for name, forward_only, quantize in AUTOTUNE_OBJECTIVES:
            plans, report = at.autotune_splits(cfg, BATCH, device=dev, forward_only=forward_only,
                                               quantize=quantize, cache_path=cache)
            check([p["n1"] for p in plans] == record["splits"][name]["picks"]
                  and all(r.get("cached") for r in report), f"autotune {name}: cache miss")
        record["cache_hit_s"] = (time.perf_counter() - t0) / len(AUTOTUNE_OBJECTIVES)
        check(not calls, f"a repeated tune measured {len(calls)} candidates")
        with open(cache) as f:
            keys = [json.loads(k) for k in json.load(f)]
        check(len(keys) == 4 and all(k["device"] == card for k in keys),
              f"autotune cache keys {[k['device'] for k in keys]} do not name the card {card}")
        print(f"autotune cache: a repeat of the 4 tunes measured nothing, "
              f"{1e3 * record['cache_hit_s']:.1f} ms per tune; keys name {card!r}")

        # 3 Adam steps at the training picks against the default splits:
        # each step's loss (of the largest loss) and the logits after the
        # steps (of the largest logit) within REL_TOL.
        # The parameters are printed, not held: Adam's first steps move an
        # entry by about ±lr whatever its gradient's size, so an entry whose
        # gradient is as small as the summation order's rounding can move
        # either way; such an entry barely moves the logits
        xb, yb = tx[:, :BATCH], ty[:BATCH]
        finals, losses, logits = [], [], []
        for splits in (record["splits"]["train"]["picks"], defaults):
            model, step = make_trainer(params, cfg, K.KERNELS, dev, TRAJ_LR,
                                       plans=at_splits(splits))
            losses.append([float(step(xb, yb)["loss"]) for _ in range(AUTOTUNE_STEPS)])
            with torch.inference_mode():
                logits.append(model(xb))
            with torch.no_grad():
                finals.append(reference_params_from_fast(model.fast_params(), cfg,
                                                         at_splits(splits)))
        check(all(math.isfinite(v) for v in losses[0]), "tuned-split steps: non-finite loss")
        loss_gap = max(abs(a - b) for a, b in zip(*losses)) / max(map(abs, losses[1]))
        err, scale = float((logits[0] - logits[1]).abs().max()), float(logits[1].abs().max())
        check(loss_gap <= REL_TOL and err <= REL_TOL * scale,
              f"{AUTOTUNE_STEPS} Adam steps at the tuned splits: losses {losses}, logits "
              f"max|d| {err} (max|ref| {scale})")
        params_gap = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(*(
            [t.detach() for t in (*f["epses"], f["linear"]["w"])] for f in finals)))
        record["train_tuned_vs_default"] = {"loss_rel": loss_gap, "logits_rel": err / scale,
                                            "params_rel": params_gap}
        print(f"{AUTOTUNE_STEPS} Adam steps (lr {TRAJ_LR:g}) at splits "
              f"{record['splits']['train']['picks']} vs {defaults}: losses {losses[0]} vs "
              f"{losses[1]} (largest gap / max loss {loss_gap:.3e}), final logits max|d|/max|ref| "
              f"{err / scale:.3e} (limit {REL_TOL:g}); parameters max|d|/max|p| "
              f"{params_gap:.3e}")
        del model, step, finals, logits

        # export at the serving picks (looked up in the cache: measured above)
        ckpt = os.path.join(tmp, "flagship_autotune.npz")
        save_params_npz(params, ckpt)
        x = tx[:, :BATCH]
        for name, quantize, key, cls in (("f32", "none", "serve f32", EPSesPlusLinear),
                                         ("int8", "int8", "serve int8", EPSesPlusLinearQ8)):
            art = os.path.join(tmp, f"autotune_{name}.zip")
            export.run(checkpoint=ckpt, epses_specs=FLAGSHIP, batch_sizes=ART_BATCHES,
                       device="cuda", quantize=quantize, autotune_splits=True,
                       autotune_cache=True, out=art)
            meta, fns = export.load_artifact(art)
            picks = record["splits"][key]["picks"]
            check(meta["autotuned_splits"] == picks,
                  f"{name} artifact's splits {meta.get('autotuned_splits')} != {picks}")
            eager = cls.from_reference(params, cfg, device=dev, plans=at_splits(picks))
            with torch.inference_mode():
                for bs in ART_BATCHES:
                    got, want = fns[bs](x[:, :bs]), eager(x[:, :bs])
                    err, scale = float((got - want).abs().max()), float(want.abs().max())
                    print(f"export --autotune-splits {name} (splits {picks}) vs eager, batch "
                          f"{bs}: max|d|={err:.3e} tol={ART_TOL * scale:.3e} bit-equal "
                          f"{bool(torch.equal(got, want))}")
                    check(torch.isfinite(got).all().item() and err <= ART_TOL * scale,
                          f"{name} artifact at tuned splits differs from the eager model")
        check(not calls, "export --autotune-splits measured again what the cache held")
    finally:
        restore()

    # the accumulation tuner on the deep model at batch 2048, and "auto"
    cfg_d = EPSesPlusLinearConfig(epses_specs=DEEP, image_size=28, q0=2)
    plans_d = fast_layer_plans(cfg_d)
    cap = resolve_auto_grad_accum(cfg_d, plans_d, DEEP_BATCH)
    check(cap == 4 and at.accum_candidates(cap, DEEP_BATCH) == [4, 8, 16],
          f"deep cap pick {cap}, candidates {at.accum_candidates(cap, DEEP_BATCH)}")
    t0 = time.perf_counter()
    pick = at.autotune_grad_accum(cfg_d, plans_d, DEEP_BATCH, cap_pick=cap, device=dev,
                                  log_fn=print, seed=SEED, cache_path=cache)
    record["accum"] = {"pick": pick, "seconds": time.perf_counter() - t0}
    with open(cache) as f:
        entry = next((v for k, v in json.load(f).items()
                      if json.loads(k).get("family") == "grad_accum"), {"candidates": []})
    record["accum"]["candidates"] = entry["candidates"]
    check(len(entry["candidates"]) == 3 and all("step_ms" in r for r in entry["candidates"]),
          f"accum candidates {entry}")
    calls, restore = counting("_measure_accum_candidate")
    try:
        auto = eps_runner._auto_grad_accum({"seed": SEED, "autotune_cache": True}, cfg_d, plans_d,
                                           DEEP_BATCH, 1, dev, None, True)
    finally:
        restore()
    check(auto == pick and not calls, f"the runner's auto took {auto}, the tuner {pick}")
    print(f"deep batch {DEEP_BATCH}: accumulation tuner picked {pick} of "
          f"{[r['accum'] for r in entry['candidates']]} (step ms "
          f"{[round(r['step_ms'], 4) for r in entry['candidates']]}), "
          f"{record['accum']['seconds']:.1f} s; the runner's auto -> {auto}")
    torch.cuda.empty_cache()

    # the ConvSBS tuner on the legacy recipe, open and ring, and 3 SGD steps
    # at its picks against the heuristics
    images, labels = data_io.synthetic_mnist_like(SBS_TUNE_BATCH, seed=1234)
    xs, ys = torch.as_tensor(images, device=dev), torch.as_tensor(labels, device=dev)
    record["conv_sbs"] = {}
    for trace_edge in (False, True):
        kind = "ring" if trace_edge else "open"
        scfg = sbs_model_cfg(CSM, xs, trace_edge)
        t0 = time.perf_counter()
        tuning, report = at.autotune_conv_sbs(scfg, 28, SBS_TUNE_BATCH, device=dev, seed=SEED)
        seconds = time.perf_counter() - t0
        for layer in (r for r in report if "candidates" in r):
            print(f"autotune conv_sbs {kind} batch {SBS_TUNE_BATCH} layer {layer['layer']}: "
                  + ", ".join(f"mim={r['mim']} mcut={r['mcut']} "
                              + (f"{r['ms']:.4f} ms" if "ms" in r else f"failed ({r['failed']})")
                              for r in layer["candidates"])
                  + f"; picked {layer['picked']} (heuristic {tuple(layer['heuristic'])})")
            check(not any("failed" in r for r in layer["candidates"]),
                  f"conv_sbs {kind}: a candidate failed on the card")
        gate = next((r["whole_model"] for r in report if "whole_model" in r), None)
        print(f"autotune conv_sbs {kind}: gate {gate}, picks {tuning}, {seconds:.1f} s")
        record["conv_sbs"][kind] = {"picks": tuning, "gate": gate, "seconds": seconds,
                                    "layers": [r for r in report if "candidates" in r]}
        sparams = sbs_recipe_params(CSM, scfg, xs, dev)
        finals = []
        for c in (dataclasses.replace(scfg, kernel_tuning=tuning), scfg):
            model = CSM.ConvSBSModel(sparams, c)
            opt = torch.optim.SGD(model.parameters(), lr=SBS_TRAJ_LR, momentum=0.9)
            for _ in range(AUTOTUNE_STEPS):
                opt.zero_grad()
                loss = torch.nn.functional.cross_entropy(model(xs), ys)
                loss.backward()
                opt.step()
            check(math.isfinite(float(loss)), f"conv_sbs {kind} tuned steps: non-finite loss")
            finals.append([p.detach() for p in model.parameters()])
        worst = 0.0
        for i, (a, b) in enumerate(zip(*finals)):
            err, scale = float((a - b).abs().max()), float(b.abs().max())
            check(err <= SBS_TRAJ_RTOL * scale, f"conv_sbs {kind}: core {i} after "
                  f"{AUTOTUNE_STEPS} steps at the picks differs from the heuristics' by {err}")
            worst = max(worst, err / scale)
        record["conv_sbs"][kind]["tuned_vs_heuristic"] = worst
        print(f"conv_sbs {kind}: {AUTOTUNE_STEPS} SGD steps at picks {tuning} vs the heuristics: "
              f"largest max|d|/max|p| {worst:.3e} (limit {SBS_TRAJ_RTOL:g})")
    del os.environ[at.CACHE_ENV]
    counts = {**bench.read_counters(), **bench.read_sbs_counters()}
    print(f"autotune phase launches {counts}")
    return counts, record


# ---------------------------------------------------------------------------
# phase 11: the bf16 operand mode


def bf16_kernels_vs_plain(K, dev) -> dict:
    """Phase 11 (a): each kernel's bf16 mode against its plain bf16 version
    on the same inputs (cmt rounded from a float32 draw), within REL_TOL
    (t within one bf16 step), and against the float32 kernel on the same
    inputs, which must differ by more (the negative control): K1 ± t,
    ``eps_dcore`` and ``eps_dviews_t`` at both flagship layers at batch 128
    (the d_views forms at layer 1, the recompute form forced there too), the
    recompute form and ``eps_dcore`` at the three-EPS model's layers 1 and 2
    (A = 64, 216). Kernel, plain and library times (one ``torch.matmul`` on
    bf16 operands for the products, which the port never calls) and the
    bound (products at the dense bf16 rate) are summed over the shapes each
    mode runs at on its path, as phase 2 sums them. Returns the kernels
    line's numbers of the bf16 entries."""
    flag = layer_dims(FLAGSHIP)
    three = layer_dims(THREE)
    shapes = {
        "flagship layer 0": flag[0], "flagship layer 1": flag[1],
        "three-EPS layer 1": three[1], "three-EPS layer 2": three[2],
    }
    runs = {
        "eps_fwd_bf16": ("flagship layer 0", "flagship layer 1", "three-EPS layer 2"),
        "eps_fwd_t_bf16": ("flagship layer 1",),
        "eps_dcore_bf16": ("flagship layer 0", "flagship layer 1", "three-EPS layer 1",
                           "three-EPS layer 2"),
        "eps_dviews_t_bf16": ("flagship layer 1",),
        "eps_dviews_recompute_bf16": ("flagship layer 1", "three-EPS layer 1",
                                      "three-EPS layer 2"),
    }
    on_path = {
        "eps_fwd_bf16": ("flagship layer 0", "flagship layer 1"),
        "eps_fwd_t_bf16": ("flagship layer 1",),
        "eps_dcore_bf16": ("flagship layer 0", "flagship layer 1"),
        "eps_dviews_t_bf16": ("flagship layer 1",),
        "eps_dviews_recompute_bf16": ("three-EPS layer 1", "three-EPS layer 2"),
    }
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "timed_by": CUDA_EVENTS, "bound_ms": 0.0, "flops": 0.0, "bf16_flops": 0.0,
               "bytes": 0.0, "f32_gap": float("inf")}
           for k in runs}
    bf = torch.bfloat16
    g_ = torch.Generator(device=dev).manual_seed(SEED)
    for label, (n, q, n1, o, h) in shapes.items():
        npix = BATCH * h * h
        views = torch.rand((n, q, npix), generator=g_, device=dev)
        cmt = torch.randn((o * q ** (n - n1), q**n1), generator=g_, device=dev) * q ** (-n / 2)
        g = torch.randn((o, npix), generator=g_, device=dev)
        cb = cmt.to(bf)
        z, a = cmt.shape
        tb = K.eps_fwd_reference(views, cb, n1, o, save_t=True)[1] if n1 < n else None
        tf = K.eps_fwd_reference(views, cmt, n1, o, save_t=True)[1] if n1 < n else None
        ub = K._suffix_chain(views, 0, n1)[0].to(bf)
        kb = K._kr2(views, g, n1).to(bf)
        f4, gemm = 4.0, 2.0 * z * a * npix
        cases = {
            "eps_fwd_bf16": (lambda: K.eps_fwd(views, cb, n1, o),
                             lambda: K.eps_fwd_reference(views, cb, n1, o),
                             lambda: K.eps_fwd(views, cmt, n1, o),
                             lambda: torch.matmul(cb, ub), (gemm, 2.0 * z * npix),
                             f4 * (views.numel() + o * npix) + 2.0 * cmt.numel()),
            "eps_fwd_t_bf16": (lambda: K.eps_fwd(views, cb, n1, o, save_t=True),
                               lambda: K.eps_fwd_reference(views, cb, n1, o, save_t=True),
                               lambda: K.eps_fwd(views, cmt, n1, o, save_t=True),
                               lambda: torch.matmul(cb, ub), (gemm, 2.0 * z * npix),
                               f4 * (views.numel() + o * npix) + 2.0 * (cmt.numel() + z * npix)),
            "eps_dcore_bf16": (lambda: K.eps_dcore(views, g, n1, o, mm_dtype=bf),
                               lambda: K.eps_dcore_reference(views, g, n1, o, bf),
                               lambda: K.eps_dcore(views, g, n1, o),
                               lambda: torch.matmul(kb, ub.T), (gemm, 0.0),
                               f4 * (views.numel() + g.numel() + z * a)),
            "eps_dviews_t_bf16": (lambda: K.eps_dviews_t(views, cb, g, tb, n1, o),
                                  lambda: K.eps_dviews_t_reference(views, cb, g, tb, n1, o),
                                  lambda: K.eps_dviews_t(views, cmt, g, tf, n1, o),
                                  lambda: torch.matmul(cb.T, kb), (gemm, 2.0 * z * npix),
                                  f4 * (2 * views.numel() + g.numel())
                                  + 2.0 * (cmt.numel() + (0 if tb is None else tb.numel()))),
            "eps_dviews_recompute_bf16": (
                lambda: K.eps_dviews_recompute(views, cb, g, n1, o),
                lambda: K.eps_dviews_recompute_reference(views, cb, g, n1, o),
                lambda: K.eps_dviews_recompute(views, cmt, g, n1, o),
                lambda: (torch.matmul(cb.T, kb), torch.matmul(cb, ub)),
                (2 * gemm, 2.0 * z * npix if n1 < n else 0.0),
                f4 * (2 * views.numel() + g.numel()) + 2.0 * cmt.numel()),
        }
        for name, (kern, plain, full, lib, (bf16_flops, flops), nbytes) in cases.items():
            if label not in runs[name]:
                continue
            got = kern()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref, f32 = plain(), full()
            ref = ref if isinstance(ref, tuple) else (ref,)
            f32 = f32 if isinstance(f32, tuple) else (f32,)
            errs = []
            for which, x, r, f in zip(("out", "t"), got, ref, f32):
                check(x.shape == r.shape and x.dtype == r.dtype,
                      f"{name} [{label}]: {which} {tuple(x.shape)} {x.dtype}")
                x, r, f = x.float(), r.float(), f.float()
                check(torch.isfinite(x).all().item(), f"{name} [{label}]: non-finite {which}")
                err, scale = float((x - r).abs().max()), float(r.abs().max())
                if which == "t":
                    excess = float(((x - r).abs() - BF16_STEP * r.abs()).max())
                    check(excess <= REL_TOL * scale,
                          f"{name} [{label}]: t more than a bf16 step from plain ({excess})")
                else:
                    check(err <= REL_TOL * scale,
                          f"{name} [{label}]: {which} differs from plain by {err} (max|ref| {scale})")
                gap = float((x - f).abs().max()) / scale
                check(gap > REL_TOL, f"{name} [{label}]: {which} within {gap:.2e} of the float32 "
                      "kernel's: the mode did not round")
                errs.append(f"{which} max|d|={err:.3e} tol={REL_TOL * scale:.3e} vs f32 kernel "
                            f"{gap:.2e} of max")
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
                res[name]["f32_gap"] = min(res[name]["f32_gap"], gap)
            t_k, t_p, t_l = median_ms([kern, plain, lib], reps=10)
            b_ms, _ = bound_ms(nbytes, flops, bf16_flops=bf16_flops)
            print(f"{name} vs plain [{label}] n={n} q={q} n1={n1} O={o} npix={npix}: "
                  f"{'; '.join(errs)}; kernel {t_k:.4f} ms "
                  f"({bf16_flops / t_k / 1e9:.2f} TFLOP/s of the products), plain {t_p:.4f} ms, "
                  f"library bf16 matmul {t_l:.4f} ms, bound {b_ms:.4f} ms")
            if label in on_path[name]:
                r_ = res[name]
                r_["ms"] += t_k
                r_["plain_ms"] += t_p
                r_["library_ms"] += t_l
                r_["bytes"] += nbytes
                r_["flops"] += flops
                r_["bf16_flops"] += bf16_flops
        del views, cmt, g, cb, tb, tf, ub, kb
    for r_ in res.values():
        r_["bound_ms"], r_["bound_by"] = bound_ms(r_.pop("bytes"), r_.pop("flops"),
                                                  bf16_flops=r_.pop("bf16_flops"))
        print(f"bf16 negative control: the closest float32 kernel result lay "
              f"{r_.pop('f32_gap'):.2e} of the largest entry away (> {REL_TOL:g})")
    for label, (n, q, n1, o, _) in shapes.items():
        mirrors = (K._fwd_bf16_plan(n, q, n1, o, 1)["smem_bytes"],
                   K._dcore_bf16_smem_bytes(n, q, n1, o),
                   K._dviews_bf16_smem_bytes(n, q, n1, o, False),
                   K._dviews_bf16_smem_bytes(n, q, n1, o, True))
        sources = (K._library("eps_fwd").dctn_eps_fwd_bf16_smem_bytes(n, q, n1, o),
                   K._library("eps_dcore").dctn_eps_dcore_bf16_smem_bytes(n, q, n1, o),
                   *(K._library("eps_dviews_t").dctn_eps_dviews_bf16_smem_bytes(n, q, n1, o, r)
                     for r in (0, 1)))
        check(mirrors == sources, f"bf16 plans [{label}]: the Python mirrors {mirrors} of "
              f"shared memory are not the sources' {sources}")
        route = K._fwd_bf16_plan(n, q, n1, o, 1)["route"]
        source_route = K._library("eps_fwd").dctn_eps_fwd_bf16_route(n, q, n1, o)
        check(route == ("wgmma" if source_route else "mma.sync"),
              f"K1 bf16 [{label}]: the plan's route {route} is not the source's")
        print(f"K1 bf16 [{label}]: {route} route")
    bf16_dcore_chunks_vs_plain(K, dev, layer_dims(FLAGSHIP)[1])
    bf16_fwd_chunks_vs_plain(K, dev, layer_dims(FLAGSHIP)[1])
    return res


def bf16_fwd_chunks_vs_plain(K, dev, dims) -> None:
    """Phase 11 (a): K1 bf16 with and without t over several chunks of
    pixels, as the deep model's layer 1 runs it at 2048 (its u's scratch
    capped to BF16_FWD_CHUNK_TILES tiles of 128 pixels here): the flagship's
    layer 1 at BF16_CHUNK_IMAGES images, a short ragged last chunk; out
    within REL_TOL of the plain version and t within a bf16 step, a chunk
    counted once each, the same bits twice, and the serving out the save_t
    out's bits."""
    n, q, n1, o, h = dims
    npix = BF16_CHUNK_IMAGES * h * h
    cap = K._BF16_FWD_OPS_BYTES
    K._BF16_FWD_OPS_BYTES = 2 * K._pad_to(q**n1, 64) * 128 * BF16_FWD_CHUNK_TILES
    try:
        plan = K._fwd_bf16_plan(n, q, n1, o, npix)
        g_ = torch.Generator(device=dev).manual_seed(SEED)
        views = torch.rand((n, q, npix), generator=g_, device=dev)
        cb = (torch.randn((o * q ** (n - n1), q**n1), generator=g_, device=dev)
              * q ** (-n / 2)).to(torch.bfloat16)
        before = K.eps_fwd.bf16_chunk_launches
        out, t = K.eps_fwd(views, cb, n1, o, save_t=True)
        torch.cuda.synchronize()
        chunks = K.eps_fwd.bf16_chunk_launches - before
        out2, t2 = K.eps_fwd(views, cb, n1, o, save_t=True)
        served = K.eps_fwd(views, cb, n1, o)
    finally:
        K._BF16_FWD_OPS_BYTES = cap
    ref, ref_t = K.eps_fwd_reference(views, cb, n1, o, save_t=True)
    err, scale = float((out - ref).abs().max()), float(ref.abs().max())
    t_f, ref_tf = t.float(), ref_t.float()
    excess = float(((t_f - ref_tf).abs() - BF16_STEP * ref_tf.abs()).max())
    last = npix - (chunks - 1) * plan["chunk"]
    print(f"eps_fwd_t_bf16 in chunks [flagship layer 1, {BF16_CHUNK_IMAGES} images, "
          f"npix={npix}]: {chunks} chunks of {plan['chunk']} pixels (the last {last}): out "
          f"max|d|={err:.3e} tol={REL_TOL * scale:.3e}, t past a bf16 step {excess:.3e}")
    check(chunks == plan["chunks"] == -(-npix // plan["chunk"]) >= 3 and last % 128 != 0,
          f"eps_fwd_bf16 chunk case: {chunks} chunks of {plan['chunk']}: not the case it "
          "should be")
    check(torch.isfinite(out).all().item() and err <= REL_TOL * scale
          and excess <= REL_TOL * float(ref_tf.abs().max()),
          "eps_fwd_bf16 in chunks differs from plain")
    check(torch.equal(out, out2) and torch.equal(t, t2), "eps_fwd_bf16 in chunks: two runs differ")
    check(torch.equal(out, served), "eps_fwd_bf16 in chunks: serving and save_t outs differ")


def bf16_dcore_chunks_vs_plain(K, dev, dims) -> None:
    """Phase 11 (a): ``eps_dcore``'s bf16 mode over several chunks of
    pixels, as the deep model's layer 1 runs it at 2048 (its operands'
    scratch capped to BF16_CHUNK_STEPS steps of 64 pixels here): the
    flagship's layer 1 at BF16_CHUNK_IMAGES images, so more than one pixel
    slice, a short last chunk (some slices with no step of it) and a ragged
    last step; against the plain version within REL_TOL, a chunk counted
    once each, the same bits twice."""
    n, q, n1, o, h = dims
    npix = BF16_CHUNK_IMAGES * h * h
    z, a = o * q ** (n - n1), q**n1
    rows = K._pad_to(a, K._BF16_DCORE_TILE) + K._pad_to(z, K._BF16_DCORE_TILE)
    cap = K._BF16_DCORE_OPS_BYTES
    K._BF16_DCORE_OPS_BYTES = 2 * rows * 64 * BF16_CHUNK_STEPS
    try:
        chunk = K._dcore_bf16_chunk(z, a, npix)
        slices = K._dcore_bf16_slices(z, a, npix, K._sm_count(dev))
        g_ = torch.Generator(device=dev).manual_seed(SEED)
        views = torch.rand((n, q, npix), generator=g_, device=dev)
        g = torch.randn((o, npix), generator=g_, device=dev)
        before = K.eps_dcore.bf16_chunk_launches
        got = K.eps_dcore(views, g, n1, o, mm_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        chunks = K.eps_dcore.bf16_chunk_launches - before
        again = K.eps_dcore(views, g, n1, o, mm_dtype=torch.bfloat16)
    finally:
        K._BF16_DCORE_OPS_BYTES = cap
    ref = K.eps_dcore_reference(views, g, n1, o, torch.bfloat16)
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    last = npix - (chunks - 1) * chunk
    print(f"eps_dcore_bf16 in chunks [flagship layer 1, {BF16_CHUNK_IMAGES} images, npix={npix}]: "
          f"{chunks} chunks of {chunk} pixels (the last {last}), {slices} slices: "
          f"max|d|={err:.3e} tol={REL_TOL * scale:.3e}")
    check(chunks == -(-npix // chunk) >= 3 and slices > 1 and npix % 64 != 0
          and -(-last // 64) < slices, f"eps_dcore_bf16 chunk case: {chunks} chunks, {slices} "
          "slices: not the case it should be")
    check(torch.isfinite(got).all().item() and err <= REL_TOL * scale,
          "eps_dcore_bf16 in chunks differs from plain")
    check(torch.equal(got, again), "eps_dcore_bf16 in chunks: two runs differ")


def bf16_phase(trunner, bench, K, params, cfg, dev, tmp) -> tuple:
    """Phase 11: the bf16 operand mode on the card. (a) the kernels'
    bf16 modes against their plain versions (``bf16_kernels_vs_plain``);
    (b) the runner's README quick start at full width with
    ``--compute-dtype bfloat16`` for BF16_RUN_ITERS iterations and its evals
    (launches exact, the final logits through the kernels against the plain
    bf16 forward); the three-EPS bench step in bf16 (its layers 1 and 2 on
    the recompute arm); (c) the deep model's step at batch 2048 with
    ``grad_accum_steps="auto"``: 2 in bf16, as the JAX docs say; (d) a bf16
    artifact exported, loaded, predicted from and served, its logits the
    eager bf16 model's bits; (e) the flagship step and forward, f32 and
    bf16, in turns. Returns (the launch counts of b-e, the kernels line's
    bf16 numbers, the phase's record)."""
    import threading
    import urllib.request

    from dctn_tpu_torch.cli import export, predict, serve
    from dctn_tpu_torch.models import EPSesPlusLinear, EPSesPlusLinearConfig, fast_layer_plans
    from dctn_tpu_torch.train import resolve_auto_grad_accum, save_params_npz

    bf = torch.bfloat16
    numbers = bf16_kernels_vs_plain(K, dev)
    keys = tuple(bench.read_counters())
    counts, record = [], {}

    # (b) the runner, then the three-EPS bench step
    sizes = RUN_SHORT_SIZES
    kw = dict(ds_type="fashionmnist", ds_path="synthetic", batch_size=BATCH,
              optimizer_name="adam", lr=3e-3, init_epses_composition_unit_empirical_output_std=True,
              epses_specs=FLAGSHIP, synthetic_sizes=sizes, compute_dtype="bfloat16",
              eval_schedule=((None, BF16_RUN_ITERS),))
    state, run_counts, out = run_runner(trunner, bench, tmp, "bf16", max_num_iters=BF16_RUN_ITERS,
                                        **kw)
    counts.append(run_counts)
    check(state.extras["cfg"].compute_dtype == bf, "the runner's model is not in bf16")
    check_runner_log(out, range(0, BF16_RUN_ITERS + 1, BF16_RUN_ITERS))
    per_step = launches_per_step(FLAGSHIP, BATCH, 1, None, keys, bf16=True)
    want = {k: v * BF16_RUN_ITERS for k, v in per_step.items()}
    want["eps_fwd"] += runner_init_launches(sizes[0], BATCH, 2)  # the init runs in float32
    want["eps_fwd_bf16"] += 2 * runner_eval_launches(sizes, BATCH, 2)
    # an eval batch holds at most BATCH images: one chunk of u a layer
    check(all(K._fwd_bf16_plan(n, q, n1, o, BATCH * h * h)["chunks"] == 1
              for n, q, n1, o, h in layer_dims(FLAGSHIP)), "a flagship forward over one chunk")
    want["eps_fwd_chunks_bf16"] += 2 * runner_eval_launches(sizes, BATCH, 2)
    check(run_counts == want, f"bf16 runner launches {run_counts} != {want}")
    final = final_reference(state)
    model = EPSesPlusLinear.from_reference(final, state.extras["cfg"])
    xb, _ = state.extras["gather"](torch.arange(BATCH, device=dev))
    with torch.inference_mode():
        got, ref = model(xb), model(xb, kernels=K.PLAIN)
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    print(f"bf16 runner: final logits vs the plain bf16 forward (batch {BATCH}): "
          f"max|d|={err:.3e} tol={REL_TOL * scale:.3e}")
    check(torch.isfinite(got).all().item() and err <= REL_TOL * scale,
          "the bf16 runner's logits differ from the plain bf16 forward")
    timing = state.extras["timing"]
    record["runner"] = {
        "ms_per_iteration": 1e3 * (timing["loop_s"] - timing["hooks_s"]) / max(timing["iters"], 1),
        "ms_per_eval": 1e3 * timing["eval_s"] / max(timing["evals"], 1),
    }
    want = launches_per_step(THREE, BATCH, 1, None, keys, bf16=True)
    check(want["eps_dviews_recompute_bf16"] == 2, f"three-EPS bf16 arms {want}")
    bench.zero_counters()
    (rec3,) = bench.run(device="cuda", steps=5, warmup=1, epses_specs=THREE, compute_dtype=bf)
    three_counts = bench.read_counters()
    counts.append(three_counts)
    check(rec3["launches_per_step"] == {k: float(v) for k, v in want.items()},
          f"three-EPS bf16 launches per step {rec3['launches_per_step']} != {want}")
    check(all(math.isfinite(rec3[k]) for k in ("first_loss", "last_loss")), "non-finite loss")
    print_train_record(rec3, "three-EPS bf16")

    # (c) the deep model at batch 2048, accumulation "auto"
    cfg_d = EPSesPlusLinearConfig(epses_specs=DEEP, image_size=28, q0=2, compute_dtype=bf)
    auto = resolve_auto_grad_accum(cfg_d, fast_layer_plans(cfg_d), DEEP_BATCH)
    print(f"deep model at batch {DEEP_BATCH} in bf16: grad_accum_steps auto -> {auto} "
          "(the JAX docs: 2; the float32 mode: 4)")
    check(auto == 2, f"auto resolved to {auto} in bf16, not 2")
    bench.zero_counters()
    (recd,) = bench.run(device="cuda", steps=DEEP_STEPS, warmup=1, batch_size=DEEP_BATCH,
                        epses_specs=DEEP, lr=DEEP_LR, reg_type=DEEP_REG[0], reg_coeff=DEEP_REG[1],
                        grad_accum_steps="auto", compute_dtype=bf)
    deep_counts = bench.read_counters()
    counts.append(deep_counts)
    want = launches_per_step(DEEP, DEEP_BATCH, 2, None, keys, bf16=True)
    check(recd["grad_accum_steps"] == 2 and recd["launches_per_step"] == {
        k: float(v) for k, v in want.items()}, f"deep bf16 launches {recd['launches_per_step']}")
    check(deep_counts == {k: v * (DEEP_STEPS + 2) for k, v in want.items()},
          f"deep bf16 launches over the run {deep_counts}")
    check(all(math.isfinite(recd[k]) for k in ("first_loss", "last_loss")), "non-finite loss")
    print_train_record(recd, f"deep batch {DEEP_BATCH} bf16 grad_accum_steps=auto (2)")
    record["deep"] = {k: recd[k] for k in ("grad_accum_steps", "step_ms_p50", "images_per_s",
                                           "peak_extra_mib", "launches_per_step")}

    # (d) a bf16 artifact: exported, loaded, predicted from, served
    bench.zero_counters()
    ckpt = os.path.join(tmp, "flagship_bf16.npz")
    save_params_npz(params, ckpt)
    art = os.path.join(tmp, "bf16.zip")
    report = export.run(checkpoint=ckpt, epses_specs=FLAGSHIP, batch_sizes=ART_BATCHES,
                        device="cuda", compute_dtype="bfloat16", out=art)
    meta, fns = export.load_artifact(art)
    check(meta["compute_dtype"] == "bfloat16" and meta["platforms"] == ["cuda"], f"meta {meta}")
    eager = EPSesPlusLinear.from_reference(
        params, EPSesPlusLinearConfig(epses_specs=FLAGSHIP, image_size=28, q0=2, compute_dtype=bf),
        device=dev)
    from dctn_tpu_torch.data import load_dataset

    x = torch.as_tensor(load_dataset("fashionmnist", "synthetic", autoscale_kernel_size=4,
                                     synthetic_sizes=(4, 4, 300)).test.x, device=dev)
    art_rec = {"export_s": report["export_s"], "artifact_bytes": report["artifact_bytes"]}
    with torch.inference_mode():
        for bs in ART_BATCHES:
            check(export.op_nodes(fns[bs]) == {"eps_fwd": 2}, f"bf16 artifact nodes bs {bs}")
            before = bench.read_counters()
            got = fns[bs](x[:, :bs])
            torch.cuda.synchronize()
            moved = {k: v - before[k] for k, v in bench.read_counters().items() if v != before[k]}
            check(moved == {"eps_fwd_bf16": 2, "eps_fwd_chunks_bf16": 2},
                  f"bf16 artifact bs {bs}: launches {moved}")
            want_l = eager(x[:, :bs])
            equal = bool(torch.equal(got, want_l))
            print(f"bf16 artifact vs eager bf16 model, batch {bs}: "
                  f"max|d|={float((got - want_l).abs().max()):.3e}, bit-equal {equal}")
            check(equal, f"bf16 artifact bs {bs}: logits are not the eager bf16 model's bits")
    run = predict.run(checkpoint=art, ds_type="fashionmnist", ds_path="synthetic",
                      batch_size=BATCH, latency_bench=True, device="cuda",
                      synthetic_sizes=(4, 4, 1024))
    with torch.inference_mode():
        direct = eager(run.x[:, :BATCH]).argmax(1).cpu().numpy()
    check(bool((direct == run.preds[:BATCH]).all()), "predict.run on the bf16 artifact")
    art_rec["predict_latency"] = {s["batch_size"]: {k: s[k] for k in ("p50_ms", "p90_ms")}
                                  for s in run.latency}
    server, smodel = serve.make_server(art, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        xs = run.x[:, :BATCH].cpu().numpy()
        buf = io.BytesIO()
        np.save(buf, xs)
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/predict", data=buf.getvalue(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            served = np.load(io.BytesIO(resp.read()))
    finally:
        server.shutdown()
        server.server_close()
        smodel.close()
    with torch.inference_mode():
        check(np.array_equal(served, fns[BATCH](run.x[:, :BATCH]).cpu().numpy()),
              "the served bf16 logits are not the artifact's")
    counts.append(bench.read_counters())
    record["artifact"] = art_rec

    # (e) the flagship step and forward, f32 and bf16, in turns
    bench.zero_counters()
    turns = []
    for dtype in (None, bf, bf, None):
        (rec,) = bench.run(device="cuda", steps=BF16_TURN_STEPS, compute_dtype=dtype,
                           time_forward=True)
        turns.append({k: rec[k] for k in ("compute_dtype", "step_ms_p50", "forward_ms_p50",
                                           "images_per_s", "peak_extra_mib")})
        print_train_record(rec, f"turn {len(turns)} {rec['compute_dtype']}")
    counts.append(bench.read_counters())
    record["turns"] = turns
    for dtype in ("float32", "bfloat16"):
        mine = [t for t in turns if t["compute_dtype"] == dtype]
        record[dtype] = {k: statistics.median(t[k] for t in mine)
                         for k in ("step_ms_p50", "forward_ms_p50", "images_per_s")}
    print(f"flagship at batch {BATCH}, in turns: step p50 f32 {record['float32']['step_ms_p50']:.4f} "
          f"ms, bf16 {record['bfloat16']['step_ms_p50']:.4f} ms; forward p50 f32 "
          f"{record['float32']['forward_ms_p50']:.4f} ms, bf16 "
          f"{record['bfloat16']['forward_ms_p50']:.4f} ms")
    return counts, numbers, record


def q8_bf16_t_vs_plain(K, Q8, dev) -> tuple:
    """Phase 11 (f): K9 storing t in bf16 (the bf16 QAT step's) against its
    plain version at flagship layer 1 at batch 128, at a TP and an SP
    shard's layer 1 (BF16_Q8_SHARDS), at BF16_Q8_EDGES and at a layer only
    the mma.sync kernel takes (BF16_Q8_MMA_SYNC): t bit-equal to the plain
    version's and to the float32 K9's t rounded to nearest even, out
    bit-equal to the float32 K9's (summed from the same float32 t) and
    within REL_TOL of the plain version's; both kernels (wgmma and
    mma.sync) and every store route of the bf16 t (BF16_Q8_ROUTES, as the
    plan and the source's own plan name it) must run. Kernel, plain,
    library (``torch._int_mm``, as K9's entry) and bound times at flagship
    layer 1, with the float32 K9 and K8 timed in the same turns. Returns the
    kernels line's numbers of ``eps_fwd_q8_t_bf16`` and the record."""
    bf = torch.bfloat16
    n, q, n1, o, h = layer_dims(FLAGSHIP)[1]
    shapes = [("flagship layer 1", n, q, n1, o, BATCH * h * h)]
    shapes += [(label, *dims) for label, _, *dims in grid_shard_shapes() if label in BF16_Q8_SHARDS]
    shapes += [*BF16_Q8_EDGES, BF16_Q8_MMA_SYNC]
    check(len(shapes) == 7, f"K9 bf16 shapes {[s_[0] for s_ in shapes]}")
    num = {"max_abs_err": 0.0, "timed_by": CUDA_EVENTS}
    record, forms, routes = {}, set(), {}
    lib = K._library("eps_fwd_q8")
    g_ = torch.Generator(device=dev).manual_seed(SEED)
    for label, n, q, n1, o, npix in shapes:
        views = torch.rand((n, q, npix), generator=g_, device=dev)
        cmt = torch.randn((o * q ** (n - n1), q**n1), generator=g_, device=dev) * q ** (-n / 2)
        wq, sw = Q8.quantize_cmt(cmt)
        z, a = cmt.shape
        plan = Q8._q8_plan(n, q, n1, o, npix, "bf16")
        form, route = plan["form"], plan["t_store"]
        source_route = Q8._T_STORES[lib.dctn_eps_fwd_q8_t_store(n, q, n1, o, npix,
                                                                Q8._T_KINDS["bf16"])]
        check(route == source_route, f"K9 bf16 [{label}]: the plan's t store {route} is not the "
                                     f"source's {source_route}")
        forms.add(form)
        routes[label] = route
        kern = lambda: Q8.eps_fwd_q8(views, wq, sw, n1, o, save_t=True, t_dtype=bf)  # noqa: E731
        k32 = lambda: Q8.eps_fwd_q8(views, wq, sw, n1, o, save_t=True)  # noqa: E731
        plain = lambda: Q8.eps_fwd_q8_reference(views, wq, sw, n1, o, save_t=True,  # noqa: E731
                                                 t_dtype=bf)
        before = Q8.eps_fwd_q8.bf16_t_launches
        (out, t), (out32, t32), (rout, rt) = kern(), k32(), plain()
        torch.cuda.synchronize()
        check(Q8.eps_fwd_q8.bf16_t_launches == before + 1, f"K9 bf16 [{label}]: not counted")
        check(t.dtype == rt.dtype == bf and t.shape == (z, npix), f"K9 bf16 [{label}]: t {t.dtype}")
        check(torch.equal(t, rt), f"K9 bf16 [{label}]: t is not the plain version's bit for bit")
        check(torch.equal(t, t32.to(bf)), f"K9 bf16 [{label}]: t is not the float32 K9's t "
                                          "rounded to nearest even")
        check(torch.equal(out, out32), f"K9 bf16 [{label}]: out is not the float32 K9's")
        err, scale = float((out - rout).abs().max()), float(rout.abs().max())
        check(torch.isfinite(out).all().item() and err <= REL_TOL * scale,
              f"K9 bf16 [{label}]: out differs from plain by {err} (max|ref| {scale})")
        num["max_abs_err"] = max(num["max_abs_err"], err)
        print(f"eps_fwd_q8_t_bf16 vs plain [{label}] n={n} q={q} n1={n1} O={o} npix={npix} "
              f"({form}, t store {route}, {plan['stages']} ring stages): t bit-equal to plain and "
              f"to the f32 K9's t rounded, out bit-equal to the f32 K9's, out max|d| vs plain "
              f"{err:.3e} tol={REL_TOL * scale:.3e}")
        if label == "flagship layer 1":
            uq = Q8._quantize_columns(K._suffix_chain(views, 0, n1)[0])[0]
            lib_mm = lambda: torch._int_mm(wq, uq)  # noqa: E731
            k8 = lambda: Q8.eps_fwd_q8(views, wq, sw, n1, o)  # noqa: E731
            t_k, t_32, t_8, t_p, t_l = median_ms([kern, k32, k8, plain, lib_mm], reps=10)
            gemm = 2.0 * z * a * npix
            nbytes = 4.0 * (views.numel() + z + o * npix) + wq.numel() + 2.0 * z * npix
            num["bound_ms"], num["bound_by"] = bound_ms(nbytes, 4.0 * z * npix, int8_ops=gemm)
            num.update(ms=t_k, plain_ms=t_p, library_ms=t_l)
            record = {"ms": t_k, "f32_t_ms": t_32, "k8_ms": t_8, "plain_ms": t_p, "library_ms": t_l,
                      "bound_ms": num["bound_ms"], "bound_by": num["bound_by"]}
            print(f"  K9 at flagship layer 1: bf16 t {t_k:.4f} ms, f32 t {t_32:.4f} ms, K8 "
                  f"{t_8:.4f} ms (in turns), plain {t_p:.4f} ms, torch._int_mm {t_l:.4f} ms, bound "
                  f"{num['bound_ms']:.4f} ms ({num['bound_by']})")
        del views, cmt, wq, sw, out, t, out32, t32, rout, rt
    check(forms == {"wgmma", "mma.sync"}, f"K9 bf16 ran on {forms}, not both kernels")
    check(set(routes.values()) == BF16_Q8_ROUTES,
          f"K9 bf16 took the t stores {sorted(set(routes.values()))}, not {sorted(BF16_Q8_ROUTES)}")
    print(f"K9 bf16 t store routes: {routes}")
    record["forms"] = sorted(forms)
    record["t_stores"] = routes
    return num, record


def qat_bf16_phase(bench, K, Q8, params, cfg, tx, ty, dev) -> tuple:
    """Phase 11 (f-h): the bf16 QAT step. (f) K9 with a bf16 t against its
    plain version (``q8_bf16_t_vs_plain``); (g) the flagship's QAT step in
    bf16 through ``bench.run`` (kernels and plain bundle, launches exact:
    K8 at layer 0, K9 with a bf16 t at layer 1, ``eps_dcore`` and
    ``eps_dviews_t`` in bf16), one step's gradients on the kernels against
    the plain bf16 QAT bundle's within BF16_QAT_GRAD_TOL, and 3 Adam steps
    at TRAJ_LR on both (losses at TRAJ_RTOL, parameters in norm at
    TRAJ_NORM_TOL); its forward logits equal the float32 QAT forward's bit
    for bit; (h) the flagship QAT step p50, f32 and bf16, in turns. Returns
    (launch counts of g-h, the kernels line's K9 bf16 numbers, record)."""
    import dataclasses

    from dctn_tpu_torch.models import EPSesPlusLinear

    bf = torch.bfloat16
    numbers, record = q8_bf16_t_vs_plain(K, Q8, dev)
    record = {"k9_bf16": record}
    keys = tuple(bench.read_counters())
    cfg16 = dataclasses.replace(cfg, compute_dtype=bf)
    counts = []

    # (g) the flagship's QAT step in bf16
    want = launches_per_step(FLAGSHIP, BATCH, 1, "int8", keys, bf16=True)
    check(want["eps_fwd_q8_t_bf16"] == 1 and want["eps_dviews_t_bf16"] == 1
          and want["eps_fwd_q8"] == 2, f"the flagship's bf16 QAT arms {want}")
    steps_run = 3 + 1 + TRAIN_STEPS
    bench.zero_counters()
    rec_k, rec_p = bench.run(device="cuda", steps=TRAIN_STEPS, compare_plain=True, qat="int8",
                             compute_dtype=bf)
    run_counts = bench.read_counters()
    counts.append(run_counts)
    check(rec_k["launches_per_step"] == {k: float(v) for k, v in want.items()},
          f"bf16 QAT launches per step {rec_k['launches_per_step']} != {want}")
    check(run_counts == {k: v * steps_run for k, v in want.items()},
          f"bf16 QAT launches over the run {run_counts}")
    for rec in (rec_k, rec_p):
        check(all(math.isfinite(rec[k]) for k in ("first_loss", "last_loss")), "non-finite loss")
        print_train_record(rec, "qat=int8 bf16")
    xb, yb = tx[:, :BATCH], ty[:BATCH]
    grads, trainers = [], []
    for kernels in (Q8.QAT_KERNELS, Q8.QAT_PLAIN):
        model, step = make_trainer(params, cfg16, kernels, dev, bench.LR)
        step(xb, yb)
        grads.append([p.grad for p in model.parameters()])
    gap = compare_gradients(grads, BF16_QAT_GRAD_TOL, "flagship bf16 QAT kernel vs plain")
    print(f"flagship bf16 QAT gradients, kernel vs plain: largest max|d|/max|ref| {gap:.3e} "
          f"(limit {BF16_QAT_GRAD_TOL:g})")
    record["gradient_gap"] = gap
    del grads
    for kernels in (Q8.QAT_KERNELS, Q8.QAT_PLAIN):
        trainers.append(make_trainer(params, cfg16, kernels, dev, TRAJ_LR))
    start = [p.detach().clone() for p in trainers[1][0].parameters()]
    losses = [[float(step(xb, yb)["loss"]) for _ in range(3)] for _, step in trainers]
    check(np.allclose(losses[0], losses[1], rtol=TRAJ_RTOL, atol=0),
          f"bf16 QAT 3 steps: losses {losses[0]} vs plain {losses[1]}")
    worst = 0.0
    for pk, pp, p0 in zip(trainers[0][0].parameters(), trainers[1][0].parameters(), start):
        move = float((pp.detach() - p0).norm())
        gap_n = float((pk.detach() - pp.detach()).norm()) / max(move, 1e-30)
        worst = max(worst, gap_n)
    check(worst <= TRAJ_NORM_TOL, f"bf16 QAT 3 steps: parameters {worst:.3e} of the move apart")
    print(f"flagship bf16 QAT, 3 Adam steps at lr {TRAJ_LR:g}, kernel vs plain: losses "
          f"{losses[0]} vs {losses[1]}; parameters {worst:.3e} of the plain move apart (norm)")
    record["trajectory"] = {"losses": losses, "parameter_gap": worst}
    model32 = EPSesPlusLinear.from_reference(params, cfg, device=dev)
    model16 = EPSesPlusLinear.from_reference(params, cfg16, device=dev)
    bench.zero_counters()
    with torch.inference_mode():
        same = torch.equal(model16(xb, kernels=Q8.QAT_KERNELS), model32(xb, kernels=Q8.QAT_KERNELS))
    counts.append(bench.read_counters())
    check(same, "the bf16 QAT forward's logits are not the float32 QAT forward's bits")
    del trainers, model32, model16

    # (h) the flagship QAT step, f32 and bf16, in turns
    bench.zero_counters()
    turns = []
    for dtype in (None, bf, bf, None):
        (rec,) = bench.run(device="cuda", steps=BF16_TURN_STEPS, qat="int8", compute_dtype=dtype)
        turns.append({k: rec[k] for k in ("compute_dtype", "step_ms_p50", "images_per_s",
                                           "peak_extra_mib")})
        print_train_record(rec, f"QAT turn {len(turns)} {rec['compute_dtype']}")
    counts.append(bench.read_counters())
    record["qat_turns"] = turns
    for dtype in ("float32", "bfloat16"):
        mine = [t_ for t_ in turns if t_["compute_dtype"] == dtype]
        record[f"qat_{dtype}"] = {k: statistics.median(t_[k] for t_ in mine)
                                  for k in ("step_ms_p50", "images_per_s")}
    print(f"flagship QAT step at batch {BATCH}, in turns: p50 f32 "
          f"{record['qat_float32']['step_ms_p50']:.4f} ms, bf16 "
          f"{record['qat_bfloat16']['step_ms_p50']:.4f} ms")
    return counts, numbers, record


# phase 12: where the port falls back as the JAX package does: an EPS model
# with a layer outside the kernels' plans trained through the runner (the
# reference layout, the plain path), and the legacy runner at a bond outside
# the ConvSBS kernels' scope (every string on the plain folds)
FALLBACK_SPECS = ((5, 4),)
FALLBACK_BATCH = 16
FALLBACK_ITERS = 4
FALLBACK_SIZES = (256, 64, 64)
FALLBACK_SBS_BOND = 12
FALLBACK_SBS_SIZES = (200, 100)


def fallback_phase(trunner, legacy_runner, bench, K, CSM, dev, tmp) -> list:
    """Phase 12: ``runner.run`` with ``--epses-specs "(5,4)"`` (outside the
    kernels' plans: JAX's ``pallas_forward_fits`` refuses it too) trains a
    few steps on the reference layout: no EPS kernel launches, both
    fallbacks (the layout's, the layer's) in run_info.txt, its logits on the
    card the plain path's; then ``legacy_runner.run`` at bond 12 trains an
    epoch on the plain folds with the fallback recorded, no ConvSBS kernel
    launched, and the trained model's logits on the card equal the CPU
    plain fold's within REL_TOL. Returns the runs' counts."""
    from dctn_tpu_torch.data import io as data_io
    from dctn_tpu_torch.models import EPSesPlusLinearReference, eps_plus_linear_forward

    t0 = time.perf_counter()
    state, counts, out = run_runner(
        trunner, bench, tmp, "fallback_eps", ds_type="fashionmnist", ds_path="synthetic",
        epses_specs=FALLBACK_SPECS, batch_size=FALLBACK_BATCH, optimizer_name="sgd", lr=1e-3,
        init_epses_composition_unit_theoretical_output_std=True, max_num_iters=FALLBACK_ITERS,
        synthetic_sizes=FALLBACK_SIZES, eval_schedule=((None, FALLBACK_ITERS),),
        keep_last_models=1)
    model = state.extras["model"]
    check(state.num_iters_done == FALLBACK_ITERS, f"(5,4) run stopped at {state.num_iters_done}")
    check(isinstance(model, EPSesPlusLinearReference) and model.backend == "pallas",
          f"(5,4) trained {type(model).__name__}, not the reference layout on the pallas backend")
    check(not any(counts.values()), f"(5,4) run launched EPS kernels {counts}")
    with open(os.path.join(out, "run_info.txt")) as f:
        info = f.read()
    check("fast (cmt) parameter layout unavailable" in info and "outside the kernels' plans" in info,
          "(5,4) run: the fallbacks are not in run_info.txt")
    x = torch.rand((1, FALLBACK_BATCH, 28, 28, 2), generator=torch.Generator().manual_seed(SEED)).to(dev)
    with torch.no_grad():
        got = model(x)
        ref = eps_plus_linear_forward(model.reference_params(), x, model.cfg)  # the xla backend
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    check(bool(torch.isfinite(got).all()) and err <= REL_TOL * scale,
          f"(5,4) logits differ from the plain path by {err} (max|ref| {scale})")
    print(f"phase 12 (5,4): {FALLBACK_ITERS} steps on the reference layout, launches {counts}, "
          f"logits vs plain max|d|={err:.3e} tol={REL_TOL * scale:.3e}, "
          f"{time.perf_counter() - t0:.1f} s")
    runs = [counts]

    t0 = time.perf_counter()
    bench.zero_counters()
    sbs_dir = os.path.join(tmp, "fallback_sbs")
    params, best_acc = legacy_runner.run(
        ds_path="synthetic", models_dir=sbs_dir, num_sbs_layers=SBS_LAYERS,
        bond_dim_size=FALLBACK_SBS_BOND, batch_size=100, epochs=1,
        synthetic_sizes=FALLBACK_SBS_SIZES, optimizer_type="sgd", learning_rate=1e-3,
        warmup_num_epochs=0, cos_sin_squared=True, make_input_window_std_one=True,
        scale_layers_using_batch=100, seed=SEED, device="cuda", tb_log_every_n_epochs=0)
    sbs_counts = bench.read_sbs_counters()
    check(not any(sbs_counts.values()), f"bond-12 run launched ConvSBS kernels {sbs_counts}")
    with open(os.path.join(sbs_dir, "run_info.txt")) as f:
        info = f.read()
    check("bonds up to 12" in info and "every string of the model" in info,
          "bond-12 run: the fallback is not in run_info.txt")
    images, _ = data_io.synthetic_mnist_like(100, seed=1234)
    xs = torch.as_tensor(images)
    cfg12 = dataclasses.replace(sbs_model_cfg(CSM, xs, False), bond_dim_size=FALLBACK_SBS_BOND)
    with torch.no_grad():
        got = CSM.ConvSBSModel(params, cfg12, device=dev)(xs.to(dev)).cpu()
        ref = CSM.ConvSBSModel(params, cfg12, device="cpu")(xs)
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    check(bool(torch.isfinite(got).all()) and err <= REL_TOL * scale,
          f"bond-12 logits on the card differ from the CPU plain fold's by {err} (max|ref| {scale})")
    print(f"phase 12 bond {FALLBACK_SBS_BOND}: best val acc {best_acc:.4f}, ConvSBS launches "
          f"{sbs_counts}, logits vs CPU plain fold max|d|={err:.3e} tol={REL_TOL * scale:.3e}, "
          f"{time.perf_counter() - t0:.1f} s")
    return runs + [sbs_counts]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile serving and training; write the tables to DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
    from dctn_tpu_torch import bench
    from dctn_tpu_torch.cli import predict
    from dctn_tpu_torch.interop import params_from_numpy, params_to_numpy
    from dctn_tpu_torch.kernels import build
    from dctn_tpu_torch.kernels import eps_kernels as K
    from dctn_tpu_torch.kernels import eps_q8_kernels as Q8
    from dctn_tpu_torch.models import (
        EPSesPlusLinearConfig,
        eps_plus_linear_forward,
        fast_layer_plans,
        init_eps_plus_linear,
    )
    from dctn_tpu_torch.train import resolve_auto_grad_accum, save_params_npz
    from dctn_tpu_torch.cli import legacy_runner
    from dctn_tpu_torch.data import io as data_io
    from dctn_tpu_torch.kernels import sbs_kernels as S
    from dctn_tpu_torch.models import conv_sbs_model as CSM
    from dctn_tpu_torch.kernels import logmatmulexp_kernels as L
    from dctn_tpu_torch.models import log_space_classifier as LSC
    from dctn_tpu_torch.ops.logmatmulexp import max_shifts

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(dev)}")

    start = lap = time.perf_counter()

    def phase_done(name: str) -> None:
        """Prints the seconds since the last phase ended."""
        nonlocal lap
        now = time.perf_counter()
        print(f"{name} phase: {now - lap:.1f} s")
        lap = now

    # phase 1: build every kernel of the paths from the checkout's sources
    build_all(build)

    phase_done("build")

    # phase 2: each kernel against its plain version
    cfg = EPSesPlusLinearConfig(epses_specs=FLAGSHIP, image_size=28, q0=2)
    numbers = kernel_vs_plain(K, Q8, dev)
    kernels_at_deep_batch(K, dev, numbers)
    numbers.update(sbs_kernels_vs_plain(S, CSM, dev))
    numbers.update(lme_kernel_vs_plain(L, LSC, max_shifts, dev))

    phase_done("kernels (2, 2b, 2c)")

    # phase 3: the serving paths, f32 then int8, through the entry point a
    # user calls
    params = init_eps_plus_linear(torch.Generator().manual_seed(SEED), cfg)
    sizes = (1024, 256, 1024)
    served = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "flagship.npz")
        save_params_npz(params, ckpt)
        for quantize in ("none", "int8"):
            bench.zero_counters()
            t0 = time.perf_counter()
            run = predict.run(
                checkpoint=ckpt, ds_type="fashionmnist", ds_path="synthetic",
                epses_specs=FLAGSHIP, batch_size=BATCH, latency_bench=True,
                device="cuda", synthetic_sizes=sizes, quantize=quantize,
            )
            served[quantize] = (run, bench.read_counters())
            print(
                f"predict.run --quantize {quantize}: {run.forward_calls} forwards, launches "
                f"{served[quantize][1]}, accuracy {run.accuracy:.4f} (random weights), "
                f"{time.perf_counter() - t0:.1f} s"
            )
    result, serving = served["none"]
    check(result.forward_calls > 0, "predict.run ran no forward")
    check(serving["eps_fwd"] == 2 * result.forward_calls,
          "eps_fwd did not run once per EPS layer and forward")
    check(all(v == 0 for k, v in serving.items() if k != "eps_fwd"),
          "eps_fwd wrote t, or another kernel ran, while serving")
    check(len(result.preds) == sizes[2], "one prediction per test image")

    # the output: finite, the right shape, and equal to the plain forward,
    # on the model and the images that predict.run served
    model = result.model
    check(result.x.device.type == "cuda" and result.x.shape[1] == sizes[2], "served split")
    with torch.inference_mode():
        x = result.x[:, :BATCH]
        logits = model(x)
        ref = model(x, kernels=K.PLAIN)
        check(tuple(logits.shape) == (BATCH, 10), f"logits shape {tuple(logits.shape)}")
        check(torch.isfinite(logits).all().item(), "non-finite logits")
        err = float((logits - ref).abs().max())
        scale = float(ref.abs().max())
        print(f"logits vs plain forward (batch {BATCH}): max|d|={err:.3e} tol={REL_TOL * scale:.3e}")
        check(err <= REL_TOL * scale, "logits differ from the plain forward")
        check(
            bool((logits.argmax(1).cpu().numpy() == result.preds[:BATCH]).all()),
            "predict.run's predictions differ from the model's argmax",
        )
        # a small input against the float64 reference-layout forward on the CPU
        small = result.x[:, :4]
        params64 = params_from_numpy(params_to_numpy(params), "cpu", torch.float64)
        ref64 = eps_plus_linear_forward(params64, small.cpu().double(), cfg)
        got = model(small).double().cpu()
        err = float((got - ref64).abs().max())
        scale = float(ref64.abs().max())
        print(f"logits vs float64 CPU reference layout (batch 4): max|d|={err:.3e} tol={REL_TOL * scale:.3e}")
        check(err <= REL_TOL * scale, "logits differ from the float64 reference")
        if args.profile:
            profile_serving({"kernel": model, "plain": lambda xs: model(xs, kernels=K.PLAIN)},
                            result.x, predict.latency_stats, args.profile, "f32")

    # int8: only eps_fwd_q8, twice per forward; logits against the plain
    # int8 forward and, as far as the JAX package's, the f32 kernel logits
    result_q8, serving_q8 = served["int8"]
    check(result_q8.forward_calls > 0, "predict.run --quantize int8 ran no forward")
    check(serving_q8["eps_fwd_q8"] == 2 * result_q8.forward_calls,
          "eps_fwd_q8 did not run once per EPS layer and int8 forward")
    check(all(v == 0 for k, v in serving_q8.items() if k != "eps_fwd_q8"),
          "eps_fwd_q8 wrote t, or another kernel ran, while serving int8")
    check(torch.equal(result_q8.x, result.x), "the int8 run served other images")
    qmodel = result_q8.model
    with torch.inference_mode():
        q_logits = qmodel(x)
        q_ref = qmodel(x, fwd=Q8.eps_fwd_q8_reference)
        check(tuple(q_logits.shape) == (BATCH, 10), f"int8 logits shape {tuple(q_logits.shape)}")
        check(torch.isfinite(q_logits).all().item(), "non-finite int8 logits")
        err = float((q_logits - q_ref).abs().max())
        scale = float(q_ref.abs().max())
        print(f"int8 logits vs plain int8 forward (batch {BATCH}): max|d|={err:.3e} "
              f"tol={Q8_LOGIT_TOL * scale:.3e} (1e-3*max|ref|)")
        check(err <= Q8_LOGIT_TOL * scale, "int8 logits differ from the plain int8 forward")
        rel = float(torch.linalg.vector_norm(q_logits - logits) / torch.linalg.vector_norm(logits))
        agree = float((result_q8.preds == result.preds).mean())
        print(f"int8 logits vs f32 kernel logits on the served images (batch {BATCH}): rel L2 "
              f"{rel:.6f} (the JAX package's {Q8_SERVED_REF} ± {Q8_SERVED_TOL}); predictions "
              f"agree on {agree:.4f} of {sizes[2]} images")
        check(abs(rel - Q8_SERVED_REF) <= Q8_SERVED_TOL,
              "int8 logits are not as far from the f32 logits as the JAX package's")
        xu = torch.rand(x.shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                        device=dev) * 2.0
        f_u, q_u = model(xu), qmodel(xu)
        rel_u = float(torch.linalg.vector_norm(q_u - f_u) / torch.linalg.vector_norm(f_u))
        print(f"int8 logits vs f32 kernel logits on uniform [0, 2) features (batch {BATCH}): "
              f"rel L2 {rel_u:.6f} (budget {Q8_BUDGET})")
        check(torch.isfinite(q_u).all().item() and rel_u < Q8_BUDGET,
              "int8 logits outside the int8 budget of the f32 logits")
        check(
            bool((q_logits.argmax(1).cpu().numpy() == result_q8.preds[:BATCH]).all()),
            "predict.run --quantize int8's predictions differ from the model's argmax",
        )
        if args.profile:
            profile_serving(
                {"kernel": qmodel, "plain": lambda xs: qmodel(xs, fwd=Q8.eps_fwd_q8_reference)},
                result_q8.x, predict.latency_stats, args.profile, "int8",
            )
    phase_done("serving")

    # phase 3b: export, load, predict and serve artifacts of the same models
    with tempfile.TemporaryDirectory() as tmp:
        exported = export_serve_phase(bench, CSM, params, cfg, served, dev, tmp)
    del served, result, model, result_q8, qmodel

    phase_done("export and serve")

    # phase 4: the training paths, f32 then QAT, through the bench entry point
    from dctn_tpu_torch.data import load_dataset

    train = load_dataset("fashionmnist", "synthetic", autoscale_kernel_size=4,
                         synthetic_sizes=(BATCH, 4, 4)).train
    tx = torch.as_tensor(train.x, device=dev)
    ty = torch.as_tensor(train.y.astype("int64"), device=dev)
    steps_run = 3 + 1 + TRAIN_STEPS  # warm-up, the memory step, the timed steps
    trained = {}
    for qat, per_step in (
        (None, {"eps_fwd": 2, "eps_fwd_t": 1, "eps_dcore": 2, "eps_dcore_sum": 1, "eps_dviews_t": 1}),
        ("int8", {"eps_fwd_q8": 2, "eps_fwd_q8_t": 1, "eps_dcore": 2, "eps_dcore_sum": 1,
                  "eps_dviews_t": 1}),
    ):
        bench.zero_counters()
        t0 = time.perf_counter()
        rec_k, rec_p = bench.run(device="cuda", steps=TRAIN_STEPS, compare_plain=True, qat=qat)
        counts = trained[qat] = bench.read_counters()
        print(f"bench.run qat={qat}: {time.perf_counter() - t0:.1f} s, launches {counts}")
        want = {k: per_step.get(k, 0) for k in counts}
        check(rec_k["launches_per_step"] == {k: float(v) for k, v in want.items()},
              f"launches per step {rec_k['launches_per_step']} != {want}")
        check(counts == {k: v * steps_run for k, v in want.items()},
              f"launches over the run {counts}")
        for rec in (rec_k, rec_p):
            check(all(math.isfinite(rec[k]) for k in ("first_loss", "last_loss")), "non-finite loss")
            print_train_record(rec, f"qat={qat}")
        if qat is None:
            check_training(params, cfg, K, tx, ty, dev)
        else:
            check_step_gradients(params, cfg, (Q8.QAT_KERNELS, Q8.QAT_PLAIN), tx, ty, dev, qat)
        if args.profile:
            profile_training(params, cfg, tx, ty, dev, args.profile, qat)

    # the three-EPS model, f32 then QAT: its layers 1 and 2 (A = 64, 216)
    # take the recompute backward
    keys = tuple(bench.read_counters())
    train3 = load_dataset("fashionmnist", "synthetic", autoscale_kernel_size=THREE[0][0],
                          synthetic_sizes=(BATCH, 4, 4)).train
    tx3 = torch.as_tensor(train3.x, device=dev)
    ty3 = torch.as_tensor(train3.y.astype("int64"), device=dev)
    cfg3 = EPSesPlusLinearConfig(epses_specs=THREE, image_size=28, q0=2)
    params3 = init_eps_plus_linear(torch.Generator().manual_seed(SEED), cfg3)
    for qat in (None, "int8"):
        want = launches_per_step(THREE, BATCH, 1, qat, keys)
        check(want["eps_dviews_recompute"] == 2 and want["eps_dviews_t"] == 0
              and want["eps_fwd_t"] == 0 and want["eps_fwd_q8_t"] == 0,
              f"three-EPS arms {want}: not both later layers on the recompute arm")
        bench.zero_counters()
        t0 = time.perf_counter()
        rec_k, rec_p = bench.run(device="cuda", steps=TRAIN_STEPS, compare_plain=True, qat=qat,
                                 epses_specs=THREE)
        counts = trained[("three", qat)] = bench.read_counters()
        print(f"bench.run three-EPS qat={qat}: {time.perf_counter() - t0:.1f} s, launches {counts}")
        check(rec_k["launches_per_step"] == {k: float(v) for k, v in want.items()},
              f"three-EPS launches per step {rec_k['launches_per_step']} != {want}")
        check(counts == {k: v * steps_run for k, v in want.items()},
              f"three-EPS launches over the run {counts}")
        for rec in (rec_k, rec_p):
            check(all(math.isfinite(rec[k]) for k in ("first_loss", "last_loss")), "non-finite loss")
            print_train_record(rec, f"three-EPS qat={qat}")
        paths = (K.KERNELS, K.PLAIN) if qat is None else (Q8.QAT_KERNELS, Q8.QAT_PLAIN)
        check_step_gradients(params3, cfg3, paths, tx3, ty3, dev, qat, "three-EPS")
    del tx3, ty3

    # the deep model's step at batch 2048, on the kernels: accum 1 (layer 1
    # over the saved-t cap: recompute) and "auto" (4: every later layer
    # saves t); the plain path would materialize ~35 GB at this batch
    cfg_d = EPSesPlusLinearConfig(epses_specs=DEEP, image_size=28, q0=2)
    auto = resolve_auto_grad_accum(cfg_d, fast_layer_plans(cfg_d), DEEP_BATCH)
    print(f"deep model at batch {DEEP_BATCH}: grad_accum_steps auto -> {auto}")
    check(auto == 4, f"auto resolved to {auto}, not 4")
    arms = {1: {"eps_dviews_recompute": 1, "eps_dviews_t": 1, "eps_fwd_t": 1},
            4: {"eps_dviews_recompute": 0, "eps_dviews_t": 8, "eps_fwd_t": 8}}
    deep_steps_run = 1 + 1 + DEEP_STEPS
    for accum in (1, "auto"):
        bench.zero_counters()
        t0 = time.perf_counter()
        (rec,) = bench.run(device="cuda", steps=DEEP_STEPS, warmup=1, batch_size=DEEP_BATCH,
                           epses_specs=DEEP, lr=DEEP_LR, reg_type=DEEP_REG[0],
                           reg_coeff=DEEP_REG[1], grad_accum_steps=accum)
        got = rec["grad_accum_steps"]
        counts = trained[("deep", got)] = bench.read_counters()
        print(f"bench.run deep batch {DEEP_BATCH} grad_accum_steps={accum} ({got}): "
              f"{time.perf_counter() - t0:.1f} s, launches {counts}")
        want = launches_per_step(DEEP, DEEP_BATCH, got, None, keys)
        check(all(want[k] == v for k, v in arms[got].items()), f"deep arms {want} at accum {got}")
        check(rec["launches_per_step"] == {k: float(v) for k, v in want.items()},
              f"deep launches per step {rec['launches_per_step']} != {want}")
        check(counts == {k: v * deep_steps_run for k, v in want.items()},
              f"deep launches over the run {counts}")
        check(all(math.isfinite(rec[k]) for k in ("first_loss", "last_loss")), "non-finite loss")
        print_train_record(rec, f"deep batch {DEEP_BATCH} grad_accum_steps={got}")
    train_d = load_dataset("fashionmnist", "synthetic", autoscale_kernel_size=DEEP[0][0],
                           synthetic_sizes=(DEEP_BATCH, 4, 4)).train
    xd = torch.as_tensor(train_d.x, device=dev)
    yd = torch.as_tensor(train_d.y.astype("int64"), device=dev)
    for seed in DEEP_ACCUM_SEEDS:
        params_d = init_eps_plus_linear(torch.Generator().manual_seed(seed), cfg_d)
        grads, metrics = [], []
        for accum in (1, 4):
            model_d, step_d = make_trainer(params_d, cfg_d, K.KERNELS, dev, DEEP_LR, DEEP_REG, accum)
            metrics.append({k: float(v) for k, v in step_d(xd, yd).items()})
            grads.append([p.grad for p in model_d.parameters()])
            del model_d, step_d
        print(f"deep step metrics (weights seed {seed}) at accum 1 {metrics[0]} and 4 {metrics[1]}")
        check(all(math.isfinite(v) for m in metrics for v in m.values()),
              "deep step: non-finite metrics")
        gap = compare_gradients(grads, DEEP_ACCUM_TOL,
                                f"deep batch {DEEP_BATCH} seed {seed} accum 1 vs accum 4")
        print(f"deep batch {DEEP_BATCH} accum 1 vs accum 4, weights seed {seed}: largest "
              f"max|d|/max|ref| {gap:.3e} (limit {DEEP_ACCUM_TOL:g})")
        del grads
    if args.profile:
        for accum in (1, 4):
            profile_training(params_d, cfg_d, xd, yd, dev, args.profile, paths=(("kernel", K.KERNELS),),
                             batch=DEEP_BATCH, lr=DEEP_LR, reg=DEEP_REG, grad_accum_steps=accum,
                             tag=f"deep_accum{accum}", warmup=2, calls=2)
    del xd, yd

    phase_done("training bench")

    # phase 4b: the EPS runner (the README quick start, a resume, QAT,
    # dropout with a frozen core, colored CIFAR)
    from dctn_tpu_torch.cli import runner as eps_runner

    runner_runs = runner_phase(eps_runner, bench, K, dev)
    phase_done("runner")

    # phase 4c: the runners' tooling (TB logging, intermediate outputs, a
    # profiled window) and the xla backends
    runner_runs += runner_tooling_phase(eps_runner, bench, K, dev)
    phase_done("runner tooling")

    # phase 6: the legacy ConvSBS runner, then its step's gradients and a
    # trajectory against the float64 CPU step
    sbs_runs = sbs_runner_phase(legacy_runner, bench, dev)
    phase_done("legacy runner")
    images, labels = data_io.synthetic_mnist_like(100, seed=1234)
    check_sbs_training(S, CSM, torch.as_tensor(images, device=dev),
                       torch.as_tensor(labels, device=dev), dev)

    # phase 7: the ConvSBS bench entry, then the sequential fold's path
    sbs_bench_counts, _ = sbs_bench_phase(bench, dev)
    sbs_bench_counts += sbs_sequential_phase(S, CSM, bench, torch.as_tensor(images, device=dev),
                                             torch.as_tensor(labels, device=dev), dev)
    if args.profile:
        profile_conv_sbs(S, CSM, args.profile, dev)
    phase_done("legacy step checks and ConvSBS bench (6, 7)")

    # phase 5b: data parallelism at world size 1 through a real NCCL group,
    # a sharded artifact at N = 1, and with 2+ cards the multichip paths
    dp_counts = dp_phase(bench, CSM, params, cfg, tx, ty, dev)
    phase_done("data parallelism (5b)")

    # phase 5c: tensor and spatial parallelism and SP x TP: the kernels at
    # the shard shapes, the shards against the whole, the grid at world size
    # 1, the height-sharded artifact
    dp_counts += grid_phase(bench, K, Q8, params, cfg, tx, ty, dev, numbers)
    phase_done("tensor and spatial parallelism (5c)")

    # phases 8 and 9: the log-space product's entries, the chain bench and
    # the log-space classifier's training
    lme_launches = [lme_chain_phase(bench, dev), log_space_phase(bench, LSC, dev)]
    if args.profile:
        profile_lme(bench, LSC, args.profile, dev)
    phase_done("log-space (8, 9)")

    # phase 10: the autotuners on the card
    with tempfile.TemporaryDirectory() as tmp:
        tuned_counts, tuned = autotune_phase(bench, CSM, params, cfg, tx, ty, dev, tmp)
    print(json.dumps({"autotune": tuned}))
    phase_done("autotune (10)")

    # phase 11: the bf16 operand mode: its kernels against their plain
    # versions, the runner, the deep step at "auto", an artifact, and the
    # flagship's f32 and bf16 step and forward in turns; then K9 with a bf16
    # t and the flagship's bf16 QAT step
    with tempfile.TemporaryDirectory() as tmp:
        bf16_counts, bf16_numbers, bf16_record = bf16_phase(eps_runner, bench, K, params, cfg,
                                                            dev, tmp)
    numbers.update(bf16_numbers)
    qat_counts, numbers["eps_fwd_q8_t_bf16"], bf16_record["qat"] = qat_bf16_phase(
        bench, K, Q8, params, cfg, tx, ty, dev)
    bf16_counts += qat_counts
    print(json.dumps({"bf16": bf16_record}))
    if args.profile:
        profile_training(params, dataclasses.replace(cfg, compute_dtype=torch.bfloat16), tx, ty,
                         dev, args.profile, tag="train_bf16")
    phase_done("bf16 operands (11)")

    # phase 12: the fallbacks where JAX falls back (an EPS model outside the
    # kernels' plans, a ConvSBS model outside their scope)
    with tempfile.TemporaryDirectory() as tmp:
        fallback_counts = fallback_phase(eps_runner, legacy_runner, bench, K, CSM, dev, tmp)
    phase_done("fallbacks (12)")
    print(f"all phases: {time.perf_counter() - start:.1f} s")

    driven = [serving, serving_q8, exported, *trained.values(), *runner_runs, *sbs_runs, *sbs_bench_counts,
              *dp_counts, *lme_launches, tuned_counts, *bf16_counts, *fallback_counts]
    # K1's (wgmma route) and eps_dcore's bf16 modes launch their operands
    # kernel and their product once a chunk of pixels: counted apart, and
    # exact in each step's count
    missing = [name for name in (*BF16_KERNELS, "eps_fwd_chunks_bf16", "eps_dcore_chunks_bf16")
               if sum(c.get(name, 0) for c in bf16_counts) == 0]
    check(not missing, f"phase 11 launched no {missing}")
    launches = {name: sum(c.get(name, 0) for c in driven) for name in KERNELS}
    print(json.dumps({"kernels": [
        {"name": name, **meta, "launches": launches[name], **numbers[name]}
        for name, meta in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
