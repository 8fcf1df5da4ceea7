#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dctn_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and builds every kernel of the serving, int8 serving, training,
   QAT and legacy ConvSBS paths from ``dctn_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once), printing each build time, the compiler's
   register report and the count of tensor-core instructions (HMMA, HGMMA,
   IMMA; ``cuobjdump -sass``) in each library; it fails if the 3xTF32
   sources (``eps_fwd``, ``eps_dcore``, ``eps_dviews_t``, ``logmatmulexp``)
   have no HMMA or HGMMA.
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
   Then the ConvSBS kernels (phase 2b, before phase 3): the forward and
   the backward (d_views both ways) of the meet-in-the-middle fold (K10,
   K11) and of the sequential fold (K12) against their plain versions at
   both layer shapes of the legacy 2-layer bond-4 model, open strings and
   rings, batch 100 and 512, and every merge position at one shape, with
   kernel, plain and bound times (no single library call folds a tensor
   train: the library column is null); at batch 512 the backward gives the
   same bits on a second run.
6. Drives the legacy ConvSBS family: ``dctn_tpu_torch.cli.legacy_runner.run``
   on synthetic data (2 layers, bond 4, batch 100, 2 epochs; SGD and RMSprop
   with momentum; open strings and ``--trace-edge`` rings), checking its
   launches (per step three forwards, three backwards of which layer 1's
   writes d_views, three d_core sums) and its best checkpoint; one step's
   gradients (cores and pixels) on the kernels against the plain path at
   batch 100, and 3 SGD steps at batch 4 against the float64 CPU step.
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
10. With ``--profile DIR`` only: the device-time breakdown (``torch.profiler``)
   of the serving forward (f32 and int8) at batch 1 and 128 and of the
   flagship training step (f32 and QAT) at batch 128, on the kernel and on
   the plain path, and of the deep model's step at batch 2048 (accumulation
   1 and 4) on the kernels, and of the ConvSBS step at batch 100 (open, ring)
   and 512 (open) on the kernel and the plain path, with the device's busy
   share and extra memory; and of the log-matmul chain's forward+backward
   (kernel form, ops form, matmul) and one log-space classifier step
   (fused_kernel, fused_plain, scan), with the device's busy share; the
   full profiler tables go to DIR.
11. Prints one JSON line describing the kernels, then the result line.

Every count of kernel launches is set to 0 just before a path is driven and
read just after it.

Any failure exits nonzero before the result line; without a CUDA device it
exits nonzero at once. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
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
# csrc/tf32x3.cuh): a third of the 495 TFLOP/s dense TF32 peak. Their
# elementwise float32 work stays at the CUDA cores' 67.
F32_PEAK_FLOPS = 67e12
TF32X3_PEAK_FLOPS = 495e12 / 3
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
    -sass`` of the toolkit that built it): counts of HMMA (mma.sync on
    f16/bf16/tf32), HGMMA (wgmma) and IMMA (int8 mma.sync)."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    ops = re.findall(r"\b(HMMA|HGMMA|IMMA)\b", sass)
    return {op: ops.count(op) for op in ("HMMA", "HGMMA", "IMMA")}


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
            counts = tensor_core_instructions(build.library_path(name))
            print(f"{name}: tensor-core instructions in its SASS {counts}")
            if name in TF32X3_SOURCES:
                check(counts["HMMA"] + counts["HGMMA"] > 0,
                      f"{name}: no HMMA or HGMMA instruction in its SASS")


def layer_dims(specs):
    """(n_k, q_k, n1_k, O, h') of each layer of a model at 28×28."""
    from dctn_tpu_torch.kernels import eps_kernels as K
    from dctn_tpu_torch.models import EPSesPlusLinearConfig, fast_layer_plans

    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=28, q0=2)
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


def bound_ms(nbytes: float, flops: float = 0.0, int8_ops: float = 0.0, mm_flops: float = 0.0):
    """The least time of the work on the card: (ms, what bounds it), the
    operations of each type at that type's peak: ``flops`` elementwise
    float32 on the CUDA cores, ``mm_flops`` float32 matrix products at the
    3xTF32 rate and ``int8_ops`` at the int8 rate, both on the tensor cores.
    The CUDA cores and the tensor cores can overlap, so the slower of the
    two bounds the operations."""
    t_ops = max(flops / F32_PEAK_FLOPS,
                mm_flops / TF32X3_PEAK_FLOPS + int8_ops / INT8_PEAK_OPS)
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
               "bound_ms": 0.0, "flops": 0.0, "int8_ops": 0.0, "mm_flops": 0.0, "bytes": 0.0}
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


def device_ms_per_call(fn, calls: int, out_path: str) -> tuple:
    """torch.profiler over ``calls`` calls of ``fn``: (device ms per call,
    the top device kernels as (name, ms per call)). Writes the whole table
    to ``out_path``. Only the kernels' own rows are summed: a host op's row,
    and a user annotation's such as ``Optimizer.step#Adam.step``, repeat
    the device time of the kernels they launched. Raises if no window shows
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    check(bool(per_kernel), f"torch.profiler showed no device time in {PROFILE_TRIES} windows")
    with open(out_path, "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    return sum(ms for _, ms in per_kernel), per_kernel[:8]


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


def make_trainer(params, cfg, kernels, dev, lr, reg=None, grad_accum_steps=1):
    """A model on ``dev`` from ``params`` and an Adam step at learning rate
    ``lr`` through ``kernels`` (a QAT bundle for the QAT step): the bench's
    (epswise L2 1e-6) unless ``reg`` gives (reg_type, reg_coeff)."""
    from dctn_tpu_torch import bench
    from dctn_tpu_torch.models import EPSesPlusLinear
    from dctn_tpu_torch.train import make_fast_train_step, make_optimizer

    model = EPSesPlusLinear.from_reference(params, cfg, device=dev)
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


def launches_per_step(specs, batch, accum, qat, keys):
    """The kernel launches of one training step, from each layer's backward
    arm (``plan_backward``) at the microbatch: its forward (writing t on the
    saved-t arm), ``eps_dcore`` (and its slice sum where its tiles are few),
    and the arm's d_views kernel (none for layer 0); ``accum``
    microbatches."""
    from dctn_tpu_torch.kernels import eps_kernels as K

    fwd = "eps_fwd" if qat is None else "eps_fwd_q8"
    counts = dict.fromkeys(keys, 0)
    for i, (n, q, n1, o, h) in enumerate(layer_dims(specs)):
        npix = batch // accum * h * h
        arm = K.plan_backward(i, n, n1, q, o, npix)
        counts[fwd] += 1
        counts[f"{fwd}_t"] += arm == "saved_t"
        counts["eps_dcore"] += 1
        counts["eps_dcore_sum"] += K._dcore_slices(o * q ** (n - n1), q**n1, npix,
                                                   K._sm_count(torch.device("cuda", 0))) > 1
        counts["eps_dviews_t"] += arm == "saved_t"
        counts["eps_dviews_recompute"] += arm == "recompute"
    return {k: v * accum for k, v in counts.items()}


def print_train_record(rec, tag: str) -> None:
    share = rec["f32_peak_share"]
    print(f"train step {tag} [{rec['path']}]: p50 {rec['step_ms_p50']:.4f} ms, "
          f"{rec['images_per_s']:.1f} img/s"
          f"{'' if share is None else f', {share:.4f} of the f32 peak'}, "
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
# the legacy ConvSBS family (phases 2b, 6 and 7)


def sbs_case(S, CSM, dev, layer, trace_edge, batch, seed=SEED):
    """One string of the legacy 2-layer bond-4 model at ``batch`` (layer 0:
    q^C = 2, o = 2 on the middle core, 26×26 windows; layer 1: q^C = 4,
    o = 10, 24×24): factors uniform in [0, 1), cores scaled so every m
    element is of order 1/bond, a normal output cotangent."""
    spec = CSM.ConvSBSModelConfig(SBS_LAYERS, SBS_BOND, trace_edge=trace_edge).layer_specs()[layer][0]
    olr, qc, ok = S.sbs_supported(spec)
    check(ok, f"legacy layer {layer} outside the kernels' support")
    side = 28 - 2 * (layer + 1)
    npix = batch * side * side
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


def sbs_work(olr, qc, npix, mcut, backward, need_dviews):
    """(bytes, flops) of one call: each input read once and each output
    written once; the forward's FMAs (m, fold, merge), and for the backward
    the forward's again (the states it reverses), twice the fold and merge
    (the two transposes of each step) and the d_core (and d_view) FMAs."""
    rows = sum(o * l * r for o, l, r in olr)
    m_fmas = rows * qc
    fold = sbs_fold_fmas(olr, mcut)
    o_total = math.prod(o for o, _, _ in olr)
    views, cores = len(olr) * qc * npix, rows * qc
    if not backward:
        return 4.0 * (views + cores + o_total * npix), 2.0 * npix * (m_fmas + fold)
    nbytes = 4.0 * (views + 2 * cores + o_total * npix + (views if need_dviews else 0))
    return nbytes, 2.0 * npix * (m_fmas * (2 + need_dviews) + 3 * fold)


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
    phase 7's sequential path)."""
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None,
               "bytes": 0.0, "flops": 0.0} for k in SBS_KERNELS}
    worst = {}

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

                    errs = held(name, label, kern(), plain())
                    t_k, t_p = median_ms([kern, plain], reps=10)
                    nbytes, flops = sbs_work(olr, qc, npix, mcut, False, False)
                    print(f"{name} vs plain [{label}]: max|d|/max|ref| {errs} "
                          f"(tol {SBS_TOL:g}*max|ref|); kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                          f"bound {bound_ms(nbytes, flops)[0]:.4f} ms")
                    if on_path:
                        for _ in range(2 if layer == 0 else 1):
                            r = res[name]
                            r["ms"] += t_k
                            r["plain_ms"] += t_p
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
    print(f"ConvSBS kernels vs plain, largest max|d|/max|ref| per kernel: {worst} "
          f"(tolerance {SBS_TOL:g})")
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
    gradient), by name, from torch.profiler (a window without any device
    event is taken again, at most PROFILE_TRIES times), and the forwards
    run."""
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
        if names:
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
           "bytes": 0.0, "flops": 0.0}
    res_s = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": None, "bytes": 0.0}
    on_path = {"chain link": 5, "classifier step": 1}
    worst = {}
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
        t_k, t_p, t_l = (device_ms_per_call(fn, LME_PROFILE_CALLS, os.devnull)[0] for fn in fns)
        s_k, s_p = (device_ms_per_call(fn, LME_PROFILE_CALLS, os.devnull)[0]
                    for fn in (lambda: L.logmatmulexp_shifts(la, lb), lambda: max_shifts(la, lb)))
        nbytes, flops = 4.0 * (theta * r + r * i + theta * i), 2.0 * theta * r * i
        s_bytes = 4.0 * (theta * r + r * i + theta + i)
        b_ms, by = bound_ms(nbytes, mm_flops=flops)
        print(f"{tag}: max|d| {err:.3e}, {share:.4f} of the limit ({LME_WALK}*2^-24*sqrt(R) + "
              f"{LME_ULPS}*2^-24*max(|ref|, |amax|+|bmax|) per entry), {n_inf} "
              f"outputs exactly -inf as plain, no NaN, same bits twice; shifts kernel equal to "
              f"max_shifts; a forward: device kernels {names}; device time per call: "
              f"kernel {t_k:.4f} ms ({flops / t_k / 1e9:.2f} TFLOP/s), plain {t_p:.4f} ms, "
              f"library torch.matmul of the exponentials {t_l:.4f} ms, shifts kernel {s_k:.4f} "
              f"ms, max_shifts {s_p:.4f} ms; one call between CUDA "
              f"events (the host's launch included): kernel {call_ms[0]:.4f} ms, plain "
              f"{call_ms[1]:.4f} ms, library {call_ms[2]:.4f} ms; bound {b_ms:.4f} ms ({by}), "
              f"splits of R {L._splits(theta, r, i)}")
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


def sbs_runner_phase(legacy_runner, bench, dev):
    """Phase 6: ``legacy_runner.run`` on the card, 2 layers, bond 4, batch
    100, SBS_RUN_EPOCHS epochs of synthetic data, SGD and RMSprop with
    momentum, open and ``--trace-edge``. Checks the launches (per step: the
    three strings' forward and backward, layer 0's two without d_views,
    layer 1's with them, and a d_core sum each; besides, a forward of each
    string per evaluation and two per string while scaling the layers)
    and the best checkpoint. Returns each run's counts."""
    n_tr, n_val = SBS_RUN_SIZES
    steps = SBS_RUN_EPOCHS * (n_tr // 100)
    runs = []
    for trace_edge in (False, True):
        for opt in ("sgd", "rmsprop"):
            bench.zero_counters()
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                _, best = legacy_runner.run(
                    ds_path="synthetic", models_dir=tmp, num_sbs_layers=SBS_LAYERS,
                    bond_dim_size=SBS_BOND, trace_edge=trace_edge, batch_size=100,
                    epochs=SBS_RUN_EPOCHS, synthetic_sizes=SBS_RUN_SIZES, optimizer_type=opt,
                    momentum=0.9, learning_rate=1e-3, warmup_num_epochs=1,
                    warmup_initial_multiplier=1e-2, cos_sin_squared=True,
                    make_input_window_std_one=True, scale_layers_using_batch=100, seed=SEED,
                    device="cuda",
                )
                ckpts = [f for f in os.listdir(tmp) if f.startswith("dctn_epoch=")]
            counts = bench.read_sbs_counters()
            label = f"legacy_runner {'--trace-edge ' if trace_edge else ''}{opt}"
            print(f"{label}: {time.perf_counter() - t0:.1f} s, best val acc {best:.4f} "
                  f"(synthetic, {SBS_RUN_EPOCHS} epochs), checkpoint {ckpts}, launches {counts}")
            check(len(ckpts) == 1 and ckpts[0].endswith(".npz"), f"{label}: no best checkpoint")
            evals, scaling = SBS_RUN_EPOCHS, 2
            want = dict.fromkeys(counts, 0)
            want.update(sbs_fwd_mim=3 * (steps + evals + scaling), sbs_bwd_mim=3 * steps,
                        sbs_bwd_dviews=steps, sbs_bwd_sum=3 * steps)
            check(counts == want, f"{label}: launches {counts} != {want}")
            print(f"{label}: per step sbs_fwd_mim 3, sbs_bwd_mim 3 (d_views 1), sum 3, over "
                  f"{steps} steps")
            runs.append(counts)
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
    and the plain path, at batch 100 open and ring and batch 512 open: the
    bench's step (SGD 1e-3) after 3 warm-up steps, over 5."""
    os.makedirs(out_dir, exist_ok=True)
    for batch, trace_edge in ((100, False), (100, True), (512, False)):
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

    # phase 1: build every kernel of the paths from the checkout's sources
    build_all(build)

    # phase 2: each kernel against its plain version
    cfg = EPSesPlusLinearConfig(epses_specs=FLAGSHIP, image_size=28, q0=2)
    numbers = kernel_vs_plain(K, Q8, dev)
    kernels_at_deep_batch(K, dev, numbers)
    numbers.update(sbs_kernels_vs_plain(S, CSM, dev))
    numbers.update(lme_kernel_vs_plain(L, LSC, max_shifts, dev))

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
    del served, result, model, result_q8, qmodel

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

    # phase 6: the legacy ConvSBS runner, then its step's gradients and a
    # trajectory against the float64 CPU step
    sbs_runs = sbs_runner_phase(legacy_runner, bench, dev)
    images, labels = data_io.synthetic_mnist_like(100, seed=1234)
    check_sbs_training(S, CSM, torch.as_tensor(images, device=dev),
                       torch.as_tensor(labels, device=dev), dev)

    # phase 7: the ConvSBS bench entry, then the sequential fold's path
    sbs_bench_counts, _ = sbs_bench_phase(bench, dev)
    sbs_bench_counts += sbs_sequential_phase(S, CSM, bench, torch.as_tensor(images, device=dev),
                                             torch.as_tensor(labels, device=dev), dev)
    if args.profile:
        profile_conv_sbs(S, CSM, args.profile, dev)

    # phases 8 and 9: the log-space product's entries, the chain bench and
    # the log-space classifier's training
    lme_launches = [lme_chain_phase(bench, dev), log_space_phase(bench, LSC, dev)]
    if args.profile:
        profile_lme(bench, LSC, args.profile, dev)

    driven = [serving, serving_q8, *trained.values(), *sbs_runs, *sbs_bench_counts,
              *lme_launches]
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
