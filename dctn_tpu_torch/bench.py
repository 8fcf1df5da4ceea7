"""Training-throughput benchmark of the port: images/s of the flagship
two-EPS ``(4,4),(3,6)`` + linear FashionMNIST training step on one CUDA card
(the port's counterpart of the root ``bench.py``'s pallas branch,
``bench.py:65-113``).

The step is by default the one the JAX bench times: the fast (cmt) layout
at the default split, Adam 3e-3, epswise L2 1e-6, batch 128, no dropout, no
gradient accumulation. ``--lr``, ``--reg-type``, ``--reg-coeff`` and
``--grad-accum-steps n|auto`` change it: the deep three-EPS step of
``experiments/three_epses_benchmark.py`` is ``--epses-specs
"(4,4),(3,12),(2,24)" --lr 1e-3 --reg-type epses_composition --reg-coeff
0.1``, and at ``--batch-size 2048`` its middle layer's t is over the saved-t
cap unless ``--grad-accum-steps auto`` (4 there: ``resolve_auto_grad_accum``)
splits the batch. The synthetic FashionMNIST train split (the port's
``load_dataset``, ν-scaled for K = 4) stays on the device; ``Batcher``
draws the shuffled index batches up front and ``make_gather_batch`` gathers
each batch on the device, so the host stays out of the timed loop. Steps
after the warm-up are timed with CUDA events.

``--qat int8`` times the quantization-aware step instead (the JAX runner's
``--qat int8``): each EPS layer's forward in int8 W8A8 (``eps_fwd_q8``),
the straight-through f32 backward.

``--compute-dtype bfloat16`` (JAX ``bench.py:79``, ``BENCH_COMPUTE_DTYPE``)
times the step with every EPS product on bf16 operands and float32 sums:
the kernels' bf16 mode (``--compare-plain``: their plain versions in the
same mode, in the same run). With ``--qat int8`` it times the bf16 QAT
step: the int8 forward on the float32 cores, K9's saved t in bf16, the
backward in the bf16 mode.

Prints one JSON line per path: the compute dtype, images/s, step ms p50,
the serving forward's ms p50 at the same batch (the model's forward under
``inference_mode``; not with ``--qat``), the first and last loss,
kernel launches per step, the step's GFLOP (computed from the layer shapes)
and their share of the H100's 67 TFLOP/s float32 peak (the f32 step) or of
its 989 TFLOP/s dense bf16 peak (the bf16 step), and the extra device
memory of one step. ``--compare-plain`` adds the
same line for the plain path (the kernels' plain PyTorch versions through
the same ``autograd.Function``), measured in the same process.

``--model-family conv_sbs`` times the legacy ConvSBS step of
``experiments/conv_sbs_benchmark.py`` instead: 2 layers, bond 4, Khrulkov
init, ``torch.optim.SGD`` 1e-3, cross-entropy on one fixed uniform 28×28
batch (default 100), open strings or ``--trace-edge`` rings, every string
folded meet-in-the-middle (K10/K11) at ``_mim_cut``'s merge position. Its
record has images/s, step ms p50, the losses, the ConvSBS kernels' launches
per step and the extra device memory.

``--model-family logmatmulexp`` is the chain benchmark of
``experiments/logmatmulexp_benchmark.py``: a chain of 6 random 256×256 f32
log-matrices reduced left to right by plain ``torch.matmul`` and by three
log-space forms (``ops.logmatmulexp``, its checkpointed
``logmatmulexp_lowmem``, and K13 through ``logmatmulexp_kernel``), the
forward and the gradients of all six (``utils.benchmark.benchmark_torch``);
one JSON line per form, then the log-space/matmul forward ratios.

``--model-family log_space`` trains the log-space classifier of
``experiments/log_space_classifier.py`` (Adam 3e-2, batch 256, 600 steps,
4096/1024 synthetic images) in three forms: ``scan`` (49 per-pixel
products), ``fused_plain`` (one block-diagonal product, the plain max-shift
form) and ``fused_kernel`` (the same through K13). One JSON line per form
with its validation accuracy and step ms; the forms must agree within 0.02
in accuracy, with finite weights.

Usage:
  python -m dctn_tpu_torch.bench [--steps 30] [--batch-size 128] [--compare-plain] [--qat int8]
      [--epses-specs "(4,4),(3,6)"] [--lr 3e-3] [--reg-type epswise] [--reg-coeff 1e-6]
      [--grad-accum-steps 1|n|auto] [--compute-dtype float32|bfloat16]
  python -m dctn_tpu_torch.bench --model-family conv_sbs [--batch-size 100] [--trace-edge]
      [--compare-plain]
  python -m dctn_tpu_torch.bench --model-family logmatmulexp [--steps 20]
  python -m dctn_tpu_torch.bench --model-family log_space [--steps 600] [--batch-size 256]
"""

from __future__ import annotations

import json
import statistics
import time
from functools import reduce

import click
import numpy as np
import torch

from .cli.specs import parse_epses_specs
from .data import Batcher, load_dataset
from .data.io import synthetic_mnist_like
from .kernels import eps_kernels as K
from .kernels import eps_q8_kernels as Q8
from .kernels import logmatmulexp_kernels as L
from .kernels import sbs_kernels as S
from .models import log_space_classifier as LSC
from .models import (
    ConvSBSModel,
    ConvSBSModelConfig,
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    fast_layer_plans,
    init_conv_sbs_model,
    init_eps_plus_linear,
)
from .ops.logmatmulexp import logmatmulexp, logmatmulexp_lowmem
from .train import make_fast_train_step, make_gather_batch, make_optimizer, resolve_auto_grad_accum
from .train.step import REG_TYPES
from .utils.benchmark import benchmark_torch

FLAGSHIP = ((4, 4), (3, 6))
# the step bench.py times (bench.py:85-113): Adam 3e-3, epswise L2 1e-6
LR = 3e-3
REG_COEFF = 1e-6
SEED = 0
# the H100 SXM's float32 peak outside the tensor cores (NVIDIA's data sheet,
# at the 700 W power limit)
H100_F32_PEAK_FLOPS = 67e12
# and its dense bf16 tensor-core peak
H100_BF16_PEAK_FLOPS = 989e12
COUNTERS = (
    ("eps_fwd", K.eps_fwd, "launches"),
    ("eps_fwd_t", K.eps_fwd, "t_launches"),
    ("eps_dcore", K.eps_dcore, "launches"),
    ("eps_dcore_sum", K.eps_dcore, "sum_launches"),
    ("eps_dviews_t", K.eps_dviews_t, "launches"),
    ("eps_dviews_recompute", K.eps_dviews_recompute, "launches"),
    ("eps_fwd_q8", Q8.eps_fwd_q8, "launches"),
    ("eps_fwd_q8_t", Q8.eps_fwd_q8, "t_launches"),
    ("eps_fwd_bf16", K.eps_fwd, "bf16_launches"),
    ("eps_fwd_t_bf16", K.eps_fwd, "bf16_t_launches"),
    ("eps_fwd_chunks_bf16", K.eps_fwd, "bf16_chunk_launches"),
    ("eps_dcore_bf16", K.eps_dcore, "bf16_launches"),
    ("eps_dcore_chunks_bf16", K.eps_dcore, "bf16_chunk_launches"),
    ("eps_dcore_sum_bf16", K.eps_dcore, "bf16_sum_launches"),
    ("eps_dviews_t_bf16", K.eps_dviews_t, "bf16_launches"),
    ("eps_dviews_recompute_bf16", K.eps_dviews_recompute, "bf16_launches"),
    ("eps_fwd_q8_t_bf16", Q8.eps_fwd_q8, "bf16_t_launches"),
)
# the ConvSBS kernels' counters, read apart: the EPS records keep their keys
SBS_COUNTERS = (
    ("sbs_fwd_mim", S.sbs_fwd, "mim_launches"),
    ("sbs_fwd_seq", S.sbs_fwd, "seq_launches"),
    ("sbs_bwd_mim", S.sbs_bwd, "mim_launches"),
    ("sbs_bwd_seq", S.sbs_bwd, "seq_launches"),
    ("sbs_bwd_dviews", S.sbs_bwd, "dviews_launches"),
    ("sbs_bwd_sum", S.sbs_bwd, "sum_launches"),
)
# the kernel and the plain path of each step, by qat mode
PATHS = {
    None: (("kernel", K.KERNELS), ("plain", K.PLAIN)),
    "int8": (("kernel", Q8.QAT_KERNELS), ("plain", Q8.QAT_PLAIN)),
}


def read_counters() -> dict:
    """The EPS kernel wrappers' launch counts, by name."""
    return {name: getattr(fn, attr) for name, fn, attr in COUNTERS}


def read_sbs_counters() -> dict:
    """The ConvSBS kernel wrappers' launch counts, by name."""
    return {name: getattr(fn, attr) for name, fn, attr in SBS_COUNTERS}


def zero_counters() -> None:
    """Every kernel wrapper's counts, EPS, ConvSBS and K13, to 0."""
    for _, fn, attr in COUNTERS + SBS_COUNTERS:
        setattr(fn, attr, 0)
    L.logmatmulexp_fwd.launches = 0
    L.logmatmulexp_shifts.launches = 0


def read_lme_launches() -> int:
    """K13's launch count (the product)."""
    return L.logmatmulexp_fwd.launches


def read_lme_shift_launches() -> int:
    """The launch count of K13's shifts kernel (one per forward on the card)."""
    return L.logmatmulexp_shifts.launches


def step_gflop(cfg: EPSesPlusLinearConfig, batch_size: int, in_channels: int = 1) -> float:
    """GFLOP of the EPS contractions of one training step, from the shapes:
    per layer 2·Z·A·npix for the forward, the same for d_cmt, and the same
    again for d_views in every layer but the first (whose input needs no
    gradient). The count is algorithmic, as the JAX package's ``algo_flops``
    (experiments/three_epses_benchmark.py): the t that a layer on the
    recompute arm computes again in its backward (another 2·Z·A·npix) is
    not counted, so the count does not depend on the batch's arms or on
    gradient accumulation. The factor products, the classifier, the
    regularizer and the optimizer are left out. The count is the same with
    ``qat="int8"``, whose forward GEMMs are int8 operations."""
    total, h = 0.0, cfg.image_size
    for i, p in enumerate(fast_layer_plans(cfg, in_channels)):
        n_k, q_k, n1_k = K._kernel_dims(p["c"], p["q"], p["kernel_size"], p["n1"], p["merge_pairs"])
        h = h - p["kernel_size"] + 1
        gemm = 2 * p["out_size"] * q_k**n_k * batch_size * h * h
        total += gemm * (2 if i == 0 else 3)
    return total / 1e9


def _device(device: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise click.UsageError(f"--device {device}: no CUDA device is available")
    return device


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _timed_steps(step_loss, rows, cuda: bool):
    """Runs ``step_loss(row)`` (one step, returning its loss) for each of
    ``rows``; returns (per-step ms, window s, losses). On CUDA each step is
    bracketed by events and the window is fenced once at its end; on the CPU
    the host clock times each step."""
    losses, marks = [], []
    if cuda:
        window = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        window[0].record()
    t0 = time.perf_counter()
    for row in rows:
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        else:
            ts = time.perf_counter()
        losses.append(step_loss(row))
        if cuda:
            ev[1].record()
        marks.append(ev if cuda else 1e3 * (time.perf_counter() - ts))
    if cuda:
        window[1].record()
        window[1].synchronize()
        return ([a.elapsed_time(b) for a, b in marks], window[0].elapsed_time(window[1]) / 1e3,
                [float(x) for x in losses])
    return marks, time.perf_counter() - t0, [float(x) for x in losses]


def _peak_extra_mib(step_once, device) -> float:
    """Device memory one step takes beyond what is allocated before it."""
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    step_once()
    torch.cuda.synchronize(device)
    return (torch.cuda.max_memory_allocated(device) - base) / 2**20


def measure_path(*, name, params, cfg, kernels, x, y, idx, warmup, device, qat=None,
                 lr=LR, reg_type="epswise", reg_coeff=REG_COEFF, grad_accum_steps=1,
                 time_forward=False):
    """One path's JSON record: a fresh model from ``params`` and a fresh
    Adam, ``warmup`` untimed steps (the first builds and loads the kernels),
    one step for peak memory, then the timed steps; then, with
    ``time_forward`` (and no ``qat``), the model's forward under
    ``inference_mode`` on the same batches, timed alike."""
    cuda = device.type == "cuda"
    model = EPSesPlusLinear.from_reference(params, cfg, device=device)
    opt = make_optimizer("adam", model.parameters(), lr)
    step = make_fast_train_step(model, opt, reg_type, reg_coeff, kernels=kernels,
                                grad_accum_steps=grad_accum_steps)
    gather = make_gather_batch(x, y)
    first = float(step(*gather(idx[0]))["loss"])
    for row in idx[1:warmup]:
        step(*gather(row))
    extra_mib = _peak_extra_mib(lambda: step(*gather(idx[warmup])), device) if cuda else None
    timed = idx[warmup + 1 :]
    before = read_counters()
    per_step_ms, window_s, losses = _timed_steps(
        lambda row: step(*gather(row))["loss"], timed, cuda
    )
    after = read_counters()
    p50 = statistics.median(per_step_ms)
    gflop = step_gflop(cfg, idx.shape[1], x.shape[0])
    fwd_p50 = None
    if time_forward and qat is None:
        with torch.inference_mode():
            model(gather(idx[0])[0], kernels=kernels)
            per_fwd_ms, _, _ = _timed_steps(
                lambda row: model(gather(row)[0], kernels=kernels).sum(), timed, cuda)
        fwd_p50 = statistics.median(per_fwd_ms)
    bf16 = cfg.compute_dtype is not None
    return {
        "metric": "train_step", "path": name, "qat": qat,
        "compute_dtype": "bfloat16" if bf16 else "float32",
        "device": _device_name(device),
        "timer": "cuda_events" if cuda else "host_clock",
        "epses_specs": [list(s) for s in cfg.epses_specs], "batch_size": int(idx.shape[1]),
        "grad_accum_steps": grad_accum_steps, "lr": lr, "reg_type": reg_type,
        "reg_coeff": reg_coeff, "timed_steps": len(timed),
        "images_per_s": idx.shape[1] * len(timed) / window_s,
        "step_ms_p50": p50,
        "forward_ms_p50": fwd_p50,
        "first_loss": first, "last_loss": losses[-1],
        "launches_per_step": {k: (after[k] - before[k]) / len(timed) for k in after},
        "step_gflop": gflop,
        "f32_peak_share": (
            gflop / (p50 / 1e3) / H100_F32_PEAK_FLOPS * 1e9
            if cuda and qat is None and not bf16 else None
        ),
        "bf16_peak_share": (
            gflop / (p50 / 1e3) / H100_BF16_PEAK_FLOPS * 1e9 if cuda and bf16 else None
        ),
        "peak_extra_mib": extra_mib,
    }


def run(*, device="cuda", steps=30, warmup=3, batch_size=128, compare_plain=False,
        epses_specs=FLAGSHIP, synthetic_sizes=(8192, 2048, 2048), qat=None, lr=LR,
        reg_type="epswise", reg_coeff=REG_COEFF, grad_accum_steps=1, compute_dtype=None,
        time_forward=False):
    """Benchmarks the training step (the int8 QAT step with
    ``qat="int8"``) on ``device``, printing and returning one record per
    path (the kernel path, then the plain one with ``compare_plain``).
    ``grad_accum_steps`` is a count or ``"auto"``, resolved for
    ``batch_size`` by ``resolve_auto_grad_accum``. ``compute_dtype``: None
    (float32) or ``torch.bfloat16``, the EPS products' operands.
    ``time_forward`` adds each path's forward p50 (``measure_path``); its
    launches count in the wrappers' counters after the steps'."""
    if qat not in PATHS:
        raise click.UsageError(f"--qat {qat}: none or int8")
    if reg_type not in REG_TYPES:
        raise click.UsageError(f"--reg-type {reg_type}: one of {', '.join(REG_TYPES)}")
    device = _device(device)
    if steps < 1 or warmup < 1:
        raise click.UsageError("--steps and --warmup must be at least 1")
    splits = load_dataset(
        "fashionmnist", "synthetic", autoscale_kernel_size=epses_specs[0][0],
        synthetic_sizes=synthetic_sizes,
    )
    train = splits.train
    channels, _, image_size, _, q0 = train.x.shape
    cfg = EPSesPlusLinearConfig(epses_specs=epses_specs, image_size=image_size, q0=q0,
                                compute_dtype=compute_dtype)
    if grad_accum_steps == "auto":
        grad_accum_steps = resolve_auto_grad_accum(
            cfg, fast_layer_plans(cfg, channels), batch_size
        )
    if not isinstance(grad_accum_steps, int) or grad_accum_steps < 1 or batch_size % grad_accum_steps:
        raise click.UsageError(
            f"--grad-accum-steps {grad_accum_steps}: a count that divides the batch size "
            f"{batch_size}, or auto"
        )
    params = init_eps_plus_linear(torch.Generator().manual_seed(SEED), cfg)
    batches = Batcher(train, batch_size, shuffle=True, drop_last=True, seed=SEED).indices_forever()
    order = np.stack([next(batches) for _ in range(warmup + 1 + steps)])
    idx = torch.as_tensor(order, device=device)
    x = torch.as_tensor(train.x, device=device)
    y = torch.as_tensor(train.y.astype(np.int64), device=device)
    records = []
    for name, kernels in PATHS[qat][: 2 if compare_plain else 1]:
        rec = measure_path(
            name=name, params=params, cfg=cfg, kernels=kernels, x=x, y=y, idx=idx,
            warmup=warmup, device=device, qat=qat, lr=lr, reg_type=reg_type,
            reg_coeff=reg_coeff, grad_accum_steps=grad_accum_steps, time_forward=time_forward,
        )
        print(json.dumps(rec))
        records.append(rec)
    return records


# the legacy ConvSBS step of experiments/conv_sbs_benchmark.py: 2 layers,
# bond 4, SGD 1e-3, CE on one fixed uniform 28×28 batch
CONV_SBS_LR = 1e-3
CONV_SBS_PATHS = (("kernel", S.KERNELS), ("plain", S.PLAIN))


def measure_conv_sbs_path(*, name, params, cfg, kernels, x, y, warmup, steps, device, lr):
    """One path's JSON record for the ConvSBS step: a fresh model from
    ``params`` and a fresh SGD, ``warmup`` untimed steps (the first builds
    and loads the kernels), one step for peak memory, then ``steps`` timed
    steps on the batch ``x``, ``y``."""
    cuda = device.type == "cuda"
    model = ConvSBSModel(params, cfg, device=device)
    opt = torch.optim.SGD(model.parameters(), lr=lr)

    def step(_row=None):
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(x, kernels=kernels), y)
        loss.backward()
        opt.step()
        return loss.detach()

    first = float(step())
    for _ in range(warmup - 1):
        step()
    extra_mib = _peak_extra_mib(step, device) if cuda else None
    before = read_sbs_counters()
    per_step_ms, window_s, losses = _timed_steps(step, range(steps), cuda)
    after = read_sbs_counters()
    return {
        "metric": "train_step", "model_family": "conv_sbs", "path": name,
        "device": _device_name(device),
        "timer": "cuda_events" if cuda else "host_clock",
        "num_sbs_layers": cfg.num_sbs_layers, "bond_dim_size": cfg.bond_dim_size,
        "trace_edge": cfg.trace_edge, "batch_size": int(x.shape[0]),
        "lr": lr, "timed_steps": steps,
        "images_per_s": x.shape[0] * steps / window_s,
        "step_ms_p50": statistics.median(per_step_ms),
        "first_loss": first, "last_loss": losses[-1],
        "launches_per_step": {k: (after[k] - before[k]) / steps for k in after},
        "peak_extra_mib": extra_mib,
    }


def run_conv_sbs(*, device="cuda", steps=30, warmup=3, batch_size=100, trace_edge=False,
                 compare_plain=False, lr=CONV_SBS_LR, num_sbs_layers=2,
                 bond_dim_size=4):
    """Benchmarks the legacy ConvSBS training step on ``device``: the
    kernel path, then the plain one with ``compare_plain``; prints and
    returns one record per path. The weights (Khrulkov normal) and the
    uniform batch come from seed 0."""
    device = _device(device)
    if steps < 1 or warmup < 1:
        raise click.UsageError("--steps and --warmup must be at least 1")
    cfg = ConvSBSModelConfig(num_sbs_layers=num_sbs_layers, bond_dim_size=bond_dim_size,
                             trace_edge=trace_edge)
    gen = torch.Generator().manual_seed(SEED)
    params = init_conv_sbs_model(gen, cfg)
    x = torch.rand((batch_size, 28, 28), generator=gen).to(device)
    y = torch.randint(0, 10, (batch_size,), generator=gen).to(device)
    records = []
    for name, kernels in CONV_SBS_PATHS[: 2 if compare_plain else 1]:
        rec = measure_conv_sbs_path(name=name, params=params, cfg=cfg, kernels=kernels, x=x,
                                    y=y, warmup=warmup, steps=steps, device=device, lr=lr)
        print(json.dumps(rec))
        records.append(rec)
    return records


# the chain of experiments/logmatmulexp_benchmark.py: 6 random 256×256 f32
# log-matrices, 20 timed iterations of each form
CHAIN = 6
CHAIN_SIZE = 256
CHAIN_ITERATIONS = 20
CHAIN_VARIANTS = {
    "matmul": lambda *ms: reduce(torch.matmul, ms),
    "logmatmulexp": lambda *ms: reduce(logmatmulexp, ms),
    "logmatmulexp_lowmem": lambda *ms: reduce(logmatmulexp_lowmem, ms),
    "logmatmulexp_kernel": lambda *ms: reduce(L.logmatmulexp_kernel, ms),
}


def chain_inputs(device):
    """The chain's log-matrices, standard normal in f32 from seed 0."""
    mats = np.random.default_rng(SEED).standard_normal((CHAIN, CHAIN_SIZE, CHAIN_SIZE))
    mats = mats.astype(np.float32)
    return [torch.as_tensor(m, device=device) for m in mats]


def run_logmatmulexp(*, device="cuda", num_iterations=CHAIN_ITERATIONS):
    """Benchmarks each form of the chain on ``device``: forward, and the
    gradients of sum(out²) in all CHAIN matrices. Prints one JSON line per
    form (with K13's launches per forward and per forward+backward), then
    the log-space/matmul forward ratios; returns the records."""
    device = _device(device)
    if num_iterations < 1:
        raise click.UsageError("--steps must be at least 1")
    mats = chain_inputs(device)
    records = []
    for name, fn in CHAIN_VARIANTS.items():
        rec = benchmark_torch(fn, mats, num_iterations=num_iterations,
                              grad_argnums=tuple(range(CHAIN)), counter=read_lme_launches)
        rec.update(function=name, size=CHAIN_SIZE, chain=CHAIN, device=_device_name(device))
        print(json.dumps(rec))
        records.append(rec)
    fwd = {r["function"]: r["forward_seconds_per_iteration"] for r in records}
    print(f"log-space / matmul forward: ops {fwd['logmatmulexp'] / fwd['matmul']:.1f}x, "
          f"kernel {fwd['logmatmulexp_kernel'] / fwd['matmul']:.1f}x "
          "(reference GPU baseline: ~165x)")
    return records


# the classifier of experiments/log_space_classifier.py
LOG_SPACE_STEPS = 600
LOG_SPACE_BATCH = 256
LOG_SPACE_SIZES = (4096, 1024)
LOG_SPACE_ACC_SPREAD = 0.02
LOG_SPACE_VARIANTS = {
    "scan": lambda w, f: LSC.log_joint(w, f),
    "fused_plain": lambda w, f: LSC.log_joint_fused(w, f, logmatmulexp),
    "fused_kernel": lambda w, f: LSC.log_joint_fused(w, f, L.logmatmulexp_kernel),
}


def log_space_data(device):
    """(train log-features, labels, validation log-features, labels) of the
    synthetic images (seed 1234; validation the next slice) on ``device``."""
    n_train, n_val = LOG_SPACE_SIZES
    x, y = synthetic_mnist_like(n_train, seed=1234)
    xv, yv = synthetic_mnist_like(n_val, seed=1234, offset=n_train)
    return (LSC.features(torch.as_tensor(x, device=device)), torch.as_tensor(y, device=device),
            LSC.features(torch.as_tensor(xv, device=device)), torch.as_tensor(yv, device=device))


def train_log_space(name, joint_fn, data, idx, device):
    """One form's training run (the experiment's ``run_variant``): the
    weights from seed 0, Adam 3e-2, one step per row of ``idx``; the steps
    after the warm-up (min(20, steps // 3)) are timed as one window. Returns
    the record and the trained weights."""
    lf, y, lfv, yv = data
    log_w = LSC.init_log_w(torch.Generator().manual_seed(SEED)).to(device).requires_grad_(True)
    opt = make_optimizer("adam", [log_w], LSC.LR)
    steps = idx.shape[0]
    warmup = min(20, steps // 3)
    cuda = device.type == "cuda"
    before = read_lme_launches()
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(joint_fn(log_w, lf[idx[i]]), y[idx[i]])
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if i == warmup:
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
    if cuda:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        window_ms = start.elapsed_time(end)
    else:
        window_ms = 1e3 * (time.perf_counter() - t0)
    step_launches = read_lme_launches() - before
    with torch.no_grad():
        val_acc = LSC.accuracy(joint_fn(log_w, lfv), yv)
    if not bool(torch.isfinite(log_w).all()):
        raise RuntimeError(f"log_space {name}: the log-weights did not stay finite")
    return {
        "metric": "train_run", "model_family": "log_space", "variant": name,
        "device": _device_name(device), "timer": "cuda_events" if cuda else "host_clock",
        "steps": steps, "batch_size": int(idx.shape[1]), "lr": LSC.LR,
        "val_acc": val_acc, "step_ms": window_ms / max(1, steps - 1 - warmup),
        "first_loss": float(losses[0]), "last_loss": float(losses[-1]),
        "logmatmulexp_launches_per_step": step_launches / steps,
        "logmatmulexp_launches_accuracy": read_lme_launches() - before - step_launches,
    }, log_w.detach()


def run_log_space(*, device="cuda", steps=LOG_SPACE_STEPS, batch_size=LOG_SPACE_BATCH):
    """Trains the classifier in each form on ``device`` from the same
    weights on the same batches (indices from ``np.random.default_rng(0)``);
    prints and returns one record per form. Raises unless the forms agree
    within 0.02 in validation accuracy."""
    device = _device(device)
    if steps < 1 or batch_size < 1:
        raise click.UsageError("--steps and --batch-size must be at least 1")
    data = log_space_data(device)
    rng = np.random.default_rng(0)
    n_train = LOG_SPACE_SIZES[0]
    idx = torch.as_tensor(np.stack([rng.integers(0, n_train, batch_size) for _ in range(steps)]),
                          device=device)
    records = []
    for name, fn in LOG_SPACE_VARIANTS.items():
        rec, _ = train_log_space(name, fn, data, idx, device)
        print(json.dumps(rec))
        records.append(rec)
    accs = [r["val_acc"] for r in records]
    if max(accs) - min(accs) >= LOG_SPACE_ACC_SPREAD:
        raise RuntimeError(f"log_space: the forms disagree on accuracy: {accs}")
    return records


@click.command()
@click.option("--model-family", type=click.Choice(("eps", "conv_sbs", "logmatmulexp", "log_space")),
              default="eps",
              help="eps: the flagship EPS step; conv_sbs: the legacy ConvSBS step "
                   "(2 layers, bond 4, SGD 1e-3); logmatmulexp: the log-space matmul chain; "
                   "log_space: the log-space classifier's training")
@click.option("--trace-edge", is_flag=True, help="conv_sbs: tensor rings instead of open strings")
@click.option("--steps", type=int, default=None,
              help="timed steps: default 30; logmatmulexp: timed iterations (20); "
                   "log_space: training steps (600)")
@click.option("--warmup", type=int, default=3, help="untimed steps first")
@click.option("--batch-size", type=int, default=None,
              help="default 128 (eps), 100 (conv_sbs), 256 (log_space)")
@click.option("--epses-specs", type=parse_epses_specs, default="(4,4),(3,6)")
@click.option("--compare-plain", is_flag=True, help="also time the plain path")
@click.option("--device", default="cuda",
              help="torch device: cuda (the kernels) or cpu (their plain versions)")
@click.option("--qat", type=click.Choice(("none", "int8")), default="none",
              help="int8: the quantization-aware step (int8 W8A8 forward, STE backward)")
@click.option("--lr", type=float, default=None,
              help="learning rate: Adam's 3e-3 (eps), SGD's 1e-3 (conv_sbs)")
@click.option("--reg-type", type=click.Choice(REG_TYPES), default="epswise")
@click.option("--reg-coeff", type=float, default=REG_COEFF)
@click.option("--grad-accum-steps", default="1",
              help="microbatches per step: a count that divides the batch size, or auto")
@click.option("--compute-dtype", type=click.Choice(("float32", "bfloat16")), default="float32",
              help="eps: the EPS products' operands (bfloat16: the kernels' bf16 mode)")
def main(model_family, trace_edge, steps, warmup, batch_size, epses_specs, compare_plain,
         device, qat, lr, reg_type, reg_coeff, grad_accum_steps, compute_dtype):
    if model_family == "logmatmulexp":
        run_logmatmulexp(device=device,
                         num_iterations=CHAIN_ITERATIONS if steps is None else steps)
        return
    if model_family == "log_space":
        run_log_space(device=device, steps=LOG_SPACE_STEPS if steps is None else steps,
                      batch_size=batch_size or LOG_SPACE_BATCH)
        return
    steps = 30 if steps is None else steps
    if model_family == "conv_sbs":
        run_conv_sbs(device=device, steps=steps, warmup=warmup, batch_size=batch_size or 100,
                     trace_edge=trace_edge, compare_plain=compare_plain,
                     lr=CONV_SBS_LR if lr is None else lr)
        return
    run(device=device, steps=steps, warmup=warmup, batch_size=batch_size or 128,
        compare_plain=compare_plain, epses_specs=epses_specs,
        qat=None if qat == "none" else qat, lr=LR if lr is None else lr, reg_type=reg_type,
        reg_coeff=reg_coeff,
        grad_accum_steps=grad_accum_steps if grad_accum_steps == "auto" else _count(grad_accum_steps),
        compute_dtype=torch.bfloat16 if compute_dtype == "bfloat16" else None, time_forward=True)


def _count(text: str) -> int:
    try:
        return int(text)
    except ValueError:
        raise click.UsageError(f"--grad-accum-steps {text}: a count or auto") from None


if __name__ == "__main__":
    main()
