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

Prints one JSON line per path: images/s, step ms p50, the first and last
loss, kernel launches per step, the step's GFLOP (computed from the layer
shapes) and, for the f32 step, their share of the H100's 67 TFLOP/s float32
peak, and the extra device memory of one step. ``--compare-plain`` adds the
same line for the plain path (the kernels' plain PyTorch versions through
the same ``autograd.Function``), measured in the same process.

``--model-family conv_sbs`` times the legacy ConvSBS step of
``experiments/conv_sbs_benchmark.py`` instead: 2 layers, bond 4, Khrulkov
init, ``torch.optim.SGD`` 1e-3, cross-entropy on one fixed uniform 28×28
batch (default 100), open strings or ``--trace-edge`` rings, every string
folded meet-in-the-middle (K10/K11) at ``_mim_cut``'s merge position. Its
record has images/s, step ms p50, the losses, the ConvSBS kernels' launches
per step and the extra device memory.

Usage:
  python -m dctn_tpu_torch.bench [--steps 30] [--batch-size 128] [--compare-plain] [--qat int8]
      [--epses-specs "(4,4),(3,6)"] [--lr 3e-3] [--reg-type epswise] [--reg-coeff 1e-6]
      [--grad-accum-steps 1|n|auto]
  python -m dctn_tpu_torch.bench --model-family conv_sbs [--batch-size 100] [--trace-edge]
      [--compare-plain]
"""

from __future__ import annotations

import json
import statistics
import time

import click
import numpy as np
import torch

from .cli.specs import parse_epses_specs
from .data import Batcher, load_dataset
from .kernels import eps_kernels as K
from .kernels import eps_q8_kernels as Q8
from .kernels import sbs_kernels as S
from .models import (
    ConvSBSModel,
    ConvSBSModelConfig,
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    fast_layer_plans,
    init_conv_sbs_model,
    init_eps_plus_linear,
)
from .train import make_fast_train_step, make_gather_batch, make_optimizer, resolve_auto_grad_accum
from .train.step import REG_TYPES

FLAGSHIP = ((4, 4), (3, 6))
# the step bench.py times (bench.py:85-113): Adam 3e-3, epswise L2 1e-6
LR = 3e-3
REG_COEFF = 1e-6
SEED = 0
# the H100 SXM's float32 peak outside the tensor cores (NVIDIA's data sheet,
# at the 700 W power limit)
H100_F32_PEAK_FLOPS = 67e12
COUNTERS = (
    ("eps_fwd", K.eps_fwd, "launches"),
    ("eps_fwd_t", K.eps_fwd, "t_launches"),
    ("eps_dcore", K.eps_dcore, "launches"),
    ("eps_dcore_sum", K.eps_dcore, "sum_launches"),
    ("eps_dviews_t", K.eps_dviews_t, "launches"),
    ("eps_dviews_recompute", K.eps_dviews_recompute, "launches"),
    ("eps_fwd_q8", Q8.eps_fwd_q8, "launches"),
    ("eps_fwd_q8_t", Q8.eps_fwd_q8, "t_launches"),
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
    """Every kernel wrapper's counts, EPS and ConvSBS, to 0."""
    for _, fn, attr in COUNTERS + SBS_COUNTERS:
        setattr(fn, attr, 0)


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
                 lr=LR, reg_type="epswise", reg_coeff=REG_COEFF, grad_accum_steps=1):
    """One path's JSON record: a fresh model from ``params`` and a fresh
    Adam, ``warmup`` untimed steps (the first builds and loads the kernels),
    one step for peak memory, then the timed steps."""
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
    return {
        "metric": "train_step", "path": name, "qat": qat,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "timer": "cuda_events" if cuda else "host_clock",
        "epses_specs": [list(s) for s in cfg.epses_specs], "batch_size": int(idx.shape[1]),
        "grad_accum_steps": grad_accum_steps, "lr": lr, "reg_type": reg_type,
        "reg_coeff": reg_coeff, "timed_steps": len(timed),
        "images_per_s": idx.shape[1] * len(timed) / window_s,
        "step_ms_p50": p50,
        "first_loss": first, "last_loss": losses[-1],
        "launches_per_step": {k: (after[k] - before[k]) / len(timed) for k in after},
        "step_gflop": gflop,
        "f32_peak_share": (
            gflop / (p50 / 1e3) / H100_F32_PEAK_FLOPS * 1e9 if cuda and qat is None else None
        ),
        "peak_extra_mib": extra_mib,
    }


def run(*, device="cuda", steps=30, warmup=3, batch_size=128, compare_plain=False,
        epses_specs=FLAGSHIP, synthetic_sizes=(8192, 2048, 2048), qat=None, lr=LR,
        reg_type="epswise", reg_coeff=REG_COEFF, grad_accum_steps=1):
    """Benchmarks the training step (the int8 QAT step with
    ``qat="int8"``) on ``device``, printing and returning one record per
    path (the kernel path, then the plain one with ``compare_plain``).
    ``grad_accum_steps`` is a count or ``"auto"``, resolved for
    ``batch_size`` by ``resolve_auto_grad_accum``."""
    if qat not in PATHS:
        raise click.UsageError(f"--qat {qat}: none or int8")
    if reg_type not in REG_TYPES:
        raise click.UsageError(f"--reg-type {reg_type}: one of {', '.join(REG_TYPES)}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise click.UsageError(f"--device {device}: no CUDA device is available")
    if steps < 1 or warmup < 1:
        raise click.UsageError("--steps and --warmup must be at least 1")
    splits = load_dataset(
        "fashionmnist", "synthetic", autoscale_kernel_size=epses_specs[0][0],
        synthetic_sizes=synthetic_sizes,
    )
    train = splits.train
    channels, _, image_size, _, q0 = train.x.shape
    cfg = EPSesPlusLinearConfig(epses_specs=epses_specs, image_size=image_size, q0=q0)
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
            reg_coeff=reg_coeff, grad_accum_steps=grad_accum_steps,
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
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
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
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise click.UsageError(f"--device {device}: no CUDA device is available")
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


@click.command()
@click.option("--model-family", type=click.Choice(("eps", "conv_sbs")), default="eps",
              help="eps: the flagship EPS step; conv_sbs: the legacy ConvSBS step "
                   "(2 layers, bond 4, SGD 1e-3)")
@click.option("--trace-edge", is_flag=True, help="conv_sbs: tensor rings instead of open strings")
@click.option("--steps", type=int, default=30, help="timed steps")
@click.option("--warmup", type=int, default=3, help="untimed steps first")
@click.option("--batch-size", type=int, default=None, help="default 128 (eps), 100 (conv_sbs)")
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
def main(model_family, trace_edge, steps, warmup, batch_size, epses_specs, compare_plain,
         device, qat, lr, reg_type, reg_coeff, grad_accum_steps):
    if model_family == "conv_sbs":
        run_conv_sbs(device=device, steps=steps, warmup=warmup, batch_size=batch_size or 100,
                     trace_edge=trace_edge, compare_plain=compare_plain,
                     lr=CONV_SBS_LR if lr is None else lr)
        return
    run(device=device, steps=steps, warmup=warmup, batch_size=batch_size or 128,
        compare_plain=compare_plain, epses_specs=epses_specs,
        qat=None if qat == "none" else qat, lr=LR if lr is None else lr, reg_type=reg_type,
        reg_coeff=reg_coeff,
        grad_accum_steps=grad_accum_steps if grad_accum_steps == "auto" else _count(grad_accum_steps))


def _count(text: str) -> int:
    try:
        return int(text)
    except ValueError:
        raise click.UsageError(f"--grad-accum-steps {text}: a count or auto") from None


if __name__ == "__main__":
    main()
