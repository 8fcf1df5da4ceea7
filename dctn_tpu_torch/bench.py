"""Training-throughput benchmark of the port: images/s of the flagship
two-EPS ``(4,4),(3,6)`` + linear FashionMNIST training step on one CUDA card
(the port's counterpart of the root ``bench.py``'s pallas branch,
``bench.py:65-113``).

The step is the one the JAX bench times: the fast (cmt) layout at the
default split, Adam 3e-3, epswise L2 1e-6, batch 128, no dropout, no
gradient accumulation. The synthetic FashionMNIST train split (the port's
``load_dataset``, ν-scaled for K = 4) stays on the device; ``Batcher``
draws the shuffled index batches up front and ``make_gather_batch`` gathers
each batch on the device, so the host stays out of the timed loop. Steps
after the warm-up are timed with CUDA events.

Prints one JSON line per path: images/s, step ms p50, the first and last
loss, kernel launches per step, the step's GFLOP (computed from the layer
shapes) and their share of the H100's 67 TFLOP/s float32 peak, and the
extra device memory of one step. ``--compare-plain`` adds the same line for
the plain path (the kernels' plain PyTorch versions through the same
``autograd.Function``), measured in the same process.

Usage:
  python -m dctn_tpu_torch.bench [--steps 30] [--batch-size 128] [--compare-plain]
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
from .models import EPSesPlusLinear, EPSesPlusLinearConfig, fast_layer_plans, init_eps_plus_linear
from .train import make_fast_train_step, make_gather_batch, make_optimizer

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
)


def read_counters() -> dict:
    """The kernel wrappers' launch counts, by name."""
    return {name: getattr(fn, attr) for name, fn, attr in COUNTERS}


def zero_counters() -> None:
    for _, fn, attr in COUNTERS:
        setattr(fn, attr, 0)


def step_gflop(cfg: EPSesPlusLinearConfig, batch_size: int, in_channels: int = 1) -> float:
    """GFLOP of the EPS contractions of one training step, from the shapes:
    per layer 2·Z·A·npix for the forward, the same for d_cmt, and the same
    again for d_views in every layer but the first (whose input needs no
    gradient). The factor products, the classifier and the optimizer are
    left out."""
    total, h = 0.0, cfg.image_size
    for i, p in enumerate(fast_layer_plans(cfg, in_channels)):
        n_k, q_k, n1_k = K._kernel_dims(p["c"], p["q"], p["kernel_size"], p["n1"], p["merge_pairs"])
        h = h - p["kernel_size"] + 1
        gemm = 2 * p["out_size"] * q_k**n_k * batch_size * h * h
        total += gemm * (2 if i == 0 else 3)
    return total / 1e9


def _timed_steps(step, gather, idx, cuda: bool):
    """Runs one step per row of ``idx``; returns (per-step ms, window s,
    losses). On CUDA each step is bracketed by events and the window is
    fenced once at its end; on the CPU the host clock times each step."""
    losses, marks = [], []
    if cuda:
        window = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        window[0].record()
    t0 = time.perf_counter()
    for row in idx:
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        else:
            ts = time.perf_counter()
        losses.append(step(*gather(row))["loss"])
        if cuda:
            ev[1].record()
        marks.append(ev if cuda else 1e3 * (time.perf_counter() - ts))
    if cuda:
        window[1].record()
        window[1].synchronize()
        return ([a.elapsed_time(b) for a, b in marks], window[0].elapsed_time(window[1]) / 1e3,
                [float(x) for x in losses])
    return marks, time.perf_counter() - t0, [float(x) for x in losses]


def measure_path(*, name, params, cfg, kernels, x, y, idx, warmup, device):
    """One path's JSON record: a fresh model from ``params`` and a fresh
    Adam, ``warmup`` untimed steps (the first builds and loads the kernels),
    one step for peak memory, then the timed steps."""
    cuda = device.type == "cuda"
    model = EPSesPlusLinear.from_reference(params, cfg, device=device)
    opt = make_optimizer("adam", model.parameters(), LR)
    step = make_fast_train_step(model, opt, "epswise", REG_COEFF, kernels=kernels)
    gather = make_gather_batch(x, y)
    first = float(step(*gather(idx[0]))["loss"])
    for row in idx[1:warmup]:
        step(*gather(row))
    extra_mib = None
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        step(*gather(idx[warmup]))
        torch.cuda.synchronize(device)
        extra_mib = (torch.cuda.max_memory_allocated(device) - base) / 2**20
    timed = idx[warmup + 1 :]
    before = read_counters()
    per_step_ms, window_s, losses = _timed_steps(step, gather, timed, cuda)
    after = read_counters()
    p50 = statistics.median(per_step_ms)
    gflop = step_gflop(cfg, idx.shape[1], x.shape[0])
    return {
        "metric": "train_step", "path": name,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "timer": "cuda_events" if cuda else "host_clock",
        "batch_size": int(idx.shape[1]), "timed_steps": len(timed),
        "images_per_s": idx.shape[1] * len(timed) / window_s,
        "step_ms_p50": p50,
        "first_loss": first, "last_loss": losses[-1],
        "launches_per_step": {k: (after[k] - before[k]) / len(timed) for k in after},
        "step_gflop": gflop,
        "f32_peak_share": gflop / (p50 / 1e3) / H100_F32_PEAK_FLOPS * 1e9 if cuda else None,
        "peak_extra_mib": extra_mib,
    }


def run(*, device="cuda", steps=30, warmup=3, batch_size=128, compare_plain=False,
        epses_specs=FLAGSHIP, synthetic_sizes=(8192, 2048, 2048)):
    """Benchmarks the training step on ``device``, printing and returning
    one record per path (the kernel path, then the plain one with
    ``compare_plain``)."""
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
    params = init_eps_plus_linear(torch.Generator().manual_seed(SEED), cfg)
    batches = Batcher(train, batch_size, shuffle=True, drop_last=True, seed=SEED).indices_forever()
    order = np.stack([next(batches) for _ in range(warmup + 1 + steps)])
    idx = torch.as_tensor(order, device=device)
    x = torch.as_tensor(train.x, device=device)
    y = torch.as_tensor(train.y.astype(np.int64), device=device)
    paths = [("kernel", K.KERNELS)] + ([("plain", K.PLAIN)] if compare_plain else [])
    records = []
    for name, kernels in paths:
        rec = measure_path(
            name=name, params=params, cfg=cfg, kernels=kernels, x=x, y=y, idx=idx,
            warmup=warmup, device=device,
        )
        print(json.dumps(rec))
        records.append(rec)
    return records


@click.command()
@click.option("--steps", type=int, default=30, help="timed steps")
@click.option("--warmup", type=int, default=3, help="untimed steps first")
@click.option("--batch-size", type=int, default=128)
@click.option("--epses-specs", type=parse_epses_specs, default="(4,4),(3,6)")
@click.option("--compare-plain", is_flag=True, help="also time the plain path")
@click.option("--device", default="cuda",
              help="torch device: cuda (the kernels) or cpu (their plain versions)")
def main(steps, warmup, batch_size, epses_specs, compare_plain, device):
    run(device=device, steps=steps, warmup=warmup, batch_size=batch_size,
        compare_plain=compare_plain, epses_specs=epses_specs)


if __name__ == "__main__":
    main()
