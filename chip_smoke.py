#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dctn_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and builds every kernel of the serving and training paths from
   ``dctn_tpu_torch/csrc`` (one ``nvcc`` per source, all at once), printing
   each build time and the compiler's register report.
2. Holds each kernel against its plain PyTorch version at the flagship
   model's layer shapes at batch 128 and at small shapes (every factor in
   the matmul half; a ragged pixel count), with median CUDA-event times of
   the kernel, the plain version and the cuBLAS matmul of the same GEMM on
   materialized operands (the GEMM alone; the port never calls it).
3. Drives the serving path: saves a seeded flagship ``(4,4),(3,6)`` model,
   runs ``dctn_tpu_torch.cli.predict.run`` on 1024 synthetic FashionMNIST
   images with the latency benchmark, checks that the forward kernel ran
   twice per forward and wrote no t, and checks the logits against the same
   forward on the plain version and, on a small input, against the float64
   reference-layout forward on the CPU.
4. Drives the training path: ``dctn_tpu_torch.bench.run`` takes Adam steps
   of the flagship at batch 128 on the kernels and on the plain path, and
   the script checks the kernels' launches per step, the gradients of one
   step against the plain path's, a 3-step trajectory at batch 4 against the
   float64 step on the CPU, and that the losses are finite.
5. With ``--profile DIR`` only: the device-time breakdown (``torch.profiler``)
   of the serving forward at batch 1 and 128 and of the training step at
   batch 128, on the kernel and on the plain path, with the device's busy
   share and extra memory; the full profiler tables go to DIR.
6. Prints one JSON line describing the kernels, then the result line.

Any failure exits nonzero before the result line; without a CUDA device it
exits nonzero at once. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

FLAGSHIP = ((4, 4), (3, 6))
BATCH = 128
SEED = 0
# kernel against plain: both sides are float32 and only the summation order
# differs (sums of 256-1536 terms in the forward and d_views, of up to 80,000
# pixels in d_cmt), far inside 1e-4 of the largest entry
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
# an H100 SXM at its 700 W limit (NVIDIA's data sheet): float32 outside the
# tensor cores, and HBM3
F32_PEAK_FLOPS = 67e12
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
}
SOURCES = ("eps_fwd", "eps_dcore", "eps_dviews_t")


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


def build_all(build) -> None:
    """Phase 1: one nvcc per source, all started together."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        done = {name: pool.submit(lambda n=name: (build.load_library(n), time.perf_counter() - t0))
                for name in SOURCES}
        for name, fut in done.items():
            print(f"built {name} in {fut.result()[1]:.2f} s")
            log = build.library_path(name).with_suffix(".log")
            if log.exists():
                print(log.read_text().strip())


def kernel_shapes(cfg, K, plans):
    """(label, n, q, n1, O, npix): the flagship layers at batch 128, then
    every factor in u (n2 = 0), then a ragged pixel count."""
    shapes, h = [], cfg.image_size
    for i, p in enumerate(plans):
        n_k, q_k, n1_k = K._kernel_dims(p["c"], p["q"], p["kernel_size"], p["n1"], p["merge_pairs"])
        h = h - p["kernel_size"] + 1
        shapes.append((f"flagship layer {i}", n_k, q_k, n1_k, p["out_size"], BATCH * h * h))
    return shapes + [("n2=0", 4, 3, 4, 5, 1000), ("ragged npix", 6, 2, 3, 3, 777)]


def bound_ms(flops: float, nbytes: float):
    """The least time of the work on the card: (ms, what bounds it)."""
    t_ops, t_bytes = flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def kernel_vs_plain(cfg, K, plans, dev):
    """Phase 2: each kernel against its plain version. Returns, per kernel,
    the JSON numbers: max |Δ| over every shape it ran at, and its kernel,
    plain, library and bound times summed over the flagship layers it runs
    at on its path (eps_fwd: the serving forward, both layers without t;
    eps_fwd_t: layer 1, which saves t for training; eps_dcore: both layers;
    eps_dviews_t: layer 1)."""
    on_path = {
        "eps_fwd": ("flagship layer 0", "flagship layer 1"),
        "eps_fwd_t": ("flagship layer 1",),
        "eps_dcore": ("flagship layer 0", "flagship layer 1"),
        "eps_dviews_t": ("flagship layer 1",),
    }
    runs = {
        "eps_fwd": ("flagship layer 0", "flagship layer 1", "n2=0", "ragged npix"),
        "eps_fwd_t": ("flagship layer 0", "flagship layer 1", "ragged npix"),
        "eps_dcore": ("flagship layer 0", "flagship layer 1", "n2=0", "ragged npix"),
        "eps_dviews_t": ("flagship layer 0", "flagship layer 1", "n2=0", "ragged npix"),
    }
    res = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "flops": 0.0, "bytes": 0.0} for k in KERNELS}
    g_ = torch.Generator(device=dev).manual_seed(SEED)
    for label, n, q, n1, o, npix in kernel_shapes(cfg, K, plans):
        views = torch.rand((n, q, npix), generator=g_, device=dev)
        cmt = torch.randn((o * q ** (n - n1), q**n1), generator=g_, device=dev) * q ** (-n / 2)
        g = torch.randn((o, npix), generator=g_, device=dev)
        z, a = cmt.shape
        t = K.eps_fwd_reference(views, cmt, n1, o, save_t=True)[1] if n1 < n else None
        u = K._suffix_chain(views, 0, n1)[0]
        kr2 = K._kr2(views, g, n1)
        f4 = 4.0  # bytes per float32
        gemm = 2.0 * z * a * npix
        cases = {
            "eps_fwd": (lambda: K.eps_fwd(views, cmt, n1, o),
                        lambda: K.eps_fwd_reference(views, cmt, n1, o),
                        lambda: torch.matmul(cmt, u),
                        gemm + 2.0 * z * npix, f4 * (views.numel() + cmt.numel() + o * npix)),
            "eps_fwd_t": (lambda: K.eps_fwd(views, cmt, n1, o, save_t=True),
                          lambda: K.eps_fwd_reference(views, cmt, n1, o, save_t=True),
                          lambda: torch.matmul(cmt, u),
                          gemm + 2.0 * z * npix,
                          f4 * (views.numel() + cmt.numel() + o * npix + z * npix)),
            "eps_dcore": (lambda: K.eps_dcore(views, g, n1, o),
                          lambda: K.eps_dcore_reference(views, g, n1, o),
                          lambda: torch.matmul(kr2, u.T),
                          gemm, f4 * (views.numel() + g.numel() + z * a)),
            "eps_dviews_t": (lambda: K.eps_dviews_t(views, cmt, g, t, n1, o),
                             lambda: K.eps_dviews_t_reference(views, cmt, g, t, n1, o),
                             lambda: torch.matmul(cmt.T, kr2),
                             gemm + 2.0 * z * npix,
                             f4 * (2 * views.numel() + cmt.numel() + g.numel()
                                   + (0 if t is None else t.numel()))),
        }
        for name, (kern, plain, lib, flops, nbytes) in cases.items():
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
                errs.append(f"{which} max|d|={err:.3e} tol={REL_TOL * scale:.3e}")
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
            t_k, t_p, t_l = median_ms([kern, plain, lib], reps=10)
            b_ms, _ = bound_ms(flops, nbytes)
            print(
                f"{name} vs plain [{label}] n={n} q={q} n1={n1} O={o} npix={npix}: "
                f"{'; '.join(errs)} (1e-4*max|ref|); kernel {t_k:.4f} ms "
                f"({gemm / t_k / 1e9:.2f} TFLOP/s of GEMM), plain {t_p:.4f} ms, "
                f"cuBLAS GEMM alone {t_l:.4f} ms, bound {b_ms:.4f} ms"
            )
            if label in on_path[name]:
                r = res[name]
                r["ms"] += t_k
                r["plain_ms"] += t_p
                r["library_ms"] += t_l
                r["flops"] += flops
                r["bytes"] += nbytes
        del views, cmt, g, t, u, kr2
    for r in res.values():
        r["bound_ms"], r["bound_by"] = bound_ms(r.pop("flops"), r.pop("bytes"))
    return res


def device_ms_per_call(fn, calls: int, out_path: str) -> tuple:
    """torch.profiler over ``calls`` calls of ``fn``: (device ms per call,
    the top device kernels as (name, ms per call)). Writes the whole table
    to ``out_path``. Only the kernels' own rows are summed: a host op's row,
    and a user annotation's such as ``Optimizer.step#Adam.step``, repeat
    the device time of the kernels they launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    with open(out_path, "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=40))
    per_kernel = sorted(
        ((e.key, e.self_device_time_total / 1e3 / calls) for e in events
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
         and not getattr(e, "is_user_annotation", False)),
        key=lambda kv: -kv[1],
    )
    return sum(ms for _, ms in per_kernel), per_kernel[:8]


def profile_serving(model, x, K, latency_stats, out_dir: str) -> None:
    """Phase 5 (opt-in): where the serving forward's time goes, on the
    kernel path and on the plain path, at batch 1 and batch 128."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {"kernel": K.KERNELS, "plain": K.PLAIN}
    for bs in (1, BATCH):
        xb = x[:, :bs]
        for name, kernels in paths.items():
            def forward(xs, kernels=kernels):
                return model(xs, kernels=kernels)

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
                lambda: forward(xb), calls, os.path.join(out_dir, f"profile_{name}_bs{bs}.txt")
            )
            print(json.dumps({
                "metric": "serving_profile", "path": name, "batch_size": bs,
                "p50_ms": stats["p50_ms"], "pipelined_throughput_img_per_s":
                stats["pipelined_throughput_img_per_s"], "device_busy_ms": busy_ms,
                "device_idle_share_at_p50": 1 - busy_ms / stats["p50_ms"],
                "host_enqueue_ms": host_ms, "extra_device_mib": extra_mib,
                "top_device_ops_ms": top,
            }))


def flagship_trainer(params, cfg, kernels, dev, lr):
    """A model on ``dev`` from ``params`` and the bench's Adam step (epswise
    L2 1e-6) at learning rate ``lr``."""
    from dctn_tpu_torch import bench
    from dctn_tpu_torch.models import EPSesPlusLinear
    from dctn_tpu_torch.train import make_fast_train_step, make_optimizer

    model = EPSesPlusLinear.from_reference(params, cfg, device=dev)
    opt = make_optimizer("adam", model.parameters(), lr)
    return model, make_fast_train_step(model, opt, "epswise", bench.REG_COEFF, kernels=kernels)


def check_training(params, cfg, K, x, y, dev) -> None:
    """The training path's output: one step's gradients on the kernels
    against the plain path's at batch 128, and a 3-step trajectory at batch
    4 against the float64 step on the CPU."""
    from dctn_tpu_torch import bench
    from dctn_tpu_torch.interop import params_from_numpy, params_to_numpy

    xb, yb = x[:, :BATCH], y[:BATCH]
    grads = []
    for kernels in (K.KERNELS, K.PLAIN):
        model, step = flagship_trainer(params, cfg, kernels, dev, bench.LR)
        step(xb, yb)
        grads.append([p.grad for p in model.parameters()])
    torch.cuda.synchronize()
    for i, (gk, gp) in enumerate(zip(*grads)):
        err, scale = float((gk - gp).abs().max()), float(gp.abs().max())
        print(f"gradient {i} {tuple(gk.shape)} kernel vs plain: max|d|={err:.3e} "
              f"tol={REL_TOL * scale:.3e} (1e-4*max|ref|)")
        check(torch.isfinite(gk).all().item(), f"gradient {i}: non-finite")
        check(err <= REL_TOL * scale, f"gradient {i} differs from the plain path's")

    p64 = params_from_numpy(params_to_numpy(params), "cpu", torch.float64)
    model_k, step_k = flagship_trainer(params, cfg, K.KERNELS, dev, TRAJ_LR)
    model_64, step_64 = flagship_trainer(p64, cfg, K.PLAIN, torch.device("cpu"), TRAJ_LR)
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


def profile_training(params, cfg, K, x, y, dev, out_dir: str) -> None:
    """Phase 5 (opt-in): where the training step's time goes at batch 128."""
    from dctn_tpu_torch import bench

    os.makedirs(out_dir, exist_ok=True)
    xb, yb = x[:, :BATCH], y[:BATCH]
    for name, kernels in (("kernel", K.KERNELS), ("plain", K.PLAIN)):
        _, step = flagship_trainer(params, cfg, kernels, dev, bench.LR)
        for _ in range(3):
            step(xb, yb)
        torch.cuda.synchronize()
        calls = 5
        t0 = time.perf_counter()
        for _ in range(calls):
            step(xb, yb)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / calls
        busy_ms, top = device_ms_per_call(
            lambda: step(xb, yb), calls, os.path.join(out_dir, f"profile_train_{name}.txt")
        )
        print(json.dumps({
            "metric": "train_profile", "path": name, "batch_size": BATCH,
            "step_wall_ms": wall_ms, "device_busy_ms": busy_ms,
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
    from dctn_tpu_torch.models import (
        EPSesPlusLinearConfig,
        eps_plus_linear_forward,
        fast_layer_plans,
        init_eps_plus_linear,
    )
    from dctn_tpu_torch.train import save_params_npz

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
    plans = fast_layer_plans(cfg)
    numbers = kernel_vs_plain(cfg, K, plans, dev)

    # phase 3: the serving path, through the entry point a user calls
    params = init_eps_plus_linear(torch.Generator().manual_seed(SEED), cfg)
    sizes = (1024, 256, 1024)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "flagship.npz")
        save_params_npz(params, ckpt)
        bench.zero_counters()
        t0 = time.perf_counter()
        result = predict.run(
            checkpoint=ckpt, ds_type="fashionmnist", ds_path="synthetic",
            epses_specs=FLAGSHIP, batch_size=BATCH, latency_bench=True,
            device="cuda", synthetic_sizes=sizes,
        )
        serving = bench.read_counters()
    print(
        f"predict.run: {result.forward_calls} forwards, launches {serving}, "
        f"accuracy {result.accuracy:.4f} (random weights), {time.perf_counter() - t0:.1f} s"
    )
    check(result.forward_calls > 0, "predict.run ran no forward")
    check(serving["eps_fwd"] == 2 * result.forward_calls,
          "eps_fwd did not run once per EPS layer and forward")
    check(serving["eps_fwd_t"] == 0, "eps_fwd wrote t while serving")
    check(serving["eps_dcore"] == serving["eps_dviews_t"] == 0, "a backward kernel ran while serving")
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
            profile_serving(model, result.x, K, predict.latency_stats, args.profile)
    del result, model

    # phase 4: the training path, through the bench entry point
    bench.zero_counters()
    t0 = time.perf_counter()
    rec_k, rec_p = bench.run(device="cuda", steps=TRAIN_STEPS, compare_plain=True)
    training = bench.read_counters()
    print(f"bench.run: {time.perf_counter() - t0:.1f} s, launches {training}")
    steps_run = 3 + 1 + TRAIN_STEPS  # warm-up, the memory step, the timed steps
    want = {"eps_fwd": 2, "eps_fwd_t": 1, "eps_dcore": 2, "eps_dcore_sum": 1, "eps_dviews_t": 1}
    check(rec_k["launches_per_step"] == {k: float(v) for k, v in want.items()},
          f"launches per step {rec_k['launches_per_step']} != {want}")
    check(training == {k: v * steps_run for k, v in want.items()},
          f"launches over the run {training}")
    for rec in (rec_k, rec_p):
        check(all(math.isfinite(rec[k]) for k in ("first_loss", "last_loss")), "non-finite loss")
        print(f"train step [{rec['path']}]: p50 {rec['step_ms_p50']:.4f} ms, "
              f"{rec['images_per_s']:.1f} img/s, {rec['f32_peak_share']:.4f} of the f32 peak, "
              f"peak extra memory {rec['peak_extra_mib']:.1f} MiB, "
              f"loss {rec['first_loss']:.6f} -> {rec['last_loss']:.6f}")
    from dctn_tpu_torch.data import load_dataset

    train = load_dataset("fashionmnist", "synthetic", autoscale_kernel_size=4,
                         synthetic_sizes=(BATCH, 4, 4)).train
    tx = torch.as_tensor(train.x, device=dev)
    ty = torch.as_tensor(train.y.astype("int64"), device=dev)
    check_training(params, cfg, K, tx, ty, dev)
    if args.profile:
        profile_training(params, cfg, K, tx, ty, dev, args.profile)

    launches = {
        "eps_fwd": serving["eps_fwd"] + training["eps_fwd"],
        "eps_fwd_t": training["eps_fwd_t"],
        "eps_dcore": training["eps_dcore"],
        "eps_dviews_t": training["eps_dviews_t"],
    }
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
