#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``dctn_tpu_torch``) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and builds every kernel of the serving path from
   ``dctn_tpu_torch/csrc``, printing the build time and the compiler's
   register report.
2. Holds each kernel against its plain PyTorch version at the flagship
   model's layer shapes at batch 128, and at two small shapes (every factor
   in the matmul half; a ragged pixel count), with median CUDA-event times
   of both.
3. Drives the serving path: saves a seeded flagship ``(4,4),(3,6)`` model,
   runs ``dctn_tpu_torch.cli.predict.run`` on 1024 synthetic FashionMNIST
   images with the latency benchmark, checks that the kernel ran twice per
   forward, and checks the logits against the same forward on the plain
   version and, on a small input, against the float64 reference-layout
   forward on the CPU.
4. With ``--profile DIR`` only: the serving forward's device-time breakdown
   (``torch.profiler``) at batch 1 and 128 on the kernel and on the plain
   path, the device's busy share, the extra device memory of one forward, and
   the plain path's latency; the full profiler tables go to DIR.
5. Prints one JSON line describing the kernels, then the result line.

Any failure exits nonzero before the result line; without a CUDA device it
exits nonzero at once. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
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
# both sides are float32; only the summation order differs
REL_TOL = 1e-4
KERNEL = {
    "name": "eps_fwd",
    "route": "cuda",
    "source": "dctn_tpu_torch/csrc/eps_fwd.cu",
    "replaces": "dctn_tpu/pallas/eps_pallas.py:227",
}


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


def kernel_vs_plain(cfg, K, plans, dev):
    """Phase 2: the kernel against eps_fwd_reference. Returns the JSON
    numbers: max |Δ| over every shape, and the kernel and plain times summed
    over the flagship layers (one batch-128 forward)."""
    shapes = []
    h = cfg.image_size
    for i, p in enumerate(plans):
        n_k, q_k, n1_k = K._kernel_dims(p["c"], p["q"], p["kernel_size"], p["n1"], p["merge_pairs"])
        h = h - p["kernel_size"] + 1
        shapes.append((f"flagship layer {i}", n_k, q_k, n1_k, p["out_size"], BATCH * h * h))
    shapes += [("n2=0", 4, 3, 4, 5, 1000), ("ragged npix", 6, 2, 3, 3, 777)]
    g = torch.Generator(device=dev).manual_seed(SEED)
    max_err, ms, plain_ms = 0.0, 0.0, 0.0
    for name, n, q, n1, o, npix in shapes:
        views = torch.rand((n, q, npix), generator=g, device=dev)
        cmt = torch.randn((o * q ** (n - n1), q**n1), generator=g, device=dev) * q ** (-n / 2)
        got = K.eps_fwd(views, cmt, n1, o)
        ref = K.eps_fwd_reference(views, cmt, n1, o)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        t_k, t_p = median_ms(
            [lambda: K.eps_fwd(views, cmt, n1, o), lambda: K.eps_fwd_reference(views, cmt, n1, o)],
            reps=20,
        )
        gflop = 2 * cmt.shape[0] * cmt.shape[1] * npix / 1e9
        print(
            f"kernel vs plain [{name}] n={n} q={q} n1={n1} O={o} npix={npix}: "
            f"max|d|={err:.3e} tol={REL_TOL * scale:.3e} (1e-4*max|ref|, max|ref|={scale:.4e}); "
            f"kernel {t_k:.4f} ms ({gflop / t_k:.2f} TFLOP/s) plain {t_p:.4f} ms"
        )
        check(torch.isfinite(got).all().item(), f"{name}: non-finite kernel output")
        check(err <= REL_TOL * scale, f"{name}: kernel differs from plain by {err}")
        max_err = max(max_err, err)
        if name.startswith("flagship"):
            ms, plain_ms = ms + t_k, plain_ms + t_p
    return max_err, ms, plain_ms


def device_ms_per_call(fn, calls: int, out_path: str) -> tuple:
    """torch.profiler over ``calls`` calls of ``fn``: (device ms per call,
    the top device kernels as (name, ms per call)). Writes the whole table
    to ``out_path``. Only the kernels' own rows are summed: a host op's row
    repeats the device time of the kernels it launched."""
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
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda kv: -kv[1],
    )
    return sum(ms for _, ms in per_kernel), per_kernel[:5]


def profile_serving(model, x, K, latency_stats, out_dir: str) -> None:
    """Phase 4 (opt-in): where the serving forward's time goes, on the
    kernel path and on the plain path, at batch 1 and batch 128."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {"kernel": K.eps_fwd, "plain": K.eps_fwd_reference}
    for bs in (1, BATCH):
        xb = x[:, :bs]
        for name, fwd in paths.items():
            def forward(xs, fwd=fwd):
                return model(xs, fwd=fwd)

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="also profile the serving forward; write the tables to DIR")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 1
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

    # phase 1: build every kernel of the path from the checkout's sources
    t0 = time.perf_counter()
    build.load_library("eps_fwd")
    print(f"built eps_fwd in {time.perf_counter() - t0:.2f} s")
    log = build.library_path("eps_fwd").with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())

    # phase 2: each kernel against its plain version
    cfg = EPSesPlusLinearConfig(epses_specs=FLAGSHIP, image_size=28, q0=2)
    plans = fast_layer_plans(cfg)
    max_err, ms, plain_ms = kernel_vs_plain(cfg, K, plans, dev)

    # phase 3: the serving path, through the entry point a user calls
    params = init_eps_plus_linear(torch.Generator().manual_seed(SEED), cfg)
    sizes = (1024, 256, 1024)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "flagship.npz")
        save_params_npz(params, ckpt)
        K.eps_fwd.launches = 0
        t0 = time.perf_counter()
        result = predict.run(
            checkpoint=ckpt, ds_type="fashionmnist", ds_path="synthetic",
            epses_specs=FLAGSHIP, batch_size=BATCH, latency_bench=True,
            device="cuda", synthetic_sizes=sizes,
        )
        launches = K.eps_fwd.launches
    print(
        f"predict.run: {result.forward_calls} forwards, {launches} eps_fwd launches, "
        f"accuracy {result.accuracy:.4f} (random weights), {time.perf_counter() - t0:.1f} s"
    )
    check(result.forward_calls > 0, "predict.run ran no forward")
    check(launches == 2 * result.forward_calls, "eps_fwd did not run once per EPS layer and forward")
    check(len(result.preds) == sizes[2], "one prediction per test image")

    # the output: finite, the right shape, and equal to the plain forward,
    # on the model and the images that predict.run served
    model = result.model
    check(result.x.device.type == "cuda" and result.x.shape[1] == sizes[2], "served split")
    with torch.inference_mode():
        x = result.x[:, :BATCH]
        logits = model(x)
        ref = model(x, fwd=K.eps_fwd_reference)
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

    print(json.dumps({"kernels": [{
        **KERNEL, "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
