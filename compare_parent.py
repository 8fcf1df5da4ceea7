#!/usr/bin/env python3
"""Time the port's EPS kernels and training steps of this checkout against
those of another checkout (a ``git archive`` of the parent commit), in
turns, on one CUDA card.

Run from the root of this checkout, with the other one unpacked in a
directory that ``.gitignore`` lists (here HEAD, the parent of uncommitted
changes):

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python3 compare_parent.py build/parent [--steps]

For every layer of the training paths in ``PATHS`` (the flagship, the
three-EPS and the deep model at batch 128, and the deep model at 512 and
2048 images per microbatch), each kernel that layer's step runs (its
forward, ``eps_dcore`` and its backward arm's d_views kernel; both d_views
forms where the layer has a v half, below batch 2048) is called from both
checkouts on the same inputs: this checkout's result is held within
``chip_smoke.REL_TOL`` of the other's, then both are timed in turns (median
CUDA-event ms). With ``--steps``, ``python -m dctn_tpu_torch.bench`` then
runs each config of ``STEPS`` in both checkouts, in the order other, this,
this, other. One JSON line per reading; exits nonzero at the first failed
check, and at once without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

from chip_smoke import (
    BATCH,
    DEEP,
    DEEP_BATCH,
    DEEP_LR,
    DEEP_REG,
    FLAGSHIP,
    REL_TOL,
    SEED,
    THREE,
    bound_ms,
    check,
    layer_dims,
    median_ms,
)

# (label, model, images per microbatch); each layer's d_views kernel is its
# backward arm's at that microbatch
PATHS = (
    ("flagship", FLAGSHIP, BATCH),
    ("three-EPS", THREE, BATCH),
    ("deep", DEEP, BATCH),
    ("deep at accum 4", DEEP, DEEP_BATCH // 4),
    ("deep at accum 1", DEEP, DEEP_BATCH),
)
# python -m dctn_tpu_torch.bench, each run in both checkouts
STEPS = (
    ("flagship f32", ()),
    ("flagship QAT", ("--qat", "int8")),
    *((f"deep batch {DEEP_BATCH} grad_accum_steps={acc}",
       ("--epses-specs", ",".join(f"({k},{o})" for k, o in DEEP), "--batch-size", str(DEEP_BATCH),
        "--lr", str(DEEP_LR), "--reg-type", DEEP_REG[0], "--reg-coeff", str(DEEP_REG[1]),
        "--grad-accum-steps", acc, "--steps", "3", "--warmup", "1")) for acc in ("1", "auto")),
)


def load_eps_kernels(root_dir: str):
    """``kernels/eps_kernels.py`` of the checkout in ``root_dir``, as the
    package ``other_dctn_tpu_torch``: its own sources, built into its own
    ``build/``."""
    root = os.path.join(os.path.abspath(root_dir), "dctn_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "other_dctn_tpu_torch", os.path.join(root, "__init__.py"),
        submodule_search_locations=[root])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module("other_dctn_tpu_torch.kernels.eps_kernels")


def layer_cases(K, i, n, q, n1, o, npix, batch, views, cmt, g):
    """(name, call on a kernels module, flops of its products) for each
    kernel the layer's training step runs."""
    z, a = cmt.shape
    arm = K.plan_backward(i, n, n1, q, o, npix)
    both = i > 0 and n1 < n and batch < DEEP_BATCH  # at 2048, t would take 13 GB
    saved = arm == "saved_t" or both
    t = K.eps_fwd(views, cmt, n1, o, save_t=True)[1] if saved else None
    mm = 2.0 * z * a * npix
    cases = [("eps_fwd_t", lambda M: M.eps_fwd(views, cmt, n1, o, save_t=True), mm)
             if arm == "saved_t" else ("eps_fwd", lambda M: M.eps_fwd(views, cmt, n1, o), mm),
             ("eps_dcore", lambda M: M.eps_dcore(views, g, n1, o), mm)]
    if saved:
        cases.append(("eps_dviews_t", lambda M: M.eps_dviews_t(views, cmt, g, t, n1, o), mm))
    if arm == "recompute" or both:
        cases.append(("eps_dviews_recompute", lambda M: M.eps_dviews_recompute(views, cmt, g, n1, o),
                      2 * mm if n1 < n else mm))
    return cases


def compare_kernels(K, OK, dev) -> None:
    g_ = torch.Generator(device=dev).manual_seed(SEED)
    for path, specs, batch in PATHS:
        for i, (n, q, n1, o, h) in enumerate(layer_dims(specs)):
            npix = batch * h * h
            views = torch.rand((n, q, npix), generator=g_, device=dev)
            cmt = torch.randn((o * q ** (n - n1), q**n1), generator=g_, device=dev) * q ** (-n / 2)
            g = torch.randn((o, npix), generator=g_, device=dev)
            for name, call, mm in layer_cases(K, i, n, q, n1, o, npix, batch, views, cmt, g):
                got, ref = call(K), call(OK)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                err = max(float((x - r).abs().max()) for x, r in zip(got, ref))
                scale = max(float(r.abs().max()) for r in ref)
                check(err <= REL_TOL * scale, f"{name} [{path} layer {i}]: differs from the "
                      f"other checkout's by {err} (max|ref| {scale})")
                del got, ref
                reps = 3 if npix > 500_000 else 10
                t_other, t_this = median_ms([lambda: call(OK), lambda: call(K)], reps=reps)
                print(json.dumps({
                    "metric": "kernel_vs_parent", "kernel": name, "path": path, "layer": i,
                    "shape": {"n": n, "q": q, "n1": n1, "O": o, "Z": cmt.shape[0],
                              "A": cmt.shape[1], "npix": npix},
                    "parent_ms": t_other, "ms": t_this, "parent_over_change": t_other / t_this,
                    "products_tflops": mm / t_this / 1e9, "bound_ms": bound_ms(0.0, mm_flops=mm)[0],
                    "max_abs_diff_vs_parent": err, "tol": REL_TOL * scale}), flush=True)
            del views, cmt, g
            torch.cuda.empty_cache()


def compare_steps(other_dir: str) -> None:
    trees = {"parent": os.path.abspath(other_dir), "change": os.path.dirname(os.path.abspath(__file__))}
    for label, extra in STEPS:
        for which in ("parent", "change", "change", "parent"):
            proc = subprocess.run([sys.executable, "-m", "dctn_tpu_torch.bench", *extra],
                                  cwd=trees[which], capture_output=True, text=True, timeout=900)
            check(proc.returncode == 0, f"bench {label} in the {which} tree: {proc.stderr[-2000:]}")
            rec = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
            print(json.dumps({"metric": "step_vs_parent", "config": label, "tree": which,
                              "step_ms_p50": rec["step_ms_p50"], "images_per_s": rec["images_per_s"],
                              "peak_extra_mib": rec["peak_extra_mib"],
                              "launches_per_step": rec["launches_per_step"]}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", metavar="DIR", help="root of the checkout to compare with")
    ap.add_argument("--steps", action="store_true", help="also the bench's steps in both checkouts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_parent: no CUDA device", file=sys.stderr)
        return 1
    from dctn_tpu_torch.kernels import eps_kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    compare_kernels(K, load_eps_kernels(args.other), torch.device("cuda", 0))
    if args.steps:
        compare_steps(args.other)
    return 0


if __name__ == "__main__":
    sys.exit(main())
