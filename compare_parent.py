#!/usr/bin/env python3
"""Time the port's kernels and training steps of this checkout against
those of another checkout (a ``git archive`` of the parent commit), in
turns, on one CUDA card.

Run from the root of this checkout, with the other one unpacked in a
directory that ``.gitignore`` lists (here HEAD, the parent of uncommitted
changes):

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python3 compare_parent.py build/parent [--steps] [--families eps,bf16,ref,q8,sbs,lme]

Each family's kernels are called from both checkouts on the same inputs and
timed in turns:

- ``eps``: for every layer of the training paths in ``PATHS`` (the
  flagship, the three-EPS and the deep model at batch 128, and the deep
  model at 512 and 2048 images per microbatch), each kernel that layer's
  step runs (its forward, ``eps_dcore`` and its backward arm's d_views
  kernel; both d_views forms where the layer has a v half, below batch
  2048), this checkout's result held within ``chip_smoke.REL_TOL`` of the
  other's (median CUDA-event ms);
- ``bf16``: the bf16 operand mode of the same kernels at the same layers
  (K1, and with t where the layer saves it; ``eps_dcore``; the arm's
  d_views form, both below batch 2048)
  and at a grid rank's shapes (``chip_smoke.grid_shard_shapes``: K1 + t,
  ``eps_dcore`` and both d_views forms at layer 1, K1 and ``eps_dcore`` at
  layer 0), on the same float32 inputs, cmt rounded to bf16 once and the
  saved bf16 t written once by this checkout's K1; each result within
  ``chip_smoke.REL_TOL`` of the other's (a bf16 t within one bf16 step),
  median CUDA-event ms in turns (K1's also by device time per call,
  torch.profiler, below 500,000 pixels), the products' TFLOP/s and their
  bound at the dense bf16 rate;
- ``ref``: the reference layout's layers on the kernels' route
  (``ops.eps.eps`` with ``backend="pallas"``, forward and backward, as the
  TP and SP grids run the reference layout) at both flagship layers at
  batch 128, held within ``chip_smoke.REL_TOL`` of each other (median
  CUDA-event ms, the host's work included: this checkout asks the kernels'
  gate at every call); and the gate's host µs per call, cached and
  uncached;
- ``q8``: the int8 forward without t (K8) and with it (K9: t in float32,
  and in bf16 as the bf16 QAT step stores it) at every layer the int8 paths
  run at batch 128 (the flagship's serving and QAT layers, the three-EPS QAT
  layers), at the flagship's layer 1 at a grid rank's shapes
  (``chip_smoke.grid_shard_shapes``) and at one shape of its mma.sync
  kernel (``Q8_MMA_SHAPE``), this checkout's t equal to the other's bit for
  bit and its output within ``chip_smoke.REL_TOL`` of the other's (device
  time per call, torch.profiler, in turns; and the median CUDA-event time of
  one call, the host's work included), each reading with the plan's t store
  route;
- ``sbs``: the ConvSBS forward (K10 at the model's merge position, K12's
  with ``mcut=None``) and backward (the same families, d_views both ways)
  at chip_smoke's phase-2b shapes (both legacy layers, open and ring, batch
  100 and 512) and K11 at every merge position of layer 1's ring at batch
  100, held within ``chip_smoke.SBS_TOL`` of the other's (device time per
  call, and the median CUDA-event time of one call, the host's work
  included);
- ``lme``: K13 at every case of ``chip_smoke.LME_SHAPES``, both held to the
  plain version within chip_smoke's per-entry limit: the product's device
  time per call (torch.profiler), and the whole forward of
  ``logmatmulexp_kernel`` (the shifts and the product: device time per
  call, and the CUDA-event time of one call, the host's launches included).

With ``--steps``, ``python -m dctn_tpu_torch.bench`` then runs each config
of ``STEPS`` of those families in both checkouts, in the order other, this,
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
import time

import torch

from chip_smoke import (
    BATCH,
    DEEP,
    DEEP_BATCH,
    DEEP_LR,
    DEEP_REG,
    FLAGSHIP,
    LME_PROFILE_CALLS,
    LME_SHAPES,
    REL_TOL,
    SBS_BATCHES,
    SBS_MCUT,
    SBS_TOL,
    SEED,
    BF16_STEP,
    THREE,
    bound_ms,
    check,
    device_ms_per_call,
    grid_shard_shapes,
    layer_dims,
    lme_limit_share,
    lme_operands,
    median_ms,
    sbs_case,
    sbs_fwd_route,
    sbs_work,
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
# python -m dctn_tpu_torch.bench, each run in both checkouts, by family
STEPS = {
    "eps": (
        ("flagship f32", ()),
        ("flagship QAT", ("--qat", "int8")),
        *((f"deep batch {DEEP_BATCH} grad_accum_steps={acc}",
           ("--epses-specs", ",".join(f"({k},{o})" for k, o in DEEP), "--batch-size",
            str(DEEP_BATCH), "--lr", str(DEEP_LR), "--reg-type", DEEP_REG[0], "--reg-coeff",
            str(DEEP_REG[1]), "--grad-accum-steps", acc, "--steps", "3", "--warmup", "1"))
          for acc in ("1", "auto")),
    ),
    "q8": (("flagship QAT", ("--qat", "int8")),
           ("flagship QAT bf16", ("--qat", "int8", "--compute-dtype", "bfloat16"))),
    "sbs": tuple(
        (f"conv_sbs batch {b} {'ring' if ring else 'open'}",
         ("--model-family", "conv_sbs", "--batch-size", str(b)) + (("--trace-edge",) if ring else ()))
        for b in SBS_BATCHES for ring in (False, True)),
    "lme": (
        ("logmatmulexp chain", ("--model-family", "logmatmulexp")),
        ("log_space classifier", ("--model-family", "log_space")),
    ),
}
# the numbers of a bench record that a step reading keeps, where present
STEP_KEYS = ("step_ms_p50", "images_per_s", "peak_extra_mib", "launches_per_step",
             "forward_seconds_per_iteration", "forward_backward_seconds_per_iteration",
             "launches_per_forward", "launches_per_forward_backward", "step_ms", "val_acc",
             "logmatmulexp_launches_per_step")
FAMILIES = ("eps", "bf16", "ref", "q8", "sbs", "lme")
# a shape of the int8 forward's mma.sync kernel: A = 81 is not a multiple of 4
Q8_MMA_SHAPE = ("mma.sync: A = 81, n2 = 0", 4, 3, 4, 5, BATCH * 625)


def load_other(root_dir: str) -> str:
    """The ``dctn_tpu_torch`` package of the checkout in ``root_dir``, as the
    package ``other_dctn_tpu_torch`` (its own sources, built into its own
    ``build/``); returns its name, for importing its modules."""
    root = os.path.join(os.path.abspath(root_dir), "dctn_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "other_dctn_tpu_torch", os.path.join(root, "__init__.py"),
        submodule_search_locations=[root])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = pkg
    spec.loader.exec_module(pkg)
    return spec.name


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


def bf16_close(x: torch.Tensor, r: torch.Tensor) -> bool:
    """``x`` within REL_TOL of max|r| of ``r``; a bf16 tensor (a saved t,
    rounded from sums in two orders) entry by entry within one bf16 step
    more."""
    bf16 = r.dtype == torch.bfloat16
    x, r = x.float(), r.float()
    limit = REL_TOL * float(r.abs().max()) + (BF16_STEP * r.abs() if bf16 else 0.0)
    return bool(torch.isfinite(x).all()) and bool(((x - r).abs() <= limit).all())


def bf16_layer_cases(K, i, n, q, n1, o, npix, both, views, cmt, g):
    """(name, call on a kernels module, bf16 flops of its products) for
    each bf16 kernel the layer's bf16 training step runs (with ``both``,
    both d_views forms where the layer has a v half), and K1 without t (the
    serving and eval forward) where the step saves t."""
    cb = cmt.to(torch.bfloat16)
    z, a = cmt.shape
    arm = K.plan_backward(i, n, n1, q, o, npix, 2)
    both = both and i > 0 and n1 < n
    saved = arm == "saved_t" or both
    t = K.eps_fwd(views, cb, n1, o, save_t=True)[1] if saved else None
    mm = 2.0 * z * a * npix
    bf = torch.bfloat16
    cases = [("eps_fwd bf16", lambda M: M.eps_fwd(views, cb, n1, o), mm)]
    if arm == "saved_t":
        cases.append(("eps_fwd_t bf16", lambda M: M.eps_fwd(views, cb, n1, o, save_t=True), mm))
    cases.append(("eps_dcore bf16", lambda M: M.eps_dcore(views, g, n1, o, mm_dtype=bf), mm))
    if saved:
        cases.append(("eps_dviews_t bf16", lambda M: M.eps_dviews_t(views, cb, g, t, n1, o), mm))
    if arm == "recompute" or both:
        cases.append(("eps_dviews_recompute bf16",
                      lambda M: M.eps_dviews_recompute(views, cb, g, n1, o),
                      2 * mm if n1 < n else mm))
    return cases


def compare_bf16(K, OK, dev) -> None:
    """The bf16 mode's kernels of both checkouts at the ``eps`` family's
    layers and at a grid rank's shapes."""
    g_ = torch.Generator(device=dev).manual_seed(SEED)
    layers = [(path, i, n, q, n1, o, batch * h * h, batch < DEEP_BATCH)
              for path, specs, batch in PATHS
              for i, (n, q, n1, o, h) in enumerate(layer_dims(specs))]
    layers += [(label, i, n, q, n1, o, npix, True)
               for label, i, n, q, n1, o, npix in grid_shard_shapes()]
    for path, i, n, q, n1, o, npix, both in layers:
        views = torch.rand((n, q, npix), generator=g_, device=dev)
        cmt = torch.randn((o * q ** (n - n1), q**n1), generator=g_, device=dev) * q ** (-n / 2)
        g = torch.randn((o, npix), generator=g_, device=dev)
        for name, call, mm in bf16_layer_cases(K, i, n, q, n1, o, npix, both, views, cmt, g):
            got, ref = call(K), call(OK)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err = max(float((x.float() - r.float()).abs().max()) for x, r in zip(got, ref))
            scale = max(float(r.float().abs().max()) for r in ref)
            check(all(bf16_close(x, r) for x, r in zip(got, ref)),
                  f"{name} [{path} layer {i}]: differs from the other checkout's by {err} "
                  f"(max|ref| {scale})")
            del got, ref
            reps = 3 if npix > 500_000 else 10
            t_other, t_this = median_ms([lambda: call(OK), lambda: call(K)], reps=reps)
            rec = {
                "metric": "bf16_kernel_vs_parent", "kernel": name, "path": path, "layer": i,
                "shape": {"n": n, "q": q, "n1": n1, "O": o, "Z": cmt.shape[0],
                          "A": cmt.shape[1], "npix": npix},
                "parent_ms": t_other, "ms": t_this, "parent_over_change": t_other / t_this,
                "products_tflops": mm / t_this / 1e9, "bound_ms": bound_ms(0.0, bf16_flops=mm)[0],
                "max_abs_diff_vs_parent": err, "tol": REL_TOL * scale}
            if name.startswith("eps_fwd") and npix <= 500_000:
                # K1 also by device time: at small shapes the host's work
                # (the wrapper and its launches) is most of a call
                dev_ms = turns_device_ms(lambda: call(OK), lambda: call(K), 10)
                rec.update({"parent_device_ms": dev_ms["parent"], "device_ms": dev_ms["change"],
                            "device_parent_over_change": dev_ms["parent"] / dev_ms["change"]})
            print(json.dumps(rec), flush=True)
        del views, cmt, g
        torch.cuda.empty_cache()


def compare_ref(E, OE, dev) -> None:
    """The reference layout's flagship layers on the kernels' route in both
    checkouts (``E``, ``OE``: their ``ops.eps``), then the gate's host time
    per call at layer 1."""
    from dctn_tpu_torch.kernels import eps_kernels as K

    g_ = torch.Generator(device=dev).manual_seed(SEED)
    h, q = 28, 2
    for i, (k, o) in enumerate(FLAGSHIP):
        n = k * k
        core = torch.randn((q,) * n + (o,), generator=g_, device=dev) * q ** (-n / 2)
        x = torch.rand((1, BATCH, h, h, q), generator=g_, device=dev)
        h, q = h - k + 1, o
        cot = torch.randn((BATCH, h, h, o), generator=g_, device=dev)

        def call(M, core=core, x=x, cot=cot, i=i):
            c, xx = core.detach().requires_grad_(True), x.detach().requires_grad_(i > 0)
            out = M.eps(c, xx, backend="pallas")
            return (out.detach(), *torch.autograd.grad(out, (c, xx) if i > 0 else (c,), cot))

        got, ref = call(E), call(OE)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        check(all(float((a - b).abs().max()) <= REL_TOL * float(b.abs().max())
                  for a, b in zip(got, ref)),
              f"reference layout layer {i}: differs from the other checkout's by {err}")
        del got, ref
        t_other, t_this = median_ms([lambda: call(OE), lambda: call(E)], reps=20)
        print(json.dumps({
            "metric": "reference_layer_vs_parent", "path": "flagship", "layer": i,
            "batch": BATCH, "parent_ms": t_other, "ms": t_this,
            "parent_over_change": t_other / t_this, "max_abs_diff_vs_parent": err}), flush=True)
    # the gate as ops.eps asks it at layer 1 (c, q, K, n1, O, pixels, layer,
    # objective): a hit of its cache, and its checks run anew
    args = (1, 4, 3, 5, 6, BATCH * h * h, 1, "train")
    n_k, q_k, n1_k = K._kernel_dims(1, 4, 3, 5, False)
    inner = (n_k, q_k, n1_k, 6, BATCH * h * h, "train", False,
             K._arms(1, n_k, n1_k, q_k, 6, BATCH * h * h, 4))
    calls = 2000
    for label, fn, fargs in (("cached", K.kernels_take_split, args),
                             ("checks", K._kernels_take.__wrapped__, inner)):
        check(fn(*fargs), f"the gate refuses flagship layer 1 ({label})")
        start = time.perf_counter()
        for _ in range(calls):
            fn(*fargs)
        print(json.dumps({"metric": "gate_host_us_per_call", "how": label,
                          "us": 1e6 * (time.perf_counter() - start) / calls}), flush=True)


def compare_q8(Q, OQ, dev) -> None:
    """K8 and K9 (t in float32 and in bf16) of both checkouts at the int8
    paths' layers at batch 128, at the flagship's layer 1 at a grid rank's
    shapes (K9 with a bf16 t only: the bf16 QAT step on a grid) and at one
    shape of the mma.sync kernel."""
    cases = [(f"{model} layer {i}", n, q, n1, o, BATCH * h * h, (None, "f32", "bf16"))
             for model, specs in (("flagship", FLAGSHIP), ("three-EPS", THREE))
             for i, (n, q, n1, o, h) in enumerate(layer_dims(specs))]
    cases += [(label, n, q, n1, o, npix, ("bf16",))
              for label, layer, n, q, n1, o, npix in grid_shard_shapes() if layer == 1]
    cases.append((*Q8_MMA_SHAPE, (None, "f32", "bf16")))
    g_ = torch.Generator(device=dev).manual_seed(SEED)
    for label, n, q, n1, o, npix, kinds in cases:
        views = torch.rand((n, q, npix), generator=g_, device=dev)
        cmt = torch.randn((o * q ** (n - n1), q**n1), generator=g_, device=dev) * q ** (-n / 2)
        wq, sw = Q.quantize_cmt(cmt)
        z, a = wq.shape
        for t_kind in kinds:
            def call(M):
                t_dtype = torch.bfloat16 if t_kind == "bf16" else None
                return lambda: M.eps_fwd_q8(views, wq, sw, n1, o, save_t=t_kind is not None,
                                            t_dtype=t_dtype)

            got, ref = call(Q)(), call(OQ)()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            err, scale = float((got[0] - ref[0]).abs().max()), float(ref[0].abs().max())
            name = {None: "eps_fwd_q8", "f32": "eps_fwd_q8_t", "bf16": "eps_fwd_q8_t_bf16"}[t_kind]
            check(err <= REL_TOL * scale, f"{name} [{label}]: differs from the other checkout's by "
                  f"{err} (max|ref| {scale})")
            check(t_kind is None or torch.equal(got[1], ref[1]),
                  f"{name} [{label}]: t is not the other checkout's bit for bit")
            del got, ref
            dev_ms = turns_device_ms(call(OQ), call(Q), 10)
            call_ms = median_ms([call(OQ), call(Q)], reps=10)
            ops = 2.0 * z * a * npix
            t_bytes = {None: 0, "f32": 4, "bf16": 2}[t_kind] * z * npix
            nbytes = 4.0 * (views.numel() + z + o * npix) + t_bytes + wq.numel()
            b_ms, by = bound_ms(nbytes, 4.0 * z * npix, int8_ops=ops)
            plan = Q._q8_plan(n, q, n1, o, npix, t_kind)
            print(json.dumps({
                "metric": "kernel_vs_parent", "kernel": name, "path": label,
                "form": plan["form"], "t_store": plan["t_store"], "stages": plan["stages"],
                "shape": {"n": n, "q": q, "n1": n1, "O": o, "Z": z, "A": a, "npix": npix},
                "parent_ms": dev_ms["parent"], "ms": dev_ms["change"],
                "parent_over_change": dev_ms["parent"] / dev_ms["change"],
                "tops": ops / dev_ms["change"] / 1e9,
                "call_ms": {"parent": call_ms[0], "change": call_ms[1]},
                "bound_ms": b_ms, "bound_by": by, "max_abs_diff_vs_parent": err,
                "tol": REL_TOL * scale, "t_bit_equal": t_kind is not None}), flush=True)
        del views, cmt, wq, sw
        torch.cuda.empty_cache()


def turns_device_ms(call_parent, call_change, calls: int) -> dict:
    """Device time per call (torch.profiler: the wrapper's kernels, its host
    work left out) of two calls, in the order parent, change, change,
    parent."""
    dev_ms = {"parent": 0.0, "change": 0.0}
    for tree in ("parent", "change", "change", "parent"):
        fn = call_parent if tree == "parent" else call_change
        fn()
        dev_ms[tree] += device_ms_per_call(fn, calls, os.devnull)[0] / 2
    return dev_ms


def compare_sbs(S, OS, dev) -> None:
    """K10, K11 and K12 (forward and backward) of both checkouts at phase
    2b's shapes, and K11 at every merge position of layer 1's ring at batch
    100."""
    from dctn_tpu_torch.models import conv_sbs_model as CSM

    def fwd_reading(label, olr, views, cores, mcut):
        def call(M):
            return lambda: M.sbs_fwd(views, cores, olr, mcut)

        got, ref = call(S)(), call(OS)()
        torch.cuda.synchronize()
        err, scale = float((got - ref).abs().max()), float(ref.abs().max())
        check(err <= SBS_TOL * scale, f"sbs_fwd [{label} mcut={mcut}]: differs from the other "
              f"checkout's by {err} (max|ref| {scale})")
        del got, ref
        dev_ms = turns_device_ms(call(OS), call(S), 20)
        call_ms = median_ms([call(OS), call(S)], reps=10)
        qc, npix = views.shape[1], views.shape[2]
        route, reg_c = sbs_fwd_route(S, olr, qc, mcut)
        b_ms, by = bound_ms(*sbs_work(olr, qc, npix, mcut, False, False, reg_c))
        print(json.dumps({
            "metric": "kernel_vs_parent", "kernel": "sbs_fwd_seq" if mcut is None else "sbs_fwd_mim",
            "path": label, "mcut": mcut, "npix": npix, "route": route,
            "parent_ms": dev_ms["parent"], "ms": dev_ms["change"],
            "parent_over_change": dev_ms["parent"] / dev_ms["change"],
            "call_ms": {"parent": call_ms[0], "change": call_ms[1]},
            "bound_ms": b_ms, "bound_by": by, "max_rel_diff_vs_parent": err / scale,
            "tol": SBS_TOL}), flush=True)

    def reading(label, olr, views, cores, g, mcut, need):
        def call(M):
            return M.sbs_bwd(views, cores, g, olr, mcut, need)

        (dv, dc), (rdv, rdc) = call(S), call(OS)
        torch.cuda.synchronize()
        pairs = list(zip(dc, rdc)) + ([(dv, rdv)] if need else [])
        worst = 0.0
        for got, ref in pairs:
            err, scale = float((got - ref).abs().max()), float(ref.abs().max())
            check(err <= SBS_TOL * scale, f"sbs_bwd [{label}]: differs from the other "
                  f"checkout's by {err} (max|ref| {scale})")
            worst = max(worst, err / scale)
        del dv, dc, rdv, rdc, pairs
        # device time per call in turns; and one call between CUDA events,
        # the host's work included
        dev_ms = turns_device_ms(lambda: call(OS), lambda: call(S), 5)
        t_other, t_this = dev_ms["parent"], dev_ms["change"]
        call_ms = median_ms([lambda: call(OS), lambda: call(S)], reps=10)
        qc, npix = views.shape[1], views.shape[2]
        b_ms, by = bound_ms(*sbs_work(olr, qc, npix, mcut, True, need))
        print(json.dumps({
            "metric": "kernel_vs_parent", "kernel": "sbs_bwd_seq" if mcut is None else "sbs_bwd_mim",
            "path": label, "mcut": mcut, "need_dviews": need, "npix": npix,
            "threads": S._bwd_launch(S._launch_plan(tuple(olr), qc, mcut, True), npix,
                                     torch.cuda.get_device_properties(dev).multi_processor_count)[0],
            "parent_ms": t_other, "ms": t_this, "parent_over_change": t_other / t_this,
            "call_ms": {"parent": call_ms[0], "change": call_ms[1]},
            "bound_ms": b_ms, "bound_by": by, "max_rel_diff_vs_parent": worst,
            "tol": SBS_TOL}), flush=True)

    for layer in (0, 1):
        for ring in (False, True):
            for batch in SBS_BATCHES:
                olr, views, cores, g = sbs_case(S, CSM, dev, layer, ring, batch)
                label = f"layer {layer} {'ring' if ring else 'open'} batch {batch}"
                for mcut in (SBS_MCUT, None):
                    fwd_reading(label, olr, views, cores, mcut)
                for mcut in (SBS_MCUT, None):
                    for need in (True, False):
                        reading(label, olr, views, cores, g, mcut, need)
                del views, cores, g
    olr, views, cores, g = sbs_case(S, CSM, dev, 1, True, 100)
    for mcut in range(1, len(olr)):
        reading("layer 1 ring batch 100", olr, views, cores, g, mcut, True)


def compare_lme(L, OL, dev) -> None:
    """K13 of both checkouts at every case of LME_SHAPES: the product alone,
    and the whole forward (shifts and product)."""
    from dctn_tpu_torch.models import log_space_classifier as LSC
    from dctn_tpu_torch.ops.logmatmulexp import max_shifts

    for label, theta, r, i, offset, neg_inf in LME_SHAPES:
        la, lb = lme_operands(LSC, dev, theta, r, i, offset, neg_inf)
        theta, r, i = la.shape[0], la.shape[1], lb.shape[1]
        amax, bmax = max_shifts(la, lb)
        ref = L.logmatmulexp_fwd_reference(la, lb, amax, bmax)
        shares = {}
        for tree, M in (("change", L), ("parent", OL)):
            err, share = lme_limit_share(M.logmatmulexp_fwd(la, lb, amax, bmax), ref, r, amax, bmax)
            check(share <= 1.0, f"logmatmulexp [{label}] of the {tree} tree: max|d| {err} over "
                  f"its limit ({share:.3f} of it)")
            shares[tree] = share

        def product(M):
            return lambda: M.logmatmulexp_fwd(la, lb, amax, bmax)

        def forward(M):
            def fn():
                with torch.no_grad():
                    return M.logmatmulexp_kernel(la, lb)
            return fn

        dev_ms = {}
        for what, make in (("product", product), ("forward", forward)):
            ts = {"parent": [], "change": []}
            for tree in ("parent", "change", "change", "parent"):
                fn = make(OL if tree == "parent" else L)
                fn()
                ts[tree].append(device_ms_per_call(fn, LME_PROFILE_CALLS, os.devnull)[0])
            dev_ms[what] = {k: sum(v) / 2 for k, v in ts.items()}
        call_other, call_this = median_ms([forward(OL), forward(L)], reps=20)
        flops = 2.0 * theta * r * i
        print(json.dumps({
            "metric": "kernel_vs_parent", "kernel": "logmatmulexp", "path": label,
            "shape": [theta, r, i], "splits": L._splits(theta, r, i),
            "parent_ms": dev_ms["product"]["parent"], "ms": dev_ms["product"]["change"],
            "parent_over_change": dev_ms["product"]["parent"] / dev_ms["product"]["change"],
            "tflops": flops / dev_ms["product"]["change"] / 1e9,
            "forward_device_ms": dev_ms["forward"], "forward_call_ms": {
                "parent": call_other, "change": call_this},
            "bound_ms": bound_ms(4.0 * (theta * r + r * i + theta * i), mm_flops=flops)[0],
            "share_of_limit": shares}), flush=True)
        del la, lb, amax, bmax, ref


def compare_steps(other_dir: str, families) -> None:
    trees = {"parent": os.path.abspath(other_dir), "change": os.path.dirname(os.path.abspath(__file__))}
    done = set()
    for family in families:
        for label, extra in STEPS.get(family, ()):
            if label in done:  # a step that two families share runs once
                continue
            done.add(label)
            for which in ("parent", "change", "change", "parent"):
                proc = subprocess.run([sys.executable, "-m", "dctn_tpu_torch.bench", *extra],
                                      cwd=trees[which], capture_output=True, text=True, timeout=900)
                check(proc.returncode == 0, f"bench {label} in the {which} tree: {proc.stderr[-2000:]}")
                rec = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
                print(json.dumps({"metric": "step_vs_parent", "config": label, "tree": which,
                                  **{k: rec[k] for k in STEP_KEYS if k in rec}}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", metavar="DIR", help="root of the checkout to compare with")
    ap.add_argument("--steps", action="store_true", help="also the bench's steps in both checkouts")
    ap.add_argument("--families", default=",".join(FAMILIES),
                    help="comma-separated families: eps, bf16, ref, q8, sbs, lme (default all)")
    args = ap.parse_args(argv)
    families = [f for f in args.families.split(",") if f]
    if not families or any(f not in FAMILIES for f in families):
        ap.error(f"--families takes some of {FAMILIES}, got {args.families!r}")
    if not torch.cuda.is_available():
        print("compare_parent: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    other = load_other(args.other)
    dev = torch.device("cuda", 0)
    mods = {"eps": "kernels.eps_kernels", "bf16": "kernels.eps_kernels", "ref": "ops.eps",
            "q8": "kernels.eps_q8_kernels", "sbs": "kernels.sbs_kernels",
            "lme": "kernels.logmatmulexp_kernels"}
    runs = {"eps": compare_kernels, "bf16": compare_bf16, "ref": compare_ref, "q8": compare_q8,
            "sbs": compare_sbs, "lme": compare_lme}
    for family in families:
        this = importlib.import_module(f"dctn_tpu_torch.{mods[family]}")
        that = importlib.import_module(f"{other}.{mods[family]}")
        runs[family](this, that, dev)
    if args.steps:
        compare_steps(args.other, families)
    return 0


if __name__ == "__main__":
    sys.exit(main())
