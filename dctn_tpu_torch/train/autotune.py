"""Measured autotuning on the device a run uses (port of
``dctn_tpu/train/autotune.py``): each EPS layer's matmul split, the
``"auto"`` gradient accumulation, and the ConvSBS strings' fold.

**Splits** (``autotune_splits``). Each EPS layer's kernels stage the window
contraction as t = cmt · u with u the Khatri-Rao product of the first n1
factors; n1 fixes the stored (Z, A) cmt parameter's shape. The default split
(``ops.eps._balanced_split``) is the JAX package's TPU cost model, kept so
that both packages store the same shapes. The tuner ranks the legal splits
by ``hopper_split_cost``, measures the ``max_candidates`` cheapest and always
the default one, each as the layer's kernels under the run's objective, and
takes the fastest unless it beats the default by less than ``min_gain``.
Splits are exact re-matricizations of the same core: train states record
theirs (``eps_splits``) and are converted on resume, so a tuned run and a
default run read each other's states.

**Accumulation** (``autotune_grad_accum``). Where the saved-t cap makes
``"auto"`` accumulate (``resolve_auto_grad_accum``), the candidates
cap · 2^k that divide the batch are timed as the real fast train step, and
the fastest is taken.

**ConvSBS** (``autotune_conv_sbs``). Per legacy-model layer the fold family
(meet-in-the-middle or sequential, ``mim``) and the merge position
(``mcut``), greedily, then a whole-model gate over at most 8 combinations of
each layer's best picks. The JAX tuner's other knobs, the pixel tile ``bn``
and the d_core route ``dcore_dot``, served only the TPU
(``kernels/sbs_kernels.py``).

Three behaviours of the JAX tuners are not copied:

- when a layer's heuristic fold fails to run, its ``better()`` can never
  adopt another candidate (autotune.py:943-948); here the fastest candidate
  that ran wins;
- its combination ranking prices a layer's heuristic option at 0 ms
  (autotune.py:1030); here every option is priced at its measured ms;
- its legacy runner exports the training picks (legacy_runner.py:700-730);
  the runners here give an artifact serving-objective picks only.

Timing (``utils.benchmark.timed_ms``): on a card CUDA events after a warm-up
call, windows of ≥ 200 ms of stream time, the better of two; on the CPU the
host clock over one call (the plain versions: a CPU ranking says nothing of
the card, and the cache never stores it under a card's key).

The cache (``default_cache_path``) persists measured picks across runs,
keyed by everything that can change a ranking or the pick rule; a corrupt or
absent file is a miss. A candidate the kernels' planners refuse
(``ValueError``) or that runs out of device memory is recorded as failed and
skipped, unless it is the default, whose failure is the run's; a build or
launch error is raised.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import time
from typing import Callable, Optional

import torch

from ..kernels import eps_kernels as EK
from ..kernels import eps_q8_kernels as Q8
from ..kernels.eps_kernels import _bf16_backward, kernels_take_split, objective_name
from ..ops import eps as eps_mod
from ..utils import fallbacks
from ..utils.benchmark import timed_ms

# Bump when a kernel or planner change invalidates measured rankings
# (entries under another schema are misses, not errors).
_CACHE_SCHEMA = 1
CACHE_ENV = "DCTN_TPU_TORCH_AUTOTUNE_CACHE"
# a candidate's failure that is the candidate's own: a planner's refusal or
# the device's memory
CANDIDATE_FAILURES = (ValueError, torch.cuda.OutOfMemoryError)


def default_cache_path() -> str:
    """``$DCTN_TPU_TORCH_AUTOTUNE_CACHE``, else
    ``~/.cache/dctn_tpu_torch/autotune.json`` (never the JAX package's
    file: its picks are TPU picks)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "dctn_tpu_torch", "autotune.json")


def device_name(device) -> str:
    """The measuring device's name in cache keys: the card's, or "cpu"."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _cache_key(cfg, batch_size, in_channels, *, device, max_candidates, charge_reg, reg_type,
               min_gain, forward_only, quantize) -> str:
    """Everything that can change a measured ranking or the pick rule: the
    device and CUDA version, the layer-shape chain, the per-rank microbatch
    (its pixel count sets the backward's arm), the compute dtype
    (autotune.py:79-82), the objective, the regularizer charged, the pick
    rule's constants and the saved-t planning constants."""
    key = {
        "schema": _CACHE_SCHEMA,
        "device": device_name(device),
        "cuda": torch.version.cuda,
        "epses_specs": [list(s) for s in cfg.epses_specs],
        "image_size": cfg.image_size,
        "q0": cfg.q0,
        "in_channels": in_channels,
        "batch_size": batch_size,
        "compute_dtype": None if cfg.compute_dtype is None else "bfloat16",
        "objective": objective_name(forward_only, quantize, cfg.compute_dtype),
        "reg": reg_type if charge_reg else None,
        "max_candidates": max_candidates,
        "min_gain": min_gain,
        "save_t_min_a": EK.SAVE_T_MIN_A,
        "save_t_max_bytes": EK.SAVE_T_MAX_BYTES,
    }
    return json.dumps(key, sort_keys=True)


def _cache_load(path: str) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}  # absent or corrupt: a miss, never an error


def _cache_store(path: str, key: str, entry: dict) -> None:
    """Read, merge, ``os.replace``: concurrent writers lose at most an
    entry, never the file."""
    try:
        data = _cache_load(path)
        data[key] = entry
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
        os.replace(tmp, path)
    except OSError:
        pass  # a read-only cache directory: caching is best-effort


def _layer_dims(cfg, in_channels: int = 1):
    """Per layer (c, q, h, w, kernel_size, out_size), whatever the splits."""
    c, q, h, w = in_channels, cfg.q0, cfg.image_size, cfg.image_size
    dims = []
    for kernel_size, out_size in cfg.epses_specs:
        dims.append((c, q, h, w, kernel_size, out_size))
        h, w = h - kernel_size + 1, w - kernel_size + 1
        c, q = 1, out_size
    return dims


# ---------------------------------------------------------------------------
# splits

# an H100 SXM's rates at its 700 W limit (NVIDIA's data sheet), as
# chip_smoke.py counts them: float32 on the CUDA cores, the f32 kernels'
# products in 3xTF32 on the tensor cores, the bf16 mode's in dense bf16,
# dense int8, HBM3
_F32_FLOPS = 67e12
_TF32X3_FLOPS = 495e12 / 3
_BF16_FLOPS = 989e12
_INT8_OPS = 1979e12
_HBM_BYTES = 3.35e12


def _pad(x: int, m: int) -> int:
    return -(-x // m) * m


def hopper_split_cost(c: int, q: int, kernel_size: int, n1: int, out_size: int, npix: int,
                      layer_index: int, objective: str, compute_dtype=None) -> float:
    """Seconds one layer at split ``n1`` would take on an H100 under
    ``objective``, from the terms that depend on the split. It is not the
    JAX package's ``_split_cost``, which prices the TPU's 128-wide MXU and
    its vector unit: on Hopper the product's operations, 2·O·q^n per pixel,
    are the same at every n1. What n1 changes here:

    - the operand build: u's A and v's B2 entries a pixel and the sum over
      b of Z = O·B2 products (float32, CUDA cores); the bf16 forward also
      writes u (A rounded up to 64 bf16 values a pixel) to device memory
      and reads it back on its wgmma route (Z > 128);
    - the padding of the product to the kernels' tiles: A to the forward's
      K step (32; int8 and bf16: 64) and Z to its Z tile (128; int8: 256;
      bf16: whole outputs, ⌊128 / B2⌋ a tile of 128 rows where B2 ≤ 128, else
      one in passes of 128; 64 on its mma.sync route, Z ≤ 128:
      ``_fwd_bf16_plan``'s ``rows``), and the backward's 128 × 128 (Z, A)
      tiles of d_cmt and d_u (bf16: 64 × 64);
    - the backward's arm (``plan_backward``): t's Z·npix entries (float32,
      or bf16 under the bf16 objectives) written and read back under the
      4 GiB cap (saved t), or t computed again (recompute);

    each at the card's peak rate for its type (the bf16 objectives'
    products at the dense bf16 rate, and so the backward of ``train-int8``
    under a bf16 ``compute_dtype``, its t at 2 bytes an entry)."""
    _, merge = EK.plan_call(c, q, kernel_size, n1)
    n_k, q_k, n1_k = EK._kernel_dims(c, q, kernel_size, n1, merge)
    a, b2 = q_k**n1_k, q_k ** (n_k - n1_k)
    z = out_size * b2
    bf16 = _bf16_backward(objective, compute_dtype)
    rate, tile, t_bytes = (_BF16_FLOPS, 64, 2) if bf16 else (_TF32X3_FLOPS, 128, 4)
    cost = npix * (a + b2 + 2 * z) / _F32_FLOPS
    if objective.endswith("int8"):
        cost += 2 * _pad(z, 256) * _pad(a, 64) * npix / _INT8_OPS
    elif bf16:
        plan = EK._fwd_bf16_plan(n_k, q_k, n1_k, out_size, npix)
        cost += 2 * plan["rows"] * plan["a_pad"] * npix / rate
        if plan["route"] == "wgmma":  # u through device memory
            cost += 4 * plan["a_pad"] * npix / _HBM_BYTES
    else:
        cost += 2 * _pad(z, tile) * _pad(a, 32) * npix / rate
    if not objective.startswith("train"):
        return cost
    tile_mm = 2 * _pad(z, tile) * _pad(a, tile) * npix / rate
    cost += tile_mm + npix * (a + z) / _F32_FLOPS  # d_cmt and its operands
    arm = EK.plan_backward(layer_index, n_k, n1_k, q_k, out_size, npix, t_bytes)
    if arm == "saved_t":
        cost += 2 * t_bytes * z * npix / _HBM_BYTES + tile_mm + npix * z / _F32_FLOPS
    elif arm == "recompute":
        cost += 2 * tile_mm + npix * z / _F32_FLOPS
    return cost


def legal_splits(c: int, q: int, kernel_size: int, out_size: int, npix: int, layer_index: int,
                 objective: str, device, compute_dtype=None) -> list:
    """The splits a layer can run at: ``split_candidates``, on a card only
    those its kernels take (``kernels_take_split``); the plain versions on
    the CPU take any."""
    n = kernel_size**2 * c
    cands = eps_mod.split_candidates(n, q)
    if torch.device(device).type != "cuda":
        return cands
    return [n1 for n1 in cands
            if kernels_take_split(c, q, kernel_size, n1, out_size, npix, layer_index, objective,
                                  compute_dtype)]


def candidate_splits(c: int, q: int, kernel_size: int, out_size: int, npix: int,
                     layer_index: int, objective: str, max_candidates: int, device,
                     compute_dtype=None) -> list:
    """The legal splits ranked by ``hopper_split_cost`` (ties to the
    smaller n1), cut to the ``max_candidates`` cheapest. The tuner adds the
    default split when it is not among them."""
    legal = legal_splits(c, q, kernel_size, out_size, npix, layer_index, objective, device,
                         compute_dtype)
    legal.sort(key=lambda n1: (hopper_split_cost(c, q, kernel_size, n1, out_size, npix,
                                                 layer_index, objective, compute_dtype), n1))
    return legal[:max_candidates]


def _measure_candidate(c, q, h, w, kernel_size, out_size, n1, batch_size, device, layer_index,
                       generator, forward_only=False, quantize=None, mm_dtype=None) -> float:
    """ms of one layer at one split on ``device``, on random operands (the
    kernels have no data-dependent control flow): the forward and backward
    of ``EPSApplyTCmt`` for training, asking for the input's gradient past
    the first layer so that the d_views kernel runs (K8/K9 with the
    straight-through backward under ``quantize="int8"``); K1 without t for
    f32 serving; K8 for int8 serving. ``mm_dtype`` bf16 measures the
    kernels' bf16 mode, the run's."""
    n1_r, merge = EK.plan_call(c, q, kernel_size, n1)
    if n1_r != n1:
        raise ValueError(f"split n1={n1} is not legal for a layer whose factor pairs merge")
    n_k, q_k, n1_k = EK._kernel_dims(c, q, kernel_size, n1, merge)
    a, z = q_k**n1_k, out_size * q_k ** (n_k - n1_k)
    cmt = (torch.randn((z, a), generator=generator) * a**-0.5).to(device)
    xT = torch.rand((c, q, h, w, batch_size), generator=generator).to(device)
    args = (out_size, kernel_size, n1, merge)
    if forward_only and quantize == "int8":
        wq, sw = Q8.quantize_cmt(cmt)

        def call():
            with torch.inference_mode():
                return Q8.eps_apply_t_q8(wq, sw, xT, *args)

    elif forward_only:

        def call():
            with torch.inference_mode():
                return EK.eps_apply_t_cmt(cmt, xT, *args, layer_index=layer_index,
                                          mm_dtype=mm_dtype)

    else:
        kernels = EK.KERNELS if quantize is None else Q8.QAT_KERNELS
        leaves = [cmt.requires_grad_()] + ([] if layer_index == 0 else [xT.requires_grad_()])

        def call():
            out = EK.eps_apply_t_cmt(cmt, xT, *args, layer_index=layer_index, kernels=kernels,
                                     mm_dtype=mm_dtype)
            return torch.autograd.grad(out.sum(), leaves)

    return timed_ms(call, device)


def _measure_reg_marginal(cfg, plans, layer: int, n1: int, device, generator) -> float:
    """ms of the composition regularizer's forward and backward with layer
    ``layer`` at split ``n1`` (the others at ``plans``' splits): its
    Kronecker powers of the inter-layer Gram matrix have q^(2·n1·m) entries,
    so a split can make the regularizer, not the kernels, the cost."""
    from ..ops.composition import inner_product_cmt

    trial = tuple({**p, "n1": n1} if j == layer else p for j, p in enumerate(plans))
    cmts = []
    for p in trial:
        n_k, q_k, n1_k = EK._kernel_dims(p["c"], p["q"], p["kernel_size"], p["n1"],
                                         p["merge_pairs"])
        a = q_k**n1_k
        shape = (p["out_size"] * q_k ** (n_k - n1_k), a)
        cmts.append((torch.randn(shape, generator=generator) * a**-0.5).to(device)
                    .requires_grad_())

    def call():
        return torch.autograd.grad(inner_product_cmt(cmts, trial), cmts)

    return timed_ms(call, device)


def _cached_plans(cache_path, ckey, base_plans, legal, log):
    """A cached pick for this problem: (plans, report) when every layer's
    split is legal (``legal(i, n1)``), else None."""
    hit = _cache_load(cache_path).get(ckey)
    if hit is None:
        return None
    picks = hit.get("picks", [])
    if len(picks) == len(base_plans) and all(
        isinstance(n1, int) and legal(i, n1) for i, n1 in enumerate(picks)
    ):
        log(f"autotune cache hit ({cache_path}): splits {tuple(picks)} reused without "
            "measuring")
        report = [{**r, "cached": True} for r in hit.get("report", [])]
        return tuple({**p, "n1": n1} for p, n1 in zip(base_plans, picks)), report
    log(f"autotune cache entry at {cache_path} is not legal here (a planner change?): "
        "measuring again")
    return None


def _problem(cfg, batch_size, in_channels, device, reg_type, reg_coeff, forward_only, quantize):
    """(base plans, charge the regularizer?, objective, legal(i, n1))."""
    from ..models.eps_plus_linear import fast_layer_plans

    base_plans = fast_layer_plans(cfg, in_channels)
    charge_reg = reg_type == "epses_composition" and reg_coeff != 0.0 and not forward_only
    objective = objective_name(forward_only, quantize, cfg.compute_dtype)
    dims = _layer_dims(cfg, in_channels)

    def legal(i, n1):
        c, q, h, w, k, o = dims[i]
        npix = batch_size * (h - k + 1) * (w - k + 1)
        return n1 in legal_splits(c, q, k, o, npix, i, objective, device, cfg.compute_dtype)

    return base_plans, charge_reg, objective, legal


def autotune_cache_lookup(cfg, batch_size: int, in_channels: int = 1, *, device="cuda",
                          max_candidates: int = 3, reg_type: str = "epswise",
                          reg_coeff: float = 0.0, min_gain: float = 0.02,
                          forward_only: bool = False, quantize: Optional[str] = None,
                          log_fn: Optional[Callable[[str], None]] = None,
                          cache_path: Optional[str] = None):
    """The lookup-only twin of ``autotune_splits``: (plans, report) when the
    cache holds measured picks for this exact problem, else None; it never
    measures."""
    if not cache_path:
        return None
    device = torch.device(device)
    base_plans, charge_reg, _, legal = _problem(cfg, batch_size, in_channels, device, reg_type,
                                                reg_coeff, forward_only, quantize)
    ckey = _cache_key(cfg, batch_size, in_channels, device=device, max_candidates=max_candidates,
                      charge_reg=charge_reg, reg_type=reg_type, min_gain=min_gain,
                      forward_only=forward_only, quantize=quantize)
    return _cached_plans(cache_path, ckey, base_plans, legal, log_fn or (lambda s: None))


def autotune_splits(cfg, batch_size: int, in_channels: int = 1, *, device="cuda",
                    max_candidates: int = 3, reg_type: str = "epswise", reg_coeff: float = 0.0,
                    min_gain: float = 0.02, forward_only: bool = False,
                    quantize: Optional[str] = None,
                    log_fn: Optional[Callable[[str], None]] = None, seed: int = 0,
                    cache_path: Optional[str] = None):
    """Measure and pick n1 per EPS layer on ``device``. Returns (plans,
    report): ``plans`` as ``fast_layer_plans`` gives them with each layer's
    n1 the measured winner, ``report`` one dict per layer with every
    candidate's row. ``batch_size`` is the per-rank microbatch the step
    runs (its pixel count sets the backward's arm).

    The objective: training f32 (default), QAT (``quantize="int8"``),
    serving f32 (``forward_only``) or serving int8 (both); a bf16
    ``cfg.compute_dtype`` makes the f32 objectives the bf16 mode's
    (``train-bf16``, ``serve-bf16``), measured and planned in it. With the
    ``epses_composition`` regularizer on (``reg_coeff`` ≠ 0) each training
    candidate is also charged its regularizer's marginal ms.

    A winner that beats the default split by less than ``min_gain`` gives
    way to it (a split change moves the stored layout for no shown gain).
    ``cache_path``: reuse and store picks (``_cache_key``)."""
    device = torch.device(device)
    log = log_fn or (lambda s: None)
    base_plans, charge_reg, objective, legal = _problem(
        cfg, batch_size, in_channels, device, reg_type, reg_coeff, forward_only, quantize)
    ckey = None
    if cache_path:
        ckey = _cache_key(cfg, batch_size, in_channels, device=device,
                          max_candidates=max_candidates, charge_reg=charge_reg,
                          reg_type=reg_type, min_gain=min_gain, forward_only=forward_only,
                          quantize=quantize)
        hit = _cached_plans(cache_path, ckey, base_plans, legal, log)
        if hit is not None:
            return hit
    generator = torch.Generator().manual_seed(seed)
    bf16 = {} if cfg.compute_dtype is None else {"mm_dtype": cfg.compute_dtype}
    plans, report = [], []
    for i, ((c, q, h, w, kernel_size, out_size), base) in enumerate(
            zip(_layer_dims(cfg, in_channels), base_plans)):
        npix = batch_size * (h - kernel_size + 1) * (w - kernel_size + 1)
        cands = list(candidate_splits(c, q, kernel_size, out_size, npix, i, objective,
                                      max_candidates, device, cfg.compute_dtype))
        if base["n1"] not in cands:  # the default is always measured
            cands.append(base["n1"])
        rows = []
        for n1 in cands:
            t0 = time.perf_counter()
            try:
                ms = _measure_candidate(c, q, h, w, kernel_size, out_size, n1, batch_size,
                                        device, i, generator, forward_only=forward_only,
                                        quantize=quantize, **bf16)
                row = {"n1": n1, "ms": ms}
                if charge_reg:
                    row["reg_ms"] = _measure_reg_marginal(cfg, base_plans, i, n1, device,
                                                          generator)
                    row["ms"] = ms + row["reg_ms"]
                    row["kernel_ms"] = ms
            except CANDIDATE_FAILURES as e:
                if n1 == base["n1"]:
                    raise
                rows.append({"n1": n1, "failed": type(e).__name__})
                log(f"autotune L{i} n1={n1}: candidate failed ({type(e).__name__}): skipped")
                fallbacks.record(
                    f"autotune layer {i}: split candidate n1={n1} failed ({type(e).__name__}): "
                    "skipped (the winner was chosen among the others)")
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                continue
            rows.append(row)
            log(f"autotune L{i} (K={kernel_size}, Q={q}->O={out_size}) n1={n1}: "
                f"{row['ms']:.3f} ms {objective}"
                + (f" (reg {row['reg_ms']:.3f})" if charge_reg else "")
                + f" (measured in {time.perf_counter() - t0:.1f} s)")
        ok_rows = [r for r in rows if "ms" in r]
        winner = min(ok_rows, key=lambda r: r["ms"])
        default_row = next(r for r in ok_rows if r["n1"] == base["n1"])
        if winner["n1"] != base["n1"] and default_row["ms"] / winner["ms"] < 1.0 + min_gain:
            log(f"autotune L{i}: n1={winner['n1']} only {default_row['ms'] / winner['ms']:.3f}x "
                f"over the default (< {1 + min_gain:.2f}x): keeping n1={base['n1']}")
            winner = default_row
        log(f"autotune L{i}: picked n1={winner['n1']} (default {base['n1']}"
            + (")" if winner["n1"] == base["n1"]
               else f", {default_row['ms'] / winner['ms']:.2f}x over the default)"))
        plans.append({**base, "n1": winner["n1"]})
        report.append({"layer": i, "kernel_size": kernel_size, "q": q, "out_size": out_size,
                       "candidates": rows, "picked_n1": winner["n1"], "model_n1": base["n1"]})
    if cache_path:
        _cache_store(cache_path, ckey, {"picks": [p["n1"] for p in plans], "report": report,
                                        "saved_at": time.strftime("%Y-%m-%dT%H:%M:%S")})
    return tuple(plans), report


# ---------------------------------------------------------------------------
# gradient accumulation


def accum_candidates(cap_pick: int, batch: int, max_extra: int = 2) -> list:
    """cap_pick · 2^k for k = 0, 1, …: those that divide ``batch``, at most
    1 + ``max_extra`` of them, none over ``batch``."""
    cands, s = [], cap_pick
    while s <= batch and len(cands) < 1 + max_extra:
        if batch % s == 0:
            cands.append(s)
        s *= 2
    return cands


def _measure_accum_candidate(cfg, plans, batch: int, accum: int, device, seed: int) -> float:
    """ms of the real fast train step (``make_fast_train_step``, SGD at
    lr 1e-3, the epswise regularizer at 1e-6) at ``accum`` accumulation
    steps, on the theoretical init and random inputs from ``seed``."""
    from ..models.eps_plus_linear import EPSesPlusLinear, init_eps_plus_linear
    from .step import make_fast_train_step

    generator = torch.Generator().manual_seed(seed)
    params = init_eps_plus_linear(generator, cfg)
    model = EPSesPlusLinear.from_reference(params, cfg, device=device, plans=plans)
    x = torch.rand((1, batch, cfg.image_size, cfg.image_size, cfg.q0),
                   generator=generator).to(device)
    y = torch.randint(0, cfg.num_classes, (batch,), generator=generator).to(device)
    optimizer = torch.optim.SGD(model.parameters(), lr=1e-3)
    step = make_fast_train_step(model, optimizer, "epswise", 1e-6, grad_accum_steps=accum)
    return timed_ms(lambda: step(x, y), device)


def autotune_grad_accum(cfg, plans, per_device_batch: int, in_channels: int = 1, *,
                        cap_pick: int, device="cuda", max_extra: int = 2,
                        log_fn: Optional[Callable[[str], None]] = None, seed: int = 0,
                        cache_path: Optional[str] = None) -> int:
    """The measured ``"auto"`` accumulation: where the saved-t cap fired
    (``cap_pick`` > 1), each of ``accum_candidates`` is timed as the real
    step and the fastest is returned (the smallest count that brings the
    saved-t backward back is not always the fastest). ``cap_pick`` ≤ 1, no
    fast plans, or more than one input channel: ``max(1, cap_pick)``
    without measuring."""
    log = log_fn or (lambda s: None)
    if cap_pick <= 1 or plans is None or in_channels != 1:
        return max(1, cap_pick)
    device = torch.device(device)
    cands = accum_candidates(cap_pick, per_device_batch, max_extra)
    if len(cands) <= 1:
        return cap_pick
    ckey = None
    if cache_path:
        key = json.loads(_cache_key(cfg, per_device_batch, in_channels, device=device,
                                    max_candidates=0, charge_reg=False, reg_type="",
                                    min_gain=0.0, forward_only=False, quantize=None))
        key.update(family="grad_accum", cap_pick=cap_pick, splits=[p["n1"] for p in plans])
        ckey = json.dumps(key, sort_keys=True)
        hit = _cache_load(cache_path).get(ckey)
        if hit is not None and hit.get("pick") in cands:
            log(f"grad-accum autotune cache hit: {hit['pick']} (measured earlier)")
            return int(hit["pick"])
    best_s, best_ms, rows = cap_pick, float("inf"), []
    for s in cands:
        t0 = time.perf_counter()
        try:
            step_ms = _measure_accum_candidate(cfg, plans, per_device_batch, s, device, seed)
        except CANDIDATE_FAILURES as e:
            log(f"grad-accum autotune: accum {s} (microbatch {per_device_batch // s}) failed "
                f"({type(e).__name__}): skipped")
            rows.append({"accum": s, "failed": type(e).__name__})
            if device.type == "cuda":
                torch.cuda.empty_cache()
            continue
        rows.append({"accum": s, "step_ms": step_ms})
        log(f"grad-accum autotune: accum {s} (microbatch {per_device_batch // s}) = "
            f"{step_ms:.2f} ms a step (measured in {time.perf_counter() - t0:.1f} s)")
        if step_ms < best_ms:
            best_s, best_ms = s, step_ms
    log(f"grad-accum autotune: picked {best_s} (the saved-t cap said {cap_pick})")
    if ckey:
        _cache_store(cache_path, ckey, {"pick": best_s, "candidates": rows,
                                        "saved_at": time.strftime("%Y-%m-%dT%H:%M:%S")})
    return best_s


# ---------------------------------------------------------------------------
# ConvSBS: per layer (mcut, mim)


def _sbs_layer_dims(cfg):
    """Per legacy-model layer (the first string's spec, (in C, in Q)): a
    layer's strings share their shapes, so one measurement covers them."""
    specs = cfg.layer_specs()
    dims, c, q = [], 1, 2
    for li, layer_spec in enumerate(specs):
        dims.append((layer_spec[0], (c, q)))
        c, q = len(layer_spec), 2 if li < len(specs) - 1 else cfg.num_labels
    return dims


def _sbs_cache_key(cfg, image_size, batch_size, *, forward_only, device) -> str:
    key = {
        "schema": _CACHE_SCHEMA,
        "family": "conv_sbs",
        "device": device_name(device),
        "cuda": torch.version.cuda,
        "num_sbs_layers": cfg.num_sbs_layers,
        "bond_dim_size": cfg.bond_dim_size,
        "trace_edge": cfg.trace_edge,
        "num_labels": cfg.num_labels,
        "image_size": image_size,
        "batch_size": batch_size,
        "objective": "serve" if forward_only else "train",
        "tuner": "greedy-mcut-mim-1",  # bump when the search changes
    }
    return json.dumps(key, sort_keys=True)


def _measure_sbs_candidate(spec, in_c, in_q, h, w, batch_size, device, is_first_layer,
                           generator, forward_only, mim, mcut) -> float:
    """ms of one string's forward (serving) or forward and backward
    (training: d_cores, and d_views past the first layer) at one fold, on
    random operands."""
    from ..kernels.sbs_kernels import conv_sbs_t

    cores = [(0.5 * torch.randn(s.as_tuple(), generator=generator)).to(device)
             for s in spec.shapes]
    xT = torch.rand((in_c, in_q, h, w, batch_size), generator=generator).to(device)
    if forward_only:
        def call():
            with torch.inference_mode():
                return conv_sbs_t(spec, cores, xT, mim=mim, mcut=mcut)
    else:
        leaves = [c.requires_grad_() for c in cores] + ([] if is_first_layer
                                                        else [xT.requires_grad_()])

        def call():
            out = conv_sbs_t(spec, cores, xT, mim=mim, mcut=mcut)
            return torch.autograd.grad(out.sum(), leaves)

    return timed_ms(call, device)


def _measure_sbs_model(cfg, tuning, image_size, batch_size, device, forward_only,
                       generator) -> float:
    """ms of the whole legacy model's forward (serving) or forward and
    backward (training) under ``kernel_tuning=tuning``: the composition
    check the per-layer search cannot make."""
    import dataclasses

    from ..models.conv_sbs_model import conv_sbs_model_forward_t, init_conv_sbs_model

    cfg_m = dataclasses.replace(cfg, kernel_tuning=tuple(tuning))
    params = tuple(tuple(tuple(c.to(device) for c in s) for s in layer)
                   for layer in init_conv_sbs_model(generator, cfg_m))
    x = torch.rand((batch_size, image_size, image_size), generator=generator).to(device)
    if forward_only:
        def call():
            with torch.inference_mode():
                return conv_sbs_model_forward_t(params, cfg_m, x)
    else:
        leaves = [c.requires_grad_() for layer in params for s in layer for c in s]

        def call():
            loss = torch.tanh(conv_sbs_model_forward_t(params, cfg_m, x)).sum()
            return torch.autograd.grad(loss, leaves)

    return timed_ms(call, device)


def _legal_sbs_pick(pick, P: int) -> bool:
    """A cached (mcut, mim): a family, and a merge position within the
    string (or none)."""
    if pick is None:
        return True
    if len(pick) != 2 or not isinstance(pick[1], bool):
        return False
    return pick[0] is None or (isinstance(pick[0], int) and 1 <= pick[0] < P)


def _sbs_cached(cfg, cache_path: str, ckey: str, log):
    """A cached (kernel_tuning, report) for this problem whose every pick
    is legal, else None."""
    hit = _cache_load(cache_path).get(ckey)
    picks = hit.get("picks", []) if isinstance(hit, dict) else []
    if len(picks) != cfg.num_sbs_layers:
        return None
    tuning = tuple(tuple(p) if p else None for p in picks)
    if not all(_legal_sbs_pick(p, len(spec.shapes))
               for p, (spec, _) in zip(tuning, _sbs_layer_dims(cfg))):
        log(f"conv_sbs autotune cache entry at {cache_path} is not legal: measuring again")
        return None
    log(f"conv_sbs autotune cache hit ({cache_path}): {tuning} reused without measuring")
    return tuning, [{**r, "cached": True} for r in hit.get("report", [])]


def conv_sbs_cache_lookup(cfg, image_size: int, batch_size: int, *, device="cuda",
                          forward_only: bool = False,
                          log_fn: Optional[Callable[[str], None]] = None,
                          cache_path: Optional[str] = None):
    """The lookup-only twin of ``autotune_conv_sbs``: the cached
    kernel_tuning for this exact problem, or None; it never measures."""
    if not cache_path:
        return None
    ckey = _sbs_cache_key(cfg, image_size, batch_size, forward_only=forward_only,
                          device=torch.device(device))
    hit = _sbs_cached(cfg, cache_path, ckey, log_fn or (lambda s: None))
    return None if hit is None else hit[0]


def autotune_conv_sbs(cfg, image_size: int, batch_size: int, *, device="cuda",
                      forward_only: bool = False, min_gain: float = 0.05,
                      log_fn: Optional[Callable[[str], None]] = None, seed: int = 0,
                      cache_path: Optional[str] = None):
    """Measure and pick each legacy-model layer's fold on ``device``.
    Returns (kernel_tuning, report): ``kernel_tuning`` for
    ``ConvSBSModelConfig.kernel_tuning``, one ``(mcut, mim)`` or None (the
    heuristic) per layer; ``report`` every candidate and the gate.

    Per layer, each stage keeping the incumbent unless a candidate beats it
    by ``min_gain``: the family (the heuristic's, ``_mim_cut``, against the
    other), then the merge position, walked from the heuristic's in the
    improving direction until gains stop. When a pick deviates, the whole
    model is timed at the heuristics and at up to 8 combinations of each
    layer's two fastest picks (ranked by their measured ms summed), and the
    best must beat the heuristics by ``min_gain`` or every pick goes. A
    layer whose heuristic fold fails takes the fastest fold that ran."""
    from ..kernels.sbs_kernels import _mim_cut, sbs_supported

    device = torch.device(device)
    log = log_fn or (lambda s: None)
    dims = _sbs_layer_dims(cfg)
    ckey = None
    if cache_path:
        ckey = _sbs_cache_key(cfg, image_size, batch_size, forward_only=forward_only,
                              device=device)
        hit = _sbs_cached(cfg, cache_path, ckey, log)
        if hit is not None:
            return hit

    generator = torch.Generator().manual_seed(seed)
    objective = "fwd" if forward_only else "fwd+bwd"
    picks, report, options = [], [], []

    def better(candidate_ms, incumbent_ms):
        # an incumbent that failed gives way to any candidate that ran
        return candidate_ms is not None and (
            incumbent_ms is None or incumbent_ms / candidate_ms >= 1.0 + min_gain)

    for li, (spec, (in_c, in_q)) in enumerate(dims):
        h = w = image_size - 2 * li  # each 3×3 snake layer takes 2 rows off
        olr, _, supported = sbs_supported(spec)
        if device.type == "cuda" and not supported:
            picks.append(None)
            options.append([(None, 0.0)])
            report.append({"layer": li, "skipped": "spec outside the kernels' scope"})
            continue
        mcut0 = _mim_cut(olr)
        heuristic = (mcut0, mcut0 is not None)
        measured, rows = {}, []

        def measure(mim, mcut, li=li, spec=spec, in_c=in_c, in_q=in_q, h=h, w=w):
            tag = (mcut, mim)
            if tag in measured:
                return measured[tag]
            t0 = time.perf_counter()
            try:
                ms = _measure_sbs_candidate(spec, in_c, in_q, h, w, batch_size, device, li == 0,
                                            generator, forward_only, mim, mcut)
            except CANDIDATE_FAILURES as e:
                log(f"conv_sbs autotune L{li} mim={mim} mcut={mcut}: failed "
                    f"({type(e).__name__}): skipped")
                measured[tag] = None
                rows.append({"mim": mim, "mcut": mcut, "failed": type(e).__name__})
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                return None
            measured[tag] = ms
            rows.append({"mim": mim, "mcut": mcut, "ms": ms})
            log(f"conv_sbs autotune L{li} mim={mim} mcut={mcut}: {ms:.3f} ms {objective} "
                f"(measured in {time.perf_counter() - t0:.1f} s)")
            return ms

        # stage 1: the family, each at its own merge position
        mim = heuristic[1]
        base_ms = measure(mim, mcut0 if mim else None)
        alt_ms = measure(not mim, mcut0 if not mim else None)
        if better(alt_ms, base_ms):
            mim, base_ms = not mim, alt_ms
        mcut = (mcut0 if mcut0 is not None else max(1, len(olr) // 2)) if mim else None
        # stage 2: the merge position, walked in the improving direction
        if mim and mcut is not None:
            for direction in (-1, +1):
                moved, mcut_c = False, mcut + direction
                while 1 <= mcut_c < len(olr):
                    ms_c = measure(True, mcut_c)
                    if not better(ms_c, base_ms):
                        break
                    mcut, base_ms, moved = mcut_c, ms_c, True
                    mcut_c += direction
                if moved:
                    break  # the other direction can only be worse
        pick = (mcut, mim)
        pick = None if pick == heuristic else pick
        picks.append(pick)
        log(f"conv_sbs autotune L{li}: picked {pick} (heuristic {heuristic})")
        report.append({"layer": li, "candidates": rows, "picked": pick,
                       "heuristic": list(heuristic), "best_ms": base_ms})
        # the gate's options: the heuristic and the two fastest picks, each
        # at its own measured ms (a heuristic that failed sorts last)
        h_ms = measured.get(heuristic)
        opts, seen = [(None, math.inf if h_ms is None else h_ms)], {None}
        for r in sorted((r for r in rows if "ms" in r), key=lambda r: r["ms"])[:2]:
            p = (r["mcut"], r["mim"])
            p = None if p == heuristic else p
            if p not in seen:
                seen.add(p)
                opts.append((p, r["ms"]))
        options.append(opts)

    if any(picks):
        def model_ms(tuning):
            try:
                return _measure_sbs_model(cfg, tuning, image_size, batch_size, device,
                                          forward_only, generator)
            except CANDIDATE_FAILURES as e:
                log(f"conv_sbs autotune whole model {tuple(tuning)}: failed "
                    f"({type(e).__name__})")
                if device.type == "cuda":
                    torch.cuda.empty_cache()
                return None

        ms_h = model_ms(())
        log(f"conv_sbs autotune whole model at the heuristics: {ms_h} ms")
        combos = sorted((c for c in itertools.product(*options) if any(p for p, _ in c)),
                        key=lambda c: sum(ms for _, ms in c))[:8]
        best_combo, best_ms = None, None
        for combo in combos:
            tuning = tuple(p for p, _ in combo)
            ms_c = model_ms(tuning)
            log(f"conv_sbs autotune whole model {tuning}: {ms_c} ms")
            if ms_c is not None and (best_ms is None or ms_c < best_ms):
                best_combo, best_ms = tuning, ms_c
        if best_combo is None or (ms_h is not None and ms_h / best_ms < 1.0 + min_gain):
            log("conv_sbs autotune: no combination beats the heuristics: keeping them")
            picks, best_ms = [None] * len(picks), ms_h
        else:
            picks = list(best_combo)
            log(f"conv_sbs autotune: whole-model winner {best_combo} ({ms_h} -> {best_ms} ms)")
        report.append({"whole_model": {"heuristic_ms": ms_h, "best_ms": best_ms,
                                       "kept": bool(any(picks))}})
    tuning = tuple(tuple(p) if p else None for p in picks)
    if ckey:
        _cache_store(cache_path, ckey, {"picks": [list(p) if p else None for p in tuning],
                                        "report": report,
                                        "saved_at": time.strftime("%Y-%m-%dT%H:%M:%S")})
    return tuning, report
