"""The data-, tensor- and spatial-parallel paths and SP×TP on several cards:
the torch counterpart of the JAX package's multichip dry run
(``__graft_entry__.py::dryrun_multichip``, its DP, TP, SP and SP×TP paths
in ``MULTICHIP_r05.json``), with the times of each.

    python -m dctn_tpu_torch.multichip --devices 4 [--profile DIR]
    python -m dctn_tpu_torch.multichip --devices 2 --device cpu --small   # gloo rehearsal

N ranks, one per card (``parallel.spawn``, NCCL), run in turn:

- ``dp_xla``: the reference-layout step (plain ``eps``, the xla backend) on
  N ranks against one card's step on the concatenated batch, and the
  sharded score against one card's;
- ``dp_fast_cmt(+dropout,+grad_accum=2)``: the fast step with parameter
  dropout (the same masks on every rank) and 2 microbatches a rank;
- ``dp_qat_int8_train``: the QAT step, its saved-t arm decided on the
  global pixel count;
- ``conv_sbs_dp_train(+sharded_score)``: the ConvSBS pixel step and score.

Each is held against one card on the concatenated batch: the first step's
gradients from one init (after the all-reduce) within ``DP_TOL`` of each
parameter's largest entry; then 3 SGD steps at per-parameter lrs set from
those gradients, with finite losses, after which every rank's parameters
equal rank 0's bit for bit and rank 0's moves match one card's taking the
same steps within ``TRAJ_TOL``; the scores within ``SCORE_TOL``. A failed
check is reported at once and the run goes on, then exits nonzero without
its last line. Then the times: the flagship ``(4,4),(3,6)``
f32 and QAT steps at 128 images a card (global 128·N) against one card at
128, the deep ``(4,4),(3,12),(2,24)`` step at 512 a card (global 512·N)
against one card at 512·N, and the 2-layer bond-4 ConvSBS step at global
512, open and ring, against one card at 512: step ms p50 (CUDA events on
rank 0), images/s, the scaling efficiency of the EPS steps (images/s on N
÷ N × images/s on one at the per-card batch; the deep step also beside one
card at the global batch) and the ConvSBS steps' speedup over one card at
the global batch, an isolated all-reduce of the step's gradient buffer, and with
``--profile`` the device time per step of the NCCL kernels and of all
kernels on rank 0 under ``torch.profiler`` (the NCCL kernel's time
includes its wait for the slowest rank) and the device's idle share.

Then the TP and SP paths on grids of the same ranks (``parallel.make_grid``;
TP (N/2 data, 2 model), SP (N/2, 2) and from 4 ranks (1, N)), each held
against one card on the whole batch as above (``tp_last_core``: the
reference layout's last core sharded, xla; ``tp_shard_all``: every core,
each layer on the kernels' route of ``ops.eps``; ``tp_fast_cmt_pallas`` and
``tp_qat_int8_train``: the last cmt's row block, f32 and int8;
``sp_halo_exchange``: the reference layout, xla; ``sp_fast_cmt_pallas(+dropout)``
on both SP grids; ``sp_qat_int8_train``): a TP model's gradients and moves
gathered over its model group, every replicated parameter equal on every
rank and every shard on the ranks of its model coordinate. Then their
times: the flagship f32 and QAT steps at 128 a data rank on the TP and the
(N/2, 2) SP grid (f32 also on (1, N)), and the deep model at global 2048 on
(1, N), each beside one card at the data rank's batch (and at the global
batch): step ms p50, images/s, launches per step, each card's peak memory,
the deep model's layer-1 arm, and with ``--profile`` the NCCL kernels' and
all kernels' device ms a step and the idle share on rank 0.

From 4 ranks, SP×TP on the (N/4 data, 2 space, 2 model) grid
(``parallel.make_sp_tp_grid``), checked as the TP paths are:
``sp_x_tp_composed`` (the reference layout, the xla backend),
``sp_x_tp_fast_cmt_pallas(+dropout)`` (the kernels on each slab and row
block) and ``sp_x_tp_qat_int8_train``; then their times, the flagship f32
and QAT steps at 128 a data rank beside one card and beside SP (1, N) at the
same global batch, and the deep model at global 2048.

Then the bf16 operand mode (``compute_dtype`` bf16) on the same grids, each
path held against one card in bf16: ``dp_qat_int8_train_bf16`` (the DP QAT
step, K9 storing its t in bf16), and the f32 paths' layout and QAT on TP
(N/2, 2), SP (N/2, 2) and, from 4 ranks, SP×TP (N/4, 2, 2)
(``tp_fast_cmt_pallas_bf16``, ``tp_qat_int8_train_bf16``, ``sp_…_bf16``,
``sp_x_tp_…_bf16``; with a model axis at BF16_MODEL_AXIS_TOL); and their
times at 128 a data rank beside one card in bf16.

Then, in this process, with a replica on each card (``parallel.replicas``):
``dp_sharded_predict`` and ``dp_sharded_predict_int8`` (``predict.run
--mesh-devices N`` at global batch 512 beside one card; every replica's
logits equal replica 0's on the same images, bit for bit),
``dp_sharded_export_serving`` (a sharded flagship artifact, ``export.run
--mesh-devices N``, served by ``serve.ArtifactModel``) and
``conv_sbs_artifact_serving`` (the ConvSBS cores the ranks trained, as a
sharded artifact over N cards) and ``sp_sharded_export_serving`` (the
height-sharded artifact, ``export.run --space-devices S`` at S = 2 and,
from 4 cards, 4, by bands of rows, against one card's artifact in the call:
logits, p50 at batch 128, served and predicted from), and the same in bf16
(``sp_sharded_export_serving_bf16``, against one card's bf16 artifact).

One JSON line per path with its checks and times; the last line is
``{"ok": true, "paths": [...]}``. Any failed check exits nonzero before it.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FLAGSHIP = ((4, 4), (3, 6))
DEEP = ((4, 4), (3, 12), (2, 24))
SMALL = ((2, 4), (2, 3))
# the grid paths' small model: every O divides a model axis of 2
SMALL_GRID = ((2, 4), (2, 4))
# every gradient of the first step, DP against one card on the concatenated
# batch, as a share of the parameter's largest entry: the two sum the
# cross-entropy's gradient over other partitions of the pixels (per rank,
# then the all-reduce), in f32 with 3xTF32 products (~2^-22 relative each)
DP_TOL = 1e-4
# mean CE and accuracy, sharded score against one card: CE summed per shard
# (f32) then over the shards (f64)
SCORE_TOL = 1e-5
# the checks' steps: the first at lr 0 (its gradients are compared), then
# CHECK_STEPS of SGD whose lr moves each parameter's largest-gradient entry
# by REL_STEP of the parameter's largest entry: small enough for every
# model's steps to stay finite (the flagship's init has a CE of ~140, and
# the ConvSBS model's CE leaves 2.3 for 33 and then NaN at 1e-2 on 4 CPU
# ranks), large enough for each move to be far above float32 spacing
CHECK_STEPS = 3
REL_STEP = 1e-3
# each parameter's move over those steps, the ranks' against one card's from
# the same lrs, as an L2 gap relative to one card's move: the moves are sums
# of lr·gradient, whose gaps are the gradients' (DP_TOL at the largest entry,
# far less in L2); a rank that masks, steps or scales otherwise gives O(1).
# Read on 4 gloo CPU ranks at these shapes (the plain versions): gradient
# gaps 1.8e-7 to 7.7e-7, move gaps 5.8e-6 to 1.3e-5
TRAJ_TOL = 1e-3
# the height-sharded artifact's logits against one card's artifact of the
# same npz, as a share of the largest logit: each band's layer rows are the
# whole layers' (the same kernels on the same pixels), and only the
# classifier's sum runs in another order (over S partial products, then
# the bias); float32 sums of 3,174 products each, ~1e-6 of the largest
ARTIFACT_TOL = 1e-5
# the bf16 paths with a model axis (TP, SP×TP) against one card in bf16,
# gradients and moves alike, as a share of the largest entry: the early
# cores are replicated, and each model rank's d_cmt of them rounds kr2 =
# g·v of its partial cotangent to bf16 before the sum over ``model`` (as
# the JAX TP step does), where one card rounds the whole cotangent once:
# each of the M + 1 roundings is at most half a bf16 step (2^-9) of the
# operand, so at most (M + 1)·2^-9 = 6e-3 of the largest entry at M = 2. The
# paths without a model axis (DP, SP) round each pixel's operands from the
# same float32 values up to the order of the sums, and keep DP_TOL and
# TRAJ_TOL.
BF16_MODEL_AXIS_TOL = 6e-3

# every failed check of this process, in order (``check``)
_FAILED: list = []


def check(ok: bool, what: str) -> bool:
    """Records a failed check (on stderr at once) and goes on, so that one
    run reports every check and every time; a run with a failed check exits
    nonzero at its end and prints no result."""
    if not ok:
        _FAILED.append(what)
        print(f"multichip check failed: {what}", file=sys.stderr, flush=True)
    return ok


def emit(mesh, record: dict) -> None:
    if mesh is None or mesh.is_primary:
        print(json.dumps(record), flush=True)


def sizes(small: bool) -> dict:
    """The shapes of the checks and the timed steps (``small``: a CPU
    rehearsal)."""
    if small:
        return dict(specs=SMALL, check_b=4, time_b=8, steps=3, warmup=1, deep=None, deep_b=0,
                    sbs_bond=2, sbs_global=16, predict_b=16, sbs_layers=2,
                    grid_specs=SMALL_GRID, deep_sp_global=0)
    return dict(specs=FLAGSHIP, check_b=16, time_b=128, steps=30, warmup=3, deep=DEEP,
                deep_b=512, sbs_bond=4, sbs_global=512, predict_b=512, sbs_layers=2,
                grid_specs=FLAGSHIP, deep_sp_global=2048)


# ---------------------------------------------------------------------------
# in the ranks


def _data(specs, n: int, seed: int = 0):
    from .data import load_dataset

    sp = load_dataset("fashionmnist", "synthetic", autoscale_kernel_size=specs[0][0],
                      synthetic_sizes=(n, 4, max(n // 2, 4))).train
    return sp.x, sp.y.astype(np.int64)


def _grads_agree(dp, one, what: str, tol: float = DP_TOL) -> float:
    """The largest gap between the DP step's gradient of a parameter (after
    its all-reduce) and one card's on the concatenated batch, from the same
    parameters, as a share of one card's largest entry of it (checked
    against ``tol``, DP_TOL by default)."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(dp, one)):
        scale = float(b.abs().max())
        if check(scale > 0, f"{what}: parameter {i} has no gradient"):
            gap = float((a.double() - b.double()).abs().max()) / scale
            worst = max(worst, gap if np.isfinite(gap) else float("inf"))
    check(worst <= tol, f"{what}: gradients differ by {worst:.3e} of the largest > {tol}")
    return worst


def _grads(model):
    return [p.grad.detach().clone() for p in model.parameters()]


def _sgd(model) -> torch.optim.SGD:
    """SGD with a group for each parameter, at lr 0 until ``_set_lrs``."""
    return torch.optim.SGD([{"params": [p]} for p in model.parameters()], lr=0.0)


def _set_lrs(opt, lrs) -> None:
    for group, lr in zip(opt.param_groups, lrs):
        group["lr"] = lr


def _step_lrs(model, grads) -> list:
    """Each parameter's lr for the moving steps: REL_STEP of its largest
    entry over its largest gradient entry."""
    lrs = []
    for p, g in zip(model.parameters(), grads):
        top = float(g.abs().max())
        lrs.append(REL_STEP * float(p.detach().abs().max()) / top if top > 0 else 0.0)
    return lrs


def _ranks_agree(mesh, model, what: str) -> bool:
    """Every rank's parameters equal rank 0's, bit for bit: the f64 sum and
    largest magnitude of each, gathered from every rank."""
    digest = torch.stack([torch.stack([p.detach().double().sum(), p.detach().double().abs().max()])
                          for p in model.parameters()])
    rows = mesh.all_gather_cat(digest[None])
    return check(bool((rows == rows[:1]).all()),
                 f"{what}: the ranks' parameters differ after {CHECK_STEPS} steps")


def _moves_agree(init, dp, one, what: str, tol: float = TRAJ_TOL) -> float:
    """The largest L2 gap between a parameter's move on the ranks and on one
    card, from the same parameters and lrs, relative to one card's move
    (checked against ``tol``, TRAJ_TOL by default)."""
    worst = 0.0
    for i, (p0, a, b) in enumerate(zip(init, dp, one)):
        da, db = a.detach().double() - p0.double(), b.detach().double() - p0.double()
        norm = float(db.norm())
        if check(norm > 0 and np.isfinite(norm), f"{what}: parameter {i} did not move on one card"):
            gap = float((da - db).norm()) / norm
            worst = max(worst, gap if np.isfinite(gap) else float("inf"))
    check(worst <= tol, f"{what}: moves differ by {worst:.3e} (L2) > {tol}")
    return worst


def _trajectory(mesh, model, opt, step, one_card, what: str, tols=(DP_TOL, TRAJ_TOL)) -> dict:
    """The checks' run: ``step()`` (the DP step on this rank's sub-batch →
    the ranks' mean loss) once at lr 0, whose gradients rank 0 holds
    against one card's on the concatenated batch (DP_TOL); then CHECK_STEPS
    steps at the lrs ``_step_lrs`` sets from those gradients, after which
    every rank's parameters must equal rank 0's and rank 0's moves those of
    one card taking the same steps at the same lrs (TRAJ_TOL; ``tols``
    gives both bounds). ``one_card()`` → (model, optimizer, step) of one
    card, run on rank 0."""
    from .bench import read_counters, read_sbs_counters, zero_counters

    zero_counters()
    first = float(step())
    grads = _grads(model)
    lrs = _step_lrs(model, grads)
    _set_lrs(opt, lrs)
    init = [p.detach().clone() for p in model.parameters()]
    losses = [first] + [float(step()) for _ in range(CHECK_STEPS)]
    launches = {**read_counters(), **read_sbs_counters()}
    rec = {"losses": losses, "launches_per_step": {
        k: v / (CHECK_STEPS + 1) for k, v in launches.items() if v}}
    check(all(np.isfinite(losses)), f"{what}: non-finite DP loss {losses}")
    rec["ranks_equal"] = _ranks_agree(mesh, model, what)
    if mesh.is_primary:
        one, opt1, step1 = one_card()
        rec["one_card_loss"] = float(step1())
        rec["gradient_gap"] = _grads_agree(grads, _grads(one), what, tols[0])
        _set_lrs(opt1, lrs)
        for _ in range(CHECK_STEPS):
            step1()
        rec["trajectory_gap"] = _moves_agree(init, list(model.parameters()),
                                             list(one.parameters()), what, tols[1])
    mesh.barrier()
    return rec


def _fast_check(mesh, z, qat=None, dropout=False, accum=1, bf16=False) -> dict:
    """DP fast (or QAT) step on the ranks against one card's on the
    concatenated batch (``bf16``: both with bf16 operands)."""
    from .models import EPSesPlusLinear, EPSesPlusLinearConfig, init_eps_plus_linear
    from .models.eps_plus_linear import draw_dropout_masks
    from .parallel import make_parallel_fast_train_step
    from .train import make_fast_train_step

    dev, w, b = mesh.device, mesh.world_size, z["check_b"]
    p = 0.9 if dropout else 1.0
    cfg = EPSesPlusLinearConfig(epses_specs=z["specs"], image_size=28, q0=2, dropout_p=p,
                                compute_dtype=torch.bfloat16 if bf16 else None)
    params = init_eps_plus_linear(torch.Generator().manual_seed(1), cfg,
                                  "unit_theoretical_output_std", dev)
    x, y = _data(z["specs"], w * b)
    xg, yg = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    model = EPSesPlusLinear.from_reference(params, cfg)
    masks = None
    if dropout:  # one draw, on every rank and the one-card step alike
        masks = draw_dropout_masks(model.plans, p, torch.Generator(device=dev).manual_seed(5))
    opt = _sgd(model)
    step = make_parallel_fast_train_step(model, opt, mesh, "epswise", 1e-4, qat=qat,
                                         grad_accum_steps=accum)
    xs, ys = xg[:, mesh.rank * b : (mesh.rank + 1) * b], yg[mesh.rank * b : (mesh.rank + 1) * b]

    def one_card():
        one = EPSesPlusLinear.from_reference(params, cfg)
        opt1 = _sgd(one)
        step1 = make_fast_train_step(one, opt1, "epswise", 1e-4, qat=qat)
        return one, opt1, lambda: step1(xg, yg, masks=None if masks is None else [masks])["loss"]

    return _trajectory(mesh, model, opt,
                       lambda: step(xs, ys, masks=None if masks is None else [masks] * accum)["loss"],
                       one_card, f"fast qat={qat} dropout={dropout} accum={accum}"
                       + (" bf16" if bf16 else ""))


def _xla_check(mesh, z) -> dict:
    """The reference-layout DP step and the sharded score against one card."""
    from .models import EPSesPlusLinearConfig, EPSesPlusLinearReference, init_eps_plus_linear
    from .models.eps_plus_linear import eps_plus_linear_forward
    from .parallel import make_parallel_score_fn, make_parallel_train_step, shard_split
    from .train import make_score_fn, make_train_step

    dev, w, b = mesh.device, mesh.world_size, max(z["check_b"] // 4, 2)
    cfg = EPSesPlusLinearConfig(epses_specs=z["specs"], image_size=28, q0=2)
    params = init_eps_plus_linear(torch.Generator().manual_seed(2), cfg,
                                  "unit_theoretical_output_std", dev)
    x, y = _data(z["specs"], w * b + 3)  # a split the ranks do not divide
    xg, yg = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    model = EPSesPlusLinearReference(params, cfg).to(dev)
    opt = _sgd(model)
    step = make_parallel_train_step(model, opt, mesh, "epses_composition", 1e-4)
    sl = slice(mesh.rank * b, (mesh.rank + 1) * b)

    def one_card():
        one = EPSesPlusLinearReference(params, cfg).to(dev)
        opt1 = _sgd(one)
        step1 = make_train_step(one, opt1, "epses_composition", 1e-4)
        return one, opt1, lambda: step1(xg[:, : w * b], yg[: w * b])["loss"]

    rec = _trajectory(mesh, model, opt, lambda: step(xg[:, sl], yg[sl])["loss"], one_card, "xla")

    def fwd(p, xb):
        return eps_plus_linear_forward(p, xb, cfg)

    # scored at the init, whose logits are of order 1 (the steps' may not be)
    score = make_parallel_score_fn(cfg, None, mesh, b, forward_fn=fwd)
    ce, acc = (float(v) for v in score(params, shard_split(mesh, x, y)))
    check(np.isfinite(ce), f"sharded score at the init: mean CE {ce}")
    rec["score"] = [ce, acc]
    if mesh.is_primary:
        ce1, acc1 = (float(v) for v in make_score_fn(cfg, None, b, forward_fn=fwd)(
            params, xg, yg))
        rec["one_card_score"] = [ce1, acc1]
        check(abs(ce - ce1) <= SCORE_TOL * max(1.0, abs(ce1)) and acc == acc1,
              f"sharded score {ce, acc} != one card's {ce1, acc1}")
    mesh.barrier()
    return rec


def _sbs_model(z, dev, trace_edge=False, seed=3):
    """The legacy runner's recipe (``--cos-sin-squared
    --make-input-window-std-one --scale-layers-using-batch 100``):
    Khrulkov-normal cores, the window-std input multiplier and every layer
    scaled to unit output std on 100 images, so that its logits are O(1)."""
    from .models.conv_sbs_model import (
        ConvSBSModel,
        ConvSBSModelConfig,
        calc_std_of_coordinates_of_windows,
        init_conv_sbs_model,
        scale_layers_using_batch,
    )

    x = _sbs_data(100, dev)[0]
    std = float(calc_std_of_coordinates_of_windows(x.cpu(), 3, True, 1.0))
    cfg = ConvSBSModelConfig(num_sbs_layers=z["sbs_layers"], bond_dim_size=z["sbs_bond"],
                             trace_edge=trace_edge, cos_sin_squared=True,
                             input_multiplier=std ** (-1.0 / 9.0))
    params = init_conv_sbs_model(torch.Generator().manual_seed(seed), cfg)
    params = tuple(tuple(tuple(c.to(dev) for c in s) for s in layer) for layer in params)
    return ConvSBSModel(scale_layers_using_batch(params, cfg, x), cfg), cfg


def _sbs_data(n: int, dev):
    from .data import io as data_io

    images, labels = data_io.synthetic_mnist_like(n, seed=1234)
    return (torch.as_tensor(images, device=dev),
            torch.as_tensor(labels.astype(np.int64), device=dev), images, labels)


def _sbs_check(mesh, z):
    """The ConvSBS pixel step and the sharded score against one card."""
    from .parallel import make_parallel_pixel_score_fn, make_parallel_pixel_train_step
    from .parallel import replicate, shard_pixel_split

    dev, w, b = mesh.device, mesh.world_size, z["check_b"]
    model, cfg = _sbs_model(z, dev)
    replicate(mesh, model.parameters())  # rank 0's scaled cores, as the runner does
    xg, yg, images, labels = _sbs_data(w * b + 3, dev)
    opt = _sgd(model)
    step = make_parallel_pixel_train_step(model, opt, mesh)
    sl = slice(mesh.rank * b, (mesh.rank + 1) * b)

    def one_card():
        one, _ = _sbs_model(z, dev)
        opt1 = _sgd(one)

        def step1():
            opt1.zero_grad(set_to_none=True)
            loss = torch.nn.functional.cross_entropy(one(xg[: w * b]), yg[: w * b])
            loss.backward()
            opt1.step()
            return loss.detach()

        return one, opt1, step1

    rec = _trajectory(mesh, model, opt, lambda: step(xg[sl], yg[sl]), one_card, "conv_sbs")
    score = make_parallel_pixel_score_fn(lambda _, xb: model(xb), mesh, b)
    ce, acc = (float(v) for v in score(None, shard_pixel_split(mesh, images, labels)))
    check(np.isfinite(ce), f"sharded ConvSBS score: mean CE {ce}")
    rec["score"] = [ce, acc]
    if mesh.is_primary:
        with torch.no_grad():
            logits = model(xg)
            ce1 = float(torch.nn.functional.cross_entropy(logits, yg))
            acc1 = float((logits.argmax(1) == yg).float().mean())
        rec["one_card_score"] = [ce1, acc1]
        check(abs(ce - ce1) <= SCORE_TOL * max(1.0, abs(ce1)) and acc == acc1,
              f"sharded ConvSBS score {ce, acc} != one card's {ce1, acc1}")
    mesh.barrier()
    cores = [[[c.detach().cpu() for c in s] for s in layer] for layer in model.params()]
    return rec, cores, cfg


def _timed(step, steps: int, warmup: int, dev) -> tuple:
    """(per-step ms, window s) of ``steps`` calls after ``warmup``: CUDA
    events around each step and the window (host clock on the CPU)."""
    for _ in range(warmup):
        step()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    per, t_start = [], time.perf_counter()
    for _ in range(steps):
        if cuda:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            step()
            b.record()
            per.append((a, b))
        else:
            t0 = time.perf_counter()
            step()
            per.append(1e3 * (time.perf_counter() - t0))
    if cuda:
        torch.cuda.synchronize(dev)
        per = [a.elapsed_time(b) for a, b in per]
    return per, time.perf_counter() - t_start


def _profile(step, steps: int, dev, out):
    """torch.profiler over ``steps`` calls on this rank: (device ms per step
    of the NCCL kernels, of all kernels, wall ms per step under the
    profiler, whose host work slows the steps)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # the profiler drops a window's device events now and then
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                step()
            torch.cuda.synchronize(dev)
        wall = 1e3 * (time.perf_counter() - t0) / steps
        rows = [(e.key, e.self_device_time_total / 1e3 / steps) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)]
        if rows:
            break
    check(bool(rows), "torch.profiler showed no device time")
    if out:
        with open(out, "w") as f:
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=30))
    nccl = sum(ms for k, ms in rows if "nccl" in k.lower())
    return nccl, sum(ms for _, ms in rows), wall


def _profiled(step, dev, out, step_ms: float) -> dict:
    """The profile's rows of a timed step: the NCCL kernels' and all
    kernels' device ms per step, and the device's idle share of the step's
    p50 timed without the profiler."""
    nccl, busy, wall = _profile(step, 10, dev, out)
    return {"nccl_ms_per_step": nccl, "device_busy_ms_per_step": busy,
            "wall_ms_per_step_profiled": wall, "device_idle_share": 1 - busy / step_ms}


def _allreduce_ms(mesh, numel: int, reps: int = 20) -> float:
    """p50 of an all-reduce of ``numel`` f32 values alone (CUDA events on
    this rank; host clock on the CPU)."""
    buf = torch.ones(numel, device=mesh.device)
    per, _ = _timed(lambda: mesh.all_reduce_(buf), reps, 3, mesh.device)
    return statistics.median(per)


def _time_eps(mesh, z, name, specs, b, qat, opts):
    """Times the DP step at ``b`` images a rank and one card at ``b`` (and,
    for the deep model, at the global batch)."""
    from .models import EPSesPlusLinear, EPSesPlusLinearConfig, init_eps_plus_linear
    from .parallel import make_parallel_fast_train_step
    from .train import make_fast_train_step, make_optimizer

    dev, w = mesh.device, mesh.world_size
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=28, q0=2)
    params = init_eps_plus_linear(torch.Generator().manual_seed(0), cfg,
                                  "unit_theoretical_output_std", dev)
    x, y = _data(specs, b)
    xs, ys = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    reg = ("epses_composition", 0.1) if specs == DEEP else ("epswise", 1e-6)
    lr = 1e-3 if specs == DEEP else 3e-3
    model = EPSesPlusLinear.from_reference(params, cfg)
    opt = make_optimizer("adam", model.parameters(), lr)
    step = make_parallel_fast_train_step(model, opt, mesh, *reg, qat=qat)
    steps = z["steps"] if specs != DEEP else 5
    per, window = _timed(lambda: step(xs, ys), steps, z["warmup"], dev)
    grads = sum(p.numel() for p in model.parameters())
    rec = {"path": name, "world_size": w, "per_card_batch": b, "global_batch": w * b,
           "qat": qat, "step_ms_p50": statistics.median(per),
           "images_per_s": w * b * steps / window, "gradient_values": grads,
           "allreduce_ms_isolated_p50": _allreduce_ms(mesh, grads + 1)}
    if opts.profile and dev.type == "cuda":
        out = (os.path.join(opts.profile, f"profile_{name}_rank{mesh.rank}.txt")
               if mesh.is_primary else None)
        rec.update(_profiled(lambda: step(xs, ys), dev, out, rec["step_ms_p50"]))
    del model, opt, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # one card: rank 0 alone, the others waiting
    one_sizes = [b] + ([w * b] if specs == DEEP and w > 1 else [])
    if mesh.is_primary:
        for bb in one_sizes:
            x1, y1 = _data(specs, bb)
            x1, y1 = torch.as_tensor(x1, device=dev), torch.as_tensor(y1, device=dev)
            one = EPSesPlusLinear.from_reference(params, cfg)
            opt1 = make_optimizer("adam", one.parameters(), lr)
            step1 = make_fast_train_step(one, opt1, *reg, qat=qat)
            per1, window1 = _timed(lambda: step1(x1, y1), min(steps, 3 if bb > 1024 else steps),
                                   min(z["warmup"], 2), dev)
            rec[f"one_card_bs{bb}_step_ms_p50"] = statistics.median(per1)
            rec[f"one_card_bs{bb}_images_per_s"] = bb * len(per1) / window1
            del one, opt1, step1
        rec["scaling_efficiency"] = rec["images_per_s"] / (w * rec[f"one_card_bs{b}_images_per_s"])
    mesh.barrier()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def _time_sbs(mesh, z, trace_edge, opts):
    """The ConvSBS DP step at a global batch of ``sbs_global`` against one
    card at that batch."""
    from .parallel import make_parallel_pixel_train_step, replicate

    dev, w = mesh.device, mesh.world_size
    b = z["sbs_global"] // w
    model, _ = _sbs_model(z, dev, trace_edge)
    replicate(mesh, model.parameters())
    xg, yg, _, _ = _sbs_data(z["sbs_global"], dev)
    sl = slice(mesh.rank * b, (mesh.rank + 1) * b)
    opt = torch.optim.SGD(model.parameters(), lr=1e-3)
    step = make_parallel_pixel_train_step(model, opt, mesh)
    per, window = _timed(lambda: step(xg[sl], yg[sl]), z["steps"], z["warmup"], dev)
    name = f"conv_sbs_step_{'ring' if trace_edge else 'open'}"
    rec = {"path": name, "world_size": w, "per_card_batch": b, "global_batch": w * b,
           "step_ms_p50": statistics.median(per), "images_per_s": w * b * z["steps"] / window}
    if opts.profile and dev.type == "cuda":
        out = (os.path.join(opts.profile, f"profile_{name}.txt") if mesh.is_primary else None)
        rec.update(_profiled(lambda: step(xg[sl], yg[sl]), dev, out, rec["step_ms_p50"]))
    if mesh.is_primary:
        one, _ = _sbs_model(z, dev, trace_edge)
        opt1 = torch.optim.SGD(one.parameters(), lr=1e-3)

        def step1():
            opt1.zero_grad(set_to_none=True)
            torch.nn.functional.cross_entropy(one(xg), yg).backward()
            opt1.step()

        per1, window1 = _timed(step1, z["steps"], z["warmup"], dev)
        rec["one_card_step_ms_p50"] = statistics.median(per1)
        rec["one_card_images_per_s"] = z["sbs_global"] * z["steps"] / window1
        rec["speedup_over_one_card"] = rec["images_per_s"] / rec["one_card_images_per_s"]
    mesh.barrier()
    return rec


# ---------------------------------------------------------------------------
# tensor and spatial parallelism on grids of the ranks


def _grids(n: int):
    """The TP grid, (n/2 data, 2 model), the SP grids, (n/2 data, 2 space)
    and, from 4 ranks, (1 data, n space), and from 4 ranks the SP×TP grid
    (n/4 data, 2 space, 2 model), or None."""
    return ((n // 2, 2), [(n // 2, 2)] + ([(1, n)] if n > 2 else []),
            (n // 4, 2, 2) if n >= 4 else None)


def _keyed(model) -> dict:
    """One card's parameters by train-state key."""
    from .train.checkpoint import _param_names

    return dict(_param_names(model))


def _tp_whole(model, of_grad: bool) -> dict:
    """The TP model group's parameters (or their gradients) gathered, by
    train-state key, in one card's layout (every rank of the group calls)."""
    from .parallel.tensor_parallel import _full

    out = {}
    for key, p, dim in model.shards():
        t = _full(p.grad if of_grad else p, dim, model.mesh)
        out[key] = t.reshape(-1, model.cfg.num_classes) if key == "linear/w" else t
    return out


def _tp_trajectory(g, model, opt, step, one_card, what: str, tols=(DP_TOL, TRAJ_TOL)) -> dict:
    """``_trajectory`` for a TP model: the first step's gradients gathered
    over the model group against one card's (DP_TOL), each shard's lr from
    its whole parameter's, CHECK_STEPS steps; then every replicated
    parameter equal on every rank and every shard equal on the ranks of
    its model coordinate, bit for bit, and the gathered moves against one
    card's (TRAJ_TOL)."""
    from .bench import read_counters, zero_counters

    zero_counters()
    first = float(step())
    grads, params = _tp_whole(model, True), _tp_whole(model, False)
    lrs = {}
    for key in grads:
        top = float(grads[key].abs().max())
        lrs[key] = REL_STEP * float(params[key].abs().max()) / top if top > 0 else 0.0
    key_of = {id(p): key for key, p, _ in model.shards()}
    for group in opt.param_groups:
        group["lr"] = lrs[key_of[id(group["params"][0])]]
    init = {k: v.clone() for k, v in params.items()}
    losses = [first] + [float(step()) for _ in range(CHECK_STEPS)]
    launches = read_counters()
    rec = {"losses": losses, "launches_per_step": {
        k: v / (CHECK_STEPS + 1) for k, v in launches.items() if v}}
    check(all(np.isfinite(losses)), f"{what}: non-finite loss {losses}")
    digest = torch.stack([torch.stack([p.detach().double().sum(), p.detach().double().abs().max()])
                          for _, p, _ in model.shards()])
    rows = g.all_gather_cat(digest[None])
    same = []
    for i, (_, _, dim) in enumerate(model.shards()):
        peers = [r for r in range(g.world_size)
                 if dim is None or r % g.size("model") == g.index("model")]
        same.append(bool((rows[peers, i] == rows[g.rank, i]).all()))
    rec["ranks_equal"] = check(all(same), f"{what}: the ranks' parameters differ after "
                                          f"{CHECK_STEPS} steps")
    final = _tp_whole(model, False)
    if g.is_primary:
        one, opt1, step1 = one_card()
        rec["one_card_loss"] = float(step1())
        named = _keyed(one)
        rec["gradient_gap"] = _grads_agree([grads[k] for k in named],
                                           [p.grad for p in named.values()], what, tols[0])
        for group in opt1.param_groups:
            group["lr"] = lrs[next(k for k, p in named.items() if p is group["params"][0])]
        for _ in range(CHECK_STEPS):
            step1()
        rec["trajectory_gap"] = _moves_agree([init[k] for k in named], [final[k] for k in named],
                                             list(named.values()), what, tols[1])
    g.barrier()
    return rec


def _grid_problem(z, dev, n_data, b, specs=None, dropout_p=1.0, seed=1, bf16=False):
    from .models import EPSesPlusLinearConfig, init_eps_plus_linear

    specs = specs or z["grid_specs"]
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=28, q0=2, dropout_p=dropout_p,
                                compute_dtype=torch.bfloat16 if bf16 else None)
    params = init_eps_plus_linear(torch.Generator().manual_seed(seed), cfg,
                                  "unit_theoretical_output_std", dev)
    x, y = _data(specs, n_data * b)
    return cfg, params, x, y


def _tp_check(mesh, z, dims, kind, bf16=False) -> dict:
    """A TP step on a (data, model) grid against one card's on the whole
    batch: ``kind`` "last_xla" (the reference layout, the last core sharded,
    the xla backend), "shard_all_pallas" (every core sharded, each layer on
    the kernels' route of ``ops.eps``), "fast" or "qat" (the fast layout's
    row block, f32 or int8); ``bf16``: both sides with bf16 operands, held
    at BF16_MODEL_AXIS_TOL."""
    from .models import EPSesPlusLinear, EPSesPlusLinearReference
    from .models.eps_plus_linear import fast_params_from_reference
    from .parallel import (TPFastModel, TPModel, make_grid, make_tp_fast_params,
                           make_tp_fast_train_step, make_tp_params, make_tp_train_step)
    from .train import make_fast_train_step, make_train_step

    g = make_grid(mesh, "model", *dims)
    dev, b = mesh.device, z["check_b"]
    cfg, params, x, y = _grid_problem(z, dev, g.n_data, b, bf16=bf16)
    xg, yg = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    sl = slice(g.data_index * b, (g.data_index + 1) * b)
    qat = "int8" if kind == "qat" else None
    if kind in ("fast", "qat"):
        fast, plans = fast_params_from_reference(params, cfg)
        model = TPFastModel(make_tp_fast_params(fast, cfg, g), plans, cfg, g)
        opt = _sgd(model)
        step = make_tp_fast_train_step(model, opt, "epswise", 1e-4, qat=qat)

        def one_card():
            one = EPSesPlusLinear.from_reference(params, cfg)
            opt1 = _sgd(one)
            step1 = make_fast_train_step(one, opt1, "epswise", 1e-4, qat=qat)
            return one, opt1, lambda: step1(xg, yg)["loss"]
    else:
        shard_all = kind == "shard_all_pallas"
        model = TPModel(make_tp_params(params, cfg, g, shard_all), cfg, g, shard_all)
        opt = _sgd(model)
        step = make_tp_train_step(model, opt, "epses_composition", 1e-4,
                                  backend="pallas" if shard_all else "xla")

        def one_card():
            one = EPSesPlusLinearReference(params, cfg).to(dev)
            opt1 = _sgd(one)
            step1 = make_train_step(one, opt1, "epses_composition", 1e-4)
            return one, opt1, lambda: step1(xg, yg)["loss"]

    tols = (BF16_MODEL_AXIS_TOL,) * 2 if bf16 else (DP_TOL, TRAJ_TOL)
    rec = _tp_trajectory(g, model, opt, lambda: step(xg[:, sl], yg[sl])["loss"], one_card,
                         f"tp {kind}{' bf16' if bf16 else ''} grid {dims}", tols)
    return {"grid": {"data": dims[0], "model": dims[1]}, **rec}


def _sp_check(mesh, z, dims, kind, bf16=False) -> dict:
    """An SP step on a (data, space) grid against one card's on the whole
    batch: ``kind`` "halo_xla" (the reference layout, the xla backend),
    "fast_dropout" (the fast layout's kernels on each slab, parameter
    dropout at p = 0.9 with one draw everywhere), "fast" (without dropout)
    or "qat"; ``bf16``: both sides with bf16 operands."""
    from .models import EPSesPlusLinear, EPSesPlusLinearReference
    from .models.eps_plus_linear import draw_dropout_masks
    from .parallel import make_grid, make_sp_fast_train_step, make_sp_train_step, sp_shard_batch
    from .train import make_fast_train_step, make_train_step

    g = make_grid(mesh, "space", *dims)
    dev, b = mesh.device, z["check_b"]
    p = 0.9 if kind == "fast_dropout" else 1.0
    cfg, params, x, y = _grid_problem(z, dev, g.n_data, b, dropout_p=p, bf16=bf16)
    xg, yg = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    xs, ys = sp_shard_batch(g, x, y)
    masks = None
    qat = "int8" if kind == "qat" else None
    if kind == "halo_xla":
        model = EPSesPlusLinearReference(params, cfg).to(dev)
        opt = _sgd(model)
        step = make_sp_train_step(model, opt, g, "epses_composition", 1e-4)

        def one_card():
            one = EPSesPlusLinearReference(params, cfg).to(dev)
            opt1 = _sgd(one)
            step1 = make_train_step(one, opt1, "epses_composition", 1e-4)
            return one, opt1, lambda: step1(xg, yg)["loss"]
    else:
        model = EPSesPlusLinear.from_reference(params, cfg)
        if p < 1.0:
            masks = draw_dropout_masks(model.plans, p, torch.Generator(device=dev).manual_seed(5))
        opt = _sgd(model)
        step = make_sp_fast_train_step(model, opt, g, "epswise", 1e-4, qat=qat)

        def one_card():
            one = EPSesPlusLinear.from_reference(params, cfg)
            opt1 = _sgd(one)
            step1 = make_fast_train_step(one, opt1, "epswise", 1e-4, qat=qat)
            return one, opt1, lambda: step1(xg, yg, masks=None if masks is None else [masks])[
                "loss"]

    rec = _trajectory(g, model, opt, lambda: step(xs, ys, masks=None if masks is None else [
        masks])["loss"], one_card, f"sp {kind}{' bf16' if bf16 else ''} grid {dims}")
    return {"grid": {"data": dims[0], "space": dims[1]}, **rec}


def _sp_tp_check(mesh, z, dims, kind, bf16=False) -> dict:
    """An SP×TP step on a (data, space, model) grid against one card's on
    the whole batch: ``kind`` "xla" (the reference layout, the last core
    sharded, the xla backend), "fast_dropout" (the fast layout's kernels on
    each slab and row block, parameter dropout at p = 0.9 with one draw
    everywhere), "fast" (without dropout) or "qat"; ``bf16``: both sides
    with bf16 operands, held at BF16_MODEL_AXIS_TOL."""
    from .models import EPSesPlusLinear, EPSesPlusLinearReference
    from .models.eps_plus_linear import draw_dropout_masks, fast_params_from_reference
    from .parallel import (TPFastModel, TPModel, make_sp_tp_fast_train_step, make_sp_tp_grid,
                           make_sp_tp_train_step, make_tp_fast_params, make_tp_params,
                           sp_tp_shard_batch)
    from .train import make_fast_train_step, make_train_step

    g = make_sp_tp_grid(mesh, *dims)
    dev, b = mesh.device, z["check_b"]
    p = 0.9 if kind == "fast_dropout" else 1.0
    cfg, params, x, y = _grid_problem(z, dev, g.n_data, b, dropout_p=p, bf16=bf16)
    xg, yg = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    xs, ys = sp_tp_shard_batch(g, x, y)
    masks = None
    qat = "int8" if kind == "qat" else None
    if kind == "xla":
        model = TPModel(make_tp_params(params, cfg, g), cfg, g)
        opt = _sgd(model)
        step = make_sp_tp_train_step(model, opt, "epses_composition", 1e-4)

        def one_card():
            one = EPSesPlusLinearReference(params, cfg).to(dev)
            opt1 = _sgd(one)
            step1 = make_train_step(one, opt1, "epses_composition", 1e-4)
            return one, opt1, lambda: step1(xg, yg)["loss"]
    else:
        fast, plans = fast_params_from_reference(params, cfg)
        model = TPFastModel(make_tp_fast_params(fast, cfg, g), plans, cfg, g)
        if p < 1.0:
            masks = draw_dropout_masks(plans, p, torch.Generator(device=dev).manual_seed(5))
        opt = _sgd(model)
        step = make_sp_tp_fast_train_step(model, opt, "epswise", 1e-4, qat=qat)

        def one_card():
            one = EPSesPlusLinear.from_reference(params, cfg)
            opt1 = _sgd(one)
            step1 = make_fast_train_step(one, opt1, "epswise", 1e-4, qat=qat)
            return one, opt1, lambda: step1(xg, yg, masks=None if masks is None else [masks])[
                "loss"]

    tols = (BF16_MODEL_AXIS_TOL,) * 2 if bf16 else (DP_TOL, TRAJ_TOL)
    rec = _tp_trajectory(g, model, opt, lambda: step(xs, ys, masks=None if masks is None else [
        masks])["loss"], one_card, f"sp x tp {kind}{' bf16' if bf16 else ''} grid {dims}", tols)
    return {"grid": dict(zip(("data", "space", "model"), dims)), **rec}


def _time_grid(mesh, z, name, axis, dims, specs, b, qat, opts, global_batch=None,
               bf16=False) -> dict:
    """Times the fast-layout step on a grid at ``b`` images a data rank (or
    at ``global_batch``), beside one card at ``b`` (and at the global
    batch): step ms p50, images/s, launches per step, the saved-t arm of
    each layer, each card's peak memory, and with ``--profile`` the NCCL
    kernels' and all kernels' device ms a step and the idle share.
    ``bf16``: both with bf16 operands."""
    from .bench import read_counters, zero_counters
    from .kernels import eps_kernels as K
    from .models import EPSesPlusLinear, EPSesPlusLinearConfig, init_eps_plus_linear
    from .models.eps_plus_linear import _plan_dims, fast_params_from_reference
    from .parallel import (TPFastModel, make_grid, make_sp_fast_train_step,
                           make_sp_tp_fast_train_step, make_sp_tp_grid, make_tp_fast_params,
                           make_tp_fast_train_step, sp_shard_batch)
    from .train import make_fast_train_step, make_optimizer

    g = make_sp_tp_grid(mesh, *dims) if axis == "sp_tp" else make_grid(mesh, axis, *dims)
    dev = mesh.device
    cuda = dev.type == "cuda"
    deep = specs == DEEP
    batch = global_batch or g.n_data * b
    b = batch // g.n_data
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=28, q0=2,
                                compute_dtype=torch.bfloat16 if bf16 else None)
    params = init_eps_plus_linear(torch.Generator().manual_seed(0), cfg,
                                  "unit_theoretical_output_std", dev)
    x, y = _data(specs, batch)
    reg = ("epses_composition", 0.1) if deep else ("epswise", 1e-6)
    lr = 1e-3 if deep else 3e-3
    if axis == "sp_tp":
        fast, plans = fast_params_from_reference(params, cfg)
        model = TPFastModel(make_tp_fast_params(fast, cfg, g), plans, cfg, g)
        opt = make_optimizer("adam", model.parameters(), lr)
        step = make_sp_tp_fast_train_step(model, opt, *reg, qat=qat)
        xs, ys = sp_shard_batch(g, x, y)
    elif axis == "model":
        fast, plans = fast_params_from_reference(params, cfg)
        model = TPFastModel(make_tp_fast_params(fast, cfg, g), plans, cfg, g)
        opt = make_optimizer("adam", model.parameters(), lr)
        step = make_tp_fast_train_step(model, opt, *reg, qat=qat)
        sl = slice(g.data_index * b, (g.data_index + 1) * b)
        xs = torch.as_tensor(x[:, sl], device=dev)
        ys = torch.as_tensor(y[sl], device=dev)
    else:
        model = EPSesPlusLinear.from_reference(params, cfg)
        opt = make_optimizer("adam", model.parameters(), lr)
        step = make_sp_fast_train_step(model, opt, g, *reg, qat=qat)
        xs, ys = sp_shard_batch(g, x, y)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    zero_counters()
    step(xs, ys)
    launches = read_counters()
    steps = 5 if deep else z["steps"]
    per, window = _timed(lambda: step(xs, ys), steps, 1 if deep else z["warmup"], dev)
    rec = {"path": name, "grid": dict(zip(("data", "space", "model"), g.dims)),
           "per_data_rank_batch": b,
           "global_batch": batch, "qat": qat, "compute_dtype": "bfloat16" if bf16 else "float32",
           "step_ms_p50": statistics.median(per),
           "images_per_s": batch * steps / window,
           "launches_per_step": {k: v for k, v in launches.items() if v},
           # layer 0 never saves t; a later layer that launches K1+t reads it
           "saved_t_layers_launched": (launches["eps_fwd_t"] + launches["eps_fwd_q8_t"]
                                       + launches["eps_fwd_t_bf16"]),
           "recompute_layers_launched": (launches["eps_dviews_recompute"]
                                         + launches["eps_dviews_recompute_bf16"])}
    if cuda:
        rec["peak_memory_gib"] = g.all_gather_object(
            torch.cuda.max_memory_allocated(dev) / 2**30)
    if deep:
        # layer 1's arm under the cap on t, on this rank's pixels (its rows)
        p1 = model.plans[1]
        n_k, q_k, n1_k = _plan_dims(p1)
        w1 = 28 - specs[0][0] - specs[1][0] + 2
        npix = b * (xs.shape[2] if axis != "model" else w1) * w1
        rec["layer1_local_pixels"] = npix
        rec["layer1_arm"] = K.plan_backward(1, n_k, n1_k, q_k, p1["out_size"], npix)
        rec["layer1_t_gib"] = p1["out_size"] * q_k ** (n_k - n1_k) * npix * 4 / 2**30
    if opts.profile and cuda:
        out = (os.path.join(opts.profile, f"profile_{name}_rank{mesh.rank}.txt")
               if mesh.is_primary else None)
        rec.update(_profiled(lambda: step(xs, ys), dev, out, rec["step_ms_p50"]))
    del model, opt, step
    if cuda:
        torch.cuda.empty_cache()
    one_sizes = [b] + ([batch] if batch != b else [])
    if mesh.is_primary:
        for bb in one_sizes:
            x1, y1 = (torch.as_tensor(a[..., :bb] if a.ndim == 1 else a[:, :bb], device=dev)
                      for a in (x, y))
            one = EPSesPlusLinear.from_reference(params, cfg)
            opt1 = make_optimizer("adam", one.parameters(), lr)
            step1 = make_fast_train_step(one, opt1, *reg, qat=qat)
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            per1, window1 = _timed(lambda: step1(x1, y1), 3 if bb > 1024 else steps,
                                   1 if bb > 1024 else min(z["warmup"], 2), dev)
            rec[f"one_card_bs{bb}_step_ms_p50"] = statistics.median(per1)
            rec[f"one_card_bs{bb}_images_per_s"] = bb * len(per1) / window1
            if cuda:
                rec[f"one_card_bs{bb}_peak_memory_gib"] = (
                    torch.cuda.max_memory_allocated(dev) / 2**30)
            del one, opt1, step1
            if cuda:
                torch.cuda.empty_cache()
    g.barrier()
    return rec


def _grid_paths(mesh, z, opts) -> tuple:
    """The TP and SP paths' checks and times on this rank; rank 0 prints
    the records. Returns (paths, times)."""
    tp_dims, sp_dims, st_dims = _grids(mesh.world_size)
    paths, times = [], []
    for kind, name in (("last_xla", "tp_last_core"), ("shard_all_pallas", "tp_shard_all"),
                       ("fast", "tp_fast_cmt_pallas"), ("qat", "tp_qat_int8_train")):
        emit(mesh, {"path": name, **_tp_check(mesh, z, tp_dims, kind)})
        paths.append(name)
    emit(mesh, {"path": "sp_halo_exchange", **_sp_check(mesh, z, sp_dims[0], "halo_xla")})
    paths.append("sp_halo_exchange")
    for dims in sp_dims:
        emit(mesh, {"path": "sp_fast_cmt_pallas(+dropout)",
                    **_sp_check(mesh, z, dims, "fast_dropout")})
    paths.append("sp_fast_cmt_pallas(+dropout)")
    emit(mesh, {"path": "sp_qat_int8_train", **_sp_check(mesh, z, sp_dims[-1], "qat")})
    paths.append("sp_qat_int8_train")
    if st_dims is not None:
        for kind, name in (("xla", "sp_x_tp_composed"),
                           ("fast_dropout", "sp_x_tp_fast_cmt_pallas(+dropout)"),
                           ("qat", "sp_x_tp_qat_int8_train")):
            emit(mesh, {"path": name, **_sp_tp_check(mesh, z, st_dims, kind)})
            paths.append(name)
    # the bf16 operand mode on each grid, the f32 paths' layout and QAT
    for kind in ("fast", "qat"):
        tag = "fast_cmt_pallas" if kind == "fast" else "qat_int8_train"
        for name, check_fn, dims in ((f"tp_{tag}_bf16", _tp_check, tp_dims),
                                     (f"sp_{tag}_bf16", _sp_check, sp_dims[0]),
                                     (f"sp_x_tp_{tag}_bf16", _sp_tp_check, st_dims)):
            if dims is None:
                continue
            emit(mesh, {"path": name, "compute_dtype": "bfloat16",
                        **check_fn(mesh, z, dims, kind, bf16=True)})
            paths.append(name)
    b = z["time_b"]
    for qat in (None, "int8"):
        tag = "qat" if qat else "f32"
        times.append(_time_grid(mesh, z, f"tp_flagship_{tag}_step", "model", tp_dims,
                                z["grid_specs"], b, qat, opts))
        times.append(_time_grid(mesh, z, f"sp_flagship_{tag}_step", "space", sp_dims[0],
                                z["grid_specs"], b, qat, opts))
    if len(sp_dims) > 1:
        times.append(_time_grid(mesh, z, "sp_flagship_f32_step", "space", sp_dims[1],
                                z["grid_specs"], b, None, opts))
    if st_dims is not None:
        # the flagship at the same global batch on (1, n) SP and on SP×TP
        times.append(_time_grid(mesh, z, "sp_flagship_qat_step", "space", sp_dims[1],
                                z["grid_specs"], b, "int8", opts))
        for qat in (None, "int8"):
            times.append(_time_grid(mesh, z, f"sp_x_tp_flagship_{'qat' if qat else 'f32'}_step",
                                    "sp_tp", st_dims, z["grid_specs"], b, qat, opts))
    for qat in (None, "int8"):
        tag = "qat" if qat else "f32_layout"
        for name, axis, dims in ((f"tp_flagship_{tag}_bf16_step", "model", tp_dims),
                                 (f"sp_flagship_{tag}_bf16_step", "space", sp_dims[0]),
                                 (f"sp_x_tp_flagship_{tag}_bf16_step", "sp_tp", st_dims)):
            if dims is not None:
                times.append(_time_grid(mesh, z, name, axis, dims, z["grid_specs"], b, qat, opts,
                                        bf16=True))
    if z["deep"] is not None:
        times.append(_time_grid(mesh, z, "deep_sp_step", "space", sp_dims[-1], z["deep"], 0,
                                None, opts, global_batch=z["deep_sp_global"]))
        if st_dims is not None:
            times.append(_time_grid(mesh, z, "deep_sp_x_tp_step", "sp_tp", st_dims, z["deep"], 0,
                                    None, opts, global_batch=z["deep_sp_global"]))
    for t in times:
        emit(mesh, {"metric": "grid_step_time", **t})
    return paths, times


def _rank_paths(mesh, opts) -> dict:
    """Every rank's share of the DP paths; rank 0 prints the records."""
    z = sizes(opts.small)
    paths = []
    rec = _xla_check(mesh, z)
    emit(mesh, {"path": "dp_xla", **rec})
    paths.append("dp_xla")
    rec = _fast_check(mesh, z, dropout=True, accum=2)
    emit(mesh, {"path": "dp_fast_cmt(+dropout,+grad_accum=2)", **rec})
    paths.append("dp_fast_cmt(+dropout,+grad_accum=2)")
    rec = _fast_check(mesh, z, qat="int8")
    emit(mesh, {"path": "dp_qat_int8_train", **rec})
    paths.append("dp_qat_int8_train")
    rec = _fast_check(mesh, z, qat="int8", bf16=True)
    emit(mesh, {"path": "dp_qat_int8_train_bf16", "compute_dtype": "bfloat16", **rec})
    paths.append("dp_qat_int8_train_bf16")
    rec, cores, sbs_cfg = _sbs_check(mesh, z)
    emit(mesh, {"path": "conv_sbs_dp_train(+sharded_score)", **rec})
    paths.append("conv_sbs_dp_train(+sharded_score)")
    grid_paths, grid_times = _grid_paths(mesh, z, opts)
    paths += grid_paths
    times = [_time_eps(mesh, z, "flagship_f32_step", z["specs"], z["time_b"], None, opts),
             _time_eps(mesh, z, "flagship_qat_step", z["specs"], z["time_b"], "int8", opts)]
    if z["deep"] is not None:
        times.append(_time_eps(mesh, z, "deep_step", z["deep"], z["deep_b"], None, opts))
    times += [_time_sbs(mesh, z, False, opts), _time_sbs(mesh, z, True, opts)]
    for t in times:
        emit(mesh, {"metric": "dp_step_time", **t})
    failed = [f"rank {r}: {what}" for r, whats in enumerate(mesh.all_gather_object(_FAILED))
              for what in whats]
    return {"paths": paths, "times": times + grid_times, "sbs_cores": cores, "sbs_cfg": sbs_cfg,
            "failed": failed}


# ---------------------------------------------------------------------------
# in this process: a replica on each card


def _replicas_bit_equal(replicas, devices, x, axis) -> bool:
    """Every replica's output on its chunk equals replica 0's on the same
    chunk, bit for bit (the same kernels on the same operands)."""
    chunks = torch.tensor_split(x, len(replicas), dim=axis)
    with torch.inference_mode():
        for fn, dev, c in zip(replicas, devices, chunks):
            if not torch.equal(fn(c.to(dev)).cpu(), replicas[0](c.to(devices[0])).cpu()):
                return False
    return True


def _predict_paths(n: int, z, device: str, tmp: str) -> list:
    from .bench import read_counters, zero_counters
    from .cli import export, predict, serve
    from .models import EPSesPlusLinearConfig, init_eps_plus_linear
    from .parallel.replicas import ShardedForward
    from .train import save_params_npz

    specs, bs = z["specs"], z["predict_b"]
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=28, q0=2)
    ckpt = os.path.join(tmp, "eps.npz")
    save_params_npz(init_eps_plus_linear(torch.Generator().manual_seed(0), cfg), ckpt)
    common = dict(checkpoint=ckpt, ds_type="fashionmnist", ds_path="synthetic",
                  epses_specs=specs, batch_size=bs, latency_bench=True, device=device,
                  synthetic_sizes=(64, 16, 2 * bs))
    out = []
    for quantize, name in (("none", "dp_sharded_predict"), ("int8", "dp_sharded_predict_int8")):
        zero_counters()
        many = predict.run(**common, quantize=quantize, mesh_devices=n)
        launches = {k: v for k, v in read_counters().items() if v}
        one = predict.run(**common, quantize=quantize)
        devices = [torch.device(device, i) if device == "cuda" else torch.device("cpu")
                   for i in range(n)]
        equal = _replicas_bit_equal(many.model, devices, many.x[:, :bs], 1)
        agree = float((many.preds == one.preds).mean())
        check(equal, f"{name}: a replica's logits differ from replica 0's")
        check(agree >= 0.999, f"{name}: predictions agree with one card on {agree}")
        lat = {s["batch_size"]: s for s in many.latency}
        lat1 = {s["batch_size"]: s for s in one.latency}
        rec = {"path": name, "devices": n, "replicas_bit_equal": equal,
               "agreement_with_one_card": agree, "launches": launches,
               "p50_ms": {b_: lat[b_]["p50_ms"] for b_ in lat},
               "one_card_p50_ms": {b_: lat1[b_]["p50_ms"] for b_ in lat1},
               "pipelined_img_per_s": lat[bs]["pipelined_throughput_img_per_s"],
               "one_card_pipelined_img_per_s": lat1[bs]["pipelined_throughput_img_per_s"]}
        print(json.dumps(rec), flush=True)
        out.append(name)
        if quantize == "none":
            f32 = many
    # the sharded artifact of the same model, served
    art = os.path.join(tmp, "eps_sharded.zip")
    export.run(checkpoint=ckpt, epses_specs=specs, batch_sizes=(n, bs), mesh_devices=n,
               device=device, out=art)
    meta, fns = export.load_artifact(art)
    x = f32.x[:, :bs]
    with torch.inference_mode():
        eager = ShardedForward(f32.model, fns[bs].devices, 1)(x)
        got = fns[bs](x)
    exact = torch.equal(got, eager)
    check(meta["mesh_devices"] == n and (exact or (device == "cpu" and torch.allclose(
        got, eager, rtol=0, atol=1e-6 * float(eager.abs().max())))),
        "dp_sharded_export_serving: the artifact's logits differ from the eager replicas'")
    model = serve.ArtifactModel(art)
    xs = f32.x[:, : min(300, f32.x.shape[1])].cpu().numpy()
    served = model.predict(xs)
    with torch.inference_mode():
        direct = torch.cat([ShardedForward(f32.model, fns[bs].devices, 1)(
            torch.as_tensor(xs[:, i : i + bs], device=f32.x.device)) for i in range(0, xs.shape[1], bs)])
    check(np.allclose(served, direct.cpu().numpy(), rtol=0, atol=1e-6 * float(direct.abs().max())),
          "dp_sharded_export_serving: served logits differ from direct calls")
    lat = predict.latency_stats(fns[bs], f32.x, bs, devices=fns[bs].devices)
    print(json.dumps({"path": "dp_sharded_export_serving", "devices": n,
                      "bit_equal_to_eager": exact, "served_images": int(xs.shape[1]),
                      "p50_ms": lat["p50_ms"], "pipelined_img_per_s":
                      lat["pipelined_throughput_img_per_s"]}), flush=True)
    out.append("dp_sharded_export_serving")
    if n >= 2:  # at the training steps' batch
        for dtype in ("float32", "bfloat16"):
            out.append(_space_artifact_path(n, ckpt, specs, f32.x, z["time_b"], device, tmp,
                                            dtype))
    return out


def _space_artifact_path(n: int, ckpt: str, specs, x_all, bs: int, device: str, tmp: str,
                         compute_dtype: str = "float32") -> str:
    """``sp_sharded_export_serving``: the flagship's height-sharded artifact
    (``export.run --space-devices S``, S = 2 and, from 4 cards, 4), served
    by bands of rows on S cards, against one card's artifact of the same
    npz in the same call: logits within ARTIFACT_TOL of the largest, one
    K1 node per EPS layer in the slab program, p50 at ``bs``; then
    ``serve.ArtifactModel`` and ``predict.run`` from the S = 2 artifact.
    ``compute_dtype`` "bfloat16" (``sp_sharded_export_serving_bf16``): both
    artifacts with bf16 operands, each band's layers in the bf16 mode."""
    from .cli import export, predict, serve

    sfx = "" if compute_dtype == "float32" else "_bf16"
    name = f"sp_sharded_export_serving{sfx}"
    one_art = os.path.join(tmp, f"eps_one{sfx}.zip")
    export.run(checkpoint=ckpt, epses_specs=specs, batch_sizes=(bs,), device=device,
               compute_dtype=compute_dtype, out=one_art)
    one = export.load_artifact(one_art)[1][bs]
    x = x_all[:, :bs]
    with torch.inference_mode():
        want = one(x)
    rec = {"path": name, "compute_dtype": compute_dtype, "batch": bs,
           "one_card_p50_ms": predict.latency_stats(one, x_all, bs)["p50_ms"], "bands": {}}
    for space in (2, 4):
        if space > n:
            continue
        art = os.path.join(tmp, f"eps_space{space}{sfx}.zip")
        report = export.run(checkpoint=ckpt, epses_specs=specs, batch_sizes=(bs,),
                            space_devices=space, device=device, compute_dtype=compute_dtype,
                            out=art)
        meta, fns = export.load_artifact(art)
        check(meta["compute_dtype"] == compute_dtype, f"{name} S={space}: meta {meta}")
        fn = fns[bs]
        with torch.inference_mode():
            got = fn(x)
        gap = float((got - want).abs().max()) / float(want.abs().max())
        check(gap <= ARTIFACT_TOL, f"{name} S={space}: logits {gap:.3e} of "
                                   f"the largest from one card's artifact > {ARTIFACT_TOL}")
        nodes = export.op_nodes(fn.replicas[0])
        check(nodes == {"eps_fwd": len(specs)}, f"{name} S={space}: operator nodes {nodes}")
        check(fn.devices == [torch.device(device, i) if device == "cuda" else torch.device("cpu")
                             for i in range(space)],
              f"{name} S={space}: bands on {fn.devices}")
        lat = predict.latency_stats(fn, x_all, bs, devices=fn.devices)
        rec["bands"][space] = {"logit_gap": gap,
                               "slab_rows": meta["space_rows"] + meta["space_halo"],
                               "op_nodes": nodes, "p50_ms": lat["p50_ms"], "p90_ms": lat["p90_ms"],
                               "pipelined_img_per_s": lat["pipelined_throughput_img_per_s"],
                               "artifact_bytes": report["artifact_bytes"]}
        if space == 2:
            xs = x_all[:, : min(300, x_all.shape[1])].cpu().numpy()
            served = serve.ArtifactModel(art).predict(xs)
            with torch.inference_mode():
                direct = torch.cat([fn(torch.as_tensor(xs[:, i : i + bs], device=x.device))
                                    for i in range(0, xs.shape[1] - bs + 1, bs)]).cpu().numpy()
            check(np.allclose(served[: direct.shape[0]], direct, rtol=0,
                              atol=1e-6 * float(np.abs(direct).max())),
                  f"{name}: served logits differ from direct calls")
            preds = predict.run(checkpoint=art, ds_type="fashionmnist", ds_path="synthetic",
                                batch_size=bs, device=device, synthetic_sizes=(64, 16, 2 * bs))
            rec["predict_accuracy"] = preds.accuracy
    print(json.dumps(rec), flush=True)
    return name


def _sbs_artifact_path(n: int, cores, cfg, device: str, tmp: str) -> str:
    from .cli import export, serve
    from .data import io as data_io
    from .models.conv_sbs_model import ConvSBSModel
    from .parallel.replicas import ShardedForward, replica_devices

    devices = replica_devices(n, device)
    bs = 100 * n
    art = os.path.join(tmp, "sbs_sharded.zip")
    serialized, _ = export.export_sharded_forward(cores, cfg, batch_sizes=(n, bs), mesh_devices=n,
                                                  model_family="conv_sbs", image_size=28)
    export.write_artifact(art, serialized, export.build_meta(
        model_family="conv_sbs", image_size=28, batch_sizes=(n, bs), backend="pallas",
        mesh_devices=n, platforms=[device], program_device="cpu",
        num_sbs_layers=cfg.num_sbs_layers,
        bond_dim_size=cfg.bond_dim_size, trace_edge=cfg.trace_edge,
        cos_sin_squared=cfg.cos_sin_squared, input_multiplier=cfg.input_multiplier,
        num_labels=cfg.num_labels))
    _, fns = export.load_artifact(art)
    images, _ = data_io.synthetic_mnist_like(bs, seed=7)
    x = torch.as_tensor(images)
    eager = [ConvSBSModel(cores, cfg, device=d) for d in devices]
    with torch.inference_mode():
        got = fns[bs](x)
        want = ShardedForward(eager, devices, 0)(x)
    check(tuple(got.shape) == (bs, cfg.num_labels) and bool(torch.isfinite(got).all()),
          "conv_sbs_artifact_serving: bad logits")
    # on a card the operator launches the eager forward's kernel: the same
    # bits; on the CPU the traced program's plain ops may sum in another
    # order than the eager ones (4.7e-10 of a 0.02 logit read at batch 100)
    exact = torch.equal(got, want)
    check(exact or (device == "cpu" and torch.allclose(
        got, want, rtol=0, atol=1e-6 * float(want.abs().max()))),
        "conv_sbs_artifact_serving: logits differ from the eager replicas")
    served = serve.ArtifactModel(art).predict(images[:150])
    check(np.array_equal(served, got[:150].numpy()) or np.allclose(
        served, got[:150].numpy(), rtol=0, atol=1e-6 * float(got.abs().max())),
        "conv_sbs_artifact_serving: served logits differ")
    print(json.dumps({"path": "conv_sbs_artifact_serving", "devices": n, "global_batch": bs,
                      "bit_equal_to_eager": exact}), flush=True)
    return "conv_sbs_artifact_serving"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, required=True, help="ranks, one per card")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (NCCL, the kernels) or cpu (gloo, their plain versions)")
    ap.add_argument("--small", action="store_true", help="small shapes, a CPU rehearsal")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="profile the timed steps on rank 0 (NCCL and device time); tables to DIR")
    opts = ap.parse_args(argv)
    from .kernels import build
    from .parallel.mesh import Host, Job, spawn

    n = opts.devices
    if n < 2:  # one card's paths: chip_smoke.py phase 5b
        ap.error("--devices: 2 or more ranks, each held against one card")
    if opts.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < n:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"multichip: {n} ranks need {n} CUDA cards; {have} visible", file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        print(smi, flush=True)
        t0 = time.perf_counter()
        build.build_all()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    if opts.profile:
        os.makedirs(opts.profile, exist_ok=True)
    t0 = time.perf_counter()
    threads = max(1, torch.get_num_threads() // n)
    # every collective here ends in seconds: a rank left waiting fails soon
    job = Job(n, n, Host(), opts.device, threads, timeout=datetime.timedelta(minutes=5))
    out = spawn(_rank_paths, job, opts)
    print(f"ranks' paths: {time.perf_counter() - t0:.1f} s", flush=True)
    paths = list(out["paths"])
    with tempfile.TemporaryDirectory() as tmp:
        paths += _predict_paths(n, sizes(opts.small), opts.device, tmp)
        paths.append(_sbs_artifact_path(n, out["sbs_cores"], out["sbs_cfg"], opts.device, tmp))
    failed = out["failed"] + _FAILED
    if failed:
        print(f"multichip: {len(failed)} check(s) failed:\n  " + "\n  ".join(failed),
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "paths": paths}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
