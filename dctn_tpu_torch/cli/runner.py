"""The EPS experiment runner of the port (``dctn_tpu/cli/runner.py``, the
reference's ``new_runner.py``): the same click flags and the same
``run(**kw)`` → ``TrainLoopState`` contract, on one device or data
parallel over several.

It covers the JAX runner's single-device and data-parallel paths: the flags and their
validation; ``run_info.txt`` with the flags, the git commit and the
performance fallbacks, the working tree's diff beside it, and ``log.log``;
synthetic or real data; the three init families (theoretical, empirical,
manual with per-core normal, uniform or from-file inits) and
``--load-model-state`` (an npz of either package, or a reference
``torch.save(state_dict)`` file); the intermediate statistics at start;
the fast (cmt) layout's training step with parameter dropout, frozen cores,
``--qat int8``, the regularizers, weight decay and gradient accumulation
(``auto``: the saved-t cap's pick, and where the cap fires on the fast
layout the fastest of its candidates, measured, ``train/autotune.py``);
evaluation on the eval schedule in
the reference's log-line format, with the QAT runs scored on the int8
forward; the last-N and best-per-metric checkpoints in the reference layout
(npz files the JAX package loads), early stopping, the max-iterations and
NaN-loss stoppers (the latter replaying to the batch that made the loss
non-finite), ``train_state_latest.npz`` on the eval schedule, exact
``--resume-from`` (also of a train state the JAX runner wrote, whose own
``--resume-from`` reads the port's), and ``--preempt-save`` (SIGTERM saves
the train state and stops); ``--tb-batches`` (the loss, the regularizer,
the histogram of the probabilities of the true class and an annotated image
grid of the batch, on the eval schedule), ``--log-intermediate-outputs``
(each layer's output on 64 training images, through the forward kernel)
into ``metrics.jsonl`` (and TensorBoard events where the ``tensorboard``
package is installed), and ``--profile-dir`` (a ``torch.profiler`` trace
of the ``--profile-iters`` window).

``--device cuda`` (the default) runs every EPS layer through the
hand-written kernels (the forward K1, with t where the backward reads it,
``eps_dcore`` and the d_views kernels; K8/K9 under ``--qat int8``), and the
empirical init's forwards through K1 too; ``--device cpu`` runs their plain
versions. A run on ``cuda`` without a card is refused, never moved to the
CPU. ``--train-backend`` and ``--eval-backend`` ``auto`` and ``pallas``
both mean those kernels (the fast layout); ``xla`` means the reference
layout through the plain ``eps``, whose products are ``torch.matmul`` on
either device (the JAX runner's XLA path): ``--train-backend xla`` trains
it (``make_train_step``; the init and the statistics at start run the plain
``eps`` too), and ``--eval-backend xla`` scores it, also for a run that
trains the fast layout (through ``reference_params_from_fast``).

A model with a layer outside the kernels' plans (``kernels_take_split``,
JAX's ``pallas_forward_fits``; for example ``--epses-specs "(5,4)"``) has
no fast layout (``FastLayoutUnavailable``): as the JAX runner does
(runner.py:670-682), it trains and scores the reference layout instead,
each layer the kernels take through them and the others on the plain path
(``ops.eps``), logs the warning "fast (cmt) parameter layout unavailable
(...); using the reference layout", records it and each layer's fallback in
``run_info.txt`` (``utils.fallbacks``), and ignores ``--autotune-splits``;
``--qat int8`` is then a usage error. The decision is the same on the CPU
as on a card, so a config writes the same train state on both.

``--debug-nans`` turns on torch.autograd's anomaly detection with its NaN
check: a backward that produces a NaN raises, with the traceback of the
forward op behind it (the JAX runner's ``jax_debug_nans``; debugging only,
it slows every step).

``--export-artifact`` exports the final params as a deployment artifact
(``cli/export.py``) on ``--device``, through the eval backend's forward:
the kernels' registered operators for pallas (K8 with ``--export-quantize
int8``), plain operations for xla.

``--mesh-devices N`` trains data parallel over N ranks, one per card
(``gloo`` CPU replicas with ``--device cpu``; ``parallel/``): the splits
sharded over the ranks, each rank's index row from
``make_local_index_stream`` (the JAX runner's draws), the step's one
all-reduce, the evals summed over the shards (``--eval-train-subset``
scores that many train samples, sharded too; the JAX runner's DP path
ignores it), the stoppers deciding on the ranks' mean loss and summed
evals, SIGTERM agreed every ``--preempt-sync-steps`` iterations. The batch
must divide by N · ``--grad-accum-steps``; ``auto`` resolves on each
rank's batch. ``--distributed HOST:PORT,NPROC,PID`` (or ``auto`` under
torchrun) spans several host processes, N counting ranks across them. The
primary writes ``<experiments-dir>/<ts>``, local rank 0 of every other host
``<ts>-proc<PID>`` (the timestamp is rank 0's); only global rank 0 writes
checkpoints, train states and the artifact. A train state of N ranks
resumes bit-equal on N ranks (the index streams fast-forwarded to its step,
their saved position checked); on another rank count, or one device, it
resumes elastically: the same parameters, moments, step and generator,
and the new rank count's index streams fast-forwarded by the step (the
JAX runner's rule), so the batches differ from the unbroken run's. With
``mesh_devices > 1`` ``run`` returns rank 0's final state: ``params`` in
the reference layout on the CPU, no optimizer.

``--model-devices M`` (tensor parallelism), ``--space-devices S`` (spatial
parallelism) or both (SP×TP) run N·S·M ranks on a ``(data, space, model)``
grid (``parallel.GridMesh``; N is ``--mesh-devices``), dispatched as the
JAX runner dispatches them (runner.py:849-1043): the fast layout where both
backends are the kernels' (TP: the last cmt's row block; SP: the kernels on
each rank's slab of rows; SP×TP: both, ``parallel.sp_tp``), else the
reference layout with each backend's ``eps`` (``--tp-shard-all`` always:
every core sharded, through the kernels' route of ``ops.eps`` with the
pallas backend); under QAT evals score the int8 forward. Every rank draws
the one-device batch stream and takes its data shard of each global batch
(under SP and SP×TP its block of the padded rows, the whole train split held
on each card, the same on every rank of a model line); evals score the data
shards through the sharded score functions. Checkpoints, train states and
the artifact are written by global rank 0 in the layout one device holds:
under TP and SP×TP the model line gathers its shards first (every rank
calls), so such a train state resumes on one device and one device's on the
grid; a layout conversion under TP is refused, as in JAX
(runner.py:1319-1330). ``--tp-shard-all`` with ``--space-devices`` (JAX
runner.py:477-486) or with ``--qat int8``, a model axis that does not divide
a sharded O, a halo wider than a rank's rows and more ranks than visible
cards are refused before any rank starts.

``--autotune-splits`` measures each EPS layer's split candidates on
``--device`` at the per-rank microbatch under the run's objective and
trains at the fastest (``train/autotune.py``); with several ranks rank 0
measures and broadcasts the picks before any parameter of the fast layout is
built, and the picks go to ``autotune_report.json``; train states record
the splits (``eps_splits``). ``--autotune-cache`` (off by default, as
ROADMAP item 20 decided; on in the JAX runner) reuses and stores measured
picks, and without ``--autotune-splits`` applies the cached splits alone.

``--compute-dtype bfloat16`` (runner.py:543-545) runs every EPS product on
bf16 operands with float32 sums (the kernels' bf16 mode, the plain
``eps``'s rounding on the xla backend) on one device, under
``--mesh-devices``/``--distributed``, on the TP, SP and SP×TP grids
(``--model-devices``, ``--space-devices``, ``--tp-shard-all``) and with
``--qat int8`` (the int8 forward on the float32 cores, its saved t in
bf16, the bf16 backward); the parameters, the optimizer and the
checkpoints stay float32, and ``--export-artifact`` writes a bf16 artifact
unless ``--export-quantize int8`` (runner.py:1763-1768). The inits and dropout masks draw
from torch generators seeded from ``--seed``, so a seed gives other weights
than in the JAX runner; pass ``--load-model-state`` to start both from the
same ones.

Run: ``python -m dctn_tpu_torch.cli.runner --experiments-dir runs --ds-type
fashionmnist --ds-path synthetic --epses-specs "(4,4),(3,6)" --batch-size 128
--optimizer adam --lr 3e-3 --init-epses-composition-unit-empirical-output-std
[--device cpu]``
"""

from __future__ import annotations

import ast
import contextlib
import json
import logging
import os
import subprocess
import time
from pathlib import Path
from typing import List

import click
import numpy as np
import torch

from ..data import Batcher, load_dataset
from ..interop import (
    eps_plus_linear_params_from_state_dict,
    is_torch_checkpoint,
    load_torch_state_dict,
    params_from_numpy,
)
from ..kernels.eps_kernels import KERNELS, objective_name
from ..kernels.eps_q8_kernels import QAT_KERNELS
from ..models.eps_plus_linear import (
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    EPSesPlusLinearReference,
    FastLayoutUnavailable,
    check_fast_plans,
    eps_plus_linear_forward,
    eps_plus_linear_forward_fast,
    fast_params_from_reference,
    init_eps_plus_linear,
    intermediate_reps_stats,
    layer_plans,
    reference_params_from_fast,
    saved_t_capped_layers,
)
from ..ops import composition
from ..parallel import plan_job, spawn
from ..train import (
    AsyncWriter,
    BestModelCheckpointer,
    LastModelsCheckpointer,
    TrainLoopState,
    ValuesNotImprovingEarlyStopper,
    every_n_iters_intervals,
    load_params_npz,
    load_train_state,
    log_parameters_stats,
    make_fast_train_step,
    make_gather_batch,
    make_optimizer,
    make_score_fn,
    make_stopper_after_n_iters,
    make_stopper_on_nan_loss,
    make_train_step,
    resolve_auto_grad_accum,
    train,
    train_state_arrays,
)
from ..train.intermediate_logger import (
    DEFAULT_TRANSFORMS,
    eps_plus_linear_named_outputs,
    eps_plus_linear_named_outputs_fast,
    log_logits_as_probabilities,
    log_named_outputs,
)
from ..train.checkpoint import index_stream_arrays, saved_index_stream
from ..train.preemption import PreemptionHandler
from ..train.step import REGULARIZERS
from ..train.tb_logging import MetricsWriter, log_batch_images
from ..utils import fallbacks
from ..utils.profiling import StepTracer
from ..utils.misc import (
    FromFileInit,
    ZeroCenteredNormalInit,
    ZeroCenteredUniformInit,
    exactly_one_true,
    implies,
    xor,
)
from .specs import fill_defaults, parse_epses_specs

DIFF_FNAME = "git_diff_with_HEAD.patch"
RUN_INFO_FNAME = "run_info.txt"
LOG_FNAME = "log.log"
# the checkout the runner's code lies in: its git commit is the run's
REPO_ROOT = Path(__file__).resolve().parents[2]

logger = logging.getLogger(__name__)


def parse_eval_schedule(s: str):
    """'((10, 1), (None, 100))' → a tuple of (length, frequency) pairs, by
    ``ast.literal_eval`` (no code runs)."""
    value = ast.literal_eval(s) if isinstance(s, str) else s
    if not isinstance(value, tuple):
        raise click.BadParameter(f"bad eval schedule {s!r}: a tuple of (length, frequency)")
    return value


def save_git_provenance(output_dir: str) -> str:
    """The checkout's commit line for run_info.txt, and its working tree's
    diff against HEAD written beside it (new_runner.py:63-78). Outside a
    git checkout the line says why."""
    try:
        commit = subprocess.run(
            ("git", "-C", str(REPO_ROOT), "show", "--format=oneline", "-s"),
            text=True, capture_output=True, check=True, timeout=60,
        ).stdout.strip()
        diff = subprocess.run(
            ("git", "-C", str(REPO_ROOT), "diff", "HEAD"),
            capture_output=True, check=True, timeout=60,
        ).stdout
        with open(os.path.join(output_dir, DIFF_FNAME), "wb") as f:
            f.write(diff)
    except (OSError, subprocess.SubprocessError) as e:
        commit = f"<no git: {e}>"
    return commit


def setup_run_provenance(output_dir: str, kwargs: dict, verbosity="INFO") -> str:
    """run_info.txt (the flags as JSON, and the commit), the git diff, and
    console + log.log logging, for both runners (runner.py:163-182). The
    performance fallbacks the run records are appended to run_info.txt."""
    commit = save_git_provenance(output_dir)
    info = os.path.join(output_dir, RUN_INFO_FNAME)
    with open(info, "w") as f:
        json.dump(
            {k: v if isinstance(v, (int, float, str, bool, type(None))) else repr(v)
             for k, v in kwargs.items()} | {"commit": commit},
            f, indent=2,
        )
    logging.basicConfig(
        level=getattr(logging, str(verbosity).upper(), logging.INFO),
        handlers=(
            logging.StreamHandler(),
            logging.FileHandler(os.path.join(output_dir, LOG_FNAME), "w", "utf-8"),
        ),
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        force=True,
    )
    fallbacks.reset()
    fallbacks.add_sink(fallbacks.file_sink(info))
    return commit


def _tuned_plans(kw: dict, cfg, plans, channels: int, per_dev: int, device, mesh,
                 use_fast: bool, qat, writes_logs: bool):
    """The fast layout's plans at the splits the run trains at
    (runner.py:684-803): with ``--autotune-splits`` measured at the
    per-rank microbatch under the run's objective (``--qat int8``: the QAT
    step; the composition regularizer charged), with ``--autotune-cache``
    alone the cached picks where the cache holds this problem, else
    ``plans``. Rank 0 measures or looks up and broadcasts the picks over
    the run's group, so that every rank holds the same cmt shapes; the
    report goes to ``autotune_report.json``."""
    if not use_fast:
        if kw["autotune_splits"]:
            logger.warning("--autotune-splits ignored: the fast (cmt) layout is not in use "
                           "(the xla backend, --tp-shard-all, or a layer outside the kernels' "
                           "plans)")
        return plans
    if not (kw["autotune_splits"] or kw["autotune_cache"]):
        return plans
    from ..train.autotune import autotune_cache_lookup, autotune_splits, default_cache_path

    ga = kw["grad_accum_steps"]
    if ga == "auto":  # the cap's pick at the default splits: the microbatch the step runs
        ga = resolve_auto_grad_accum(cfg, plans, per_dev)
    micro = max(1, per_dev // max(1, ga))
    if kw["model_devices"] > 1 or kw["space_devices"] > 1:
        logger.warning("--autotune-splits measures unsharded layer shapes; under "
                       "--space-devices/--model-devices the per-device shapes differ: treat "
                       "the picks as approximate")
    problem = dict(device=device, reg_type=kw["reg_type"], reg_coeff=kw["reg_coeff"],
                   quantize=qat, log_fn=logger.info)
    cache = default_cache_path() if kw["autotune_cache"] else None
    picks, report = None, None
    if mesh is None or mesh.is_primary:
        if kw["autotune_splits"]:
            tuned, report = autotune_splits(cfg, micro, channels, seed=kw["seed"],
                                            cache_path=cache, **problem)
        else:
            hit = autotune_cache_lookup(cfg, micro, channels, cache_path=cache, **problem)
            tuned = plans if hit is None else hit[0]
        picks = [p["n1"] for p in tuned]
    if mesh is not None:
        picks = mesh.broadcast_object(picks)
        if not mesh.is_primary and kw["autotune_splits"]:
            report = [{"layer": i, "picked_n1": n1, "model_n1": p["n1"],
                       "broadcast_from_rank_0": True}
                      for i, (p, n1) in enumerate(zip(plans, picks))]
            logger.info("autotune splits broadcast from rank 0: %s", tuple(picks))
    if picks != [p["n1"] for p in plans]:
        logger.info("EPS splits %s (the defaults %s)", tuple(picks),
                    tuple(p["n1"] for p in plans))
    if report is not None and writes_logs:
        with open(os.path.join(kw["output_dir"], "autotune_report.json"), "w") as f:
            json.dump(report, f, indent=1)
    return tuple({**p, "n1": n1} for p, n1 in zip(plans, picks))


def _auto_grad_accum(kw: dict, cfg, plans, per_dev: int, channels: int, device, mesh,
                     use_fast: bool) -> int:
    """``--grad-accum-steps auto`` (runner.py:804-845): the saved-t cap's
    pick, and where the cap fired on the fast layout the measured fastest
    of its candidates (``autotune_grad_accum``), measured by rank 0 and
    broadcast, since the ranks' accumulation counts must agree."""
    cap_pick = resolve_auto_grad_accum(cfg, plans, per_dev)
    if cap_pick <= 1 or not use_fast:
        return cap_pick
    from ..train.autotune import autotune_grad_accum, default_cache_path

    pick = None
    if mesh is None or mesh.is_primary:
        pick = autotune_grad_accum(
            cfg, plans, per_dev, channels, cap_pick=cap_pick, device=device,
            log_fn=logger.info, seed=kw["seed"],
            cache_path=default_cache_path() if kw["autotune_cache"] else None)
    return pick if mesh is None else mesh.broadcast_object(pick)


def _hint_saved_t_recipe(cfg, plans, batch: int, accum: int) -> None:
    """Warns when a layer's saved-t backward is held back only by the cap
    on t at this microbatch, and names the accumulation that brings it back
    (runner.py:97-129)."""
    if batch % accum:
        return
    capped = saved_t_capped_layers(cfg, plans, batch // accum)
    if not capped:
        return
    suggest = None
    s = accum * 2
    while s <= batch:
        if batch % s == 0 and not saved_t_capped_layers(cfg, plans, batch // s):
            suggest = s
            break
        s *= 2
    msg = (
        f"saved-t backward capped for EPS layer(s) {capped} at microbatch {batch // accum} — "
        "the backward recomputes t there."
    )
    if suggest:
        msg += f" Consider --grad-accum-steps {suggest}: microbatch t buffers stay under the cap."
    logger.warning(msg)


@click.command()
@click.option("--experiments-dir", type=click.Path(file_okay=False), required=True)
@click.option("--ds-type", type=click.Choice((
    "mnist", "fashionmnist", "cifar10_28x28_grayscale",
    "cifar10_32x32_grayscale", "cifar10_rgb", "cifar10_YCbCr"),
    case_sensitive=False), required=True)
@click.option("--ds-path", type=str, required=True,
              help="dataset root, or 'synthetic' for generated data")
@click.option("--seed", type=int, default=0)
@click.option("-v", "--verbosity", default="INFO")
@click.option("--epses-specs", type=parse_epses_specs, required=True, help="e.g. (4,4),(3,6)")
@click.option("--batch-size", type=int, required=True)
@click.option("--load-model-state", type=click.Path(exists=True, dir_okay=False))
@click.option("--optimizer", "optimizer_name",
              type=click.Choice(("adam", "sgd"), case_sensitive=False), default="adam")
@click.option("--lr", type=float, default=1e-3)
@click.option("--reg-type", type=click.Choice(("epswise", "epses_composition")),
              default="epses_composition")
@click.option("--reg-coeff", type=float, default=0.0)
@click.option("--wd", type=float, default=0.0, help="weight decay")
@click.option("--es-train-acc/--no-es-train-acc", default=True)
@click.option("--es-val-acc/--no-es-val-acc", default=True)
@click.option("--es-train-mean-ce/--no-es-train-mean-ce", default=True)
@click.option("--es-val-mean-ce/--no-es-val-mean-ce", default=True)
@click.option("--patience", type=int, default=20)
@click.option("--max-num-iters", type=int, default=None)
@click.option("--keep-last-models", type=int, default=10)
@click.option("--init-epses-composition-unit-theoretical-output-std/"
              "--no-init-epses-composition-unit-theoretical-output-std", default=False)
@click.option("--init-epses-composition-unit-empirical-output-std/"
              "--no-init-epses-composition-unit-empirical-output-std", default=False)
@click.option("--init-epses-composition-unit-empirical-output-std-subset-size",
              type=int, default=10880)
@click.option("--dropout-p", type=float, default=1.0,
              help="the probability of keeping each component of an EPS core")
@click.option("--eval-schedule", type=parse_eval_schedule,
              default="((10, 1), (100, 10), (1000, 100), (20000, 500), (None, 5000))")
@click.option("--phi-multiplier", type=float, default=None, help="ν")
@click.option("--center-and-normalize-each-channel/"
              "--no-center-and-normalize-each-channel", default=False)
@click.option("--nu-per-channel", nargs=3, type=float, default=None)
@click.option("--add-constant-channel", type=float, default=None)
@click.option("--init-eps-zero-centered-normal-std", nargs=2, type=(int, float), multiple=True)
@click.option("--init-eps-from-file", nargs=2,
              type=(int, click.Path(exists=True, dir_okay=False)), multiple=True)
@click.option("--init-linear-weight-zero-centered-uniform", type=float, default=None)
@click.option("--init-linear-weight-zero-centered-normal-std", type=float, default=None)
@click.option("--init-linear-bias-zero-centered-uniform", type=float, default=None)
@click.option("--freeze-eps", type=int, multiple=True)
@click.option("--log-intermediate-reps-stats-batch-size", type=int, default=None)
@click.option("--compute-dtype", type=click.Choice(("float32", "bfloat16")), default="float32",
              help="the EPS products' operands: bfloat16 rounds them to bf16 and sums in float32 "
                   "(the kernels' bf16 mode); parameters and optimizer stay float32. With --qat "
                   "int8 the int8 forward saves its t in bf16; on every grid "
                   "(--mesh-devices, --model-devices, --space-devices) each rank runs the mode")
@click.option("--eval-backend", type=click.Choice(("auto", "xla", "pallas")), default="auto",
              help="auto or pallas: the fast layout, through the kernels on cuda and their "
                   "plain versions on cpu; xla: the reference layout through torch.matmul")
@click.option("--train-backend", type=click.Choice(("auto", "xla", "pallas")), default="auto",
              help="as --eval-backend, for the training step")
@click.option("--tb-batches/--no-tb-batches", default=False,
              help="log the batch loss, reg_term, the probabilities of the true class and an "
                   "image grid into metrics.jsonl (and TensorBoard) on the eval schedule")
@click.option("--log-intermediate-outputs/--no-log-intermediate-outputs", default=False,
              help="log each layer's output on 64 training images on the eval schedule")
@click.option("--debug-nans/--no-debug-nans", default=False,
              help="torch.autograd anomaly detection with its NaN check (slow; debugging only)")
@click.option("--breakpoint-on-nan-loss/--no-breakpoint-on-nan-loss", default=False,
              help="breakpoint() after the NaN-loss stopper's dump, its host values in scope")
@click.option("--grad-accum-steps", type=str, default="1",
              help="microbatch each step into this many accumulation slices, or 'auto': the "
                   "smallest that keeps every EPS layer's saved-t backward under its cap")
@click.option("--mesh-devices", type=int, default=1,
              help="data parallel over this many ranks, one per card (CPU replicas with "
                   "--device cpu); counts ranks across every host of --distributed")
@click.option("--model-devices", type=int, default=1,
              help="tensor parallel over this many ranks a data rank: the last EPS core's "
                   "output dim (every core's with --tp-shard-all) and the classifier's rows "
                   "sharded over a model axis (parallel/tensor_parallel.py)")
@click.option("--tp-shard-all/--tp-shard-last", default=False,
              help="shard EVERY EPS core's output dim (an all_gather between layers) instead of "
                   "only the last core's")
@click.option("--space-devices", type=int, default=1,
              help="spatial parallel over this many ranks a data rank: the image height sharded "
                   "with one halo exchange per EPS layer (parallel/spatial_parallel.py)")
@click.option("--autotune-splits/--no-autotune-splits", default=False,
              help="measure each EPS layer's matmul-split candidates on --device at the "
                   "per-rank microbatch and train at the fastest (train/autotune.py; exact: "
                   "splits only re-matricize the cores); rank 0 measures, every rank takes "
                   "its picks")
@click.option("--autotune-cache/--no-autotune-cache", default=False,
              help="reuse and store measured picks (splits, the measured 'auto' accumulation) "
                   "in train/autotune.default_cache_path() ($DCTN_TPU_TORCH_AUTOTUNE_CACHE); "
                   "without --autotune-splits, apply cached splits only. Off by default here, "
                   "on in the JAX runner")
@click.option("--resume-from", type=click.Path(exists=True, dir_okay=False), default=None,
              help="resume params, optimizer, step and the dropout generator from a "
                   "train_state .npz (saved as train_state_latest.npz at every eval)")
@click.option("--synthetic-sizes", nargs=3, type=int, default=(8192, 2048, 2048),
              help="train/val/test sizes when --ds-path synthetic")
@click.option("--export-artifact", type=click.Path(dir_okay=False), default=None,
              help="after training, export the final params as a deployment artifact "
                   "(cli/export.py) on --device, through the eval backend's forward")
@click.option("--export-batch-sizes", type=str, default="1,128",
              help="serving batch sizes for --export-artifact")
@click.option("--export-quantize", type=click.Choice(("none", "int8")), default="none",
              help="int8: the exported artifact serves the W8A8 int8 forward (needs "
                   "--export-artifact and the pallas eval backend)")
@click.option("--qat", type=click.Choice(("none", "int8")), default="none",
              help="quantization-aware training: every EPS layer's forward in int8 W8A8 "
                   "(K8/K9) with straight-through gradients; evals score the same forward")
@click.option("--eval-train-subset", type=int, default=None,
              help="score only this many train samples per eval (full set if unset)")
@click.option("--profile-dir", type=click.Path(file_okay=False), default=None,
              help="write a torch.profiler trace (CPU and CUDA activity) of the "
                   "--profile-iters window into this directory")
@click.option("--profile-iters", nargs=2, type=int, default=(10, 5),
              help="START COUNT window for --profile-dir")
@click.option("--preempt-save/--no-preempt-save", default=True,
              help="on SIGTERM: finish the step in flight, save the train state, stop")
@click.option("--preempt-sync-steps", type=int, default=16,
              help="under --mesh-devices > 1, iterations between the ranks' agreements on a "
                   "preemption stop (they all stop at the same step)")
@click.option("--distributed", default=None,
              help="'HOST:PORT,NPROC,PID': this is host process PID of NPROC, each starting its "
                   "share of --mesh-devices ranks, meeting at HOST:PORT; 'auto': torchrun's ranks")
@click.option("--device", default="cuda",
              help="torch device: cuda (the kernels) or cpu (their plain versions)")
def main(**kwargs) -> None:
    run(**kwargs)


def _validate(kw: dict) -> None:
    """The flags' interactions (new_runner.py:289-321, runner.py:401-500),
    each failure naming the flags."""
    specs = kw["epses_specs"]
    _validate_grid(kw)
    chosen: List[bool] = [False] * len(specs)
    for eps_index, _ in list(kw["init_eps_zero_centered_normal_std"]) + list(kw["init_eps_from_file"]):
        if not 0 <= eps_index < len(specs) or chosen[eps_index]:
            raise click.BadParameter(
                f"EPS {eps_index} was given more than one per-tensor init, or is not a layer "
                "(--init-eps-zero-centered-normal-std / --init-eps-from-file may each name an "
                "eps index at most once, and not both)"
            )
        chosen[eps_index] = True
    per_param = all(chosen) if chosen else False
    if any(chosen) and not per_param:
        missing = [i for i, c in enumerate(chosen) if not c]
        raise click.BadParameter(
            f"per-tensor EPS inits must cover EVERY eps or none — missing inits for eps indices {missing}"
        )
    w_uni = kw["init_linear_weight_zero_centered_uniform"] is not None
    w_std = kw["init_linear_weight_zero_centered_normal_std"] is not None
    b_uni = kw["init_linear_bias_zero_centered_uniform"] is not None
    if not (per_param == xor(w_uni, w_std) == b_uni):
        raise click.BadParameter(
            "the manual (per-tensor) init family needs the full set together: per-eps inits for "
            "every eps, exactly one of --init-linear-weight-zero-centered-uniform / "
            "--init-linear-weight-zero-centered-normal-std, and "
            "--init-linear-bias-zero-centered-uniform — and none of them with the composition "
            "init families"
        )
    if not exactly_one_true(
        kw["init_epses_composition_unit_theoretical_output_std"],
        kw["init_epses_composition_unit_empirical_output_std"],
        per_param,
    ):
        raise click.BadParameter(
            "choose exactly one initialization family: "
            "--init-epses-composition-unit-theoretical-output-std, "
            "--init-epses-composition-unit-empirical-output-std, or a full per-tensor manual init"
        )
    colored = kw["ds_type"] in ("cifar10_rgb", "cifar10_YCbCr")
    for given, name, want_colored in (
        (kw["center_and_normalize_each_channel"], "--center-and-normalize-each-channel", True),
        (bool(kw["nu_per_channel"]), "--nu-per-channel", True),
        (kw["add_constant_channel"] is not None, "--add-constant-channel", True),
        (kw["phi_multiplier"] is not None, "--phi-multiplier", False),
    ):
        if not implies(given, colored == want_colored):
            raise click.BadParameter(
                f"{name} applies to "
                + ("colored CIFAR datasets only (--ds-type cifar10_rgb / cifar10_YCbCr)"
                   if want_colored
                   else "grayscale datasets only (colored datasets scale per channel via "
                        "--nu-per-channel)")
            )
    if kw["export_quantize"] not in (None, "none"):
        # at start, not after training: the int8 kernel runs on the fast layout
        if not kw["export_artifact"]:
            raise click.UsageError("--export-quantize needs --export-artifact")
        if kw["eval_backend"] == "xla":
            raise click.UsageError("--export-quantize int8 needs the pallas eval backend")
    if kw["qat"] not in (None, "none") and "xla" in (kw["train_backend"], kw["eval_backend"]):
        raise click.BadParameter(
            "--qat int8 runs on the fast (cmt) layout's kernels: --train-backend and "
            "--eval-backend must both be pallas (or auto)"
        )
    if kw["qat"] not in (None, "none") and kw["export_artifact"] and kw["export_quantize"] in (
            None, "none"):
        logger.warning(
            "--qat int8 without --export-quantize int8: the exported artifact will serve the "
            "f32 kernels, not the quantized forward the training metrics measured"
        )
    if not 0.0 < kw["dropout_p"] <= 1.0:
        raise click.BadParameter(f"--dropout-p {kw['dropout_p']}: a keep probability in (0, 1]")
    if any(not 0 <= i < len(specs) for i in kw["freeze_eps"]):
        raise click.BadParameter(f"--freeze-eps {list(kw['freeze_eps'])}: not all are layers")
    ga = kw["grad_accum_steps"]
    if isinstance(ga, str) and ga.strip().lower() != "auto":
        try:
            ga = kw["grad_accum_steps"] = int(ga)
        except ValueError:
            raise click.BadParameter(f"--grad-accum-steps {ga!r}: a count or 'auto'") from None
    if isinstance(ga, str):
        kw["grad_accum_steps"] = "auto"
    elif ga < 1 or kw["batch_size"] % (kw["mesh_devices"] * ga):
        raise click.BadParameter(
            "--grad-accum-steps must be >= 1 or 'auto', and --batch-size divisible by "
            "--mesh-devices * --grad-accum-steps (each rank's sub-batch is microbatched into "
            "equal accumulation slices)"
        )
    if kw["mesh_devices"] < 1 or kw["batch_size"] % kw["mesh_devices"]:
        raise click.BadParameter(
            f"--batch-size {kw['batch_size']} must be divisible by --mesh-devices "
            f"{kw['mesh_devices']} (each rank takes an equal sub-batch)"
        )


# the image size of each dataset (data/pipeline.py), for the grid's checks
# before any rank starts
IMAGE_SIZES = {"mnist": 28, "fashionmnist": 28, "cifar10_28x28_grayscale": 28}


def _validate_grid(kw: dict) -> None:
    """The tensor- and spatial-parallel flags and their composition
    (runner.py:477-486, :569-574, tensor_parallel.py:88-92,
    spatial_parallel.py:91-100): refused here, before any rank starts, when
    their grid cannot be built."""
    from ..parallel import check_model_axis, sp_check_config

    model, space = kw["model_devices"], kw["space_devices"]
    if model < 1 or space < 1:
        raise click.BadParameter("--model-devices and --space-devices count ranks: >= 1")
    if model > 1 and space > 1 and kw["tp_shard_all"]:
        raise click.BadParameter(
            "--tp-shard-all does not compose with --space-devices (its inter-layer all_gathers "
            "would interleave with the per-layer halo exchange; use the default last-core TP "
            "layout)")
    if kw["qat"] not in (None, "none") and model > 1 and kw["tp_shard_all"]:
        raise click.BadParameter(
            "--qat int8 with --tp-shard-all: shard_all has no fast (cmt) layout analog and QAT "
            "runs only on the fast pipeline (use the default last-core TP layout)")
    cfg = EPSesPlusLinearConfig(epses_specs=kw["epses_specs"],
                                image_size=IMAGE_SIZES.get(kw["ds_type"], 32))
    try:
        if model > 1:
            check_model_axis(cfg, model, kw["tp_shard_all"])
        if space > 1:
            sp_check_config(cfg, space)
    except ValueError as e:
        raise click.BadParameter(f"--model-devices {model} --space-devices {space}: {e}") from None


def _load_model_state(path: str, params, device):
    """Params from ``--load-model-state`` (an npz of either package, or a
    reference torch ``state_dict``; runner.py:617-632), shapes checked
    against ``params``."""
    if is_torch_checkpoint(path):
        loaded = eps_plus_linear_params_from_state_dict(load_torch_state_dict(path))
        what = "reference torch state_dict"
    else:
        loaded = load_params_npz(path)
        what = "model state"
    got = [tuple(c.shape) for c in loaded["epses"]] + [tuple(loaded["linear"][k].shape) for k in "wb"]
    want = [tuple(c.shape) for c in params["epses"]] + [tuple(params["linear"][k].shape) for k in "wb"]
    if got != want:
        raise click.BadParameter(
            f"--load-model-state {path} does not match this model: leaves {got} vs {want}"
        )
    logger.info("loaded %s from %s", what, path)
    return params_from_numpy(loaded, device, params["linear"]["w"].dtype)


def _device_batches(index_stream, chunk: int, device):
    """The index batches (or, under data parallelism, (W, b) arrays of
    them) on the device, moved ``chunk`` at a time (an epoch) from pinned
    memory without waiting, so that no iteration waits on a copy
    from the host and the card's queue never drains for one."""
    while True:
        rows = torch.from_numpy(np.stack([next(index_stream) for _ in range(chunk)]))
        if device.type == "cuda":
            rows = rows.pin_memory().to(device, non_blocking=True)
        yield from rows.to(device).unbind(0)


def run(**kwargs) -> TrainLoopState:
    """Programmatic entry: the flags as keyword arguments by their Python
    names; unspecified ones take the CLI defaults. Returns the final
    ``TrainLoopState``; its ``extras`` hold the run's ``output_dir``,
    ``model``, ``step``, ``gather``, ``timing`` and ``params_view`` (the
    loop's params → the reference layout). With ranks (``--mesh-devices``
    > 1, ``--distributed``) it starts them, and returns local rank 0's
    final state: the reference-layout params on the CPU, the iterations,
    stop reason and metrics, and ``extras`` with ``output_dir``,
    ``timing``, ``cfg``, ``world_size`` and an identity ``params_view``."""
    kw = fill_defaults(main, dict(kwargs))
    _validate(kw)
    device = torch.device(kw["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise click.BadParameter(
            f"--device {device}: no CUDA device is available (--device cpu runs the plain versions)"
        )
    try:
        job = plan_job(kw["mesh_devices"], kw["distributed"], device.type, kw["model_devices"],
                       kw["space_devices"])
    except ValueError as e:
        raise click.BadParameter(str(e)) from None
    if job is None:
        return _run(kw, device, None)
    out = spawn(_run_rank, job, kw)
    state = TrainLoopState(params=out["params"], opt_state=None, rng=None,
                           num_iters_done=out["num_iters_done"], stop=True,
                           stop_reason=out["stop_reason"], iter_metrics=out["iter_metrics"])
    state.extras.update(output_dir=out["output_dir"], timing=out["timing"], cfg=out["cfg"],
                        world_size=job.world_size, params_view=lambda params: params)
    return state


def _run_rank(mesh, kw: dict) -> dict:
    """One rank's run; what local rank 0 hands back to ``run``."""
    state = _run(kw, mesh.device, mesh)
    params = state.extras["params_view"](state.params)
    return {
        "params": {"epses": tuple(c.detach().cpu() for c in params["epses"]),
                   "linear": {k: v.detach().cpu() for k, v in params["linear"].items()}},
        "num_iters_done": state.num_iters_done, "stop_reason": state.stop_reason,
        "iter_metrics": dict(state.iter_metrics), "output_dir": state.extras["output_dir"],
        "timing": state.extras["timing"], "cfg": state.extras["cfg"],
    }


def _run(kw: dict, device: torch.device, mesh) -> TrainLoopState:
    """The run on one device (``mesh`` None), or one rank's share of a
    data-parallel run, or of a tensor- or spatial-parallel one or both
    (``mesh`` a ``GridMesh``)."""
    from ..parallel import GridMesh

    grid = mesh if isinstance(mesh, GridMesh) else None
    tp = grid is not None and grid.size("model") > 1
    sp = grid is not None and grid.size("space") > 1
    primary = mesh is None or mesh.is_primary
    writes_logs = mesh is None or mesh.writes_logs
    ts = time.strftime("%Y-%m-%d-%H-%M-%S")
    if mesh is not None:
        # one name for the run on every host, rank 0's clock
        ts = mesh.broadcast_object(ts)
    run_name = ts if mesh is None or mesh.node == 0 else f"{ts}-proc{mesh.node}"
    output_dir = os.path.join(kw["experiments_dir"], run_name)
    if writes_logs:
        if os.path.exists(output_dir):
            raise click.ClickException(
                f"{output_dir} exists: one run per experiments dir and second")
        os.makedirs(output_dir)
    kw = dict(kw, output_dir=output_dir)
    specs = kw["epses_specs"]

    if writes_logs:
        setup_run_provenance(output_dir, kw, kw["verbosity"])
    else:
        # the host's other ranks log warnings and errors to the console only
        logging.basicConfig(level=logging.WARNING, force=True,
                            format=f"rank {mesh.rank}: %(name)s - %(levelname)s - %(message)s")
    logger.info("output_dir=%r", output_dir)
    if mesh is not None:
        pids = mesh.all_gather_object(os.getpid())
        if grid is None:
            logger.info("data parallel: %d ranks (%s), rank pids %s", mesh.world_size,
                        mesh.backend, pids)
        elif tp and sp:
            logger.info("SP x TP: grid (data=%d, space=%d, model=%d), %d ranks (%s), rank pids %s",
                        *grid.dims, grid.world_size, grid.backend, pids)
        else:
            axis = "model" if tp else "space"
            logger.info("%s parallelism: grid (data=%d, %s=%d), %d ranks (%s), rank pids %s",
                        "tensor" if tp else "spatial", grid.n_data, axis, grid.size(axis),
                        grid.world_size, grid.backend, pids)

    # --- data (new_runner.py:345-376) ---
    autoscale = specs[0][0] if kw["phi_multiplier"] is None and not kw["nu_per_channel"] else None
    splits = load_dataset(
        kw["ds_type"], kw["ds_path"],
        phi_multiplier=kw["phi_multiplier"],
        autoscale_kernel_size=autoscale,
        center_and_normalize_each_channel=kw["center_and_normalize_each_channel"],
        add_constant_channel=kw["add_constant_channel"],
        nu_per_channel=kw["nu_per_channel"] or None,
        synthetic_sizes=tuple(kw["synthetic_sizes"]),
    )
    image_size, q0 = splits.train.x.shape[2], splits.train.x.shape[-1]
    cfg = EPSesPlusLinearConfig(
        epses_specs=specs, image_size=image_size, q0=q0, dropout_p=kw["dropout_p"],
        compute_dtype=torch.bfloat16 if kw["compute_dtype"] == "bfloat16" else None)
    qat = None if kw["qat"] in (None, "none") else kw["qat"]
    if sp:
        from ..parallel import sp_local_rows

        logger.info("%d image rows a space rank", sp_local_rows(image_size, grid.size("space")))
    # the layouts the backends train and score: xla is the reference layout
    # through the plain eps, anything else the fast layout's kernels
    train_ref = kw["train_backend"] == "xla"
    eval_ref = kw["eval_backend"] == "xla"

    # --- model init (new_runner.py:378-431); the init and the dropout masks
    # draw from generators of their own, both from --seed ---
    init_seed, train_seed = (int(s) for s in np.random.SeedSequence(kw["seed"]).generate_state(2))
    init_gen = torch.Generator().manual_seed(init_seed)
    subset = kw["init_epses_composition_unit_empirical_output_std_subset_size"]
    x_init = torch.as_tensor(splits.train.x[:, :subset], device=device)
    if kw["init_epses_composition_unit_empirical_output_std"]:
        params = init_eps_plus_linear(init_gen, cfg, "unit_empirical_output_std", device,
                                      init_input=x_init, init_batch_size=kw["batch_size"],
                                      plain=train_ref)
    elif kw["init_epses_composition_unit_theoretical_output_std"]:
        params = init_eps_plus_linear(init_gen, cfg, "unit_theoretical_output_std", device)
    else:
        eps_inits = [None] * len(specs)
        for i, std in kw["init_eps_zero_centered_normal_std"]:
            eps_inits[i] = ZeroCenteredNormalInit(std)
        for i, path in kw["init_eps_from_file"]:
            eps_inits[i] = FromFileInit(path)
        w_init = (
            ZeroCenteredUniformInit(kw["init_linear_weight_zero_centered_uniform"])
            if kw["init_linear_weight_zero_centered_uniform"] is not None
            else ZeroCenteredNormalInit(kw["init_linear_weight_zero_centered_normal_std"])
        )
        b_init = ZeroCenteredUniformInit(kw["init_linear_bias_zero_centered_uniform"])
        params = init_eps_plus_linear(init_gen, cfg, "manual", device, eps_inits=tuple(eps_inits),
                                      linear_weight_init=w_init, linear_bias_init=b_init)
    if kw["load_model_state"]:
        params = _load_model_state(kw["load_model_state"], params, device)
    if writes_logs:  # statistics for the log, identical on every rank
        with torch.no_grad():
            logger.info("inner_product(epses, epses)=%.4e",
                        float(composition.inner_product(params["epses"], params["epses"])))
            stats_bs = kw["log_intermediate_reps_stats_batch_size"] or kw["batch_size"] // 2
            intermediate_reps_stats(params, x_init, cfg, stats_bs, plain=train_ref)
    del x_init

    # --- training assembly (new_runner.py:443-546): the fast (cmt) layout,
    # or the reference one for --train-backend xla ---
    k0 = specs[0][0]
    channels = (params["epses"][0].ndim - 1) // (k0 * k0)
    # the fast layout's plans: its shapes, and the conversions of train
    # states and checkpoints, whichever layout trains
    plans = layer_plans(cfg, channels)
    shard_all = tp and kw["tp_shard_all"]
    if grid is not None:
        from ..parallel import replicate

        # rank 0's init on every rank, then each rank's shard of it
        replicate(mesh, list(params["epses"]) + list(params["linear"].values()))
        # the fast layout where both backends are the kernels' and a fast form
        # exists (not --tp-shard-all: runner.py:663-667); else the reference
        # layout with each backend's eps (xla, or the kernels' route)
        train_ref = eval_ref = train_ref or eval_ref or shard_all
    # the fast layout only where the kernels take every layer (runner.py:
    # 670-682): else the reference layout, through the kernels where they
    # take a layer
    fast_fits = True
    try:
        check_fast_plans(cfg, plans, objective_name(False, qat, cfg.compute_dtype))
    except FastLayoutUnavailable as e:
        fast_fits = False
        if not train_ref or not eval_ref:
            if qat is not None:
                # no silent f32 fallback when the user asked for QAT
                raise click.UsageError(
                    f"--qat int8 needs the fast (cmt) layout, which is unavailable for this "
                    f"model: {e}") from None
            logger.warning("fast (cmt) parameter layout unavailable (%s); using the reference "
                           "layout", e)
            fallbacks.record(f"fast (cmt) parameter layout unavailable ({e}); using the "
                             "reference layout")
            train_ref = eval_ref = True
    world = 1 if mesh is None else mesh.data_size
    per_dev = kw["batch_size"] // world  # each data rank's batch
    # the splits the fast layout trains at: measured or looked up by rank 0
    # and broadcast, before any parameter of that layout is built
    plans = _tuned_plans(kw, cfg, plans, channels, per_dev, device, mesh, not train_ref,
                         qat, writes_logs)
    ref_backends = ("xla" if kw["train_backend"] == "xla" else "pallas",
                    "xla" if kw["eval_backend"] == "xla" else "pallas")
    if tp:
        from ..parallel import TPFastModel, TPModel, make_tp_fast_params, make_tp_params

        if train_ref:
            model = TPModel(make_tp_params(params, cfg, grid, shard_all), cfg, grid, shard_all)
        else:
            model = TPFastModel(make_tp_fast_params(
                fast_params_from_reference(params, cfg, plans)[0], cfg, grid), plans, cfg, grid)
    elif train_ref:
        model = EPSesPlusLinearReference(params, cfg, backend=ref_backends[0]).to(device)
    else:
        model = EPSesPlusLinear.from_reference(params, cfg, device=device, plans=plans)
    del params
    if mesh is not None and grid is None:
        from ..parallel import replicate

        replicate(mesh, model.parameters())  # rank 0's init on every rank
    optimizer = make_optimizer(kw["optimizer_name"], model.parameters(), kw["lr"], kw["wd"])
    if kw["grad_accum_steps"] == "auto":
        kw["grad_accum_steps"] = _auto_grad_accum(kw, cfg, plans, per_dev, channels, device,
                                                  mesh, not train_ref)
        logger.info("grad-accum-steps auto -> %d", kw["grad_accum_steps"])
    step_kw = dict(frozen_eps_indices=kw["freeze_eps"], with_probs=kw["tb_batches"],
                   grad_accum_steps=kw["grad_accum_steps"])
    if tp and sp:
        from ..parallel import make_sp_tp_fast_train_step, make_sp_tp_train_step

        if train_ref:
            step = make_sp_tp_train_step(model, optimizer, kw["reg_type"], kw["reg_coeff"],
                                         backend=ref_backends[0], **step_kw)
        else:
            step = make_sp_tp_fast_train_step(model, optimizer, kw["reg_type"],
                                              kw["reg_coeff"], qat=qat, **step_kw)
    elif tp:
        from ..parallel import make_tp_fast_train_step, make_tp_train_step

        if train_ref:
            step = make_tp_train_step(model, optimizer, kw["reg_type"], kw["reg_coeff"],
                                      backend=ref_backends[0], **step_kw)
        else:
            step = make_tp_fast_train_step(model, optimizer, kw["reg_type"], kw["reg_coeff"],
                                           qat=qat, **step_kw)
    elif sp:
        from ..parallel import make_sp_fast_train_step, make_sp_train_step

        if train_ref:
            step = make_sp_train_step(model, optimizer, grid, kw["reg_type"], kw["reg_coeff"],
                                      backend=ref_backends[0], **step_kw)
        else:
            step = make_sp_fast_train_step(model, optimizer, grid, kw["reg_type"],
                                           kw["reg_coeff"], qat=qat, **step_kw)
    elif mesh is not None:
        from ..parallel import make_parallel_fast_train_step, make_parallel_train_step

        if train_ref:
            step = make_parallel_train_step(model, optimizer, mesh, kw["reg_type"],
                                            kw["reg_coeff"], **step_kw)
        else:
            step = make_parallel_fast_train_step(model, optimizer, mesh, kw["reg_type"],
                                                 kw["reg_coeff"], qat=qat, **step_kw)
    elif train_ref:
        step = make_train_step(model, optimizer, kw["reg_type"], kw["reg_coeff"], **step_kw)
    else:
        step = make_fast_train_step(model, optimizer, kw["reg_type"], kw["reg_coeff"], qat=qat,
                                    **step_kw)
    if not train_ref and grid is None:
        _hint_saved_t_recipe(cfg, plans, per_dev, kw["grad_accum_steps"])
    eval_kernels = KERNELS if qat is None else QAT_KERNELS
    if qat is not None:
        logger.info("QAT int8 active: W8A8 forward with straight-through gradients; evals "
                    "score the quantized forward")

    def params_view(params):
        """The reference layout of the loop's params (``state.params``):
        under tensor parallelism the model group's shards gathered, which
        every rank of the group must call."""
        if tp:
            from ..parallel import merge_tp_fast_params, merge_tp_params

            if train_ref:
                return merge_tp_params(params, cfg, grid, shard_all)
            return reference_params_from_fast(merge_tp_fast_params(params, cfg, grid), cfg, plans)
        return params if train_ref else reference_params_from_fast(params, cfg, plans)

    def eval_params(params):
        """The loop's params in the eval backend's layout."""
        if grid is not None:  # one layout for both backends
            return params
        if eval_ref:
            return params_view(params)
        return fast_params_from_reference(params, cfg, plans)[0] if train_ref else params

    def eval_forward(params, xb):
        """The eval backend's forward of params in its layout."""
        if eval_ref:
            return eps_plus_linear_forward(params, xb, cfg, backend=ref_backends[1])
        return eps_plus_linear_forward_fast(params, xb, cfg, plans, kernels=eval_kernels)

    if tp and sp:
        from ..parallel import make_sp_tp_forward

        eval_forward = make_sp_tp_forward(cfg, grid, None if eval_ref else plans, qat,
                                          ref_backends[1])
    elif tp:
        from ..parallel import make_tp_fast_forward, make_tp_forward

        eval_forward = (make_tp_forward(cfg, grid, shard_all, ref_backends[1]) if eval_ref
                        else make_tp_fast_forward(cfg, plans, grid, qat))
    elif sp:
        from ..parallel import make_sp_forward

        eval_forward = make_sp_forward(cfg, grid, None if eval_ref else plans, qat,
                                       ref_backends[1])

    def forward(params, xb):
        return eval_forward(eval_params(params), xb)

    if mesh is None:
        score_eval = make_score_fn(cfg, plans, kw["batch_size"], forward_fn=eval_forward)
    elif tp and sp:
        from ..parallel import make_sp_tp_score_fn

        score_eval = make_sp_tp_score_fn(cfg, grid, per_dev, None if eval_ref else plans, qat,
                                         ref_backends[1])
    else:
        from ..parallel import make_parallel_score_fn

        # each rank scores its shard at its own batch (the JAX DP path's)
        score_eval = make_parallel_score_fn(cfg, plans, mesh, per_dev, forward_fn=eval_forward)

    def score(params, *split):
        """(mean CE, accuracy) of one device's ``x, y``, or of a rank's
        ``ShardedSplit``."""
        return score_eval(eval_params(params), *split)
    logger.info(
        "%s parameter layout on %s: training through %s, evals through %s",
        "reference" if train_ref else "fast (cmt)", device,
        "the plain eps (torch.matmul)" if ref_backends[0] == "xla"
        else "eps on the kernels where they take a layer" if train_ref
        else "the CUDA kernels" if device.type == "cuda" else "the kernels' plain versions",
        "the plain eps (torch.matmul)" if ref_backends[1] == "xla"
        else "eps on the kernels where they take a layer" if eval_ref
        else "the fast layout's forward",
    )

    n_eval_train = kw["eval_train_subset"] or len(splits.train)
    if grid is not None:
        # the one-device batch stream (runner.py:1203-1260): each step's global
        # batch, each rank its data shard of it; a rank holds the whole train
        # split (under SP its block of the padded rows)
        from ..parallel import shard_split, sp_row_block, sp_shard_split

        split_of = sp_shard_split if sp else shard_split
        x_tr = torch.as_tensor(np.ascontiguousarray(sp_row_block(splits.train.x, grid))
                               if sp else splits.train.x, device=device)
        y_tr = torch.as_tensor(splits.train.y.astype(np.int64), device=device)
        tr_eval = (split_of(grid, splits.train.x[:, :n_eval_train],
                            np.asarray(splits.train.y)[:n_eval_train]),)
        val_eval = (split_of(grid, splits.val.x, np.asarray(splits.val.y)),)
        batcher = Batcher(splits.train, kw["batch_size"], shuffle=True, drop_last=True,
                          seed=kw["seed"])
        if len(batcher) == 0:
            raise click.BadParameter(
                f"--batch-size {kw['batch_size']} is over the {len(splits.train)} training images"
            )
        index_stream = batcher.indices_forever()
        lo = grid.data_index * per_dev

        def gather(idx):
            """This rank's data shard of the global batch ``idx``."""
            own = idx[lo : lo + per_dev]
            return x_tr.index_select(1, own), y_tr.index_select(0, own)
    elif mesh is None:
        x_tr = torch.as_tensor(splits.train.x, device=device)
        y_tr = torch.as_tensor(splits.train.y.astype(np.int64), device=device)
        x_val = torch.as_tensor(splits.val.x, device=device)
        y_val = torch.as_tensor(splits.val.y.astype(np.int64), device=device)
        gather = make_gather_batch(x_tr, y_tr)
        tr_eval, val_eval = (x_tr[:, :n_eval_train], y_tr[:n_eval_train]), (x_val, y_val)
        batcher = Batcher(splits.train, kw["batch_size"], shuffle=True, drop_last=True,
                          seed=kw["seed"])
        if len(batcher) == 0:
            raise click.BadParameter(
                f"--batch-size {kw['batch_size']} is over the {len(splits.train)} training images"
            )
        index_stream = batcher.indices_forever()
    else:
        from ..parallel import make_local_index_stream, shard_split

        y_tr_host = np.asarray(splits.train.y)
        tr_split = shard_split(mesh, splits.train.x, y_tr_host)
        x_tr = tr_split.x  # this rank's shard
        tr_eval = (tr_split if n_eval_train >= len(y_tr_host) else shard_split(
            mesh, splits.train.x[:, :n_eval_train], y_tr_host[:n_eval_train]),)
        val_eval = (shard_split(mesh, splits.val.x, np.asarray(splits.val.y)),)
        index_stream = make_local_index_stream(tr_split, per_dev, kw["seed"])
        if per_dev > min(index_stream.valid_per_shard):
            raise click.BadParameter(
                f"--batch-size {kw['batch_size']} over {world} ranks takes {per_dev} images a "
                f"rank, over the {min(index_stream.valid_per_shard)} of the smallest shard"
            )
        replay = {"stream": None, "at": 0}

        def stream_position(step: int):
            """The index streams' (orders, cursors) after ``step`` draws, for
            the train state: a replay of the stream on the host, moved on
            from the last save's (the loop's stream runs an epoch ahead)."""
            if replay["stream"] is None or replay["at"] > step:
                replay.update(stream=make_local_index_stream(tr_split, per_dev, kw["seed"]), at=0)
            for _ in range(step - replay["at"]):
                next(replay["stream"])
            replay["at"] = step
            return replay["stream"].orders, replay["stream"].cursors

        def gather(idx):
            """This rank's row of the (W, b) index array, from its shard."""
            row = idx[mesh.rank]
            return tr_split.x.index_select(1, row), tr_split.y.index_select(0, row)
    generator = torch.Generator(device=device).manual_seed(train_seed)

    resume_step = 0
    if kw["resume_from"]:
        try:
            if tp:
                from ..parallel import load_tp_train_state

                resume_step = load_tp_train_state(kw["resume_from"], model, optimizer, plans,
                                                  generator)
            else:
                resume_step = load_train_state(kw["resume_from"], model, optimizer, cfg, plans,
                                               generator)
            with np.load(kw["resume_from"]) as d:
                written_by_jax = "generator_state" not in d.files
        except (KeyError, ValueError) as e:
            raise click.ClickException(f"--resume-from {kw['resume_from']}: {e}") from None
        logger.info("resumed train state from %s at step %d", kw["resume_from"], resume_step)
        if written_by_jax and cfg.dropout_p < 1.0:
            # the JAX key's dropout stream has no counterpart in a torch
            # generator: the masks from here on are the port's own draws
            fallbacks.record(
                f"--resume-from {kw['resume_from']} has no generator_state (a train state the "
                "JAX runner wrote): its dropout stream cannot be continued, the resumed run "
                "draws its masks from the port's generator seeded from --seed"
            )
        # the shuffled batch stream restarts at epoch 0: fast-forward it, so
        # the resumed run takes the batches the unbroken run would have
        for _ in range(resume_step):
            next(index_stream)
        # a grid's batches are the one-device stream's
        _check_resumed_stream(kw["resume_from"], 1 if grid is not None else world, index_stream)

    schedule = every_n_iters_intervals(*kw["eval_schedule"])
    # hook_s: each named hook's seconds, call by call
    timing = {"hooks_s": 0.0, "eval_s": 0.0, "evals": 0, "hook_s": {}}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(hook, name=None):
        """``hook`` with its host time counted apart from the steps': the
        card is synchronised before the clock starts and again before it
        stops. A ``name`` also lists each call's seconds in
        ``timing["hook_s"][name]``."""

        def wrapped(state):
            sync()
            t0 = time.perf_counter()
            hook(state)
            sync()
            dt = time.perf_counter() - t0
            timing["hooks_s"] += dt
            if name is not None:
                timing["hook_s"].setdefault(name, []).append(dt)

        return wrapped

    def evaluate_and_log(state: TrainLoopState) -> None:
        t0 = time.perf_counter()
        trm, tra = score(state.params, *tr_eval)
        vm, va = score(state.params, *val_eval)
        state.iter_metrics.update(train_mean_ce=float(trm), train_acc=float(tra),
                                  val_mean_ce=float(vm), val_acc=float(va))
        if state.device_metrics is not None:
            reg_term = float(state.device_metrics["reg_term"])
        else:
            with torch.no_grad():
                reg_term = float(REGULARIZERS[kw["reg_type"]](params_view(state.params)))
        # the reference's eval line (new_runner.py:468-473), parsed by viz.log_parsing
        logger.info(
            "After %07d iters: train/val mean_ce=%.5f/%.5f acc=%.2f%%/%.2f%% reg_term=%.2e",
            state.num_iters_done,
            state.iter_metrics["train_mean_ce"], state.iter_metrics["val_mean_ce"],
            state.iter_metrics["train_acc"] * 100, state.iter_metrics["val_acc"] * 100,
            reg_term,
        )
        timing["eval_s"] += time.perf_counter() - t0
        timing["evals"] += 1

    writer = AsyncWriter()

    def save_train_state(state: TrainLoopState, completed_offset: int = 0) -> None:
        """The full train state. ``completed_offset`` is 1 after a step (the
        preemption hook after the step): ``num_iters_done`` then names the
        iteration just done and the generator already stands at the next.
        Under tensor parallelism every rank gathers its model group's shards
        (the layout one device holds) and rank 0 writes."""
        step_no = state.num_iters_done + completed_offset
        if tp:
            from ..parallel import tp_train_state_arrays

            arrays = tp_train_state_arrays(model, optimizer, step_no, generator, seed=train_seed)
            if primary:
                writer.submit(arrays, os.path.join(output_dir, "train_state_latest.npz"))
            return
        arrays = train_state_arrays(model, optimizer, step_no, plans, generator, seed=train_seed)
        if mesh is not None and grid is None:
            arrays.update(index_stream_arrays(*stream_position(step_no), world))
        writer.submit(arrays, os.path.join(output_dir, "train_state_latest.npz"))

    metrics = (("train_acc", False), ("val_acc", False), ("train_mean_ce", True), ("val_mean_ce", True))
    es_metrics = tuple((name, low) for name, low in metrics if kw[f"es_{name}"])
    # evals and stoppers run on every rank (collectives, and decisions from
    # the ranks' summed evals and mean loss); the writing hooks on the
    # ranks that write
    at_iter_start = [schedule(timed(evaluate_and_log))]
    ckpt_view = params_view
    if tp:
        # the writers' reference params: the model group's shards, gathered on
        # every rank at each scheduled iteration before rank 0 writes them
        merged = {}

        def gather_for_writers(state: TrainLoopState) -> None:
            merged["params"] = params_view(state.params)

        at_iter_start.append(schedule(timed(gather_for_writers)))
        ckpt_view = lambda params: merged["params"]  # noqa: E731
    if writes_logs:
        at_iter_start.append(schedule(timed(log_parameters_stats)))
    if tp and not primary:
        at_iter_start.append(schedule(timed(save_train_state)))  # its gathers
    if primary:
        best_ckpts = [BestModelCheckpointer(output_dir, k, low, writer, params_view=ckpt_view)
                      for k, low in metrics]
        at_iter_start += [
            schedule(timed(LastModelsCheckpointer(output_dir, kw["keep_last_models"], writer,
                                                  params_view=ckpt_view))),
            schedule(timed(save_train_state)),
        ] + [schedule(timed(c)) for c in best_ckpts]
    if es_metrics:
        at_iter_start.append(schedule(ValuesNotImprovingEarlyStopper(kw["patience"], es_metrics)))
    if kw["max_num_iters"] is not None:
        at_iter_start.append(schedule(make_stopper_after_n_iters(kw["max_num_iters"])))
    nan_stopper = make_stopper_on_nan_loss(
        output_dir, forward, params_view=params_view, replay_step=step, replay_gather=gather,
        interactive=kw["breakpoint_on_nan_loss"] and primary, write_files=primary,
        views_on_every_rank=tp or sp,
    )
    after_step = [schedule(timed(nan_stopper))]
    metrics_writer = None
    if writes_logs and (kw["tb_batches"] or kw["log_intermediate_outputs"]):
        metrics_writer = MetricsWriter(output_dir)
    if writes_logs and kw["tb_batches"]:
        raw_images = splits.train.unmodified_x

        def log_batch_to_tb(state: TrainLoopState) -> None:
            """The step's metrics on the eval schedule (runner.py:1632-1647):
            read from the card here only, so the steps between stay free of
            host syncs."""
            m = state.device_metrics
            if m is None:
                return
            nitd = state.num_iters_done
            metrics_writer.add_scalar("loss", float(m["loss"]), nitd)
            metrics_writer.add_scalar("reg_term", float(m["reg_term"]), nitd)
            probs = m["probs_of_true_class"].cpu().numpy()
            metrics_writer.add_histogram("probs_of_true_class", probs, nitd)
            if raw_images is not None and raw_images.ndim == 3:
                sel = state.batch_indices.cpu().numpy()
                if mesh is not None and grid is None:
                    # rank d's row holds positions in its shard, which starts
                    # at d·n_local: the gathered probabilities' order
                    sel = np.arange(world)[:, None] * tr_split.n_local + sel
                sel = sel.reshape(-1)[:32]
                log_batch_images(metrics_writer, raw_images[sel], probs[:32],
                                 splits.train.y[sel], nitd)
            metrics_writer.flush()

        after_step.append(schedule(timed(log_batch_to_tb, "tb_batches")))
    if (writes_logs or tp) and kw["log_intermediate_outputs"]:
        probe = torch.as_tensor(splits.train.x[:, :64], device=device)

        # the fast layout's outputs through the forward kernel (also for a
        # tensor-parallel reference layout on the kernels), else the
        # reference layout's through the plain eps
        fast_logs = not train_ref or (tp and kw["train_backend"] != "xla" and fast_fits)

        def log_intermediates(state: TrainLoopState) -> None:
            """Each layer's output on the probe images (runner.py:1649-1678):
            the fast layout's through the forward kernel, the reference
            layout's through the plain eps. Under tensor parallelism every
            rank gathers the whole parameters, and the logging ranks log
            the one-device model's outputs; under spatial parallelism the
            parameters are whole on every rank."""
            params = state.params
            if tp:
                params = params_view(params)
                if not writes_logs:
                    return
                if fast_logs:
                    params = fast_params_from_reference(params, cfg, plans)[0]
            with torch.no_grad():
                if fast_logs:
                    named = eps_plus_linear_named_outputs_fast(params, probe, cfg, plans)
                else:
                    named = eps_plus_linear_named_outputs(params, probe, cfg)
            log_named_outputs(metrics_writer, named, state.num_iters_done, DEFAULT_TRANSFORMS)
            log_named_outputs(metrics_writer, named, state.num_iters_done,
                              (log_logits_as_probabilities,),
                              module_filter=lambda name: name == "linear")
            metrics_writer.flush()

        at_iter_start.append(schedule(timed(log_intermediates, "intermediate_outputs")))
    tracer = None
    if writes_logs and kw["profile_dir"]:
        # first at an iteration's start, so that an eval there falls
        # outside the window; its starting and writing the trace are timed
        # apart from the steps (the window's own time is the tracer's)
        prof_dir = kw["profile_dir"] if mesh is None or mesh.node == 0 else (
            f"{kw['profile_dir']}-proc{mesh.node}")
        tracer = StepTracer(prof_dir, *kw["profile_iters"])
        timed_tracer = timed(tracer, "profiler")

        def profile(state: TrainLoopState) -> None:
            if tracer.acts_at(state.num_iters_done):
                timed_tracer(state)

        at_iter_start.insert(0, profile)

    state = TrainLoopState(
        params=(model.params3() if train_ref else model.fast_params3()) if tp else
        model.reference_params() if train_ref else model.fast_params(),
        opt_state=optimizer, rng=generator, num_iters_done=resume_step,
    )
    state.extras.update(output_dir=output_dir, cfg=cfg, model=model, step=step, gather=gather,
                        timing=timing, params_view=params_view)
    nan_stopper.enable_replay(state)
    # an epoch of index batches a copy; under data parallelism (W, b) arrays,
    # an epoch of the smallest shard
    epoch = (len(batcher) if mesh is None or grid is not None
             else max(min(index_stream.valid_per_shard) // per_dev, 1))
    batches = _device_batches(index_stream, epoch, device)
    with contextlib.ExitStack() as stack:
        if kw["debug_nans"]:
            stack.enter_context(torch.autograd.detect_anomaly(check_nan=True))
            logger.info("torch.autograd anomaly detection (check_nan) enabled")
        if kw["preempt_save"]:
            preempt = stack.enter_context(PreemptionHandler())
            preempt_save = (save_train_state if primary or tp
                            else (lambda st, completed_offset=0: None))
            if mesh is not None:
                # agreed every --preempt-sync-steps iterations: every rank
                # stops at the same step
                at_iter_start = [preempt.make_synced_hook(
                    preempt_save, kw["preempt_sync_steps"], mesh.any)] + at_iter_start
            else:
                # checked every iteration (a flag read): before the step, and
                # after it with the step counted as done
                at_iter_start = [preempt.make_hook(preempt_save)] + at_iter_start
                after_step = after_step + [preempt.make_hook(lambda st: preempt_save(st, 1))]
        sync()
        t0 = time.perf_counter()
        train(state, step, gather, batches, at_iter_start=at_iter_start, after_step=after_step)
        sync()
        loop_s = time.perf_counter() - t0
    if tracer is not None:
        tracer.close()
        timing["profile_window"] = {"iterations": tracer.iterations, "s": tracer.window_s,
                                    "export_s": tracer.export_s}
    if metrics_writer is not None:
        metrics_writer.close()
    writer.wait()
    iters = state.num_iters_done - resume_step
    timing.update(loop_s=loop_s, iters=iters)
    logger.info(
        "timing: %d iterations at %.3f ms each (the steps, with the host's launches; %.3f s "
        "more in the scheduled hooks), %d evals at %.3f ms each",
        iters, 1e3 * (loop_s - timing["hooks_s"]) / max(iters, 1), timing["hooks_s"],
        timing["evals"], 1e3 * timing["eval_s"] / max(timing["evals"], 1),
    )
    logger.info("training stopped: %s at %d iters", state.stop_reason, state.num_iters_done)
    if kw["export_artifact"] and (primary or tp):
        final = params_view(state.params)  # under TP the model group's gather
        if primary:
            _export_final(kw, final, cfg, int(splits.train.x.shape[0]), device,
                          "xla" if eval_ref and kw["eval_backend"] == "xla" else "pallas")
    return state


def _check_resumed_stream(path: str, world: int, index_stream) -> None:
    """After the fast-forward: on the rank count the train state was saved
    on, its index streams' saved position must be where this run's stand
    (the same seed, data and batch); on another count the resume is
    elastic, and says so."""
    saved_world, orders, cursors = saved_index_stream(path)
    if saved_world != world:
        logger.warning(
            "elastic resume: the train state was saved on %d rank(s), this run has %d; the "
            "parameters, moments, step and generator continue, the batches are this rank "
            "count's streams fast-forwarded to the step (not the unbroken run's)",
            saved_world, world)
        return
    if orders is None:
        return
    now_orders, now_cursors = index_stream.orders, index_stream.cursors
    if list(cursors) != list(now_cursors) or any(
            not np.array_equal(a, b) for a, b in zip(orders, now_orders)):
        raise click.ClickException(
            f"--resume-from {path}: its index streams stand elsewhere than this run's at its "
            "step (another --seed, dataset or --batch-size): the resume would not continue "
            "its trajectory")


def _export_final(kw: dict, params, cfg: EPSesPlusLinearConfig, channels: int, device,
                  backend: str) -> None:
    """``--export-artifact``: the final reference-layout ``params`` as a
    deployment artifact on ``device``, through the eval backend's forward."""
    from .export import build_meta, export_forward, parse_batch_sizes, write_artifact

    bss = parse_batch_sizes(kw["export_batch_sizes"])
    quantize = None if kw["export_quantize"] in (None, "none") else kw["export_quantize"]
    serialized, _ = export_forward(params, cfg, batch_sizes=bss, channels=channels,
                                   device=device, backend=backend, quantize=quantize)
    write_artifact(kw["export_artifact"], serialized, build_meta(
        model_family="eps", image_size=cfg.image_size, batch_sizes=bss, backend=backend,
        platforms=[device.type], quantize=quantize or "none",
        # a quantized artifact's products are int8 whatever the training
        # compute dtype (runner.py:1763-1768)
        compute_dtype="bfloat16" if cfg.compute_dtype is not None and not quantize else "float32",
        epses_specs=[list(s) for s in cfg.epses_specs], q0=cfg.q0, channels=channels,
        num_classes=cfg.num_classes,
    ))
    logger.info("deployment artifact written to %s (bs %s)", kw["export_artifact"], sorted(bss))


if __name__ == "__main__":
    main()
