"""The legacy ConvSBS MNIST runner of the port (``dctn_tpu/cli/legacy_runner.py``,
reference ``mnist.py:314-596``): the same click flags and the same
``run(**kw)`` → ``(params, best_acc)`` contract, on one device or data
parallel over several.

Covers the single-device path of the JAX runner: synthetic or MNIST data
and the seeded train/val split, ``run_info.txt`` (the flags, the git
commit and the performance fallbacks, with the working tree's diff beside
it) and ``log.log``, ``--shuffle-pixels``, the input multiplier
or ``--make-input-window-std-one``, the four SBS inits with
``--initialization-std``, ``--init-load-file`` (the npz of either package,
or a reference torch ``state_dict``), ``--scale-layers-using-batch``, the
exponential warmup with SGD or RMSprop, the epoch loop in the JAX runner's
batch order (``np.random.default_rng(seed + 1)``), per-epoch validation CE
and accuracy, the best-checkpoint npz (``dctn_epoch=…_vacc=….npz``, keys
``{layer}/{string}/{core}``, readable by the JAX package's ``load_pytree``)
and epoch-patience early stopping. Every string runs through the ConvSBS
kernels on ``--device cuda`` (the default) and their plain versions on
``--device cpu``. On the CPU any bond size and ring bond trains, as in the
JAX runner; on CUDA a string outside the kernels' scope (a ring bond over
4, a bond over 8) is refused before training (ROADMAP item 16).

The train state (``train_state_latest.npz``: the cores, the torch
optimizer's state with the warmup's step, the epoch and step in it, the
best accuracy and the epochs without improvement) is saved after every
epoch and, with ``--preempt-save`` (on by default), after the step in
flight when SIGTERM comes; ``--resume-from`` restores it and fast-forwards
the epoch-shuffle RNG and the epoch's batches, so the resumed run ends on
the unbroken run's bits. ``--tb-log-every-n-epochs`` (10 by default; 0
turns it off) logs, into ``metrics.jsonl`` (and TensorBoard events where
the ``tensorboard`` package is installed), the validation metrics, the lr,
the weights' and the gradients' histograms on a probe batch (the forward
K10 and backward K11 on a card), each string's output on that batch and
each string's TT mean and std. ``--profile-dir`` writes a
``torch.profiler`` trace of the ``--profile-iters`` window.

``--export-artifact`` writes the final cores as a ConvSBS deployment
artifact (``cli/export.py``: raw pixels in, every string through the
``sbs_fwd`` operator) on ``--device`` after training; with
``--shuffle-pixels`` it is refused before training, since the artifact
would not hold the pixel permutation.

``--mesh-devices N`` (and ``--distributed``, as in the EPS runner:
``parallel/``) trains data parallel over N ranks, one per card: the pixel
splits sharded on the sample axis, the cores replicated, each epoch's
per-shard orders drawn from the one ``default_rng(seed + 1)`` chain as the
JAX runner draws them (legacy_runner.py:414-470), one all-reduce a step,
the validation scored over the shards; SIGTERM is agreed every
``--preempt-sync-steps`` steps. Global rank 0 writes the checkpoints, the
train state and the artifact; local rank 0 of another host writes its
logs to ``<models-dir>-proc<PID>``. A train state resumes on any rank
count; a mid-epoch position the new step grid lacks restarts that epoch
(legacy_runner.py:633-640). With ranks, ``run`` returns rank 0's cores on
the CPU.

``--autotune-kernels`` measures each layer's fold (family and merge
position, ``train/autotune.autotune_conv_sbs``) on ``--device`` at the
per-rank batch with the training objective, keeps picks that win end to
end, and trains at them (``ConvSBSModelConfig.kernel_tuning``; rank 0
measures and broadcasts); the report goes to ``autotune_report.json``.
``--autotune-cache`` (off by default here, on in the JAX runner) reuses and
stores measured picks, and alone applies the cached ones. An
``--export-artifact`` takes serving-objective picks only: measured at the
largest export batch with ``--autotune-kernels``, looked up under the
serving key with ``--autotune-cache``, else the kernels' own picks.

The inits draw from a ``torch.Generator`` seeded with ``--seed``, so a seed
gives other weights than in the JAX runner; pass ``--init-load-file`` to
start both from the same ones.

Run: ``python -m dctn_tpu_torch.cli.legacy_runner --ds-path synthetic
--models-dir runs/legacy --num-sbs-layers 2 --bond-dim-size 4 [--trace-edge]
[--device cpu]``
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import random
import time
from types import SimpleNamespace

import click
import numpy as np
import torch

from ..data import io as data_io
from ..interop import (
    conv_sbs_params_from_numpy,
    conv_sbs_params_from_state_dict,
    is_torch_checkpoint,
    load_torch_state_dict,
)
from ..models.conv_sbs_model import (
    ConvSBSModel,
    ConvSBSModelConfig,
    calc_std_of_coordinates_of_windows,
    check_kernel_scope,
    init_conv_sbs_model,
    make_legacy_optimizer,
    make_warmup_lr_schedule,
    scale_layers_using_batch,
)
from ..ops import sbs
from ..train.checkpoint import (
    AsyncWriter,
    conv_sbs_train_state_arrays,
    load_conv_sbs_params_npz,
    load_conv_sbs_train_state,
    save_conv_sbs_params_npz,
)
from ..train.intermediate_logger import (
    DEFAULT_TRANSFORMS,
    conv_sbs_model_named_outputs,
    log_named_outputs,
    log_tree_histograms,
)
from ..train.preemption import PreemptionHandler
from ..parallel import plan_job, spawn
from ..train.tb_logging import MetricsWriter, log_conv_sbs_tt_statistics
from ..utils.profiling import StepTracer
from .runner import setup_run_provenance
from .specs import fill_defaults

logger = logging.getLogger(__name__)

MNIST_DATASET_SIZE = 60000

INITIALIZERS = {
    "dumb-normal": sbs.init_dumb_normal,
    "khrulkov-normal": sbs.init_khrulkov_normal,
    "normal-preserving-output-std": sbs.init_normal_preserving_output_std,
    "min-random-eye": sbs.init_min_random_eye,
}

def permute_pixels_batch(images: np.ndarray, permutation) -> np.ndarray:
    n, h, w = images.shape
    return images.reshape(n, h * w)[:, permutation].reshape(n, h, w)


@click.command()
@click.option("--ds-path", type=str, required=True, help="MNIST root, or 'synthetic'")
@click.option("--models-dir", type=click.Path(file_okay=False), required=True)
@click.option("--init-load-file", type=click.Path(exists=True, dir_okay=False))
@click.option("--train-dataset-size", "-t", type=int, default=58000)
@click.option("--num-sbs-layers", type=int, default=2)
@click.option("--bond-dim-size", type=int, default=2)
@click.option("--trace-edge", is_flag=True)
@click.option("--learning-rate", "-r", type=float, default=1e-2)
@click.option("--momentum", type=float, default=0.0)
@click.option("--batch-size", "-b", type=int, default=100)
@click.option("--initialization", type=click.Choice(tuple(INITIALIZERS)), default="khrulkov-normal")
@click.option("--initialization-std", type=float, default=None)
@click.option("--scale-layers-using-batch", type=int, default=None,
              help="pass the batch size for data-dependent layer rescaling")
@click.option("--epochs", type=int, default=5000)
@click.option("--early-stopping-patience-num-epochs", type=int, default=None)
@click.option("--warmup-num-epochs", "-w", type=int, default=40)
@click.option("--warmup-initial-multiplier", type=float, default=1e-20)
@click.option("--cos-sin-squared", is_flag=True)
@click.option("--make-input-window-std-one", is_flag=True)
@click.option("--input-multiplier", type=float, default=None)
@click.option("--optimizer-type", type=click.Choice(("sgd", "rmsprop")), default="sgd")
@click.option("--rmsprop-alpha", type=float, default=0.99)
@click.option("--weight-decay", type=float, default=0.0)
@click.option("--shuffle-pixels", is_flag=True)
@click.option("--mesh-devices", type=int, default=1,
              help="data parallel over this many ranks, one per card (CPU replicas with "
                   "--device cpu): replicated cores, pixel splits sharded on the sample axis, "
                   "one gradient all-reduce a step")
@click.option("--autotune-kernels/--no-autotune-kernels", default=False,
              help="measure each layer's ConvSBS fold (family, merge position) on --device "
                   "and train with the fastest that wins end to end "
                   "(train/autotune.autotune_conv_sbs); --export-artifact re-tunes with the "
                   "serving objective at the largest export batch")
@click.option("--autotune-cache/--no-autotune-cache", default=False,
              help="reuse and store measured picks in train/autotune.default_cache_path() "
                   "($DCTN_TPU_TORCH_AUTOTUNE_CACHE); alone, apply cached picks (serving ones "
                   "to an export). Off by default here, on in the JAX runner")
@click.option("--export-artifact", type=click.Path(dir_okay=False), default=None,
              help="after training, export the final cores as a deployment artifact "
                   "(cli/export.py) on --device")
@click.option("--export-batch-sizes", type=str, default="1,100",
              help="serving batch sizes for --export-artifact")
@click.option("--resume-from", type=click.Path(exists=True, dir_okay=False), default=None,
              help="train_state_latest.npz of an earlier (maybe preempted) run: restores the "
                   "cores, the optimizer with the warmup's step, the epoch and step and the "
                   "best-model bookkeeping, and continues the trajectory exactly")
@click.option("--preempt-sync-steps", type=int, default=16,
              help="under --mesh-devices > 1, steps between the ranks' agreements on a "
                   "preemption stop (they all stop at the same step)")
@click.option("--preempt-save/--no-preempt-save", default=True,
              help="on SIGTERM: finish the step in flight, save the train state, stop "
                   "(--resume-from train_state_latest.npz continues the trajectory)")
@click.option("--profile-dir", type=click.Path(file_okay=False), default=None,
              help="write a torch.profiler trace (CPU and CUDA activity) of the "
                   "--profile-iters window of steps into this directory")
@click.option("--profile-iters", nargs=2, type=int, default=(10, 5),
              help="START COUNT window for --profile-dir")
@click.option("--seed", type=int, default=0)
@click.option("--synthetic-sizes", nargs=2, type=int, default=(2048, 512))
@click.option("--tb-log-every-n-epochs", type=int, default=10,
              help="every this many epochs log the validation metrics, the lr, weight and "
                   "probe-gradient histograms, the strings' outputs and TT statistics into "
                   "metrics.jsonl (0: off)")
@click.option("--distributed", default=None,
              help="'HOST:PORT,NPROC,PID': this is host process PID of NPROC, each starting its "
                   "share of --mesh-devices ranks, meeting at HOST:PORT; 'auto': torchrun's ranks")
@click.option("--device", default="cuda",
              help="torch device: cuda (the kernels) or cpu (their plain versions)")
def main(**kw) -> None:
    run(**kw)


def _tuned_config(kw: dict, cfg: ConvSBSModelConfig, image_size: int, batch: int, device,
                  mesh, writes_logs: bool) -> ConvSBSModelConfig:
    """``cfg`` with the training-objective fold picks (legacy_runner.py:
    269-350): measured with ``--autotune-kernels``, cached ones with
    ``--autotune-cache`` alone; rank 0 measures or looks up and broadcasts."""
    if not (kw["autotune_kernels"] or kw["autotune_cache"]):
        return cfg
    from ..train.autotune import autotune_conv_sbs, conv_sbs_cache_lookup, default_cache_path

    cache = default_cache_path() if kw["autotune_cache"] else None
    tuning = report = None
    if mesh is None or mesh.is_primary:
        if kw["autotune_kernels"]:
            tuning, report = autotune_conv_sbs(cfg, image_size, batch, device=device,
                                               log_fn=logger.info, seed=kw["seed"],
                                               cache_path=cache)
        else:
            tuning = conv_sbs_cache_lookup(cfg, image_size, batch, device=device,
                                           log_fn=logger.info, cache_path=cache)
    if mesh is not None:
        tuning = mesh.broadcast_object(tuning)
        if not mesh.is_primary and kw["autotune_kernels"]:
            report = [{"broadcast_from_rank_0": True, "picks": tuning}]
    if report is not None and writes_logs:
        with open(os.path.join(kw["models_dir"], "autotune_report.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
    if not tuning or not any(tuning):
        return cfg
    logger.info("conv_sbs kernel_tuning: %s", tuning)
    return dataclasses.replace(cfg, kernel_tuning=tuple(tuning))


def _serving_tuning(kw: dict, cfg: ConvSBSModelConfig, image_size: int, batch: int,
                    device) -> tuple:
    """An artifact's fold picks, at the SERVING objective only: measured at
    ``batch`` with ``--autotune-kernels``, looked up under the serving key
    with ``--autotune-cache`` alone, else () (the kernels' own picks).
    Never the training picks."""
    if not (kw["autotune_kernels"] or kw["autotune_cache"]):
        return ()
    from ..train.autotune import autotune_conv_sbs, conv_sbs_cache_lookup, default_cache_path

    base = dataclasses.replace(cfg, kernel_tuning=())
    cache = default_cache_path() if kw["autotune_cache"] else None
    if kw["autotune_kernels"]:
        tuning, _ = autotune_conv_sbs(base, image_size, batch, device=device, forward_only=True,
                                      log_fn=logger.info, seed=kw["seed"], cache_path=cache)
    else:
        tuning = conv_sbs_cache_lookup(base, image_size, batch, device=device,
                                       forward_only=True, log_fn=logger.info, cache_path=cache)
    logger.info("export: serving-objective kernel picks %s", tuning)
    return tuple(tuning) if tuning and any(tuning) else ()


def _load_init(path: str, template):
    """Params from an npz of either package, or a reference torch
    ``state_dict``; shapes checked against ``template``."""
    if is_torch_checkpoint(path):
        loaded = conv_sbs_params_from_state_dict(load_torch_state_dict(path))
        logger.info("loaded reference torch state_dict from %s", path)
    else:
        loaded = load_conv_sbs_params_npz(path)
    got = [tuple(c.shape) for layer in loaded for s in layer for c in s]
    want = [tuple(c.shape) for layer in template for s in layer for c in s]
    if got != want:
        raise click.BadParameter(
            f"--init-load-file {path} does not match this model: cores {got} vs {want}"
        )
    return loaded


def _score(model: ConvSBSModel, x: torch.Tensor, y: torch.Tensor):
    """Mean CE and accuracy over a split, in one forward."""
    with torch.no_grad():
        logits = model(x)
        ce = torch.nn.functional.cross_entropy(logits, y)
        acc = (logits.argmax(1) == y).float().mean()
    return float(ce), float(acc)


def run(**kw):
    kw = fill_defaults(main, kw)
    if kw["export_artifact"] and kw["shuffle_pixels"]:
        # the artifact holds the quantum map and the multiplier but not the
        # host's pixel permutation: it would mis-serve raw images
        raise click.UsageError("--export-artifact with --shuffle-pixels is not supported")
    if kw["make_input_window_std_one"] and kw["input_multiplier"] is not None:
        raise click.BadParameter(
            "--make-input-window-std-one computes the input scaling from the data — it "
            "conflicts with an explicit --input-multiplier; pass one or the other"
        )
    if kw["mesh_devices"] < 1 or kw["batch_size"] % kw["mesh_devices"]:
        raise click.BadParameter(
            f"--batch-size {kw['batch_size']} must be divisible by --mesh-devices "
            f"{kw['mesh_devices']} (each rank takes an equal sub-batch)"
        )
    device = torch.device(kw["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise click.BadParameter(f"--device {device}: no CUDA device is available")
    try:
        job = plan_job(kw["mesh_devices"], kw["distributed"], device.type)
    except ValueError as e:
        raise click.BadParameter(str(e)) from None
    if job is None:
        return _run(kw, device, None)
    params, best_acc = spawn(_run_rank, job, kw)
    return params, best_acc


def _run_rank(mesh, kw: dict):
    """One rank's run; local rank 0's cores (on the CPU) and best accuracy
    go back to ``run``."""
    params, best_acc = _run(kw, mesh.device, mesh)
    return tuple(tuple(tuple(c.cpu() for c in s) for s in layer) for layer in params), best_acc


def _run(kw: dict, device: torch.device, mesh):
    """The run on one device (``mesh`` None), or one rank's share of a
    data-parallel run."""
    primary = mesh is None or mesh.is_primary
    writes_logs = mesh is None or mesh.writes_logs
    if mesh is not None and mesh.node != 0:
        # another host's logs and provenance, beside the primary's files
        kw = dict(kw, models_dir=f"{kw['models_dir']}-proc{mesh.node}")
    if writes_logs:
        os.makedirs(kw["models_dir"], exist_ok=True)
        setup_run_provenance(kw["models_dir"], kw)
    else:
        logging.basicConfig(level=logging.WARNING, force=True,
                            format=f"rank {mesh.rank}: %(name)s - %(levelname)s - %(message)s")

    # data: the train split into train/val (random_split analog)
    if kw["ds_path"] == "synthetic":
        n_tr, n_val = kw["synthetic_sizes"]
        images, labels = data_io.synthetic_mnist_like(n_tr + n_val, seed=1234)
    else:
        raw, labels = data_io.load_mnist_like(kw["ds_path"], "MNIST", train=True)
        images = raw.astype(np.float32) / 255.0
        assert len(images) == MNIST_DATASET_SIZE
        n_val = MNIST_DATASET_SIZE - kw["train_dataset_size"]
    if kw["shuffle_pixels"]:
        random.seed(kw["seed"])
        perm = random.sample(range(images.shape[1] * images.shape[2]),
                             images.shape[1] * images.shape[2])
        logger.info("pixel shuffle hash=%d", hash(tuple(perm)))
        images = permute_pixels_batch(images, perm)
    order = np.random.default_rng(kw["seed"]).permutation(len(images))
    tr_idx, val_idx = order[: len(images) - n_val], order[len(images) - n_val :]
    labels = labels.astype(np.int64)
    x_tr_host, y_tr_host = images[tr_idx], labels[tr_idx]

    # the input multiplier (mnist.py:434-445)
    multiplier = kw["input_multiplier"] or 1.0
    if kw["make_input_window_std_one"]:
        std = float(calc_std_of_coordinates_of_windows(
            torch.as_tensor(x_tr_host[:4096]), 3, kw["cos_sin_squared"], 1.0))
        # a window coordinate is a product of K² factors, each linear in the
        # multiplier, so its std scales as multiplier^(K²)
        multiplier = std ** (-1.0 / 9.0)
        logger.info("window std=%s → input multiplier=%s", std, multiplier)

    cfg = ConvSBSModelConfig(
        num_sbs_layers=kw["num_sbs_layers"], bond_dim_size=kw["bond_dim_size"],
        trace_edge=kw["trace_edge"], cos_sin_squared=kw["cos_sin_squared"],
        input_multiplier=multiplier,
    )
    check_kernel_scope(cfg, device.type == "cuda")
    image_size = int(images.shape[1])
    world = 1 if mesh is None else mesh.world_size
    cfg = _tuned_config(kw, cfg, image_size, kw["batch_size"] // world, device, mesh,
                        writes_logs)
    init_kwargs = {}
    if kw["initialization_std"] is not None:
        init_kwargs = {
            "dumb-normal": {"std": kw["initialization_std"]},
            "khrulkov-normal": {"std_of_matrix": kw["initialization_std"]},
            "normal-preserving-output-std": {},
            "min-random-eye": {"base_std": kw["initialization_std"]},
        }[kw["initialization"]]
    elif kw["initialization"] == "min-random-eye":
        init_kwargs = {"base_std": 1e-3}
    params = init_conv_sbs_model(torch.Generator().manual_seed(kw["seed"]), cfg,
                                 INITIALIZERS[kw["initialization"]], **init_kwargs)
    if kw["init_load_file"]:
        params = conv_sbs_params_from_numpy(_load_init(kw["init_load_file"], params),
                                            dtype=torch.float32)
    params = tuple(tuple(tuple(c.to(device) for c in s) for s in layer) for layer in params)
    if kw["scale_layers_using_batch"]:
        params = scale_layers_using_batch(params, cfg, torch.as_tensor(
            x_tr_host[: kw["scale_layers_using_batch"]], device=device))
    model = ConvSBSModel(params, cfg)
    per_dev = kw["batch_size"] // world
    if mesh is None:
        x_tr = torch.as_tensor(x_tr_host, device=device)
        y_tr = torch.as_tensor(y_tr_host, device=device)
        x_val = torch.as_tensor(images[val_idx], device=device)
        y_val = torch.as_tensor(labels[val_idx], device=device)
    else:
        from ..parallel import (
            make_parallel_pixel_score_fn,
            make_parallel_pixel_train_step,
            replicate,
            shard_pixel_split,
        )

        replicate(mesh, model.parameters())
        tr_split = shard_pixel_split(mesh, x_tr_host, y_tr_host)
        val_split = shard_pixel_split(mesh, images[val_idx], labels[val_idx])
        x_tr, y_tr = tr_split.x, tr_split.y  # this rank's shard
        valid_per_shard = tr_split.valid_per_shard
        dp_score = make_parallel_pixel_score_fn(lambda _, xb: model(xb), mesh, per_dev)
        logger.info("data parallelism: %d ranks (%s), %d samples a rank a step", world,
                    mesh.backend, per_dev)

    # the optimizer under the exponential warmup, one scheduler step per update
    steps_per_epoch = max(len(y_tr_host) // kw["batch_size"], 1)
    opt = make_legacy_optimizer(
        kw["optimizer_type"], model.parameters(), kw["learning_rate"],
        momentum=kw["momentum"], rmsprop_alpha=kw["rmsprop_alpha"],
        weight_decay=kw["weight_decay"],
    )
    lr_multiplier = make_warmup_lr_schedule(
        kw["warmup_num_epochs"], steps_per_epoch, kw["warmup_initial_multiplier"])
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lr_multiplier)

    # the full-resume restore (legacy_runner.py:394-413)
    resume_epoch, resume_step = 0, 0
    best_acc, best_file, bad_epochs = -1.0, None, 0
    if kw["resume_from"]:
        try:
            warmup_step, resume_epoch, resume_step, best_acc, bad_epochs = (
                load_conv_sbs_train_state(kw["resume_from"], model, opt))
        except (KeyError, ValueError) as e:
            raise click.ClickException(f"--resume-from {kw['resume_from']}: {e}") from None
        # the scheduler at the saved step: LambdaLR's lr is base·multiplier(step)
        sched.last_epoch = warmup_step
        for group, base in zip(opt.param_groups, sched.base_lrs):
            group["lr"] = base * lr_multiplier(warmup_step)
        sched._last_lr = [group["lr"] for group in opt.param_groups]
        logger.info("resumed train state from %s at epoch %d step %d",
                    kw["resume_from"], resume_epoch, resume_step)

    tb_every = kw["tb_log_every_n_epochs"] if writes_logs else 0
    tb_writer = None
    if tb_every:
        tb_writer = MetricsWriter(kw["models_dir"])
        probe_n = min(kw["batch_size"], len(y_tr_host))
        x_probe = torch.as_tensor(x_tr_host[:probe_n], device=device)
        y_probe = torch.as_tensor(y_tr_host[:probe_n], device=device)
        layer_specs = cfg.layer_specs()

        def log_tb(it: int) -> None:
            """The weights, their gradients on the probe batch (the kernels'
            forward and backward on a card), the strings' outputs on it and
            their TT statistics (legacy_runner.py:529-560)."""
            params = model.params()
            tb_writer.add_scalar("lr", kw["learning_rate"] * lr_multiplier(it), it)
            log_tree_histograms(tb_writer, params, it, "weights")
            loss = torch.nn.functional.cross_entropy(model(x_probe), y_probe)
            leaves = [c for layer in params for string in layer for c in string]
            grads = iter(torch.autograd.grad(loss, leaves))
            grad_tree = tuple(tuple(tuple(next(grads) for _ in string) for string in layer)
                              for layer in params)
            log_tree_histograms(tb_writer, grad_tree, it, "grads")
            with torch.no_grad():
                named = conv_sbs_model_named_outputs(params, cfg, x_probe)
                log_named_outputs(tb_writer, named, it, DEFAULT_TRANSFORMS)
                log_conv_sbs_tt_statistics(tb_writer, {
                    f"layer{i}.string{j}": (spec, cores)
                    for i, (specs_l, cores_l) in enumerate(zip(layer_specs, params))
                    for j, (spec, cores) in enumerate(zip(specs_l, cores_l))
                }, it)

    tracer = None
    if kw["profile_dir"] and writes_logs:
        tracer = StepTracer(kw["profile_dir"] if mesh is None or mesh.node == 0
                            else f"{kw['profile_dir']}-proc{mesh.node}", *kw["profile_iters"])
    writer = AsyncWriter()
    state_file = os.path.join(kw["models_dir"], "train_state_latest.npz")

    def save_train_state(epoch: int, step_in_epoch: int) -> None:
        if not primary:  # the replicated state is written once, by rank 0
            return
        writer.submit(conv_sbs_train_state_arrays(
            model.params(), opt, sched.last_epoch, epoch, step_in_epoch, best_acc, bad_epochs,
        ), state_file)

    # the epoch's batches: a permutation of the split, or under data
    # parallelism one of each shard's valid samples (rank d takes its own),
    # all drawn from one seeded chain on every rank (legacy_runner.py:447-460)
    rng = np.random.default_rng(kw["seed"] + 1)
    if mesh is None:
        steps_this_epoch = steps_per_epoch

        def draw_epoch():
            return torch.as_tensor(rng.permutation(len(y_tr_host)), device=device)
    else:
        steps_this_epoch = max(min(valid_per_shard) // per_dev, 1)
        dp_step = make_parallel_pixel_train_step(model, opt, mesh)

        def draw_epoch():
            orders = [rng.permutation(v) for v in valid_per_shard]
            return torch.as_tensor(orders[mesh.rank], device=device)
    # fast-forward the epoch-shuffle RNG over the epochs done, so that the
    # resumed run takes the batches the unbroken one would
    for _ in range(resume_epoch):
        draw_epoch()
    if resume_step > steps_this_epoch:
        # an elastic resume onto fewer ranks or a larger batch: the saved
        # mid-epoch position is not on this step grid (legacy_runner.py:633-640)
        logger.warning(
            "saved step-in-epoch %d exceeds this configuration's %d steps per epoch (the batch "
            "size or the rank count changed): resuming at the start of epoch %d",
            resume_step, steps_this_epoch, resume_epoch,
        )
        resume_step = 0
    preempt = PreemptionHandler() if kw["preempt_save"] else None
    sync_every = max(1, kw["preempt_sync_steps"])

    def preempt_fired_now(global_step: int) -> bool:
        """On one device, whether SIGTERM came; under data parallelism
        every ``--preempt-sync-steps`` steps whether it came to any rank
        (every rank asks at the same steps)."""
        if preempt is None:
            return False
        if mesh is None:
            return preempt.fired is not None
        return global_step % sync_every == 0 and mesh.any(preempt.fired is not None)

    preempted = False
    loss = torch.full((), float("nan"))
    with preempt if preempt is not None else contextlib.nullcontext():
        for epoch in range(resume_epoch, kw["epochs"]):
            perm = draw_epoch()
            skip = resume_step if epoch == resume_epoch else 0
            for s in range(skip, steps_this_epoch):
                if tracer is not None:
                    tracer(SimpleNamespace(num_iters_done=epoch * steps_this_epoch + s))
                idx = perm[s * per_dev : (s + 1) * per_dev]
                if mesh is None:
                    opt.zero_grad(set_to_none=True)
                    loss = torch.nn.functional.cross_entropy(model(x_tr[idx]), y_tr[idx])
                    loss.backward()
                    opt.step()
                else:
                    loss = dp_step(x_tr[idx], y_tr[idx])
                sched.step()
                if preempt_fired_now(epoch * steps_this_epoch + s + 1):
                    # the step in flight is done: resume at batch s + 1
                    save_train_state(epoch, s + 1)
                    logger.info("training stopped: preempted (%s) at epoch %d step %d; train "
                                "state saved for --resume-from",
                                preempt.fired or "a signal on another rank", epoch, s + 1)
                    preempted = True
                    break
            if preempted:
                break
            if mesh is None:
                vce, vacc = _score(model, x_val, y_val)
            else:
                vce, vacc = (float(v) for v in dp_score(None, val_split))
            logger.info("epoch %d: val ce=%.5f acc=%.2f%%", epoch, vce, vacc * 100)
            if tb_every and epoch % tb_every == 0:
                t0 = time.perf_counter()
                it = (epoch + 1) * steps_per_epoch
                tb_writer.add_scalar("val/mean_ce", vce, it)
                tb_writer.add_scalar("val/acc", vacc, it)
                tb_writer.add_scalar("train/last_batch_loss", float(loss.detach()), it)
                log_tb(it)
                tb_writer.flush()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                logger.info("TB log at iteration %d: %.3f ms", it, 1e3 * (time.perf_counter() - t0))
            if vacc > best_acc:
                best_acc, bad_epochs = vacc, 0
                if primary:
                    new_file = os.path.join(kw["models_dir"],
                                            f"dctn_epoch={epoch}_vacc={vacc:.4f}.npz")
                    save_conv_sbs_params_npz(model.params(), new_file)
                    if best_file and os.path.exists(best_file):
                        os.remove(best_file)
                    best_file = new_file
            else:
                bad_epochs += 1
                patience = kw["early_stopping_patience_num_epochs"]
                if patience is not None and bad_epochs > patience:
                    logger.info("early stopping at epoch %d", epoch)
                    break
            # the epoch is done, with its eval and bookkeeping: a hard kill
            # loses at most one epoch
            save_train_state(epoch + 1, 0)
    if tracer is not None:
        tracer.close()
    if tb_writer is not None:
        tb_writer.close()
    writer.wait()
    params = tuple(tuple(tuple(c.detach() for c in s) for s in layer) for layer in model.params())
    if kw["export_artifact"] and primary:
        from .export import build_meta, export_conv_sbs_forward, parse_batch_sizes, write_artifact

        bss = parse_batch_sizes(kw["export_batch_sizes"])
        export_cfg = dataclasses.replace(cfg, kernel_tuning=_serving_tuning(
            kw, cfg, image_size, max(bss), device))
        write_artifact(
            kw["export_artifact"],
            export_conv_sbs_forward(params, export_cfg, batch_sizes=bss, image_size=image_size,
                                    device=device)[0],
            build_meta(
                model_family="conv_sbs", image_size=image_size, batch_sizes=bss,
                backend="pallas", platforms=[device.type], num_sbs_layers=cfg.num_sbs_layers,
                bond_dim_size=cfg.bond_dim_size, trace_edge=cfg.trace_edge,
                cos_sin_squared=cfg.cos_sin_squared, input_multiplier=cfg.input_multiplier,
                num_labels=cfg.num_labels,
            ),
        )
        logger.info("deployment artifact written to %s (bs %s)", kw["export_artifact"], sorted(bss))
    return params, best_acc


if __name__ == "__main__":
    main()
