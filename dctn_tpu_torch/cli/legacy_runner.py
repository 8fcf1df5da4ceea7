"""The legacy ConvSBS MNIST runner of the port (``dctn_tpu/cli/legacy_runner.py``,
reference ``mnist.py:314-596``): the same click flags and the same
``run(**kw)`` → ``(params, best_acc)`` contract, for one device.

Covers the single-device path of the JAX runner: synthetic or MNIST data
and the seeded train/val split, ``--shuffle-pixels``, the input multiplier
or ``--make-input-window-std-one``, the four SBS inits with
``--initialization-std``, ``--init-load-file`` (the npz of either package,
or a reference torch ``state_dict``), ``--scale-layers-using-batch``, the
exponential warmup with SGD or RMSprop, the epoch loop in the JAX runner's
batch order (``np.random.default_rng(seed + 1)``), per-epoch validation CE
and accuracy, the best-checkpoint npz (``dctn_epoch=…_vacc=….npz``, keys
``{layer}/{string}/{core}``, readable by the JAX package's ``load_pytree``)
and epoch-patience early stopping. Every string runs through the ConvSBS
kernels on ``--device cuda`` (the default) and their plain versions on
``--device cpu``.

Refused until their slices land (ROADMAP names each): ``--mesh-devices`` > 1
and ``--distributed`` (multi-GPU DP), ``--autotune-kernels`` and
``--autotune-cache`` (the autotuner), ``--export-artifact`` (export),
``--resume-from`` and ``--preempt-save`` (train-state saves and resume),
``--profile-dir`` and a nonzero ``--tb-log-every-n-epochs`` (TB logging and
TT statistics). The three of them that are on by default in JAX
(``--autotune-cache``, ``--preempt-save``, ``--tb-log-every-n-epochs 10``)
are off by default here.

The inits draw from a ``torch.Generator`` seeded with ``--seed``, so a seed
gives other weights than in the JAX runner; pass ``--init-load-file`` to
start both from the same ones.

Run: ``python -m dctn_tpu_torch.cli.legacy_runner --ds-path synthetic
--models-dir runs/legacy --num-sbs-layers 2 --bond-dim-size 4 [--trace-edge]
[--device cpu]``
"""

from __future__ import annotations

import json
import logging
import os
import random

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
from ..train.checkpoint import load_conv_sbs_params_npz, save_conv_sbs_params_npz

logger = logging.getLogger(__name__)

MNIST_DATASET_SIZE = 60000

INITIALIZERS = {
    "dumb-normal": sbs.init_dumb_normal,
    "khrulkov-normal": sbs.init_khrulkov_normal,
    "normal-preserving-output-std": sbs.init_normal_preserving_output_std,
    "min-random-eye": sbs.init_min_random_eye,
}

# each refused flag, the value that means "off", and the ROADMAP slice that ports it
REFUSED = (
    ("mesh_devices", 1, "--mesh-devices > 1", "multi-GPU DP for the legacy family (slice 7)"),
    ("distributed", None, "--distributed", "multi-GPU DP for the legacy family (slice 7)"),
    ("autotune_kernels", False, "--autotune-kernels", "the autotuner (slice 8, item 20)"),
    ("autotune_cache", False, "--autotune-cache", "the autotuner (slice 8, item 20)"),
    ("export_artifact", None, "--export-artifact", "export and serve (slice 6, item 18)"),
    ("resume_from", None, "--resume-from", "train-state saves and resume (slice 4, item 13)"),
    ("preempt_save", False, "--preempt-save", "train-state saves and resume (slice 4, item 13)"),
    ("profile_dir", None, "--profile-dir", "TB logging and TT statistics (slice 4, item 13)"),
    ("tb_log_every_n_epochs", 0, "--tb-log-every-n-epochs != 0",
     "TB logging and TT statistics (slice 4, item 13)"),
)


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
              help="not ported yet (multi-GPU DP, ROADMAP slice 7): only 1 is accepted")
@click.option("--autotune-kernels/--no-autotune-kernels", default=False,
              help="not ported yet (the autotuner, ROADMAP item 20)")
@click.option("--autotune-cache/--no-autotune-cache", default=False,
              help="not ported yet (the autotuner, ROADMAP item 20); off by default "
                   "here, on in the JAX runner")
@click.option("--export-artifact", type=click.Path(dir_okay=False), default=None,
              help="not ported yet (export, ROADMAP item 18)")
@click.option("--export-batch-sizes", type=str, default="1,100",
              help="serving batch sizes for --export-artifact")
@click.option("--resume-from", type=click.Path(exists=True, dir_okay=False), default=None,
              help="not ported yet (train-state saves and resume, ROADMAP item 13)")
@click.option("--preempt-sync-steps", type=int, default=16,
              help="with --distributed, steps between preemption agreements")
@click.option("--preempt-save/--no-preempt-save", default=False,
              help="not ported yet (train-state saves and resume, ROADMAP item 13); off by "
                   "default here, on in the JAX runner")
@click.option("--profile-dir", type=click.Path(file_okay=False), default=None,
              help="not ported yet (ROADMAP item 13)")
@click.option("--profile-iters", nargs=2, type=int, default=(10, 5),
              help="START COUNT window for --profile-dir")
@click.option("--seed", type=int, default=0)
@click.option("--synthetic-sizes", nargs=2, type=int, default=(2048, 512))
@click.option("--tb-log-every-n-epochs", type=int, default=0,
              help="not ported yet (TB logging and TT statistics, ROADMAP item 13): only 0 "
                   "is accepted; the JAX runner's default is 10")
@click.option("--distributed", default=None,
              help="not ported yet (multi-GPU DP, ROADMAP slice 7)")
@click.option("--device", default="cuda",
              help="torch device: cuda (the kernels) or cpu (their plain versions)")
def main(**kw) -> None:
    run(**kw)


def _fill_defaults(kw: dict) -> dict:
    for param in main.params:
        if param.name not in kw:
            default = param.default
            if type(default).__name__ == "Sentinel":
                default = () if param.multiple else None
            kw[param.name] = default
    return kw


def _refuse_unported(kw: dict) -> None:
    for name, off, flag, slice_ in REFUSED:
        if kw[name] is not None and kw[name] != off:
            raise click.BadParameter(
                f"{flag} is not ported to the PyTorch runner yet: ROADMAP, {slice_}"
            )


def _setup_logging(models_dir: str, kw: dict) -> None:
    """run_info.txt (the run's flags as JSON) and console + log.log logging,
    as the JAX runners write them (runner.py:163-182, without the git
    provenance)."""
    with open(os.path.join(models_dir, "run_info.txt"), "w") as f:
        json.dump({k: v if isinstance(v, (int, float, str, bool, type(None))) else repr(v)
                   for k, v in kw.items()}, f, indent=2)
    logging.basicConfig(
        level=logging.INFO,
        handlers=(logging.StreamHandler(),
                  logging.FileHandler(os.path.join(models_dir, "log.log"), "w", "utf-8")),
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        force=True,
    )


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
    kw = _fill_defaults(kw)
    _refuse_unported(kw)
    device = torch.device(kw["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise click.BadParameter(f"--device {device}: no CUDA device is available")
    os.makedirs(kw["models_dir"], exist_ok=True)
    _setup_logging(kw["models_dir"], kw)
    if kw["make_input_window_std_one"] and kw["input_multiplier"] is not None:
        raise click.BadParameter(
            "--make-input-window-std-one computes the input scaling from the data — it "
            "conflicts with an explicit --input-multiplier; pass one or the other"
        )

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
    check_kernel_scope(cfg)
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
    x_tr = torch.as_tensor(x_tr_host, device=device)
    y_tr = torch.as_tensor(y_tr_host, device=device)
    x_val = torch.as_tensor(images[val_idx], device=device)
    y_val = torch.as_tensor(labels[val_idx], device=device)
    if kw["scale_layers_using_batch"]:
        params = scale_layers_using_batch(params, cfg, x_tr[: kw["scale_layers_using_batch"]])
    model = ConvSBSModel(params, cfg)

    # the optimizer under the exponential warmup, one scheduler step per update
    steps_per_epoch = max(len(y_tr_host) // kw["batch_size"], 1)
    opt = make_legacy_optimizer(
        kw["optimizer_type"], model.parameters(), kw["learning_rate"],
        momentum=kw["momentum"], rmsprop_alpha=kw["rmsprop_alpha"],
        weight_decay=kw["weight_decay"],
    )
    sched = torch.optim.lr_scheduler.LambdaLR(opt, make_warmup_lr_schedule(
        kw["warmup_num_epochs"], steps_per_epoch, kw["warmup_initial_multiplier"]))

    rng = np.random.default_rng(kw["seed"] + 1)
    best_acc, best_file, bad_epochs = -1.0, None, 0
    for epoch in range(kw["epochs"]):
        perm = torch.as_tensor(rng.permutation(len(y_tr_host)), device=device)
        for s in range(steps_per_epoch):
            idx = perm[s * kw["batch_size"] : (s + 1) * kw["batch_size"]]
            opt.zero_grad(set_to_none=True)
            loss = torch.nn.functional.cross_entropy(model(x_tr[idx]), y_tr[idx])
            loss.backward()
            opt.step()
            sched.step()
        vce, vacc = _score(model, x_val, y_val)
        logger.info("epoch %d: val ce=%.5f acc=%.2f%%", epoch, vce, vacc * 100)
        if vacc > best_acc:
            best_acc, bad_epochs = vacc, 0
            new_file = os.path.join(kw["models_dir"], f"dctn_epoch={epoch}_vacc={vacc:.4f}.npz")
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
    params = tuple(tuple(tuple(c.detach() for c in s) for s in layer) for layer in model.params())
    return params, best_acc


if __name__ == "__main__":
    main()
