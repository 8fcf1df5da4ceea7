"""Inference entry point of the port: load an npz checkpoint, emit
predictions and latency statistics (port of ``dctn_tpu/cli/predict.py``).

The checkpoint is the JAX package's reference-layout npz; the model runs
the fast (cmt) forward, whose EPS layers are the hand-written CUDA kernels
on ``--device cuda`` and their plain PyTorch versions on ``--device cpu``.
``--quantize int8`` serves the int8 W8A8 model (cores quantized once at
load, ``EPSesPlusLinearQ8``). A model with a layer outside the kernels'
plans has no fast layout (``FastLayoutUnavailable``): it is served by the
reference-layout forward, through the kernels for each layer they take and
the plain path for the others, with the fallback recorded, as JAX's
``_resolve_forward`` does (predict.py:98-135); ``--quantize int8`` then
raises. An artifact of ``cli/export.py`` serves in
place of the checkpoint: the model config and weights come from it (no
``--epses-specs``), every batch size used needs its entry point, and a
short last batch is padded with its first image and trimmed, since the
artifact's programs are static-shaped.

``--mesh-devices N`` serves an npz checkpoint data parallel from this one
process (JAX predict.py:291-300): a replica of the model (f32, or int8
with ``--quantize int8``) on each of ``cuda:0`` … ``cuda:N-1`` (CPU
replicas with ``--device cpu``), every batch split over them and the
logits gathered (``parallel.replicas``); no process group. A sharded
artifact brings its cards itself: N replicas by batch share (``export
--mesh-devices N``), or S by band of image rows (``export --space-devices
S``, the height-sharded artifact).

Usage:
  python -m dctn_tpu_torch.cli.predict CKPT.npz --ds-type fashionmnist \
      --ds-path synthetic --epses-specs "(4,4),(3,6)" --split test \
      --out preds.npy --latency-bench [--quantize int8]
  python -m dctn_tpu_torch.cli.predict model.zip --ds-type fashionmnist \
      --ds-path synthetic --split test --batch-size 128
"""

from __future__ import annotations

import dataclasses
import json
import time
import zipfile
from typing import Dict, Union

import click
import numpy as np
import torch

from ..data import load_dataset
from ..interop import params_from_numpy
from ..kernels.eps_kernels import objective_name
from ..models import (
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    EPSesPlusLinearQ8,
    EPSesPlusLinearReference,
    FastLayoutUnavailable,
    fast_layer_plans,
    layer_plans,
)
from ..parallel.replicas import ShardedForward, replica_devices
from ..train import load_params_npz
from .specs import parse_epses_specs


def _is_artifact(path: str) -> bool:
    """True iff ``path`` is an exported deployment artifact (a zip with
    meta.json) rather than an npz checkpoint."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as zf:
        return "meta.json" in zf.namelist()


def _check_params(params, cfg: EPSesPlusLinearConfig, channels: int) -> None:
    """Every leaf has the shape ``cfg`` implies (the JAX loader checks the
    same against its template)."""
    want = {f"epses/{i}": p["core_shape"] for i, p in enumerate(layer_plans(cfg, channels))}
    want["linear/w"] = (cfg.linear_in_features, cfg.num_classes)
    want["linear/b"] = (cfg.num_classes,)
    got = {f"epses/{i}": tuple(c.shape) for i, c in enumerate(params["epses"])}
    got.update({f"linear/{k}": tuple(v.shape) for k, v in params["linear"].items()})
    for key, shape in want.items():
        if got.get(key) != tuple(shape):
            raise ValueError(f"checkpoint leaf {key}: shape {got.get(key)} != model {tuple(shape)}")


def serving_model_kind(cfg: EPSesPlusLinearConfig, channels: int, quantize=None):
    """What builds the model that serves ``cfg`` from reference-layout
    params, ``(params, cfg) → model``: ``EPSesPlusLinearQ8`` for int8,
    ``EPSesPlusLinear`` where the kernels take every layer, else
    ``EPSesPlusLinearReference`` on the pallas backend (each layer the
    kernels take through them). Int8 without a fast layout raises
    ``FastLayoutUnavailable`` (predict.py:118-123)."""
    try:
        plans = fast_layer_plans(cfg, channels, objective_name(True, quantize, cfg.compute_dtype))
    except FastLayoutUnavailable:
        if quantize:
            raise
        return lambda params, cfg: EPSesPlusLinearReference(params, cfg, backend="pallas")
    kind = EPSesPlusLinearQ8 if quantize == "int8" else EPSesPlusLinear
    return lambda params, cfg: kind.from_reference(params, cfg, plans=plans)


def predict_split(forward, x: torch.Tensor, batch_size: int, pad: bool = False) -> np.ndarray:
    """Argmax predictions of ``forward`` over a (C, N, H, W, Q) split in
    batches. The last batch may be short, or with ``pad`` (a static-shaped
    artifact) is padded with its first image and trimmed."""
    preds = []
    for start in range(0, x.shape[1], batch_size):
        xb = x[:, start : start + batch_size]
        n = xb.shape[1]
        if pad and n < batch_size:
            xb = torch.cat([xb, xb[:, :1].expand(-1, batch_size - n, -1, -1, -1)], dim=1)
        preds.append(forward(xb)[:n].argmax(dim=1).cpu())
    return torch.cat(preds).numpy()


def _artifact_forward(path: str, batch_sizes, device):
    """(meta, cfg, entry points) of an eps-family artifact, with an entry
    point for every batch size in ``batch_sizes``; ``cfg.compute_dtype``
    is the artifact's (``meta["compute_dtype"]``: a bf16 artifact rounds
    its EPS operands inside its graph)."""
    from .export import load_artifact

    try:
        meta, fns = load_artifact(path, device)
    except ValueError as e:
        raise click.UsageError(str(e)) from None
    family = meta.get("model_family", "eps")
    if family != "eps":
        raise click.UsageError(f"predict serves eps-family artifacts; this one is {family!r}")
    missing = [bs for bs in batch_sizes if bs not in fns]
    if missing:
        raise click.UsageError(
            f"artifact has entry points for batch sizes {sorted(fns)}; missing {missing}: "
            "re-export with --batch-sizes"
        )
    cfg = EPSesPlusLinearConfig(
        epses_specs=tuple(tuple(s) for s in meta["epses_specs"]), image_size=meta["image_size"],
        q0=meta["q0"], num_classes=meta.get("num_classes", 10),
        compute_dtype=torch.bfloat16 if meta.get("compute_dtype") == "bfloat16" else None,
    )
    return meta, cfg, fns


def latency_stats(forward, x: torch.Tensor, batch_size: int, iters: int = 30,
                  devices=None) -> dict:
    """Per-call latency of ``forward``, each call fenced with
    ``torch.cuda.synchronize()`` on ``x``'s device and every one of
    ``devices`` (the replicas' cards), and the pipelined throughput of a
    window of calls with one fence at its end, timed with CUDA events on
    ``x``'s device, where the outputs are gathered (host clock on a CPU
    device)."""
    cuda = x.device.type == "cuda"
    fenced = {x.device, *(devices or ())}

    def fence():
        if cuda:
            for d in fenced:
                torch.cuda.synchronize(d)

    xb = x[:, :batch_size]
    forward(xb)
    fence()  # warm: the first call builds and loads the kernel
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        forward(xb)
        fence()
        times.append(time.perf_counter() - t0)
    times.sort()
    # the steady-state rate under a full request queue; a long window
    # amortizes the one fence at its end
    window = min(2048, max(iters, 49152 // batch_size))
    best = float("inf")
    for _ in range(3):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(window):
                forward(xb)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(window):
                forward(xb)
            best = min(best, time.perf_counter() - t0)
    return {
        "batch_size": batch_size,
        "device": torch.cuda.get_device_name(x.device) if cuda else "cpu",
        "p50_ms": 1e3 * times[len(times) // 2],
        "p90_ms": 1e3 * times[int(len(times) * 0.9)],
        "min_ms": 1e3 * times[0],
        "throughput_img_per_s": batch_size / times[len(times) // 2],
        "pipelined_throughput_img_per_s": batch_size * window / best,
        "calls": 1 + iters + 3 * window,
    }


@dataclasses.dataclass
class PredictRun:
    preds: np.ndarray
    accuracy: float
    latency: list  # one latency_stats dict per batch size
    forward_calls: int  # model forwards, prediction and latency together
    # the model that served: an artifact's entry points by batch size, or
    # under --mesh-devices the replicas, one per device
    model: Union[EPSesPlusLinear, EPSesPlusLinearQ8, Dict[int, torch.nn.Module], list]
    x: torch.Tensor  # the split it served, (C, N, H, W, Q) on its device


@click.command()
@click.argument("checkpoint", type=click.Path(exists=True, dir_okay=False))
@click.option("--ds-type", required=True)
@click.option("--ds-path", required=True)
@click.option("--epses-specs", type=parse_epses_specs, default=None,
              help="the model's EPS layers, e.g. '(4,4),(3,6)'; required for npz checkpoints, "
                   "artifacts carry their own")
@click.option("--phi-multiplier", type=float, default=None)
@click.option("--split", type=click.Choice(("train", "val", "test")), default="test")
@click.option("--batch-size", type=int, default=128)
@click.option("--out", type=click.Path(dir_okay=False), default=None,
              help="write predictions (int64 npy) here")
@click.option("--latency-bench", is_flag=True,
              help="print a JSON latency line for batch sizes 1 and --batch-size")
@click.option("--mesh-devices", type=int, default=1,
              help="serve on this many cards (CPU replicas with --device cpu), a model replica "
                   "on each, every batch split over them")
@click.option("--quantize", type=click.Choice(("none", "int8")), default="none",
              help="int8: W8A8 dynamic quantization of the EPS layers (npz checkpoints only: "
                   "artifacts bake their quantization at export time)")
@click.option("--device", default="cuda",
              help="torch device to run on: cuda (the kernels) or cpu (their plain versions)")
def main(checkpoint, ds_type, ds_path, epses_specs, phi_multiplier, split,
         batch_size, out, latency_bench, mesh_devices, quantize, device):
    run(checkpoint=checkpoint, ds_type=ds_type, ds_path=ds_path,
        epses_specs=epses_specs, phi_multiplier=phi_multiplier, split=split,
        batch_size=batch_size, out=out, latency_bench=latency_bench,
        mesh_devices=mesh_devices, quantize=quantize, device=device)


def run(*, checkpoint, ds_type, ds_path, epses_specs=None, phi_multiplier=None,
        split="test", batch_size=128, out=None, latency_bench=False,
        mesh_devices=1, quantize="none", synthetic_sizes=(8192, 2048, 2048),
        device="cuda") -> PredictRun:
    if quantize not in (None, "none", "int8"):
        raise click.UsageError(f"--quantize {quantize} is not supported: none or int8")
    if mesh_devices < 1:
        raise click.UsageError(f"--mesh-devices {mesh_devices}: at least one device")
    artifact = _is_artifact(checkpoint)
    if artifact and quantize == "int8":
        raise click.UsageError(
            "--quantize applies to npz checkpoints; artifacts bake their quantization at "
            "export time (export --quantize int8)"
        )
    if not artifact and not epses_specs:
        raise click.UsageError("--epses-specs is required for npz checkpoints")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise click.UsageError(f"--device {device}: no CUDA device is available")
    if artifact:
        needed = sorted({batch_size} | ({1, batch_size} if latency_bench else set()))
        meta, cfg, fns = _artifact_forward(checkpoint, needed, device)
        if mesh_devices not in (1, meta.get("mesh_devices", 1)):
            raise click.UsageError(
                f"--mesh-devices {mesh_devices}: the artifact serves on "
                f"{meta.get('mesh_devices', 1)} device(s) (export --mesh-devices)")
        epses_specs = cfg.epses_specs
    splits = load_dataset(
        ds_type, ds_path, phi_multiplier=phi_multiplier,
        autoscale_kernel_size=None if phi_multiplier else epses_specs[0][0],
        synthetic_sizes=synthetic_sizes,
    )
    sp = getattr(splits, split)
    channels, _, image_size, _, q0 = sp.x.shape
    if artifact:
        want = (meta.get("channels", channels), cfg.image_size, cfg.q0)
        if (channels, image_size, q0) != want:
            raise click.UsageError(
                f"dataset shape (channels={channels}, {image_size}, q0={q0}) does not match the "
                f"artifact (channels={want[0]}, {want[1]}, q0={want[2]})"
            )
        model = fns
        # a sharded artifact's cards: one a batch share (--mesh-devices) or
        # one a band of rows (--space-devices)
        cards = max(meta.get("mesh_devices", 1), meta.get("space_devices", 1))
        devices = ([torch.device(device.type, i) for i in range(cards)] if cards > 1
                   else [device])

        def call(xb):
            return fns[xb.shape[1]](xb)
    else:
        cfg = EPSesPlusLinearConfig(epses_specs=epses_specs, image_size=image_size, q0=q0)
        kind = serving_model_kind(cfg, channels, None if quantize == "none" else quantize)
        if mesh_devices == 1:
            devices = [device]
            params = params_from_numpy(load_params_npz(checkpoint), device, cfg.dtype)
            _check_params(params, cfg, channels)
            model = call = kind(params, cfg)
        else:
            try:
                devices = replica_devices(mesh_devices, device.type)
            except ValueError as e:
                raise click.UsageError(f"--mesh-devices {mesh_devices}: {e}") from None
            loaded = load_params_npz(checkpoint)
            _check_params(params_from_numpy(loaded, "cpu", cfg.dtype), cfg, channels)
            # each replica made on its own device, as the one-device model is
            model = [kind(params_from_numpy(loaded, d, cfg.dtype), cfg) for d in devices]
            call = ShardedForward(model, devices, batch_axis=1)
    forward_calls = 0

    def forward(xb):
        nonlocal forward_calls
        forward_calls += 1
        return call(xb)

    x = torch.as_tensor(sp.x, device=device)
    latency = []
    with torch.inference_mode():
        preds = predict_split(forward, x, batch_size, pad=artifact)
        acc = float(np.mean(preds == np.asarray(sp.y)))
        print(f"{split}: n={len(preds)} accuracy={acc:.2%}")
        if out:
            np.save(out, preds)
            print(f"predictions written to {out}")
        if latency_bench:
            for bs in sorted({1, batch_size}):
                stats = latency_stats(forward, x, bs, devices=devices)
                print(json.dumps({"metric": "forward_latency", **stats}))
                latency.append(stats)
    return PredictRun(preds, acc, latency, forward_calls, model, x)


if __name__ == "__main__":
    main()
