"""Model export for deployment (port of ``dctn_tpu/cli/export.py``): the
serving forward as ``torch.export`` programs with the trained weights
inside, one per batch size, in one zip.

Both model families export: EPSesPlusLinear (``--model-family eps``) and
the legacy ConvSBS stack (``conv_sbs``, raw (bs, H, W) pixels in, the
quantum map inside the graph). The ``pallas`` backend (the default, also
what ``auto`` means) traces the fast forward with its kernels as the
registered operators of ``kernels/ops.py`` (K1 per EPS layer, K8 per layer
with ``--quantize int8``, one ConvSBS fold per string): a loaded artifact
launches the same hand-written kernels as eager serving, and loading it
needs ``dctn_tpu_torch`` installed, which registers those operators. The
``xla`` backend traces the reference-layout forward through plain PyTorch
operations only: its artifact loads wherever ``torch`` is installed.

An artifact runs on the device type it was exported on (``--device``,
``cuda`` by default): its weights lie there. ``load_artifact`` refuses
another device type, and a CUDA artifact where no card is available; it
never moves a one-card artifact.

``--mesh-devices N`` exports a sharded artifact (``export_sharded_forward``,
JAX export.py:78-130): each entry point takes a global batch divisible by
N and serves it on N cards (or N CPU replicas), each taking an equal share
(``parallel.replicas.ShardedForward``). Its program is the one-card
forward at the local batch, exported device-free (traced with its weights
on the CPU) and moved onto each card at load: one program in the zip
whatever N, a load without re-tracing, and, as for one-card artifacts, no
model code needed beyond the operators. ``meta["mesh_devices"]`` is N and
``meta["program_device"]`` ``"cpu"`` (``export_sharded_forward`` at N = 1
with that key gives a one-replica artifact of the same kind);
``load_artifact`` needs N visible cards.

``--space-devices S`` exports the height-sharded artifact (eps family;
``export_space_sharded_forward``, JAX export.py:130-215): each entry point
takes a global batch of whole images, H = S·Hl rows, and serves each image
by bands of Hl rows on S cards, for images whose activations one card
cannot hold. JAX exports one ``shard_map`` with a halo ``ppermute`` per
layer; ``torch.export`` holds no program that spans cards, and the port
serves from one process without a process group. So each card runs one
device-free program on an overlapped slab of the image, rows [s·Hl, s·Hl +
Hl + Σ_i(K_i − 1)), zero past the bottom: every EPS layer with no exchange,
then its partial logits against its h-slice of the classifier, which the
program takes as its second input. The loader (``_load_space_sharded``)
places a copy of the program on ``cuda:0`` … ``cuda:S-1`` with the slices
of ``classifier.pt``, launches every card before it gathers, sums the
partial logits on the input's device in card order and adds the bias once
(``parallel.replicas.RowShardedForward``). The cost: layer 0 runs
Σ_{i≥1}(K_i − 1) more rows than a training slab (the flagship: 19 rows
against 17 at S = 2, 12 against 10 at S = 4); no card holds a whole image's
activations. ``meta["space_devices"]`` is S; ``load_artifact`` needs S
visible cards and never puts two bands on one card. As in JAX, it refuses
another family, ``--mesh-devices`` beside it, ``--quantize int8`` and a
height that S does not divide.

A model with a layer outside the kernels' plans has no fast layout
(``FastLayoutUnavailable``): the ``pallas`` backend then traces the
reference-layout forward, each layer the kernels take through the K1
operator and the others through plain operations, with the fallback
recorded (JAX export.py:172-195 and predict.py:98-135); ``--quantize int8``
raises, and ``--autotune-splits`` is ignored. The height-sharded artifact
does the same in each card's slab program.

``--autotune-splits`` measures each EPS layer's split candidates with the
serving objective (the forward, f32 or int8) on ``--device`` at the largest
batch size a card serves, and exports at the picks; ``--autotune-cache``
reuses and stores such picks, and alone exports at the cached ones
(``serving_splits``). Splits are exact: only the kernels' speed changes.
``meta["autotuned_splits"]`` records them.

``--compute-dtype bfloat16`` (eps family; JAX export.py:505-509) exports
the forward with the EPS products' operands rounded to bf16 and float32
sums: on the pallas backend each layer's float32 core is rounded inside
the graph and K1 runs its bf16 mode, on the xla backend the plain
operations round where the JAX ``eps`` casts; ``meta["compute_dtype"]``
says ``"bfloat16"``. So does the height-sharded artifact
(``--space-devices``: each card's slab program rounds its layers' cores the
same way, JAX's ``_sp_fast_forward_local``, export.py:188-195). It refuses
``--quantize int8`` (JAX's words).

Artifact layout (a zip):
  meta.json          the model config, batch sizes, device type, backend
                     (and ``autotuned_splits`` where the splits were tuned)
  forward_bs{N}.pt2  ``torch.export.save`` of the program for batch size N
                     (static shapes: the kernels' launch plans are fixed per
                     shape)
  classifier.pt      height-sharded artifacts only: the classifier's S
                     h-slices and its bias (``torch.save``)

Usage:
  python -m dctn_tpu_torch.cli.export CKPT.npz --epses-specs "(4,4),(3,6)" \
      --batch-sizes 1,128 --out model.zip [--quantize int8]
  # serving side:
  #   from dctn_tpu_torch.cli.export import load_artifact
  #   meta, fns = load_artifact("model.zip")
  #   logits = fns[128](x)          # x (C, 128, H, W, Q0) on meta's device
"""

from __future__ import annotations

import io
import json
import os
import time
import zipfile
from typing import Callable, Dict, Sequence, Tuple

import click
import torch
from torch import nn

from ..interop import conv_sbs_params_from_numpy, params_from_numpy
from ..kernels import ops  # registers the operators that pallas graphs name
from ..kernels.eps_kernels import eps_apply_t_cmt, objective_name
from ..kernels.eps_q8_kernels import quantize_fast_params
from ..models import (
    ConvSBSModel,
    ConvSBSModelConfig,
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    EPSesPlusLinearQ8,
    EPSesPlusLinearReference,
    FastLayoutUnavailable,
    check_fast_plans,
    conv_sbs_model_forward,
    fast_params_from_reference,
    init_conv_sbs_model,
    layer_plans,
)
from ..ops import eps as eps_mod
from ..train import load_conv_sbs_params_npz, load_params_npz
from .specs import parse_epses_specs

_META_NAME = "meta.json"
_ENTRY = "forward_bs{}.pt2"
_CLASSIFIER = "classifier.pt"
BACKENDS = ("pallas", "xla")


class _Program(nn.Module):
    """What one entry point traces: ``forward(model, x)`` over ``model``,
    whose parameters become the program's weights."""

    def __init__(self, model: nn.Module, forward: Callable):
        super().__init__()
        # contiguous weights: the saved program stores each in its own
        # storage, as torch.export.load expects
        for t in (*model.parameters(), *model.buffers()):
            t.data = t.data.contiguous()
        self.model = model
        self._forward = forward

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward(self.model, x)


def _serialize(program: _Program, batch_sizes: Sequence[int], shape: Callable, device):
    """({bs: saved program}, {bs: export seconds}): ``torch.export`` of
    ``program`` at the input shape ``shape(bs)`` on ``device``. Traced under
    ``no_grad``: the layers' autograd Functions then run their forwards
    alone, and the graph holds the operators' nodes."""
    serialized, seconds = {}, {}
    for bs in batch_sizes:
        t0 = time.perf_counter()
        with torch.no_grad():
            exported = torch.export.export(program.eval(), (torch.zeros(shape(bs), device=device),))
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        serialized[bs], seconds[bs] = buf.getvalue(), time.perf_counter() - t0
    return serialized, seconds


def _plans_at(cfg: EPSesPlusLinearConfig, channels: int, splits, quantize=None):
    """The fast layout's plans with each layer's n1 from ``splits`` (None:
    the default splits); raises ``FastLayoutUnavailable`` where the serving
    kernels (K1, or K8 with ``quantize``) do not take a layer."""
    plans = layer_plans(cfg, channels)
    if splits is not None:
        if len(splits) != len(plans):
            raise ValueError(f"{len(splits)} splits for {len(plans)} EPS layers")
        plans = tuple({**p, "n1": int(n1)} for p, n1 in zip(plans, splits))
    check_fast_plans(cfg, plans, objective_name(True, quantize, cfg.compute_dtype))
    return plans


@torch.no_grad()
def _eps_program(params, cfg: EPSesPlusLinearConfig, channels: int, device, backend: str,
                 quantize, splits=None) -> _Program:
    """The serving model of ``backend`` on ``device``: the fast (cmt) model
    at ``splits`` through the operator bundles (K1, or K8 with
    ``quantize="int8"``), or the reference-layout model through plain
    operations; for a model without a fast layout the reference-layout
    model through the K1 operator where it takes a layer (``quantize``
    then raises ``FastLayoutUnavailable``)."""
    if backend == "xla":
        if quantize:
            raise ValueError("quantize needs the pallas backend (the int8 kernel's fast layout)")
        return _Program(EPSesPlusLinearReference(params, cfg).to(device), lambda m, x: m(x))
    try:
        plans = _plans_at(cfg, channels, splits, quantize)
    except FastLayoutUnavailable:
        if quantize:
            raise
        model = EPSesPlusLinearReference(params, cfg, backend="pallas").to(device)
        return _Program(model, lambda m, x: m(x, kernels=ops.OP_KERNELS))
    fast, plans = fast_params_from_reference(params, cfg, plans=plans)
    if quantize == "int8":
        model = EPSesPlusLinearQ8(quantize_fast_params(fast), plans, cfg).to(device)
        return _Program(model, lambda m, x: m(x, fwd=ops.eps_fwd_q8))
    model = EPSesPlusLinear(fast, plans, cfg).to(device)
    return _Program(model, lambda m, x: m(x, kernels=ops.OP_KERNELS))


@torch.no_grad()
def _sbs_program(params, cfg: ConvSBSModelConfig, device, backend: str) -> _Program:
    """The ConvSBS serving model on ``device``: every string through the
    ``sbs_fwd`` operator, or the plain reference-layout forward."""
    model = ConvSBSModel(params, cfg, device=device, dtype=torch.float32)
    if backend == "pallas":
        return _Program(model, lambda m, x: m(x, kernels=ops.OP_SBS_KERNELS))
    return _Program(model, lambda m, x: conv_sbs_model_forward(m.params(), m.cfg, x))


def export_forward(
    params,
    cfg: EPSesPlusLinearConfig,
    *,
    batch_sizes: Sequence[int],
    channels: int = 1,
    device="cuda",
    backend: str = "pallas",
    quantize=None,
    splits=None,
) -> Tuple[Dict[int, bytes], Dict[int, float]]:
    """The serving forward of reference-layout ``params`` (tensors on any
    device), one saved program per batch size, the weights inside on
    ``device``: input (C, bs, H, W, Q₀) f32 there, output (bs, classes).
    ``quantize="int8"``: the W8A8 model, its int8 cores inside the program.
    ``splits``: each EPS layer's matmul split (pallas; None: the defaults),
    e.g. serving-objective picks of ``train.autotune.autotune_splits``.
    Returns ({bs: saved program}, {bs: export seconds})."""
    assert backend in BACKENDS and quantize in (None, "int8"), (backend, quantize)
    program = _eps_program(params, cfg, channels, device, backend, quantize, splits)
    size = cfg.image_size
    return _serialize(program, batch_sizes, lambda bs: (channels, bs, size, size, cfg.q0), device)


def export_conv_sbs_forward(
    params,
    cfg: ConvSBSModelConfig,
    *,
    batch_sizes: Sequence[int],
    image_size: int = 28,
    device="cuda",
    backend: str = "pallas",
) -> Tuple[Dict[int, bytes], Dict[int, float]]:
    """ConvSBS (legacy family) serving export: raw (bs, H, W) pixels →
    (bs, num_labels) logits, the quantum map inside the program. ``pallas``
    folds every string through the ``sbs_fwd`` operator; ``xla`` is the
    plain reference-layout forward. Returns as ``export_forward``."""
    assert backend in BACKENDS, backend
    program = _sbs_program(params, cfg, device, backend)
    return _serialize(program, batch_sizes, lambda bs: (bs, image_size, image_size), device)


def export_sharded_forward(
    params,
    cfg,
    *,
    batch_sizes: Sequence[int],
    mesh_devices: int,
    channels: int = 1,
    backend: str = "pallas",
    quantize=None,
    model_family: str = "eps",
    image_size: int = 28,
    splits=None,
) -> Tuple[Dict[int, bytes], Dict[int, float]]:
    """The data-sharded serving export (JAX export.py:78-130): for each
    global batch size (divisible by ``mesh_devices``), the one-card program
    at its local batch, exported device-free (weights on the CPU) so that
    ``load_artifact`` places a replica on each card. ``cfg`` is the
    ``model_family``'s config (``eps`` or ``conv_sbs``). Returns as
    ``export_forward``, keyed by the global batch size; ``splits`` as
    there (eps family)."""
    bad = [bs for bs in batch_sizes if bs % mesh_devices]
    if bad:
        raise ValueError(f"global batch sizes {bad} are not divisible by mesh_devices={mesh_devices}")
    local = {bs: bs // mesh_devices for bs in batch_sizes}
    if model_family == "eps":
        serialized, seconds = export_forward(params, cfg, batch_sizes=sorted(set(local.values())),
                                             channels=channels, device="cpu", backend=backend,
                                             quantize=quantize, splits=splits)
    else:
        serialized, seconds = export_conv_sbs_forward(
            params, cfg, batch_sizes=sorted(set(local.values())), image_size=image_size,
            device="cpu", backend=backend)
    return ({bs: serialized[lb] for bs, lb in local.items()},
            {bs: seconds[lb] for bs, lb in local.items()})


class _SlabProgram(nn.Module):
    """What a height-sharded artifact's entry point traces: one card's slab
    (C, B, Hl + Σ(K−1), W, Q₀) through every EPS layer, then its partial
    logits (B, classes) against the classifier's h-slice ``w_loc``
    (Hl·W'·O, classes, rows ordered (h, w, o)). ``plans`` None: the
    reference cores through ``eps`` on ``backend`` (xla: plain operations;
    pallas, a model without a fast layout: the K1 operator where it takes
    a layer); else the cmts through the K1 operator (pallas).
    ``compute_dtype``: the products' operands, None (float32) or bf16 (the
    float32 cores rounded inside the graph)."""

    def __init__(self, cores, plans=None, compute_dtype=None, backend="xla"):
        super().__init__()
        self.cores = nn.ParameterList(nn.Parameter(c.detach().clone().contiguous(),
                                                   requires_grad=False) for c in cores)
        self.plans = plans
        self.compute_dtype = compute_dtype
        self.backend = backend

    def features(self, slab: torch.Tensor) -> torch.Tensor:
        """The last EPS layer's output on ``slab`` (or on a whole image):
        (B, rows, W', O) through the reference cores, batch-minor (O, rows,
        W', B) through the cmts."""
        if self.plans is None:
            h = slab
            for core in self.cores:
                h = eps_mod.eps(core, h, backend=self.backend, compute_dtype=self.compute_dtype,
                                kernels=ops.OP_KERNELS)[None]
            return h[0]
        xT = slab.permute(0, 4, 2, 3, 1)
        for i, (cmt, p) in enumerate(zip(self.cores, self.plans)):
            xT = eps_apply_t_cmt(cmt, xT, p["out_size"], p["kernel_size"], p["n1"],
                                 p["merge_pairs"], layer_index=i, kernels=ops.OP_KERNELS,
                                 mm_dtype=self.compute_dtype)[None]
        return xT[0]

    def forward(self, slab: torch.Tensor, w_loc: torch.Tensor) -> torch.Tensor:
        f = self.features(slab)
        if self.plans is None:
            return f.reshape(f.shape[0], -1) @ w_loc
        o, hl, wl, b = f.shape
        return torch.tensordot(f.reshape(o, hl * wl, b), w_loc.reshape(hl * wl, o, -1),
                               dims=([0, 1], [1, 0]))


def space_layout(cfg: EPSesPlusLinearConfig, space_devices: int) -> Tuple[int, int]:
    """(Hl, halo) of a height-sharded artifact: each card's band of output
    rows, H / S, and the rows below it its slab adds, Σ_i(K_i − 1). Refuses
    a height that S does not divide and, as SP training does, a halo wider
    than a band."""
    from ..parallel import sp_check_config

    if cfg.image_size % space_devices:
        raise ValueError(
            f"image height {cfg.image_size} is not divisible by space_devices={space_devices} "
            "(the exported module carries no height pad)")
    sp_check_config(cfg, space_devices)
    return cfg.image_size // space_devices, sum(k - 1 for k, _ in cfg.epses_specs)


def space_classifier(params, cfg: EPSesPlusLinearConfig, space_devices: int) -> dict:
    """The classifier of reference-layout ``params`` as the height-sharded
    artifact holds it: ``w`` (S, Hl·W'·O, classes), card s's h-slice of the
    weight zero-padded along h to S·Hl rows, and the bias ``b``."""
    hl, _ = space_layout(cfg, space_devices)
    v = cfg.pre_linear_image_size
    w = params["linear"]["w"].detach().cpu().reshape(v, v, -1, cfg.num_classes)
    w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, 0, 0, space_devices * hl - v))
    return {"w": w.reshape(space_devices, -1, cfg.num_classes).contiguous(),
            "b": params["linear"]["b"].detach().cpu().clone()}


def space_slab_program(params, cfg: EPSesPlusLinearConfig, channels: int = 1,
                       backend: str = "pallas", splits=None) -> _SlabProgram:
    """The slab program of reference-layout ``params`` on the CPU (what
    ``export_space_sharded_forward`` traces and serving places on each
    card): the fast layout's cmts at ``splits`` for ``pallas``, the
    reference cores for ``xla``; in ``cfg.compute_dtype``'s operands."""
    cores = tuple(c.detach().cpu() for c in params["epses"])
    if backend == "xla":
        return _SlabProgram(cores, compute_dtype=cfg.compute_dtype)
    try:
        plans = _plans_at(cfg, channels, splits)
    except FastLayoutUnavailable:
        return _SlabProgram(cores, compute_dtype=cfg.compute_dtype, backend="pallas")
    fast, plans = fast_params_from_reference({"epses": cores, "linear": {}}, cfg, plans=plans)
    return _SlabProgram(fast["epses_cmt"], plans, cfg.compute_dtype)


def export_space_sharded_forward(
    params,
    cfg: EPSesPlusLinearConfig,
    *,
    batch_sizes: Sequence[int],
    space_devices: int,
    channels: int = 1,
    backend: str = "pallas",
    splits=None,
) -> Tuple[Dict[int, bytes], Dict[int, float], bytes]:
    """The height-sharded serving export (JAX export.py:130-215): for each
    batch size the device-free slab program (``space_slab_program``),
    traced on the CPU at the slab's shape with a classifier slice, and the
    classifier's S slices with the bias (``space_classifier``), saved
    apart; ``splits`` as in ``export_forward``. Returns ({bs: saved
    program}, {bs: export seconds}, the ``classifier.pt`` bytes)."""
    assert backend in BACKENDS, backend
    hl, halo = space_layout(cfg, space_devices)
    program = space_slab_program(params, cfg, channels, backend, splits)
    classifier = space_classifier(params, cfg, space_devices)
    w0 = classifier["w"][0]
    serialized, seconds = {}, {}
    for bs in batch_sizes:
        t0 = time.perf_counter()
        slab = torch.zeros(channels, bs, hl + halo, cfg.image_size, cfg.q0)
        with torch.no_grad():
            exported = torch.export.export(program.eval(), (slab, w0))
        buf = io.BytesIO()
        torch.export.save(exported, buf)
        serialized[bs], seconds[bs] = buf.getvalue(), time.perf_counter() - t0
    buf = io.BytesIO()
    torch.save(classifier, buf)
    return serialized, seconds, buf.getvalue()


def write_artifact(path: str, serialized: Dict[int, bytes], meta: dict,
                   classifier: bytes = None) -> None:
    """The artifact zip: the meta, one program per batch size, and a
    height-sharded artifact's ``classifier``."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        zf.writestr(_META_NAME, json.dumps(meta, indent=1))
        for bs, blob in sorted(serialized.items()):
            zf.writestr(_ENTRY.format(bs), blob)
        if classifier is not None:
            zf.writestr(_CLASSIFIER, classifier)


def load_artifact(path: str, device=None) -> Tuple[dict, Dict[int, torch.nn.Module]]:
    """(meta, {batch_size: callable}): each callable maps an input batch on
    the artifact's device to logits, with the program's weights frozen.
    ``device`` (default: the artifact's) must be the device the artifact was
    exported on: its type, and for a card its index (``cuda`` alone means
    the current card). A sharded artifact (``meta["mesh_devices"]`` N > 1)
    loads a replica of each program onto ``cuda:0`` … ``cuda:N-1`` (or N
    CPU replicas): its callables take an input on any device and return the
    logits there. So does a height-sharded artifact (``meta["space_devices"]``
    S > 1), whose program goes onto ``cuda:0`` … ``cuda:S-1``, one band of
    rows each, refused where fewer cards are visible. A JAX package artifact
    (``.jaxexp`` entries) is refused: re-export its npz checkpoint with this
    package."""
    fns: Dict[int, torch.nn.Module] = {}
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        if any(n.endswith(".jaxexp") for n in names):
            raise ValueError(
                f"{path} is an artifact of the JAX package (jax.export entries); the port loads "
                "its own: re-export from the npz checkpoint with `python -m "
                "dctn_tpu_torch.cli.export CKPT.npz ...`"
            )
        meta = json.loads(zf.read(_META_NAME))
        exported_on = (meta.get("platforms") or ["cpu"])[0]
        if meta.get("space_devices", 1) > 1:
            return meta, _load_space_sharded(zf, names, meta, exported_on, device, path)
        if meta.get("mesh_devices", 1) > 1 or meta.get("program_device") == "cpu":
            return meta, _load_sharded(zf, names, meta, exported_on, device, path)
        want = torch.device(device if device is not None else exported_on)
        if want.type != exported_on:
            raise ValueError(
                f"{path} was exported on {exported_on}; it does not load onto {want.type} "
                f"(re-export it with --device {want.type})"
            )
        if want.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"{path} was exported on cuda, and no CUDA device is available")
            if want.index is None:
                want = torch.device("cuda", torch.cuda.current_device())
        for name in names:
            if name == _META_NAME:
                continue
            bs = int(name[len("forward_bs") : -len(".pt2")])
            program = torch.export.load(io.BytesIO(zf.read(name)))
            held = {t.device for t in (*program.state_dict.values(), *program.constants.values())
                    if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
            if held - {want}:
                raise ValueError(
                    f"{path}'s weights lie on {', '.join(sorted(map(str, held)))}; it does not "
                    f"load onto {want} (export it there, or serve it there)"
                )
            fn = program.module()
            for p in fn.parameters():
                p.requires_grad_(False)
            fns[bs] = fn
    return meta, fns


# the check torch.export puts before each dtype cast (a bf16 artifact rounds
# its float32 cores inside the graph): it names the device it was traced on
_ASSERT_METADATA = torch.ops.aten._assert_tensor_metadata.default


def place_program(fn, dev):
    """A device-free program (a sharded artifact's ``torch.export`` module)
    moved onto ``dev``, its weights frozen and its dtype casts' metadata
    checks pointed at ``dev``, where its tensors now are. Returns it."""
    fn = fn.to(dev)
    for p in fn.parameters():
        p.requires_grad_(False)
    changed = False
    for node in fn.graph.nodes:
        if node.target is _ASSERT_METADATA and node.kwargs.get("device") is not None:
            node.kwargs = {**node.kwargs, "device": torch.device(dev)}
            changed = True
    if changed:
        fn.recompile()
    return fn


def _placed_programs(zf, names, meta: dict, exported_on: str, device, path: str, n: int):
    """The devices of a sharded artifact's ``n`` cards (``n`` CPU replicas),
    and {batch size: [a copy of the entry's device-free program on each]}."""
    import copy

    from ..parallel.replicas import replica_devices

    want = torch.device(device if device is not None else exported_on)
    if want.type != exported_on:
        raise ValueError(f"{path} serves on {exported_on}; it does not load onto {want.type}")
    devices = replica_devices(n, exported_on)
    programs = {}
    for name in names:
        if not name.startswith("forward_bs"):
            continue
        bs = int(name[len("forward_bs") : -len(".pt2")])
        base = torch.export.load(io.BytesIO(zf.read(name))).module()
        for node in base.graph.nodes:
            if "device" in node.kwargs and node.target is not _ASSERT_METADATA:
                raise ValueError(f"{path}: its program names a device ({node}); it cannot move")
        programs[bs] = [place_program(copy.deepcopy(base), dev) for dev in devices]
    return devices, programs


def _load_sharded(zf, names, meta: dict, exported_on: str, device, path: str):
    """{global batch size: ShardedForward} over a replica of each entry's
    device-free program on each of ``meta["mesh_devices"]`` devices."""
    from ..parallel.replicas import ShardedForward

    devices, programs = _placed_programs(zf, names, meta, exported_on, device, path,
                                         meta["mesh_devices"])
    axis = 1 if meta.get("model_family", "eps") == "eps" else 0
    return {bs: ShardedForward(replicas, devices, axis) for bs, replicas in programs.items()}


def _load_space_sharded(zf, names, meta: dict, exported_on: str, device, path: str):
    """{batch size: RowShardedForward} of a height-sharded artifact: its
    slab program on each of ``meta["space_devices"]`` cards, each with its
    h-slice of the classifier."""
    from ..parallel.replicas import RowShardedForward

    n = meta["space_devices"]
    try:
        devices, programs = _placed_programs(zf, names, meta, exported_on, device, path, n)
    except ValueError as e:
        raise ValueError(f"{path} is height-sharded over {n} devices: {e}") from None
    classifier = torch.load(io.BytesIO(zf.read(_CLASSIFIER)), weights_only=True)
    return {bs: RowShardedForward(replicas, devices, list(classifier["w"]), classifier["b"],
                                  meta["space_rows"], meta["space_halo"])
            for bs, replicas in programs.items()}


def op_nodes(fn: torch.nn.Module) -> Dict[str, int]:
    """How many nodes of each ``dctn_tpu_torch`` operator a loaded entry
    point's graph holds (``{}`` for an xla artifact)."""
    counts: Dict[str, int] = {}
    for node in fn.graph.nodes:
        name = getattr(node.target, "name", lambda: "")()
        if node.op == "call_function" and name.startswith(f"{ops.NAMESPACE}::"):
            key = name.split("::", 1)[1]
            counts[key] = counts.get(key, 0) + 1
    return counts


def parse_batch_sizes(s: str) -> Tuple[int, ...]:
    """'1,128' → (1, 128): export's and the runners' --export-batch-sizes."""
    return tuple(int(v) for v in s.split(",") if v.strip())


def build_meta(
    *,
    model_family: str,
    image_size: int,
    batch_sizes: Sequence[int],
    backend: str,
    mesh_devices: int = 1,
    space_devices: int = 1,
    platforms: Sequence[str],
    compute_dtype: str = "float32",
    quantize: str = "none",
    **family_meta,
) -> dict:
    """The artifact meta, the JAX package's schema with ``torch_version``
    in place of ``jax_version`` and the torch device type in ``platforms``;
    export's CLI and both runners' --export-artifact build it here."""
    return {
        "format_version": 1,
        "model_family": model_family,
        "image_size": image_size,
        "batch_sizes": sorted(batch_sizes),
        "mesh_devices": mesh_devices,
        "space_devices": space_devices,
        "platforms": list(platforms),
        "backend": backend,
        "compute_dtype": compute_dtype if model_family == "eps" else "float32",
        "quantize": quantize if model_family == "eps" else "none",
        "in_dtype": "float32",
        "torch_version": torch.__version__,
        **family_meta,
    }


def serving_splits(cfg: EPSesPlusLinearConfig, batch_size: int, channels: int, device, quantize,
                   tune: bool, cache: bool, log_fn=None):
    """An artifact's splits, always at the SERVING objective (the forward,
    f32 or ``quantize="int8"``) at ``batch_size`` images a card: measured on
    ``device`` with ``tune`` (reusing and storing picks with ``cache``),
    else with ``cache`` the picks the cache holds for that problem, else
    None (the default splits)."""
    from ..train.autotune import autotune_cache_lookup, autotune_splits, default_cache_path

    problem = dict(device=device, forward_only=True, quantize=quantize, log_fn=log_fn,
                   cache_path=default_cache_path() if cache else None)
    if tune:
        plans, _ = autotune_splits(cfg, max(1, batch_size), channels, **problem)
    else:
        hit = autotune_cache_lookup(cfg, max(1, batch_size), channels, **problem)
        if hit is None:
            return None
        plans = hit[0]
    return tuple(p["n1"] for p in plans)


def _parse_int_list(_ctx, _param, value: str) -> Tuple[int, ...]:
    return parse_batch_sizes(value)


@click.command()
@click.argument("checkpoint", type=click.Path(exists=True, dir_okay=False))
@click.option("--model-family", type=click.Choice(("eps", "conv_sbs")), default="eps")
@click.option("--epses-specs", type=parse_epses_specs, default=None,
              help="required for --model-family eps")
@click.option("--image-size", type=int, default=28)
@click.option("--q0", type=int, default=2)
@click.option("--channels", type=int, default=1)
@click.option("--num-classes", type=int, default=10)
@click.option("--num-sbs-layers", type=int, default=2, help="conv_sbs family")
@click.option("--bond-dim", type=int, default=4, help="conv_sbs family")
@click.option("--trace-edge/--no-trace-edge", default=False, help="conv_sbs family")
@click.option("--cos-sin-squared", is_flag=True, help="conv_sbs family")
@click.option("--input-multiplier", type=float, default=1.0, help="conv_sbs family")
@click.option("--batch-sizes", callback=_parse_int_list, default="1,128",
              help="comma-separated; one exported entry point per size")
@click.option("--mesh-devices", type=int, default=1,
              help="a sharded artifact: every --batch-sizes entry is a global batch split over "
                   "this many cards (or CPU replicas), a replica on each")
@click.option("--space-devices", type=int, default=1,
              help="the height-sharded artifact (eps family): every image served by bands of "
                   "H / S rows on S cards (or CPU replicas), a slab program on each")
@click.option("--device", default="cuda",
              help="torch device to export on and serve on: cuda (the kernels) or cpu "
                   "(their plain versions)")
@click.option("--backend", type=click.Choice(("auto", "pallas", "xla")), default="auto",
              help="pallas (and auto): the fast forward through the kernels' operators; "
                   "xla: the reference-layout forward in plain operations, loadable without "
                   "this package")
@click.option("--compute-dtype", type=click.Choice(("float32", "bfloat16")), default="float32",
              help="the EPS products' operands (eps family): bfloat16 rounds them to bf16 and "
                   "sums in float32 (the kernels' bf16 mode); the artifact keeps float32 "
                   "weights")
@click.option("--quantize", type=click.Choice(("none", "int8")), default="none",
              help="W8A8 int8 EPS layers (eps family, pallas backend): int8 cores inside "
                   "the artifact, the activations quantized per pixel in the kernel")
@click.option("--autotune-splits/--no-autotune-splits", default=False,
              help="measure each EPS layer's matmul-split candidates on --device with the "
                   "SERVING objective (the forward, f32 or --quantize int8) at the largest "
                   "batch size (per card), and export at the fastest (eps family, pallas "
                   "backend; exact: splits only re-matricize the cores)")
@click.option("--autotune-cache/--no-autotune-cache", default=False,
              help="reuse and store serving-objective split picks in "
                   "train/autotune.default_cache_path() ($DCTN_TPU_TORCH_AUTOTUNE_CACHE); "
                   "without --autotune-splits, export at cached picks alone. Off by default")
@click.option("--out", type=click.Path(dir_okay=False), required=True)
def main(**kw):
    run(**kw)


def run(*, checkpoint, model_family="eps", epses_specs=None, image_size=28, q0=2, channels=1,
        num_classes=10, num_sbs_layers=2, bond_dim=4, trace_edge=False, cos_sin_squared=False,
        input_multiplier=1.0, batch_sizes=(1, 128), mesh_devices=1, space_devices=1,
        device="cuda", backend="auto", compute_dtype="float32", quantize="none",
        autotune_splits=False, autotune_cache=False, out=None) -> dict:
    """Export the npz ``checkpoint`` to the artifact ``out``; returns each
    entry point's export seconds and bytes, and the artifact's bytes."""
    if backend == "auto":
        backend = "pallas"
    if autotune_splits and (model_family != "eps" or backend != "pallas"):
        raise click.UsageError(
            "--autotune-splits needs --model-family eps and the pallas backend (the fast "
            "layout): it is the only path with tunable splits")
    if quantize != "none":
        if model_family != "eps":
            raise click.UsageError(
                "--quantize needs --model-family eps: the ConvSBS kernels are per-pixel bond "
                "folds on the CUDA cores, with no tensor-core matmul to quantize (and KB-scale "
                "cores)"
            )
        if backend != "pallas":
            raise click.UsageError(
                "--quantize needs the pallas backend (the int8 kernel runs on the fast layout)"
            )
        if compute_dtype == "bfloat16":  # JAX export.py:463-467, its words
            raise click.UsageError(
                "--quantize int8 and --compute-dtype bfloat16 are mutually exclusive: the W8A8 "
                "kernels fix their own dtypes (int8 tensor-core products accumulating in int32, "
                "f32 elsewhere)"
            )
    device = torch.device(device)
    if mesh_devices < 1 or space_devices < 1:
        raise click.UsageError(
            f"--mesh-devices {mesh_devices} --space-devices {space_devices}: at least one device")
    if space_devices > 1:  # JAX export.py:471-493, its words
        if model_family != "eps":
            raise click.UsageError("--space-devices > 1 needs --model-family eps")
        if mesh_devices > 1:
            raise click.UsageError(
                "--space-devices and --mesh-devices are mutually exclusive in export (one "
                "sharded entry convention per artifact; shard data OR image height)")
        if quantize != "none":
            raise click.UsageError(
                "--quantize int8 does not compose with --space-devices export: the W8A8 serving "
                "kernels plan per full image (use --mesh-devices or single-chip int8)")
        if image_size % space_devices:
            raise click.UsageError(
                f"--image-size {image_size} must be divisible by --space-devices "
                f"{space_devices} (the exported module carries no height pad)")
        if epses_specs:
            try:  # a halo wider than a band, before the checkpoint loads
                space_layout(EPSesPlusLinearConfig(epses_specs=tuple(epses_specs),
                                                   image_size=image_size, q0=q0), space_devices)
            except ValueError as e:
                raise click.UsageError(f"--space-devices {space_devices}: {e}") from None
    sharded = mesh_devices > 1 or space_devices > 1
    if mesh_devices > 1:
        bad = [bs for bs in batch_sizes if bs % mesh_devices]
        if bad:
            raise click.UsageError(
                f"global batch sizes {bad} are not divisible by --mesh-devices {mesh_devices}")
    if not sharded and device.type == "cuda" and not torch.cuda.is_available():
        # a one-card artifact's weights are placed on the card; a sharded
        # one is traced device-free on the CPU
        raise click.UsageError(f"--device {device}: no CUDA device is available")
    t0 = time.perf_counter()
    if model_family == "eps":
        if not epses_specs:
            raise click.UsageError("--model-family eps needs --epses-specs")
        from .predict import _check_params

        cfg = EPSesPlusLinearConfig(
            epses_specs=tuple(epses_specs), image_size=image_size, q0=q0,
            num_classes=num_classes,
            compute_dtype=torch.bfloat16 if compute_dtype == "bfloat16" else None)
        params = params_from_numpy(load_params_npz(checkpoint),
                                   "cpu" if sharded else device, torch.float32)
        _check_params(params, cfg, channels)
        q = None if quantize == "none" else quantize
        splits = None
        if backend == "pallas" and (autotune_splits or autotune_cache):
            try:
                _plans_at(cfg, channels, None, q)
            except FastLayoutUnavailable as e:
                if q:
                    raise
                click.echo(f"--autotune-splits ignored: the fast (cmt) layout is not in use ({e})",
                           err=True)
                autotune_splits = autotune_cache = False
        if backend == "pallas" and (autotune_splits or autotune_cache):
            splits = serving_splits(cfg, max(batch_sizes) // mesh_devices, channels, device, q,
                                    autotune_splits, autotune_cache,
                                    log_fn=lambda m: click.echo(m, err=True))
        if space_devices > 1:
            serialized, seconds, classifier = export_space_sharded_forward(
                params, cfg, batch_sizes=batch_sizes, space_devices=space_devices,
                channels=channels, backend=backend, splits=splits)
            hl, halo = space_layout(cfg, space_devices)
        elif mesh_devices > 1:
            serialized, seconds = export_sharded_forward(
                params, cfg, batch_sizes=batch_sizes, mesh_devices=mesh_devices,
                channels=channels, backend=backend, quantize=q, splits=splits)
        else:
            serialized, seconds = export_forward(
                params, cfg, batch_sizes=batch_sizes, channels=channels, device=device,
                backend=backend, quantize=q, splits=splits)
        family_meta = {"epses_specs": [list(s) for s in epses_specs], "q0": q0,
                       "channels": channels, "num_classes": num_classes}
        if splits is not None:
            family_meta["autotuned_splits"] = list(splits)
    else:
        cfg = ConvSBSModelConfig(
            num_sbs_layers=num_sbs_layers, bond_dim_size=bond_dim, trace_edge=trace_edge,
            cos_sin_squared=cos_sin_squared, input_multiplier=input_multiplier,
            num_labels=num_classes,
        )
        params = conv_sbs_params_from_numpy(load_conv_sbs_params_npz(checkpoint),
                                            device if mesh_devices == 1 else "cpu", torch.float32)
        got = [tuple(c.shape) for layer in params for s in layer for c in s]
        want = [tuple(c.shape) for layer in init_conv_sbs_model(torch.Generator(), cfg)
                for s in layer for c in s]
        if got != want:
            raise click.UsageError(f"{checkpoint} does not match this model: cores {got} vs {want}")
        if mesh_devices > 1:
            serialized, seconds = export_sharded_forward(
                params, cfg, batch_sizes=batch_sizes, mesh_devices=mesh_devices,
                backend=backend, model_family="conv_sbs", image_size=image_size)
        else:
            serialized, seconds = export_conv_sbs_forward(
                params, cfg, batch_sizes=batch_sizes, image_size=image_size, device=device,
                backend=backend)
        family_meta = {"num_sbs_layers": num_sbs_layers, "bond_dim_size": bond_dim,
                       "trace_edge": trace_edge, "cos_sin_squared": cos_sin_squared,
                       "input_multiplier": input_multiplier, "num_labels": num_classes}
    if sharded:
        family_meta["program_device"] = "cpu"  # placed on each card at load
    if space_devices > 1:
        family_meta.update(space_rows=hl, space_halo=halo)
    meta = build_meta(
        model_family=model_family, image_size=image_size, batch_sizes=batch_sizes,
        backend=backend, mesh_devices=mesh_devices, space_devices=space_devices,
        platforms=[device.type], compute_dtype=compute_dtype, quantize=quantize, **family_meta,
    )
    write_artifact(out, serialized, meta, classifier if space_devices > 1 else None)
    report = {
        "export_s": seconds,
        "entry_bytes": {bs: len(b) for bs, b in serialized.items()},
        "artifact_bytes": os.path.getsize(out),
        "total_s": time.perf_counter() - t0,
    }
    print(
        f"exported {len(serialized)} entry point(s) (bs {sorted(serialized)}, device "
        f"{device.type}" + (f" x {mesh_devices} replicas" if mesh_devices > 1 else "")
        + (f" x {space_devices} bands of rows" if space_devices > 1 else "")
        + f", backend {backend}, quantize {quantize}) to {out} "
        f"({report['artifact_bytes'] / 1e6:.2f} MB; export s per entry "
        + ", ".join(f"bs {bs}: {s:.2f}" for bs, s in report["export_s"].items()) + ")"
    )
    return report


if __name__ == "__main__":
    main()
