"""Checkpoints as npz (port of ``dctn_tpu/train/checkpoint.py``): model
parameters, the full train state of the EPS runner, and ``AsyncWriter``,
which writes them on a host thread.

A file is the one ``dctn_tpu.train.save_pytree`` writes for a pytree: one
array per leaf, keyed by its tree path (checkpoint.py:22-63), dict keys in
sorted order: ``epses/0``, …, ``linear/b``, ``linear/w`` for the EPS model,
and ``{layer}/{string}/{core}`` for the legacy ConvSBS model's nested
tuples. numpy only, so a parameter file serves both packages.

The train state (``train_state_arrays``, ``load_train_state``) has the
JAX runner's keys (cli/runner.py:1510-1538): ``params/…`` in the layout
``param_layout`` names (1 = fast cmt, 0 = reference), the optimizer's
moments under ``opt_state/{i}/mu/…`` and ``…/nu/…`` with their step
``opt_state/{i}/count`` (i = 1 after weight decay's empty state, else 0;
none for SGD), ``step``, ``eps_splits``, each layer's matmul split, which
fixes the cmt shapes, and ``rng``, a uint32 (2,) key in the layout of
``jax.random.key_data``, so that the JAX runner resumes a state the port
wrote. The port's dropout stream is the state of its generator, kept
under ``generator_state``; neither package can continue the other's, so a
state crosses packages exactly only without dropout.

The legacy ConvSBS runner's train state (``conv_sbs_train_state_arrays``,
``load_conv_sbs_train_state``) has the JAX legacy runner's keys for the
params and the loop's position (legacy_runner.py:59-74) and the torch
optimizer's own state under ``torch_opt_state/…``.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

_EPS_KEY = re.compile(r"^epses/(\d+)$")
_CONV_SBS_KEY = re.compile(r"^(\d+)/(\d+)/(\d+)$")


def _to_numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """Leaves of nested dicts, tuples and lists keyed by their paths, as
    ``save_pytree`` names them: dict keys sorted, sequence items by index,
    ``/`` between."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, value in items:
        out.update(flatten_tree(value, f"{prefix}/{key}" if prefix else key))
    return out


class AsyncWriter:
    """Writes npz files on background threads, so that the training loop
    does not wait for the disk (``AsyncWriter``, checkpoint.py:66-102).
    ``submit`` copies the tree to the host at once (the tensors change with
    the next step) and returns; ``wait`` joins every pending write. A write
    goes to ``<file>.tmp`` first and is renamed into place; writes to one
    file run in the order they were submitted, each after the one before
    (two at once would share the temporary file)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: list = []
        self._last: Dict[str, threading.Thread] = {}

    def submit(self, tree, filename: str) -> None:
        host = {k: _to_numpy(v) for k, v in flatten_tree(tree).items()}
        with self._lock:
            before = self._last.get(filename)

            def write():
                if before is not None:
                    before.join()
                _write_npz(host, filename)

            t = threading.Thread(target=write, daemon=True)
            self._last[filename] = t
            t.start()
            self._pending = [x for x in self._pending if x.is_alive()] + [t]

    def wait(self) -> None:
        with self._lock:
            pending = list(self._pending)
        for t in pending:
            t.join()


def _write_npz(arrays: Dict[str, np.ndarray], filename: str) -> None:
    tmp = filename + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, filename)


def save_params_npz(params: Dict[str, Any], filename: str) -> None:
    """Write reference-layout ``params`` (torch tensors or numpy arrays)."""
    arrays = {f"epses/{i}": _to_numpy(c) for i, c in enumerate(params["epses"])}
    arrays.update({f"linear/{k}": _to_numpy(v) for k, v in params["linear"].items()})
    _write_npz(arrays, filename)


def load_params_npz(filename: str) -> Dict[str, Any]:
    """Read reference-layout parameters as numpy arrays."""
    with np.load(filename) as data:
        idx = sorted(int(m.group(1)) for k in data.files if (m := _EPS_KEY.match(k)))
        if not idx or idx != list(range(len(idx))):
            raise KeyError(f"checkpoint {filename} has no epses/0..N-1 leaves")
        for key in ("linear/w", "linear/b"):
            if key not in data.files:
                raise KeyError(f"checkpoint {filename} missing leaf {key}")
        return {
            "epses": tuple(data[f"epses/{i}"] for i in idx),
            "linear": {"w": data["linear/w"], "b": data["linear/b"]},
        }


def save_conv_sbs_params_npz(params, filename: str) -> None:
    """Write the legacy ConvSBS params (a tuple over layers of tuples over
    strings of tuples of cores, torch tensors or numpy arrays)."""
    _write_npz(
        {f"{l}/{s}/{c}": _to_numpy(core)
         for l, layer in enumerate(params)
         for s, string in enumerate(layer)
         for c, core in enumerate(string)},
        filename,
    )


def load_conv_sbs_params_npz(filename: str):
    """Read the legacy ConvSBS params as numpy arrays, nested as written."""
    with np.load(filename) as data:
        keys = {tuple(int(g) for g in m.groups()): k
                for k in data.files if (m := _CONV_SBS_KEY.match(k))}
        if not keys:
            raise KeyError(f"checkpoint {filename} has no {{layer}}/{{string}}/{{core}} leaves")
        params = []
        for l in range(max(l for l, _, _ in keys) + 1):
            strings = []
            for s in range(max(s for ll, s, _ in keys if ll == l) + 1):
                n = max(c for ll, ss, c in keys if (ll, ss) == (l, s)) + 1
                missing = [c for c in range(n) if (l, s, c) not in keys]
                if missing:
                    raise KeyError(f"checkpoint {filename} missing leaves {l}/{s}/{missing}")
                strings.append(tuple(data[keys[(l, s, c)]] for c in range(n)))
            params.append(tuple(strings))
        return tuple(params)


# ---------------------------------------------------------------------------
# the EPS runner's train state


def _is_fast(model) -> bool:
    """Whether ``model`` holds the fast (cmt) layout (``EPSesPlusLinear``)
    or the reference one (``EPSesPlusLinearReference``)."""
    return hasattr(model, "cmts")


def _param_names(model):
    """(key under ``params/``, parameter) of the model, in its layout."""
    cores = (("epses_cmt", model.cmts) if _is_fast(model) else ("epses", model.cores))
    return [(f"{cores[0]}/{i}", c) for i, c in enumerate(cores[1])] + [
        ("linear/w", model.linear_w), ("linear/b", model.linear_b)
    ]


def jax_key_data(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.PRNGKey(seed))`` for the default
    threefry key, in numpy: the seed's high and low 32 bits."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _opt_prefix(optimizer: torch.optim.Optimizer) -> Optional[str]:
    """Where optax's chain keeps Adam's state: ``opt_state/1`` after
    ``add_decayed_weights``, else ``opt_state/0``; None for SGD (no state)."""
    if not isinstance(optimizer, torch.optim.Adam):
        return None
    return "opt_state/1" if optimizer.param_groups[0]["weight_decay"] else "opt_state/0"


def train_state_arrays(
    model, optimizer, step: int, plans, generator=None, seed: int = 0
) -> Dict[str, Any]:
    """The train state of ``model`` (either layout) and ``optimizer`` after
    ``step`` iterations, keyed as the JAX runner's ``save_train_state``
    writes it, with the dropout ``generator``'s state, and as ``rng`` the
    JAX key of ``seed`` (``jax_key_data``): tensors, for
    ``AsyncWriter.submit``. Before the first step Adam's moments are 0."""
    out: Dict[str, Any] = {f"params/{k}": p for k, p in _param_names(model)}
    prefix = _opt_prefix(optimizer)
    if prefix is not None:
        count = 0
        for k, p in _param_names(model):
            st = optimizer.state.get(p, {})
            out[f"{prefix}/mu/{k}"] = st.get("exp_avg", torch.zeros_like(p))
            out[f"{prefix}/nu/{k}"] = st.get("exp_avg_sq", torch.zeros_like(p))
            count = int(st["step"]) if "step" in st else count
        out[f"{prefix}/count"] = np.int32(count)
    out["step"] = np.int64(step)
    out["rng"] = jax_key_data(seed)
    out["param_layout"] = np.int32(1 if _is_fast(model) else 0)
    if _is_fast(model):
        out["eps_splits"] = np.asarray([p["n1"] for p in plans], np.int32)
    if generator is not None:
        out["generator_state"] = generator.get_state()
    return out


def load_train_state(filename: str, model, optimizer, cfg, plans, generator=None) -> int:
    """Restores ``model``'s parameters, ``optimizer``'s state and the
    ``generator``'s from a train state file; returns its ``step``. A file in
    the other layout than ``model``'s (``param_layout``), or saved under
    other splits (``eps_splits``; none: the legacy split rule) is
    converted, parameters and moments alike (the layouts differ by a
    permutation, and the moments are elementwise), as the JAX runner
    converts (runner.py:1283-1400). ``plans`` are the fast layout's, for a
    reference-layout ``model`` too. A file the JAX runner wrote has no
    ``generator_state``: the generator is then left as it is."""
    from ..models.eps_plus_linear import (
        fast_params_from_reference,
        legacy_split_plans,
        reference_params_from_fast,
    )

    with np.load(filename) as data:
        arrays = {k: data[k] for k in data.files}
    saved_fast = bool(arrays.get("param_layout", 0))
    if saved_fast and "eps_splits" in arrays:
        saved_plans = tuple({**p, "n1": int(s)} for p, s in zip(plans, arrays["eps_splits"]))
    elif saved_fast:
        saved_plans = legacy_split_plans(plans)
    fast_target = _is_fast(model)
    same_layout = (saved_fast and fast_target
                   and [p["n1"] for p in saved_plans] == [p["n1"] for p in plans])

    def group(prefix: str):
        """The parameter-shaped group under ``prefix``, in the model's layout."""
        def get(key):
            if f"{prefix}/{key}" not in arrays:
                raise KeyError(f"train state {filename} missing leaf {prefix}/{key}")
            return torch.from_numpy(np.array(arrays[f"{prefix}/{key}"]))

        linear = {"w": get("linear/w"), "b": get("linear/b")}
        n = len(plans)
        if saved_fast:
            fast = {"epses_cmt": tuple(get(f"epses_cmt/{i}") for i in range(n)), "linear": linear}
            if same_layout:
                return fast
            ref = reference_params_from_fast(fast, cfg, saved_plans)
        else:
            ref = {"epses": tuple(get(f"epses/{i}") for i in range(n)), "linear": linear}
        return fast_params_from_reference(ref, cfg, plans)[0] if fast_target else ref

    def by_name(tree):
        cores = "epses_cmt" if fast_target else "epses"
        return {f"{cores}/{i}": c for i, c in enumerate(tree[cores])} | {
            f"linear/{k}": v for k, v in tree["linear"].items()
        }

    params = by_name(group("params"))
    with torch.no_grad():
        for k, p in _param_names(model):
            if tuple(params[k].shape) != tuple(p.shape):
                raise ValueError(
                    f"train state {filename}: {k} is {tuple(params[k].shape)}, the model's "
                    f"{tuple(p.shape)}"
                )
            p.copy_(params[k])
    prefix = _opt_prefix(optimizer)
    if prefix is not None:
        mu, nu = by_name(group(f"{prefix}/mu")), by_name(group(f"{prefix}/nu"))
        key = f"{prefix}/count"
        if key not in arrays:
            raise KeyError(f"train state {filename} missing leaf {key}")
        count = float(arrays[key])
        # a state_dict numbers the parameters in the optimizer's own order
        order = [p for group in optimizer.param_groups for p in group["params"]]
        sd = optimizer.state_dict()
        sd["state"] = {
            next(i for i, q in enumerate(order) if q is p): {
                "step": torch.tensor(count, dtype=torch.float32), "exp_avg": mu[k],
                "exp_avg_sq": nu[k],
            }
            for k, p in _param_names(model)
        }
        optimizer.load_state_dict(sd)
    if generator is not None and "generator_state" in arrays:
        generator.set_state(torch.from_numpy(np.array(arrays["generator_state"])))
    return int(arrays["step"])


def index_stream_arrays(orders, cursors, world_size: int) -> Dict[str, Any]:
    """A data-parallel train state's extra leaves (rank 0 writes them beside
    ``train_state_arrays``'): ``mesh_devices``, the rank count it was saved
    on, and the position of the ranks' index streams
    (``parallel.LocalIndexStream``) at its step: each shard's epoch order
    ``index_stream/orders/{d}`` and ``index_stream/cursors``. A resume on
    the same rank count fast-forwards its streams to the step and checks
    them against these; the JAX package's loader reads none of them."""
    out: Dict[str, Any] = {f"index_stream/orders/{d}": np.asarray(o, np.int64)
                           for d, o in enumerate(orders)}
    out["index_stream/cursors"] = np.asarray(cursors, np.int64)
    out["mesh_devices"] = np.int32(world_size)
    return out


def saved_index_stream(filename: str):
    """(rank count, orders, cursors) of a train state: 1 and None, None
    for a single-device state; the rank count and None, None for a state
    the JAX runner wrote, which records neither."""
    with np.load(filename) as data:
        world = int(data["mesh_devices"]) if "mesh_devices" in data.files else 1
        if "index_stream/cursors" not in data.files:
            return world, None, None
        cursors = data["index_stream/cursors"].tolist()
        return world, [data[f"index_stream/orders/{d}"] for d in range(len(cursors))], cursors


# ---------------------------------------------------------------------------
# the legacy ConvSBS runner's train state


def conv_sbs_train_state_arrays(
    params, optimizer: torch.optim.Optimizer, warmup_step: int, epoch: int,
    step_in_epoch: int, best_acc: float, bad_epochs: int,
) -> Dict[str, Any]:
    """Everything the legacy epoch loop needs to continue a trajectory
    exactly (``_train_state_tree``, legacy_runner.py:59-74): the cores
    under ``params/{layer}/{string}/{core}``, the loop's position
    (``epoch``, ``step_in_epoch``) and the best-model and early-stopping
    bookkeeping under the JAX keys; the torch optimizer's per-parameter
    state (momentum buffers, RMSprop's square averages and step counts)
    under ``torch_opt_state/{parameter index}/{name}``, and the warmup
    schedule's step count under ``warmup_step``. The epoch-shuffle RNG is
    not stored: the runner fast-forwards its seeded chain on resume."""
    out: Dict[str, Any] = {
        f"params/{l}/{s}/{c}": core
        for l, layer in enumerate(params)
        for s, string in enumerate(layer)
        for c, core in enumerate(string)
    }
    for i, state in optimizer.state_dict()["state"].items():
        for name, value in state.items():
            if value is not None:
                out[f"torch_opt_state/{i}/{name}"] = value
    out.update(
        epoch=np.int64(epoch), step_in_epoch=np.int64(step_in_epoch),
        best_acc=np.float64(best_acc), bad_epochs=np.int64(bad_epochs),
        warmup_step=np.int64(warmup_step),
    )
    return out


def load_conv_sbs_train_state(filename: str, model, optimizer: torch.optim.Optimizer):
    """Restores the legacy ``model``'s cores and ``optimizer``'s state from a
    train state file; returns (warmup_step, epoch, step_in_epoch, best_acc,
    bad_epochs)."""
    with np.load(filename) as data:
        arrays = {k: data[k] for k in data.files}
    for key in ("epoch", "step_in_epoch", "best_acc", "bad_epochs", "warmup_step"):
        if key not in arrays:
            raise KeyError(f"train state {filename} missing leaf {key}")
    with torch.no_grad():
        for l, layer in enumerate(model.params()):
            for s, string in enumerate(layer):
                for c, core in enumerate(string):
                    key = f"params/{l}/{s}/{c}"
                    if key not in arrays:
                        raise KeyError(f"train state {filename} missing leaf {key}")
                    if tuple(arrays[key].shape) != tuple(core.shape):
                        raise ValueError(
                            f"train state {filename}: {key} is {arrays[key].shape}, the "
                            f"model's {tuple(core.shape)}"
                        )
                    core.copy_(torch.from_numpy(arrays[key]))
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for key, value in arrays.items():
        if key.startswith("torch_opt_state/"):
            _, i, name = key.split("/")
            state.setdefault(int(i), {})[name] = torch.from_numpy(np.array(value))
    sd = optimizer.state_dict()
    sd["state"] = state
    optimizer.load_state_dict(sd)
    return (int(arrays["warmup_step"]), int(arrays["epoch"]), int(arrays["step_in_epoch"]),
            float(arrays["best_acc"]), int(arrays["bad_epochs"]))
