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
none for SGD), ``step``, and ``eps_splits``, each layer's matmul split,
which fixes the cmt shapes. The JAX ``rng`` key has no counterpart: the
port keeps the state of its dropout generator under ``generator_state``.
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
    goes to ``<file>.tmp`` first and is renamed into place."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: list = []

    def submit(self, tree, filename: str) -> None:
        host = {k: _to_numpy(v) for k, v in flatten_tree(tree).items()}
        t = threading.Thread(target=_write_npz, args=(host, filename), daemon=True)
        t.start()
        with self._lock:
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


def _param_names(model):
    """(key under ``params/``, parameter) of the fast-layout model."""
    return [(f"epses_cmt/{i}", c) for i, c in enumerate(model.cmts)] + [
        ("linear/w", model.linear_w), ("linear/b", model.linear_b)
    ]


def _opt_prefix(optimizer: torch.optim.Optimizer) -> Optional[str]:
    """Where optax's chain keeps Adam's state: ``opt_state/1`` after
    ``add_decayed_weights``, else ``opt_state/0``; None for SGD (no state)."""
    if not isinstance(optimizer, torch.optim.Adam):
        return None
    return "opt_state/1" if optimizer.param_groups[0]["weight_decay"] else "opt_state/0"


def train_state_arrays(model, optimizer, step: int, plans, generator=None) -> Dict[str, Any]:
    """The train state of ``model`` (fast layout) and ``optimizer`` after
    ``step`` iterations, keyed as the JAX runner's ``save_train_state``
    writes it, with the dropout ``generator``'s state: tensors, for
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
    out["param_layout"] = np.int32(1)
    out["eps_splits"] = np.asarray([p["n1"] for p in plans], np.int32)
    if generator is not None:
        out["generator_state"] = generator.get_state()
    return out


def load_train_state(filename: str, model, optimizer, cfg, plans, generator=None) -> int:
    """Restores ``model``'s parameters, ``optimizer``'s state and the
    ``generator``'s from a train state file; returns its ``step``. A file in
    the reference layout (``param_layout`` 0) or saved under other splits
    (``eps_splits``; none: the legacy split rule) is converted, parameters
    and moments alike (the layouts differ by a permutation, and the moments
    are elementwise), as the JAX runner converts (runner.py:1283-1400)."""
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
    same_layout = saved_fast and [p["n1"] for p in saved_plans] == [p["n1"] for p in plans]

    def group(prefix: str):
        """The parameter-shaped group under ``prefix``, in the current layout."""
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
        return fast_params_from_reference(ref, cfg, plans)[0]

    def by_name(fast):
        return {f"epses_cmt/{i}": c for i, c in enumerate(fast["epses_cmt"])} | {
            f"linear/{k}": v for k, v in fast["linear"].items()
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
