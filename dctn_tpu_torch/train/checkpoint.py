"""Parameter checkpoints as npz (port of ``dctn_tpu/train/checkpoint.py``
for the model parameters).

The file is the one ``dctn_tpu.train.save_pytree`` writes for a parameter
pytree: one array per leaf, keyed by its tree path (checkpoint.py:22-63) —
``epses/0``, …, ``linear/b``, ``linear/w`` for the EPS model, and
``{layer}/{string}/{core}`` for the legacy ConvSBS model's nested tuples.
numpy only, so one file serves both packages.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict

import numpy as np

_EPS_KEY = re.compile(r"^epses/(\d+)$")
_CONV_SBS_KEY = re.compile(r"^(\d+)/(\d+)/(\d+)$")


def _to_numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


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
