"""Parameter checkpoints as npz (port of ``dctn_tpu/train/checkpoint.py``
for the model parameters).

The file is the one ``dctn_tpu.train.save_pytree`` writes for the
reference-layout parameter pytree: one array per leaf, keyed by its tree
path — ``epses/0``, ``epses/1``, …, ``linear/b``, ``linear/w``
(checkpoint.py:22-63). numpy only, so one file serves both packages.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict

import numpy as np

_EPS_KEY = re.compile(r"^epses/(\d+)$")


def _to_numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def save_params_npz(params: Dict[str, Any], filename: str) -> None:
    """Write reference-layout ``params`` (torch tensors or numpy arrays)."""
    arrays = {f"epses/{i}": _to_numpy(c) for i, c in enumerate(params["epses"])}
    arrays.update({f"linear/{k}": _to_numpy(v) for k, v in params["linear"].items()})
    tmp = filename + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, filename)


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
