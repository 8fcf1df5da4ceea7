"""Parameters across the two packages: the JAX package's reference-layout
parameter pytree, given as numpy arrays, to the port's tensors and back."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def params_from_numpy(
    np_params: Dict[str, Any], device="cpu", dtype: Optional[torch.dtype] = None
) -> Dict[str, Any]:
    """``{"epses": (core, …), "linear": {"w", "b"}}`` of numpy arrays → the
    same structure of tensors on ``device`` (in ``dtype`` if given)."""

    def conv(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return {
        "epses": tuple(conv(c) for c in np_params["epses"]),
        "linear": {k: conv(v) for k, v in np_params["linear"].items()},
    }


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of ``params_from_numpy``."""

    def conv(t):
        return t.detach().cpu().numpy()

    return {
        "epses": tuple(conv(c) for c in params["epses"]),
        "linear": {k: conv(v) for k, v in params["linear"].items()},
    }
