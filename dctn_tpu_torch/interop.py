"""Parameters across the two packages: the JAX package's reference-layout
parameter pytrees (the EPS model's and the legacy ConvSBS model's), given as
numpy arrays, to the port's tensors and back; and both models' params to
and from the reference torch ``state_dict``."""

from __future__ import annotations

import re
import zipfile
from typing import Any, Dict, Mapping, Optional

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


def conv_sbs_params_from_numpy(np_params, device="cpu", dtype: Optional[torch.dtype] = None):
    """The legacy ConvSBS params, a tuple over layers of tuples over strings
    of tuples of cores, numpy → tensors on ``device`` (in ``dtype`` if
    given)."""
    return tuple(
        tuple(tuple(torch.tensor(np.asarray(c), dtype=dtype, device=device) for c in string)
              for string in layer)
        for layer in np_params
    )


def conv_sbs_params_to_numpy(params):
    """Inverse of ``conv_sbs_params_from_numpy``."""
    return tuple(
        tuple(tuple(c.detach().cpu().numpy() for c in string) for string in layer)
        for layer in params
    )


_EPS_KEY = re.compile(r"^epses\.(\d+)$")


def eps_plus_linear_params_from_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference ``EPSesPlusLinear.state_dict()`` → reference-layout
    params as numpy (``interop/torch_checkpoint.py:115-142``): the cores
    ``epses.{i}`` as they are, ``linear.weight`` transposed from torch's
    (out, in) to (in, out). Raises for another model's keys."""
    cores = {int(m.group(1)): torch.as_tensor(v).detach().cpu().numpy()
             for k, v in sd.items() if (m := _EPS_KEY.match(k))}
    if not cores or "linear.weight" not in sd or "linear.bias" not in sd:
        raise ValueError(
            "state_dict is not an EPSesPlusLinear checkpoint (expected 'epses.{i}' + "
            f"'linear.weight'/'linear.bias' keys; got {sorted(sd)[:6]}...)"
        )
    n = max(cores) + 1
    missing = [i for i in range(n) if i not in cores]
    if missing:
        raise ValueError(f"state_dict missing epses indices {missing}")
    weight = torch.as_tensor(sd["linear.weight"]).detach().cpu().numpy()
    return {
        "epses": tuple(cores[i] for i in range(n)),
        "linear": {"w": np.ascontiguousarray(weight.T),
                   "b": torch.as_tensor(sd["linear.bias"]).detach().cpu().numpy()},
    }


def state_dict_from_eps_plus_linear_params(params, dropout_p: float = 1.0) -> Dict[str, torch.Tensor]:
    """Reference-layout params (tensors or numpy) → a ``state_dict`` the
    reference ``EPSesPlusLinear`` loads (torch_checkpoint.py:145-165), with
    its keep-probability buffer ``p``."""

    def cpu(a):
        return a.detach().cpu().clone() if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a))

    sd = {f"epses.{i}": cpu(c) for i, c in enumerate(params["epses"])}
    sd["linear.weight"] = cpu(params["linear"]["w"]).T.contiguous()
    sd["linear.bias"] = cpu(params["linear"]["b"])
    sd["p"] = torch.tensor(dropout_p, dtype=sd["linear.bias"].dtype)
    return sd


_CONV_SBS_KEY = re.compile(r"^conv_sbses\.(\d+)\.strings\.(\d+)\.cores\.(\d+)$")


def state_dict_from_conv_sbs_params(params) -> Dict[str, torch.Tensor]:
    """ConvSBS params → a ``state_dict`` that the reference
    ``DCTNMnistModel`` loads (``interop/torch_checkpoint.py:190-202``)."""
    return {
        f"conv_sbses.{l}.strings.{s}.cores.{c}": (
            core.detach().cpu().clone() if isinstance(core, torch.Tensor)
            else torch.tensor(np.asarray(core))
        )
        for l, layer in enumerate(params)
        for s, string in enumerate(layer)
        for c, core in enumerate(string)
    }


def conv_sbs_params_from_state_dict(sd: Mapping[str, Any]):
    """A reference ``DCTNMnistModel.state_dict()`` → ConvSBS params as numpy
    (``interop/torch_checkpoint.py:168-187``); raises for another model's
    keys."""
    cores = {}
    for key, value in sd.items():
        m = _CONV_SBS_KEY.match(key)
        if m:
            cores[tuple(int(g) for g in m.groups())] = torch.as_tensor(value).detach().cpu().numpy()
    if not cores:
        raise ValueError(
            "state_dict is not a DCTNMnistModel checkpoint (expected "
            f"'conv_sbses.{{l}}.strings.{{s}}.cores.{{c}}' keys; got {sorted(sd)[:6]}...)"
        )
    n_layers = max(l for l, _, _ in cores) + 1
    return tuple(
        tuple(
            tuple(cores[(l, s, c)]
                  for c in range(max(c for ll, ss, c in cores if (ll, ss) == (l, s)) + 1))
            for s in range(max(s for ll, s, _ in cores if ll == l) + 1)
        )
        for l in range(n_layers)
    )


def is_torch_checkpoint(path: str) -> bool:
    """True if ``path`` is a torch checkpoint rather than an npz (a copy of
    ``interop/torch_checkpoint.py:51-65``): npz archives hold ``*.npy``
    members, torch ≥ 1.6 archives a ``data.pkl`` one, and an older torch
    save is no zip at all."""
    try:
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
    except zipfile.BadZipFile:
        return True
    if any(n.endswith("data.pkl") for n in names):
        return True
    return not any(n.endswith(".npy") for n in names)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch-saved ``state_dict`` (or one wrapped under a ``state_dict`` or
    ``model`` key), its tensors on the CPU (torch_checkpoint.py:68-102).
    Loaded with ``weights_only``: tensors and containers only."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    if not isinstance(obj, dict) or not all(isinstance(v, torch.Tensor) for v in obj.values()):
        raise ValueError(f"{path} does not contain a torch state_dict (got {type(obj).__name__})")
    return obj
