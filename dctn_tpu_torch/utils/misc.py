"""Small boolean helpers and the value types that name one tensor's
initialization (a copy of ``dctn_tpu/utils/misc.py``: the port imports
nothing of the JAX package)."""

from __future__ import annotations

import dataclasses
from typing import Union


def implies(x: bool, y: bool) -> bool:
    return (not x) or y


def xor(*args: bool) -> bool:
    result = False
    for a in args:
        result = result != bool(a)
    return result


def exactly_one_true(*args: bool) -> bool:
    if not all(isinstance(a, bool) for a in args):
        raise TypeError("exactly_one_true expects bools")
    return sum(args) == 1


@dataclasses.dataclass(frozen=True)
class ZeroCenteredNormalInit:
    std: float


@dataclasses.dataclass(frozen=True)
class ZeroCenteredUniformInit:
    maximum: float


@dataclasses.dataclass(frozen=True)
class FromFileInit:
    path: str


OneTensorInit = Union[ZeroCenteredNormalInit, ZeroCenteredUniformInit, FromFileInit]
