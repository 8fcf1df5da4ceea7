"""Command-line value parsers and the defaults of ``run(**kw)`` (from
``dctn_tpu/cli/runner.py``, which imports jax and so cannot be shared)."""

from __future__ import annotations

import re
from typing import Tuple

import click


def parse_epses_specs(s: str) -> Tuple[Tuple[int, int], ...]:
    """'(4,4),(3,6)' → ((4, 4), (3, 6)) (runner.py:132)."""
    if re.match(r"^\((\d+),(\d+)\)(,\((\d+),(\d+)\))*$", s) is None:
        raise click.BadParameter(f"bad epses specs {s!r}")
    nums = [int(x) for x in re.findall(r"\d+", s)]
    return tuple((nums[i], nums[i + 1]) for i in range(0, len(nums), 2))


def fill_defaults(command: click.Command, kw: dict) -> dict:
    """``kw`` with every option of ``command`` it lacks at the CLI's default,
    converted as click converts a string default (runner.py:364-373): the
    contract of the runners' ``run(**kw)``."""
    for param in command.params:
        if param.name not in kw:
            default = param.default
            if type(default).__name__ == "Sentinel" or default is None:  # no default
                default = () if param.multiple else None
            elif isinstance(default, str):
                default = param.type.convert(default, param, None)
            kw[param.name] = default
    return kw
