"""Command-line value parsers (from ``dctn_tpu/cli/runner.py``, which
imports jax and so cannot be shared)."""

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
