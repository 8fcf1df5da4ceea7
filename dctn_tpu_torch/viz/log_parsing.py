"""Parse training ``log.log`` eval lines back into records (a copy of
``dctn_tpu/viz/log_parsing.py``: the port's runners write the same eval
lines).

Capability parity: reference ``dctn/visualization/log_parsing.py``. The
eval-line *format* is the shared contract between the runner's logging and
this parser (and the plotting layer above it); the implementation below is
this repo's own — a table-driven single-pass regex parse and a running-max
filter expressed as a scan.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Iterable, List, Optional, Tuple, TypeVar

T = TypeVar("T")

# One named group per Record field; the runner may append extra fields (e.g.
# " reg_term=...") after the match, which this deliberately tolerates.
_EVAL_LINE = re.compile(
    r"After (?P<nitd>\d+) iters: "
    r"train/val mean_ce=(?P<trmce>\d+\.\d+)/(?P<vmce>\d+\.\d+) "
    r"acc=(?P<tracc>\d+\.\d+)%/(?P<vacc>\d+\.\d+)"
)

# field -> conversion applied to the captured string
_CONVERSIONS: Tuple[Tuple[str, Callable[[str], Any]], ...] = (
    ("nitd", int),
    ("trmce", float),
    ("vmce", float),
    ("tracc", lambda s: float(s) / 100.0),
    ("vacc", lambda s: float(s) / 100.0),
)


@dataclasses.dataclass(frozen=True)
class Record:
    nitd: int
    trmce: float
    vmce: float
    tracc: float
    vacc: float


def get_increasing_subsequence(
    xs: Iterable[T], calc_key: Callable[[T], Any] = lambda x: x
) -> List[T]:
    """Elements whose key strictly exceeds every key seen before them.

    (The greedy left-to-right increasing subsequence — NOT the longest one;
    matches the reference's filter semantics for monotone-tracc plots.)
    """
    kept: List[T] = []
    best = None
    have_best = False
    for x in xs:
        k = calc_key(x)
        if not have_best or k > best:
            kept.append(x)
            best = k
            have_best = True
    return kept


def maybe_extract_record(line: str) -> Optional[Record]:
    m = _EVAL_LINE.search(line)
    if m is None:
        return None
    return Record(**{name: conv(m[name]) for name, conv in _CONVERSIONS})


def load_records(log_fname: str, increasing_tracc: bool = False) -> Tuple[Record, ...]:
    records: List[Record] = []
    with open(log_fname, encoding="utf-8") as f:
        for line in f:
            rec = maybe_extract_record(line)
            if rec is not None:
                records.append(rec)
    if increasing_tracc:
        records = get_increasing_subsequence(records, lambda r: r.tracc)
    return tuple(records)
