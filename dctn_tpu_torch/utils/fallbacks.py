"""Performance fallbacks: a fast path that a run did not take is logged
once and recorded (a copy of ``dctn_tpu/utils/fallbacks.py``).

``record(reason)`` logs one warning per distinct reason per process and
remembers it; the runners register a sink that appends each new reason to
the run's ``run_info.txt``, so the provenance record says which fast paths
the run did not take.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, List, Tuple

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_events: List[str] = []
_sinks: List[Callable[[str], None]] = []


def record(reason: str) -> None:
    """Log and remember a performance fallback (once per reason)."""
    with _lock:
        if reason in _events:
            return
        _events.append(reason)
        sinks = list(_sinks)
    logger.warning("performance fallback: %s", reason)
    for sink in sinks:
        try:
            sink(reason)
        except Exception:  # a sink failure must never break the hot path
            logger.exception("fallback sink failed")


def events() -> Tuple[str, ...]:
    """All distinct fallback reasons recorded so far."""
    with _lock:
        return tuple(_events)


def add_sink(sink: Callable[[str], None]) -> None:
    """Register a callback invoked once per new distinct reason."""
    with _lock:
        _sinks.append(sink)


def file_sink(path: str) -> Callable[[str], None]:
    """A sink appending ``performance_fallback: <reason>`` lines to ``path``,
    opening the file per event so each line is flushed at once."""

    def sink(reason: str) -> None:
        with open(path, "a") as f:
            f.write(f"performance_fallback: {reason}\n")

    return sink


def reset() -> None:
    """Clear events and sinks (a runner calls it at start, so one process
    running several jobs attributes each event to its own run)."""
    with _lock:
        _events.clear()
        _sinks.clear()
