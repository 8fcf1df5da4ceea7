"""SIGTERM turns into a clean stop that saves the full train state (port of
``dctn_tpu/train/preemption.py``, on one process).

A preempted machine gets SIGTERM and a grace period. The handler only sets
a flag; the hook it makes runs on the training thread after the step in
flight, writes the train state (parameters, optimizer moments, step and the
dropout generator's state) and stops the loop with a ``preempted`` reason.
``--resume-from <run>/train_state_latest.npz`` then continues the same
trajectory: the runner restores that state and fast-forwards the shuffled
batch stream to the saved step.

Under data parallelism a rank that stopped alone would leave the others
waiting in the next step's all-reduce, so ``make_synced_hook`` (JAX
preemption.py:86-115) stops them together: every ``sync_every``
iterations all ranks agree whether any of them was signalled, and if one
was, all save (global rank 0 writes) and stop at the same step. The
spawner passes a SIGTERM it receives on to every rank.
"""

from __future__ import annotations

import logging
import signal
from typing import Callable, Optional, Sequence

logger = logging.getLogger(__name__)


class PreemptionHandler:
    """A context manager that installs handlers for ``signals`` which
    request a clean stop, and restores the previous ones on exit."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.fired: Optional[str] = None
        self._prev: dict = {}
        self.installed = False

    def __enter__(self) -> "PreemptionHandler":
        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._on_signal)
            self.installed = True
        except ValueError:
            # signal.signal works on the main thread only: a caller driving
            # run() from another thread trains without preemption safety
            logger.warning("not on the main thread — preemption handler disabled")
        return self

    def __exit__(self, *exc) -> bool:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self.installed = False
        return False

    def _on_signal(self, signum, frame) -> None:
        self.fired = signal.Signals(signum).name
        logger.warning(
            "received %s: checkpointing train state and stopping after the current step",
            self.fired,
        )

    def make_hook(self, save_fn: Callable) -> Callable:
        """A loop hook: once a signal has fired, ``save_fn(state)`` writes the
        train state (the runner passes the offset right for the hook's place
        in the loop) and the loop stops."""

        def hook(state) -> None:
            if self.fired is not None and not state.stop:
                save_fn(state)
                state.stop = True
                state.stop_reason = f"preempted ({self.fired}); train state saved for --resume-from"

        return hook

    def make_synced_hook(self, save_fn: Callable, sync_every: int,
                         agree: Callable[[bool], bool]) -> Callable:
        """An at-iteration-start hook for data-parallel ranks: a local signal
        stops nothing by itself; every ``sync_every`` iterations
        ``agree(fired)`` (``DataMesh.any``, a collective every rank calls)
        tells whether any rank was signalled, and if one was, every rank
        runs ``save_fn(state)`` and stops at this same iteration. The stop
        can come up to ``sync_every`` steps after the signal: keep that
        inside the grace period."""
        if sync_every < 1:
            raise ValueError(f"sync_every must be at least 1, not {sync_every}")

        def hook(state) -> None:
            if state.stop or state.num_iters_done % sync_every:
                return
            if agree(self.fired is not None):
                save_fn(state)
                state.stop = True
                state.stop_reason = (
                    f"preempted ({self.fired or 'a signal on another rank'}; every rank stopped "
                    "at the same step); train state saved for --resume-from"
                )

        return hook
