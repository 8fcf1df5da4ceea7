"""Device traces of a window of training iterations (port of
``dctn_tpu/utils/profiling.py``, on ``torch.profiler``).

``StepTracer`` is a loop hook that records CPU and, where a card is
present, CUDA activity over iterations ``[start, start + count)`` and
writes the trace into its directory with
``torch.profiler.tensorboard_trace_handler`` (a ``*.pt.trace.json`` file,
which TensorBoard's profiler plugin and chrome://tracing read). A backend
that cannot trace is logged and skipped, as in the JAX package; callers that
need the trace check the directory (``trace_files``).
"""

from __future__ import annotations

import contextlib
import glob
import logging
import os
import time
from typing import List

import torch

logger = logging.getLogger(__name__)


def _profiler(log_dir: str):
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def trace_files(log_dir: str) -> List[str]:
    """The traces written into ``log_dir``."""
    return sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json*")))


class StepTracer:
    """A train-loop hook tracing iterations [start, start + count): append it
    to the loop's ``at_iter_start`` hooks and call :meth:`close` after
    training, which may stop inside the window (profiling.py:17-66). The
    trace starts before iteration ``start``'s step and stops before
    iteration ``start + count``'s, with the card synchronised first so that
    the window holds its kernels. ``window_s`` is then the window's wall
    time between those two synchronisations, over ``iterations``
    iterations, and ``export_s`` the time the trace took to write."""

    def __init__(self, log_dir: str, start: int, count: int):
        if count < 1:
            raise ValueError(f"a trace window of {count} iterations")
        self.log_dir = log_dir
        self.start = start
        self.stop_at = start + count
        self.active = False
        self.done = False
        self._prof = None
        self._t0 = self._it0 = None
        self.window_s = self.export_s = 0.0
        self.iterations = 0

    def acts_at(self, it: int) -> bool:
        """Whether the call at iteration ``it`` starts or stops the window."""
        if self.done:
            return False
        return it >= self.stop_at if self.active else it >= self.start

    def __call__(self, state) -> None:
        it = state.num_iters_done
        if not self.done and not self.active and it >= self.start:
            try:
                self._prof = _profiler(self.log_dir)
                _sync()
                self._t0, self._it0 = time.perf_counter(), it
                self._prof.start()
                self.active = True
                logger.info("profiler trace started at iter %d", it)
            except Exception as e:  # a backend that cannot trace
                logger.warning("profiler trace unavailable: %s", e)
                self.done = True
        elif self.active and it >= self.stop_at:
            self.close(it)

    def close(self, it=None) -> None:
        """Stops an open window (``it``: the iteration it stops before, if
        known) and writes its trace."""
        if self.active:
            try:
                _sync()
                t1 = time.perf_counter()
                self.window_s = t1 - self._t0
                self.iterations = (it if it is not None else self.stop_at) - self._it0
                self._prof.stop()
                self.export_s = time.perf_counter() - t1
                logger.info("profiler trace written to %s", self.log_dir)
            except Exception as e:
                logger.warning("profiler stop failed: %s", e)
            self.active = False
            self._prof = None
        self.done = True


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block into ``log_dir`` (profiling.py:69-78)."""
    prof = None
    try:
        prof = _profiler(log_dir)
        prof.start()
    except Exception as e:
        logger.warning("profiler trace unavailable: %s", e)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                _sync()
                prof.stop()
                logger.info("profiler trace written to %s", log_dir)
            except Exception as e:
                logger.warning("profiler stop failed: %s", e)
