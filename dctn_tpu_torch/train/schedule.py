"""The piecewise eval schedule (a copy of ``dctn_tpu/train/schedule.py``,
reference ``dctn/training.py:90-113``).

``every_n_iters_intervals((10, 1), (100, 10), (None, 100))``: during the
first 10 iterations fire every iteration, during the next 100 every 10, and
after that every 100. A hook fires when num_iters_done % freq == 0, with
freq from the last interval whose start ≤ num_iters_done.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple


class EvalSchedule:
    def __init__(self, *intervals: Tuple[Optional[int], int]):
        intervals = list(intervals)
        if not intervals:
            raise ValueError("need at least one interval")
        if intervals[-1][0] is not None:
            intervals.append((None, 1))
        starts = [0]
        for length, _ in intervals[:-1]:
            starts.append(starts[-1] + length)
        self._starts = starts
        self._intervals = intervals

    def freq_at(self, num_iters_done: int) -> int:
        freq = self._intervals[0][1]
        for start, (_, f) in zip(self._starts, self._intervals):
            if num_iters_done >= start:
                freq = f
        return freq

    def should_fire(self, num_iters_done: int) -> bool:
        return num_iters_done % self.freq_at(num_iters_done) == 0

    def __call__(self, func: Callable) -> Callable:
        """Wrap a hook so that it runs only on schedule."""

        def wrapped(state):
            if self.should_fire(state.num_iters_done):
                func(state)

        wrapped.__name__ = getattr(func, "__name__", repr(func))
        return wrapped


def every_n_iters_intervals(*intervals) -> EvalSchedule:
    return EvalSchedule(*intervals)
