"""A pool of ranks for the port's multi-rank CPU tests: the ranks start
once (``dctn_tpu_torch.parallel.mesh.spawn``) and run a sequence of short
jobs, so that a test module pays for the ranks' start once."""

from __future__ import annotations

import time
import traceback
from typing import Any, Callable

from dctn_tpu_torch.parallel.mesh import DataMesh, Job, spawn


def _pool_loop(mesh: DataMesh, inboxes, outbox) -> None:
    """A pooled rank: runs each job ``(fn, args)`` from its inbox and posts
    (rank, result, traceback) to the outbox, until it takes None."""
    while True:
        item = inboxes[mesh.local_rank].get()
        if item is None:
            return
        fn, args = item
        try:
            outbox.put((mesh.rank, fn(mesh, *args), None))
        except Exception:
            outbox.put((mesh.rank, None, traceback.format_exc()))


class RankPool:
    """Ranks that stay up between jobs, so that a sequence of short jobs
    pays for the ranks' start once: ``run(fn, *args)`` runs ``fn(mesh,
    *args)`` on every rank of a one-host ``job`` and returns rank 0's
    result. ``close()`` stops the ranks."""

    def __init__(self, job: Job):
        import multiprocessing
        import threading

        if job.host.nodes != 1 or job.host.torchrun:
            raise ValueError("a RankPool runs the ranks of one host")
        ctx = multiprocessing.get_context("spawn")
        self.job = job
        self._inboxes = [ctx.Queue() for _ in range(job.local_ranks)]
        self._outbox = ctx.Queue()
        self._error: list = []

        def serve():
            try:
                spawn(_pool_loop, job, self._inboxes, self._outbox)
            except BaseException as e:  # reported by the next run()
                self._error.append(e)

        self._thread = threading.Thread(target=serve, daemon=True)
        self._thread.start()

    def run(self, fn: Callable, *args, timeout: float = 300.0) -> Any:
        import queue

        for box in self._inboxes:
            box.put((fn, args))
        results, errors = {}, {}
        deadline = time.monotonic() + timeout
        while len(results) + len(errors) < self.job.local_ranks:
            if self._error:
                raise RuntimeError("the rank pool stopped") from self._error[0]
            try:
                rank, value, err = self._outbox.get(
                    timeout=min(1.0, max(0.01, deadline - time.monotonic())))
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{fn.__name__} did not finish on every rank in {timeout} s")
                continue
            if err is not None:
                errors[rank] = err
            else:
                results[rank] = value
        if errors:  # every rank has answered: the pool is ready for the next job
            rank = min(errors)
            raise RuntimeError(f"{fn.__name__} failed on rank {rank}:\n{errors[rank]}")
        return results[0]

    def close(self, timeout: float = 30.0) -> None:
        for box in self._inboxes:
            box.put(None)
        self._thread.join(timeout)
