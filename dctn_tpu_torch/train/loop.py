"""The training loop: an event loop around the training step (port of
``dctn_tpu/train/loop.py``; reference ``dctn/training.py``): epochs
without end, at-iteration-start and after-step hooks, the last-N and
best-per-metric checkpointers with metric-stamped file names, early
stopping on several metrics, the max-iterations stopper, and the NaN-loss
stopper that replays from its last clean observation to dump the batch
that made the loss non-finite.

The loop reads nothing from the device in the steady state: the step's
metrics stay there, and a flag that some loss was not finite is kept on the
device across steps (one ``isfinite`` and one ``or`` per step, no transfer).
Hooks on the eval schedule read the flag and the metrics; between them the
host only launches work, so the card is never held up waiting for it.
Checkpoints are written by ``AsyncWriter``'s threads.

Under data parallelism every rank runs this loop in lock step: the index
stream yields the (W, b) array of every rank's local rows, ``gather_fn``
takes the rank's own, and the step holds the one all-reduce. The hooks that
decide (the evals, whose sums are all-reduced, the stoppers on the ranks'
mean loss, the preemption agreement) run on every rank, so that all ranks
stop at the same iteration; the hooks that only write run on the ranks that
write (``cli/runner.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from collections import deque
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .checkpoint import AsyncWriter, _to_numpy, flatten_tree

logger = logging.getLogger(__name__)

Hook = Callable[["TrainLoopState"], None]


@dataclasses.dataclass
class TrainLoopState:
    """The state the loop and its hooks share. ``params`` is the model's
    fast-layout parameter tree (the live tensors: the step updates them in
    place), ``opt_state`` the optimizer, ``rng`` the dropout generator (None
    without dropout)."""

    params: Any
    opt_state: Any
    rng: Optional[torch.Generator]
    num_iters_done: int = 0
    stop: bool = False
    stop_reason: Optional[str] = None
    iter_metrics: Dict[str, float] = dataclasses.field(default_factory=dict)
    batch_indices: Any = None
    last_batch: Optional[Tuple[Any, Any]] = None  # (xb, yb) on the device
    device_metrics: Any = None  # the last step's metrics, on the device
    nan_flag: Any = None  # a bool tensor on the device, or'ed across steps
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


def train(
    state: TrainLoopState,
    step_fn: Callable,
    gather_fn: Callable,
    index_stream,
    at_iter_start: Sequence[Hook] = (),
    after_step: Sequence[Hook] = (),
) -> TrainLoopState:
    """Runs until a hook sets ``state.stop``. ``step_fn(xb, yb, generator) →
    metrics`` (with a ``"loss"``), ``gather_fn(idx) → (xb, yb)``;
    ``index_stream`` yields each iteration's batch indices (on the device,
    so that no copy waits for the card)."""
    nan_accum = None
    for num_iters_done, idx in enumerate(index_stream, start=state.num_iters_done):
        state.num_iters_done = num_iters_done
        state.iter_metrics = {}
        state.batch_indices = idx
        hist = state.extras.get("nan_replay_idx_history")
        if hist is not None:  # the NaN stopper's replay is on
            hist.append(idx)
        for hook in at_iter_start:
            hook(state)
            if state.stop:
                break
        if state.stop:
            break
        xb, yb = gather_fn(idx)
        state.last_batch = (xb, yb)
        metrics = step_fn(xb, yb, state.rng)
        bad = ~torch.isfinite(metrics["loss"])
        nan_accum = bad if nan_accum is None else nan_accum | bad
        state.device_metrics = metrics
        state.nan_flag = nan_accum
        for hook in after_step:
            hook(state)
            if state.stop:
                break
        if state.stop:
            break
    return state


# ---------------------------------------------------------------------------
# checkpointers (training.py:116-174)


def _metrics_filename(prefix: str, state: TrainLoopState) -> str:
    m = state.iter_metrics
    nitd = state.num_iters_done
    tracc = m.get("train_acc", float("nan"))
    vacc = m.get("val_acc", float("nan"))
    trmce = m.get("train_mean_ce", float("nan"))
    vmce = m.get("val_mean_ce", float("nan"))
    return (
        f"{prefix}_nitd={nitd:07}_tracc={tracc:.4f}_vacc={vacc:.4f}"
        f"_trmce={trmce:.4f}_vmce={vmce:.4f}.npz"
    )


class LastModelsCheckpointer:
    """The N most recent model checkpoints (training.py:127-145), in the
    layout ``params_view`` gives (the runner's: the reference layout)."""

    def __init__(self, dir: str, n: int, writer: Optional[AsyncWriter] = None,
                 params_view: Optional[Callable] = None):
        if n < 1:
            raise ValueError(f"keep at least one model, not {n}")
        self.dir = dir
        self.n = n
        self.filenames: deque = deque()
        self.writer = writer or AsyncWriter()
        self.params_view = params_view

    def __call__(self, state: TrainLoopState) -> None:
        filename = _metrics_filename("model", state)
        payload = self.params_view(state.params) if self.params_view else state.params
        self.writer.submit(payload, os.path.join(self.dir, filename))
        self.filenames.appendleft(filename)
        while len(self.filenames) > self.n:
            old = self.filenames.pop()
            self.writer.wait()
            path = os.path.join(self.dir, old)
            if os.path.exists(path):
                os.remove(path)


class BestModelCheckpointer:
    """The one best checkpoint by one metric (training.py:148-174)."""

    def __init__(self, dir: str, key: str, low_is_good: bool,
                 writer: Optional[AsyncWriter] = None, params_view: Optional[Callable] = None):
        self.dir = dir
        self.key = key
        self.low_is_good = low_is_good
        self.best_value = float("inf") if low_is_good else float("-inf")
        self.filename: Optional[str] = None
        self.writer = writer or AsyncWriter()
        self.params_view = params_view

    def __call__(self, state: TrainLoopState) -> None:
        if self.key not in state.iter_metrics:
            return
        value = state.iter_metrics[self.key]
        better = value < self.best_value if self.low_is_good else value > self.best_value
        if better:
            new_filename = _metrics_filename(f"model_best_{self.key}", state)
            payload = self.params_view(state.params) if self.params_view else state.params
            self.writer.submit(payload, os.path.join(self.dir, new_filename))
            self.best_value = value
            if self.filename is not None:
                self.writer.wait()
                old = os.path.join(self.dir, self.filename)
                if os.path.exists(old):
                    os.remove(old)
            self.filename = new_filename


# ---------------------------------------------------------------------------
# stoppers (training.py:177-237)


class ValuesNotImprovingEarlyStopper:
    """Stops when none of the tracked metrics improved for ``patience``
    calls in a row."""

    def __init__(self, patience: int, keys: Sequence[Tuple[str, bool]]):
        self.keys = tuple(keys)
        self.best_values = [float("inf") if low else float("-inf") for _, low in keys]
        self.num_bad_calls = 0
        self.patience = patience

    def __call__(self, state: TrainLoopState) -> None:
        improvement = False
        for i, (key, low_is_good) in enumerate(self.keys):
            if key not in state.iter_metrics:
                continue
            value = state.iter_metrics[key]
            best = self.best_values[i]
            if (low_is_good and value < best) or (not low_is_good and value > best):
                self.best_values[i] = value
                improvement = True
        self.num_bad_calls = 0 if improvement else self.num_bad_calls + 1
        if self.num_bad_calls > self.patience:
            state.stop = True
            state.stop_reason = "early_stopping"
            logger.info("Early stopping at num_iters_done=%d", state.num_iters_done)


def make_stopper_after_n_iters(n: int) -> Hook:
    def maybe_stop(state: TrainLoopState) -> None:
        if state.num_iters_done >= n:
            state.stop = True
            state.stop_reason = "max_iters"

    return maybe_stop


def _clone_tree(tree):
    """Copies of the tensors of a tree of dicts, tuples and lists."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _leaves(params):
    return list(flatten_tree(params).values())


def make_stopper_on_nan_loss(
    dir: str,
    forward_fn: Optional[Callable[[Any, Any], Any]] = None,
    params_view: Optional[Callable] = None,
    replay_step: Optional[Callable] = None,
    replay_gather: Optional[Callable] = None,
    interactive: bool = False,
    write_files: bool = True,
    views_on_every_rank: bool = False,
) -> "NanLossStopper":
    """The NaN-loss stopper (training.py:213-237). It reads the loop's NaN
    flag when it runs (put it on the eval schedule, so the flag costs no
    transfer per step). When it fires it dumps, to ``nan_loss_stop/``, the
    parameters (``params_view``'s layout), the batch's indices and contents
    and, with ``forward_fn(params, xb) → output``, the model's output.

    With ``replay_step`` and ``replay_gather`` (the loop's step and gather)
    it dumps the batch that made the loss non-finite, with the parameters
    before its update, as the reference's check after every iteration
    would: at every clean observation it keeps a copy of the parameters,
    the optimizer's state and the generator's (the anchor) and clears the
    loop's index history; when the flag is up it restores the anchor and
    steps again through the recorded batches, reading the loss after each,
    until one is not finite. Call ``enable_replay(state)`` once before
    ``train`` so that the first anchor covers the steps before the first
    observation. Without replay, or when the replay does not reproduce the
    NaN, it dumps the observation step's batch and its updated parameters,
    and its README says so.

    Data-parallel ranks all run the stopper: the flag comes from the
    ranks' mean loss, so they stop together, and the replay's steps hold
    the all-reduce, so every rank replays (to the same iteration); only the
    rank with ``write_files`` writes the dump. With ``views_on_every_rank``
    (tensor and spatial parallelism, whose ``params_view`` and
    ``forward_fn`` hold collectives) every rank computes the dump's
    parameters and output, and the writing rank writes them."""
    return NanLossStopper(dir, forward_fn, params_view, replay_step, replay_gather, interactive,
                          write_files, views_on_every_rank)


class NanLossStopper:
    """See ``make_stopper_on_nan_loss``. ``interactive=True`` (the runner's
    ``--breakpoint-on-nan-loss``) calls ``breakpoint()`` after the dump,
    with ``params_host``, ``batch_host``, ``out_host`` and ``iter_no`` in
    scope."""

    def __init__(self, dir, forward_fn, params_view, replay_step, replay_gather,
                 interactive=False, write_files=True, views_on_every_rank=False):
        self.write_files = write_files
        self.views_on_every_rank = views_on_every_rank
        self.dir = dir
        self.forward_fn = forward_fn
        self.params_view = params_view
        self.replay_step = replay_step
        self.replay_gather = replay_gather
        self.interactive = interactive
        self._anchor = None  # (params, optimizer state, generator state, next iteration)

    @property
    def replay_enabled(self):
        return self.replay_step is not None and self.replay_gather is not None

    def enable_replay(self, state: TrainLoopState) -> None:
        """Installs the index history and the first anchor (the state before
        the loop's next iteration)."""
        if not self.replay_enabled:
            raise ValueError("replay needs replay_step and replay_gather")
        state.extras["nan_replay_idx_history"] = []
        self._reanchor(state, next_iter=state.num_iters_done)

    def _reanchor(self, state: TrainLoopState, next_iter=None) -> None:
        if next_iter is None:  # after iteration N's step: the anchor is N + 1's input
            next_iter = state.num_iters_done + 1
        opt = state.opt_state
        self._anchor = (
            _clone_tree(state.params),
            _clone_tree(opt.state_dict()) if opt is not None else None,
            state.rng.get_state() if state.rng is not None else None,
            next_iter,
        )
        hist = state.extras.get("nan_replay_idx_history")
        if hist is not None:
            hist.clear()

    def _replay(self, state: TrainLoopState):
        """Restores the anchor into the live parameters, optimizer and
        generator, then steps through the recorded batches reading each
        loss. Returns (iteration, idx, xb, yb, parameters before its step)
        of the first non-finite loss, or None."""
        params0, opt0, gen0, it0 = self._anchor
        with torch.no_grad():
            for live, saved in zip(_leaves(state.params), _leaves(params0)):
                live.copy_(saved)
        if opt0 is not None:
            state.opt_state.load_state_dict(_clone_tree(opt0))
        if gen0 is not None:
            state.rng.set_state(gen0)
        for i, idx in enumerate(list(state.extras.get("nan_replay_idx_history") or ())):
            xb, yb = self.replay_gather(idx)
            before = _clone_tree(state.params)
            metrics = self.replay_step(xb, yb, state.rng)
            if not np.isfinite(float(metrics["loss"])):
                return it0 + i, idx, xb, yb, before
        return None

    def __call__(self, state: TrainLoopState) -> None:
        if state.nan_flag is None:
            return
        if not bool(state.nan_flag):
            if self.replay_enabled and self._anchor is not None:
                self._reanchor(state)
            return
        logger.warning("Stopping because of NaN or Inf loss")
        state.stop = True
        state.stop_reason = "nan_loss"
        triggering = (
            self._replay(state) if self.replay_enabled and self._anchor is not None else None
        )
        if triggering is not None:
            iter_no, idx, xb, yb, dump_params = triggering
            logger.warning("NaN replay isolated the triggering iteration: %d", iter_no)
            readme = (
                f"NaN/Inf flag observed at step {state.num_iters_done}; replaying from the "
                "last clean observation isolated the TRIGGERING iteration: "
                f"{iter_no}. The saved batch/output and params are from THAT iteration "
                "(params as they were BEFORE its update — the reference's per-iteration "
                "dump semantics, training.py:213-237).\n"
            )
        else:
            if self.replay_enabled and self._anchor is not None:
                logger.warning(
                    "NaN replay did not reproduce the non-finite loss; dumping the "
                    "observation-step state instead"
                )
            iter_no, idx = state.num_iters_done, state.batch_indices
            xb, yb = state.last_batch or (None, None)
            dump_params = state.params
            readme = (
                "NaN/Inf was detected by the device-accumulated flag at observation step "
                f"{state.num_iters_done}. The saved batch/output are from THIS step "
                "(post-update params), not necessarily the iteration that produced the "
                "NaN — that happened at or before this step, since the previous scheduled "
                "observation.\n"
            )
        if not (self.write_files or self.views_on_every_rank):
            return
        subdir = os.path.join(self.dir, "nan_loss_stop")
        if self.write_files and os.path.exists(subdir):
            logger.error("%s already exists; the dump is skipped", subdir)
            if not self.views_on_every_rank:
                return
        params_host = {
            k: _to_numpy(v) for k, v in flatten_tree(
                self.params_view(dump_params) if self.params_view else dump_params
            ).items()
        }
        batch_host = out_host = None
        if xb is not None and yb is not None:
            batch_host = (_to_numpy(xb), _to_numpy(yb))
            if self.forward_fn is not None:
                with torch.no_grad():
                    out_host = _to_numpy(self.forward_fn(dump_params, xb))
        if not self.write_files or os.path.exists(subdir):
            return
        if self.interactive:
            breakpoint()  # noqa: T100
        os.mkdir(subdir)
        with open(os.path.join(subdir, "README.txt"), "w") as f:
            f.write(readme)
        np.savez(os.path.join(subdir, f"model_nitd={iter_no}.npz"), **params_host)
        if idx is not None:
            np.save(os.path.join(subdir, "batch_indices.npy"), _to_numpy(idx))
        if batch_host is not None:
            np.savez(os.path.join(subdir, "batch.npz"), x=batch_host[0], y=batch_host[1])
            if out_host is not None:
                np.save(os.path.join(subdir, "output.npy"), out_host)


def log_parameters_stats(state: TrainLoopState) -> None:
    """μ, σ and shape of every parameter (training.py:240-248), by the
    path ``save_pytree`` gives it."""
    logger.info("After %07d iters:", state.num_iters_done)
    for name, leaf in flatten_tree(state.params).items():
        arr = _to_numpy(leaf)
        logger.info("%s: μ=%.7e, σ=%.7e, shape=%s", name, arr.mean(), arr.std(), arr.shape)
