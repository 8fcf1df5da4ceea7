"""Data parallelism over the ranks of a ``DataMesh`` (port of
``dctn_tpu/parallel/data_parallel.py``).

As in JAX:

- the DATASET is sharded along its sample axis: N is padded to a multiple
  of the rank count with copies of the first sample, and rank d holds
  samples [d·n_local, (d+1)·n_local) on its own device
  (``shard_split``, ``shard_pixel_split``). Each step's batch indices are
  drawn per shard on the host (``make_local_index_stream``, the JAX
  draws exactly, so index rows compare one to one), and each rank gathers
  its sub-batch from its own shard;
- PARAMETERS and the optimizer state are replicated (``replicate``
  broadcasts rank 0's). Each rank runs the single-device step's forward,
  cross-entropy, backward and gradient accumulation on its sub-batch; then
  ONE all-reduce of all the gradients flattened into a single buffer, with
  the cross-entropy beside them, divided by the rank count, takes the
  place of JAX's ``pmean`` (data_parallel.py:167); then the regularizer
  (identical on every rank), the frozen-core mask and the same optimizer
  update on every rank. Dropout masks parameters, so every rank draws the
  same masks from a generator seeded identically (the replicated key of
  JAX);
- evaluation scores each shard in padded fixed-size batches and sums
  (CE sum, correct) over the ranks in one all-reduce, the padding masked
  by its global position against ``n_valid``.

With per-rank batch b the global batch is W·b; the step equals the
single-device step on the concatenated batch up to the summation order of
the mean (``tests/test_torch_port_parallel.py``). The f32 fast step plans
each rank's saved-t arm on its own pixels; the QAT step decides it on the
global pixel count (``pixel_scale``, eps_pallas_q8.py:383-416), so its STE
gradient is the single-device one. The model's ``cfg.compute_dtype`` rides
along: the steps and the sharded evals run every EPS layer in its operands
(bf16: the kernels' bf16 mode), as one device does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..train.evaluation import padded_batch_ids, score_sharded
from ..train.step import make_fast_train_step, make_train_step
from .mesh import DataMesh

# ---------------------------------------------------------------------------
# dataset sharding


@dataclasses.dataclass
class ShardedSplit:
    """This rank's shard of a split: ``x`` (C, n_local, H, W, Q), or
    (n_local, H, W) for pixel splits (``sample_axis`` 0), and ``y``
    (n_local,) on the rank's device. ``n_valid`` is the true sample count
    before padding to a multiple of the rank count."""

    x: torch.Tensor
    y: torch.Tensor
    n_valid: int
    n_local: int
    mesh: DataMesh
    sample_axis: int = 1

    @property
    def valid_per_shard(self) -> list:
        return valid_per_shard(self.n_valid, self.n_local, self.mesh.data_size)


def valid_per_shard(n_valid: int, n_local: int, world_size: int) -> list:
    """Each shard's count of true samples: shard d holds positions
    [d·n_local, (d+1)·n_local), those at or past ``n_valid`` padding."""
    return [max(0, min(n_valid - d * n_local, n_local)) for d in range(world_size)]


def _pad_to_ranks(x: np.ndarray, y: np.ndarray, ndev: int, axis: int):
    n = y.shape[0]
    n_pad = (-n) % ndev
    if n_pad:
        first = np.take(x, [0], axis=axis)
        x = np.concatenate([x, np.repeat(first, n_pad, axis=axis)], axis=axis)
        y = np.concatenate([y, np.repeat(y[:1], n_pad, axis=0)], axis=0)
    return x, y


def _shard(mesh: DataMesh, x: np.ndarray, y: np.ndarray, axis: int) -> ShardedSplit:
    n = y.shape[0]
    x, y = _pad_to_ranks(np.asarray(x), np.asarray(y), mesh.data_size, axis)
    n_local = y.shape[0] // mesh.data_size
    lo, hi = mesh.data_index * n_local, (mesh.data_index + 1) * n_local
    xs = np.take(x, np.arange(lo, hi), axis=axis)
    return ShardedSplit(
        torch.as_tensor(np.ascontiguousarray(xs), device=mesh.device),
        torch.as_tensor(y[lo:hi].astype(np.int64), device=mesh.device),
        n_valid=n, n_local=n_local, mesh=mesh, sample_axis=axis,
    )


def shard_split(mesh: DataMesh, x: np.ndarray, y: np.ndarray) -> ShardedSplit:
    """Pad N to a multiple of the data axis's size (data_parallel.py:67-90)
    and keep this rank's shard of a (C, N, H, W, Q) split on its device:
    the shard of its data coordinate, so that every rank of a model or
    space group holds the same samples."""
    return _shard(mesh, x, y, 1)


def shard_pixel_split(mesh: DataMesh, x: np.ndarray, y: np.ndarray) -> ShardedSplit:
    """The same for (N, H, W) pixel splits (data_parallel.py:327-338)."""
    return _shard(mesh, x, y, 0)


@torch.no_grad()
def replicate(mesh: DataMesh, tensors):
    """Rank 0's values of ``tensors`` (an iterable of tensors on the rank's
    device, parameters included) on every rank, in place; returns them."""
    tensors = list(tensors)
    for t in tensors:
        # a grid smaller than the world broadcasts over its own ranks
        dist.broadcast(t.data, src=0, group=getattr(mesh, "grid_group", None))
    return tensors


class LocalIndexStream:
    """Infinite stream of (W, per_device_batch) local index arrays
    (``make_local_index_stream``, data_parallel.py:286-323, the same draws):
    each rank's row an independent within-shard shuffle, epoch-wise and
    drop-last, from ``np.random.default_rng(seed·1000003 + d)``; padding
    rows (beyond ``n_valid``) are never drawn. Every rank iterates the
    whole array and takes its own row. ``orders`` and ``cursors`` are each
    shard's epoch order and its next position in it, after the latest
    draw."""

    def __init__(self, world_size: int, n_local: int, n_valid: int, per_device_batch: int,
                 seed: int = 0):
        self.ndev = world_size
        self.b = per_device_batch
        self.valid_per_shard = valid_per_shard(n_valid, n_local, world_size)
        self.rngs = [np.random.default_rng(seed * 1000003 + d) for d in range(world_size)]
        self.orders = [self.rngs[d].permutation(v) for d, v in enumerate(self.valid_per_shard)]
        self.cursors = [0] * world_size

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        out = np.empty((self.ndev, self.b), np.int32)
        for d in range(self.ndev):
            if self.cursors[d] + self.b > len(self.orders[d]):
                self.orders[d] = self.rngs[d].permutation(self.valid_per_shard[d])
                self.cursors[d] = 0
            out[d] = self.orders[d][self.cursors[d] : self.cursors[d] + self.b]
            self.cursors[d] += self.b
        return out


def make_local_index_stream(split: ShardedSplit, per_device_batch: int,
                            seed: int = 0) -> LocalIndexStream:
    """One row per data coordinate: the ranks of a model or space group
    take the same row, so they draw the same batch."""
    return LocalIndexStream(split.mesh.data_size, split.n_local, split.n_valid,
                            per_device_batch, seed)


# ---------------------------------------------------------------------------
# training steps


class GradAllReduce:
    """The step's one collective: every gradient of ``params`` (those that
    have one: the same on every rank) and the cross-entropy flattened into
    one buffer, summed over the ranks and divided by their count.
    ``gather`` concatenates each rank's per-sample tensor in rank order
    (``with_probs``)."""

    def __init__(self, mesh: DataMesh):
        self.mesh = mesh

    def mean(self, params: Sequence[torch.Tensor], ce: torch.Tensor) -> torch.Tensor:
        grads = [p.grad for p in params if p.grad is not None]
        ce = ce.detach().reshape(1).to(grads[0].dtype)
        buf = torch.cat([g.reshape(-1) for g in grads] + [ce])
        self.mesh.reduce_data_(buf).div_(self.mesh.data_size)
        offset = 0
        for g in grads:
            g.copy_(buf[offset : offset + g.numel()].view_as(g))
            offset += g.numel()
        return buf[offset].clone()  # not a view that would keep the buffer alive

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.gather_data(t)


def make_parallel_train_step(
    model, optimizer: torch.optim.Optimizer, mesh: DataMesh,
    reg_type: str = "epses_composition", reg_coeff: float = 0.0, *,
    frozen_eps_indices: Sequence[int] = (), with_probs: bool = False,
    grad_accum_steps: int = 1,
):
    """One rank's DP step over the reference layout (the xla backend;
    data_parallel.py:199-231): ``step(xb, yb, generator=None, masks=None)``
    on this rank's sub-batch → metrics whose ``loss`` and ``ce`` are the
    ranks' mean and whose ``reg_term`` is this rank's (identical on all);
    ``probs_of_true_class`` with ``with_probs`` is every rank's, in rank
    order."""
    return make_train_step(
        model, optimizer, reg_type, reg_coeff, frozen_eps_indices=frozen_eps_indices,
        with_probs=with_probs, grad_accum_steps=grad_accum_steps,
        collective=GradAllReduce(mesh),
    )


def make_parallel_fast_train_step(
    model, optimizer: torch.optim.Optimizer, mesh: DataMesh,
    reg_type: str = "epswise", reg_coeff: float = 0.0, *,
    frozen_eps_indices: Sequence[int] = (), with_probs: bool = False,
    grad_accum_steps: int = 1, qat: Optional[str] = None, kernels=None,
):
    """One rank's DP step over the fast (cmt) layout, the flagship path
    (data_parallel.py:234-283): ``make_fast_train_step`` on this rank's
    sub-batch, with dropout masks, frozen cores, accumulation before the
    collective and ``qat="int8"`` (its saved-t arm decided on the global
    pixel count), then the one all-reduce. Returns the step of
    ``make_parallel_train_step``."""
    return make_fast_train_step(
        model, optimizer, reg_type, reg_coeff, kernels=kernels,
        frozen_eps_indices=frozen_eps_indices, with_probs=with_probs,
        grad_accum_steps=grad_accum_steps, qat=qat, collective=GradAllReduce(mesh),
        pixel_scale=mesh.world_size if qat is not None else 1,
    )


def make_parallel_pixel_train_step(model, optimizer: torch.optim.Optimizer, mesh: DataMesh,
                                   forward_fn: Optional[Callable] = None):
    """One rank's DP step for pixel-batch models, the ConvSBS family
    (data_parallel.py:341-377): ``step(xb, yb) → the ranks' mean loss`` (a
    0-d tensor on the device) on this rank's (b, H, W) sub-batch: the
    cross-entropy's backward, the one all-reduce, the update.
    ``forward_fn(xb)`` is ``model(xb)`` by default."""
    forward_fn = forward_fn or model
    collective = GradAllReduce(mesh)

    def step(xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = F.cross_entropy(forward_fn(xb), yb)
        loss.backward()
        loss = collective.mean(list(model.parameters()), loss)
        optimizer.step()
        return loss

    return step


# ---------------------------------------------------------------------------
# evaluation and prediction


def make_parallel_score_fn(cfg, plans, mesh: DataMesh, batch_size: int, forward_fn=None):
    """``score(params, split) → (mean_ce, acc)`` over a ``ShardedSplit``
    (data_parallel.py:469-518), 0-d tensors on the rank's device, the same
    on every rank. ``forward_fn(params, xb) → logits`` is the fast forward
    by default; ``batch_size`` is each rank's. ``mesh`` is JAX's argument:
    the split carries its own."""
    from ..models.eps_plus_linear import eps_plus_linear_forward_fast

    if forward_fn is None:
        def forward_fn(params, xb):
            return eps_plus_linear_forward_fast(params, xb, cfg, plans)

    return make_parallel_pixel_score_fn(forward_fn, mesh, batch_size)


def make_parallel_pixel_score_fn(forward_fn, mesh: DataMesh, batch_size: int):
    """``score(params, split) → (mean_ce, acc)`` through ``forward_fn(params,
    xb) → logits``, the pixel-batch form (data_parallel.py:380-417); a pixel
    split and an EPS split are scored alike (``score_sharded``)."""

    def score_split(params, split: ShardedSplit):
        return score_sharded(lambda xb: forward_fn(params, xb), split, batch_size)

    return score_split


def make_parallel_predict_fn(cfg, plans, mesh: DataMesh, batch_size: int, forward_fn=None):
    """``predict(params, split) → int64 np.ndarray`` of argmax class ids over
    the split's ``n_valid`` samples (data_parallel.py:420-466): each rank
    predicts its shard in padded batches, and the ranks' ids are gathered
    in rank order."""
    from ..models.eps_plus_linear import eps_plus_linear_forward_fast

    if forward_fn is None:
        def forward_fn(params, xb):
            return eps_plus_linear_forward_fast(params, xb, cfg, plans)

    def predict_split(params, split: ShardedSplit) -> np.ndarray:
        ids, _ = padded_batch_ids(split.n_local, batch_size, split.x.device)
        preds = torch.empty(split.n_local, dtype=torch.int64, device=split.x.device)
        with torch.no_grad():
            for idx in ids:
                logits = forward_fn(params, split.x.index_select(split.sample_axis, idx))
                # clamped ids repeat the last sample: each write is its own id's
                preds[idx] = logits.argmax(1)
        return split.mesh.gather_data(preds).cpu().numpy()[: split.n_valid]

    return predict_split
