"""Evaluation: the mean cross-entropy and the accuracy over a whole split
(port of ``dctn_tpu/train/evaluation.py``; reference
``dctn/evaluation.py:7-22``: the CE summed and divided by the sample count).

The split stays on its device and is scored in fixed-size batches of
clamped sample ids with a validity mask, as the JAX package scans it: every
forward has the same batch size, and only two scalars leave the device,
when the caller reads them. A data-parallel run scores its sharded splits
with ``score_sharded``: each rank its shard, then one all-reduce.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F

from ..models.eps_plus_linear import EPSesPlusLinearConfig, eps_plus_linear_forward_fast


def padded_batch_ids(n_local: int, batch_size: int, device="cpu"):
    """Clamped sample ids and the in-range mask for ``n_local`` samples in
    batches of ``batch_size``: both (num_batches, batch_size)."""
    num_batches = -(-n_local // batch_size)
    ids = torch.arange(num_batches * batch_size, device=device)
    in_range = (ids < n_local).reshape(num_batches, batch_size)
    clamped = torch.clamp(ids, max=n_local - 1).reshape(num_batches, batch_size)
    return clamped, in_range


def masked_ce_acc_scan(forward_fn, x, y, ids, valid, sample_axis: int = 1):
    """Σ masked CE and the count of correct predictions over the padded
    batches (``masked_ce_acc_scan``, evaluation.py:33-59): ``forward_fn(xb)
    → logits``; ``ids`` and ``valid`` (num_batches, batch_size);
    ``sample_axis`` the dim of ``x`` that indexes samples (1 for (C, N, H,
    W, Q) splits). Returns 0-d tensors on the device: the CE sum in
    float32, the count in int64."""
    ce_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    correct = torch.zeros((), dtype=torch.int64, device=x.device)
    for idx, mask in zip(ids, valid):
        xb = x.index_select(sample_axis, idx)
        yb = y.index_select(0, idx)
        logits = forward_fn(xb)
        ce = F.cross_entropy(logits, yb, reduction="none")
        ce_sum = ce_sum + torch.sum(ce * mask).to(torch.float32)
        correct = correct + torch.sum((logits.argmax(1) == yb) & mask)
    return ce_sum, correct


def make_score_fn(
    cfg: EPSesPlusLinearConfig, plans, batch_size: int, forward_fn=None
) -> Callable[[dict, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``score(params, x, y) → (mean_ce, accuracy)``, 0-d tensors
    on the split's device, computed without gradients. ``x`` (C, N, H, W,
    Q), ``y`` (N,). ``forward_fn(params, xb) → logits`` replaces the f32
    fast forward (``eps_plus_linear_forward_fast`` through the kernels on a
    card, their plain versions on the CPU); the QAT runner passes the int8
    one."""
    if forward_fn is None:
        def forward_fn(params, xb):
            return eps_plus_linear_forward_fast(params, xb, cfg, plans)

    def score(params, x, y):
        n = y.shape[0]
        ids, valid = padded_batch_ids(n, batch_size, x.device)
        with torch.no_grad():
            ce_sum, correct = masked_ce_acc_scan(lambda xb: forward_fn(params, xb), x, y, ids, valid)
        return ce_sum / n, correct.to(torch.float32) / n

    return score


def score_sharded(forward_fn, split, batch_size: int):
    """(mean CE, accuracy) over a ``parallel.ShardedSplit``, the same 0-d
    tensors on every rank (the per-device scan and psum of
    ``make_parallel_score_fn``, data_parallel.py:469-518): each rank scans
    its shard in padded batches of ``batch_size``, samples past
    ``n_valid`` masked by their global position, and one all-reduce sums
    (CE sum, correct) over the data axis's ranks, in float64 (on a grid the
    ranks of a model or space group hold the same shard, and
    ``forward_fn`` runs their collectives). ``forward_fn(xb) → logits``;
    every rank must call."""
    mesh = split.mesh
    base = mesh.data_index * split.n_local
    ids, in_range = padded_batch_ids(split.n_local, batch_size, split.x.device)
    valid = in_range & (base + ids < split.n_valid)
    with torch.no_grad():
        ce_sum, correct = masked_ce_acc_scan(forward_fn, split.x, split.y, ids, valid,
                                             sample_axis=split.sample_axis)
    sums = mesh.reduce_data_(torch.stack([ce_sum.to(torch.float64), correct.to(torch.float64)]))
    n = split.n_valid
    return (sums[0] / n).to(torch.float32), (sums[1] / n).to(torch.float32)
