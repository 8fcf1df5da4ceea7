"""The collectives of tensor and spatial parallelism as
``torch.autograd.Function``s, each with its true transpose (port of
``_psum_value_only``, ``_gather_model``, tensor_parallel.py:150-179, and
``_halo_pull`` / ``_with_halo``, spatial_parallel.py:130-166), and the
grid's gradient reduction (``GridGradReduce``).

JAX differentiates inside ``shard_map`` with ``check_vma=False`` and writes
every cross-device edge's backward by hand; here each rank runs autograd on
its own graph, and these Functions are those edges:

- ``psum_value_only``: the sum over a group in the forward, the identity in
  the backward: each rank keeps its own partial derivative, and the step's
  reduction sums the leaves that need it;
- ``gather_along``: an ``all_gather`` along a dim in the forward, its
  transpose in the backward: a ``reduce_scatter`` (``nccl``), or on
  ``gloo``, which has no reduce-scatter, an all-reduce and this rank's
  slice (the same sum);
- ``with_halo``: the first K−1 rows of the next rank of the space group
  below this rank's block (``dist.batch_isend_irecv`` on the space group,
  JAX's ``ppermute``); the last rank receives zeros, the bottom padding. Its
  backward sends the cotangent of the received rows back to the rank that
  owns them; rank 0's incoming cotangent is zero (nobody sent to it).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


class _PsumValueOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        s = x.detach().clone()
        dist.all_reduce(s, group=group)
        return s

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum_value_only(x: torch.Tensor, mesh) -> torch.Tensor:
    """Σ of ``x`` over this rank's model or space group in the value; the
    identity in the backward (``_psum_value_only``)."""
    if mesh.n_other == 1:
        return x
    return _PsumValueOnly.apply(x, mesh.other_group)


def _gather_cat(x: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh):
        ctx.dim, ctx.mesh = dim, mesh
        return _gather_cat(x, dim, mesh.n_other, mesh.other_group)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, n = ctx.mesh, ctx.dim, ctx.mesh.n_other
        if mesh.backend == "nccl":
            front = g.movedim(dim, 0).contiguous()
            out = torch.empty((front.shape[0] // n,) + tuple(front.shape[1:]),
                              dtype=g.dtype, device=g.device)
            dist.reduce_scatter_tensor(out, front, group=mesh.other_group)
            return out.movedim(0, dim), None, None
        total = g.contiguous().clone()
        dist.all_reduce(total, group=mesh.other_group)
        size = total.shape[dim] // n
        return total.narrow(dim, mesh.other_index * size, size).contiguous(), None, None


def gather_along(x: torch.Tensor, dim: int, mesh) -> torch.Tensor:
    """The model group's ``x`` concatenated along ``dim`` in model order;
    the backward sums every rank's cotangent and gives each its slice
    (``_gather_model``)."""
    if mesh.n_other == 1:
        return x
    return _GatherAlong.apply(x, dim, mesh)


def _exchange(t: torch.Tensor, send_to, recv_from, group) -> torch.Tensor:
    """Sends ``t`` to global rank ``send_to`` and receives a tensor of its
    shape from ``recv_from`` (either may be None) in one batch on ``group``;
    zeros where nothing is received."""
    t = t.contiguous()
    out = torch.zeros_like(t)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, t, send_to, group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, out, recv_from, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _HaloPull(torch.autograd.Function):
    @staticmethod
    def forward(ctx, head, mesh):
        ctx.mesh = mesh
        j, n = mesh.other_index, mesh.n_other
        return _exchange(head, mesh.other_rank(j - 1) if j > 0 else None,
                         mesh.other_rank(j + 1) if j < n - 1 else None, mesh.other_group)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        j, n = mesh.other_index, mesh.n_other
        return _exchange(g, mesh.other_rank(j + 1) if j < n - 1 else None,
                         mesh.other_rank(j - 1) if j > 0 else None, mesh.other_group), None


def with_halo(x: torch.Tensor, kernel_size: int, mesh, row_axis: int) -> torch.Tensor:
    """``x`` with the next space rank's first K−1 rows concatenated below
    its block along ``row_axis`` (zeros on the last rank): the slab of
    Hl+K−1 rows a K×K layer turns into Hl rows (``_with_halo``). A space
    axis of one rank holds the whole image: no halo, the layer shrinks it
    as on one device."""
    if kernel_size == 1 or mesh.n_other == 1:
        return x
    halo = _HaloPull.apply(x.narrow(row_axis, 0, kernel_size - 1), mesh)
    return torch.cat([x, halo], dim=row_axis)


def grad_scaled(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``x``'s value with ``scale`` times its gradient: a regularizer of
    replicated parameters whose gradient the step then sums over a group of
    ``1/scale`` ranks (the JAX steps' ``reg / n``, its value kept whole for
    the metrics)."""
    if scale == 1:
        return x
    return x.detach() + (x * scale - (x * scale).detach())


class GridGradReduce:
    """A grid step's reduction of its gradients (the per-leaf rules of
    tensor_parallel.py:318-339 and spatial_parallel.py:272-284): the
    gradients of ``summed`` (parameters whose every rank of a model or
    space group holds only its part: replicated cores under TP, every core
    and the classifier's weight under SP) summed over that group in one
    all-reduce of one flattened buffer; then every gradient, with the
    cross-entropy beside them, averaged over the data group in one more.
    The bias enters after the logits' sum: its gradient is whole on every
    rank, as is that of a sharded leaf (its own slice). The regularizer is
    added before this reduction (``reg_inside``), in the local form whose
    reduction is its gradient once."""

    reg_inside = True

    def __init__(self, mesh, summed: Sequence[torch.Tensor]):
        self.mesh = mesh
        self.summed = {id(p) for p in summed}

    def mean(self, params: Sequence[torch.Tensor], ce: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        with_grad = [p for p in params if p.grad is not None]
        other = [p.grad for p in with_grad if id(p) in self.summed]
        if mesh.n_other > 1 and other:
            buf = torch.cat([g.reshape(-1) for g in other])
            mesh.reduce_other_(buf)
            _unflatten(buf, other)
        ce = ce.detach().reshape(1).to(with_grad[0].dtype)
        if mesh.n_data == 1:
            return ce[0]
        grads = [p.grad for p in with_grad]
        buf = torch.cat([g.reshape(-1) for g in grads] + [ce])
        mesh.reduce_data_(buf).div_(mesh.n_data)
        _unflatten(buf, grads)
        return buf[-1].clone()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.gather_data(t)


def _unflatten(buf: torch.Tensor, grads) -> None:
    offset = 0
    for g in grads:
        g.copy_(buf[offset : offset + g.numel()].view_as(g))
        offset += g.numel()
