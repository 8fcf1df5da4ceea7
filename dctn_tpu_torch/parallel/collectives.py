"""The collectives of tensor and spatial parallelism and their composition
as ``torch.autograd.Function``s, each with its true transpose (port of
``_psum_value_only``, ``_gather_model``, tensor_parallel.py:150-179, and
``_halo_pull`` / ``_with_halo``, spatial_parallel.py:130-166), and the
grid's gradient reduction (``GridGradReduce``), each on the named axes of
the ``(data, space, model)`` grid (``mesh.GridMesh``).

JAX differentiates inside ``shard_map`` with ``check_vma=False`` and writes
every cross-device edge's backward by hand; here each rank runs autograd on
its own graph, and these Functions are those edges:

- ``psum_value_only``: the sum over the group of some axes in the forward,
  the identity in the backward: each rank keeps its own partial
  derivative, and the step's reduction sums the leaves that need it;
- ``gather_along``: an ``all_gather`` along a dim over the model line in
  the forward, its transpose in the backward: a ``reduce_scatter``
  (``nccl``), or on ``gloo``, which has no reduce-scatter, an all-reduce
  and this rank's slice (the same sum);
- ``with_halo``: the first K−1 rows of the next rank of the space line
  below this rank's block (``dist.batch_isend_irecv`` on the space line,
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


def psum_value_only(x: torch.Tensor, mesh, axes=("space", "model")) -> torch.Tensor:
    """Σ of ``x`` over this rank's group of ``axes`` in the value; the
    identity in the backward (``_psum_value_only``). The default sums over
    every axis beside data: a TP or SP grid's one, SP×TP's plane."""
    if not mesh.live(axes):
        return x
    return _PsumValueOnly.apply(x, mesh.group(axes))


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.dim, ctx.mesh, ctx.axis = dim, mesh, axis
        return mesh.gather_cat(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, axis = ctx.mesh, ctx.dim, ctx.axis
        n, group = mesh.size(axis), mesh.group(axis)
        if mesh.backend == "nccl":
            front = g.movedim(dim, 0).contiguous()
            out = torch.empty((front.shape[0] // n,) + tuple(front.shape[1:]),
                              dtype=g.dtype, device=g.device)
            dist.reduce_scatter_tensor(out, front, group=group)
            return out.movedim(0, dim), None, None, None
        total = g.contiguous().clone()
        dist.all_reduce(total, group=group)
        size = total.shape[dim] // n
        return total.narrow(dim, mesh.index(axis) * size, size).contiguous(), None, None, None


def gather_along(x: torch.Tensor, dim: int, mesh, axis: str = "model") -> torch.Tensor:
    """This rank's ``axis`` group's ``x`` concatenated along ``dim`` in
    coordinate order; the backward sums every rank's cotangent and gives
    each its slice (``_gather_model``)."""
    if mesh.size(axis) == 1:
        return x
    return _GatherAlong.apply(x, dim, mesh, axis)


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


def _space_neighbours(mesh) -> tuple:
    """The global ranks above and below this one on its space line (None
    past either end)."""
    j, n = mesh.index("space"), mesh.size("space")
    return (mesh.peer("space", j - 1) if j > 0 else None,
            mesh.peer("space", j + 1) if j < n - 1 else None)


class _HaloPull(torch.autograd.Function):
    @staticmethod
    def forward(ctx, head, mesh):
        ctx.mesh = mesh
        above, below = _space_neighbours(mesh)
        return _exchange(head, above, below, mesh.group("space"))

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        above, below = _space_neighbours(mesh)
        return _exchange(g, below, above, mesh.group("space")), None


def with_halo(x: torch.Tensor, kernel_size: int, mesh, row_axis: int) -> torch.Tensor:
    """``x`` with the next space rank's first K−1 rows concatenated below
    its block along ``row_axis`` (zeros on the last): the slab of Hl+K−1
    rows a K×K layer turns into Hl rows (``_with_halo``). The neighbours
    are this rank's space line's (``mesh.peer``: on SP×TP rank ± n_model).
    A space axis of one rank holds the whole image: no halo, the layer
    shrinks it as on one device."""
    if kernel_size == 1 or mesh.size("space") == 1:
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
    """A grid step's reduction of its gradients: a per-leaf axis table
    (``_reduce_grads``, sp_tp.py:164-181; tensor_parallel.py:318-339 and
    spatial_parallel.py:272-284 are its cases with one axis of one rank).
    ``table`` pairs a parameter with the axes its gradient is summed over,
    those whose every rank holds only its part of it: SP×TP's early
    (replicated) cores over ``("space", "model")``, the last core's O-slice
    and the classifier's weight over ``"space"``. Axes of one rank drop out,
    and the leaves that share a group are summed in one all-reduce of one
    flattened buffer, in parameter order; then every gradient, with the
    cross-entropy beside them, is averaged over the data group in one more.
    A leaf outside the table (the bias, which enters after the logits' sum;
    a model shard on a space axis of one) is only averaged over data. The
    regularizer is added before this reduction (``reg_inside``), in the
    local form whose reduction is its gradient once."""

    reg_inside = True

    def __init__(self, mesh, table: Sequence[tuple]):
        self.mesh = mesh
        self.axes = {id(p): mesh.live(axes) for p, axes in table}

    def mean(self, params: Sequence[torch.Tensor], ce: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        with_grad = [p for p in params if p.grad is not None]
        by_group = {}
        for p in with_grad:
            live = self.axes.get(id(p), ())
            if live:
                by_group.setdefault(live, []).append(p.grad)
        for live, grads in by_group.items():
            buf = torch.cat([g.reshape(-1) for g in grads])
            mesh.reduce_(buf, live)
            _unflatten(buf, grads)
        ce = ce.detach().reshape(1).to(with_grad[0].dtype)
        if mesh.size("data") == 1:
            return ce[0]
        grads = [p.grad for p in with_grad]
        buf = torch.cat([g.reshape(-1) for g in grads] + [ce])
        mesh.reduce_data_(buf).div_(mesh.size("data"))
        _unflatten(buf, grads)
        return buf[-1].clone()

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.gather_data(t)


def _unflatten(buf: torch.Tensor, grads) -> None:
    offset = 0
    for g in grads:
        g.copy_(buf[offset : offset + g.numel()].view_as(g))
        offset += g.numel()
