"""Host side of K13, the fused log-space matrix product (port of
``dctn_tpu/pallas/logmatmulexp_pallas.py``).

``logmatmulexp_fwd`` is the wrapper of the product in ``csrc/logmatmulexp.cu``:
for f32 ``log_a`` (Θ, R), ``log_b`` (R, I) and their shifts ``amax`` (Θ, 1)
and ``bmax`` (1, I), log(exp(log_a − amax) @ exp(log_b − bmax)) + amax +
bmax, the exponentials made in shared memory and never stored, the product
in 3xTF32 on the tensor cores, and R's splits summed in the same launch.
``logmatmulexp_shifts`` is the wrapper of the same source's shifts kernel:
the row maxima of ``log_a`` and the column maxima of ``log_b``, a non-finite
maximum replaced by 0, in one launch. On CPU tensors each runs its plain
version (``logmatmulexp_fwd_reference``, ``max_shifts``: the same arithmetic
as torch ops); on CUDA tensors it launches its kernel or raises. There is no
fallback.

``LogMatMulExp`` is the ``torch.autograd.Function`` around them, with the
boundary of the JAX ``custom_vjp`` (logmatmulexp_pallas.py:86-125): its
forward computes the shifts (``_forward``, :53-57) and the product, two
launches on the card, and saves (log_a, log_b, amax, bmax, out) as ``_fwd``
does (:104-106); its backward is ``_bwd`` (:109-124) as torch ops. The TPU
backward has no kernel either: P = exp(A − a*), Q = exp(B − b*), S = exp(out
− a* − b*), dS = g/S where S > 0 and 0 elsewhere, dA = P·(dS·Qᵀ), dB =
Q·(Pᵀ·dS), the two products by ``torch.matmul``. ``logmatmulexp_kernel`` is
the counterpart of ``logmatmulexp_pallas``. ``KERNEL`` and ``PLAIN`` are the
two bundles of (shifts, forward), for callers that choose between the kernels
and their plain versions.

The kernels' arrival counters (the last CTA of a tile, or of a row or column
group of the shifts, finishes it) are one persistent zeroed buffer per
device, which every launch leaves zeroed: two forwards must not run at once
on different streams of one device.

Not ported, because it serves only the TPU: the padding of every operand
to (128, 128) tiles at −1e30 and the clamp of the inputs there (:29,
:59-65): the CUDA kernel masks its ragged edges, so nothing is padded.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable

import torch

from ..ops.logmatmulexp import logmatmulexp_shifted, max_shifts
from . import build

# the product's tile (csrc/logmatmulexp.cu): 64×64 outputs per CTA, R in
# chunks of 32, two raw chunks in flight, the exponentials as TF32 hi and lo
# planes; the CTA is 8 warps (two per SM) where the grid fits the card at two
# CTAs per SM, else 4 warps (three per SM)
_BM = 64
_BN = 64
_BK = 32
_STAGES = 2
_RAW_FLOATS = _BM * (_BK + 4) + _BK * (_BN + 4)
_PLANE_FLOATS = 2 * (_BM * (_BK + 4) + _BK * (_BN + 8))
_SMEM_BYTES = 4 * (_STAGES * _RAW_FLOATS + _PLANE_FLOATS + _BM + _BN)
_H100_SMS = 132
# R is split until the grid has about two CTAs for each of an H100's 132
# SMs, with at least two chunks in each split: a constant, so the split
# points, and with them the bits of the result, depend on the shape alone
_TARGET_CTAS = 2 * 132
_MIN_CHUNKS_PER_SPLIT = 2
# the shifts kernel: 8 rows of A or 32 columns of B per block, R in slices
# of 2048
_SHIFT_ROWS = 8
_SHIFT_COLS = 32
_SHIFT_SLICE = 2048


# the kernel's plain version: the ops form's max-shift arithmetic with the
# shifts given, the exponentials materialized
logmatmulexp_fwd_reference = logmatmulexp_shifted


def _splits(theta: int, r: int, n_i: int) -> int:
    """How many parts the kernel splits R into (see ``_TARGET_CTAS``)."""
    tiles = -(-theta // _BM) * -(-n_i // _BN)
    chunks = -(-r // _BK)
    return max(1, min(-(-_TARGET_CTAS // tiles), chunks // _MIN_CHUNKS_PER_SPLIT))


def _plan(theta: int, r: int, n_i: int, sms: int = _H100_SMS) -> dict:
    """The product's launch on a card of ``sms`` SMs: its grid (column
    tiles, row tiles, splits of R), the chunks of R, the CTA's warps along N
    (4: 8 warps, or 2: 4 warps where the grid is over two CTAs per SM) and
    threads, and the shared memory of a CTA. The two forms give the same
    bits."""
    splits = _splits(theta, r, n_i)
    grid = (-(-n_i // _BN), -(-theta // _BM), splits)
    warps_n = 4 if grid[0] * grid[1] * splits <= 2 * sms else 2
    return {"grid": grid, "splits": splits, "chunks": -(-r // _BK), "tile": (_BM, _BN, _BK),
            "warps_n": warps_n, "threads": 64 * warps_n, "smem_bytes": _SMEM_BYTES}


def _shift_plan(theta: int, r: int, n_i: int) -> dict:
    """The shifts kernel's launch: its groups (blocks of rows of A, then of
    columns of B) by slices of R."""
    groups = -(-theta // _SHIFT_ROWS) + -(-n_i // _SHIFT_COLS)
    return {"grid": (groups, max(1, -(-r // _SHIFT_SLICE))), "groups": groups,
            "slices": max(1, -(-r // _SHIFT_SLICE))}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/logmatmulexp.cu``."""
    lib = build.load_library("logmatmulexp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dctn_lme_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.dctn_lme_fwd.restype = ctypes.c_int
    lib.dctn_lme_shifts.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.dctn_lme_shifts.restype = ctypes.c_int
    lib.dctn_lme_smem_bytes.restype = ctypes.c_int
    if lib.dctn_lme_smem_bytes() != _SMEM_BYTES:
        raise RuntimeError(f"logmatmulexp.cu takes {lib.dctn_lme_smem_bytes()} B of shared "
                           f"memory per CTA, the host plans {_SMEM_BYTES}")
    return lib


_COUNTERS: dict = {}


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 arrival counters on ``dev``, kept from
    call to call: every launch leaves them zeroed."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[key] = buf
    return buf


def _check_args(log_a, log_b, amax, bmax) -> None:
    def fail(what):
        raise ValueError(f"logmatmulexp: {what} (log_a {tuple(log_a.shape)}, log_b "
                         f"{tuple(log_b.shape)}, amax {tuple(amax.shape)}, bmax "
                         f"{tuple(bmax.shape)})")

    for key, x in (("log_a", log_a), ("log_b", log_b), ("amax", amax), ("bmax", bmax)):
        if x.dtype != torch.float32:
            fail(f"the kernel takes float32, got {key} {x.dtype}")
        if x.device != log_a.device:
            fail(f"{key} on {x.device}, log_a on {log_a.device}")
    if log_a.ndim != 2 or log_b.ndim != 2 or log_a.shape[1] != log_b.shape[0]:
        fail("not (Θ, R) and (R, I)")
    if tuple(amax.shape) != (log_a.shape[0], 1) or tuple(bmax.shape) != (1, log_b.shape[1]):
        fail("shifts are not (Θ, 1) and (1, I)")


def logmatmulexp_fwd(
    log_a: torch.Tensor, log_b: torch.Tensor, amax: torch.Tensor, bmax: torch.Tensor
) -> torch.Tensor:
    """K13's forward, (Θ, I). CPU tensors run
    ``logmatmulexp_fwd_reference``; CUDA tensors launch the kernel (where R
    is split, its last CTA of each tile adds the splits in a fixed order in
    the same launch), and ``logmatmulexp_fwd.launches`` counts its
    launches."""
    if log_a.device.type == "cpu":
        return logmatmulexp_fwd_reference(log_a, log_b, amax, bmax)
    if log_a.device.type != "cuda":
        raise ValueError(f"logmatmulexp_fwd runs on cpu or cuda, not {log_a.device}")
    _check_args(log_a, log_b, amax, bmax)
    (theta, r), n_i = log_a.shape, log_b.shape[1]
    dev = log_a.device
    log_a, log_b = log_a.contiguous(), log_b.contiguous()
    amax, bmax = amax.contiguous(), bmax.contiguous()
    plan = _plan(theta, r, n_i, torch.cuda.get_device_properties(dev).multi_processor_count)
    splits = plan["splits"]
    out = torch.empty((theta, n_i), dtype=torch.float32, device=dev)
    partial = counters = None
    if splits > 1:
        partial = torch.empty((splits, theta, n_i), dtype=torch.float32, device=dev)
        counters = _counters(dev, plan["grid"][0] * plan["grid"][1])
    with torch.cuda.device(dev):
        err = _library().dctn_lme_fwd(
            log_a.data_ptr(), log_b.data_ptr(), amax.data_ptr(), bmax.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(),
            None if counters is None else counters.data_ptr(), theta, r, n_i, splits,
            plan["warps_n"], torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"logmatmulexp kernel launch failed with CUDA error {err}")
    logmatmulexp_fwd.launches += 1
    return out


logmatmulexp_fwd.launches = 0


def logmatmulexp_shifts(log_a: torch.Tensor, log_b: torch.Tensor):
    """The shifts of K13: the row maxima of ``log_a`` (Θ, 1) and the column
    maxima of ``log_b`` (1, I), a non-finite maximum replaced by 0. CPU
    tensors run ``max_shifts``; CUDA tensors launch the shifts kernel (one
    launch; the same bits as ``max_shifts``: a maximum is exact in any
    order), and ``logmatmulexp_shifts.launches`` counts its launches."""
    if log_a.device.type == "cpu":
        return max_shifts(log_a, log_b)
    if log_a.device.type != "cuda":
        raise ValueError(f"logmatmulexp_shifts runs on cpu or cuda, not {log_a.device}")
    (theta, r), n_i = log_a.shape, log_b.shape[1]
    dev = log_a.device
    amax = torch.empty((theta, 1), dtype=torch.float32, device=dev)
    bmax = torch.empty((1, n_i), dtype=torch.float32, device=dev)
    _check_args(log_a, log_b, amax, bmax)
    log_a, log_b = log_a.contiguous(), log_b.contiguous()
    plan = _shift_plan(theta, r, n_i)
    part = counters = None
    if plan["slices"] > 1:
        part = torch.empty((plan["slices"], theta + n_i), dtype=torch.float32, device=dev)
        counters = _counters(dev, plan["groups"])
    with torch.cuda.device(dev):
        err = _library().dctn_lme_shifts(
            log_a.data_ptr(), log_b.data_ptr(), amax.data_ptr(), bmax.data_ptr(),
            None if part is None else part.data_ptr(),
            None if counters is None else counters.data_ptr(), theta, r, n_i,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"logmatmulexp shifts kernel launch failed with CUDA error {err}")
    logmatmulexp_shifts.launches += 1
    return amax, bmax


logmatmulexp_shifts.launches = 0


@dataclasses.dataclass(frozen=True)
class LMEKernels:
    """The shifts and the shifted product, with the signatures of
    ``logmatmulexp_shifts`` and ``logmatmulexp_fwd``."""

    shifts: Callable
    fwd: Callable


# what ``LogMatMulExp`` runs: the kernels, or their plain versions for a
# caller that runs the plain path on the card on purpose
KERNEL = LMEKernels(logmatmulexp_shifts, logmatmulexp_fwd)
PLAIN = LMEKernels(max_shifts, logmatmulexp_fwd_reference)


class LogMatMulExp(torch.autograd.Function):
    """log(exp(log_a) @ exp(log_b)) through ``kernels`` (``KERNEL`` or
    ``PLAIN``), with the backward of logmatmulexp_pallas.py:109-124."""

    @staticmethod
    def forward(ctx, log_a, log_b, kernels: LMEKernels):
        amax, bmax = kernels.shifts(log_a, log_b)
        out = kernels.fwd(log_a, log_b, amax, bmax)
        ctx.save_for_backward(log_a, log_b, amax, bmax, out)
        return out

    @staticmethod
    def backward(ctx, g):
        log_a, log_b, amax, bmax, out = ctx.saved_tensors
        p = torch.exp(log_a - amax)
        q = torch.exp(log_b - bmax)
        # g / S with S = exp(out − a* − b*); S = 0 for an all −inf row or column
        s = torch.exp(out - amax - bmax)
        ds = torch.where(s > 0, g / s, torch.zeros_like(s))
        return p * (ds @ q.T), q * (p.T @ ds), None


def logmatmulexp_kernel(
    log_a: torch.Tensor, log_b: torch.Tensor, kernels: LMEKernels = KERNEL
) -> torch.Tensor:
    """log(exp(log_a) @ exp(log_b)), (Θ, R) × (R, I) → (Θ, I), through K13
    (the counterpart of ``logmatmulexp_pallas``), differentiable in both.
    ``kernels`` is ``KERNEL`` unless a caller runs the plain versions on the
    card."""
    return LogMatMulExp.apply(log_a, log_b, kernels)
