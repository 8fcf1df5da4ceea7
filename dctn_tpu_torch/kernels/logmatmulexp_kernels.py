"""Host side of K13, the fused log-space matrix product (port of
``dctn_tpu/pallas/logmatmulexp_pallas.py``).

``logmatmulexp_fwd`` is the wrapper of ``csrc/logmatmulexp.cu``: for f32
``log_a`` (Θ, R), ``log_b`` (R, I) and their shifts ``amax`` (Θ, 1) and
``bmax`` (1, I), log(exp(log_a − amax) @ exp(log_b − bmax)) + amax + bmax,
the exponentials made as the operands are loaded and never stored. On a CPU
tensor it runs its plain version ``logmatmulexp_fwd_reference`` (the same
arithmetic as torch ops); on a CUDA tensor it launches the kernel or raises.
There is no fallback.

``LogMatMulExp`` is the ``torch.autograd.Function`` around it, with the
boundary of the JAX ``custom_vjp`` (logmatmulexp_pallas.py:86-125): its
forward computes the shifts as torch ops, as ``_forward`` does (:53-57), and
saves (log_a, log_b, amax, bmax, out) as ``_fwd`` does (:104-106); its
backward is ``_bwd`` (:109-124) as torch ops. The TPU backward has no
kernel either: P = exp(A − a*), Q = exp(B − b*), S = exp(out − a* − b*),
dS = g/S where S > 0 and 0 elsewhere, dA = P·(dS·Qᵀ), dB = Q·(Pᵀ·dS), the
two products by ``torch.matmul``. ``logmatmulexp_kernel`` is the
counterpart of ``logmatmulexp_pallas``. ``KERNEL`` and ``PLAIN`` are the
two forwards, for callers that choose between the kernel and its plain
version.

Not ported, because it serves only the TPU: the padding of every operand
to (128, 128) tiles at −1e30 and the clamp of the inputs there (:29,
:59-65): the CUDA kernel masks its ragged edges, so nothing is padded.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch

from ..ops.logmatmulexp import logmatmulexp_shifted, max_shifts
from . import build

# the kernel's tile (csrc/logmatmulexp.cu): 64×64 outputs per CTA, R in
# chunks of 32
_BM = 64
_BN = 64
_BK = 32
# R is split until the grid has about two CTAs for each of an H100's 132
# SMs, with at least two chunks in each split: a constant, so the split
# points, and with them the bits of the result, depend on the shape alone
_TARGET_CTAS = 2 * 132
_MIN_CHUNKS_PER_SPLIT = 2


# the kernel's plain version: the ops form's max-shift arithmetic with the
# shifts given, the exponentials materialized
logmatmulexp_fwd_reference = logmatmulexp_shifted


def _splits(theta: int, r: int, n_i: int) -> int:
    """How many parts the kernel splits R into (see ``_TARGET_CTAS``)."""
    tiles = -(-theta // _BM) * -(-n_i // _BN)
    chunks = -(-r // _BK)
    return max(1, min(-(-_TARGET_CTAS // tiles), chunks // _MIN_CHUNKS_PER_SPLIT))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/logmatmulexp.cu``."""
    lib = build.load_library("logmatmulexp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dctn_lme_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.dctn_lme_fwd.restype = ctypes.c_int
    return lib


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
    ``logmatmulexp_fwd_reference``; CUDA tensors launch the kernel (and,
    where R is split, the fixed-order sum of the splits in the same call),
    and ``logmatmulexp_fwd.launches`` counts the calls that launched it."""
    if log_a.device.type == "cpu":
        return logmatmulexp_fwd_reference(log_a, log_b, amax, bmax)
    if log_a.device.type != "cuda":
        raise ValueError(f"logmatmulexp_fwd runs on cpu or cuda, not {log_a.device}")
    _check_args(log_a, log_b, amax, bmax)
    (theta, r), n_i = log_a.shape, log_b.shape[1]
    dev = log_a.device
    log_a, log_b = log_a.contiguous(), log_b.contiguous()
    amax, bmax = amax.contiguous(), bmax.contiguous()
    splits = _splits(theta, r, n_i)
    out = torch.empty((theta, n_i), dtype=torch.float32, device=dev)
    partial = (torch.empty((splits, theta, n_i), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    with torch.cuda.device(dev):
        err = _library().dctn_lme_fwd(
            log_a.data_ptr(), log_b.data_ptr(), amax.data_ptr(), bmax.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(), theta, r, n_i,
            splits, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"logmatmulexp kernel launch failed with CUDA error {err}")
    logmatmulexp_fwd.launches += 1
    return out


logmatmulexp_fwd.launches = 0


# the forwards ``LogMatMulExp`` takes: the kernel, or its plain version for a
# caller that runs the plain path on the card on purpose
KERNEL = logmatmulexp_fwd
PLAIN = logmatmulexp_fwd_reference


class LogMatMulExp(torch.autograd.Function):
    """log(exp(log_a) @ exp(log_b)) through ``fwd`` (``KERNEL`` or
    ``PLAIN``), with the backward of logmatmulexp_pallas.py:109-124."""

    @staticmethod
    def forward(ctx, log_a, log_b, fwd: Callable):
        amax, bmax = max_shifts(log_a, log_b)
        out = fwd(log_a, log_b, amax, bmax)
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
    log_a: torch.Tensor, log_b: torch.Tensor, fwd: Callable = KERNEL
) -> torch.Tensor:
    """log(exp(log_a) @ exp(log_b)), (Θ, R) × (R, I) → (Θ, I), through K13
    (the counterpart of ``logmatmulexp_pallas``), differentiable in both.
    ``fwd`` is ``KERNEL`` unless a caller runs the plain version on the
    card."""
    return LogMatMulExp.apply(log_a, log_b, fwd)
