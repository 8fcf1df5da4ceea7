"""Host side of the EPS forward kernel (port of the forward half of
``dctn_tpu/pallas/eps_pallas.py``).

The layer works in the transposed batch-minor layout: ``xT`` (C, Q, H, W, B)
in, ``outT`` (O, H', W', B) out, the flat pixel index ``(h·W' + w)·B + b``.
The host builds the (n, q, npix) stack of window factors (merging q=2
factor pairs into q=4 ones, as the JAX plan does) and hands it, with the
core in its matricized (Z, A) "cmt" layout, to ``eps_fwd``:

- on a CPU tensor ``eps_fwd`` runs ``eps_fwd_reference``, the plain PyTorch
  version;
- on a CUDA tensor it launches the hand-written kernel
  ``csrc/eps_fwd.cu`` (which replaces ``_fwd_kernel_factory``,
  eps_pallas.py:227) or raises. There is no fallback.

Unlike the JAX host glue, the factor stack is not padded to a tile
multiple: the kernel masks its ragged last pixel tile itself. The TPU VMEM
planners (``pallas_forward_fits``, ``_largest_bn``, ``_*_bytes``) have no
counterpart; the wrapper checks the kernel's own limits instead.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build

# the kernel's limits (csrc/eps_fwd.cu)
_MAX_B2 = 512
_MAX_FACTOR_ROWS = 256
_MAX_OUT_SIZE = 65535


def _slice_specs(kernel_size: int, num_channels: int):
    """(δh, δw, c) per view, in window_views order: position-major,
    channel-minor."""
    return tuple(
        (dh, dw, c)
        for dh in range(kernel_size)
        for dw in range(kernel_size)
        for c in range(num_channels)
    )


def _stack_views_from_xT(
    xT: torch.Tensor, kernel_size: int, merge_pairs: bool
) -> Tuple[torch.Tensor, int]:
    """The (n, q, npix) factor stack from ``xT`` (C, Q, H, W, B), and npix.
    ``merge_pairs``: Khatri-Rao adjacent view pairs, the first one slowest,
    so a q=2 chain runs as a q²=4 one (eps_pallas.py:633-666, without the
    padding)."""
    c, q, h, w, b = xT.shape
    hp, wp = h - kernel_size + 1, w - kernel_size + 1
    npix = b * hp * wp
    views = [
        xT[ch, :, dh : dh + hp, dw : dw + wp, :].reshape(q, npix)
        for dh, dw, ch in _slice_specs(kernel_size, c)
    ]
    if merge_pairs:
        views = [
            (views[2 * i][:, None, :] * views[2 * i + 1][None, :, :]).reshape(
                q * q, npix
            )
            for i in range(len(views) // 2)
        ]
    return torch.stack(views, dim=0), npix


def _kernel_dims(c: int, q: int, kernel_size: int, n1: int, merge_pairs: bool):
    """(n_k, q_k, n1_k) as the kernel sees them after optional pair merging."""
    n = kernel_size**2 * c
    if merge_pairs:
        return n // 2, q * q, n1 // 2
    return n, q, n1


def _core_to_cmt_k(core: torch.Tensor, n1_k: int, q_k: int) -> torch.Tensor:
    """Matricize with OUTPUT-major rows: cmt[(o, b), a], a over the first n1_k
    (possibly merged) factor dims, b over the rest, both row-major. The
    row-major reshape of (q,)*n to (q²,)*(n/2) moves no memory, so merged
    pairs line up with the core's dims."""
    o = core.shape[-1]
    a = q_k**n1_k
    b = core.numel() // (o * a)
    return core.reshape(a, b, o).permute(2, 1, 0).reshape(o * b, a).contiguous()


def plan_call(c: int, q: int, kernel_size: int, n1: int):
    """(n1, merge_pairs) for one layer: q=2 factor pairs merge when n is
    even, and a merged layer needs an even split, so an odd n1 is nudged
    (eps_pallas.py:983-999, without the TPU tile planning)."""
    n = kernel_size**2 * c
    merge_pairs = q == 2 and n % 2 == 0
    if merge_pairs and n1 % 2 == 1:
        n1 += 1 if n1 + 1 <= n else -1
    return n1, merge_pairs


def _suffix_chain(views_t: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """f_start ⊗ … ⊗ f_{stop-1} over the (q, npix) factors, f_start slowest,
    built from the back as the TPU kernel's ``_suffix_chain`` does."""
    s = views_t[stop - 1]
    for k in range(stop - 2, start - 1, -1):
        s = (views_t[k][:, None, :] * s[None, :, :]).reshape(-1, s.shape[-1])
    return s


def eps_fwd_reference(
    views_t: torch.Tensor, cmt: torch.Tensor, n1: int, out_size: int
) -> torch.Tensor:
    """The kernel's plain PyTorch version: u from the first n1 factors,
    t = cmt @ u, then out[o, p] = Σ_b t[(o, b), p]·v[b, p] (out = t when
    every factor is in u). (n, q, npix), (Z, A) → (O, npix)."""
    n, q, npix = views_t.shape
    t = cmt @ _suffix_chain(views_t, 0, n1)
    if n1 == n:
        return t
    v = _suffix_chain(views_t, n1, n)
    return torch.sum(t.reshape(out_size, q ** (n - n1), npix) * v[None], dim=1)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = build.load_library("eps_fwd")
    lib.dctn_eps_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.dctn_eps_fwd.restype = ctypes.c_int
    return lib


def _check_kernel_args(views_t, cmt, n1, out_size):
    n, q, npix = views_t.shape
    shape = f"views {tuple(views_t.shape)}, cmt {tuple(cmt.shape)}, n1={n1}, O={out_size}"
    if views_t.dtype != torch.float32 or cmt.dtype != torch.float32:
        raise ValueError(f"eps_fwd kernel takes float32, got {views_t.dtype}/{cmt.dtype}")
    if cmt.device != views_t.device:
        raise ValueError(f"eps_fwd: views on {views_t.device}, cmt on {cmt.device}")
    if not (views_t.is_contiguous() and cmt.is_contiguous()):
        raise ValueError(f"eps_fwd kernel takes contiguous tensors ({shape})")
    if not 1 <= n1 <= n:
        raise ValueError(f"eps_fwd: split n1 outside [1, n] ({shape})")
    b2 = q ** (n - n1)
    if b2 > _MAX_B2 or n * q > _MAX_FACTOR_ROWS or out_size > _MAX_OUT_SIZE:
        raise ValueError(
            f"eps_fwd kernel limits exceeded ({shape}): needs q^(n-n1)={b2} "
            f"<= {_MAX_B2}, n·q={n * q} <= {_MAX_FACTOR_ROWS}, "
            f"O <= {_MAX_OUT_SIZE}"
        )
    if tuple(cmt.shape) != (out_size * b2, q**n1):
        raise ValueError(f"eps_fwd: cmt is not (O·q^(n-n1), q^n1) ({shape})")


def eps_fwd(
    views_t: torch.Tensor, cmt: torch.Tensor, n1: int, out_size: int
) -> torch.Tensor:
    """One EPS layer's forward on the factor stack: (n, q, npix) views and
    the (Z, A) cmt → (O, npix). CPU tensors run ``eps_fwd_reference``; CUDA
    tensors run the kernel, and ``eps_fwd.launches`` counts its launches."""
    if views_t.device.type == "cpu":
        return eps_fwd_reference(views_t, cmt, n1, out_size)
    if views_t.device.type != "cuda":
        raise ValueError(f"eps_fwd runs on cpu or cuda, not {views_t.device}")
    _check_kernel_args(views_t, cmt, n1, out_size)
    n, q, npix = views_t.shape
    out = torch.empty((out_size, npix), dtype=torch.float32, device=views_t.device)
    stream = torch.cuda.current_stream(views_t.device).cuda_stream
    with torch.cuda.device(views_t.device):
        err = _library().dctn_eps_fwd(
            views_t.data_ptr(), cmt.data_ptr(), out.data_ptr(),
            n, q, n1, out_size, npix, stream,
        )
    if err != 0:
        raise RuntimeError(f"eps_fwd kernel launch failed with CUDA error {err}")
    eps_fwd.launches += 1
    return out


eps_fwd.launches = 0


def eps_apply_t_cmt(
    cmt: torch.Tensor,
    xT: torch.Tensor,
    out_size: int,
    kernel_size: int,
    n1: int,
    merge_pairs: bool,
    fwd=eps_fwd,
) -> torch.Tensor:
    """One EPS layer on the matricized core (eps_pallas.py:924-963, the
    forward only, with no t output): ``xT`` (C, Q, H, W, B) → ``outT``
    (O, H', W', B). ``fwd`` is the layer's contraction, ``eps_fwd`` unless a
    caller checks the kernel against ``eps_fwd_reference``."""
    c, q, h, w, b = xT.shape
    hp, wp = h - kernel_size + 1, w - kernel_size + 1
    _, _, n1_k = _kernel_dims(c, q, kernel_size, n1, merge_pairs)
    views_t, _ = _stack_views_from_xT(xT, kernel_size, merge_pairs)
    return fwd(views_t, cmt, n1_k, out_size).reshape(out_size, hp, wp, b)
