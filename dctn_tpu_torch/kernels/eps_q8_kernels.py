"""Host side of the int8 (W8A8) EPS forward (port of
``dctn_tpu/pallas/eps_pallas_q8.py``): int8 serving and quantization-aware
training (QAT) with straight-through gradients.

Scheme (dynamic W8A8, no calibration data, as in the JAX package):

- weights: per-row symmetric int8 of the layer's (Z, A) cmt,
  ``sw = max(max|row| / 127, 1e-30)``, ``wq = clip(round(cmt / sw))``
  (``quantize_cmt``);
- activations: the same per pixel column of u, the Khatri-Rao chain of the
  first n1 factors (``_quantize_columns``);
- ``t = (wq · uq in int32) · sw · su``, then ``out[o] = Σ_b t[(o, b)]·v[b]``
  in f32.

``eps_fwd_q8`` runs the hand-written kernel (``csrc/eps_fwd_q8.cu``,
replacing ``_fwd_q8_kernel_factory``, eps_pallas_q8.py:98) on CUDA tensors
and its plain version ``eps_fwd_q8_reference`` on CPU tensors; with
``save_t`` it also writes the dequantized t (K9). The quantizers of the
weights stay torch ops on the card: they run outside the TPU kernel too.

The plain version is written so that the kernel's uq, int32 t and saved t
equal it bit for bit: true division everywhere (torch's CUDA division by a
Python scalar multiplies by its reciprocal instead), round half to even,
and an exact integer product (an int8 ``torch.mm`` would wrap, and CUDA has
no integer matmul: float64 on every device, exact below 2⁵³, and far faster
on the CPU than an int32 matmul).

QAT: ``QAT_KERNELS`` and ``QAT_PLAIN`` are ``EPSKernels`` bundles whose
forward quantizes the live f32 cmt and runs the int8 forward; their backward
is the f32 one (``eps_dcore``, ``eps_dviews_t``) on the f32 cmt, fed the
dequantized t when one was saved, or recomputing t in f32 from the f32 cmt
when none was (``eps_dviews_recompute``, as the JAX STE backward does,
eps_pallas_q8.py:262-268), so ``EPSApplyTCmt`` gives the
straight-through backward unchanged, and ``plan_backward`` picks each
layer's arm as it does for the f32 forward (the JAX package's
``qat_save_decision`` is the same rule).
"""

from __future__ import annotations

import torch

from .eps_kernels import (
    EPSKernels,
    _MAX_B2,
    _MAX_SMEM_BYTES,
    _check_device,
    _check_split,
    _check_tensors,
    _kernel_dims,
    _library,
    _raise_on_error,
    _stack_views_from_xT,
    _stream,
    _suffix_chain,
    eps_dcore,
    eps_dcore_reference,
    eps_dviews_recompute,
    eps_dviews_recompute_reference,
    eps_dviews_t,
    eps_dviews_t_reference,
)

# all-zero rows and columns quantize to 0 with this scale instead of dividing
# by zero (a black pixel's φ features are exact zeros)
_EPS_SCALE = 1e-30
# csrc/eps_fwd_q8.cu's tiling: pixels per CTA, A columns per step, rows of Z
# per block, staged rows per warp
_TILE_PIX = 64
_STEP_K = 64
_BLOCK_ROWS = 128
_ROWS_PER_WARP = 16


# ---------------------------------------------------------------------------
# quantizers and the plain forward


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax / 127, 1e-30), by a true division on every device."""
    return torch.clamp_min(absmax / torch.full_like(absmax, 127.0), _EPS_SCALE)


def quantize_cmt(cmt: torch.Tensor):
    """Per-row symmetric int8 of a (Z, A) cmt: (wq int8 (Z, A), sw f32
    (Z, 1)), bit for bit the JAX package's ``quantize_cmt``."""
    cmt = cmt.to(torch.float32)
    sw = _scale(cmt.abs().amax(dim=1, keepdim=True))
    wq = torch.clamp(torch.round(cmt / sw), -127, 127).to(torch.int8)
    return wq, sw


def _quantize_columns(u: torch.Tensor):
    """Per-column int8 of the (A, npix) chain product: (uq int8, su f32
    (1, npix))."""
    su = _scale(u.abs().amax(dim=0, keepdim=True))
    uq = torch.clamp(torch.round(u / su), -127, 127).to(torch.int8)
    return uq, su


def _int_matmul(wq: torch.Tensor, uq: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of two int8 matrices: every partial sum is
    an integer below A·127² < 2³¹, so float64 holds it exactly."""
    return (wq.to(torch.float64) @ uq.to(torch.float64)).to(torch.int32)


def eps_fwd_q8_reference(
    views_t: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, n1: int, out_size: int,
    save_t: bool = False,
):
    """The int8 forward kernel's plain PyTorch version: (n, q, npix) f32
    views, the (Z, A) int8 wq and its (Z, 1) scales → (O, npix), and the
    dequantized t (Z, npix) too when ``save_t``."""
    n, _, npix = views_t.shape
    uq, su = _quantize_columns(_suffix_chain(views_t, 0, n1)[0])
    t = (_int_matmul(wq, uq).to(torch.float32) * sw) * su
    if n1 == n:
        out = t
    else:
        v = _suffix_chain(views_t, n1, n)[0]
        out = torch.sum(t.reshape(out_size, -1, npix) * v[None], dim=1)
    return (out, t) if save_t else out


# ---------------------------------------------------------------------------
# the kernel's wrapper


def _q8_smem_bytes(n: int, q: int, n1: int) -> int:
    """Shared memory of one ``eps_fwd_q8`` launch (``smem_layout`` in
    csrc/eps_fwd_q8.cu): staged factors, su, two carry rows and the staged
    partial rows (one per warp when B2 is a multiple of 16, else one per row
    of the block) in f32; the digit tables of a and b; the A × 64 uq tile,
    16-byte aligned, its rows padded to a 64 multiple plus 64."""
    a, b2 = q**n1, q ** (n - n1)
    units = 8 if b2 % _ROWS_PER_WARP == 0 else _BLOCK_ROWS
    floats = n * q * _TILE_PIX + 3 * _TILE_PIX + units * (_TILE_PIX + 8)
    uq_offset = -(-4 * (floats + a + b2) // 16) * 16
    a_pad = -(-a // _STEP_K) * _STEP_K
    return uq_offset + _TILE_PIX * (a_pad + 64)


def _check_q8_args(views_t, wq, sw, n1, out_size):
    n, q, npix = views_t.shape
    shape = (
        f"views {tuple(views_t.shape)}, wq {tuple(wq.shape)}, sw {tuple(sw.shape)}, "
        f"n1={n1}, O={out_size}"
    )
    _check_tensors("eps_fwd_q8", shape, views_t.device, views=views_t, sw=sw)
    _check_tensors("eps_fwd_q8", shape, views_t.device, torch.int8, wq=wq)
    _check_split("eps_fwd_q8", shape, n, q, n1)
    a, b2 = q**n1, q ** (n - n1)
    bits = (q - 1).bit_length()
    smem = _q8_smem_bytes(n, q, n1)
    if b2 > _MAX_B2 or a * 127 * 127 >= 2**31 or bits * max(n1, n - n1) > 32 or smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"eps_fwd_q8 kernel limits exceeded ({shape}): needs q^(n-n1)={b2} <= {_MAX_B2}, "
            f"A·127² < 2³¹, digits in 32 bits, and {smem} B of shared memory <= {_MAX_SMEM_BYTES}"
        )
    if tuple(wq.shape) != (out_size * b2, a) or tuple(sw.shape) != (out_size * b2, 1):
        raise ValueError(f"eps_fwd_q8: wq is not (O·q^(n-n1), q^n1) or sw not (Z, 1) ({shape})")


def _launch_q8(views_t, wq, sw, n1: int, out_size: int, t=None, su=None) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors (``t`` (Z, npix) and ``su``
    (npix,) are written when given); counts it in ``eps_fwd_q8.launches``
    and, with ``t``, ``eps_fwd_q8.t_launches``."""
    _check_device("eps_fwd_q8", views_t)
    _check_q8_args(views_t, wq, sw, n1, out_size)
    n, q, npix = views_t.shape
    dev = views_t.device
    out = torch.empty((out_size, npix), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _library("eps_fwd_q8").dctn_eps_fwd_q8(
            views_t.data_ptr(), wq.data_ptr(), sw.data_ptr(), out.data_ptr(),
            None if t is None else t.data_ptr(), None if su is None else su.data_ptr(),
            n, q, n1, out_size, npix, _stream(dev),
        )
    _raise_on_error("eps_fwd_q8", err)
    eps_fwd_q8.launches += 1
    eps_fwd_q8.t_launches += t is not None
    return out


def eps_fwd_q8(
    views_t: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, n1: int, out_size: int,
    save_t: bool = False,
):
    """One EPS layer's int8 forward on the factor stack: (n, q, npix) f32
    views, the (Z, A) int8 wq and its (Z, 1) f32 scales → (O, npix), and the
    dequantized t (Z, npix) too when ``save_t``. CPU tensors run
    ``eps_fwd_q8_reference``; CUDA tensors run the kernel:
    ``eps_fwd_q8.launches`` counts its launches and ``eps_fwd_q8.t_launches``
    those that wrote t."""
    if views_t.device.type == "cpu":
        return eps_fwd_q8_reference(views_t, wq, sw, n1, out_size, save_t)
    if not save_t:
        return _launch_q8(views_t, wq, sw, n1, out_size)
    t = torch.empty((wq.shape[0], views_t.shape[2]), dtype=torch.float32, device=views_t.device)
    return _launch_q8(views_t, wq, sw, n1, out_size, t=t), t


eps_fwd_q8.launches = 0
eps_fwd_q8.t_launches = 0


# ---------------------------------------------------------------------------
# serving


def eps_apply_t_q8(
    wq: torch.Tensor, sw: torch.Tensor, xT: torch.Tensor, out_size: int, kernel_size: int,
    n1: int, merge_pairs: bool, fwd=eps_fwd_q8,
) -> torch.Tensor:
    """One EPS layer's int8 serving forward (``eps_pallas_apply_t_q8``,
    eps_pallas_q8.py:167): ``xT`` (C, Q, H, W, B) → ``outT`` (O, H', W', B),
    ``wq``/``sw`` quantized under the same (n1, merge_pairs) plan. ``fwd``
    is ``eps_fwd_q8`` unless a caller runs the plain version on purpose."""
    c, q, h, w, b = xT.shape
    _, _, n1_k = _kernel_dims(c, q, kernel_size, n1, merge_pairs)
    views_t, _ = _stack_views_from_xT(xT, kernel_size, merge_pairs)
    out = fwd(views_t, wq, sw, n1_k, out_size)
    return out.reshape(out_size, h - kernel_size + 1, w - kernel_size + 1, b)


def quantize_fast_params(fast):
    """Fast (cmt) parameters → the int8 serving parameters
    ``{"epses_q": (wq, …), "epses_scale": (sw, …), "linear": {…}}``; the
    classifier stays f32."""
    wqs, sws = zip(*(quantize_cmt(c) for c in fast["epses_cmt"]))
    return {"epses_q": tuple(wqs), "epses_scale": tuple(sws), "linear": dict(fast["linear"])}


def quantize_reference_params(params, cfg):
    """Reference-layout parameters → (int8 serving parameters, plans)."""
    from ..models.eps_plus_linear import fast_params_from_reference

    fast, plans = fast_params_from_reference(params, cfg)
    return quantize_fast_params(fast), plans


# ---------------------------------------------------------------------------
# QAT


def _quantized_fwd(q8_fwd):
    """An ``EPSKernels.fwd`` that quantizes the live f32 cmt and runs
    ``q8_fwd`` (the kernel or its plain version)."""

    def fwd(views_t, cmt, n1, out_size, save_t=False):
        wq, sw = quantize_cmt(cmt)
        return q8_fwd(views_t, wq, sw, n1, out_size, save_t)

    return fwd


QAT_KERNELS = EPSKernels(
    _quantized_fwd(eps_fwd_q8), eps_dcore, eps_dviews_t, eps_dviews_recompute
)
QAT_PLAIN = EPSKernels(
    _quantized_fwd(eps_fwd_q8_reference), eps_dcore_reference, eps_dviews_t_reference,
    eps_dviews_recompute_reference,
)

