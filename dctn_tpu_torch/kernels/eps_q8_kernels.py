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
``save_t`` it also writes the dequantized t (K9), in float32 or, with
``t_dtype=torch.bfloat16``, in bf16 (the float32 t rounded to nearest even,
as the JAX QAT step stores it in its operand dtype, eps_pallas_q8.py:297).
The quantizers of the weights stay torch ops on the card: they run outside
the TPU kernel too.

The plain version is written so that the kernel's uq, int32 t and saved t
equal it bit for bit: true division everywhere (torch's CUDA division by a
Python scalar multiplies by its reciprocal instead), round half to even,
and an exact integer product (an int8 ``torch.mm`` would wrap, and CUDA has
no integer matmul: float64 on every device, exact below 2⁵³, and far faster
on the CPU than an int32 matmul).

QAT: ``QAT_KERNELS`` and ``QAT_PLAIN`` are ``EPSKernels`` bundles (marked
``quantizes``) whose forward quantizes the live f32 cmt and runs the int8
forward; their backward is the operand dtype's (``eps_dcore``,
``eps_dviews_t``) on the cmt in that dtype, fed the dequantized t when one
was saved, or recomputing t from the cmt when none was
(``eps_dviews_recompute``, as the JAX STE backward does,
eps_pallas_q8.py:262-268, :317-330), so ``EPSApplyTCmt`` gives the
straight-through backward unchanged. In the bf16 mode ``EPSApplyTCmt``
hands the forward the float32 cmt (JAX quantizes ``cmt32``,
eps_pallas_q8.py:293: quantizing the bf16-rounded core would change
``sw`` and ``wq``, and the forward would no longer be int8 serving's) with
``t_dtype`` bf16, and the backward the bf16-rounded copy, so the QAT
forward's logits are the float32 QAT step's bit for bit. ``plan_backward`` picks each
layer's arm as it does for the f32 forward (the JAX package's
``qat_save_decision`` is the same rule). Because the arm changes the STE
gradient (a saved dequantized t, or t recomputed in f32), a data-parallel
QAT step decides it on the global pixel count: ``eps_apply_t_cmt``'s
``pixel_scale`` is the rank count there (``parallel.data_parallel``), so
every rank takes the arm one device takes on the whole batch.
"""

from __future__ import annotations

import functools

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
# csrc/eps_fwd_q8.cu's tiling. The wgmma kernel: pixels per CTA (M), rows of
# Z per N tile (N), A bytes per ring stage, ring stages, rows of t staged per
# N tile (and their stride in floats), the most rows of u's suffix table T and
# the most factors left of it. The mma.sync kernel: pixels per CTA, A columns
# per step, rows of Z per block, staged rows per warp.
_WG_TILE_P = 128
_WG_TILE_N = 256
_WG_STEP_K = 64
_WG_STAGES = 5
_WG_STAGED_ROWS = 128
_WG_STAGED_STRIDE = _WG_TILE_P + 4
_WG_MAX_T = 64
_WG_MAX_LEAD = 4
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
    save_t: bool = False, t_dtype=None,
):
    """The int8 forward kernel's plain PyTorch version: (n, q, npix) f32
    views, the (Z, A) int8 wq and its (Z, 1) scales → (O, npix), and the
    dequantized t (Z, npix) too when ``save_t``, in ``t_dtype`` (None:
    float32; bf16: the float32 t rounded to nearest even; ``out`` is summed
    from the float32 t either way)."""
    n, _, npix = views_t.shape
    uq, su = _quantize_columns(_suffix_chain(views_t, 0, n1)[0])
    t = (_int_matmul(wq, uq).to(torch.float32) * sw) * su
    if n1 == n:
        out = t
    else:
        v = _suffix_chain(views_t, n1, n)[0]
        out = torch.sum(t.reshape(out_size, -1, npix) * v[None], dim=1)
    return (out, t.to(_t_dtype(t_dtype))) if save_t else out


# ---------------------------------------------------------------------------
# the kernel's wrapper


def _t_dtype(t_dtype) -> torch.dtype:
    """K9's storage dtype of t: float32 (None) or bf16; anything else
    raises."""
    if t_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"eps_fwd_q8 stores t in float32 or bfloat16, not {t_dtype!r}")
    return torch.float32 if t_dtype is None else t_dtype


def _align128(x: int) -> int:
    return -(-x // 128) * 128


@functools.lru_cache(maxsize=256)
def _q8_plan(n: int, q: int, n1: int, out_size: int, npix: int) -> dict:
    """One ``eps_fwd_q8`` launch (``make_plan`` in csrc/eps_fwd_q8.cu), from
    the shape alone. ``form`` is "wgmma" where A is a multiple of 4, u has at
    most 8 factors left of its suffix table, the sum over b has a route (in
    registers where B2 is a multiple of 8 and v's trailing factors make 8 or
    16 rows; else on a staged t tile, B2 ≤ 128) and the shared memory fits;
    else "mma.sync". wgmma: ``grid`` 128-pixel tiles, ``tiles`` N tiles of
    ``n`` = 256 rows along Z, each ``outputs`` whole outputs (or one output
    in ``passes`` tiles), wq through a ring of ``stages``. mma.sync: 64-pixel
    tiles, Z in blocks of ``n`` = 128 rows. ``smem_bytes``: the form's
    shared memory."""
    a, b2, n2 = q**n1, q ** (n - n1), n - n1
    a_pad = -(-a // _WG_STEP_K) * _WG_STEP_K
    lt = 1
    t_cap = min(max(16, a // 4), _WG_MAX_T)
    while lt < n1 and q ** (lt + 1) <= t_cap:
        lt += 1
    l2 = 0
    while l2 < n2 and q**l2 < 8:
        l2 += 1
    s2 = q**l2
    regs = b2 % 8 == 0 and s2 in (8, 16)
    if regs and b2 > _WG_TILE_N:
        outs, passes = 1, -(-b2 // _WG_TILE_N)
        tiles = out_size * passes
    else:
        outs, passes = min((_WG_TILE_N if regs else _WG_STAGED_ROWS) // b2, out_size), 1
        tiles = -(-out_size // outs) if outs else 0
    ring = _WG_STAGES * _WG_TILE_N * _WG_STEP_K
    staged = 0 if regs else 4 * _WG_STAGED_ROWS * _WG_STAGED_STRIDE
    row = 4 * _WG_TILE_P
    vrows = b2 // s2 + s2 if regs else (b2 if n2 else 0)
    t_rows = q**lt if lt >= 2 else 0  # the factor rows, T and their digit codes
    prologue = (n * q + t_rows) * row + 4 * (t_rows + vrows)
    off_v = _align128(_align128(a_pad * _WG_TILE_P) + max(ring + staged, prologue))
    # su, sw of two N tiles, the ring's full and empty barriers
    wgmma_bytes = off_v + vrows * row + row + 2 * _WG_TILE_N * 4 + 2 * _WG_STAGES * 8
    if a % 4 == 0 and n1 - lt <= _WG_MAX_LEAD and outs > 0 and wgmma_bytes <= _MAX_SMEM_BYTES:
        return {"form": "wgmma", "grid": (-(-npix // _WG_TILE_P),), "n": _WG_TILE_N,
                "outputs": outs, "passes": passes, "tiles": tiles, "stages": _WG_STAGES,
                "route": "registers" if regs else "staged", "smem_bytes": wgmma_bytes}
    units = 8 if b2 % _ROWS_PER_WARP == 0 else _BLOCK_ROWS
    floats = n * q * _TILE_PIX + 3 * _TILE_PIX + units * (_TILE_PIX + 8)
    uq_offset = -(-4 * (floats + a + b2) // 16) * 16
    return {"form": "mma.sync", "grid": (-(-npix // _TILE_PIX),), "n": _BLOCK_ROWS,
            "outputs": None, "passes": None, "tiles": -(-out_size * b2 // _BLOCK_ROWS),
            "stages": 1, "route": None,
            "smem_bytes": uq_offset + _TILE_PIX * (-(-a // _STEP_K) * _STEP_K + 64)}


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
    if b2 > _MAX_B2 or a * 127 * 127 >= 2**31:
        raise ValueError(
            f"eps_fwd_q8 kernel limits exceeded ({shape}): needs q^(n-n1)={b2} <= {_MAX_B2} "
            "and A·127² < 2³¹"
        )
    plan = _q8_plan(n, q, n1, out_size, npix)
    bits = (q - 1).bit_length()
    if plan["form"] == "mma.sync" and (bits * max(n1, n - n1) > 32 or plan["smem_bytes"] > _MAX_SMEM_BYTES):
        raise ValueError(
            f"eps_fwd_q8 kernel limits exceeded ({shape}): neither form takes it; the mma.sync "
            f"kernel needs digits in 32 bits and {plan['smem_bytes']} B of shared memory "
            f"<= {_MAX_SMEM_BYTES}"
        )
    if tuple(wq.shape) != (out_size * b2, a) or tuple(sw.shape) != (out_size * b2, 1):
        raise ValueError(f"eps_fwd_q8: wq is not (O·q^(n-n1), q^n1) or sw not (Z, 1) ({shape})")


def _launch_q8(views_t, wq, sw, n1: int, out_size: int, t=None, su=None) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors (``t`` (Z, npix), float32
    or bf16, and ``su`` (npix,) are written when given); counts it in
    ``eps_fwd_q8.launches`` and, with ``t``, ``eps_fwd_q8.t_launches``, a
    bf16 t also in ``eps_fwd_q8.bf16_t_launches``."""
    _check_device("eps_fwd_q8", views_t)
    _check_q8_args(views_t, wq, sw, n1, out_size)
    n, q, npix = views_t.shape
    dev = views_t.device
    bf16_t = t is not None and t.dtype == torch.bfloat16
    if t is not None and (t.dtype not in (torch.float32, torch.bfloat16) or not t.is_contiguous()
                          or tuple(t.shape) != (wq.shape[0], npix) or t.device != dev):
        raise ValueError(f"eps_fwd_q8: t must be a contiguous float32 or bfloat16 (Z, npix) = "
                         f"{(wq.shape[0], npix)} tensor on {dev}, not {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    out = torch.empty((out_size, npix), dtype=torch.float32, device=dev)
    lib = _library("eps_fwd_q8")
    entry = lib.dctn_eps_fwd_q8_t_bf16 if bf16_t else lib.dctn_eps_fwd_q8
    with torch.cuda.device(dev):
        err = entry(
            views_t.data_ptr(), wq.data_ptr(), sw.data_ptr(), out.data_ptr(),
            None if t is None else t.data_ptr(), None if su is None else su.data_ptr(),
            n, q, n1, out_size, npix, _stream(dev),
        )
    _raise_on_error("eps_fwd_q8", err)
    eps_fwd_q8.launches += 1
    eps_fwd_q8.t_launches += t is not None
    eps_fwd_q8.bf16_t_launches += bf16_t
    return out


def eps_fwd_q8(
    views_t: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, n1: int, out_size: int,
    save_t: bool = False, t_dtype=None,
):
    """One EPS layer's int8 forward on the factor stack: (n, q, npix) f32
    views, the (Z, A) int8 wq and its (Z, 1) f32 scales → (O, npix), and the
    dequantized t (Z, npix) too when ``save_t``, stored in ``t_dtype``
    (None: float32; bf16: rounded to nearest even from the float32 t, which
    ``out`` is summed from either way). CPU tensors run
    ``eps_fwd_q8_reference``; CUDA tensors run the kernel:
    ``eps_fwd_q8.launches`` counts its launches, ``eps_fwd_q8.t_launches``
    those that wrote t and ``eps_fwd_q8.bf16_t_launches`` those that wrote
    it in bf16."""
    t_dtype = _t_dtype(t_dtype)
    if views_t.device.type == "cpu":
        return eps_fwd_q8_reference(views_t, wq, sw, n1, out_size, save_t, t_dtype)
    if not save_t:
        return _launch_q8(views_t, wq, sw, n1, out_size)
    t = torch.empty((wq.shape[0], views_t.shape[2]), dtype=t_dtype, device=views_t.device)
    return _launch_q8(views_t, wq, sw, n1, out_size, t=t), t


eps_fwd_q8.launches = 0
eps_fwd_q8.t_launches = 0
eps_fwd_q8.bf16_t_launches = 0


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


def quantize_reference_params(params, cfg, plans=None):
    """Reference-layout parameters → (int8 serving parameters, plans), the
    cores matricized under ``plans`` (default: ``fast_layer_plans``')."""
    from ..models.eps_plus_linear import fast_params_from_reference

    fast, plans = fast_params_from_reference(params, cfg, plans)
    return quantize_fast_params(fast), plans


# ---------------------------------------------------------------------------
# QAT


def _quantized_fwd(q8_fwd):
    """An ``EPSKernels.fwd`` that quantizes the live cmt (float32: the QAT
    bundles' ``EPSApplyTCmt`` passes the float32 parameter in every mode)
    and runs ``q8_fwd`` (the kernel or its plain version), t stored in
    ``t_dtype``."""

    def fwd(views_t, cmt, n1, out_size, save_t=False, t_dtype=None):
        wq, sw = quantize_cmt(cmt)
        return q8_fwd(views_t, wq, sw, n1, out_size, save_t, t_dtype)

    return fwd


QAT_KERNELS = EPSKernels(
    _quantized_fwd(eps_fwd_q8), eps_dcore, eps_dviews_t, eps_dviews_recompute, quantizes=True
)
QAT_PLAIN = EPSKernels(
    _quantized_fwd(eps_fwd_q8_reference), eps_dcore_reference, eps_dviews_t_reference,
    eps_dviews_recompute_reference, quantizes=True,
)

