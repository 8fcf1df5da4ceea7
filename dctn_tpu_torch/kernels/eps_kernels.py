"""Host side of the EPS kernels (port of ``dctn_tpu/pallas/eps_pallas.py``):
the forward, and the backward of the fast training step.

The layer works in the transposed batch-minor layout: ``xT`` (C, Q, H, W, B)
in, ``outT`` (O, H', W', B) out, the flat pixel index ``(h·W' + w)·B + b``.
The host builds the (n, q, npix) stack of window factors (merging q=2
factor pairs into q=4 ones, as the JAX plan does) and hands it, with the
core in its matricized (Z, A) "cmt" layout, to three contractions:

- ``eps_fwd``: the layer's output and, for training, its t = cmt·u
  (``csrc/eps_fwd.cu``, replacing ``_fwd_kernel_factory``, eps_pallas.py:227;
  its product in 3xTF32 on the tensor cores);
- ``eps_dcore``: d_cmt (``csrc/eps_dcore.cu``, replacing
  ``_dcore_kernel_factory``, :348, and the d_cmt half of
  ``_bwd_fused_t_kernel_factory``, :303);
- ``eps_dviews_t``: the factors' cotangents from the saved t
  (``csrc/eps_dviews_t.cu``, replacing the d_views half of
  ``_bwd_fused_t_kernel_factory``);
- ``eps_dviews_recompute``: the same cotangents with t recomputed in the
  kernel (the same source's recompute form, replacing the d_views half of
  ``_bwd_fused_kernel_factory``, K4, :254, and ``_dviews_kernel_factory``
  without t, K6, :391).

Each has a bf16 operand mode (the JAX package's ``mm_dtype`` of bfloat16,
eps_pallas.py:227-391): the Khatri-Rao operands (u, and kr2 = g ⊗ v) are
formed in float32 and rounded to bf16, cmt is read as bf16, one bf16
product per pair on the tensor cores (``csrc/bf16.cuh``), every sum in
float32; the forward's epilogue reads the unrounded t and a float32 v, and
the saved t is stored in bf16. The mode follows cmt's dtype (``eps_dcore``,
which takes no cmt, takes ``mm_dtype``), as the TPU kernel's ``md =
cmt_ref.dtype`` does; float32 cmt is the 3xTF32 mode, bf16 cmt the bf16
one. The bf16 kernels are their own launches, counted in ``bf16_launches``
(``bf16_t_launches`` for K1 with t), beside the float32 counters.

On a CPU tensor each wrapper runs its plain PyTorch version (``*_reference``);
on a CUDA tensor it launches its hand-written kernel or raises. There is no
fallback. ``KERNELS`` and ``PLAIN`` bundle the four for the callers that
choose between them; ``eps_q8_kernels`` adds the int8 forward and its QAT
bundles. ``EPSApplyTCmt`` is the layer's
``torch.autograd.Function``; ``plan_backward`` picks its backward arm.

Unlike the JAX host glue, the factor stack is not padded to a tile
multiple: the kernels mask their ragged last pixel tile themselves. The TPU
VMEM planners (``pallas_forward_fits``, ``_largest_bn``, ``_dcore_plan``,
``_*_bytes``) have no counterpart; each wrapper checks its kernel's own
limits instead.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, List, Optional, Tuple

import torch

from . import build

# the kernels' limits (csrc/eps_fwd.cu, eps_dcore.cu, eps_dviews_t.cu)
_MAX_B2 = 512
_MAX_FACTOR_ROWS = 256
_MAX_OUT_SIZE = 65535
_MAX_SMEM_BYTES = 227 * 1024
_DCORE_TILE = 128
_DCORE_MAX_SLICES = 64
# eps_fwd's tiles (csrc/eps_fwd.cu): a CTA takes 128 pixels and the rows of
# whole outputs, 128 rows of Z per pass, 32 columns of A per step; u's
# Kronecker split takes trailing digits up to 16 values, as eps_dcore's
_FWD_TILE_Z = 128
_FWD_TILE_P = 128
_FWD_CHUNK_A = 32
# eps_dcore splits the pixels of a layer whose 128 x 128 (Z, A) tiles would
# leave more than half of the card's SMs idle (an H100 SXM has 132): into as
# many slices as make about two CTAs per SM (two fit beside each other, so
# one's operand build runs beside the other's product), each slice at least
# 1024 pixels long. A layer with more tiles (the flagship's layer 1: 96)
# takes one slice and no sum.
_DCORE_MIN_SLICE_PIXELS = 1024
# X rows of eps_dcore's Kronecker build split off trailing digits up to this
# many values (csrc/eps_dcore.cu, kMaxKron)
_DCORE_MAX_KRON = 16
# The backward reads a forward-saved t when A = q_k^n1_k is at least this:
# the JAX package's default (DCTN_TPU_SAVE_T_MIN_A, eps_pallas.py:810), set
# for the TPU's bf16 rate against its HBM. In float32 on an H100 the saved t
# (8·Z bytes per pixel, written and read) costs less than its recompute
# (2·Z·A flops per pixel) already from A ≈ 80 (67 TFLOP/s against
# 3.35 TB/s); the port keeps 512 so that both packages take the same arm,
# until the Hopper break-even is measured.
SAVE_T_MIN_A = 512
# ... and only while the saved t, Z·npix float32 entries, stays within this
# footprint: the JAX package's cap (DCTN_TPU_SAVE_T_MAX_BYTES, 4 GiB,
# eps_pallas.py:814); beyond it the layer takes the recompute arm
SAVE_T_MAX_BYTES = 4 << 30
# the operand dtypes of the kernels: None (float32 in 3xTF32) or bf16
OPERAND_DTYPES = (None, torch.bfloat16)
# where the bf16 kernels' plans and their limits are written down
BF16_ITEM = "ROADMAP, the bf16 plans' limits"


def operand_dtype(mm_dtype) -> torch.dtype:
    """The dtype the products read: float32 for None (3xTF32) or bf16;
    anything else raises."""
    if mm_dtype not in OPERAND_DTYPES:
        raise ValueError(f"the EPS kernels take compute dtype None or torch.bfloat16, not {mm_dtype!r}")
    return torch.float32 if mm_dtype is None else mm_dtype


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest even) and back to its dtype where
    ``dtype`` is bf16: the products of two such operands are exact in
    float32, so a float32 matmul of them sums in float32 what a bf16
    tensor-core product does (a bf16 ``torch.matmul`` accumulates
    otherwise). ``x`` itself for any other ``dtype``."""
    return x.to(dtype).to(x.dtype) if dtype == torch.bfloat16 else x


def _up(x: torch.Tensor) -> torch.Tensor:
    """A bf16 operand (cmt, a saved t) in float32; any other as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


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
    padding). Plain torch ops: under autograd their backward is the
    unmerge and sum of window cotangents of ``_dxT_from_dviews_t``
    (eps_pallas.py:669-701)."""
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


def plan_backward(
    layer_index: int, n_k: int, n1_k: int, q_k: int, out_size: int, npix: int,
    t_bytes: int = 4,
) -> str:
    """The backward arm of one layer (``_save_t_plan`` and ``_bwd_dispatch``,
    eps_pallas.py:794-894, without the VMEM planning and without padding
    npix to a tile: the port's kernels mask their last tile):

    - ``"dcore_only"``: the model's first layer, whose input needs no
      gradient (the JAX ``force_two_pass``, whose d_views pass XLA drops):
      ``eps_dcore`` alone;
    - ``"saved_t"``: n2 > 0, A = q_k^n1_k ≥ ``SAVE_T_MIN_A`` and t's
      footprint Z·npix·``t_bytes`` ≤ ``SAVE_T_MAX_BYTES``: the forward
      writes t, the backward runs ``eps_dcore`` and ``eps_dviews_t``.
      ``t_bytes`` is t's storage size, the operand dtype's (4 for float32,
      2 for bf16), as the JAX cap counts it (eps_pallas.py:820-823);
    - ``"recompute"``: anything else (K4/K6): the forward writes no t, the
      backward runs ``eps_dcore`` and ``eps_dviews_recompute``.

    The f32 and the int8 (QAT) forward take the same arm: the JAX
    package's ``qat_save_decision`` (eps_pallas_q8.py:228) is this rule.
    """
    if layer_index == 0:
        return "dcore_only"
    n2 = n_k - n1_k
    z = out_size * q_k**n2
    if n2 > 0 and q_k**n1_k >= SAVE_T_MIN_A and z * npix * t_bytes <= SAVE_T_MAX_BYTES:
        return "saved_t"
    return "recompute"


# ---------------------------------------------------------------------------
# plain PyTorch versions of the kernels


def _suffix_chain(views_t: torch.Tensor, start: int, stop: int) -> List[torch.Tensor]:
    """Suffix Khatri-Rao products over the (q, npix) factors: entry k-start
    is f_k ⊗ … ⊗ f_{stop-1} (f_k slowest), built from the back as the TPU
    kernel's ``_suffix_chain`` does; entry 0 is the whole product."""
    sufs = [views_t[stop - 1]]
    for k in range(stop - 2, start - 1, -1):
        s = sufs[0]
        sufs.insert(0, (views_t[k][:, None, :] * s[None, :, :]).reshape(-1, s.shape[-1]))
    return sufs


def _kr2(views_t: torch.Tensor, g: torch.Tensor, n1: int) -> torch.Tensor:
    """kr2[(o, b), p] = g[o, p]·v[b, p], o slowest like cmt's rows (g when
    every factor is in u)."""
    n, _, npix = views_t.shape
    if n1 == n:
        return g
    v = _suffix_chain(views_t, n1, n)[0]
    return (g[:, None, :] * v[None, :, :]).reshape(-1, npix)


def _chain_bwd(views_t, sufs, d, start: int, stop: int) -> List[torch.Tensor]:
    """The front-peel sweep of the TPU kernel's ``_chain_bwd``
    (eps_pallas.py:206-224): the cotangent of each factor f_start … f_{stop-1}
    from that of their Khatri-Rao product. No division, so zero factors
    are fine."""
    out = []
    for k in range(start, stop - 1):
        f = views_t[k]
        d3 = d.reshape(f.shape[0], -1, d.shape[-1])
        out.append(torch.sum(d3 * sufs[k - start + 1][None], dim=1))
        d = torch.sum(d3 * f[:, None, :], dim=0)
    out.append(d)
    return out


def _fwd_t(views_t: torch.Tensor, cmt: torch.Tensor, n1: int) -> torch.Tensor:
    """t = cmt·u in float32, unrounded: u built in float32 and rounded to
    cmt's dtype (eps_pallas.py:237)."""
    u = _suffix_chain(views_t, 0, n1)[0]
    return _up(cmt) @ _round(u, cmt.dtype)


def eps_fwd_reference(
    views_t: torch.Tensor, cmt: torch.Tensor, n1: int, out_size: int,
    save_t: bool = False,
):
    """The forward kernel's plain PyTorch version: u from the first n1
    factors, t = cmt @ u, then out[o, p] = Σ_b t[(o, b), p]·v[b, p] (out = t
    when every factor is in u). (n, q, npix), (Z, A) → (O, npix), and t
    (Z, npix) too when ``save_t``. A bf16 cmt is the bf16 mode: u rounded to
    bf16, the epilogue on the unrounded t and the float32 v, t returned in
    bf16 (eps_pallas.py:227-250)."""
    n, q, npix = views_t.shape
    t = _fwd_t(views_t, cmt, n1)
    if n1 == n:
        out = t
    else:
        v = _suffix_chain(views_t, n1, n)[0]
        out = torch.sum(t.reshape(out_size, q ** (n - n1), npix) * v[None], dim=1)
    return (out, t.to(cmt.dtype)) if save_t else out


def eps_dcore_reference(
    views_t: torch.Tensor, g: torch.Tensor, n1: int, out_size: int, mm_dtype=None
) -> torch.Tensor:
    """The d_cmt kernel's plain version: d_cmt[z, a] = Σ_p kr2[z, p]·u[a, p].
    (n, q, npix), (O, npix) → (Z, A), float32. ``mm_dtype`` bf16 rounds kr2
    and u (eps_pallas.py:372-376)."""
    del out_size  # rows follow g
    md = operand_dtype(mm_dtype)
    return _round(_kr2(views_t, g, n1), md) @ _round(_suffix_chain(views_t, 0, n1)[0], md).T


def eps_dviews_t_reference(
    views_t: torch.Tensor, cmt: torch.Tensor, g: torch.Tensor,
    t: Optional[torch.Tensor], n1: int, out_size: int,
) -> torch.Tensor:
    """The d_views kernel's plain version: d_u = cmtᵀ·kr2 and
    d_v[b, p] = Σ_o t[(o, b), p]·g[o, p], each through ``_chain_bwd`` to its
    factors. ``t`` is None when n2 = 0. → (n, q, npix). A bf16 cmt rounds
    kr2; a bf16 t is read as float32 (eps_pallas.py:303-345)."""
    n, _, npix = views_t.shape
    d_u = _up(cmt).T @ _round(_kr2(views_t, g, n1), cmt.dtype)
    dviews = _chain_bwd(views_t, _suffix_chain(views_t, 0, n1), d_u, 0, n1)
    if n1 < n:
        d_v = torch.sum(_up(t).reshape(out_size, -1, npix) * g[:, None, :], dim=0)
        dviews += _chain_bwd(views_t, _suffix_chain(views_t, n1, n), d_v, n1, n)
    return torch.stack(dviews, dim=0)


def eps_dviews_recompute_reference(
    views_t: torch.Tensor, cmt: torch.Tensor, g: torch.Tensor, n1: int, out_size: int
) -> torch.Tensor:
    """The recompute arm's d_views (K4 ``_bwd_fused_kernel_factory``'s half,
    K6 ``_dviews_kernel_factory`` without t), plain: t recomputed, in
    float32 and unrounded in the bf16 mode too (eps_pallas.py:294)."""
    t = _fwd_t(views_t, cmt, n1) if n1 < views_t.shape[0] else None
    return eps_dviews_t_reference(views_t, cmt, g, t, n1, out_size)


# ---------------------------------------------------------------------------
# the kernels' wrappers


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C entries of each source, with their signatures: pointers and the
# stream as c_void_p
_ENTRIES = {
    "eps_fwd": {
        "dctn_eps_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _P],
        "dctn_eps_fwd_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _P],
    },
    "eps_dcore": {
        "dctn_eps_dcore": [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _I, _P],
        "dctn_eps_dcore_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _I, _P],
    },
    "eps_dviews_t": {
        "dctn_eps_dviews_t": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _P],
        "dctn_eps_dviews_recompute": [_P, _P, _P, _P, _I, _I, _I, _I, _LL, _P],
        "dctn_eps_dviews_t_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _P],
        "dctn_eps_dviews_recompute_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _P],
    },
    "eps_fwd_q8": {
        "dctn_eps_fwd_q8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _P],
        "dctn_eps_fwd_q8_t_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _P],
    },
}


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``, with its C
    entries' signatures."""
    lib = build.load_library(name)
    for entry, argtypes in _ENTRIES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_tensors(name: str, shape: str, device, dtype=torch.float32, **tensors) -> None:
    """``dtype``, contiguous, all on ``device``."""
    for key, x in tensors.items():
        if x.dtype != dtype:
            raise ValueError(f"{name} kernel takes {dtype}, got {key} {x.dtype} ({shape})")
        if x.device != device:
            raise ValueError(f"{name}: {key} on {x.device}, views on {device} ({shape})")
        if not x.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors, {key} is not ({shape})")


def _check_split(name: str, shape: str, n: int, q: int, n1: int) -> None:
    if not 1 <= n1 <= n:
        raise ValueError(f"{name}: split n1 outside [1, n] ({shape})")
    if n * q > _MAX_FACTOR_ROWS:
        raise ValueError(
            f"{name} kernel limits exceeded ({shape}): needs n·q={n * q} "
            f"<= {_MAX_FACTOR_ROWS}"
        )


def _fwd_plan(n: int, q: int, n1: int, out_size: int, npix: int) -> dict:
    """One ``eps_fwd`` launch (``make_plan`` in csrc/eps_fwd.cu): each CTA
    owns 128 pixels and ``outputs`` whole outputs (⌊128 / B2⌋ where B2 ≤ 128,
    else one, whose B2 rows it walks in ``passes`` of 128); ``grid`` is
    (pixel tiles, Z tiles). u = X·Y with Y the product of u's lv trailing
    factors (s = q^lv ≤ 16 values). ``kernel`` is "wgmma" where s % 4 == 0
    and its shared memory fits, else "mma.sync". Shared memory of both: the
    staged factor rows, 132 floats apart, and each pass row's v digits (n2
    ints); the mma.sync kernel's Y (s rows) and the larger of its two cmt
    stages (128 × 40) with two buffers of the X rows a step of 32 columns
    spans and the 128 × 136 epilogue tile; the wgmma kernel's pixel-major Y
    (128 × (s + 4 or s + 8)), the larger of two steps' operand planes (4 ×
    128 × 32 each) and the epilogue tile, and three raw cmt stages (128 ×
    36)."""
    b2 = q ** (n - n1)
    lv = 0
    while lv < n1 and q ** (lv + 1) <= _DCORE_MAX_KRON:
        lv += 1
    s = q**lv
    x_rows = (s - 1 + _FWD_CHUNK_A - 1) // s + 1
    outputs = min(_FWD_TILE_Z // b2, out_size) if b2 <= _FWD_TILE_Z else 1
    epi = _FWD_TILE_Z * 136
    common = n * q * 132 + _FWD_TILE_Z * (n - n1)
    mma = 4 * (common + s * 132 + max(2 * _FWD_TILE_Z * 40 + 2 * x_rows * 132, epi))
    wgmma = 4 * (common + _FWD_TILE_P * (s + (4 if s % 8 == 0 else 8))
                 + max(2 * 4 * _FWD_TILE_Z * _FWD_CHUNK_A, epi) + 3 * _FWD_TILE_Z * 36)
    kernel = "wgmma" if s % 4 == 0 and wgmma <= _MAX_SMEM_BYTES else "mma.sync"
    return {
        "outputs": outputs,
        "passes": math.ceil(outputs * b2 / _FWD_TILE_Z),
        "grid": (math.ceil(npix / _FWD_TILE_P), math.ceil(out_size / outputs)),
        "kernel": kernel,
        "smem_bytes": wgmma if kernel == "wgmma" else mma,
    }


def _check_kernel_args(views_t, cmt, n1, out_size):
    n, q, npix = views_t.shape
    shape = f"views {tuple(views_t.shape)}, cmt {tuple(cmt.shape)}, n1={n1}, O={out_size}"
    _check_tensors("eps_fwd", shape, views_t.device, views=views_t, cmt=cmt)
    _check_split("eps_fwd", shape, n, q, n1)
    b2 = q ** (n - n1)
    if b2 > _MAX_B2 or out_size > _MAX_OUT_SIZE:
        raise ValueError(
            f"eps_fwd kernel limits exceeded ({shape}): needs q^(n-n1)={b2} "
            f"<= {_MAX_B2}, O <= {_MAX_OUT_SIZE}"
        )
    if tuple(cmt.shape) != (out_size * b2, q**n1):
        raise ValueError(f"eps_fwd: cmt is not (O·q^(n-n1), q^n1) ({shape})")
    smem = _fwd_plan(n, q, n1, out_size, npix)["smem_bytes"]
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"eps_fwd kernel limits exceeded ({shape}): needs {smem} B of "
            f"shared memory > {_MAX_SMEM_BYTES}"
        )


# The bf16 mode's kernels (csrc/bf16.cuh; the *_bf16 entries of eps_fwd.cu,
# eps_dcore.cu and eps_dviews_t.cu): mma.sync.m16n8k16 on bf16 operands
# staged in shared memory with rows of K / 2 + 4 words (a k16 step's
# fragments then read without bank conflicts: ``op_words``), float32 rows 4
# floats longer than their tile.


def _op_words(chunk: int) -> int:
    return chunk // 2 + 4


# K1: a CTA takes 64 pixels and a Z tile of whole outputs, 64 rows of Z per
# pass, 64 columns of A per step
_BF16_FWD_TILE = 64
_BF16_FWD_CHUNK = 64
# eps_dcore: 64 x 64 (Z, A) tiles over steps of 32 pixels, pixel slices as
# the float32 kernel's, aiming at four CTAs per SM, each slice at least
# this long
_BF16_DCORE_TILE = 64
_BF16_DCORE_MIN_SLICE_PIXELS = 2048
# d_views: a CTA takes 32 pixels; d_u in tiles of 128 rows of A and, on the
# recompute arm, t in tiles of 128 rows of Z, both over steps of 128; the
# factors' cotangents summed by four thread quarters apart; the
# leave-one-out products over at most this many factors of a half
_BF16_DVIEWS_TILE_P = 32
_BF16_DVIEWS_CHUNK = 128
_BF16_MAX_CHAIN = 8


def _fwd_bf16_plan(n: int, q: int, n1: int, out_size: int, npix: int) -> dict:
    """One bf16 ``eps_fwd`` launch (``make_plan_bf16`` in csrc/eps_fwd.cu):
    ``outputs`` whole outputs a CTA (⌊64 / B2⌋ where B2 ≤ 64, else one),
    walked in ``passes`` of 64 rows; shared memory: the staged factor rows
    (68 floats each), the 64 x 68 t tile, the outputs' sums and the two
    64-row operand tiles."""
    tile = _BF16_FWD_TILE
    b2 = q ** (n - n1)
    outputs = min(tile // b2, out_size) if b2 <= tile else 1
    rows = tile + 4
    return {
        "outputs": outputs,
        "passes": math.ceil(outputs * b2 / tile),
        "grid": (math.ceil(npix / tile), math.ceil(out_size / outputs)),
        "smem_bytes": 4 * (rows * (n * q + tile) + outputs * tile)
        + 4 * 2 * tile * _op_words(_BF16_FWD_CHUNK),
    }


def _dcore_bf16_smem_bytes(n: int, q: int, n1: int, out_size: int) -> int:
    """Shared memory of one bf16 ``eps_dcore`` launch (``smem_bytes`` in
    csrc/eps_dcore.cu): a step's factor rows and the g rows a Z tile
    touches (36 floats each), each tile row's factor-row offsets (n ints)
    and the two operand tiles."""
    tile = _BF16_DCORE_TILE
    g_rows = min(out_size, (tile - 1) // q ** (n - n1) + 2)
    return 4 * (36 * (n * q + g_rows) + tile * n) + 4 * 2 * tile * _op_words(32)


def _dcore_bf16_slices(z: int, a: int, npix: int, sms: int) -> int:
    """The pixel slices of a bf16 ``eps_dcore`` launch on ``sms`` SMs."""
    tiles = math.ceil(z / _BF16_DCORE_TILE) * math.ceil(a / _BF16_DCORE_TILE)
    return max(1, min(math.ceil(4 * sms / tiles), npix // _BF16_DCORE_MIN_SLICE_PIXELS,
                      _DCORE_MAX_SLICES))


def _dviews_bf16_smem_bytes(n: int, q: int, n1: int, out_size: int) -> int:
    """Shared memory of one bf16 d_views launch, either form
    (``smem_bytes`` in csrc/eps_dviews_t.cu): the staged factor rows, g, v
    and d_v (36 floats each), the four quarters' factor cotangents (32
    floats a row), the 128-row product tile, and the two operand tiles."""
    b2 = q ** (n - n1)
    tile_p = _BF16_DVIEWS_TILE_P
    return (4 * (36 * (n * q + out_size + 2 * b2 + 128) + 4 * n * q * tile_p)
            + 4 * (128 + tile_p) * _op_words(_BF16_DVIEWS_CHUNK))


def _check_bf16_plan(name: str, shape: str, smem: int, **limits) -> None:
    """Raises where a bf16 launch is outside its kernel's plan: shared
    memory over the card's 227 KB, or a ``limits`` entry (value, most)
    over its most. The bf16 mode never runs the float32 kernel or the
    plain version in its place."""
    over = [f"{k}={v} > {most}" for k, (v, most) in limits.items() if v > most]
    if smem > _MAX_SMEM_BYTES:
        over.append(f"{smem} B of shared memory > {_MAX_SMEM_BYTES}")
    if over:
        raise ValueError(
            f"{name}: bf16 operand mode outside its kernel's plan ({shape}): "
            f"{', '.join(over)} ({BF16_ITEM})"
        )


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def _check_device(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")


def eps_fwd(
    views_t: torch.Tensor, cmt: torch.Tensor, n1: int, out_size: int,
    save_t: bool = False,
):
    """One EPS layer's forward on the factor stack: (n, q, npix) views and
    the (Z, A) cmt → (O, npix), and t (Z, npix) too when ``save_t``. CPU
    tensors run ``eps_fwd_reference``; CUDA tensors run the kernel:
    ``eps_fwd.launches`` counts its launches and ``eps_fwd.t_launches``
    those that wrote t. A bf16 cmt runs the bf16 mode (t in bf16), counted
    in ``eps_fwd.bf16_launches`` and ``eps_fwd.bf16_t_launches``."""
    if views_t.device.type == "cpu":
        return eps_fwd_reference(views_t, cmt, n1, out_size, save_t)
    _check_device("eps_fwd", views_t)
    if cmt.dtype == torch.bfloat16:
        return _eps_fwd_bf16(views_t, cmt, n1, out_size, save_t)
    _check_kernel_args(views_t, cmt, n1, out_size)
    n, q, npix = views_t.shape
    dev = views_t.device
    out = torch.empty((out_size, npix), dtype=torch.float32, device=dev)
    t = torch.empty((cmt.shape[0], npix), dtype=torch.float32, device=dev) if save_t else None
    with torch.cuda.device(dev):
        err = _library("eps_fwd").dctn_eps_fwd(
            views_t.data_ptr(), cmt.data_ptr(), out.data_ptr(),
            None if t is None else t.data_ptr(), n, q, n1, out_size, npix, _stream(dev),
        )
    _raise_on_error("eps_fwd", err)
    eps_fwd.launches += 1
    if save_t:
        eps_fwd.t_launches += 1
        return out, t
    return out


def _check_fwd_bf16_args(views_t, cmt, n1, out_size):
    """The arguments of ``eps_fwd``'s bf16 mode: float32 views, bf16 cmt,
    within ``_fwd_bf16_plan``."""
    n, q, npix = views_t.shape
    shape = f"views {tuple(views_t.shape)}, cmt {tuple(cmt.shape)}, n1={n1}, O={out_size}"
    _check_tensors("eps_fwd", shape, views_t.device, views=views_t)
    _check_tensors("eps_fwd", shape, views_t.device, torch.bfloat16, cmt=cmt)
    _check_split("eps_fwd", shape, n, q, n1)
    b2 = q ** (n - n1)
    if tuple(cmt.shape) != (out_size * b2, q**n1):
        raise ValueError(f"eps_fwd: cmt is not (O·q^(n-n1), q^n1) ({shape})")
    plan = _fwd_bf16_plan(n, q, n1, out_size, npix)
    _check_bf16_plan("eps_fwd", shape, plan["smem_bytes"], **{
        "q^(n-n1)": (b2, _MAX_B2), "Z tiles": (plan["grid"][1], _MAX_OUT_SIZE)})


def _eps_fwd_bf16(views_t, cmt, n1, out_size, save_t):
    """``eps_fwd``'s bf16 mode on CUDA tensors."""
    _check_fwd_bf16_args(views_t, cmt, n1, out_size)
    n, q, npix = views_t.shape
    dev = views_t.device
    out = torch.empty((out_size, npix), dtype=torch.float32, device=dev)
    t = torch.empty((cmt.shape[0], npix), dtype=torch.bfloat16, device=dev) if save_t else None
    with torch.cuda.device(dev):
        err = _library("eps_fwd").dctn_eps_fwd_bf16(
            views_t.data_ptr(), cmt.data_ptr(), out.data_ptr(),
            None if t is None else t.data_ptr(), n, q, n1, out_size, npix, _stream(dev),
        )
    _raise_on_error("eps_fwd (bf16)", err)
    eps_fwd.bf16_launches += 1
    if save_t:
        eps_fwd.bf16_t_launches += 1
        return out, t
    return out


eps_fwd.launches = 0
eps_fwd.t_launches = 0
eps_fwd.bf16_launches = 0
eps_fwd.bf16_t_launches = 0


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    """The SMs of the card ``dev``; ``eps_dcore`` plans its slices and its
    CTAs per SM by them."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _dcore_slices(z: int, a: int, npix: int, sms: int) -> int:
    """How many pixel ranges ``eps_dcore`` sums apart (then adds in a fixed
    order) on a card of ``sms`` SMs: 1 when the (Z, A) tiles fill more than
    half of them."""
    tiles = math.ceil(z / _DCORE_TILE) * math.ceil(a / _DCORE_TILE)
    if 2 * tiles > sms:
        return 1
    return max(1, min(
        2 * sms // tiles,
        npix // _DCORE_MIN_SLICE_PIXELS,
        _DCORE_MAX_SLICES,
    ))


def _dcore_smem_bytes(n: int, q: int, n1: int, out_size: int) -> int:
    """Shared memory of one ``eps_dcore`` launch (``make_plan`` in
    csrc/eps_dcore.cu): each of the 256 threads' 64 f32 totals; two stages
    of the staged factor rows, the g rows a Z tile touches, a row of ones
    and one of zeros (32 pixels each); two buffers of the Kronecker build's
    X and Y rows of both operands and a zero row (40 floats apart); and the
    staged rows each X, Y row multiplies."""

    def split(factors):  # (trailing digits lv, s = q^lv, X rows a tile spans)
        lv = 0
        while lv < factors and q ** (lv + 1) <= _DCORE_MAX_KRON:
            lv += 1
        return lv, q**lv, (_DCORE_TILE - 1) // q**lv + 2

    n2 = n - n1
    (lv_u, s_u, cx_u), (lv_k, s_k, cx_k) = split(n1), split(n2)
    g_rows = min(out_size, (_DCORE_TILE - 1) // q**n2 + 2)
    xy_rows = cx_u + s_u + cx_k + s_k
    floats = 256 * 64 + 2 * (n * q + g_rows + 2) * 32 + 2 * (xy_rows + 1) * 40
    return 4 * (floats + xy_rows * max(n1 - lv_u, lv_u, n2 - lv_k + 1, lv_k))


def _check_dcore_args(views_t, g, n1, out_size):
    n, q, npix = views_t.shape
    shape = f"views {tuple(views_t.shape)}, g {tuple(g.shape)}, n1={n1}, O={out_size}"
    _check_tensors("eps_dcore", shape, views_t.device, views=views_t, g=g)
    _check_split("eps_dcore", shape, n, q, n1)
    if tuple(g.shape) != (out_size, npix):
        raise ValueError(f"eps_dcore: g is not (O, npix) ({shape})")
    if math.ceil(out_size * q ** (n - n1) / _DCORE_TILE) > 65535:
        raise ValueError(f"eps_dcore kernel limits exceeded ({shape}): Z/128 > 65535")
    smem = _dcore_smem_bytes(n, q, n1, out_size)
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"eps_dcore kernel limits exceeded ({shape}): needs {smem} B of "
            f"shared memory > {_MAX_SMEM_BYTES}"
        )


def eps_dcore(
    views_t: torch.Tensor, g: torch.Tensor, n1: int, out_size: int, mm_dtype=None
) -> torch.Tensor:
    """d_cmt (Z, A) of one EPS layer from the (n, q, npix) views and the
    (O, npix) output cotangent, in float32. CPU tensors run
    ``eps_dcore_reference``; CUDA tensors run the kernel:
    ``eps_dcore.launches`` counts its calls, ``eps_dcore.sum_launches``
    those that also ran the fixed-order sum of pixel slices (a second
    device kernel of the same call). ``mm_dtype`` bf16 runs the bf16 mode,
    counted in ``eps_dcore.bf16_launches`` (``bf16_sum_launches``)."""
    bf16 = operand_dtype(mm_dtype) == torch.bfloat16
    if views_t.device.type == "cpu":
        if bf16:
            return eps_dcore_reference(views_t, g, n1, out_size, mm_dtype)
        return eps_dcore_reference(views_t, g, n1, out_size)
    _check_device("eps_dcore", views_t)
    if bf16:
        return _eps_dcore_bf16(views_t, g, n1, out_size)
    _check_dcore_args(views_t, g, n1, out_size)
    n, q, npix = views_t.shape
    dev = views_t.device
    z, a = out_size * q ** (n - n1), q**n1
    sms = _sm_count(dev)
    slices = _dcore_slices(z, a, npix, sms)
    d_cmt = torch.empty((z, a), dtype=torch.float32, device=dev)
    scratch = (
        torch.empty((slices, z, a), dtype=torch.float32, device=dev) if slices > 1 else None
    )
    with torch.cuda.device(dev):
        err = _library("eps_dcore").dctn_eps_dcore(
            views_t.data_ptr(), g.data_ptr(), d_cmt.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            n, q, n1, out_size, npix, slices, sms, _stream(dev),
        )
    _raise_on_error("eps_dcore", err)
    eps_dcore.launches += 1
    eps_dcore.sum_launches += slices > 1
    return d_cmt


def _check_dcore_bf16_args(views_t, g, n1, out_size):
    """The arguments of ``eps_dcore``'s bf16 mode."""
    n, q, npix = views_t.shape
    shape = f"views {tuple(views_t.shape)}, g {tuple(g.shape)}, n1={n1}, O={out_size}"
    _check_tensors("eps_dcore", shape, views_t.device, views=views_t, g=g)
    _check_split("eps_dcore", shape, n, q, n1)
    if tuple(g.shape) != (out_size, npix):
        raise ValueError(f"eps_dcore: g is not (O, npix) ({shape})")
    z = out_size * q ** (n - n1)
    _check_bf16_plan("eps_dcore", shape, _dcore_bf16_smem_bytes(n, q, n1, out_size),
                     **{"Z tiles": (math.ceil(z / _BF16_DCORE_TILE), 65535)})


def _eps_dcore_bf16(views_t, g, n1, out_size):
    """``eps_dcore``'s bf16 mode on CUDA tensors."""
    _check_dcore_bf16_args(views_t, g, n1, out_size)
    n, q, npix = views_t.shape
    z, a = out_size * q ** (n - n1), q**n1
    dev = views_t.device
    slices = _dcore_bf16_slices(z, a, npix, _sm_count(dev))
    d_cmt = torch.empty((z, a), dtype=torch.float32, device=dev)
    scratch = (
        torch.empty((slices, z, a), dtype=torch.float32, device=dev) if slices > 1 else None
    )
    with torch.cuda.device(dev):
        err = _library("eps_dcore").dctn_eps_dcore_bf16(
            views_t.data_ptr(), g.data_ptr(), d_cmt.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            n, q, n1, out_size, npix, slices, _stream(dev),
        )
    _raise_on_error("eps_dcore (bf16)", err)
    eps_dcore.bf16_launches += 1
    eps_dcore.bf16_sum_launches += slices > 1
    return d_cmt


eps_dcore.launches = 0
eps_dcore.sum_launches = 0
eps_dcore.bf16_launches = 0
eps_dcore.bf16_sum_launches = 0


def _dviews_smem_bytes(n: int, q: int, n1: int, out_size: int, recompute: bool) -> int:
    """The least shared memory a launch of the d_views kernel can take, for
    64 pixels (``smem_bytes`` in csrc/eps_dviews_t.cu, over the four
    configurations of its ``choose_config``, which launches the first that
    fits): the wrapper refuses a shape over the card's limit. Staged factors
    and their cotangents, v (then d_v), g and a zero row, two cmt stages for
    MA rows of A, u's Kronecker factors X and Y (q^(n1-lv) + q^lv rows, lv =
    n1 // 2, and a zero row) and either their cotangents (the Kronecker
    fold) or the u digit table (the leave-one-out fold, n1 x MA ints); v, g,
    X and Y rows 72 floats apart."""
    lv = n1 // 2
    xy_rows = q ** (n1 - lv) + q**lv

    def at(ma, kron):
        stage = max(32 * (ma + 8), ma * 36)
        uxy = (xy_rows + 1) * 72 if kron or (recompute and n1 < n) else 0
        return (4 * (64 * 2 * n * q + 72 * (q ** (n - n1) + 1 + out_size) + 2 * stage + uxy
                     + (xy_rows * 64 if kron else 0)) + (0 if kron else 4 * n1 * ma))

    return min(at(ma, kron) for kron in (True, False) for ma in (128, 64))


def _check_dviews_args(name, views_t, cmt, g, t, n1, out_size):
    """The arguments of ``eps_dviews_t`` (with its saved ``t``) or of
    ``eps_dviews_recompute`` (``t`` None), each within its form's shared
    memory (``_dviews_smem_bytes``)."""
    n, q, npix = views_t.shape
    shape = (
        f"views {tuple(views_t.shape)}, cmt {tuple(cmt.shape)}, g {tuple(g.shape)}, "
        f"t {None if t is None else tuple(t.shape)}, n1={n1}, O={out_size}"
    )
    tensors = {"views": views_t, "cmt": cmt, "g": g}
    if t is not None:
        tensors["t"] = t
    _check_tensors(name, shape, views_t.device, **tensors)
    _check_split(name, shape, n, q, n1)
    z = out_size * q ** (n - n1)
    if tuple(cmt.shape) != (z, q**n1) or tuple(g.shape) != (out_size, npix):
        raise ValueError(f"{name}: cmt is not (O·q^(n-n1), q^n1) or g not (O, npix) ({shape})")
    smem = _dviews_smem_bytes(n, q, n1, out_size, name == "eps_dviews_recompute")
    if smem > _MAX_SMEM_BYTES:
        raise ValueError(
            f"{name} kernel limits exceeded ({shape}): needs {smem} B of "
            f"shared memory > {_MAX_SMEM_BYTES}"
        )


def eps_dviews_t(
    views_t: torch.Tensor, cmt: torch.Tensor, g: torch.Tensor,
    t: Optional[torch.Tensor], n1: int, out_size: int,
) -> torch.Tensor:
    """The (n, q, npix) cotangent of the factor stack, from the (Z, A) cmt,
    the (O, npix) output cotangent and the forward-saved (Z, npix) t (None
    when n2 = 0). CPU tensors run ``eps_dviews_t_reference``; CUDA tensors
    run the kernel, and ``eps_dviews_t.launches`` counts its launches. A
    bf16 cmt (and t) runs the bf16 mode, counted in
    ``eps_dviews_t.bf16_launches``."""
    if views_t.device.type == "cpu":
        return eps_dviews_t_reference(views_t, cmt, g, t, n1, out_size)
    _check_device("eps_dviews_t", views_t)
    n, q, npix = views_t.shape
    if (t is None) != (n1 == n) or (t is not None and tuple(t.shape) != (cmt.shape[0], npix)):
        raise ValueError(
            f"eps_dviews_t: t must be (Z, npix) when n2 > 0, None when n2 = 0 "
            f"(t {None if t is None else tuple(t.shape)}, cmt {tuple(cmt.shape)}, n1={n1})"
        )
    if cmt.dtype == torch.bfloat16:
        return _eps_dviews_bf16("eps_dviews_t", views_t, cmt, g, t, n1, out_size)
    _check_dviews_args("eps_dviews_t", views_t, cmt, g, t, n1, out_size)
    dev = views_t.device
    dviews = torch.empty((n, q, npix), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _library("eps_dviews_t").dctn_eps_dviews_t(
            views_t.data_ptr(), cmt.data_ptr(), g.data_ptr(),
            None if t is None else t.data_ptr(), dviews.data_ptr(),
            n, q, n1, out_size, npix, _stream(dev),
        )
    _raise_on_error("eps_dviews_t", err)
    eps_dviews_t.launches += 1
    return dviews


eps_dviews_t.launches = 0
eps_dviews_t.bf16_launches = 0


def eps_dviews_recompute(
    views_t: torch.Tensor, cmt: torch.Tensor, g: torch.Tensor, n1: int, out_size: int
) -> torch.Tensor:
    """The recompute arm's d_views: the (n, q, npix) cotangent of the
    factor stack from the (Z, A) cmt and the (O, npix) output cotangent,
    with t recomputed in the kernel and never written. CPU tensors run
    ``eps_dviews_recompute_reference``; CUDA tensors run the kernel, and
    ``eps_dviews_recompute.launches`` counts its launches. A bf16 cmt runs
    the bf16 mode (t recomputed in float32, unrounded), counted in
    ``eps_dviews_recompute.bf16_launches``."""
    if views_t.device.type == "cpu":
        return eps_dviews_recompute_reference(views_t, cmt, g, n1, out_size)
    _check_device("eps_dviews_recompute", views_t)
    if cmt.dtype == torch.bfloat16:
        return _eps_dviews_bf16("eps_dviews_recompute", views_t, cmt, g, None, n1, out_size)
    _check_dviews_args("eps_dviews_recompute", views_t, cmt, g, None, n1, out_size)
    n, q, npix = views_t.shape
    dev = views_t.device
    dviews = torch.empty((n, q, npix), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _library("eps_dviews_t").dctn_eps_dviews_recompute(
            views_t.data_ptr(), cmt.data_ptr(), g.data_ptr(), dviews.data_ptr(),
            n, q, n1, out_size, npix, _stream(dev),
        )
    _raise_on_error("eps_dviews_recompute", err)
    eps_dviews_recompute.launches += 1
    return dviews


eps_dviews_recompute.launches = 0
eps_dviews_recompute.bf16_launches = 0


def _check_dviews_bf16_args(name, views_t, cmt, g, t, n1, out_size):
    """The arguments of the bf16 mode of ``eps_dviews_t`` (with its bf16
    ``t``) or of ``eps_dviews_recompute`` (``t`` None)."""
    n, q, npix = views_t.shape
    shape = (
        f"views {tuple(views_t.shape)}, cmt {tuple(cmt.shape)}, g {tuple(g.shape)}, "
        f"t {None if t is None else tuple(t.shape)}, n1={n1}, O={out_size}"
    )
    _check_tensors(name, shape, views_t.device, views=views_t, g=g)
    bf = {"cmt": cmt} if t is None else {"cmt": cmt, "t": t}
    _check_tensors(name, shape, views_t.device, torch.bfloat16, **bf)
    _check_split(name, shape, n, q, n1)
    z = out_size * q ** (n - n1)
    if tuple(cmt.shape) != (z, q**n1) or tuple(g.shape) != (out_size, npix):
        raise ValueError(f"{name}: cmt is not (O·q^(n-n1), q^n1) or g not (O, npix) ({shape})")
    _check_bf16_plan(name, shape, _dviews_bf16_smem_bytes(n, q, n1, out_size), **{
        "q^(n-n1)": (q ** (n - n1), _MAX_B2), "n1": (n1, _BF16_MAX_CHAIN),
        "n-n1": (n - n1, _BF16_MAX_CHAIN)})


def _eps_dviews_bf16(name, views_t, cmt, g, t, n1, out_size):
    """The bf16 mode of ``eps_dviews_t`` (with the saved bf16 ``t``) or of
    ``eps_dviews_recompute`` (``t`` None) on CUDA tensors."""
    _check_dviews_bf16_args(name, views_t, cmt, g, t, n1, out_size)
    n, q, npix = views_t.shape
    dev = views_t.device
    dviews = torch.empty((n, q, npix), dtype=torch.float32, device=dev)
    cmt_t = cmt.t().contiguous()  # d_u's operand rows: (A, Z), Z contiguous
    lib = _library("eps_dviews_t")
    with torch.cuda.device(dev):
        if name == "eps_dviews_recompute":
            err = lib.dctn_eps_dviews_recompute_bf16(
                views_t.data_ptr(), cmt.data_ptr(), cmt_t.data_ptr(), g.data_ptr(),
                dviews.data_ptr(), n, q, n1, out_size, npix, _stream(dev),
            )
        else:
            err = lib.dctn_eps_dviews_t_bf16(
                views_t.data_ptr(), cmt.data_ptr(), cmt_t.data_ptr(), g.data_ptr(),
                None if t is None else t.data_ptr(), dviews.data_ptr(),
                n, q, n1, out_size, npix, _stream(dev),
            )
    _raise_on_error(f"{name} (bf16)", err)
    (eps_dviews_recompute if name == "eps_dviews_recompute" else eps_dviews_t).bf16_launches += 1
    return dviews


@dataclasses.dataclass(frozen=True)
class EPSKernels:
    """The contractions of one EPS layer's forward and backward, with the
    signatures of ``eps_fwd``, ``eps_dcore``, ``eps_dviews_t`` and
    ``eps_dviews_recompute``. ``quantizes``: ``fwd`` is an int8 forward
    that quantizes the cmt it is given (the QAT bundles of
    ``eps_q8_kernels``): it takes the float32 cmt in every mode, and a
    ``t_dtype`` to store t in."""

    fwd: Callable
    dcore: Callable
    dviews_t: Callable
    dviews_recompute: Callable
    quantizes: bool = False


KERNELS = EPSKernels(eps_fwd, eps_dcore, eps_dviews_t, eps_dviews_recompute)
PLAIN = EPSKernels(
    eps_fwd_reference, eps_dcore_reference, eps_dviews_t_reference,
    eps_dviews_recompute_reference,
)


# ---------------------------------------------------------------------------
# the layer


class EPSApplyTCmt(torch.autograd.Function):
    """One EPS layer on the factor stack, with its gradient
    (``eps_pallas_apply_t_cmt``'s custom_vjp, eps_pallas.py:923-980, on the
    stack): (views (n, q, npix), cmt (Z, A)) → (O, npix).

    The forward writes t when ``save_t``; the backward computes d_cmt with
    ``dcore`` when cmt needs a gradient, and the views' cotangent when they
    need one: from t with ``dviews_t``, or, without a saved t, with
    ``dviews_recompute``.

    ``mm_dtype`` bf16 is the bf16 operand mode: the Function takes the
    float32 cmt and rounds it to bf16 inside ``forward`` (``cmt32.astype
    (mm_dtype)``, eps_pallas.py:955), the kernels read the bf16 copy, and
    d_cmt comes back in float32 from ``dcore``. Cast outside the Function,
    autograd would round the gradient to the bf16 input's dtype too. A
    bundle that ``quantizes`` (QAT) gets the float32 cmt in its forward
    instead, with t to be stored in the operand dtype
    (``_q8train_fwd``, eps_pallas_q8.py:293-297); its backward reads the
    bf16 copy (``_q8train_bwd``, :317-330)."""

    @staticmethod
    def forward(ctx, views_t, cmt, n1: int, out_size: int, save_t: bool, kernels: EPSKernels,
                mm_dtype=None):
        cmtm = cmt if mm_dtype is None else cmt.to(operand_dtype(mm_dtype))
        if kernels.quantizes:
            fwd = functools.partial(kernels.fwd, views_t, cmt, n1, out_size,
                                    t_dtype=cmtm.dtype)
        else:
            fwd = functools.partial(kernels.fwd, views_t, cmtm, n1, out_size)
        out, t = fwd(save_t=True) if save_t else (fwd(), None)
        ctx.save_for_backward(views_t, cmtm, t)
        ctx.n1, ctx.out_size, ctx.kernels, ctx.mm_dtype = n1, out_size, kernels, mm_dtype
        return out

    @staticmethod
    def backward(ctx, g):
        views_t, cmt, t = ctx.saved_tensors
        g = g.contiguous()
        k, n1, o = ctx.kernels, ctx.n1, ctx.out_size
        d_views = d_cmt = None
        if ctx.needs_input_grad[1]:
            if ctx.mm_dtype is None:
                d_cmt = k.dcore(views_t, g, n1, o)
            else:
                d_cmt = k.dcore(views_t, g, n1, o, mm_dtype=ctx.mm_dtype)
        if ctx.needs_input_grad[0]:
            if t is None:
                d_views = k.dviews_recompute(views_t, cmt, g, n1, o)
            else:
                d_views = k.dviews_t(views_t, cmt, g, t, n1, o)
        return d_views, d_cmt, None, None, None, None, None


def eps_apply_t_cmt(
    cmt: torch.Tensor,
    xT: torch.Tensor,
    out_size: int,
    kernel_size: int,
    n1: int,
    merge_pairs: bool,
    *,
    layer_index: int,
    kernels: EPSKernels = KERNELS,
    pixel_scale: int = 1,
    save_shapes: Optional[Tuple[int, int]] = None,
    mm_dtype=None,
) -> torch.Tensor:
    """One EPS layer on the matricized core (eps_pallas.py:924-980):
    ``xT`` (C, Q, H, W, B) → ``outT`` (O, H', W', B), differentiable in
    both. The forward writes t only when grad is on, ``xT`` needs a gradient
    and ``plan_backward`` picks the saved-t arm for this layer, so serving
    (under ``inference_mode``) writes none. ``kernels`` is ``KERNELS``
    unless a caller runs the plain versions or the int8 forward
    (``eps_q8_kernels.QAT_KERNELS``).

    ``mm_dtype``: the operand dtype, None (float32, 3xTF32 on a card) or
    ``torch.bfloat16`` (the bf16 mode: ``cmt`` stays the float32 parameter
    and is rounded inside ``EPSApplyTCmt``; t is stored in bf16, so
    ``plan_backward`` counts 2 bytes an entry).

    ``pixel_scale``: ``plan_backward`` decides on ``npix · pixel_scale``
    pixels. A data-parallel QAT step passes its rank count, so that every
    rank takes the arm that one device takes on the whole batch
    (``forward_fast_q8train``'s ``pixel_scale``, eps_pallas_q8.py:383-416);
    the f32 step plans each rank on its own pixels (1).

    ``save_shapes``: the unsharded ``(out_size, npix)`` that
    ``plan_backward`` decides on instead (``apply_q8train_layer``'s
    ``save_shapes``, eps_pallas_q8.py:327-366), for a rank that runs a row
    block of the core (tensor parallelism: the whole O) or a slab of the
    image (spatial parallelism: the valid global height, the batch of every
    data rank), so that every rank takes the arm one device takes; the QAT
    steps of those layouts pass it (the arm changes the STE gradient), their
    f32 steps plan on the rank's own shapes, as JAX's ``plan_pallas_call``
    does on the shard's."""
    t_bytes = operand_dtype(mm_dtype).itemsize
    c, q, h, w, b = xT.shape
    hp, wp = h - kernel_size + 1, w - kernel_size + 1
    n_k, q_k, n1_k = _kernel_dims(c, q, kernel_size, n1, merge_pairs)
    views_t, npix = _stack_views_from_xT(xT, kernel_size, merge_pairs)
    plan_out, plan_npix = (out_size, npix * pixel_scale) if save_shapes is None else save_shapes
    save_t = (
        torch.is_grad_enabled()
        and xT.requires_grad
        and plan_backward(layer_index, n_k, n1_k, q_k, plan_out, plan_npix, t_bytes) == "saved_t"
    )
    out = EPSApplyTCmt.apply(views_t, cmt, n1_k, out_size, save_t, kernels, mm_dtype)
    return out.reshape(out_size, hp, wp, b)
