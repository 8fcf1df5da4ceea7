"""Host side of the ConvSBS kernels (port of ``dctn_tpu/pallas/sbs_pallas.py``):
the fused tensor-train fold of one string, forward and backward.

The string works in the transposed batch-minor layout: ``xT`` (C, Q, H, W, B)
in, ``outT`` (∏o, H', W', B) out, the flat pixel index ``(h·W' + w)·B + b``.
The host merges the C channel views of each core's position into one
(P, q^C, npix) factor stack (``_merge_channel_views``, channel 0 slowest) and
matricizes each core to (l·r·o, q^C) rows in (l, r, o) order
(``_core_to_lro``). Two kernels then fold the string per pixel:

- ``sbs_fwd`` (``csrc/sbs_fwd.cu``): the string's contraction per pixel.
  With a merge position it replaces the meet-in-the-middle
  ``_sbs_fwd_mim_kernel_factory`` (K10, sbs_pallas.py:430), with
  ``mcut=None`` the sequential ``_sbs_fwd_kernel_factory`` (K12's forward,
  :256): one function in two rounding orders. ``_fwd_route`` picks the
  kernel from the string's shape. The register route (``_reg_plan``: at most
  one core with o > 1, bonds ≤ 8, ring bond ≤ 4) folds both ends toward the
  output core with b0 × bond states in registers, for both families alike;
  ``mcut`` then only names the family counted. The shared-memory route takes
  the other strings: the prefix fold of cores 0..mcut−1, the suffix fold of
  cores P−1..mcut seeded with δ(b0) (the ring closure; 1 for an open
  string), and their merge Σ_{b0, r_m} pre ⊗ suf; with ``mcut=None`` the
  prefix runs over all P cores and the merge with the bare seed is the ring
  trace.
- ``sbs_bwd`` (``csrc/sbs_bwd.cu``): the reverse of the same fold, giving
  d_cores (per-CTA partial sums over pixels, then a second kernel that adds
  them in a fixed order) and, when asked, d_views; K11
  (``_sbs_bwd_mim_kernel_factory``, :471) with a merge position, K12's
  backward (``_sbs_bwd_kernel_factory``, :281) with ``mcut=None``. The TPU
  kernel computes the sequential backward from per-core prefix and suffix
  tables; the port reverses the sequential fold instead (same gradients,
  every prefix state kept, no suffix table).

On a CPU tensor each wrapper runs its plain PyTorch version (``*_reference``:
the same folds as batched einsums, the backward by autograd through them);
on a CUDA tensor it launches its kernel or raises. There is no fallback
inside a wrapper: ``conv_sbs_t`` (and the model, for all its strings at
once) decides before any launch to run a string outside the kernels'
scope (``sbs_supported``) on the plain folds (``PLAIN``), and records that
fallback (``utils.fallbacks``), as the JAX package runs such a string on
its XLA fold (ops/sbs.py:279-305). ``ConvSBSApply`` is the
``torch.autograd.Function`` around the pair, with the boundary of the JAX
``custom_vjp`` (sbs_pallas.py:674-764): (views, cores in (l·r·o, q^C)) ↔
(d_views, d_cores). The merge, the core permutation and the
output reshape stay outside it, and autograd differentiates them. d_views is
computed exactly when ``ctx.needs_input_grad`` asks for it: in the model
that is every layer but the first, whose input is the untrained quantum map
of the pixels.

Not ported, because they serve only the TPU: the VMEM tile pick
(``bn``/``_pick_bn``: the kernels here give one pixel to each thread and mask
the ragged last block, so nothing is padded), the MXU/VPU choice of the
d_core tail (``dcore_dot``, ``_QC_UNROLL_MAX``: there is no matrix unit in a
per-pixel fold on CUDA cores), the ``DCTN_TPU_SBS_MIM`` environment variable
(the family is chosen by the ``mim``/``mcut`` arguments alone) and the VMEM
budget in ``sbs_plan``'s ``fits`` clause (the kernels check their own shared
memory instead, ``_launch_plan``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..utils import fallbacks
from . import build

# the kernels' limits (csrc/sbs_plan.cuh)
_MAX_CORES = 16
_MAX_QC = 16
_MAX_SMEM_BYTES = 227 * 1024
# a Hopper SM's shared memory, and what each resident block reserves of it
_SM_SMEM_BYTES = 228 * 1024
_BLOCK_RESERVED_SMEM = 1024
_FWD_MAX_THREADS = 256
_BWD_MAX_THREADS = 256
# the backward's d_core contraction (csrc/sbs_bwd.cu): dm rows per tile
_BWD_DM_ROWS = 16
# the backward kernel's registers a thread at most (its __launch_bounds__:
# two CTAs of 256 threads on an SM's 65,536)
_BWD_REGISTERS = 128
_SM_REGISTERS = 65536
# where widening the kernels' scope is written down (the wrappers' refusals
# name it; a string outside the scope takes the plain folds before any
# launch)
_SCOPE_ITEM = "ROADMAP Queue 2 follow-up 8 (the ConvSBS kernels' scope)"
# the forward's register route (csrc/sbs_fwd.cu, sbs_fwd_reg_kernel): the
# padded shapes it is instantiated at (bond B, ring bond B0, q^C KQ)
_REG_BONDS = (4, 8)
_REG_RING_BONDS = (1, 2, 4)
_REG_QCS = (4, 16)


def sbs_supported(spec) -> Tuple[Tuple[Tuple[int, int, int], ...], int, bool]:
    """Per-core (o, l, r), q^C, and whether the kernels take the spec:
    ``sbs_plan``'s rule (sbs_pallas.py:87) without its VMEM clause — at most
    3 channels, a ring bond of at most 4, every bond at most 8 — and the
    kernels' own limits, at most 16 cores and q^C ≤ 16."""
    olr = tuple(
        (s.out_quantum_dim_size, s.bond_left_size, s.bond_right_size) for s in spec.shapes
    )
    qc = spec.in_quantum_dim_size**spec.in_num_channels
    supported = (
        spec.in_num_channels <= 3
        and spec.bond_sizes[0] <= 4
        and all(l <= 8 and r <= 8 for _, l, r in olr)
        and len(olr) <= _MAX_CORES
        and qc <= _MAX_QC
    )
    return olr, qc, supported


def _core_to_lro(core: torch.Tensor, o: int, l: int, r: int, qc: int) -> torch.Tensor:
    """Core dims (o, l, r) + (q,)*C → (l·r·o, q^C), rows ordered (l, r, o)
    (sbs_pallas.py:120-124)."""
    return core.reshape(o, l, r, qc).permute(1, 2, 0, 3).reshape(l * r * o, qc)


def _merge_channel_views(xT: torch.Tensor, positions, qc: int):
    """``xT`` (C, Q, H, W, B) → the per-position merged factors (P, q^C,
    npix), flat pixel index ((h·W' + w)·B + b), channel 0 slowest like the
    core's quantum dims (sbs_pallas.py:633-656); and npix, H', W'."""
    c, q, h, w, b = xT.shape
    hp = h - max(p.h for p in positions)
    wp = w - max(p.w for p in positions)
    npix = b * hp * wp
    merged = []
    for pos in positions:
        fs = [xT[ch, :, pos.h : pos.h + hp, pos.w : pos.w + wp, :].reshape(q, npix)
              for ch in range(c)]
        m = fs[0]
        for f in fs[1:]:
            m = (m[:, None, :] * f[None, :, :]).reshape(-1, npix)
        merged.append(m)
    return torch.stack(merged, dim=0), npix, hp, wp


def _mim_cut(olr) -> Optional[int]:
    """Merge position m (1 ≤ m ≤ P−1) with the fewest fold and merge
    multiplications, or None when the sequential fold is at least as cheap
    (P < 3, or degenerate bond and output patterns) (sbs_pallas.py:399-427)."""
    P = len(olr)
    if P < 3:
        return None
    b0 = olr[0][1]

    def mim_cost(m):
        c, o_pre = 0, olr[0][0]
        for i in range(1, m):
            o, l, r = olr[i]
            c += b0 * l * r * o_pre * o
            o_pre *= o
        o_suf = 1
        for i in range(P - 1, m - 1, -1):
            o, l, r = olr[i]
            c += l * b0 * r * o * o_suf
            o_suf *= o
        return c + b0 * olr[m][1] * o_pre * o_suf

    seq, o_acc = 0, olr[0][0]
    for i in range(1, P):
        o, l, r = olr[i]
        seq += b0 * l * r * o_acc * o
        o_acc *= o
    best = min(range(1, P), key=mim_cost)
    return best if mim_cost(best) < seq else None


def _check_mcut(olr, mcut: Optional[int]) -> None:
    if mcut is not None and not 1 <= mcut < len(olr):
        raise ValueError(f"merge cut {mcut} outside [1, {len(olr)})")


# ---------------------------------------------------------------------------
# plain PyTorch versions of the kernels


def _seed(b0: int, npix: int, like: torch.Tensor) -> torch.Tensor:
    """δ(s, b) rows (s, b, O=1) for every pixel: the ring closure (1 for an
    open string)."""
    eye = torch.eye(b0, dtype=like.dtype, device=like.device)
    return eye.reshape(b0, b0, 1, 1).expand(b0, b0, 1, npix)


def sbs_fwd_reference(
    views_t: torch.Tensor, cores_lro: Sequence[torch.Tensor], olr, mcut: Optional[int]
) -> torch.Tensor:
    """The forward kernel's plain version, (P, q^C, npix) → (∏o, npix).
    ``mcut``: the meet-in-the-middle fold (K10): prefix 0..mcut−1 as
    (b0, r, O_pre) states, suffix P−1..mcut as (l, b0, O_suf) states from
    the δ(b0) seed, merged over (b0, r_m); None: the sequential fold (K12)
    of all P cores, closed by the ring trace."""
    _check_mcut(olr, mcut)
    P, _, npix = views_t.shape
    b0 = olr[0][1]
    ms = [core @ views_t[i] for i, core in enumerate(cores_lro)]  # rows (l, r, o)
    o0, l0, r0 = olr[0]
    acc = ms[0].reshape(l0, r0, o0, npix)  # (b0, r, O_pre)
    for i in range(1, P if mcut is None else mcut):
        o, l, r = olr[i]
        acc = torch.einsum("bxOp,xsop->bsOop", acc, ms[i].reshape(l, r, o, npix))
        acc = acc.reshape(b0, r, -1, npix)
    if mcut is None:
        return torch.diagonal(acc, dim1=0, dim2=1).sum(-1)
    t = _seed(b0, npix, views_t)  # (r_{P-1} = b0, b0, O_suf)
    for i in range(P - 1, mcut - 1, -1):
        o, l, r = olr[i]
        t = torch.einsum("xsop,sbQp->xboQp", ms[i].reshape(l, r, o, npix), t)
        t = t.reshape(l, b0, -1, npix)
    return torch.einsum("bsPp,sbQp->PQp", acc, t).reshape(-1, npix)


def sbs_bwd_reference(
    views_t: torch.Tensor, cores_lro: Sequence[torch.Tensor], g: torch.Tensor, olr,
    mcut: Optional[int], need_dviews: bool,
) -> Tuple[Optional[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """The backward kernel's plain version: autograd through
    ``sbs_fwd_reference`` with the output cotangent g (∏o, npix) →
    (d_views (P, q^C, npix) or None, d_cores each (l·r·o, q^C))."""
    with torch.enable_grad():
        v = views_t.detach().requires_grad_(need_dviews)
        cs = [c.detach().requires_grad_(True) for c in cores_lro]
        out = sbs_fwd_reference(v, cs, olr, mcut)
        grads = torch.autograd.grad(out, cs + ([v] if need_dviews else []), g)
    return (grads[-1] if need_dviews else None), tuple(grads[: len(cs)])


# ---------------------------------------------------------------------------
# the kernels' launch plan and wrappers


def _state_sizes(olr, mcut_k: int):
    """Per-pixel fold states, in floats: ``pre[i]``, the prefix after core i
    (rows (b0, r_i, O_pre)); ``suf[i]``, the suffix after core i (rows (l_i,
    b0, O_suf)), and ``suf[P]`` the δ(b0) seed it starts from."""
    P, b0 = len(olr), olr[0][1]
    pre, o_pre = [], 1
    for i in range(mcut_k):
        o, _, r = olr[i]
        o_pre *= o
        pre.append(b0 * r * o_pre)
    suf, o_suf = {P: b0 * b0}, 1
    for i in range(P - 1, mcut_k - 1, -1):
        o, l, _ = olr[i]
        o_suf *= o
        suf[i] = l * b0 * o_suf
    return pre, suf


def _layout(olr, mcut_k: int, backward: bool):
    """Offsets (in floats per thread) of the fold's buffers in shared
    memory, and their total S. Forward: two prefix and two suffix buffers,
    used in turn. Backward: every prefix state and every suffix state kept
    (the reverse reads them: ``tnext[i]``, the suffix that core i folds
    into, is ``suf[i+1]``), the suffix at the merge, and two buffers each
    for the cotangents of the prefix and of the suffix states."""
    P = len(olr)
    pre, suf = _state_sizes(olr, mcut_k)
    lay = dict.fromkeys(("pre_a", "pre_b", "suf_a", "suf_b", "suf", "da_a", "da_b",
                         "dt_a", "dt_b"), 0)
    lay["lstate"], lay["tnext"] = [0] * _MAX_CORES, [0] * _MAX_CORES
    if not backward:
        max_pre, max_suf = max(pre), max(suf.values())
        lay.update(pre_b=max_pre, suf_a=2 * max_pre, suf_b=2 * max_pre + max_suf)
        return lay, 2 * max_pre + 2 * max_suf
    s = 0
    for i, n in enumerate(pre):
        lay["lstate"][i] = s
        s += n
    for i in range(mcut_k, P):
        lay["tnext"][i] = s
        s += suf[i + 1]
    max_t = max(suf.values()) if mcut_k < P else 0
    lay["suf"] = s
    s += suf[mcut_k]
    lay.update(da_a=s, da_b=s + max(pre), dt_a=s + 2 * max(pre),
               dt_b=s + 2 * max(pre) + max_t)
    return lay, s + 2 * max(pre) + 2 * max_t


def _bwd_segments(threads: int, qc: int) -> int:
    """The backward's pixel segments per d_core element: the threads of a
    tile over the elements of 16 dm rows (``tile_segments``)."""
    return max(1, threads // (_BWD_DM_ROWS * qc))


def _bwd_tile_floats(threads: int, qc: int, o_total: int) -> int:
    """Floats of the backward's d_core contraction tiles (16 dm rows and
    the q^C views of each pixel, in rows of threads + 4·segments floats, and
    one partial per thread) and of the pixels' staged output cotangent
    (``tile_floats``)."""
    tp = threads + 4 * _bwd_segments(threads, qc)
    return (_BWD_DM_ROWS + qc) * tp + threads + o_total * threads


def _smem_bytes(nelem: int, threads: int, state: int, backward: bool, qc: int = 1,
                o_total: int = 1, spill: bool = False) -> int:
    """Shared memory of one launch: the cores and the fold states of every
    thread and, in the backward, the CTA's d_core sums and, unless they
    spill to device memory, the contraction's tiles and the staged output
    cotangent from a 16-byte boundary (``bwd_smem_bytes``)."""
    if not backward:
        return 4 * (nelem + threads * state)
    if spill:
        return 4 * (2 * nelem + threads * state)
    return 4 * (-(-2 * nelem // 4) * 4 + _bwd_tile_floats(threads, qc, o_total) + threads * state)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    ints: Tuple[int, ...]  # the kernel's Plan struct (csrc/sbs_plan.cuh)
    threads: int
    nelem: int
    smem_bytes: int
    array: ctypes.Array = dataclasses.field(compare=False)  # ``ints`` as the C int[]
    # backward: the contraction's tiles and the staged g in device memory
    spill: bool = False
    o_total: int = 1

    def bwd_smem_bytes(self, threads: int) -> int:
        """The backward's shared memory at ``threads`` threads."""
        return _smem_bytes(self.nelem, threads, self.ints[4], True, self.ints[1], self.o_total,
                           self.spill)


@functools.lru_cache(maxsize=None)
def _launch_plan(olr, qc: int, mcut: Optional[int], backward: bool) -> LaunchPlan:
    """The Plan struct of ``csrc/sbs_plan.cuh`` as ints, and the most
    threads per block (a multiple of 32, at most 256) whose states fit the
    shared memory; raises where not even 32 do, or where the string is
    outside the kernels' limits. The backward keeps its d_core contraction's
    tiles and the staged g in shared memory where 32 threads fit with them,
    and else spills them to device memory (``spill``): its shared memory is
    then the cores, one d_core sum and the states, what the backward needed
    before the contraction, so it takes every string it took."""
    P = len(olr)
    b0 = olr[0][1]
    if not 1 <= P <= _MAX_CORES or not 1 <= qc <= _MAX_QC:
        raise ValueError(
            f"ConvSBS kernels take 1..{_MAX_CORES} cores and q^C <= {_MAX_QC}, got "
            f"{P} cores, q^C = {qc}: outside the kernels' scope ({_SCOPE_ITEM})"
        )
    if any(olr[i][2] != olr[(i + 1) % P][1] for i in range(P)):
        raise ValueError(f"bond chain {olr} does not close")
    _check_mcut(olr, mcut)
    mcut_k = P if mcut is None else mcut
    lay, state = _layout(olr, mcut_k, backward)
    sizes = [o * l * r * qc for o, l, r in olr]
    nelem = sum(sizes)
    offs = [sum(sizes[:i]) for i in range(P)] + [0] * (_MAX_CORES - P)
    o_total = math.prod(o for o, _, _ in olr)
    threads, spill = 0, False
    for spill in ((False, True) if backward else (False,)):
        for t in range(_BWD_MAX_THREADS if backward else _FWD_MAX_THREADS, 0, -32):
            if _smem_bytes(nelem, t, state, backward, qc, o_total, spill) <= _MAX_SMEM_BYTES:
                threads = t
                break
        if threads:
            break
    if not threads:
        raise ValueError(
            f"ConvSBS string {olr} with q^C = {qc}: its fold needs "
            f"{_smem_bytes(nelem, 32, state, backward, qc, o_total, backward)} B of shared "
            f"memory at 32 threads, over {_MAX_SMEM_BYTES}: outside the kernels' scope "
            f"({_SCOPE_ITEM})"
        )
    pad = [0] * (_MAX_CORES - P)
    ints = (
        (P, qc, b0, mcut_k, state, nelem)
        + tuple([o for o, _, _ in olr] + pad) + tuple([l for _, l, _ in olr] + pad)
        + tuple([r for _, _, r in olr] + pad) + tuple(offs)
        + (lay["pre_a"], lay["pre_b"], lay["suf_a"], lay["suf_b"])
        + tuple(lay["lstate"]) + tuple(lay["tnext"])
        + (lay["suf"], lay["da_a"], lay["da_b"], lay["dt_a"], lay["dt_b"], int(spill))
    )
    return LaunchPlan(ints, threads, nelem,
                      _smem_bytes(nelem, threads, state, backward, qc, o_total, spill),
                      (ctypes.c_int * len(ints))(*ints), spill, o_total)


@dataclasses.dataclass(frozen=True)
class RegPlan:
    """The forward's register route for one string: the kernel's ``RegPlan``
    struct (csrc/sbs_fwd.cu) as ints, the output core ``c`` both ends fold
    toward, the padded shape (``B``, ``B0``, ``KQ``) and the staged cores'
    shared memory."""

    ints: Tuple[int, ...]
    c: int
    B: int
    B0: int
    KQ: int
    smem_bytes: int
    array: ctypes.Array = dataclasses.field(compare=False)


@functools.lru_cache(maxsize=None)
def _reg_plan(olr, qc: int) -> Optional[RegPlan]:
    """The register route's plan, or None where the string is outside it:
    more than one core with o > 1, a bond over 8, a ring bond over 4, q^C
    over 16, more than 16 cores, or staged cores (qc B×B slabs for every core
    and o of them for the output core) over the shared memory. The output
    core is the one with o > 1, else the middle one."""
    P, b0 = len(olr), olr[0][1]
    outs = [i for i, (o, _, _) in enumerate(olr) if o > 1]
    bond = max(max(l, r) for _, l, r in olr)
    if (len(outs) > 1 or bond > max(_REG_BONDS) or b0 > max(_REG_RING_BONDS)
            or not 1 <= qc <= max(_REG_QCS) or not 1 <= P <= _MAX_CORES
            or any(olr[i][2] != olr[(i + 1) % P][1] for i in range(P))):
        return None
    c = outs[0] if outs else (P - 1) // 2
    oc = olr[c][0]
    B = min(x for x in _REG_BONDS if x >= bond)
    B0 = min(x for x in _REG_RING_BONDS if x >= b0)
    KQ = min(x for x in _REG_QCS if x >= qc)
    smem = 4 * (P - 1 + oc) * qc * B * B
    if smem > _MAX_SMEM_BYTES:
        return None
    pad = [0] * (_MAX_CORES - P)
    ints = ((P, qc, b0, c, oc, B, B0, KQ)
            + tuple([l for _, l, _ in olr] + pad) + tuple([r for _, _, r in olr] + pad))
    return RegPlan(ints, c, B, B0, KQ, smem, (ctypes.c_int * len(ints))(*ints))


def _fwd_route(olr, qc: int, mcut: Optional[int]):
    """The forward's route for one string, from its shape alone:
    ``("registers", RegPlan)`` where the register kernel's plan holds it
    (both families then run the same arithmetic, folded toward the output
    core; ``mcut`` only picks the family counted), else ``("shared",
    LaunchPlan)``, the shared-memory kernel at the family's merge position.
    Raises where neither takes the string."""
    _check_mcut(olr, mcut)
    reg = _reg_plan(tuple(olr), qc)
    if reg is not None:
        return "registers", reg
    return "shared", _launch_plan(tuple(olr), qc, mcut, False)


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRIES = {
    "sbs_fwd": {"dctn_sbs_fwd": [_P, _P, _P, _P, _I, _LL, _I, _P],
                "dctn_sbs_fwd_reg": [_P, _P, _P, _P, _I, _LL, _P]},
    "sbs_bwd": {"dctn_sbs_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _P]},
}


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu`` with its C entries'
    signatures."""
    lib = build.load_library(name)
    for entry, argtypes in _ENTRIES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check_args(name: str, views_t, cores_lro, olr, qc: int, g=None) -> None:
    P, qv, npix = views_t.shape
    shape = f"views {tuple(views_t.shape)}, olr {olr}, q^C {qc}"
    tensors = [("views", views_t)] + [(f"core {i}", c) for i, c in enumerate(cores_lro)]
    if g is not None:
        tensors.append(("g", g))
    for key, x in tensors:
        if x.dtype != torch.float32:
            raise ValueError(f"{name} kernel takes float32, got {key} {x.dtype} ({shape})")
        if x.device != views_t.device:
            raise ValueError(f"{name}: {key} on {x.device}, views on {views_t.device} ({shape})")
    if P != len(olr) or qv != qc or len(cores_lro) != P:
        raise ValueError(f"{name}: views are not (P, q^C, npix) for the cores ({shape})")
    for i, (c, (o, l, r)) in enumerate(zip(cores_lro, olr)):
        if tuple(c.shape) != (l * r * o, qc):
            raise ValueError(f"{name}: core {i} is {tuple(c.shape)}, not (l·r·o, q^C) ({shape})")
    if g is not None and tuple(g.shape) != (math.prod(o for o, _, _ in olr), npix):
        raise ValueError(f"{name}: g is {tuple(g.shape)}, not (∏o, npix) ({shape})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on_error(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def _flat_cores(cores_lro) -> torch.Tensor:
    return torch.cat([c.reshape(-1) for c in cores_lro]).contiguous()


def sbs_fwd(
    views_t: torch.Tensor, cores_lro: Sequence[torch.Tensor], olr, mcut: Optional[int]
) -> torch.Tensor:
    """One string's fold over the (P, q^C, npix) factor stack → (∏o, npix).
    ``mcut`` a merge position: the meet-in-the-middle family (K10); None: the
    sequential family (K12). CPU tensors run ``sbs_fwd_reference``; CUDA
    tensors launch the kernel of ``_fwd_route``'s route (on the register
    route both families fold toward the output core; on the shared-memory
    route ``mcut`` is the merge position), and ``sbs_fwd.mim_launches`` /
    ``sbs_fwd.seq_launches`` count its launches of each family."""
    if views_t.device.type == "cpu":
        return sbs_fwd_reference(views_t, cores_lro, olr, mcut)
    if views_t.device.type != "cuda":
        raise ValueError(f"sbs_fwd runs on cpu or cuda, not {views_t.device}")
    P, qc, npix = views_t.shape
    _check_args("sbs_fwd", views_t, cores_lro, olr, qc)
    route, plan = _fwd_route(olr, qc, mcut)
    dev = views_t.device
    views_t = views_t.contiguous()
    out = torch.empty((math.prod(o for o, _, _ in olr), npix), dtype=torch.float32, device=dev)
    lib = _library("sbs_fwd")
    with torch.cuda.device(dev):
        if route == "registers":
            # the register kernel stages each core where it lies: no copy into one buffer
            cores = [c.contiguous() for c in cores_lro]
            ptrs = (ctypes.c_void_p * P)(*[c.data_ptr() for c in cores])
            err = lib.dctn_sbs_fwd_reg(views_t.data_ptr(), ptrs, out.data_ptr(),
                                       plan.array, len(plan.ints), npix, _stream(dev))
        else:
            cores = _flat_cores(cores_lro)
            err = lib.dctn_sbs_fwd(views_t.data_ptr(), cores.data_ptr(), out.data_ptr(),
                                   plan.array, len(plan.ints), npix, plan.threads, _stream(dev))
    _raise_on_error("sbs_fwd", err)
    if mcut is None:
        sbs_fwd.seq_launches += 1
    else:
        sbs_fwd.mim_launches += 1
    return out


sbs_fwd.mim_launches = 0
sbs_fwd.seq_launches = 0


@functools.lru_cache(maxsize=None)
def _bwd_launch(plan: LaunchPlan, npix: int, sms: int) -> Tuple[int, int]:
    """(threads, CTAs) of the backward on a card of ``sms`` SMs. The CTAs
    are as many as are resident at once (by shared memory and by the
    kernel's at most ``_BWD_REGISTERS`` registers a thread), at most one per
    tile of pixels; each takes an equal share of the pixels and keeps one
    partial d_core. The threads (a multiple of 32, at most the plan's) are
    those that keep the most warps resident on an SM (a pixel's fold is a
    chain of dependent shared-memory steps, which more warps hide), the
    most of them on a tie: fewer contraction rounds per pixel. Fixed for a
    card and shape, so the partial sums, and the fixed-order sum over them,
    are the same from run to run."""
    best = None
    for threads in range(plan.threads, 0, -32):
        smem = plan.bwd_smem_bytes(threads)
        per_sm = max(1, min(2048 // threads, _SM_REGISTERS // (_BWD_REGISTERS * threads),
                            _SM_SMEM_BYTES // (smem + _BLOCK_RESERVED_SMEM)))
        blocks = min(-(-npix // threads), per_sm * sms)
        warps = min(per_sm, -(-blocks // sms)) * threads // 32
        if best is None or warps > best[0]:
            best = (warps, threads, blocks)
    return best[1], best[2]


def sbs_bwd(
    views_t: torch.Tensor, cores_lro: Sequence[torch.Tensor], g: torch.Tensor, olr,
    mcut: Optional[int], need_dviews: bool,
) -> Tuple[Optional[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """The string's gradient from the (∏o, npix) output cotangent g:
    (d_views (P, q^C, npix), or None without ``need_dviews``, which skips
    its sweeps and its write; d_cores each (l·r·o, q^C)). CPU tensors run
    ``sbs_bwd_reference``; CUDA tensors launch the kernel (K11 with a merge
    position, K12's backward with ``mcut=None``) and the fixed-order sum of
    its per-CTA d_core partials: ``sbs_bwd.mim_launches`` /
    ``sbs_bwd.seq_launches`` count the calls of each family,
    ``sbs_bwd.dviews_launches`` those that wrote d_views, and
    ``sbs_bwd.sum_launches`` the sums."""
    if views_t.device.type == "cpu":
        return sbs_bwd_reference(views_t, cores_lro, g, olr, mcut, need_dviews)
    if views_t.device.type != "cuda":
        raise ValueError(f"sbs_bwd runs on cpu or cuda, not {views_t.device}")
    P, qc, npix = views_t.shape
    _check_args("sbs_bwd", views_t, cores_lro, olr, qc, g)
    plan = _launch_plan(tuple(olr), qc, mcut, True)
    dev = views_t.device
    views_t, g = views_t.contiguous(), g.contiguous()
    cores = _flat_cores(cores_lro)
    threads, blocks = _bwd_launch(plan, npix, torch.cuda.get_device_properties(dev).multi_processor_count)
    partial = torch.empty((blocks, plan.nelem), dtype=torch.float32, device=dev)
    scratch = (torch.empty((blocks, _bwd_tile_floats(threads, qc, plan.o_total)),
                           dtype=torch.float32, device=dev) if plan.spill else None)
    d_cores = torch.empty((plan.nelem,), dtype=torch.float32, device=dev)
    d_views = torch.empty_like(views_t) if need_dviews else None
    with torch.cuda.device(dev):
        err = _library("sbs_bwd").dctn_sbs_bwd(
            views_t.data_ptr(), cores.data_ptr(), g.data_ptr(),
            None if d_views is None else d_views.data_ptr(), partial.data_ptr(),
            None if scratch is None else scratch.data_ptr(), d_cores.data_ptr(), plan.array,
            len(plan.ints), npix, threads, blocks,
            _stream(dev),
        )
    _raise_on_error("sbs_bwd", err)
    if mcut is None:
        sbs_bwd.seq_launches += 1
    else:
        sbs_bwd.mim_launches += 1
    sbs_bwd.dviews_launches += need_dviews
    sbs_bwd.sum_launches += 1
    sizes = [c.numel() for c in cores_lro]
    return d_views, tuple(
        d.view(c.shape) for d, c in zip(torch.split(d_cores, sizes), cores_lro)
    )


sbs_bwd.mim_launches = 0
sbs_bwd.seq_launches = 0
sbs_bwd.dviews_launches = 0
sbs_bwd.sum_launches = 0


@dataclasses.dataclass(frozen=True)
class SBSKernels:
    """The fold's forward and backward, with the signatures of ``sbs_fwd``
    and ``sbs_bwd``."""

    fwd: Callable
    bwd: Callable


KERNELS = SBSKernels(sbs_fwd, sbs_bwd)
PLAIN = SBSKernels(sbs_fwd_reference, sbs_bwd_reference)


class ConvSBSApply(torch.autograd.Function):
    """One string on the factor stack, with its gradient (the custom_vjp of
    sbs_pallas.py:674-764): (views (P, q^C, npix), cores (l·r·o, q^C) each)
    → (∏o, npix). The backward computes d_views only when the views need a
    gradient."""

    @staticmethod
    def forward(ctx, views_t, olr, mcut, kernels: SBSKernels, *cores_lro):
        ctx.save_for_backward(views_t, *cores_lro)
        ctx.olr, ctx.mcut, ctx.kernels = olr, mcut, kernels
        return kernels.fwd(views_t, cores_lro, olr, mcut)

    @staticmethod
    def backward(ctx, g):
        views_t, *cores_lro = ctx.saved_tensors
        need_dviews = ctx.needs_input_grad[0]
        d_views, d_cores = ctx.kernels.bwd(
            views_t, cores_lro, g.contiguous(), ctx.olr, ctx.mcut, need_dviews
        )
        return (d_views, None, None, None) + tuple(d_cores)


def record_plain_fold(spec, whole_model: bool = False) -> None:
    """Records that ``spec``, outside the kernels' scope, runs on the plain
    folds (with ``whole_model``, every string of its model does), in the
    words of the JAX package's reason (ops/sbs.py:290-305)."""
    olr, qc, _ = sbs_supported(spec)
    fallbacks.record(
        f"ConvSBS string ({len(olr)} cores, q^C={qc}, bonds up to "
        f"{max(l for _, l, _ in olr)}): spec outside kernel scope (merged factor/bond too "
        f"large) — running the plain bond fold"
        + (" on every string of the model" if whole_model else "")
    )


@functools.lru_cache(maxsize=None)
def _string_plan(spec, mim: Optional[bool], mcut: Optional[int]):
    """(olr, q^C, merge position or None, whether the kernels take the
    spec) of one string and fold family, resolved once per spec: the route
    is the kernels where ``sbs_supported``, else the plain folds, on any
    device alike."""
    olr, qc, supported = sbs_supported(spec)
    if mim is False:
        mcut = None
    elif mcut is None:
        mcut = _mim_cut(olr)
    else:
        _check_mcut(olr, mcut)
    return olr, qc, mcut, supported


def conv_sbs_t(
    spec, cores: Sequence[torch.Tensor], xT: torch.Tensor, mim: Optional[bool] = None,
    mcut: Optional[int] = None, kernels: SBSKernels = KERNELS,
) -> torch.Tensor:
    """One ConvSBS string over the batch-minor input ``xT`` (C, Q, H, W, B)
    → ``outT`` (∏o, H', W', B), differentiable in the cores and in ``xT``
    (sbs_pallas.py:767-829). ``mim`` picks the family: True or None the
    meet-in-the-middle fold at ``mcut`` (by default ``_mim_cut``'s position,
    or the sequential fold where that is cheaper), False the sequential
    fold. ``kernels`` is ``KERNELS`` unless a caller runs the plain versions
    on the card. A spec outside the kernels' scope (``sbs_supported``) runs
    on ``PLAIN`` whatever ``kernels`` says, the fallback recorded, on any
    device."""
    olr, qc, mcut, supported = _string_plan(spec, mim, mcut)
    if not supported and kernels is not PLAIN:
        record_plain_fold(spec)
        kernels = PLAIN
    views_t, npix, hp, wp = _merge_channel_views(xT, spec.positions, qc)
    cores_lro = tuple(_core_to_lro(c, o, l, r, qc) for c, (o, l, r) in zip(cores, olr))
    out = ConvSBSApply.apply(views_t, olr, mcut, kernels, *cores_lro)
    return out.reshape(-1, hp, wp, xT.shape[4])
