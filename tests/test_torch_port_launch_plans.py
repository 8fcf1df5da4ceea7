"""The launch plans of the port's CUDA kernels, on the CPU.

``eps_fwd`` (csrc/eps_fwd.cu) gives each CTA 128 pixels and a Z tile of
whole outputs (or all B2 rows of one, in passes of 128 rows), so its sum
over b never crosses CTAs; its shared memory grows with n*q.
``eps_dcore`` runs 128 x 128 (Z, A) tiles over `_dcore_slices` pixel ranges
(csrc/eps_dcore.cu); the d_views kernel (csrc/eps_dviews_t.cu) one CTA per
64 pixels; the shared memory of both grows with n*q, B2 and O. At every layer
shape ``chip_smoke.py`` drives (``kernel_shapes``), and at the deep model's
layers at the batches its step runs (2048, and 512 per microbatch at
accumulation 4), the plans stay within the card's limits: at most 227 KB of
shared memory per block, 65,535 CTAs along a grid's y and z, 2^31 - 1
along x, and at most 64 slices, only where the tiles leave more than half of
an H100's 132 SMs idle, and then within two CTAs per SM. K13
(csrc/logmatmulexp.cu) splits R by the shape alone and fits three CTAs on
an SM at every case of ``chip_smoke.LME_SHAPES``; the ConvSBS backward
(csrc/sbs_bwd.cu) plans threads, CTAs and shared memory within the card's
limits for the legacy strings and the scope's edge, and takes every string
it took before its d_core contraction. No kernel runs here; this file
imports neither jax nor the JAX package.
"""

import importlib.util
import math
from pathlib import Path

import pytest

from dctn_tpu_torch.kernels import eps_kernels as K
from dctn_tpu_torch.kernels import logmatmulexp_kernels as L
from dctn_tpu_torch.kernels import sbs_kernels as S

_ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", _ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

_GRID_X, _GRID_YZ = 2**31 - 1, 65535
_SMS = 132  # an H100 SXM's


def _shapes():
    shapes = list(chip_smoke.kernel_shapes())
    for batch in (chip_smoke.DEEP_BATCH, chip_smoke.DEEP_BATCH // 4):
        for i, (n, q, n1, o, h) in enumerate(chip_smoke.layer_dims(chip_smoke.DEEP)):
            shapes.append((f"deep layer {i} at batch {batch}", n, q, n1, o, batch * h * h))
    return shapes


_SHAPES = _shapes()


@pytest.mark.parametrize("label,n,q,n1,o,npix", _SHAPES, ids=[s[0] for s in _SHAPES])
def test_tensor_core_launch_plans_fit_the_card(label, n, q, n1, o, npix):
    z, a = o * q ** (n - n1), q**n1
    slices = K._dcore_slices(z, a, npix, _SMS)
    tiles = math.ceil(z / K._DCORE_TILE) * math.ceil(a / K._DCORE_TILE)
    assert 1 <= slices <= K._DCORE_MAX_SLICES
    assert slices == 1 or (2 * tiles <= _SMS and tiles * slices <= 2 * _SMS
                           and npix // slices >= K._DCORE_MIN_SLICE_PIXELS)
    assert math.ceil(a / K._DCORE_TILE) <= _GRID_X
    assert math.ceil(z / K._DCORE_TILE) <= _GRID_YZ and slices <= _GRID_YZ
    assert K._dcore_smem_bytes(n, q, n1, o) <= K._MAX_SMEM_BYTES
    assert math.ceil(npix / 64) <= _GRID_X
    for recompute in (False, True):
        assert K._dviews_smem_bytes(n, q, n1, o, recompute) <= K._MAX_SMEM_BYTES


@pytest.mark.parametrize("layer,sums", [(0, True), (1, False)])
def test_flagship_dcore_slice_sums_per_step_are_unchanged(layer, sums):
    """The flagship step at batch 128 launches one slice sum (layer 0, 16
    tiles over 16 slices); layer 1's 96 tiles take one slice and no sum."""
    n, q, n1, o, h = chip_smoke.layer_dims(chip_smoke.FLAGSHIP)[layer]
    assert (K._dcore_slices(o * q ** (n - n1), q**n1, chip_smoke.BATCH * h * h, _SMS) > 1) == sums


def test_dviews_refuses_a_shape_over_its_shared_memory():
    """B2 = 2^11 rows of v (and of d_v) for 64 pixels: over 227 KB in both
    forms; the wrapper refuses it before any launch."""
    import torch

    n, q, n1, o = 12, 2, 1, 1
    assert K._dviews_smem_bytes(n, q, n1, o, False) > K._MAX_SMEM_BYTES
    views = torch.zeros((n, q, 64), device="meta")
    cmt = torch.zeros((2**11, 2), device="meta")
    with pytest.raises(ValueError, match="shared memory"):
        K._check_dviews_args("eps_dviews_recompute", views, cmt, torch.zeros((o, 64), device="meta"),
                             None, n1, o)


def test_dcore_refuses_a_shape_over_its_shared_memory():
    """n2 = 0 with q = 64 and 300 output channels: 129 rows of g and of X
    staged per 32 pixels beside the totals, over 227 KB; the wrapper refuses
    it before any launch."""
    import torch

    n, q, n1, o = 4, 64, 4, 300
    assert K._dcore_smem_bytes(n, q, n1, o) > K._MAX_SMEM_BYTES
    views = torch.zeros((n, q, 64), device="meta")
    with pytest.raises(ValueError, match="shared memory"):
        K._check_dcore_args(views, torch.zeros((o, 64), device="meta"), n1, o)


@pytest.mark.parametrize("sms,slices", [(132, 16), (114, 14)])
def test_dcore_slices_follow_the_card_sm_count(sms, slices):
    """Flagship layer 0 at batch 128 (16 tiles) takes about two CTAs per SM
    of the card it runs on: an H100 SXM's 132, or an H100 PCIe's 114."""
    n, q, n1, o, h = chip_smoke.layer_dims(chip_smoke.FLAGSHIP)[0]
    assert K._dcore_slices(o * q ** (n - n1), q**n1, chip_smoke.BATCH * h * h, sms) == slices


# (label, n, q, n1, O, npix, kernel): the layers eps_fwd runs on the port's
# paths (kernel dims after the pair merge) at batch 128 and the deep
# model's at 2048, then every factor in u, a ragged pixel count, B2 = 512,
# n*q = 256 and O at its limit; with the kernel that takes each (wgmma where
# s = q^lv is a multiple of 4 and its shared memory fits)
_FWD_SHAPES = [
    ("flagship and deep layer 0", 8, 4, 4, 4, 128 * 625, "wgmma"),
    ("flagship layer 1", 9, 4, 5, 6, 128 * 529, "wgmma"),
    ("deep layer 1", 9, 4, 5, 12, 128 * 529, "wgmma"),
    ("deep layer 2", 4, 12, 3, 24, 128 * 484, "wgmma"),
    ("three-EPS layer 0", 2, 4, 2, 4, 128 * 729, "wgmma"),
    ("three-EPS layer 1", 4, 4, 3, 6, 128 * 676, "wgmma"),
    ("three-EPS layer 2", 4, 6, 3, 12, 128 * 625, "mma.sync"),
    ("deep layer 1 at batch 2048", 9, 4, 5, 12, 2048 * 529, "wgmma"),
    ("deep layer 2 at batch 2048", 4, 12, 3, 24, 2048 * 484, "wgmma"),
    ("n2=0", 4, 3, 4, 5, 1000, "mma.sync"),
    ("ragged npix", 6, 2, 3, 3, 777, "wgmma"),
    ("B2=512", 10, 2, 1, 2, 300, "mma.sync"),
    ("n*q=256", 2, 128, 1, 2, 300, "mma.sync"),
    ("n*q=76 with s=16", 19, 4, 15, 1, 300, "mma.sync"),  # the wgmma plan is over 227 KB
    ("O at its limit", 3, 5, 2, 65535, 300, "mma.sync"),
]


@pytest.mark.parametrize("label,n,q,n1,o,npix,kernel", _FWD_SHAPES, ids=[s[0] for s in _FWD_SHAPES])
def test_fwd_launch_plan_fits_the_card(label, n, q, n1, o, npix, kernel):
    b2 = q ** (n - n1)
    plan = K._fwd_plan(n, q, n1, o, npix)
    assert plan["kernel"] == kernel
    outputs, passes = plan["outputs"], plan["passes"]
    # the Z tile holds whole outputs, or all B2 rows of one in passes
    assert 1 <= outputs <= o
    if b2 <= K._FWD_TILE_Z:
        assert passes == 1
        assert outputs * b2 <= K._FWD_TILE_Z < (outputs + 1) * b2 or outputs == o
    else:
        assert outputs == 1 and passes == math.ceil(b2 / K._FWD_TILE_Z)
    # every output in exactly one Z tile, every pixel in one pixel tile
    grid_x, grid_y = plan["grid"]
    assert grid_y == math.ceil(o / outputs) and (grid_y - 1) * outputs < o
    assert grid_x * K._FWD_TILE_P >= npix > (grid_x - 1) * K._FWD_TILE_P
    assert grid_x <= _GRID_X and grid_y <= _GRID_YZ
    assert plan["smem_bytes"] <= K._MAX_SMEM_BYTES


@pytest.mark.parametrize("layer,outputs,tiles", [(0, 1, 4), (1, 1, 6)])
def test_fwd_flagship_tiles_take_whole_outputs(layer, outputs, tiles):
    """The flagship's layers (B2 = 256): one output per CTA in two passes of
    128 rows; the deep model's layer 2 (B2 = 12): 10 outputs, 3 Z tiles."""
    n, q, n1, o, h = chip_smoke.layer_dims(chip_smoke.FLAGSHIP)[layer]
    plan = K._fwd_plan(n, q, n1, o, chip_smoke.BATCH * h * h)
    assert (plan["outputs"], plan["passes"], plan["grid"][1]) == (outputs, 2, tiles)
    n, q, n1, o, h = chip_smoke.layer_dims(chip_smoke.DEEP)[2]
    plan = K._fwd_plan(n, q, n1, o, chip_smoke.BATCH * h * h)
    assert (plan["outputs"], plan["passes"], plan["grid"][1]) == (10, 1, 3)


# ---------------------------------------------------------------------------
# K13 (csrc/logmatmulexp.cu): a 64×64 tile per CTA, R in chunks of 32,
# split by the shape alone; its shifts kernel in slices of R

_SM_SMEM = 228 * 1024  # an H100 SM's shared memory; each CTA reserves 1 KB of it
_LME = [(c[0], c[1], c[2], c[3]) for c in chip_smoke.LME_SHAPES]


@pytest.mark.parametrize("label,theta,r,n_i", _LME, ids=[c[0] for c in _LME])
def test_lme_plan_fits_the_card(label, theta, r, n_i):
    plan = L._plan(theta, r, n_i)
    assert plan["tile"] == (64, 64, 32) and plan["threads"] == 64 * plan["warps_n"]
    grid_x, grid_y, splits = plan["grid"]
    assert (grid_x, grid_y) == (math.ceil(n_i / 64), math.ceil(theta / 64))
    assert splits == plan["splits"] == L._splits(theta, r, n_i)
    # every split has at least two chunks of R, and no CTA goes without one
    assert splits == 1 or plan["chunks"] // splits >= 2
    assert grid_x <= _GRID_X and grid_y <= _GRID_YZ and splits <= _GRID_YZ
    # 8 warps where the grid fits at two CTAs per SM, else 4 warps, three
    # CTAs per SM
    ctas = grid_x * grid_y * splits
    assert plan["warps_n"] == (4 if ctas <= 2 * _SMS else 2)
    assert plan["smem_bytes"] <= K._MAX_SMEM_BYTES
    assert 3 * (plan["smem_bytes"] + 1024) <= _SM_SMEM
    shifts = L._shift_plan(theta, r, n_i)
    assert shifts["slices"] == max(1, math.ceil(r / 2048))
    assert shifts["groups"] == math.ceil(theta / 8) + math.ceil(n_i / 32) <= _GRID_X
    # the split count, and with it the order of the sums, is the shape's alone
    assert L._plan(theta, r, n_i) == plan


def test_lme_large_r_runs_in_one_wave():
    """R = 32768: 16 tiles × 17 splits = 272 CTAs, within the 3 × 132 an H100
    holds at once (264 at two CTAs per SM would leave 8 for a second
    wave)."""
    plan = L._plan(256, 32768, 256)
    ctas = plan["grid"][0] * plan["grid"][1] * plan["grid"][2]
    assert ctas == 272 and 2 * _SMS < ctas <= 3 * _SMS and plan["threads"] == 128


# ---------------------------------------------------------------------------
# K11 and K12's backward (csrc/sbs_bwd.cu): threads and CTAs per string and
# pixel count


def _legacy_strings():
    from dctn_tpu_torch.models.conv_sbs_model import ConvSBSModelConfig

    out = []
    for ring in (False, True):
        for layer, specs in enumerate(ConvSBSModelConfig(2, 4, trace_edge=ring).layer_specs()):
            olr, qc, ok = S.sbs_supported(specs[0])
            assert ok
            side = 28 - 2 * (layer + 1)
            out.append((f"layer {layer} {'ring' if ring else 'open'}", olr, qc,
                        [b * side * side for b in chip_smoke.SBS_BATCHES]))
    return out


def _edge(P, b0, bond, qc, o=1):
    """A string at the scope's edge: P cores, ring bond b0, inner bonds
    ``bond``, output o on the middle core."""
    return tuple(((o if i == P // 2 else 1), b0 if i == 0 else bond, b0 if i == P - 1 else bond)
                 for i in range(P))


_SBS_STRINGS = _legacy_strings() + [
    ("ring bond 4, q^C 16", _edge(4, 4, 4, 16, 2), 16, [1000, 60_000]),
    ("bond 8, three channels", _edge(5, 1, 8, 8, 3), 8, [1000, 60_000]),
    ("ring 4, bond 8, q^C 9", _edge(9, 4, 8, 9), 9, [1000, 60_000]),
    ("spills: bond 8, o 20, q^C 16", _edge(3, 1, 8, 16, 20), 16, [1000, 60_000]),
]


@pytest.mark.parametrize("label,olr,qc,npixes", _SBS_STRINGS, ids=[s[0] for s in _SBS_STRINGS])
def test_sbs_bwd_launch_fits_the_card(label, olr, qc, npixes):
    for mcut in (None, S._mim_cut(olr), 1, len(olr) - 1):
        plan = S._launch_plan(olr, qc, mcut, True)
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
        assert plan.smem_bytes == plan.bwd_smem_bytes(plan.threads) <= K._MAX_SMEM_BYTES
        assert plan.spill == (label.startswith("spills"))
        for npix in npixes:
            threads, blocks = S._bwd_launch(plan, npix, _SMS)
            smem = plan.bwd_smem_bytes(threads)
            per_sm = min(2048 // threads, 65536 // (128 * threads), _SM_SMEM // (smem + 1024))
            assert threads % 32 == 0 and 32 <= threads <= plan.threads
            assert smem <= K._MAX_SMEM_BYTES and per_sm >= 1
            assert 1 <= blocks <= min(math.ceil(npix / threads), per_sm * _SMS)


def test_sbs_bwd_layer0_batch100_shares_pixels_evenly():
    """Layer 0's strings at batch 100 (67,600 pixels): two CTAs of 256
    threads per SM (128 registers a thread), 264 in all, each with 256 or
    257 pixels; whole tiles of 256 would have left one CTA two tiles."""
    label, olr, qc, npixes = _legacy_strings()[0]
    plan = S._launch_plan(olr, qc, 4, True)
    threads, blocks = S._bwd_launch(plan, npixes[0], _SMS)
    assert (threads, blocks) == (256, 2 * _SMS)
    shares = {npixes[0] * (b + 1) // blocks - npixes[0] * b // blocks for b in range(blocks)}
    assert shares == {256, 257}


def _parent_takes(olr, qc, mcut):
    """The rule the backward had before its d_core contraction: the cores,
    one d_core sum per warp and the states at 32 threads within 227 KB."""
    state = S._layout(olr, len(olr) if mcut is None else mcut, True)[1]
    nelem = sum(o * l * r * qc for o, l, r in olr)
    return 4 * (2 * nelem + 32 * state) <= K._MAX_SMEM_BYTES


@pytest.mark.parametrize("P", [3, 9, 16])
def test_sbs_bwd_takes_every_string_it_took(P):
    """Bonds 1–8, ring bonds 1–4, q^C up to 16, an output of up to 20 on the
    middle core: every string the backward took before still plans, on the
    contraction's tiles in shared memory or, where they do not fit, in
    device memory."""
    took = spilled = 0
    for bond in range(1, 9):
        for b0 in range(1, 5):
            for qc in (1, 2, 4, 9, 16):
                for o in (1, 10, 20):
                    olr = _edge(P, b0, bond, qc, o)
                    for mcut in {None, S._mim_cut(olr)}:
                        if _parent_takes(olr, qc, mcut):
                            took += 1
                            spilled += S._launch_plan(olr, qc, mcut, True).spill
    assert took > 0 and spilled < took
