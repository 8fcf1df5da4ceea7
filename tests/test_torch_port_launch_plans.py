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
it took before its d_core contraction; the ConvSBS forward (csrc/sbs_fwd.cu)
takes the legacy strings and the plan's edges on its register route, the
rest on its shared-memory kernel, and every string it took before. The int8 forward (csrc/eps_fwd_q8.cu)
takes every layer of the flagship and the three-EPS QAT model on its wgmma
kernel, tiles pixels and Z without overlap, and takes every shape it took
before. No kernel runs here; this file imports neither jax nor the JAX
package.
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from dctn_tpu_torch.kernels import eps_kernels as K
from dctn_tpu_torch.kernels import eps_q8_kernels as Q8
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
    # a tensor- or spatial-parallel rank's shapes (chip_smoke phase 5c)
    shapes += [(label, n, q, n1, o, npix)
               for label, _, n, q, n1, o, npix in chip_smoke.grid_shard_shapes()]
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


# the plans a grid rank's shapes of the flagship take at batch 128 a data
# rank (chip_smoke.grid_shard_shapes): K1's kernel and its Z tiles, K8's form
# and N tiles, and eps_dcore's pixel slices on 132 SMs. Layer 1 on 3 or 2
# rows of O has 48 or 32 of the (Z, A) tiles where the whole layer has 96, so
# eps_dcore sums 5 or 8 pixel slices where the whole layer takes one; under
# SP x TP the O = 3 row block on a slab takes TP's plan
_GRID_PLANS = {
    "TP layer 1, O=3 (model 2)": ("wgmma", 3, "wgmma", 3, 5),
    "TP layer 1, O=2 (model 3)": ("wgmma", 2, "wgmma", 2, 8),
    "SP layer 0, 14 rows (space 2)": ("wgmma", 4, "wgmma", 4, 16),
    "SP layer 1, 14 rows (space 2)": ("wgmma", 6, "wgmma", 6, 1),
    "SP layer 0, 7 rows (space 4)": ("wgmma", 4, "wgmma", 4, 16),
    "SP layer 1, 7 rows (space 4)": ("wgmma", 6, "wgmma", 6, 1),
    "SP x TP layer 1, O=3, 14 rows (space 2, model 2)": ("wgmma", 3, "wgmma", 3, 5),
    "SP x TP layer 1, O=3, 7 rows (space 4, model 2)": ("wgmma", 3, "wgmma", 3, 5),
}


@pytest.mark.parametrize("label,layer,n,q,n1,o,npix", chip_smoke.grid_shard_shapes(),
                         ids=[s[0] for s in chip_smoke.grid_shard_shapes()])
def test_grid_shard_shapes_take_their_plans(label, layer, n, q, n1, o, npix):
    """The launch plans of the shapes a TP, SP or SP x TP rank gives the
    flagship's layers, pinned: each takes the kernel the whole layer takes;
    only ``eps_dcore``'s pixel slices follow the smaller Z."""
    fwd, z_tiles, form, n_tiles, slices = _GRID_PLANS[label]
    plan = K._fwd_plan(n, q, n1, o, npix)
    assert (plan["kernel"], plan["grid"][1]) == (fwd, z_tiles)
    assert plan["grid"][0] == math.ceil(npix / K._FWD_TILE_P)
    q8 = Q8._q8_plan(n, q, n1, o, npix)
    assert (q8["form"], q8["tiles"]) == (form, n_tiles)
    assert K._dcore_slices(o * q ** (n - n1), q**n1, npix, _SMS) == slices


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


# ---------------------------------------------------------------------------
# K10 and K12's forward (csrc/sbs_fwd.cu): the register route where its plan
# holds the string, the shared-memory kernel for the rest


@pytest.mark.parametrize("index", range(4), ids=[s[0] for s in _legacy_strings()])
def test_sbs_fwd_legacy_strings_take_the_register_route(index):
    """Every legacy string folds toward its output core (core 4: o = 2 at
    layer 0, 10 at layer 1) with bond 4, q^C within 4, and the ring bond 1
    (open) or 4; its cores staged as (P − 1 + o) q^C 4×4 slabs. Both
    families take the same plan."""
    label, olr, qc, _ = _legacy_strings()[index]
    layer, ring = int(label.split()[1]), label.endswith("ring")
    oc = 2 if layer == 0 else 10
    for mcut in (None, S._mim_cut(olr)):
        route, plan = S._fwd_route(olr, qc, mcut)
        assert route == "registers"
        assert (plan.c, plan.B, plan.B0, plan.KQ) == (4, 4, 4 if ring else 1, 4)
        assert plan.smem_bytes == 4 * (8 + oc) * qc * 16 == (1280 if layer == 0 else 4608)
        assert plan.ints[:8] == (9, qc, 4 if ring else 1, 4, oc, 4, 4 if ring else 1, 4)
        assert plan.ints[8:17] == tuple(l for _, l, _ in olr)
        assert plan.ints[24:33] == tuple(r for _, _, r in olr)
        assert len(plan.ints) == 8 + 2 * 16


# (label, olr, q^C, route, (c, B, B0, KQ) on the register route)
_FWD_EDGES = [
    ("bond 8, three channels", _edge(5, 1, 8, 8, 3), 8, "registers", (2, 8, 1, 16)),
    ("ring bond 4 at q^C 16", _edge(4, 4, 4, 16, 2), 16, "registers", (2, 4, 4, 16)),
    ("ring bond 3 pads to 4", _edge(6, 3, 4, 2, 5), 2, "registers", (3, 4, 4, 4)),
    ("ring bond 2", _edge(6, 2, 5, 3, 5), 3, "registers", (3, 8, 2, 4)),
    ("16 cores", _edge(16, 4, 8, 16, 2), 16, "registers", (8, 8, 4, 16)),
    ("every o 1: the middle core", _edge(8, 1, 4, 4, 1), 4, "registers", (3, 4, 1, 4)),
    ("output on core 0", ((3, 4, 4), (1, 4, 4), (1, 4, 4)), 4, "registers", (0, 4, 4, 4)),
    ("one core", ((6, 3, 3),), 4, "registers", (0, 4, 4, 4)),
    ("staged cores at the shared memory's edge", _edge(16, 4, 8, 16, 41), 16, "registers",
     (8, 8, 4, 16)),
    ("staged cores over the shared memory", _edge(16, 1, 5, 16, 42), 16, "shared", None),
    ("two cores with o > 1", ((2, 1, 4), (1, 4, 4), (3, 4, 1)), 2, "shared", None),
    ("two outputs in a ring of bond 4 at q^C 16", ((2, 4, 4), (1, 4, 4), (3, 4, 4)), 16, "shared",
     None),
]


@pytest.mark.parametrize("label,olr,qc,route,shape", _FWD_EDGES, ids=[e[0] for e in _FWD_EDGES])
def test_sbs_fwd_route_at_the_plan_edges(label, olr, qc, route, shape):
    """The register route takes a string with at most one core of o > 1,
    bonds within 8, a ring bond within 4 (padded to 1, 2 or 4), q^C within
    16 (4 or 16) and its staged cores within 227 KB; the shared-memory kernel
    takes the rest, at the family's merge position."""
    for mcut in (None, S._mim_cut(olr)):
        got, plan = S._fwd_route(olr, qc, mcut)
        assert got == route
        if route == "registers":
            assert (plan.c, plan.B, plan.B0, plan.KQ) == shape
            assert plan.smem_bytes == 4 * (len(olr) - 1 + olr[plan.c][0]) * qc * plan.B**2
            assert plan.smem_bytes <= S._MAX_SMEM_BYTES
        else:
            assert plan.ints[3] == (len(olr) if mcut is None else mcut)
            assert plan.smem_bytes <= S._MAX_SMEM_BYTES


def _fwd_parent_takes(olr, qc, mcut):
    """The rule the forward had before its register route: the shared-memory
    kernel's plan, which raises where 32 threads' states do not fit."""
    try:
        S._launch_plan(olr, qc, mcut, False)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("P", [3, 9, 16])
def test_sbs_fwd_takes_every_string_it_took(P):
    """Bonds 1–8, ring bonds 1–4, q^C up to 16, an output of up to 40 on
    the middle core, or outputs on two cores: every string the forward took
    before still has a route; every one with a single output core takes the
    register route (its staged cores fit), the two-output ones the
    shared-memory kernel."""
    took = 0
    for bond in range(1, 9):
        for b0 in range(1, 5):
            for qc in (1, 2, 4, 9, 16):
                for o in (1, 10, 40):
                    one = _edge(P, b0, bond, qc, o)
                    two = tuple((2 if i in (0, P - 1) else 1, l, r)
                                for i, (_, l, r) in enumerate(one))
                    for olr, want in ((one, "registers"), (two, "shared")):
                        for mcut in {None, S._mim_cut(olr)}:
                            if _fwd_parent_takes(olr, qc, mcut):
                                took += 1
                                assert S._fwd_route(olr, qc, mcut)[0] == want
    assert took > 0


# ---------------------------------------------------------------------------
# K8/K9 (csrc/eps_fwd_q8.cu): the wgmma kernel's 128-pixel tiles and N tiles
# of whole outputs (or passes of one), or the mma.sync kernel, from the shape
# alone

_cuda_spec = importlib.util.spec_from_file_location("torch_port_cuda_cases",
                                                    _ROOT / "tests" / "test_torch_port_cuda.py")
_cuda_cases = importlib.util.module_from_spec(_cuda_spec)
_cuda_spec.loader.exec_module(_cuda_cases)


def _q8_shapes():
    """(label, n, q, n1, O, npix, form): the layers K8 and K9 run on the
    port's paths at batch 128 (the flagship's serving and QAT, the three-EPS
    model's QAT), then every shape of the card tests (``_Q8_SHAPES``)."""
    shapes = []
    for model, specs in (("flagship", chip_smoke.FLAGSHIP), ("three-EPS", chip_smoke.THREE)):
        for i, (n, q, n1, o, h) in enumerate(chip_smoke.layer_dims(specs)):
            shapes.append((f"{model} layer {i}", n, q, n1, o, chip_smoke.BATCH * h * h, "wgmma"))
    for n, q, n1, o, npix in _cuda_cases._Q8_SHAPES:
        # on mma.sync: A not a multiple of 4 (81, 5, 3, 2), or a wgmma plan
        # over 227 KB (n*q = 256 factor rows beside the staged tile; A = 676
        # on the staged route; A = 2048 on the register route)
        over = {(2, 128, 1), (2, 26, 2), (11, 2, 11), (14, 2, 11)}
        form = "mma.sync" if q**n1 % 4 or (n, q, n1) in over else "wgmma"
        shapes.append((f"card n={n} q={q} n1={n1} O={o} npix={npix}", n, q, n1, o, npix, form))
    return shapes


_Q8_PLAN_SHAPES = _q8_shapes()


def _q8_tiles(plan, b2, o):
    """Z rows [first, first + rows) of each N tile, as ``tile_rows`` in
    csrc/eps_fwd_q8.cu walks them."""
    z = o * b2
    if plan["passes"] > 1:
        return [(k // plan["passes"] * b2 + k % plan["passes"] * plan["n"],
                 min(plan["n"], b2 - k % plan["passes"] * plan["n"])) for k in range(plan["tiles"])]
    step = plan["outputs"] * b2
    return [(k * step, min(step, z - k * step)) for k in range(plan["tiles"])]


@pytest.mark.parametrize("label,n,q,n1,o,npix,form", _Q8_PLAN_SHAPES, ids=[s[0] for s in _Q8_PLAN_SHAPES])
def test_q8_launch_plan_fits_the_card(label, n, q, n1, o, npix, form):
    b2 = q ** (n - n1)
    plan = Q8._q8_plan(n, q, n1, o, npix)
    assert plan["form"] == form
    assert plan["smem_bytes"] <= K._MAX_SMEM_BYTES
    tile_p = 128 if form == "wgmma" else 64
    (grid_x,) = plan["grid"]
    # every pixel in exactly one tile
    assert grid_x * tile_p >= npix > (grid_x - 1) * tile_p and grid_x <= _GRID_X
    if form == "mma.sync":
        return
    assert plan["n"] == 256 and plan["stages"] >= 3
    # every row of Z in exactly one N tile, and every output whole in one
    # tile (or in its own passes, B2 > 256), the tile within N (and within
    # 128 rows where t is staged)
    rows = [z for first, count in _q8_tiles(plan, b2, o) for z in range(first, first + count)]
    assert sorted(rows) == list(range(o * b2))
    cap = plan["n"] if plan["route"] == "registers" else 128
    for first, count in _q8_tiles(plan, b2, o):
        assert 0 < count <= cap
        if plan["passes"] == 1:
            assert first % b2 == 0 and count % b2 == 0
        else:
            assert b2 > plan["n"] and first // b2 == (first + count - 1) // b2


@pytest.mark.parametrize("layer,tiles", [(0, 4), (1, 6)])
def test_q8_flagship_tiles_are_one_output_each(layer, tiles):
    """The flagship's layers (B2 = 256): one output per N tile of 256 rows,
    summed over b in registers; the three-EPS QAT layers (B2 = 1, 4, 6):
    all their outputs in one tile, summed over b on the staged tile."""
    n, q, n1, o, h = chip_smoke.layer_dims(chip_smoke.FLAGSHIP)[layer]
    plan = Q8._q8_plan(n, q, n1, o, chip_smoke.BATCH * h * h)
    assert (plan["outputs"], plan["passes"], plan["tiles"], plan["route"]) == (1, 1, tiles, "registers")
    for n, q, n1, o, h in chip_smoke.layer_dims(chip_smoke.THREE):
        plan = Q8._q8_plan(n, q, n1, o, chip_smoke.BATCH * h * h)
        assert (plan["outputs"], plan["tiles"], plan["route"]) == (o, 1, "staged")


def _q8_parent_takes(n, q, n1, o):
    """The rule the int8 forward had before its wgmma kernel: B2 <= 512,
    n*q <= 256, A*127^2 < 2^31, the digits of a and b in 32 bits, and its
    64-pixel tile's shared memory within 227 KB."""
    a, b2 = q**n1, q ** (n - n1)
    if b2 > 512 or n * q > 256 or a * 127 * 127 >= 2**31 or (q - 1).bit_length() * max(n1, n - n1) > 32:
        return False
    units = 8 if b2 % 16 == 0 else 128
    floats = n * q * 64 + 3 * 64 + units * 72
    return -(-4 * (floats + a + b2) // 16) * 16 + 64 * (-(-a // 64) * 64 + 64) <= K._MAX_SMEM_BYTES


@pytest.mark.parametrize("q_range", [(1, 9), (9, 33), (33, 129)])
def test_q8_takes_every_shape_it_took(q_range):
    """Every shape the kernel took before (n up to 13, O of 1 to 40) still
    passes the wrapper's checks, on one form or the other."""
    took = on_wgmma = 0
    for q in range(*q_range):
        for n in range(1, 14):
            for n1 in range(1, n + 1):
                for o in (1, 6, 40):
                    if not _q8_parent_takes(n, q, n1, o):
                        continue
                    took += 1
                    b2, a = q ** (n - n1), q**n1
                    views = torch.zeros((n, q, 8), device="meta")
                    wq = torch.zeros((o * b2, a), dtype=torch.int8, device="meta")
                    Q8._check_q8_args(views, wq, torch.zeros((o * b2, 1), device="meta"), n1, o)
                    on_wgmma += Q8._q8_plan(n, q, n1, o, 8)["form"] == "wgmma"
    assert took > 0 and 0 < on_wgmma <= took
