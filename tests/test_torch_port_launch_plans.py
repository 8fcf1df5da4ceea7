"""The launch plans of the 3xTF32 tensor-core kernels, on the CPU.

``eps_dcore`` runs 128 x 128 (Z, A) tiles over `_dcore_slices` pixel ranges
(csrc/eps_dcore.cu); the d_views kernel (csrc/eps_dviews_t.cu) one CTA per
64 pixels; the shared memory of both grows with n*q, B2 and O. At every layer
shape ``chip_smoke.py`` drives (``kernel_shapes``), and at the deep model's
layers at the batches its step runs (2048, and 512 per microbatch at
accumulation 4), the plans stay within the card's limits: at most 227 KB of
shared memory per block, 65,535 CTAs along a grid's y and z, 2^31 - 1
along x, and at most 64 slices, only where the tiles leave more than half of
an H100's 132 SMs idle, and then within two CTAs per SM. No kernel runs
here; this file imports neither jax nor the JAX package.
"""

import importlib.util
import math
from pathlib import Path

import pytest

from dctn_tpu_torch.kernels import eps_kernels as K

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
