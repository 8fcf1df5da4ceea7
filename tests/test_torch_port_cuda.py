"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed. ``tests/conftest.py`` imports jax, so on such a
machine run it without the conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

On a host without a CUDA device every test skips itself.

Tolerance 1e-4·max|ref| unless said: kernel and plain version are both
float32 and differ only in the order of their sums (the ConvSBS folds'
sums over ≤ 160 bond and output terms per pixel and, in d_cores, over up
to 57,600 pixels). The int8 forward's
quantized operands and int32 sums are exact on both sides, so its saved t
and its column scales are held bit for bit. K13, the log-space product, is
held per entry of its log output (``_assert_lme_close``: a random walk of R
roundings plus ulps of the larger of the output and the summed shifts), with
−inf where the plain version has it and no NaN.
"""

import math

import pytest
import torch

from dctn_tpu_torch.kernels import eps_kernels as K
from dctn_tpu_torch.kernels import eps_q8_kernels as Q8
from dctn_tpu_torch.kernels import sbs_kernels as S
from dctn_tpu_torch.models import conv_sbs_model as CSM
from dctn_tpu_torch.ops import sbs as SBS
from dctn_tpu_torch.utils.pos2d import Pos2D

REL_TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, n, q, n1, o, npix, seed=0):
    g_ = torch.Generator(device=dev).manual_seed(seed)
    views = torch.rand((n, q, npix), generator=g_, device=dev)
    cmt = torch.randn((o * q ** (n - n1), q**n1), generator=g_, device=dev) * q ** (-n / 2)
    g = torch.randn((o, npix), generator=g_, device=dev)
    return views, cmt, g


def _assert_close(got, ref):
    assert got.shape == ref.shape
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= REL_TOL * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,q,n1,o,npix",
    [
        (8, 4, 4, 4, 2 * 625),  # flagship layer 0 (merged), batch 2
        (9, 4, 5, 6, 2 * 529),  # flagship layer 1, batch 2
        (4, 3, 4, 5, 1000),  # n2 = 0: out = t; A = 81 is not a chunk multiple
        (6, 2, 3, 3, 777),  # ragged last pixel tile
        (3, 5, 1, 2, 130),  # B2 = 25, not a multiple of the 8-row tile
        (10, 2, 1, 2, 300),  # B2 = 512, the most the kernel takes
        (2, 128, 1, 2, 300),  # n·q = 256 staged factor rows, the most it takes (mma.sync)
    ],
)
def test_kernel_matches_plain_on_cuda(cuda_device, n, q, n1, o, npix):
    views, cmt, _ = _inputs(cuda_device, n, q, n1, o, npix)
    before = K.eps_fwd.launches
    got = K.eps_fwd(views, cmt, n1, o)
    torch.cuda.synchronize()
    assert K.eps_fwd.launches == before + 1
    ref = K.eps_fwd_reference(views, cmt, n1, o)
    assert got.shape == ref.shape == (o, npix)
    _assert_close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,q,n1,o,npix",
    [
        (9, 4, 5, 6, 2 * 529),  # flagship layer 1, batch 2: the layer that saves t
        (9, 4, 5, 6, 128 * 529),  # the same at batch 128
        (6, 2, 3, 3, 777),  # ragged: the scalar stores of the last tile
        (3, 5, 1, 2, 130),  # B2 = 25; npix not a multiple of 4
        (10, 2, 1, 2, 300),  # B2 = 512, the most the kernel takes: four passes
        # the other layers the port's paths run (kernel dims after the pair
        # merge), at 2 images
        (8, 4, 4, 4, 2 * 625),  # flagship and deep layer 0: B2 = 256, two passes of 128 rows
        (9, 4, 5, 12, 2 * 529),  # deep layer 1: Z = 3072
        (4, 12, 3, 24, 2 * 484),  # deep layer 2: B2 = 12, Z tiles of 10, 10 and 4 outputs
        (2, 4, 2, 4, 2 * 729),  # three-EPS layer 0: n2 = 0, out = t
        (4, 4, 3, 6, 2 * 676),  # three-EPS layer 1: A = 64, B2 = 4
        (4, 6, 3, 12, 2 * 625),  # three-EPS layer 2: s = 6, the mma.sync kernel
    ],
)
def test_forward_with_t_matches_plain(cuda_device, n, q, n1, o, npix):
    """Both outputs against the plain version and against float64 (3xTF32
    keeps float32 accuracy); the serving form's out is the save_t form's,
    bit for bit (the two share their sums)."""
    views, cmt, _ = _inputs(cuda_device, n, q, n1, o, npix)
    before = (K.eps_fwd.launches, K.eps_fwd.t_launches)
    out, t = K.eps_fwd(views, cmt, n1, o, save_t=True)
    torch.cuda.synchronize()
    assert (K.eps_fwd.launches, K.eps_fwd.t_launches) == (before[0] + 1, before[1] + 1)
    ref_out, ref_t = K.eps_fwd_reference(views, cmt, n1, o, save_t=True)
    _assert_close(out, ref_out)
    _assert_close(t, ref_t)
    out64, t64 = K.eps_fwd_reference(views.double().cpu(), cmt.double().cpu(), n1, o, save_t=True)
    _assert_close(out.double().cpu(), out64)
    _assert_close(t.double().cpu(), t64)
    # the same launch without t gives the same output
    torch.testing.assert_close(K.eps_fwd(views, cmt, n1, o), out, rtol=0, atol=0)


_BWD_SHAPES = [
    (8, 4, 4, 4, 2 * 625),  # flagship layer 0 (merged), batch 2
    (9, 4, 5, 6, 2 * 529),  # flagship layer 1, batch 2
    (4, 3, 4, 5, 1000),  # n2 = 0: kr2 = g; A = 81 is not a tile multiple
    (6, 2, 3, 3, 777),  # ragged last pixel tile
    (3, 5, 1, 2, 130),  # B2 = 25, Z = 50: ragged Z tile
    (5, 3, 2, 7, 9000),  # Z = 189, A = 9: ragged tiles, and pixel slices
    (2, 128, 1, 2, 300),  # n·q = 256 staged factor rows, the most they take
    # the deep (4,4),(3,12),(2,24) config's middle layer, batch 2: O = 12,
    # Z = 3072, whose d_cmt the TPU runs o-tiled (K5, pix_axis=1)
    (9, 4, 5, 12, 2 * 529),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,q,n1,o,npix",
    _BWD_SHAPES + [
        (8, 4, 4, 4, 128 * 625),  # flagship layer 0 at batch 128: 5 pixel slices
        (9, 4, 5, 6, 128 * 529),  # flagship layer 1 at batch 128
    ],
)
def test_dcore_matches_plain(cuda_device, n, q, n1, o, npix):
    views, _, g = _inputs(cuda_device, n, q, n1, o, npix)
    before = K.eps_dcore.launches
    got = K.eps_dcore(views, g, n1, o)
    torch.cuda.synchronize()
    assert K.eps_dcore.launches == before + 1
    _assert_close(got, K.eps_dcore_reference(views, g, n1, o))


@pytest.mark.cuda
def test_dcore_is_the_same_from_run_to_run(cuda_device):
    views, _, g = _inputs(cuda_device, 8, 4, 4, 4, 40_000)
    assert K._dcore_slices(1024, 256, 40_000, K._sm_count(cuda_device)) > 1
    torch.testing.assert_close(
        K.eps_dcore(views, g, 4, 4), K.eps_dcore(views, g, 4, 4), rtol=0, atol=0
    )


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,q,n1,o,npix",
    _BWD_SHAPES + [
        (9, 4, 5, 6, 128 * 529),  # flagship layer 1 at batch 128
        (9, 2, 2, 2, 300),  # B2 = 128, n2 = 7: a long front peel
        (4, 2, 3, 1, 64),  # n2 = 1: no peel step; one exact tile
    ],
)
def test_dviews_t_matches_plain(cuda_device, n, q, n1, o, npix):
    views, cmt, g = _inputs(cuda_device, n, q, n1, o, npix)
    t = K.eps_fwd_reference(views, cmt, n1, o, save_t=True)[1] if n1 < n else None
    before = K.eps_dviews_t.launches
    got = K.eps_dviews_t(views, cmt, g, t, n1, o)
    torch.cuda.synchronize()
    assert K.eps_dviews_t.launches == before + 1
    _assert_close(got, K.eps_dviews_t_reference(views, cmt, g, t, n1, o))


@pytest.mark.cuda
def test_dviews_t_with_zero_factors(cuda_device):
    """Black pixels make whole factors 0; no leave-one-out product may
    divide by them."""
    views, cmt, g = _inputs(cuda_device, 9, 4, 5, 6, 700)
    views[:, 0, ::3] = 0.0
    views[2, :, ::5] = 0.0
    t = K.eps_fwd_reference(views, cmt, 5, 6, save_t=True)[1]
    got = K.eps_dviews_t(views, cmt, g, t, 5, 6)
    _assert_close(got, K.eps_dviews_t_reference(views, cmt, g, t, 5, 6))


_RECOMPUTE_SHAPES = [
    (9, 4, 5, 6, 128 * 529),  # flagship layer 1 at batch 128, forced onto the arm
    (9, 4, 5, 12, 128 * 529),  # the deep model's layer 1 at batch 128: Z = 3072
    (4, 6, 3, 12, 128 * 625),  # three-EPS layer 2: A = 216, not a chunk multiple
    (4, 4, 3, 6, 2 * 676),  # three-EPS layer 1: A = 64, B2 = 4
    (4, 12, 3, 24, 2 * 484),  # the deep model's layer 2: q = 12, Z = 288
    (4, 3, 4, 5, 1000),  # n2 = 0: no t to recompute
    (6, 2, 3, 3, 777),  # ragged last pixel tile
    (3, 5, 1, 2, 130),  # B2 = 25, Z = 50: a ragged Z chunk
    (9, 2, 2, 2, 300),  # B2 = 128: two Z chunks per channel
    (5, 3, 2, 7, 900),  # B2 = 27: a channel split across Z chunks
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,n1,o,npix", _RECOMPUTE_SHAPES)
def test_dviews_recompute_matches_plain(cuda_device, n, q, n1, o, npix):
    views, cmt, g = _inputs(cuda_device, n, q, n1, o, npix)
    before = K.eps_dviews_recompute.launches
    got = K.eps_dviews_recompute(views, cmt, g, n1, o)
    torch.cuda.synchronize()
    assert K.eps_dviews_recompute.launches == before + 1
    _assert_close(got, K.eps_dviews_recompute_reference(views, cmt, g, n1, o))


@pytest.mark.cuda
def test_dviews_recompute_with_zero_factors(cuda_device):
    views, cmt, g = _inputs(cuda_device, 9, 4, 5, 6, 700)
    views[:, 0, ::3] = 0.0
    views[2, :, ::5] = 0.0
    views[7, :, 1::4] = 0.0  # a v factor: t stays, d_v's chain sees zeros
    got = K.eps_dviews_recompute(views, cmt, g, 5, 6)
    _assert_close(got, K.eps_dviews_recompute_reference(views, cmt, g, 5, 6))


@pytest.mark.cuda
def test_dviews_recompute_is_the_same_from_run_to_run(cuda_device):
    views, cmt, g = _inputs(cuda_device, 9, 4, 5, 12, 20_000)
    torch.testing.assert_close(
        K.eps_dviews_recompute(views, cmt, g, 5, 12),
        K.eps_dviews_recompute(views, cmt, g, 5, 12), rtol=0, atol=0,
    )


@pytest.mark.cuda
def test_recompute_arm_runs_the_bundles_member(cuda_device):
    """A layer on the recompute arm (A = 64) takes its d_views from the
    bundle's recompute member: the kernel on KERNELS, the plain version on
    PLAIN, which runs on the card too; both agree."""
    xT = torch.rand((1, 4, 9, 9, 3), device=cuda_device, requires_grad=True)
    cmt = (torch.randn((6 * 4, 64), device=cuda_device) * 0.125).requires_grad_(True)
    grads = []
    for kernels in (K.KERNELS, K.PLAIN):
        before = (K.eps_dviews_recompute.launches, K.eps_fwd.t_launches)
        out = K.eps_apply_t_cmt(cmt, xT, 6, 2, 3, False, layer_index=1, kernels=kernels)
        grads.append(torch.autograd.grad(torch.sum(out * torch.cos(out)), (xT, cmt)))
        launched = K.eps_dviews_recompute.launches - before[0]
        assert launched == (1 if kernels is K.KERNELS else 0)
        assert K.eps_fwd.t_launches == before[1]
    for a, b in zip(*grads):
        _assert_close(a, b)


@pytest.mark.cuda
def test_kernels_and_plain_versions_hold_to_a_float64_oracle(cuda_device):
    n, q, n1, o, npix = 6, 3, 3, 4, 2000
    views, cmt, g = _inputs(cuda_device, n, q, n1, o, npix)
    v64, c64, g64 = (x.double().cpu() for x in (views, cmt, g))
    out64, t64 = K.eps_fwd_reference(v64, c64, n1, o, save_t=True)
    t = t64.float().to(cuda_device)
    cases = [
        (K.eps_fwd(views, cmt, n1, o, save_t=True)[1], K.eps_fwd_reference(views, cmt, n1, o, True)[1], t64),
        (K.eps_dcore(views, g, n1, o), K.eps_dcore_reference(views, g, n1, o),
         K.eps_dcore_reference(v64, g64, n1, o)),
        (K.eps_dviews_t(views, cmt, g, t, n1, o), K.eps_dviews_t_reference(views, cmt, g, t, n1, o),
         K.eps_dviews_t_reference(v64, c64, g64, t64, n1, o)),
        (K.eps_dviews_recompute(views, cmt, g, n1, o),
         K.eps_dviews_recompute_reference(views, cmt, g, n1, o),
         K.eps_dviews_recompute_reference(v64, c64, g64, n1, o)),
    ]
    for got, plain, oracle in cases:
        _assert_close(got.double().cpu(), oracle)
        _assert_close(plain.double().cpu(), oracle)


@pytest.mark.cuda
def test_layer_gradients_match_the_plain_path(cuda_device):
    """EPSApplyTCmt on the kernels against the same Function on the plain
    versions, saved-t arm (layer 1 of the flagship) and d_cmt-only arm."""
    xT = torch.rand((1, 4, 9, 9, 3), device=cuda_device, requires_grad=True)
    cmt = torch.randn((6 * 256, 1024), device=cuda_device) * 4**-4.5
    cmt.requires_grad_(True)
    grads = []
    for kernels in (K.KERNELS, K.PLAIN):
        out = K.eps_apply_t_cmt(cmt, xT, 6, 3, 5, False, layer_index=1, kernels=kernels)
        grads.append(torch.autograd.grad(torch.sum(out * torch.cos(out)), (xT, cmt)))
    for a, b in zip(*grads):
        _assert_close(a, b)
    before = K.eps_fwd.t_launches
    x0 = torch.rand((1, 2, 8, 8, 3), device=cuda_device)
    c0 = (torch.randn((4 * 256, 256), device=cuda_device) * 2.0**-8).requires_grad_(True)
    d = [torch.autograd.grad(K.eps_apply_t_cmt(c0, x0, 4, 4, 8, True, layer_index=0,
                                               kernels=k).sum(), c0)[0]
         for k in (K.KERNELS, K.PLAIN)]
    _assert_close(*d)
    assert K.eps_fwd.t_launches == before


@pytest.mark.cuda
def test_kernel_refuses_shapes_outside_its_limits(cuda_device):
    views = torch.zeros((11, 2, 64), device=cuda_device)
    cmt = torch.zeros((1024, 2), device=cuda_device)
    with pytest.raises(ValueError, match="limits"):
        K.eps_fwd(views, cmt, 1, 1)


@pytest.mark.cuda
def test_backward_kernels_refuse_shapes_outside_their_limits(cuda_device):
    big = torch.zeros((33, 8, 64), device=cuda_device)  # n·q = 264
    with pytest.raises(ValueError, match="limits"):
        K.eps_dcore(big, torch.zeros((1, 64), device=cuda_device), 32, 1)
    # B2 = 2^11 rows of v: over a block's shared memory
    v = torch.zeros((12, 2, 64), device=cuda_device)
    c = torch.zeros((2**11, 2), device=cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        K.eps_dviews_t(v, c, torch.zeros((1, 64), device=cuda_device),
                       torch.zeros((2**11, 64), device=cuda_device), 1, 1)
    with pytest.raises(ValueError, match="eps_dviews_recompute kernel limits exceeded"):
        K.eps_dviews_recompute(v, c, torch.zeros((1, 64), device=cuda_device), 1, 1)


# ---------------------------------------------------------------------------
# the 3xTF32 tensor-core kernels' tiling: eps_fwd's 128-pixel tiles of whole
# outputs over 32-column steps of A (t for eps_fwd_t), eps_dcore's 128 x 128
# (Z, A) tiles over 32-pixel steps, the d_views kernel's 64-pixel tiles with
# MA = 128 (or 64) rows of A or Z per product and 32 K rows per step

# (n, q, n1, O, npix): Z = O·q^(n-n1), A = q^n1 and npix below 16, between 16
# and 128, and just over 128; n2 = 0; pixel slices
_TILING_SHAPES = [
    (3, 3, 2, 4, 15),  # Z 12, A 9, npix 15: all below 16
    (3, 3, 2, 20, 100),  # Z 60, A 9, npix 100
    (3, 3, 2, 43, 129),  # Z 129, A 9, npix 129: just over 128
    (3, 12, 2, 2, 129),  # Z 24, A 144: just over 128 (two tiles, 16 rows in the second)
    (2, 12, 2, 129, 40),  # n2 = 0: Z = O = 129, A 144; kr2 = g
    (4, 2, 4, 3, 20),  # n2 = 0: Z 3, A 16
    (3, 5, 2, 26, 9000),  # Z 130, A 25: two Z tiles, eight pixel slices
    (6, 3, 3, 1, 20_000),  # Z 27, A 27: one tile, 19 pixel slices, A % 4 != 0
    # n·q = 256: d_views' leave-one-out fold (dX, dY do not fit), and MA = 64
    # rows of A per product in the recompute form
    (2, 128, 1, 2, 300),
]


def _tiling_case(dev, n, q, n1, o, npix, zero=False):
    views, cmt, g = _inputs(dev, n, q, n1, o, npix)
    if zero:  # black pixels: whole factors 0, in u and in v
        views[:, 0, ::3] = 0.0
        views[0, :, ::5] = 0.0
        views[n - 1, :, 1::4] = 0.0
    t = K.eps_fwd_reference(views, cmt, n1, o, save_t=True)[1] if n1 < n else None
    return views, cmt, g, t


_REDESIGNED = {
    "eps_fwd": (lambda M, v, c, g, t, n1, o: M.eps_fwd(v, c, n1, o),
                lambda v, c, g, t, n1, o: K.eps_fwd_reference(v, c, n1, o)),
    "eps_fwd_t": (lambda M, v, c, g, t, n1, o: M.eps_fwd(v, c, n1, o, save_t=True)[1],
                  lambda v, c, g, t, n1, o: K.eps_fwd_reference(v, c, n1, o, save_t=True)[1]),
    "eps_dcore": (lambda M, v, c, g, t, n1, o: M.eps_dcore(v, g, n1, o),
                  lambda v, c, g, t, n1, o: K.eps_dcore_reference(v, g, n1, o)),
    "eps_dviews_t": (lambda M, v, c, g, t, n1, o: M.eps_dviews_t(v, c, g, t, n1, o),
                     K.eps_dviews_t_reference),
    "eps_dviews_recompute": (lambda M, v, c, g, t, n1, o: M.eps_dviews_recompute(v, c, g, n1, o),
                             lambda v, c, g, t, n1, o: K.eps_dviews_recompute_reference(v, c, g, n1, o)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(_REDESIGNED))
@pytest.mark.parametrize("n,q,n1,o,npix", _TILING_SHAPES)
def test_tensor_core_tiling_matches_plain(cuda_device, kernel, n, q, n1, o, npix):
    views, cmt, g, t = _tiling_case(cuda_device, n, q, n1, o, npix)
    run, plain = _REDESIGNED[kernel]
    got = run(K, views, cmt, g, t, n1, o)
    torch.cuda.synchronize()
    _assert_close(got, plain(views, cmt, g, t, n1, o))


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,n1,o,npix,slices", [
    (3, 3, 2, 43, 129, 1),
    (3, 5, 2, 26, 9000, 8),
    (6, 3, 3, 1, 20_000, 19),
    (8, 4, 4, 4, 128 * 625, 16),  # flagship layer 0 at batch 128
    (9, 4, 5, 6, 128 * 529, 1),  # flagship layer 1 at batch 128: 96 tiles, no sum
])
def test_dcore_slices_as_planned(cuda_device, n, q, n1, o, npix, slices):
    """The pixel slices of the launch plan on an H100 SXM (132 SMs), and
    the slice sum launched where the card's own plan has more than one."""
    z, a = o * q ** (n - n1), q**n1
    assert K._dcore_slices(z, a, npix, 132) == slices
    slices = K._dcore_slices(z, a, npix, K._sm_count(cuda_device))
    views, _, g = _inputs(cuda_device, n, q, n1, o, npix)
    before = (K.eps_dcore.launches, K.eps_dcore.sum_launches)
    got = K.eps_dcore(views, g, n1, o)
    torch.cuda.synchronize()
    assert (K.eps_dcore.launches, K.eps_dcore.sum_launches) == (before[0] + 1, before[1] + (slices > 1))
    _assert_close(got, K.eps_dcore_reference(views, g, n1, o))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(_REDESIGNED))
@pytest.mark.parametrize("n,q,n1,o,npix", [(9, 4, 5, 6, 700), (6, 3, 3, 4, 9000), (3, 3, 2, 43, 129)])
def test_tensor_core_kernels_with_zero_factors(cuda_device, kernel, n, q, n1, o, npix):
    views, cmt, g, t = _tiling_case(cuda_device, n, q, n1, o, npix, zero=True)
    run, plain = _REDESIGNED[kernel]
    _assert_close(run(K, views, cmt, g, t, n1, o), plain(views, cmt, g, t, n1, o))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(_REDESIGNED))
@pytest.mark.parametrize("n,q,n1,o,npix", [(8, 4, 4, 4, 40_000), (9, 4, 5, 6, 20_000), (3, 5, 2, 26, 9000)])
def test_tensor_core_kernels_give_the_same_bits_twice(cuda_device, kernel, n, q, n1, o, npix):
    """No float atomics: the same inputs give the same bits."""
    views, cmt, g, t = _tiling_case(cuda_device, n, q, n1, o, npix)
    run = _REDESIGNED[kernel][0]
    torch.testing.assert_close(run(K, views, cmt, g, t, n1, o), run(K, views, cmt, g, t, n1, o),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(_REDESIGNED))
def test_tensor_core_kernels_hold_to_a_float64_oracle_at_flagship_layer_1(cuda_device, kernel):
    """3xTF32 at float32 accuracy: kernel within REL_TOL of the float64
    plain version at the flagship's layer 1 (batch 8: sums over 4,232
    pixels in d_cmt, 1,536 rows of Z in d_u and 1,024 columns of A in t)."""
    views, cmt, g, t = _tiling_case(cuda_device, 9, 4, 5, 6, 8 * 529)
    run, plain = _REDESIGNED[kernel]
    got = run(K, views, cmt, g, t, 5, 6).double().cpu()
    oracle = plain(*(None if x is None else x.double().cpu() for x in (views, cmt, g, t)), 5, 6)
    _assert_close(got, oracle)


# ---------------------------------------------------------------------------
# the int8 forward (K8, and K9 with t)

_Q8_SHAPES = [
    (8, 4, 4, 4, 2 * 625),  # flagship layer 0 (merged), batch 2
    (9, 4, 5, 6, 2 * 529),  # flagship layer 1, batch 2
    (8, 4, 4, 4, 128 * 625),  # flagship layer 0 at batch 128
    (9, 4, 5, 6, 128 * 529),  # flagship layer 1 at batch 128
    (4, 3, 4, 5, 1000),  # n2 = 0: out = t; A = 81: unaligned wq rows, ragged K step
    (6, 2, 3, 3, 777),  # ragged last pixel tile; B2 = 8: rows staged one by one
    (3, 5, 1, 2, 130),  # B2 = 25, A = 5
    (6, 3, 1, 2, 200),  # B2 = 243: a channel carried across blocks of 128 rows
    (10, 2, 1, 2, 300),  # B2 = 512, the most the kernel takes
    (2, 128, 1, 2, 300),  # n·q = 256 staged factor rows, the most it takes (mma.sync)
    (3, 4, 1, 7, 999),  # B2 = 16: warp sums, 7 channels in one block; odd npix
    (11, 2, 11, 1, 300),  # A = 2048 in shared memory, n2 = 0
    # the wgmma kernel's edges (kernels/eps_q8_kernels.py::_q8_plan)
    (3, 6, 2, 5, 4000),  # B2 = 6, summed on the staged tile: 30 of the N tile's 256 rows
    (3, 4, 2, 3, 555),  # Z = 12 < 16; 555 pixels: a ragged 128-pixel tile
    (11, 2, 2, 2, 1000),  # B2 = 512 in registers: two passes of 256 rows per output
    (2, 24, 2, 3, 1000),  # A = 576, the largest the staged route holds
    (2, 26, 2, 3, 1000),  # A = 676, over it: the mma.sync kernel
    (14, 2, 11, 1, 300),  # A = 2048 with B2 = 8, over the register route's 1,024: mma.sync
]


def _q8_inputs(dev, n, q, n1, o, npix, seed=0):
    views, cmt, _ = _inputs(dev, n, q, n1, o, npix, seed)
    return (views, *Q8.quantize_cmt(cmt))


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,n1,o,npix", _Q8_SHAPES)
def test_q8_kernel_matches_plain(cuda_device, n, q, n1, o, npix):
    views, wq, sw = _q8_inputs(cuda_device, n, q, n1, o, npix)
    before = (Q8.eps_fwd_q8.launches, Q8.eps_fwd_q8.t_launches)
    out = Q8.eps_fwd_q8(views, wq, sw, n1, o)
    out_t, t = Q8.eps_fwd_q8(views, wq, sw, n1, o, save_t=True)
    torch.cuda.synchronize()
    assert (Q8.eps_fwd_q8.launches, Q8.eps_fwd_q8.t_launches) == (before[0] + 2, before[1] + 1)
    ref_out, ref_t = Q8.eps_fwd_q8_reference(views, wq, sw, n1, o, save_t=True)
    assert out.shape == ref_out.shape == (o, npix)
    _assert_close(out, ref_out)
    assert torch.equal(t, ref_t)  # K9's t, bit for bit
    assert torch.equal(out_t, out)


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,n1,o,npix", _Q8_SHAPES)
def test_q8_kernel_bf16_t_matches_plain(cuda_device, n, q, n1, o, npix):
    """K9 storing t in bf16 (the bf16 QAT step's): t bit-equal to the plain
    version's and to the float32 K9's t rounded to nearest even, out
    bit-equal to the float32 K9's (both routes: the shapes span the wgmma
    and the mma.sync kernels, ``_q8_plan``)."""
    views, wq, sw = _q8_inputs(cuda_device, n, q, n1, o, npix)
    before = (Q8.eps_fwd_q8.t_launches, Q8.eps_fwd_q8.bf16_t_launches)
    out32, t32 = Q8.eps_fwd_q8(views, wq, sw, n1, o, save_t=True)
    out16, t16 = Q8.eps_fwd_q8(views, wq, sw, n1, o, save_t=True, t_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert (Q8.eps_fwd_q8.t_launches, Q8.eps_fwd_q8.bf16_t_launches) == (before[0] + 2,
                                                                          before[1] + 1)
    ref_out, ref_t = Q8.eps_fwd_q8_reference(views, wq, sw, n1, o, save_t=True,
                                             t_dtype=torch.bfloat16)
    assert t16.dtype == ref_t.dtype == torch.bfloat16
    assert torch.equal(t16, ref_t)
    assert torch.equal(t16, t32.to(torch.bfloat16))
    assert torch.equal(out16, out32)
    _assert_close(out16, ref_out)


@pytest.mark.cuda
def test_qat_bf16_layer_gradients_match_the_plain_path(cuda_device):
    """The bf16 QAT layer (the int8 forward on the float32 cmt, t in bf16,
    the bf16 backward) on the kernels against the same Function with the
    plain backward fed the kernel's t, at the flagship's layer 1 (saved-t
    arm): its output equals the float32 QAT layer's bit for bit."""
    xT = torch.rand((1, 4, 9, 9, 3), device=cuda_device, requires_grad=True)
    cmt = (torch.randn((6 * 256, 1024), device=cuda_device) * 4**-4.5).requires_grad_(True)
    plain_bwd = K.EPSKernels(Q8.QAT_KERNELS.fwd, K.eps_dcore_reference, K.eps_dviews_t_reference,
                             K.eps_dviews_recompute_reference, quantizes=True)
    res, before = [], Q8.eps_fwd_q8.bf16_t_launches
    for kernels in (Q8.QAT_KERNELS, plain_bwd):
        out = K.eps_apply_t_cmt(cmt, xT, 6, 3, 5, False, layer_index=1, kernels=kernels,
                                mm_dtype=torch.bfloat16)
        res.append((out, *torch.autograd.grad(torch.sum(out * torch.cos(out)), (xT, cmt))))
    assert Q8.eps_fwd_q8.bf16_t_launches - before == 2
    for a, b in zip(*res):
        _assert_close(a, b)
    f32 = K.eps_apply_t_cmt(cmt, xT, 6, 3, 5, False, layer_index=1, kernels=Q8.QAT_KERNELS)
    assert torch.equal(res[0][0], f32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,n1,o,npix", [(9, 4, 5, 6, 20_000), (4, 6, 3, 12, 9000), (11, 2, 2, 2, 1000)])
def test_q8_kernel_gives_the_same_bits_twice(cuda_device, n, q, n1, o, npix):
    """The register route (flagship layer 1, and B2 = 512 in two passes)
    and the staged one (three-EPS layer 2): out and t the same bits on a
    second run: the sums over b run in a fixed order."""
    views, wq, sw = _q8_inputs(cuda_device, n, q, n1, o, npix, seed=3)
    first = Q8.eps_fwd_q8(views, wq, sw, n1, o, save_t=True)
    second = Q8.eps_fwd_q8(views, wq, sw, n1, o, save_t=True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _max_abs_u_scales(views, n1):
    return Q8._quantize_columns(K._suffix_chain(views, 0, n1)[0])[1][0]


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,n1,o,npix", [(9, 4, 5, 6, 2 * 529), (8, 4, 4, 4, 700), (4, 3, 4, 5, 333)])
def test_q8_column_scales_equal_max_abs_u(cuda_device, n, q, n1, o, npix):
    """The kernel's closed-form su (the product of the factors' largest
    |entries|) is max|u| / 127 of the plain version, bit for bit."""
    views, wq, sw = _q8_inputs(cuda_device, n, q, n1, o, npix)
    views -= 0.5  # signed factors
    su = torch.empty(npix, device=cuda_device)
    Q8._launch_q8(views, wq, sw, n1, o, su=su)
    assert torch.equal(su, _max_abs_u_scales(views, n1))


@pytest.mark.cuda
def test_q8_with_zero_factors(cuda_device):
    """Black pixels are exact zeros after φ: a column of u that is all 0
    takes the 1e-30 guard scale and gives exact zeros, and partly zero
    factors quantize as in the plain version."""
    n, q, n1, o, npix = 9, 4, 5, 6, 700
    views, wq, sw = _q8_inputs(cuda_device, n, q, n1, o, npix)
    views[:, :, ::7] = 0.0  # every factor 0: u, v, out all 0
    views[2, :, 3::5] = 0.0  # one u factor 0: its u column is 0
    views[7, :, 4::5] = 0.0  # one v factor 0: t stays, out is 0
    views[0, 0, ::3] = 0.0  # partly zero
    su = torch.empty(npix, device=cuda_device)
    out = Q8._launch_q8(views, wq, sw, n1, o, su=su)
    out_t, t = Q8.eps_fwd_q8(views, wq, sw, n1, o, save_t=True)
    ref_out, ref_t = Q8.eps_fwd_q8_reference(views, wq, sw, n1, o, save_t=True)
    assert torch.equal(su, _max_abs_u_scales(views, n1))
    assert float(su[0]) == float(torch.tensor(1e-30)) and float(su[3]) == float(su[0])
    assert torch.equal(out[:, ::7], torch.zeros_like(out[:, ::7]))
    assert torch.equal(t, ref_t)
    _assert_close(out, ref_out)


@pytest.mark.cuda
def test_qat_layer_gradients_match_the_plain_path(cuda_device):
    """EPSApplyTCmt with the int8 forward (QAT_KERNELS) against the same
    Function on the plain versions: the saved-t arm of the flagship's layer
    1 and the d_cmt-only arm of layer 0."""
    xT = torch.rand((1, 4, 9, 9, 3), device=cuda_device, requires_grad=True)
    cmt = (torch.randn((6 * 256, 1024), device=cuda_device) * 4**-4.5).requires_grad_(True)
    res = []
    for kernels in (Q8.QAT_KERNELS, Q8.QAT_PLAIN):
        out = K.eps_apply_t_cmt(cmt, xT, 6, 3, 5, False, layer_index=1, kernels=kernels)
        res.append((out, *torch.autograd.grad(torch.sum(out * torch.cos(out)), (xT, cmt))))
    for a, b in zip(*res):
        _assert_close(a, b)
    x0 = torch.rand((1, 2, 8, 8, 3), device=cuda_device)
    c0 = (torch.randn((4 * 256, 256), device=cuda_device) * 2.0**-8).requires_grad_(True)
    before = Q8.eps_fwd_q8.t_launches
    d = [torch.autograd.grad(K.eps_apply_t_cmt(c0, x0, 4, 4, 8, True, layer_index=0,
                                               kernels=k).sum(), c0)[0]
         for k in (Q8.QAT_KERNELS, Q8.QAT_PLAIN)]
    _assert_close(*d)
    assert Q8.eps_fwd_q8.t_launches == before


@pytest.mark.cuda
def test_qat_recompute_arm_matches_the_plain_path(cuda_device):
    """The QAT bundles on a layer without a saved t (A = 216): the int8
    forward, then d_views recomputed in f32 from the f32 cmt, kernel
    against plain."""
    xT = torch.rand((1, 6, 9, 9, 3), device=cuda_device, requires_grad=True)
    cmt = (torch.randn((12 * 6, 216), device=cuda_device) * 6**-2).requires_grad_(True)
    res = []
    for kernels in (Q8.QAT_KERNELS, Q8.QAT_PLAIN):
        before = K.eps_dviews_recompute.launches
        out = K.eps_apply_t_cmt(cmt, xT, 12, 2, 3, False, layer_index=1, kernels=kernels)
        res.append((out, *torch.autograd.grad(torch.sum(out * torch.cos(out)), (xT, cmt))))
        assert K.eps_dviews_recompute.launches - before == (1 if kernels is Q8.QAT_KERNELS else 0)
    for a, b in zip(*res):
        _assert_close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,q,n1,o",
    [
        (11, 2, 1, 1),  # B2 = 1024 > 512
        (33, 8, 32, 1),  # n·q = 264 > 256
        (12, 2, 12, 1),  # A = 4096: uq over a block's shared memory
    ],
)
def test_q8_kernel_refuses_shapes_outside_its_limits(cuda_device, n, q, n1, o):
    views = torch.zeros((n, q, 64), device=cuda_device)
    wq = torch.zeros((o * min(q ** (n - n1), 2048), min(q**n1, 4096)), dtype=torch.int8,
                     device=cuda_device)
    sw = torch.ones((wq.shape[0], 1), device=cuda_device)
    with pytest.raises(ValueError, match="limits"):
        Q8.eps_fwd_q8(views, wq, sw, n1, o)
    with pytest.raises(ValueError, match="int8"):
        Q8.eps_fwd_q8(torch.zeros((2, 2, 64), device=cuda_device),
                      torch.zeros((2, 2), device=cuda_device), sw[:2], 1, 1)


# ---------------------------------------------------------------------------
# the ConvSBS fold (K10, K11, K12 forward and backward)


def _sbs_case(dev, layer, trace_edge, batch, seed=0, bond=4):
    """One string of the legacy 2-layer model (layer 0: q^C = 2, o = 2 on
    the middle core, 26×26 windows; layer 1: q^C = 4, o = 10, 24×24),
    random factors in [0, 1) and cores scaled so every m element is of
    order 1/bond, and a random output cotangent."""
    cfg = CSM.ConvSBSModelConfig(2, bond, trace_edge=trace_edge)
    spec = cfg.layer_specs()[layer][0]
    olr, qc, ok = S.sbs_supported(spec)
    assert ok
    side = 26 if layer == 0 else 24
    npix = batch * side * side
    g_ = torch.Generator(device=dev).manual_seed(seed)
    views = torch.rand((len(olr), qc, npix), generator=g_, device=dev)
    scale = 1.0 / (bond * (qc / 3) ** 0.5)
    cores = [torch.randn((l * r * o, qc), generator=g_, device=dev) * scale for o, l, r in olr]
    g = torch.randn((math.prod(o for o, _, _ in olr), npix), generator=g_, device=dev)
    return olr, views, cores, g


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [3, 100])
@pytest.mark.parametrize("mcut", [4, None])
@pytest.mark.parametrize("trace_edge", [False, True])
@pytest.mark.parametrize("layer", [0, 1])
def test_sbs_kernels_match_plain(cuda_device, layer, trace_edge, mcut, batch):
    """The forward and the backward (with and without d_views) of both
    families at the legacy layer shapes, against the plain versions."""
    olr, views, cores, g = _sbs_case(cuda_device, layer, trace_edge, batch)
    before = (S.sbs_fwd.mim_launches, S.sbs_fwd.seq_launches)
    out = S.sbs_fwd(views, cores, olr, mcut)
    torch.cuda.synchronize()
    assert (S.sbs_fwd.mim_launches - before[0], S.sbs_fwd.seq_launches - before[1]) == (
        (1, 0) if mcut else (0, 1))
    _assert_close(out, S.sbs_fwd_reference(views, cores, olr, mcut))
    for need in (True, False):
        dv, dc = S.sbs_bwd(views, cores, g, olr, mcut, need)
        rdv, rdc = S.sbs_bwd_reference(views, cores, g, olr, mcut, need)
        torch.cuda.synchronize()
        assert (dv is None) == (not need)
        if need:
            _assert_close(dv, rdv)
        for a, b in zip(dc, rdc):
            _assert_close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("trace_edge", [False, True])
def test_sbs_every_merge_position(cuda_device, trace_edge):
    olr, views, cores, g = _sbs_case(cuda_device, 1, trace_edge, 2)
    for mcut in range(1, len(olr)):
        _assert_close(S.sbs_fwd(views, cores, olr, mcut), S.sbs_fwd_reference(views, cores, olr, mcut))
        dv, dc = S.sbs_bwd(views, cores, g, olr, mcut, True)
        rdv, rdc = S.sbs_bwd_reference(views, cores, g, olr, mcut, True)
        _assert_close(dv, rdv)
        for a, b in zip(dc, rdc):
            _assert_close(a, b)


@pytest.mark.cuda
def test_sbs_dcore_partial_sums_are_the_same_from_run_to_run(cuda_device):
    olr, views, cores, g = _sbs_case(cuda_device, 1, True, 100)
    runs = [S.sbs_bwd(views, cores, g, olr, 4, True) for _ in range(2)]
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_sbs_kernels_hold_to_a_float64_oracle(cuda_device):
    olr, views, cores, g = _sbs_case(cuda_device, 1, True, 2)
    v64, c64, g64 = views.double().cpu(), [c.double().cpu() for c in cores], g.double().cpu()
    _assert_close(S.sbs_fwd(views, cores, olr, 4).double().cpu(),
                  S.sbs_fwd_reference(v64, c64, olr, 4))
    dv, dc = S.sbs_bwd(views, cores, g, olr, None, True)
    rdv, rdc = S.sbs_bwd_reference(v64, c64, g64, olr, None, True)
    _assert_close(dv.double().cpu(), rdv)
    for a, b in zip(dc, rdc):
        _assert_close(a.double().cpu(), b)


def _sequential_forward(params, cfg, x, kernels):
    """The model's batch-minor forward with every string on the sequential
    fold (``conv_sbs_t(mim=False)``, K12)."""
    xT = CSM.batch_to_quantum(x, cfg.cos_sin_squared, cfg.input_multiplier).permute(0, 4, 2, 3, 1)
    for layer_spec, layer_params in zip(cfg.layer_specs(), params):
        outs = [S.conv_sbs_t(s, c, xT, mim=False, kernels=kernels)
                for s, c in zip(layer_spec, layer_params)]
        xT = torch.stack(outs, dim=0)
    return outs[0].mean(dim=(1, 2)).T


@pytest.mark.cuda
@pytest.mark.parametrize("fold", ["auto", "sequential"])
def test_conv_sbs_model_gradients_match_the_plain_path(cuda_device, fold):
    """The legacy model's CE gradients, in the cores and in the pixels (layer
    0's d_views), on the kernels against the plain versions; d_views only
    where the input needs a gradient. ``auto`` is the model's own forward
    (meet-in-the-middle, K10/K11), ``sequential`` the same layers with every
    string through ``conv_sbs_t(mim=False)`` (K12)."""
    cfg = CSM.ConvSBSModelConfig(2, 4, trace_edge=True, cos_sin_squared=True)
    params = CSM.init_conv_sbs_model(torch.Generator().manual_seed(0), cfg)
    x = torch.rand((5, 28, 28), device=cuda_device)
    y = torch.arange(5, device=cuda_device)
    x = x.requires_grad_(True)
    params = CSM.scale_layers_using_batch(
        tuple(tuple(tuple(c.to(cuda_device) for c in s) for s in layer) for layer in params), cfg,
        x.detach(),
    )
    grads = []
    for kernels in (S.KERNELS, S.PLAIN):
        model = CSM.ConvSBSModel(params, cfg)
        before = (S.sbs_bwd.dviews_launches, S.sbs_bwd.mim_launches, S.sbs_bwd.seq_launches)
        logits = (model(x, kernels=kernels) if fold == "auto"
                  else _sequential_forward(model.params(), cfg, x, kernels))
        loss = torch.nn.functional.cross_entropy(logits, y)
        grads.append(torch.autograd.grad(loss, [x, *model.parameters()]))
        # layer 1's string, and layer 0's two strings, whose pixels need a gradient
        after = (S.sbs_bwd.dviews_launches, S.sbs_bwd.mim_launches, S.sbs_bwd.seq_launches)
        launched = [a - b for a, b in zip(after, before)]
        if kernels is S.PLAIN:
            assert launched == [0, 0, 0]
        else:
            assert launched == ([3, 3, 0] if fold == "auto" else [3, 0, 3])
    assert float(grads[0][0].abs().max()) > 0.0
    for a, b in zip(*grads):
        _assert_close(a, b)


@pytest.mark.cuda
def test_sbs_kernels_refuse_what_they_do_not_take(cuda_device):
    olr, views, cores, g = _sbs_case(cuda_device, 0, False, 1)
    with pytest.raises(ValueError, match="float32"):
        S.sbs_fwd(views.double(), [c.double() for c in cores], olr, 4)
    with pytest.raises(ValueError, match="not .l·r·o"):
        S.sbs_fwd(views, [cores[0][:-1]] + cores[1:], olr, 4)
    with pytest.raises(ValueError, match="merge cut"):
        S.sbs_bwd(views, cores, g, olr, 9, True)


# strings at the kernels' scope edge, as per-core (o, l, r) and q^C: a ring
# of bond 4 with q^C = 16 (two channels of q = 4), three channels (q^C = 8)
# with inner bonds of 8, a 9-core ring of bond 4 with bonds of 8, and one
# whose states leave no room for the d_core contraction's tiles in shared
# memory (they spill to device memory)
_SBS_EDGE = [
    (((1, 4, 4), (2, 4, 4), (1, 4, 4), (1, 4, 4)), 16),
    (((1, 1, 8), (1, 8, 8), (3, 8, 8), (1, 8, 8), (1, 8, 1)), 8),
    (tuple(((2 if i == 4 else 1), 4 if i == 0 else 8, 4 if i == 8 else 8) for i in range(9)), 9),
    (((1, 1, 8), (20, 8, 8), (1, 8, 1)), 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("olr,qc", _SBS_EDGE, ids=["ring4_qc16", "bond8_3ch", "ring4_bond8_9cores",
                                                    "spills"])
def test_sbs_bwd_at_the_scope_edge_matches_plain(cuda_device, olr, qc):
    """K11 (the model's merge position) and K12's backward at the strings of
    the scope's edge against the plain folds, d_views both ways."""
    g_ = torch.Generator(device=cuda_device).manual_seed(3)
    npix = 3001
    views = torch.rand((len(olr), qc, npix), generator=g_, device=cuda_device)
    cores = [torch.randn((l * r * o, qc), generator=g_, device=cuda_device) / (max(l, r) * qc**0.5)
             for o, l, r in olr]
    g = torch.randn((math.prod(o for o, _, _ in olr), npix), generator=g_, device=cuda_device)
    assert S._launch_plan(olr, qc, None, True).spill == (qc == 16 and len(olr) == 3)
    for mcut in (S._mim_cut(olr), None):
        for need in (True, False):
            dv, dc = S.sbs_bwd(views, cores, g, olr, mcut, need)
            rdv, rdc = S.sbs_bwd_reference(views, cores, g, olr, mcut, need)
            torch.cuda.synchronize()
            if need:
                _assert_close(dv, rdv)
            for a, b in zip(dc, rdc):
                _assert_close(a, b)


def _fwd_edge(P, b0, bond, o, at=None):
    """P cores, ring bond b0, inner bonds ``bond``, output o on core ``at``
    (the middle one by default)."""
    at = P // 2 if at is None else at
    return tuple(((o if i == at else 1), b0 if i == 0 else bond, b0 if i == P - 1 else bond)
                 for i in range(P))


# the forward's strings at its register route's plan edges and beside them,
# as (olr, q^C, route): bond 8 with three channels, a ring of bond 4 at q^C
# 16, ring bonds 3 and 2 (padded to 4 and 2), 16 cores of bond 8, every o 1
# (folded toward the middle core), the output on core 0 and on the last
# core, one core, uneven bonds, staged cores at and over the shared memory's
# edge, and two cores with o > 1 (the shared-memory kernel)
_SBS_FWD_EDGE = [
    (_fwd_edge(5, 1, 8, 3), 8, "registers"),
    (_fwd_edge(4, 4, 4, 2), 16, "registers"),
    (_fwd_edge(6, 3, 4, 5), 2, "registers"),
    (_fwd_edge(6, 2, 5, 5), 3, "registers"),
    (_fwd_edge(16, 4, 8, 2), 16, "registers"),
    (_fwd_edge(8, 1, 4, 1), 4, "registers"),
    (_fwd_edge(5, 4, 4, 3, at=0), 2, "registers"),
    (_fwd_edge(5, 4, 4, 3, at=4), 2, "registers"),
    (((6, 3, 3),), 4, "registers"),
    (((1, 1, 3), (1, 3, 5), (7, 5, 2), (1, 2, 6), (1, 6, 1)), 2, "registers"),
    (_fwd_edge(16, 4, 8, 41), 16, "registers"),
    (_fwd_edge(16, 1, 5, 42), 16, "shared"),
    (((2, 1, 4), (1, 4, 4), (3, 4, 1)), 2, "shared"),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "olr,qc,route", _SBS_FWD_EDGE,
    ids=["bond8_3ch", "ring4_qc16", "ring3", "ring2", "16_cores", "every_o_1", "out_core0",
         "out_last_core", "one_core", "uneven_bonds", "smem_edge", "over_smem_edge", "two_outputs"])
def test_sbs_fwd_routes_match_plain(cuda_device, olr, qc, route):
    """K10 and K12's forward at the register route's plan edges and on the
    shared-memory kernel against the plain folds, each family counted, the
    same bits on a second run."""
    g_ = torch.Generator(device=cuda_device).manual_seed(5)
    npix = 3001
    views = torch.rand((len(olr), qc, npix), generator=g_, device=cuda_device)
    cores = [torch.randn((l * r * o, qc), generator=g_, device=cuda_device) / (max(l, r) * qc**0.5)
             for o, l, r in olr]
    for mcut in (S._mim_cut(olr), None):
        assert S._fwd_route(olr, qc, mcut)[0] == route
        before = (S.sbs_fwd.mim_launches, S.sbs_fwd.seq_launches)
        out = S.sbs_fwd(views, cores, olr, mcut)
        torch.cuda.synchronize()
        assert (S.sbs_fwd.mim_launches - before[0], S.sbs_fwd.seq_launches - before[1]) == (
            (1, 0) if mcut else (0, 1))
        _assert_close(out, S.sbs_fwd_reference(views, cores, olr, mcut))
        torch.testing.assert_close(S.sbs_fwd(views, cores, olr, mcut), out, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("layer,trace_edge", [(0, False), (1, True)])
def test_sbs_fwd_gives_the_same_bits_twice(cuda_device, layer, trace_edge):
    """The legacy strings at batch 100 on the register route: both families
    the same bits on a second run, and the same bits as each other (one
    arithmetic order, folded toward the output core)."""
    olr, views, cores, _ = _sbs_case(cuda_device, layer, trace_edge, 100)
    assert S._fwd_route(olr, views.shape[1], None)[0] == "registers"
    runs = [S.sbs_fwd(views, cores, olr, mcut) for mcut in (4, 4, None, None)]
    for other in runs[1:]:
        torch.testing.assert_close(other, runs[0], rtol=0, atol=0)


def _wide_string(bonds, channels):
    """A two-core string outside the kernels' scope (the specs of
    test_torch_port_sbs.py::test_support_rule_and_kernel_plan)."""
    cores = tuple(SBS.SBSSpecCore(Pos2D(0, w), 1) for w in (0, 1))
    return SBS.SBSSpecString(cores, bonds, channels, 2)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bonds,channels", [((5, 5), 1), ((1, 9), 1), ((1, 2), 4)], ids=["ring5", "bond9", "four_ch"]
)
def test_repaired_sbs_scope_still_refuses_wide_strings_on_cuda(cuda_device, bonds, channels):
    """Strings outside the kernels' scope (a ring of bond 5, a bond of 9, 4
    channels): on the card ``conv_sbs_t`` decides before any launch to run
    them on the plain folds, as the JAX package runs its XLA fold, and
    records the fallback; no kernel launches, and the result is the plain
    fold's on the same card, bit for bit."""
    from dctn_tpu_torch.utils import fallbacks

    spec = _wide_string(bonds, channels)
    assert not S.sbs_supported(spec)[2]
    xT = torch.rand((channels, 2, 6, 6, 2), device=cuda_device)
    cores = [torch.randn(s.as_tuple(), device=cuda_device) for s in spec.shapes]
    before = (S.sbs_fwd.mim_launches, S.sbs_fwd.seq_launches)
    got = S.conv_sbs_t(spec, cores, xT)
    assert (S.sbs_fwd.mim_launches, S.sbs_fwd.seq_launches) == before
    assert any("outside kernel scope" in e for e in fallbacks.events())
    torch.testing.assert_close(got, S.conv_sbs_t(spec, cores, xT, kernels=S.PLAIN), rtol=0, atol=0)


@pytest.mark.cuda
def test_repaired_model_scope_still_refuses_ring_bond_5_on_cuda(cuda_device):
    """The model with ring bond 5 (outside the kernels' scope) runs every
    string on the plain folds on the card, the fallback recorded, no kernel
    launched: its logits equal the CPU plain fold's within REL_TOL."""
    from dctn_tpu_torch.utils import fallbacks

    cfg = CSM.ConvSBSModelConfig(2, 5, trace_edge=True)
    params = CSM.init_conv_sbs_model(torch.Generator().manual_seed(0), cfg)
    x = torch.rand((2, 28, 28))
    before = S.sbs_fwd.mim_launches + S.sbs_fwd.seq_launches
    got = CSM.ConvSBSModel(params, cfg, device=cuda_device)(x.to(cuda_device))
    assert S.sbs_fwd.mim_launches + S.sbs_fwd.seq_launches == before
    assert any("every string of the model" in e for e in fallbacks.events())
    _assert_close(got.cpu(), CSM.ConvSBSModel(params, cfg)(x))


# ---------------------------------------------------------------------------
# K13, the fused log-space product


def _lme_inputs(dev, theta, r, i, offset=0.0, neg_inf=False, seed=0):
    g_ = torch.Generator(device=dev).manual_seed(seed)
    la = torch.randn((theta, r), generator=g_, device=dev) * 3 + offset
    lb = torch.randn((r, i), generator=g_, device=dev) * 3 - offset
    if neg_inf:
        la[min(3, theta - 1)] = -math.inf
        lb[:, min(5, i - 1)] = -math.inf
        la[torch.rand((theta, r), generator=g_, device=dev) < 0.1] = -math.inf
        lb[torch.rand((r, i), generator=g_, device=dev) < 0.1] = -math.inf
    return la, lb


def _assert_lme_close(got, ref, r, amax, bmax):
    """K13 against its plain version: both float32, the sum over R in other
    orders (the kernel's chunks and splits of R, cuBLAS's blocking), so
    log(sum) differs by about √R·2⁻²⁴ (a random walk of R roundings), and
    adding the shifts rounds at an ulp of log(sum) + amax and of the output,
    whose magnitudes |amax| + |bmax| and |ref| bound: per entry 16·2⁻²⁴·√R +
    8·2⁻²⁴·max(|ref|, |amax| + |bmax|). −inf only where the plain version
    has it, and no NaN."""
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert not bool(torch.isnan(got).any())
    assert torch.equal(torch.isneginf(got), torch.isneginf(ref))
    fin = torch.isfinite(ref)
    shift = (amax.abs() + bmax.abs()).expand_as(ref)[fin]
    tol = 2.0**-24 * (16 * math.sqrt(r) + 8 * torch.maximum(ref[fin].abs(), shift))
    assert bool(((got[fin] - ref[fin]).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "theta,r,i,offset,neg_inf",
    [
        (256, 256, 256, 0.0, False),  # a chain link: R split 4 ways
        (256, 98, 490, 0.0, True),  # the classifier's step shape, R split 2 ways
        (100, 60, 37, 0.0, False),  # ragged edges, R not split
        (100, 60, 37, 80.0, True),  # offsets of ±80, −inf rows, columns and entries
        (256, 32768, 256, 0.0, False),  # the large-R regime, R split 17 ways
        (1, 1, 1, 0.0, False),
    ],
)
def test_lme_kernel_matches_plain(cuda_device, theta, r, i, offset, neg_inf):
    from dctn_tpu_torch.kernels import logmatmulexp_kernels as L
    from dctn_tpu_torch.ops.logmatmulexp import max_shifts

    la, lb = _lme_inputs(cuda_device, theta, r, i, offset, neg_inf)
    amax, bmax = max_shifts(la, lb)
    before = L.logmatmulexp_fwd.launches
    got = L.logmatmulexp_fwd(la, lb, amax, bmax)
    torch.cuda.synchronize()
    assert L.logmatmulexp_fwd.launches == before + 1
    ref = L.logmatmulexp_fwd_reference(la, lb, amax, bmax)
    _assert_lme_close(got, ref, r, amax, bmax)
    if neg_inf:
        assert bool((got[min(3, theta - 1)] == -math.inf).all())
        assert bool((got[:, min(5, i - 1)] == -math.inf).all())
    # a fixed split of R and no atomics: the same bits on every run
    assert torch.equal(L.logmatmulexp_fwd(la, lb, amax, bmax), got)


@pytest.mark.cuda
def test_lme_kernel_on_the_classifiers_block_diagonal(cuda_device):
    """The classifier's operands: features (256, 98) and the block-diagonal
    weights (98, 490), −inf off the blocks."""
    from dctn_tpu_torch.kernels import logmatmulexp_kernels as L
    from dctn_tpu_torch.models import log_space_classifier as LSC
    from dctn_tpu_torch.ops.logmatmulexp import max_shifts

    x = torch.rand((256, 28, 28), generator=torch.Generator().manual_seed(0)).to(cuda_device)
    la = LSC.features(x).reshape(256, 98)
    lb = LSC.block_diagonal(LSC.init_log_w(torch.Generator().manual_seed(0)).to(cuda_device))
    amax, bmax = max_shifts(la, lb)
    _assert_lme_close(L.logmatmulexp_fwd(la, lb, amax, bmax),
                      L.logmatmulexp_fwd_reference(la, lb, amax, bmax), 98, amax, bmax)


@pytest.mark.cuda
def test_lme_gradients_match_the_plain_path(cuda_device):
    from dctn_tpu_torch.kernels import logmatmulexp_kernels as L

    la, lb = _lme_inputs(cuda_device, 100, 300, 70, neg_inf=True)
    g = torch.randn((100, 70), generator=torch.Generator(device=cuda_device).manual_seed(1),
                    device=cuda_device)
    grads = []
    for fwd in (L.KERNEL, L.PLAIN):
        a, b = la.clone().requires_grad_(True), lb.clone().requires_grad_(True)
        out = L.logmatmulexp_kernel(a, b, fwd)
        grads.append(torch.autograd.grad(out, (a, b), torch.where(torch.isfinite(out), g, 0.0)))
    for a, b in zip(*grads):
        assert bool(torch.isfinite(a).all())
        _assert_close(a, b)


@pytest.mark.cuda
def test_lme_kernel_refuses_what_it_does_not_take(cuda_device):
    from dctn_tpu_torch.kernels import logmatmulexp_kernels as L
    from dctn_tpu_torch.ops.logmatmulexp import max_shifts

    la, lb = _lme_inputs(cuda_device, 8, 16, 4)
    amax, bmax = max_shifts(la, lb)
    with pytest.raises(ValueError, match="float32"):
        L.logmatmulexp_fwd(la.double(), lb.double(), amax.double(), bmax.double())
    with pytest.raises(ValueError, match="float32"):
        L.logmatmulexp_kernel(la.half(), lb.half())
    with pytest.raises(ValueError, match="on cpu"):
        L.logmatmulexp_fwd(la, lb.cpu(), amax, bmax)
    with pytest.raises(ValueError, match="not .Θ, R. and .R, I."):
        L.logmatmulexp_fwd(la, lb[:-1], amax, bmax)
    with pytest.raises(ValueError, match="shifts"):
        L.logmatmulexp_fwd(la, lb, amax.T, bmax)


@pytest.mark.cuda
@pytest.mark.parametrize("theta,r,i,neg_inf", [
    (256, 98, 490, True),  # the classifier's shape
    (100, 61, 37, True),  # ragged, −inf rows, columns and entries
    (7, 5000, 300, True),  # three slices of R, combined by the last block
    (256, 32768, 256, False),  # the large-R regime
    (1, 1, 1, False),
])
def test_lme_shifts_kernel_equals_max_shifts(cuda_device, theta, r, i, neg_inf):
    """The shifts kernel against ``max_shifts``, bit for bit: a maximum is
    exact in any order, and a non-finite one (an all −inf row or column)
    becomes 0."""
    from dctn_tpu_torch.kernels import logmatmulexp_kernels as L
    from dctn_tpu_torch.ops.logmatmulexp import max_shifts

    la, lb = _lme_inputs(cuda_device, theta, r, i, neg_inf=neg_inf)
    before = L.logmatmulexp_shifts.launches
    amax, bmax = L.logmatmulexp_shifts(la, lb)
    torch.cuda.synchronize()
    assert L.logmatmulexp_shifts.launches == before + 1
    ref_a, ref_b = max_shifts(la, lb)
    assert torch.equal(amax, ref_a) and torch.equal(bmax, ref_b)
    if neg_inf:
        assert float(amax[min(3, theta - 1), 0]) == 0.0 and float(bmax[0, min(5, i - 1)]) == 0.0
    # the slices' arrival counters are left at 0: a second call agrees
    assert torch.equal(L.logmatmulexp_shifts(la, lb)[0], amax)


@pytest.mark.cuda
def test_lme_through_the_autograd_function_on_the_classifiers_operands(cuda_device):
    """K13 through ``LogMatMulExp`` on the card against the plain path, on
    the classifier's operands at a ragged R (98, not a multiple of 8) and Θ
    (37 images): features and the block-diagonal weights, −inf off the
    blocks. A forward is one launch of the shifts kernel and one of the
    product; the outputs and both gradients agree with the plain path's."""
    from dctn_tpu_torch.kernels import logmatmulexp_kernels as L
    from dctn_tpu_torch.models import log_space_classifier as LSC
    from dctn_tpu_torch.ops.logmatmulexp import max_shifts

    x = torch.rand((37, 28, 28), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    la = LSC.features(x).reshape(37, 98)
    lb = LSC.block_diagonal(LSC.init_log_w(torch.Generator().manual_seed(1)).to(cuda_device))
    assert bool(torch.isneginf(lb).any())
    g = torch.randn((37, 490), generator=torch.Generator(device=cuda_device).manual_seed(2),
                    device=cuda_device)
    outs, grads = [], []
    for kernels in (L.KERNEL, L.PLAIN):
        a, b = la.clone().requires_grad_(True), lb.clone().requires_grad_(True)
        before = (L.logmatmulexp_shifts.launches, L.logmatmulexp_fwd.launches)
        out = L.logmatmulexp_kernel(a, b, kernels)
        launched = (L.logmatmulexp_shifts.launches - before[0], L.logmatmulexp_fwd.launches - before[1])
        assert launched == ((1, 1) if kernels is L.KERNEL else (0, 0))
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, (a, b), torch.where(torch.isfinite(out), g, 0.0)))
    amax, bmax = max_shifts(la, lb)
    _assert_lme_close(outs[0], outs[1], 98, amax, bmax)
    for got, ref in zip(*grads):
        assert bool(torch.isfinite(got).all())
        _assert_close(got, ref)


# ---------------------------------------------------------------------------
# the EPS runner's modules on the card


@pytest.mark.cuda
@pytest.mark.parametrize("specs,q0,size", [
    (((4, 4), (3, 6)), 2, 28),  # the flagship: K1's wgmma kernel
    (((2, 4), (3, 6)), 3, 32),  # Q₀ = 3 (colored CIFAR): layer 0 on K1's mma.sync kernel
])
def test_empirical_init_through_k1_matches_the_plain_init(cuda_device, specs, q0, size):
    """The empirical init on the card (every slice's forward through K1)
    against the same init on the CPU's plain reference-layout ``eps``, on
    the same unit-normal cores: the scaled cores within REL_TOL (float32
    sums in other orders, then a scale from float64 totals)."""
    from dctn_tpu_torch.ops import composition

    g = torch.Generator().manual_seed(0)
    x = torch.rand((1, 300, size, size, q0), generator=g)
    cores, q = [], q0
    for k, o in specs:
        cores.append(torch.randn((q,) * (k * k) + (o,), generator=g))
        q = o
    before = K.eps_fwd.launches
    got = composition.make_unit_empirical_output_std(None, specs, x.to(cuda_device), batch_size=128,
                                                     unit_cores=cores)
    torch.cuda.synchronize()
    assert K.eps_fwd.launches - before == 2 * len(specs) * math.ceil(300 / 128)
    ref = composition.make_unit_empirical_output_std(None, specs, x, batch_size=128, unit_cores=cores)
    for a, b in zip(got, ref):
        _assert_close(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("frozen,dropout_p", [((), 0.9), ((0,), 1.0), ((1,), 0.9)])
def test_step_with_dropout_and_frozen_cores_matches_the_plain_step(cuda_device, frozen, dropout_p):
    """One flagship step at batch 16 with parameter dropout (the same masks)
    and frozen cores, through the kernels and through the plain versions:
    gradients within REL_TOL; a frozen core's gradient is 0 and its
    ``eps_dcore`` never launches (layer 1 frozen behind a trained layer 0
    still launches the d_views kernel from its saved t)."""
    from dctn_tpu_torch.models import (
        EPSesPlusLinear,
        EPSesPlusLinearConfig,
        draw_dropout_masks,
        init_eps_plus_linear,
    )
    from dctn_tpu_torch.train import make_fast_train_step, make_optimizer

    cfg = EPSesPlusLinearConfig(epses_specs=((4, 4), (3, 6)), dropout_p=dropout_p)
    params = init_eps_plus_linear(torch.Generator().manual_seed(0), cfg)
    from dctn_tpu_torch.data import load_dataset

    train = load_dataset("fashionmnist", "synthetic", autoscale_kernel_size=4,
                         synthetic_sizes=(16, 4, 4)).train  # ν-scaled φ features
    x = torch.as_tensor(train.x, device=cuda_device)
    y = torch.as_tensor(train.y.astype("int64"), device=cuda_device)
    grads = []
    for kernels in (K.KERNELS, K.PLAIN):
        model = EPSesPlusLinear.from_reference(params, cfg, device=cuda_device)
        step = make_fast_train_step(model, make_optimizer("adam", model.parameters(), 1e-3),
                                    kernels=kernels, frozen_eps_indices=frozen)
        masks = draw_dropout_masks(model.plans, dropout_p,
                                   torch.Generator(device=cuda_device).manual_seed(2))
        before = (K.eps_dcore.launches, K.eps_dviews_t.launches)
        step(x, y, masks=(masks,) if dropout_p < 1 else None)
        torch.cuda.synchronize()
        if kernels is K.KERNELS:
            assert K.eps_dcore.launches - before[0] == 2 - len(frozen)
            assert K.eps_dviews_t.launches - before[1] == (0 if frozen == (0,) else 1)
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        if float(b.abs().max()) > 0:
            _assert_close(a, b)
        else:  # a frozen core: 0 on both paths
            assert torch.equal(a, b)
    for i in frozen:
        assert float(grads[0][2 + i].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# deployment artifacts (cli/export.py): the kernels as registered operators


def _artifact_case(dev, family):
    """A seeded model of ``family`` on the card, its eager forward, its
    input batch and the launch counter(s) of its kernel."""
    from dctn_tpu_torch.models import (
        ConvSBSModel,
        EPSesPlusLinear,
        EPSesPlusLinearConfig,
        EPSesPlusLinearQ8,
        init_eps_plus_linear,
    )

    g = torch.Generator().manual_seed(0)
    if family == "conv_sbs":
        cfg = CSM.ConvSBSModelConfig(2, 4, cos_sin_squared=True, input_multiplier=1.2)
        params = CSM.init_conv_sbs_model(g, cfg)
        params = tuple(tuple(tuple(c.to(dev) for c in s) for s in layer) for layer in params)
        x = torch.rand((100, 28, 28), generator=g).to(dev)
        params = CSM.scale_layers_using_batch(params, cfg, x)
        return (params, cfg), ConvSBSModel(params, cfg), x, lambda: S.sbs_fwd.mim_launches
    cfg = EPSesPlusLinearConfig(epses_specs=((4, 4), (3, 6)))
    params = init_eps_plus_linear(g, cfg)
    x = torch.rand((1, 100, 28, 28, 2), generator=g).to(dev)
    if family == "int8":
        return (params, cfg), EPSesPlusLinearQ8.from_reference(params, cfg, device=dev), x, \
            lambda: Q8.eps_fwd_q8.launches
    return (params, cfg), EPSesPlusLinear.from_reference(params, cfg, device=dev), x, \
        lambda: K.eps_fwd.launches


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["f32", "int8", "conv_sbs"])
def test_artifact_on_the_card_gives_the_eager_bits_and_launches_the_kernels(
        cuda_device, tmp_path, family):
    """Exported on the card and loaded back: the graph holds one operator
    node per EPS layer (per ConvSBS string), a call launches the kernel as
    often as the eager forward does (K1 without t), and gives its bits."""
    from dctn_tpu_torch.cli import export

    (params, cfg), model, x, launches = _artifact_case(cuda_device, family)
    path = str(tmp_path / f"{family}.zip")
    if family == "conv_sbs":
        blobs, _ = export.export_conv_sbs_forward(params, cfg, batch_sizes=(100,),
                                                  device=cuda_device)
        want_nodes = {"sbs_fwd": 3}
    else:
        blobs, _ = export.export_forward(params, cfg, batch_sizes=(100,), device=cuda_device,
                                         quantize="int8" if family == "int8" else None)
        want_nodes = {"eps_fwd_q8" if family == "int8" else "eps_fwd": 2}
    export.write_artifact(path, blobs, export.build_meta(
        model_family="conv_sbs" if family == "conv_sbs" else "eps", image_size=28,
        batch_sizes=(100,), backend="pallas", platforms=["cuda"]))
    meta, fns = export.load_artifact(path)
    assert meta["platforms"] == ["cuda"] and export.op_nodes(fns[100]) == want_nodes
    with torch.inference_mode():
        before = launches()
        want = model(x)
        torch.cuda.synchronize()
        eager = launches() - before
        t_before = K.eps_fwd.t_launches
        got = fns[100](x)
        torch.cuda.synchronize()
    assert launches() - before - eager == eager == (3 if family == "conv_sbs" else 2)
    assert K.eps_fwd.t_launches == t_before
    assert got.device.type == "cuda" and torch.equal(got, want)
    with pytest.raises(ValueError, match="does not load onto cpu"):
        export.load_artifact(path, "cpu")
    with pytest.raises(ValueError, match="weights lie on cuda:0; it does not load onto cuda:1"):
        export.load_artifact(path, "cuda:1")


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["f32", "int8", "conv_sbs"])
def test_kernels_launch_on_a_card_that_is_not_current(two_cards, family):
    """K1, K8 and K10 (and, for f32, the step's backward kernels) called on
    cuda:1 tensors while cuda:0 is the current device: they launch there
    (the wrappers enter the tensor's device) and give cuda:0's bits, as a
    single-process replica (predict --mesh-devices, sharded artifacts)
    calls them."""
    d0, d1 = two_cards
    _, model0, x0, launches = _artifact_case(d0, family)
    _, model1, x1, _ = _artifact_case(d1, family)
    assert torch.cuda.current_device() == 0
    with torch.inference_mode():
        want = model0(x0)
        before = launches()
        got = model1(x1)
        torch.cuda.synchronize(d1)
    assert launches() - before == (3 if family == "conv_sbs" else 2)
    assert got.device == d1 and torch.equal(got.cpu(), want.cpu())
    if family == "f32":  # the training step's kernels: K1+t, eps_dcore, the d_views kernel
        y = torch.arange(100) % 10
        grads = []
        for model, x in ((model0, x0), (model1, x1)):
            model.zero_grad(set_to_none=True)
            torch.nn.functional.cross_entropy(model(x), y.to(x.device)).backward()
            grads.append([p.grad.cpu() for p in model.parameters()])
        assert torch.cuda.current_device() == 0
        assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["f32", "int8", "conv_sbs"])
def test_sharded_artifact_serves_on_every_card(two_cards, tmp_path, family):
    """A sharded artifact (``export --mesh-devices N``, N the visible cards
    up to 4) loads a replica onto each card; a global batch's logits equal
    the eager model's on each card's share, bit for bit."""
    from dctn_tpu_torch.cli import export

    n = min(4, torch.cuda.device_count())
    (params, cfg), model, x, _ = _artifact_case(two_cards[0], family)
    host = _to_cpu(params)
    bs = 25 * n
    x = x[:bs] if family == "conv_sbs" else x[:, :bs]
    path = str(tmp_path / f"{family}.zip")
    blobs, _ = export.export_sharded_forward(
        host, cfg, batch_sizes=(bs,), mesh_devices=n,
        quantize="int8" if family == "int8" else None,
        model_family="conv_sbs" if family == "conv_sbs" else "eps")
    export.write_artifact(path, blobs, export.build_meta(
        model_family="conv_sbs" if family == "conv_sbs" else "eps", image_size=28,
        batch_sizes=(bs,), backend="pallas", mesh_devices=n, platforms=["cuda"],
        program_device="cpu"))
    meta, fns = export.load_artifact(path)
    assert meta["mesh_devices"] == n and fns[bs].devices == [torch.device("cuda", i)
                                                              for i in range(n)]
    axis = 0 if family == "conv_sbs" else 1
    with torch.inference_mode():
        got = fns[bs](x)
        want = torch.cat([model(c) for c in torch.tensor_split(x, n, dim=axis)])
    assert got.device == x.device and torch.equal(got, want)


def _to_cpu(params):
    """A tree of tensors (dicts, tuples) with every tensor on the CPU."""
    if isinstance(params, dict):
        return {k: _to_cpu(v) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(_to_cpu(v) for v in params)
    return params.cpu()


def _grid_collectives_job(mesh):
    """On 2 ranks of 2 cards (nccl): ``with_halo`` on a (data 1, space 2)
    grid and ``gather_along`` / ``psum_value_only`` on a (data 1, model 2)
    grid, forward and backward, each against what the rows and slices must
    be; returns every rank's (check, ok) pairs."""
    from dctn_tpu_torch.parallel import gather_along, make_grid, psum_value_only, with_halo

    sp, tp = make_grid(mesh, "space", 1, 2), make_grid(mesh, "model", 1, 2)
    dev, r = mesh.device, mesh.rank
    full = torch.arange(2 * 3 * 8 * 5 * 2, dtype=torch.float32, device=dev).reshape(2, 3, 8, 5, 2)
    x = full[:, :, 4 * r : 4 * r + 4].clone().requires_grad_(True)
    slab = with_halo(x, 3, sp, row_axis=2)
    want = torch.cat([full[:, :, 4 * r : 4 * r + 4],
                      full[:, :, 4 : 6] if r == 0 else torch.zeros_like(full[:, :, :2])], dim=2)
    up = torch.full_like(slab, float(r + 1))
    slab.backward(up)
    # rank 1's first two rows also carry rank 0's cotangent of its halo (1)
    g_want = torch.full_like(x, float(r + 1))
    if r == 1:
        g_want[:, :, :2] += 1.0
    out = [("halo forward", torch.equal(slab.detach(), want)),
           ("halo backward", torch.equal(x.grad, g_want))]
    a = (torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3) + 10 * r).requires_grad_(True)
    gathered = gather_along(a, 1, tp)
    out.append(("gather forward", torch.equal(gathered.detach(), torch.cat(
        [torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3) + 10 * j for j in (0, 1)],
        dim=1))))
    cot = torch.arange(12, dtype=torch.float32, device=dev).reshape(2, 6) * (r + 1)
    gathered.backward(cot)
    base = torch.arange(12, dtype=torch.float32, device=dev).reshape(2, 6) * 3  # Σ over ranks
    out.append(("gather backward (reduce-scatter)", torch.equal(a.grad, base[:, 3 * r : 3 * r + 3])))
    b = torch.full((4,), float(r + 1), device=dev, requires_grad=True)
    s = psum_value_only(b, tp)
    s.backward(torch.ones_like(s))
    out.append(("psum value", torch.equal(s.detach(), torch.full_like(s, 3.0))))
    out.append(("psum backward (identity)", torch.equal(b.grad, torch.ones_like(b))))
    return mesh.all_gather_object(out)


@pytest.mark.cuda
def test_grid_collectives_over_nccl_on_every_card(two_cards):
    """The halo pull and the model gather (``parallel.collectives``) over a
    real ``nccl`` group of 2 ranks on 2 cards, forward and backward: the
    halo is the next rank's first K − 1 rows (zeros on the last), its
    backward sends the cotangent back to the owner; the gather concatenates
    in model order and its backward is a reduce-scatter; the value-only sum
    has an identity backward."""
    from dctn_tpu_torch.parallel.mesh import Host, Job, spawn

    results = spawn(_grid_collectives_job, Job(2, 2, Host(), "cuda"))
    bad = [(rank, what) for rank, checks in enumerate(results) for what, ok in checks if not ok]
    assert not bad, bad


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    torch.cuda.set_device(0)
    return [torch.device("cuda", i) for i in range(4)]


def _sp_tp_collectives_job(mesh):
    """On 4 ranks of 4 cards (nccl), the (data 1, space 2, model 2) grid:
    rank = 2·s + m, so a space line's neighbour is rank ± 2. ``with_halo``
    forward and backward along the space line, each model column with its
    own values (a halo from rank ± 1 would bring the other column's), and
    ``psum_value_only`` over the plane, over space and over model; returns
    every rank's (check, ok) pairs."""
    from dctn_tpu_torch.parallel import make_sp_tp_grid, psum_value_only, with_halo

    g = make_sp_tp_grid(mesh, 1, 2, 2)
    dev, r = mesh.device, mesh.rank
    s, m = g.index("space"), g.index("model")
    out = [("coordinates", (s, m) == (r // 2, r % 2)),
           ("space neighbour", g.peer("space", 1 - s) == (r + 2 if s == 0 else r - 2))]
    full = (torch.arange(2 * 3 * 8 * 5 * 2, dtype=torch.float32, device=dev)
            .reshape(2, 3, 8, 5, 2) + 1000.0 * m)
    x = full[:, :, 4 * s : 4 * s + 4].clone().requires_grad_(True)
    slab = with_halo(x, 3, g, row_axis=2)
    want = torch.cat([full[:, :, 4 * s : 4 * s + 4],
                      full[:, :, 4:6] if s == 0 else torch.zeros_like(full[:, :, :2])], dim=2)
    slab.backward(torch.full_like(slab, float(r + 1)))
    # space 1's first two rows also carry the cotangent of rank r - 2's halo
    g_want = torch.full_like(x, float(r + 1))
    if s == 1:
        g_want[:, :, :2] += float(r - 1)
    out += [("halo forward", torch.equal(slab.detach(), want)),
            ("halo backward", torch.equal(x.grad, g_want))]
    b = torch.full((4,), float(r + 1), device=dev, requires_grad=True)
    v = psum_value_only(b, g, ("space", "model"))
    v.backward(torch.ones_like(v))
    out += [("plane sum", torch.equal(v.detach(), torch.full_like(v, 10.0))),
            ("plane sum backward (identity)", torch.equal(b.grad, torch.ones_like(b))),
            ("space sum", torch.equal(psum_value_only(b.detach(), g, "space"),
                                      torch.full_like(v, 2.0 * m + 4))),
            ("model sum", torch.equal(psum_value_only(b.detach(), g, "model"),
                                      torch.full_like(v, 4.0 * s + 3)))]
    return mesh.all_gather_object(out)


@pytest.mark.cuda
def test_sp_tp_grid_collectives_over_nccl_on_four_cards(four_cards):
    """The SP x TP grid's collectives over a real ``nccl`` group of 4 ranks
    on 4 cards, (1, 2, 2): the halo comes from the space line's neighbour,
    rank ± 2, forward and backward; the value-only sums run over the plane,
    the space line and the model line, each with an identity backward."""
    from dctn_tpu_torch.parallel.mesh import Host, Job, spawn

    results = spawn(_sp_tp_collectives_job, Job(4, 4, Host(), "cuda"))
    bad = [(rank, what) for rank, checks in enumerate(results) for what, ok in checks if not ok]
    assert not bad, bad


# ---------------------------------------------------------------------------
# the bf16 operand mode (K1 ± t, eps_dcore and both d_views forms)
#
# Tolerance: the kernel and its plain version form the same float32
# operands (the plain version's suffix chain, in the same order) and round
# them to the same bf16 values; bf16 products are exact in float32, so the
# two differ only in the order of their float32 sums: REL_TOL of the
# largest entry, as the float32 mode. The negative control: the float32
# (3xTF32) kernel on the same inputs must differ from the bf16 result by
# more than that tolerance, or the mode did not round. K1's saved t is
# itself rounded to bf16 from sums taken in two orders, so an entry may land
# one bf16 step (2^-7 of its size at most) from the plain version's.
BF16_STEP = 2.0**-7


def _assert_close_bf16(got, ref):
    """``got`` against ``ref`` as ``_assert_close``; a bf16 tensor entry by
    entry within one bf16 step of ``ref`` (plus REL_TOL of the largest)."""
    if ref.dtype != torch.bfloat16:
        _assert_close(got, ref)
        return
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all()
    limit = BF16_STEP * ref.abs() + REL_TOL * float(ref.abs().max())
    assert bool(((got - ref).abs() <= limit).all())

_BF16_SHAPES = [
    (8, 4, 4, 4, 128 * 625),  # flagship layer 0 at batch 128
    (9, 4, 5, 6, 128 * 529),  # flagship layer 1 at batch 128
    (4, 4, 3, 6, 2 * 676),  # three-EPS layer 1: A = 64, B2 = 4
    (4, 6, 3, 12, 2 * 625),  # three-EPS layer 2: A = 216, not a step multiple
    (4, 12, 3, 24, 2 * 484),  # deep layer 2: A = 1728, B2 = 12
    (9, 4, 5, 12, 2 * 529),  # deep layer 1: Z = 3072
    (4, 3, 4, 5, 1000),  # n2 = 0: out = t
    (6, 2, 3, 3, 777),  # ragged last pixel tile
    (3, 5, 1, 2, 130),  # B2 = 25: outputs across pass rows
    (10, 2, 2, 2, 300),  # B2 = 256, n2 = 8: the most factors a half takes
]


def _bf16_cases(views, cmt, g, n1, o):
    """name → (kernel call, plain call, f32 kernel call, counter) on the
    same inputs; cmt is float32, each bf16 call rounds it once."""
    cb = cmt.to(torch.bfloat16)
    n = views.shape[0]
    tb = K.eps_fwd_reference(views, cb, n1, o, save_t=True)[1] if n1 < n else None
    tf = K.eps_fwd_reference(views, cmt, n1, o, save_t=True)[1] if n1 < n else None
    return {
        "eps_fwd": (lambda: K.eps_fwd(views, cb, n1, o), lambda: K.eps_fwd_reference(views, cb, n1, o),
                    lambda: K.eps_fwd(views, cmt, n1, o), (K.eps_fwd, "bf16_launches")),
        "eps_fwd_t": (lambda: K.eps_fwd(views, cb, n1, o, save_t=True),
                      lambda: K.eps_fwd_reference(views, cb, n1, o, save_t=True),
                      lambda: K.eps_fwd(views, cmt, n1, o, save_t=True),
                      (K.eps_fwd, "bf16_t_launches")),
        "eps_dcore": (lambda: K.eps_dcore(views, g, n1, o, mm_dtype=torch.bfloat16),
                      lambda: K.eps_dcore_reference(views, g, n1, o, torch.bfloat16),
                      lambda: K.eps_dcore(views, g, n1, o), (K.eps_dcore, "bf16_launches")),
        "eps_dviews_t": (lambda: K.eps_dviews_t(views, cb, g, tb, n1, o),
                         lambda: K.eps_dviews_t_reference(views, cb, g, tb, n1, o),
                         lambda: K.eps_dviews_t(views, cmt, g, tf, n1, o),
                         (K.eps_dviews_t, "bf16_launches")),
        "eps_dviews_recompute": (lambda: K.eps_dviews_recompute(views, cb, g, n1, o),
                                 lambda: K.eps_dviews_recompute_reference(views, cb, g, n1, o),
                                 lambda: K.eps_dviews_recompute(views, cmt, g, n1, o),
                                 (K.eps_dviews_recompute, "bf16_launches")),
    }


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["eps_fwd", "eps_fwd_t", "eps_dcore", "eps_dviews_t",
                                    "eps_dviews_recompute"])
@pytest.mark.parametrize("n,q,n1,o,npix", _BF16_SHAPES)
def test_bf16_kernels_match_plain_and_round(cuda_device, kernel, n, q, n1, o, npix):
    if kernel == "eps_fwd_t" and n1 == n:
        pytest.skip("no t to save when n2 = 0")
    views, cmt, g = _inputs(cuda_device, n, q, n1, o, npix)
    call, plain, f32, (fn, counter) = _bf16_cases(views, cmt, g, n1, o)[kernel]
    f32_before = fn.launches
    before = getattr(fn, counter)
    got = _as_tuple(call())
    torch.cuda.synchronize()
    assert getattr(fn, counter) == before + 1
    assert fn.launches == f32_before
    ref, full = _as_tuple(plain()), _as_tuple(f32())
    for x, r, f in zip(got, ref, full):
        assert x.dtype == r.dtype
        _assert_close_bf16(x, r)
        scale = float(r.float().abs().max())
        assert float((x.float() - f.float()).abs().max()) > REL_TOL * scale
    if kernel == "eps_fwd_t":  # the serving form gives the save_t form's out bits
        assert torch.equal(got[0], K.eps_fwd(views, cmt.to(torch.bfloat16), n1, o))


# the flagship's layers at a grid rank's shapes at batch 128 a data rank
# (chip_smoke.grid_shard_shapes): layer 1 at O / 2 and O / 3 (TP), layers 0
# and 1 on 14 and 7 rows (SP), layer 1 at O / 2 on 14 and 7 rows (SP x TP)
_BF16_GRID_SHAPES = [
    (9, 4, 5, 3, 128 * 529),
    (9, 4, 5, 2, 128 * 529),
    (8, 4, 4, 4, 128 * 14 * 25),
    (9, 4, 5, 6, 128 * 14 * 23),
    (8, 4, 4, 4, 128 * 7 * 25),
    (9, 4, 5, 6, 128 * 7 * 23),
    (9, 4, 5, 3, 128 * 14 * 23),
    (9, 4, 5, 3, 128 * 7 * 23),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["eps_dcore", "eps_dviews_t", "eps_dviews_recompute"])
@pytest.mark.parametrize("n,q,n1,o,npix", _BF16_GRID_SHAPES)
def test_bf16_backward_kernels_at_grid_rank_shapes(cuda_device, kernel, n, q, n1, o, npix):
    """The bf16 backward kernels (``eps_dcore``, both d_views forms) against
    their plain versions at a grid rank's shapes, as at the whole layer's."""
    if kernel != "eps_dcore" and n1 == n:
        pytest.skip("no d_views at these shapes")
    views, cmt, g = _inputs(cuda_device, n, q, n1, o, npix)
    call, plain, _, _ = _bf16_cases(views, cmt, g, n1, o)[kernel]
    got = call()
    torch.cuda.synchronize()
    _assert_close_bf16(got, plain())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["eps_fwd", "eps_fwd_t"])
@pytest.mark.parametrize("n,q,n1,o,npix", _BF16_GRID_SHAPES)
def test_bf16_forward_at_grid_rank_shapes(cuda_device, kernel, n, q, n1, o, npix):
    """K1 bf16 with and without t against its plain version at a grid
    rank's shapes (small Z, many pixels), as at the whole layer's."""
    if kernel == "eps_fwd_t" and n1 == n:
        pytest.skip("no t to save when n2 = 0")
    views, cmt, g = _inputs(cuda_device, n, q, n1, o, npix)
    call, plain, _, _ = _bf16_cases(views, cmt, g, n1, o)[kernel]
    got = _as_tuple(call())
    torch.cuda.synchronize()
    for x, r in zip(got, _as_tuple(plain())):
        _assert_close_bf16(x, r)


# K1 bf16 at the edges of its plan: (n, q, n1, O, npix); the wgmma route
# where Z > 128, else the mma.sync one
_BF16_FWD_EDGES = [
    (4, 3, 4, 200, 1000),  # wgmma, A = 81 (cmt zero-padded to 128), n2 = 0
    (6, 3, 4, 20, 1000),  # wgmma, A = 81 with B2 = 9: 14 outputs a Z tile, then 6
    (3, 16, 1, 5, 129),  # wgmma, A = 16; B2 = 256 in 2 passes; one pixel past a tile
    (10, 2, 1, 3, 333),  # wgmma, B2 = 512: four passes a CTA, A = 2; ragged npix
    (9, 4, 5, 2, 777),  # wgmma, B2 = 256 past the Z tile: two passes; ragged npix
    (4, 2, 2, 300, 2000),  # wgmma, B2 = 4: 32 outputs a Z tile, the last tile 12
    (2, 128, 1, 2, 400),  # wgmma, q = 128: B2 = 128, v's 128 staged factor rows
    (2, 4, 2, 4, 2 * 729),  # mma.sync: three-EPS layer 0, A = 16, n2 = 0
    (4, 3, 4, 5, 1000),  # mma.sync: A = 81, no multiple of 8; n2 = 0
    (6, 3, 4, 7, 1000),  # mma.sync: Z = 63, B2 = 9: 7 outputs a Z tile
    (2, 128, 1, 1, 300),  # mma.sync: B2 = 128, one output in 2 passes of 64
]


@pytest.mark.cuda
@pytest.mark.parametrize("save_t", [False, True])
@pytest.mark.parametrize("n,q,n1,o,npix", _BF16_FWD_EDGES)
def test_bf16_fwd_at_its_edges_matches_plain(cuda_device, n, q, n1, o, npix, save_t):
    """K1 bf16 ± t against its plain version where its plan is tight, on
    the route its plan names: out within REL_TOL, t within a bf16 step; one
    launch counted and the plan's chunks (none on the mma.sync route); the
    serving out the save_t out's bits."""
    if save_t and n1 == n:
        pytest.skip("no t to save when n2 = 0")
    views, cmt, _ = _inputs(cuda_device, n, q, n1, o, npix)
    cb = cmt.to(torch.bfloat16)
    launches, chunks = K.eps_fwd.bf16_launches, K.eps_fwd.bf16_chunk_launches
    got = _as_tuple(K.eps_fwd(views, cb, n1, o, save_t=save_t))
    torch.cuda.synchronize()
    assert K.eps_fwd.bf16_launches - launches == 1
    plan = K._fwd_bf16_plan(n, q, n1, o, npix)
    assert plan["route"] == ("wgmma" if cmt.shape[0] > 128 else "mma.sync")
    assert K.eps_fwd.bf16_chunk_launches - chunks == plan["chunks"]
    for x, r in zip(got, _as_tuple(K.eps_fwd_reference(views, cb, n1, o, save_t=save_t))):
        _assert_close_bf16(x, r)
    if save_t:
        assert torch.equal(got[0], K.eps_fwd(views, cb, n1, o))


# K1 bf16 in chunks of pixels (its u's scratch capped small): (n, q, n1, O,
# npix, tiles of 128 pixels a chunk); the last chunk short and ragged
_BF16_FWD_CHUNKS = [
    (9, 4, 5, 6, 127 * 529, 100),  # flagship layer 1: 6 chunks, the last 3,183 pixels
    (8, 4, 4, 4, 20_001, 30),  # flagship layer 0: 6 chunks, the last 801
    (4, 6, 3, 24, 9_999, 7),  # A = 216, padded to 256: 12 chunks
    (4, 3, 4, 200, 3_000, 2),  # A = 81, n2 = 0: 12 chunks
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,n1,o,npix,tiles", _BF16_FWD_CHUNKS)
def test_bf16_fwd_in_chunks_matches_plain(cuda_device, monkeypatch, n, q, n1, o, npix, tiles):
    """K1 bf16 ± t over several chunks of pixels against its plain version,
    one chunk counted each and one launch a call, the same bits twice, and
    the serving out the save_t out's bits."""
    a_pad = K._pad_to(q**n1, 64)
    monkeypatch.setattr(K, "_BF16_FWD_OPS_BYTES", 2 * a_pad * 128 * tiles)
    plan = K._fwd_bf16_plan(n, q, n1, o, npix)
    assert plan["chunk"] == 128 * tiles and plan["chunks"] == math.ceil(npix / plan["chunk"]) > 2
    views, cmt, _ = _inputs(cuda_device, n, q, n1, o, npix)
    cb = cmt.to(torch.bfloat16)
    save_t = n1 < n
    chunks, launches = K.eps_fwd.bf16_chunk_launches, K.eps_fwd.bf16_launches
    got = _as_tuple(K.eps_fwd(views, cb, n1, o, save_t=save_t))
    torch.cuda.synchronize()
    assert K.eps_fwd.bf16_chunk_launches - chunks == plan["chunks"]
    assert K.eps_fwd.bf16_launches - launches == 1
    for x, r in zip(got, _as_tuple(K.eps_fwd_reference(views, cb, n1, o, save_t=save_t))):
        _assert_close_bf16(x, r)
    for a, b in zip(got, _as_tuple(K.eps_fwd(views, cb, n1, o, save_t=save_t))):
        assert torch.equal(a, b)
    assert torch.equal(got[0], K.eps_fwd(views, cb, n1, o))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["eps_fwd", "eps_fwd_t", "eps_dcore", "eps_dviews_t",
                                    "eps_dviews_recompute"])
def test_bf16_kernels_give_the_same_bits_twice(cuda_device, kernel):
    views, cmt, g = _inputs(cuda_device, 9, 4, 5, 6, 20_000)
    call = _bf16_cases(views, cmt, g, 5, 6)[kernel][0]
    for a, b in zip(_as_tuple(call()), _as_tuple(call())):
        assert torch.equal(a, b)


# eps_dcore's bf16 mode in chunks of pixels (its operands' scratch capped
# small): (n, q, n1, O, npix, steps of 64 pixels a chunk). Each has more than
# one pixel slice; the last chunk is short (a few steps, some slices with no
# step of it) and, where npix is no multiple of 64, ragged
_BF16_DCORE_CHUNKS = [
    (9, 4, 5, 6, 127 * 529, 209),  # flagship layer 1: 6 chunks, the last 5 steps, ragged
    (9, 4, 5, 6, 128 * 529, 151),  # 8 chunks, the last one step: 5 of 6 slices empty
    (9, 4, 5, 12, 40_000, 100),  # deep layer 1 (Z = 3072): 7 chunks
    (4, 6, 3, 12, 30_001, 50),  # A = 216: 10 chunks, the last ragged
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,n1,o,npix,steps", _BF16_DCORE_CHUNKS)
def test_bf16_dcore_in_chunks_matches_plain(cuda_device, monkeypatch, n, q, n1, o, npix, steps):
    """``eps_dcore``'s bf16 mode over several chunks (later chunks add into
    each slice's part, then the slice sum) against its plain version, one
    operands kernel and product counted a chunk, the same bits twice."""
    z, a = o * q ** (n - n1), q**n1
    rows = K._pad_to(a, K._BF16_DCORE_TILE) + K._pad_to(z, K._BF16_DCORE_TILE)
    monkeypatch.setattr(K, "_BF16_DCORE_OPS_BYTES", 2 * rows * 64 * steps)
    chunk = K._dcore_bf16_chunk(z, a, npix)
    assert chunk == 64 * steps and npix > 2 * chunk
    assert K._dcore_bf16_slices(z, a, npix, K._sm_count(cuda_device)) > 1
    views, _, g = _inputs(cuda_device, n, q, n1, o, npix)
    chunks, sums = K.eps_dcore.bf16_chunk_launches, K.eps_dcore.bf16_sum_launches
    got = K.eps_dcore(views, g, n1, o, mm_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert K.eps_dcore.bf16_chunk_launches - chunks == math.ceil(npix / chunk)
    assert K.eps_dcore.bf16_sum_launches - sums == 1
    _assert_close(got, K.eps_dcore_reference(views, g, n1, o, torch.bfloat16))
    assert torch.equal(got, K.eps_dcore(views, g, n1, o, mm_dtype=torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("n,q,n1,o,npix", _BF16_SHAPES + _BF16_GRID_SHAPES + _BF16_FWD_EDGES)
def test_bf16_plan_mirrors_equal_the_sources(cuda_device, n, q, n1, o, npix):
    """The Python mirrors of the bf16 kernels' shared memory (the gate's and
    the wrappers' checks) equal the sources' own ``smem_bytes``, asked
    through their C queries."""
    del cuda_device
    plan, lib = K._fwd_bf16_plan(n, q, n1, o, npix), K._library("eps_fwd")
    assert plan["smem_bytes"] == lib.dctn_eps_fwd_bf16_smem_bytes(n, q, n1, o)
    assert plan["route"] == ("wgmma" if lib.dctn_eps_fwd_bf16_route(n, q, n1, o) else "mma.sync")
    assert K._dcore_bf16_smem_bytes(n, q, n1, o) == K._library(
        "eps_dcore").dctn_eps_dcore_bf16_smem_bytes(n, q, n1, o)
    for recompute in (False, True):
        assert K._dviews_bf16_smem_bytes(n, q, n1, o, recompute) == K._library(
            "eps_dviews_t").dctn_eps_dviews_bf16_smem_bytes(n, q, n1, o, int(recompute))


@pytest.mark.cuda
def test_bf16_kernels_with_zero_factors(cuda_device):
    views, cmt, g = _inputs(cuda_device, 9, 4, 5, 6, 700)
    views[:, 0, ::3] = 0.0
    views[2, :, ::5] = 0.0
    views[7, :, 1::4] = 0.0
    for call, plain, _, _ in _bf16_cases(views, cmt, g, 5, 6).values():
        for x, r in zip(_as_tuple(call()), _as_tuple(plain())):
            _assert_close_bf16(x, r)


@pytest.mark.cuda
@pytest.mark.parametrize("layer_index,n1,save", [(1, 5, True), (1, 5, False), (0, 5, False)])
def test_bf16_layer_gradients_match_the_plain_path(cuda_device, layer_index, n1, save):
    """EPSApplyTCmt in the bf16 mode on the kernels against the same
    Function with the plain backward: the saved-t arm of the flagship's
    layer 1, the same layer forced onto the recompute arm (a cap of 0
    bytes), and the d_cmt-only arm; d_cmt comes back float32. Both sides run
    the kernel's forward, so the backward reads the same saved bf16 t (the
    plain forward's t, rounded from sums in another order, may land a bf16
    step apart in some entries); the plain forward's output is held apart."""
    xT = torch.rand((1, 4, 9, 9, 3), device=cuda_device, requires_grad=True)
    cmt = (torch.randn((6 * 256, 1024), device=cuda_device) * 4**-4.5).requires_grad_(True)
    plain_bwd = K.EPSKernels(K.eps_fwd, K.eps_dcore_reference, K.eps_dviews_t_reference,
                             K.eps_dviews_recompute_reference)
    cap = K.SAVE_T_MAX_BYTES
    K.SAVE_T_MAX_BYTES = cap if save else 0
    try:
        grads, outs, t_writes = [], [], K.eps_fwd.bf16_t_launches
        for kernels in (K.KERNELS, plain_bwd, K.PLAIN):
            out = K.eps_apply_t_cmt(cmt, xT, 6, 3, n1, False, layer_index=layer_index,
                                    kernels=kernels, mm_dtype=torch.bfloat16)
            outs.append(out.detach())
            if kernels is not K.PLAIN:
                grads.append(torch.autograd.grad(torch.sum(out * torch.cos(out)), (xT, cmt)))
    finally:
        K.SAVE_T_MAX_BYTES = cap
    assert K.eps_fwd.bf16_t_launches - t_writes == (2 if save and layer_index else 0)
    _assert_close(outs[0], outs[2])
    for a, b in zip(*grads):
        assert a.dtype == b.dtype == torch.float32
        _assert_close(a, b)


@pytest.mark.cuda
def test_bf16_mode_refuses_what_its_plan_does_not_take(cuda_device):
    views, cmt, g = _inputs(cuda_device, 10, 2, 1, 2, 300)  # n - n1 = 9 factors of v
    cb = cmt.to(torch.bfloat16)
    with pytest.raises(ValueError, match="the bf16 plans' limits"):
        K.eps_dviews_recompute(views, cb, g, 1, 2)
    t = torch.zeros((cmt.shape[0], 300), device=cuda_device)  # a float32 t with a bf16 cmt
    with pytest.raises(ValueError, match="bfloat16"):
        K.eps_dviews_t(views, cb, g, t, 1, 2)
    with pytest.raises(ValueError, match="compute dtype"):
        K.eps_dcore(views, g, 1, 2, mm_dtype=torch.float16)
