"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed. ``tests/conftest.py`` imports jax, so on such a
machine run it without the conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

On a host without a CUDA device every test skips itself.

Tolerance 1e-4·max|ref| throughout: kernel and plain version are both
float32 and differ only in the order of their sums.
"""

import pytest
import torch

from dctn_tpu_torch.kernels import eps_kernels as K

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
        (2, 128, 1, 2, 300),  # n·q = 256 staged factor rows, the most it takes
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
        (10, 2, 1, 2, 300),  # B2 = 512
    ],
)
def test_forward_with_t_matches_plain(cuda_device, n, q, n1, o, npix):
    views, cmt, _ = _inputs(cuda_device, n, q, n1, o, npix)
    before = (K.eps_fwd.launches, K.eps_fwd.t_launches)
    out, t = K.eps_fwd(views, cmt, n1, o, save_t=True)
    torch.cuda.synchronize()
    assert (K.eps_fwd.launches, K.eps_fwd.t_launches) == (before[0] + 1, before[1] + 1)
    ref_out, ref_t = K.eps_fwd_reference(views, cmt, n1, o, save_t=True)
    _assert_close(out, ref_out)
    _assert_close(t, ref_t)
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
    assert K._dcore_slices(1024, 256, 40_000) > 1
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
    with pytest.raises(NotImplementedError, match="K4"):
        K.eps_dviews_recompute(v, c, torch.zeros((1, 64), device=cuda_device), 1, 1)
