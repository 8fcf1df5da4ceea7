"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither jax nor the JAX package, so it runs where only
PyTorch is installed. ``tests/conftest.py`` imports jax, so on such a
machine run it without the conftest:

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

On a host without a CUDA device every test skips itself.
"""

import pytest
import torch

from dctn_tpu_torch.kernels import eps_kernels as K


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
    """Tolerance 1e-4·max|ref|: both sides are float32 and only the
    summation order differs."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    views = torch.rand((n, q, npix), generator=g, device=cuda_device)
    cmt = torch.randn((o * q ** (n - n1), q**n1), generator=g, device=cuda_device)
    before = K.eps_fwd.launches
    got = K.eps_fwd(views, cmt, n1, o)
    torch.cuda.synchronize()
    assert K.eps_fwd.launches == before + 1
    ref = K.eps_fwd_reference(views, cmt, n1, o)
    assert got.shape == ref.shape == (o, npix)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_kernel_refuses_shapes_outside_its_limits(cuda_device):
    views = torch.zeros((11, 2, 64), device=cuda_device)
    cmt = torch.zeros((1024, 2), device=cuda_device)
    with pytest.raises(ValueError, match="limits"):
        K.eps_fwd(views, cmt, 1, 1)
