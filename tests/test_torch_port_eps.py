"""The port's EPS ops and forward kernel host side against the JAX package.

Inputs come from numpy and go to both packages. The JAX side runs its
Pallas forward in interpret mode, as its own tests do; the port's CPU
tensors take the kernel's plain version. The CUDA kernel itself is held
against that plain version on the card in ``test_torch_port_cuda.py``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctn_tpu.ops import eps as jeps
from dctn_tpu.ops import windows as jwindows
from dctn_tpu.pallas import eps_pallas as jp
from dctn_tpu_torch.kernels import eps_kernels as K
from dctn_tpu_torch.ops import eps as teps
from dctn_tpu_torch.ops import windows as twindows

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """Neither jax nor the JAX package: the port runs where only PyTorch is."""
    code = (
        "import sys, dctn_tpu_torch, dctn_tpu_torch.cli.predict, "
        "dctn_tpu_torch.kernels.eps_kernels, dctn_tpu_torch.kernels.eps_q8_kernels, "
        "dctn_tpu_torch.models, dctn_tpu_torch.data, dctn_tpu_torch.interop, "
        "dctn_tpu_torch.bench, dctn_tpu_torch.train.step, dctn_tpu_torch.train.optimizers, "
        "dctn_tpu_torch.kernels.sbs_kernels, dctn_tpu_torch.ops.sbs, dctn_tpu_torch.ops.rank_one, "
        "dctn_tpu_torch.utils.pos2d, dctn_tpu_torch.models.conv_sbs_model, "
        "dctn_tpu_torch.cli.legacy_runner, dctn_tpu_torch.train.checkpoint\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dctn_tpu'))\n"
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_chip_smoke_imports_only_the_port():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "dctn_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "dctn_tpu"}, roots


@pytest.mark.parametrize("q", [2, 3, 4, 12])
def test_balanced_split_and_plan_match_jax(q):
    for n in range(1, 17):
        for o in (1, 4, 6, 24):
            n1 = teps._balanced_split(n, q, o)
            assert n1 == jeps._balanced_split(n, q, o), (n, q, o)
    compared = 0
    for c, k in ((1, 2), (1, 3), (1, 4), (3, 2)):
        n = k * k * c
        for n1 in range(1, n + 1):
            try:
                j_n1, _, j_merge, _ = jp.plan_pallas_call(c, q, k, n1, 4, 1000, None, True)
            except AssertionError:  # no TPU VMEM plan for this split
                continue
            assert K.plan_call(c, q, k, n1) == (j_n1, j_merge), (c, q, k, n1)
            compared += 1
    assert compared >= 4


@pytest.mark.parametrize("c,q,k", [(1, 2, 2), (3, 2, 2), (1, 3, 3), (3, 3, 2)])
def test_window_views_match_jax(c, q, k):
    x = np.random.default_rng(0).normal(size=(c, 2, 6, 5, q))
    got = twindows.window_views(torch.as_tensor(x), k)
    ref = jwindows.window_views(jnp.asarray(x), k)
    assert len(got) == len(ref) == k * k * c
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("c,q,k", [(1, 2, 2), (3, 2, 2), (1, 3, 3), (3, 3, 2)])
def test_stack_views_and_cmt_match_jax_exactly(c, q, k):
    rng = np.random.default_rng(1)
    n = k * k * c
    merge_pairs = q == 2 and n % 2 == 0
    xT = rng.normal(size=(c, q, 7, 6, 3))  # f64
    got, npix = K._stack_views_from_xT(torch.as_tensor(xT), k, merge_pairs)
    ref, jnpix = jp._stack_views_from_xT(jnp.asarray(xT), k, 128, merge_pairs)
    assert npix == jnpix == 3 * (7 - k + 1) * (6 - k + 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref)[:, :, :npix])

    core = rng.normal(size=(q,) * n + (5,))
    for n1 in range(2, n + 1, 2) if merge_pairs else range(1, n + 1):
        _, q_k, n1_k = K._kernel_dims(c, q, k, n1, merge_pairs)
        assert (q_k, n1_k) == jp._kernel_dims(c, q, k, n1, merge_pairs)[1:]
        np.testing.assert_array_equal(
            K._core_to_cmt_k(torch.as_tensor(core), n1_k, q_k).numpy(),
            np.asarray(jp._core_to_cmt_k(jnp.asarray(core), n1_k, q_k)),
        )


# (c, q, k, n1 in model terms, O, batch) — the views are built by the JAX
# host glue and handed to both forwards
_FWD_CASES = {
    "merged_q2": (1, 2, 2, 2, 3, 2),  # 4 factors of q=2 → 2 of q=4
    "n2_zero": (1, 3, 2, 4, 5, 2),  # every factor in u: out = t
    "ragged_npix": (1, 4, 2, 3, 4, 3),  # npix = 3·4·4 = 48, not a tile multiple
}


@pytest.mark.parametrize("case", sorted(_FWD_CASES))
def test_eps_fwd_reference_matches_pallas_interpret(case):
    c, q, k, n1, o, b = _FWD_CASES[case]
    rng = np.random.default_rng(2)
    n = k * k * c
    n1, merge_pairs = K.plan_call(c, q, k, n1)
    _, q_k, n1_k = K._kernel_dims(c, q, k, n1, merge_pairs)
    xT = rng.uniform(size=(c, q, 5, 5, b)).astype(np.float32)
    core = (rng.normal(size=(q,) * n + (o,)) * q ** (-n / 2)).astype(np.float32)
    views, npix = jp._stack_views_from_xT(jnp.asarray(xT), k, 128, merge_pairs)
    cmt = jp._core_to_cmt_k(jnp.asarray(core), n1_k, q_k)
    ref = np.asarray(jp._run_fwd(views, cmt, n1_k, o, 128, True))[:, :npix]
    got = K.eps_fwd_reference(
        torch.tensor(np.asarray(views)[:, :, :npix]), torch.tensor(np.asarray(cmt)),
        n1_k, o,
    ).numpy()
    assert got.shape == (o, npix) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("c,q,k,o,split", [(1, 2, 2, 3, None), (1, 3, 2, 4, 4), (2, 2, 2, 2, 3)])
def test_reference_layout_eps_matches_jax_xla(c, q, k, o, split):
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(c, 2, 6, 5, q))
    core = rng.normal(size=(q,) * (k * k * c) + (o,))
    got = teps.eps(torch.as_tensor(core), torch.as_tensor(x), split=split).numpy()
    ref = np.asarray(jeps.eps(jnp.asarray(core), jnp.asarray(x), split=split, backend="xla"))
    assert got.shape == ref.shape == (2, 6 - k + 1, 5 - k + 1, o)
    np.testing.assert_allclose(got, ref, rtol=1e-10)


def test_eps_unit_theoretical_init_is_seeded_and_scaled():
    g = torch.Generator().manual_seed(0)
    a = teps.make_eps_unit_theoretical_output_std(g, 2, 1, 4, 3)
    b = teps.make_eps_unit_theoretical_output_std(torch.Generator().manual_seed(0), 2, 1, 4, 3)
    assert a.shape == teps.eps_shape(2, 1, 4, 3) == (4, 4, 4, 4, 3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert abs(float(a.std()) * 4**2 - 1.0) < 0.1  # std = (Q^(C·K²))^(-1/2)


def test_eps_fwd_on_cpu_runs_the_plain_version_without_counting():
    rng = np.random.default_rng(4)
    views = torch.as_tensor(rng.uniform(size=(3, 2, 10)).astype(np.float32))
    cmt = torch.as_tensor(rng.normal(size=(2 * 2, 4)).astype(np.float32))
    before = K.eps_fwd.launches
    torch.testing.assert_close(
        K.eps_fwd(views, cmt, 2, 2), K.eps_fwd_reference(views, cmt, 2, 2), rtol=0, atol=0
    )
    assert K.eps_fwd.launches == before


@pytest.mark.parametrize(
    "shape,n1,o,cmt_shape,match",
    [
        ((11, 2, 8), 1, 1, (1024, 2), "limits"),  # q^(n-n1) = 1024 > 512
        ((33, 8, 8), 32, 1, (8, 1), "limits"),  # n·q = 264 > 256
        ((3, 2, 8), 2, 2, (4, 2), "not \\(O"),  # wrong cmt shape
        ((3, 2, 8), 4, 2, (4, 4), "outside"),  # bad split
    ],
)
def test_kernel_limits_raise_naming_the_shape(shape, n1, o, cmt_shape, match):
    with pytest.raises(ValueError, match=match) as err:
        K._check_kernel_args(torch.zeros(shape), torch.zeros(cmt_shape), n1, o)
    assert str(tuple(shape)) in str(err.value)


def test_kernel_args_inside_the_limits_pass():
    # the flagship's second layer: q^(n-n1) = 256, n·q = 36
    K._check_kernel_args(torch.zeros((9, 4, 8)), torch.zeros((6 * 256, 1024)), 5, 6)
    with pytest.raises(ValueError, match="float32"):
        K._check_kernel_args(torch.zeros((9, 4, 8), dtype=torch.float64),
                             torch.zeros((6 * 256, 1024)), 5, 6)
