"""The port's ConvSBS fold and the plain versions of its kernels against the
JAX package, on the CPU.

Cores and inputs are made with numpy and cross to both packages as numpy
arrays. The JAX side runs ``sbs.conv_sbs(backend="xla")`` in float64, or its
fused Pallas kernels in interpret mode (``conv_sbs_pallas_t(...,
interpret=True)``) in float32, as its own tests do; the port's CPU tensors
take the kernels' plain versions. The CUDA kernels themselves are held
against those plain versions on the card (``test_torch_port_cuda.py``,
``chip_smoke.py``).

Tolerances: float64 against float64, rtol 1e-10 (the same sums in other
orders); the float32 plain versions against the float32 interpret-mode
kernels, rtol 2e-5 with atol 1e-6 (the folds of ≤ 9 cores and the sums of
their gradients over ≤ 75 pixels, in other orders), as the JAX package holds
its own kernels to its XLA fold (tests/test_sbs_pallas.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctn_tpu.ops import sbs as jsbs
from dctn_tpu.pallas import sbs_pallas as jp
from dctn_tpu.utils.pos2d import Pos2D as JPos2D
from dctn_tpu_torch.kernels import sbs_kernels as K
from dctn_tpu_torch.ops import sbs as tsbs
from dctn_tpu_torch.utils.pos2d import Pos2D

SNAKE9 = [(0, 0), (0, 1), (0, 2), (1, 2), (1, 1), (1, 0), (2, 0), (2, 1), (2, 2)]
# the five CASES of tests/test_sbs_pallas.py:28, then the legacy ring snake
CASES = [
    ([(0, 0), (0, 1), (1, 0), (1, 1)], (1, 3, 1, 1), (1, 2, 3, 2), 1),
    (SNAKE9, (1, 1, 1, 1, 2, 1, 1, 1, 1), (1, 2, 2, 2, 2, 2, 2, 2, 2), 1),
    (SNAKE9, (1, 1, 1, 1, 10, 1, 1, 1, 1), (1, 4, 4, 4, 4, 4, 4, 4, 4), 1),
    ([(0, 0), (0, 1), (1, 1), (1, 0)], (2, 1, 1, 1), (1, 2, 2, 2), 2),
    ([(0, 0), (0, 1), (1, 1), (1, 0)], (1, 3, 1, 1), (1, 2, 2, 2), 3),
    (SNAKE9, (1, 1, 1, 1, 2, 1, 1, 1, 1), (2,) * 9, 1),
]
# a ring with mixed bonds, as test_mim_every_merge_position's
MIXED_RING = ([(0, 0), (0, 1), (1, 0), (1, 1)], (2, 2, 2, 2), (2, 3, 4, 2), 1)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _specs(case):
    positions, outs, bonds, channels = case
    jspec = jsbs.SBSSpecString(
        tuple(jsbs.SBSSpecCore(JPos2D(h, w), o) for (h, w), o in zip(positions, outs)),
        tuple(bonds), channels, 2,
    )
    tspec = tsbs.SBSSpecString(
        tuple(tsbs.SBSSpecCore(Pos2D(h, w), o) for (h, w), o in zip(positions, outs)),
        tuple(bonds), channels, 2,
    )
    return jspec, tspec


def _inputs(spec, dtype, seed=0, batch=2, size=5):
    rng = np.random.default_rng(seed)
    cores = [(0.5 * rng.standard_normal(s.as_tuple())).astype(dtype) for s in spec.shapes]
    x = rng.uniform(size=(spec.in_num_channels, batch, size, size, 2)).astype(dtype)
    return cores, x


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_plain_fold_matches_jax_xla_f64(idx):
    jspec, tspec = _specs(CASES[idx])
    cores, x = _inputs(jspec, np.float64)
    want = jax.jit(lambda cs, xx: jsbs.conv_sbs(jspec, cs, xx))(
        [jnp.asarray(c) for c in cores], jnp.asarray(x)
    )
    got = tsbs.conv_sbs(tspec, [torch.from_numpy(c) for c in cores], torch.from_numpy(x))
    assert got.shape == want.shape
    _close(got, want, 1e-10)


def test_mim_cut_matches_jax():
    for case in CASES + [MIXED_RING]:
        jspec, tspec = _specs(case)
        olr, qc, ok = K.sbs_supported(tspec)
        jolr, jqc, jok = jp.sbs_plan(jspec)
        assert (olr, qc, ok) == (jolr, jqc, jok)
        assert K._mim_cut(olr) == jp._mim_cut(jolr)


def _xT(x):
    """(C, B, H, W, Q) → the batch-minor (C, Q, H, W, B)."""
    return np.ascontiguousarray(np.transpose(x, (0, 4, 2, 3, 1)))


def _jax_fused(jspec, cores, xT, g, **kw):
    """Output and (d_cores, d_xT) of the interpret-mode Pallas kernels."""

    @jax.jit
    def fused(cs, xt, gg):
        out, vjp = jax.vjp(
            lambda cs_, xt_: jp.conv_sbs_pallas_t(jspec, cs_, xt_, interpret=True, **kw), cs, xt
        )
        return out, vjp(gg)

    return fused([jnp.asarray(c) for c in cores], jnp.asarray(xT), jnp.asarray(g))


def _port_fused(tspec, cores, xT, g, x_grad=True, **kw):
    tc = [torch.from_numpy(c).requires_grad_(True) for c in cores]
    txT = torch.from_numpy(xT).requires_grad_(x_grad)
    out = K.conv_sbs_t(tspec, tc, txT, **kw)
    (out * torch.from_numpy(np.asarray(g))).sum().backward()
    return out.detach(), [c.grad for c in tc], txT.grad


@pytest.mark.parametrize("idx,mim", [(0, True), (0, False), (3, False), (5, True)])
def test_plain_kernels_match_pallas_interpret_f32(idx, mim):
    """Forward, d_cores and d_views of the plain fold (the meet-in-the-middle
    family with mim=True, the sequential one with mim=False) against the
    interpret-mode Pallas kernels of the same family (the sequential family
    on a ring: the merge-position test below)."""
    jspec, tspec = _specs(CASES[idx])
    cores, x = _inputs(jspec, np.float32)
    xT = _xT(x)
    o_total = jspec.out_total_quantum_dim_size
    hp = 5 - jspec.max_height_pos
    g = np.random.default_rng(1).standard_normal((o_total, hp, hp, 2)).astype(np.float32)
    out_j, (gc_j, gx_j) = _jax_fused(jspec, cores, xT, g, mim=mim)
    out_t, gc_t, gx_t = _port_fused(tspec, cores, xT, g, mim=mim)
    _close(out_t, out_j, 2e-5, 1e-6, "out")
    for i, (a, b) in enumerate(zip(gc_t, gc_j)):
        _close(a, b, 2e-5, 1e-6, f"d_core {i}")
    _close(gx_t, gx_j, 2e-5, 1e-6, "d_xT")


def test_every_merge_position_matches_pallas_interpret_f32():
    """Every merge position m ∈ [1, P-1] of the plain fold against the
    interpret-mode kernels at the same m, forward and gradients
    (as test_mim_every_merge_position), and the sequential family."""
    jspec, tspec = _specs(MIXED_RING)
    cores, x = _inputs(jspec, np.float32, batch=3, size=4)
    xT = _xT(x)
    g = np.random.default_rng(2).standard_normal((16, 3, 3, 3)).astype(np.float32)
    mcuts = [None] + list(range(1, len(cores)))
    kws = [{"mim": False} if mcut is None else {"mim": True, "mcut": mcut} for mcut in mcuts]

    @jax.jit
    def every_cut(cs, xt, gg):  # one compile for all the cuts' kernels
        res = []
        for kw in kws:
            out, vjp = jax.vjp(
                lambda cs_, xt_: jp.conv_sbs_pallas_t(jspec, cs_, xt_, interpret=True, **kw), cs, xt
            )
            res.append((out, vjp(gg)))
        return res

    results = every_cut([jnp.asarray(c) for c in cores], jnp.asarray(xT), jnp.asarray(g))
    for mcut, kw, (out_j, (gc_j, gx_j)) in zip(mcuts, kws, results):
        out_t, gc_t, gx_t = _port_fused(tspec, cores, xT, g, **kw)
        _close(out_t, out_j, 2e-5, 1e-6, f"out mcut={mcut}")
        for i, (a, b) in enumerate(zip(gc_t, gc_j)):
            _close(a, b, 2e-5, 1e-6, f"d_core {i} mcut={mcut}")
        _close(gx_t, gx_j, 2e-5, 1e-6, f"d_xT mcut={mcut}")


@pytest.mark.parametrize("mim", [True, False])
def test_need_dviews_off_keeps_d_cores(mim):
    """With an input that needs no gradient the backward skips d_views (the
    plain version returns None for it) and d_cores equal JAX's
    ``need_dviews=False`` kernels' and the port's own with d_views."""
    jspec, tspec = _specs(MIXED_RING)
    cores, x = _inputs(jspec, np.float32)
    xT = _xT(x)
    g = np.random.default_rng(3).standard_normal((16, 4, 4, 2)).astype(np.float32)
    _, (gc_j, _) = _jax_fused(jspec, cores, xT, g, mim=mim, need_dviews=False)
    out_t, gc_t, gx_t = _port_fused(tspec, cores, xT, g, x_grad=False, mim=mim)
    _, gc_full, _ = _port_fused(tspec, cores, xT, g, mim=mim)
    assert gx_t is None
    for a, b, c in zip(gc_t, gc_j, gc_full):
        _close(a, b, 2e-5, 1e-6)
        _close(a, c, 0.0)
    olr, qc, _ = K.sbs_supported(tspec)
    views, *_ = K._merge_channel_views(torch.from_numpy(xT), tspec.positions, qc)
    lro = [K._core_to_lro(torch.from_numpy(c), o, l, r, qc) for c, (o, l, r) in zip(cores, olr)]
    gt = torch.from_numpy(g).reshape(16, -1)
    d_views, d_cores = K.sbs_bwd_reference(views, lro, gt, olr, K._mim_cut(olr) if mim else None,
                                           need_dviews=False)
    assert d_views is None and len(d_cores) == len(cores)


@pytest.mark.parametrize("idx", range(len(CASES)))
@pytest.mark.parametrize("mim", [True, False])
def test_plain_kernel_gradients_match_jax_xla_f64(idx, mim):
    """The fused route's gradients (cores and input) in float64 against
    ``jax.grad`` of the XLA fold."""
    jspec, tspec = _specs(CASES[idx])
    cores, x = _inputs(jspec, np.float64)

    def jloss(cs, xx):
        return jnp.sum(jnp.tanh(jsbs.conv_sbs(jspec, cs, xx)))

    gc_j, gx_j = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        [jnp.asarray(c) for c in cores], jnp.asarray(x)
    )
    tc = [torch.from_numpy(c).requires_grad_(True) for c in cores]
    tx = torch.from_numpy(x).requires_grad_(True)
    outT = K.conv_sbs_t(tspec, tc, tx.permute(0, 4, 2, 3, 1), mim=mim)
    torch.tanh(outT).sum().backward()
    for a, b in zip(tc, gc_j):
        _close(a.grad, b, 1e-10, 1e-13)
    _close(tx.grad, gx_j, 1e-10, 1e-13)


def test_merge_and_core_layout_match_jax():
    """The (P, q^C, npix) factor stack and the (l·r·o, q^C) core matrices
    equal the JAX host glue's, bit for bit."""
    jspec, tspec = _specs(CASES[4])
    cores, x = _inputs(jspec, np.float32)
    xT = _xT(x)
    olr, qc, _ = K.sbs_supported(tspec)
    v_j, npix_j, hp_j, wp_j = jp._merge_channel_views(jnp.asarray(xT), jspec.positions, qc)
    v_t, npix, hp, wp = K._merge_channel_views(torch.from_numpy(xT), tspec.positions, qc)
    assert (npix, hp, wp) == (npix_j, hp_j, wp_j)
    _close(v_t, v_j, 0.0)
    for c, (o, l, r) in zip(cores, olr):
        _close(K._core_to_lro(torch.from_numpy(c), o, l, r, qc),
               jp._core_to_lro(jnp.asarray(c), o, l, r, qc), 0.0)


def test_support_rule_and_kernel_plan():
    """The support rule refuses what ``sbs_plan`` refuses outside its VMEM
    clause; the launch plan of every legacy string, both families, forward
    and backward, fits the shared memory with at least 32 threads."""
    _, ring5 = _specs(([(0, 0), (0, 1)], (1, 1), (5, 5), 1))
    _, bond9 = _specs(([(0, 0), (0, 1)], (1, 1), (1, 9), 1))
    _, four_ch = _specs(([(0, 0), (0, 1)], (1, 1), (1, 2), 4))
    for spec in (ring5, bond9, four_ch):
        assert not K.sbs_supported(spec)[2]
        with pytest.raises(ValueError, match="ROADMAP"):
            K.conv_sbs_t(spec, [torch.zeros(s.as_tuple()) for s in spec.shapes],
                         torch.zeros((spec.in_num_channels, 2, 4, 4, 1)))
    from dctn_tpu_torch.models.conv_sbs_model import ConvSBSModelConfig

    for trace_edge in (False, True):
        for layer in ConvSBSModelConfig(2, 4, trace_edge=trace_edge).layer_specs():
            for spec in layer:
                olr, qc, ok = K.sbs_supported(spec)
                assert ok and K._mim_cut(olr) == 4
                for mcut in (4, None):
                    for backward in (False, True):
                        plan = K._launch_plan(olr, qc, mcut, backward)
                        assert plan.threads >= 32 and plan.smem_bytes <= K._MAX_SMEM_BYTES
                        lay, state = K._layout(olr, len(olr) if mcut is None else mcut, backward)
                        assert 0 < state == plan.ints[4]
