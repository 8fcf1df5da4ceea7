"""The port's bf16 operand mode against the JAX package's
``compute_dtype=bfloat16``, on the CPU.

The JAX side runs its Pallas kernels in interpret mode with ``mm_dtype``
bfloat16 (``_run_fwd``, ``_run_bwd_fused_t``, ``_run_bwd_fused``,
``_run_bwd``), its layer (``eps_pallas_apply_t_cmt``), its xla ``eps`` and
its fast model on ``pallas_interpret``; the port's CPU tensors run the
kernels' plain versions in the same mode. Inputs are made with numpy and
cross as numpy arrays.

Tolerance: both sides round the same float32 operands to the same bf16
values and sum the exact bf16 products in float32, so they differ only in
the order of float32 sums: rtol 1e-5 with atol 1e-6 of the largest entry,
as the float32 parity tests. A negative control shows that this tolerance
catches a rounding in the wrong place (v, or t before the epilogue). The
one exception is a tensor stored in bf16, the saved t: rounded from sums
taken in two orders, an entry may land one bf16 step (2^-7 of its size at
most) from the other package's; every check downstream of a saved t is fed
the same t on both sides, or a layer small enough that no entry does.
"""

import click
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctn_tpu import models as jm
from dctn_tpu.cli import runner as jrunner
from dctn_tpu.models import eps_plus_linear as jmodel
from dctn_tpu.ops import eps as jeps
from dctn_tpu.pallas import eps_pallas as jp
from dctn_tpu.train import make_optimizer as jax_make_optimizer
from dctn_tpu.train.step import make_fast_train_step as jax_make_fast_train_step
from dctn_tpu_torch.cli import export
from dctn_tpu_torch.cli import runner as trunner
from dctn_tpu_torch.data import load_dataset
from dctn_tpu_torch.interop import params_from_numpy
from dctn_tpu_torch.kernels import eps_kernels as K
from dctn_tpu_torch.models import (
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    EPSesPlusLinearReference,
    fast_layer_plans,
    saved_t_capped_layers,
)
from dctn_tpu_torch.ops import eps as eps_mod
from dctn_tpu_torch.train import make_fast_train_step, make_optimizer, resolve_auto_grad_accum
from dctn_tpu_torch.train import save_params_npz

BF = torch.bfloat16
RTOL = 1e-5
FLAGSHIP = ((4, 4), (3, 6))
THREE = ((2, 4), (2, 6), (2, 12))
DEEP = ((4, 4), (3, 12), (2, 24))
NPIX, BN = 128, 128
# (n, q, n1, O) of the kernels' shapes after the pair merge
SHAPES = {
    "flagship layer 1": (9, 4, 5, 6),  # A = 1024, B2 = 256: the saved-t arm
    "three-EPS layer 2": (4, 6, 3, 12),  # A = 216: the recompute arm
    "n2 = 0": (3, 3, 3, 5),  # kr2 = g, out = t
}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6 * np.abs(want).max())


def _np(x):
    """A JAX array (bf16 too) as a float32 numpy array."""
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# the plain versions against the TPU kernels in interpret mode


@pytest.fixture(scope="module")
def kernel_cases():
    """Per shape, the inputs and the JAX kernels' outputs with mm_dtype
    bf16, computed once: K1 with t, K2 (saved t), K4 (fused recompute), and
    the two-pass K3 + K6."""
    cases = {}
    for name, (n, q, n1, o) in SHAPES.items():
        rng = np.random.default_rng(len(cases))
        views = rng.uniform(size=(n, q, NPIX)).astype(np.float32)
        cmt = (rng.normal(size=(o * q ** (n - n1), q**n1)) * q ** (-n / 2)).astype(np.float32)
        g = rng.normal(size=(o, NPIX)).astype(np.float32)
        vj, cb, gj = jnp.asarray(views), jnp.asarray(cmt).astype(jnp.bfloat16), jnp.asarray(g)
        case = {"dims": (n, q, n1, o), "views": views, "cmt": cmt, "g": g}
        if n1 < n:
            out, t = jp._run_fwd(vj, cb, n1, o, BN, True, save_t=True)
            case["t"] = _np(t)
            case["k2"] = [_np(a) for a in jp._run_bwd_fused_t(vj, cb, gj, t, n1, o, BN, True)]
        else:
            out = jp._run_fwd(vj, cb, n1, o, BN, True)
        case["out"] = _np(out)
        case["k4"] = [_np(a) for a in jp._run_bwd_fused(vj, cb, gj, n1, o, BN, True)]
        case["k3k6"] = [_np(a) for a in jp._run_bwd(vj, cb, gj, n1, o, BN, BN, True, jnp.bfloat16)]
        cases[name] = case
    return cases


def _torch_case(case):
    n, q, n1, o = case["dims"]
    return (torch.tensor(case["views"]), torch.tensor(case["cmt"]).to(BF),
            torch.tensor(case["g"]), n, q, n1, o)


@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_forward_matches_k1(kernel_cases, name):
    """out at rtol 1e-5; the saved bf16 t within one bf16 step of JAX's."""
    case = kernel_cases[name]
    views, cb, _, n, _, n1, o = _torch_case(case)
    if n1 == n:
        _close(K.eps_fwd_reference(views, cb, n1, o), case["out"])
        return
    out, t = K.eps_fwd_reference(views, cb, n1, o, save_t=True)
    assert t.dtype == BF and out.dtype == torch.float32
    _close(out, case["out"])
    want = case["t"]
    assert np.all(np.abs(t.float().numpy() - want)
                  <= 2.0**-7 * np.abs(want) + RTOL * np.abs(want).max())


@pytest.mark.parametrize("name", ["flagship layer 1", "three-EPS layer 2"])
def test_the_tolerance_catches_a_rounding_in_the_wrong_place(kernel_cases, name):
    """The negative control: the forward with t rounded to bf16 before the
    epilogue, or with v rounded, fails the tolerance the port passes."""
    case = kernel_cases[name]
    views, cb, _, n, q, n1, o = _torch_case(case)
    t = K._fwd_t(views, cb, n1)
    v = K._suffix_chain(views, n1, n)[0]
    rounded_t = torch.sum(t.to(BF).float().reshape(o, q ** (n - n1), NPIX) * v[None], dim=1)
    rounded_v = torch.sum(t.reshape(o, q ** (n - n1), NPIX) * v.to(BF).float()[None], dim=1)
    for wrong in (rounded_t, rounded_v):
        with pytest.raises(AssertionError):
            _close(wrong, case["out"])
    _close(K.eps_fwd_reference(views, cb, n1, o), case["out"])


@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_dcore_matches_k2_k3_and_k4(kernel_cases, name):
    """d_cmt (float32) of the JAX kernels that compute it: K2's (saved t),
    K4's and the two-pass K3's."""
    case = kernel_cases[name]
    views, _, g, _, _, n1, o = _torch_case(case)
    got = K.eps_dcore_reference(views, g, n1, o, torch.bfloat16)
    assert got.dtype == torch.float32
    for key in ("k2", "k4", "k3k6"):
        if key in case:
            _close(got, case[key][1])


@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_dviews_match_k2_k4_and_k6(kernel_cases, name):
    """d_views on both arms: from JAX's saved bf16 t (K2), and with t
    recomputed unrounded (K4, and K6 without t)."""
    case = kernel_cases[name]
    views, cb, g, n, _, n1, o = _torch_case(case)
    rec = K.eps_dviews_recompute_reference(views, cb, g, n1, o)
    _close(rec, case["k4"][0])
    _close(rec, case["k3k6"][0])
    if n1 < n:
        t = torch.tensor(case["t"]).to(BF)  # JAX's t, exact in bf16
        _close(K.eps_dviews_t_reference(views, cb, g, t, n1, o), case["k2"][0])


def test_an_unknown_compute_dtype_is_refused():
    views, g = torch.zeros((2, 2, 4)), torch.zeros((1, 4))
    with pytest.raises(ValueError, match="compute dtype"):
        K.eps_dcore(views, g, 1, 1, mm_dtype=torch.float16)
    with pytest.raises(ValueError, match="compute dtype"):
        EPSesPlusLinearConfig(epses_specs=FLAGSHIP, compute_dtype=torch.float16)


# ---------------------------------------------------------------------------
# the layer against eps_pallas_apply_t_cmt


@pytest.mark.parametrize("specs,layer,min_a,want_arm", [
    (THREE, 2, None, "recompute"),  # A = 216
    (THREE, 1, 1, "saved_t"),  # A = 64, on the saved-t arm by a threshold of 1 in both
    (FLAGSHIP, 0, None, "dcore_only"),  # the first layer: d_cmt alone
])
def test_layer_matches_jax_vjp(specs, layer, min_a, want_arm, monkeypatch):
    """EPSApplyTCmt in the bf16 mode against jax.vjp of
    eps_pallas_apply_t_cmt with mm_dtype bf16, batch 16 on an 8×8 image:
    the value, d_cmt (float32, not rounded to bf16) and d_xT."""
    if min_a is not None:
        monkeypatch.setenv("DCTN_TPU_SAVE_T_MIN_A", str(min_a))
        monkeypatch.setattr(K, "SAVE_T_MIN_A", min_a)
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=8, q0=2)
    p = fast_layer_plans(cfg)[layer]
    c, q, k, o = p["c"], p["q"], p["kernel_size"], p["out_size"]
    h = 8 - sum(kk - 1 for kk, _ in specs[:layer])
    npix = 16 * (h - k + 1) ** 2
    rng = np.random.default_rng(10 * layer + len(specs))
    xT = rng.uniform(size=(c, q, h, h, 16)).astype(np.float32)
    n = k * k * c
    core = (rng.normal(size=(q,) * n + (o,)) * q ** (-n / 2)).astype(np.float32)
    n1, bn, merge, mm = jp.plan_pallas_call(c, q, k, p["n1"], o, npix, jnp.bfloat16, True)
    assert mm == jnp.bfloat16 and (n1, merge) == (p["n1"], p["merge_pairs"])
    n_k, q_k, n1_k = jp._kernel_dims(c, q, k, n1, merge)
    assert K.plan_backward(layer, n_k, n1_k, q_k, o, npix, 2) == want_arm
    npad = -(-npix // bn) * bn
    assert (jp._save_t_plan(n_k, n1_k, q_k, o, bn, mm, npad, layer == 0) is not None) == (
        want_arm == "saved_t")

    cmt = np.asarray(jp._core_to_cmt_k(jnp.asarray(core), n1_k, q_k))
    out_j, vjp = jax.vjp(
        lambda c_, x_: jp.eps_pallas_apply_t_cmt(c_, x_, o, k, n1, bn, True, mm, merge, layer == 0),
        jnp.asarray(cmt), jnp.asarray(xT),
    )
    g = rng.normal(size=out_j.shape).astype(np.float32)
    d_cmt_j, d_xT_j = vjp(jnp.asarray(g))

    cmt_t = torch.tensor(cmt, requires_grad=True)
    xT_t = torch.tensor(xT, requires_grad=True)
    saved = K.eps_fwd.bf16_t_launches, K.eps_fwd.t_launches
    out = K.eps_apply_t_cmt(cmt_t, xT_t, o, k, n1, merge, layer_index=layer, mm_dtype=BF)
    d_cmt, d_xT = torch.autograd.grad(out, (cmt_t, xT_t), torch.tensor(g))
    assert (K.eps_fwd.bf16_t_launches, K.eps_fwd.t_launches) == saved  # the CPU runs no kernel
    assert d_cmt.dtype == torch.float32 and not torch.equal(d_cmt, d_cmt.to(BF).float())
    for got, want in ((out, out_j), (d_cmt, d_cmt_j), (d_xT, d_xT_j)):
        _close(got, want)


# ---------------------------------------------------------------------------
# the xla eps


@pytest.mark.parametrize("custom_vjp", [True, False])
@pytest.mark.parametrize("q,k,o,split", [(3, 2, 5, None), (2, 2, 4, 4)])  # n2 > 0; n1 = n
def test_xla_eps_matches_jax(custom_vjp, q, k, o, split):
    """eps(..., compute_dtype=bf16) on the reference layout, both backward
    paths (the JAX custom VJP's casts, autograd of the cast forward):
    value, d_core and d_x against the JAX package's."""
    rng = np.random.default_rng(q + k + o)
    core = (rng.normal(size=(q,) * (k * k) + (o,)) * q ** (-k * k / 2)).astype(np.float32)
    x = rng.uniform(size=(1, 4, 6, 6, q)).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda c_, x_: jeps.eps(c_, x_, split=split, compute_dtype=jnp.bfloat16,
                                custom_vjp=custom_vjp),
        jnp.asarray(core), jnp.asarray(x))
    g = rng.normal(size=out_j.shape).astype(np.float32)
    d_core_j, d_x_j = vjp(jnp.asarray(g))
    core_t, x_t = torch.tensor(core, requires_grad=True), torch.tensor(x, requires_grad=True)
    out = eps_mod.eps(core_t, x_t, split=split, custom_vjp=custom_vjp, compute_dtype=BF)
    d_core, d_x = torch.autograd.grad(out, (core_t, x_t), torch.tensor(g))
    for got, want in ((out, out_j), (d_core, d_core_j), (d_x, d_x_j)):
        _close(got, want)
    # the float32 forward is another function
    with pytest.raises(AssertionError):
        _close(eps_mod.eps(core_t, x_t, split=split), out_j)


# ---------------------------------------------------------------------------
# the model and its training step


def _model_setup(specs, unit_features=True, image_size=8, batch=8, seed=0):
    """(JAX cfg, JAX params, numpy params, port cfg, x, y), both configs
    bf16. ``unit_features``: inputs of unit second moment, the scale at
    which the theoretical init keeps every layer's output O(1) (on uniform
    [0, 1) features each layer's output shrinks by 3^(K²/2) and the logits
    are their bias to the bit); else uniform [0, 1) features, on which the
    flagship stays trainable at lr 0.05 (test_torch_port_train.py)."""
    jcfg = jm.EPSesPlusLinearConfig(
        epses_specs=specs, image_size=image_size, q0=2, compute_dtype=jnp.bfloat16,
        train_backend="pallas_interpret", eval_backend="pallas_interpret",
    )
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=image_size, q0=2,
                                compute_dtype=BF)
    # the JAX package's theoretical init, drawn with numpy: each core
    # randn·Q^(-n/2), the classifier's w randn·in^(-1/2)/4 and b U(±in^(-1/2))
    rng = np.random.default_rng(seed)
    n_in = cfg.linear_in_features
    np_params = {
        "epses": tuple((rng.standard_normal(p["core_shape"])
                        * p["q"] ** (-(len(p["core_shape"]) - 1) / 2)).astype(np.float32)
                       for p in fast_layer_plans(cfg)),
        "linear": {"w": (rng.standard_normal((n_in, 10)) * n_in**-0.5 / 4).astype(np.float32),
                   "b": (rng.uniform(-1, 1, 10) * n_in**-0.5).astype(np.float32)},
    }
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    x = rng.uniform(size=(1, batch, image_size, image_size, 2))
    x = (x * np.sqrt(3.0) if unit_features else x).astype(np.float32)
    y = np.arange(batch) % 10
    return jcfg, jparams, np_params, cfg, x, y


def _leaves(model):
    return list(model.cmts) + [model.linear_w, model.linear_b]


def _jleaves(fast):
    return list(fast["epses_cmt"]) + [fast["linear"]["w"], fast["linear"]["b"]]


# End to end, a layer past the first builds its u from the earlier layer's
# output, which the two packages sum in other orders, and rounds it to bf16;
# so does the backward's kr2 = g·v, from cotangents summed in other orders,
# and K1 its saved t. Where the two float32 values straddle a bf16 rounding
# boundary, an entry lands one bf16 step (2^-8 of itself) apart and carries
# that into what follows. The logits are held to 1e-4 of the largest (read:
# 4e-7 to 2e-5 over seeds 0-3 on both models; the float32 model misses by
# 3e-3 or more). The gradients: the three-EPS model's (its sums are short:
# read 3e-6 of the largest at most) at rtol 1e-5, atol 1e-5 of the largest.
# The flagship's are not compared end to end at this size: its layer-0
# d_cmt sums 200 pixels, so one landing moves an entry by up to 6e-3 of the
# largest (seed 3), the size of the gap to the float32 gradients. Its
# layers are held one at a time, each with the same inputs, cotangent and t
# on both sides, at rtol 1e-5 (test_plain_*, test_layer_matches_jax_vjp).
CASCADE_LOGITS = 1e-4


def _jax_loss_and_logits(jcfg, jplans, x, y):
    def loss(fast):
        logits = jmodel.eps_plus_linear_forward_fast(fast, jnp.asarray(x), jcfg, jplans,
                                                     training=True)
        ce = -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(y)[:, None], 1))
        return ce, logits

    return jax.jit(jax.value_and_grad(loss, has_aux=True))


@pytest.mark.parametrize("specs", [FLAGSHIP, THREE], ids=["flagship", "three"])
def test_fast_model_matches_jax(specs):
    """The fast model's logits (on features of unit second moment: O(1)
    logits) against the JAX fast forward with compute_dtype bf16 on
    pallas_interpret at 1e-4 of the largest, and the three-EPS model's
    cross-entropy gradients at rtol 1e-5, atol 1e-5 of the largest (the
    bounds above); the float32 model misses both (the negative control)."""
    import torch.nn.functional as F

    jcfg, jparams, np_params, cfg, x, y = _model_setup(specs)
    jfast, jplans = jmodel.fast_params_from_reference(jparams, jcfg)
    model = EPSesPlusLinear.from_reference(params_from_numpy(np_params), cfg)
    f32 = EPSesPlusLinear.from_reference(params_from_numpy(np_params),
                                         EPSesPlusLinearConfig(epses_specs=specs, image_size=8))
    assert model.plans == jplans
    (_, want), jgrads = _jax_loss_and_logits(jcfg, jplans, x, y)(jfast)
    want, jgrads = np.asarray(want), _jleaves(jgrads)
    grads, logits = [], []
    for m in (model, f32):
        out = m(torch.tensor(x))
        F.cross_entropy(out, torch.tensor(y)).backward()
        grads.append([p.grad for p in _leaves(m)])
        logits.append(out.detach().numpy())
    limit = CASCADE_LOGITS * np.abs(want).max()
    np.testing.assert_allclose(logits[0], want, rtol=RTOL, atol=limit)
    assert np.abs(logits[1] - want).max() > limit
    if specs == FLAGSHIP:
        return
    for i, (got, g32, want_g) in enumerate(zip(*grads, jgrads)):
        want_g = np.asarray(want_g)
        scale = np.abs(want_g).max()
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want_g, rtol=RTOL, atol=RTOL * scale)
        if i < len(model.cmts):  # the float32 cores' gradients are another function's
            assert np.abs(g32.numpy() - want_g).max() > RTOL * scale


@pytest.mark.parametrize("specs", [FLAGSHIP, THREE], ids=["flagship", "three"])
def test_three_fast_steps_match_jax(specs):
    """3 Adam steps (lr 0.05, epswise 1e-3, batch 8 on an 8×8 image, uniform
    features) of the port's fast step in bf16 against the JAX fast step with
    compute_dtype bf16 on pallas_interpret: the losses and the parameters at
    the bound the float32 step is held to (rtol 2e-5, atol 1e-7,
    test_torch_port_train.py); the parameters stay float32."""
    jcfg, jparams, np_params, cfg, x, y = _model_setup(specs, unit_features=False)
    jfast, jplans = jmodel.fast_params_from_reference(jparams, jcfg)
    jopt = jax_make_optimizer("adam", 0.05)
    jstep = jax_make_fast_train_step(jcfg, jopt, jplans, "epswise", 1e-3, donate=False)
    f, o = jfast, jopt.init(jfast)
    jmetrics = []
    for i in range(3):
        f, o, m = jstep(f, o, jax.random.PRNGKey(5 + i), jnp.asarray(x), jnp.asarray(y))
        jmetrics.append(m)
    model = EPSesPlusLinear.from_reference(params_from_numpy(np_params), cfg)
    step = make_fast_train_step(model, make_optimizer("adam", model.parameters(), 0.05),
                                "epswise", 1e-3)
    metrics = [step(torch.tensor(x), torch.tensor(y)) for _ in range(3)]
    for m, jm_ in zip(metrics, jmetrics):
        for key in ("loss", "ce", "reg_term"):
            np.testing.assert_allclose(float(m[key]), float(jm_[key]), rtol=2e-5)
    for got, want in zip(_leaves(model), _jleaves(f)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=1e-7)


def test_reference_layout_forward_matches_jax_xla():
    """The xla backend's model (EPSesPlusLinearReference) in bf16 against
    the JAX reference-layout forward on its xla backend, the logits at the
    end-to-end bound above."""
    _, jparams, np_params, cfg, x, _ = _model_setup(FLAGSHIP)
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=FLAGSHIP, image_size=8, q0=2,
                                    compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got = EPSesPlusLinearReference(params_from_numpy(np_params), cfg)(torch.tensor(x))
    want = jmodel.eps_plus_linear_forward(jparams, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=CASCADE_LOGITS * np.abs(want).max())


def test_qat_refuses_the_bf16_mode():
    """Once refused, now the mode: ``qat="int8"`` takes a bf16 model and
    steps it, its parameters float32 and finite (its parity with the JAX
    package: tests/test_torch_port_bf16_qat.py)."""
    _, _, np_params, cfg, x, y = _model_setup(THREE)
    model = EPSesPlusLinear.from_reference(params_from_numpy(np_params), cfg)
    step = make_fast_train_step(model, make_optimizer("adam", model.parameters(), 1e-3),
                                qat="int8")
    m = step(torch.tensor(x), torch.tensor(y))
    assert np.isfinite(float(m["loss"]))
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all() for p in model.parameters())


# ---------------------------------------------------------------------------
# the saved-t cap in bf16 and "auto" accumulation


@pytest.mark.parametrize("specs", [FLAGSHIP, DEEP], ids=["flagship", "deep"])
def test_saved_t_cap_and_auto_accum_match_jax_bf16(specs):
    """saved_t_capped_layers and resolve_auto_grad_accum with a bf16
    compute dtype against the JAX package's (its runner's
    ``_resolve_auto_grad_accum``), batch 128 to 8192 at 28×28: t counted at
    2 bytes an entry on both sides. The deep model at 2048 picks 2, as the
    JAX docs say (the float32 mode picks 4)."""
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=specs, image_size=28, q0=2,
                                    compute_dtype=jnp.bfloat16, train_backend="pallas",
                                    eval_backend="pallas")
    jplans = jmodel.fast_layer_plans(jcfg)
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=28, q0=2, compute_dtype=BF)
    plans = fast_layer_plans(cfg)
    assert plans == jplans
    for batch in (128, 256, 512, 1024, 2048, 4096, 8192):
        assert saved_t_capped_layers(cfg, plans, batch) == jmodel.saved_t_capped_layers(
            jcfg, jplans, batch), batch
        assert resolve_auto_grad_accum(cfg, plans, batch) == jrunner._resolve_auto_grad_accum(
            jcfg, jplans, batch), batch
    if specs == DEEP:
        assert resolve_auto_grad_accum(cfg, plans, 2048) == 2
        assert resolve_auto_grad_accum(EPSesPlusLinearConfig(epses_specs=DEEP), plans, 2048) == 4


# ---------------------------------------------------------------------------
# the runner and export

RUN = dict(ds_type="fashionmnist", ds_path="synthetic", epses_specs=((2, 4), (2, 6)),
           batch_size=16, optimizer_name="adam", lr=3e-3, synthetic_sizes=(64, 32, 32),
           eval_schedule=((None, 2),), max_num_iters=4, keep_last_models=1,
           init_epses_composition_unit_theoretical_output_std=True, device="cpu")


def test_runner_trains_in_bf16_and_exports_a_bf16_artifact(tmp_path):
    """--compute-dtype bfloat16 on one device: the run's model is in the
    mode, its parameters float32; --export-artifact writes a bf16 artifact
    equal to the eager bf16 forward, and an int8 export of it says float32
    (runner.py:1763-1768)."""
    art = str(tmp_path / "bf16.zip")
    state = trunner.run(experiments_dir=str(tmp_path / "exp"), compute_dtype="bfloat16",
                        export_artifact=art, export_batch_sizes="8", **RUN)
    cfg = state.extras["cfg"]
    assert cfg.compute_dtype == BF
    final = state.extras["params_view"](state.params)
    assert all(c.dtype == torch.float32 for c in final["epses"])
    meta, fns = export.load_artifact(art)
    assert meta["compute_dtype"] == "bfloat16"
    model = EPSesPlusLinear.from_reference(final, cfg)
    x = torch.tensor(load_dataset("fashionmnist", "synthetic", autoscale_kernel_size=2,
                                  synthetic_sizes=(64, 32, 32)).test.x[:, :8])
    with torch.inference_mode():
        assert torch.equal(fns[8](x), model(x))
    art8 = str(tmp_path / "int8.zip")
    trunner.run(experiments_dir=str(tmp_path / "exp8"), compute_dtype="bfloat16",
                export_artifact=art8, export_batch_sizes="8", export_quantize="int8", **RUN)
    assert export.load_artifact(art8)[0]["compute_dtype"] == "float32"


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_export_writes_a_bf16_artifact_equal_to_the_eager_forward(tmp_path, backend):
    """export.run --compute-dtype bfloat16 on the CPU: the artifact gives
    the eager bf16 model's logits bit for bit, and its meta says so."""
    rng = np.random.default_rng(7)
    cfg = EPSesPlusLinearConfig(epses_specs=((2, 4), (2, 6)), image_size=8, q0=2,
                                compute_dtype=BF)
    np_params = {"epses": tuple((rng.standard_normal(p["core_shape"]) * 0.5).astype(np.float32)
                                for p in fast_layer_plans(cfg)),
                 "linear": {"w": rng.standard_normal((cfg.linear_in_features, 10)).astype(np.float32),
                            "b": rng.standard_normal(10).astype(np.float32)}}
    ckpt, art = str(tmp_path / "m.npz"), str(tmp_path / "m.zip")
    save_params_npz(np_params, ckpt)
    export.run(checkpoint=ckpt, epses_specs=cfg.epses_specs, image_size=8, batch_sizes=(3,),
               device="cpu", backend=backend, compute_dtype="bfloat16", out=art)
    meta, fns = export.load_artifact(art)
    assert meta["compute_dtype"] == "bfloat16"
    params = params_from_numpy(np_params)
    model = (EPSesPlusLinear.from_reference(params, cfg) if backend == "pallas"
             else EPSesPlusLinearReference(params, cfg))
    x = torch.tensor(rng.random((1, 3, 8, 8, 2)).astype(np.float32))
    with torch.inference_mode():
        assert torch.equal(fns[3](x), model(x))
    if backend == "pallas":
        assert export.op_nodes(fns[3]) == {"eps_fwd": 2}


def test_export_refuses_the_bf16_combinations(tmp_path):
    """``--quantize int8`` with bf16 stays refused, in JAX's words;
    ``--space-devices`` with bf16, once refused, exports a bf16
    height-sharded artifact (its parity: tests/test_torch_port_export_sp.py)."""
    kw = dict(checkpoint=str(tmp_path / "none.npz"), epses_specs=((2, 4),), image_size=8,
              batch_sizes=(2,), device="cpu", compute_dtype="bfloat16",
              out=str(tmp_path / "bad.zip"))
    with pytest.raises(click.UsageError, match="mutually exclusive"):
        export.run(quantize="int8", **kw)
    _, _, np_params, _, _, _ = _model_setup(((2, 4),))
    save_params_npz(np_params, kw["checkpoint"])
    export.run(space_devices=2, **kw)
    meta, _ = export.load_artifact(kw["out"])
    assert meta["compute_dtype"] == "bfloat16" and meta["space_devices"] == 2
