"""The recompute backward, the composition regularizer and gradient
accumulation of the port against the JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (``pallas_interpret``)
or its XLA reference-layout step in float64; the port's CPU tensors run the
kernels' plain versions. Parameters come from the JAX init and inputs are
made with numpy; both cross as numpy arrays. The recompute kernel itself is
held against its plain version on the card (``test_torch_port_cuda.py``,
``chip_smoke.py``).
"""

import json

import click
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctn_tpu import models as jm
from dctn_tpu.cli import runner as jrunner
from dctn_tpu.models import eps_plus_linear as jmodel
from dctn_tpu.ops import composition as jcomp
from dctn_tpu.ops import eps as jeps
from dctn_tpu.pallas import eps_pallas as jp
from dctn_tpu.train import make_optimizer as jax_make_optimizer
from dctn_tpu.train import make_train_step as jax_make_train_step
from dctn_tpu.train.step import make_fast_train_step as jax_make_fast_train_step
from dctn_tpu_torch import bench
from dctn_tpu_torch.interop import params_from_numpy
from dctn_tpu_torch.kernels import eps_kernels as K
from dctn_tpu_torch.models import (
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    epses_composition_l2_regularizer,
    epses_composition_l2_regularizer_fast,
    fast_layer_plans,
    fast_params_from_reference,
    reference_params_from_fast,
    saved_t_capped_layers,
)
from dctn_tpu_torch.ops import composition, eps as eps_mod
from dctn_tpu_torch.train import make_fast_train_step, make_optimizer, resolve_auto_grad_accum

FLAGSHIP = ((4, 4), (3, 6))
DEEP = ((4, 4), (3, 12), (2, 24))
# the repo's three-EPS QAT family (experiments/qat_value.py:35-37): every
# later layer has A = q_k^n1_k < 512 and takes the recompute arm
THREE = ((2, 4), (2, 6), (2, 12))
# a coefficient at which the composition term moves the trajectory (its
# gradient is of the cross-entropy's order on these models) and the 3 steps
# stay finite
COMPOSITION_COEFF = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once (see
    test_torch_port_train.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _setup(specs, image_size=8, batch=16, seed=0):
    jcfg = jm.EPSesPlusLinearConfig(
        epses_specs=specs, image_size=image_size, q0=2,
        train_backend="pallas_interpret", eval_backend="pallas_interpret",
    )
    jparams = jm.init_eps_plus_linear(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=image_size, q0=2)
    # uniform features, as in test_torch_port_train.py: trainable at lr 0.05
    # for the 3 steps on both models
    x = np.random.default_rng(seed).uniform(size=(1, batch, image_size, image_size, 2)).astype(np.float32)
    y = np.arange(batch) % 10
    return jcfg, jparams, np_params, cfg, x, y


# ---------------------------------------------------------------------------
# one layer on the recompute arm against the JAX custom_vjp


@pytest.mark.parametrize("force_two_pass", [False, True])  # JAX: K4, or K3 + K6
@pytest.mark.parametrize(
    "specs,layer,cap",
    [
        (THREE, 1, None),  # A = 64
        (THREE, 2, None),  # A = 216
        (FLAGSHIP, 1, 0),  # A = 1024, forced onto the arm by a zero cap on t
    ],
)
def test_recompute_layer_matches_jax_vjp(specs, layer, cap, force_two_pass, monkeypatch):
    """EPSApplyTCmt on the recompute arm against jax.vjp of
    eps_pallas_apply_t_cmt in interpret mode, float32, rtol 1e-5: the
    layer's value, d_cmt and d_xT, batch 16 on an 8×8 image."""
    if cap is not None:
        monkeypatch.setenv("DCTN_TPU_SAVE_T_MAX_BYTES", str(cap))
        monkeypatch.setattr(K, "SAVE_T_MAX_BYTES", cap)
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=8, q0=2)
    p = fast_layer_plans(cfg)[layer]
    c, q, k, o = p["c"], p["q"], p["kernel_size"], p["out_size"]
    h = 8 - sum(kk - 1 for kk, _ in specs[:layer])
    npix = 16 * (h - k + 1) ** 2
    rng = np.random.default_rng(10 * layer + len(specs))
    xT = rng.uniform(size=(c, q, h, h, 16)).astype(np.float32)
    n = k * k * c
    core = (rng.normal(size=(q,) * n + (o,)) * q ** (-n / 2)).astype(np.float32)
    n1, bn, merge, mm = jp.plan_pallas_call(c, q, k, p["n1"], o, npix, None, True)
    assert (n1, merge) == (p["n1"], p["merge_pairs"])
    n_k, q_k, n1_k = jp._kernel_dims(c, q, k, n1, merge)
    npad = -(-npix // bn) * bn
    assert jp._save_t_plan(n_k, n1_k, q_k, o, bn, mm, npad, force_two_pass) is None
    if not force_two_pass:  # the fused recompute kernel, not the two-pass one
        fused = jp._largest_bn(lambda v: jp._fused_bytes(n_k, n1_k, q_k, o, v, 4), cap=bn)
        assert fused is not None and fused >= jp._FUSED_MIN_BN
    assert K.plan_backward(layer, n_k, n1_k, q_k, o, npix) == "recompute"

    cmt = np.asarray(jp._core_to_cmt_k(jnp.asarray(core), n1_k, q_k))
    out_j, vjp = jax.vjp(
        lambda c_, x_: jp.eps_pallas_apply_t_cmt(c_, x_, o, k, n1, bn, True, mm, merge, force_two_pass),
        jnp.asarray(cmt), jnp.asarray(xT),
    )
    g = rng.normal(size=out_j.shape).astype(np.float32)
    d_cmt_j, d_xT_j = vjp(jnp.asarray(g))

    cmt_t = torch.tensor(cmt, requires_grad=True)
    xT_t = torch.tensor(xT, requires_grad=True)
    out = K.eps_apply_t_cmt(cmt_t, xT_t, o, k, n1, merge, layer_index=layer)
    d_cmt, d_xT = torch.autograd.grad(out, (cmt_t, xT_t), torch.tensor(g))
    for got, want in ((out, out_j), (d_cmt, d_cmt_j), (d_xT, d_xT_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.detach().numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max()
        )


# ---------------------------------------------------------------------------
# the composition's inner product


def _numpy_params(specs, image_size, seed):
    """Reference-layout float64 parameters made with numpy: each core
    randn·(Q^n)^(-1/2) (the unit-theoretical scale), the classifier randn."""
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=image_size, q0=2)
    rng = np.random.default_rng(seed)
    cores, q = [], 2
    for k, o in specs:
        cores.append(rng.normal(size=(q,) * (k * k) + (o,)) * q ** (-k * k / 2))
        q = o
    linear = {"w": rng.normal(size=(cfg.linear_in_features, 10)) * 0.1, "b": rng.normal(size=(10,))}
    return cfg, {"epses": tuple(cores), "linear": linear}


@pytest.mark.parametrize("specs,image_size", [(DEEP, 28), (THREE, 8), (FLAGSHIP, 8)])
def test_composition_inner_products_match_jax_f64(specs, image_size):
    """inner_product (reference layout) and inner_product_cmt (fast layout,
    on the model's own plans) against the JAX package's, float64, rtol
    1e-10; and the two regularizers against the JAX one."""
    cfg, np_params = _numpy_params(specs, image_size, seed=1)
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=specs, image_size=image_size, q0=2, dtype=jnp.float64)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, dtype=torch.float64)
    fast, plans = fast_params_from_reference(params, cfg)
    jfast, jplans = jmodel.fast_params_from_reference(jparams, jcfg)
    assert plans == jplans
    want = float(jcomp.inner_product(jparams["epses"], jparams["epses"]))
    want_cmt = float(jcomp.inner_product_cmt(jfast["epses_cmt"], jplans))
    got = float(composition.inner_product(params["epses"], params["epses"]))
    got_cmt = float(composition.inner_product_cmt(fast["epses_cmt"], plans))
    np.testing.assert_allclose([got, got_cmt], [want, want_cmt], rtol=1e-10)
    np.testing.assert_allclose(got_cmt, got, rtol=1e-10)
    want_reg = float(jmodel.epses_composition_l2_regularizer(jparams))
    np.testing.assert_allclose(
        [float(epses_composition_l2_regularizer(params)),
         float(epses_composition_l2_regularizer_fast(fast, plans))],
        [want_reg, want_reg], rtol=1e-10,
    )


def test_eps_algebra_matches_jax_f64():
    """kron_power, contract_on_input_dims, inner_product and
    absorb_on_input_dims (ops/eps.py:394-451) on random float64 cores."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(3,) * 5 + (4,))
    b = rng.normal(size=(3,) * 5 + (4,))
    x = rng.normal(size=(3, 2))
    m = rng.normal(size=(2, 3))
    t = {k: torch.tensor(v) for k, v in dict(a=a, b=b, x=x, m=m).items()}
    pairs = [
        (eps_mod.kron_power(t["m"], 3), jeps.kron_power(jnp.asarray(m), 3)),
        (eps_mod.contract_on_input_dims(t["a"], t["b"]), jeps.contract_on_input_dims(jnp.asarray(a), jnp.asarray(b))),
        (eps_mod.inner_product(t["a"], t["b"]), jeps.inner_product(jnp.asarray(a), jnp.asarray(b))),
        (eps_mod.absorb_on_input_dims(t["a"], t["x"]), jeps.absorb_on_input_dims(jnp.asarray(a), jnp.asarray(x))),
        # one input dim: no second half
        (eps_mod.absorb_on_input_dims(t["a"][0, 0, 0, 0], t["x"]),
         jeps.absorb_on_input_dims(jnp.asarray(a[0, 0, 0, 0]), jnp.asarray(x))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)


# ---------------------------------------------------------------------------
# the step with gradient accumulation and the composition regularizer


def _port_steps(np_params, cfg, x, y, lr, reg_type, coeff, accum, steps, dtype):
    model = EPSesPlusLinear.from_reference(params_from_numpy(np_params, dtype=dtype), cfg)
    opt = make_optimizer("adam", model.parameters(), lr)
    step = make_fast_train_step(model, opt, reg_type, coeff, grad_accum_steps=accum)
    xt, yt = torch.tensor(x, dtype=dtype), torch.tensor(y)
    return model, [step(xt, yt) for _ in range(steps)]


@pytest.mark.parametrize("accum", [2, 4])
@pytest.mark.parametrize("specs", [THREE, FLAGSHIP])
def test_accumulated_composition_step_matches_jax_pallas_interpret_f32(specs, accum):
    """3 Adam steps (lr 0.05) with the composition regularizer and
    ``grad_accum_steps`` 2 or 4 against dctn_tpu's fast step on
    pallas_interpret, batch 16 on an 8×8 image, float32. The three-EPS
    model's later layers run the recompute backward.

    Tolerance: rtol 2e-5, the bound tests/test_fast_layout.py holds the JAX
    fast step to, on the metrics, and on each parameter in norm. Entry by
    entry it cannot hold: the composition regularizer's f32 gradient is
    ~1e-6 of its largest entry from the float64 one in either package (the
    two sum in other orders), and Adam's m/√v turns that into a visible
    step for the few entries whose gradient is near 0 (192 of the
    flagship's 1.5M layer-1 entries, up to 7e-6 apart after 3 steps;
    without the regularizer every entry holds rtol 2e-5, atol 1e-7). The
    float64 test below holds every entry at 1e-10."""
    jcfg, jparams, np_params, cfg, x, y = _setup(specs)
    jfast, jplans = jmodel.fast_params_from_reference(jparams, jcfg)
    jopt = jax_make_optimizer("adam", 0.05)
    jstep = jax_make_fast_train_step(
        jcfg, jopt, jplans, "epses_composition", COMPOSITION_COEFF, donate=False,
        grad_accum_steps=accum,
    )
    f, o = jfast, jopt.init(jfast)
    jmetrics = []
    for i in range(3):
        f, o, m = jstep(f, o, jax.random.PRNGKey(5 + i), jnp.asarray(x), jnp.asarray(y))
        jmetrics.append(m)
    model, metrics = _port_steps(np_params, cfg, x, y, 0.05, "epses_composition",
                                 COMPOSITION_COEFF, accum, 3, torch.float32)
    for m, jm_ in zip(metrics, jmetrics):
        for key in ("loss", "ce", "reg_term"):
            np.testing.assert_allclose(float(m[key]), float(jm_[key]), rtol=2e-5)
    got = [*model.cmts, model.linear_w, model.linear_b]
    want = [*f["epses_cmt"], f["linear"]["w"], f["linear"]["b"]]
    for a, b in zip(got, want):
        a, b = a.detach().numpy(), np.asarray(b)
        assert np.linalg.norm(a - b) <= 2e-5 * np.linalg.norm(b)


@pytest.mark.parametrize("specs,accum", [(THREE, 4), (FLAGSHIP, 2)])
def test_accumulated_composition_step_matches_jax_xla_reference_layout_f64(specs, accum):
    """The same 3 steps in float64 against dctn_tpu's reference-layout step
    on the xla backend (its composition regularizer on the N-D cores),
    rtol 1e-10."""
    _, jparams, np_params, cfg, x, y = _setup(specs)
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=specs, image_size=8, q0=2, dtype=jnp.float64)
    j64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jparams)
    jopt = jax_make_optimizer("adam", 0.05)
    jstep = jax_make_train_step(jcfg, jopt, "epses_composition", COMPOSITION_COEFF, donate=False,
                                grad_accum_steps=accum)
    p, o = j64, jopt.init(j64)
    jmetrics = []
    for i in range(3):
        p, o, m = jstep(p, o, jax.random.PRNGKey(5 + i), jnp.asarray(x, jnp.float64), jnp.asarray(y))
        jmetrics.append(m)
    model, metrics = _port_steps(np_params, cfg, x.astype(np.float64), y, 0.05, "epses_composition",
                                 COMPOSITION_COEFF, accum, 3, torch.float64)
    for m, jm_ in zip(metrics, jmetrics):
        for key in ("loss", "ce", "reg_term"):
            np.testing.assert_allclose(float(m[key]), float(jm_[key]), rtol=1e-10)
    back = reference_params_from_fast(model.fast_params(), cfg, model.plans)
    for got, want in zip(back["epses"], p["epses"]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-10, atol=1e-15)
    for key in ("w", "b"):
        np.testing.assert_allclose(
            back["linear"][key].detach().numpy(), np.asarray(p["linear"][key]), rtol=1e-10, atol=1e-15
        )


def test_accumulation_gives_the_whole_batch_gradient_f64():
    """One epswise step at grad_accum_steps 4 and at 1 from the same
    parameters: the microbatches' averaged gradients are the whole batch's,
    float64 rtol 1e-10 (an SGD step moves every parameter by lr·grad)."""
    _, _, np_params, cfg, x, y = _setup(THREE)
    params = []
    for accum in (1, 4):
        model = EPSesPlusLinear.from_reference(params_from_numpy(np_params, dtype=torch.float64), cfg)
        step = make_fast_train_step(model, make_optimizer("sgd", model.parameters(), 1.0), "epswise",
                                    1e-3, grad_accum_steps=accum)
        m = step(torch.tensor(x, dtype=torch.float64), torch.tensor(y))
        params.append(([p.grad.clone() for p in model.parameters()], m))
    (g1, m1), (g4, m4) = params
    for a, b in zip(g4, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-14)
    for key in ("loss", "ce", "reg_term"):
        np.testing.assert_allclose(float(m4[key]), float(m1[key]), rtol=1e-10)


def test_step_refuses_an_accumulation_that_does_not_divide_the_batch():
    _, _, np_params, cfg, x, y = _setup(THREE, batch=6)
    model = EPSesPlusLinear.from_reference(params_from_numpy(np_params), cfg)
    step = make_fast_train_step(model, make_optimizer("adam", model.parameters(), 1e-3),
                                grad_accum_steps=4)
    with pytest.raises(ValueError, match="does not divide the batch of 6"):
        step(torch.tensor(x), torch.tensor(y))


# ---------------------------------------------------------------------------
# the saved-t cap and grad_accum_steps="auto"

_BATCHES = (128, 256, 512, 1024, 2048, 4096, 8192)


@pytest.mark.parametrize("specs", [FLAGSHIP, DEEP])
def test_saved_t_capped_layers_and_auto_accum_match_jax_f32(specs):
    """saved_t_capped_layers and resolve_auto_grad_accum against the JAX
    package's (its runner's ``_resolve_auto_grad_accum``) with a float32
    compute dtype, the port's t: at batch 128 to 8192, 28×28."""
    jcfg = jm.EPSesPlusLinearConfig(
        epses_specs=specs, image_size=28, q0=2, compute_dtype=jnp.float32,
        train_backend="pallas", eval_backend="pallas",
    )
    jplans = jmodel.fast_layer_plans(jcfg)
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=28, q0=2)
    plans = fast_layer_plans(cfg)
    assert plans == jplans
    for batch in _BATCHES:
        assert saved_t_capped_layers(cfg, plans, batch) == jmodel.saved_t_capped_layers(jcfg, jplans, batch), batch
        assert resolve_auto_grad_accum(cfg, plans, batch) == jrunner._resolve_auto_grad_accum(
            jcfg, jplans, batch
        ), batch
    if specs == DEEP:
        # the middle layer's float32 t is 6.2 GiB at batch 2048, 1.6 GiB at
        # 512 (the TPU's bf16 t fits at 1024, where the JAX docs pick 2)
        assert saved_t_capped_layers(cfg, plans, 2048) == [1]
        assert resolve_auto_grad_accum(cfg, plans, 2048) == 4
        assert saved_t_capped_layers(cfg, plans, 8192) == [1, 2]


# ---------------------------------------------------------------------------
# the bench entry with the new options


def test_bench_runs_the_deep_step_options_on_cpu(capsys):
    """The bench with a learning rate, the composition regularizer and
    ``--grad-accum-steps``: a count, and ``auto`` (1 for this model and
    batch: nothing is capped)."""
    recs = []
    for accum in (2, "auto"):
        recs += bench.run(device="cpu", steps=1, warmup=1, batch_size=8, epses_specs=THREE,
                          synthetic_sizes=(32, 4, 4), lr=1e-3, reg_type="epses_composition",
                          reg_coeff=0.1, grad_accum_steps=accum, compare_plain=accum == 2)
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert lines == recs
    assert [(r["path"], r["grad_accum_steps"]) for r in recs] == [("kernel", 2), ("plain", 2), ("kernel", 1)]
    for r in recs:
        assert (r["lr"], r["reg_type"], r["reg_coeff"]) == (1e-3, "epses_composition", 0.1)
        assert r["epses_specs"] == [list(s) for s in THREE]
        assert np.isfinite([r["first_loss"], r["last_loss"]]).all()
        assert r["launches_per_step"]["eps_dviews_recompute"] == 0.0  # the CPU runs no kernel
    assert recs[0]["first_loss"] == pytest.approx(recs[2]["first_loss"], rel=1e-5)
    with pytest.raises(click.UsageError, match="divides the batch size"):
        bench.run(device="cpu", steps=1, batch_size=8, epses_specs=THREE,
                  synthetic_sizes=(32, 4, 4), grad_accum_steps=3)
    with pytest.raises(click.UsageError, match="--reg-type"):
        bench.run(device="cpu", steps=1, batch_size=8, epses_specs=THREE,
                  synthetic_sizes=(32, 4, 4), reg_type="nosuchreg")
