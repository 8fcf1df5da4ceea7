"""The port's training step against the JAX package's, on the CPU.

Parameters come from the JAX package's init and cross as numpy arrays;
inputs are made with numpy and given to both. The JAX side runs its Pallas
kernels in interpret mode (``pallas_interpret``), as its own tests do, or
its XLA reference-layout step in float64; the port's CPU tensors run the
kernels' plain versions. The CUDA kernels themselves are held against those
plain versions on the card (``test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import json

import click
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctn_tpu import models as jm
from dctn_tpu.models import eps_plus_linear as jmodel
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
    fast_layer_plans,
    reference_params_from_fast,
)
from dctn_tpu_torch.train import make_fast_train_step, make_gather_batch, make_optimizer

FLAGSHIP = ((4, 4), (3, 6))


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once; torch's default
    of one thread per core in each would starve the others (the JAX
    package's virtual 8-device mesh aborts when a collective waits too
    long for one of its devices)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _setup(specs=FLAGSHIP, image_size=8, batch=16, seed=0):
    jcfg = jm.EPSesPlusLinearConfig(
        epses_specs=specs, image_size=image_size, q0=2,
        train_backend="pallas_interpret", eval_backend="pallas_interpret",
    )
    jparams = jm.init_eps_plus_linear(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=image_size, q0=2)
    # uniform features, as tests/test_fast_layout.py feeds the JAX step: at
    # lr 0.05 the flagship stays trainable on them for the 3 steps, where on
    # ν-scaled φ-features it diverges (loss 4.3 → 1.9e19) and float32
    # trajectories part ways however right the arithmetic is
    x = np.random.default_rng(seed).uniform(size=(1, batch, image_size, image_size, 2)).astype(np.float32)
    y = np.arange(batch) % 10
    return jcfg, jparams, np_params, cfg, x, y


# ---------------------------------------------------------------------------
# the plain backward


@pytest.mark.parametrize(
    "n,q,n1,o,npix",
    [
        (4, 3, 4, 5, 7),  # n2 = 0: kr2 = g, no v half
        (4, 3, 2, 3, 9),  # n2 > 0
        (8, 4, 4, 4, 6),  # the flagship's merged first layer (q = 4 from 2)
        (9, 4, 5, 2, 5),  # the flagship's second layer, unmerged
        (5, 2, 1, 2, 6),  # n1 = 1: one u factor
        (5, 2, 4, 2, 6),  # n2 = 1: one v factor
    ],
)
def test_plain_backward_matches_autograd(n, q, n1, o, npix):
    """eps_dcore_reference and eps_dviews_t_reference (and the recompute
    arm) equal torch.autograd.grad of eps_fwd_reference, float64."""
    rng = np.random.default_rng(n * 100 + q * 10 + n1)
    views = torch.tensor(rng.uniform(size=(n, q, npix)), requires_grad=True)
    cmt = torch.tensor(rng.normal(size=(o * q ** (n - n1), q**n1)), requires_grad=True)
    g = torch.tensor(rng.normal(size=(o, npix)))
    d_views, d_cmt = torch.autograd.grad(K.eps_fwd_reference(views, cmt, n1, o), (views, cmt), g)
    with torch.no_grad():
        out, t = K.eps_fwd_reference(views, cmt, n1, o, save_t=True)
        t = t if n1 < n else None
        got_cmt = K.eps_dcore_reference(views, g, n1, o)
        got_views = K.eps_dviews_t_reference(views, cmt, g, t, n1, o)
        got_recompute = K.eps_dviews_recompute_reference(views, cmt, g, n1, o)
    np.testing.assert_allclose(got_cmt.numpy(), d_cmt.numpy(), rtol=1e-10)
    np.testing.assert_allclose(got_views.numpy(), d_views.numpy(), rtol=1e-10)
    np.testing.assert_allclose(got_recompute.numpy(), d_views.numpy(), rtol=1e-10)


def test_plain_backward_handles_zero_factors():
    """Black pixels give factors that are exactly 0: the chain backward
    takes no quotient, so their cotangents stay finite and right."""
    rng = np.random.default_rng(7)
    v = rng.uniform(size=(6, 2, 10))
    v[:, 0, ::2] = 0.0
    views = torch.tensor(v, requires_grad=True)
    cmt = torch.tensor(rng.normal(size=(2 * 8, 8)), requires_grad=True)
    g = torch.tensor(rng.normal(size=(2, 10)))
    want = torch.autograd.grad(K.eps_fwd_reference(views, cmt, 3, 2), views, g)[0]
    with torch.no_grad():
        t = K.eps_fwd_reference(views, cmt, 3, 2, save_t=True)[1]
        got = K.eps_dviews_t_reference(views, cmt, g, t, 3, 2)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-10, atol=1e-14)


# ---------------------------------------------------------------------------
# one layer against the JAX custom_vjp


@pytest.mark.parametrize(
    "layer,want_plan",
    [
        (1, "fused_t"),  # (3,6) on the 5×5 output of layer 0: saves t
        (0, None),  # (4,4) on the 8×8 input, force_two_pass: no t
    ],
)
def test_layer_value_and_grads_match_jax_vjp(layer, want_plan):
    """EPSApplyTCmt (through eps_apply_t_cmt) against jax.vjp of
    eps_pallas_apply_t_cmt in interpret mode, float32, rtol 1e-5, at the
    flagship's layer shapes on an 8×8 image, batch 16."""
    cfg = EPSesPlusLinearConfig(epses_specs=FLAGSHIP, image_size=8, q0=2)
    p = fast_layer_plans(cfg)[layer]
    c, q, k, o = p["c"], p["q"], p["kernel_size"], p["out_size"]
    h = 8 if layer == 0 else 5
    rng = np.random.default_rng(layer)
    xT = rng.uniform(size=(c, q, h, h, 16)).astype(np.float32)
    n = k * k * c
    core = (rng.normal(size=(q,) * n + (o,)) * q ** (-n / 2)).astype(np.float32)
    n1, bn, merge, mm = jp.plan_pallas_call(c, q, k, p["n1"], o, 16 * (h - k + 1) ** 2, None, True)
    assert (n1, merge) == (p["n1"], p["merge_pairs"])
    n_k, q_k, n1_k = jp._kernel_dims(c, q, k, n1, merge)
    npad = -(-16 * (h - k + 1) ** 2 // bn) * bn
    plan = jp._save_t_plan(n_k, n1_k, q_k, o, bn, mm, npad, layer == 0)
    assert (plan[0] if plan else None) == want_plan
    npix = 16 * (h - k + 1) ** 2
    want_arm = "saved_t" if want_plan else "dcore_only"
    assert K.plan_backward(layer, n_k, n1_k, q_k, o, npix) == want_arm

    cmt = np.asarray(jp._core_to_cmt_k(jnp.asarray(core), n1_k, q_k))
    out_j, vjp = jax.vjp(
        lambda c_, x_: jp.eps_pallas_apply_t_cmt(c_, x_, o, k, n1, bn, True, mm, merge, layer == 0),
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


def _spy_kernels(calls):
    def fwd(views, cmt, n1, out_size, save_t=False):
        calls.append(("fwd", save_t))
        return K.eps_fwd_reference(views, cmt, n1, out_size, save_t)

    def dcore(*args):
        calls.append(("dcore",))
        return K.eps_dcore_reference(*args)

    def dviews_t(*args):
        calls.append(("dviews_t",))
        return K.eps_dviews_t_reference(*args)

    def dviews_recompute(*args):
        calls.append(("dviews_recompute",))
        return K.eps_dviews_recompute_reference(*args)

    return K.EPSKernels(fwd, dcore, dviews_t, dviews_recompute)


def test_training_saves_t_and_serving_does_not():
    """The flagship's training forward asks for t in layer 1 only, and its
    backward runs d_cmt twice and the saved-t d_views once; under
    inference_mode the forward writes no t at all, and the wrappers count
    no launch on the CPU."""
    _, _, np_params, cfg, x, y = _setup()
    model = EPSesPlusLinear.from_reference(params_from_numpy(np_params), cfg)
    assert all(p.requires_grad for p in model.parameters())
    calls = []
    kernels = _spy_kernels(calls)
    before = bench.read_counters()
    loss = torch.nn.functional.cross_entropy(model(torch.tensor(x), kernels=kernels), torch.tensor(y))
    loss.backward()
    assert calls[:2] == [("fwd", False), ("fwd", True)]
    assert sorted(calls[2:]) == [("dcore",), ("dcore",), ("dviews_t",)]
    calls.clear()
    with torch.inference_mode():
        model(torch.tensor(x), kernels=kernels)
        model(torch.tensor(x))
    assert calls == [("fwd", False), ("fwd", False)]
    assert bench.read_counters() == before


def test_layer_recompute_arm_runs_plain_on_cpu():
    """A later layer below the saved-t threshold (A = 16) takes the
    recompute arm: no t, and the bundle's recompute member (here the plain
    version) gives the views' gradient."""
    calls = []
    xT = torch.rand((1, 4, 5, 5, 2), dtype=torch.float64, requires_grad=True)
    cmt = torch.randn((2 * 4**7, 4**2), dtype=torch.float64, requires_grad=True)
    assert K.plan_backward(1, 9, 2, 4, 2, 18) == "recompute"
    out = K.eps_apply_t_cmt(cmt, xT, 2, 3, 2, False, layer_index=1, kernels=_spy_kernels(calls))
    got = torch.autograd.grad(out.sum(), xT)[0]
    assert calls == [("fwd", False), ("dcore",), ("dviews_recompute",)]
    views, _ = K._stack_views_from_xT(xT, 3, False)
    want = torch.autograd.grad(K.eps_fwd_reference(views, cmt, 2, 2).sum(), xT)[0]
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize(
    "specs,image_size",
    [(FLAGSHIP, 28), (((3, 3), (2, 4)), 8), (((4, 4), (3, 12), (2, 24)), 28)],
)
def test_plan_backward_matches_jax(specs, image_size):
    """Layer 0 takes the d_cmt-only arm (JAX: force_two_pass), a later
    layer the saved-t arm exactly when JAX's _save_t_plan saves t."""
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=image_size, q0=2)
    h = image_size
    arms = []
    for i, p in enumerate(fast_layer_plans(cfg)):
        h = h - p["kernel_size"] + 1
        npix = 128 * h * h
        n1, bn, merge, mm = jp.plan_pallas_call(
            p["c"], p["q"], p["kernel_size"], p["n1"], p["out_size"], npix, None, True
        )
        n_k, q_k, n1_k = jp._kernel_dims(p["c"], p["q"], p["kernel_size"], n1, merge)
        npad = -(-npix // bn) * bn
        saves = jp._save_t_plan(n_k, n1_k, q_k, p["out_size"], bn, mm, npad, i == 0) is not None
        arm = K.plan_backward(i, n_k, n1_k, q_k, p["out_size"], npix)
        assert (arm == "dcore_only") == (i == 0)
        assert (arm == "saved_t") == saves, (i, n_k, n1_k, q_k)
        arms.append(arm)
    if specs == FLAGSHIP:
        assert arms == ["dcore_only", "saved_t"]


# ---------------------------------------------------------------------------
# the step


def _port_steps(np_params, cfg, x, y, lr, coeff, steps, dtype):
    model = EPSesPlusLinear.from_reference(params_from_numpy(np_params, dtype=dtype), cfg)
    opt = make_optimizer("adam", model.parameters(), lr)
    step = make_fast_train_step(model, opt, "epswise", coeff)
    xt, yt = torch.tensor(x, dtype=dtype), torch.tensor(y)
    metrics = [step(xt, yt) for _ in range(steps)]
    return model, metrics


def test_fast_step_matches_jax_pallas_interpret_f32():
    """3 Adam steps of the port's fast step against dctn_tpu's fast step on
    pallas_interpret: the flagship on an 8×8 image, batch 16, lr 0.05,
    epswise 1e-3, float32. rtol 2e-5 (atol 1e-7), the bound
    tests/test_fast_layout.py holds the JAX fast step to."""
    jcfg, jparams, np_params, cfg, x, y = _setup()
    jfast, jplans = jmodel.fast_params_from_reference(jparams, jcfg)
    jopt = jax_make_optimizer("adam", 0.05)
    jstep = jax_make_fast_train_step(jcfg, jopt, jplans, "epswise", 1e-3, donate=False)
    f, o = jfast, jopt.init(jfast)
    jmetrics = []
    for i in range(3):
        f, o, m = jstep(f, o, jax.random.PRNGKey(5 + i), jnp.asarray(x), jnp.asarray(y))
        jmetrics.append(m)
    model, metrics = _port_steps(np_params, cfg, x, y, 0.05, 1e-3, 3, torch.float32)
    assert model.plans == jplans
    for m, jm_ in zip(metrics, jmetrics):
        for key in ("loss", "ce", "reg_term"):
            np.testing.assert_allclose(float(m[key]), float(jm_[key]), rtol=2e-5)
    for got, want in zip(model.cmts, f["epses_cmt"]):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=1e-7)
    for got, want in ((model.linear_w, f["linear"]["w"]), (model.linear_b, f["linear"]["b"])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-5, atol=1e-7)


def test_fast_step_matches_jax_xla_reference_layout_f64():
    """The same 3 steps in float64 against dctn_tpu's reference-layout step
    on the xla backend, rtol 1e-10."""
    _, jparams, np_params, cfg, x, y = _setup()
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=FLAGSHIP, image_size=8, q0=2, dtype=jnp.float64)
    j64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jparams)
    jopt = jax_make_optimizer("adam", 0.05)
    jstep = jax_make_train_step(jcfg, jopt, "epswise", 1e-3, donate=False)
    p, o = j64, jopt.init(j64)
    jmetrics = []
    for i in range(3):
        p, o, m = jstep(p, o, jax.random.PRNGKey(5 + i), jnp.asarray(x, jnp.float64), jnp.asarray(y))
        jmetrics.append(m)
    model, metrics = _port_steps(np_params, cfg, x.astype(np.float64), y, 0.05, 1e-3, 3, torch.float64)
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


def test_step_leaves_the_callers_tensors_alone():
    _, _, np_params, cfg, x, y = _setup(specs=((3, 3), (2, 4)))
    params = params_from_numpy(np_params)
    w0 = params["linear"]["w"].clone()
    model = EPSesPlusLinear.from_reference(params, cfg)
    step = make_fast_train_step(model, make_optimizer("sgd", model.parameters(), 0.1), "epswise", 0.0)
    m = step(torch.tensor(x), torch.tensor(y))
    assert float(m["reg_term"]) == 0.0 and float(m["loss"]) == float(m["ce"])
    torch.testing.assert_close(params["linear"]["w"], w0, rtol=0, atol=0)
    assert not torch.equal(model.linear_w.detach(), w0)


@pytest.mark.parametrize(
    "kwargs,match",
    [
        ({"grad_accum_steps": 0}, "at least 1"),
        ({"frozen_eps_indices": (2,)}, "outside the model's 2 cores"),
        ({"qat": "int8", "kernels": K.PLAIN}, "pass qat or kernels"),
        ({"qat": "int4"}, "unsupported qat"),
        ({"reg_type": "nosuchreg"}, "unknown reg_type"),
    ],
)
def test_step_refuses_unported_options(kwargs, match):
    """What the port does not run yet is refused with a message that says
    when it comes, and so are options it cannot take (accumulation that
    does not divide the batch is refused at the step:
    tests/test_torch_port_recompute.py)."""
    specs = ((3, 3), (2, 4))
    _, _, np_params, cfg, _, _ = _setup(specs=specs)
    model = EPSesPlusLinear.from_reference(params_from_numpy(np_params), cfg)
    opt = make_optimizer("adam", model.parameters(), 1e-3)
    with pytest.raises(ValueError, match=match):
        make_fast_train_step(model, opt, **kwargs)


def test_make_optimizer_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("rmsprop", [torch.zeros(1, requires_grad=True)], 0.1)


@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adam", 0.01), ("sgd", 0.01)])
def test_optimizer_matches_optax_chain(name, wd):
    """torch's Adam/SGD with weight_decay equals the JAX package's
    add_decayed_weights → scale_by_adam (or identity) → scale(-lr), over 5
    steps of fixed gradients, float64."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(3, 4))
    grads = [rng.normal(size=(3, 4)) for _ in range(5)]
    jopt = jax_make_optimizer(name, 0.01, wd)
    jp_, state = jnp.asarray(p0), jopt.init(jnp.asarray(p0))
    for g in grads:
        upd, state = jopt.update(jnp.asarray(g), state, jp_)
        jp_ = jp_ + upd
    tp = torch.tensor(p0, requires_grad=True)
    opt = make_optimizer(name, [tp], 0.01, wd)
    for g in grads:
        tp.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp_), rtol=1e-12)


def test_gather_batch_takes_the_indexed_samples():
    x = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    y = torch.arange(5) * 10
    xb, yb = make_gather_batch(x, y)(np.array([4, 1]))
    torch.testing.assert_close(xb, x[:, [4, 1]])
    assert yb.tolist() == [40, 10]


# ---------------------------------------------------------------------------
# the bench entry


def test_bench_runs_on_cpu_and_reports_its_fields(capsys):
    recs = bench.run(device="cpu", steps=2, warmup=1, batch_size=8, compare_plain=True,
                     epses_specs=((3, 3), (2, 4)), synthetic_sizes=(32, 4, 4))
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert lines == recs and [r["path"] for r in recs] == ["kernel", "plain"]
    for r in recs:
        assert r["device"] == "cpu" and r["timer"] == "host_clock" and r["timed_steps"] == 2
        assert np.isfinite([r["first_loss"], r["last_loss"], r["images_per_s"], r["step_ms_p50"]]).all()
        assert r["f32_peak_share"] is None and r["peak_extra_mib"] is None
        assert set(r["launches_per_step"]) == {
            "eps_fwd", "eps_fwd_t", "eps_dcore", "eps_dcore_sum", "eps_dviews_t",
            "eps_dviews_recompute", "eps_fwd_q8", "eps_fwd_q8_t", "eps_fwd_bf16",
            "eps_fwd_t_bf16", "eps_fwd_chunks_bf16", "eps_dcore_bf16", "eps_dcore_chunks_bf16",
            "eps_dcore_sum_bf16", "eps_dviews_t_bf16", "eps_dviews_recompute_bf16",
            "eps_fwd_q8_t_bf16",
        }
        assert r["step_gflop"] > 0
    # both paths start from the same parameters and batch
    assert recs[0]["first_loss"] == pytest.approx(recs[1]["first_loss"], rel=1e-6)


def test_step_gflop_of_the_flagship():
    """723 GFLOP at batch 128: forward + d_cmt of both layers, d_views of
    layer 1 (layer 0's input needs no gradient)."""
    cfg = EPSesPlusLinearConfig(epses_specs=FLAGSHIP, image_size=28, q0=2)
    want = 2 * (2 * 1024 * 256 * 128 * 625) + 3 * (2 * 1536 * 1024 * 128 * 529)
    assert bench.step_gflop(cfg, 128) == pytest.approx(want / 1e9)
    assert 722 < want / 1e9 < 724


def test_bench_refuses_a_cuda_device_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(click.UsageError, match="no CUDA device"):
        bench.run(device="cuda", steps=1, batch_size=4, epses_specs=((3, 3), (2, 4)),
                  synthetic_sizes=(8, 4, 4))
