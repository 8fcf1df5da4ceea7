"""The port's bf16 QAT step (``qat="int8"`` with ``compute_dtype`` bf16)
against the JAX package's, on the CPU.

In the JAX bf16 QAT step the int8 forward (K9, ``_fwd_q8_kernel_factory``
with ``save_t``) quantizes the float32 cmt and stores its dequantized t in
the operand dtype (``_q8train_fwd``, eps_pallas_q8.py:293-297); the backward
reads that bf16 t with the bf16-rounded core (``_q8train_bwd``, :317-330).
The JAX side runs in interpret mode on ``pallas_interpret``; the port's CPU
tensors run the plain versions. Inputs are made with numpy.

Tolerances, as in ``tests/test_torch_port_bf16.py``: rtol 1e-5 (with atol
1e-6 of the largest entry) where both sides sum the same operands in other
orders; one bf16 step (2^-8 of an entry) for a tensor stored in bf16, the
saved t (JAX's in-kernel su is ``x × f32(1/127)``, the port's a true
division: a t a last bit apart in float32 may round to neighbouring bf16
values); end to end only the logits and a short-sum model (the three-EPS
one), whose gradients hold at rtol 1e-5, atol 1e-5 of the largest (read:
4e-7 at most over seeds 0-3; the float32 QAT gradients are 3e-3 away). The
layer test feeds both backward passes JAX's t.

The module defines its rank job at the top level and imports no JAX at
import, so that its rank processes never load it.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dctn_tpu_torch.interop import params_from_numpy
from dctn_tpu_torch.kernels import eps_kernels as K
from dctn_tpu_torch.kernels import eps_q8_kernels as Q8
from dctn_tpu_torch.models import (
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    eps_plus_linear_forward_fast,
    fast_layer_plans,
)
from dctn_tpu_torch.parallel import make_parallel_fast_train_step
from dctn_tpu_torch.parallel.mesh import Host, Job
from dctn_tpu_torch.train import make_fast_train_step, make_optimizer
from torch_port_rank_pool import RankPool

BF = torch.bfloat16
RTOL = 1e-5
BF16_STEP = 2.0**-8
FLAGSHIP = ((4, 4), (3, 6))
THREE = ((2, 4), (2, 6), (2, 12))
# the three-EPS model's gradients on unit features are 10-50 times its
# parameters' largest entries: at 1e-4 each step moves them by about 1%
LR = 1e-4
RANKS = 2
TIMEOUT_S = 120
# (n, q, n1, O) after the pair merge: the flagship's layer 1 (A = 1024, B2
# = 256), a staged sum (B2 = 6) and n2 = 0 (out = t)
K9_SHAPES = [(9, 4, 5, 6), (3, 6, 2, 5), (3, 3, 3, 5)]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _model_setup(specs, seed=0, image_size=8, batch=8):
    """(numpy params, x, y): the theoretical init drawn with numpy (each
    core randn·Q^(-n/2), the classifier's w randn·in^(-1/2)/4, b
    U(±in^(-1/2))) and features of unit second moment, on which every
    layer's output stays O(1)."""
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=image_size, q0=2)
    rng = np.random.default_rng(seed)
    n_in = cfg.linear_in_features
    params = {
        "epses": tuple((rng.standard_normal(p["core_shape"])
                        * p["q"] ** (-(len(p["core_shape"]) - 1) / 2)).astype(np.float32)
                       for p in fast_layer_plans(cfg)),
        "linear": {"w": (rng.standard_normal((n_in, 10)) * n_in**-0.5 / 4).astype(np.float32),
                   "b": (rng.uniform(-1, 1, 10) * n_in**-0.5).astype(np.float32)},
    }
    x = (rng.uniform(size=(1, batch, image_size, image_size, 2)) * np.sqrt(3.0)).astype(np.float32)
    return params, x, np.arange(batch) % 10


def _cfg(specs, bf16=True, image_size=8):
    return EPSesPlusLinearConfig(epses_specs=specs, image_size=image_size, q0=2,
                                 compute_dtype=BF if bf16 else None)


def _jcfg(specs, image_size=8):
    import jax.numpy as jnp

    from dctn_tpu import models as jm

    return jm.EPSesPlusLinearConfig(
        epses_specs=specs, image_size=image_size, q0=2, compute_dtype=jnp.bfloat16,
        train_backend="pallas_interpret", eval_backend="pallas_interpret")


def _k9_inputs(n, q, n1, o, npix=256, seed=0):
    rng = np.random.default_rng(seed + 10 * n + q)
    views = rng.uniform(size=(n, q, npix)).astype(np.float32)
    cmt = (rng.normal(size=(o * q ** (n - n1), q**n1)) * q ** (-n / 2)).astype(np.float32)
    return views, cmt


# ---------------------------------------------------------------------------
# K9 with a bf16 t


@pytest.mark.parametrize("n,q,n1,o", K9_SHAPES)
def test_k9_plain_bf16_t_matches_jax_interpret(n, q, n1, o):
    """The plain K9 with ``t_dtype`` bf16 against JAX's
    ``_run_fwd_q8(save_t=True, t_dtype=bfloat16)`` in interpret mode on
    the same int8 core (JAX's ``quantize_cmt``, bit-equal to the port's):
    out at rtol 1e-6 (the float32 K9's bound), t within one bf16 step."""
    import jax.numpy as jnp

    from dctn_tpu.pallas import eps_pallas_q8 as jq

    views, cmt = _k9_inputs(n, q, n1, o)
    jwq, jsw = jq.quantize_cmt(jnp.asarray(cmt))
    want_out, want_t = jq._run_fwd_q8(jnp.asarray(views), jwq, jsw, n1, o, 128, True,
                                      save_t=True, t_dtype=jnp.bfloat16)
    assert want_t.dtype == jnp.bfloat16
    wq, sw = Q8.quantize_cmt(torch.tensor(cmt))
    assert np.array_equal(wq.numpy(), np.asarray(jwq)) and np.array_equal(sw.numpy(), jsw)
    out, t = Q8.eps_fwd_q8(torch.tensor(views), wq, sw, n1, o, save_t=True, t_dtype=BF)
    assert t.dtype == BF and out.dtype == torch.float32
    want_out = np.asarray(want_out)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=1e-6,
                               atol=1e-6 * np.abs(want_out).max())
    want_t = np.asarray(want_t.astype(jnp.float32))
    assert np.all(np.abs(t.float().numpy() - want_t) <= BF16_STEP * np.abs(want_t))


@pytest.mark.parametrize("n,q,n1,o", K9_SHAPES)
def test_plain_bf16_t_is_the_f32_t_rounded(n, q, n1, o):
    """``eps_fwd_q8_reference``'s bf16 t is its float32 t rounded to
    nearest even, bit for bit, and out is unchanged (summed from the
    float32 t): what the card's K9 is held to (``chip_smoke.py``)."""
    views, cmt = _k9_inputs(n, q, n1, o, npix=300, seed=1)
    views, (wq, sw) = torch.tensor(views), Q8.quantize_cmt(torch.tensor(cmt))
    out32, t32 = Q8.eps_fwd_q8_reference(views, wq, sw, n1, o, save_t=True)
    out16, t16 = Q8.eps_fwd_q8_reference(views, wq, sw, n1, o, save_t=True, t_dtype=BF)
    assert t32.dtype == torch.float32 and t16.dtype == BF
    assert torch.equal(t16, t32.to(BF)) and not torch.equal(t16.float(), t32)
    assert torch.equal(out16, out32)
    with pytest.raises(ValueError, match="bfloat16"):
        Q8.eps_fwd_q8(views, wq, sw, n1, o, save_t=True, t_dtype=torch.float16)


# ---------------------------------------------------------------------------
# the QAT layer and step


@pytest.mark.parametrize("layer,saves", [(1, True), (0, False)], ids=["saved_t", "first"])
def test_qat_bf16_layer_matches_jax_vjp(layer, saves):
    """One bf16 QAT layer (``EPSApplyTCmt`` with ``QAT_PLAIN`` and
    ``mm_dtype`` bf16) against ``jax.vjp`` of
    ``eps_pallas_apply_t_cmt_q8train`` with ``mm_dtype`` bf16 in interpret
    mode, at the flagship's layer shapes on an 8×8 image, batch 16. Layer 1
    saves its t in bf16 (the same arm on both sides, decided at 2 bytes an
    entry); the port's t is within one bf16 step of JAX's, and both
    backward passes are fed JAX's t. Forward rtol 1e-6, gradients rtol
    1e-5, each with atol 1e-6 of the largest entry."""
    import jax
    import jax.numpy as jnp

    from dctn_tpu.pallas import eps_pallas as jp
    from dctn_tpu.pallas import eps_pallas_q8 as jq

    p = fast_layer_plans(_cfg(FLAGSHIP))[layer]
    c, q, k, o = p["c"], p["q"], p["kernel_size"], p["out_size"]
    h = 8 if layer == 0 else 5
    npix = 16 * (h - k + 1) ** 2
    rng = np.random.default_rng(20 + layer)
    xT = rng.uniform(size=(c, q, h, h, 16)).astype(np.float32)
    n = k * k * c
    core = (rng.normal(size=(q,) * n + (o,)) * q ** (-n / 2)).astype(np.float32)
    n1, bn, merge, mm = jp.plan_pallas_call(c, q, k, p["n1"], o, npix, jnp.bfloat16, True)
    assert jnp.dtype(mm) == jnp.bfloat16
    n_k, q_k, n1_k = jp._kernel_dims(c, q, k, n1, merge)
    save = jq.qat_save_decision(c, q, k, p["n1"], o, npix, jnp.bfloat16, True, layer == 0)
    assert save == saves == (K.plan_backward(layer, n_k, n1_k, q_k, o, npix, 2) == "saved_t")
    bn_q8 = jq.plan_q8_train_bn(n_k, n1_k, q_k, o, max(128, -(-npix // 128) * 128), save, 2)
    cmt = np.asarray(jp._core_to_cmt_k(jnp.asarray(core), n1_k, q_k))
    # the custom_vjp's halves, so that the test can read the saved t
    out_j, res = jq._q8train_fwd(jnp.asarray(cmt), jnp.asarray(xT), o, k, n1, bn, bn_q8, True,
                                 mm, merge, layer == 0, save)
    t_j = res[-1]
    g = rng.normal(size=out_j.shape).astype(np.float32)
    d_cmt_j, d_xT_j = jq._q8train_bwd(o, k, n1, bn, bn_q8, True, mm, merge, layer == 0, save,
                                      res, jnp.asarray(g))

    seen = []

    def fwd(views, cmt_, n1_, out_size, save_t=False, t_dtype=None):
        seen.append((cmt_.dtype, t_dtype, save_t))
        got = Q8.QAT_PLAIN.fwd(views, cmt_, n1_, out_size, save_t, t_dtype)
        if not save_t:
            return got
        out_, t_ = got
        want_t = np.asarray(t_j.astype(jnp.float32))[:, :t_.shape[1]]
        assert t_.dtype == BF
        assert np.all(np.abs(t_.float().numpy() - want_t) <= BF16_STEP * np.abs(want_t))
        return out_, torch.tensor(want_t).to(BF)  # JAX's t for both backward passes

    kernels = K.EPSKernels(fwd, K.eps_dcore_reference, K.eps_dviews_t_reference,
                           K.eps_dviews_recompute_reference, quantizes=True)
    cmt_t = torch.tensor(cmt, requires_grad=True)
    xT_t = torch.tensor(xT, requires_grad=True)
    out = K.eps_apply_t_cmt(cmt_t, xT_t, o, k, n1, merge, layer_index=layer, kernels=kernels,
                            mm_dtype=BF)
    d_cmt, d_xT = torch.autograd.grad(out, (cmt_t, xT_t), torch.tensor(g))
    # the forward quantized the float32 cmt and stored t in bf16 where it saved one
    assert seen == [(torch.float32, BF, saves)]
    out_j = np.asarray(out_j)
    np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=1e-6,
                               atol=1e-6 * np.abs(out_j).max())
    for got, want in ((d_cmt, d_cmt_j), (d_xT, d_xT_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6 * np.abs(want).max())


def test_qat_bf16_step_matches_jax(monkeypatch):
    """2 SGD steps (lr 1e-4, epswise 1e-3) of ``make_fast_train_step(qat=
    "int8")`` in bf16 against the JAX package's fast step with
    ``qat="int8"`` and ``compute_dtype`` bf16 on ``pallas_interpret``: the
    three-EPS model on unit features, its layers 1 and 2 moved onto the
    saved-t arm (A = 16 and 36 under a threshold of 1 on both sides), so
    that K9 stores a bf16 t there. The losses at rtol 2e-5, every
    parameter's move at rtol 1e-5, atol 1e-5 of its largest entry; the
    float32 QAT step's moves miss that bound (the negative control)."""
    import jax
    import jax.numpy as jnp

    from dctn_tpu.models import eps_plus_linear as jmodel
    from dctn_tpu.train import make_optimizer as jax_make_optimizer
    from dctn_tpu.train.step import make_fast_train_step as jax_make_fast_train_step

    monkeypatch.setenv("DCTN_TPU_SAVE_T_MIN_A", "1")
    monkeypatch.setattr(K, "SAVE_T_MIN_A", 1)
    params, x, y = _model_setup(THREE)
    jcfg = _jcfg(THREE)
    jfast, jplans = jmodel.fast_params_from_reference(
        jax.tree_util.tree_map(jnp.asarray, params), jcfg)
    jopt = jax_make_optimizer("sgd", LR)
    jstep = jax_make_fast_train_step(jcfg, jopt, jplans, "epswise", 1e-3, donate=False,
                                     qat="int8")
    f, o = jfast, jopt.init(jfast)
    jlosses = []
    for i in range(2):
        f, o, m = jstep(f, o, jax.random.PRNGKey(5 + i), jnp.asarray(x), jnp.asarray(y))
        jlosses.append(float(m["loss"]))
    want = [np.asarray(a - b) for a, b in zip(
        list(f["epses_cmt"]) + [f["linear"]["w"], f["linear"]["b"]],
        list(jfast["epses_cmt"]) + [jfast["linear"]["w"], jfast["linear"]["b"]])]

    moves, t_dtypes = {}, []

    def spy(views, cmt, n1, out_size, save_t=False, t_dtype=None):
        if save_t:
            t_dtypes.append(t_dtype)
        return Q8.QAT_PLAIN.fwd(views, cmt, n1, out_size, save_t, t_dtype)

    for bf16 in (True, False):
        model = EPSesPlusLinear.from_reference(params_from_numpy(params), _cfg(THREE, bf16))
        leaves = list(model.cmts) + [model.linear_w, model.linear_b]
        start = [p.detach().clone() for p in leaves]
        kernels = K.EPSKernels(spy, *(getattr(Q8.QAT_PLAIN, f_) for f_ in (
            "dcore", "dviews_t", "dviews_recompute")), quantizes=True)
        step = make_fast_train_step(model, make_optimizer("sgd", model.parameters(), LR),
                                    "epswise", 1e-3, kernels=kernels)
        losses = [float(step(torch.tensor(x), torch.tensor(y))["loss"]) for _ in range(2)]
        if bf16:
            np.testing.assert_allclose(losses, jlosses, rtol=2e-5)
        moves[bf16] = [(p.detach() - s).numpy() for p, s in zip(leaves, start)]
    assert t_dtypes == [BF, BF] * 2 + [torch.float32, torch.float32] * 2
    names = [f"cmt {i}" for i in range(3)] + ["w", "b"]
    for name, got, got32, w in zip(names, moves[True], moves[False], want):
        scale = np.abs(w).max()
        np.testing.assert_allclose(got, w, rtol=RTOL, atol=RTOL * scale, err_msg=name)
        if name.startswith("cmt"):
            assert np.abs(got32 - w).max() > 10 * RTOL * scale, name


def _qat_logits(params, x, bf16, kernels=Q8.QAT_PLAIN):
    model = EPSesPlusLinear.from_reference(params_from_numpy(params), _cfg(FLAGSHIP, bf16))
    xt = torch.tensor(x)
    with torch.no_grad():
        return eps_plus_linear_forward_fast(model.fast_params(), xt, model.cfg, model.plans,
                                            kernels=kernels)


def test_qat_bf16_forward_equals_the_f32_qat_forward():
    """The bf16 QAT forward quantizes the float32 cores, so its logits are
    the float32 QAT forward's bit for bit (the int8 serving numerics); its
    gradient is the bf16 backward's."""
    params, x, y = _model_setup(FLAGSHIP, seed=1)
    assert torch.equal(_qat_logits(params, x, True), _qat_logits(params, x, False))
    model = EPSesPlusLinear.from_reference(params_from_numpy(params), _cfg(FLAGSHIP))
    F.cross_entropy(model(torch.tensor(x), kernels=Q8.QAT_PLAIN), torch.tensor(y)).backward()
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in model.parameters())


def test_quantizing_the_rounded_core_breaks_the_equality():
    """The negative control: a bundle that quantizes the core it is handed,
    without ``quantizes`` (so ``EPSApplyTCmt`` hands it the bf16-rounded
    cmt), gives other per-row scales and int8 entries, and logits that are
    not the float32 QAT forward's."""
    params, x, _ = _model_setup(FLAGSHIP, seed=1)
    rounded = K.EPSKernels(Q8.QAT_PLAIN.fwd, Q8.QAT_PLAIN.dcore, Q8.QAT_PLAIN.dviews_t,
                           Q8.QAT_PLAIN.dviews_recompute)
    assert not torch.equal(_qat_logits(params, x, True, rounded), _qat_logits(params, x, False))
    cmt = EPSesPlusLinear.from_reference(params_from_numpy(params), _cfg(FLAGSHIP)).cmts[1]
    (wq, sw), (wq_r, sw_r) = Q8.quantize_cmt(cmt.detach()), Q8.quantize_cmt(cmt.detach().to(BF))
    assert not torch.equal(sw, sw_r) and not torch.equal(wq, wq_r)


# ---------------------------------------------------------------------------
# the runner

RUN = dict(ds_type="fashionmnist", ds_path="synthetic", epses_specs=((2, 4), (2, 6)),
           batch_size=16, optimizer_name="sgd", lr=1e-3, synthetic_sizes=(64, 32, 32),
           eval_schedule=((None, 2),), max_num_iters=4, keep_last_models=1,
           init_epses_composition_unit_theoretical_output_std=True, device="cpu")


def test_runner_trains_qat_in_bf16_and_exports_int8_in_float32(tmp_path):
    """``--qat int8 --compute-dtype bfloat16`` on one device: 4 iterations
    of the bf16 QAT step, its parameters float32 and finite, the log says
    QAT is on; ``--export-artifact --export-quantize int8`` after it writes
    an int8 artifact in float32 (runner.py:1763-1768), whose logits are the
    float32 QAT forward's of the final parameters (the int8 forward is the
    same in both modes, up to the serving forward's own rounding, held at
    1e-6 of the largest)."""
    from dctn_tpu_torch.cli import export
    from dctn_tpu_torch.cli import runner as trunner
    from dctn_tpu_torch.data import load_dataset

    art = str(tmp_path / "int8.zip")
    state = trunner.run(experiments_dir=str(tmp_path / "exp"), compute_dtype="bfloat16",
                        qat="int8", export_artifact=art, export_batch_sizes="8",
                        export_quantize="int8", **RUN)
    assert state.num_iters_done == 4 and state.extras["cfg"].compute_dtype == BF
    final = state.extras["params_view"](state.params)
    assert all(c.dtype == torch.float32 and torch.isfinite(c).all() for c in final["epses"])
    with open(os.path.join(state.extras["output_dir"], "log.log")) as f:
        assert "QAT int8 active" in f.read()
    meta, fns = export.load_artifact(art)
    assert (meta["compute_dtype"], meta["quantize"]) == ("float32", "int8")
    cfg = EPSesPlusLinearConfig(epses_specs=RUN["epses_specs"], image_size=28, q0=2)
    model = EPSesPlusLinear.from_reference(final, cfg)
    x = torch.tensor(load_dataset("fashionmnist", "synthetic", autoscale_kernel_size=2,
                                  synthetic_sizes=(64, 32, 32)).test.x[:, :8])
    with torch.inference_mode():
        got, want = fns[8](x), model(x, kernels=Q8.QAT_PLAIN)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_bench_times_the_bf16_qat_step_on_cpu(capsys):
    """``bench.run(qat="int8", compute_dtype=bf16)``: the QAT step in the
    bf16 mode, kernel and plain paths from the same parameters."""
    from dctn_tpu_torch import bench

    recs = bench.run(device="cpu", steps=2, warmup=1, batch_size=8, compare_plain=True,
                     epses_specs=((3, 3), (2, 4)), synthetic_sizes=(32, 4, 4), qat="int8",
                     compute_dtype=BF)
    assert [(r["path"], r["qat"], r["compute_dtype"]) for r in recs] == [
        ("kernel", "int8", "bfloat16"), ("plain", "int8", "bfloat16")]
    assert np.isfinite([r["first_loss"] for r in recs]).all()
    assert recs[0]["first_loss"] == pytest.approx(recs[1]["first_loss"], rel=1e-6)
    assert "eps_fwd_q8_t_bf16" in recs[0]["launches_per_step"]


def test_autotune_measures_the_bf16_qat_step(monkeypatch):
    """The QAT objective keeps JAX's name, ``train-int8``, under a bf16
    compute dtype, and measures and prices the bf16 QAT step: each
    candidate runs with ``mm_dtype`` bf16, the split cost's backward at the
    bf16 rate with t at 2 bytes, and the check of a split takes the bf16
    backward's plans."""
    from dctn_tpu_torch.train import autotune as at

    seen = []

    def measure(*args, quantize=None, mm_dtype=None, **kw):
        seen.append((quantize, mm_dtype))
        return 1.0

    monkeypatch.setattr(at, "_measure_candidate", measure)
    cfg = _cfg(FLAGSHIP, image_size=12)
    _, report = at.autotune_splits(cfg, 4, device="cpu", quantize="int8")
    assert seen and set(seen) == {("int8", BF)} and len(report) == 2
    assert at.objective_name(False, "int8", BF) == "train-int8"
    args = (1, 4, 3, 5, 6, 128 * 529, 1, "train-int8")  # flagship layer 1 at 128: saved t
    cost16, cost32 = at.hopper_split_cost(*args, compute_dtype=BF), at.hopper_split_cost(*args)
    assert cost16 < cost32
    assert at.kernels_take_split(*args, compute_dtype=BF)
    assert at.kernels_take_split(*args)


# ---------------------------------------------------------------------------
# data parallelism


def job_dp_qat_bf16(mesh, params, x, y, min_a):
    """One rank's DP bf16 QAT step (2 SGD steps) on its half of the batch;
    rank 0 returns the parameters."""
    K.SAVE_T_MIN_A = min_a
    model = EPSesPlusLinear.from_reference(params_from_numpy(params), _cfg(THREE))
    step = make_parallel_fast_train_step(model, make_optimizer("sgd", model.parameters(), LR),
                                         mesh, "epswise", 1e-3, qat="int8")
    b = y.shape[0] // mesh.world_size
    sl = slice(mesh.rank * b, (mesh.rank + 1) * b)
    losses = [float(step(torch.as_tensor(x[:, sl]), torch.as_tensor(y[sl]))["loss"])
              for _ in range(2)]
    return losses, [p.detach().numpy().copy() for p in model.parameters()]


@pytest.fixture(scope="module")
def pool():
    p = RankPool(Job(RANKS, RANKS, Host(), "cpu", threads=1))
    yield p
    p.close()


def test_dp_qat_bf16_is_the_single_device_step(pool, monkeypatch):
    """The DP bf16 QAT step on 2 gloo ranks (4 images each, layers 1-2 on
    the saved-t arm, decided on the global pixel count) against one device
    on the 8 images: the losses at rtol 1e-5 and each parameter's move at
    rtol 1e-5, atol 1e-5 of its largest entry (the two sum the
    cross-entropy's gradient over other partitions of the pixels)."""
    monkeypatch.setattr(K, "SAVE_T_MIN_A", 1)
    params, x, y = _model_setup(THREE, seed=2)
    losses, got = pool.run(job_dp_qat_bf16, params, x, y, 1, timeout=TIMEOUT_S)
    model = EPSesPlusLinear.from_reference(params_from_numpy(params), _cfg(THREE))
    start = [p.detach().clone() for p in model.parameters()]
    step = make_fast_train_step(model, make_optimizer("sgd", model.parameters(), LR), "epswise",
                                1e-3, qat="int8")
    want_losses = [float(step(torch.tensor(x), torch.tensor(y))["loss"]) for _ in range(2)]
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL)
    for g, p, s in zip(got, model.parameters(), start):
        move, want = g - s.numpy(), (p.detach() - s).numpy()
        np.testing.assert_allclose(move, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_the_module_imports_no_jax_at_import():
    """The rank processes import this module to find their job."""
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, %r); import test_torch_port_bf16_qat\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'dctn_tpu')]" % here)
    subprocess.run([sys.executable, "-c", code], cwd=os.path.dirname(here), check=True,
                   timeout=120)
