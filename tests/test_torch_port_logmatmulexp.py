"""The port's log-space matrix product (ops forms, K13's host side and plain
version), the log-space classifier and their bench entries, against the
JAX package on the CPU.

Inputs are made with numpy and cross to both packages as numpy arrays.
Tolerances: float64 against float64, rtol 1e-10 (the same arithmetic, sums
in other orders; the JAX package holds its own forms to each other at
1e-10 to 1e-12, tests/test_logmatmulexp.py). K13's plain version in float32
against the JAX kernel in interpret mode at the limits the JAX package sets
for that kernel (tests/test_logmatmulexp_pallas.py): forward against the
float64 oracle at rtol 2e-5, gradients at rtol 2e-4 with atol 1e-6, large
magnitudes at rtol 1e-4. The CUDA kernel itself is held against the plain
version on the card (``test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import functools
import importlib.util
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from click.testing import CliRunner

from dctn_tpu.ops import logmatmulexp as jlme
from dctn_tpu.pallas.logmatmulexp_pallas import logmatmulexp_pallas
from dctn_tpu_torch import bench
from dctn_tpu_torch.data import io as data_io
from dctn_tpu_torch.kernels import logmatmulexp_kernels as L
from dctn_tpu_torch.models import log_space_classifier as LSC
from dctn_tpu_torch.ops import logmatmulexp as tlme
from dctn_tpu_torch.train import make_optimizer

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), rtol=rtol, atol=atol, err_msg=what,
    )


def _pair(theta, r, i, scale=3.0, offsets=(0.0, 0.0), seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    la = rng.standard_normal((theta, r)) * scale + offsets[0]
    lb = rng.standard_normal((r, i)) * scale + offsets[1]
    return la.astype(dtype), lb.astype(dtype)


def _oracle(la, lb):
    return np.log(np.exp(la.astype(np.float64)) @ np.exp(lb.astype(np.float64)))


def _sin_grads(fn, la, lb):
    """Gradients of sum(sin(fn(a, b))) in both, on torch tensors."""
    a, b = (torch.from_numpy(t).requires_grad_(True) for t in (la, lb))
    return torch.autograd.grad(torch.sin(fn(a, b)).sum(), (a, b))


# ---------------------------------------------------------------------------
# the ops forms, float64


TORCH_FORMS = {
    "logmatmulexp": tlme.logmatmulexp,
    "logmatmulexp_lowmem": tlme.logmatmulexp_lowmem,
    "logmatmulexp_reference": tlme.logmatmulexp_reference,
    "logmatmulexp_kernel": L.logmatmulexp_kernel,
}


@pytest.mark.parametrize("form", sorted(TORCH_FORMS))
def test_forms_match_jax_and_the_oracle_f64(form):
    la, lb = _pair(8, 16, 5)
    want = jlme.logmatmulexp(jnp.asarray(la), jnp.asarray(lb))
    got = TORCH_FORMS[form](torch.from_numpy(la), torch.from_numpy(lb))
    assert got.dtype == torch.float64 and got.shape == (8, 5)
    _close(got, want, 1e-10)
    _close(got, _oracle(la, lb), 1e-10)


def test_result_dtype_follows_promote_types():
    la, lb = _pair(3, 4, 2)
    got = tlme.logmatmulexp(torch.from_numpy(la.astype(np.float32)), torch.from_numpy(lb))
    assert got.dtype == torch.promote_types(torch.float32, torch.float64) == torch.float64


@pytest.mark.parametrize("form", ["logmatmulexp", "logmatmulexp_lowmem", "logmatmulexp_kernel"])
def test_extreme_values_stable_f64(form):
    """Entries around ±700 overflow a naive exp in float64; the max-shift
    forms stay finite and equal the JAX package's logsumexp oracle."""
    la, lb = _pair(4, 8, 3, scale=10.0, offsets=(700.0, -700.0))
    got = TORCH_FORMS[form](torch.from_numpy(la), torch.from_numpy(lb))
    assert bool(torch.isfinite(got).all())
    _close(got, jlme.logmatmulexp_reference(jnp.asarray(la), jnp.asarray(lb)), 1e-10)


@functools.lru_cache(maxsize=None)
def _jax_sin_grads_f64():
    la, lb = _pair(5, 7, 4, scale=1.0)
    grads = jax.jit(jax.grad(
        lambda a, b: jnp.sum(jnp.sin(jlme.logmatmulexp(a, b))), argnums=(0, 1)
    ))(jnp.asarray(la), jnp.asarray(lb))
    return la, lb, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("form", sorted(TORCH_FORMS))
def test_gradients_match_jax_f64(form):
    la, lb, want = _jax_sin_grads_f64()
    got = _sin_grads(TORCH_FORMS[form], la, lb)
    for g, w in zip(got, want):
        _close(g, w, 1e-10)


def test_lowmem_gradient_equals_plain():
    """The checkpointed form recomputes the same arithmetic: the same bits."""
    la, lb, _ = _jax_sin_grads_f64()
    for g, w in zip(_sin_grads(tlme.logmatmulexp_lowmem, la, lb),
                    _sin_grads(tlme.logmatmulexp, la, lb)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("form", sorted(TORCH_FORMS))
def test_neg_inf_rows_and_columns(form):
    """−inf entries are zero probabilities: a row of A or a column of B
    that is all −inf gives −inf outputs, never NaN (tests/test_logmatmulexp.py's
    2×2 case, and a random one with −inf rows, columns and entries)."""
    inf = math.inf
    la = np.array([[0.0, -inf], [-inf, 0.0]])
    got = TORCH_FORMS[form](torch.from_numpy(la), torch.from_numpy(la.copy()))
    _close(got, np.array([[0.0, -inf], [-inf, 0.0]]), 0.0)
    la, lb = _pair(6, 9, 5)
    la[2] = -inf
    lb[:, 3] = -inf
    la[0, :4] = -inf
    lb[5:, 1] = -inf
    got = TORCH_FORMS[form](torch.from_numpy(la), torch.from_numpy(lb))
    assert not bool(torch.isnan(got).any())
    assert bool((got[2] == -inf).all()) and bool((got[:, 3] == -inf).all())
    _close(got, jlme.logmatmulexp(jnp.asarray(la), jnp.asarray(lb)), 1e-10)


def test_kernel_gradient_guards_neg_inf_outputs_like_jax():
    """The kernel's backward takes dS = 0 where S = 0 (an all −inf row or
    column), as the JAX kernel's ``_bwd`` does: finite gradients, equal to
    the interpret-mode JAX kernel's in float32 (gradient of sum(exp(out)))."""
    la, lb = _pair(6, 9, 5, dtype=np.float32)
    la[2] = -math.inf
    lb[:, 3] = -math.inf
    want = jax.jit(jax.grad(
        lambda a, b: jnp.sum(jnp.exp(logmatmulexp_pallas(a, b, True))), argnums=(0, 1)
    ))(jnp.asarray(la), jnp.asarray(lb))
    a, b = (torch.from_numpy(t).requires_grad_(True) for t in (la, lb))
    got = torch.autograd.grad(torch.exp(L.logmatmulexp_kernel(a, b)).sum(), (a, b))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        _close(g, w, 2e-4, 1e-6)


# ---------------------------------------------------------------------------
# K13's plain version (the CPU arm of logmatmulexp_kernel), float32, against
# the interpret-mode JAX kernel


@functools.lru_cache(maxsize=None)
def _pallas(theta, r, i, scale=3.0, offsets=(0.0, 0.0)):
    """Inputs in float32 and the JAX kernel's output and gradients of
    sum(sin(out)), one compile per shape."""
    la, lb = _pair(theta, r, i, scale, offsets, dtype=np.float32)
    out, vjp = jax.vjp(lambda a, b: logmatmulexp_pallas(a, b, True), jnp.asarray(la),
                       jnp.asarray(lb))
    grads = vjp(jnp.cos(out))
    return la, lb, np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("shape", [(128, 256, 128), (256, 256, 256), (100, 60, 37)])
def test_kernel_plain_version_forward_matches_pallas_and_the_oracle(shape):
    la, lb, want, _ = _pallas(*shape)
    got = L.logmatmulexp_kernel(torch.from_numpy(la), torch.from_numpy(lb))
    assert got.dtype == torch.float32 and got.shape == shape[::2]
    _close(got, _oracle(la, lb), 2e-5)
    _close(got, want, 2e-5)


def test_kernel_plain_version_gradient_matches_pallas_and_the_reference():
    la, lb, _, want = _pallas(64, 128, 64, scale=1.0)
    got = _sin_grads(L.logmatmulexp_kernel, la, lb)
    ref = _sin_grads(tlme.logmatmulexp_reference, la, lb)
    for g, w, r in zip(got, want, ref):
        _close(g, w, 2e-4, 1e-6)
        _close(g, r, 2e-4, 1e-6)


def test_kernel_plain_version_large_magnitudes_stable():
    la, lb, want, _ = _pallas(32, 128, 32, scale=10.0, offsets=(80.0, -80.0))
    got = L.logmatmulexp_kernel(torch.from_numpy(la), torch.from_numpy(lb))
    assert bool(torch.isfinite(got).all())
    ref = tlme.logmatmulexp_reference(torch.from_numpy(la).double(), torch.from_numpy(lb).double())
    _close(got, ref, 1e-4)
    _close(got, want, 1e-4)


def test_wrapper_runs_the_plain_version_on_cpu_and_counts_no_launch():
    la, lb = _pair(7, 11, 5, dtype=np.float32)
    a, b = torch.from_numpy(la), torch.from_numpy(lb)
    amax, bmax = tlme.max_shifts(a, b)
    before = L.logmatmulexp_fwd.launches
    got = L.logmatmulexp_fwd(a, b, amax, bmax)
    assert L.logmatmulexp_fwd.launches == before
    assert torch.equal(got, L.logmatmulexp_fwd_reference(a, b, amax, bmax))
    assert torch.equal(L.logmatmulexp_kernel(a, b, L.PLAIN), got)


def test_split_plan_reaches_the_sms_with_whole_chunks():
    """R is split into parts of at least two 32-wide chunks until the grid
    has about two CTAs per SM; the entries' shapes split 4 (256³), 2 (the
    classifier's step) and 17 (R = 32768) ways."""
    assert L._splits(256, 256, 256) == 4
    assert L._splits(256, 98, 490) == 2
    assert L._splits(256, 32768, 256) == 17
    assert L._splits(100, 60, 37) == 1
    assert L._splits(4096, 4096, 4096) == 1


# ---------------------------------------------------------------------------
# the log-space classifier against the experiment's own functions


@functools.lru_cache(maxsize=None)
def _experiment():
    """experiments/log_space_classifier.py, loaded by its path (not edited)."""
    spec = importlib.util.spec_from_file_location(
        "log_space_classifier_experiment", REPO / "experiments" / "log_space_classifier.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _classifier_inputs(n=16, seed=0):
    x, y = data_io.synthetic_mnist_like(n, seed=1234)
    w = np.random.default_rng(seed).uniform(0.3, 1.0, size=(49, 10, 2))
    return x.astype(np.float64), y, np.log(w)


def test_features_match_the_experiment_f64():
    x, _, _ = _classifier_inputs()
    _close(LSC.features(torch.from_numpy(x)), _experiment().features(jnp.asarray(x)), 1e-10)


@pytest.mark.parametrize("form", ["scan", "fused"])
def test_log_joint_matches_the_experiment_f64(form):
    exp = _experiment()
    x, _, log_w = _classifier_inputs()
    lf = np.array(exp.features(jnp.asarray(x)))
    if form == "scan":
        want = exp.log_joint(jnp.asarray(log_w), jnp.asarray(lf))
        gots = [LSC.log_joint(torch.from_numpy(log_w), torch.from_numpy(lf))]
    else:
        want = exp.log_joint_fused(jnp.asarray(log_w), jnp.asarray(lf), jlme.logmatmulexp)
        gots = [LSC.log_joint_fused(torch.from_numpy(log_w), torch.from_numpy(lf), lme)
                for lme in (tlme.logmatmulexp, L.logmatmulexp_kernel)]
    for got in gots:
        assert got.shape == (16, 10)
        _close(got, want, 1e-10)


def test_block_diagonal_layout_and_gradient():
    """Entry (p·2 + q, p·10 + c) is log_w[p, c, q], −inf elsewhere, and the
    gradient reaches exactly the placed entries."""
    _, _, log_w = _classifier_inputs()
    w = torch.from_numpy(log_w).requires_grad_(True)
    lb = LSC.block_diagonal(w)
    assert lb.shape == (98, 490)
    assert int(torch.isfinite(lb).sum()) == 980
    assert float(lb.detach()[2 * 7 + 1, 10 * 7 + 3]) == log_w[7, 3, 1]
    (g,) = torch.autograd.grad(torch.where(torch.isfinite(lb), lb, 0.0).sum(), w)
    assert torch.equal(g, torch.ones_like(w))


def _jax_trajectory(form, log_w, lf, y, idx):
    exp = _experiment()
    joint = ((lambda w, f: exp.log_joint(w, f)) if form == "scan"
             else (lambda w, f: exp.log_joint_fused(w, f, jlme.logmatmulexp)))
    opt = optax.adam(LSC.LR)
    w = jnp.asarray(log_w)
    state = opt.init(w)

    @jax.jit
    def step(w, s, i):
        def loss_fn(w):
            lp = jax.nn.log_softmax(joint(w, lf[i]))
            return -jnp.mean(jnp.take_along_axis(lp, y[i][:, None], axis=1))

        loss, g = jax.value_and_grad(loss_fn)(w)
        upd, s = opt.update(g, s)
        return optax.apply_updates(w, upd), s, loss

    losses = []
    for row in idx:
        w, state, loss = step(w, state, jnp.asarray(row))
        losses.append(float(loss))
    return np.asarray(w), losses


@pytest.mark.parametrize("variant", sorted(bench.LOG_SPACE_VARIANTS))
def test_adam_trajectory_matches_jax_optax_f64(variant):
    """3 Adam 3e-2 steps at batch 16 from the same weights on the same
    batches, each form of the bench against the experiment's (the fused
    forms against its ``fused_xla``)."""
    exp = _experiment()
    x, y, log_w = _classifier_inputs(n=64)
    lf = np.array(exp.features(jnp.asarray(x)))
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, 64, 16) for _ in range(3)])
    want_w, want_losses = _jax_trajectory("scan" if variant == "scan" else "fused", log_w,
                                          jnp.asarray(lf), jnp.asarray(y), idx)
    w = torch.from_numpy(log_w.copy()).requires_grad_(True)
    opt = make_optimizer("adam", [w], LSC.LR)
    lf_t, y_t = torch.from_numpy(lf), torch.from_numpy(y)
    losses = []
    for row in torch.from_numpy(idx):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(
            bench.LOG_SPACE_VARIANTS[variant](w, lf_t[row]), y_t[row])
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    _close(np.array(losses), np.array(want_losses), 1e-10)
    _close(w, want_w, 1e-10)


# ---------------------------------------------------------------------------
# the bench entries on the CPU, tiny sizes


def _json_lines(output):
    return [json.loads(line) for line in output.splitlines() if line.startswith("{")]


def test_logmatmulexp_chain_bench_runs_on_cpu():
    res = CliRunner().invoke(bench.main, ["--model-family", "logmatmulexp", "--device", "cpu",
                                          "--steps", "2"])
    assert res.exit_code == 0, res.output
    recs = _json_lines(res.output)
    assert [r["function"] for r in recs] == list(bench.CHAIN_VARIANTS)
    for r in recs:
        assert r["device"] == "cpu" and r["timer"] == "host_clock" and r["chain"] == 6
        assert r["size"] == 256
        assert r["forward_seconds_per_iteration"] > 0
        assert r["forward_backward_seconds_per_iteration"] > 0
        assert r["launches_per_forward"] == r["launches_per_forward_backward"] == 0
    assert "log-space / matmul forward" in res.output


def test_log_space_bench_runs_on_cpu():
    res = CliRunner().invoke(bench.main, ["--model-family", "log_space", "--device", "cpu",
                                          "--steps", "3", "--batch-size", "8"])
    assert res.exit_code == 0, res.output
    recs = _json_lines(res.output)
    assert [r["variant"] for r in recs] == list(bench.LOG_SPACE_VARIANTS)
    for r in recs:
        assert r["device"] == "cpu" and r["steps"] == 3 and r["batch_size"] == 8
        assert 0.0 <= r["val_acc"] <= 1.0 and math.isfinite(r["last_loss"])
        assert r["logmatmulexp_launches_per_step"] == r["logmatmulexp_launches_accuracy"] == 0
    assert max(r["val_acc"] for r in recs) - min(r["val_acc"] for r in recs) < 0.02
