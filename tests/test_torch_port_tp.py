"""The port's tensor parallelism (``dctn_tpu_torch.parallel.tensor_parallel``)
on the CPU: ``gloo`` ranks of one module-wide rank pool of four, on
``(data, model)`` grids of 2 and 4 ranks, against the JAX package's own
``make_tp_*`` on the conftest's virtual CPU mesh, from the same numpy
weights and batch (the JAX tests' sizes: ``(2,3),(2,4)`` or, where every
core is sharded, ``(2,4),(2,4)``, on 6×6 images, batch 8); and the runner
with ``--model-devices 2`` beside one device.

The rank processes run the jobs below, which this module defines at its
top level; the module imports no JAX at import (the JAX package is
imported inside the tests), so the ranks never load it.

Tolerances, each a share of the largest value compared:
- ``F64_TOL`` 1e-10: float64 on both sides (the reference layout, xla):
  the same products summed over other partitions (the model shards' partial
  logits, the data ranks' mean); readings ≤ 1e-14;
- ``F32_TOL`` rtol 2e-5, atol 1e-7: the fast layout in float32 against
  JAX's ``pallas_interpret`` (f32 and QAT), the bound of
  ``tests/test_torch_port_q8.py::test_qat_step_matches_jax_pallas_interpret``
  (float32 sums in other orders; int8 steps at this seed identical);
- ``MOVE_TOL`` 5e-5 of the largest move, the runner against one device's
  run (float32 steps in other summation orders, the bound of
  ``tests/test_torch_port_dp_runner.py``); a resume from a train state
  bit for bit.
"""

import os
import re

import click
import numpy as np
import pytest
import torch

from dctn_tpu_torch.cli import runner as trunner
from dctn_tpu_torch.cli.specs import fill_defaults
from dctn_tpu_torch.interop import params_from_numpy
from dctn_tpu_torch.kernels import eps_kernels as K
from dctn_tpu_torch.models import EPSesPlusLinearConfig
from dctn_tpu_torch.models.eps_plus_linear import fast_params_from_reference
from dctn_tpu_torch.parallel import (
    TPFastModel,
    TPModel,
    check_model_axis,
    make_grid,
    make_tp_fast_forward,
    make_tp_fast_params,
    make_tp_fast_score_fn,
    make_tp_fast_train_step,
    make_tp_forward,
    make_tp_params,
    make_tp_score_fn,
    make_tp_train_step,
    merge_tp_fast_params,
    merge_tp_params,
    shard_split,
    tp_reference_params,
)
from dctn_tpu_torch.parallel.mesh import Host, Job
from dctn_tpu_torch.train import load_params_npz, make_optimizer
from torch_port_bf16_problem import LR as BF16_LR
from torch_port_bf16_problem import check_moves, one_device_f32, unit_problem
from torch_port_rank_pool import RankPool

F64_TOL = 1e-10
F32_RTOL, F32_ATOL = 2e-5, 1e-7
MOVE_TOL = 5e-5
RANKS = 4
SPECS = ((2, 3), (2, 4))
SPECS_ALL = ((2, 4), (2, 4))
LR, REG = 0.05, 1e-3
STEPS = 2
TIMEOUT_S = 180
# the saved-t threshold on A; the bf16 QAT cases lower it to 1 on both sides
# so that K9 stores a bf16 t at these small layers
SAVE_T_MIN_A = K.SAVE_T_MIN_A


# ---------------------------------------------------------------------------
# the jobs the ranks run: fn(mesh, *args), top-level so that they pickle


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_np(v) for v in tree]
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def job_tp(mesh, grid, params, x, y, o):
    """The TP model of ``o`` on a ``grid`` = (n_data, n_model) of the pool's
    ranks: its forward on the batch, ``STEPS`` SGD steps on this rank's data
    shard (``o["masks"]``: each step's dropout masks per microbatch), its
    score; rank 0 returns them with the merged reference params."""
    g = make_grid(mesh, "model", *grid)
    if g is None:
        return None
    cfg = EPSesPlusLinearConfig(epses_specs=o["specs"], image_size=x.shape[2], q0=x.shape[-1],
                                dropout_p=o.get("dropout_p", 1.0),
                                compute_dtype=torch.bfloat16 if o.get("bf16") else None)
    K.SAVE_T_MIN_A = o.get("min_a", SAVE_T_MIN_A)
    params = params_from_numpy(params)
    qat, shard_all = o.get("qat"), o.get("shard_all", False)
    kw = dict(frozen_eps_indices=o.get("frozen", ()), with_probs=o.get("with_probs", False),
              grad_accum_steps=o.get("accum", 1))
    if o["fast"]:
        fast, plans = fast_params_from_reference(params, cfg)
        model = TPFastModel(make_tp_fast_params(fast, cfg, g), plans, cfg, g)
        opt = make_optimizer("sgd", model.parameters(), o.get("lr", LR))
        step = make_tp_fast_train_step(model, opt, o["reg_type"], REG, qat=qat, **kw)
        forward = make_tp_fast_forward(cfg, plans, g, qat)
        score = make_tp_fast_score_fn(cfg, plans, g, 3, qat)
        now = model.fast_params3
        round_trip = merge_tp_fast_params(now(), cfg, g)
        round_trip = {"epses": round_trip["epses_cmt"], "linear": round_trip["linear"]}
        start = fast
    else:
        backend = o.get("backend", "xla")
        model = TPModel(make_tp_params(params, cfg, g, shard_all), cfg, g, shard_all)
        opt = make_optimizer("sgd", model.parameters(), o.get("lr", LR))
        step = make_tp_train_step(model, opt, o["reg_type"], REG, backend=backend, **kw)
        forward = make_tp_forward(cfg, g, shard_all, backend)
        score = make_tp_score_fn(cfg, g, 3, shard_all, backend)
        now = model.params3
        round_trip = merge_tp_params(now(), cfg, g, shard_all)
        start = params
    key = "epses_cmt" if o["fast"] else "epses"
    exact = all(torch.equal(a, b_) for a, b_ in zip(
        list(round_trip["epses"]) + [round_trip["linear"]["w"]],
        list(start[key]) + [start["linear"]["w"]]))
    b = y.shape[0] // g.n_data
    sl = slice(g.data_index * b, (g.data_index + 1) * b)
    xs, ys = torch.as_tensor(x[:, sl]), torch.as_tensor(y[sl])
    logits = g.gather_data(forward(now(), xs))
    metrics = []
    for i in range(STEPS):
        masks = o.get("masks")
        m = step(xs, ys, masks=None if masks is None else [
            tuple(torch.as_tensor(t) for t in mb) for mb in masks[i]])
        metrics.append({k: _np(v) for k, v in m.items()})
    got_score = [float(v) for v in score(now(), shard_split(g, x, y))]
    merged = tp_reference_params(model)
    if g.rank != 0:
        return None
    return {"logits": _np(logits), "metrics": metrics, "score": got_score, "params": _np(merged),
            "round_trip_exact": exact}


def job_runner(mesh, grid, kw):
    """One rank of the EPS runner on a ``grid`` of the pool's ranks, as
    ``run`` starts it (``grid`` None: one device, rank 0 alone)."""
    kw = fill_defaults(trunner.main, dict(kw))
    trunner._validate(kw)
    if grid is None:
        if mesh.rank != 0:
            return None
        state = trunner._run(kw, mesh.device, None)
        view = state.extras["params_view"](state.params)
        return {"params": _np(view), "iters": state.num_iters_done,
                "output_dir": state.extras["output_dir"]}
    g = make_grid(mesh, "model", *grid)
    if g is None:
        return None
    out = trunner._run_rank(g, kw)
    return {"params": _np(out["params"]), "iters": out["num_iters_done"],
            "output_dir": out["output_dir"]}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(Job(RANKS, RANKS, Host(), "cpu", threads=1))
    yield p
    p.close()


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the JAX side


def _problem(specs, dtype=np.float64, dropout_p=1.0, backend="xla", compute_dtype=None):
    """The JAX config, its params (JAX's init) and the numpy copies, and a
    batch."""
    import jax

    from dctn_tpu.models import EPSesPlusLinearConfig as JCfg
    from dctn_tpu.models import init_eps_plus_linear

    jcfg = JCfg(epses_specs=specs, image_size=6, q0=2, dtype=dtype, dropout_p=dropout_p,
                train_backend=backend, eval_backend=backend, compute_dtype=compute_dtype)
    jparams = jax.tree_util.tree_map(lambda a: a.astype(dtype),
                                     init_eps_plus_linear(jax.random.PRNGKey(0), jcfg))
    x = np.random.default_rng(1).uniform(size=(1, 8, 6, 6, 2)).astype(dtype)
    y = np.arange(8) % 10
    return jcfg, jparams, jax.tree_util.tree_map(np.asarray, jparams), x, y


def _rngs():
    import jax

    return [jax.random.PRNGKey(10 + i) for i in range(STEPS)]


def _jax_masks(shapes, p, accum):
    """Each step's dropout masks per microbatch, as the JAX steps draw them:
    ``split(rng, n_cores)`` (through ``grad_accum_scan``'s ``split(rng,
    steps)`` first when accumulating), Bernoulli(p) over each whole core."""
    import jax

    out = []
    for rng in _rngs():
        mbs = [rng] if accum == 1 else list(jax.random.split(rng, accum))
        out.append([tuple(np.asarray(jax.random.bernoulli(k, p, s))
                          for k, s in zip(jax.random.split(r, len(shapes)), shapes))
                     for r in mbs])
    return out


def _jax_tp(jcfg, jparams, x, y, grid, reg_type, fast=False, shard_all=False, qat=None,
            frozen=(), accum=1, with_probs=False, lr=LR):
    """The JAX package's TP forward, STEPS SGD steps and score on a
    ``make_tp_mesh(*grid)``; the merged reference params."""
    import jax
    import jax.numpy as jnp

    from dctn_tpu.models.eps_plus_linear import (
        fast_params_from_reference as jfast_from_ref,
        reference_params_from_fast as jref_from_fast,
    )
    from dctn_tpu.parallel import tensor_parallel as jtp
    from dctn_tpu.train import make_optimizer as jopt_of

    mesh = jtp.make_tp_mesh(*grid)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    opt = jopt_of("sgd", lr)
    kw = dict(frozen_eps_indices=frozen, grad_accum_steps=accum, with_probs=with_probs)
    if fast:
        f, plans = jfast_from_ref(jparams, jcfg)
        p3 = jtp.make_tp_fast_params(f, jcfg, mesh)
        step = jtp.make_tp_fast_train_step(jcfg, opt, plans, mesh, reg_type, REG, qat=qat, **kw)
        score = jtp.make_tp_fast_score_fn(jcfg, plans, mesh, 3, qat=qat)
        logits = None
    else:
        p3 = jtp.make_tp_params(jparams, jcfg, mesh, shard_all)
        step = jtp.make_tp_train_step(jcfg, opt, mesh, reg_type, REG, shard_all=shard_all, **kw)
        score = jtp.make_tp_score_fn(jcfg, mesh, 3, p3, shard_all)
        logits = np.asarray(jtp.make_tp_forward(jcfg, mesh, p3, shard_all)(p3, xj))
    state = jax.jit(opt.init)(p3)
    metrics = []
    for rng in _rngs():
        p3, state, m = step(p3, state, rng, xj, yj)
        metrics.append(jax.tree_util.tree_map(np.asarray, m))
    sc = [float(v) for v in score(p3, xj, yj)]
    if fast:
        merged = jref_from_fast(jtp.merge_tp_fast_params(p3, jcfg), jcfg, plans)
    else:
        merged = jtp.merge_tp_params(p3, jcfg)
    return logits, metrics, sc, jax.tree_util.tree_map(np.asarray, merged)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _close(got, want, tol=None, what=""):
    """Every leaf within ``tol`` of its largest magnitude (float64), or
    within F32_RTOL/F32_ATOL (float32 with ``tol`` None)."""
    for i, (a, b) in enumerate(zip(_leaves(got), _leaves(want), strict=True)):
        if tol is None:
            np.testing.assert_allclose(a, b, rtol=F32_RTOL, atol=F32_ATOL, err_msg=f"{what} {i}")
        else:
            scale = max(float(np.abs(b).max()), 1e-300)
            assert float(np.abs(a - b).max()) <= tol * scale, (what, i, np.abs(a - b).max())


def _compare(got, jax_out, tol=F64_TOL, probs=False):
    logits, metrics, score, params = jax_out
    if logits is not None:
        _close(got["logits"], logits, tol, "logits")
    for m, jm in zip(got["metrics"], metrics):
        for k in ("loss", "ce", "reg_term") + (("probs_of_true_class",) if probs else ()):
            _close(m[k], jm[k], tol, k)
    _close(got["score"], score, tol, "score")
    _close(got["params"], params, tol, "params")
    assert got["round_trip_exact"]


# ---------------------------------------------------------------------------
# the steps against the JAX package's


@pytest.mark.parametrize("shard_all", [False, True], ids=["last", "shard_all"])
@pytest.mark.parametrize("reg_type", ["epswise", "epses_composition"])
def test_tp_forward_step_and_score_match_jax(pool, reg_type, shard_all):
    """On a (2 data, 2 model) grid of 4 ranks: the forward's logits, 2 SGD
    steps of the reference layout (the regularizer's local form, the
    per-leaf reductions) and the sharded score match JAX's
    ``make_tp_forward`` / ``make_tp_train_step`` / ``make_tp_score_fn``;
    the shards merge back to the params they came from, bit for bit."""
    specs = SPECS_ALL if shard_all else SPECS
    jcfg, jparams, params, x, y = _problem(specs)
    got = pool.run(job_tp, (2, 2), params, x, y,
                   {"specs": specs, "fast": False, "shard_all": shard_all,
                    "reg_type": reg_type}, timeout=TIMEOUT_S)
    _compare(got, _jax_tp(jcfg, jparams, x, y, (2, 2), reg_type, shard_all=shard_all))


@pytest.mark.parametrize("grid", [(1, 2), (1, 4)], ids=["2ranks", "4ranks"])
def test_tp_shard_all_on_a_model_axis_of_2_and_4(pool, grid):
    """Every core sharded 2 and 4 ways (a grid of 2 ranks, then of 4), the
    composition regularizer gathering the early cores, against JAX."""
    jcfg, jparams, params, x, y = _problem(SPECS_ALL)
    got = pool.run(job_tp, grid, params, x, y,
                   {"specs": SPECS_ALL, "fast": False, "shard_all": True,
                    "reg_type": "epses_composition"}, timeout=TIMEOUT_S)
    _compare(got, _jax_tp(jcfg, jparams, x, y, grid, "epses_composition", shard_all=True))


def test_tp_shard_all_on_the_kernel_route_matches_jax(pool):
    """``--tp-shard-all`` with the pallas backend: every layer through
    ``ops.eps``'s kernel route (the cmt of the local core, ``eps_apply_t_cmt``;
    their plain versions on the CPU) gives JAX's xla step: the split is
    exact."""
    jcfg, jparams, params, x, y = _problem(SPECS_ALL)
    got = pool.run(job_tp, (2, 2), params, x, y,
                   {"specs": SPECS_ALL, "fast": False, "shard_all": True, "backend": "pallas",
                    "reg_type": "epswise"}, timeout=TIMEOUT_S)
    _compare(got, _jax_tp(jcfg, jparams, x, y, (2, 2), "epswise", shard_all=True))


@pytest.mark.parametrize("shard_all", [False, True], ids=["last", "shard_all"])
def test_tp_dropout_accumulation_frozen_and_probs_match_jax(pool, shard_all):
    """Dropout at p = 0.7 with JAX's masks (each drawn over the whole core,
    the shards taking their O range: the one realization), 2 accumulation
    microbatches, core 0 frozen, and the probabilities of the true class
    gathered over ``data``, against JAX's TP step with the same options."""
    specs = SPECS_ALL if shard_all else SPECS
    jcfg, jparams, params, x, y = _problem(specs, dropout_p=0.7)
    masks = _jax_masks([c.shape for c in params["epses"]], 0.7, 2)
    got = pool.run(job_tp, (2, 2), params, x, y,
                   {"specs": specs, "fast": False, "shard_all": shard_all, "dropout_p": 0.7,
                    "reg_type": "epswise", "masks": masks, "accum": 2, "frozen": (0,),
                    "with_probs": True}, timeout=TIMEOUT_S)
    want = _jax_tp(jcfg, jparams, x, y, (2, 2), "epswise", shard_all=shard_all, frozen=(0,),
                   accum=2, with_probs=True)
    _compare(got, want, probs=True)
    np.testing.assert_array_equal(got["params"]["epses"][0], params["epses"][0])


@pytest.mark.parametrize("qat,reg_type,dropout_p", [
    (None, "epses_composition", 0.8), ("int8", "epswise", 1.0)], ids=["f32", "qat_int8"])
def test_tp_fast_layout_matches_jax_interpret(pool, qat, reg_type, dropout_p):
    """The fast (cmt) layout, last core's row block on each model rank, in
    float32 against JAX's ``make_tp_fast_*`` on ``pallas_interpret``: f32
    with dropout and the composition regularizer (the gathered last cmt),
    and QAT (K8/K9's forward, the saved-t arm on the whole O and batch)."""
    import jax

    jcfg, jparams, params, x, y = _problem(SPECS, np.float32, dropout_p, "pallas_interpret")
    masks = None if dropout_p == 1.0 else _jax_masks([c.shape for c in params["epses"]],
                                                     dropout_p, 1)
    got = pool.run(job_tp, (2, 2), params, x, y,
                   {"specs": SPECS, "fast": True, "qat": qat, "dropout_p": dropout_p,
                    "reg_type": reg_type, "masks": masks}, timeout=TIMEOUT_S)
    want = _jax_tp(jcfg, jparams, x, y, (2, 2), reg_type, fast=True, qat=qat)
    _compare(got, want, tol=None)
    # the forward against JAX's one-device fast forward
    from dctn_tpu.models.eps_plus_linear import (
        eps_plus_linear_forward_fast,
        fast_params_from_reference as jfast_from_ref,
    )
    from dctn_tpu.pallas.eps_pallas_q8 import forward_fast_q8train

    f, plans = jfast_from_ref(jparams, jcfg)
    if qat is None:
        ref = eps_plus_linear_forward_fast(f, jax.numpy.asarray(x), jcfg, plans, training=False)
    else:
        ref = forward_fast_q8train(f, jax.numpy.asarray(x), jcfg, plans, training=False)
    np.testing.assert_allclose(got["logits"], np.asarray(ref), rtol=F32_RTOL, atol=1e-6)


@pytest.mark.parametrize("kind", ["last_xla", "fast", "qat"])
def test_tp_bf16_matches_jax(pool, monkeypatch, kind):
    """``compute_dtype`` bf16 on a (2 data, 2 model) grid against JAX's
    ``make_tp_*`` with ``compute_dtype`` bf16, in float32, on the problem
    of ``torch_port_bf16_problem``: the reference layout (the last core
    sharded, xla), the fast layout and QAT on ``pallas_interpret`` (the
    QAT layers on the saved-t arm, the threshold on A set to 1 on both
    sides: K9 stores a bf16 t). The forward, 2 SGD steps and the score at
    the float32 bound (F32_RTOL, F32_ATOL: these short sums land no bf16
    operand a step apart), and the logits against JAX's one-device bf16
    forward; each parameter's move within MOVE_RTOL of JAX's, which JAX's
    the port's float32 run on one device misses (the mode is on)."""
    fast = kind != "last_xla"
    qat = "int8" if kind == "qat" else None
    backend = "pallas_interpret" if fast else "xla"
    if qat:
        monkeypatch.setenv("DCTN_TPU_SAVE_T_MIN_A", "1")
    jcfg, jparams, params, x, y = unit_problem(SPECS, backend=backend)
    got = pool.run(job_tp, (2, 2), params, x, y,
                   {"specs": SPECS, "fast": fast, "qat": qat, "bf16": True, "lr": BF16_LR,
                    "min_a": 1 if qat else SAVE_T_MIN_A, "reg_type": "epswise"},
                   timeout=TIMEOUT_S)
    np.testing.assert_allclose(got["logits"], _jax_tp_logits(jcfg, jparams, x, fast, qat),
                               rtol=F32_RTOL, atol=1e-6)
    want = _jax_tp(jcfg, jparams, x, y, (2, 2), "epswise", fast=fast, qat=qat, lr=BF16_LR)
    want32 = one_device_f32(params, SPECS, x, y, kind, "epswise", REG, BF16_LR, STEPS)
    _compare(got, want, tol=None)
    check_moves(params, got["params"], want[3], want32)


def _jax_tp_logits(jcfg, jparams, x, fast, qat):
    """JAX's one-device forward of ``jcfg``: fast (QAT's with ``qat``) or
    the reference layout."""
    import jax.numpy as jnp

    from dctn_tpu.models.eps_plus_linear import (
        eps_plus_linear_forward,
        eps_plus_linear_forward_fast,
        fast_params_from_reference as jfast_from_ref,
    )
    from dctn_tpu.pallas.eps_pallas_q8 import forward_fast_q8train

    if not fast:
        return np.asarray(eps_plus_linear_forward(jparams, jnp.asarray(x), jcfg))
    f, plans = jfast_from_ref(jparams, jcfg)
    run = eps_plus_linear_forward_fast if qat is None else forward_fast_q8train
    return np.asarray(run(f, jnp.asarray(x), jcfg, plans, training=False))


def test_tp_refuses_a_model_axis_that_does_not_divide_o(tmp_path):
    """``make_tp_params``' check (tensor_parallel.py:88-92), and the runner's
    refusals before any rank starts: a model axis that does not divide the
    sharded O, QAT with ``--tp-shard-all`` (runner.py:569-574), and with a
    space axis beside it (SP x TP) a model axis that does not divide the
    last O."""
    cfg = EPSesPlusLinearConfig(epses_specs=SPECS, image_size=6)
    check_model_axis(cfg, 2)  # the last O, 4
    with pytest.raises(ValueError, match="output dim 3 not divisible by model axis 2"):
        check_model_axis(cfg, 2, shard_all=True)
    base = dict(QUICK, experiments_dir=str(tmp_path), max_num_iters=1)
    for kw, match in (
        ({"model_devices": 3}, "output dim 4 not divisible by model axis 3"),
        ({"model_devices": 2, "tp_shard_all": True, "qat": "int8"}, "--qat int8 with --tp-shard"),
        ({"model_devices": 3, "space_devices": 2}, "output dim 4 not divisible by model axis 3"),
        ({"model_devices": 2, "device": "cuda"}, "CUDA"),
    ):
        with pytest.raises(click.BadParameter, match=match):
            trunner.run(**{**base, **kw})
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# the runner

QUICK = dict(ds_type="fashionmnist", ds_path="synthetic", epses_specs=SPECS_ALL, batch_size=16,
             optimizer_name="adam", lr=3e-3, wd=0.1, reg_coeff=1e-4, synthetic_sizes=(64, 32, 32),
             eval_schedule=((None, 2),), keep_last_models=1, patience=100,
             init_epses_composition_unit_theoretical_output_std=True, device="cpu")


def _last_ckpt(out_dir):
    names = sorted(f for f in os.listdir(out_dir) if re.match(r"model_nitd=\d+_", f))
    return load_params_npz(os.path.join(out_dir, names[-1]))


def _moves(init, got, want, what):
    for i, (s, a, b) in enumerate(zip(_leaves(init), _leaves(got), _leaves(want), strict=True)):
        ma, mb = a.astype(np.float64) - s, b.astype(np.float64) - s
        scale = float(np.abs(mb).max())
        assert scale > 1e-5, f"{what}: leaf {i} did not move"
        np.testing.assert_allclose(ma, mb, rtol=0, atol=MOVE_TOL * scale, err_msg=f"{what} {i}")


@pytest.fixture(scope="module")
def one_device(pool, tmp_path_factory):
    """The runner on one device: 4 Adam iterations (wd 0.1, epswise 1e-4)
    from the theoretical init, the starting params from its first
    checkpoint."""
    tmp = tmp_path_factory.mktemp("one")
    out = pool.run(job_runner, None, dict(QUICK, experiments_dir=str(tmp), max_num_iters=4,
                                          reg_type="epswise", keep_last_models=3),
                   timeout=TIMEOUT_S)
    names = sorted(f for f in os.listdir(out["output_dir"]) if f.startswith("model_nitd="))
    out["init"] = load_params_npz(os.path.join(out["output_dir"], names[0]))
    return out


@pytest.mark.parametrize("extra,grid", [
    ({"model_devices": 2}, (1, 2)),
    ({"model_devices": 2, "tp_shard_all": True}, (1, 2)),
    ({"model_devices": 2, "mesh_devices": 2}, (2, 2)),
], ids=["model2", "model2_shard_all", "data2_model2"])
def test_runner_tp_beside_one_device(pool, one_device, tmp_path, extra, grid):
    """``--model-devices 2`` (the fast layout; with ``--tp-shard-all`` the
    reference layout through the kernels' route; with ``--mesh-devices 2``
    a (2, 2) grid) from the same seed: the one-device batch stream, each
    rank its data shard; its last checkpoint, written by rank 0 in the
    reference layout, moves within MOVE_TOL of one device's; the log names
    the grid."""
    out = pool.run(job_runner, grid, dict(QUICK, experiments_dir=str(tmp_path), max_num_iters=4,
                                          reg_type="epswise", **extra), timeout=TIMEOUT_S)
    assert out["iters"] == 4
    ckpt = _last_ckpt(out["output_dir"])
    _moves(one_device["init"], ckpt, one_device["params"], str(extra))
    _moves(one_device["init"], out["params"], one_device["params"], str(extra))
    with open(os.path.join(out["output_dir"], "log.log")) as f:
        assert re.search(rf"tensor parallelism: grid \(data={grid[0]}, model=2\)", f.read())


# the bf16 runner on the TP grid against one device in bf16, the L2 gap of
# each parameter's move over 4 SGD iterations relative to one device's
# move: with every core sharded the same operands are rounded (read 1.6e-5);
# with the last core alone sharded each model rank rounds kr2 = g·v of its
# partial cotangent of the replicated layers before the sum over ``model``,
# where one device rounds the whole one, as JAX's TP step does too
# (test_tp_bf16_matches_jax holds the step to JAX's at 1e-5): read 1.6e-3,
# against 4e-3 to 1e-2 for the float32 run
BF16_RUNNER_L2 = {"model2_qat": 3e-3, "model2_shard_all": 1e-4}


@pytest.mark.parametrize("extra", [
    {"model_devices": 2, "qat": "int8"}, {"model_devices": 2, "tp_shard_all": True},
], ids=["model2_qat", "model2_shard_all"])
def test_runner_tp_bf16_beside_one_device(pool, tmp_path, request, extra):
    """``--compute-dtype bfloat16 --model-devices 2``, with ``--qat int8``
    (K9's bf16 t under the threshold the runner keeps) and with
    ``--tp-shard-all``, from the same seed as one device's bf16 run with
    the same options (SGD 1e-3, 4 iterations): each parameter's move
    within BF16_RUNNER_L2 of one device's in L2; the parameters stay
    float32 and the log names the grid."""
    kw = dict(QUICK, max_num_iters=4, reg_type="epswise", compute_dtype="bfloat16",
              optimizer_name="sgd", lr=1e-3, wd=0.0, keep_last_models=5)
    one_kw = {k: v for k, v in extra.items() if k == "qat"}
    one = pool.run(job_runner, None, dict(kw, experiments_dir=str(tmp_path / "one"), **one_kw),
                   timeout=TIMEOUT_S)
    out = pool.run(job_runner, (1, 2), dict(kw, experiments_dir=str(tmp_path / "tp"), **extra),
                   timeout=TIMEOUT_S)
    assert out["iters"] == 4
    names = sorted(f for f in os.listdir(one["output_dir"]) if f.startswith("model_nitd="))
    init = load_params_npz(os.path.join(one["output_dir"], names[0]))
    bound = BF16_RUNNER_L2[request.node.callspec.id]
    for i, (s0, a, b) in enumerate(zip(_leaves(init), _leaves(out["params"]),
                                       _leaves(one["params"]), strict=True)):
        assert a.dtype == np.float32
        mb = b.astype(np.float64) - s0
        gap = float(np.linalg.norm(a.astype(np.float64) - s0 - mb) / np.linalg.norm(mb))
        assert gap <= bound, (i, gap)
    with open(os.path.join(out["output_dir"], "log.log")) as f:
        assert re.search(r"tensor parallelism: grid \(data=1, model=2\)", f.read())


def test_runner_tp_resumes_bit_equal_and_loads_one_device_states(pool, tmp_path):
    """A TP run's train state (the model group's shards gathered, the layout
    one device writes) at iteration 2, resumed on the same grid to 4,
    equals the unbroken run bit for bit; the same file resumes on one
    device; a reference-layout state is refused under TP (no layout
    conversion, runner.py:1319-1330)."""
    kw = dict(QUICK, model_devices=2, mesh_devices=2, reg_type="epses_composition")
    whole = pool.run(job_runner, (2, 2), dict(kw, experiments_dir=str(tmp_path / "a"),
                                              max_num_iters=4), timeout=TIMEOUT_S)
    half = pool.run(job_runner, (2, 2), dict(kw, experiments_dir=str(tmp_path / "b"),
                                             max_num_iters=2), timeout=TIMEOUT_S)
    state = os.path.join(half["output_dir"], "train_state_latest.npz")
    resumed = pool.run(job_runner, (2, 2), dict(kw, experiments_dir=str(tmp_path / "c"),
                                                max_num_iters=4, resume_from=state),
                       timeout=TIMEOUT_S)
    for a, b in zip(_leaves(resumed["params"]), _leaves(whole["params"]), strict=True):
        np.testing.assert_array_equal(a, b)
    one = pool.run(job_runner, None, dict(QUICK, reg_type="epses_composition",
                                          experiments_dir=str(tmp_path / "d"), max_num_iters=4,
                                          resume_from=state), timeout=TIMEOUT_S)
    _moves(load_params_npz(os.path.join(half["output_dir"], sorted(
        f for f in os.listdir(half["output_dir"]) if f.startswith("model_nitd="))[-1])),
        one["params"], whole["params"], "one device from the TP state")
    ref_state = pool.run(job_runner, (1, 2), dict(
        kw, mesh_devices=1, train_backend="xla", eval_backend="xla",
        experiments_dir=str(tmp_path / "e"), max_num_iters=2), timeout=TIMEOUT_S)
    with pytest.raises(RuntimeError, match="converts no layout"):
        pool.run(job_runner, (1, 2), dict(kw, mesh_devices=1, experiments_dir=str(tmp_path / "f"),
                                          max_num_iters=4, resume_from=os.path.join(
                                              ref_state["output_dir"],
                                              "train_state_latest.npz")), timeout=TIMEOUT_S)
