"""The port's SP×TP (``dctn_tpu_torch.parallel.sp_tp``) on the CPU: ``gloo``
ranks of one module-wide rank pool of four, on ``(data, space, model)``
grids ``(1, 2, 2)`` and ``(2, 2, 1)``, against the JAX package's own
``make_sp_tp_*`` on the conftest's virtual CPU mesh, from the same numpy
weights and batch (the JAX tests' sizes, ``tests/test_sp_tp.py:35-47``:
``(2,3),(2,4)`` on 6×6 images, batch 8); and the runner with
``--space-devices 2 --model-devices 2`` beside one device.

The rank processes run the jobs below, which this module defines at its
top level; the module imports no JAX at import (the JAX package is
imported inside the tests), so the ranks never load it.

Tolerances, each a share of the largest value compared (as in
``tests/test_torch_port_tp.py`` and ``test_torch_port_sp.py``):
- ``F64_TOL`` 1e-10: float64 on both sides (the reference layout, xla):
  the same products summed over other partitions (the plane's partial
  logits over rows and O-slices, the gradients' sums over the plane and
  over space, the data ranks' mean);
- rtol 2e-5, atol 1e-7: the fast layout in float32 against JAX's
  ``pallas_interpret`` (f32 and QAT), the bound of
  ``tests/test_torch_port_q8.py::test_qat_step_matches_jax_pallas_interpret``
  (float32 sums in other orders);
- ``MOVE_L2_TOL`` 1e-4, the runner against one device's run, each leaf's
  move in L2, for both backends: Adam steps an entry whose float32 gradient
  is near its ε by up to ±lr when the sums' order moves that gradient (the
  classifier's here summed over 2 row bands × 2 O-slices), which max|Δ|
  counts in full and L2 does not (the reason of
  ``tests/test_torch_port_sp.py``; read here: one entry of the 27,040 of
  ``linear/w`` 1.67e-6 apart, where ``test_torch_port_sp.py``'s 5e-5 of
  the largest move allows 6.0e-7); a resume from a train state bit for
  bit.
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
    make_sp_tp_fast_train_step,
    make_sp_tp_forward,
    make_sp_tp_grid,
    make_sp_tp_score_fn,
    make_sp_tp_train_step,
    make_tp_fast_params,
    make_tp_params,
    sp_shard_split,
    sp_tp_check_config,
    sp_tp_shard_batch,
    tp_reference_params,
)
from dctn_tpu_torch.parallel.mesh import Host, Job
from dctn_tpu_torch.train import load_params_npz, make_optimizer
from torch_port_bf16_problem import LR as BF16_LR
from torch_port_bf16_problem import check_moves, one_device_f32, unit_problem
from torch_port_rank_pool import RankPool

F64_TOL = 1e-10
F32_RTOL, F32_ATOL = 2e-5, 1e-7
MOVE_L2_TOL = 1e-4
RANKS = 4
SPECS = ((2, 3), (2, 4))
LR, REG = 0.05, 1e-3
STEPS = 2
TIMEOUT_S = 180
# the saved-t threshold on A; the bf16 QAT case lowers it to 1 on both sides
SAVE_T_MIN_A = K.SAVE_T_MIN_A


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_np(v) for v in tree]
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


# ---------------------------------------------------------------------------
# the jobs the ranks run: fn(mesh, *args), top-level so that they pickle


def job_sp_tp(mesh, grid, params, x, y, o):
    """The SP×TP model of ``o`` on a ``grid`` = (n_data, n_space, n_model)
    of the pool's ranks: its forward on the batch, ``STEPS`` SGD steps on
    this rank's rows of its data shard (``o["masks"]``: each step's dropout
    masks per microbatch), its score; rank 0 returns them with the merged
    reference params."""
    g = make_sp_tp_grid(mesh, *grid)
    if g is None:
        return None
    cfg = EPSesPlusLinearConfig(epses_specs=o["specs"], image_size=x.shape[2], q0=x.shape[-1],
                                dropout_p=o.get("dropout_p", 1.0),
                                compute_dtype=torch.bfloat16 if o.get("bf16") else None)
    K.SAVE_T_MIN_A = o.get("min_a", SAVE_T_MIN_A)
    params = params_from_numpy(params)
    qat = o.get("qat")
    kw = dict(frozen_eps_indices=o.get("frozen", ()), with_probs=o.get("with_probs", False),
              grad_accum_steps=o.get("accum", 1))
    if o["fast"]:
        fast, plans = fast_params_from_reference(params, cfg)
        model = TPFastModel(make_tp_fast_params(fast, cfg, g), plans, cfg, g)
        opt = make_optimizer("sgd", model.parameters(), o.get("lr", LR))
        step = make_sp_tp_fast_train_step(model, opt, o["reg_type"], REG, qat=qat, **kw)
        forward = make_sp_tp_forward(cfg, g, plans, qat)
        score = make_sp_tp_score_fn(cfg, g, 3, plans, qat)
        now = model.fast_params3
    else:
        model = TPModel(make_tp_params(params, cfg, g), cfg, g)
        opt = make_optimizer("sgd", model.parameters(), o.get("lr", LR))
        step = make_sp_tp_train_step(model, opt, o["reg_type"], REG, **kw)
        forward = make_sp_tp_forward(cfg, g)
        score = make_sp_tp_score_fn(cfg, g, 3)
        now = model.params3
    xs, ys = sp_tp_shard_batch(g, x, y)
    logits = g.gather_data(forward(now(), xs))
    metrics = []
    for i in range(STEPS):
        masks = o.get("masks")
        m = step(xs, ys, masks=None if masks is None else [
            tuple(torch.as_tensor(t) for t in mb) for mb in masks[i]])
        metrics.append({k: _np(v) for k, v in m.items()})
    got_score = [float(v) for v in score(now(), sp_shard_split(g, x, y))]
    merged = tp_reference_params(model)
    # every rank of a space line holds the same shard, bit for bit
    digest = torch.stack([p.detach().double().sum() for p in model.parameters()])
    rows = g.all_gather_cat(digest[None])
    same = all(bool((rows[g.peer("space", j)] == rows[g.rank]).all())
               for j in range(g.size("space")))
    if g.rank != 0:
        return None
    return {"logits": _np(logits), "metrics": metrics, "score": got_score, "params": _np(merged),
            "space_replicas_equal": same}


def job_runner(mesh, grid, kw):
    """One rank of the EPS runner on a ``grid`` of the pool's ranks, as
    ``run`` starts it (``grid`` None: one device, rank 0 alone)."""
    kw = fill_defaults(trunner.main, dict(kw))
    trunner._validate(kw)
    if grid is None:
        if mesh.rank != 0:
            return None
        state = trunner._run(kw, mesh.device, None)
        return {"params": _np(state.extras["params_view"](state.params)),
                "iters": state.num_iters_done, "output_dir": state.extras["output_dir"]}
    g = make_sp_tp_grid(mesh, *grid)
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


def _problem(specs=SPECS, dtype=np.float64, dropout_p=1.0, backend="xla"):
    import jax

    from dctn_tpu.models import EPSesPlusLinearConfig as JCfg
    from dctn_tpu.models import init_eps_plus_linear

    jcfg = JCfg(epses_specs=specs, image_size=6, q0=2, dtype=dtype, dropout_p=dropout_p,
                train_backend=backend, eval_backend=backend)
    jparams = jax.tree_util.tree_map(lambda a: a.astype(dtype),
                                     init_eps_plus_linear(jax.random.PRNGKey(0), jcfg))
    x = np.random.default_rng(1).uniform(size=(1, 8, 6, 6, 2)).astype(dtype)
    y = np.arange(8) % 10
    return jcfg, jparams, jax.tree_util.tree_map(np.asarray, jparams), x, y


def _rngs():
    import jax

    return [jax.random.PRNGKey(10 + i) for i in range(STEPS)]


def _jax_masks(shapes, p, accum):
    """Each step's dropout masks per microbatch, as the JAX steps draw them
    (``split(rng, n_cores)``, through ``grad_accum_scan``'s split first when
    accumulating), Bernoulli(p) over each whole core."""
    import jax

    out = []
    for rng in _rngs():
        mbs = [rng] if accum == 1 else list(jax.random.split(rng, accum))
        out.append([tuple(np.asarray(jax.random.bernoulli(k, p, s))
                          for k, s in zip(jax.random.split(r, len(shapes)), shapes))
                     for r in mbs])
    return out


def _jax_sp_tp(jcfg, jparams, x, y, grid, reg_type, fast=False, qat=None, frozen=(), accum=1,
               with_probs=False, lr=LR):
    """The JAX package's SP×TP forward, STEPS SGD steps and score on a
    ``make_sp_tp_mesh(*grid)``; the merged reference params."""
    import jax
    import jax.numpy as jnp

    from dctn_tpu.models.eps_plus_linear import (
        fast_params_from_reference as jfast_from_ref,
        reference_params_from_fast as jref_from_fast,
    )
    from dctn_tpu.parallel import sp_tp as jst
    from dctn_tpu.parallel import tensor_parallel as jtp
    from dctn_tpu.train import make_optimizer as jopt_of

    mesh = jst.make_sp_tp_mesh(*grid)
    xs, ys = jst.sp_tp_shard_batch(mesh, x, y)
    opt = jopt_of("sgd", lr)
    kw = dict(frozen_eps_indices=frozen, grad_accum_steps=accum, with_probs=with_probs)
    if fast:
        f, plans = jfast_from_ref(jparams, jcfg)
        p3 = jtp.make_tp_fast_params(f, jcfg, mesh)
        step = jst.make_sp_tp_fast_train_step(jcfg, opt, plans, mesh, reg_type, REG, qat=qat,
                                              **kw)
    else:
        p3, plans = jtp.make_tp_params(jparams, jcfg, mesh), None
        step = jst.make_sp_tp_train_step(jcfg, opt, mesh, reg_type, REG, **kw)
    logits = np.asarray(jst.make_sp_tp_forward(jcfg, mesh, p3, plans, qat=qat)(p3, xs))
    state = jax.jit(opt.init)(p3)
    metrics = []
    for rng in _rngs():
        p3, state, m = step(p3, state, rng, xs, ys)
        metrics.append(jax.tree_util.tree_map(np.asarray, m))
    score = jst.make_sp_tp_score_fn(jcfg, mesh, 3, p3, plans, qat=qat)
    sc = [float(v) for v in score(p3, jst.sp_tp_shard_batch(mesh, x), jnp.asarray(y))]
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
    for i, (a, b) in enumerate(zip(_leaves(got), _leaves(want), strict=True)):
        if tol is None:
            np.testing.assert_allclose(a, b, rtol=F32_RTOL, atol=F32_ATOL, err_msg=f"{what} {i}")
        else:
            scale = max(float(np.abs(b).max()), 1e-300)
            assert float(np.abs(a - b).max()) <= tol * scale, (what, i, np.abs(a - b).max())


def _compare(got, jax_out, tol=F64_TOL, probs=False):
    logits, metrics, score, params = jax_out
    if tol is None:
        np.testing.assert_allclose(got["logits"], logits, rtol=F32_RTOL, atol=1e-6)
    else:
        _close(got["logits"], logits, tol, "logits")
    for m, jm in zip(got["metrics"], metrics):
        for k in ("loss", "ce", "reg_term") + (("probs_of_true_class",) if probs else ()):
            _close(m[k], jm[k], tol, k)
    _close(got["score"], score, tol, "score")
    _close(got["params"], params, tol, "params")
    assert got["space_replicas_equal"]


# ---------------------------------------------------------------------------
# the steps against the JAX package's


@pytest.mark.parametrize("grid,reg_type", [
    ((1, 2, 2), "epswise"), ((1, 2, 2), "epses_composition"), ((2, 2, 1), "epses_composition"),
], ids=["plane_epswise", "plane_composition", "data2_space2"])
def test_sp_tp_forward_step_and_score_match_jax(pool, grid, reg_type):
    """The reference layout on a (1 data, 2 space, 2 model) grid with each
    regularizer (the halo's transposes, the plane's logits sum, the per-leaf
    reductions over the plane and over space, the regularizer's local form
    divided by n_space), and on (2, 2, 1) (the data mean): the forward's
    logits, 2 SGD steps and the score match JAX's ``make_sp_tp_forward`` /
    ``make_sp_tp_train_step`` / ``make_sp_tp_score_fn``; every rank of a
    space line holds the same parameters."""
    jcfg, jparams, params, x, y = _problem()
    got = pool.run(job_sp_tp, grid, params, x, y, {"specs": SPECS, "fast": False,
                                                   "reg_type": reg_type}, timeout=TIMEOUT_S)
    _compare(got, _jax_sp_tp(jcfg, jparams, x, y, grid, reg_type))


def test_sp_tp_dropout_accumulation_frozen_and_probs_match_jax(pool):
    """Dropout at p = 0.7 with JAX's masks (whole-shape draws, the last
    core's O range on each model rank: the one-device realization), 2
    accumulation microbatches, core 0 frozen and the probabilities of the
    true class, on (1, 2, 2) against JAX's SP×TP step with the same
    options."""
    jcfg, jparams, params, x, y = _problem(dropout_p=0.7)
    masks = _jax_masks([c.shape for c in params["epses"]], 0.7, 2)
    got = pool.run(job_sp_tp, (1, 2, 2), params, x, y,
                   {"specs": SPECS, "fast": False, "dropout_p": 0.7, "reg_type": "epswise",
                    "masks": masks, "accum": 2, "frozen": (0,), "with_probs": True},
                   timeout=TIMEOUT_S)
    _compare(got, _jax_sp_tp(jcfg, jparams, x, y, (1, 2, 2), "epswise", frozen=(0,), accum=2,
                             with_probs=True), probs=True)
    np.testing.assert_array_equal(got["params"]["epses"][0], params["epses"][0])


@pytest.mark.parametrize("qat,reg_type,dropout_p", [
    (None, "epses_composition", 0.8), ("int8", "epswise", 1.0)], ids=["f32", "qat_int8"])
def test_sp_tp_fast_layout_matches_jax_interpret(pool, qat, reg_type, dropout_p):
    """The fast (cmt) layout on each slab, the last layer on its row block,
    in float32 on (1, 2, 2), against JAX's ``make_sp_tp_fast_*`` on
    ``pallas_interpret``: f32 with dropout and the composition regularizer,
    and QAT (K8/K9's forward, the saved-t arm on the whole O and the valid
    global pixels)."""
    jcfg, jparams, params, x, y = _problem(dtype=np.float32, dropout_p=dropout_p,
                                           backend="pallas_interpret")
    masks = None if dropout_p == 1.0 else _jax_masks([c.shape for c in params["epses"]],
                                                     dropout_p, 1)
    got = pool.run(job_sp_tp, (1, 2, 2), params, x, y,
                   {"specs": SPECS, "fast": True, "qat": qat, "dropout_p": dropout_p,
                    "reg_type": reg_type, "masks": masks}, timeout=TIMEOUT_S)
    _compare(got, _jax_sp_tp(jcfg, jparams, x, y, (1, 2, 2), reg_type, fast=True, qat=qat),
             tol=None)


@pytest.mark.parametrize("kind", ["xla", "fast", "qat"])
def test_sp_tp_bf16_matches_jax(pool, monkeypatch, kind):
    """``compute_dtype`` bf16 on (1, 2, 2) against JAX's ``make_sp_tp_*``
    with ``compute_dtype`` bf16, in float32, on the problem of
    ``torch_port_bf16_problem``: the reference layout (xla), the fast layout
    and QAT on ``pallas_interpret`` (the saved-t arm forced on both sides:
    K9 stores a bf16 t). The forward, 2 SGD steps and the score at the
    float32 bound, and each parameter's move within MOVE_RTOL of JAX's,
    which the port's float32 run on one device misses."""
    fast = kind != "xla"
    qat = "int8" if kind == "qat" else None
    if qat:
        monkeypatch.setenv("DCTN_TPU_SAVE_T_MIN_A", "1")
    jcfg, jparams, params, x, y = unit_problem(
        SPECS, backend="pallas_interpret" if fast else "xla")
    got = pool.run(job_sp_tp, (1, 2, 2), params, x, y,
                   {"specs": SPECS, "fast": fast, "qat": qat, "bf16": True, "lr": BF16_LR,
                    "min_a": 1 if qat else SAVE_T_MIN_A, "reg_type": "epswise"},
                   timeout=TIMEOUT_S)
    want = _jax_sp_tp(jcfg, jparams, x, y, (1, 2, 2), "epswise", fast=fast, qat=qat,
                      lr=BF16_LR)
    want32 = one_device_f32(params, SPECS, x, y, kind, "epswise", REG, BF16_LR, STEPS)
    _compare(got, want, tol=None)
    check_moves(params, got["params"], want[3], want32)


def test_sp_tp_halo_and_model_axis_constraints_raise(tmp_path):
    """A halo wider than a shard's rows and a model axis that does not
    divide the last O (``sp_check_config``, ``make_tp_params``) are refused:
    by the function, and by the runner before any rank starts; so are
    ``--tp-shard-all`` with ``--space-devices`` (JAX runner.py:477-486) and
    more ranks than visible cards."""
    cfg = EPSesPlusLinearConfig(epses_specs=((4, 3), (2, 4)), image_size=6)
    assert sp_tp_check_config(cfg, 2, 2) == 3
    with pytest.raises(ValueError, match="halo"):
        sp_tp_check_config(cfg, 4, 2)  # Hl = 2 < K - 1 = 3
    with pytest.raises(ValueError, match="not divisible by model axis 3"):
        sp_tp_check_config(cfg, 2, 3)
    base = dict(QUICK, experiments_dir=str(tmp_path), max_num_iters=1)
    for kw, match in (
        ({"model_devices": 2, "space_devices": 14, "epses_specs": ((4, 4), (3, 6))},
         "3-row halo but each device holds only 2 rows"),
        ({"model_devices": 3, "space_devices": 2}, "output dim 4 not divisible by model axis 3"),
        ({"model_devices": 2, "space_devices": 2, "tp_shard_all": True},
         "--tp-shard-all does not compose with --space-devices"),
        ({"model_devices": 2, "space_devices": 2, "device": "cuda"}, "CUDA"),
    ):
        with pytest.raises(click.BadParameter, match=match):
            trunner.run(**{**base, **kw})
    assert not os.listdir(tmp_path)


def test_sp_tp_forward_matches_jax_one_device(pool):
    """The composed forward's logits against JAX's one-device forward on the
    whole batch (``eps_plus_linear_forward``), float64: the grid rebuilds
    the one-device model."""
    from dctn_tpu.models import eps_plus_linear_forward

    jcfg, jparams, params, x, y = _problem()
    got = pool.run(job_sp_tp, (1, 2, 2), params, x, y, {"specs": SPECS, "fast": False,
                                                        "reg_type": "epswise"},
                   timeout=TIMEOUT_S)
    ref = np.asarray(eps_plus_linear_forward(jparams, x, jcfg, training=False))
    _close(got["logits"], ref, F64_TOL, "logits")


# ---------------------------------------------------------------------------
# the runner

QUICK = dict(ds_type="fashionmnist", ds_path="synthetic", epses_specs=SPECS, batch_size=16,
             optimizer_name="adam", lr=3e-3, wd=0.1, reg_coeff=1e-4, synthetic_sizes=(64, 32, 32),
             eval_schedule=((None, 2),), keep_last_models=1, patience=100,
             init_epses_composition_unit_theoretical_output_std=True, device="cpu")


def _moves(init, got, want, what):
    for i, (s, a, b) in enumerate(zip(_leaves(init), _leaves(got), _leaves(want), strict=True)):
        ma, mb = a.astype(np.float64) - s, b.astype(np.float64) - s
        assert float(np.abs(mb).max()) > 1e-5, f"{what}: leaf {i} did not move"
        gap = float(np.linalg.norm(ma - mb) / np.linalg.norm(mb))
        assert gap <= MOVE_L2_TOL, f"{what} {i}: moves differ by {gap:.3e} in L2"


def _ckpts(out_dir):
    return sorted(f for f in os.listdir(out_dir) if re.match(r"model_nitd=\d+_", f))


@pytest.fixture(scope="module")
def one_device(pool, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    out = pool.run(job_runner, None, dict(QUICK, experiments_dir=str(tmp), max_num_iters=4,
                                          keep_last_models=3), timeout=TIMEOUT_S)
    out["init"] = load_params_npz(os.path.join(out["output_dir"], _ckpts(out["output_dir"])[0]))
    return out


@pytest.mark.parametrize("extra", [{}, {"train_backend": "xla", "eval_backend": "xla"}],
                         ids=["fast", "xla"])
def test_runner_sp_tp_beside_one_device(pool, one_device, tmp_path, extra):
    """``--space-devices 2 --model-devices 2`` (the fast layout's kernels on
    each slab and row block; the reference layout with the xla backends)
    from the same seed: the one-device batch stream, each rank its rows of
    its data shard; its last checkpoint, written by rank 0 in the reference
    layout after the model line's gather, moves as one device's with the
    same backends (MOVE_L2_TOL), and loads into the one-device runner's
    ``--load-model-state``; the log names the grid."""
    out = pool.run(job_runner, (1, 2, 2), dict(QUICK, experiments_dir=str(tmp_path / "g"),
                                               max_num_iters=4, space_devices=2,
                                               model_devices=2, **extra), timeout=TIMEOUT_S)
    assert out["iters"] == 4
    one = one_device
    if extra:
        one = pool.run(job_runner, None, dict(QUICK, experiments_dir=str(tmp_path / "one"),
                                              max_num_iters=4, **extra), timeout=TIMEOUT_S)
    last = os.path.join(out["output_dir"], _ckpts(out["output_dir"])[-1])
    _moves(one_device["init"], load_params_npz(last), one["params"], str(extra))
    with open(os.path.join(out["output_dir"], "log.log")) as f:
        assert re.search(r"SP x TP: grid \(data=1, space=2, model=2\)", f.read())
    if not extra:  # the checkpoint is the one-device layout
        loaded = pool.run(job_runner, None, dict(QUICK, experiments_dir=str(tmp_path / "ld"),
                                                 max_num_iters=0, load_model_state=last),
                          timeout=TIMEOUT_S)
        for a, b in zip(_leaves(loaded["params"]), _leaves(load_params_npz(last)), strict=True):
            np.testing.assert_array_equal(a, b)


def test_runner_sp_tp_resumes_bit_equal(pool, tmp_path):
    """An SP×TP run's train state at iteration 2, resumed on the same grid
    to 4 with QAT on, equals the unbroken run bit for bit."""
    kw = dict(QUICK, space_devices=2, model_devices=2, qat="int8")
    whole = pool.run(job_runner, (1, 2, 2), dict(kw, experiments_dir=str(tmp_path / "a"),
                                                 max_num_iters=4), timeout=TIMEOUT_S)
    half = pool.run(job_runner, (1, 2, 2), dict(kw, experiments_dir=str(tmp_path / "b"),
                                                max_num_iters=2), timeout=TIMEOUT_S)
    resumed = pool.run(job_runner, (1, 2, 2), dict(
        kw, experiments_dir=str(tmp_path / "c"), max_num_iters=4,
        resume_from=os.path.join(half["output_dir"], "train_state_latest.npz")),
        timeout=TIMEOUT_S)
    for a, b in zip(_leaves(resumed["params"]), _leaves(whole["params"]), strict=True):
        np.testing.assert_array_equal(a, b)
