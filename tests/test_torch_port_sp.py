"""The port's spatial parallelism (``dctn_tpu_torch.parallel.spatial_parallel``)
on the CPU: ``gloo`` ranks of one module-wide rank pool of four, on
``(data, space)`` grids of 2 and 4 ranks, against the JAX package's own
``make_sp_*`` on the conftest's virtual CPU mesh, from the same numpy
weights and batch (the JAX tests' sizes: ``(2,3),(2,4)`` on 6×6 images,
batch 8; a K = 3 layer on 7×7 images for the 2-row halo); and the runner
with ``--space-devices 2`` beside one device.

The rank processes run the jobs below, which this module defines at its
top level; the module imports no JAX at import (the JAX package is
imported inside the tests), so the ranks never load it.

Tolerances, each a share of the largest value compared (as in
``tests/test_torch_port_tp.py``):
- ``F64_TOL`` 1e-10: float64 on both sides (the reference layout, xla): the
  same products summed over other partitions (the rows' partial logits and
  gradients, the data ranks' mean); readings ≤ 1e-14;
- rtol 2e-5, atol 1e-7: the fast layout in float32 against JAX's
  ``pallas_interpret`` (f32 and QAT), the bound of
  ``tests/test_torch_port_q8.py::test_qat_step_matches_jax_pallas_interpret``;
- ``MOVE_TOL`` 5e-5 of the largest move, the runner against one device's
  run (float32 steps in other summation orders); a resume from a train
  state bit for bit;
- ``MOVE_L2_TOL`` 1e-4, the runner with the xla backends against one
  device's, each leaf's move in L2: Adam steps an entry whose float32
  gradient is near its ε by up to ±lr more or less when the sum's order
  (the classifier summed over 4 row slices) moves that gradient, which
  max|Δ| counts in full (one entry of 27,040 at 1.17e-6 against the
  1.08e-6 MOVE_TOL allows, in one reading) and L2 does not (readings
  1.1e-7 to 1.3e-6).
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
from dctn_tpu_torch.models import (
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    EPSesPlusLinearReference,
    reference_params_from_fast,
)
from dctn_tpu_torch.parallel import (
    make_grid,
    make_sp_fast_train_step,
    make_sp_forward,
    make_sp_score_fn,
    make_sp_train_step,
    pad_rows,
    sp_check_config,
    sp_local_rows,
    sp_shard_batch,
    sp_shard_split,
)
from dctn_tpu_torch.parallel.mesh import Host, Job
from dctn_tpu_torch.train import load_params_npz, make_optimizer
from torch_port_bf16_problem import LR as BF16_LR
from torch_port_bf16_problem import check_moves, one_device_f32, unit_problem
from torch_port_rank_pool import RankPool

F64_TOL = 1e-10
F32_RTOL, F32_ATOL = 2e-5, 1e-7
MOVE_TOL = 5e-5
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


def job_sp(mesh, grid, params, x, y, o):
    """The SP model of ``o`` on a ``grid`` = (n_data, n_space) of the pool's
    ranks: its forward on the batch, ``STEPS`` SGD steps on this rank's rows
    of its data shard, its score; rank 0 returns them with the reference
    params."""
    g = make_grid(mesh, "space", *grid)
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
        model = EPSesPlusLinear.from_reference(params, cfg)
        opt = make_optimizer("sgd", model.parameters(), o.get("lr", LR))
        step = make_sp_fast_train_step(model, opt, g, o["reg_type"], REG, qat=qat, **kw)
        forward = make_sp_forward(cfg, g, model.plans, qat)
        score = make_sp_score_fn(cfg, g, 3, model.plans, qat)
        now = model.fast_params
    else:
        model = EPSesPlusLinearReference(params, cfg)
        opt = make_optimizer("sgd", model.parameters(), o.get("lr", LR))
        step = make_sp_train_step(model, opt, g, o["reg_type"], REG, **kw)
        forward = make_sp_forward(cfg, g)
        score = make_sp_score_fn(cfg, g, 3)
        now = model.reference_params
    xs, ys = sp_shard_batch(g, x, y)
    logits = g.gather_data(forward(now(), xs))
    metrics = []
    for i in range(STEPS):
        masks = o.get("masks")
        m = step(xs, ys, masks=None if masks is None else [
            tuple(torch.as_tensor(t) for t in mb) for mb in masks[i]])
        metrics.append({k: _np(v) for k, v in m.items()})
    got_score = [float(v) for v in score(now(), sp_shard_split(g, x, y))]
    if g.rank != 0:
        return None
    ref = reference_params_from_fast(now(), cfg, model.plans) if o["fast"] else now()
    return {"logits": _np(logits), "metrics": metrics, "score": got_score, "params": _np(ref)}


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
    g = make_grid(mesh, "space", *grid)
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


def _problem(specs=SPECS, image=6, dtype=np.float64, dropout_p=1.0, backend="xla"):
    import jax

    from dctn_tpu.models import EPSesPlusLinearConfig as JCfg
    from dctn_tpu.models import init_eps_plus_linear

    jcfg = JCfg(epses_specs=specs, image_size=image, q0=2, dtype=dtype, dropout_p=dropout_p,
                train_backend=backend, eval_backend=backend)
    jparams = jax.tree_util.tree_map(lambda a: a.astype(dtype),
                                     init_eps_plus_linear(jax.random.PRNGKey(0), jcfg))
    x = np.random.default_rng(1).uniform(size=(1, 8, image, image, 2)).astype(dtype)
    y = np.arange(8) % 10
    return jcfg, jparams, jax.tree_util.tree_map(np.asarray, jparams), x, y


def _rngs():
    import jax

    return [jax.random.PRNGKey(10 + i) for i in range(STEPS)]


def _jax_masks(shapes, p, accum):
    """Each step's dropout masks per microbatch, as the JAX steps draw them."""
    import jax

    out = []
    for rng in _rngs():
        mbs = [rng] if accum == 1 else list(jax.random.split(rng, accum))
        out.append([tuple(np.asarray(jax.random.bernoulli(k, p, s))
                          for k, s in zip(jax.random.split(r, len(shapes)), shapes))
                     for r in mbs])
    return out


def _jax_sp(jcfg, jparams, x, y, grid, reg_type, fast=False, qat=None, frozen=(), accum=1,
            with_probs=False, lr=LR):
    """The JAX package's SP forward, STEPS SGD steps and score on a
    ``make_sp_mesh(*grid)``; the reference params."""
    import jax
    import jax.numpy as jnp

    from dctn_tpu.models.eps_plus_linear import (
        fast_params_from_reference as jfast_from_ref,
        reference_params_from_fast as jref_from_fast,
    )
    from dctn_tpu.parallel import spatial_parallel as jsp
    from dctn_tpu.train import make_optimizer as jopt_of

    mesh = jsp.make_sp_mesh(*grid)
    xs, ys = jsp.sp_shard_batch(mesh, x, y)
    opt = jopt_of("sgd", lr)
    kw = dict(frozen_eps_indices=frozen, grad_accum_steps=accum, with_probs=with_probs)
    if fast:
        p, plans = jfast_from_ref(jparams, jcfg)
        step = jsp.make_sp_fast_train_step(jcfg, opt, plans, mesh, reg_type, REG, qat=qat, **kw)
    else:
        p, plans = jparams, None
        step = jsp.make_sp_train_step(jcfg, opt, mesh, reg_type, REG, **kw)
    logits = np.asarray(jsp.make_sp_forward(jcfg, mesh, plans, qat=qat)(p, xs))
    state = opt.init(p)
    metrics = []
    for rng in _rngs():
        p, state, m = step(p, state, rng, xs, ys)
        metrics.append(jax.tree_util.tree_map(np.asarray, m))
    score = jsp.make_sp_score_fn(jcfg, mesh, 3, plans, qat=qat)
    sc = [float(v) for v in score(p, jax.device_put(pad_rows(x, grid[1])), jnp.asarray(y))]
    ref = jref_from_fast(p, jcfg, plans) if fast else p
    return logits, metrics, sc, jax.tree_util.tree_map(np.asarray, ref)


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


# ---------------------------------------------------------------------------
# the steps against the JAX package's


@pytest.mark.parametrize("grid,reg_type", [
    ((1, 2), "epswise"), ((2, 2), "epses_composition"), ((1, 4), "epses_composition"),
], ids=["space2", "data2_space2", "space4"])
def test_sp_forward_step_and_score_match_jax(pool, grid, reg_type):
    """The reference layout on grids of 2 and 4 ranks (6 rows over 4: Hl =
    2, two bottom rows of padding): the forward's logits, 2 SGD steps (the
    halo's transposes, the regularizer divided by P, the per-leaf
    reductions) and the score match JAX's ``make_sp_forward`` /
    ``make_sp_train_step`` / ``make_sp_score_fn``."""
    jcfg, jparams, params, x, y = _problem()
    got = pool.run(job_sp, grid, params, x, y, {"specs": SPECS, "fast": False,
                                               "reg_type": reg_type}, timeout=TIMEOUT_S)
    _compare(got, _jax_sp(jcfg, jparams, x, y, grid, reg_type))


def test_sp_two_row_halo_of_a_k3_layer_matches_jax(pool):
    """A K = 3 first layer on 7×7 images over 2 space ranks (Hl = 4, a
    2-row halo, one row of padding) against JAX."""
    specs = ((3, 3), (2, 4))
    jcfg, jparams, params, x, y = _problem(specs, image=7)
    got = pool.run(job_sp, (1, 2), params, x, y, {"specs": specs, "fast": False,
                                                  "reg_type": "epswise"}, timeout=TIMEOUT_S)
    _compare(got, _jax_sp(jcfg, jparams, x, y, (1, 2), "epswise"))


def test_sp_dropout_accumulation_frozen_and_probs_match_jax(pool):
    """Dropout at p = 0.7 with JAX's masks (the same realization on every
    rank), 2 accumulation microbatches, core 1 frozen, and the
    probabilities of the true class gathered over ``data``, on a (2, 2)
    grid against JAX's SP step with the same options."""
    jcfg, jparams, params, x, y = _problem(dropout_p=0.7)
    masks = _jax_masks([c.shape for c in params["epses"]], 0.7, 2)
    got = pool.run(job_sp, (2, 2), params, x, y,
                   {"specs": SPECS, "fast": False, "dropout_p": 0.7, "reg_type": "epswise",
                    "masks": masks, "accum": 2, "frozen": (1,), "with_probs": True},
                   timeout=TIMEOUT_S)
    _compare(got, _jax_sp(jcfg, jparams, x, y, (2, 2), "epswise", frozen=(1,), accum=2,
                          with_probs=True), probs=True)
    np.testing.assert_array_equal(got["params"]["epses"][1], params["epses"][1])


@pytest.mark.parametrize("qat,reg_type,dropout_p", [
    (None, "epses_composition", 0.8), ("int8", "epswise", 1.0)], ids=["f32", "qat_int8"])
def test_sp_fast_layout_matches_jax_interpret(pool, qat, reg_type, dropout_p):
    """The fast (cmt) layout on each slab in float32, on a (1, 4) grid,
    against JAX's ``make_sp_fast_*`` on ``pallas_interpret``: f32 with
    dropout and the composition regularizer, and QAT (K8/K9's forward, the
    saved-t arm decided on the valid global height and batch)."""
    jcfg, jparams, params, x, y = _problem(dtype=np.float32, dropout_p=dropout_p,
                                           backend="pallas_interpret")
    masks = None if dropout_p == 1.0 else _jax_masks([c.shape for c in params["epses"]],
                                                     dropout_p, 1)
    got = pool.run(job_sp, (1, 4), params, x, y,
                   {"specs": SPECS, "fast": True, "qat": qat, "dropout_p": dropout_p,
                    "reg_type": reg_type, "masks": masks}, timeout=TIMEOUT_S)
    _compare(got, _jax_sp(jcfg, jparams, x, y, (1, 4), reg_type, fast=True, qat=qat), tol=None)


@pytest.mark.parametrize("kind", ["halo_xla", "fast", "qat"])
def test_sp_bf16_matches_jax(pool, monkeypatch, kind):
    """``compute_dtype`` bf16 on a (2 data, 2 space) grid against JAX's
    ``make_sp_*`` with ``compute_dtype`` bf16, in float32, on the problem
    of ``torch_port_bf16_problem``: the reference layout (xla), the fast
    layout and QAT on ``pallas_interpret`` (the saved-t arm forced on both
    sides: K9 stores a bf16 t). The forward, 2 SGD steps and the score at
    the float32 bound, and each parameter's move within MOVE_RTOL of JAX's,
    which the port's float32 run on one device misses."""
    fast = kind != "halo_xla"
    qat = "int8" if kind == "qat" else None
    if qat:
        monkeypatch.setenv("DCTN_TPU_SAVE_T_MIN_A", "1")
    jcfg, jparams, params, x, y = unit_problem(
        SPECS, backend="pallas_interpret" if fast else "xla")
    got = pool.run(job_sp, (2, 2), params, x, y,
                   {"specs": SPECS, "fast": fast, "qat": qat, "bf16": True, "lr": BF16_LR,
                    "min_a": 1 if qat else SAVE_T_MIN_A, "reg_type": "epswise"},
                   timeout=TIMEOUT_S)
    want = _jax_sp(jcfg, jparams, x, y, (2, 2), "epswise", fast=fast, qat=qat, lr=BF16_LR)
    want32 = one_device_f32(params, SPECS, x, y, kind, "epswise", REG, BF16_LR, STEPS)
    _compare(got, want, tol=None)
    check_moves(params, got["params"], want[3], want32)


def test_sp_halo_constraint_raises(tmp_path):
    """A halo wider than a shard (``sp_check_config``,
    spatial_parallel.py:91-100) is refused: by the function, and by the
    runner before any rank starts."""
    cfg = EPSesPlusLinearConfig(epses_specs=((4, 4),), image_size=6)
    assert sp_local_rows(6, 4) == 2 and sp_check_config(cfg, 2) == 3
    with pytest.raises(ValueError, match="halo"):
        sp_check_config(cfg, 4)  # Hl = 2 < K - 1 = 3
    with pytest.raises(click.BadParameter, match="3-row halo but each device holds only 2 rows"):
        trunner.run(**dict(QUICK, experiments_dir=str(tmp_path), max_num_iters=1,
                           epses_specs=((4, 4), (3, 6)), space_devices=14))
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# the runner

QUICK = dict(ds_type="fashionmnist", ds_path="synthetic", epses_specs=SPECS, batch_size=16,
             optimizer_name="adam", lr=3e-3, wd=0.1, reg_coeff=1e-4, synthetic_sizes=(64, 32, 32),
             eval_schedule=((None, 2),), keep_last_models=1, patience=100,
             init_epses_composition_unit_theoretical_output_std=True, device="cpu")


def _moves(init, got, want, what, l2=False):
    for i, (s, a, b) in enumerate(zip(_leaves(init), _leaves(got), _leaves(want), strict=True)):
        ma, mb = a.astype(np.float64) - s, b.astype(np.float64) - s
        scale = float(np.abs(mb).max())
        assert scale > 1e-5, f"{what}: leaf {i} did not move"
        if l2:
            gap = float(np.linalg.norm(ma - mb) / np.linalg.norm(mb))
            assert gap <= MOVE_L2_TOL, f"{what} {i}: moves differ by {gap:.3e} in L2"
        else:
            np.testing.assert_allclose(ma, mb, rtol=0, atol=MOVE_TOL * scale,
                                       err_msg=f"{what} {i}")


def _ckpts(out_dir):
    return sorted(f for f in os.listdir(out_dir) if re.match(r"model_nitd=\d+_", f))


@pytest.fixture(scope="module")
def one_device(pool, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    out = pool.run(job_runner, None, dict(QUICK, experiments_dir=str(tmp), max_num_iters=4,
                                          keep_last_models=3), timeout=TIMEOUT_S)
    out["init"] = load_params_npz(os.path.join(out["output_dir"], _ckpts(out["output_dir"])[0]))
    return out


@pytest.mark.parametrize("extra,grid", [
    ({"space_devices": 2}, (1, 2)),
    ({"space_devices": 2, "mesh_devices": 2}, (2, 2)),
    ({"space_devices": 4, "train_backend": "xla", "eval_backend": "xla"}, (1, 4)),
], ids=["space2", "data2_space2", "space4_xla"])
def test_runner_sp_beside_one_device(pool, one_device, tmp_path, extra, grid):
    """``--space-devices`` (the fast layout's kernels on each slab; the
    reference layout with the xla backends) from the same seed: the
    one-device batch stream, each rank its rows of its data shard; its last
    checkpoint, written by rank 0, moves within MOVE_TOL of one device's
    with the same backends; the log names the grid."""
    out = pool.run(job_runner, grid, dict(QUICK, experiments_dir=str(tmp_path / "sp"),
                                          max_num_iters=4, **extra), timeout=TIMEOUT_S)
    assert out["iters"] == 4
    one = one_device
    if "train_backend" in extra:
        one = pool.run(job_runner, None, dict(
            QUICK, experiments_dir=str(tmp_path / "one"), max_num_iters=4,
            train_backend="xla", eval_backend="xla"), timeout=TIMEOUT_S)
    ckpt = load_params_npz(os.path.join(out["output_dir"], _ckpts(out["output_dir"])[-1]))
    _moves(one_device["init"], ckpt, one["params"], str(extra), l2=one is not one_device)
    with open(os.path.join(out["output_dir"], "log.log")) as f:
        assert re.search(rf"spatial parallelism: grid \(data={grid[0]}, space={grid[1]}\)",
                         f.read())


def test_runner_sp_bf16_beside_one_device(pool, tmp_path):
    """``--compute-dtype bfloat16 --space-devices 2 --mesh-devices 2 --qat
    int8`` (K9's bf16 t under the threshold the runner keeps) from the same
    seed as one device's bf16 QAT run (SGD 1e-3, 4 iterations): each
    parameter's move within MOVE_L2_TOL of one device's in L2 (each pixel's
    operands are one device's: read 3e-5, against 2e-2 for the float32
    run); the parameters stay float32 and the log names the grid."""
    kw = dict(QUICK, max_num_iters=4, compute_dtype="bfloat16", qat="int8",
              optimizer_name="sgd", lr=1e-3, wd=0.0, keep_last_models=5)
    one = pool.run(job_runner, None, dict(kw, experiments_dir=str(tmp_path / "one")),
                   timeout=TIMEOUT_S)
    out = pool.run(job_runner, (2, 2), dict(kw, experiments_dir=str(tmp_path / "sp"),
                                            space_devices=2, mesh_devices=2), timeout=TIMEOUT_S)
    assert out["iters"] == 4
    init = load_params_npz(os.path.join(one["output_dir"], _ckpts(one["output_dir"])[0]))
    assert all(a.dtype == np.float32 for a in _leaves(out["params"]))
    _moves(init, out["params"], one["params"], "bf16 qat space2", l2=True)
    with open(os.path.join(out["output_dir"], "log.log")) as f:
        assert re.search(r"spatial parallelism: grid \(data=2, space=2\)", f.read())


def test_runner_sp_resumes_bit_equal(pool, tmp_path):
    """An SP run's train state at iteration 2, resumed on the same grid to 4
    with QAT on, equals the unbroken run bit for bit."""
    kw = dict(QUICK, space_devices=2, mesh_devices=2, qat="int8")
    whole = pool.run(job_runner, (2, 2), dict(kw, experiments_dir=str(tmp_path / "a"),
                                              max_num_iters=4), timeout=TIMEOUT_S)
    half = pool.run(job_runner, (2, 2), dict(kw, experiments_dir=str(tmp_path / "b"),
                                             max_num_iters=2), timeout=TIMEOUT_S)
    resumed = pool.run(job_runner, (2, 2), dict(
        kw, experiments_dir=str(tmp_path / "c"), max_num_iters=4,
        resume_from=os.path.join(half["output_dir"], "train_state_latest.npz")),
        timeout=TIMEOUT_S)
    for a, b in zip(_leaves(resumed["params"]), _leaves(whole["params"]), strict=True):
        np.testing.assert_array_equal(a, b)
