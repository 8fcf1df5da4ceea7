"""The port's data parallelism (``dctn_tpu_torch.parallel``) on the CPU: two
``gloo`` ranks of one module-wide rank pool, against the port's
single-device steps on the concatenated batch and against the JAX
package's DP steps on a 2-device mesh (the conftest's virtual CPU devices,
``xla`` backends).

The rank processes run the jobs below, which this module defines at its
top level; the module imports no JAX at import (the JAX package is
imported inside the tests), so the ranks never load it. Each test's pool
call has a timeout of its own.

Tolerances, each a share of the largest value compared:
- ``STEP_TOL`` 1e-5, a DP step's parameter moves against one process's on
  the same images: float32 means taken over other partitions of the batch
  (per rank, then the all-reduce), through Adam's division by √v (readings
  ≤ 3e-7);
- ``JAX_TOL`` 5e-5, against the JAX DP steps: float32 in other summation
  orders throughout (the bound of ``tests/test_torch_port_runner.py``);
- ``SCORE_TOL`` 1e-6 for the mean CE: per-shard f32 sums, summed in f64
  here and in f32 by JAX's psum;
- ``multichip``'s checks, at their own (``DP_TOL``, ``TRAJ_TOL``).
"""

import numpy as np
import pytest
import torch

from dctn_tpu_torch.interop import conv_sbs_params_from_numpy, params_from_numpy
from dctn_tpu_torch.kernels import eps_kernels as K
from dctn_tpu_torch.models import (
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    EPSesPlusLinearReference,
    init_eps_plus_linear,
)
from dctn_tpu_torch.models.conv_sbs_model import ConvSBSModel, ConvSBSModelConfig
from dctn_tpu_torch.models.eps_plus_linear import eps_plus_linear_forward
from dctn_tpu_torch.parallel import (
    GradAllReduce,
    make_local_index_stream,
    make_parallel_fast_train_step,
    make_parallel_pixel_score_fn,
    make_parallel_pixel_train_step,
    make_parallel_predict_fn,
    make_parallel_score_fn,
    make_parallel_train_step,
    replicate,
    shard_pixel_split,
    shard_split,
)
from dctn_tpu_torch.parallel.mesh import Host, Job
from torch_port_rank_pool import RankPool
from dctn_tpu_torch.train import make_fast_train_step, make_optimizer

STEP_TOL = 1e-5
JAX_TOL = 5e-5
SCORE_TOL = 1e-6
RANKS = 2
SPECS = ((2, 4), (2, 3))
TIMEOUT_S = 120


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np_tree(v) for v in tree)
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _assert_moves(init, got, want, tol, what=""):
    """Every leaf's move agrees within ``tol`` of the largest move."""
    worst = 0.0
    for i, (s, a, b) in enumerate(zip(_leaves(init), _leaves(got), _leaves(want))):
        ma, mb = a.astype(np.float64) - s, b.astype(np.float64) - s
        scale = float(np.abs(mb).max())
        assert scale > 0, f"{what}: leaf {i} did not move"
        worst = max(worst, float(np.abs(ma - mb).max()) / scale)
    assert worst <= tol, f"{what}: moves differ by {worst:.3e} of the largest"
    return worst


# ---------------------------------------------------------------------------
# the jobs the ranks run: fn(mesh, *args), top-level so that they pickle


def _rank_slice(mesh, b):
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def job_fast_steps(mesh, params, specs, x, y, steps, accum, masks, frozen, qat=None, cap=None,
                   pixel_scale=None, reg=1e-3):
    """The DP fast step on this rank's slice of (x, y); returns the final
    reference params, the losses and the arms ``plan_backward`` chose in the
    steps (recorded once the model is built: its gate asks too)."""
    from dctn_tpu_torch.kernels import eps_kernels

    arms, plan = [], eps_kernels.plan_backward

    def recording(*a):
        arms.append(plan(*a))
        return arms[-1]

    cap0 = eps_kernels.SAVE_T_MAX_BYTES
    if cap is not None:
        eps_kernels.SAVE_T_MAX_BYTES = cap
    try:
        cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=x.shape[2], q0=x.shape[-1],
                                    dropout_p=0.9 if masks is not None else 1.0)
        model = EPSesPlusLinear.from_reference(params_from_numpy(params), cfg)
        eps_kernels.plan_backward = recording
        opt = make_optimizer("adam", model.parameters(), 3e-3, 0.1)
        if pixel_scale is None:
            step = make_parallel_fast_train_step(model, opt, mesh, "epswise", reg,
                                                 frozen_eps_indices=frozen, qat=qat,
                                                 grad_accum_steps=accum)
        else:  # the DP step with another pixel count for the saved-t decision
            step = make_fast_train_step(model, opt, "epswise", reg, qat=qat,
                                        collective=GradAllReduce(mesh), pixel_scale=pixel_scale)
        b = y.shape[0] // mesh.world_size
        xs = torch.as_tensor(x[:, _rank_slice(mesh, b)])
        ys = torch.as_tensor(y[_rank_slice(mesh, b)])
        m = None if masks is None else [tuple(torch.as_tensor(t) for t in masks)] * accum
        losses = [float(step(xs, ys, masks=m)["loss"]) for _ in range(steps)]
        grads = [p.grad.numpy().copy() for p in model.parameters()]
        from dctn_tpu_torch.models import reference_params_from_fast

        ref = reference_params_from_fast(model.fast_params(), cfg, model.plans)
        return _np_tree(ref), losses, arms, grads
    finally:
        eps_kernels.plan_backward = plan
        eps_kernels.SAVE_T_MAX_BYTES = cap0


def job_probs(mesh, params, specs, x, y):
    """One DP fast step with ``with_probs``: every rank's probabilities."""
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=x.shape[2], q0=x.shape[-1])
    model = EPSesPlusLinear.from_reference(params_from_numpy(params), cfg)
    opt = make_optimizer("sgd", model.parameters(), 1e-3)
    step = make_parallel_fast_train_step(model, opt, mesh, with_probs=True)
    b = y.shape[0] // mesh.world_size
    m = step(torch.as_tensor(x[:, _rank_slice(mesh, b)]), torch.as_tensor(y[_rank_slice(mesh, b)]))
    return m["probs_of_true_class"].numpy()


def job_fail_on_rank_0(mesh):
    """Rank 0 fails while the others wait for it in a collective."""
    if mesh.rank == 0:
        raise ValueError("rank 0 gives up")
    mesh.barrier()


def job_reference_steps(mesh, params, specs, x, y, rows, lr):
    """The DP reference-layout step, each step on this rank's row of the
    (W, b) local index array, from its shard."""
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=x.shape[2], q0=x.shape[-1])
    model = EPSesPlusLinearReference(params_from_numpy(params), cfg)
    opt = make_optimizer("adam", model.parameters(), lr, 0.1)
    step = make_parallel_train_step(model, opt, mesh, "epses_composition", 1e-3)
    split = shard_split(mesh, x, y)
    for row in rows:
        idx = torch.as_tensor(row[mesh.rank], dtype=torch.int64)
        step(split.x.index_select(1, idx), split.y.index_select(0, idx))
    return _np_tree(model.reference_params())


def job_pixel_steps(mesh, cores, cfg_kw, x, y, rows, lr):
    """The DP ConvSBS step, each step on this rank's row from its shard."""
    cfg = ConvSBSModelConfig(**cfg_kw)
    model = ConvSBSModel(conv_sbs_params_from_numpy(cores, dtype=torch.float32), cfg)
    opt = torch.optim.SGD(model.parameters(), lr=lr)
    step = make_parallel_pixel_train_step(model, opt, mesh)
    split = shard_pixel_split(mesh, x, y)
    losses = []
    for row in rows:
        idx = torch.as_tensor(row[mesh.rank], dtype=torch.int64)
        losses.append(float(step(split.x.index_select(0, idx), split.y.index_select(0, idx))))
    score = make_parallel_pixel_score_fn(lambda _, xb: model(xb), mesh, 2)
    return _np_tree(model.params()), losses, [float(v) for v in score(None, split)]


def job_score(mesh, params, specs, x, y, batch):
    """The sharded score and prediction of the reference-layout forward."""
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=x.shape[2], q0=x.shape[-1])
    p = params_from_numpy(params)

    def fwd(params_, xb):
        return eps_plus_linear_forward(params_, xb, cfg)

    split = shard_split(mesh, x, y)
    ce, acc = make_parallel_score_fn(cfg, None, mesh, batch, forward_fn=fwd)(p, split)
    preds = make_parallel_predict_fn(cfg, None, mesh, batch, forward_fn=fwd)(p, split)
    return float(ce), float(acc), preds, split.n_local


def job_multichip_checks(mesh):
    """``multichip``'s on-card checks at its CPU rehearsal's shapes: the
    failures they record and their records."""
    from dctn_tpu_torch import multichip as mc

    mc._FAILED.clear()
    z = mc.sizes(True)
    recs = [mc._xla_check(mesh, z), mc._fast_check(mesh, z, dropout=True, accum=2),
            mc._fast_check(mesh, z, qat="int8"), mc._sbs_check(mesh, z)[0]]
    return list(mc._FAILED), recs


def job_multichip_trajectory(mesh, how):
    """``multichip``'s trajectory check on a linear classifier whose DP
    steps go wrong after the first: ``rank``, rank 1 shrinks its
    parameters alone; ``update``, every rank shrinks them (an update one
    card does not make); ``none``, nothing. Returns the failures."""
    from dctn_tpu_torch import multichip as mc

    mc._FAILED.clear()
    model = torch.nn.Linear(6, 3)
    replicate(mesh, model.parameters())
    init = {k: v.clone() for k, v in model.state_dict().items()}
    x = torch.randn(8, 6, generator=torch.Generator().manual_seed(1))
    y = torch.arange(8) % 3
    opt = mc._sgd(model)
    step = make_parallel_pixel_train_step(model, opt, mesh)
    sl = _rank_slice(mesh, 8 // mesh.world_size)
    calls = [0]

    def dp():
        loss = step(x[sl], y[sl])
        calls[0] += 1
        if calls[0] > 1 and (how == "update" or (how == "rank" and mesh.rank == 1)):
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 - 1e-3)
        return loss

    def one_card():
        one = torch.nn.Linear(6, 3)
        one.load_state_dict(init)
        opt1 = mc._sgd(one)

        def step1():
            opt1.zero_grad(set_to_none=True)
            loss = torch.nn.functional.cross_entropy(one(x), y)
            loss.backward()
            opt1.step()
            return loss.detach()

        return one, opt1, step1

    mc._trajectory(mesh, model, opt, dp, one_card, how)
    return list(mc._FAILED)


# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool():
    """Two gloo ranks for the whole module, one thread each."""
    p = RankPool(Job(RANKS, RANKS, Host(), "cpu", threads=1))
    yield p
    p.close()


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _eps_problem(specs=SPECS, n=8, seed=0, image=8):
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=image, q0=2)
    params = init_eps_plus_linear(torch.Generator().manual_seed(seed), cfg,
                                  "unit_theoretical_output_std")
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (1, n, image, image, 2)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int64)
    return cfg, _np_tree(params), x, y


@pytest.mark.parametrize("ndev,n,b", [(2, 37, 4), (4, 64, 8), (3, 100, 7)])
def test_local_index_stream_is_the_jax_stream(ndev, n, b):
    """``make_local_index_stream`` gives JAX's rows, row for row, over
    several epochs of every shard (a split the ranks do not divide)."""
    from types import SimpleNamespace

    from dctn_tpu.parallel.data_parallel import make_local_index_stream as jax_stream

    n_local = -(-n // ndev)
    fake = SimpleNamespace(mesh=SimpleNamespace(devices=np.empty(ndev), world_size=ndev,
                                                data_size=ndev),
                           n_local=n_local, n_valid=n)
    ours, theirs = make_local_index_stream(fake, b, seed=5), jax_stream(fake, b, seed=5)
    for _ in range(40):
        np.testing.assert_array_equal(next(ours), next(theirs))


@pytest.mark.parametrize("accum", [1, 2])
def test_dp_fast_step_is_the_single_device_step(pool, accum):
    """3 Adam steps (weight decay 0.1, epswise L2) of the DP fast step on 2
    ranks, with a passed dropout mask and a frozen core, against the
    single-device step on the concatenated batch: every move within
    STEP_TOL; the losses are the ranks' mean."""
    cfg, params, x, y = _eps_problem(n=8)
    cfg = EPSesPlusLinearConfig(epses_specs=SPECS, image_size=8, q0=2, dropout_p=0.9)
    plans = EPSesPlusLinear.from_reference(params_from_numpy(params), cfg).plans
    g = torch.Generator().manual_seed(7)
    masks = tuple(torch.rand(p["core_shape"], generator=g) < 0.9 for p in plans)
    got, losses, _, _ = pool.run(job_fast_steps, params, SPECS, x, y, 3, accum,
                                 _np_tree(masks), (0,), timeout=TIMEOUT_S)
    model = EPSesPlusLinear.from_reference(params_from_numpy(params), cfg)
    opt = make_optimizer("adam", model.parameters(), 3e-3, 0.1)
    step = make_fast_train_step(model, opt, "epswise", 1e-3, frozen_eps_indices=(0,))
    want_losses = [float(step(torch.as_tensor(x), torch.as_tensor(y), masks=[masks])["loss"])
                   for _ in range(3)]
    from dctn_tpu_torch.models import reference_params_from_fast

    want = _np_tree(reference_params_from_fast(model.fast_params(), cfg, model.plans))
    _assert_moves(params, got, want, STEP_TOL, f"accum {accum}")
    np.testing.assert_allclose(losses, want_losses, rtol=1e-6)


def _on_data_axis(mesh, rows):
    """A (W, b) index array sharded over the JAX mesh's ``data`` axis."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    return jax.device_put(rows, NamedSharding(mesh, PartitionSpec("data")))


def _jax_problem(specs=SPECS, n=24, image=8):
    cfg, params, x, y = _eps_problem(specs, n=n, image=image)
    return cfg, params, x, y


def test_dp_reference_step_is_the_jax_dp_step(pool):
    """The DP reference-layout step (the xla backend) on 2 ranks against
    JAX ``make_parallel_train_step`` on a 2-device mesh: the same init, the
    same local index rows (each package's ``make_local_index_stream``, equal
    row for row), 3 Adam steps (wd 0.1, composition regularizer)."""
    import jax

    from dctn_tpu import models as jm
    from dctn_tpu.parallel import make_mesh as jmake_mesh
    from dctn_tpu.parallel import make_parallel_train_step as jstep_fn
    from dctn_tpu.parallel import replicate as jreplicate
    from dctn_tpu.parallel import shard_split as jshard
    from dctn_tpu.parallel.data_parallel import make_local_index_stream as jstream
    from dctn_tpu.train.optimizers import make_optimizer as jopt

    _, params, x, y = _jax_problem()
    mesh = jmake_mesh(RANKS)
    jsplit = jshard(mesh, x, y)
    rows = [next(s) for s in [jstream(jsplit, 4, seed=1)] for _ in range(3)]
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=SPECS, image_size=8, q0=2)
    opt = jopt("adam", 3e-3, 0.1)
    step = jstep_fn(jcfg, opt, mesh, "epses_composition", 1e-3, donate=False)
    jp = jax.tree_util.tree_map(np.asarray, params)
    p, o = jreplicate(mesh, jp), jreplicate(mesh, opt.init(jp))
    for row in rows:
        p, o, _ = step(p, o, jax.random.PRNGKey(0), jsplit.x, jsplit.y, _on_data_axis(mesh, row))
    want = jax.tree_util.tree_map(np.asarray, p)
    got = pool.run(job_reference_steps, params, SPECS, x, y, rows, 3e-3, timeout=TIMEOUT_S)
    _assert_moves(params, got, want, JAX_TOL, "reference layout")


def test_dp_pixel_step_and_score_are_the_jax_ones(pool):
    """The DP ConvSBS step (SGD) on 2 ranks against JAX
    ``make_parallel_pixel_train_step`` on a 2-device mesh (xla folds), 3
    steps on the same local rows, then the sharded score against JAX
    ``make_parallel_pixel_score_fn`` on a split of 13 (not a multiple of
    2)."""
    import jax
    import jax.numpy as jnp
    import optax

    from dctn_tpu.models import conv_sbs_model as jcsm
    from dctn_tpu.parallel import make_mesh as jmake_mesh
    from dctn_tpu.parallel import make_parallel_pixel_score_fn as jscore
    from dctn_tpu.parallel import make_parallel_pixel_train_step as jstep_fn
    from dctn_tpu.parallel import replicate as jreplicate
    from dctn_tpu.parallel import shard_pixel_split as jshard
    from dctn_tpu.parallel.data_parallel import make_local_index_stream as jstream
    from dctn_tpu_torch.models.conv_sbs_model import (
        calc_std_of_coordinates_of_windows,
        init_conv_sbs_model,
        scale_layers_using_batch,
    )

    rng = np.random.default_rng(3)
    x = rng.uniform(size=(13, 5, 5)).astype(np.float32)
    y = rng.integers(0, 10, 13).astype(np.int64)
    std = float(calc_std_of_coordinates_of_windows(torch.as_tensor(x), 3, False, 1.0))
    kw = dict(num_sbs_layers=2, bond_dim_size=2, input_multiplier=std ** (-1.0 / 9.0))
    tcfg = ConvSBSModelConfig(**kw)
    cores = _np_tree(scale_layers_using_batch(
        init_conv_sbs_model(torch.Generator().manual_seed(0), tcfg), tcfg, torch.as_tensor(x)))
    mesh = jmake_mesh(RANKS)
    jsplit = jshard(mesh, x, y)
    rows = [next(s) for s in [jstream(jsplit, 3, seed=2)] for _ in range(3)]
    jcfg = jcsm.ConvSBSModelConfig(**kw)

    def fwd(p, xb):
        return jcsm.conv_sbs_model_forward(p, jcfg, xb)

    opt = optax.sgd(0.05)
    step = jstep_fn(fwd, opt, mesh, donate=False)
    jp = jax.tree_util.tree_map(jnp.asarray, cores)
    p, o = jreplicate(mesh, jp), jreplicate(mesh, opt.init(jp))
    jlosses = []
    for row in rows:
        p, o, loss = step(p, o, jsplit.x, jsplit.y, _on_data_axis(mesh, row))
        jlosses.append(float(loss))
    jce, jacc = (float(v) for v in jscore(fwd, mesh, 2)(p, jsplit))
    got, losses, (ce, acc) = pool.run(job_pixel_steps, cores, kw, x, y, rows, 0.05,
                                      timeout=TIMEOUT_S)
    _assert_moves(cores, got, jax.tree_util.tree_map(np.asarray, p), JAX_TOL, "ConvSBS")
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert abs(ce - jce) <= SCORE_TOL * abs(jce) and acc == jacc


def test_sharded_score_and_predict_are_the_jax_ones(pool):
    """The sharded score on a split of 37 (padded to 38 over 2 ranks)
    against JAX ``make_parallel_score_fn`` on a 2-device mesh, and the
    sharded predictions against JAX ``make_parallel_predict_fn``."""
    import jax

    from dctn_tpu import models as jm
    from dctn_tpu.parallel import make_mesh as jmake_mesh
    from dctn_tpu.parallel import make_parallel_predict_fn as jpredict
    from dctn_tpu.parallel import make_parallel_score_fn as jscore
    from dctn_tpu.parallel import shard_split as jshard

    _, params, x, y = _eps_problem(n=37, seed=4)
    mesh = jmake_mesh(RANKS)
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=SPECS, image_size=8, q0=2)
    jsplit = jshard(mesh, x, y)
    jp = jax.tree_util.tree_map(np.asarray, params)
    jce, jacc = (float(v) for v in jscore(jcfg, mesh, 4)(jp, jsplit))
    jpreds = jpredict(jcfg, mesh, 4)(jp, jsplit)
    ce, acc, preds, n_local = pool.run(job_score, params, SPECS, x, y, 4, timeout=TIMEOUT_S)
    assert n_local == 19
    assert abs(ce - jce) <= SCORE_TOL * abs(jce), (ce, jce)
    assert acc == pytest.approx(jacc, abs=1e-7)
    np.testing.assert_array_equal(preds, jpreds)


def test_dp_qat_decides_saved_t_on_the_global_pixel_count(pool):
    """DP QAT at 2 images a rank, with the saved-t cap between layer 1's t
    at 2 images and at 4: one device on the 4 recomputes t, so the DP step
    does too (its arms are the single-device step's, and its gradients
    agree within STEP_TOL), while a rank deciding on its own pixels would
    save the dequantized t, whose STE gradient is another (here more than
    100·STEP_TOL away)."""
    specs = ((2, 4), (3, 4))
    cfg, params, x, y = _eps_problem(specs, n=4, seed=2, image=10)
    plans = EPSesPlusLinear.from_reference(params_from_numpy(params), cfg).plans
    from dctn_tpu_torch.models.eps_plus_linear import _plan_dims

    n_k, q_k, n1_k = _plan_dims(plans[1])
    z = plans[1]["out_size"] * q_k ** (n_k - n1_k)
    hw = (10 - specs[0][0] + 1 - specs[1][0] + 1) ** 2
    cap = z * hw * 4 * 3  # t of 3 images: over 2 a rank, under the global 4
    # no regularizer: its gradient would hide layer 0's cross-entropy one
    _, _, arms, grads = pool.run(job_fast_steps, params, specs, x, y, 1, 1, None, (), "int8",
                                 cap, None, 0.0, timeout=TIMEOUT_S)
    _, _, local_arms, local_grads = pool.run(job_fast_steps, params, specs, x, y, 1, 1, None,
                                             (), "int8", cap, 1, 0.0, timeout=TIMEOUT_S)
    # layer 0's input needs no gradient: only layer 1 is planned
    assert arms == ["recompute"] and local_arms == ["saved_t"]

    cap0, K.SAVE_T_MAX_BYTES = K.SAVE_T_MAX_BYTES, cap
    try:
        model = EPSesPlusLinear.from_reference(params_from_numpy(params), cfg)
        opt = make_optimizer("adam", model.parameters(), 3e-3, 0.1)
        step = make_fast_train_step(model, opt, "epswise", 0.0, qat="int8")
        step(torch.as_tensor(x), torch.as_tensor(y))
        want = [p.grad.numpy() for p in model.parameters()]
    finally:
        K.SAVE_T_MAX_BYTES = cap0

    def gap(got):
        return max(float(np.abs(a - b).max()) / float(np.abs(b).max())
                   for a, b in zip(got, want))

    assert gap(grads) <= STEP_TOL, gap(grads)
    assert gap(local_grads) > 100 * STEP_TOL, gap(local_grads)


def test_dp_probs_are_gathered_in_rank_order(pool):
    """``with_probs`` (``--tb-batches``): the step's probabilities of the
    true class are every rank's, rank-major (JAX's ``P("data")`` order), so
    on the concatenated batch they are the single-device step's."""
    cfg, params, x, y = _eps_problem(n=8)
    got = pool.run(job_probs, params, SPECS, x, y, timeout=TIMEOUT_S)
    model = EPSesPlusLinear.from_reference(params_from_numpy(params), cfg)
    step = make_fast_train_step(model, make_optimizer("sgd", model.parameters(), 1e-3),
                                with_probs=True)
    want = step(torch.as_tensor(x), torch.as_tensor(y))["probs_of_true_class"].numpy()
    assert got.shape == (8,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_a_failed_rank_ends_the_job_instead_of_hanging_it():
    """A rank that raises while the others wait in a collective it will
    never join: it leaves at once, the spawner kills the others and raises
    its traceback (well within the 30-minute collective timeout)."""
    import time

    from dctn_tpu_torch.parallel import spawn

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"rank 0 of 2 failed:(.|\n)*rank 0 gives up"):
        spawn(job_fail_on_rank_0, Job(RANKS, RANKS, Host(), "cpu", threads=1))
    assert time.monotonic() - t0 < 60


def test_multichip_checks_pass_on_two_ranks(pool):
    """``python -m dctn_tpu_torch.multichip``'s checks (xla, fast with
    dropout and accumulation 2, QAT and ConvSBS) on two gloo ranks at its
    rehearsal's shapes: no failure, every rank's parameters equal after
    the steps, gradients and moves within its own tolerances."""
    from dctn_tpu_torch import multichip as mc

    failed, recs = pool.run(job_multichip_checks, timeout=TIMEOUT_S)
    assert failed == []
    for rec in recs:
        assert rec["ranks_equal"] is True
        assert rec["gradient_gap"] <= mc.DP_TOL
        assert 0 <= rec["trajectory_gap"] <= mc.TRAJ_TOL
        assert len(rec["losses"]) == mc.CHECK_STEPS + 1 and np.isfinite(rec["losses"]).all()


@pytest.mark.parametrize("how,caught", [
    ("none", None),
    ("rank", "the ranks' parameters differ"),
    ("update", "moves differ"),
])
def test_multichip_trajectory_check_catches_steps_that_go_wrong(pool, how, caught):
    """The trajectory check fails a rank that updates alone (the ranks'
    parameters are gathered and compared) and ranks that all update
    otherwise than one card (their moves against one card's), and passes
    a run that does neither."""
    failed = pool.run(job_multichip_trajectory, how, timeout=TIMEOUT_S)
    if caught is None:
        assert failed == []
    else:
        assert any(caught in f for f in failed), failed
        if how == "update":
            assert not any("ranks' parameters differ" in f for f in failed), failed
