"""The port's EPS runner on the CPU: beside the JAX runner from one shared
init (and caught by a mutated gradient), on the fast layout and on the
reference layout (the xla backends), with the TB logging of batches and of
intermediate outputs beside the JAX runner's, and a profiled window; exact
resume and SIGTERM resume, train states crossing between the packages both
ways, the NaN stopper's replay, the early stopper, the flags it refuses,
its provenance, its log and checkpoints as the JAX package reads them.

The port's CPU tensors run the kernels' plain versions, the JAX runner its
default CPU backend, XLA; both float32. The kernels themselves are held
against the plain versions on the card (``chip_smoke.py``), where the
runner's own phase drives them.
"""

import os
import signal
import threading

import click
import jax
import numpy as np
import pytest
import torch

from dctn_tpu import models as jm
from dctn_tpu.cli import runner as jrunner
from dctn_tpu.train import loop as jloop
from dctn_tpu.train.checkpoint import load_pytree, save_pytree
from dctn_tpu.viz import load_records
from dctn_tpu_torch.cli import legacy_runner as tlegacy
from dctn_tpu_torch.cli import runner as trunner
from dctn_tpu_torch.interop import params_from_numpy, state_dict_from_eps_plus_linear_params
from dctn_tpu_torch.kernels import eps_kernels as K
from dctn_tpu_torch.models import (
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    eps_plus_linear_forward_fast,
    fast_params_from_reference,
    reference_params_from_fast,
)
from dctn_tpu_torch.train import (
    TrainLoopState,
    ValuesNotImprovingEarlyStopper,
    load_train_state,
    make_fast_train_step,
    make_gather_batch,
    make_optimizer,
    make_stopper_after_n_iters,
    make_stopper_on_nan_loss,
    every_n_iters_intervals,
    train,
    train_state_arrays,
)
from dctn_tpu_torch.train.checkpoint import flatten_tree

SPECS = ((2, 4), (2, 3))
IMAGE = {"fashionmnist": (28, 2), "cifar10_rgb": (32, 3)}  # (image size, Q₀)
# the two runners' shared recipe: Adam at weight decay 0.1, so that the
# update depends on the gradient's scale (Adam alone divides it out, and a
# mutated gradient would pass); 4 iterations, evals every 2
SHARED = dict(ds_path="synthetic", epses_specs=SPECS, batch_size=16, optimizer_name="adam",
              lr=3e-3, wd=0.1, synthetic_sizes=(64, 32, 32), eval_schedule=((None, 2),),
              max_num_iters=4, keep_last_models=2,
              init_epses_composition_unit_theoretical_output_std=True)
# each run's move from the shared init against the other's, per parameter,
# as a share of the largest move: float32 steps in other summation orders
# read ≤ 7.7e-6 (fashionmnist); layer 1's d_cmt ×1.001 reads 3.7e-4
MOVE_TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _out_dir(root) -> str:
    (sub,) = os.listdir(root)
    return os.path.join(root, sub)


def _reference(state):
    """A port run's final params in the reference layout, as numpy."""
    ref = state.extras["params_view"](state.params)
    return jax.tree_util.tree_map(lambda t: t.detach().numpy(), ref)


@pytest.fixture(scope="module")
def beside(tmp_path_factory):
    """``beside(ds_type)`` → (the flags, the shared init, the JAX run's params
    and out dir, the port's state and out dir): both runners from one npz
    of JAX-drawn weights, run once per ds_type and module, with
    ``--tb-batches`` and ``--log-intermediate-outputs`` (which leave the
    trajectory as it is); the port's run also traces iterations 1-2 into
    ``prof/`` beside its out dir."""
    done = {}

    def get(ds_type):
        if ds_type not in done:
            tmp = tmp_path_factory.mktemp(ds_type)
            size, q0 = IMAGE[ds_type]
            init = jm.init_eps_plus_linear(
                jax.random.PRNGKey(3),
                jm.EPSesPlusLinearConfig(epses_specs=SPECS, image_size=size, q0=q0),
            )
            init_file = str(tmp / "init.npz")
            save_pytree(init, init_file)
            kw = dict(SHARED, ds_type=ds_type, load_model_state=init_file, tb_batches=True,
                      log_intermediate_outputs=True)
            jstate = jrunner.run(experiments_dir=str(tmp / "jax"), autotune_cache=False, **kw)
            tstate = trunner.run(experiments_dir=str(tmp / "port"), device="cpu",
                                 profile_dir=str(tmp / "prof"), profile_iters=(1, 2), **kw)
            done[ds_type] = (kw, jax.tree_util.tree_map(np.asarray, init),
                             jax.tree_util.tree_map(np.asarray, jstate.params),
                             _out_dir(tmp / "jax"), tstate, _out_dir(tmp / "port"))
        return done[ds_type]

    return get


def _assert_moves_agree(init, jparams, tparams):
    """Every parameter's move agrees within MOVE_TOL of the largest."""
    leaves = jax.tree_util.tree_leaves
    for i, (t, j, s) in enumerate(zip(leaves(tparams), leaves(jparams), leaves(init))):
        moved_t, moved_j = t.astype(np.float64) - s, j.astype(np.float64) - s
        scale = float(np.abs(moved_j).max())
        assert scale > 1e-4, f"leaf {i} did not move"
        np.testing.assert_allclose(moved_t, moved_j, rtol=0, atol=MOVE_TOL * scale,
                                   err_msg=f"leaf {i}")


def _assert_runs_agree(init, jparams, tparams, jdir, tdir):
    """Every parameter's move agrees within MOVE_TOL of the largest; the
    eval lines within their printed precision (CE to 5 decimals, accuracy
    within one of the 32 validation images); the same checkpoints kept."""
    _assert_moves_agree(init, jparams, tparams)
    jrec, trec = (load_records(os.path.join(d, "log.log")) for d in (jdir, tdir))
    assert [r.nitd for r in trec] == [r.nitd for r in jrec] == [0, 2, 4]
    for a, b in zip(trec, jrec):
        assert abs(a.trmce - b.trmce) <= 1.5e-5 and abs(a.vmce - b.vmce) <= 1.5e-5, (a, b)
        assert abs(a.tracc - b.tracc) <= 1 / 32 + 1e-9 and abs(a.vacc - b.vacc) <= 1 / 32 + 1e-9

    def kept(d):
        return sorted(f.split("_tracc")[0] for f in os.listdir(d) if f.startswith("model"))

    assert kept(tdir) == kept(jdir)


@pytest.mark.parametrize("ds_type", ["fashionmnist", "cifar10_rgb"])
def test_runner_matches_the_jax_runner(beside, ds_type):
    """From one shared init, with the same seed (the same batches) and no
    dropout, 4 Adam steps of the port's runner and of the JAX runner agree
    (``_assert_runs_agree``), grayscale and colored (Q₀ = 3)."""
    _, init, jparams, jdir, tstate, tdir = beside(ds_type)
    assert tstate.stop_reason == "max_iters" and tstate.num_iters_done == 4
    _assert_runs_agree(init, jparams, _reference(tstate), jdir, tdir)


def test_a_mutated_dcore_fails_the_comparison(beside, tmp_path, monkeypatch):
    """Layer 1's d_cmt ×1.001 in every step (the plain version the port's
    CPU run takes) moves the run outside the comparison's tolerance."""
    kw, init, jparams, jdir, _, _ = beside("fashionmnist")
    plain = K.eps_dcore_reference
    out_1 = SPECS[1][1]

    def mutated(views_t, g, n1, out_size):
        d = plain(views_t, g, n1, out_size)
        return d * 1.001 if out_size == out_1 else d

    monkeypatch.setattr(K, "eps_dcore_reference", mutated)
    state = trunner.run(experiments_dir=str(tmp_path), device="cpu", **kw)
    with pytest.raises(AssertionError):
        _assert_runs_agree(init, jparams, _reference(state), jdir, _out_dir(tmp_path))


@pytest.mark.parametrize("ds_type", ["fashionmnist", "cifar10_rgb"])
def test_log_parses_and_checkpoints_load_in_the_jax_package(beside, ds_type):
    """log.log's eval lines parse with ``dctn_tpu.viz``; every checkpoint
    (last and best) loads in ``load_pytree`` with the JAX model's template
    and equals the final params where it was written at the end;
    run_info.txt has the flags and the commit, and the diff is beside it."""
    _, init, _, _, tstate, tdir = beside(ds_type)
    records = load_records(os.path.join(tdir, "log.log"))
    assert [r.nitd for r in records] == [0, 2, 4]
    template = jax.tree_util.tree_map(jax.numpy.asarray, init)
    files = os.listdir(tdir)
    assert sum(f.startswith("model_best_") for f in files) == 4
    final = _reference(tstate)
    for f in files:
        if f.startswith("model"):
            loaded = load_pytree(template, os.path.join(tdir, f))
            if f.startswith("model_nitd=0000004"):
                for a, b in zip(jax.tree_util.tree_leaves(loaded), jax.tree_util.tree_leaves(final)):
                    np.testing.assert_array_equal(np.asarray(a), b)
    import json

    with open(os.path.join(tdir, "run_info.txt")) as f:
        info = json.load(f)
    assert info["batch_size"] == 16 and info["device"] == "cpu" and info["commit"]
    assert "git_diff_with_HEAD.patch" in files and "train_state_latest.npz" in files


def _metrics(out_dir):
    import json

    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# the TB records of the two runs, float32 runs whose params agree within
# MOVE_TOL of their moves: each number within TB_RTOL of itself or TB_ATOL;
# the largest difference read 1.6e-6 of max(|value|, 1e-2) (fashionmnist,
# eps_1's histogram mean)
TB_RTOL, TB_ATOL = 2e-5, 1e-7


@pytest.mark.parametrize("ds_type", ["fashionmnist", "cifar10_rgb"])
def test_tb_records_match_the_jax_runner(beside, ds_type):
    """``--tb-batches`` and ``--log-intermediate-outputs`` write the JAX
    runner's records into metrics.jsonl: the same tags at the same
    iterations in the same order (loss, reg_term, the probabilities'
    histogram and, on grayscale images, the batch grid after the steps of
    iterations 0 and 2; every transform of eps_0, eps_1 and linear at the
    evals before iterations 0 and 2), each number within TB_RTOL or
    TB_ATOL; and the profiled window's trace is written."""
    _, _, _, jdir, _, tdir = beside(ds_type)
    jrec, trec = _metrics(jdir), _metrics(tdir)
    assert [(r["tag"], r["step"]) for r in trec] == [(r["tag"], r["step"]) for r in jrec]
    tags = {r["tag"] for r in trec}
    assert {"loss", "reg_term", "probs_of_true_class", "intermediate_dumb_mean/eps_0",
            "intermediate_dumb/eps_1", "intermediate_logits_as_probabilities/linear"} <= tags
    assert ("batch" in tags) == (ds_type == "fashionmnist")
    assert {r["step"] for r in trec} == {0, 2}
    for a, b in zip(trec, jrec):
        for k, v in b.items():
            if isinstance(v, float):
                assert a[k] == pytest.approx(v, rel=TB_RTOL, abs=TB_ATOL), (b["tag"], k)
            else:
                assert a[k] == v, (b["tag"], k)
    from dctn_tpu_torch.utils.profiling import trace_files

    (trace,) = trace_files(os.path.join(os.path.dirname(os.path.dirname(tdir)), "prof"))
    assert os.path.getsize(trace) > 0


@pytest.mark.parametrize("backends", [("xla", "xla"), ("pallas", "xla"), ("xla", "pallas")],
                         ids=["xla", "train_pallas_eval_xla", "train_xla_eval_pallas"])
def test_xla_backends_match_the_jax_runner(beside, tmp_path, backends):
    """``--train-backend xla`` trains the reference layout through the plain
    eps (``make_train_step``) and ``--eval-backend xla`` scores it, also
    for a fast-layout run: each pair ends within ``_assert_runs_agree`` of
    the JAX runner (whose CPU backend is XLA), and a run that trains on the
    fast layout ends on the bits of the beside run, whose evals differ only
    in their backend."""
    kw, init, jparams, jdir, tstate, _ = beside("fashionmnist")
    train_backend, eval_backend = backends
    state = trunner.run(experiments_dir=str(tmp_path), device="cpu", train_backend=train_backend,
                        eval_backend=eval_backend, **kw)
    got = _reference(state)
    _assert_runs_agree(init, jparams, got, jdir, _out_dir(tmp_path))
    if train_backend == "pallas":
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(_reference(tstate))):
            np.testing.assert_array_equal(a, b)


def test_train_states_cross_between_the_packages(beside, tmp_path):
    """The JAX runner's train state at iteration 2, resumed by the port to 4,
    and the port's, resumed by ``dctn_tpu.cli.runner.run`` to 4, each end
    within MOVE_TOL of the other package's unbroken run (no dropout: both
    take the seeded Batcher's batches). The port's file has the JAX key
    leaf ``rng`` (uint32, 2); the port resuming a JAX state with dropout on
    records that it cannot continue the JAX dropout stream."""
    kw, init, jparams, _, tstate, _ = beside("fashionmnist")
    kw = {k: v for k, v in kw.items() if k not in ("tb_batches", "log_intermediate_outputs")}
    two = dict(kw, max_num_iters=2)
    jrunner.run(experiments_dir=str(tmp_path / "jax2"), autotune_cache=False, **two)
    trunner.run(experiments_dir=str(tmp_path / "port2"), device="cpu", **two)
    jfile = os.path.join(_out_dir(tmp_path / "jax2"), "train_state_latest.npz")
    tfile = os.path.join(_out_dir(tmp_path / "port2"), "train_state_latest.npz")
    with np.load(tfile) as d:
        assert d["rng"].dtype == np.uint32 and d["rng"].shape == (2,) and int(d["step"]) == 2
    port_from_jax = trunner.run(experiments_dir=str(tmp_path / "p"), device="cpu", resume_from=jfile,
                                **kw)
    jax_from_port = jrunner.run(experiments_dir=str(tmp_path / "j"), autotune_cache=False,
                                resume_from=tfile, **kw)
    assert port_from_jax.num_iters_done == jax_from_port.num_iters_done == 4
    _assert_moves_agree(init, jparams, _reference(port_from_jax))
    _assert_moves_agree(init, jax.tree_util.tree_map(np.asarray, jax_from_port.params),
                        _reference(tstate))
    trunner.run(experiments_dir=str(tmp_path / "drop"), device="cpu", resume_from=jfile,
                **dict(kw, dropout_p=0.9, max_num_iters=3))
    with open(os.path.join(_out_dir(tmp_path / "drop"), "run_info.txt")) as f:
        assert "its dropout stream cannot be continued" in f.read()


COMMON = dict(ds_type="fashionmnist", ds_path="synthetic", epses_specs=SPECS, batch_size=16,
              optimizer_name="adam", lr=3e-3, wd=0.01, dropout_p=0.8, device="cpu",
              synthetic_sizes=(64, 32, 32), init_epses_composition_unit_empirical_output_std=True,
              init_epses_composition_unit_empirical_output_std_subset_size=64)


def _assert_bit_equal(a, b):
    for (k, x), y in zip(flatten_tree(a.params).items(), flatten_tree(b.params).values()):
        assert torch.equal(x, y), k


def test_resume_is_bit_equal(tmp_path):
    """With parameter dropout (p = 0.8) and weight decay: 12 iterations
    against 8 and a resume from the train state saved at 8 (an epoch is 4
    batches, so the batch stream is fast-forwarded across epochs) give the
    same bits; the file has the JAX runner's keys."""
    sched = dict(eval_schedule=((None, 4),))
    a = trunner.run(experiments_dir=str(tmp_path / "a"), max_num_iters=12, **sched, **COMMON)
    trunner.run(experiments_dir=str(tmp_path / "b"), max_num_iters=8, **sched, **COMMON)
    state_file = os.path.join(_out_dir(tmp_path / "b"), "train_state_latest.npz")
    with np.load(state_file) as d:
        assert int(d["step"]) == 8 and int(d["param_layout"]) == 1
        assert int(d["opt_state/1/count"]) == 8 and "generator_state" in d.files
        assert {"params/epses_cmt/0", "opt_state/1/mu/linear/w", "eps_splits"} <= set(d.files)
    c = trunner.run(experiments_dir=str(tmp_path / "c"), max_num_iters=12,
                    resume_from=state_file, **sched, **COMMON)
    assert c.num_iters_done == 12
    _assert_bit_equal(a, c)


def test_sigterm_saves_a_train_state_that_resumes_the_same_way(tmp_path):
    """SIGTERM under ``--preempt-save`` (the default) stops the loop with the
    train state saved; a resume from it 3 iterations on equals the unbroken
    run to the same step, bit for bit."""
    prev = signal.signal(signal.SIGTERM, lambda *a: None)  # a late kill stays harmless
    try:
        stop_killing = threading.Event()

        def killer():
            while not stop_killing.wait(0.5):
                os.kill(os.getpid(), signal.SIGTERM)

        t = threading.Thread(target=killer, daemon=True)
        t.start()
        state = trunner.run(experiments_dir=str(tmp_path / "a"), max_num_iters=10**6,
                            eval_schedule=((None, 10**6),), **COMMON)
        stop_killing.set()
        t.join(5)
        assert not t.is_alive()
    finally:
        signal.signal(signal.SIGTERM, prev)
    assert state.stop_reason.startswith("preempted (SIGTERM)")
    state_file = os.path.join(_out_dir(tmp_path / "a"), "train_state_latest.npz")
    with np.load(state_file) as d:
        saved = int(d["step"])
    assert 0 < saved <= state.num_iters_done + 1
    target = saved + 3
    b = trunner.run(experiments_dir=str(tmp_path / "b"), max_num_iters=target, resume_from=state_file,
                    eval_schedule=((None, 1),), **COMMON)
    c = trunner.run(experiments_dir=str(tmp_path / "c"), max_num_iters=target,
                    eval_schedule=((None, target),), **COMMON)
    assert b.num_iters_done == c.num_iters_done == target
    _assert_bit_equal(b, c)


def _np_params(image_size=8, seed=0):
    """Reference-layout params of ``SPECS`` drawn with numpy (a JAX draw
    compiles a sampler per shape), as numpy arrays."""
    rng = np.random.default_rng(seed)
    h = image_size - 2
    return {"epses": (rng.normal(size=(2,) * 4 + (4,)) * 0.25,
                      rng.normal(size=(4,) * 4 + (3,)) / 16),
            "linear": {"w": rng.normal(size=(h * h * 3, 10)) * 0.05,
                       "b": rng.uniform(-0.05, 0.05, size=(10,))}}


@pytest.mark.parametrize("saved_as", ["reference layout", "other splits", "untagged splits"])
def test_train_state_saved_in_another_layout_is_converted(tmp_path, saved_as):
    """A train state whose params and Adam moments are in the reference
    layout (``param_layout`` 0), in the fast layout under other matmul
    splits (``eps_splits`` [4, 2]; the current ones are [4, 3]), or untagged
    (the legacy split rule's [4, 4]) loads into the fast model as the same
    numbers, permuted."""
    cfg = EPSesPlusLinearConfig(epses_specs=SPECS, image_size=8, q0=2)
    np_params = _np_params()
    model = EPSesPlusLinear.from_reference(params_from_numpy(np_params, dtype=torch.float32), cfg)
    assert [p["n1"] for p in model.plans] == [4, 3]
    opt = make_optimizer("adam", model.parameters(), 1e-2)
    step = make_fast_train_step(model, opt)
    x = torch.rand((1, 8, 8, 8, 2), generator=torch.Generator().manual_seed(0))
    for _ in range(2):
        step(x, torch.arange(8))
    saved = train_state_arrays(model, opt, 2, model.plans)
    splits = {"reference layout": None, "other splits": [4, 2], "untagged splits": [4, 4]}[saved_as]
    out = {"step": np.int64(2), "opt_state/0/count": np.int32(2),
           "param_layout": np.int32(0 if splits is None else 1)}
    if saved_as == "other splits":
        out["eps_splits"] = np.asarray(splits, np.int32)
    for group in ("params", "opt_state/0/mu", "opt_state/0/nu"):
        fast = {"epses_cmt": tuple(saved[f"{group}/epses_cmt/{i}"] for i in range(2)),
                "linear": {k: saved[f"{group}/linear/{k}"] for k in "wb"}}
        tree = reference_params_from_fast(fast, cfg, model.plans)
        if splits is not None:
            plans = tuple({**p, "n1": n1} for p, n1 in zip(model.plans, splits))
            tree = fast_params_from_reference(tree, cfg, plans)[0]
        out.update({f"{group}/{k}": v.detach().numpy() for k, v in flatten_tree(tree).items()})
    path = str(tmp_path / "state.npz")
    np.savez(path, **out)
    fresh = EPSesPlusLinear.from_reference(params_from_numpy(np_params, dtype=torch.float32), cfg)
    fresh_opt = make_optimizer("adam", fresh.parameters(), 1e-2)
    assert load_train_state(path, fresh, fresh_opt, cfg, fresh.plans) == 2
    for p, q in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(opt.state[p][key], fresh_opt.state[q][key]), key


def test_nan_replay_dumps_the_triggering_batch(tmp_path):
    """One poisoned sample makes the loss non-finite at iteration 1; the
    stopper reads the flag at iteration 5 and its replay dumps iteration 1's
    batch with the params from before its update (JAX's
    ``test_nan_replay_isolates_triggering_batch``, on the port)."""
    cfg = EPSesPlusLinearConfig(epses_specs=SPECS, image_size=8, q0=2)
    init = _np_params()

    def fresh():
        model = EPSesPlusLinear.from_reference(params_from_numpy(init, dtype=torch.float32), cfg)
        opt = make_optimizer("sgd", model.parameters(), 1e-2)
        return model, opt, make_fast_train_step(model, opt)

    model, opt, step = fresh()
    x = torch.rand((1, 64, 8, 8, 2), generator=torch.Generator().manual_seed(0))
    x[:, 13] = 1e30
    gather = make_gather_batch(x, torch.arange(64) % 10)

    def forward(fast, xb):
        return eps_plus_linear_forward_fast(fast, xb, cfg, model.plans)

    def view(fast):
        return reference_params_from_fast(fast, cfg, model.plans)

    nan_hook = make_stopper_on_nan_loss(str(tmp_path), forward, params_view=view,
                                        replay_step=step, replay_gather=gather)
    state = TrainLoopState(params=model.fast_params(), opt_state=opt, rng=None)
    nan_hook.enable_replay(state)

    def stream():  # step i takes samples [8i, 8i + 8): sample 13 is in step 1
        i = 0
        while True:
            yield torch.arange(8 * i, 8 * i + 8) % 64
            i += 1

    train(state, step, gather, stream(), at_iter_start=[make_stopper_after_n_iters(50)],
          after_step=[every_n_iters_intervals((None, 5))(nan_hook)])
    assert state.stop_reason == "nan_loss" and state.num_iters_done == 5
    dump = os.path.join(str(tmp_path), "nan_loss_stop")
    assert "model_nitd=1.npz" in os.listdir(dump)
    assert "TRIGGERING iteration: 1" in open(os.path.join(dump, "README.txt")).read()
    np.testing.assert_array_equal(np.load(os.path.join(dump, "batch_indices.npy")), np.arange(8, 16))
    assert np.load(os.path.join(dump, "batch.npz"))["x"].max() >= 1e29
    assert np.load(os.path.join(dump, "output.npy")).shape == (8, 10)
    model0, _, step0 = fresh()
    step0(*gather(torch.arange(8)))
    want = flatten_tree(view(model0.fast_params()))
    with np.load(os.path.join(dump, "model_nitd=1.npz")) as got:
        assert sorted(got.files) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v.detach().numpy(), err_msg=k)


def test_early_stopper_stops_where_jax_stops():
    """The same metric sequences stop both packages' early stoppers at the
    same call, with the same reason."""
    keys = (("val_acc", False), ("val_mean_ce", True))
    seq = [(0.5, 2.0), (0.6, 1.9), (0.55, 1.95), (0.58, 1.91), (0.62, 2.1), (0.6, 2.0),
           (0.61, 1.95), (0.6, 1.92)]
    stopped = []
    for stopper, state in (
        (ValuesNotImprovingEarlyStopper(2, keys), TrainLoopState(None, None, None)),
        (jloop.ValuesNotImprovingEarlyStopper(2, keys), jloop.TrainLoopState(None, None, None)),
    ):
        for i, (acc, ce) in enumerate(seq):
            state.num_iters_done = i
            state.iter_metrics = {"val_acc": acc, "val_mean_ce": ce}
            stopper(state)
            if state.stop:
                break
        stopped.append((state.num_iters_done, state.stop_reason))
    assert stopped[0] == stopped[1] == (7, "early_stopping")


_REFUSED_VALUES = {
    "mesh_devices": 2, "model_devices": 2, "space_devices": 2, "tp_shard_all": True,
    "distributed": "auto", "autotune_splits": True, "autotune_cache": True, "qat": "int8",
}


@pytest.mark.parametrize("name,accepted,flag,where", trunner.REFUSED,
                         ids=[r[0] for r in trunner.REFUSED])
def test_unported_flags_are_refused(tmp_path, name, accepted, flag, where):
    """Each flag the port does not run yet beside ``--compute-dtype
    bfloat16`` is refused with it before the run starts, naming its ROADMAP
    item."""
    with pytest.raises(click.BadParameter, match=r"ROADMAP, .*(item|follow-up) \d+"):
        trunner.run(experiments_dir=str(tmp_path), max_num_iters=1,
                    **{**COMMON, "compute_dtype": "bfloat16", name: _REFUSED_VALUES[name]})
    assert not os.listdir(tmp_path)


def test_flag_validation_and_the_device(tmp_path):
    """Flag conflicts name the flags (``test_flag_validation_messages`` of
    the JAX runner), and ``--device cuda`` without a card is refused, not
    run on the CPU."""
    base = {**COMMON, "init_epses_composition_unit_empirical_output_std": False}
    with pytest.raises(click.BadParameter, match="exactly one initialization family"):
        trunner.run(experiments_dir=str(tmp_path), **base)
    with pytest.raises(click.BadParameter, match="colored CIFAR"):
        trunner.run(experiments_dir=str(tmp_path), **{**COMMON, "nu_per_channel": (0.5, 0.5, 0.5)})
    with pytest.raises(click.BadParameter, match="cover EVERY eps"):
        trunner.run(experiments_dir=str(tmp_path), **base,
                    init_eps_zero_centered_normal_std=((0, 0.1),))
    with pytest.raises(click.BadParameter, match="--freeze-eps"):
        trunner.run(experiments_dir=str(tmp_path), **{**COMMON, "freeze_eps": (2,)})
    with pytest.raises(click.BadParameter, match="--grad-accum-steps"):
        trunner.run(experiments_dir=str(tmp_path), **{**COMMON, "grad_accum_steps": "3"})
    with pytest.raises(click.BadParameter, match="--qat int8 runs on the fast"):
        trunner.run(experiments_dir=str(tmp_path), **{**COMMON, "qat": "int8",
                                                      "train_backend": "xla"})
    if not torch.cuda.is_available():
        with pytest.raises(click.BadParameter, match="no CUDA device"):
            trunner.run(experiments_dir=str(tmp_path), **{**COMMON, "device": "cuda"})
    assert not os.listdir(tmp_path)
    with pytest.raises(click.BadParameter, match="over the 64 training images"):
        trunner.run(experiments_dir=str(tmp_path / "big"), **{**COMMON, "batch_size": 128})


def test_load_model_state_takes_a_reference_state_dict(tmp_path):
    """``--load-model-state`` with a reference ``torch.save(state_dict)``
    file: at learning rate 0 the run ends on exactly the loaded weights,
    and its last checkpoint is them in the reference layout."""
    np_params = jax.tree_util.tree_map(lambda a: a.astype(np.float32), _np_params(28, seed=4))
    pt = str(tmp_path / "reference.pt")
    torch.save(state_dict_from_eps_plus_linear_params(np_params), pt)
    state = trunner.run(experiments_dir=str(tmp_path / "run"), max_num_iters=2,
                        load_model_state=pt, eval_schedule=((None, 2),),
                        **{**COMMON, "lr": 0.0, "wd": 0.0})
    got = _reference(state)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(np_params)):
        np.testing.assert_array_equal(a, b)


def test_legacy_runner_writes_the_shared_provenance(tmp_path):
    """The legacy runner's run_info.txt has the commit, the diff is beside
    it, and a performance fallback the run records lands in it."""
    import json

    from dctn_tpu_torch.utils import fallbacks

    tlegacy.run(ds_path="synthetic", models_dir=str(tmp_path), num_sbs_layers=2, bond_dim_size=2,
                batch_size=32, synthetic_sizes=(64, 32), epochs=1, warmup_num_epochs=0,
                device="cpu")
    fallbacks.record("a fallback recorded after setup")
    with open(tmp_path / "run_info.txt") as f:
        text = f.read()
    info = json.loads(text[: text.rindex("}") + 1])
    assert info["commit"] and info["bond_dim_size"] == 2
    assert "performance_fallback: a fallback recorded after setup" in text
    assert os.path.exists(tmp_path / "git_diff_with_HEAD.patch")
    fallbacks.reset()
