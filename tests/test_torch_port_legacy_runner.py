"""The port's legacy ConvSBS runner on the CPU: an end-to-end run whose best
checkpoint the JAX package reads, a run beside the JAX runner from the same
initial weights with both runners' TB logging, resumes (at an epoch's end,
mid-epoch, and after SIGTERM) bit-equal to the unbroken run, and the flags
it refuses until their slices land."""

import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctn_tpu.cli import legacy_runner as jrunner
from dctn_tpu.models import conv_sbs_model as jm
from dctn_tpu.train.checkpoint import load_pytree, save_pytree
from dctn_tpu_torch.cli import legacy_runner as trunner
from dctn_tpu_torch.data import io as data_io
from dctn_tpu_torch.interop import conv_sbs_params_from_numpy
from dctn_tpu_torch.models import conv_sbs_model as tm

SIZES = (128, 64)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _common(tmp, **kw):
    return dict(ds_path="synthetic", models_dir=str(tmp), num_sbs_layers=2, bond_dim_size=2,
                batch_size=32, synthetic_sizes=SIZES, seed=0, **kw)


def test_end_to_end_run_writes_a_checkpoint_jax_reads(tmp_path):
    params, best_acc = trunner.run(
        **_common(tmp_path), device="cpu", trace_edge=True, optimizer_type="rmsprop",
        learning_rate=3e-3, momentum=0.5, epochs=2, warmup_num_epochs=1,
        warmup_initial_multiplier=1e-2, make_input_window_std_one=True,
        scale_layers_using_batch=64, early_stopping_patience_num_epochs=3,
    )
    files = os.listdir(tmp_path)
    assert "run_info.txt" in files and "log.log" in files
    best = [f for f in files if f.startswith("dctn_epoch=") and f.endswith(".npz")]
    assert len(best) == 1 and 0.0 <= best_acc <= 1.0
    assert best[0].endswith(f"_vacc={best_acc:.4f}.npz")
    template = jm.init_conv_sbs_model(
        jax.random.PRNGKey(0), jm.ConvSBSModelConfig(2, 2, trace_edge=True)
    )
    loaded = load_pytree(template, str(tmp_path / best[0]))
    leaves = jax.tree_util.tree_leaves(loaded)
    assert len(leaves) == sum(len(s) for layer in params for s in layer)
    assert all(bool(jnp.all(jnp.isfinite(a))) for a in leaves)


def test_ring_bond_5_outside_the_kernels_scope_trains_on_cpu(tmp_path):
    """``--trace-edge --bond-dim-size 5`` (outside the CUDA kernels' scope,
    refused on the card) trains on the CPU on the plain folds, as the JAX
    runner trains it on its XLA fold; its checkpoint loads in the JAX
    package."""
    kw = _common(tmp_path)
    kw["bond_dim_size"] = 5
    params, best_acc = trunner.run(
        **kw, device="cpu", trace_edge=True, optimizer_type="sgd", learning_rate=1e-3,
        epochs=1, warmup_num_epochs=0, make_input_window_std_one=True,
        scale_layers_using_batch=64,
    )
    best = [f for f in os.listdir(tmp_path) if f.startswith("dctn_epoch=")]
    assert len(best) == 1 and 0.0 <= best_acc <= 1.0
    template = jm.init_conv_sbs_model(
        jax.random.PRNGKey(0), jm.ConvSBSModelConfig(2, 5, trace_edge=True)
    )
    leaves = jax.tree_util.tree_leaves(load_pytree(template, str(tmp_path / best[0])))
    assert [a.shape for a in leaves] == [tuple(c.shape) for layer in params for s in layer
                                         for c in s]
    assert all(bool(jnp.all(jnp.isfinite(a))) for a in leaves)


def _split():
    """The runners' train pixels and validation split of the synthetic data
    (seed 0)."""
    images, labels = data_io.synthetic_mnist_like(sum(SIZES), seed=1234)
    order = np.random.default_rng(0).permutation(len(images))
    tr, val = order[: SIZES[0]], order[SIZES[0]:]
    return images[tr], torch.from_numpy(images[val]).double(), torch.from_numpy(labels[val])


@pytest.mark.parametrize("optimizer_type,momentum", [("sgd", 0.9), ("rmsprop", 0.9)])
def test_one_epoch_beside_the_jax_runner(tmp_path, optimizer_type, momentum):
    """Both runners start from one npz of initial weights with the same
    seed, so they draw the same split and batches, and both take the recipe
    that gives logits of order 1 (``--make-input-window-std-one``,
    ``--scale-layers-using-batch 64``). One epoch is 4 steps, lr 1e-2 (SGD)
    or 1e-3 (RMSprop), no warmup. Each run's move from its scaled start (each package's
    ``scale_layers_using_batch`` on the same 64 images, as its runner does)
    is over 1e-5 of the core's largest entry in every core, a hundred
    float32 roundings, and the two moves agree within 5e-3 of their largest
    entry: the smallest moves (layer 1's under SGD, 4e-5 of max|p|) carry
    float32 rounding of up to ~2e-3 of themselves; read 5.1e-4 (SGD) and
    3.8e-5 (RMSprop). The weights agree within float32 rounding (rtol 1e-4
    with atol 1e-6: the steps' float32 sums are taken in other orders and
    momentum carries each difference on), the validation CE within rtol
    1e-5 (computed from each run's weights by the same float64 forward) and
    the accuracy within one of the 64 images."""
    cfg = jm.ConvSBSModelConfig(2, 2)
    init = jm.init_conv_sbs_model(jax.random.PRNGKey(3), cfg)
    init_file = str(tmp_path / "init.npz")
    save_pytree(init, init_file)
    kw = dict(init_load_file=init_file, epochs=1, warmup_num_epochs=0,
              learning_rate={"sgd": 1e-2, "rmsprop": 1e-3}[optimizer_type],
              optimizer_type=optimizer_type, momentum=momentum,
              make_input_window_std_one=True, scale_layers_using_batch=64)
    jparams, jacc = jrunner.run(**_common(tmp_path / "jax"), **kw, tb_log_every_n_epochs=1,
                                preempt_save=False, autotune_cache=False)
    tparams, tacc = trunner.run(**_common(tmp_path / "port"), **kw, tb_log_every_n_epochs=1,
                                device="cpu")
    x_tr, x_val, y_val = _split()
    jstd = float(jax.jit(jm.calc_std_of_coordinates_of_windows, static_argnums=(1, 2, 3))(
        jnp.asarray(x_tr), 3, False, 1.0))
    std = float(tm.calc_std_of_coordinates_of_windows(torch.from_numpy(x_tr), 3, False, 1.0))
    jcfg = jm.ConvSBSModelConfig(2, 2, input_multiplier=jstd ** (-1.0 / 9.0))
    tcfg = tm.ConvSBSModelConfig(2, 2, input_multiplier=std ** (-1.0 / 9.0))
    jstart = jm.scale_layers_using_batch(init, jcfg, jnp.asarray(x_tr[:64]))
    tstart = tm.scale_layers_using_batch(
        conv_sbs_params_from_numpy(jax.tree_util.tree_map(np.asarray, init)), tcfg,
        torch.from_numpy(x_tr[:64]),
    )
    leaves = jax.tree_util.tree_leaves
    for i, (a, b, a0, b0) in enumerate(zip(leaves(tparams), leaves(jparams), leaves(tstart),
                                           leaves(jstart))):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        moved_t, moved_j = a - a0.numpy(), b - np.asarray(b0, np.float64)
        scale = float(np.abs(b).max())
        assert float(np.abs(moved_t).max()) > 1e-5 * scale, f"core {i} did not move"
        np.testing.assert_allclose(moved_t, moved_j, rtol=0.0,
                                   atol=5e-3 * float(np.abs(moved_j).max()), err_msg=f"core {i}")
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=f"core {i}")
    scores = []
    for p in (tparams, jax.tree_util.tree_map(np.asarray, jparams)):
        p64 = conv_sbs_params_from_numpy(jax.tree_util.tree_map(np.asarray, p), dtype=torch.float64)
        logits = tm.conv_sbs_model_forward_t(p64, tcfg, x_val)
        scores.append((float(torch.nn.functional.cross_entropy(logits, y_val)),
                       float((logits.argmax(1) == y_val).double().mean())))
    (ce_t, acc_t), (ce_j, acc_j) = scores
    assert ce_t == pytest.approx(ce_j, rel=1e-5)
    assert abs(acc_t - acc_j) <= 1 / SIZES[1] and abs(tacc - jacc) <= 1 / SIZES[1]
    _assert_tb_records_agree(tmp_path / "port", tmp_path / "jax")


def _records(d):
    with open(os.path.join(d, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# the TB records of the two runners after an epoch (float32 runs whose
# weights agree within rtol 1e-4): every number within TB_RTOL of
# max(|value|, TB_FLOOR); the largest difference read 5.1e-5 (SGD, a probe
# gradient's histogram max) and 3.0e-5 (RMSprop)
TB_RTOL, TB_FLOOR = 5e-4, 1e-3


def _assert_tb_records_agree(tdir, jdir):
    """``--tb-log-every-n-epochs 1`` writes the JAX runner's records: the
    same tags at the same iteration in the same order (the validation
    metrics, the last batch's loss, the lr, the weights' and the probe
    gradients' histograms by ``{layer}/{string}/{core}``, every transform
    of each string's output, each string's TT mean and std)."""
    trec, jrec = _records(tdir), _records(jdir)
    assert [(r["tag"], r["step"]) for r in trec] == [(r["tag"], r["step"]) for r in jrec]
    tags = {r["tag"] for r in trec}
    assert {"lr", "val/acc", "weights/1/0/8", "grads_std/0/1/4", "layer1.string0/tt_std",
            "intermediate_dumb_mean/layer0.string1"} <= tags
    for a, b in zip(trec, jrec):
        for k, v in b.items():
            if isinstance(v, float):
                assert abs(a[k] - v) <= TB_RTOL * max(abs(v), TB_FLOOR), (b["tag"], k, a[k], v)


def test_conv_sbs_bench_runs_on_cpu_and_reports_its_fields():
    """The bench's ConvSBS step on the CPU (the plain versions), open and
    ring, both paths; its records count the ConvSBS kernels only."""
    from dctn_tpu_torch import bench

    for trace_edge in (False, True):
        recs = bench.run_conv_sbs(device="cpu", steps=1, warmup=1, batch_size=2,
                                  trace_edge=trace_edge, compare_plain=True)
        assert [r["path"] for r in recs] == ["kernel", "plain"]
        for r in recs:
            assert r["trace_edge"] == trace_edge and r["batch_size"] == 2
            assert np.isfinite([r["first_loss"], r["last_loss"], r["images_per_s"]]).all()
            assert set(r["launches_per_step"]) == {name for name, _, _ in bench.SBS_COUNTERS}


def test_init_load_file_takes_a_reference_state_dict(tmp_path):
    """``--init-load-file`` with a reference ``torch.save(state_dict)``
    file: at learning rate 0 the run returns exactly the loaded cores."""
    from dctn_tpu_torch.interop import state_dict_from_conv_sbs_params

    np_params = jax.tree_util.tree_map(
        np.asarray, jm.init_conv_sbs_model(jax.random.PRNGKey(5), jm.ConvSBSModelConfig(2, 2))
    )
    pt = str(tmp_path / "reference.pt")
    torch.save(state_dict_from_conv_sbs_params(np_params), pt)
    params, _ = trunner.run(**_common(tmp_path / "run"), device="cpu", init_load_file=pt,
                            epochs=1, learning_rate=0.0)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(np_params)):
        assert np.array_equal(a.numpy(), b)


def _recipe(tmp, **kw):
    """RMSprop with momentum under a 2-epoch warmup (every piece of the
    optimizer's state and the warmup's step matter on resume), 4 steps an
    epoch."""
    return dict(_common(tmp), device="cpu", optimizer_type="rmsprop", momentum=0.5,
                learning_rate=3e-3, warmup_num_epochs=2, warmup_initial_multiplier=1e-2,
                make_input_window_std_one=True, scale_layers_using_batch=64, **kw)


def _assert_same_bits(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        assert torch.equal(x, y)


class _FiresAfter(trunner.PreemptionHandler):
    """A preemption handler whose signal is seen after the ``n``-th step."""

    def __init__(self, n):
        super().__init__()
        self.reads = 0
        self.n = n

    @property
    def fired(self):
        self.reads += 1
        return "SIGTERM" if self.reads >= self.n else None

    @fired.setter
    def fired(self, value):
        pass


def test_resume_at_an_epoch_end_and_mid_epoch_is_bit_equal(tmp_path, monkeypatch):
    """Three epochs unbroken; one epoch, then resumed to three from its train
    state; and a run stopped after step 6 (mid-epoch 1: the state says
    epoch 1, step 2) resumed to three: all end on the same bits with the
    same best accuracy, and the state file has the JAX keys."""
    unbroken, acc = trunner.run(**_recipe(tmp_path / "a", epochs=3))
    trunner.run(**_recipe(tmp_path / "b", epochs=1))
    state = str(tmp_path / "b" / "train_state_latest.npz")
    with np.load(state) as d:
        assert int(d["epoch"]) == 1 and int(d["step_in_epoch"]) == 0
        assert {"params/1/0/8", "best_acc", "bad_epochs", "warmup_step",
                "torch_opt_state/0/square_avg", "torch_opt_state/0/momentum_buffer"} <= set(d.files)
    resumed, acc_b = trunner.run(**_recipe(tmp_path / "c", epochs=3), resume_from=state)
    _assert_same_bits(unbroken, resumed)
    monkeypatch.setattr(trunner, "PreemptionHandler", lambda: _FiresAfter(6))
    trunner.run(**_recipe(tmp_path / "d", epochs=3))
    monkeypatch.undo()
    state = str(tmp_path / "d" / "train_state_latest.npz")
    with np.load(state) as d:
        assert (int(d["epoch"]), int(d["step_in_epoch"]), int(d["warmup_step"])) == (1, 2, 6)
    mid, acc_d = trunner.run(**_recipe(tmp_path / "e", epochs=3), resume_from=state)
    _assert_same_bits(unbroken, mid)
    assert acc == acc_b == acc_d


def test_sigterm_saves_a_train_state_that_resumes_the_same_way(tmp_path):
    """A real SIGTERM under ``--preempt-save`` (the default) stops the run
    after the step in flight with the train state saved; resumed to the
    epoch after the one it stopped in, it ends on the bits of an unbroken
    run to that epoch."""
    prev = signal.signal(signal.SIGTERM, lambda *a: None)  # a late kill stays harmless
    try:
        stop_killing = threading.Event()

        def killer():
            while not stop_killing.wait(0.5):
                os.kill(os.getpid(), signal.SIGTERM)

        t = threading.Thread(target=killer, daemon=True)
        t.start()
        trunner.run(**_recipe(tmp_path / "a", epochs=10**6, tb_log_every_n_epochs=0))
        stop_killing.set()
        t.join(5)
        assert not t.is_alive()
    finally:
        signal.signal(signal.SIGTERM, prev)
    state = str(tmp_path / "a" / "train_state_latest.npz")
    with np.load(state) as d:
        target = int(d["epoch"]) + 2
    resumed, _ = trunner.run(**_recipe(tmp_path / "b", epochs=target, tb_log_every_n_epochs=0),
                             resume_from=state)
    unbroken, _ = trunner.run(**_recipe(tmp_path / "c", epochs=target, tb_log_every_n_epochs=0))
    _assert_same_bits(unbroken, resumed)
