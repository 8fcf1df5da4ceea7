"""The port's legacy ConvSBS runner on the CPU: an end-to-end run whose best
checkpoint the JAX package reads, a run beside the JAX runner from the same
initial weights, and the flags it refuses until their slices land."""

import os

import click
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
    jparams, jacc = jrunner.run(**_common(tmp_path / "jax"), **kw, tb_log_every_n_epochs=0,
                                preempt_save=False, autotune_cache=False)
    tparams, tacc = trunner.run(**_common(tmp_path / "port"), **kw, device="cpu")
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


@pytest.mark.parametrize("name,off,flag,slice_", trunner.REFUSED)
def test_unported_flags_are_refused(tmp_path, name, off, flag, slice_):
    value = {"mesh_devices": 2, "distributed": "auto", "autotune_kernels": True,
             "autotune_cache": True, "export_artifact": str(tmp_path / "a.zip"),
             "resume_from": str(tmp_path / "state.npz"), "preempt_save": True,
             "profile_dir": str(tmp_path / "prof"), "tb_log_every_n_epochs": 10}[name]
    with pytest.raises(click.BadParameter, match="ROADMAP"):
        trunner.run(**_common(tmp_path), device="cpu", epochs=1, **{name: value})
    assert not os.path.exists(tmp_path / "run_info.txt")


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
