"""The port's ``viz`` (``dctn_tpu_torch/viz/``) against the JAX package's
(``dctn_tpu/viz/``) on the same log files: one ``log.log`` written by the
port's EPS runner and one by the JAX runner. The records, the running-max
filter, the plot config of the experiments directory and both HTML
dashboards must come out the same."""

import os

import pytest
import torch

from dctn_tpu_torch.cli import runner as trunner
from dctn_tpu_torch.viz import Record, get_increasing_subsequence, load_records
from dctn_tpu_torch.viz.interactive import render_interactive_dashboard
from dctn_tpu_torch.viz.make_plot_config import make_plot_config, split_shared_varying
from dctn_tpu_torch.viz.plotting import render_dashboard

RUN = dict(ds_type="fashionmnist", ds_path="synthetic", epses_specs=((2, 3),),
           batch_size=16, optimizer_name="adam", lr=3e-3, synthetic_sizes=(64, 32, 32),
           eval_schedule=((None, 1),), max_num_iters=3, keep_last_models=1,
           init_epses_composition_unit_theoretical_output_std=True)


@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    """An experiments directory holding a run of each runner, and the
    JAX package's viz."""
    import dctn_tpu.viz.interactive as jinteractive
    import dctn_tpu.viz.log_parsing as jlog
    import dctn_tpu.viz.make_plot_config as jconfig
    import dctn_tpu.viz.plotting as jplotting
    from dctn_tpu.cli import runner as jrunner

    root = tmp_path_factory.mktemp("experiments")
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        trunner.run(experiments_dir=str(root / "port"), device="cpu", **RUN)
    finally:
        torch.set_num_threads(threads)
    jrunner.run(experiments_dir=str(root / "jax"), autotune_cache=False, **RUN)
    logs = [os.path.join(root, d, sub, "log.log") for d in ("port", "jax")
            for sub in os.listdir(root / d)]
    return root, logs, (jlog, jconfig, jplotting, jinteractive)


@pytest.mark.parametrize("increasing", [False, True])
def test_records_of_both_runners_logs_equal_jax(experiments, increasing):
    _, logs, (jlog, *_) = experiments
    for log in logs:
        got = load_records(log, increasing)
        want = jlog.load_records(log, increasing)
        assert [tuple(vars(r).values()) for r in got] == [tuple(vars(r).values()) for r in want]
        if not increasing:
            assert [r.nitd for r in got] == [0, 1, 2, 3]


def test_increasing_subsequence_equals_jax(experiments):
    _, _, (jlog, *_) = experiments
    xs = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 9, 10]
    assert get_increasing_subsequence(xs) == jlog.get_increasing_subsequence(xs)
    recs = [Record(i, 0.0, 0.0, a, 0.0) for i, a in enumerate((0.1, 0.3, 0.2, 0.3, 0.5))]
    assert ([r.nitd for r in get_increasing_subsequence(recs, lambda r: r.tracc)]
            == [r.nitd for r in jlog.get_increasing_subsequence(recs, lambda r: r.tracc)]
            == [0, 1, 4])


def test_plot_config_and_dashboards_equal_jax(experiments, tmp_path):
    """``make_plot_config`` of each runner's experiments directory and of
    one holding both, then the interactive and the static (matplotlib)
    dashboards of the config, byte for byte."""
    root, logs, (_, jconfig, jplotting, jinteractive) = experiments
    both = tmp_path / "both"
    both.mkdir()
    for log in logs:
        run_dir = os.path.dirname(log)
        os.symlink(run_dir, both / f"{os.path.basename(os.path.dirname(run_dir))}-run")
    for d in (root / "port", root / "jax", both):
        config = make_plot_config(str(d), title="runs", subset=1 if d == both else None)
        assert config == jconfig.make_plot_config(str(d), title="runs",
                                                  subset=1 if d == both else None)
    config = make_plot_config(str(both))
    assert config == jconfig.make_plot_config(str(both)) and len(config["experiments"]) == 2
    infos = {"a": {"lr": 1, "seed": 0}, "b": {"lr": 2, "seed": 0}}
    assert split_shared_varying(infos) == jconfig.split_shared_varying(infos)
    for render, jrender, name in ((render_interactive_dashboard,
                                   jinteractive.render_interactive_dashboard, "interactive"),
                                  (render_dashboard, jplotting.render_dashboard, "static")):
        got, want = tmp_path / f"{name}.html", tmp_path / f"{name}_jax.html"
        render(config, str(got), increasing_tracc=True)
        jrender(config, str(want), increasing_tracc=True)
        assert got.read_bytes() == want.read_bytes()
        assert len(got.read_bytes()) > 1000
