"""Both runners of the port data parallel on the CPU (``--mesh-devices 2``,
``gloo`` ranks): beside the JAX runners at ``--mesh-devices 2`` (the
conftest's virtual devices, xla backends) from one shared init; two host
processes of one rank each under ``--distributed``; SIGTERM to one rank
stopping both at one step, with one train state, resumed bit-equal;
resumes on the same rank count (bit-equal) and elastic ones (2 → 1,
1 → 2), a JAX DP train state resumed by the port; ``predict
--mesh-devices 2`` and a sharded artifact on two CPU replicas; the
refusals.

Runs that need no ``spawn`` of their own go through a module-wide pool of
two ranks (``_run_rank`` of each runner, as ``run`` calls it in every
rank). This module imports no JAX at import: the ranks import it.

Tolerances: ``MOVE_TOL`` 5e-5 of the largest move against the JAX runner
(float32 steps in other summation orders, as in
``tests/test_torch_port_runner.py``); the legacy runner's weights within
rtol 1e-4, atol 1e-6 of JAX's (as ``test_one_epoch_beside_the_jax_runner``);
the rest bit for bit.
"""

import os
import re
import signal
import socket
import subprocess
import sys
import time

import click
import numpy as np
import pytest
import torch

from dctn_tpu_torch.cli import export, predict, serve
from dctn_tpu_torch.cli import legacy_runner as tlegacy
from dctn_tpu_torch.cli import runner as trunner
from dctn_tpu_torch.cli.specs import fill_defaults
from dctn_tpu_torch.parallel import plan_job
from dctn_tpu_torch.parallel.mesh import Host, Job
from torch_port_rank_pool import RankPool
from dctn_tpu_torch.train.checkpoint import load_params_npz

SPECS = ((2, 4), (2, 3))
RANKS = 2
MOVE_TOL = 5e-5
TIMEOUT_S = 180
# the JAX runner's DP step from the shared init: Adam at weight decay 0.1
# (a mutated gradient's scale shows), evals every 2 of 4 iterations
SHARED = dict(ds_type="fashionmnist", ds_path="synthetic", epses_specs=SPECS, batch_size=16,
              optimizer_name="adam", lr=3e-3, wd=0.1, synthetic_sizes=(64, 32, 32),
              eval_schedule=((None, 2),), max_num_iters=4, keep_last_models=2,
              init_epses_composition_unit_theoretical_output_std=True)
# the quick runs of the resumes and the subprocesses
QUICK = dict(ds_type="fashionmnist", ds_path="synthetic", epses_specs=SPECS, batch_size=16,
             optimizer_name="adam", lr=3e-3, synthetic_sizes=(64, 32, 32),
             eval_schedule=((None, 4),), keep_last_models=1, patience=100,
             init_epses_composition_unit_theoretical_output_std=True, device="cpu")


def job_eps_run(mesh, kw):
    """One rank of the EPS runner, as ``run`` starts it."""
    kw = fill_defaults(trunner.main, dict(kw))
    trunner._validate(kw)
    return trunner._run_rank(mesh, kw)


def job_legacy_run(mesh, kw):
    """One rank of the legacy runner, as ``run`` starts it."""
    return tlegacy._run_rank(mesh, fill_defaults(tlegacy.main, dict(kw)))


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


def _out_dir(root) -> str:
    subs = sorted(os.listdir(root))
    return os.path.join(root, subs[0])


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_np(v) for v in tree]
    return tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _assert_moves(init, got, want, what=""):
    for i, (s, a, b) in enumerate(zip(_leaves(init), _leaves(got), _leaves(want))):
        ma, mb = a.astype(np.float64) - s, b.astype(np.float64) - s
        scale = float(np.abs(mb).max())
        assert scale > 1e-4, f"{what}: leaf {i} did not move"
        np.testing.assert_allclose(ma, mb, rtol=0, atol=MOVE_TOL * scale, err_msg=f"{what} {i}")


def _assert_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def beside(tmp_path_factory):
    """The port's ``run(mesh_devices=2)`` (its own spawn) and the JAX
    runner at ``mesh_devices=2``, from one npz of JAX-drawn weights; and the
    JAX runner's DP train state at iteration 4 resumed by the port to 8,
    beside the JAX runner's 8 unbroken."""
    import jax

    from dctn_tpu import models as jm
    from dctn_tpu.cli import runner as jrunner
    from dctn_tpu.train.checkpoint import save_pytree

    tmp = tmp_path_factory.mktemp("beside")
    init = jm.init_eps_plus_linear(jax.random.PRNGKey(3), jm.EPSesPlusLinearConfig(
        epses_specs=SPECS, image_size=28, q0=2))
    init_file = str(tmp / "init.npz")
    save_pytree(init, init_file)
    kw = dict(SHARED, load_model_state=init_file)
    jstate = jrunner.run(experiments_dir=str(tmp / "jax"), mesh_devices=RANKS,
                         autotune_cache=False, **kw)
    tstate = trunner.run(experiments_dir=str(tmp / "port"), mesh_devices=RANKS, device="cpu",
                         **kw)
    jstate8 = jrunner.run(experiments_dir=str(tmp / "jax8"), mesh_devices=RANKS,
                          autotune_cache=False, **dict(kw, max_num_iters=8))
    jax_state = os.path.join(_out_dir(tmp / "jax"), "train_state_latest.npz")
    crossed = trunner.run(experiments_dir=str(tmp / "crossed"), mesh_devices=RANKS,
                          device="cpu", resume_from=jax_state, **dict(kw, max_num_iters=8))
    tree = jax.tree_util.tree_map(np.asarray, init)
    return dict(kw=kw, init=tree, jparams=jax.tree_util.tree_map(np.asarray, jstate.params),
                tstate=tstate, jdir=_out_dir(tmp / "jax"), tdir=_out_dir(tmp / "port"),
                jparams8=jax.tree_util.tree_map(np.asarray, jstate8.params), crossed=crossed)


def test_runner_dp_beside_the_jax_dp_runner(beside):
    """``run(mesh_devices=2, device="cpu")`` against the JAX runner at
    ``--mesh-devices 2``: the same local index rows (``make_local_index_stream``
    of each package), every parameter's move within MOVE_TOL, the eval lines
    within their printed precision, the same checkpoints; rank 0's state
    comes back in the reference layout."""
    from dctn_tpu.viz import load_records

    t = beside["tstate"]
    assert t.num_iters_done == 4 and t.stop_reason == "max_iters"
    assert t.extras["world_size"] == RANKS
    got = t.extras["params_view"](t.params)
    _assert_moves(beside["init"], _np(got), beside["jparams"], "mesh 2")
    jrec, trec = (load_records(os.path.join(d, "log.log")) for d in (beside["jdir"],
                                                                        beside["tdir"]))
    assert [r.nitd for r in trec] == [r.nitd for r in jrec] == [0, 2, 4]
    for a, b in zip(trec, jrec):
        assert abs(a.trmce - b.trmce) <= 1.5e-5 and abs(a.vmce - b.vmce) <= 1.5e-5, (a, b)
        assert abs(a.tracc - b.tracc) <= 1 / 32 + 1e-9 and abs(a.vacc - b.vacc) <= 1 / 32 + 1e-9
    ckpts = [sorted(re.sub(r"_tracc.*", "", f) for f in os.listdir(d) if f.startswith("model"))
             for d in (beside["tdir"], beside["jdir"])]
    assert ckpts[0] == ckpts[1]
    with open(os.path.join(beside["tdir"], "log.log")) as f:
        assert re.search(r"data parallel: 2 ranks \(gloo\), rank pids \[\d+, \d+\]", f.read())


def test_jax_dp_train_state_resumes_in_the_port(beside):
    """A train state the JAX runner wrote at iteration 4 of a 2-device DP
    run, resumed by the port on 2 ranks to 8, lands within MOVE_TOL of the
    JAX runner's unbroken 8: the same local streams fast-forwarded."""
    c = beside["crossed"]
    assert c.num_iters_done == 8
    _assert_moves(beside["init"], _np(c.extras["params_view"](c.params)), beside["jparams8"],
                  "crossed")


def test_legacy_runner_dp_beside_the_jax_dp_runner(tmp_path, pool):
    """The legacy runner at ``--mesh-devices 2`` (through the pool's ranks)
    beside the JAX legacy runner at ``--mesh-devices 2`` from one npz, one
    epoch of SGD with momentum: the same per-shard orders from one
    ``default_rng(seed + 1)`` chain, the weights within rtol 1e-4, atol 1e-6,
    the best accuracy within one of 64 validation images; rank 0 wrote the
    checkpoint and the train state."""
    import jax

    from dctn_tpu.cli import legacy_runner as jlegacy
    from dctn_tpu.models import conv_sbs_model as jm
    from dctn_tpu.train.checkpoint import save_pytree

    init = jm.init_conv_sbs_model(jax.random.PRNGKey(3), jm.ConvSBSModelConfig(2, 2))
    init_file = str(tmp_path / "init.npz")
    save_pytree(init, init_file)
    common = dict(ds_path="synthetic", num_sbs_layers=2, bond_dim_size=2, batch_size=32,
                  synthetic_sizes=(128, 64), seed=0, init_load_file=init_file, epochs=1,
                  warmup_num_epochs=0, learning_rate=1e-2, optimizer_type="sgd", momentum=0.9,
                  make_input_window_std_one=True, scale_layers_using_batch=64,
                  tb_log_every_n_epochs=0, mesh_devices=RANKS)
    jparams, jacc = jlegacy.run(models_dir=str(tmp_path / "jax"), preempt_save=False,
                                autotune_cache=False, **common)
    tparams, tacc = pool.run(job_legacy_run, dict(common, models_dir=str(tmp_path / "port"),
                                                  device="cpu"), timeout=TIMEOUT_S)
    for a, b in zip(_leaves(_np(tparams)), jax.tree_util.tree_leaves(jparams), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)
    assert abs(tacc - jacc) <= 1 / 64 + 1e-9
    files = os.listdir(tmp_path / "port")
    assert "train_state_latest.npz" in files and any(f.startswith("dctn_epoch=") for f in files)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(kw) -> list:
    """The EPS runner's command line for ``kw``."""
    argv = [sys.executable, "-m", "dctn_tpu_torch.cli.runner"]
    for k, v in kw.items():
        flag = "--" + {"optimizer_name": "optimizer"}.get(k, k).replace("_", "-")
        if v is True:
            argv.append(flag)
        elif k == "epses_specs":
            argv += [flag, ",".join(f"({a},{b})" for a, b in v)]
        elif isinstance(v, tuple) and k == "synthetic_sizes":
            argv += [flag, *map(str, v)]
        elif isinstance(v, tuple):
            argv += [flag, repr(v).replace(" ", "")]
        else:
            argv += [flag, str(v)]
    return argv


def _env():
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"  # one thread a rank, as the pool's ranks: the same bits
    return env


def test_distributed_two_host_processes_of_one_rank(tmp_path, pool):
    """``--distributed 127.0.0.1:PORT,2,PID``, two host processes of one
    rank each: rank 0 names the run (``<ts>`` and ``<ts>-proc1``, the same
    timestamp), only it writes checkpoints and the train state, and its
    final model is the bits of the same run on one host's two ranks."""
    port = _free_port()
    procs = [subprocess.Popen(
        _cli(dict(QUICK, experiments_dir=str(tmp_path / "dist"), max_num_iters=4,
                  mesh_devices=2, distributed=f"127.0.0.1:{port},2,{pid}")),
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for pid in (0, 1)]
    outs = [p.communicate(timeout=TIMEOUT_S)[0].decode() for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    runs = sorted(os.listdir(tmp_path / "dist"))
    assert len(runs) == 2 and runs[1] == runs[0] + "-proc1", runs
    primary, other = (tmp_path / "dist" / r for r in runs)
    assert "train_state_latest.npz" in os.listdir(primary)
    assert sorted(os.listdir(other)) == sorted(["git_diff_with_HEAD.patch", "log.log",
                                                "run_info.txt"])
    one_host = pool.run(job_eps_run, dict(QUICK, experiments_dir=str(tmp_path / "one"),
                                          max_num_iters=4, mesh_devices=2), timeout=TIMEOUT_S)
    (final,) = [f for f in os.listdir(primary) if f.startswith("model_nitd=0000004")]
    _assert_equal(load_params_npz(os.path.join(primary, final)), _np(one_host["params"]))


def test_distributed_auto_takes_torchrun_ranks(tmp_path):
    """``--distributed auto`` reads torchrun's environment (here a job of
    one rank): the process is the rank, meeting the others at
    ``env://``."""
    env = dict(_env(), RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    proc = subprocess.run(
        _cli(dict(QUICK, experiments_dir=str(tmp_path), max_num_iters=4, distributed="auto")),
        env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(os.path.join(_out_dir(tmp_path), "log.log")) as f:
        log = f.read()
    assert "data parallel: 1 ranks (gloo)" in log
    assert "training stopped: max_iters at 4 iters" in log


def test_sigterm_to_one_rank_stops_both_at_one_step(tmp_path, pool):
    """SIGTERM to rank 1 alone of ``python -m dctn_tpu_torch.cli.runner
    --mesh-devices 2``: at the next multiple of ``--preempt-sync-steps`` both
    ranks stop together (the process exits 0), rank 0 saves one train state
    there, and its resume is bit-equal to the unbroken run."""
    sync = 4
    proc = subprocess.Popen(
        _cli(dict(QUICK, experiments_dir=str(tmp_path / "run"), max_num_iters=100000,
                  eval_schedule=((None, 100000),), mesh_devices=2, preempt_sync_steps=sync)),
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        # the eval at iteration 0 sums over both ranks, so once rank 0 has
        # logged it every rank is in the loop, its handler installed
        pids, deadline = None, time.monotonic() + TIMEOUT_S
        while pids is None and time.monotonic() < deadline and proc.poll() is None:
            time.sleep(0.2)
            if os.path.isdir(tmp_path / "run") and os.listdir(tmp_path / "run"):
                path = os.path.join(_out_dir(tmp_path / "run"), "log.log")
                if not os.path.exists(path):  # the run dir is made before its log
                    continue
                with open(path) as f:
                    log = f.read()
                m = re.search(r"rank pids \[(\d+), (\d+)\]", log)
                if m and "After 0000000 iters" in log:
                    pids = (int(m.group(1)), int(m.group(2)))
        assert pids, "the ranks never started their loop"
        time.sleep(0.5)  # a few steps in
        os.kill(pids[1], signal.SIGTERM)
        out = proc.communicate(timeout=TIMEOUT_S)[0].decode()
    finally:
        if proc.poll() is None:  # the runner and its ranks
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, out
    run_dir = _out_dir(tmp_path / "run")
    with open(os.path.join(run_dir, "log.log")) as f:
        log = f.read()
    assert "every rank stopped at the same step" in log
    with np.load(os.path.join(run_dir, "train_state_latest.npz")) as d:
        step, world = int(d["step"]), int(d["mesh_devices"])
    assert step > 0 and step % sync == 0 and world == 2
    m = re.search(r"training stopped: preempted .* at (\d+) iters", log)
    assert m and int(m.group(1)) == step
    resumed = pool.run(job_eps_run, dict(
        QUICK, experiments_dir=str(tmp_path / "resumed"), max_num_iters=step + 4,
        mesh_devices=2, resume_from=os.path.join(run_dir, "train_state_latest.npz")),
        timeout=TIMEOUT_S)
    unbroken = pool.run(job_eps_run, dict(
        QUICK, experiments_dir=str(tmp_path / "unbroken"), max_num_iters=step + 4,
        mesh_devices=2), timeout=TIMEOUT_S)
    _assert_equal(resumed["params"], unbroken["params"])


@pytest.fixture(scope="module")
def resumes(tmp_path_factory, pool):
    """Train states at iteration 8 of a 2-rank and of a one-device run,
    resumed to 12 on 2 ranks (the 2-rank one bit-equal to the unbroken 12)
    and on one device."""
    tmp = tmp_path_factory.mktemp("resumes")

    def on_ranks(name, **kw):
        return pool.run(job_eps_run, dict(QUICK, experiments_dir=str(tmp / name),
                                          mesh_devices=2, **kw), timeout=TIMEOUT_S)

    on_ranks("two8", max_num_iters=8)
    trunner.run(**QUICK, experiments_dir=str(tmp / "one8"), max_num_iters=8)
    state2, state1 = (os.path.join(_out_dir(tmp / n), "train_state_latest.npz")
                      for n in ("two8", "one8"))
    return dict(
        tmp=tmp, state2=state2,
        same=on_ranks("same", max_num_iters=12, resume_from=state2),
        unbroken=on_ranks("unbroken", max_num_iters=12),
        up=on_ranks("up", max_num_iters=12, resume_from=state1),
        down=trunner.run(**QUICK, experiments_dir=str(tmp / "down"), max_num_iters=12,
                         resume_from=state2),
    )


def test_same_rank_count_resume_is_bit_equal(resumes):
    """A 2-rank train state saved at 8 (its index streams' orders and
    cursors beside the step) resumed on 2 ranks to 12 ends on the unbroken
    run's bits."""
    with np.load(resumes["state2"]) as d:
        assert int(d["mesh_devices"]) == 2 and int(d["step"]) == 8
        assert d["index_stream/cursors"].shape == (2,)
    assert resumes["same"]["num_iters_done"] == 12
    _assert_equal(resumes["same"]["params"], resumes["unbroken"]["params"])


@pytest.mark.parametrize("way", ["down", "up"])
def test_elastic_resume(resumes, way):
    """2 → 1 and 1 → 2: the parameters, moments, step and generator load,
    and training goes on to 12 on the new count's streams, which the log
    names as elastic."""
    r = resumes[way]
    params, iters = ((r.extras["params_view"](r.params), r.num_iters_done) if way == "down"
                     else (r["params"], r["num_iters_done"]))
    assert iters == 12
    assert all(np.isfinite(x).all() for x in _leaves(_np(params)))
    with open(os.path.join(_out_dir(resumes["tmp"] / way), "log.log")) as f:
        assert re.search(r"elastic resume: the train state was saved on [12] rank", f.read())


def test_a_moved_stream_is_refused_on_the_same_rank_count(resumes, pool, tmp_path):
    """The saved streams' position guards a same-count resume: another
    --seed (another batch order) is refused, on every rank, before a step."""
    with pytest.raises(RuntimeError, match="index streams stand elsewhere"):
        pool.run(job_eps_run, dict(QUICK, experiments_dir=str(tmp_path), max_num_iters=12,
                                   mesh_devices=2, seed=1, resume_from=resumes["state2"]),
                 timeout=TIMEOUT_S)


def test_tb_batches_and_the_artifact_under_dp(tmp_path, pool):
    """``--tb-batches`` on 2 ranks logs the gathered batch (its histogram
    and the image grid of the global indices) from local rank 0, and
    ``--export-artifact`` is written once, by rank 0, loadable."""
    import json

    art = str(tmp_path / "final.zip")
    out = pool.run(job_eps_run, dict(QUICK, experiments_dir=str(tmp_path / "run"),
                                     max_num_iters=4, mesh_devices=2, tb_batches=True,
                                     export_artifact=art, export_batch_sizes="1,8"),
                   timeout=TIMEOUT_S)
    assert out["num_iters_done"] == 4
    with open(os.path.join(_out_dir(tmp_path / "run"), "metrics.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"loss", "reg_term", "probs_of_true_class", "batch"} <= tags
    meta, fns = export.load_artifact(art)
    assert sorted(fns) == [1, 8] and meta["platforms"] == ["cpu"]


def _predict_case(tmp_path):
    from dctn_tpu_torch.models import EPSesPlusLinearConfig, init_eps_plus_linear
    from dctn_tpu_torch.train import save_params_npz

    cfg = EPSesPlusLinearConfig(epses_specs=SPECS, image_size=28, q0=2)
    ckpt = str(tmp_path / "m.npz")
    save_params_npz(init_eps_plus_linear(torch.Generator().manual_seed(0), cfg), ckpt)
    return ckpt, dict(checkpoint=ckpt, ds_type="fashionmnist", ds_path="synthetic",
                      epses_specs=SPECS, batch_size=16, device="cpu",
                      synthetic_sizes=(64, 16, 40))


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_predict_on_two_cpu_replicas(tmp_path, quantize):
    """``predict --mesh-devices 2``: a replica a device, each batch split
    over them; the logits are one replica's on each half, bit for bit, and
    the predictions those of one device."""
    from dctn_tpu_torch.parallel.replicas import ShardedForward

    _, kw = _predict_case(tmp_path)
    one = predict.run(**kw, quantize=quantize)
    two = predict.run(**kw, quantize=quantize, mesh_devices=2)
    assert isinstance(two.model, list) and len(two.model) == 2
    np.testing.assert_array_equal(two.preds, one.preds)
    x = two.x[:, :16]
    with torch.inference_mode():
        got = ShardedForward(two.model, [torch.device("cpu")] * 2, 1)(x)
        want = torch.cat([one.model(c) for c in torch.tensor_split(x, 2, dim=1)])
    assert torch.equal(got, want)


def test_sharded_artifact_on_two_cpu_replicas(tmp_path):
    """``export --mesh-devices 2``: the meta says so, a replica of the
    device-free program a device, each global batch split over them (each
    replica's logits one replica's on its half, bit for bit; within 1e-6 of
    the eager model's: the traced program's plain ops may sum in another
    order than the eager ones); ``predict`` and ``serve`` take it; a global
    batch the replicas do not divide is refused."""
    ckpt, kw = _predict_case(tmp_path)
    art = str(tmp_path / "sharded.zip")
    export.run(checkpoint=ckpt, epses_specs=SPECS, batch_sizes=(2, 16), mesh_devices=2,
               device="cpu", out=art)
    meta, fns = export.load_artifact(art)
    assert meta["mesh_devices"] == 2 and meta["program_device"] == "cpu"
    assert meta["batch_sizes"] == [2, 16] and len(fns[16].replicas) == 2
    one = predict.run(**kw)
    x = one.x[:, :16]
    with torch.inference_mode():
        got = fns[16](x)
        halves = torch.cat([fns[16].replicas[0](c) for c in torch.tensor_split(x, 2, dim=1)])
        eager = torch.cat([one.model(c) for c in torch.tensor_split(x, 2, dim=1)])
    assert torch.equal(got, halves)
    assert float((got - eager).abs().max()) <= 1e-6 * float(eager.abs().max())
    served = predict.run(checkpoint=art, ds_type="fashionmnist", ds_path="synthetic",
                         batch_size=16, device="cpu", synthetic_sizes=(64, 16, 40))
    np.testing.assert_array_equal(served.preds, one.preds)
    model = serve.ArtifactModel(art)
    assert model.device == torch.device("cpu")
    np.testing.assert_array_equal(model.predict(x[:, :5].numpy()), got[:5].numpy())
    with pytest.raises(click.UsageError, match=r"global batch sizes \[3\] are not divisible"):
        export.run(checkpoint=ckpt, epses_specs=SPECS, batch_sizes=(3,), mesh_devices=2,
                   device="cpu", out=str(tmp_path / "bad.zip"))


def test_more_ranks_than_cards_is_refused_before_any_rank_starts(tmp_path, monkeypatch):
    """Two ranks on a host with one visible card: refused by the runners
    and predict, nothing started or written; the same job on the CPU plans
    two gloo ranks."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"2 rank\(s\) on this host need 2 CUDA card\(s\); 1"):
        plan_job(2, None, "cuda")
    with pytest.raises(click.BadParameter, match="need 2 CUDA card"):
        trunner.run(**dict(QUICK, device="cuda"), experiments_dir=str(tmp_path / "eps"),
                    max_num_iters=1, mesh_devices=2)
    with pytest.raises(click.BadParameter, match="need 2 CUDA card"):
        tlegacy.run(ds_path="synthetic", models_dir=str(tmp_path / "legacy"), device="cuda",
                    mesh_devices=2)
    _, kw = _predict_case(tmp_path)
    with pytest.raises(click.UsageError, match="2 replicas need 2 CUDA cards; 1 visible"):
        predict.run(**dict(kw, device="cuda"), mesh_devices=2)
    assert not os.path.exists(tmp_path / "eps") and not os.path.exists(tmp_path / "legacy")
    job = plan_job(2, None, "cpu")
    assert (job.world_size, job.local_ranks, job.backend) == (2, 2, "gloo")
    assert plan_job(1, None, "cpu") is None


@pytest.mark.parametrize("flag,value", [("model_devices", 2), ("space_devices", 2),
                                        ("tp_shard_all", True)])
def test_tp_and_sp_flags_name_their_item(tmp_path, flag, value):
    """Tensor and spatial parallelism run (tests/test_torch_port_tp.py,
    test_torch_port_sp.py), and composed (SP x TP,
    tests/test_torch_port_sp_tp.py); what a composed grid cannot build is
    refused before any rank starts, naming what it refuses: with each flag
    on top of the other axis, a model axis that does not divide the last O,
    a halo wider than a rank's rows, and ``--tp-shard-all`` with
    ``--space-devices``."""
    refused = {"model_devices": ({}, "output dim 3 not divisible by model axis 2"),
               "space_devices": ({"epses_specs": ((4, 4), (3, 6)), "space_devices": 7 * value},
                                 "3-row halo but each device holds only 2 rows"),
               "tp_shard_all": ({}, "--tp-shard-all does not compose with --space-devices")}
    extra, match = refused[flag]
    both = {"model_devices": 2, "space_devices": 2, flag: value, **extra}
    with pytest.raises(click.BadParameter, match=match):
        trunner.run(**{**QUICK, **both}, experiments_dir=str(tmp_path), max_num_iters=1)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("kw,match", [
    ({"batch_size": 15, "mesh_devices": 2}, r"divisible by --mesh-devices \* --grad-accum"),
    ({"distributed": "localhost:1234"}, "'auto' or 'HOST:PORT,NPROC,PID'"),
    ({"distributed": "127.0.0.1:1234,2,0", "mesh_devices": 3, "batch_size": 18},
     "multiple of the 2 host"),
])
def test_mesh_flag_refusals(tmp_path, kw, match):
    with pytest.raises(click.BadParameter, match=match):
        trunner.run(**{**QUICK, **kw}, experiments_dir=str(tmp_path / "x"), max_num_iters=1)
