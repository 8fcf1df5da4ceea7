"""The port's ``torch_convert`` and ``sweep`` beside the JAX package's on the
CPU: both conversion directions for both model families give the JAX
tool's arrays exactly, and the sweep's grid and command lines are the JAX
sweep's with the port's runner as the command."""

import sys

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from dctn_tpu.cli import sweep as jsweep
from dctn_tpu.cli import torch_convert as jconvert
from dctn_tpu.models import conv_sbs_model as jcsm
from dctn_tpu.train.checkpoint import save_pytree
from dctn_tpu_torch.cli import sweep as tsweep
from dctn_tpu_torch.cli import torch_convert as tconvert


def _params(family):
    """Numpy params of either family, from a seeded numpy draw."""
    rng = np.random.default_rng(0)
    if family == "eps_plus_linear":
        return {"epses": (rng.normal(size=(2,) * 4 + (4,)), rng.normal(size=(4,) * 4 + (3,))),
                "linear": {"w": rng.normal(size=(108, 10)), "b": rng.normal(size=(10,))}}
    specs = jcsm.ConvSBSModelConfig(2, 2).layer_specs()
    return tuple(tuple(tuple(rng.normal(size=sh.as_tuple()).astype(np.float32)
                             for sh in spec.shapes) for spec in layer) for layer in specs)


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


@pytest.mark.parametrize("family", ["eps_plus_linear", "conv_sbs"])
def test_torch_convert_both_ways_matches_the_jax_tool(tmp_path, family):
    """npz → .pt and back, with the family inferred: the port's .pt holds
    the JAX tool's state_dict tensors exactly, the port's npz the JAX
    tool's arrays, under the same keys; an npz of neither family is
    refused."""
    src = str(tmp_path / "params.npz")
    save_pytree(_params(family), src)
    pt = {}
    for name, main in (("jax", jconvert.main), ("port", tconvert.main)):
        out = str(tmp_path / f"{name}.pt")
        CliRunner().invoke(main, [src, out], catch_exceptions=False)
        pt[name] = torch.load(out, weights_only=True)
    assert list(pt["port"]) == list(pt["jax"])
    for k, v in pt["jax"].items():
        assert torch.equal(pt["port"][k], v), k
    back = {}
    for name, main in (("jax", jconvert.main), ("port", tconvert.main)):
        out = str(tmp_path / f"{name}_back.npz")
        CliRunner().invoke(main, [str(tmp_path / "jax.pt"), out], catch_exceptions=False)
        back[name] = _npz(out)
    assert sorted(back["port"]) == sorted(back["jax"]) == sorted(_npz(src))
    for k, v in back["jax"].items():
        assert back["port"][k].dtype == v.dtype and np.array_equal(back["port"][k], v), k
    assert tconvert.convert(str(tmp_path / "port.pt"), str(tmp_path / "again.npz")) == family
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, something=np.zeros(2))
    result = CliRunner().invoke(tconvert.main, [bad, str(tmp_path / "bad.pt")])
    assert result.exit_code != 0 and "cannot infer model family" in result.output


def test_sweep_grid_and_argv_match_the_jax_sweep():
    """The same spec expands to the same shuffled configs, and each config
    to the JAX sweep's command line with the port's runner module."""
    base = {"batch-size": 32, "epses-specs": "(2,4),(2,3)"}
    grid = {"lr": [1e-3, 1e-4, 3e-4], "reg-coeff": [0.0, 1e-6], "es-val-acc": [True, False]}
    for seed in (0, 7, None):
        configs = tsweep.expand_grid(base, grid, shuffle_seed=seed)
        assert configs == jsweep.expand_grid(base, grid, shuffle_seed=seed) and len(configs) == 12
    cfg = {"lr": 1e-3, "es-val-acc": False, "tb_batches": True, "nu-per-channel": (1, 2, 3)}
    want = jsweep.config_to_argv(cfg)
    got = tsweep.config_to_argv(cfg)
    assert got[:3] == [sys.executable, "-m", "dctn_tpu_torch.cli.runner"]
    assert got[3:] == want[3:] and "--tb-batches" in got and "--no-es-val-acc" in got


def test_run_sweep_keeps_going_past_failures_with_its_worker_env(monkeypatch):
    """Failed configs are recorded and the sweep goes on; each slot's
    worker_env reaches its subprocess."""
    monkeypatch.setattr(tsweep, "config_to_argv", lambda cfg: [
        sys.executable, "-c",
        "import os, sys; sys.exit(%d + int(os.environ['SLOT_CODE']))" % cfg["code"]])
    results = tsweep.run_sweep([{"code": 0}, {"code": 3}, {"code": 0}], num_workers=2,
                               worker_env=[{"SLOT_CODE": "0"}, {"SLOT_CODE": "0"}],
                               poll_interval=0.05)
    assert sorted(code for _, code in results) == [0, 0, 3]
    results = tsweep.run_sweep([{"code": 0}], num_workers=1, worker_env=[{"SLOT_CODE": "5"}],
                               poll_interval=0.05)
    assert [code for _, code in results] == [5]


def test_async_writer_keeps_the_order_of_writes_to_one_file(tmp_path):
    """Writes submitted back to back to one file land in order, each after
    the one before (they share the temporary file), so the file ends as the
    last one submitted; writes to other files do not wait for them."""
    import threading

    from dctn_tpu_torch.train.checkpoint import AsyncWriter

    errors = []
    prev_hook, prev_switch = threading.excepthook, sys.getswitchinterval()
    threading.excepthook = lambda args: errors.append(args.exc_value)
    sys.setswitchinterval(1e-6)
    try:
        writer = AsyncWriter()
        path = str(tmp_path / "state.npz")
        for i in range(30):
            writer.submit({"step": np.int64(i), "x": torch.full((20000,), float(i))}, path)
            writer.submit({"step": np.int64(i)}, str(tmp_path / f"other{i}.npz"))
        writer.wait()
    finally:
        threading.excepthook = prev_hook
        sys.setswitchinterval(prev_switch)
    assert not errors
    with np.load(path) as d:
        assert int(d["step"]) == 29 and float(d["x"][0]) == 29.0
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["state.npz"] + [f"other{i}.npz" for i in range(30)])
