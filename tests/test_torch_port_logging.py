"""The port's TB logging, intermediate outputs, TT statistics and profiling
on the CPU, each held against the JAX package on the same arrays:
``MetricsWriter``'s jsonl lines and the annotated image grid, the named
outputs of both model families with their tags and values, the parameter
histograms' tags, the TT statistics in float64 (and against the dense
tensor they stand for), and ``StepTracer``'s window."""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctn_tpu.models import conv_sbs_model as jcsm
from dctn_tpu.models import eps_plus_linear as jepl
from dctn_tpu.ops import sbs as jsbs
from dctn_tpu.train import intermediate_logger as jil
from dctn_tpu.train import tb_logging as jtb
from dctn_tpu_torch.interop import conv_sbs_params_from_numpy, params_from_numpy
from dctn_tpu_torch.models import conv_sbs_model as tcsm
from dctn_tpu_torch.models import eps_plus_linear as tepl
from dctn_tpu_torch.ops import sbs as tsbs
from dctn_tpu_torch.train import intermediate_logger as til
from dctn_tpu_torch.train import tb_logging as ttb
from dctn_tpu_torch.utils import profiling


def _lines(d):
    with open(os.path.join(d, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _writers(tmp_path):
    """A JAX and a port MetricsWriter without TensorBoard events, so that
    the jsonl file is the whole record."""
    return (jtb.MetricsWriter(str(tmp_path / "jax"), use_tensorboard=False),
            ttb.MetricsWriter(str(tmp_path / "port"), use_tensorboard=False))


def _assert_same_records(tmp_path, rtol=0.0, atol=0.0):
    """The two writers' lines: the same tags, steps and keys in the same
    order, every number within the tolerance."""
    jl, tl = _lines(tmp_path / "jax"), _lines(tmp_path / "port")
    assert [(r["tag"], r["step"], sorted(r)) for r in tl] == [
        (r["tag"], r["step"], sorted(r)) for r in jl]
    for a, b in zip(tl, jl):
        for k, v in b.items():
            if isinstance(v, float):
                assert a[k] == pytest.approx(v, rel=rtol, abs=atol), (b["tag"], k)
            else:
                assert a[k] == v, (b["tag"], k)
    return tl


def test_metrics_writer_lines_and_image_grid_match_jax(tmp_path):
    """Scalars, histograms and the annotated batch grid (good/bad bar, label
    dots, the grid) give the JAX writer's lines, and the images are the JAX
    helpers' arrays exactly."""
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(11, 6, 5)).astype(np.float32)
    probs = np.concatenate([[0.0, 1.0, 0.5], rng.uniform(size=8)]).astype(np.float32)
    labels = rng.integers(0, 10, size=11)
    for img, p, lbl in zip(images, probs, labels):
        bar = ttb.add_good_bad_bar(img, p)
        np.testing.assert_array_equal(bar, jtb.add_good_bad_bar(img, p))
        np.testing.assert_array_equal(ttb.add_y_dots(bar, int(lbl)), jtb.add_y_dots(bar, int(lbl)))
    tiles = [jtb.add_y_dots(jtb.add_good_bad_bar(i, p), int(l)) for i, p, l in zip(images, probs, labels)]
    for nrow, pad in ((8, 1), (3, 2)):
        np.testing.assert_array_equal(ttb.make_image_grid(tiles, nrow, pad),
                                      jtb.make_image_grid(tiles, nrow, pad))
    jw, tw = _writers(tmp_path)
    for w, mod in ((jw, jtb), (tw, ttb)):
        w.add_scalar("loss", 1.25, 3)
        w.add_scalar("reg_term", np.float32(2e-3), 3)
        w.add_histogram("probs_of_true_class", probs, 3)
        mod.log_batch_images(w, images, probs, labels, 3)
        w.close()
    lines = _assert_same_records(tmp_path)
    assert lines[-1]["image_shape"] == list(jtb.make_image_grid(tiles).shape)


def _np_eps_params(specs, q0, image_size, seed=0):
    rng = np.random.default_rng(seed)
    epses, q, h = [], q0, image_size
    for k, o in specs:
        epses.append(rng.normal(size=(q,) * (k * k) + (o,)) * q ** (-k * k / 2))
        q, h = o, h - k + 1
    return {"epses": tuple(epses),
            "linear": {"w": rng.normal(size=(h * h * q, 10)) * 0.1,
                       "b": rng.uniform(-0.1, 0.1, size=(10,))}}


def test_eps_named_outputs_and_histograms_match_jax(tmp_path):
    """The EPS model's named outputs in float64, through the plain eps and
    through the fast layout (the forward kernel's path), equal the JAX
    package's within 1e-12 of each output's largest entry; logged, they give
    the JAX tags (``intermediate_{transform}/{eps_i|linear}``, and the
    logits as probabilities) with the same numbers within 1e-9; the
    parameters' histograms have the JAX leaf names."""
    specs, q0, size = ((2, 4), (2, 3)), 2, 8
    np_params = _np_eps_params(specs, q0, size)
    x = np.random.default_rng(1).uniform(size=(1, 16, size, size, q0))
    jcfg = jepl.EPSesPlusLinearConfig(epses_specs=specs, image_size=size, q0=q0)
    tcfg = tepl.EPSesPlusLinearConfig(epses_specs=specs, image_size=size, q0=q0)
    jnamed = jil.eps_plus_linear_named_outputs(
        jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(x), jcfg)
    params = params_from_numpy(np_params, dtype=torch.float64)
    fast, plans = tepl.fast_params_from_reference(params, tcfg)
    xt = torch.tensor(x)
    for named in (til.eps_plus_linear_named_outputs(params, xt, tcfg),
                  til.eps_plus_linear_named_outputs_fast(fast, xt, tcfg, plans)):
        assert list(named) == list(jnamed) == ["eps_0", "eps_1", "linear"]
        for k, v in jnamed.items():
            v = np.asarray(v)
            np.testing.assert_allclose(named[k].numpy(), v, rtol=0,
                                       atol=1e-12 * np.abs(v).max(), err_msg=k)
    jw, tw = _writers(tmp_path)
    for w, il, named, tree in ((jw, jil, jnamed, np_params), (tw, til, til.eps_plus_linear_named_outputs_fast(fast, xt, tcfg, plans), params)):
        il.log_named_outputs(w, named, 5, il.DEFAULT_TRANSFORMS)
        il.log_named_outputs(w, named, 5, (il.log_logits_as_probabilities,),
                             module_filter=lambda name: name == "linear")
        il.log_tree_histograms(w, tree, 5, "weights")
        w.close()
    lines = _assert_same_records(tmp_path, rtol=1e-9, atol=1e-12)
    tags = {r["tag"] for r in lines}
    assert {"intermediate_dumb_mean/eps_0", "intermediate_dumb/linear",
            "intermediate_logits_as_probabilities/linear", "weights/epses/1",
            "weights_std/linear/w"} <= tags


@pytest.mark.parametrize("trace_edge", [False, True], ids=["open", "ring"])
def test_conv_sbs_named_outputs_and_histograms_match_jax(tmp_path, trace_edge):
    """The ConvSBS model's named outputs (``layer{i}.string{j}`` and the
    logits) in float64 through ``conv_sbs_t`` equal the JAX package's within
    1e-12 of each output's largest entry; logged with the weights' and a
    gradient tree's histograms, they give the JAX tags (leaves named
    ``{layer}/{string}/{core}``) with the same numbers within 1e-9."""
    jcfg = jcsm.ConvSBSModelConfig(2, 2, trace_edge=trace_edge, input_multiplier=1.3)
    tcfg = tcsm.ConvSBSModelConfig(2, 2, trace_edge=trace_edge, input_multiplier=1.3)
    rng = np.random.default_rng(2)
    np_params = tuple(tuple(tuple(rng.normal(size=sh.as_tuple()) * 0.7 for sh in spec.shapes)
                            for spec in layer) for layer in tcfg.layer_specs())
    grads = jax.tree_util.tree_map(lambda a: a * 0.01 + 1.0, np_params)
    images = rng.uniform(size=(5, 28, 28))
    jnamed = jil.conv_sbs_model_named_outputs(
        jax.tree_util.tree_map(jnp.asarray, np_params), jcfg, jnp.asarray(images))
    params = conv_sbs_params_from_numpy(np_params, dtype=torch.float64)
    tnamed = til.conv_sbs_model_named_outputs(params, tcfg, torch.tensor(images))
    assert list(tnamed) == list(jnamed)
    for k, v in jnamed.items():
        v = np.asarray(v)
        np.testing.assert_allclose(tnamed[k].numpy(), v, rtol=0, atol=1e-12 * np.abs(v).max(),
                                   err_msg=k)
    jw, tw = _writers(tmp_path)
    for w, il, named, p, g in ((jw, jil, jnamed, np_params, grads),
                               (tw, til, tnamed, params, conv_sbs_params_from_numpy(grads))):
        il.log_named_outputs(w, named, 7, il.DEFAULT_TRANSFORMS)
        il.log_tree_histograms(w, p, 7, "weights")
        il.log_tree_histograms(w, g, 7, "grads")
        w.close()
    tags = {r["tag"] for r in _assert_same_records(tmp_path, rtol=1e-9, atol=1e-12)}
    assert {"intermediate_dumb_std/layer0.string1", "intermediate_dumb/logits",
            "weights/1/0/8", "grads_mean/0/1/0"} <= tags


@pytest.mark.parametrize("trace_edge", [False, True], ids=["open", "ring"])
def test_tt_statistics_match_jax_and_the_dense_tensor(tmp_path, trace_edge):
    """``tt_sum`` … ``tt_std`` of every legacy string in float64 equal the
    JAX package's within 1e-12 (relative) and the statistics of the dense
    tensor ``as_explicit_tensor`` builds within 1e-10; ``as_explicit_tensor``
    and ``as_eps`` equal the JAX package's; ``log_conv_sbs_tt_statistics``
    writes the JAX lines."""
    tcfg = tcsm.ConvSBSModelConfig(2, 2, trace_edge=trace_edge)
    jcfg = jcsm.ConvSBSModelConfig(2, 2, trace_edge=trace_edge)
    rng = np.random.default_rng(3)
    named = {}
    for i, (tl, jl) in enumerate(zip(tcfg.layer_specs(), jcfg.layer_specs())):
        for j, (ts, js) in enumerate(zip(tl, jl)):
            cores = [rng.normal(size=sh.as_tuple()) for sh in ts.shapes]
            tc, jc = [torch.tensor(c) for c in cores], [jnp.asarray(c) for c in cores]
            assert ts.nelement == js.nelement
            dense = tsbs.as_explicit_tensor(ts, tc)
            np.testing.assert_allclose(dense.numpy(), np.asarray(jsbs.as_explicit_tensor(js, jc)),
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(tsbs.as_eps(ts, tc).numpy(),
                                       np.asarray(jsbs.as_eps(js, jc)), rtol=1e-12, atol=1e-12)
            d = dense.numpy().ravel()
            want = {"tt_sum": d.sum(), "tt_mean": d.mean(), "tt_squared_fro_norm": (d * d).sum(),
                    "tt_fro_norm": np.sqrt((d * d).sum()), "tt_var": d.var(ddof=1),
                    "tt_std": d.std(ddof=1)}
            for name, value in want.items():
                got = float(getattr(tsbs, name)(ts, tc))
                assert got == pytest.approx(float(getattr(jsbs, name)(js, jc)), rel=1e-12, abs=1e-12)
                assert got == pytest.approx(value, rel=1e-10, abs=1e-10), name
            assert float(tsbs.tt_var(ts, tc, unbiased=False)) == pytest.approx(d.var(), rel=1e-10)
            named[f"layer{i}.string{j}"] = (ts, tc, js, jc)
    jw, tw = _writers(tmp_path)
    jtb.log_conv_sbs_tt_statistics(jw, {k: (v[2], v[3]) for k, v in named.items()}, 4)
    ttb.log_conv_sbs_tt_statistics(tw, {k: (v[0], v[1]) for k, v in named.items()}, 4)
    jw.close()
    tw.close()
    _assert_same_records(tmp_path, rtol=1e-12, atol=1e-12)


class _FakeProfiler:
    def __init__(self, calls, d):
        self.calls, self.d = calls, d

    def start(self):
        self.calls.append(("start", self.d))

    def stop(self):
        self.calls.append(("stop",))


def _state(it):
    return types.SimpleNamespace(num_iters_done=it)


def test_step_tracer_window_close_and_a_backend_that_cannot_trace(monkeypatch):
    """The window starts at the first iteration ≥ start and stops at
    start + count, once each; ``close`` stops a window training left open
    and is idempotent; a profiler that cannot start disables the tracer
    without raising or retrying (the JAX package's three StepTracer tests)."""
    calls = []
    monkeypatch.setattr(profiling, "_profiler", lambda d: _FakeProfiler(calls, d))
    tr = profiling.StepTracer("traces", start=2, count=3)
    for it in range(8):
        tr(_state(it))
    tr.close()
    assert calls == [("start", "traces"), ("stop",)]
    calls.clear()
    tr = profiling.StepTracer("traces", start=0, count=100)
    tr(_state(0))
    tr.close()
    tr.close()
    assert calls == [("start", "traces"), ("stop",)]

    def boom(d):
        raise RuntimeError("no trace support")

    monkeypatch.setattr(profiling, "_profiler", boom)
    tr = profiling.StepTracer("traces", start=0, count=2)
    tr(_state(0))
    assert tr.done and not tr.active
    tr(_state(1))
    tr.close()
    with pytest.raises(ValueError):
        profiling.StepTracer("traces", start=0, count=0)


def test_step_tracer_writes_a_trace_of_its_window(tmp_path):
    """On the CPU the window's torch.profiler trace lands in the directory
    and names the ops run inside it; ``trace`` does the same for a block."""
    d = str(tmp_path / "prof")
    tr = profiling.StepTracer(d, start=1, count=2)
    a = torch.ones(8, 8)
    for it in range(4):
        tr(_state(it))
        a = torch.mm(a, a) / 8
    tr.close()
    (trace,) = profiling.trace_files(d)
    with open(trace) as f:
        assert "aten::mm" in f.read()
    d2 = str(tmp_path / "block")
    with profiling.trace(d2):
        torch.mm(a, a)
    assert len(profiling.trace_files(d2)) == 1
