"""The port's autotuners (``dctn_tpu_torch/train/autotune.py``) on the CPU,
held against the JAX package's (``dctn_tpu/train/autotune.py``).

A ranking measured on the CPU says nothing of the card, so the decisions
are compared on injected times: the same tables of milliseconds go into
both packages' measurers, and both must make the same picks and reports,
for the split tuner (with a failed candidate and both sides of the
``min_gain`` edge), the accumulation tuner and the ConvSBS tuner; each
reference defect the port does not copy has a test of its own. Then the
cache, the plans flow through the runner (a non-default split trains within
float32 reordering of the default one, on one device and on tensor
parallelism, and its train state resumes in both packages), the CLIs on
``--device cpu``, and rank 0's picks broadcast to every rank.

The rank processes (``torch_port_rank_pool``) import this module, so JAX is
imported inside the tests only.
"""

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from dctn_tpu_torch.cli import export as texport
from dctn_tpu_torch.cli import legacy_runner as tlegacy
from dctn_tpu_torch.cli import predict as tpredict
from dctn_tpu_torch.cli import runner as trunner
from dctn_tpu_torch.cli import serve as tserve
from dctn_tpu_torch.cli.specs import fill_defaults
from dctn_tpu_torch.interop import params_from_numpy
from dctn_tpu_torch.kernels.sbs_kernels import _mim_cut, sbs_supported
from dctn_tpu_torch.models import EPSesPlusLinear, EPSesPlusLinearConfig, fast_layer_plans
from dctn_tpu_torch.models.conv_sbs_model import ConvSBSModelConfig
from dctn_tpu_torch.models.eps_plus_linear import (
    eps_plus_linear_forward_fast,
    fast_params_from_reference,
    init_eps_plus_linear,
)
from dctn_tpu_torch.parallel import make_grid
from dctn_tpu_torch.parallel.mesh import Host, Job
from dctn_tpu_torch.train import autotune as at
from dctn_tpu_torch.train import load_params_npz, save_params_npz
from dctn_tpu_torch.utils import fallbacks
from torch_port_rank_pool import RankPool

REPO = Path(__file__).resolve().parents[1]
SMALL = ((3, 3), (2, 4))  # layer 0: n = 9, q = 2 (no pair merge); layer 1: n = 4, q = 3
FLAGSHIP = ((4, 4), (3, 6))
THREE = ((2, 4), (2, 6), (2, 12))
DEEP = ((4, 4), (3, 12), (2, 24))
OBJECTIVES = ((False, None), (False, "int8"), (True, None), (True, "int8"))
SPECS = ((2, 4), (2, 4))  # the runner's model: splits (4, 3) by default, (2, 2) tuned
TUNED = [2, 2]
# SGD: its update is linear in the gradient, so another split's float32
# summation order moves a parameter by that order's rounding alone (Adam
# divides each gradient entry by its own scale, and an entry near zero then
# moves by ±lr on a rounding's sign)
RECIPE = dict(ds_type="fashionmnist", ds_path="synthetic", epses_specs=SPECS, batch_size=16,
              optimizer_name="sgd", lr=1e-2, wd=0.0, synthetic_sizes=(64, 32, 32),
              eval_schedule=((None, 2),), keep_last_models=1,
              init_epses_composition_unit_theoretical_output_std=True)
# each run's move from the shared init against the default-split run's, per
# parameter, as a share of the largest move: splits are exact
# re-matricizations, so only float32 summation orders differ (the runner
# tests' bound for two packages' orders, test_torch_port_runner.py)
MOVE_TOL = 5e-5
TIMEOUT_S = 180


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _own_cache(tmp_path, monkeypatch):
    """Every test's cache in its own directory, never the home directory."""
    monkeypatch.setenv(at.CACHE_ENV, str(tmp_path / "autotune_cache.json"))
    yield
    fallbacks.reset()


def _jax():
    import jax

    from dctn_tpu import models as jm
    from dctn_tpu.models import conv_sbs_model as jcsm
    from dctn_tpu.models import eps_plus_linear as jmodel
    from dctn_tpu.ops import eps as jeps
    from dctn_tpu.train import autotune as jat
    from dctn_tpu.train import step as jstep

    return jax, jm, jmodel, jeps, jat, jstep, jcsm


def _cfg(specs, image=8):
    return EPSesPlusLinearConfig(epses_specs=specs, image_size=image, q0=2)


def _jcfg(specs, image=8):
    _, jm, *_ = _jax()
    return jm.EPSesPlusLinearConfig(epses_specs=specs, image_size=image, q0=2,
                                    train_backend="pallas_interpret",
                                    eval_backend="pallas_interpret")


def _measurer(table):
    """A split measurer of either package from ``table[(q, out_size, n1)]``
    (None: the planner refuses the candidate)."""

    def measure(c, q, h, w, kernel_size, out_size, n1, *args, **kwargs):
        ms = table[(q, out_size, n1)]
        if ms is None:
            raise ValueError(f"split n1={n1} refused by the planner")
        return ms

    return measure


def _split_measurer(fast_n1, slow=2.0, fast=1.0):
    """Every candidate at ``slow`` ms but n1 = ``fast_n1`` at ``fast``."""
    return lambda c, q, h, w, k, o, n1, *a, **kw: fast if n1 == fast_n1 else slow


# ---------------------------------------------------------------------------
# the split tuner's decisions against the JAX tuner's


def _pick_rule_case(name, d0, d1):
    """(candidates by (q, out_size), times by (q, out_size, n1), reg times
    by (layer, n1), autotune kwargs) for SMALL with defaults d0, d1."""
    a0, b0 = [n for n in range(1, 10) if n != d0][:2]
    a1 = next(n for n in range(1, 5) if n != d1)
    cands = {(2, 3): [d0, a0, b0], (3, 4): [d1, a1]}
    table = {(2, 3, d0): 1.0, (2, 3, a0): 0.5, (2, 3, b0): None, (3, 4, a1): 1.0}
    kw, reg = {}, None
    if name == "edge_adopted":  # 1.02 / 1.00 is not below 1 + min_gain: the winner stands
        table[(3, 4, d1)] = 1.02
    elif name == "edge_kept":  # just below the edge: the default stays
        table[(3, 4, d1)] = 1.0199
    elif name == "reg_flips":  # the composition regularizer's marginal turns layer 0 back
        table[(3, 4, d1)] = 1.5
        reg = {(0, d0): 0.1, (0, a0): 0.9, (1, d1): 0.2, (1, a1): 0.1}
        kw = dict(reg_type="epses_composition", reg_coeff=1e-2)
    else:  # serve_int8: the serving int8 objective, the same rule
        table[(3, 4, d1)] = 3.0
        kw = dict(forward_only=True, quantize="int8")
    return cands, table, reg, kw


@pytest.mark.parametrize("name", ["edge_adopted", "edge_kept", "reg_flips", "serve_int8"])
def test_split_picks_and_reports_equal_jax(name, monkeypatch):
    """Both packages' ``autotune_splits`` on one candidate list and one
    table of ms (a non-default candidate refused by the planner, the
    ``min_gain`` edge from both sides, the regularizer's marginal, the
    serving int8 objective) pick the same splits with the same report."""
    jax, jm, jmodel, jeps, jat, *_ = _jax()
    jcfg, cfg = _jcfg(SMALL), _cfg(SMALL)
    d0, d1 = (p["n1"] for p in fast_layer_plans(cfg))
    assert (d0, d1) == tuple(p["n1"] for p in jmodel.fast_layer_plans(jcfg))
    cands, table, reg, kw = _pick_rule_case(name, d0, d1)
    monkeypatch.setattr(jat, "candidate_splits", lambda n, q, o, *a, **k: list(cands[(q, o)]))
    monkeypatch.setattr(at, "candidate_splits",
                        lambda c, q, k, o, *a, **kws: list(cands[(q, o)]))
    for mod in (jat, at):
        monkeypatch.setattr(mod, "_measure_candidate", _measurer(table))
        if reg:
            monkeypatch.setattr(mod, "_measure_reg_marginal",
                                lambda cfg_, plans, layer, n1, *a: reg[(layer, n1)])
    jplans, jreport = jat.autotune_splits(jcfg, 4, **kw)
    plans, report = at.autotune_splits(cfg, 4, device="cpu", **kw)
    assert [p["n1"] for p in plans] == [p["n1"] for p in jplans]
    assert report == jreport
    assert any(f"n1={cands[(2, 3)][2]} failed (ValueError)" in e for e in fallbacks.events())
    want = {"edge_adopted": cands[(3, 4)][1], "edge_kept": d1}.get(name)
    if want is not None:
        assert plans[1]["n1"] == want


@pytest.mark.parametrize("specs", [FLAGSHIP, THREE, DEEP], ids=["flagship", "three", "deep"])
def test_default_splits_and_candidate_sets_equal_jax(specs, monkeypatch):
    """The default split equals JAX's; on the CPU the candidate set is
    JAX's ``split_candidates``; on a card every objective's legal set (the
    kernels' own plans, checked on shape-only tensors) holds the default
    and lies within it; and whatever ``hopper_split_cost`` ranks first, the
    tuner measures the default (here on the card's candidate path with an
    injected measurer, batch 128)."""
    jax, jm, jmodel, jeps, jat, *_ = _jax()
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=specs)
    cfg = EPSesPlusLinearConfig(epses_specs=specs)
    defaults = [p["n1"] for p in fast_layer_plans(cfg)]
    assert defaults == [p["n1"] for p in jmodel.fast_layer_plans(jcfg)]
    assert at._layer_dims(cfg) == jat._layer_dims(jcfg)
    for i, ((c, q, h, w, k, o), d) in enumerate(zip(at._layer_dims(cfg), defaults)):
        npix = 128 * (h - k + 1) * (w - k + 1)
        every = jeps.split_candidates(k * k * c, q)
        assert sorted(at.candidate_splits(c, q, k, o, npix, i, "train", 99, "cpu")) == every
        for fo, qz in OBJECTIVES:
            legal = at.legal_splits(c, q, k, o, npix, i, at.objective_name(fo, qz), "cuda")
            assert d in legal and set(legal) <= set(every), (i, fo, qz, legal)
    monkeypatch.setattr(at, "_measure_candidate", lambda *a, **k: 1.0)
    for fo, qz in OBJECTIVES:
        _, report = at.autotune_splits(cfg, 128, device="cuda", forward_only=fo, quantize=qz)
        for r, d in zip(report, defaults):
            measured = [row["n1"] for row in r["candidates"]]
            assert d in measured and len(measured) <= 4 and r["picked_n1"] == d


@pytest.mark.parametrize("forward_only,quantize", OBJECTIVES)
def test_the_measurers_run_on_the_cpu(forward_only, quantize):
    """The real measurers, uninjected, on the plain versions at a tiny
    size (times on the host clock, their ranking meaningless): every
    candidate and the regularizer's marginal timed, the picks legal and
    the measured minimum unless within min_gain of the default; the
    accumulation and ConvSBS tuners too."""
    cfg = _cfg(SMALL)
    plans, report = at.autotune_splits(cfg, 2, device="cpu", forward_only=forward_only,
                                       quantize=quantize, reg_type="epses_composition",
                                       reg_coeff=1e-2, min_gain=0.0)
    for p, r in zip(plans, report):
        rows = r["candidates"]
        assert all(row["ms"] > 0 for row in rows) and r["model_n1"] in [x["n1"] for x in rows]
        assert all(("reg_ms" in row) != forward_only for row in rows)
        assert p["n1"] == r["picked_n1"] == min(rows, key=lambda x: x["ms"])["n1"]
    if forward_only:
        return
    assert at.autotune_grad_accum(cfg, plans, 8, cap_pick=2, device="cpu") in (2, 4, 8)
    scfg = ConvSBSModelConfig(num_sbs_layers=2, bond_dim_size=2, trace_edge=quantize is None)
    tuning, sreport = at.autotune_conv_sbs(scfg, 7, 2, device="cpu", min_gain=-1.0)
    assert all(r["candidates"] and all(x["ms"] > 0 for x in r["candidates"])
               for r in sreport if "layer" in r)
    assert len(tuning) == 2 and sreport[-1]["whole_model"]["heuristic_ms"] > 0


def test_kernels_take_split_mirrors_the_wrappers_refusals():
    """The card's legal set is the wrappers' own checks: flagship layer 0
    (q² = 4 after the pair merge) refuses B2 = 4^(8 - n1/2) over 512, so
    n1 < 8; its int8 forward refuses A = 4^6 (no form's shared memory)."""
    assert at.legal_splits(1, 2, 4, 4, 128 * 625, 0, "train", "cuda") == [8, 10, 12, 14, 16]
    assert at.legal_splits(1, 2, 4, 4, 128 * 625, 0, "serve-int8", "cuda") == [8, 10]
    assert not at.kernels_take_split(1, 2, 4, 7, 4, 100, 0, "train")  # odd split, merged pairs


# ---------------------------------------------------------------------------
# the accumulation tuner against JAX's


def test_accum_candidates_and_pick_equal_jax(monkeypatch):
    """Over a grid of (cap pick, batch) the port times the accumulations
    JAX builds, in order (none where fewer than two divide the batch); on
    one set of injected step times both take the same winner, one the cap
    model would not pick."""
    jax, jm, jmodel, jeps, jat, jstep, _ = _jax()
    import jax.numpy as jnp

    jcfg, cfg = _jcfg(((3, 4), (2, 4)), 10), _cfg(((3, 4), (2, 4)), 10)
    jplans, plans = jmodel.fast_layer_plans(jcfg, 1), fast_layer_plans(cfg, 1)
    built, timed, sleeps = [], [], {}

    def fake_factory(cfg_, opt_, plans_, reg_, coeff_, donate, grad_accum_steps):
        built.append(grad_accum_steps)

        def step(p, o, rng, x, y):
            time.sleep(sleeps.get(grad_accum_steps, 0.0))
            return p, o, {"loss": jnp.float32(0.0)}

        return step

    monkeypatch.setattr(jstep, "make_fast_train_step", fake_factory)
    # no model: the fake steps never read one (each init compiles for seconds)
    monkeypatch.setattr(jmodel, "init_eps_plus_linear", lambda key, cfg_: {})
    monkeypatch.setattr(jmodel, "fast_params_from_reference", lambda *a, **k: ({}, jplans))
    monkeypatch.setattr(at, "_measure_accum_candidate",
                        lambda cfg_, plans_, b, s, dev, seed: timed.append(s) or
                        1e3 * sleeps.get(s, 0.0))
    for cap in (2, 3, 4, 8, 16):  # two batch sizes: each new shape compiles JAX's draws
        for batch in (12, 16):
            built.clear()
            timed.clear()
            jat.autotune_grad_accum(jcfg, jplans, batch, cap_pick=cap)
            at.autotune_grad_accum(cfg, plans, batch, cap_pick=cap, device="cpu")
            want = at.accum_candidates(cap, batch)
            assert timed == built == (want if len(want) > 1 else []), (cap, batch)
    sleeps.update({2: 0.03, 4: 0.01, 8: 0.045})
    assert jat.autotune_grad_accum(jcfg, jplans, 16, cap_pick=2) == 4
    assert at.autotune_grad_accum(cfg, plans, 16, cap_pick=2, device="cpu") == 4
    assert at.autotune_grad_accum(cfg, plans, 16, cap_pick=1, device="cpu") == 1
    assert at.autotune_grad_accum(cfg, plans, 16, 3, cap_pick=2, device="cpu") == 2


# ---------------------------------------------------------------------------
# the ConvSBS tuner against JAX's


def _heuristic_cuts(cfg):
    return [_mim_cut(sbs_supported(spec)[0]) for spec, _ in at._sbs_layer_dims(cfg)]


def _sbs_inject(monkeypatch, jat, cfg, table, model_table=None):
    """Both packages' ConvSBS measurers from ``table[(layer, mim, mcut)]``
    (None: refused); JAX's ``bn`` and ``dcore_dot`` knobs time as their
    (mim, mcut). The whole model: ``model_table[picks]``, else the sum of
    each layer's time at its pick (None: its heuristic)."""
    cuts = _heuristic_cuts(cfg)

    def layer_ms(li, mim, mcut):
        ms = table[(li, mim, mcut)]
        if ms is None:
            raise ValueError("refused")
        return ms

    def model_ms(picks):
        picks = tuple(picks) + (None,) * (len(cuts) - len(picks))
        if model_table and picks in model_table:
            return model_table[picks]
        return sum(layer_ms(li, True, cuts[li]) if p is None else layer_ms(li, p[1], p[0])
                   for li, p in enumerate(picks))

    monkeypatch.setattr(jat, "_measure_sbs_candidate",
                        lambda spec, in_c, in_q, h, w, b, interp, first, key, fo, mim, bn, mcut,
                        dot: layer_ms(0 if in_c == 1 else 1, mim, mcut))
    monkeypatch.setattr(at, "_measure_sbs_candidate",
                        lambda spec, in_c, in_q, h, w, b, dev, first, gen, fo, mim, mcut:
                        layer_ms(0 if in_c == 1 else 1, mim, mcut))
    monkeypatch.setattr(jat, "_measure_sbs_model",
                        lambda cfg_, tuning, *a: model_ms(
                            tuple(None if p is None else (p[1], p[3]) for p in tuning)))
    monkeypatch.setattr(at, "_measure_sbs_model",
                        lambda cfg_, tuning, *a: model_ms(tuple(tuning)))
    return cuts


def _sbs_cfgs(trace_edge):
    *_, jcsm = _jax()
    return (jcsm.ConvSBSModelConfig(num_sbs_layers=2, bond_dim_size=2, trace_edge=trace_edge,
                                    backend="pallas_interpret"),
            ConvSBSModelConfig(num_sbs_layers=2, bond_dim_size=2, trace_edge=trace_edge))


def _as_port(jtuning):
    """JAX picks (bn, mcut, dcore_dot, mim) as the port's (mcut, mim)."""
    return tuple(None if p is None else (p[1], p[3]) for p in jtuning)


@pytest.mark.parametrize("trace_edge", [False, True], ids=["open", "ring"])
@pytest.mark.parametrize("forward_only", [False, True], ids=["train", "serve"])
def test_conv_sbs_picks_equal_jax(trace_edge, forward_only, monkeypatch):
    """One table of ms by (layer, family, merge position): layer 0 takes the
    sequential fold, layer 1 walks its merge position up by two (the first
    step by more than min_gain), and the whole-model gate takes the
    combination both tuners find fastest."""
    *_, jat, _, _ = _jax()
    jcfg, cfg = _sbs_cfgs(trace_edge)
    m0, m1 = _heuristic_cuts(cfg)
    table = {(0, True, m0): 10.0, (0, False, None): 9.0,
             (1, True, m1): 10.0, (1, False, None): 10.2, (1, True, m1 - 1): 10.5,
             (1, True, m1 + 1): 9.0, (1, True, m1 + 2): 8.9, (1, True, m1 + 3): 9.5}
    _sbs_inject(monkeypatch, jat, cfg, table)
    jtuning, _ = jat.autotune_conv_sbs(jcfg, 7, 3, forward_only=forward_only)
    tuning, report = at.autotune_conv_sbs(cfg, 7, 3, device="cpu", forward_only=forward_only)
    assert tuning == _as_port(jtuning) == ((None, False), (m1 + 2, True))
    assert report[-1]["whole_model"] == {"heuristic_ms": 20.0, "best_ms": 17.9, "kept": True}


def test_conv_sbs_heuristic_that_fails_gives_way(monkeypatch):
    """Defect 1 of the JAX tuner, not copied: where a layer's heuristic fold
    fails, JAX's ``better()`` can adopt nothing (autotune.py:943-948), and
    its whole-model baseline then fails, so it keeps every heuristic (the
    run would fail on it). The port takes the fastest fold that ran."""
    *_, jat, _, _ = _jax()
    jcfg, cfg = _sbs_cfgs(False)
    m0, m1 = _heuristic_cuts(cfg)
    table = {(0, True, m0): None, (0, False, None): 9.0, (0, True, m0 - 1): 9.5,
             (0, True, m0 + 1): 9.6,
             (1, True, m1): 10.0, (1, False, None): 10.2, (1, True, m1 - 1): 10.5,
             (1, True, m1 + 1): 9.0, (1, True, m1 + 2): 8.9, (1, True, m1 + 3): 9.5}
    _sbs_inject(monkeypatch, jat, cfg, table)
    jtuning, _ = jat.autotune_conv_sbs(jcfg, 7, 3)
    tuning, report = at.autotune_conv_sbs(cfg, 7, 3, device="cpu")
    assert _as_port(jtuning) == (None, None)
    assert tuning == ((None, False), (m1 + 2, True))
    assert report[0]["candidates"][0] == {"mim": True, "mcut": m0, "failed": "ValueError"}
    assert report[-1]["whole_model"]["heuristic_ms"] is None


def test_conv_sbs_gate_prices_the_heuristic_at_its_ms(monkeypatch):
    """Defect 2 of the JAX tuner, not copied: its gate ranks combinations
    with a layer's heuristic priced at 0 ms (autotune.py:1030), so of 9
    combinations the 8 it measures leave out the two layers' second picks
    together, here the fastest whole model. The port prices each option at
    its measured ms, measures all 8 non-heuristic combinations and finds
    it."""
    *_, jat, _, _ = _jax()
    jcfg, cfg = _sbs_cfgs(False)
    m0, m1 = _heuristic_cuts(cfg)
    table = {}
    for li, m in enumerate((m0, m1)):
        table.update({(li, True, m): 10.0, (li, False, None): 10.6, (li, True, m - 1): 9.4,
                      (li, True, m - 2): 9.3})
    second = ((m0 - 1, True), (m1 - 1, True))
    _sbs_inject(monkeypatch, jat, cfg, table, {second: 15.0})
    jtuning, _ = jat.autotune_conv_sbs(jcfg, 7, 3)
    tuning, _ = at.autotune_conv_sbs(cfg, 7, 3, device="cpu")
    assert _as_port(jtuning) == ((m0 - 2, True), (m1 - 2, True))
    assert tuning == second


# ---------------------------------------------------------------------------
# the cache


def test_cache_hit_illegal_entry_corrupt_file_and_key(monkeypatch):
    """A hit measures nothing; an entry whose picks the planner no longer
    takes is measured again; a corrupt file is a miss (and is replaced by
    a good one); the key names "cpu" and the objective; the path is the
    environment's. The accumulation and ConvSBS picks hit the same way."""
    path = at.default_cache_path()
    assert path == os.environ[at.CACHE_ENV]
    calls = []
    monkeypatch.setattr(at, "_measure_candidate",
                        lambda c, q, h, w, k, o, n1, *a, **kw: calls.append(n1) or 1.0 / n1)
    cfg = _cfg(SMALL)
    plans, _ = at.autotune_splits(cfg, 4, device="cpu", cache_path=path)
    first = len(calls)
    assert first > 0
    again, report = at.autotune_splits(cfg, 4, device="cpu", cache_path=path)
    assert len(calls) == first and again == plans and all(r["cached"] for r in report)
    assert at.autotune_cache_lookup(cfg, 4, device="cpu", cache_path=path)[0] == plans
    assert at.autotune_cache_lookup(cfg, 4, device="cpu", forward_only=True,
                                    cache_path=path) is None
    with open(path) as f:
        data = json.load(f)
    (key,) = data
    assert json.loads(key)["device"] == "cpu" and json.loads(key)["objective"] == "train"
    data[key]["picks"] = [99, 99]
    with open(path, "w") as f:
        json.dump(data, f)
    assert at.autotune_splits(cfg, 4, device="cpu", cache_path=path)[0] == plans
    assert len(calls) == 2 * first
    with open(path, "w") as f:
        f.write("{not json")
    assert at.autotune_splits(cfg, 4, device="cpu", cache_path=path)[0] == plans
    assert len(calls) == 3 * first
    with open(path) as f:
        (key,) = json.load(f)
    assert json.loads(key)["device"] == "cpu"

    monkeypatch.setattr(at, "_measure_accum_candidate",
                        lambda cfg_, plans_, b, s, dev, seed: calls.append(s) or 10.0 / s)
    assert at.autotune_grad_accum(cfg, plans, 16, cap_pick=2, device="cpu",
                                  cache_path=path) == 8
    n = len(calls)
    assert at.autotune_grad_accum(cfg, plans, 16, cap_pick=2, device="cpu",
                                  cache_path=path) == 8 and len(calls) == n
    scfg = ConvSBSModelConfig(num_sbs_layers=2, bond_dim_size=2)
    monkeypatch.setattr(at, "_measure_sbs_candidate", lambda *a: calls.append(a) or 1.0)
    tuning, _ = at.autotune_conv_sbs(scfg, 7, 3, device="cpu", cache_path=path)
    n = len(calls)
    assert at.autotune_conv_sbs(scfg, 7, 3, device="cpu", cache_path=path)[0] == tuning
    assert at.conv_sbs_cache_lookup(scfg, 7, 3, device="cpu", cache_path=path) == tuning
    assert len(calls) == n


# ---------------------------------------------------------------------------
# the plans flow through the runner; train states across packages


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The runner on one device from one seeded init npz: the default
    splits 4 iterations; the tuned splits (an injected measurer makes n1 =
    2 fastest in both layers) 4 iterations and 2 (its train state)."""
    tmp = tmp_path_factory.mktemp("runs")
    cfg = EPSesPlusLinearConfig(epses_specs=SPECS, image_size=28, q0=2)
    init = str(tmp / "init.npz")
    save_params_npz(init_eps_plus_linear(torch.Generator().manual_seed(5), cfg), init)
    out = {"init": init, "tmp": tmp}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(at.CACHE_ENV, str(tmp / "cache.json"))
        mp.setattr(at, "_measure_candidate", _split_measurer(2))
        for name, iters, tune in (("default", 4, False), ("tuned", 4, True), ("tuned2", 2, True)):
            state = trunner.run(experiments_dir=str(tmp / name), device="cpu",
                                load_model_state=init, max_num_iters=iters,
                                autotune_splits=tune, **RECIPE)
            out[name] = (state, state.extras["output_dir"])
    return out


def _reference(state):
    ref = state.extras["params_view"](state.params)
    return {"epses": [c.detach().numpy() for c in ref["epses"]],
            "linear": {k: v.detach().numpy() for k, v in ref["linear"].items()}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _moves(init, got, want, what):
    for i, (s, a, b) in enumerate(zip(_leaves(init), _leaves(got), _leaves(want), strict=True)):
        ma, mb = a.astype(np.float64) - s, b.astype(np.float64) - s
        scale = float(np.abs(mb).max())
        assert scale > 1e-5, f"{what}: leaf {i} did not move"
        np.testing.assert_allclose(ma, mb, rtol=0, atol=MOVE_TOL * scale, err_msg=f"{what} {i}")


def test_tuned_splits_train_like_the_default_splits(runs):
    """The runner's --autotune-splits run trains at its picks (2, 2), not
    the defaults (4, 3): every parameter's move agrees with the default-
    split run's within MOVE_TOL; it writes ``autotune_report.json`` and its
    train state records the splits (``eps_splits``)."""
    init = load_params_npz(runs["init"])
    tuned, tuned_dir = runs["tuned"]
    default, _ = runs["default"]
    assert tuned.num_iters_done == 4
    assert [p["n1"] for p in tuned.extras["model"].plans] == TUNED
    assert [tuple(c.shape) for c in tuned.extras["model"].cmts] != [
        tuple(c.shape) for c in default.extras["model"].cmts]
    _moves(init, _reference(tuned), _reference(default), "tuned vs default")
    with open(os.path.join(tuned_dir, "autotune_report.json")) as f:
        report = json.load(f)
    assert [r["picked_n1"] for r in report] == TUNED and [r["model_n1"] for r in report] == [4, 3]
    with np.load(os.path.join(tuned_dir, "train_state_latest.npz")) as d:
        assert d["eps_splits"].tolist() == TUNED
    with open(os.path.join(tuned_dir, "log.log")) as f:
        assert "EPS splits (2, 2) (the defaults (4, 3))" in f.read()


def test_tuned_train_state_resumes_in_both_packages(runs, monkeypatch):
    """The tuned run's train state at iteration 2 resumes: in the port at
    the default splits (converted) and at the tuned ones (bit-equal to the
    unbroken tuned run), and in the JAX runner (its resume path converts by
    ``eps_splits``), each to 4 within MOVE_TOL of the default-split run."""
    jax, *_ = _jax()
    from dctn_tpu.cli import runner as jrunner

    init = load_params_npz(runs["init"])
    tmp, want = runs["tmp"], _reference(runs["default"][0])
    state = os.path.join(runs["tuned2"][1], "train_state_latest.npz")
    common = dict(RECIPE, load_model_state=runs["init"], max_num_iters=4, resume_from=state)
    converted = trunner.run(experiments_dir=str(tmp / "resumed_default"), device="cpu", **common)
    _moves(init, _reference(converted), want, "port, default splits")
    monkeypatch.setattr(at, "_measure_candidate", _split_measurer(2))
    same = trunner.run(experiments_dir=str(tmp / "resumed_tuned"), device="cpu",
                       autotune_splits=True, **common)
    for a, b in zip(_leaves(_reference(same)), _leaves(_reference(runs["tuned"][0]))):
        np.testing.assert_array_equal(a, b)
    jstate = jrunner.run(experiments_dir=str(tmp / "resumed_jax"), autotune_cache=False, **common)
    assert jstate.num_iters_done == 4
    _moves(init, jax.tree_util.tree_map(np.asarray, jstate.params), want, "JAX resume")


def test_fast_forward_at_tuned_splits_equals_jax():
    """The port's fast forward at a non-default split against the JAX
    package's ``eps_plus_linear_forward_fast`` (interpret-mode kernels) at
    the same plans, float32."""
    jax, jm, jmodel, *_ = _jax()
    import jax.numpy as jnp

    jcfg = _jcfg(SPECS, 10)
    cfg = _cfg(SPECS, 10)
    jparams = jm.init_eps_plus_linear(jax.random.PRNGKey(2), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    plans = tuple({**p, "n1": n1} for p, n1 in zip(fast_layer_plans(cfg), TUNED))
    jplans = tuple({**p, "n1": n1} for p, n1 in zip(jmodel.fast_layer_plans(jcfg), TUNED))
    x = np.random.default_rng(2).uniform(size=(1, 3, 10, 10, 2)).astype(np.float32)
    jfast, _ = jmodel.fast_params_from_reference(jparams, jcfg, plans=jplans)
    ref = np.asarray(jmodel.eps_plus_linear_forward_fast(jfast, jnp.asarray(x), jcfg, jplans))
    fast, _ = fast_params_from_reference(params, cfg, plans)
    got = eps_plus_linear_forward_fast(fast, torch.as_tensor(x), cfg, plans).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())
    default = EPSesPlusLinear.from_reference(params, cfg)
    with torch.inference_mode():
        np.testing.assert_allclose(default(torch.as_tensor(x)).numpy(), got, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the CLIs on --device cpu


def test_export_tunes_serving_splits_and_predict_serves_them(runs, tmp_path, monkeypatch):
    """``--autotune-splits`` measures the SERVING objective (the forward,
    f32 or int8) at the largest batch, bakes the picks in and records
    ``autotuned_splits``; the artifact equals the eager model at those
    splits; ``predict`` and ``serve`` serve it; ``--autotune-cache`` alone then exports
    at the cached picks without measuring."""
    seen = []

    def measure(c, q, h, w, k, o, n1, batch, *a, forward_only=False, quantize=None):
        seen.append((batch, forward_only, quantize))
        return 1.0 if n1 == 2 else 2.0

    monkeypatch.setattr(at, "_measure_candidate", measure)
    params = params_from_numpy(load_params_npz(runs["init"]))
    cfg = EPSesPlusLinearConfig(epses_specs=SPECS, image_size=28, q0=2)
    plans = tuple({**p, "n1": n1} for p, n1 in zip(fast_layer_plans(cfg), TUNED))
    args = dict(checkpoint=runs["init"], epses_specs=SPECS, batch_sizes=(1, 4), device="cpu")
    for quantize in ("none", "int8"):
        seen.clear()
        out = str(tmp_path / f"{quantize}.zip")
        texport.run(out=out, quantize=quantize, autotune_splits=True, autotune_cache=True,
                    **args)
        assert seen and set(seen) == {(4, True, None if quantize == "none" else "int8")}
        meta, fns = texport.load_artifact(out)
        assert meta["autotuned_splits"] == TUNED
        if quantize == "none":
            x = torch.rand((1, 4, 28, 28, 2), generator=torch.Generator().manual_seed(0))
            with torch.inference_mode():
                assert torch.equal(fns[4](x), EPSesPlusLinear.from_reference(
                    params, cfg, plans=plans)(x))
            result = tpredict.run(checkpoint=out, ds_type="fashionmnist", ds_path="synthetic",
                                  batch_size=4, device="cpu", synthetic_sizes=(8, 8, 8))
            assert len(result.preds) == 8
            served = tserve.ArtifactModel(out)
            try:
                np.testing.assert_array_equal(served.predict(x[:, :3].numpy()),
                                              fns[4](torch.cat([x[:, :3], x[:, 2:3]], 1))[:3]
                                              .numpy())
            finally:
                served.close()
    seen.clear()
    texport.run(out=str(tmp_path / "cached.zip"), autotune_cache=True, **args)
    assert not seen
    assert texport.load_artifact(str(tmp_path / "cached.zip"))[0]["autotuned_splits"] == TUNED


def _sbs_fwd_cuts(artifact):
    """Each ``sbs_fwd`` node's merge position in an artifact's program."""
    _, fns = texport.load_artifact(artifact)
    cuts = {bs: [n.args[3] for n in fn.graph.nodes
                 if n.op == "call_function" and "sbs_fwd" in str(n.target)]
            for bs, fn in fns.items()}
    (one,) = {tuple(c) for c in cuts.values()}  # every entry point the same
    return list(one)


def test_legacy_runner_trains_at_training_picks_and_exports_serving_picks(tmp_path,
                                                                         monkeypatch):
    """``--autotune-kernels`` trains at the training objective's picks and
    ``--export-artifact`` re-tunes at the serving objective, whose picks
    the artifact's folds take. Defect 3 of the JAX legacy runner, not
    copied: with the cache alone it exports the training picks
    (legacy_runner.py:700-730); the port looks the serving key up, and
    without a serving entry exports the kernels' own picks."""
    cfg = ConvSBSModelConfig(num_sbs_layers=2, bond_dim_size=2)
    m0, m1 = _heuristic_cuts(cfg)

    def layer_ms(li, forward_only, mim, mcut):
        best = ((0, False, None), (1, True, m1 + 1)) if forward_only else ((1, True, m1 - 1),)
        return 5.0 if (li, mim, mcut) in best else 10.0

    def model_ms(cfg_, tuning, image_size, batch, dev, forward_only, gen):
        tuning = tuple(tuning) + (None,) * (2 - len(tuning))
        return sum(layer_ms(li, forward_only, *((True, m) if p is None else (p[1], p[0])))
                   for li, (p, m) in enumerate(zip(tuning, (m0, m1))))

    monkeypatch.setattr(at, "_measure_sbs_candidate",
                        lambda spec, in_c, in_q, h, w, b, dev, first, gen, fo, mim, mcut:
                        layer_ms(0 if in_c == 1 else 1, fo, mim, mcut))
    monkeypatch.setattr(at, "_measure_sbs_model", model_ms)
    kw = dict(ds_path="synthetic", num_sbs_layers=2, bond_dim_size=2, device="cpu",
              synthetic_sizes=(32, 16), batch_size=16, epochs=1, warmup_num_epochs=0,
              export_batch_sizes="4", tb_log_every_n_epochs=0)
    art = str(tmp_path / "a.zip")
    tlegacy.run(models_dir=str(tmp_path / "tuned"), autotune_kernels=True, autotune_cache=True,
                export_artifact=art, **kw)
    with open(tmp_path / "tuned" / "autotune_report.json") as f:
        assert json.load(f)[0]["picked"] is None
    with open(tmp_path / "tuned" / "log.log") as f:
        assert f"conv_sbs kernel_tuning: (None, ({m1 - 1}, True))" in f.read()
    assert _sbs_fwd_cuts(art) == [None, None, m1 + 1]
    cached = str(tmp_path / "cached.zip")
    tlegacy.run(models_dir=str(tmp_path / "cached"), autotune_cache=True, export_artifact=cached,
                **kw)
    assert _sbs_fwd_cuts(cached) == [None, None, m1 + 1]
    os.remove(os.environ[at.CACHE_ENV])  # a cache with the training entry alone
    at.autotune_conv_sbs(cfg, 28, 16, device="cpu", cache_path=os.environ[at.CACHE_ENV])
    lkw = dict(autotune_kernels=False, autotune_cache=True, seed=0)
    assert tlegacy._serving_tuning(lkw, cfg, 28, 4, torch.device("cpu")) == ()


def test_no_flag_of_the_autotuner_is_refused(tmp_path):
    """ROADMAP item 20's flags are accepted by every CLI; what the runner
    and export still refuse is ``--compute-dtype bfloat16`` beside the flags
    of ROADMAP item 14b."""
    assert [r[0] for r in trunner.REFUSED] == ["qat", "model_devices", "space_devices"]
    assert [r[0] for r in texport.REFUSED] == ["space_devices"]
    assert not hasattr(tlegacy, "REFUSED")
    kw = fill_defaults(trunner.main, dict(RECIPE, experiments_dir=str(tmp_path),
                                          autotune_splits=True, autotune_cache=True))
    trunner._validate(kw)
    for cmd in (trunner.main, tlegacy.main, texport.main):
        text = " ".join(p.help or "" for p in cmd.params if "autotune" in p.name)
        assert text and "not ported" not in text and "item 20" not in text


def test_autotune_and_viz_import_no_jax():
    code = ("import sys, dctn_tpu_torch.train.autotune, dctn_tpu_torch.viz, "
            "dctn_tpu_torch.viz.plotting, dctn_tpu_torch.viz.interactive, "
            "dctn_tpu_torch.viz.make_plot_config\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dctn_tpu', 'matplotlib'))\n"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


# ---------------------------------------------------------------------------
# two ranks: rank 0's picks everywhere


def _rank_split_measurer(rank):
    """Rank 0 finds n1 = 2 fastest, rank 1 the defaults."""
    return _split_measurer(2) if rank == 0 else (lambda c, q, h, w, k, o, n1, *a, **kw:
                                                 1.0 if n1 in (4, 3) else 2.0)


def job_broadcast(mesh, tmp):
    """Each rank's splits, accumulation and ConvSBS picks after the
    runners' tuning, with rank-dependent times, the lookup-only path too;
    rank 0 returns every rank's."""
    at._measure_candidate = _rank_split_measurer(mesh.rank)
    at._measure_accum_candidate = lambda cfg, plans, b, s, dev, seed: (
        1.0 if s == (2 if mesh.rank == 0 else 4) else 2.0)
    at._measure_sbs_candidate = lambda spec, in_c, *a: (
        1.0 if (mesh.rank == 0) == (a[-2] is False) else 2.0)
    at._measure_sbs_model = lambda cfg, tuning, *a: 1.0 if any(tuning) else 2.0
    os.environ[at.CACHE_ENV] = os.path.join(tmp, f"cache{mesh.rank}.json")
    cfg = EPSesPlusLinearConfig(epses_specs=SPECS, image_size=28, q0=2)
    base = fast_layer_plans(cfg)
    kw = fill_defaults(trunner.main, dict(RECIPE, experiments_dir=tmp, autotune_splits=True,
                                          autotune_cache=True))
    trunner._validate(kw)
    kw["output_dir"] = tmp
    dev = torch.device("cpu")
    tuned = trunner._tuned_plans(kw, cfg, base, 1, 8, dev, mesh, True, None, mesh.rank == 0)
    looked_up = trunner._tuned_plans(dict(kw, autotune_splits=False), cfg, base, 1, 8, dev, mesh,
                                     True, None, False)
    resolve = trunner.resolve_auto_grad_accum
    trunner.resolve_auto_grad_accum = lambda *a: 2
    try:
        accum = trunner._auto_grad_accum(kw, cfg, tuned, 8, 1, dev, mesh, True)
    finally:
        trunner.resolve_auto_grad_accum = resolve
    scfg = ConvSBSModelConfig(num_sbs_layers=2, bond_dim_size=2)
    lkw = dict(autotune_kernels=True, autotune_cache=False, seed=0, models_dir=tmp)
    sbs = tlegacy._tuned_config(lkw, scfg, 12, 4, dev, mesh, False).kernel_tuning
    shapes = [tuple(c.shape) for c in fast_params_from_reference(
        init_eps_plus_linear(torch.Generator().manual_seed(0), cfg), cfg, tuned)[0]["epses_cmt"]]
    mine = ([p["n1"] for p in tuned], [p["n1"] for p in looked_up], accum, sbs, shapes)
    return mesh.all_gather_object(mine)


def job_tp_runner(mesh, kw):
    """The runner on a (data 1, model 2) grid of the pool's two ranks with
    rank-dependent split times; rank 0 returns its reference params and
    out dir."""
    at._measure_candidate = _rank_split_measurer(mesh.rank)
    kw = fill_defaults(trunner.main, dict(kw))
    trunner._validate(kw)
    out = trunner._run_rank(make_grid(mesh, "model", 1, 2), kw)
    return {"params": {"epses": [c.numpy() for c in out["params"]["epses"]],
                       "linear": {k: v.numpy() for k, v in out["params"]["linear"].items()}},
            "iters": out["num_iters_done"], "output_dir": out["output_dir"]}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(Job(2, 2, Host(), "cpu", threads=1))
    yield p
    p.close()


def test_rank_0_picks_reach_every_rank(pool, tmp_path):
    """With rank-dependent times (rank 1 alone would keep the defaults, or
    accumulate 4, or keep the meet-in-the-middle folds), both ranks end
    with rank 0's splits, looked up from rank 0's cache too, its
    accumulation and its ConvSBS picks, and equal cmt shapes."""
    per_rank = pool.run(job_broadcast, str(tmp_path), timeout=TIMEOUT_S)
    assert len(per_rank) == 2 and per_rank[0] == per_rank[1]
    splits, looked_up, accum, sbs, _ = per_rank[0]
    assert splits == looked_up == TUNED and accum == 2
    assert all(p is not None and p[1] is False for p in sbs)


def test_tensor_parallel_runner_trains_at_tuned_splits(pool, runs, tmp_path):
    """``--model-devices 2 --autotune-splits`` (the fast layout's row
    blocks built from the tuned plans, the plans-flow repair): both ranks
    take rank 0's picks, train 4 iterations, and move within MOVE_TOL of
    the default-split run on one device."""
    out = pool.run(job_tp_runner, dict(RECIPE, experiments_dir=str(tmp_path), device="cpu",
                                       load_model_state=runs["init"], max_num_iters=4,
                                       model_devices=2, autotune_splits=True),
                   timeout=TIMEOUT_S)
    assert out["iters"] == 4
    with open(os.path.join(out["output_dir"], "autotune_report.json")) as f:
        assert [r["picked_n1"] for r in json.load(f)] == TUNED
    with open(os.path.join(out["output_dir"], "log.log")) as f:
        log = f.read()
    assert re.search(r"tensor parallelism: grid \(data=1, model=2\)", log)
    assert "measures unsharded layer shapes" in log
    _moves(load_params_npz(runs["init"]), out["params"], _reference(runs["default"][0]),
           "TP at the tuned splits")
