"""The port's inits, composition ops, parameter dropout and frozen cores
against the JAX package, on the CPU.

Inputs come from numpy and go to both packages. The JAX package's draws
(its unit-normal cores, its dropout masks) cross to the port as numpy
arrays, so both compute on the same numbers; where a draw cannot cross (a
manual init's normal or uniform core), shapes and ranges are compared. The
comparisons run in float64 on both sides (the tests run JAX with x64), so
their tolerances are a few hundred float64 roundings: the two packages sum
in other orders, and nothing else differs. The CUDA kernels themselves are
held against the plain versions on the card (``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctn_tpu import models as jm
from dctn_tpu.ops import composition as jcomp
from dctn_tpu.train import make_optimizer as jax_make_optimizer
from dctn_tpu.train import make_train_step as jax_make_train_step
from dctn_tpu.utils import misc as jmisc
from dctn_tpu_torch.interop import params_from_numpy
from dctn_tpu_torch.kernels import eps_kernels as K
from dctn_tpu_torch.models import (
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    init_eps_plus_linear,
    intermediate_reps_stats,
    reference_params_from_fast,
)
from dctn_tpu_torch.ops import composition as tcomp
from dctn_tpu_torch.train import make_fast_train_step, make_optimizer
from dctn_tpu_torch.utils import misc as tmisc

# layer 1 (n = 9, q = 4) takes the saved-t backward (A = 4^5 ≥ 512), as the
# flagship's does; layer 0 is narrow, to keep the JAX package's compiles short
SPECS = ((2, 4), (3, 3))
# float64 on both sides: sums over ≤ 2^16 terms in other orders
RTOL64 = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _data(c, n, size, q, seed=0):
    """φ-like features in [0, 1): every factor positive, as the data's."""
    return np.random.default_rng(seed).uniform(size=(c, n, size, size, q))


def _params(specs, image_size, seed=0):
    """Reference-layout params at the theoretical init's scale, drawn with
    numpy (JAX's own draws would compile a sampler per shape), for both
    packages: (numpy tree, JAX tree)."""
    rng = np.random.default_rng(seed)
    cores, q, size = [], 2, image_size
    for k, o in specs:
        cores.append(rng.normal(size=(q,) * (k * k) + (o,)) * q ** (-k * k / 2))
        q, size = o, size - k + 1
    n_in = size * size * q
    np_params = {"epses": tuple(cores), "linear": {
        "w": rng.normal(size=(n_in, 10)) * n_in**-0.5 / 4,
        "b": rng.uniform(-(n_in**-0.5), n_in**-0.5, size=(10,)),
    }}
    return np_params, jax.tree_util.tree_map(jnp.asarray, np_params)


@pytest.mark.parametrize("specs,q0,size", [
    (((2, 4), (2, 3)), 2, 7),  # layer 0 merges factor pairs (q = 2)
    (((2, 4), (3, 2)), 3, 8),  # Q₀ = 3, as the colored CIFAR data
])
def test_empirical_init_matches_jax_on_its_draws(specs, q0, size):
    """``make_unit_empirical_output_std`` on the JAX package's unit-normal
    draws (its key chain: one split per layer): the scaled cores, and so
    every layer's input, equal JAX's within RTOL64. 14 images in slices of
    8 (a ragged last slice)."""
    x = _data(1, 14, size, q0)
    key = jax.random.PRNGKey(5)
    want = jcomp.make_unit_empirical_output_std(key, specs, jnp.asarray(x), jnp.float64, 8)
    shapes, c, q = [], 1, q0
    for k, o in specs:
        shapes.append((q,) * (k * k * c) + (o,))
        q = o
    draws = [np.asarray(jax.random.normal(k, s, jnp.float64))
             for k, s in zip(jax.random.split(key, len(specs)), shapes)]
    got = tcomp.make_unit_empirical_output_std(
        None, specs, torch.tensor(x), torch.float64, 8,
        unit_cores=[torch.tensor(d) for d in draws],
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL64, atol=0)
    # the first core's output on the subset has std 1 (the init's point)
    out = tcomp.contract_with_input(got[:1], torch.tensor(x))
    assert float(out.std(correction=0)) == pytest.approx(1.0, rel=1e-12)


def test_composition_ops_and_intermediate_stats_match_jax():
    """``contract_with_input``, ``epswise_squared_fro_norm`` and
    ``intermediate_reps_stats`` (which runs ``transform_in_slices`` and the
    rank-one window statistics) against JAX, float64."""
    specs = ((2, 4), (2, 3))
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=specs, image_size=7, q0=2, dtype=jnp.float64)
    np_params, jparams = _params(specs, 7, seed=1)
    params = params_from_numpy(np_params, dtype=torch.float64)
    x = _data(1, 9, 7, 2, seed=2)
    np.testing.assert_allclose(
        tcomp.contract_with_input(params["epses"], torch.tensor(x)).numpy(),
        np.asarray(jcomp.contract_with_input(jparams["epses"], jnp.asarray(x))), rtol=RTOL64,
    )
    assert float(tcomp.epswise_squared_fro_norm(params["epses"])) == pytest.approx(
        float(jcomp.epswise_squared_fro_norm(jparams["epses"])), rel=RTOL64)
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=7, q0=2, dtype=torch.float64)
    got = intermediate_reps_stats(params, torch.tensor(x), cfg, batch_size=4)
    want = jm.intermediate_reps_stats(jparams, jnp.asarray(x), jcfg, batch_size=4)
    assert got.keys() == want.keys()
    for name in want:
        for k in ("mean", "std", "second_moment"):
            assert got[name][k] == pytest.approx(want[name][k], rel=1e-9, abs=1e-12), (name, k)


def test_manual_and_from_file_inits(tmp_path):
    """The manual family: from-file cores equal the file in both packages;
    normal and uniform cores and the classifier's manual inits have JAX's
    shapes and their distributions' scale (the two RNGs differ, so the draws
    cannot be compared)."""
    specs = ((2, 4), (2, 3))
    core0 = np.random.default_rng(3).normal(size=(2,) * 4 + (4,))
    path = str(tmp_path / "core0.npy")
    np.save(path, core0)
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=specs, image_size=8, q0=2, dtype=jnp.float64)
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=8, q0=2, dtype=torch.float64)
    want = jm.init_eps_plus_linear(
        jax.random.PRNGKey(0), jcfg, "manual",
        eps_inits=(jmisc.FromFileInit(path), jmisc.ZeroCenteredNormalInit(0.5)),
        linear_weight_init=jmisc.ZeroCenteredUniformInit(0.25),
        linear_bias_init=jmisc.ZeroCenteredUniformInit(0.125),
    )
    for cores in ((tmisc.FromFileInit(path), tmisc.ZeroCenteredNormalInit(0.5)),
                  (tmisc.FromFileInit(path), tmisc.ZeroCenteredUniformInit(0.5))):
        got = init_eps_plus_linear(
            torch.Generator().manual_seed(0), cfg, "manual", eps_inits=cores,
            linear_weight_init=tmisc.ZeroCenteredUniformInit(0.25),
            linear_bias_init=tmisc.ZeroCenteredUniformInit(0.125),
        )
        leaves = jax.tree_util.tree_leaves
        assert [tuple(a.shape) for a in leaves(got)] == [a.shape for a in leaves(want)]
        np.testing.assert_array_equal(got["epses"][0].numpy(), np.asarray(want["epses"][0]))
        c1 = got["epses"][1]
        if isinstance(cores[1], tmisc.ZeroCenteredNormalInit):
            assert float(c1.std()) == pytest.approx(0.5, rel=0.05)
        else:
            assert 0.45 < float(c1.abs().max()) <= 0.5
        assert float(got["linear"]["w"].abs().max()) <= 0.25
        assert float(got["linear"]["b"].abs().max()) <= 0.125
    bad = str(tmp_path / "bad.npy")
    np.save(bad, core0[..., :2])
    with pytest.raises(ValueError, match="core shape"):
        init_eps_plus_linear(torch.Generator(), cfg, "manual",
                             eps_inits=(tmisc.FromFileInit(bad), tmisc.ZeroCenteredNormalInit(1.0)))


def _step_setup(dropout_p=1.0, image_size=8, batch=16, seed=0, specs=SPECS):
    """``specs`` at 8×8 in float64, JAX's params, uniform features."""
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=specs, image_size=image_size, q0=2,
                                    dropout_p=dropout_p, dtype=jnp.float64)
    np_params, jparams = _params(specs, image_size, seed)
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=image_size, q0=2,
                                dropout_p=dropout_p, dtype=torch.float64)
    x = _data(1, batch, image_size, 2, seed)
    y = np.arange(batch) % 10
    return jcfg, jparams, np_params, cfg, x, y


def _recording_kernels(calls):
    """The plain versions, each call recorded with the layer's out_size."""
    def rec(name, fn):
        def wrapped(*args, **kwargs):
            calls.append((name, args[-1] if name != "fwd" else args[3]))
            return fn(*args, **kwargs)
        return wrapped

    return K.EPSKernels(rec("fwd", K.eps_fwd_reference), rec("dcore", K.eps_dcore_reference),
                        rec("dviews_t", K.eps_dviews_t_reference),
                        rec("dviews_recompute", K.eps_dviews_recompute_reference))


def _assert_params_close(model, cfg, jparams, what):
    got = reference_params_from_fast(model.fast_params(), cfg, model.plans)
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(got),
                                   jax.tree_util.tree_leaves(jparams))):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-8, atol=1e-13,
                                   err_msg=f"{what}: leaf {i}")


def test_dropout_step_matches_jax_with_its_masks():
    """Two Adam steps with parameter dropout (p = 0.8) against JAX's
    reference-layout step: the port takes the masks JAX draws from its step
    key (one split per core, Bernoulli(p) over the core's shape), so the
    two compute on the same dropped cores. Adam moves a parameter by
    ~lr·m/√v, which float64 keeps within rtol 1e-8 of JAX's; the metrics
    within RTOL64·1e3."""
    specs = ((2, 4), (2, 3))
    jcfg, jparams, np_params, cfg, x, y = _step_setup(dropout_p=0.8, specs=specs)
    jopt = jax_make_optimizer("adam", 1e-2)
    jstep = jax_make_train_step(jcfg, jopt, "epswise", 1e-3, donate=False)
    model = EPSesPlusLinear.from_reference(params_from_numpy(np_params, dtype=torch.float64), cfg)
    step = make_fast_train_step(model, make_optimizer("adam", model.parameters(), 1e-2),
                                "epswise", 1e-3)
    shapes = [c.shape for c in jparams["epses"]]
    draw = jax.jit(lambda key: [jax.random.bernoulli(k, 0.8, s)
                                for k, s in zip(jax.random.split(key, len(shapes)), shapes)])
    jstate, p = jopt.init(jparams), jparams
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        masks = tuple(torch.tensor(np.asarray(m)) for m in draw(key))
        assert 0 < float(masks[1].double().mean()) < 1
        p, jstate, jm_ = jstep(p, jstate, key, jnp.asarray(x), jnp.asarray(y))
        m = step(torch.tensor(x), torch.tensor(y), masks=(masks,))
        for k in ("loss", "ce", "reg_term"):
            assert float(m[k]) == pytest.approx(float(jm_[k]), rel=RTOL64 * 1e3), (i, k)
    _assert_params_close(model, cfg, p, "dropout step")


@pytest.mark.parametrize("frozen", [0, 1])
def test_frozen_core_matches_jax_at_weight_decay(frozen):
    """``frozen_eps_indices`` at weight decay 0.05: the frozen core's
    gradient is 0, so Adam moves it by the decay alone, as JAX's step does
    (``mask_frozen``, then ``add_decayed_weights``). Its ``eps_dcore`` never
    runs; with layer 1 frozen and layer 0 trained, layer 1 still computes
    its input's cotangent, from the saved t (K6 with t) and nothing else."""
    jcfg, jparams, np_params, cfg, x, y = _step_setup()
    jopt = jax_make_optimizer("adam", 1e-2, 0.05)
    jstep = jax_make_train_step(jcfg, jopt, "epswise", 0.0, frozen_eps_indices=(frozen,),
                                donate=False)
    model = EPSesPlusLinear.from_reference(params_from_numpy(np_params, dtype=torch.float64), cfg)
    calls = []
    step = make_fast_train_step(model, make_optimizer("adam", model.parameters(), 1e-2, 0.05),
                                kernels=_recording_kernels(calls), frozen_eps_indices=(frozen,))
    jstate, p = jopt.init(jparams), jparams
    for i in range(2):
        p, jstate, _ = jstep(p, jstate, jax.random.PRNGKey(i), jnp.asarray(x), jnp.asarray(y))
        step(torch.tensor(x), torch.tensor(y))
    _assert_params_close(model, cfg, p, f"frozen {frozen}")
    start = np.asarray(jparams["epses"][frozen])
    moved = np.abs(np.asarray(p["epses"][frozen]) - start).max()
    assert 0 < moved < 0.05  # by the decay only: Adam's first steps move a free core by ~lr
    outs = [o for _, o in SPECS]
    per_step = [(n, outs.index(o)) for n, o in calls[: len(calls) // 2]]
    if frozen == 0:  # layer 1's input needs no gradient: d_cmt of layer 1 alone
        assert sorted(per_step) == [("dcore", 1), ("fwd", 0), ("fwd", 1)]
    else:  # layer 0's d_cmt, and layer 1's d_views from its saved t
        assert sorted(per_step) == [("dcore", 0), ("dviews_t", 1), ("fwd", 0), ("fwd", 1)]
