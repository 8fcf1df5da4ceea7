"""The port's legacy ConvSBS model (forward, gradients, helpers, warmup,
optimizers, inits, weights interop) against the JAX package, on the CPU.

Weights cross as numpy (``interop.conv_sbs_params_from_numpy``), inputs are
made with numpy. The JAX side runs its ``backend="xla"`` reference-layout
model in float64; the port runs its batch-minor pipeline (the kernels'
plain versions on CPU tensors) and its reference-layout forward. Float64
against float64 at rtol 1e-10: the same arithmetic with sums in other
orders. The models follow the legacy runner's recipe (the window-std input
multiplier, every layer scaled to unit output std on the batch), so their
logits and gradients are of order 1: with Khrulkov cores alone the 5×5
model's logits are ~1e-18, and a wrong gradient would hide under any
absolute tolerance.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dctn_tpu.interop import torch_checkpoint as jtc
from dctn_tpu.models import conv_sbs_model as jm
from dctn_tpu.ops import sbs as jsbs
from dctn_tpu.train.checkpoint import load_pytree, save_pytree
from dctn_tpu_torch import interop
from dctn_tpu_torch.models import conv_sbs_model as tm
from dctn_tpu_torch.ops import sbs as tsbs
from dctn_tpu_torch.train import load_conv_sbs_params_npz, save_conv_sbs_params_npz


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# jitted: eagerly, each of its many small ops compiles alone
_jax_window_std = jax.jit(jm.calc_std_of_coordinates_of_windows, static_argnums=(1, 2, 3))


@functools.lru_cache(maxsize=None)
def _setup(layers, trace_edge, bond=2, seed=0, batch=3, scaled=True):
    """Configs, float64 weights and pixels on the runner's recipe: the input
    multiplier that makes the window coordinates' std 1, Khrulkov cores
    and, with ``scaled``, every layer scaled on the pixels (by the port's
    ``scale_layers_using_batch``, which the test below holds to JAX's; the
    weights then cross to both packages as numpy)."""
    size = 2 * layers + 1  # each 3×3 layer takes 2 rows; one pixel left at the end
    x = np.random.default_rng(seed).uniform(size=(batch, size, size))
    std = float(_jax_window_std(jnp.asarray(x), 3, False, 1.0))
    kw = dict(num_sbs_layers=layers, bond_dim_size=bond, trace_edge=trace_edge,
              input_multiplier=std ** (-1.0 / 9.0))
    jcfg, tcfg = jm.ConvSBSModelConfig(**kw), tm.ConvSBSModelConfig(**kw)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init_conv_sbs_model(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float64)
    )
    if scaled:
        params = jax.tree_util.tree_map(
            lambda t: t.numpy(),
            tm.scale_layers_using_batch(interop.conv_sbs_params_from_numpy(params), tcfg,
                                        torch.from_numpy(x)),
        )
    return jcfg, tcfg, params, x


def _close(got, want, rtol=1e-10, atol=0.0, what=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), rtol=rtol, atol=atol, err_msg=what,
    )


def _close_to_order_one(got, want, rtol=1e-10, what=""):
    """``got`` equals ``want``, an array whose largest entry is of order 1,
    entrywise within rtol of each entry or of that largest one."""
    scale = float(np.abs(np.asarray(want)).max())
    assert scale > 1e-2, f"{what}: max|ref| {scale} is too small to show an error"
    _close(got, want, rtol=rtol, atol=rtol * scale, what=what)


@pytest.mark.parametrize("layers", [2, 3])
@pytest.mark.parametrize("trace_edge", [False, True])
def test_model_forward_matches_jax_xla_f64(layers, trace_edge):
    jcfg, tcfg, np_params, x = _setup(layers, trace_edge)
    want = jax.jit(lambda p, xx: jm.conv_sbs_model_forward(p, jcfg, xx))(
        jax.tree_util.tree_map(jnp.asarray, np_params), jnp.asarray(x)
    )
    params = interop.conv_sbs_params_from_numpy(np_params)
    xt = torch.from_numpy(x)
    got_t = tm.conv_sbs_model_forward_t(params, tcfg, xt)
    got_ref = tm.conv_sbs_model_forward(params, tcfg, xt)
    got_mod = tm.ConvSBSModel(params, tcfg)(xt)
    assert got_t.shape == want.shape == (3, 10)
    assert float(np.abs(np.asarray(want)).max()) > 0.5  # logits of order 1
    for got in (got_t, got_ref, got_mod):
        _close(got, want)


def _jax_ce(jcfg, p, xx, yy):
    lp = jax.nn.log_softmax(jm.conv_sbs_model_forward(p, jcfg, xx))
    return -jnp.mean(jnp.take_along_axis(lp, yy[:, None], axis=1))


@pytest.mark.parametrize("trace_edge", [False, True])
def test_gradients_and_layer0_input_gradient_match_jax_xla_f64(trace_edge):
    """The CE's gradients in every core and in the pixels. The pixels'
    gradient runs back through layer 0's d_views (which the JAX Pallas
    pipeline hard-codes off and returns as zeros): here it is the true one,
    nonzero, and equal to the XLA model's."""
    jcfg, tcfg, np_params, x = _setup(2, trace_edge)
    y = np.array([1, 4, 9])
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    gp_j, gx_j = jax.jit(jax.grad(lambda p, xx: _jax_ce(jcfg, p, xx, jnp.asarray(y)),
                                  argnums=(0, 1)))(jp, jnp.asarray(x))
    model = tm.ConvSBSModel(interop.conv_sbs_params_from_numpy(np_params), tcfg)
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.nn.functional.cross_entropy(model(xt), torch.from_numpy(y)).backward()
    for i, (a, b) in enumerate(zip(model.parameters(), jax.tree_util.tree_leaves(gp_j))):
        _close_to_order_one(a.grad, b, what=f"core {i}")
    _close_to_order_one(xt.grad, gx_j, what="pixels")
    # with pixels that need no gradient, layer 0 skips its d_views and the
    # cores' gradients stay the same
    model.zero_grad()
    torch.nn.functional.cross_entropy(model(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    for i, (a, b) in enumerate(zip(model.parameters(), jax.tree_util.tree_leaves(gp_j))):
        _close_to_order_one(a.grad, b, what=f"core {i}, no d_views")


@pytest.mark.parametrize("trace_edge", [False, True])
def test_scale_layers_using_batch_matches_jax_f64(trace_edge):
    jcfg, tcfg, np_params, x = _setup(2, trace_edge, batch=4, scaled=False)
    want = jm.scale_layers_using_batch(
        jax.tree_util.tree_map(jnp.asarray, np_params), jcfg, jnp.asarray(x)
    )
    got = tm.scale_layers_using_batch(interop.conv_sbs_params_from_numpy(np_params), tcfg,
                                      torch.from_numpy(x))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        _close(a, b)


@pytest.mark.parametrize("cos_sin_squared", [False, True])
def test_quantum_map_and_window_std_match_jax(cos_sin_squared):
    x = np.random.default_rng(1).uniform(size=(4, 6, 6))
    _close(tm.batch_to_quantum(torch.from_numpy(x), cos_sin_squared, 1.3),
           jm.batch_to_quantum(jnp.asarray(x), cos_sin_squared, 1.3))
    _close(tm.calc_std_of_coordinates_of_windows(torch.from_numpy(x), 3, cos_sin_squared, 1.3),
           jm.calc_std_of_coordinates_of_windows(jnp.asarray(x), 3, cos_sin_squared, 1.3))


def test_warmup_schedule_values():
    """LambdaLR's lr, base·multiplier, equals the JAX schedule at each step,
    in f64: m^(W/W) at step 0, m^((W-e)/W) in epoch e, 1 from epoch W on."""
    base, m = 3e-3, 1e-20
    for warmup, spe in ((40, 5), (2, 3), (0, 4)):
        want = jm.make_warmup_lr_schedule(base, warmup, spe, m)
        mult = tm.make_warmup_lr_schedule(warmup, spe, m)
        for step in (0, 1, spe, 2 * spe + 1, warmup * spe - 1, warmup * spe, warmup * spe + 7):
            step = max(step, 0)
            assert base * mult(step) == pytest.approx(float(want(step)), rel=1e-15, abs=0.0)
    mult = tm.make_warmup_lr_schedule(2, 3, 1e-2)
    assert [mult(s) for s in (0, 2, 3, 5, 6, 100)] == [1e-2, 1e-2, 1e-1, 1e-1, 1.0, 1.0]


@pytest.mark.parametrize(
    "opt_kind,opt_kw",
    [
        ("sgd", dict(momentum=0.9, weight_decay=1e-4)),
        ("rmsprop", dict(momentum=0.9, rmsprop_alpha=0.95, weight_decay=1e-4)),
    ],
)
def test_optimizer_trajectory_matches_jax_f64(opt_kind, opt_kw):
    """Three steps of torch's SGD / RMSprop with momentum and weight decay
    under the warmup (LambdaLR, one scheduler step per update) against the
    JAX ``make_legacy_optimizer`` with its schedule, on the same model and
    batches. The CE gradients, not the weight decay, move the weights:
    each core's first gradient is over 5 times its decay term (the decay,
    1e-4 of the weight, still shows a million times over the tolerance),
    and each core moves by over 1e-2 of its largest entry (1e8 times the
    tolerance)."""
    jcfg, tcfg, np_params, _ = _setup(2, False)
    rng = np.random.default_rng(5)
    xs = rng.uniform(size=(3, 4, 5, 5))
    ys = rng.integers(0, 10, (3, 4))
    base, warmup, spe = 3e-2, 2, 1
    opt = jm.make_legacy_optimizer(opt_kind, jm.make_warmup_lr_schedule(base, warmup, spe, 1e-2),
                                   **opt_kw)
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    state = opt.init(params)

    @jax.jit
    def step(p, o, xb, yb):
        grads = jax.grad(lambda pp: _jax_ce(jcfg, pp, xb, yb))(p)
        updates, o = opt.update(grads, o, p)
        return optax.apply_updates(p, updates), o

    model = tm.ConvSBSModel(interop.conv_sbs_params_from_numpy(np_params), tcfg)
    torch.nn.functional.cross_entropy(model(torch.from_numpy(xs[0])),
                                      torch.from_numpy(ys[0])).backward()
    for i, p in enumerate(model.parameters()):
        decay = opt_kw["weight_decay"] * float(p.detach().abs().max())
        assert float(p.grad.abs().max()) > 5 * decay, f"core {i}: gradient below its decay"
    topt = tm.make_legacy_optimizer(opt_kind, model.parameters(), base, **opt_kw)
    sched = torch.optim.lr_scheduler.LambdaLR(topt, tm.make_warmup_lr_schedule(warmup, spe, 1e-2))
    for i in range(3):
        params, state = step(params, state, jnp.asarray(xs[i]), jnp.asarray(ys[i]))
        topt.zero_grad()
        torch.nn.functional.cross_entropy(model(torch.from_numpy(xs[i])),
                                          torch.from_numpy(ys[i])).backward()
        topt.step()
        sched.step()
    start = jax.tree_util.tree_leaves(np_params)
    for i, (a, b, p0) in enumerate(zip(model.parameters(), jax.tree_util.tree_leaves(params), start)):
        moved = float(np.abs(np.asarray(b) - p0).max())
        assert moved > 1e-2 * float(np.abs(p0).max()), f"core {i} moved only {moved}"
        _close_to_order_one(a, b, what=f"core {i}")


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("init_dumb_normal", {"std": 0.7}),
        ("init_khrulkov_normal", {}),
        ("init_normal_preserving_output_std", {}),
        ("init_min_random_eye", {"base_std": 1e-2}),
    ],
)
def test_inits_shapes_and_statistics(name, kwargs):
    """Each init gives the spec's core shapes (the JAX spec's) and, over 100
    draws, the mean and element std that the JAX init draws from (the
    generators differ, so the numbers do not): N(0, std), N(0,
    khrulkov_core_std) with the JAX package's value of it, or the scaled
    identity plus N(0, base_std/q^C) noise of ``min_random_eye``."""
    spec = tm.ConvSBSModelConfig(num_sbs_layers=2, bond_dim_size=4).layer_specs()[1][0]
    jspec = jm.ConvSBSModelConfig(num_sbs_layers=2, bond_dim_size=4).layer_specs()[1][0]
    assert tsbs.khrulkov_core_std(spec, None) == jsbs.khrulkov_core_std(jspec, None)
    assert tsbs.khrulkov_core_std(spec, 0.3) == jsbs.khrulkov_core_std(jspec, 0.3)
    qc = spec.in_quantum_dim_size**spec.in_num_channels
    std = {
        "init_dumb_normal": 0.7,
        "init_khrulkov_normal": jsbs.khrulkov_core_std(jspec, None),
        "init_normal_preserving_output_std": jsbs.khrulkov_core_std(jspec, jspec.in_total_dim_size**-0.5),
        "init_min_random_eye": 1e-2 / qc,
    }[name]
    gen = torch.Generator().manual_seed(0)
    draws = [getattr(tsbs, name)(gen, spec, **kwargs) for _ in range(100)]
    base = (jax.jit(lambda k: jsbs.init_min_random_eye(k, jspec, base_std=0.0))(jax.random.PRNGKey(0))
            if name == "init_min_random_eye" else None)
    for i, (shape, jshape) in enumerate(zip(spec.shapes, jspec.shapes)):
        assert tuple(draws[0][i].shape) == shape.as_tuple() == jshape.as_tuple()
        got = torch.stack([d[i] for d in draws]).double()
        mean = torch.zeros(shape.as_tuple(), dtype=torch.float64)
        if base is not None:
            mean = torch.from_numpy(np.asarray(base[i], dtype=np.float64))
        noise = got - mean
        n = noise.numel()
        # ≥ 100·64 samples: the mean within 5 standard errors of 0, the std
        # within 5 standard errors of its own (√(1/2n) relative)
        assert abs(float(noise.mean())) <= 5 * std / math.sqrt(n)
        assert float(noise.std()) == pytest.approx(std, rel=5 / math.sqrt(2 * n))


def test_weights_interop_state_dict_and_npz():
    """The reference ``state_dict`` keys and values, the module's own
    ``state_dict``, and npz files that each package writes and the other
    reads."""
    _, tcfg, np_params, _ = _setup(2, True)
    sd = interop.state_dict_from_conv_sbs_params(np_params)
    jsd = jtc.state_dict_from_conv_sbs_params(np_params)
    assert sorted(sd) == sorted(jsd)
    for k in sd:
        assert torch.equal(sd[k], jsd[k])
    model = tm.ConvSBSModel(interop.conv_sbs_params_from_numpy(np_params), tcfg)
    assert sorted(model.state_dict()) == sorted(sd)
    back = interop.conv_sbs_params_from_state_dict(model.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(np_params)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="DCTNMnistModel"):
        interop.conv_sbs_params_from_state_dict({"epses.0": torch.zeros(2)})


def test_npz_checkpoints_cross_packages(tmp_path):
    _, _, np_params, _ = _setup(2, False)
    port_file, jax_file = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_conv_sbs_params_npz(interop.conv_sbs_params_from_numpy(np_params), port_file)
    save_pytree(jax.tree_util.tree_map(jnp.asarray, np_params), jax_file)
    via_jax = load_pytree(np_params, port_file)
    via_port = load_conv_sbs_params_npz(jax_file)
    for a, b, c in zip(jax.tree_util.tree_leaves(via_jax), jax.tree_util.tree_leaves(via_port),
                       jax.tree_util.tree_leaves(np_params)):
        assert np.array_equal(np.asarray(a), c) and np.array_equal(b, c)
