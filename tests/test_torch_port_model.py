"""The port's model, parameter layouts, checkpoints and interop against the
JAX package, on the CPU.

The JAX package draws the parameters; they cross to the port as numpy
arrays (``params_from_numpy``), and inputs come from numpy for both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctn_tpu import models as jm
from dctn_tpu.models import eps_plus_linear as jmodel
from dctn_tpu.train import load_pytree, save_pytree
from dctn_tpu_torch.interop import params_from_numpy, params_to_numpy
from dctn_tpu_torch.kernels import eps_kernels as K
from dctn_tpu_torch.models import (
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    eps_plus_linear_forward,
    eps_plus_linear_forward_fast,
    fast_layer_plans,
    fast_params_from_reference,
    init_eps_plus_linear,
    reference_params_from_fast,
)
from dctn_tpu_torch.train import load_params_npz, save_params_npz

# (specs, image size): the first merges no factor pairs, the second merges
# them in layer 0 (q0 = 2, K = 2) and again after an O = 2 layer
SPECS = [(((3, 3), (2, 4)), 8), (((2, 4), (2, 2), (2, 3)), 9)]


def _jax_setup(specs, image_size, seed=0):
    jcfg = jm.EPSesPlusLinearConfig(
        epses_specs=specs, image_size=image_size, q0=2,
        eval_backend="pallas_interpret", train_backend="pallas_interpret",
    )
    jparams = jm.init_eps_plus_linear(jax.random.PRNGKey(seed), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=image_size, q0=2)
    x = np.random.default_rng(seed).uniform(size=(1, 4, image_size, image_size, 2))
    return jcfg, jparams, np_params, cfg, x


@pytest.mark.parametrize("specs,image_size", SPECS)
def test_fast_plans_and_cmts_equal_jax_exactly(specs, image_size):
    jcfg, jparams, np_params, cfg, _ = _jax_setup(specs, image_size)
    jfast, jplans = jmodel.fast_params_from_reference(jparams, jcfg)
    fast, plans = fast_params_from_reference(params_from_numpy(np_params), cfg)
    assert plans == jplans
    for a, b in zip(fast["epses_cmt"], jfast["epses_cmt"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = reference_params_from_fast(fast, cfg, plans)
    for a, b in zip(back["epses"], np_params["epses"]):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("specs,image_size", SPECS)
def test_forwards_match_jax_xla_in_f64(specs, image_size):
    """Both of the port's forwards against the JAX reference-layout forward
    on the xla backend, float64, rtol 1e-10."""
    jcfg, jparams, np_params, cfg, x = _jax_setup(specs, image_size)
    xla_cfg = jm.EPSesPlusLinearConfig(epses_specs=specs, image_size=image_size, q0=2)
    j64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jparams)
    ref = np.asarray(jm.eps_plus_linear_forward(j64, jnp.asarray(x), xla_cfg))
    params = params_from_numpy(np_params, dtype=torch.float64)
    xt = torch.as_tensor(x)
    fast, plans = fast_params_from_reference(params, cfg)
    got_fast = eps_plus_linear_forward_fast(fast, xt, cfg, plans).numpy()
    got_ref = eps_plus_linear_forward(params, xt, cfg).numpy()
    assert got_fast.shape == ref.shape == (4, 10)
    np.testing.assert_allclose(got_fast, ref, rtol=1e-10)
    np.testing.assert_allclose(got_ref, ref, rtol=1e-10)


@pytest.mark.parametrize("specs,image_size", SPECS)
def test_fast_forward_matches_jax_pallas_interpret_in_f32(specs, image_size):
    jcfg, jparams, np_params, cfg, x = _jax_setup(specs, image_size)
    x32 = x.astype(np.float32)
    jfast, jplans = jmodel.fast_params_from_reference(jparams, jcfg)
    ref = np.asarray(jmodel.eps_plus_linear_forward_fast(jfast, jnp.asarray(x32), jcfg, jplans))
    fast, plans = fast_params_from_reference(params_from_numpy(np_params), cfg)
    got = eps_plus_linear_forward_fast(fast, torch.as_tensor(x32), cfg, plans).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


def test_module_forward_equals_the_functional_forward():
    _, _, np_params, cfg, x = _jax_setup(*SPECS[1])
    params = params_from_numpy(np_params)
    model = EPSesPlusLinear.from_reference(params, cfg, device="cpu")
    assert all(p.requires_grad for p in model.parameters())  # trainable
    fast, plans = fast_params_from_reference(params, cfg)
    xt = torch.as_tensor(x.astype(np.float32))
    with torch.inference_mode():
        torch.testing.assert_close(
            model(xt), eps_plus_linear_forward_fast(fast, xt, cfg, plans), rtol=0, atol=0
        )
        torch.testing.assert_close(model(xt, kernels=K.PLAIN), model(xt), rtol=0, atol=0)


def test_init_shapes_seeding_and_linear_scale():
    cfg = EPSesPlusLinearConfig(epses_specs=((4, 4), (3, 6)), image_size=28, q0=2)
    a = init_eps_plus_linear(torch.Generator().manual_seed(3), cfg)
    b = init_eps_plus_linear(torch.Generator().manual_seed(3), cfg)
    assert [tuple(c.shape) for c in a["epses"]] == [p["core_shape"] for p in fast_layer_plans(cfg)]
    n_in = cfg.linear_in_features
    assert n_in == 23 * 23 * 6
    assert tuple(a["linear"]["w"].shape) == (n_in, 10) and tuple(a["linear"]["b"].shape) == (10,)
    for x, y in zip(a["epses"] + (a["linear"]["w"],), b["epses"] + (b["linear"]["w"],)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert abs(float(a["linear"]["w"].std()) * n_in**0.5 * 4 - 1) < 0.05
    assert float(a["linear"]["b"].abs().max()) <= n_in**-0.5
    with pytest.raises(ValueError, match="needs init_input"):
        init_eps_plus_linear(torch.Generator(), cfg, "unit_empirical_output_std")


def test_checkpoints_cross_between_the_packages(tmp_path):
    jcfg, jparams, np_params, _, _ = _jax_setup(*SPECS[0])
    jax_file = str(tmp_path / "jax.npz")
    save_pytree(jparams, jax_file)
    loaded = load_params_npz(jax_file)
    assert len(loaded["epses"]) == 2
    for a, b in zip(loaded["epses"], np_params["epses"]):
        np.testing.assert_array_equal(a, b)
    for k in ("w", "b"):
        np.testing.assert_array_equal(loaded["linear"][k], np_params["linear"][k])

    torch_file = str(tmp_path / "torch.npz")
    save_params_npz(params_from_numpy(np_params), torch_file)
    back = load_pytree(jparams, torch_file)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_missing_leaf_raises(tmp_path):
    f = str(tmp_path / "bad.npz")
    np.savez(f, **{"epses/0": np.zeros(3), "linear/w": np.zeros(2)})
    with pytest.raises(KeyError, match="linear/b"):
        load_params_npz(f)


def test_interop_round_trip():
    _, _, np_params, _, _ = _jax_setup(*SPECS[0])
    back = params_to_numpy(params_from_numpy(np_params, dtype=torch.float64))
    for a, b in zip(back["epses"], np_params["epses"]):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back["linear"]["w"], np_params["linear"]["w"])
