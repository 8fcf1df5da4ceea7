"""The port's predict entry point against the JAX package, on the CPU."""

import click
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from dctn_tpu import models as jm
from dctn_tpu.cli.runner import parse_epses_specs as jax_parse_epses_specs
from dctn_tpu.data import load_dataset
from dctn_tpu.train import save_pytree
from dctn_tpu_torch.cli import predict
from dctn_tpu_torch.cli.specs import parse_epses_specs

SPECS = ((3, 3), (2, 4))
SIZES = (16, 8, 16)


@pytest.fixture
def jax_checkpoint(tmp_path):
    cfg = jm.EPSesPlusLinearConfig(epses_specs=SPECS, image_size=28, q0=2)
    params = jm.init_eps_plus_linear(jax.random.PRNGKey(0), cfg)
    path = str(tmp_path / "model.npz")
    save_pytree(params, path)
    return path, params, cfg


def test_predict_gives_the_argmax_of_the_jax_logits(jax_checkpoint, tmp_path):
    path, params, cfg = jax_checkpoint
    out = str(tmp_path / "preds.npy")
    result = predict.run(
        checkpoint=path, ds_type="fashionmnist", ds_path="synthetic",
        epses_specs=SPECS, batch_size=6, out=out, device="cpu",
        synthetic_sizes=SIZES,
    )
    test = load_dataset(
        "fashionmnist", "synthetic", autoscale_kernel_size=SPECS[0][0], synthetic_sizes=SIZES
    ).test
    logits = np.asarray(jm.eps_plus_linear_forward(params, jnp.asarray(test.x), cfg))
    np.testing.assert_array_equal(result.x.numpy(), test.x)
    np.testing.assert_array_equal(result.preds, logits.argmax(axis=1))
    np.testing.assert_array_equal(np.load(out), result.preds)
    assert result.forward_calls == 3  # 16 images in batches of 6
    assert result.accuracy == float(np.mean(result.preds == test.y))
    assert result.latency == []


def test_cli_main_runs_on_cpu(jax_checkpoint):
    path, _, _ = jax_checkpoint
    res = CliRunner().invoke(
        predict.main,
        [path, "--ds-type", "fashionmnist", "--ds-path", "synthetic",
         "--epses-specs", "(3,3),(2,4)", "--split", "val", "--device", "cpu"],
    )
    assert res.exit_code == 0, res.output
    assert "val: n=2048" in res.output


@pytest.mark.parametrize(
    "kwargs,match",
    [
        ({"quantize": "int4"}, "--quantize int4 is not supported"),
        ({"mesh_devices": 0}, "--mesh-devices 0: at least one device"),
        ({"epses_specs": None}, "--epses-specs is required"),
    ],
)
def test_unported_inputs_are_refused(jax_checkpoint, kwargs, match):
    path, _, _ = jax_checkpoint
    args = dict(checkpoint=path, ds_type="fashionmnist", ds_path="synthetic",
                epses_specs=SPECS, device="cpu", synthetic_sizes=SIZES)
    with pytest.raises(click.UsageError, match=match):
        predict.run(**{**args, **kwargs})


def test_cuda_device_without_a_card_is_refused(jax_checkpoint):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    path, _, _ = jax_checkpoint
    with pytest.raises(click.UsageError, match="no CUDA device"):
        predict.run(checkpoint=path, ds_type="fashionmnist", ds_path="synthetic",
                    epses_specs=SPECS, device="cuda", synthetic_sizes=SIZES)


def test_checkpoint_of_another_model_is_refused(jax_checkpoint):
    path, _, _ = jax_checkpoint
    with pytest.raises(ValueError, match="epses/1"):
        predict.run(checkpoint=path, ds_type="fashionmnist", ds_path="synthetic",
                    epses_specs=((3, 3), (2, 5)), device="cpu", synthetic_sizes=SIZES)


def test_latency_stats_fields_and_call_count():
    x = torch.zeros((1, 64, 4, 4, 2))
    calls = []

    def forward(xb):
        calls.append(xb.shape[1])
        return xb.sum()

    stats = predict.latency_stats(forward, x, 16, iters=5)
    assert stats["calls"] == len(calls) == 1 + 5 + 3 * min(2048, max(5, 49152 // 16))
    assert set(calls) == {16}
    assert stats["device"] == "cpu" and stats["batch_size"] == 16
    assert 0 < stats["min_ms"] <= stats["p50_ms"] <= stats["p90_ms"]


@pytest.mark.parametrize("s", ["(4,4),(3,6)", "(2,4)", "(4,4),(3,12),(2,24)"])
def test_parse_epses_specs_matches_jax(s):
    assert parse_epses_specs(s) == jax_parse_epses_specs(s)


def test_parse_epses_specs_rejects_bad_input():
    with pytest.raises(click.BadParameter):
        parse_epses_specs("(4,4)(3,6)")
