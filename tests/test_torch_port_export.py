"""The port's deployment artifacts (``dctn_tpu_torch/cli/export.py``) against
the eager port models and the JAX package's own artifacts, on the CPU.

One seeded model of each family is made with numpy (the JAX init, through
an npz both packages read) and exported once per module: the fast (cmt)
model through the K1 operator (f32) and the K8 operator (int8), the ConvSBS
model through the ConvSBS fold's operator, and both families' plain
reference forwards (the ``xla`` backend). On the CPU each operator runs its
kernel's plain version, so a loaded artifact must give its eager model's
logits bit for bit: only the traced glue around the operators could differ.

Against the JAX package (its ``export_forward`` / ``export_conv_sbs_forward``
artifacts, xla backend, loaded with its ``load_artifact``): rtol 1e-5 with
atol 1e-6 of the largest logit, the float32 sums of two implementations in
other orders (the bound of ``test_torch_port_model.py``). The int8 artifact
is held to ``tests/test_torch_port_q8.py``'s bounds against JAX's
``forward_fast_q8`` in interpret mode.
"""

import json
import subprocess
import sys
import zipfile

import click
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from dctn_tpu import models as jm
from dctn_tpu.cli import export as jexport
from dctn_tpu.models import conv_sbs_model as jcsm
from dctn_tpu.models import eps_plus_linear as jmodel
from dctn_tpu.pallas import eps_pallas_q8 as jq
from dctn_tpu_torch.cli import export, predict
from dctn_tpu_torch.cli import legacy_runner as tlegacy
from dctn_tpu_torch.cli import runner as trunner
from dctn_tpu_torch.data import load_dataset
from dctn_tpu_torch.interop import conv_sbs_params_from_numpy, params_from_numpy
from dctn_tpu_torch.kernels import ops
from dctn_tpu_torch.models import (
    ConvSBSModel,
    ConvSBSModelConfig,
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    EPSesPlusLinearQ8,
    EPSesPlusLinearReference,
    fast_layer_plans,
    init_conv_sbs_model,
)
from dctn_tpu_torch.train import save_conv_sbs_params_npz, save_params_npz

SPECS = ((2, 4), (2, 6))
IMAGE = 8
BS = (2, 5)
SBS_BS = (5,)
SBS_CFG = dict(num_sbs_layers=2, bond_dim_size=2)
RTOL, ATOL = 1e-5, 1e-6  # against the JAX package, atol of the largest logit


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _x(bs: int, seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).random((1, bs, IMAGE, IMAGE, 2)) * 1.4).astype(np.float32)


def _pixels(bs: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random((bs, IMAGE, IMAGE)).astype(np.float32)


def _eps_numpy(specs, image_size, seed):
    """Reference-layout EPS params drawn with numpy at the port's shapes."""
    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=image_size, q0=2)
    rng = np.random.default_rng(seed)
    draw = lambda shape: (rng.standard_normal(shape) * 0.5).astype(np.float32)  # noqa: E731
    return {"epses": tuple(draw(p["core_shape"]) for p in fast_layer_plans(cfg)),
            "linear": {"w": draw((cfg.linear_in_features, 10)), "b": draw((10,))}}


def _sbs_numpy(seed):
    """ConvSBS cores drawn with numpy at the port's shapes."""
    rng = np.random.default_rng(seed)
    shapes = init_conv_sbs_model(torch.Generator(), ConvSBSModelConfig(**SBS_CFG))
    return tuple(tuple(tuple((rng.standard_normal(tuple(c.shape)) * 0.7).astype(np.float32)
                             for c in string) for string in layer) for layer in shapes)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """The seeded models' npz checkpoints and every kind of artifact of them,
    exported once through ``export.run`` on the CPU and loaded once."""
    tmp = tmp_path_factory.mktemp("export")
    np_eps, np_sbs = _eps_numpy(SPECS, IMAGE, 3), _sbs_numpy(4)
    eps_ckpt, sbs_ckpt = str(tmp / "eps.npz"), str(tmp / "sbs.npz")
    save_params_npz(np_eps, eps_ckpt)
    save_conv_sbs_params_npz(np_sbs, sbs_ckpt)
    eps_kw = dict(checkpoint=eps_ckpt, epses_specs=SPECS, image_size=IMAGE, q0=2,
                  batch_sizes=BS, device="cpu")
    sbs_kw = dict(checkpoint=sbs_ckpt, model_family="conv_sbs", image_size=IMAGE,
                  num_sbs_layers=2, bond_dim=2, input_multiplier=1.3, batch_sizes=SBS_BS,
                  device="cpu")
    arts, reports, loaded = {}, {}, {}
    for name, kw in {
        "f32": dict(eps_kw), "int8": dict(eps_kw, quantize="int8"),
        "eps_xla": dict(eps_kw, backend="xla"), "conv_sbs": dict(sbs_kw),
        "conv_sbs_xla": dict(sbs_kw, backend="xla"),
    }.items():
        arts[name] = str(tmp / f"{name}.zip")
        reports[name] = export.run(out=arts[name], **kw)
        loaded[name] = export.load_artifact(arts[name])
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=SPECS, image_size=IMAGE, q0=2)
    scfg = jcsm.ConvSBSModelConfig(**SBS_CFG, input_multiplier=1.3)
    return dict(tmp=tmp, jcfg=jcfg, jparams=_to_jax(np_eps), scfg=scfg,
                sparams=_to_jax(np_sbs), eps_ckpt=eps_ckpt, arts=arts, reports=reports,
                loaded=loaded, eps=params_from_numpy(np_eps),
                sbs=conv_sbs_params_from_numpy(np_sbs))


def _eager(made, name):
    """The eager port model an artifact was exported from, and its input."""
    cfg = EPSesPlusLinearConfig(epses_specs=SPECS, image_size=IMAGE, q0=2)
    scfg = ConvSBSModelConfig(**SBS_CFG, input_multiplier=1.3)
    if name == "f32":
        return EPSesPlusLinear.from_reference(made["eps"], cfg), _x
    if name == "int8":
        return EPSesPlusLinearQ8.from_reference(made["eps"], cfg), _x
    if name == "eps_xla":
        return EPSesPlusLinearReference(made["eps"], cfg), _x
    if name == "conv_sbs":
        return ConvSBSModel(made["sbs"], scfg), _pixels
    from dctn_tpu_torch.models import conv_sbs_model_forward

    return (lambda x: conv_sbs_model_forward(made["sbs"], scfg, x)), _pixels


@pytest.mark.parametrize("name", ["f32", "int8", "conv_sbs", "eps_xla", "conv_sbs_xla"])
def test_loaded_artifact_gives_the_eager_logits_bit_for_bit(made, name):
    meta, fns = made["loaded"][name]
    sizes = list(SBS_BS if name.startswith("conv_sbs") else BS)
    assert sorted(fns) == sizes and meta["batch_sizes"] == sizes
    model, inputs = _eager(made, name)
    for bs in sizes:
        x = torch.tensor(inputs(bs, seed=bs))
        with torch.inference_mode():
            got, want = fns[bs](x), model(x)
        assert got.shape == (bs, 10) and torch.isfinite(got).all()
        assert torch.equal(got, want), (name, bs, float((got - want).abs().max()))


@pytest.mark.parametrize("name,want", [
    ("f32", {"eps_fwd": 2}), ("int8", {"eps_fwd_q8": 2}), ("conv_sbs", {"sbs_fwd": 3}),
    ("eps_xla", {}), ("conv_sbs_xla", {}),
])
def test_graphs_hold_one_operator_node_per_layer_or_string(made, name, want):
    """One K1 (or K8) node per EPS layer, one fold per ConvSBS string (two
    in layer 0, one in the last), and no operator in an xla artifact."""
    for fn in made["loaded"][name][1].values():
        assert export.op_nodes(fn) == want


@pytest.mark.parametrize("name", ["f32", "eps_xla"])
def test_eps_artifact_matches_the_jax_artifact(made, name):
    jart = str(made["tmp"] / "jax_eps.dctnx")
    jexport.write_artifact(jart, jexport.export_forward(made["jparams"], made["jcfg"],
                                                        batch_sizes=(5,)), {"batch_sizes": [5]})
    _, jfns = jexport.load_artifact(jart)
    fns = made["loaded"][name][1]
    x = _x(5, seed=11)
    want = np.asarray(jfns[5](jnp.asarray(x)))
    with torch.inference_mode():
        got = fns[5](torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("name", ["conv_sbs", "conv_sbs_xla"])
def test_conv_sbs_artifact_matches_the_jax_artifact(made, name):
    jart = str(made["tmp"] / "jax_sbs.dctnx")
    jexport.write_artifact(jart, jexport.export_conv_sbs_forward(
        made["sparams"], made["scfg"], batch_sizes=(5,), image_size=IMAGE), {"batch_sizes": [5]})
    _, jfns = jexport.load_artifact(jart)
    fns = made["loaded"][name][1]
    x = _pixels(5, seed=12)
    want = np.asarray(jfns[5](jnp.asarray(x)))
    with torch.inference_mode():
        got = fns[5](torch.tensor(x)).numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max())


def test_int8_artifact_matches_the_jax_int8_forward(made):
    """Within ``test_torch_port_q8.py``'s bounds of JAX's forward_fast_q8 in
    interpret mode (rtol 1e-6, atol 1e-6 of the largest logit)."""
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=SPECS, image_size=IMAGE, q0=2,
                                    eval_backend="pallas_interpret")
    jfast, jplans = jmodel.fast_params_from_reference(made["jparams"], jcfg)
    x = _x(5, seed=13)
    want = np.asarray(jq.forward_fast_q8(jq.quantize_fast_params(jfast, jplans), jnp.asarray(x),
                                         jcfg, jplans, interpret=True))
    with torch.inference_mode():
        got = made["loaded"]["int8"][1][5](torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_meta_has_the_jax_schema(made):
    """The keys of the JAX package's build_meta, with torch_version in place
    of jax_version; the values of the shared keys equal but the device."""
    kw = dict(model_family="eps", image_size=IMAGE, batch_sizes=list(BS), backend="pallas",
              epses_specs=[list(s) for s in SPECS], q0=2, channels=1, num_classes=10)
    want = jexport.build_meta(**kw)
    got = export.build_meta(platforms=["cpu"], **kw)
    assert set(got) == (set(want) - {"jax_version"}) | {"torch_version"}
    assert {k: v for k, v in got.items() if k not in ("torch_version", "platforms")} == {
        k: v for k, v in want.items() if k not in ("jax_version", "platforms")}
    with zipfile.ZipFile(made["arts"]["int8"]) as zf:
        meta = json.loads(zf.read("meta.json"))
        names = set(zf.namelist())
    assert names == {"meta.json", "forward_bs2.pt2", "forward_bs5.pt2"}
    assert meta == made["loaded"]["int8"][0]
    assert meta == {**got, "quantize": "int8", "torch_version": torch.__version__}
    with zipfile.ZipFile(made["arts"]["conv_sbs_xla"]) as zf:
        meta = json.loads(zf.read("meta.json"))
    assert meta["backend"] == "xla" and meta["model_family"] == "conv_sbs"
    assert meta["input_multiplier"] == 1.3 and meta["platforms"] == ["cpu"]
    report = made["reports"]["f32"]
    assert sorted(report["export_s"]) == list(BS) and report["artifact_bytes"] > 0


def test_xla_artifact_loads_where_the_port_is_not_installed(made):
    """An xla artifact holds plain operations only: torch and the standard
    library load and run it in a process where importing dctn_tpu_torch
    fails."""
    x = _x(2, seed=5)
    np.save(made["tmp"] / "x.npy", x)
    code = (
        "import io, json, sys, zipfile\n"
        "sys.modules['dctn_tpu_torch'] = None\n"
        "try:\n    import dctn_tpu_torch\nexcept ImportError:\n    pass\n"
        "else:\n    raise SystemExit('dctn_tpu_torch imported')\n"
        "import numpy as np, torch\n"
        f"zf = zipfile.ZipFile({made['arts']['eps_xla']!r})\n"
        "fn = torch.export.load(io.BytesIO(zf.read('forward_bs2.pt2'))).module()\n"
        f"out = fn(torch.tensor(np.load({str(made['tmp'] / 'x.npy')!r})))\n"
        f"np.save({str(made['tmp'] / 'out.npy')!r}, out.detach().numpy())\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=made["tmp"], check=True, timeout=120)
    model, _ = _eager(made, "eps_xla")
    with torch.inference_mode():
        want = model(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(np.load(made["tmp"] / "out.npy"), want)


def test_cli_end_to_end(made, tmp_path):
    out = str(tmp_path / "cli.zip")
    res = CliRunner().invoke(export.main, [
        made["eps_ckpt"], "--epses-specs", "(2,4),(2,6)", "--image-size", str(IMAGE),
        "--batch-sizes", "3", "--device", "cpu", "--out", out,
    ])
    assert res.exit_code == 0, res.output
    assert "exported 1 entry point(s) (bs [3], device cpu, backend pallas" in res.output
    meta, fns = export.load_artifact(out)
    assert meta["backend"] == "pallas" and meta["platforms"] == ["cpu"]
    model, _ = _eager(made, "f32")
    x = torch.tensor(_x(3, seed=3))
    with torch.inference_mode():
        assert torch.equal(fns[3](x), model(x))


@pytest.mark.parametrize("kw,match", [
    ({"mesh_devices": 2, "batch_sizes": (3,)},
     r"global batch sizes \[3\] are not divisible by --mesh-devices 2"),
    ({"space_devices": 2, "mesh_devices": 2}, "--space-devices and --mesh-devices are mutually"),
    ({"autotune_splits": True, "backend": "xla"},
     "--autotune-splits needs --model-family eps and the pallas backend"),
    ({"autotune_splits": True, "model_family": "conv_sbs"},
     "--autotune-splits needs --model-family eps and the pallas backend"),
    ({"compute_dtype": "bfloat16", "quantize": "int8"},
     "--quantize int8 and --compute-dtype bfloat16 are mutually exclusive"),
    ({"quantize": "int8", "backend": "xla"}, "needs the pallas backend"),
    ({"quantize": "int8", "model_family": "conv_sbs"}, "needs --model-family eps"),
    ({"epses_specs": None}, "needs --epses-specs"),
])
def test_cli_refusals(made, tmp_path, kw, match):
    args = dict(checkpoint=made["eps_ckpt"], epses_specs=SPECS, image_size=IMAGE,
                batch_sizes=(2,), device="cpu", out=str(tmp_path / "bad.zip"))
    with pytest.raises(click.UsageError, match=match):
        export.run(**{**args, **kw})
    assert not (tmp_path / "bad.zip").exists()


def test_jax_artifact_and_other_devices_are_refused(made, tmp_path):
    jart = str(tmp_path / "jax.dctnx")
    jexport.write_artifact(jart, jexport.export_forward(made["jparams"], made["jcfg"],
                                                        batch_sizes=(2,)), {"batch_sizes": [2]})
    with pytest.raises(ValueError, match="artifact of the JAX package.*re-export"):
        export.load_artifact(jart)
    with pytest.raises(click.UsageError, match="artifact of the JAX package"):
        predict.run(checkpoint=jart, ds_type="fashionmnist", ds_path="synthetic", device="cpu")
    with pytest.raises(ValueError, match="exported on cpu; it does not load onto cuda"):
        export.load_artifact(made["arts"]["f32"], "cuda")
    if not torch.cuda.is_available():
        with zipfile.ZipFile(made["arts"]["f32"]) as zf:
            blobs = {n: zf.read(n) for n in zf.namelist()}
        meta = json.loads(blobs.pop("meta.json"))
        fake = str(tmp_path / "cuda.zip")
        export.write_artifact(fake, {int(n[10:-4]): b for n, b in blobs.items()},
                              {**meta, "platforms": ["cuda"]})
        with pytest.raises(RuntimeError, match="exported on cuda, and no CUDA device"):
            export.load_artifact(fake)


# ---------------------------------------------------------------------------
# predict from an artifact

PREDICT_SPECS = ((3, 3), (2, 4))
PREDICT_SIZES = (16, 8, 16)


@pytest.fixture(scope="module")
def predict_artifact(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("predict")
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=PREDICT_SPECS, image_size=28, q0=2)
    np_params = _eps_numpy(PREDICT_SPECS, 28, 5)
    ckpt = str(tmp / "model.npz")
    save_params_npz(np_params, ckpt)
    jparams = _to_jax(np_params)
    art = str(tmp / "model.zip")
    export.run(checkpoint=ckpt, epses_specs=PREDICT_SPECS, batch_sizes=(1, 6), device="cpu",
               out=art)
    return art, jparams, jcfg


def test_predict_from_an_artifact_gives_the_argmax_of_the_jax_logits(predict_artifact):
    """16 test images in batches of 6: the last batch of 4 is padded to the
    entry point of 6 and trimmed."""
    art, jparams, jcfg = predict_artifact
    result = predict.run(checkpoint=art, ds_type="fashionmnist", ds_path="synthetic",
                         batch_size=6, device="cpu", synthetic_sizes=PREDICT_SIZES)
    test = load_dataset("fashionmnist", "synthetic", autoscale_kernel_size=3,
                        synthetic_sizes=PREDICT_SIZES).test
    logits = np.asarray(jm.eps_plus_linear_forward(jparams, jnp.asarray(test.x), jcfg))
    np.testing.assert_array_equal(result.preds, logits.argmax(axis=1))
    assert sorted(result.model) == [1, 6] and result.forward_calls == 3
    assert result.accuracy == float(np.mean(result.preds == test.y))


@pytest.mark.parametrize("kw,match", [
    ({"quantize": "int8"}, "artifacts bake their quantization"),
    ({"batch_size": 4}, r"missing \[4\]"),
    ({"latency_bench": True, "batch_size": 6, "ds_type": "cifar10_rgb"}, "does not match"),
])
def test_predict_artifact_refusals(predict_artifact, kw, match):
    args = dict(checkpoint=predict_artifact[0], ds_type="fashionmnist", ds_path="synthetic",
                batch_size=6, device="cpu", synthetic_sizes=PREDICT_SIZES)
    with pytest.raises(click.UsageError, match=match):
        predict.run(**{**args, **kw})


# ---------------------------------------------------------------------------
# the runners' --export-artifact

RUN = dict(ds_type="fashionmnist", ds_path="synthetic", epses_specs=((2, 4),), batch_size=16,
           optimizer_name="adam", lr=3e-3, synthetic_sizes=(64, 32, 32),
           eval_schedule=((None, 2),), max_num_iters=4, keep_last_models=1,
           init_epses_composition_unit_theoretical_output_std=True, device="cpu")


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_runner_exports_the_final_params(tmp_path, quantize):
    art = str(tmp_path / "trained.zip")
    state = trunner.run(experiments_dir=str(tmp_path / "exp"), export_artifact=art,
                        export_batch_sizes="1,8", export_quantize=quantize, **RUN)
    meta, fns = export.load_artifact(art)
    assert meta["batch_sizes"] == [1, 8] and meta["quantize"] == quantize
    assert export.op_nodes(fns[8]) == {"eps_fwd" if quantize == "none" else "eps_fwd_q8": 1}
    final = state.extras["params_view"](state.params)
    cfg = state.extras["cfg"]
    model = (EPSesPlusLinear if quantize == "none" else EPSesPlusLinearQ8).from_reference(final,
                                                                                         cfg)
    x = torch.tensor(load_dataset("fashionmnist", "synthetic", autoscale_kernel_size=2,
                                  synthetic_sizes=(64, 32, 32)).test.x[:, :8])
    with torch.inference_mode():
        assert torch.equal(fns[8](x), model(x))


def test_runner_export_validation_and_the_qat_warning(tmp_path, caplog):
    with pytest.raises(click.UsageError, match="needs --export-artifact"):
        trunner.run(experiments_dir=str(tmp_path / "e1"), export_quantize="int8", **RUN)
    with pytest.raises(click.UsageError, match="pallas eval backend"):
        trunner.run(experiments_dir=str(tmp_path / "e2"), export_quantize="int8",
                    export_artifact=str(tmp_path / "a.zip"), eval_backend="xla", **RUN)
    assert not (tmp_path / "e1").exists() and not (tmp_path / "e2").exists()
    art = str(tmp_path / "qat.zip")
    with caplog.at_level("WARNING"):
        trunner.run(experiments_dir=str(tmp_path / "e3"), qat="int8", export_artifact=art,
                    export_batch_sizes="8", **{**RUN, "max_num_iters": 1})
    assert "--qat int8 without --export-quantize int8" in caplog.text
    meta, fns = export.load_artifact(art)
    assert meta["quantize"] == "none" and export.op_nodes(fns[8]) == {"eps_fwd": 1}


def test_xla_eval_backend_exports_the_plain_forward(tmp_path):
    art = str(tmp_path / "xla.zip")
    state = trunner.run(experiments_dir=str(tmp_path / "exp"), export_artifact=art,
                        export_batch_sizes="4", eval_backend="xla", **RUN)
    meta, fns = export.load_artifact(art)
    assert meta["backend"] == "xla" and export.op_nodes(fns[4]) == {}
    # the reference view of the fast layout's cores is a permutation of
    # their storage; the artifact holds them contiguous, and so does this
    # eager model (a product's bits can depend on its operand's strides)
    final = state.extras["params_view"](state.params)
    final = {"epses": tuple(c.contiguous() for c in final["epses"]), "linear": final["linear"]}
    model = EPSesPlusLinearReference(final, state.extras["cfg"])
    x = torch.tensor(load_dataset("fashionmnist", "synthetic", autoscale_kernel_size=2,
                                  synthetic_sizes=(64, 32, 32)).test.x[:, :4])
    with torch.inference_mode():
        assert torch.equal(fns[4](x), model(x))


def test_legacy_runner_exports_the_final_cores(tmp_path):
    art = str(tmp_path / "legacy.zip")
    params, _ = tlegacy.run(ds_path="synthetic", models_dir=str(tmp_path / "m"), num_sbs_layers=2,
                            bond_dim_size=2, batch_size=32, synthetic_sizes=(64, 32), epochs=1,
                            device="cpu", make_input_window_std_one=True, export_artifact=art,
                            export_batch_sizes="4", tb_log_every_n_epochs=0)
    meta, fns = export.load_artifact(art)
    assert meta["model_family"] == "conv_sbs" and meta["batch_sizes"] == [4]
    assert export.op_nodes(fns[4]) == {"sbs_fwd": 3}
    cfg = ConvSBSModelConfig(num_sbs_layers=2, bond_dim_size=2,
                             input_multiplier=meta["input_multiplier"])
    x = torch.tensor(np.random.default_rng(9).random((4, 28, 28)).astype(np.float32))
    with torch.inference_mode():
        assert torch.equal(fns[4](x), ConvSBSModel(params, cfg)(x))
    with pytest.raises(click.UsageError, match="--shuffle-pixels"):
        tlegacy.run(ds_path="synthetic", models_dir=str(tmp_path / "m2"), num_sbs_layers=2,
                    bond_dim_size=2, device="cpu", shuffle_pixels=True, export_artifact=art)
    assert not (tmp_path / "m2").exists()


def test_operators_run_the_plain_versions_on_cpu_tensors_without_counting():
    """On CPU tensors each operator is its wrapper's plain version, and the
    wrappers count only CUDA launches."""
    from dctn_tpu_torch.kernels import eps_kernels as K
    from dctn_tpu_torch.kernels import eps_q8_kernels as Q8
    from dctn_tpu_torch.kernels import sbs_kernels as S

    g = torch.Generator().manual_seed(0)
    views = torch.rand((4, 4, 37), generator=g)
    cmt = torch.randn((3 * 16, 16), generator=g)  # Z = O·q^(n−n1), A = q^n1
    before = (K.eps_fwd.launches, Q8.eps_fwd_q8.launches, S.sbs_fwd.mim_launches)
    assert torch.equal(ops.eps_fwd(views, cmt, 2, 3), K.eps_fwd_reference(views, cmt, 2, 3))
    wq, sw = Q8.quantize_cmt(cmt)
    assert torch.equal(ops.eps_fwd_q8(views, wq, sw, 2, 3),
                       Q8.eps_fwd_q8_reference(views, wq, sw, 2, 3))
    olr = ((1, 1, 2), (3, 2, 2), (1, 2, 1))
    cores = [torch.randn((l * r * o, 4), generator=g) for o, l, r in olr]
    sviews = torch.rand((3, 4, 37), generator=g)
    got = ops.sbs_fwd(sviews, cores, [v for t in olr for v in t], 1)
    assert torch.equal(got, S.sbs_fwd_reference(sviews, cores, olr, 1))
    assert (K.eps_fwd.launches, Q8.eps_fwd_q8.launches, S.sbs_fwd.mim_launches) == before
