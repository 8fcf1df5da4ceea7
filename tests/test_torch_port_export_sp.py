"""The port's height-sharded artifact (``export --space-devices S``,
``cli/export.py::export_space_sharded_forward``, served by
``parallel.replicas.RowShardedForward``) on the CPU, mirroring the JAX
package's ``tests/test_export.py::test_export_space_sharded_forward``: the
model ``(2,3),(2,4)`` on 6×6 images, batch 8, exported with
``--space-devices 3`` for the ``xla`` and ``pallas`` backends (the kernels'
plain versions on the CPU) and served on 3 CPU replicas.

Tolerances: against the JAX package's own height-sharded artifact (loaded on
the conftest's virtual mesh) and its one-device forward, rtol 1e-5 with
atol 1e-6 of the largest logit (``tests/test_torch_port_export.py``'s
bound: float32 sums of two implementations in other orders; the JAX test
holds its own artifact at atol 1e-5). Each band's layer outputs against the
whole model's rows, and the artifact against the eager slab programs, bit
for bit (the same plain operations on the same rows).
"""

import click
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctn_tpu import models as jm
from dctn_tpu.cli import export as jexport
from dctn_tpu_torch.cli import export, predict, serve
from dctn_tpu_torch.data import load_dataset
from dctn_tpu_torch.interop import params_from_numpy
from dctn_tpu_torch.models import EPSesPlusLinearConfig
from dctn_tpu_torch.parallel.replicas import RowShardedForward
from dctn_tpu_torch.train import save_params_npz
from torch_port_bf16_problem import unit_problem

SPECS = ((2, 3), (2, 4))
IMAGE, BATCH, SPACE = 6, 8, 3
RTOL, ATOL = 1e-5, 1e-6  # against the JAX package, atol of the largest logit
PREDICT_SPECS = ((3, 3), (2, 4))
PREDICT_SIZES = (16, 8, 16)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """The JAX test's seeded model (its init, through an npz both packages
    read), its batch, and the height-sharded artifacts of both packages."""
    tmp = tmp_path_factory.mktemp("export_sp")
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=SPECS, image_size=IMAGE, q0=2, num_classes=10)
    jparams = jm.init_eps_plus_linear(jax.random.PRNGKey(11), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    ckpt = str(tmp / "ckpt.npz")
    save_params_npz(np_params, ckpt)
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(12), (1, BATCH, IMAGE, IMAGE, 2))
                   * 1.4, np.float32)
    common = dict(checkpoint=ckpt, epses_specs=SPECS, image_size=IMAGE, q0=2,
                  batch_sizes=(BATCH,), space_devices=SPACE)
    arts = {}
    for backend in ("xla", "pallas"):
        arts[backend] = str(tmp / f"{backend}.zip")
        export.run(**common, backend=backend, device="cpu", out=arts[backend])
    jart = str(tmp / "jax.dctnx")
    jexport.run(**common, backend="xla", out=jart)
    _, jfns = jexport.load_artifact(jart)
    return {"ckpt": ckpt, "arts": arts, "x": x, "jparams": jparams, "jcfg": jcfg,
            "params": params_from_numpy(np_params),
            "jax_sharded": np.asarray(jfns[BATCH](jnp.asarray(x))),
            "jax_one": np.asarray(jm.eps_plus_linear_forward(jparams, jnp.asarray(x), jcfg,
                                                             training=False))}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_space_sharded_artifact_matches_jax(made, backend):
    """Its logits on 3 CPU replicas against JAX's height-sharded artifact
    (``export_space_sharded_forward`` on the virtual mesh) and JAX's
    one-device forward; its meta says how it is sharded."""
    meta, fns = export.load_artifact(made["arts"][backend])
    assert (meta["space_devices"], meta["mesh_devices"], meta["program_device"]) == (SPACE, 1,
                                                                                    "cpu")
    assert (meta["space_rows"], meta["space_halo"]) == (IMAGE // SPACE, 2)
    fn = fns[BATCH]
    assert isinstance(fn, RowShardedForward) and len(fn.devices) == SPACE
    with torch.inference_mode():
        got = fn(torch.as_tensor(made["x"])).numpy()
    assert got.shape == (BATCH, 10)
    _close(got, made["jax_sharded"])
    _close(got, made["jax_one"])


@pytest.fixture(scope="module")
def made_bf16(tmp_path_factory):
    """A bf16 model of unit-scale layers (``torch_port_bf16_problem``), its
    height-sharded artifacts with ``compute_dtype`` bf16 from both packages
    and the port's float32 one of the same npz."""
    tmp = tmp_path_factory.mktemp("export_sp_bf16")
    jcfg, jparams, np_params, x, _ = unit_problem(SPECS, image=IMAGE, backend="xla",
                                                  batch=BATCH)
    ckpt = str(tmp / "ckpt.npz")
    save_params_npz(np_params, ckpt)
    common = dict(checkpoint=ckpt, epses_specs=SPECS, image_size=IMAGE, q0=2,
                  batch_sizes=(BATCH,), space_devices=SPACE)
    arts = {}
    for backend, dtype in (("xla", "bfloat16"), ("pallas", "bfloat16"), ("pallas", "float32")):
        arts[backend, dtype] = str(tmp / f"{backend}_{dtype}.zip")
        export.run(**common, backend=backend, device="cpu", compute_dtype=dtype,
                   out=arts[backend, dtype])
    jart = str(tmp / "jax.dctnx")
    jexport.run(**common, backend="xla", compute_dtype="bfloat16", out=jart)
    _, jfns = jexport.load_artifact(jart)
    return {"arts": arts, "x": x, "jax_sharded": np.asarray(jfns[BATCH](jnp.asarray(x))),
            "jax_one": np.asarray(jm.eps_plus_linear_forward(jparams, jnp.asarray(x), jcfg,
                                                             training=False))}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_bf16_space_sharded_artifact_matches_jax(made_bf16, backend):
    """``export --space-devices 3 --compute-dtype bfloat16`` on 3 CPU
    replicas against JAX's bf16 height-sharded artifact and its one-device
    bf16 forward, at the float32 bound (the layers' short sums land no bf16
    operand a step apart); its meta says bf16. The port's float32 artifact
    of the same npz misses the bound (the mode is on)."""
    meta, fns = export.load_artifact(made_bf16["arts"][backend, "bfloat16"])
    assert meta["compute_dtype"] == "bfloat16" and meta["space_devices"] == SPACE
    _, fns32 = export.load_artifact(made_bf16["arts"]["pallas", "float32"])
    x = torch.as_tensor(made_bf16["x"])
    with torch.inference_mode():
        got, got32 = fns[BATCH](x).numpy(), fns32[BATCH](x).numpy()
    _close(got, made_bf16["jax_sharded"])
    _close(got, made_bf16["jax_one"])
    with pytest.raises(AssertionError):
        _close(got32, made_bf16["jax_sharded"])


@pytest.mark.parametrize("backend,want", [("xla", {}), ("pallas", {"eps_fwd": 2})])
def test_slab_program_holds_one_operator_node_per_layer(made, backend, want):
    """The pallas slab program calls K1 through its operator once per EPS
    layer; the xla one holds plain operations only."""
    _, fns = export.load_artifact(made["arts"][backend])
    for replica in fns[BATCH].replicas:
        assert export.op_nodes(replica) == want


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_each_band_is_the_whole_models_rows(made, backend):
    """Each card's slab program, run eagerly, gives the rows of its band of
    the whole image's last layer through the same program (the rows past
    the valid height aside) bit for bit, and the loaded artifact the eager
    slab programs' partial logits summed in card order, plus the bias."""
    cfg = EPSesPlusLinearConfig(epses_specs=SPECS, image_size=IMAGE, q0=2)
    params = made["params"]
    x = torch.as_tensor(made["x"])
    program = export.space_slab_program(params, cfg, backend=backend)
    classifier = export.space_classifier(params, cfg, SPACE)
    fn = export.load_artifact(made["arts"][backend])[1][BATCH]
    row_dim = 1  # (B, rows, W', O) or (O, rows, W', B)
    hl = IMAGE // SPACE
    total = None
    with torch.inference_mode():
        whole = program.features(x)
        valid = whole.shape[row_dim]
        for s, slab in enumerate(fn.slabs(x)):
            band = program.features(slab)
            n = max(0, min(hl, valid - s * hl))
            assert band.shape[row_dim] == hl
            assert torch.equal(band[:, :n], whole[:, s * hl : s * hl + n]), s
            part = program(slab, classifier["w"][s])
            total = part if total is None else total + part
        got = fn(x)
    assert torch.equal(got, total + classifier["b"])


def test_refusals_with_jax_words(made, tmp_path):
    """JAX's refusals (export.py:471-493) in its words: int8, a data axis
    beside it, a height the space axis does not divide, another family;
    and a halo wider than a band. Nothing is written."""
    base = dict(checkpoint=made["ckpt"], epses_specs=SPECS, image_size=IMAGE, q0=2,
                batch_sizes=(BATCH,), device="cpu", out=str(tmp_path / "bad.zip"))
    for kw, match in (
        (dict(space_devices=3, quantize="int8"), "does not compose with --space-devices"),
        (dict(space_devices=3, mesh_devices=2), "mutually exclusive"),
        (dict(space_devices=4), "must be divisible by --space-devices 4"),
        (dict(space_devices=3, model_family="conv_sbs"), "needs --model-family eps"),
        (dict(space_devices=3, epses_specs=((4, 3), (2, 4))),
         "3-row halo but each device holds only 2 rows"),
    ):
        with pytest.raises(click.UsageError, match=match):
            export.run(**{**base, **kw})
    assert not (tmp_path / "bad.zip").exists()


def test_load_refuses_fewer_cards_than_bands(made, tmp_path):
    """An artifact exported for 3 cards does not load where fewer are
    visible (here none), naming the count; it never puts two bands on one
    card."""
    art = str(tmp_path / "cuda.zip")
    export.run(checkpoint=made["ckpt"], epses_specs=SPECS, image_size=IMAGE, q0=2,
               batch_sizes=(BATCH,), space_devices=SPACE, device="cuda", out=art)
    with pytest.raises(ValueError, match="height-sharded over 3 devices: 3 replicas need 3 "
                                         "CUDA cards; 0 visible"):
        export.load_artifact(art)


@pytest.fixture(scope="module")
def predict_artifact(tmp_path_factory):
    """A model on the 28×28 images predict reads, exported over 4 bands of
    7 rows (the pallas backend)."""
    tmp = tmp_path_factory.mktemp("predict_sp")
    jcfg = jm.EPSesPlusLinearConfig(epses_specs=PREDICT_SPECS, image_size=28, q0=2)
    jparams = jm.init_eps_plus_linear(jax.random.PRNGKey(5), jcfg)
    ckpt = str(tmp / "model.npz")
    save_params_npz(jax.tree_util.tree_map(np.asarray, jparams), ckpt)
    art = str(tmp / "model.zip")
    export.run(checkpoint=ckpt, epses_specs=PREDICT_SPECS, batch_sizes=(1, 6), space_devices=4,
               device="cpu", out=art)
    return art, jparams, jcfg


def test_predict_and_serve_the_height_sharded_artifact(predict_artifact):
    """``predict`` serves it in batches of 6 (the last padded and trimmed)
    and ``serve.ArtifactModel`` chunks and pads a request over its entry
    points, its input kept on the host; both give the argmax and the logits
    of JAX's one-device forward."""
    art, jparams, jcfg = predict_artifact
    result = predict.run(checkpoint=art, ds_type="fashionmnist", ds_path="synthetic",
                         batch_size=6, device="cpu", synthetic_sizes=PREDICT_SIZES)
    test = load_dataset("fashionmnist", "synthetic", autoscale_kernel_size=3,
                        synthetic_sizes=PREDICT_SIZES).test
    logits = np.asarray(jm.eps_plus_linear_forward(jparams, jnp.asarray(test.x), jcfg))
    np.testing.assert_array_equal(result.preds, logits.argmax(axis=1))
    assert result.forward_calls == 3
    model = serve.ArtifactModel(art)
    assert model.device == torch.device("cpu")
    _close(model.predict(np.asarray(test.x[:, :7])), logits[:7])
