"""Where the port falls back as the JAX package does, on the CPU.

- The EPS gate (``eps_kernels.kernels_take_split`` at any pixel count, on
  ``meta`` tensors) against JAX's ``pallas_forward_fits`` at float32 and
  bf16 widths, over the repo's models and four layers outside the kernels'
  plans.
- A model with a layer outside the plans: the runner trains the reference
  layout (the layers the kernels take through them, the others on the plain
  path) with the fallback in ``run_info.txt``, beside the JAX runner's
  reference-layout run from one npz with JAX's gate forced the same way; its
  ``--qat int8`` is refused; predict and both export paths serve the
  reference forward, int8 refused.
- The ConvSBS route as a pure function of the config against JAX's
  ``sbs_pallas_profitable``, bonds 2–12, open and ring; the legacy runner
  trains an out-of-scope model and records the fallback.
- The bf16 kernels' plan mirrors at every layer of the repo's models.

The decision is forced at a small width by patching the gates (JAX's at
run time, no file of ``dctn_tpu`` changes): the port's plain versions on
the CPU run the same arithmetic on either route.
"""

import os

import jax
import numpy as np
import pytest
import torch

from dctn_tpu import models as jm
from dctn_tpu.cli import runner as jrunner
from dctn_tpu.models import conv_sbs_model as jsbs_model
from dctn_tpu.pallas import eps_pallas as jeps_pallas
from dctn_tpu.pallas.sbs_pallas import sbs_pallas_profitable
from dctn_tpu.train.checkpoint import save_pytree
from dctn_tpu_torch.cli import export as texport
from dctn_tpu_torch.cli import legacy_runner as tlegacy
from dctn_tpu_torch.cli import predict as tpredict
from dctn_tpu_torch.cli import runner as trunner
from dctn_tpu_torch.interop import params_from_numpy
from dctn_tpu_torch.kernels import eps_kernels as K
from dctn_tpu_torch.models import conv_sbs_model as tsbs_model
from dctn_tpu_torch.models import eps_plus_linear as tmodel
from dctn_tpu_torch.ops import eps as teps

SPECS = ((2, 4), (2, 3))
# the runners' shared recipe (tests/test_torch_port_runner.py's): Adam at
# weight decay 0.1, 4 iterations, evals every 2
SHARED = dict(ds_type="fashionmnist", ds_path="synthetic", epses_specs=SPECS, batch_size=16,
              optimizer_name="adam", lr=3e-3, wd=0.1, synthetic_sizes=(64, 32, 32),
              eval_schedule=((None, 2),), max_num_iters=4, keep_last_models=2,
              init_epses_composition_unit_theoretical_output_std=True)
# each run's move from the shared init against the other's, as a share of
# the largest move: float32 steps in other summation orders (the runner
# tests' bound, tests/test_torch_port_runner.py)
MOVE_TOL = 5e-5
# logits of the served reference forward against JAX's, float32 in other
# summation orders, a share of the largest logit
LOGIT_TOL = 1e-5
FALLBACK = "performance_fallback:"


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The suite runs in several worker processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the gate against JAX's

# (c, q, K, O, layer index): the repo's models' layers, and four outside
# the kernels' plans
LAYERS = {
    "flagship layer 0": (1, 2, 4, 4, 0),
    "flagship layer 1": (1, 4, 3, 6, 1),
    "three-EPS layer 0": (1, 2, 2, 4, 0),
    "three-EPS layer 1": (1, 4, 2, 6, 1),
    "three-EPS layer 2": (1, 6, 2, 12, 2),
    "deep layer 1": (1, 4, 3, 12, 1),
    "deep layer 2": (1, 12, 2, 24, 2),
    "CIFAR (2,12), 3 channels": (3, 2, 2, 12, 0),
    "CIFAR rgb (2,4), Q0 = 3": (1, 3, 2, 4, 0),
    "CIFAR rgb (3,6) after it": (1, 4, 3, 6, 1),
    "(5,4)": (1, 2, 5, 4, 0),
    "colored (3,8)": (3, 2, 3, 8, 0),
    "(4,16) as a second layer": (1, 4, 4, 16, 1),
    "(3,24) after (4,16)": (1, 16, 3, 24, 1),
}
OUT_OF_PLAN = ("(5,4)", "colored (3,8)", "(4,16) as a second layer", "(3,24) after (4,16)")


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(LAYERS))
def test_gate_agrees_with_pallas_forward_fits(name, bf16):
    """At the JAX package's split, the port's gate for the training step
    (K1 ± t, ``eps_dcore``, every d_views arm; the bf16 mode's plans with
    ``bf16``) takes exactly the layers ``pallas_forward_fits`` takes at that
    width (mm_bytes 4 or 2), and each objective's gate agrees for these
    layers; the four out-of-plan layers are refused."""
    c, q, k, o, li = LAYERS[name]
    n = k * k * c
    n1 = teps._balanced_split(n, q, o)
    cd = torch.bfloat16 if bf16 else None
    n1_k, _ = K.plan_call(c, q, k, n1)
    takes = K.kernels_take_split(c, q, k, n1_k, o, None, li, K.objective_name(False, None, cd), cd)
    assert takes == jeps_pallas.pallas_forward_fits(n, n1, q, o, mm_bytes=2 if bf16 else 4)
    assert takes == (name not in OUT_OF_PLAN)
    for objective in ("serve-f32", "serve-int8", "train-int8"):
        assert K.kernels_take_split(c, q, k, n1_k, o, None, li, objective, cd) == takes


def test_gate_is_the_autotuners_and_takes_every_arm():
    """The tuner's ``kernels_take_split`` is the gate itself; at any pixel
    count (None) a layer whose A reaches ``SAVE_T_MIN_A`` is checked on both
    d_views arms, at a pixel count on its arm there."""
    from dctn_tpu_torch.train import autotune as at

    assert at.kernels_take_split is K.kernels_take_split
    assert at.objective_name is K.objective_name
    assert K._arms(1, 9, 5, 4, 6, None, 4) == ("saved_t", "recompute")
    assert K._arms(1, 9, 5, 4, 6, 128 * 529, 4) == ("saved_t",)
    assert K._arms(1, 4, 3, 4, 6, None, 4) == ("recompute",)
    assert K._arms(0, 8, 4, 4, 4, None, 4) == ("dcore_only",)


# ---------------------------------------------------------------------------
# a model outside the kernels' plans: the runner, predict and export


def _force_port_gate(monkeypatch, refused_outputs):
    """The port's gate refuses the layers whose O is in ``refused_outputs``
    (each module that holds the gate's name)."""
    real = K.kernels_take_split

    def gate(c, q, k, n1, o, npix, li, objective, compute_dtype=None):
        return o not in refused_outputs and real(c, q, k, n1, o, npix, li, objective,
                                                 compute_dtype)

    for mod in (K, tmodel, teps):
        monkeypatch.setattr(mod, "kernels_take_split", gate)


def _fallback_lines(out_dir):
    """The fallbacks a run recorded (the first follows the flags' JSON on
    its line)."""
    with open(os.path.join(out_dir, "run_info.txt")) as f:
        return [ln.split(FALLBACK, 1)[1] for ln in f.read().splitlines() if FALLBACK in ln]


def _out_dir(root) -> str:
    (sub,) = os.listdir(root)
    return os.path.join(root, sub)


@pytest.fixture(scope="module")
def init_npz(tmp_path_factory):
    """One npz of JAX-drawn weights for SPECS, and them as numpy."""
    tmp = tmp_path_factory.mktemp("init")
    init = jm.init_eps_plus_linear(jax.random.PRNGKey(3),
                                   jm.EPSesPlusLinearConfig(epses_specs=SPECS))
    path = str(tmp / "init.npz")
    save_pytree(init, path)
    return path, jax.tree_util.tree_map(np.asarray, init)


def test_runner_trains_the_reference_layout_beside_jax(init_npz, tmp_path, monkeypatch):
    """Layer 1 (O = 3) refused by the port's gate and every layer by JAX's
    (``pallas_forward_fits`` patched): both runners train the reference
    layout from one npz, the port's layer 0 through the kernels' route
    (their plain versions here) and its layer 1 on the plain path, JAX's on
    its XLA path; every parameter's move agrees within MOVE_TOL of the
    largest; both record their fallbacks in run_info.txt, the port's the
    layout's and layer 1's."""
    path, init = init_npz
    kw = dict(SHARED, load_model_state=path)
    monkeypatch.setattr(jeps_pallas, "pallas_forward_fits", lambda *a, **k: False)
    jstate = jrunner.run(experiments_dir=str(tmp_path / "jax"), autotune_cache=False,
                         train_backend="pallas_interpret", eval_backend="pallas_interpret", **kw)
    _force_port_gate(monkeypatch, {3})
    tstate = trunner.run(experiments_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert isinstance(tstate.extras["model"], tmodel.EPSesPlusLinearReference)
    assert tstate.extras["model"].backend == "pallas" and tstate.num_iters_done == 4
    leaves = jax.tree_util.tree_leaves
    tparams = jax.tree_util.tree_map(lambda t: t.detach().numpy(),
                                     tstate.extras["params_view"](tstate.params))
    for i, (t, j, s) in enumerate(zip(leaves(tparams), leaves(jstate.params), leaves(init))):
        moved_t, moved_j = t.astype(np.float64) - s, np.asarray(j, np.float64) - s
        scale = float(np.abs(moved_j).max())
        assert scale > 1e-4, f"leaf {i} did not move"
        np.testing.assert_allclose(moved_t, moved_j, rtol=0, atol=MOVE_TOL * scale,
                                   err_msg=f"leaf {i}")
    port = _fallback_lines(_out_dir(tmp_path / "port"))
    assert any("fast (cmt) parameter layout unavailable" in ln for ln in port), port
    assert any("EPS layer (n=4, n1=" in ln and "o=3" in ln for ln in port), port
    assert not any("o=4" in ln for ln in port), port  # layer 0 took the kernels' route
    assert _fallback_lines(_out_dir(tmp_path / "jax"))


def test_runner_refuses_qat_without_the_fast_layout(init_npz, tmp_path, monkeypatch):
    """``--qat int8`` needs the fast layout: a usage error in JAX's words,
    as the JAX runner's, before any step."""
    import click

    _force_port_gate(monkeypatch, {3})
    with pytest.raises(click.UsageError, match="--qat int8 needs the fast"):
        trunner.run(experiments_dir=str(tmp_path), device="cpu",
                    **dict(SHARED, load_model_state=init_npz[0], qat="int8"))


def test_predict_and_export_serve_the_reference_forward(init_npz, tmp_path, monkeypatch):
    """predict and both export paths of a model whose layer 1 the kernels
    refuse serve the reference forward (layer 0 through the K1 operator's
    route), its logits within LOGIT_TOL of JAX's reference forward on the
    same weights; int8 raises ``FastLayoutUnavailable`` in each."""
    path, init = init_npz
    _force_port_gate(monkeypatch, {3})
    cfg = tmodel.EPSesPlusLinearConfig(epses_specs=SPECS)
    params = params_from_numpy(init, "cpu", torch.float32)
    x = np.random.default_rng(0).random((1, 3, 28, 28, 2), dtype=np.float32)
    want = np.asarray(jm.eps_plus_linear_forward(
        jax.tree_util.tree_map(jax.numpy.asarray, init), jax.numpy.asarray(x),
        jm.EPSesPlusLinearConfig(epses_specs=SPECS)))
    scale = float(np.abs(want).max())
    model = tpredict.serving_model_kind(cfg, 1)(params, cfg)
    assert isinstance(model, tmodel.EPSesPlusLinearReference) and model.backend == "pallas"
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * scale)
    with pytest.raises(tmodel.FastLayoutUnavailable):
        tpredict.serving_model_kind(cfg, 1, "int8")
    run = tpredict.run(checkpoint=path, ds_type="fashionmnist", ds_path="synthetic",
                       epses_specs=SPECS, split="test", batch_size=16, device="cpu",
                       synthetic_sizes=(64, 32, 32))
    assert isinstance(run.model, tmodel.EPSesPlusLinearReference) and len(run.preds) == 32
    serialized, _ = texport.export_forward(params, cfg, batch_sizes=(3,), device="cpu")
    art = str(tmp_path / "a.zip")
    texport.write_artifact(art, serialized, texport.build_meta(
        model_family="eps", image_size=28, batch_sizes=(3,), backend="pallas",
        platforms=["cpu"], quantize="none", compute_dtype="float32",
        epses_specs=[list(s) for s in SPECS], q0=2, channels=1, num_classes=10))
    _, fns = texport.load_artifact(art, "cpu")
    np.testing.assert_allclose(fns[3](torch.from_numpy(x)).numpy(), want, rtol=0,
                               atol=LOGIT_TOL * scale)
    with pytest.raises(tmodel.FastLayoutUnavailable):
        texport.export_forward(params, cfg, batch_sizes=(3,), device="cpu", quantize="int8")
    slab = texport.space_slab_program(params, cfg, 1, "pallas")
    assert slab.plans is None and slab.backend == "pallas"
    with torch.no_grad():
        whole = slab.features(torch.from_numpy(x))
    assert whole.shape == (3, 26, 26, 3)


# ---------------------------------------------------------------------------
# ConvSBS


@pytest.mark.parametrize("trace_edge", [False, True], ids=["open", "ring"])
@pytest.mark.parametrize("bond", list(range(2, 13)))
def test_conv_sbs_route_matches_sbs_pallas_profitable(bond, trace_edge):
    """The port's ConvSBS route, a pure function of the config: the
    kernels where JAX takes its fused kernels (every string
    ``sbs_pallas_profitable``), else every string on the plain folds."""
    jcfg = jsbs_model.ConvSBSModelConfig(2, bond, trace_edge=trace_edge)
    tcfg = tsbs_model.ConvSBSModelConfig(2, bond, trace_edge=trace_edge)
    jax_kernels = all(sbs_pallas_profitable(s) for layer in jcfg.layer_specs() for s in layer)
    specs, route = tsbs_model.check_kernel_scope(tcfg)
    assert route == ("kernels" if jax_kernels else "plain")
    _, kernels = tsbs_model.model_kernels(tcfg)
    assert (kernels is tsbs_model.PLAIN) == (not jax_kernels)


def test_legacy_runner_records_the_plain_fold(tmp_path):
    """``--bond-dim-size 9`` (the least bond outside the kernels' scope)
    trains on the plain folds with the fallback in run_info.txt (the JAX
    runner's provenance line)."""
    kw = dict(ds_path="synthetic", models_dir=str(tmp_path), num_sbs_layers=2,
              bond_dim_size=9, synthetic_sizes=(16, 16), batch_size=16, epochs=1,
              warmup_num_epochs=0, optimizer_type="sgd", learning_rate=1e-3,
              make_input_window_std_one=True, scale_layers_using_batch=16, seed=0, device="cpu",
              tb_log_every_n_epochs=0)
    _, best_acc = tlegacy.run(**kw)
    assert 0.0 <= best_acc <= 1.0
    lines = _fallback_lines(str(tmp_path))
    assert any("bonds up to 9" in ln and "every string of the model" in ln for ln in lines)


# ---------------------------------------------------------------------------
# the bf16 kernels' plan mirrors


@pytest.mark.parametrize("name", [k for k in LAYERS if k not in OUT_OF_PLAN])
def test_bf16_plan_mirrors_take_every_repo_layer(name):
    """At each layer of the repo's models the bf16 K1, ``eps_dcore`` and
    d_views plans' Python mirrors fit 227 KB (tests/test_torch_port_cuda.py
    holds them equal to the sources' own queries); the d_views limits (≤ 8
    factors a half, B2 ≤ 512) hold where a d_views kernel runs."""
    c, q, k, o, li = LAYERS[name]
    n1, merge = K.plan_call(c, q, k, teps._balanced_split(k * k * c, q, o))
    n, q_k, n1_k = K._kernel_dims(c, q, k, n1, merge)
    assert K._fwd_bf16_plan(n, q_k, n1_k, o, 1)["smem_bytes"] <= K._MAX_SMEM_BYTES
    assert K._dcore_bf16_smem_bytes(n, q_k, n1_k, o) <= K._MAX_SMEM_BYTES
    for recompute in (False, True):
        dviews = K._dviews_bf16_smem_bytes(n, q_k, n1_k, o, recompute)
        assert li == 0 or dviews <= K._MAX_SMEM_BYTES
    if li > 0:
        assert n1_k <= K._BF16_MAX_CHAIN and n - n1_k <= K._BF16_MAX_CHAIN
        assert q_k ** (n - n1_k) <= K._MAX_B2


def test_bf16_plans_at_the_flagship():
    """The flagship's bf16 plans (a pin: a change is a plan change): K1 at
    both layers on its wgmma route (B2 = 256: one output a CTA in 2 passes
    of 128 rows) 141,568
    B (its ring, 131,072 B, and v's 16 staged factor rows), u in rows of A
    (256 and 1024) for the whole batch of 128 in one chunk (80,000 and 67,712
    pixels: 41 and 139 MB), grids of 4 × 625 and 6 × 529 CTAs; the deep
    model's layer 1 at batch 2048 in 9 chunks of 131,072 pixels (256 MiB of
    u each). At layer 1 ``eps_dcore`` 131,072 B (its ring), 6 pixel slices on 132 SMs at batch
    128 (96 tiles of 128 x 128), its operands for the whole batch in one
    chunk (67,712 pixels, 347 MB of u and kr2) and for the deep
    model's layer 1 at batch 2048 in chunks of 65,536; d_views 179,880 B,
    the recompute form 196,520 B (its table of u's last 3 factors, 64
    rows)."""
    assert K._fwd_bf16_plan(8, 4, 4, 4, 128 * 625) == {
        "route": "wgmma", "outputs": 1, "passes": 2, "rows": 1024, "a_pad": 256, "chunk": 80000,
        "chunks": 1, "grid": (4, 625), "smem_bytes": 141568}
    assert K._fwd_bf16_plan(9, 4, 5, 6, 128 * 529) == {
        "route": "wgmma", "outputs": 1, "passes": 2, "rows": 1536, "a_pad": 1024, "chunk": 67712,
        "chunks": 1, "grid": (6, 529), "smem_bytes": 141568}
    deep = K._fwd_bf16_plan(9, 4, 5, 12, 2048 * 529)
    assert (deep["chunk"], deep["chunks"], deep["grid"]) == (131072, 9, (12, 1024))
    assert K._dcore_bf16_smem_bytes(9, 4, 5, 6) == 131072
    assert K._dcore_bf16_slices(1536, 1024, 128 * 529, 132) == 6
    assert K._dcore_bf16_chunk(1536, 1024, 128 * 529) == 67712
    assert K._dcore_bf16_chunk(3072, 1024, 2048 * 529) == 65536
    assert K._dviews_bf16_smem_bytes(9, 4, 5, 6) == 179880
    assert K._dviews_bf16_smem_bytes(9, 4, 5, 6, recompute=True) == 196520
    assert K._dviews_bf16_table_rows(4, 5) == 64


# the bf16 forward's pure-Python pieces: its chunks of u, cmt's padding, its
# plan over every shape the kernels' limits admit


@pytest.mark.parametrize("a,npix,cap", [
    (1024, 128 * 529, 256 << 20),  # flagship layer 1: one chunk
    (1024, 2048 * 529, 256 << 20),  # deep layer 1 at 2048: 9 chunks
    (16, 1, 256 << 20),  # one pixel: one tile
    (81, 10_000, 2 * 128 * 128 * 7),  # A padded to 128; 7 tiles a chunk
    (1 << 20, 5_000, 256 << 20),  # a row of u past the cap: one tile a chunk
    (64, 10**9, 256 << 20),  # the grid's 65535 tiles bound the chunk
])
def test_bf16_fwd_chunks_of_u(monkeypatch, a, npix, cap):
    """A chunk is a whole number of 128-pixel tiles (at least one), at
    most the cap's bytes of u (rows of A rounded up to 64), at most npix
    rounded up and 65535 tiles; the chunks cover npix."""
    monkeypatch.setattr(K, "_BF16_FWD_OPS_BYTES", cap)
    chunk = K._fwd_bf16_chunk(a, npix)
    a_pad = -(-a // 64) * 64
    assert chunk % 128 == 0 and 128 <= chunk <= 65535 * 128
    assert chunk == 128 or 2 * chunk * a_pad <= cap
    assert chunk <= -(-npix // 128) * 128
    assert chunk == min(-(-npix // 128) * 128, 65535 * 128) or 2 * (chunk + 128) * a_pad > cap


@pytest.mark.parametrize("a", [16, 64, 81, 216, 1024])
def test_bf16_fwd_cmt_padding(a):
    """cmt as the bf16 forward reads it: itself where its rows are whole
    steps of 64 and 16-byte aligned, else a copy zero-padded past A."""
    z = 12
    cmt = torch.randn((z, a)).to(torch.bfloat16)
    a_pad = -(-a // 64) * 64
    got = K._fwd_bf16_cmt(cmt, a_pad)
    assert (got is cmt) == (a == a_pad)
    assert got.shape == (z, a_pad) and got.data_ptr() % 16 == 0
    assert torch.equal(got[:, :a], cmt) and not got[:, a:].any()
    base = torch.zeros(z * a + 1, dtype=torch.bfloat16)
    shifted = base[1:].view(z, a)  # 2 bytes past an aligned start
    shifted.copy_(cmt)
    moved = K._fwd_bf16_cmt(shifted, a_pad)
    assert moved is not shifted and moved.data_ptr() % 16 == 0
    assert torch.equal(moved[:, :a], cmt)


@pytest.mark.parametrize("n,q,n1,o", [
    (2, 128, 1, 2),  # v's most staged factor rows: 128
    (10, 2, 1, 3),  # B2 = 512, nine factors of v
    (3, 8, 1, 1),  # q^2 = 64: B2 = 64, two outputs' worth of Z tile, O = 1
    (3, 16, 1, 65535),  # B2 = 256, O at the old grid's limit
    (4, 64, 3, 5),  # n*q = 256, B2 = 64
    (2, 4, 2, 4),  # three-EPS layer 0: A = 16, n2 = 0; mma.sync
    (4, 64, 3, 1),  # mma.sync at n*q = 256 (B2 = 64, Z = 64)
    (2, 128, 1, 1),  # mma.sync with B2 = 128: one output in 2 passes of 64
])
def test_bf16_fwd_plan_takes_every_shape_within_the_limits(n, q, n1, o):
    """Every shape within the bf16 mode's limits (n·q ≤ 256, B2 ≤ 512)
    fits the forward's plan in 227 KB (the wgmma route: v's n2·q ≤ 128
    staged rows beside the 128 KB ring; the mma.sync route: at most 122 KB
    at n·q = 256), and the wrapper's check takes it on shape-only
    tensors."""
    z, a = o * q ** (n - n1), q**n1
    plan = K._fwd_bf16_plan(n, q, n1, o, 1000)
    assert plan["route"] == ("wgmma" if z > 128 else "mma.sync")
    assert plan["smem_bytes"] <= K._MAX_SMEM_BYTES
    views = torch.empty((n, q, 1000), device="meta")
    cmt = torch.empty((z, a), dtype=torch.bfloat16, device="meta")
    assert K._check_fwd_bf16_args(views, cmt, n1, o) == plan


# the route each of the repo's layers takes (a pin: a change is a plan
# change): wgmma where Z > 128, the mma.sync kernel for the three-EPS
# model's small Z (4, 24 and 72 rows), where u's round trip through device
# memory and a second launch cost more than they save
_BF16_FWD_ROUTES = {
    "flagship layer 0": "wgmma", "flagship layer 1": "wgmma", "three-EPS layer 0": "mma.sync",
    "three-EPS layer 1": "mma.sync", "three-EPS layer 2": "mma.sync", "deep layer 1": "wgmma",
    "deep layer 2": "wgmma",
}


@pytest.mark.parametrize("name", [k for k in LAYERS if k not in OUT_OF_PLAN])
def test_bf16_fwd_route_of_every_repo_layer(name):
    c, q, k, o, _ = LAYERS[name]
    n1, merge = K.plan_call(c, q, k, teps._balanced_split(k * k * c, q, o))
    n, q_k, n1_k = K._kernel_dims(c, q, k, n1, merge)
    plan = K._fwd_bf16_plan(n, q_k, n1_k, o, 128 * 625)
    z = o * q_k ** (n - n1_k)
    assert plan["route"] == ("wgmma" if z > 128 else "mma.sync")
    assert plan["route"] == _BF16_FWD_ROUTES.get(name, plan["route"])
    assert (plan["chunks"] > 0) == (plan["route"] == "wgmma")
