"""The reference layout's differentiable ``eps()`` and training step, and the
steps' ``with_probs``, on the CPU, held against the JAX package in float64:
``eps``'s custom backward (``EPSContract``, the JAX ``_eps_contract_bwd``)
and its plain autograd against ``jax.grad`` of ``eps(backend="xla")``,
``eps_one_by_one``; ``make_train_step`` against the JAX ``make_train_step``
(its metrics and the per-sample probabilities too); and with the
probabilities on or off, both steps make the same update bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dctn_tpu.models import eps_plus_linear as jepl
from dctn_tpu.ops import eps as jeps
from dctn_tpu.train import make_optimizer as jax_make_optimizer
from dctn_tpu.train import make_train_step as jax_make_train_step
from dctn_tpu_torch.interop import params_from_numpy
from dctn_tpu_torch.models import (
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    EPSesPlusLinearReference,
    draw_dropout_masks,
    eps_plus_linear_forward,
    fast_params_from_reference,
)
from dctn_tpu_torch.ops import eps as teps
from dctn_tpu_torch.train import make_fast_train_step, make_optimizer, make_train_step
from dctn_tpu_torch.train.checkpoint import flatten_tree

# float64 gradients of the same sums in other orders: within this share of
# the largest entry (read ≤ 2e-15 on these shapes)
GRAD_TOL = 1e-12


@pytest.mark.parametrize("custom_vjp", [True, False], ids=["custom_vjp", "autograd"])
@pytest.mark.parametrize(
    "k,c,q,o,split",
    [(2, 1, 2, 3, None), (2, 2, 3, 4, None), (2, 1, 4, 3, 4), (3, 1, 2, 2, 2), (2, 1, 3, 5, 1)],
    ids=["flagship-like", "two-channels", "n1=n", "k3", "n1=1"],
)
def test_eps_gradients_match_jax_xla(k, c, q, o, split, custom_vjp):
    """The core's and the input's gradients of Σ eps(core, x)·g, through
    ``EPSContract`` and through autograd of the staged forward, equal
    ``jax.grad`` of the JAX ``eps`` (xla backend, its custom VJP) within
    GRAD_TOL of each gradient's largest entry; so do the outputs, and
    ``eps_one_by_one`` agrees with both."""
    n = k * k * c
    rng = np.random.default_rng(k * 100 + c * 10 + q)
    core = rng.normal(size=(q,) * n + (o,))
    x = rng.uniform(size=(c, 3, 6, 5, q))
    g = rng.normal(size=(3, 7 - k, 6 - k, o))

    def jloss(cc, xx):
        return jnp.sum(jeps.eps(cc, xx, split=split, backend="xla") * g)

    jout = np.asarray(jeps.eps(jnp.asarray(core), jnp.asarray(x), split=split, backend="xla"))
    jd_core, jd_x = (np.asarray(a) for a in jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(core), jnp.asarray(x)))
    tc = torch.tensor(core, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    out = teps.eps(tc, tx, split=split, custom_vjp=custom_vjp)
    (out * torch.tensor(g)).sum().backward()
    for got, want, what in ((out.detach().numpy(), jout, "out"), (tc.grad.numpy(), jd_core, "d_core"),
                            (tx.grad.numpy(), jd_x, "d_x")):
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=what)
    oracle = teps.eps_one_by_one(torch.tensor(core), torch.tensor(x)).numpy()
    np.testing.assert_allclose(oracle, jout, rtol=0, atol=GRAD_TOL * np.abs(jout).max())


def test_eps_backward_without_the_inputs_gradient_and_the_shape_helpers():
    """An input that needs no gradient (a first layer's) gets none and the
    core's gradient is unchanged; ``is_eps`` and ``matrix_shape`` as in the
    JAX package."""
    rng = np.random.default_rng(0)
    core = rng.normal(size=(2,) * 4 + (3,))
    x = rng.uniform(size=(1, 2, 5, 5, 2))
    grads = []
    for need_x in (False, True):
        tc = torch.tensor(core, requires_grad=True)
        tx = torch.tensor(x, requires_grad=need_x)
        teps.eps(tc, tx).pow(2).sum().backward()
        assert (tx.grad is None) == (not need_x)
        grads.append(tc.grad)
    assert torch.equal(*grads)
    for a in (core, np.zeros((3, 4)), np.zeros((2, 3, 4)), np.zeros((5,))):
        assert teps.is_eps(torch.tensor(a)) == jeps.is_eps(jnp.asarray(a))
    assert teps.matrix_shape(torch.tensor(core)) == jeps.matrix_shape(jnp.asarray(core)) == (3, 16)


SPECS = ((2, 4), (2, 3))


def _setup(batch=8, size=7, seed=0):
    rng = np.random.default_rng(seed)
    np_params = {"epses": (rng.normal(size=(2,) * 4 + (4,)) * 0.25,
                           rng.normal(size=(4,) * 4 + (3,)) / 16),
                 "linear": {"w": rng.normal(size=((size - 2) ** 2 * 3, 10)) * 0.05,
                            "b": rng.uniform(-0.05, 0.05, size=(10,))}}
    x = rng.uniform(size=(1, batch, size, size, 2))
    y = np.arange(batch) % 10
    return np_params, x, y


@pytest.mark.parametrize("accum", [1, 2])
def test_reference_step_matches_the_jax_step(accum):
    """Three float64 steps of ``make_train_step`` (Adam at weight decay 0.1,
    the composition regularizer, layer 1 frozen so that only the decay moves
    it, ``with_probs``) against the
    JAX ``make_train_step`` on the same params and batch: the params after
    each step within GRAD_TOL·1e3 of their largest entry (Adam divides by a
    square root of the gradients' squares: their last bits come through
    scaled up), loss, CE, reg and the per-sample probabilities within 1e-12
    relative."""
    np_params, x, y = _setup()
    size = x.shape[2]
    jcfg = jepl.EPSesPlusLinearConfig(epses_specs=SPECS, image_size=size, q0=2)
    cfg = EPSesPlusLinearConfig(epses_specs=SPECS, image_size=size, q0=2, dtype=torch.float64)
    jopt = jax_make_optimizer("adam", 1e-2, 0.1)
    jstep = jax_make_train_step(jcfg, jopt, "epses_composition", 1e-3, frozen_eps_indices=(1,),
                                donate=False, with_probs=True, grad_accum_steps=accum)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jo = jopt.init(jp)
    model = EPSesPlusLinearReference(params_from_numpy(np_params, dtype=torch.float64), cfg)
    opt = make_optimizer("adam", model.parameters(), 1e-2, 0.1)
    step = make_train_step(model, opt, "epses_composition", 1e-3, frozen_eps_indices=(1,),
                           with_probs=True, grad_accum_steps=accum)
    key = jax.random.PRNGKey(0)
    for _ in range(3):
        jp, jo, jm = jstep(jp, jo, key, jnp.asarray(x), jnp.asarray(y))
        m = step(torch.tensor(x), torch.tensor(y))
        for k in ("loss", "ce", "reg_term", "probs_of_true_class"):
            np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-12, atol=0, err_msg=k)
        for name, got in flatten_tree(model.reference_params()).items():
            want = np.asarray(flatten_tree(jp)[name])
            np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                       atol=GRAD_TOL * 1e3 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("layout", ["fast", "reference"])
@pytest.mark.parametrize("accum", [1, 2])
def test_with_probs_leaves_the_update_bit_equal(layout, accum):
    """With parameter dropout (p = 0.8, masks from generators of one seed)
    and weight decay, two steps with the probabilities on and off end on the
    same bits and report the same loss; the probabilities are each sample's
    softmax probability of its label under the step's (dropped) forward, in
    batch order over the microbatches, on the step's device."""
    np_params, x, y = _setup()
    size = x.shape[2]
    cfg = EPSesPlusLinearConfig(epses_specs=SPECS, image_size=size, q0=2, dropout_p=0.8)
    params = params_from_numpy(np_params, dtype=torch.float32)
    runs = []
    for with_probs in (False, True):
        if layout == "fast":
            model = EPSesPlusLinear.from_reference(params, cfg)
            make = make_fast_train_step
        else:
            model = EPSesPlusLinearReference(params, cfg)
            make = make_train_step
        opt = make_optimizer("adam", model.parameters(), 1e-2, 0.01)
        step = make(model, opt, "epswise", 1e-4, with_probs=with_probs, grad_accum_steps=accum)
        gen = torch.Generator().manual_seed(5)
        xb, yb = torch.tensor(x, dtype=torch.float32), torch.tensor(y)
        metrics = [step(xb, yb, gen) for _ in range(2)]
        runs.append((model, metrics))
    (m0, met0), (m1, met1) = runs
    for a, b in zip(m0.parameters(), m1.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(met0, met1):
        assert torch.equal(a["loss"], b["loss"]) and "probs_of_true_class" not in a
        probs = b["probs_of_true_class"]
        assert probs.shape == (8,) and probs.device == xb.device
        assert bool(((probs > 0) & (probs < 1)).all())
    # the probabilities of the first step, recomputed from its dropped forward
    ref = params_from_numpy(np_params, dtype=torch.float32)
    plans = fast_params_from_reference(ref, cfg)[1]
    gen = torch.Generator().manual_seed(5)
    want = []
    for i in range(accum):
        mb = 8 // accum
        masks = draw_dropout_masks(plans, 0.8, gen)
        logits = eps_plus_linear_forward(ref, xb[:, i * mb : (i + 1) * mb], cfg, masks=masks)
        want.append(torch.softmax(logits, 1)[torch.arange(mb), yb[i * mb : (i + 1) * mb]])
    torch.testing.assert_close(met1[0]["probs_of_true_class"], torch.cat(want), rtol=1e-5, atol=1e-7)
