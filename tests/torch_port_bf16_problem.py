"""The problem the bf16 cases of the port's grid tests share (TP, SP,
SP×TP): the JAX package's config with ``compute_dtype`` bf16 in float32, the
theoretical init drawn with numpy and features of unit second moment.

On the grid tests' uniform [0, 1) features each layer's output shrinks by
3^(K²/2) under JAX's init, so the bf16 operands' rounding moves the logits
by less than the float32 bound (1.4e-5 of the largest against 2e-5, read
on the TP grid): a port that ran those layers in float32 would pass. Here
each layer's output stays O(1), so the float32 logits miss the bound by
two orders of magnitude, and the gradients are 10-50 times the parameters'
largest entries: the steps run at ``LR`` 1e-4 (about 1% a step)."""

from __future__ import annotations

import numpy as np

LR = 1e-4


def unit_problem(specs, image=6, backend="pallas_interpret", batch=8, seed=0):
    """(JAX cfg, JAX params, numpy params, x, y): each core randn·Q^(-n/2),
    the classifier's w randn·in^(-1/2)/4 and b U(±in^(-1/2)), x uniform
    times √3."""
    import jax
    import jax.numpy as jnp

    from dctn_tpu.models import EPSesPlusLinearConfig as JCfg
    from dctn_tpu.models import init_eps_plus_linear

    jcfg = JCfg(epses_specs=specs, image_size=image, q0=2, dtype=np.float32,
                train_backend=backend, eval_backend=backend, compute_dtype=jnp.bfloat16)
    shapes = init_eps_plus_linear(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(seed)
    n_in = shapes["linear"]["w"].shape[0]
    params = {
        "epses": tuple((rng.standard_normal(c.shape) * c.shape[0] ** (-(c.ndim - 1) / 2))
                       .astype(np.float32) for c in shapes["epses"]),
        "linear": {"w": (rng.standard_normal(shapes["linear"]["w"].shape) * n_in**-0.5 / 4)
                   .astype(np.float32),
                   "b": (rng.uniform(-1, 1, shapes["linear"]["b"].shape) * n_in**-0.5)
                   .astype(np.float32)},
    }
    x = (rng.uniform(size=(1, batch, image, image, 2)) * np.sqrt(3.0)).astype(np.float32)
    y = np.arange(batch) % 10
    return jcfg, jax.tree_util.tree_map(jnp.asarray, params), params, x, y


# each parameter's move over the steps, the grid's against JAX's, as a
# share of JAX's largest move: the moves are sums of lr·gradient, and the
# two packages' bf16 gradients agree to ~4e-7 of the largest on these short
# sums; the float32 run's moves are 3e-3 or more away. Plus two float32
# spacings of the parameter's largest entry: a move is read as the
# difference of two float32 parameters
MOVE_RTOL = 1e-5


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree, dtype=np.float64)]


def check_moves(init, got, want, want32) -> None:
    """Every parameter's move from ``init`` in ``got`` within MOVE_RTOL of
    its largest move in ``want`` (JAX's bf16 run); some core's move in
    ``want32`` (JAX's float32 run) further than that from ``got``'s."""
    missed = []
    for i, (s, a, b, c) in enumerate(zip(_leaves(init), _leaves(got), _leaves(want),
                                         _leaves(want32), strict=True)):
        ma, mb, mc = a - s, b - s, c - s
        scale = float(np.abs(mb).max())
        assert scale > 0, f"leaf {i} did not move"
        bound = MOVE_RTOL * scale + 2 * float(np.spacing(np.float32(np.abs(b).max())))
        assert float(np.abs(ma - mb).max()) <= bound, (i, np.abs(ma - mb).max(), scale)
        missed.append(float(np.abs(ma - mc).max()) > bound)
    assert any(missed), "the float32 run's moves are within the bound: is the bf16 mode on?"


def one_device_f32(params, specs, x, y, kind, reg_type, reg, lr, steps):
    """The port's float32 run on one device over the whole batch: ``steps``
    SGD steps of the fast step (``kind`` "fast"), the QAT step ("qat") or
    the reference layout's ("xla", any other kind); its reference params
    (numpy). What the bf16 grid runs' moves are held apart from."""
    import torch

    from dctn_tpu_torch.interop import params_from_numpy
    from dctn_tpu_torch.models import (
        EPSesPlusLinear,
        EPSesPlusLinearConfig,
        EPSesPlusLinearReference,
        reference_params_from_fast,
    )
    from dctn_tpu_torch.train import make_fast_train_step, make_optimizer, make_train_step

    cfg = EPSesPlusLinearConfig(epses_specs=specs, image_size=x.shape[2], q0=x.shape[-1])
    fast = kind in ("fast", "qat")
    if fast:
        model = EPSesPlusLinear.from_reference(params_from_numpy(params), cfg)
        step = make_fast_train_step(model, make_optimizer("sgd", model.parameters(), lr),
                                    reg_type, reg, qat="int8" if kind == "qat" else None)
    else:
        model = EPSesPlusLinearReference(params_from_numpy(params), cfg)
        step = make_train_step(model, make_optimizer("sgd", model.parameters(), lr), reg_type, reg)
    for _ in range(steps):
        step(torch.as_tensor(x), torch.as_tensor(y))
    now = (reference_params_from_fast(model.fast_params(), cfg, model.plans) if fast
           else model.reference_params())
    return {"epses": [c.detach().numpy() for c in now["epses"]],
            "linear": {k: v.detach().numpy() for k, v in now["linear"].items()}}
