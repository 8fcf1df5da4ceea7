"""ConvSBS, the string-bond-state (tensor-train) patch operator (port of
``dctn_tpu/ops/sbs.py``: the specs, the four inits, the plain fold and
``multiply_by_scalar``).

A ConvSBS parameterizes a multilinear window operator as a tensor train:
one core per kernel position, of shape ``(out_q, bond_l, bond_r, Q_in, …,
Q_in)`` (one Q_in dim per channel). ``conv_sbs`` here is the JAX package's
``backend="xla"`` fold in the reference layout; the batch-minor kernel
route is ``kernels.sbs_kernels.conv_sbs_t``. The TT statistics (``tt_*``)
and ``as_eps`` are not ported yet (ROADMAP, the logging slice).

The inits draw from a ``torch.Generator``, so the same seed gives other
numbers than ``jax.random``; the tests carry weights across as numpy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from ..utils.pos2d import Pos2D, pos_to_index
from .eps import khatri_rao
from .windows import window_views_at_positions


@dataclasses.dataclass(frozen=True)
class SBSSpecCore:
    """One TT core's position in the kernel grid and its output quantum dim."""

    position: Pos2D
    out_quantum_dim_size: int


@dataclasses.dataclass(frozen=True)
class SBSCoreShape:
    out_quantum_dim_size: int
    bond_left_size: int
    bond_right_size: int
    in_num_channels: int
    in_quantum_dim_size: int

    def as_tuple(self) -> Tuple[int, ...]:
        return (
            self.out_quantum_dim_size, self.bond_left_size, self.bond_right_size,
        ) + (self.in_quantum_dim_size,) * self.in_num_channels


@dataclasses.dataclass(frozen=True)
class SBSSpecString:
    """A string of TT cores (sbs.py:77-148). ``bond_sizes[i]`` is the LEFT
    bond of core i; its right bond is ``bond_sizes[i+1]``, cyclically, so
    ``bond_sizes[0]`` > 1 closes a tensor ring (trace_edge)."""

    cores: Tuple[SBSSpecCore, ...]
    bond_sizes: Tuple[int, ...]
    in_num_channels: int
    in_quantum_dim_size: int = 2

    def __post_init__(self):
        if min(c.position.h for c in self.cores) != 0 or min(
            c.position.w for c in self.cores
        ) != 0:
            raise ValueError("positions of cores must start at (0, 0)")
        if len(self.bond_sizes) != len(self.cores):
            raise ValueError(f"{len(self.bond_sizes)=} must equal {len(self.cores)=}")

    def __len__(self) -> int:
        return len(self.cores)

    @property
    def shapes(self) -> Tuple[SBSCoreShape, ...]:
        right = self.bond_sizes[1:] + (self.bond_sizes[0],)
        return tuple(
            SBSCoreShape(c.out_quantum_dim_size, left, r, self.in_num_channels,
                         self.in_quantum_dim_size)
            for c, left, r in zip(self.cores, self.bond_sizes, right)
        )

    @property
    def positions(self) -> Tuple[Pos2D, ...]:
        return tuple(c.position for c in self.cores)

    @property
    def max_height_pos(self) -> int:
        return max(c.position.h for c in self.cores)

    @property
    def max_width_pos(self) -> int:
        return max(c.position.w for c in self.cores)

    def get_indices_wrt_standard_order(self) -> Tuple[int, ...]:
        """For a full rectangular grid: each core's index in raster order."""
        assert len(self) == (self.max_width_pos + 1) * (self.max_height_pos + 1), (
            "cores must tile a full rectangle"
        )
        return tuple(pos_to_index(self.max_width_pos, p) for p in self.positions)

    @property
    def out_total_quantum_dim_size(self) -> int:
        return math.prod(c.out_quantum_dim_size for c in self.cores)

    @property
    def in_total_dim_size(self) -> int:
        return self.in_quantum_dim_size ** (self.in_num_channels * len(self))


SBSCores = Tuple[torch.Tensor, ...]


def validate_cores(spec: SBSSpecString, cores: Sequence[torch.Tensor]) -> None:
    assert len(cores) == len(spec)
    for core, shape in zip(cores, spec.shapes):
        assert tuple(core.shape) == shape.as_tuple(), (tuple(core.shape), shape.as_tuple())


# ---------------------------------------------------------------------------
# initializers (sbs.py:164-250)


def _normal(generator: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=dtype)


def init_dumb_normal(
    generator: torch.Generator, spec: SBSSpecString, std: float = 0.9,
    dtype=torch.float32,
) -> SBSCores:
    return tuple(std * _normal(generator, s.as_tuple(), dtype) for s in spec.shapes)


def khrulkov_core_std(spec: SBSSpecString, std_of_matrix: Optional[float]) -> float:
    """Per-core element std of the Khrulkov TT-aware init: the dense
    matrix's element variance split evenly across the cores and divided by
    the product of the bond ranks."""
    if std_of_matrix is not None:
        var_matrix = std_of_matrix**2
    else:
        var_matrix = 2.0 / (spec.in_total_dim_size + spec.out_total_quantum_dim_size)
    n = len(spec)
    var_cores = var_matrix ** (1.0 / n) / math.prod(spec.bond_sizes) ** (1.0 / n)
    return math.sqrt(var_cores)


def init_khrulkov_normal(
    generator: torch.Generator, spec: SBSSpecString,
    std_of_matrix: Optional[float] = None, dtype=torch.float32,
) -> SBSCores:
    std = khrulkov_core_std(spec, std_of_matrix)
    return tuple(std * _normal(generator, s.as_tuple(), dtype) for s in spec.shapes)


def init_normal_preserving_output_std(
    generator: torch.Generator, spec: SBSSpecString, dtype=torch.float32
) -> SBSCores:
    """Khrulkov init with matrix std (Q^(C·#cores))^(-1/2): input windows
    with i.i.d. coordinates of mean μ and std σ give outputs of std √(σ²+μ²)."""
    return init_khrulkov_normal(generator, spec, spec.in_total_dim_size**-0.5, dtype=dtype)


def init_min_random_eye(
    generator: torch.Generator, spec: SBSSpecString, base_std: float,
    dtype=torch.float32,
) -> SBSCores:
    """Identity-like + noise: middle cores get a truncated scaled identity
    over (bond_l, bond_r), the first and last a single 1/Q^C entry at
    [0, 0, 0, …], all N(0, base_std/Q^C) noise."""
    assert spec.bond_sizes[0] == 1, "min_random_eye can't work with a tensor ring"
    inner = spec.bond_sizes[1:]
    assert all(b == inner[0] for b in inner), "all inner bonds must match"
    bond = inner[0] if inner else 1
    out_dim = spec.out_total_quantum_dim_size
    assert out_dim == max(s.out_quantum_dim_size for s in spec.shapes), (
        "min_random_eye needs a single core carrying the whole output dim"
    )
    q_total = spec.in_quantum_dim_size**spec.in_num_channels
    m = min(bond, out_dim)
    eye = torch.zeros((bond, bond), dtype=dtype)
    eye[:m, :m] = torch.eye(m, dtype=dtype) / q_total
    cores = []
    for i, shape in enumerate(spec.shapes):
        noise = _normal(generator, shape.as_tuple(), dtype) * (base_std / q_total)
        if i == 0 or i == len(spec) - 1:
            base = torch.zeros(shape.as_tuple(), dtype=dtype)
            base[(0, 0, 0) + (0,) * spec.in_num_channels] = 1.0 / q_total
        else:
            base = eye.reshape((1, bond, bond) + (1,) * spec.in_num_channels).expand(
                shape.as_tuple()
            )
        cores.append(base + noise)
    return tuple(cores)


# ---------------------------------------------------------------------------
# the plain fold


def conv_sbs(spec: SBSSpecString, cores: Sequence[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The string over all windows of ``x`` (C, B, H, W, Q) → (B, H', W',
    ∏ out_q), H' = H - max_h (the XLA branch of sbs.py:263-339): per core one
    contraction of the Khatri-Rao-merged channel views with the matricized
    core, a left-to-right bond fold accumulating the output dims, then the
    ring trace (a squeeze for an open string)."""
    validate_cores(spec, cores)
    c = spec.in_num_channels
    views = window_views_at_positions(x, spec.positions)
    tt_mats = []
    for i, (core, shape) in enumerate(zip(cores, spec.shapes)):
        inp = khatri_rao(views[i * c : (i + 1) * c])  # (B, H', W', Q^C)
        o, l, r = shape.out_quantum_dim_size, shape.bond_left_size, shape.bond_right_size
        m = inp @ core.reshape(o * l * r, -1).T
        tt_mats.append(m.reshape(*m.shape[:-1], o, l, r))
    # acc (B, H', W', O, b0, r): the first core's (o, l, r) already has it
    acc = tt_mats[0]
    for m in tt_mats[1:]:
        acc = torch.einsum("...xar,...yrs->...xyas", acc, m)
        acc = acc.reshape(*acc.shape[:3], acc.shape[3] * acc.shape[4], *acc.shape[5:])
    return torch.diagonal(acc, dim1=-2, dim2=-1).sum(-1)


def many_conv_sbs(
    specs: Sequence[SBSSpecString], cores_per_string: Sequence[Sequence[torch.Tensor]],
    x: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """Several strings over the same input (ManyConvSBS, sbs.py:342-352)."""
    return tuple(conv_sbs(s, cs, x) for s, cs in zip(specs, cores_per_string))


def make_many_specs(
    in_num_channels: int, in_quantum_dim_size: int, bond_dim_size: int,
    trace_edge: bool, cores_specs: Sequence[Tuple[SBSSpecCore, ...]],
) -> Tuple[SBSSpecString, ...]:
    """The strings' specs as ManyConvSBS builds them (sbs.py:355-376): the
    first bond is 1 unless trace_edge; all strings share the total output
    dim."""
    specs = tuple(
        SBSSpecString(
            tuple(cs),
            (bond_dim_size if trace_edge else 1,) + (bond_dim_size,) * (len(cs) - 1),
            in_num_channels, in_quantum_dim_size,
        )
        for cs in cores_specs
    )
    assert len({s.out_total_quantum_dim_size for s in specs}) == 1, (
        "all strings must have the same total output dim"
    )
    return specs


def multiply_by_scalar(
    spec: SBSSpecString, cores: Sequence[torch.Tensor], scalar: float
) -> SBSCores:
    """Scale the implied dense tensor by ``scalar``, the factor spread
    evenly over the cores (sbs.py:438-449)."""
    n = len(cores)
    if scalar < 0 and n % 2 == 0:
        raise ValueError("cannot distribute a negative scalar over an even chain")
    factor = scalar ** (1.0 / n) if scalar >= 0 else -((-scalar) ** (1.0 / n))
    return tuple(c * factor for c in cores)
