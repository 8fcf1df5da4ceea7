"""Statistics of a batch of rank-one tensors without densifying it (port of
the part of ``dctn_tpu/ops/rank_one.py`` that ``std_over_batch`` needs).

A rank-one tensor T = v₁ ⊗ … ⊗ v_F is kept as its factors; over a batch,
sum(T) = ∏_f sum(v_f) and ‖T‖²_F = ∏_f ‖v_f‖², so nothing of size Q^F is
built (rank_one.py:1-16).
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class RankOneTensorsBatch:
    """Factors of a batch of rank-one tensors: every index over the dims other
    than ``factors_dim`` and ``coordinates_dim`` names one tensor, whose
    factors are the fibers of the remaining 2-D slice."""

    array: torch.Tensor
    factors_dim: int
    coordinates_dim: int

    def __post_init__(self):
        if self.factors_dim == self.coordinates_dim:
            raise ValueError("factors_dim must differ from coordinates_dim")
        nd = self.array.ndim
        if not (0 <= self.factors_dim < nd and 0 <= self.coordinates_dim < nd):
            raise ValueError("dims out of range")

    @property
    def ncoordinates(self) -> int:
        """Number of elements in ONE dense tensor of the batch."""
        return self.array.shape[self.coordinates_dim] ** self.array.shape[self.factors_dim]

    @property
    def ntensors(self) -> int:
        return math.prod(
            s for i, s in enumerate(self.array.shape)
            if i not in (self.factors_dim, self.coordinates_dim)
        )

    def _prod_of_sums(self, a: torch.Tensor) -> torch.Tensor:
        return torch.prod(
            torch.sum(a, dim=self.coordinates_dim, keepdim=True),
            dim=self.factors_dim, keepdim=True,
        )

    def sum_over_batch(self) -> torch.Tensor:
        return torch.sum(self._prod_of_sums(self.array))

    def mean_over_batch(self) -> torch.Tensor:
        return self.sum_over_batch() / float(self.ntensors * self.ncoordinates)

    def squared_fro_norm_over_batch(self) -> torch.Tensor:
        return torch.sum(self._prod_of_sums(self.array**2))

    def var_over_batch(self, unbiased: bool = True) -> torch.Tensor:
        """Variance over the implied dense batch via the sum/norm identities
        (rank_one.py:97-108)."""
        total = self.sum_over_batch()
        mean = self.mean_over_batch()
        nelement = float(self.ntensors * self.ncoordinates)
        divisor = nelement - 1.0 if unbiased else nelement
        return (
            self.squared_fro_norm_over_batch() / divisor
            - 2 * total / divisor * mean
            + nelement / divisor * mean**2
        )

    def std_over_batch(self, unbiased: bool = True) -> torch.Tensor:
        return self.var_over_batch(unbiased) ** 0.5
