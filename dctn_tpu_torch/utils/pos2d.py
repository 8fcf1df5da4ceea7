"""2-D grid positions with a raster-order index (port of
``dctn_tpu/utils/pos2d.py``, a copy: the port imports nothing of the JAX
package). Plain Python values that lay out kernel positions."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, order=True)
class Pos2D:
    h: int
    w: int


def pos_to_index(max_w: int, pos: Pos2D) -> int:
    """Index of ``pos`` in raster order over a grid with widths 0..max_w:
    0 1 2  3
    4 5 6  7
    8 9 10 11
    """
    if pos.w > max_w:
        raise ValueError(f"{pos.w=} exceeds {max_w=}")
    return pos.h * (max_w + 1) + pos.w


def index_to_pos(max_w: int, index: int) -> Pos2D:
    """Inverse of ``pos_to_index`` for a fixed ``max_w``."""
    return Pos2D(index // (max_w + 1), index % (max_w + 1))


def raster_positions(kernel_size: int) -> tuple[Pos2D, ...]:
    """All positions of a kernel_size×kernel_size grid in raster order."""
    return tuple(Pos2D(h, w) for h in range(kernel_size) for w in range(kernel_size))
