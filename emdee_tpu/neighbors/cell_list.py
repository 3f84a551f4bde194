"""Fixed-shape bin-and-sort cell lists.

The fixed-shape re-design of the reference's linked-cell CUDA machinery
(cells.jl).  The reference builds per-cell linked lists with pointer-chasing
kernels (`distribute!` cells.jl:46-60), incrementally splices movers through
shared-memory baskets (`clean_cells!`/`collect_baskets!`/`renew_cells!`
cells.jl:62-174), and gathers neighbor candidates through a half-shell
action/reaction stencil (cells.jl:28-44).  Pointer-chasing and atomics are
hostile to XLA; here the same geometry becomes dense, static-shape array ops:

- cell ids from wrapped scaled coordinates (the cells.jl:80-85 binning math),
- a stable `argsort` by cell id replacing the linked lists,
- a dense ``(num_cells, capacity)`` atom table built with a scatter,
- stencil *offsets* precomputed on host (the cells.jl:28-34 geometry, with the
  correct ``max(|v|-1, 0)`` nearest-corner distance instead of the reference's
  conservative ``|v|-1``), applied with modular arithmetic in-graph.

"Incremental update" needs no special kernels: rebuilding is one sort — O(N
log N) with perfect memory coalescing — and is further amortized by the
displacement-triggered neighbor list on top (neighbor_list.py).

Geometry matches the reference: M = ⌊ndiv·L/cutoff⌋ cells per dimension with
ndiv=2 by default (cells.jl:36,176).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from emdee_tpu.core.pbc import wrap_scaled


class CellList(NamedTuple):
    """Dense cell decomposition of an atom set (all arrays, jit-carryable)."""

    cell_ids: jax.Array  # (N,) int32 — cell id per atom
    sorted_atoms: jax.Array  # (N,) int32 — atom indices sorted by cell id
    cell_table: jax.Array  # (num_cells, capacity) int32 — atom ids, pad = N
    cell_counts: jax.Array  # (num_cells,) int32
    overflow: jax.Array  # () bool — some cell exceeded capacity

    @property
    def num_cells(self) -> int:
        return self.cell_table.shape[0]

    @property
    def capacity(self) -> int:
        return self.cell_table.shape[1]


def cells_per_dimension(box: float, cutoff: float, ndiv: int = 2) -> int:
    """M = ⌊ndiv·L/cutoff⌋ (cells.jl:36). Requires M ≥ 2·ndiv+1 for a valid
    PBC stencil; falls back to the largest valid M (or signals all-pairs)."""
    m = int(np.floor(ndiv * box / cutoff))
    return m


def suggest_capacity(num_atoms: int, num_cells: int, multiplier: float = 1.6, minimum: int = 4) -> int:
    """Static per-cell capacity.

    Occupancy of small cells is ~Poisson(mean): the max over many cells sits
    several √mean above the mean, so the margin includes a fluctuation term —
    capacity overflow is then a rare event handled by doubling, not the norm.
    """
    mean = num_atoms / max(num_cells, 1)
    return max(minimum, int(np.ceil(mean * multiplier + 3.0 * np.sqrt(mean) + 2.0)))


def stencil_offsets(cells_per_dim: int, ndiv: int = 2, half: bool = False) -> np.ndarray:
    """Integer cell-offset vectors whose cells can contain atoms within the
    cutoff (host-side, static).

    The cutoff expressed in cell units is exactly ndiv only when M·cutoff =
    ndiv·L; since M = ⌊ndiv·L/cutoff⌋, cutoff_cells = M·cutoff/L ≤ ndiv, so
    scanning |v| ≤ ndiv suffices.  A cell at offset v is included when the
    nearest-corner distance  Σ_d max(|v_d|−1, 0)²  is below cutoff_cells²
    (the corrected form of cells.jl:28-34).  With `half=True` only the
    lexicographic upper half is returned (Newton-3 "action" stencil,
    cells.jl:31,38-44); the full shell excludes (0,0,0).
    """
    n = ndiv
    rng = np.arange(-n, n + 1)
    vx, vy, vz = np.meshgrid(rng, rng, rng, indexing="ij")
    offsets = np.stack([vx.ravel(), vy.ravel(), vz.ravel()], axis=1)
    # Conservative inclusion at cutoff_cells = ndiv (its maximum value).
    corner = np.maximum(np.abs(offsets) - 1, 0)
    keep = (corner**2).sum(axis=1) < float(n) ** 2
    offsets = offsets[keep]
    # Drop the origin; optionally keep only the half shell.
    nonzero = ~np.all(offsets == 0, axis=1)
    offsets = offsets[nonzero]
    if half:
        # Lexicographic (z, y, x) positivity — one of each ±v pair.
        key = offsets[:, 2] * (2 * n + 1) ** 2 + offsets[:, 1] * (2 * n + 1) + offsets[:, 0]
        offsets = offsets[key > 0]
    return offsets.astype(np.int32)


def compute_cell_ids(positions: jax.Array, box, cells_per_dim: int) -> jax.Array:
    """Cell id per atom, x-fastest ordering: id = vx + M·(vy + M·vz)
    (the cells.jl:80-85 binning: v = ⌊M·wrap(s)⌋ on box-scaled coords)."""
    m = cells_per_dim
    s = wrap_scaled(positions / box)
    v = jnp.floor(m * s).astype(jnp.int32)
    v = jnp.clip(v, 0, m - 1)  # guard the s→1.0 float edge
    return v[:, 0] + m * (v[:, 1] + m * v[:, 2])


@partial(jax.jit, static_argnames=("cells_per_dim", "capacity"))
def build_cell_list(
    positions: jax.Array,
    box,
    *,
    cells_per_dim: int,
    capacity: int,
) -> CellList:
    """Bin-and-sort: one stable sort replaces distribute!/renew_cells!."""
    n = positions.shape[0]
    num_cells = cells_per_dim**3
    cell_ids = compute_cell_ids(positions, box, cells_per_dim)
    sorted_atoms = jnp.argsort(cell_ids, stable=True).astype(jnp.int32)
    sorted_ids = cell_ids[sorted_atoms]

    counts = jnp.zeros(num_cells, jnp.int32).at[cell_ids].add(1)
    # Rank of each sorted atom within its cell: position − cell-start offset.
    starts = jnp.cumsum(counts) - counts  # (num_cells,)
    ranks = jnp.arange(n, dtype=jnp.int32) - starts[sorted_ids].astype(jnp.int32)

    table = jnp.full((num_cells, capacity), n, jnp.int32)
    # 'drop' silently discards overflow writes; the flag reports them.
    table = table.at[sorted_ids, ranks].set(sorted_atoms, mode="drop")
    overflow = jnp.max(counts) > capacity
    return CellList(
        cell_ids=cell_ids,
        sorted_atoms=sorted_atoms,
        cell_table=table,
        cell_counts=counts,
        overflow=overflow,
    )


def stencil_cell_ids(cells_per_dim: int, offsets: np.ndarray) -> jnp.ndarray:
    """(num_cells, S) table of wrapped neighbor-cell ids for each cell —
    the dense analog of `surrounding_cells` (cells.jl:38-44)."""
    m = cells_per_dim
    ids = np.arange(m**3)
    vx = ids % m
    vy = (ids // m) % m
    vz = ids // (m * m)
    coords = np.stack([vx, vy, vz], axis=1)  # (num_cells, 3)
    nbr = (coords[:, None, :] + offsets[None, :, :]) % m  # (num_cells, S, 3)
    return jnp.asarray(
        nbr[..., 0] + m * (nbr[..., 1] + m * nbr[..., 2]), dtype=jnp.int32
    )
