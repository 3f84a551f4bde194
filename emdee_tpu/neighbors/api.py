"""User-facing nonbonded force-function factory.

`make_force_fn` picks and wires a nonbonded backend:

- ``allpairs``      — masked O(N²); exact, best for small N; also the
                      reference-parity path (supports parity_mode).
- ``neighbor_list`` — cell-list-built padded Verlet list with a skin,
                      displacement-triggered in-graph rebuild; O(N).
- ``auto``          — neighbor list when the geometry supports it (box holds
                      ≥ 5³ half-cutoff cells), else all-pairs.

The production path is the dense-cell engine
(`emdee_tpu.neighbors.cell_dense.make_cell_dense_sim`), which owns its own
state layout; `emdee_tpu.utils.runner` drives it.

The returned `Nonbonded` bundle exposes:
  init(positions)                  → aux   (neighbor state; host-side retry on
                                            capacity overflow)
  compute(positions, aux, outputs) → NonbondedOutput
  update(positions, aux)           → aux   (conditional rebuild, jit-safe)
  force_fn(positions, box, aux)    → (forces, aux)  — the integrator hook
All device code is shape-static; capacities are chosen at init and doubled on
overflow (the overflow-handling the reference stubbed, cells.jl:251,265).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from emdee_tpu.core.types import ALL_OUTPUTS, FORCES, LJParams, NonbondedOutput
from emdee_tpu.neighbors.allpairs import compute_nonbonded_allpairs
from emdee_tpu.neighbors.cell_list import cells_per_dimension, suggest_capacity
from emdee_tpu.neighbors.neighbor_force import (
    apply_exclusion_corrections,
    compute_nonbonded_neighborlist,
)
from emdee_tpu.neighbors.neighbor_list import (
    NeighborList,
    build_neighbor_list,
    estimate_max_neighbors,
    needs_rebuild,
)
from emdee_tpu.potentials.lennard_jones import LennardJonesModel


@dataclasses.dataclass(frozen=True)
class NonbondedConfig:
    """Static nonbonded configuration (hashable → usable as a jit static)."""

    cutoff: float
    switch: float  # switching-function onset radius (rs < rc)
    method: str = "auto"  # allpairs | neighbor_list | auto
    skin: float = 0.0  # Verlet buffer; 0 → auto (0.1·cutoff) for list methods
    ndiv: int = 2  # cells per cutoff (cells.jl:36 geometry)
    cell_capacity_multiplier: float = 1.6
    neighbor_multiplier: float = 1.4
    max_neighbors: Optional[int] = None  # None → density estimate
    parity_mode: bool = False  # reproduce the reference's beyond-rc quirk
    coulomb_alpha: float = 0.2  # DSF damping (used when charges are given)
    coulomb_constant: float = 1.0  # e²/4πε0 in simulation units

    def __post_init__(self):
        if self.switch >= self.cutoff:
            raise ValueError("switch must be < cutoff")
        if self.method not in ("auto", "allpairs", "neighbor_list"):
            raise ValueError(f"unknown nonbonded method {self.method!r}")
        if self.parity_mode and self.method not in ("allpairs", "auto"):
            raise ValueError("parity_mode requires the all-pairs method")

    @property
    def effective_skin(self) -> float:
        return self.skin if self.skin > 0 else 0.1 * self.cutoff

    def list_geometry(self, box: float) -> tuple:
        """(list_cutoff, cells_per_dim) of the cell grid backing the Verlet
        list — the single home of the skin/M arithmetic."""
        list_cutoff = self.cutoff + self.effective_skin
        return list_cutoff, cells_per_dimension(box, list_cutoff, self.ndiv)


class Nonbonded(NamedTuple):
    config: NonbondedConfig
    model: LennardJonesModel
    init: Callable  # positions → aux
    compute: Callable  # (positions, aux, outputs=) → NonbondedOutput
    update: Callable  # (positions, aux) → aux
    force_fn: Callable  # (positions, box, aux) → (forces, aux)


def resolve_method(config: NonbondedConfig, box: float, num_atoms: int) -> str:
    method = config.method
    if method == "auto":
        _, m = config.list_geometry(box)
        method = "neighbor_list" if (m >= 2 * config.ndiv + 1 and num_atoms >= 256) else "allpairs"
    return method


def make_force_fn(
    config: NonbondedConfig,
    params: LJParams,
    box: float,
    num_atoms: int,
    exclusion_pairs: Optional[jax.Array] = None,
    exclusion_scales: Optional[jax.Array] = None,
    charges: Optional[jax.Array] = None,
    exclusion_scales_coulomb: Optional[jax.Array] = None,
) -> Nonbonded:
    """Build the nonbonded bundle for a fixed (box, N) problem shape.

    With `charges`, DSF Coulomb electrostatics (potentials/coulomb.py) are
    added to every pair evaluation, with independent 1-4 scaling via
    `exclusion_scales_coulomb`."""
    model = LennardJonesModel.create(config.cutoff, config.switch)
    method = resolve_method(config, box, num_atoms)
    has_exclusions = exclusion_pairs is not None and exclusion_pairs.shape[0] > 0
    if has_exclusions and exclusion_scales is None:
        exclusion_scales = jnp.zeros(exclusion_pairs.shape[0], jnp.float32)
    coulomb = None
    if charges is not None:
        from emdee_tpu.potentials.coulomb import DSFCoulomb

        charges = jnp.asarray(charges, jnp.float32)
        coulomb = DSFCoulomb.create(
            config.cutoff, config.coulomb_alpha, config.coulomb_constant
        )
        if config.parity_mode:
            raise ValueError("parity_mode is LJ-only (the reference has no electrostatics)")

    def _correct(out, positions, outputs):
        if not has_exclusions:
            return out
        return apply_exclusion_corrections(
            out, positions, jnp.asarray(box, positions.dtype), model, params,
            exclusion_pairs, exclusion_scales,
            charges, coulomb, exclusion_scales_coulomb,
            outputs=outputs,
        )

    if method == "allpairs":

        def init(positions):
            return ()

        def compute(positions, aux=(), *, outputs=ALL_OUTPUTS):
            out = compute_nonbonded_allpairs(
                positions, jnp.asarray(box, positions.dtype), model, params,
                None, charges, coulomb,
                outputs=outputs, parity_mode=config.parity_mode,
            )
            return _correct(out, positions, outputs)

        def update(positions, aux=()):
            return aux

        def force_fn(positions, box_, aux=()):
            out = compute_nonbonded_allpairs(
                positions, box_, model, params, None, charges, coulomb,
                outputs=FORCES, parity_mode=config.parity_mode,
            )
            return _correct(out, positions, FORCES).forces, aux

        return Nonbonded(config, model, init, compute, update, force_fn)

    # ---- neighbor-list-backed methods ----
    skin = config.effective_skin
    list_cutoff, m = config.list_geometry(box)
    if m < 2 * config.ndiv + 1:
        raise ValueError(
            f"box {box} too small for cell lists at cutoff {list_cutoff} "
            f"(M={m}); use method='allpairs'"
        )
    cell_cap = suggest_capacity(num_atoms, m**3, config.cell_capacity_multiplier)
    max_nbrs = config.max_neighbors or estimate_max_neighbors(
        num_atoms, box, list_cutoff, config.neighbor_multiplier
    )
    _pair_pass = compute_nonbonded_neighborlist

    def _build(positions, cap_cell, cap_nbrs):
        return build_neighbor_list(
            positions, jnp.asarray(box, positions.dtype), list_cutoff,
            cells_per_dim=m, cell_capacity=cap_cell, max_neighbors=cap_nbrs,
            ndiv=config.ndiv,
        )

    def init(positions) -> NeighborList:
        cap_cell, cap_nbrs = cell_cap, max_nbrs
        for _ in range(8):  # host-side capacity doubling on overflow
            nbrs = _build(positions, cap_cell, cap_nbrs)
            if not bool(nbrs.overflow):
                return nbrs
            cap_cell *= 2
            cap_nbrs *= 2
        raise RuntimeError("neighbor-list capacity overflow persisted after doubling")

    def update(positions, nbrs: NeighborList) -> NeighborList:
        """Rebuild when displacement exceeds skin/2; jit/scan-safe."""
        box_ = jnp.asarray(box, positions.dtype)
        new = jax.lax.cond(
            needs_rebuild(nbrs, positions, box_, skin),
            lambda p: _build(p, nbrs.cell_capacity, nbrs.idx.shape[1]),
            lambda p: nbrs,
            positions,
        )
        # Sticky overflow: a single overflowed rebuild anywhere in a rollout
        # must survive to the host-side check after the scan.
        return new._replace(overflow=new.overflow | nbrs.overflow)

    def compute(positions, nbrs: NeighborList, *, outputs=ALL_OUTPUTS):
        out = _pair_pass(
            positions, jnp.asarray(box, positions.dtype), model, params, nbrs,
            charges, coulomb, outputs=outputs,
        )
        return _correct(out, positions, outputs)

    def force_fn(positions, box_, nbrs: NeighborList):
        nbrs = update(positions, nbrs)
        out = _pair_pass(
            positions, box_, model, params, nbrs, charges, coulomb, outputs=FORCES
        )
        return _correct(out, positions, FORCES).forces, nbrs

    return Nonbonded(config, model, init, compute, update, force_fn)
