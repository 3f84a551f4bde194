"""Core pytree types for the MD engine.

The reference keeps state in ad-hoc CuArrays (positions `3×N`, per-atom LJ
params as an array of structs, nonbonded.jl:109-120).  Here state is a single
JAX pytree so that the whole integrator step can be jitted, scanned, sharded
and checkpointed as a unit.

Output selection: the reference specializes its kernel at compile time on a
bitmask ``Val(FORCES|ENERGIES|VIRIALS)`` (nonbonded.jl:12-14,111).  The same
idea maps to static (hashable) jit arguments here; `FORCES`/`ENERGIES`/
`VIRIALS` keep the reference's bit values.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

# Output-selection bitmask (reference: nonbonded.jl:12-14).
FORCES = 1 << 0
ENERGIES = 1 << 1
VIRIALS = 1 << 2
ALL_OUTPUTS = FORCES | ENERGIES | VIRIALS


class LJParams(NamedTuple):
    """Per-atom Lennard-Jones parameters, pre-transformed for mixing.

    The reference stores ``(σ/2, 2√ε)`` per atom (lennard_jones.jl:13-18) so
    Lorentz-Berthelot mixing becomes one add and one multiply in the kernel:
    ``σᵢⱼ = half_sigma_i + half_sigma_j`` and
    ``4εᵢⱼ = twice_sqrt_eps_i * twice_sqrt_eps_j``.
    """

    half_sigma: jax.Array  # (N,) float32
    twice_sqrt_eps: jax.Array  # (N,) float32

    @property
    def num_atoms(self) -> int:
        return self.half_sigma.shape[0]


class NonbondedOutput(NamedTuple):
    """Per-atom nonbonded results.

    Conventions match the reference (nonbonded.jl:93-94,102-103,142-145):
    each atom of a pair receives half of the pair energy E and half of the
    pair virial ``−r·dE/dr``; total potential energy = sum(energies), total
    scalar virial W = sum(virials).
    """

    forces: Optional[jax.Array] = None  # (N, 3) float32
    energies: Optional[jax.Array] = None  # (N,) float32
    virials: Optional[jax.Array] = None  # (N,) float32


class State(NamedTuple):
    """Full dynamical state of a simulation — a single jit/scan-able pytree."""

    positions: jax.Array  # (N, 3) float32
    velocities: jax.Array  # (N, 3) float32
    box: jax.Array  # scalar float32 — cubic box edge L (reference: scalar L)
    masses: jax.Array  # (N,) float32
    step: jax.Array  # scalar int32
    rng: Optional[jax.Array] = None  # PRNG key for stochastic extensions

    @property
    def num_atoms(self) -> int:
        return self.positions.shape[0]


def make_state(
    positions,
    velocities=None,
    box=1.0,
    masses=None,
    step=0,
    rng=None,
    dtype=jnp.float32,
) -> State:
    """Build a `State`, filling velocity/mass defaults (zeros / ones)."""
    positions = jnp.asarray(positions, dtype)
    if positions.ndim != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions must be (N, 3), got {positions.shape}")
    n = positions.shape[0]
    if velocities is None:
        velocities = jnp.zeros_like(positions)
    else:
        velocities = jnp.asarray(velocities, dtype)
    if masses is None:
        masses = jnp.ones((n,), dtype)
    else:
        masses = jnp.asarray(masses, dtype)
    return State(
        positions=positions,
        velocities=velocities,
        box=jnp.asarray(box, dtype),
        masses=masses,
        step=jnp.asarray(step, jnp.int32),
        rng=rng,
    )
