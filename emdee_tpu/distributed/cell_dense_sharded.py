"""Multi-chip dense-cell engine: z-slabs of cells per device.

A 1D slab decomposition of the ~1M-atom LJ fluid.  Combines the single-chip dense-cell engine (neighbors by static
shifts, no gathers in the hot loop) with spatial decomposition:

- The slot grid (cell-major, z slowest) is sharded over a 1D mesh along z:
  device d owns cell layers [d·Mloc, (d+1)·Mloc).  All state arrays keep
  their (M³, C, …) shapes with a `P(ATOM_AXIS)` sharding — elementwise
  integrator math partitions trivially.
- The force pass runs under `shard_map`: each device `ppermute`s its top and
  bottom cell layers to its ring neighbors (one (M², C) layer per direction
  per field — a few hundred KB), builds a z-extended local grid, and
  evaluates the full 27-stencil with center-only accumulation.  Full-shell
  (each pair computed by both owners) means NO reverse force traffic — the
  one-way halo is the entire communication, the multi-chip analog of the
  choice that keeps the single-chip hot loop scatter-free.
- Rebinning (and its cross-slab atom migration) is the global gather-based
  `_rebin`, jitted over the sharded arrays — XLA inserts the collectives;
  amortized over `rebin_every` steps like on one chip.

Requires cells_per_dim % num_devices == 0 and ≥ 2 layers per device.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from emdee_tpu.core.pbc import minimum_image, wrap
from emdee_tpu.distributed.mesh import ATOM_AXIS
from emdee_tpu.neighbors.cell_dense import (
    CellDenseConfig,
    CellDenseState,
    _needs_rebin,
    _rebin,
)
from emdee_tpu.potentials.lennard_jones import LennardJonesModel, pair_interaction

_FULL_SHELL = [
    (dz, dy, dx)
    for dz in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
]


def validate_sharded_config(config: CellDenseConfig, num_devices: int) -> int:
    m = config.cells_per_dim
    if m % num_devices != 0:
        raise ValueError(
            f"cells_per_dim {m} must divide evenly over {num_devices} devices"
        )
    m_loc = m // num_devices
    if num_devices > 1 and m_loc < 2:
        raise ValueError(
            f"{m_loc} cell layer(s) per device — need ≥ 2 so halos don't alias"
        )
    return m_loc


def _halo_exchange(layers_lo, layers_hi, ndev):
    """(my bottom layer, my top layer) → (lower halo, upper halo): each
    device sends its top right and its bottom left around the ring."""
    if ndev == 1:
        # Single device: the halos are the periodic wrap of my own grid.
        return layers_hi, layers_lo
    right = [(i, (i + 1) % ndev) for i in range(ndev)]
    left = [(i, (i - 1) % ndev) for i in range(ndev)]
    # My lower halo = left neighbor's top layer (they send right).
    halo_lo = jax.lax.ppermute(layers_hi, ATOM_AXIS, right)
    halo_hi = jax.lax.ppermute(layers_lo, ATOM_AXIS, left)
    return halo_lo, halo_hi


def _local_forces(
    pos,
    hs,
    tse,
    valid,
    model: LennardJonesModel,
    config: CellDenseConfig,
    m_loc: int,
    ndev: int,
    compute_energy: bool,
):
    """Per-shard force pass over a z-extended cell grid (runs in shard_map).

    pos: (Mloc·M², C, 3) local block; returns per-slot forces (+e, w).
    """
    m, c = config.cells_per_dim, config.capacity
    box = jnp.float32(config.box)
    grid = lambda a: a.reshape((m_loc, m * m) + a.shape[1:])

    def extend(a):
        g = grid(a)
        halo_lo, halo_hi = _halo_exchange(g[:1], g[-1:], ndev)
        return jnp.concatenate([halo_lo, g, halo_hi], axis=0)  # (Mloc+2, M², …)

    scaled = pos / box
    ext_scaled = extend(scaled)
    ext_hs = extend(hs)
    ext_tse = extend(tse)
    ext_valid = extend(valid)

    def nbr_block(ext, dz, dy, dx):
        # z via the extended axis (explicit halos), y/x via periodic rolls.
        blk = jax.lax.slice_in_dim(ext, 1 + dz, 1 + dz + m_loc, axis=0)
        shaped = blk.reshape((m_loc, m, m) + blk.shape[2:])
        rolled = jnp.roll(shaped, shift=(-dy, -dx), axis=(1, 2))
        return rolled.reshape((m_loc * m * m,) + blk.shape[2:])

    cen_scaled = scaled
    cen_hs = hs
    cen_tse = tse
    cen_valid = valid
    eye = jnp.eye(c, dtype=bool)

    forces = jnp.zeros_like(pos)
    energies = jnp.zeros_like(hs) if compute_energy else None
    virials = jnp.zeros_like(hs) if compute_energy else None

    for dz, dy, dx in _FULL_SHELL:
        n_scaled = nbr_block(ext_scaled, dz, dy, dx)
        n_hs = nbr_block(ext_hs, dz, dy, dx)
        n_tse = nbr_block(ext_tse, dz, dy, dx)
        n_valid = nbr_block(ext_valid, dz, dy, dx)

        dv = box * minimum_image(cen_scaled[:, :, None, :] - n_scaled[:, None, :, :])
        r2 = jnp.sum(dv * dv, axis=-1)  # (cells_loc, C, C)
        ok = cen_valid[:, :, None] & n_valid[:, None, :]
        if (dz, dy, dx) == (0, 0, 0):
            ok = ok & ~eye[None]
        r2s = jnp.where(ok, r2, 1.0)
        e, mrE = pair_interaction(
            r2s, model,
            cen_hs[:, :, None], cen_tse[:, :, None],
            n_hs[:, None, :], n_tse[:, None, :],
        )
        g = jnp.where(ok, mrE / r2s, 0.0)
        forces = forces + jnp.sum(g[..., None] * dv, axis=2)
        if compute_energy:
            energies = energies + 0.5 * jnp.sum(jnp.where(ok, e, 0.0), axis=2)
            virials = virials + 0.5 * jnp.sum(jnp.where(ok, mrE, 0.0), axis=2)

    if compute_energy:
        return forces, energies, virials
    return (forces,)


def make_sharded_cell_dense_sim(
    config: CellDenseConfig,
    model: LennardJonesModel,
    dt: float,
    mesh: Mesh,
):
    """(rollout, energy) for the slab-sharded dense-cell engine.

    rollout(state, num_steps, rebin_every) — same contract as the
    single-chip `make_cell_dense_sim`; state arrays are (M³, C, …) with the
    leading axis sharded over the mesh.
    """
    ndev = mesh.devices.size
    m_loc = validate_sharded_config(config, ndev)
    dt_f = jnp.float32(dt)
    box = jnp.float32(config.box)
    spec = P(ATOM_AXIS)
    shard = NamedSharding(mesh, spec)

    forces_sharded = jax.shard_map(
        partial(
            _local_forces,
            model=model, config=config, m_loc=m_loc, ndev=ndev, compute_energy=False,
        ),
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=(spec,),
        check_vma=False,
    )
    energies_sharded = jax.shard_map(
        partial(
            _local_forces,
            model=model, config=config, m_loc=m_loc, ndev=ndev, compute_energy=True,
        ),
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=(spec, spec, spec),
        check_vma=False,
    )

    def forces_of(state: CellDenseState):
        (f,) = forces_sharded(
            state.positions, state.half_sigma, state.twice_sqrt_eps, state.valid
        )
        return f

    def constrain(state: CellDenseState) -> CellDenseState:
        return jax.tree_util.tree_map(
            lambda a: jax.lax.with_sharding_constraint(a, shard)
            if getattr(a, "ndim", 0) >= 1 and a.shape[0] == config.num_cells
            else a,
            state,
        )

    def one_step(carry, _):
        # No mid-block wrap (mirrors the single-chip engine: positions are
        # wrapped at rebin time; the min-image pair math here tolerates the
        # ≤ skin/2 overhang either way).
        state, forces = carry
        inv_m = state.inv_masses[..., None]
        v_half = state.velocities + (0.5 * dt_f) * forces * inv_m
        new_pos = state.positions + dt_f * v_half
        new_pos = jnp.where(state.valid[..., None], new_pos, state.positions)
        state = state._replace(positions=new_pos, velocities=v_half)
        new_forces = forces_of(state)
        new_vel = state.velocities + (0.5 * dt_f) * new_forces * state.inv_masses[..., None]
        state = state._replace(velocities=new_vel, step=state.step + 1)
        return (state, new_forces), None

    @partial(jax.jit, static_argnames=("num_steps", "rebin_every"))
    def rollout(state: CellDenseState, num_steps: int, rebin_every: int = 10):
        def block(carry, _):
            st, f = carry
            st, f = _rebin(st, config, forces=f)
            st = constrain(st)
            (st, f), _ = jax.lax.scan(one_step, (st, f), None, length=rebin_every)
            st = st._replace(overflow=st.overflow | _needs_rebin(st, config))
            return (st, f), None

        blocks, rem = divmod(num_steps, rebin_every)
        carry = (constrain(state), forces_of(state))
        if blocks:
            carry, _ = jax.lax.scan(block, carry, None, length=blocks)
        if rem:
            st, f = _rebin(carry[0], config, forces=carry[1])
            st = constrain(st)
            (st, f), _ = jax.lax.scan(one_step, (st, f), None, length=rem)
            st = st._replace(overflow=st.overflow | _needs_rebin(st, config))
            carry = (st, f)
        return carry[0]

    @jax.jit
    def energy(state: CellDenseState):
        _, e, w = energies_sharded(
            state.positions, state.half_sigma, state.twice_sqrt_eps, state.valid
        )
        pe = jnp.sum(jnp.where(state.valid, e, 0.0))
        vir = jnp.sum(jnp.where(state.valid, w, 0.0))
        ke = 0.5 * jnp.sum(
            jnp.where(
                state.valid[..., None],
                state.velocities**2 / jnp.maximum(state.inv_masses[..., None], 1e-30),
                0.0,
            )
        )
        return pe, vir, ke

    return rollout, energy


def distribute_cell_dense(state: CellDenseState, mesh: Mesh) -> CellDenseState:
    """Place an initialized CellDenseState onto the mesh (slab-sharded)."""
    shard = NamedSharding(mesh, P(ATOM_AXIS))
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, shard)
        if getattr(a, "ndim", 0) >= 1
        else jax.device_put(a, NamedSharding(mesh, P())),
        state,
    )
