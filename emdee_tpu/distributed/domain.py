"""Spatial domain decomposition over a 1D device mesh (slabs along z).

Atom-table formulation: each shard's force pass evaluates its owned rows
against ALL owned+ghost columns — O(N_shard²), fine for the small/medium
systems and correctness tests it serves.  The PRODUCTION multi-chip path is
`distributed.grid_sharded` (3D cell-grid decomposition, per-shard
half-shell pair pass, O(N)); this module remains as the simplest-possible
sharded reference implementation and the ghost/ownership semantics testbed.

The multi-chip scale-out the reference never had (SURVEY.md §2b): atoms are
sharded into z-slabs, one per device.  Each step, every device

1. selects the atoms within a halo width of its slab faces and sends them to
   its ±1 ring neighbors with `jax.lax.ppermute` (neighbour traffic only),
2. computes forces for its OWNED atoms against owned+ghost candidates — full
   accumulation (each pair evaluated by both owners), so no cross-device
   force reduction is ever needed: the per-owner sum plays the role the
   reference's atomicAdd reduction plays intra-GPU (nonbonded.jl:88-104),
3. integrates its owned atoms locally.

Atoms drift: slab ownership is refreshed by `redistribute` (a global
sort-to-slots, XLA inserting the collectives), run every `resort_every`
steps.  Between refreshes, a halo margin (`halo_skin`) keeps the ghost set a
superset of what the cutoff needs; the `overflow` flag reports any violated
capacity so the host can re-run with larger slots — never silently.

All shapes are static: per-shard slot capacity and halo capacity are fixed,
with validity masks (the fixed-shape answer to the reference's undef padding,
nonbonded.jl:28-38).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from emdee_tpu.core.pbc import minimum_image, wrap
from emdee_tpu.core.types import LJParams
from emdee_tpu.distributed.mesh import ATOM_AXIS
from emdee_tpu.potentials.lennard_jones import LennardJonesModel, pair_interaction


class ShardedState(NamedTuple):
    """Slab-sharded simulation state: leading axis = D·slot_cap, sharded."""

    positions: jax.Array  # (D*S, 3)
    velocities: jax.Array  # (D*S, 3)
    masses: jax.Array  # (D*S,)
    half_sigma: jax.Array  # (D*S,)
    twice_sqrt_eps: jax.Array  # (D*S,)
    atom_id: jax.Array  # (D*S,) int32 — original index, N for empty slots
    valid: jax.Array  # (D*S,) bool
    step: jax.Array  # () int32
    overflow: jax.Array  # () bool — slot/halo capacity violated


class DomainConfig(NamedTuple):
    """Static decomposition geometry."""

    num_devices: int
    slot_capacity: int  # owned-atom slots per shard
    halo_capacity: int  # ghost slots per face
    box: float
    cutoff: float
    halo_skin: float  # extra halo width covering drift between resorts
    resort_every: int

    @property
    def halo_width(self) -> float:
        return self.cutoff + self.halo_skin

    @property
    def slab_width(self) -> float:
        return self.box / self.num_devices


def suggest_domain_config(
    num_atoms: int,
    box: float,
    cutoff: float,
    num_devices: int,
    halo_skin: float = 0.5,
    resort_every: int = 20,
    slot_multiplier: float = 1.3,
    halo_multiplier: float = 1.6,
) -> DomainConfig:
    density = num_atoms / box**3
    slab = box / num_devices
    halo_w = cutoff + halo_skin
    if num_devices > 1 and slab < 2.0 * halo_w:
        raise ValueError(
            f"slab width {slab:.3f} < 2×halo width {2 * halo_w:.3f}: too many "
            f"devices for this box (atoms would ghost through multiple slabs)"
        )
    slot = int(np.ceil(num_atoms / num_devices * slot_multiplier)) + 8
    halo = int(np.ceil(density * box * box * halo_w * halo_multiplier)) + 8
    return DomainConfig(
        num_devices=num_devices,
        slot_capacity=_round_up8(slot),
        halo_capacity=_round_up8(halo),
        box=box,
        cutoff=cutoff,
        halo_skin=halo_skin,
        resort_every=resort_every,
    )


def _round_up8(x: int) -> int:
    return -(-x // 8) * 8


def _sharding(mesh: Mesh):
    return NamedSharding(mesh, P(ATOM_AXIS))


# ---------------------------------------------------------------------------
# Global redistribution: sort atoms into slab-major slot layout.
# ---------------------------------------------------------------------------


def redistribute(state: ShardedState, config: DomainConfig, mesh: Mesh) -> ShardedState:
    """Re-sort every atom into its owning slab's slot block.

    A global bin-and-scatter (same construction as the cell list's dense
    table): slab id from z, stable argsort, rank-in-slab, scatter to
    slot = slab·S + rank.  Runs as ordinary global jnp under jit — XLA
    inserts the all-to-all — and is amortized over `resort_every` steps.
    """
    d, s = config.num_devices, config.slot_capacity
    total = d * s
    z = state.positions[:, 2]
    # wrap to [0, box) to bin; invalid slots → virtual slab d (dropped).
    zw = z - jnp.floor(z / config.box) * config.box
    slab = jnp.clip((zw / config.slab_width).astype(jnp.int32), 0, d - 1)
    slab = jnp.where(state.valid, slab, d)

    order = jnp.argsort(slab, stable=True).astype(jnp.int32)
    slab_sorted = slab[order]
    counts = jnp.zeros(d + 1, jnp.int32).at[slab].add(1)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(total, dtype=jnp.int32) - starts[slab_sorted]
    dest = jnp.where(slab_sorted < d, slab_sorted * s + rank, total)

    def scatter(arr, fill):
        out = jnp.full((total,) + arr.shape[1:], fill, arr.dtype)
        return out.at[dest].set(arr[order], mode="drop")

    shd = _sharding(mesh)
    new = ShardedState(
        positions=jax.lax.with_sharding_constraint(scatter(state.positions, 0.0), shd),
        velocities=jax.lax.with_sharding_constraint(scatter(state.velocities, 0.0), shd),
        masses=jax.lax.with_sharding_constraint(scatter(state.masses, 1.0), shd),
        half_sigma=jax.lax.with_sharding_constraint(scatter(state.half_sigma, 0.0), shd),
        twice_sqrt_eps=jax.lax.with_sharding_constraint(
            scatter(state.twice_sqrt_eps, 0.0), shd
        ),
        atom_id=jax.lax.with_sharding_constraint(
            scatter(state.atom_id, np.iinfo(np.int32).max), shd
        ),
        valid=jax.lax.with_sharding_constraint(scatter(state.valid, False), shd),
        step=state.step,
        overflow=state.overflow | (jnp.max(counts[:d]) > s),
    )
    return new


def distribute(
    positions,
    velocities,
    masses,
    params: LJParams,
    config: DomainConfig,
    mesh: Mesh,
) -> ShardedState:
    """Host entry: pack dense (N, …) arrays into the sharded slot layout."""
    n = positions.shape[0]
    total = config.num_devices * config.slot_capacity
    if n > total:
        raise ValueError(f"{n} atoms exceed total slot capacity {total}")
    pad = total - n

    def pad0(x, fill=0.0):
        x = jnp.asarray(x, jnp.float32)
        width = ((0, pad),) + ((0, 0),) * (x.ndim - 1)
        return jnp.pad(x, width, constant_values=fill)

    state = ShardedState(
        positions=pad0(positions),
        velocities=pad0(velocities),
        masses=pad0(masses, 1.0),
        half_sigma=pad0(params.half_sigma),
        twice_sqrt_eps=pad0(params.twice_sqrt_eps),
        atom_id=jnp.pad(jnp.arange(n, dtype=jnp.int32), (0, pad), constant_values=n),
        valid=jnp.pad(jnp.ones(n, bool), (0, pad), constant_values=False),
        step=jnp.asarray(0, jnp.int32),
        overflow=jnp.asarray(False),
    )
    return jax.jit(
        partial(redistribute, config=config, mesh=mesh),
        out_shardings=None,
    )(state)


# ---------------------------------------------------------------------------
# Per-shard force pass with halo exchange (runs inside shard_map).
# ---------------------------------------------------------------------------


def _halo_pack(pos, hs, tse, sel, halo_cap):
    """Compact the selected atoms' (pos, params) into fixed halo buffers."""
    k = jnp.cumsum(sel) - 1
    dest = jnp.where(sel, k, halo_cap)
    buf_pos = jnp.zeros((halo_cap, 3), pos.dtype).at[dest].set(pos, mode="drop")
    buf_hs = jnp.zeros((halo_cap,), hs.dtype).at[dest].set(hs, mode="drop")
    buf_tse = jnp.zeros((halo_cap,), tse.dtype).at[dest].set(tse, mode="drop")
    buf_valid = jnp.zeros((halo_cap,), bool).at[dest].set(sel, mode="drop")
    over = jnp.sum(sel) > halo_cap
    return buf_pos, buf_hs, buf_tse, buf_valid, over


def _shard_forces(
    pos,
    hs,
    tse,
    valid,
    model: LennardJonesModel,
    config: DomainConfig,
    *,
    compute_energy: bool,
    row_chunk: int = 2048,
):
    """Force (and optional energy/virial) for owned atoms of one shard.

    Runs under shard_map: `pos` etc. are this shard's (S, …) blocks.
    Exchanges halos with ring neighbors, then evaluates masked pair math of
    owned rows against owned+ghost columns in row chunks.
    """
    d_idx = jax.lax.axis_index(ATOM_AXIS)
    ndev = config.num_devices
    box = jnp.asarray(config.box, pos.dtype)
    w = config.slab_width
    halo_w = config.halo_width

    if ndev > 1:
        z = pos[:, 2]
        # Distances measured periodically to this slab's faces.
        low_face = d_idx.astype(pos.dtype) * w
        high_face = low_face + w
        dist_low = (z - low_face) - jnp.round((z - low_face) / box) * box
        dist_high = (z - high_face) - jnp.round((z - high_face) / box) * box
        send_left = valid & (dist_low < halo_w)
        send_right = valid & (dist_high > -halo_w)

        pk_l = _halo_pack(pos, hs, tse, send_left, config.halo_capacity)
        pk_r = _halo_pack(pos, hs, tse, send_right, config.halo_capacity)

        right_perm = [(i, (i + 1) % ndev) for i in range(ndev)]
        left_perm = [(i, (i - 1) % ndev) for i in range(ndev)]
        # Our low-edge atoms go to the left neighbor; we receive the right
        # neighbor's low-edge atoms as our right ghosts, and vice versa.
        ghost_r = [jax.lax.ppermute(x, ATOM_AXIS, left_perm) for x in pk_l[:4]]
        ghost_l = [jax.lax.ppermute(x, ATOM_AXIS, right_perm) for x in pk_r[:4]]
        halo_over = pk_l[4] | pk_r[4]

        col_pos = jnp.concatenate([pos, ghost_l[0], ghost_r[0]], axis=0)
        col_hs = jnp.concatenate([hs, ghost_l[1], ghost_r[1]])
        col_tse = jnp.concatenate([tse, ghost_l[2], ghost_r[2]])
        col_valid = jnp.concatenate([valid, ghost_l[3], ghost_r[3]])
    else:
        col_pos, col_hs, col_tse, col_valid = pos, hs, tse, valid
        halo_over = jnp.asarray(False)

    s_cap = pos.shape[0]
    n_cols = col_pos.shape[0]
    col_scaled = col_pos / box
    scaled = pos / box

    n_chunks = -(-s_cap // row_chunk)
    pad_rows = n_chunks * row_chunk - s_cap
    scaled_p = jnp.pad(scaled, ((0, pad_rows), (0, 0)))
    hs_p = jnp.pad(hs, (0, pad_rows))
    tse_p = jnp.pad(tse, (0, pad_rows))
    valid_p = jnp.pad(valid, (0, pad_rows))
    row_pos_id = jnp.arange(n_chunks * row_chunk, dtype=jnp.int32)
    col_pos_id = jnp.arange(n_cols, dtype=jnp.int32)

    def chunk(start):
        s_i = jax.lax.dynamic_slice_in_dim(scaled_p, start, row_chunk)
        h_i = jax.lax.dynamic_slice_in_dim(hs_p, start, row_chunk)
        t_i = jax.lax.dynamic_slice_in_dim(tse_p, start, row_chunk)
        v_i = jax.lax.dynamic_slice_in_dim(valid_p, start, row_chunk)
        ids_i = start + row_pos_id[:row_chunk]
        dv = box * minimum_image(s_i[:, None, :] - col_scaled[None, :, :])
        r2 = jnp.sum(dv * dv, axis=-1)
        # A row atom equals column j only in the owned block (j < s_cap):
        # ghosts are never copies of our own atoms (slab ≥ 2×halo rule).
        same = ids_i[:, None] == col_pos_id[None, :]
        ok = v_i[:, None] & col_valid[None, :] & ~same
        r2s = jnp.where(ok, r2, jnp.asarray(1.0, pos.dtype))
        energy, minus_rE = pair_interaction(
            r2s, model, h_i[:, None], t_i[:, None], col_hs[None, :], col_tse[None, :]
        )
        energy = jnp.where(ok, energy, 0.0)
        minus_rE = jnp.where(ok, minus_rE, 0.0)
        f = jnp.sum((minus_rE / r2s)[..., None] * dv, axis=1)
        if compute_energy:
            return f, 0.5 * jnp.sum(energy, axis=1), 0.5 * jnp.sum(minus_rE, axis=1)
        return (f,)

    outs = jax.lax.map(chunk, jnp.arange(0, n_chunks * row_chunk, row_chunk, jnp.int32))
    forces = outs[0].reshape(-1, 3)[:s_cap]
    if compute_energy:
        e = outs[1].reshape(-1)[:s_cap]
        v = outs[2].reshape(-1)[:s_cap]
        return forces, e, v, halo_over
    return forces, None, None, halo_over


# ---------------------------------------------------------------------------
# Sharded step + rollout.
# ---------------------------------------------------------------------------


def make_sharded_step(
    config: DomainConfig,
    mesh: Mesh,
    model: LennardJonesModel,
    dt: float,
):
    """Build (rollout_fn, energy_fn) for the sharded system.

    rollout_fn(state, num_blocks) advances resort_every·num_blocks steps:
    each block redistributes ownership once, then scans `resort_every`
    velocity-Verlet steps under shard_map with per-step halo exchange.
    """
    shard_map = jax.shard_map

    spec = P(ATOM_AXIS)
    dt_f = jnp.float32(dt)

    def _forces_only(pos, hs, tse, valid):
        f, _, _, over = _shard_forces(pos, hs, tse, valid, model, config, compute_energy=False)
        # Reduce the per-shard flag so the P() (replicated) out_spec is honest.
        over = jax.lax.psum(over.astype(jnp.int32), ATOM_AXIS) > 0
        return f, over

    forces_sharded = shard_map(
        _forces_only,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=(spec, P()),
        check_vma=False,
    )

    def _energies(pos, hs, tse, valid):
        _, e, v, _ = _shard_forces(pos, hs, tse, valid, model, config, compute_energy=True)
        return jnp.sum(e)[None], jnp.sum(v)[None]

    energies_sharded = shard_map(
        _energies,
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=(P(ATOM_AXIS), P(ATOM_AXIS)),
        check_vma=False,
    )

    def energy_fn(state: ShardedState):
        e, v = energies_sharded(
            state.positions, state.half_sigma, state.twice_sqrt_eps, state.valid
        )
        return jnp.sum(e), jnp.sum(v)

    def one_step(carry, _):
        state, forces = carry
        inv_m = jnp.where(state.valid, 1.0 / state.masses, 0.0)[:, None]
        v_half = state.velocities + (0.5 * dt_f) * forces * inv_m
        new_pos = wrap(state.positions + dt_f * v_half, jnp.float32(config.box))
        new_forces, over = forces_sharded(
            new_pos, state.half_sigma, state.twice_sqrt_eps, state.valid
        )
        new_vel = v_half + (0.5 * dt_f) * new_forces * inv_m
        state = state._replace(
            positions=new_pos,
            velocities=new_vel,
            step=state.step + 1,
            overflow=state.overflow | over,
        )
        return (state, new_forces), None

    @partial(jax.jit, static_argnames=("num_blocks",))
    def rollout(state: ShardedState, num_blocks: int) -> ShardedState:
        def block(st, _):
            st = redistribute(st, config, mesh)
            ref_z = st.positions[:, 2]
            f, over = forces_sharded(st.positions, st.half_sigma, st.twice_sqrt_eps, st.valid)
            st = st._replace(overflow=st.overflow | over)
            (st, _), _ = jax.lax.scan(one_step, (st, f), None, length=config.resort_every)
            # Staleness guard (mirrors cell_dense._needs_rebin): ownership is
            # only refreshed at block starts, and the halo width covers an
            # atom at most `halo_skin` past its slab face.  An atom that
            # drifted further within the block may have silently lost pairs
            # (asymmetrically — breaking Newton's 3rd law): trip the sticky
            # flag so the caller re-runs with a larger halo_skin or a smaller
            # resort_every.
            dz = st.positions[:, 2] - ref_z
            dz = dz - jnp.round(dz / config.box) * config.box
            stale = jnp.max(jnp.where(st.valid, jnp.abs(dz), 0.0)) > config.halo_skin
            st = st._replace(overflow=st.overflow | stale)
            return st, None

        state, _ = jax.lax.scan(block, state, None, length=num_blocks)
        return state

    return rollout, energy_fn


def gather_dense(state: ShardedState, num_atoms: int):
    """Undo the slot layout: dense (N, …) arrays ordered by original atom id."""
    ids = np.asarray(state.atom_id)
    keep = np.asarray(state.valid)
    order = ids[keep]
    pos = np.zeros((num_atoms, 3), np.float32)
    vel = np.zeros((num_atoms, 3), np.float32)
    pos[order] = np.asarray(state.positions)[keep]
    vel[order] = np.asarray(state.velocities)[keep]
    return pos, vel
