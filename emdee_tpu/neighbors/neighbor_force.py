"""Nonbonded force/energy/virial evaluation over a padded neighbor list.

The production O(N) force pass: a per-atom gather of neighbor positions and
parameters followed by vectorized pair math and an ordinary (deterministic)
reduction over the neighbor axis.  This is the role `compute_tile!` plays in
the reference (nonbonded.jl:44-107); warp shuffles and atomicAdd become a
dense gather and a sum — no atomics are needed.

Exclusions (bonded 1-2/1-3 pairs, scaled 1-4 pairs from the molecular graph)
are handled by *correction*, not by masks in the hot loop: the main pass
computes all pairs within the cutoff, and `apply_exclusion_corrections`
subtracts (1−scale)·contribution for the small static exclusion pair list.
This keeps the hot kernel branch-free and makes exclusions O(#exclusions).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from emdee_tpu.core.pbc import minimum_image
from emdee_tpu.core.types import ALL_OUTPUTS, ENERGIES, FORCES, VIRIALS, LJParams, NonbondedOutput
from emdee_tpu.neighbors.neighbor_list import NeighborList
from emdee_tpu.potentials.lennard_jones import LennardJonesModel, pair_interaction


@partial(jax.jit, static_argnames=("outputs", "atom_chunk"))
def compute_nonbonded_neighborlist(
    positions: jax.Array,
    box,
    model: LennardJonesModel,
    params: LJParams,
    nbrs: NeighborList,
    charges=None,
    coulomb=None,
    *,
    outputs: int = ALL_OUTPUTS,
    atom_chunk: int = 8192,
) -> NonbondedOutput:
    """Forces/energies/virials from an (N, K) neighbor table.

    Per-atom conventions match the reference (nonbonded.jl:93-94): since the
    full-shell list contains each pair twice (once per owner), energy_i =
    ½ Σ_j E_ij and virial_i = ½ Σ_j (−r·E′)_ij give the same half-split.
    """
    n = positions.shape[0]
    k = nbrs.idx.shape[1]
    dtype = positions.dtype
    scaled = positions / box
    hs = params.half_sigma.astype(dtype)
    tse = params.twice_sqrt_eps.astype(dtype)
    # Sentinel row n: far-away inert neighbor.
    scaled_ext = jnp.concatenate([scaled, jnp.zeros((1, 3), dtype)], axis=0)
    hs_ext = jnp.concatenate([hs, jnp.zeros((1,), dtype)])
    tse_ext = jnp.concatenate([tse, jnp.zeros((1,), dtype)])
    q = charges.astype(dtype) if charges is not None else None
    q_ext = jnp.concatenate([q, jnp.zeros((1,), dtype)]) if q is not None else None

    n_pad = -(-n // atom_chunk) * atom_chunk
    scaled_pad = jnp.pad(scaled, ((0, n_pad - n), (0, 0)))
    hs_pad = jnp.pad(hs, (0, n_pad - n))
    tse_pad = jnp.pad(tse, (0, n_pad - n))
    q_pad = jnp.pad(q, (0, n_pad - n)) if q is not None else None
    idx_pad = jnp.pad(nbrs.idx, ((0, n_pad - n), (0, 0)), constant_values=n)

    def block(start):
        s_i = jax.lax.dynamic_slice_in_dim(scaled_pad, start, atom_chunk)
        hs_i = jax.lax.dynamic_slice_in_dim(hs_pad, start, atom_chunk)
        tse_i = jax.lax.dynamic_slice_in_dim(tse_pad, start, atom_chunk)
        jdx = jax.lax.dynamic_slice_in_dim(idx_pad, start, atom_chunk)  # (B, K)
        valid = jdx < n
        s_j = scaled_ext[jdx]  # (B, K, 3)
        dv = box * minimum_image(s_i[:, None, :] - s_j)
        r2 = jnp.sum(dv * dv, axis=-1)
        r2_safe = jnp.where(valid, r2, jnp.asarray(1.0, dtype))
        energy, minus_rE = pair_interaction(
            r2_safe, model, hs_i[:, None], tse_i[:, None], hs_ext[jdx], tse_ext[jdx]
        )
        if q is not None:
            from emdee_tpu.potentials.coulomb import coulomb_interaction

            q_i = jax.lax.dynamic_slice_in_dim(q_pad, start, atom_chunk)
            e_c, mre_c = coulomb_interaction(r2_safe, coulomb, q_i[:, None], q_ext[jdx])
            energy = energy + e_c
            minus_rE = minus_rE + mre_c
        energy = jnp.where(valid, energy, 0.0)
        minus_rE = jnp.where(valid, minus_rE, 0.0)
        out = []
        if outputs & FORCES:
            out.append(jnp.sum((minus_rE / r2_safe)[..., None] * dv, axis=1))
        if outputs & ENERGIES:
            out.append(0.5 * jnp.sum(energy, axis=1))
        if outputs & VIRIALS:
            out.append(0.5 * jnp.sum(minus_rE, axis=1))
        return tuple(out)

    starts = jnp.arange(0, n_pad, atom_chunk, dtype=jnp.int32)
    blocks = jax.lax.map(block, starts)

    i = 0
    forces = energies = virials = None
    if outputs & FORCES:
        forces = blocks[i].reshape(n_pad, 3)[:n]
        i += 1
    if outputs & ENERGIES:
        energies = blocks[i].reshape(n_pad)[:n]
        i += 1
    if outputs & VIRIALS:
        virials = blocks[i].reshape(n_pad)[:n]
    return NonbondedOutput(forces=forces, energies=energies, virials=virials)


@partial(jax.jit, static_argnames=("outputs",))
def apply_exclusion_corrections(
    out: NonbondedOutput,
    positions: jax.Array,
    box,
    model: LennardJonesModel,
    params: LJParams,
    exclusion_pairs: jax.Array,  # (P, 2) int32, i≠j; may contain (n, n) padding
    exclusion_scales: jax.Array,  # (P,) float32 — 0 for full exclusion, lj14scale for 1-4
    charges: jax.Array = None,
    coulomb=None,
    exclusion_scales_coulomb: jax.Array = None,  # (P,) — coulomb14scale for 1-4
    *,
    outputs: int = ALL_OUTPUTS,
) -> NonbondedOutput:
    """Subtract (1−scale) of each excluded pair's contribution from `out`.

    Pairs beyond the cutoff contribute zero in the main pass and correctly
    receive zero correction (the true-cutoff pair function vanishes there).
    LJ and Coulomb terms carry independent 1-4 scale factors (the
    lj14scale/coulomb14scale pair the reference parses, modelling.jl:198-200).
    """
    n = positions.shape[0]
    dtype = positions.dtype
    pi = jnp.minimum(exclusion_pairs[:, 0], n - 1)
    pj = jnp.minimum(exclusion_pairs[:, 1], n - 1)
    real = (exclusion_pairs[:, 0] < n) & (exclusion_pairs[:, 1] < n)
    weight = jnp.where(real, 1.0 - exclusion_scales.astype(dtype), 0.0)

    dv = box * minimum_image((positions[pi] - positions[pj]) / box)
    r2 = jnp.sum(dv * dv, axis=-1)
    r2_safe = jnp.where(real, r2, jnp.asarray(1.0, dtype))
    energy, minus_rE = pair_interaction(
        r2_safe, model,
        params.half_sigma[pi], params.twice_sqrt_eps[pi],
        params.half_sigma[pj], params.twice_sqrt_eps[pj],
    )
    energy = weight * energy
    minus_rE = weight * minus_rE
    if charges is not None:
        from emdee_tpu.potentials.coulomb import coulomb_interaction

        scales_c = (
            exclusion_scales_coulomb
            if exclusion_scales_coulomb is not None
            else exclusion_scales
        )
        weight_c = jnp.where(real, 1.0 - scales_c.astype(dtype), 0.0)
        e_c, mre_c = coulomb_interaction(r2_safe, coulomb, charges[pi], charges[pj])
        energy = energy + weight_c * e_c
        minus_rE = minus_rE + weight_c * mre_c

    forces, energies, virials = out.forces, out.energies, out.virials
    if outputs & FORCES and forces is not None:
        f_ij = (minus_rE / r2_safe)[:, None] * dv
        forces = forces.at[pi].add(-f_ij).at[pj].add(f_ij)
    if outputs & ENERGIES and energies is not None:
        energies = energies.at[pi].add(-0.5 * energy).at[pj].add(-0.5 * energy)
    if outputs & VIRIALS and virials is not None:
        virials = virials.at[pi].add(-0.5 * minus_rE).at[pj].add(-0.5 * minus_rE)
    return NonbondedOutput(forces=forces, energies=energies, virials=virials)
