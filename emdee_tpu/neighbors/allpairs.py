"""All-pairs (O(N²)) nonbonded evaluation.

The array re-design of the reference's warp-tiled all-pairs CUDA kernel
(nonbonded.jl:44-120).  Where the reference enumerates n(n+1)/2 32×32 atom
tiles, rotates atom-j data through warp lanes with `shfl_sync`, and reduces
with global `atomic_add!`, here the pair interactions are expressed as one
dense broadcasted computation that XLA tiles and fuses, evaluated in
row-blocks under `lax.map` to bound the working set.  Newton's-3rd-law lane
shuffles and atomics are unnecessary: each atom row
computes its full interaction sum directly (every pair is evaluated twice,
which is a bandwidth/FLOP trade XLA handles easily at the N where all-pairs
is the right algorithm at all), and the per-atom reduction is an ordinary
deterministic `sum` — no atomics, bitwise-reproducible.

Per-atom conventions match the reference exactly (nonbonded.jl:93-94,102-103):
energy_i = ½ Σ_j E_ij, virial_i = ½ Σ_j (−r·E′)_ij, force_i = Σ_j f_ij.

This path doubles as the fast oracle for the cell-list / kernel paths and as
the production path for small N.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from emdee_tpu.core.pbc import minimum_image
from emdee_tpu.core.types import ALL_OUTPUTS, ENERGIES, FORCES, VIRIALS, LJParams, NonbondedOutput
from emdee_tpu.potentials.lennard_jones import LennardJonesModel, pair_interaction


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


@partial(jax.jit, static_argnames=("outputs", "parity_mode", "row_chunk"))
def compute_nonbonded_allpairs(
    positions: jax.Array,
    box: jax.Array,
    model: LennardJonesModel,
    params: LJParams,
    mask: Optional[jax.Array] = None,
    charges: Optional[jax.Array] = None,
    coulomb=None,
    *,
    outputs: int = ALL_OUTPUTS,
    parity_mode: bool = False,
    row_chunk: int = 512,
) -> NonbondedOutput:
    """All-pairs forces/energies/virials.

    Args:
      positions: (N, 3) float32.
      box: scalar cubic box edge L.
      model: LJ model constants.
      params: per-atom (σ/2, 2√ε).
      mask: optional (N,) bool; False rows are inert padding.
      charges: optional (N,) per-atom charges — adds DSF Coulomb terms.
      coulomb: DSFCoulomb model constants (required with charges).
      outputs: static bitmask FORCES|ENERGIES|VIRIALS (nonbonded.jl:12-14).
      parity_mode: reproduce the reference's beyond-cutoff quirk (see
        potentials.lennard_jones).
      row_chunk: static row-block size for the lax.map sweep.
    """
    n = positions.shape[0]
    dtype = positions.dtype
    scaled = positions / box
    hs = params.half_sigma.astype(dtype)
    tse = params.twice_sqrt_eps.astype(dtype)
    valid = jnp.ones((n,), bool) if mask is None else mask
    q = charges.astype(dtype) if charges is not None else None

    # Pad rows so the block sweep has a static uniform shape.
    n_pad = _round_up(max(n, 1), row_chunk)
    pad = n_pad - n
    scaled_p = jnp.pad(scaled, ((0, pad), (0, 0)))
    hs_p = jnp.pad(hs, (0, pad))
    tse_p = jnp.pad(tse, (0, pad))
    valid_p = jnp.pad(valid, (0, pad))
    q_p = jnp.pad(q, (0, pad)) if q is not None else None
    row_ids = jnp.arange(n_pad, dtype=jnp.int32)

    def row_block(block_start):
        ids_i = block_start + jnp.arange(row_chunk, dtype=jnp.int32)
        s_i = jax.lax.dynamic_slice_in_dim(scaled_p, block_start, row_chunk)
        hs_i = jax.lax.dynamic_slice_in_dim(hs_p, block_start, row_chunk)
        tse_i = jax.lax.dynamic_slice_in_dim(tse_p, block_start, row_chunk)
        v_i = jax.lax.dynamic_slice_in_dim(valid_p, block_start, row_chunk)

        # (B, N, 3) minimum-image displacements on scaled coords, then → real.
        dv = box * minimum_image(s_i[:, None, :] - scaled[None, :, :])
        r2 = jnp.sum(dv * dv, axis=-1)  # (B, N)
        pair_ok = (ids_i[:, None] != row_ids[None, :n]) & v_i[:, None] & valid[None, :]
        r2_safe = jnp.where(pair_ok, r2, jnp.asarray(1.0, dtype))
        energy, minus_rE = pair_interaction(
            r2_safe, model, hs_i[:, None], tse_i[:, None], hs[None, :], tse[None, :],
            parity_mode=parity_mode,
        )
        if q is not None:
            from emdee_tpu.potentials.coulomb import coulomb_interaction

            q_i = jax.lax.dynamic_slice_in_dim(q_p, block_start, row_chunk)
            e_c, mre_c = coulomb_interaction(
                r2_safe, coulomb, q_i[:, None], q[None, :]
            )
            energy = energy + e_c
            minus_rE = minus_rE + mre_c
        energy = jnp.where(pair_ok, energy, 0.0)
        minus_rE = jnp.where(pair_ok, minus_rE, 0.0)

        out = []
        if outputs & FORCES:
            f = jnp.sum((minus_rE / r2_safe)[..., None] * dv, axis=1)  # (B, 3)
            out.append(f)
        if outputs & ENERGIES:
            out.append(0.5 * jnp.sum(energy, axis=1))
        if outputs & VIRIALS:
            out.append(0.5 * jnp.sum(minus_rE, axis=1))
        return tuple(out)

    starts = jnp.arange(0, n_pad, row_chunk, dtype=jnp.int32)
    blocks = jax.lax.map(row_block, starts)

    idx = 0
    forces = energies = virials = None
    if outputs & FORCES:
        forces = blocks[idx].reshape(n_pad, 3)[:n]
        idx += 1
    if outputs & ENERGIES:
        energies = blocks[idx].reshape(n_pad)[:n]
        idx += 1
    if outputs & VIRIALS:
        virials = blocks[idx].reshape(n_pad)[:n]
    return NonbondedOutput(forces=forces, energies=energies, virials=virials)
