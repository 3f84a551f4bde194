"""Pair forces of the dense-cell engine as one Pallas-Triton GPU kernel.

One program owns a block of B slots of one cell (B a power of two; a cell of
capacity C is covered by ⌈C/B⌉ blocks) and walks the full 27-cell shell: for
each neighbour cell and each of its slot blocks it loads the B neighbour
coordinates, evaluates the B×B pair tile in registers, and adds the row sums
to its own force accumulators.  Every pair is evaluated from both sides, so
no reaction is written anywhere: each slot's force is stored once, with no
atomics, and the result does not depend on scheduling.  This is the CUDA
reference's tile (one block per 32×32 atom tile, nonbonded.jl:68-104) on the
slot layout, with the neighbour cell as the j-tile; at C = 32 a cell is one
tile.

Periodic images come from cell-index arithmetic: a neighbour cell across a
box face has its coordinates shifted by ±L.  That is exact because the engine
stores every coordinate within skin/2 of its cell (positions are wrapped at
each rebin and drift less than skin/2 between rebins).

The pair physics is `pair_interaction` and `coulomb_interaction` themselves,
evaluated on register tiles; only erfc is swapped for `erfc_chebyshev`,
because the Triton lowering has no erfc.  Energies and virials are not
computed here: observables stay on `cell_dense_forces(compute_energy=True)`.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from emdee_tpu.potentials.coulomb import (
    DSFCoulomb,
    coulomb_interaction,
    erfc_chebyshev,
)
from emdee_tpu.potentials.lennard_jones import LennardJonesModel, pair_interaction

_BLOCKS = (16, 32, 64)


def block_size(capacity: int) -> int:
    """Slot-block width B for a cell capacity: the least padded width
    ⌈C/B⌉·B, ties to the larger block (fewer loop trips)."""
    return min(_BLOCKS, key=lambda b: (-(-capacity // b) * b, -b))


def static_lj(model: LennardJonesModel) -> tuple:
    """LJ model constants as hashable floats (rc², rs², δ⁻²)."""
    return tuple(float(v) for v in model)


def _kernel(*refs, m, c, blk, nblk, lj, dsf, uniform, excl_e, has_q):
    it = iter(refs)
    x_ref, y_ref, z_ref, aid_ref, box_ref = (next(it) for _ in range(5))
    hs_ref = tse_ref = q_ref = ids_ref = mlj_ref = mcs_ref = None
    if uniform is None:
        hs_ref, tse_ref = next(it), next(it)
    if has_q:
        q_ref = next(it)
    if excl_e:
        ids_ref, mlj_ref = next(it), next(it)
        if has_q:
            mcs_ref = next(it)
    fx_ref, fy_ref, fz_ref = next(it), next(it), next(it)

    ns = m * m * m * c
    cell = pl.program_id(0)
    iblk = pl.program_id(1)
    # Truncating integer ops: every operand here is non-negative.
    rem = lambda a, b: jax.lax.rem(a, jnp.int32(b))
    div = lambda a, b: jax.lax.div(a, jnp.int32(b))
    cx = rem(cell, m)
    cy = rem(div(cell, m), m)
    cz = div(cell, m * m)
    lanes = jnp.arange(blk, dtype=jnp.int32)
    box = plgpu.load(box_ref.at[pl.ds(0, blk)])

    def load(ref, start, mask, other, offset=0):
        return plgpu.load(
            ref.at[pl.ds(offset + start, blk)], mask=mask, other=other
        )

    i0 = cell * c + iblk * blk
    mi = iblk * blk + lanes < c
    xi = load(x_ref, i0, mi, 0.0)
    yi = load(y_ref, i0, mi, 0.0)
    zi = load(z_ref, i0, mi, 0.0)
    aid_i = load(aid_ref, i0, mi, -2.0)  # atom id; −2 marks an empty slot
    if uniform is None:
        hs_i = load(hs_ref, i0, mi, 0.0)[:, None]
        tse_i = load(tse_ref, i0, mi, 0.0)[:, None]
    else:
        hs_i, tse_i = uniform
    q_i = load(q_ref, i0, mi, 0.0)[:, None] if has_q else None
    tags = []
    for e in range(excl_e):
        tags.append((
            load(ids_ref, i0, mi, -1.0, e * ns)[:, None],
            load(mlj_ref, i0, mi, 0.0, e * ns)[:, None],
            load(mcs_ref, i0, mi, 0.0, e * ns)[:, None] if has_q else None,
        ))
    lj_model = LennardJonesModel(*lj)
    dsf_model = None if dsf is None else DSFCoulomb(
        alpha=dsf[0], rc=dsf[1], rc2=dsf[1] * dsf[1], e_shift=dsf[2],
        f_shift=dsf[3], kc=dsf[4],
    )

    def wrap(n):
        # Neighbour cell coordinate n ∈ [−1, M] → (stored cell, image shift).
        lo = (n < 0).astype(jnp.int32)
        hi = (n >= m).astype(jnp.int32)
        return n + m * (lo - hi), (hi - lo).astype(jnp.float32)

    def body(k, acc):
        fx, fy, fz = acc
        off, jblk = (k, 0) if nblk == 1 else (div(k, nblk), rem(k, nblk))
        nx, sx = wrap(cx + rem(off, 3) - 1)
        ny, sy = wrap(cy + rem(div(off, 3), 3) - 1)
        nz, sz = wrap(cz + div(off, 9) - 1)
        j0 = (nx + m * (ny + m * nz)) * c + jblk * blk
        mj = jblk * blk + lanes < c
        xj = load(x_ref, j0, mj, 0.0) + sx * box
        yj = load(y_ref, j0, mj, 0.0) + sy * box
        zj = load(z_ref, j0, mj, 0.0) + sz * box
        aid_j = load(aid_ref, j0, mj, -2.0)[None, :]
        dx = xi[:, None] - xj[None, :]
        dy = yi[:, None] - yj[None, :]
        dz = zi[:, None] - zj[None, :]
        r2 = dx * dx + dy * dy + dz * dz
        # Both slots live and distinct atoms (the self pair shares its id).
        ok = (aid_i[:, None] >= 0.0) & (aid_j >= 0.0) & (aid_i[:, None] != aid_j)
        r2s = jnp.where(ok, r2, 1.0)
        if uniform is None:
            hs_j = load(hs_ref, j0, mj, 0.0)[None, :]
            tse_j = load(tse_ref, j0, mj, 0.0)[None, :]
        else:
            hs_j, tse_j = uniform
        _, mre = pair_interaction(r2s, lj_model, hs_i, tse_i, hs_j, tse_j)
        csc = None
        if excl_e:
            wlj = 0.0
            wcs = 0.0
            for ids_e, mlj_e, mcs_e in tags:
                match = ids_e == aid_j
                wlj = wlj + jnp.where(match, mlj_e, 0.0)
                if has_q:
                    wcs = wcs + jnp.where(match, mcs_e, 0.0)
            mre = mre * (1.0 - wlj)
            if has_q:
                csc = 1.0 - wcs
        if has_q:
            q_j = load(q_ref, j0, mj, 0.0)[None, :]
            _, mre_c = coulomb_interaction(
                r2s, dsf_model, q_i, q_j, erfc_fn=erfc_chebyshev
            )
            mre = mre + (mre_c if csc is None else mre_c * csc)
        g = jnp.where(ok, mre / r2s, 0.0)
        return (
            fx + jnp.sum(g * dx, axis=1),
            fy + jnp.sum(g * dy, axis=1),
            fz + jnp.sum(g * dz, axis=1),
        )

    zero = jnp.zeros((blk,), jnp.float32)
    fx, fy, fz = jax.lax.fori_loop(0, 27 * nblk, body, (zero, zero, zero))
    plgpu.store(fx_ref.at[pl.ds(i0, blk)], fx, mask=mi)
    plgpu.store(fy_ref.at[pl.ds(i0, blk)], fy, mask=mi)
    plgpu.store(fz_ref.at[pl.ds(i0, blk)], fz, mask=mi)


@partial(jax.jit, static_argnames=("config", "lj", "dsf", "uniform_params", "interpret"))
def cell_pair_forces(
    state,
    config,
    lj: tuple,
    dsf: tuple | None = None,
    excl=None,
    *,
    uniform_params: tuple | None = None,
    interpret: bool = False,
):
    """(M³, C, 3) pair forces of every live slot — `cell_dense_forces`'s
    forces, computed by the full-shell kernel.

    lj: `static_lj(model)`; dsf: `coulomb_consts(coulomb)` or None (charges
    are then ignored); excl: slot-space tags (ids, mlj, mcs) as
    `cell_dense_forces` takes them; uniform_params: static (σ/2, 2√ε) when
    every atom shares one LJ type.  `interpret` runs the kernel on the CPU
    through the Pallas interpreter; only tests set it."""
    from emdee_tpu.neighbors.cell_dense import _state_box

    m, c = config.cells_per_dim, config.capacity
    if m < 3:
        raise ValueError(f"the 27-cell shell needs cells_per_dim ≥ 3, got {m}")
    ns = config.num_slots
    blk = block_size(c)
    nblk = -(-c // blk)
    has_q = dsf is not None
    if has_q and state.charges is None:
        raise ValueError("coulomb model given but state has no charges")
    flat = lambda a: a.reshape(ns).astype(jnp.float32)
    pos = state.positions
    box = jnp.broadcast_to(_state_box(state, config).astype(jnp.float32), (blk,))
    inputs = [
        flat(pos[..., 0]), flat(pos[..., 1]), flat(pos[..., 2]),
        flat(jnp.where(state.valid, state.atom_id, -2)), box,
    ]
    if uniform_params is None:
        inputs += [flat(state.half_sigma), flat(state.twice_sqrt_eps)]
    if has_q:
        inputs.append(flat(state.charges))
    excl_e = 0
    if excl is not None:
        ids, mlj, mcs = excl
        if has_q and mcs is None:
            mcs = mlj  # Coulomb scales default to the LJ scales
        excl_e = int(ids.shape[-1])
        # (M³, C, E) → (E·NS,): each tag column contiguous.
        tag = lambda t: jnp.moveaxis(t, -1, 0).reshape(excl_e * ns).astype(jnp.float32)
        inputs += [tag(ids), tag(mlj)]
        if has_q:
            inputs.append(tag(mcs))
    kernel = partial(
        _kernel, m=m, c=c, blk=blk, nblk=nblk, lj=lj, dsf=dsf,
        uniform=uniform_params, excl_e=excl_e, has_q=has_q,
    )
    out = jax.ShapeDtypeStruct((ns,), jnp.float32)
    fx, fy, fz = pl.pallas_call(
        kernel,
        out_shape=(out, out, out),
        grid=(m**3, nblk),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, blk * blk // 256), num_stages=2
        ),
        interpret=interpret,
        name="cell_pair_forces",
    )(*inputs)
    return jnp.stack([fx, fy, fz], axis=-1).reshape(pos.shape)
