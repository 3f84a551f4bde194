"""3D grid-sharded dense-cell engine: the production multi-chip path.

Shards the (M, M, M, C) slot grid over a 3D device mesh ("gz", "gy", "gx") —
spatial domain decomposition in all three axes, lifting the 1D slab cap of
`cell_dense_sharded` (device count there ≤ ⌊M/2⌋; here ≤ ⌊M/2⌋³).  The whole
rollout runs inside ONE `shard_map` region, so every byte of communication is
an explicit `ppermute` over the mesh ring — nothing left to the partitioner:

- **Force pass** = the XLA half-shell (`_local_forces_xla`) on each
  shard's local block.  Ghost cells come from 3 successive face exchanges
  (z, then y of the z-extended block, then x) — two `ppermute`s per axis
  deliver faces, edges AND corners (corner data rides through two hops).
  Newton's 3rd law is kept across shards: the reaction ghost buffer is
  folded back with the same three exchanges in reverse — one extra
  ppermute pair per axis instead of the 2× pair FLOPs of full-shell double
  compute.
- **Rebin** = the gather-free shift rebin (`cell_dense._route_axis_pass`)
  with the ±1-cell neighbor blocks delivered by halo ppermute — atom
  migration between shards is the same one-layer exchange as the halo.
- Elementwise integrator math needs no communication at all; global scalars
  (energy, overflow, staleness) are `psum`/`pmax` reductions.

This is the multi-device spatial decomposition the reference never had
(SURVEY.md §2b): `ppermute` between devices plays the role warp shuffles
play inside one GPU in `compute_tile!` (nonbonded.jl:68-84), one level up
the hierarchy.  Molecular systems are first-class: DSF Coulomb rides every
pair evaluation (charges travel with the halos) and kernel-resident exclusion
tags are rebuilt per shard after each rebin (`excl_tables`), so cross-boundary
exclusions work through the ghost copies for free.

Mesh axis sizes of 1 degrade gracefully to local periodic wraps, so a
(D, 1, 1) mesh reproduces the 1D slab decomposition and (1, 1, 1) the
single-chip engine exactly.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from emdee_tpu.neighbors.cell_dense import (
    CellDenseConfig,
    CellDenseState,
    _route_axis_pass,
)
from emdee_tpu.potentials.lennard_jones import LennardJonesModel, pair_interaction

AXES = ("gz", "gy", "gx")

# Grid axis k (0=z, 1=y, 2=x) ↔ position component (x=0, y=1, z=2).
_COORD_OF_AXIS = (2, 1, 0)


def make_grid_mesh(shape: Tuple[int, int, int], devices=None) -> Mesh:
    """A (nz, ny, nx) device mesh with axes ("gz", "gy", "gx")."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = int(np.prod(shape))
    if devices.size < n:
        raise ValueError(f"need {n} devices, have {devices.size}")
    return Mesh(devices[:n].reshape(shape), AXES)


def validate_grid_config(config: CellDenseConfig, mesh: Mesh) -> Tuple[int, int, int]:
    m = config.cells_per_dim
    locs = []
    for ax in AXES:
        nd = mesh.shape[ax]
        if m % nd != 0:
            raise ValueError(f"cells_per_dim {m} must divide over {nd} ({ax}) devices")
        loc = m // nd
        if nd > 1 and loc < 2:
            raise ValueError(f"{loc} cell layer(s) per device on {ax} — need ≥ 2")
        locs.append(loc)
    return tuple(locs)


def _grid_leaves(state: CellDenseState, config: CellDenseConfig) -> CellDenseState:
    """(M³, C, …) leaves → (M, M, M, C, …) grid layout (axes z, y, x)."""
    m = config.cells_per_dim

    def to_grid(a):
        if getattr(a, "ndim", 0) >= 2 and a.shape[0] == config.num_cells:
            return a.reshape((m, m, m) + a.shape[1:])
        return a

    return jax.tree_util.tree_map(to_grid, state)


def _flat_leaves(state: CellDenseState, config: CellDenseConfig) -> CellDenseState:
    m = config.cells_per_dim

    def to_flat(a):
        if getattr(a, "ndim", 0) >= 4 and a.shape[:3] == (m, m, m):
            return a.reshape((config.num_cells,) + a.shape[3:])
        return a

    return jax.tree_util.tree_map(to_flat, state)


def distribute_grid(state: CellDenseState, config: CellDenseConfig, mesh: Mesh):
    """Single-chip CellDenseState → grid-layout state sharded over the mesh."""
    g = _grid_leaves(state, config)
    shard = NamedSharding(mesh, P(*AXES))
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(a, shard if getattr(a, "ndim", 0) >= 3 else rep), g
    )


def gather_grid_atoms(state: CellDenseState, config: CellDenseConfig, num_atoms: int):
    """Grid-sharded state → (N, 3) positions/velocities by atom id (host)."""
    from emdee_tpu.neighbors.cell_dense import gather_dense_atoms

    flat = jax.device_get(_flat_leaves(state, config))
    return gather_dense_atoms(flat, num_atoms)


def reconfigure_grid_state(
    state: CellDenseState, config: CellDenseConfig, mesh: Mesh
):
    """NPT geometry re-derive for a GRID-SHARDED run: when the dynamic box
    drifts past the static-geometry guard (the rollout's sticky flag trips at
    box < M·(rc + skin)), gather the state host-side, re-derive the cell
    grid at the current box (cells_per_dim rounded to a multiple of every
    mesh axis so the decomposition still divides), and redistribute over the
    same mesh.  Returns (sharded state', config'); build fresh rollout/energy
    closures from config' (M and C are trace-time statics — a geometry
    change is a recompile by construction).

    Long NPT runs alternate: rollout until `state.overflow` trips on the
    geometry guard → `reconfigure_grid_state` → new closures → continue."""
    from emdee_tpu.neighbors.cell_dense import reconfigure_dense_state

    lcm = 1
    for ax in AXES:
        nd = mesh.shape[ax]
        lcm = lcm * nd // int(np.gcd(lcm, nd))
    flat = jax.device_get(_flat_leaves(state, config))
    new_flat, new_config = reconfigure_dense_state(
        flat, config, cells_multiple_of=lcm,
        min_cells_per_dim=2 * max(mesh.shape[ax] for ax in AXES),
    )
    validate_grid_config(new_config, mesh)
    return distribute_grid(new_flat, new_config, mesh), new_config


def make_grid_sharded_sim(
    config: CellDenseConfig,
    model: LennardJonesModel,
    dt: float,
    mesh: Mesh,
    backend: str = "auto",
    coulomb=None,
    excl_tables=None,
    thermostat=None,
    barostat=None,
    bonded=None,
    excl_leftover=None,
    atom_params=None,
    atom_charges=None,
):
    """(rollout, energy) closures; state is grid-layout, mesh-sharded.

    backend: 'xla' (half-shell via static slices of the ghost grid) or
    'auto' (the same — it is the only per-shard pair pass).

    coulomb: optional DSFCoulomb model (state.charges must be set) — DSF
    electrostatics ride every pair evaluation, sharded like LJ.
    excl_tables: optional (ids, mlj, mcs) atom-indexed exclusion tables
    (cell_dense_molecular.build_exclusion_tables, replicated on every
    shard); slot tags are rebuilt per shard after each rebin and compared
    in-pass — the multi-chip version of the kernel-resident exclusions.

    thermostat: optional `cell_dense.CSVRConfig` (Bussi global rescale per
    step — kinetic energy via 3-axis psum, replicated PRNG key → identical
    α on every shard, one collective per step) or `cell_dense.LangevinConfig`
    (BAOAB — per-shard noise from the replicated key folded with the shard
    index, no communication at all).  The rollout then requires an `rng`
    argument.

    barostat: optional `cell_dense.BerendsenBarostatConfig` — Berendsen
    μ-rescale of positions and the (dynamic, replicated) box at every rebin
    boundary, with the pressure from a psum'd energy/virial pass.  The
    sticky flag trips if the box shrinks past M·(rc + skin) (the static cell
    count no longer fits) — re-derive the config and redistribute to
    continue.

    bonded: optional `BondedSystem` with ATOM indices (replicated static
    tables).  Bonds/angles/torsions are evaluated owner-computes on the
    EXTENDED (ghost) grid: a term's partners are always within one cell of
    its owner atom (term span ≪ cell side = rc + skin), so after the halo
    exchange the owning shard already holds every position it needs; forces
    scattered onto ghost slots ride the existing reverse reaction folds —
    no extra communication.  Per-rebin bindings come from a psum-replicated
    atom→global-slot map.  If a term ever spans > 1 cell (broken/stretched
    topology), the sticky overflow flag trips.

    excl_leftover: optional (pairs, lj_scales, coulomb_scales) exclusion
    pairs BEYOND the kernel tag band (`build_exclusion_tables(band_e=…)`'s
    leftover) — evaluated as −(1−s)·(LJ [+ DSF]) corrections on the same
    extended-grid machinery.  Requires `atom_params` (atom-ordered LJParams)
    and, with coulomb, `atom_charges`.
    """
    mz, my, mx = validate_grid_config(config, mesh)
    sizes = tuple(mesh.shape[ax] for ax in AXES)
    m = config.cells_per_dim
    c = config.capacity
    # Dynamic (NPT) box: helpers read the CURRENT traced box through this
    # trace-time routing cell — set from the shard_map argument at entry and
    # updated by the barostat's μ-rescale, so every ghost shift, wrap and
    # binning inside the region sees the live value.
    box_cell = [jnp.float32(config.box)]

    def _box():
        return box_cell[0]

    dt_f = jnp.float32(dt)
    if backend not in ("auto", "xla"):
        raise ValueError(
            f"unknown grid-sharded backend {backend!r}; expected 'auto' or 'xla'"
        )
    has_q = coulomb is not None
    has_excl = excl_tables is not None
    if has_excl and has_q and excl_tables[2] is None:
        # Mirror the single-chip engines: a missing Coulomb-scale table means
        # "use the LJ scales", never "skip Coulomb exclusions" — silently
        # skipping would give bonded 1-2/1-3 pairs full electrostatics.
        excl_tables = (excl_tables[0], excl_tables[1], excl_tables[1])
    excl_e = 0 if not has_excl else int(excl_tables[0].shape[-1])
    excl_cs = has_excl and excl_tables[2] is not None
    n_tab = None if not has_excl else int(excl_tables[0].shape[0]) - 1
    if has_excl:
        # Column-pack the tag tables so the per-rebin rebuild is ONE
        # row gather (the same packing as make_exclusion_aux_fn on the
        # single-device engine).
        excl_packed = jnp.concatenate(
            [t for t in excl_tables if t is not None], axis=-1
        )

    # ---- extended-grid bonded / leftover-exclusion terms ----
    has_bonded = bonded is not None and any(t is not None for t in bonded)
    has_leftover = excl_leftover is not None and len(excl_leftover[0]) > 0
    has_terms = has_bonded or has_leftover
    n_at = int(config.num_atoms)
    n_ext = (mz + 2) * (my + 2) * (mx + 2) * c  # extended-grid slot count
    if has_leftover:
        if atom_params is None:
            raise ValueError("excl_leftover needs atom-ordered LJ params")
        lo_np = np.asarray(excl_leftover[0], np.int64)
        lo_pi, lo_pj = lo_np[:, 0], lo_np[:, 1]
        _hs = np.asarray(atom_params.half_sigma, np.float32)
        _tse = np.asarray(atom_params.twice_sqrt_eps, np.float32)
        lo_hs_i, lo_tse_i = jnp.asarray(_hs[lo_pi]), jnp.asarray(_tse[lo_pi])
        lo_hs_j, lo_tse_j = jnp.asarray(_hs[lo_pj]), jnp.asarray(_tse[lo_pj])
        lo_wlj = jnp.asarray(1.0 - np.asarray(excl_leftover[1], np.float32))
        lo_pairs = jnp.asarray(lo_np, jnp.int32)
        lo_has_q = has_q and atom_charges is not None
        if lo_has_q:
            _qn = np.asarray(atom_charges, np.float32)
            lo_qi, lo_qj = jnp.asarray(_qn[lo_pi]), jnp.asarray(_qn[lo_pj])
            _cs = (
                excl_leftover[2]
                if excl_leftover[2] is not None
                else excl_leftover[1]
            )
            lo_wc = jnp.asarray(1.0 - np.asarray(_cs, np.float32))

    spec = P(*AXES)
    rep = P()
    spill_eps = float(config.cell_side) - float(config.cutoff) - float(config.skin)

    # ---- communication primitives (inside shard_map) ----

    def _edge(x, axis, take_hi):
        nloc = x.shape[axis]
        return jax.lax.slice_in_dim(x, nloc - 1 if take_hi else 0, nloc if take_hi else 1, axis=axis)

    def _halo(x, axis, coord_shift=None):
        """(…) local block → (lo, hi) neighbor boundary layers along grid
        axis (0=z,1=y,2=x).  coord_shift: the box-wrap offset to apply to a
        COORDINATE field crossing the global seam (None for non-coords)."""
        size = sizes[axis]
        lo_src = _edge(x, axis, take_hi=True)  # neighbor below sends its top
        hi_src = _edge(x, axis, take_hi=False)
        if size == 1:
            lo, hi = lo_src, hi_src
            if coord_shift is not None:
                lo = lo - coord_shift
                hi = hi + coord_shift
            return lo, hi
        fwd = [(i, (i + 1) % size) for i in range(size)]
        back = [(i, (i - 1) % size) for i in range(size)]
        lo = jax.lax.ppermute(lo_src, AXES[axis], fwd)
        hi = jax.lax.ppermute(hi_src, AXES[axis], back)
        if coord_shift is not None:
            idx = jax.lax.axis_index(AXES[axis])
            lo = jnp.where(idx == 0, lo - coord_shift, lo)
            hi = jnp.where(idx == size - 1, hi + coord_shift, hi)
        return lo, hi

    def _ghost3(x, coord_axis=None):
        """Local (mz, my, mx, C…) block → (mz+2, my+2, mx+2, C…) ghost grid.
        coord_axis: grid axis whose coordinate this field is (box shifts at
        the global seam), or None."""
        for axis in (0, 1, 2):
            shift = _box() if coord_axis == axis else None
            lo, hi = _halo(x, axis, coord_shift=shift)
            x = jnp.concatenate([lo, x, hi], axis=axis)
        return x

    def _fold3(r):
        """Reaction ghost (mz+2, my+2, mx+2, C…) → interior (mz, my, mx, C…)
        with each ghost layer delivered back to its owner (reverse order)."""
        for axis in (2, 1, 0):
            size = sizes[axis]
            n_ext = r.shape[axis]
            lo_g = jax.lax.slice_in_dim(r, 0, 1, axis=axis)
            hi_g = jax.lax.slice_in_dim(r, n_ext - 1, n_ext, axis=axis)
            body = jax.lax.slice_in_dim(r, 1, n_ext - 1, axis=axis)
            if size > 1:
                # My lo ghost belongs to my −axis neighbor's top layer.
                fwd = [(i, (i + 1) % size) for i in range(size)]
                back = [(i, (i - 1) % size) for i in range(size)]
                lo_g = jax.lax.ppermute(lo_g, AXES[axis], back)  # goes down
                hi_g = jax.lax.ppermute(hi_g, AXES[axis], fwd)
                # After the permute: lo_g here is my +axis neighbor's lo ghost
                # → belongs to MY top layer; hi_g is my −axis neighbor's hi
                # ghost → my bottom layer.
            nloc = body.shape[axis]
            first = jax.lax.slice_in_dim(body, 0, 1, axis=axis) + hi_g
            mid = jax.lax.slice_in_dim(body, 1, nloc - 1, axis=axis)
            last = jax.lax.slice_in_dim(body, nloc - 1, nloc, axis=axis) + lo_g
            r = jnp.concatenate([first, mid, last], axis=axis)
        return r

    # ---- extended-grid term bindings (bonded + leftover exclusions) ----
    #
    # Owner-computes on the ghost grid: for every term the shard owning the
    # term's OWNER atom evaluates it, gathering partner positions from its
    # (mz+2, my+2, mx+2, C) extended grid — chemistry guarantees partners sit
    # within ±1 cell of the owner (spans ≪ cell side) — and scattering ghost
    # forces that ride the existing reverse reaction folds.  The per-rebin
    # binding needs one psum of an (N+1,) atom→global-slot map; every shard
    # walks the full replicated term tables with an ownership mask (the pair
    # pass, which dominates, is what actually scales).

    def _atom_gslot_map(aid, valid):
        """Replicated (N+1,) atom id → global slot id (cell·C + slot)."""
        iz = (jax.lax.axis_index(AXES[0]) * mz + jnp.arange(mz, dtype=jnp.int32))
        iy = (jax.lax.axis_index(AXES[1]) * my + jnp.arange(my, dtype=jnp.int32))
        ix = (jax.lax.axis_index(AXES[2]) * mx + jnp.arange(mx, dtype=jnp.int32))
        cell = (
            iz[:, None, None] * m + iy[None, :, None]
        ) * m + ix[None, None, :]
        gslot = cell[..., None] * c + jnp.arange(c, dtype=jnp.int32)
        ids = jnp.where(valid, aid, n_at).reshape(-1)
        amap = jnp.zeros((n_at + 1,), jnp.int32).at[ids].set(gslot.reshape(-1))
        for ax in AXES:
            amap = jax.lax.psum(amap, ax)
        return amap

    def _ext_of(amap, atoms, owner_col, valid_rows):
        """Term atoms (T, k) → extended-grid indices + ownership mask.

        Non-owned (and pad) rows point at the n_ext pad slot.  Returns a
        `bad` flag: an OWNED valid term whose partner strayed beyond ±1 cell
        of the owner (impossible for intact topology) — OR'd into the sticky
        overflow so broken physics can't pass silently."""
        gs = amap[jnp.minimum(atoms, n_at)]  # (T, k)
        slot = gs % c
        cell = gs // c
        cxg = cell % m
        cyg = (cell // m) % m
        czg = cell // (m * m)
        sz = jax.lax.axis_index(AXES[0])
        sy = jax.lax.axis_index(AXES[1])
        sx = jax.lax.axis_index(AXES[2])
        oz, oy, ox = czg[:, owner_col], cyg[:, owner_col], cxg[:, owner_col]
        mine = (oz // mz == sz) & (oy // my == sy) & (ox // mx == sx)
        if valid_rows is not None:
            mine = mine & valid_rows

        def rel(cg, co):
            d = cg - co[:, None]
            half = m // 2
            return ((d + half) % m) - half  # periodic wrap to [−half, half)

        dz, dy, dx = rel(czg, oz), rel(cyg, oy), rel(cxg, ox)
        bad = jnp.any(
            mine[:, None]
            & ((jnp.abs(dz) > 1) | (jnp.abs(dy) > 1) | (jnp.abs(dx) > 1))
        )
        ez = (oz - sz * mz)[:, None] + jnp.clip(dz, -1, 1) + 1
        ey = (oy - sy * my)[:, None] + jnp.clip(dy, -1, 1) + 1
        ex = (ox - sx * mx)[:, None] + jnp.clip(dx, -1, 1) + 1
        ext = ((ez * (my + 2) + ey) * (mx + 2) + ex) * c + slot
        return jnp.where(mine[:, None], ext, n_ext), mine, bad

    def _bind_terms(aid, valid):
        """Per-rebin term→extended-slot bindings (dict pytree) + bad flag."""
        if not has_terms:
            return None, jnp.asarray(False)
        amap = _atom_gslot_map(aid, valid)
        out = {}
        bad = jnp.asarray(False)
        if has_bonded:
            fam = {}
            for name, tab, oc in (
                ("bonds", bonded.bonds, 0),
                ("angles", bonded.angles, 1),
                ("torsions", bonded.torsions, 1),
                ("impropers", bonded.impropers, 1),
            ):
                if tab is None:
                    continue
                ext, mine, b = _ext_of(amap, tab.atoms, oc, tab.valid)
                fam[name] = (ext, mine)
                bad = bad | b
            out["bonded"] = fam
        if has_leftover:
            ext, mine, b = _ext_of(amap, lo_pairs, 0, None)
            out["leftover"] = (ext, mine)
            bad = bad | b
        return out, bad

    def _pos_ext_flat(gx_, gy_, gz_):
        """Ghost coordinate grids → (n_ext + 1, 3) with a zero pad row."""
        return jnp.concatenate(
            [
                jnp.stack(
                    [gx_.reshape(-1), gy_.reshape(-1), gz_.reshape(-1)], axis=-1
                ),
                jnp.zeros((1, 3), jnp.float32),
            ]
        )

    def _term_rows(pos_ext, ebind):
        """(idx, contrib) scatter rows of every owned term, extended-slot
        indexed — the caller folds them into its reaction ghost buffer."""
        from emdee_tpu.potentials.bonded import (
            angle_force_rows,
            bond_force_rows,
            torsion_force_rows,
        )

        box = _box()
        idxs, contribs = [], []
        if has_bonded:
            fam = ebind["bonded"]
            for name, tab, rows in (
                ("bonds", bonded.bonds, bond_force_rows),
                ("angles", bonded.angles, angle_force_rows),
                ("torsions", bonded.torsions, torsion_force_rows),
                ("impropers", bonded.impropers, torsion_force_rows),
            ):
                if name not in fam:
                    continue
                ext, mine = fam[name]
                idx, con = rows(pos_ext, box, tab._replace(atoms=ext, valid=mine))
                idxs.append(idx)
                contribs.append(con)
        if has_leftover:
            ext, mine = ebind["leftover"]
            i, j = ext[:, 0], ext[:, 1]
            dv = pos_ext[i] - pos_ext[j]  # ghosts are seam-shifted: exact
            r2 = jnp.sum(dv * dv, axis=-1)
            r2s = jnp.where(mine, r2, 1.0)
            _, mre = pair_interaction(
                r2s, model, lo_hs_i, lo_tse_i, lo_hs_j, lo_tse_j
            )
            mre = lo_wlj * mre
            if lo_has_q:
                from emdee_tpu.potentials.coulomb import coulomb_interaction

                _, mre_c = coulomb_interaction(r2s, coulomb, lo_qi, lo_qj)
                mre = mre + lo_wc * mre_c
            mre = jnp.where(mine, mre, 0.0)
            f_ij = (mre / r2s)[:, None] * dv
            idxs.append(jnp.concatenate([i, j]))
            contribs.append(jnp.concatenate([-f_ij, f_ij]))
        return jnp.concatenate(idxs), jnp.concatenate(contribs)

    def _term_force_grid(gx_, gy_, gz_, ebind):
        """Owned-term forces on the extended grid (gz, gy, gx, C, 3) —
        interior rows add locally, ghost rows ride the reverse halo fold."""
        idx, contrib = _term_rows(_pos_ext_flat(gx_, gy_, gz_), ebind)
        f = jnp.zeros((n_ext + 1, 3), jnp.float32).at[idx].add(contrib)
        return f[:-1].reshape(mz + 2, my + 2, mx + 2, c, 3)

    def _term_energy_virial(pos_ext, ebind):
        """Shard-local (pe, vir) scalars of the owned terms."""
        from emdee_tpu.potentials.bonded import (
            angle_energy,
            bond_energy,
            bond_virial,
            torsion_energy,
        )

        box = _box()
        pe = jnp.float32(0.0)
        vir = jnp.float32(0.0)
        if has_bonded:
            fam = ebind["bonded"]
            for name, tab, efn in (
                ("bonds", bonded.bonds, bond_energy),
                ("angles", bonded.angles, angle_energy),
                ("torsions", bonded.torsions, torsion_energy),
                ("impropers", bonded.impropers, torsion_energy),
            ):
                if name not in fam:
                    continue
                ext, mine = fam[name]
                rt = tab._replace(atoms=ext, valid=mine)
                pe = pe + efn(pos_ext, box, rt)
                if name == "bonds":
                    # Angles/torsions are scale-invariant: zero virial.
                    vir = vir + bond_virial(pos_ext, box, rt)
        if has_leftover:
            ext, mine = ebind["leftover"]
            i, j = ext[:, 0], ext[:, 1]
            dv = pos_ext[i] - pos_ext[j]
            r2 = jnp.sum(dv * dv, axis=-1)
            r2s = jnp.where(mine, r2, 1.0)
            e, mre = pair_interaction(
                r2s, model, lo_hs_i, lo_tse_i, lo_hs_j, lo_tse_j
            )
            e = lo_wlj * e
            mre = lo_wlj * mre
            if lo_has_q:
                from emdee_tpu.potentials.coulomb import coulomb_interaction

                e_c, mre_c = coulomb_interaction(r2s, coulomb, lo_qi, lo_qj)
                e = e + lo_wc * e_c
                mre = mre + lo_wc * mre_c
            pe = pe - jnp.sum(jnp.where(mine, e, 0.0))
            vir = vir - jnp.sum(jnp.where(mine, mre, 0.0))
        return pe, vir

    def _local_forces_xla(pos, hs, tse, valid, q, aid_f, aux, compute_energy,
                          ebind=None):
        """Portable half-shell on the ghost grid: static slices, same comm.

        With `ebind` (extended-grid term bindings), owned bonded/leftover
        term forces are scattered onto the same reaction ghost buffer (one
        shared fold); in compute_energy mode the return grows to
        (forces, energies, virials, term_pe, term_vir) with the term pe/vir
        as shard-local SCALARS (callers psum them alongside the slot sums)."""
        from emdee_tpu.potentials.coulomb import coulomb_interaction

        # Coordinates need per-axis seam shifts; build per-component ghosts.
        gx_ = _ghost3(pos[..., 0], coord_axis=2)
        gy_ = _ghost3(pos[..., 1], coord_axis=1)
        gz_ = _ghost3(pos[..., 2], coord_axis=0)
        gpos = jnp.stack([gx_, gy_, gz_], axis=-1)  # (mz+2, my+2, mx+2, C, 3)
        ghs = _ghost3(hs)
        gtse = _ghost3(tse)
        gvalid = _ghost3(valid)
        gq = _ghost3(q) if has_q else None
        gaid = _ghost3(aid_f) if has_excl else None

        def pair_terms(r2s, hs_i, tse_i, hs_j, tse_j, q_i, q_j, aid_j):
            e, mrE = pair_interaction(r2s, model, hs_i, tse_i, hs_j, tse_j)
            csc = None
            if has_excl:
                ids_s, mlj_s, mcs_s = aux
                match = ids_s[..., :, None, :] == aid_j[..., None, :, None]
                ljsc = 1.0 - jnp.sum(
                    jnp.where(match, mlj_s[..., :, None, :], 0.0), axis=-1
                )
                e = e * ljsc
                mrE = mrE * ljsc
                if has_q and excl_cs:
                    csc = 1.0 - jnp.sum(
                        jnp.where(match, mcs_s[..., :, None, :], 0.0), axis=-1
                    )
            if has_q:
                e_c, mre_c = coulomb_interaction(r2s, coulomb, q_i, q_j)
                if csc is not None:
                    e_c = e_c * csc
                    mre_c = mre_c * csc
                e = e + e_c
                mrE = mrE + mre_c
            return e, mrE

        def block(g, dz, dy, dx):
            return jax.lax.slice(
                g,
                (1 + dz, 1 + dy, 1 + dx) + (0,) * (g.ndim - 3),
                (1 + dz + mz, 1 + dy + my, 1 + dx + mx) + g.shape[3:],
            )

        half_shell = [
            (dz, dy, dx)
            for dz in (-1, 0, 1)
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if (dz, dy, dx) > (0, 0, 0)
        ]
        cells = (mz, my, mx)
        forces = jnp.zeros_like(pos)
        energies = jnp.zeros_like(hs) if compute_energy else None
        virials = jnp.zeros_like(hs) if compute_energy else None
        react = jnp.zeros((mz + 2, my + 2, mx + 2, c, 3), pos.dtype)
        e_react = jnp.zeros((mz + 2, my + 2, mx + 2, c), pos.dtype) if compute_energy else None
        w_react = jnp.zeros_like(e_react) if compute_energy else None
        eye = jnp.eye(c, dtype=bool)

        # Self-cell tile (both directions, no reaction needed).
        dv = pos[..., :, None, :] - pos[..., None, :, :]
        r2 = jnp.sum(dv * dv, axis=-1)
        ok = valid[..., :, None] & valid[..., None, :] & ~eye
        r2s = jnp.where(ok, r2, 1.0)
        e, mrE = pair_terms(
            r2s, hs[..., :, None], tse[..., :, None], hs[..., None, :], tse[..., None, :],
            q[..., :, None] if has_q else None,
            q[..., None, :] if has_q else None,
            aid_f if has_excl else None,
        )
        g = jnp.where(ok, mrE / r2s, 0.0)
        forces = forces + jnp.sum(g[..., None] * dv, axis=-2)
        if compute_energy:
            energies = energies + 0.5 * jnp.sum(jnp.where(ok, e, 0.0), axis=-1)
            virials = virials + 0.5 * jnp.sum(jnp.where(ok, mrE, 0.0), axis=-1)

        for dz, dy, dx in half_shell:
            npos = block(gpos, dz, dy, dx)
            nhs = block(ghs, dz, dy, dx)
            ntse = block(gtse, dz, dy, dx)
            nvalid = block(gvalid, dz, dy, dx)
            dv = pos[..., :, None, :] - npos[..., None, :, :]
            r2 = jnp.sum(dv * dv, axis=-1)
            ok = valid[..., :, None] & nvalid[..., None, :]
            r2s = jnp.where(ok, r2, 1.0)
            e, mrE = pair_terms(
                r2s,
                hs[..., :, None], tse[..., :, None],
                nhs[..., None, :], ntse[..., None, :],
                q[..., :, None] if has_q else None,
                block(gq, dz, dy, dx)[..., None, :] if has_q else None,
                block(gaid, dz, dy, dx) if has_excl else None,
            )
            g = jnp.where(ok, mrE / r2s, 0.0)
            gdv = g[..., None] * dv
            forces = forces + jnp.sum(gdv, axis=-2)
            reaction = -jnp.sum(gdv, axis=-3)  # (mz, my, mx, C, 3)
            pad = [(1 + dz, 1 - dz), (1 + dy, 1 - dy), (1 + dx, 1 - dx), (0, 0), (0, 0)]
            react = react + jnp.pad(reaction, pad)
            if compute_energy:
                e_m = jnp.where(ok, e, 0.0)
                w_m = jnp.where(ok, mrE, 0.0)
                energies = energies + 0.5 * jnp.sum(e_m, axis=-1)
                virials = virials + 0.5 * jnp.sum(w_m, axis=-1)
                e_r = 0.5 * jnp.sum(e_m, axis=-2)
                w_r = 0.5 * jnp.sum(w_m, axis=-2)
                e_react = e_react + jnp.pad(e_r, pad[:-1])
                w_react = w_react + jnp.pad(w_r, pad[:-1])

        if ebind is not None:
            react = react + _term_force_grid(gx_, gy_, gz_, ebind)
        forces = forces + _fold3(react)
        if compute_energy:
            energies = energies + _fold3(e_react)
            virials = virials + _fold3(w_react)
            tpe = tvir = jnp.float32(0.0)
            if ebind is not None:
                tpe, tvir = _term_energy_virial(
                    _pos_ext_flat(gx_, gy_, gz_), ebind
                )
            return forces, energies, virials, tpe, tvir
        return forces

    def _aid_of(aid, valid):
        return jnp.where(valid, aid, -2).astype(jnp.float32)

    def _aux_of(aid):
        if not has_excl:
            return None
        idx = jnp.minimum(aid, n_tab)
        g = excl_packed[idx]
        return (
            g[..., :excl_e], g[..., excl_e : 2 * excl_e],
            g[..., 2 * excl_e : 3 * excl_e] if excl_cs else None,
        )

    def forces_of(pos, hs, tse, valid, q, aid, aux, ebind=None):
        aid_f = _aid_of(aid, valid) if has_excl else None
        return _local_forces_xla(
            pos, hs, tse, valid, q, aid_f, aux, compute_energy=False,
            ebind=ebind,
        )

    def pair_energy_of(pos, hs, tse, valid, q, aid, aux, ebind=None):
        aid_f = _aid_of(aid, valid) if has_excl else None
        _, e, w, tpe, tvir = _local_forces_xla(
            pos, hs, tse, valid, q, aid_f, aux, compute_energy=True,
            ebind=ebind,
        )
        return e, w, tpe, tvir

    # ---- per-shard shift rebin ----

    def _nbr_factory(axis):
        """nbr(x, δ) for `_route_axis_pass`: content of the δ=±1 grid-axis
        neighbor cell, for (cells_loc, C) or (cells_loc,) arrays — one halo
        ppermute when the mesh axis is sharded, a local roll otherwise."""
        locs = (mz, my, mx)
        nloc = locs[axis]
        size = sizes[axis]

        def nbr(x, d):
            shaped = x.reshape((mz, my, mx) + x.shape[1:])
            if size == 1:
                out = jnp.roll(shaped, -d, axis=axis)
            elif d == +1:
                # Content of my +1 cell: local rows 1.. plus the +neighbor's
                # first layer (each device sends its first layer downward).
                main = jax.lax.slice_in_dim(shaped, 1, nloc, axis=axis)
                send = jax.lax.slice_in_dim(shaped, 0, 1, axis=axis)
                hi = jax.lax.ppermute(
                    send, AXES[axis], [(i, (i - 1) % size) for i in range(size)]
                )
                out = jnp.concatenate([main, hi], axis=axis)
            else:
                main = jax.lax.slice_in_dim(shaped, 0, nloc - 1, axis=axis)
                send = jax.lax.slice_in_dim(shaped, nloc - 1, nloc, axis=axis)
                lo = jax.lax.ppermute(
                    send, AXES[axis], [(i, (i + 1) % size) for i in range(size)]
                )
                out = jnp.concatenate([lo, main], axis=axis)
            return out.reshape(x.shape)

        return nbr

    def _b_global(axis):
        """(cells_loc,) global cell coordinate along one grid axis."""
        locs = (mz, my, mx)
        base = jax.lax.axis_index(AXES[axis]) * locs[axis]
        ar = base + jnp.arange(locs[axis], dtype=jnp.int32)
        shape = [1, 1, 1]
        shape[axis] = locs[axis]
        grid = ar.reshape(shape) * jnp.ones((mz, my, mx), jnp.int32)
        return grid.reshape(mz * my * mx)

    def _rebin_local(pos, vel, inv_m, hs, tse, aid, valid, overflow, forces, q):
        """Per-shard shift rebin: three ±1 routing passes (z, y, x), each
        pass's cross-shard candidate layers delivered by one ppermute pair —
        atom migration between shards costs the same as a halo exchange.

        forces=None (the leapfrog NVE path) routes 3 fewer fields through
        the bandwidth-bound log-shift rounds; new_f is then None."""
        ncl = mz * my * mx
        flat = lambda a: a.reshape((ncl,) + a.shape[3:])
        posf = flat(pos)
        validf = flat(valid)
        box = _box()
        posw = jnp.where(validf[..., None], posf - jnp.floor(posf / box) * box, 0.0)
        fields = [posw[..., 0], posw[..., 1], posw[..., 2]]
        fields += [flat(vel)[..., i] for i in range(3)]
        fields += [flat(inv_m), flat(hs), flat(tse)]
        q_col = None
        if q is not None:
            q_col = len(fields)
            fields.append(flat(q))
        f_col = None
        if forces is not None:
            f_col = len(fields)
            fields += [flat(forces)[..., i] for i in range(3)]
        fields.append(flat(aid))
        nf = len(fields)
        # Pass order z, y, x — matches the single-chip `_rebin_shift`, so
        # slot order (and with it f32 summation order) is identical.
        for axis in (0, 1, 2):
            cf = _COORD_OF_AXIS[axis]
            fields, validf, overflow = _route_axis_pass(
                fields, validf, overflow, cf, _b_global(axis), m, config,
                spill_eps, _nbr_factory(axis), box=box,
            )
        unflat = lambda a: a.reshape((mz, my, mx) + a.shape[1:])
        new_pos = jnp.stack(fields[0:3], axis=-1)
        new_pos = jnp.where(validf[..., None], new_pos, 0.0)
        zero = lambda a: jnp.where(validf, a, 0.0)
        new_vel = jnp.where(validf[..., None], jnp.stack(fields[3:6], axis=-1), 0.0)
        new_f = None
        if f_col is not None:
            new_f = unflat(jnp.where(
                validf[..., None], jnp.stack(fields[f_col : f_col + 3], axis=-1), 0.0
            ))
        new_aid = jnp.where(validf, fields[nf - 1], config.num_slots)
        new_q = None if q_col is None else unflat(zero(fields[q_col]))
        return (
            unflat(new_pos), unflat(new_vel), unflat(zero(fields[6])),
            unflat(zero(fields[7])), unflat(zero(fields[8])), unflat(new_aid),
            unflat(validf), overflow, new_f, unflat(new_pos), new_q,
        )

    def _needs_rebin_local(pos, ref, valid):
        box = _box()
        dvv = pos - ref
        dvv = dvv - jnp.round(dvv / box) * box
        d2 = jnp.sum(dvv * dvv, axis=-1)
        d2 = jnp.where(valid, d2, 0.0)
        return jnp.max(d2) > (0.5 * config.skin) ** 2

    def _all_reduce_or(flag):
        v = flag.astype(jnp.int32)
        for ax in AXES:
            v = jax.lax.pmax(v, ax)
        return v > 0

    # ---- rollout under one shard_map ----

    def _rollout_local(num_steps, rebin_every, pos, vel, inv_m, hs, tse, aid,
                       valid, ref, step, overflow, rng, boxv, q=None):
        box_cell[0] = boxv
        def make_one_step(inv_m, hs, tse, valid, q, aid, aux, ebind=None):
            from emdee_tpu.neighbors.cell_dense import LangevinConfig as _LC

            if isinstance(thermostat, _LC):
                # Per-shard-distinct noise: fold the linear shard index into
                # the (replicated) step key.
                shard_lin = (
                    jax.lax.axis_index(AXES[0]) * (sizes[1] * sizes[2])
                    + jax.lax.axis_index(AXES[1]) * sizes[2]
                    + jax.lax.axis_index(AXES[2])
                )
                kT = thermostat.kB * thermostat.temperature
                c1 = float(np.exp(-thermostat.friction * dt))
                c2 = float(np.sqrt((1.0 - c1 * c1) * kT))

                def one_step(carry, _):
                    pos, vel, f, key = carry
                    # BAOAB: kick, half drift, OU solve, half drift, kick.
                    v = vel + (0.5 * dt_f) * f * inv_m[..., None]
                    x = pos + (0.5 * dt_f) * v
                    key, sub = jax.random.split(key)
                    noise = jax.random.normal(
                        jax.random.fold_in(sub, shard_lin), v.shape, v.dtype
                    )
                    v = c1 * v + c2 * jnp.sqrt(inv_m[..., None]) * noise
                    x = x + (0.5 * dt_f) * v
                    x = jnp.where(valid[..., None], x, pos)
                    f_new = forces_of(x, hs, tse, valid, q, aid, aux, ebind)
                    v_new = v + (0.5 * dt_f) * f_new * inv_m[..., None]
                    v_new = jnp.where(valid[..., None], v_new, 0.0)
                    return (x, v_new, f_new, key), None

                return one_step

            def one_step(carry, _):
                pos, vel, f, key = carry
                v_half = vel + (0.5 * dt_f) * f * inv_m[..., None]
                new_pos = pos + dt_f * v_half
                new_pos = jnp.where(valid[..., None], new_pos, pos)
                f_new = forces_of(new_pos, hs, tse, valid, q, aid, aux, ebind)
                v_new = v_half + (0.5 * dt_f) * f_new * inv_m[..., None]
                if thermostat is not None:
                    from emdee_tpu.dynamics.bussi import _csvr_alpha2

                    kin = 0.5 * jnp.sum(
                        jnp.where(
                            valid[..., None],
                            v_new**2 / jnp.maximum(inv_m[..., None], 1e-30),
                            0.0,
                        )
                    )
                    for ax in AXES:
                        kin = jax.lax.psum(kin, ax)
                    key, sub = jax.random.split(key)
                    alpha2 = _csvr_alpha2(
                        sub, jnp.maximum(kin, 1e-30),
                        jnp.float32(3.0 * config.num_atoms - 3.0),
                        jnp.float32(thermostat.kB * thermostat.temperature),
                        dt_f, jnp.float32(thermostat.tau), jnp.float32,
                    )
                    v_new = jnp.sqrt(jnp.maximum(alpha2, 0.0)) * v_new
                return (new_pos, v_new, f_new, key), None

            return one_step

        def run_block(carry, length):
            pos, vel, inv_m, hs, tse, aid, valid, ref, overflow, f, q, key, boxv = carry
            box_cell[0] = boxv
            if barostat is not None:
                # Berendsen μ-rescale at the block boundary (the single-chip
                # engine's protocol, with the pressure psum'd over shards).
                ebind_b = _bind_terms(aid, valid)[0] if has_terms else None
                _e_l, w_l, _tpe, tvir = pair_energy_of(
                    pos, hs, tse, valid, q, aid, _aux_of(aid), ebind_b
                )
                pvk = jnp.stack([
                    jnp.sum(jnp.where(valid, w_l, 0.0)) + tvir,
                    0.5 * jnp.sum(jnp.where(
                        valid[..., None], vel**2 / jnp.maximum(inv_m[..., None], 1e-30), 0.0
                    )),
                ])
                for ax in AXES:
                    pvk = jax.lax.psum(pvk, ax)
                p_inst = (2.0 * pvk[1] + pvk[0]) / (3.0 * boxv**3)
                mu3 = 1.0 - (length * dt / barostat.tau) * barostat.kappa * (
                    barostat.pressure - p_inst
                )
                mu = jnp.clip(mu3, 0.9, 1.1) ** (1.0 / 3.0)
                boxv = boxv * mu
                box_cell[0] = boxv
                pos = pos * mu
                ref = ref * mu
                overflow = overflow | (
                    boxv < config.cells_per_dim * (config.cutoff + config.skin)
                )
            (pos, vel, inv_m, hs, tse, aid, valid, overflow, f, ref, q) = _rebin_local(
                pos, vel, inv_m, hs, tse, aid, valid, overflow, f, q
            )
            aux = _aux_of(aid)
            ebind = None
            if has_terms:
                ebind, bad = _bind_terms(aid, valid)
                overflow = overflow | bad
            (pos, vel, f, key), _ = jax.lax.scan(
                make_one_step(inv_m, hs, tse, valid, q, aid, aux, ebind),
                (pos, vel, f, key), None, length=length,
            )
            overflow = overflow | _needs_rebin_local(pos, ref, valid)
            return (pos, vel, inv_m, hs, tse, aid, valid, ref, overflow, f, q, key, boxv)

        def run_block_lf(carry, length):
            # Leapfrog NVE block (no thermostat/barostat): velocities ride a
            # half-step offset, each step is (drift, force, full kick), and
            # NO force field crosses the rebin — 3 fewer routed arrays in
            # the bandwidth-bound shift-rebin rounds (the single-chip
            # engine's same optimization, cell_dense.py rollout).
            pos, vel, inv_m, hs, tse, aid, valid, ref, overflow, q = carry
            (pos, vel, inv_m, hs, tse, aid, valid, overflow, _f, ref, q) = _rebin_local(
                pos, vel, inv_m, hs, tse, aid, valid, overflow, None, q
            )
            aux = _aux_of(aid)
            ebind = None
            if has_terms:
                ebind, bad = _bind_terms(aid, valid)
                overflow = overflow | bad

            def lf_step(c, _):
                pos, vel = c
                x = pos + dt_f * vel
                x = jnp.where(valid[..., None], x, pos)
                f = forces_of(x, hs, tse, valid, q, aid, aux, ebind)
                v = vel + dt_f * f * inv_m[..., None]
                v = jnp.where(valid[..., None], v, 0.0)
                return (x, v), None

            (pos, vel), _ = jax.lax.scan(lf_step, (pos, vel), None, length=length)
            overflow = overflow | _needs_rebin_local(pos, ref, valid)
            return (pos, vel, inv_m, hs, tse, aid, valid, ref, overflow, q)

        blocks, rem = divmod(num_steps, rebin_every)

        if thermostat is None and barostat is None and num_steps:
            ebind0 = None
            if has_terms:
                ebind0, bad0 = _bind_terms(aid, valid)
                overflow = overflow | bad0
            f0 = forces_of(pos, hs, tse, valid, q, aid, _aux_of(aid), ebind0)
            vel = jnp.where(
                valid[..., None], vel + (0.5 * dt_f) * f0 * inv_m[..., None], 0.0
            )
            carry = (pos, vel, inv_m, hs, tse, aid, valid, ref, overflow, q)
            if blocks:
                carry, _ = jax.lax.scan(
                    lambda cr, _: (run_block_lf(cr, rebin_every), None), carry,
                    None, length=blocks,
                )
            if rem:
                carry = run_block_lf(carry, rem)
            (pos, vel, inv_m, hs, tse, aid, valid, ref, overflow, q) = carry
            ebind1 = None
            if has_terms:
                ebind1, bad1 = _bind_terms(aid, valid)
                overflow = overflow | bad1
            f_end = forces_of(pos, hs, tse, valid, q, aid, _aux_of(aid), ebind1)
            vel = jnp.where(
                valid[..., None], vel - (0.5 * dt_f) * f_end * inv_m[..., None], 0.0
            )
            overflow = _all_reduce_or(overflow)
            q_out = q if q is not None else jnp.zeros((), jnp.float32)
            return (
                pos, vel, inv_m, hs, tse, aid, valid, ref, step + num_steps,
                overflow, boxv, q_out,
            )

        ebind0 = None
        if has_terms:
            ebind0, bad0 = _bind_terms(aid, valid)
            overflow = overflow | bad0
        f0 = forces_of(pos, hs, tse, valid, q, aid, _aux_of(aid), ebind0)
        carry = (pos, vel, inv_m, hs, tse, aid, valid, ref, overflow, f0, q, rng, boxv)
        if blocks:
            carry, _ = jax.lax.scan(
                lambda cr, _: (run_block(cr, rebin_every), None), carry, None,
                length=blocks,
            )
        if rem:
            carry = run_block(carry, rem)
        (pos, vel, inv_m, hs, tse, aid, valid, ref, overflow, f, q, _key, boxv) = carry
        overflow = _all_reduce_or(overflow)
        # A concrete dummy when chargeless: shard_map out_specs need a leaf.
        q_out = q if q is not None else jnp.zeros((), jnp.float32)
        return (
            pos, vel, inv_m, hs, tse, aid, valid, ref, step + num_steps,
            overflow, boxv, q_out,
        )

    @partial(jax.jit, static_argnames=("num_steps", "rebin_every"))
    def rollout(state: CellDenseState, num_steps: int, rebin_every: int = 10,
                rng=None):
        if has_q and state.charges is None:
            raise ValueError("coulomb model given but state has no charges")
        if thermostat is not None and rng is None:
            raise ValueError("a thermostatted rollout needs an rng key")
        if rng is None:
            rng = jax.random.PRNGKey(0)  # unused by the NVE step
        # Charges ride the rebin whenever the state carries them — even
        # LJ-only runs must keep them bound to the right slots.
        route_q = state.charges is not None
        from emdee_tpu.neighbors.cell_dense import _state_box

        boxv = _state_box(state, config)
        fn = jax.shard_map(
            partial(_rollout_local, num_steps, rebin_every),
            mesh=mesh,
            in_specs=(spec,) * 8 + (rep, rep, rep, rep) + ((spec,) if route_q else ()),
            out_specs=(spec,) * 8 + (rep, rep, rep) + ((spec,) if route_q else (rep,)),
            check_vma=False,
        )
        args = (
            state.positions, state.velocities, state.inv_masses, state.half_sigma,
            state.twice_sqrt_eps, state.atom_id, state.valid, state.ref_positions,
            state.step, state.overflow, rng, boxv,
        ) + ((state.charges,) if route_q else ())
        (pos, vel, inv_m, hs, tse, aid, valid, ref, step, overflow, box_out, q_out) = fn(*args)
        return state._replace(
            positions=pos, velocities=vel, inv_masses=inv_m, half_sigma=hs,
            twice_sqrt_eps=tse, atom_id=aid, valid=valid, ref_positions=ref,
            step=step, overflow=overflow,
            charges=q_out if route_q else None,
            box=box_out if (barostat is not None or state.box is not None) else state.box,
        )

    def _energy_local(pos, vel, inv_m, hs, tse, valid, aid, boxv, q=None):
        box_cell[0] = boxv
        ebind = _bind_terms(aid, valid)[0] if has_terms else None
        e, w, tpe, tvir = pair_energy_of(
            pos, hs, tse, valid, q, aid, _aux_of(aid), ebind
        )
        pe = jnp.sum(jnp.where(valid, e, 0.0)) + tpe
        vir = jnp.sum(jnp.where(valid, w, 0.0)) + tvir
        ke = 0.5 * jnp.sum(
            jnp.where(valid[..., None], vel**2 / jnp.maximum(inv_m[..., None], 1e-30), 0.0)
        )
        out = jnp.stack([pe, vir, ke])
        for ax in AXES:
            out = jax.lax.psum(out, ax)
        return out[0], out[1], out[2]

    @jax.jit
    def energy(state: CellDenseState):
        from emdee_tpu.neighbors.cell_dense import _state_box

        fn = jax.shard_map(
            _energy_local,
            mesh=mesh,
            in_specs=(spec,) * 7 + (rep,) + ((spec,) if has_q else ()),
            out_specs=(rep, rep, rep),
            check_vma=False,
        )
        args = (
            state.positions, state.velocities, state.inv_masses,
            state.half_sigma, state.twice_sqrt_eps, state.valid, state.atom_id,
            _state_box(state, config),
        ) + ((state.charges,) if has_q else ())
        return fn(*args)

    return rollout, energy
