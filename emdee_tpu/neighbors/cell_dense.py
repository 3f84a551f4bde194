"""Dense-cell force engine: the simulation lives in a cell-slot layout.

- Atoms live in a dense slot grid ``(M, M, M, C)`` (cell side h = L/M ≥
  cutoff + skin, capacity C a multiple of 8), built once per rebin — the
  same bin-and-sort as cell_list.py, but the *state* stays in this layout
  between rebins, so steps never reindex atoms.
- The pair pass runs either as XLA code (`cell_dense_forces`: the 27-cell
  neighbourhood enumerated with static ``jnp.roll`` shifts of the slot grid,
  Newton's third law across cells by rolling reactions back — a shift, not a
  scatter, the role atomicAdd plays in the reference, nonbonded.jl:88-104)
  or as the full-shell GPU kernel (`cell_pair_kernel.cell_pair_forces`).
  `resolve_dense_backend` picks one.

Per-atom energy/virial conventions match the reference (half-split,
nonbonded.jl:93-94): each computed pair contributes E/2 to both sides.

Rebinning is blocked (every `rebin_every` steps inside the scan, with a
skin/2 staleness check per block) rather than triggered per step: the scan
body stays free of data-dependent control flow, and the sticky flag makes a
too-long block visible instead of silently wrong.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from emdee_tpu.core.pbc import displacement, wrap_scaled
from emdee_tpu.core.types import LJParams
from emdee_tpu.potentials.lennard_jones import LennardJonesModel, pair_interaction


class CellDenseConfig(NamedTuple):
    """Static geometry of the dense-cell engine."""

    cells_per_dim: int  # M
    capacity: int  # C, slots per cell (multiple of 8)
    box: float
    cutoff: float
    switch: float
    skin: float
    num_atoms: int
    # Boundary-spill balancing (see `_rebin_shift`): lets capacity sit near
    # the mean occupancy instead of covering the 2.5σ tail.  Requires the
    # shift rebin and cell side > cutoff + skin.
    spill: bool = False
    # Squeeze mode: spill toward an occupancy ≤ spill_target < capacity
    # (0 → use capacity).  Lets a wide-capacity state be progressively
    # packed over successive rebins — thermal motion refreshes the
    # near-face eligible set each rebin — until `shrink_capacity` can
    # slice the empty columns off.
    spill_target: int = 0

    @property
    def num_cells(self) -> int:
        return self.cells_per_dim**3

    @property
    def num_slots(self) -> int:
        return self.num_cells * self.capacity

    @property
    def cell_side(self) -> float:
        return self.box / self.cells_per_dim


class CellDenseState(NamedTuple):
    """Simulation state in slot layout: leading dims (M³, C)."""

    positions: jax.Array  # (M³, C, 3)
    velocities: jax.Array  # (M³, C, 3)
    inv_masses: jax.Array  # (M³, C) — 0 for empty slots
    half_sigma: jax.Array  # (M³, C)
    twice_sqrt_eps: jax.Array  # (M³, C)
    atom_id: jax.Array  # (M³, C) int32, sentinel = num_slots for empty
    valid: jax.Array  # (M³, C) bool
    ref_positions: jax.Array  # (M³, C, 3) — positions at last rebin
    step: jax.Array  # () int32
    overflow: jax.Array  # () bool
    charges: Optional[jax.Array] = None  # (M³, C) — molecular systems only
    # Dynamic (NPT) box length; None → the static config.box.  Cell COUNT
    # stays static (M is compile-time); only the box/cell SIDE breathes.
    # Every traced consumer (binning, ghost shifts, minimum image) is pure
    # arithmetic in the box, so a traced scalar costs nothing.
    box: Optional[jax.Array] = None


def _state_box(state: "CellDenseState", config: "CellDenseConfig"):
    return jnp.float32(config.box) if state.box is None else state.box


class CSVRConfig(NamedTuple):
    """Bussi CSVR thermostat on the dense engine: one global velocity
    rescale per step (dynamics/bussi.py math in slot space)."""

    temperature: float
    tau: float
    kB: float = 1.0


class LangevinConfig(NamedTuple):
    """BAOAB Langevin thermostat on the dense engine (dynamics/langevin.py
    math in slot space; the mid-step drift does NOT wrap — the engine's
    no-wrap-between-rebins contract)."""

    temperature: float
    friction: float
    kB: float = 1.0


class BerendsenBarostatConfig(NamedTuple):
    """Berendsen weak pressure coupling on the dense engine, applied at REBIN
    boundaries: μ = (1 − (dt_block/τ)·κ·(P₀ − P))^{1/3} rescales positions
    and the dynamic state box once per block (dynamics/npt.py's per-step
    protocol, amortized to where the engine re-bins anyway).  Cell COUNT
    stays static; the sticky overflow flag trips if the box shrinks past
    M·(rc + skin) — re-derive the config via `suggest_cell_dense_config`
    and re-init (`cell_dense_init`) to continue from there."""

    pressure: float
    tau: float
    kappa: float = 1.0


def suggest_cell_dense_config(
    num_atoms: int,
    box: float,
    cutoff: float,
    switch: float,
    skin: float = 0.4,
    capacity_multiplier: Optional[float] = None,
    spill: bool = False,
    spill_margin: float = 0.15,
    cells_multiple_of: int = 1,
) -> CellDenseConfig:
    """Derive a dense-cell config (cells/dim, slot capacity) from geometry.

    `spill=True` selects boundary-spill balancing: slot capacity near the
    mean occupancy (mean+0.5σ instead of mean+2.5σ, and pair work scales as
    capacity²), paid for by a shift rebin that routes spilled atoms and
    hold-backs (`_route_axis_pass`).

    cells_multiple_of: round cells/dim DOWN to this multiple (a sharded run
    needs M divisible by every mesh axis; the cell side only grows, so the
    rc + skin bound still holds); capacity follows the rounded M."""
    m = int(np.floor(box / (cutoff + skin + (spill_margin if spill else 0.0))))
    m = (m // cells_multiple_of) * cells_multiple_of
    if m < 3:
        raise ValueError(
            f"box {box} holds only {m} cells of side ≥ {cutoff + skin}; "
            "use the all-pairs method for boxes this small"
        )
    mean_occ = num_atoms / m**3
    # 2.5σ margin: dense-liquid occupancy fluctuations are sub-Poisson
    # (repulsive cores anticorrelate; measured max 30 at mean 19.9 =
    # mean + 2.28·√mean over long equilibrated 100k-atom runs).  Pair work
    # scales as capacity², so the margin is deliberately tight: an
    # overflowing cell trips the sticky flag rather than silently
    # corrupting, and callers double capacity on retry.
    if capacity_multiplier is not None:
        import warnings

        warnings.warn(
            "capacity_multiplier is deprecated and ignored — capacity is set "
            "from the measured occupancy margin (mean + 2.5σ); pass a wider "
            "config via config._replace(capacity=...) if you need headroom",
            DeprecationWarning,
            stacklevel=2,
        )
    if spill:
        # Boundary-spill balancing (`_rebin_shift`) sheds the occupancy
        # tail into face-adjacent cells, so capacity only needs to cover
        # ~mean + 0.5σ.  Requires spill margin ε = h − rc − skin > 0,
        # reserved above via `spill_margin`.
        cap = int(np.ceil(mean_occ + 0.5 * np.sqrt(mean_occ) + 0.5))
    else:
        cap = int(np.ceil(mean_occ + 2.5 * np.sqrt(mean_occ) + 1.0))
    cap = -(-cap // 8) * 8
    return CellDenseConfig(
        cells_per_dim=m,
        capacity=cap,
        box=box,
        cutoff=cutoff,
        switch=switch,
        skin=skin,
        num_atoms=num_atoms,
        spill=spill,
    )


def suggest_rebin_interval(
    skin: float, dt: float, temperature: float, mass: float = 1.0, vmax_sigmas: float = 6.0
) -> int:
    """Steps between rebins such that even a `vmax_sigmas`-sigma atom stays
    within skin/2 of its bin-time position: K = (skin/2) / (vmax·dt).

    6σ is MEASURED, not paranoia: a 5σ default (25% fewer rebins) was tried
    and the per-block skin/2 staleness gate tripped at the 97k benchmark —
    an atom sustained ≥5.1σ across a block — so anything looser than ~6σ
    produces invalid runs.  The sticky overflow flag remains the backstop."""
    vmax = vmax_sigmas * np.sqrt(temperature / mass)
    return max(1, int(np.floor(0.5 * skin / (vmax * dt))))


def _half_shell_offsets() -> np.ndarray:
    """13 half-shell offsets of the 27-stencil (lexicographic upper half) —
    Newton-3 ownership, the cells.jl:31 'action' idea on a dense grid."""
    offs = []
    for vz in (-1, 0, 1):
        for vy in (-1, 0, 1):
            for vx in (-1, 0, 1):
                if (vz, vy, vx) > (0, 0, 0) or (vz > 0) or (vz == 0 and vy > 0) or (
                    vz == 0 and vy == 0 and vx > 0
                ):
                    offs.append((vx, vy, vz))
    return np.asarray(sorted(set(offs)), np.int32)


_OFFSETS = _half_shell_offsets()


# ---------------------------------------------------------------------------
# Binning: dense (N,)-arrays ↔ slot grid
# ---------------------------------------------------------------------------


def _bin_to_slots(positions, per_atom, config: CellDenseConfig, valid=None, cell_override=None):
    """Scatter per-atom arrays into the (M³, C) slot layout.

    positions: (K, 3); per_atom: dict name → (K, …) arrays; valid: optional
    (K,) bool — False rows (inert padding slots during a rebin) are routed to
    a virtual cell and dropped, so they can never displace real atoms.
    Returns slot arrays + overflow flag.  One argsort + one scatter — this is
    `build_cell_list` with the whole state riding along.
    """
    m, c = config.cells_per_dim, config.capacity
    n = positions.shape[0]
    num_cells = m**3
    if cell_override is not None:
        cell = jnp.asarray(cell_override, jnp.int32)
    else:
        s = wrap_scaled(positions / config.box)
        v = jnp.clip(jnp.floor(m * s).astype(jnp.int32), 0, m - 1)
        cell = v[:, 0] + m * (v[:, 1] + m * v[:, 2])
    if valid is not None:
        cell = jnp.where(valid, cell, num_cells)

    order = jnp.argsort(cell, stable=True).astype(jnp.int32)
    cell_sorted = cell[order]
    counts = jnp.zeros(num_cells + 1, jnp.int32).at[cell].add(1)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(n, dtype=jnp.int32) - starts[cell_sorted]
    dest = jnp.where(
        (cell_sorted < num_cells) & (rank < c), cell_sorted * c + rank, num_cells * c
    )

    def scatter(arr, fill):
        flat = jnp.full((num_cells * c,) + arr.shape[1:], fill, arr.dtype)
        flat = flat.at[dest].set(arr[order], mode="drop")
        return flat.reshape((num_cells, c) + arr.shape[1:])

    out = {name: scatter(arr, fill) for name, (arr, fill) in per_atom.items()}
    overflow = jnp.max(counts[:num_cells]) > c
    return out, overflow


def _rebin(
    state: CellDenseState, config: CellDenseConfig, forces: Optional[jax.Array] = None
):
    """Re-sort live slots into fresh cells (in-graph, fixed shapes): the
    sort rebin, which handles any displacement.

    - every NEW slot gathers its source — src(cell, rank) =
      order[start(cell) + rank] — instead of old slots scattering,
    - per-cell starts/counts come from `searchsorted` on the sorted keys and
      are expanded with structured `repeat`s (no cell-indexed gathers),
    - every per-slot field (incl. int32 atom ids, bitcast to f32, and
      optionally the current forces) rides ONE packed (slots, 10|13) gather.

    When `forces` is given, returns (state, permuted_forces) so a blocked
    rollout can keep integrating without re-evaluating forces after the
    permutation.
    """
    m, c = config.cells_per_dim, config.capacity
    num_cells = m**3
    ns = config.num_slots
    flat_pos = state.positions.reshape(ns, 3)
    valid = state.valid.reshape(ns)

    sbox = _state_box(state, config)
    s = wrap_scaled(flat_pos / sbox)
    v = jnp.clip(jnp.floor(m * s).astype(jnp.int32), 0, m - 1)
    cell = v[:, 0] + m * (v[:, 1] + m * v[:, 2])
    cell = jnp.where(valid, cell, num_cells)

    order = jnp.argsort(cell, stable=True).astype(jnp.int32)
    cell_sorted = cell[order]
    # Scatter-free per-cell starts/counts from the sorted keys.
    starts = jnp.searchsorted(
        cell_sorted, jnp.arange(num_cells + 1, dtype=jnp.int32)
    ).astype(jnp.int32)
    counts = (starts[1:] - starts[:-1]).astype(jnp.int32)
    overflow = jnp.max(counts) > c

    new_rank = jnp.tile(jnp.arange(c, dtype=jnp.int32), num_cells)
    starts_rep = jnp.repeat(starts[:num_cells], c)  # structured, not a gather
    counts_rep = jnp.repeat(counts, c)
    new_valid = new_rank < counts_rep
    src_sorted_pos = jnp.minimum(starts_rep + new_rank, ns - 1)
    src = order[src_sorted_pos]

    fields = [
        flat_pos,
        state.velocities.reshape(ns, 3),
        state.inv_masses.reshape(ns, 1),
        state.half_sigma.reshape(ns, 1),
        state.twice_sqrt_eps.reshape(ns, 1),
        jax.lax.bitcast_convert_type(state.atom_id.reshape(ns, 1), jnp.float32),
    ]
    q_col = None
    if state.charges is not None:
        q_col = sum(f.shape[1] for f in fields)
        fields.append(state.charges.reshape(ns, 1))
    f_col = sum(f.shape[1] for f in fields)
    if forces is not None:
        fields.append(forces.reshape(ns, 3))
    packed = jnp.concatenate(fields, axis=1)
    moved = jnp.where(new_valid[:, None], packed[src], 0.0)
    # Wrap positions into [0, L) here (and only here): between rebins the
    # integrator leaves them unwrapped so the kernel's raw ghost-shifted
    # differences stay valid.
    moved = moved.at[:, 0:3].set(
        jnp.where(
            new_valid[:, None],
            moved[:, 0:3] - jnp.floor(moved[:, 0:3] / sbox) * sbox,
            0.0,
        )
    )
    new_ids = jnp.where(
        new_valid,
        jax.lax.bitcast_convert_type(moved[:, 9], jnp.int32),
        config.num_slots,
    )

    new_pos = moved[:, 0:3].reshape(num_cells, c, 3)
    new_state = CellDenseState(
        positions=new_pos,
        velocities=moved[:, 3:6].reshape(num_cells, c, 3),
        inv_masses=moved[:, 6].reshape(num_cells, c),
        half_sigma=moved[:, 7].reshape(num_cells, c),
        twice_sqrt_eps=moved[:, 8].reshape(num_cells, c),
        atom_id=new_ids.reshape(num_cells, c),
        valid=new_valid.reshape(num_cells, c),
        ref_positions=new_pos,
        step=state.step,
        overflow=state.overflow | overflow,
        charges=None if q_col is None else moved[:, q_col].reshape(num_cells, c),
        box=state.box,
    )
    if forces is None:
        return new_state
    return new_state, moved[:, f_col : f_col + 3].reshape(num_cells, c, 3)


def _route_axis_pass(fields, valid, overflow, cf, b, m, config, spill_eps, nbr, box=None):
    """One ±1-cell routing pass along one grid axis — the core of the shift
    rebin, shared by the single-chip (`_rebin_shift`) and grid-sharded
    (`distributed.grid_sharded`) engines.

    fields: list of (cells, C) arrays (fields[cf] is this pass's coordinate);
    b: (cells,) global cell coordinate along the axis; m: global cell count
    along the axis; nbr(x, δ): the δ∈{+1,−1} axis-neighbor's content of x for
    every cell row — a periodic `_roll_cells` on one chip, a halo `ppermute`
    across shards.  Returns (fields, valid, overflow) with each cell's
    candidates compacted back into C slots.

    Mechanics: arrival ranks = mask @ strict-upper-triangular as a bf16
    matrix product with f32 accumulation (0/1 operands are exact in bf16,
    and integer sums stay exact in f32 in any order); compaction of the
    3C-candidate window into C slots by log-shift rounds — each kept element
    slides left by s = index − rank lanes; s is non-decreasing along the
    window and destinations are strictly increasing, so moving every element
    by bit j of its own s (LSB→MSB, one `roll`+`where` per bit) is provably
    collision-free.  Pure lane shifts and selects: bit-exact transport, no
    gathers, no scatters.
    """
    c = config.capacity
    k = 3 * c
    box = jnp.float32(config.box) if box is None else box
    sut = jnp.asarray(np.triu(np.ones((k, k), np.float32), 1), jnp.bfloat16)
    slot_iota = jnp.arange(c, dtype=jnp.int32)
    cand_iota = jnp.arange(k, dtype=jnp.int32)
    n_bits = max(1, int(np.ceil(np.log2(k))))

    coord = fields[cf]  # (cells, C)
    t = jnp.clip(jnp.floor(m * wrap_scaled(coord / box)).astype(jnp.int32), 0, m - 1)
    d = jnp.where(valid, (t - b[:, None]) % m, 0)
    legal = (d == 0) | (d == 1) | (d == m - 1)
    overflow = overflow | jnp.any(valid & ~legal)
    g_minus = valid & (d == m - 1)  # target = b − 1
    g_stay = valid & (d == 0)
    g_plus = valid & (d == 1)  # target = b + 1

    if config.spill and spill_eps > 0.0:
        # Boundary-spill balancing: over-capacity cells re-route stayers
        # that sit within `spill_eps` of the +face of this pass's axis
        # into the next cell.  Spills are ONE-directional (+face only):
        # with bidirectional spills two atoms can leave the same true
        # cell in opposite directions, landing in stored cells two apart
        # while within cutoff (a silently missed pair).  One-directional,
        # the worst case across a 2-cell stored gap is an unspilled atom
        # vs a +spilled one: axis separation ≥ h − ε − skin, which is
        # ≥ rc exactly when ε ≤ h − rc − skin — how `spill_eps` is
        # defined.  This lets capacity sit near mean+0.5σ instead of
        # mean+2.5σ; pair work ~C², so the occupancy tail is the
        # difference between C=32 and C=24 at the 100k benchmark.
        c_t = config.spill_target or c  # squeeze mode targets below capacity
        sums = lambda a: jnp.sum(a, axis=1, dtype=jnp.int32)
        count0 = (
            nbr(sums(g_plus), -1) + sums(g_stay) + nbr(sums(g_minus), +1)
        )  # arrivals per dest cell before spilling
        excess = jnp.maximum(count0 - c_t, 0)
        # Room in cell b+1 from pre-spill counts: a cell that itself
        # sheds has room 0 and receives nothing; shedding only frees
        # space, so pre-spill room is conservative.
        room = jnp.maximum(c_t - count0, 0)
        budget_plus = nbr(room, +1)
        frac = m * wrap_scaled(coord / box) - t.astype(coord.dtype)
        eps_frac = spill_eps / float(config.cell_side)
        elig_plus = g_stay & (frac > 1.0 - eps_frac)
        csum = lambda e: jnp.cumsum(e, axis=1) - e  # exclusive, in-cell
        n_plus = jnp.minimum(jnp.minimum(excess, budget_plus), sums(elig_plus))
        spill_p = elig_plus & (csum(elig_plus) < n_plus[:, None])
        g_stay = g_stay & ~spill_p
        g_plus = g_plus | spill_p
        # Hold-backs: a −1 mover (true cell = b−1) still within ε of the
        # face it crossed may stay stored in b — the SAME one-directional
        # contract (stored = true or true+1), viewed from the other side.
        # Recent down-crossers are almost always within drift ≤ skin/2 ≲ ε
        # of the face, so holds roughly double the shedding eligibility.
        # From dest cell q's view a hold in q+1 removes one arrival exactly
        # like a spill from q, so both share the excess/room budget.
        elig_hold = g_minus & (frac > 1.0 - eps_frac)
        n_hold = jnp.minimum(
            jnp.minimum(excess - n_plus, budget_plus - n_plus),
            nbr(sums(elig_hold), +1),
        )
        n_hold_here = nbr(n_hold, -1)  # my own holds, decided by cell b−1
        hold_p = elig_hold & (csum(elig_hold) < n_hold_here[:, None])
        g_minus = g_minus & ~hold_p
        g_stay = g_stay | hold_p
        # A spill/hold across the periodic boundary must store an unwrapped
        # coordinate coherent with the stored cell's frame (the force
        # kernel's ghost copies shift by ±L per CELL index, assuming
        # positions sit near their stored cell) — exactly the same
        # overhang contract as inter-rebin drift.
        wrap_p = spill_p & (b == m - 1)[:, None]
        wrap_h = hold_p & (b == 0)[:, None]
        fields[cf] = jnp.where(
            wrap_p | wrap_h, coord - box, fields[cf]
        )

    # Dest cell q's candidates: [q−1's g_plus, q's g_stay, q+1's g_minus].
    mask = jnp.concatenate([nbr(g_plus, -1), g_stay, nbr(g_minus, +1)], axis=1)
    cand = [
        jnp.concatenate([nbr(f, -1), f, nbr(f, +1)], axis=1) for f in fields
    ]

    rank = jax.lax.dot_general(
        mask.astype(jnp.bfloat16), sut, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    ).astype(jnp.int32)  # exclusive prefix counts — exact integers
    counts = jnp.sum(mask, axis=1, dtype=jnp.int32)  # (cells,)
    overflow = overflow | (jnp.max(counts) > c)

    # Left-shift distance per kept candidate; 0 for junk lanes.
    s = jnp.where(mask, cand_iota[None, :] - rank, 0)
    # Per-field roll+select rounds; each field stays its own array, so XLA
    # fuses one field's whole round chain instead of moving a packed array
    # of every field once per round.
    for j in range(n_bits):
        sh = 1 << j
        moving = (s & sh) != 0
        # An element arrives at lane l from lane l+2ʲ — unless the
        # source index wrapped around the (circular) roll.
        arrive = jnp.roll(moving, -sh, axis=1) & (cand_iota[None, :] < k - sh)
        cand = [jnp.where(arrive, jnp.roll(f, -sh, axis=1), f) for f in cand]
        s = jnp.where(arrive, jnp.roll(s, -sh, axis=1) - sh, s)
        # Vacated lanes keep a stale copy of the mover; zero its shift
        # so the duplicate never moves again (it then either gets
        # overwritten by the true occupant's later arrival or lies
        # beyond the kept [0, C) window).
        s = jnp.where(moving & ~arrive, 0, s)
    fields = [f[:, :c] for f in cand]
    valid = slot_iota[None, :] < counts[:, None]
    return fields, valid, overflow


def _rebin_shift(
    state: CellDenseState,
    config: CellDenseConfig,
    forces: Optional[jax.Array] = None,
    uniform_params=None,
    uniform_mass: Optional[float] = None,
):
    """Incremental rebin: three axis passes of ±1-cell routing.

    Between rebins every atom moves less than skin/2 < cell side (the same
    staleness bound `_needs_rebin` enforces), so its new cell is within the
    27-neighborhood of its current cell.  Factorized per axis, routing is
    between x±1, then y±1, then z±1 cells only — 3·C candidates per cell —
    and each pass is dense math (`_route_axis_pass`; the reference's
    incremental `update_cells!` chain, cells.jl:196-222, splices linked
    lists instead):

    - candidate tiles via static `jnp.roll` (PBC for free, no indices),
    - arrival ranks as exact integer prefix sums,
    - compaction of the 3C-candidate window into C slots by log-shift
      rounds — bit-exact transport, no gathers, no scatters,
    - atoms that moved further than one cell on any axis, or past cell
      capacity, are dropped with the sticky overflow flag set (callers
      re-init via `cell_dense_init`, which handles arbitrary states).

    Each atom lands in the same cell with the same payload as under the
    sort rebin `_rebin`; the order of atoms within a cell may differ.
    """
    m, c = config.cells_per_dim, config.capacity
    nc = m**3
    box = _state_box(state, config)
    valid = state.valid

    # Wrap positions into [0, L) here (and only here): between rebins the
    # integrator leaves them unwrapped so the force pass's ghost-shifted
    # differences stay valid.
    pos = state.positions
    pos = jnp.where(valid[..., None], pos - jnp.floor(pos / box) * box, 0.0)

    # Scalar transported fields, each (nc, C) so lane rolls stay on the
    # minor axis.  atom_id rides as int32 (selects are type-agnostic).
    # Uniform per-atom constants (LJ params, mass) are NOT routed — they are
    # reconstructed from the new valid mask afterwards.
    fields = [pos[..., 0], pos[..., 1], pos[..., 2]]
    fields += [state.velocities[..., i] for i in range(3)]
    im_col = hs_col = None
    if uniform_mass is None:
        im_col = len(fields)
        fields.append(state.inv_masses)
    if uniform_params is None:
        hs_col = len(fields)
        fields += [state.half_sigma, state.twice_sqrt_eps]
    q_col = None
    if state.charges is not None:
        q_col = len(fields)
        fields.append(state.charges)
    f_col = len(fields)
    if forces is not None:
        fields += [forces[..., i] for i in range(3)]
    fields.append(state.atom_id)
    nf = len(fields)

    spill_eps = float(config.cell_side) - float(config.cutoff) - float(config.skin)
    overflow = state.overflow
    # Passes over the (z, y, x) cell grid axes; `off` is the +1 cell offset
    # in `_roll_cells`'s (ox, oy, oz) convention, `cf` the position
    # component (x=0, y=1, z=2) binned by this pass.
    cell_ids = jnp.arange(nc, dtype=jnp.int32)
    for axis, off, cf in ((0, (0, 0, 1), 2), (1, (0, 1, 0), 1), (2, (1, 0, 0), 0)):
        # Cell's own coordinate along this axis (id = x + M·(y + M·z)).
        b = {2: cell_ids % m, 1: (cell_ids // m) % m, 0: cell_ids // (m * m)}[axis]
        nbr = lambda x, d, off=off: _roll_cells(x, tuple(d * o for o in off), m)
        fields, valid, overflow = _route_axis_pass(
            fields, valid, overflow, cf, b, m, config, spill_eps, nbr, box=box
        )

    new_pos = jnp.stack(fields[0:3], axis=-1)
    new_pos = jnp.where(valid[..., None], new_pos, 0.0)
    zero = lambda a: jnp.where(valid, a, 0.0)
    const = lambda v: jnp.where(valid, jnp.float32(v), 0.0)
    new_state = CellDenseState(
        positions=new_pos,
        velocities=jnp.where(
            valid[..., None], jnp.stack(fields[3:6], axis=-1), 0.0
        ),
        inv_masses=zero(fields[im_col]) if im_col is not None else const(1.0 / uniform_mass),
        half_sigma=zero(fields[hs_col]) if hs_col is not None else const(uniform_params[0]),
        twice_sqrt_eps=zero(fields[hs_col + 1]) if hs_col is not None else const(uniform_params[1]),
        atom_id=jnp.where(valid, fields[nf - 1], config.num_slots),
        valid=valid,
        ref_positions=new_pos,
        step=state.step,
        overflow=overflow,
        charges=None if q_col is None else zero(fields[q_col]),
        box=state.box,
    )
    if forces is None:
        return new_state
    new_forces = jnp.where(
        valid[..., None], jnp.stack(fields[f_col : f_col + 3], axis=-1), 0.0
    )
    return new_state, new_forces


def _spill_assign_np(positions, config: CellDenseConfig):
    """Init-time one-directional boundary spill (host-side, numpy).

    Greedy +face routing of overfull cells' near-face atoms into their +axis
    neighbor — the same geometry contract as `_rebin_shift`'s spill (stored
    cell ≤ ε past an atom's true cell along +axis only).  Returns
    (cell ids, coordinate array with periodic-seam spills shifted by −L, ok).
    """
    m, cap = config.cells_per_dim, config.capacity
    box, h = float(config.box), float(config.cell_side)
    eps = h - float(config.cutoff) - float(config.skin)
    pos = np.asarray(positions, np.float64)
    s = pos / box - np.floor(pos / box)
    v = np.clip(np.floor(m * s).astype(np.int64), 0, m - 1)
    frac = m * s - v
    true_cell = (v[:, 0] + m * (v[:, 1] + m * v[:, 2])).astype(np.int64)
    cell = true_cell.copy()
    pos_out = np.asarray(positions, np.float32).copy()
    counts = np.bincount(cell, minlength=m**3)
    if eps <= 0.0:
        return cell.astype(np.int32), pos_out, bool(counts.max() <= cap)
    strides = (1, m, m * m)
    # Iterate until converged: shedding can cascade (a receiving cell sheds
    # its own near-face atoms next round), which the runtime spill gets for
    # free across successive rebins.  Only unspilled atoms (stored == true)
    # are eligible — stored may only ever be true or true+1 along each axis.
    for _ in range(16):
        progressed = False
        for ax in (0, 1, 2):
            over = np.flatnonzero(counts > cap)
            if not over.size:
                break
            stride = strides[ax]
            for cid in over:
                need = int(counts[cid] - cap)
                if need <= 0:
                    continue
                coord_ax = (cid // stride) % m
                ncid = cid + stride if coord_ax < m - 1 else cid - (m - 1) * stride
                room = int(cap - counts[ncid])
                if room <= 0:
                    continue
                members = np.flatnonzero((cell == cid) & (true_cell == cid))
                elig = members[frac[members, ax] > 1.0 - eps / h]
                elig = elig[np.argsort(-frac[elig, ax])][: min(need, room)]
                if not elig.size:
                    continue
                cell[elig] = ncid
                counts[cid] -= elig.size
                counts[ncid] += elig.size
                progressed = True
                if coord_ax == m - 1:  # periodic seam: store a coherent coord
                    pos_out[elig, ax] -= box
        if counts.max() <= cap or not progressed:
            break
    return cell.astype(np.int32), pos_out, bool(counts.max() <= cap)


def shrink_capacity(state: CellDenseState, config: CellDenseConfig, new_capacity: int):
    """Slice the slot-column axis down to `new_capacity` after a spill
    squeeze has emptied the upper columns (compaction always packs valid
    slots first, so occupancy ≤ new_capacity ⟺ columns ≥ new_capacity are
    empty).  Returns (state, config) at the new capacity; raises if any
    upper-column slot is still occupied."""
    if new_capacity >= config.capacity:
        return state, config
    leftover = int(np.asarray(state.valid)[:, new_capacity:].sum())
    if leftover:
        raise ValueError(
            f"{leftover} atoms still stored beyond capacity {new_capacity} — "
            "squeeze has not converged (run more rebins with spill_target set)"
        )
    cut = lambda a: a[:, :new_capacity]
    return (
        CellDenseState(
            positions=cut(state.positions),
            velocities=cut(state.velocities),
            inv_masses=cut(state.inv_masses),
            half_sigma=cut(state.half_sigma),
            twice_sqrt_eps=cut(state.twice_sqrt_eps),
            atom_id=cut(state.atom_id),
            valid=cut(state.valid),
            ref_positions=cut(state.ref_positions),
            step=state.step,
            overflow=state.overflow,
            charges=None if state.charges is None else cut(state.charges),
            box=state.box,
        ),
        config._replace(capacity=new_capacity, spill_target=0),
    )


def cell_dense_init(
    positions,
    velocities,
    masses,
    params: LJParams,
    config: CellDenseConfig,
    charges=None,
) -> CellDenseState:
    """Host entry: pack (N, …) arrays into slot layout (with overflow retry
    left to the caller via the flag).

    Input positions may lie outside [0, L) (PDB files routinely do); they
    are binned from the raw values and STORED wrapped — the same convention
    as every rebin — so the engine contract (stored coordinates consistent
    with the assigned cell, raw ghost-shifted differences valid) holds from
    step 0.  The XLA backend min-images every delta and never notices, but
    the GPU kernel's image shifts and the grid-sharded halo shifts rely on
    it: an atom at x = L + ε binned to cell 0 but stored unwrapped sits a
    full box away from its seam neighbors and silently loses those pairs."""
    n = positions.shape[0]
    cell_override = None
    if config.spill:
        p64 = np.asarray(positions, np.float64)
        positions = p64 - np.floor(p64 / config.box) * config.box
        cell_ids, positions, _ = _spill_assign_np(positions, config)
        cell_override = jnp.asarray(cell_ids)
    positions = jnp.asarray(positions, jnp.float32)
    stored_pos = positions - jnp.floor(positions / config.box) * config.box
    per_atom = {
        "positions": (stored_pos, 0.0),
        "velocities": (jnp.asarray(velocities, jnp.float32), 0.0),
        "inv_masses": (1.0 / jnp.asarray(masses, jnp.float32), 0.0),
        "half_sigma": (jnp.asarray(params.half_sigma, jnp.float32), 0.0),
        "twice_sqrt_eps": (jnp.asarray(params.twice_sqrt_eps, jnp.float32), 0.0),
        "atom_id": (jnp.arange(n, dtype=jnp.int32), config.num_slots),
        "valid": (jnp.ones(n, bool), False),
    }
    if charges is not None:
        per_atom["charges"] = (jnp.asarray(charges, jnp.float32), 0.0)
    out, overflow = _bin_to_slots(positions, per_atom, config, cell_override=cell_override)
    return CellDenseState(
        positions=out["positions"],
        velocities=out["velocities"],
        inv_masses=jnp.where(out["valid"], out["inv_masses"], 0.0),
        half_sigma=out["half_sigma"],
        twice_sqrt_eps=out["twice_sqrt_eps"],
        atom_id=jnp.where(out["valid"], out["atom_id"], config.num_slots),
        valid=out["valid"],
        ref_positions=out["positions"],
        step=jnp.asarray(0, jnp.int32),
        overflow=overflow,
        charges=out["charges"] if charges is not None else None,
    )


# ---------------------------------------------------------------------------
# The gather-free force pass
# ---------------------------------------------------------------------------


def _roll_cells(grid: jax.Array, offset, m: int) -> jax.Array:
    """Neighbor block for a cell offset: roll the (M³, C, …) slot grid so
    that cell c's row holds cell (c+offset)'s content, PBC-wrapped."""
    shaped = grid.reshape((m, m, m) + grid.shape[1:])  # (Mz? no: x fastest)
    # Cell id = x + M·(y + M·z) → reshape gives axes (z, y, x).
    rolled = jnp.roll(
        shaped, shift=(-int(offset[2]), -int(offset[1]), -int(offset[0])), axis=(0, 1, 2)
    )
    return rolled.reshape(grid.shape)


@partial(jax.jit, static_argnames=("config", "compute_energy"))
def cell_dense_forces(
    state: CellDenseState,
    model: LennardJonesModel,
    config: CellDenseConfig,
    coulomb=None,
    excl=None,
    *,
    compute_energy: bool = False,
):
    """Forces (+ per-slot energies/virials) for every live slot.

    Structure: one full C×C self-cell tile (each intra-cell pair evaluated
    from both sides — no Newton needed) plus one (M³, C, 13·C) tile of the
    13 half-shell neighbour cells, with Newton-3 reaction accumulation via
    reverse rolls.  One wide tile is the fastest grouping on the GPU: fewer
    fusions outweigh the larger intermediates (docs/PERF.md).  This is also the plain reference the GPU kernel is checked
    against.

    With `coulomb` (a DSFCoulomb model) and state.charges set, DSF
    electrostatics ride the same tiles — the typed/charged-System bridge the
    reference never connected (modelling.jl:323-349 vs its compute layer).

    excl: optional slot-space exclusion tags (ids, mlj, mcs): ids (M³, C, E)
    f32 partner ATOM ids (−1 pad), mlj/mcs (M³, C, E) the 1−scale weights.
    Each pair compares the neighbor's atom id against the center's E tags —
    exclusions without masks, gathers or a correction pass.
    """
    m, c = config.cells_per_dim, config.capacity
    box = _state_box(state, config)
    pos = state.positions
    hs = state.half_sigma
    tse = state.twice_sqrt_eps
    q = state.charges if coulomb is not None else None
    valid = state.valid
    nc = m**3
    if coulomb is not None and state.charges is None:
        raise ValueError("coulomb model given but state has no charges")
    aid_f = None
    if excl is not None:
        # Neighbor-side atom ids as exact-in-f32 integers; invalid → −2
        # (never matches the −1 pad or any real id).  Missing Coulomb
        # scales default to the LJ scales (the correction-pass convention).
        if coulomb is not None and excl[2] is None:
            excl = (excl[0], excl[1], excl[1])
        aid_f = jnp.where(valid, state.atom_id, -2).astype(jnp.float32)

    def pair_terms(r2s, ok, hs_i, tse_i, hs_j, tse_j, q_i=None, q_j=None, aid_j=None):
        e, mrE = pair_interaction(r2s, model, hs_i, tse_i, hs_j, tse_j)
        csc = None
        if excl is not None:
            ids_e, mlj_e, mcs_e = excl  # (M³, C, E) each
            match = ids_e[:, :, None, :] == aid_j[:, None, :, None]
            ljsc = 1.0 - jnp.sum(
                jnp.where(match, mlj_e[:, :, None, :], 0.0), axis=-1
            )
            e = e * ljsc
            mrE = mrE * ljsc
            if q is not None:
                csc = 1.0 - jnp.sum(
                    jnp.where(match, mcs_e[:, :, None, :], 0.0), axis=-1
                )
        if q is not None:
            from emdee_tpu.potentials.coulomb import coulomb_interaction

            e_c, mre_c = coulomb_interaction(r2s, coulomb, q_i, q_j)
            if csc is not None:
                e_c = e_c * csc
                mre_c = mre_c * csc
            e = e + e_c
            mrE = mrE + mre_c
        return jnp.where(ok, e, 0.0), jnp.where(ok, mrE, 0.0)

    forces = jnp.zeros_like(pos)
    energies = jnp.zeros_like(hs) if compute_energy else None
    virials = jnp.zeros_like(hs) if compute_energy else None

    # ---- self-cell tile: (M³, C, C), both directions, mask i==j ----
    # Differences of raw coordinates, then the minimum image: scaling the
    # coordinates themselves by 1/L first would cost their absolute
    # precision (an ulp of L, ~1e-5 σ at the 1M-atom box) on every pair.
    dv = displacement(pos[:, :, None, :], pos[:, None, :, :], box)
    r2 = jnp.sum(dv * dv, axis=-1)
    eye = jnp.eye(c, dtype=bool)
    ok = valid[:, :, None] & valid[:, None, :] & ~eye[None]
    r2s = jnp.where(ok, r2, 1.0)
    e, mrE = pair_terms(
        r2s, ok, hs[:, :, None], tse[:, :, None], hs[:, None, :], tse[:, None, :],
        q[:, :, None] if q is not None else None,
        q[:, None, :] if q is not None else None,
        aid_f,
    )
    forces = forces + jnp.sum((mrE / r2s)[..., None] * dv, axis=2)
    if compute_energy:
        energies = energies + 0.5 * jnp.sum(e, axis=2)
        virials = virials + 0.5 * jnp.sum(mrE, axis=2)

    # ---- half shell: one (M³, C, 13·C) tile with reaction rolls ----
    nbr = lambda a: jnp.concatenate([_roll_cells(a, o, m) for o in _OFFSETS], axis=1)
    nbr_pos = nbr(pos)  # (M³, 13·C, 3)
    nbr_q = nbr(q) if q is not None else None
    nbr_aid = nbr(aid_f) if aid_f is not None else None
    dv = displacement(pos[:, :, None, :], nbr_pos[:, None, :, :], box)
    r2 = jnp.sum(dv * dv, axis=-1)  # (M³, C, 13·C)
    ok = valid[:, :, None] & nbr(valid)[:, None, :]
    r2s = jnp.where(ok, r2, 1.0)
    e, mrE = pair_terms(
        r2s, ok, hs[:, :, None], tse[:, :, None],
        nbr(hs)[:, None, :], nbr(tse)[:, None, :],
        q[:, :, None] if q is not None else None,
        nbr_q[:, None, :] if q is not None else None,
        nbr_aid,
    )
    # Materialize only the per-pair scalar g = (−r·E′)/r² and let each
    # reduction re-derive g·dv — keeping the (…, 13·C, 3) force-vector
    # tensor out of device memory: a tensor consumed by two reductions
    # (center sum + Newton reaction sum) is not fused away by XLA.
    g = jnp.where(ok, mrE / r2s, 0.0)
    gdv = g[..., None] * dv
    forces = forces + jnp.sum(gdv, axis=2)
    # Reaction: −f summed over the center axis, rolled back onto owners.
    reaction = -jnp.sum(gdv, axis=1)  # (M³, 13·C, 3)
    for k, o in enumerate(_OFFSETS):
        forces = forces + _roll_cells(reaction[:, k * c : (k + 1) * c], -o, m)
    if compute_energy:
        e = jnp.where(ok, e, 0.0)
        mrE = jnp.where(ok, mrE, 0.0)
        energies = energies + 0.5 * jnp.sum(e, axis=2)
        virials = virials + 0.5 * jnp.sum(mrE, axis=2)
        e_r = 0.5 * jnp.sum(e, axis=1)
        w_r = 0.5 * jnp.sum(mrE, axis=1)
        for k, o in enumerate(_OFFSETS):
            energies = energies + _roll_cells(e_r[:, k * c : (k + 1) * c], -o, m)
            virials = virials + _roll_cells(w_r[:, k * c : (k + 1) * c], -o, m)

    if compute_energy:
        return forces, energies, virials
    return forces, None, None


# ---------------------------------------------------------------------------
# Integration in slot space
# ---------------------------------------------------------------------------


def _needs_rebin(state: CellDenseState, config: CellDenseConfig) -> jax.Array:
    sbox = _state_box(state, config)
    dv = state.positions - state.ref_positions
    dv = dv - jnp.round(dv / sbox) * sbox
    d2 = jnp.sum(dv * dv, axis=-1)
    d2 = jnp.where(state.valid, d2, 0.0)
    return jnp.max(d2) > (0.5 * config.skin) ** 2


def detect_uniform_params(params: LJParams):
    """Host-side check: if every atom shares one (σ/2, 2√ε), return that pair
    as floats for the kernel's static uniform fast path, else None."""
    hs = np.asarray(params.half_sigma)
    tse = np.asarray(params.twice_sqrt_eps)
    if hs.size and np.all(hs == hs.flat[0]) and np.all(tse == tse.flat[0]):
        return (float(hs.flat[0]), float(tse.flat[0]))
    return None


BACKENDS = ("xla", "triton")


def resolve_dense_backend(backend: str = "auto") -> str:
    """Resolve 'auto' to the concrete pair-pass backend for this platform:
    the full-shell Triton kernel (`cell_pair_kernel`) on a GPU, the compiled
    XLA engine (`cell_dense_forces`) elsewhere.  Never an interpreter."""
    if backend == "auto":
        return "triton" if jax.default_backend() == "gpu" else "xla"
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown dense-cell backend {backend!r}; expected 'auto' or one "
            f"of {BACKENDS}"
        )
    return backend


def make_cell_dense_sim(
    config: CellDenseConfig,
    model: LennardJonesModel,
    dt: float,
    backend: str = "auto",
    uniform_params=None,
    rebin: str = "shift",
    coulomb=None,
    extra_forces=None,
    extra_energy=None,
    uniform_mass: Optional[float] = None,
    aux_fn=None,
    extra_aux_fn=None,
    thermostat=None,
    barostat=None,
):
    """Build (rollout, energy) closures for slot-space NVE/NVT.

    thermostat: None (NVE), a `CSVRConfig` (Bussi stochastic velocity
    rescaling — one global factor per step, canonical KE sampling), or a
    `LangevinConfig` (BAOAB).  With a thermostat the rollout requires an
    `rng` key argument and threads it through the scan.

    barostat: optional `BerendsenBarostatConfig` — weak pressure coupling
    applied once per rebin block: the state box becomes DYNAMIC
    (state.box), positions/box rescale by μ, and the whole NPT run stays
    one compiled program until the sticky flag says the static cell
    geometry no longer fits the box.

    backend: 'xla' (`cell_dense_forces`), 'triton' (the full-shell GPU
    kernel, `cell_pair_kernel.cell_pair_forces`), or 'auto'
    (`resolve_dense_backend`).  Energies and virials always come from
    `cell_dense_forces`; they are off the per-step path.

    uniform_params: optional static (half_sigma, twice_sqrt_eps) floats when
    all atoms share one LJ type (see `detect_uniform_params`) — the rebin
    stops routing the parameter fields and the kernel stops loading them.

    rebin: 'shift' (±1-cell routing, `_rebin_shift`; requires the
    ≤1-cell-per-interval staleness invariant the rollout already enforces)
    or 'sort' (argsort-based `_rebin`, handles any displacement).

    coulomb: optional DSFCoulomb model — state.charges must be set; DSF
    electrostatics are added to every pair evaluation.

    extra_forces(state) → (M³, C, 3) / extra_energy(state) → (pe, vir):
    additive slot-space hooks for molecular terms (exclusion corrections,
    bonded forces) — see cell_dense_molecular.make_molecular_dense_sim.

    aux_fn(state) → slot-space exclusion tags (ids, mlj, mcs), rebuilt after
    every rebin (binning is fixed between rebins, so one gather per rebin,
    amortized) and fed to the pair pass — kernel-resident exclusions.

    extra_aux_fn(state) → per-rebin bindings handed to extra_forces /
    extra_energy as their second argument (e.g. bonded term→slot index
    tables: slot↔atom binding only changes at rebins, so the remap is one
    small gather per rebin instead of a per-step atom-space round trip).
    """
    backend = resolve_dense_backend(backend)
    if rebin == "shift":
        rebin_fn = partial(
            _rebin_shift, uniform_params=uniform_params, uniform_mass=uniform_mass,
        )
    elif rebin == "sort":
        rebin_fn = _rebin
    else:
        raise ValueError(f"unknown rebin {rebin!r}; expected 'shift' or 'sort'")
    dt_f = jnp.float32(dt)
    if backend == "triton":
        from emdee_tpu.neighbors.cell_pair_kernel import cell_pair_forces, static_lj
        from emdee_tpu.potentials.coulomb import coulomb_consts

        lj = static_lj(model)
        dsf = None if coulomb is None else coulomb_consts(coulomb)

        def forces_of_pairs(state, aux=None):
            return cell_pair_forces(
                state, config, lj, dsf, aux, uniform_params=uniform_params
            )
    else:

        def forces_of_pairs(state, aux=None):
            return cell_dense_forces(state, model, config, coulomb, aux)[0]

    def energy_forces(state, aux=None):
        return cell_dense_forces(
            state, model, config, coulomb, aux, compute_energy=True
        )

    if extra_forces is None:
        def forces_of(state, aux=None, eaux=None):
            return forces_of_pairs(state, aux)
    else:

        def forces_of(state, aux=None, eaux=None):
            return forces_of_pairs(state, aux) + extra_forces(state, eaux)

    def energy_of(st: CellDenseState):
        _, e, w = energy_forces(st, aux_fn(st) if aux_fn is not None else None)
        pe = jnp.sum(jnp.where(st.valid, e, 0.0))
        vir = jnp.sum(jnp.where(st.valid, w, 0.0))
        if extra_energy is not None:
            pe_x, vir_x = extra_energy(
                st, extra_aux_fn(st) if extra_aux_fn is not None else None
            )
            pe = pe + pe_x
            vir = vir + vir_x
        ke = 0.5 * jnp.sum(
            jnp.where(
                st.valid[..., None],
                st.velocities**2 / jnp.maximum(st.inv_masses[..., None], 1e-30),
                0.0,
            )
        )
        return pe, vir, ke

    if thermostat is not None and not isinstance(thermostat, (CSVRConfig, LangevinConfig)):
        raise ValueError(f"unknown thermostat {thermostat!r}")
    if barostat is not None and config.spill:
        raise ValueError("barostat + boundary-spill capacity mode is unsupported")
    ndof = 3.0 * config.num_atoms - 3.0  # VV conserves the (zeroed) COM momentum

    def make_one_step(aux, eaux):
        def one_step(carry, _):
            # NO PBC wrap here: the GPU kernel computes image-shifted
            # differences, so a mid-block wrap would teleport a boundary-
            # crossing atom by ±L and silently sever its pair interactions
            # until the next rebin (steady NVE heating ∝ rebin_every).
            # Positions drift at most skin/2 past the box faces between
            # rebins — exactly what the image shifts cover — and are
            # wrapped at rebin time.
            state, forces, key = carry
            inv_m = state.inv_masses[..., None]
            if isinstance(thermostat, LangevinConfig):
                # BAOAB: kick, half drift, exact OU solve, half drift, kick.
                kT = thermostat.kB * thermostat.temperature
                c1 = float(np.exp(-thermostat.friction * dt))
                c2 = float(np.sqrt((1.0 - c1 * c1) * kT))
                v = state.velocities + (0.5 * dt_f) * forces * inv_m
                x = state.positions + (0.5 * dt_f) * v
                key, sub = jax.random.split(key)
                noise = jax.random.normal(sub, v.shape, v.dtype)
                # invalid slots: inv_m = 0 ⇒ no noise, velocities stay 0.
                v = c1 * v + c2 * jnp.sqrt(inv_m) * noise
                x = x + (0.5 * dt_f) * v
                x = jnp.where(state.valid[..., None], x, state.positions)
                state = state._replace(positions=x, velocities=v)
                new_forces = forces_of(state, aux, eaux)
                new_vel = v + (0.5 * dt_f) * new_forces * inv_m
                state = state._replace(velocities=new_vel, step=state.step + 1)
                return (state, new_forces, key), None
            v_half = state.velocities + (0.5 * dt_f) * forces * inv_m
            new_pos = state.positions + dt_f * v_half
            new_pos = jnp.where(state.valid[..., None], new_pos, state.positions)
            state = state._replace(positions=new_pos, velocities=v_half)
            new_forces = forces_of(state, aux, eaux)
            new_vel = state.velocities + (0.5 * dt_f) * new_forces * state.inv_masses[..., None]
            if isinstance(thermostat, CSVRConfig):
                from emdee_tpu.dynamics.bussi import _csvr_alpha2

                kin = 0.5 * jnp.sum(
                    jnp.where(
                        state.valid[..., None],
                        new_vel**2 / jnp.maximum(state.inv_masses[..., None], 1e-30),
                        0.0,
                    )
                )
                key, sub = jax.random.split(key)
                alpha2 = _csvr_alpha2(
                    sub, jnp.maximum(kin, 1e-30), jnp.float32(ndof),
                    jnp.float32(thermostat.kB * thermostat.temperature),
                    dt_f, jnp.float32(thermostat.tau), jnp.float32,
                )
                new_vel = jnp.sqrt(jnp.maximum(alpha2, 0.0)) * new_vel
            state = state._replace(velocities=new_vel, step=state.step + 1)
            return (state, new_forces, key), None

        return one_step

    @partial(jax.jit, static_argnames=("num_steps", "rebin_every", "record"))
    def rollout(
        state: CellDenseState,
        num_steps: int,
        rebin_every: int = 10,
        record: bool = False,
        rng=None,
    ):
        """Blocked NVE rollout: rebin unconditionally every `rebin_every`
        steps, then scan that many plain steps.

        Unconditional-but-amortized rebinning plus a staleness check keeps
        the step free of data-dependent control flow and is still safe: if
        any atom moved more than skin/2 within a block, the sticky
        `overflow` flag trips and the caller re-runs with a smaller
        `rebin_every`.

        With record=True, returns (state, records) where records holds
        per-block (step, potential, virial, kinetic) scalars.
        """
        blocks, rem = divmod(num_steps, rebin_every)

        def observables(st):
            pe, vir, ke = energy_of(st)
            return (st.step, pe, vir, ke)

        def block_of(length):
            def block(carry, _):
                st, f, key = carry
                if barostat is not None:
                    # Berendsen μ-rescale at the block boundary (forces carry
                    # over unrescaled — the same weak-coupling approximation
                    # as the per-step protocol, amortized to rebin cadence).
                    pe, vir, ke = energy_of(st)
                    boxv = _state_box(st, config)
                    p_inst = (2.0 * ke + vir) / (3.0 * boxv**3)
                    mu3 = 1.0 - (length * dt / barostat.tau) * barostat.kappa * (
                        barostat.pressure - p_inst
                    )
                    mu = jnp.clip(mu3, 0.9, 1.1) ** (1.0 / 3.0)
                    new_box = boxv * mu
                    st = st._replace(
                        positions=st.positions * mu,
                        ref_positions=st.ref_positions * mu,
                        box=new_box,
                        overflow=st.overflow
                        | (new_box < config.cells_per_dim * (config.cutoff + config.skin)),
                    )
                # The permutation carries the current forces along, so no
                # extra force evaluation is needed after a rebin.
                st, f = rebin_fn(st, config, forces=f)
                aux = aux_fn(st) if aux_fn is not None else None
                eaux = extra_aux_fn(st) if extra_aux_fn is not None else None
                (st, f, key), _ = jax.lax.scan(
                    make_one_step(aux, eaux), (st, f, key), None, length=length
                )
                # Staleness check: the block's steps ran on the bins made at
                # the block start; flag if skin/2 displacement was violated.
                st = st._replace(overflow=st.overflow | _needs_rebin(st, config))
                return (st, f, key), (observables(st) if record else None)

            return block

        if thermostat is not None and rng is None:
            raise ValueError("a thermostatted rollout needs an rng key")
        if rng is None:
            rng = jax.random.PRNGKey(0)  # unused by the NVE step
        if barostat is not None and state.box is None:
            state = state._replace(box=jnp.float32(config.box))

        if thermostat is None and barostat is None and not record and num_steps:
            # Leapfrog-structured NVE: velocities ride a half step offset
            # inside the rollout, so each step is (drift, force, full kick)
            # and NO FORCE FIELD crosses a rebin — the shift rebin routes
            # 3 fewer (cells, C) arrays through its log-shift rounds.
            # Identical physics
            # to kick-drift-kick (the same update reassociated; trajectories
            # agree to f32 roundoff); velocities are re-synced by a closing
            # half un-kick, whose force pass is one extra evaluation per
            # ROLLOUT, not per block.  Thermostats, barostats and record mode
            # keep the synced KDK path (they read v at integer steps).
            aux0 = aux_fn(state) if aux_fn is not None else None
            eaux0 = extra_aux_fn(state) if extra_aux_fn is not None else None
            f0 = forces_of(state, aux0, eaux0)
            state = state._replace(
                velocities=state.velocities
                + (0.5 * dt_f) * f0 * state.inv_masses[..., None]
            )

            def lf_block(length):
                def block(st, _):
                    st = rebin_fn(st, config)
                    aux = aux_fn(st) if aux_fn is not None else None
                    eaux = extra_aux_fn(st) if extra_aux_fn is not None else None
                    # Kahan-compensated drift AND kick: the f32 position
                    # increment dt·v is ~1e-4 of the coordinate, so plain
                    # `+=` loses ~1 ulp/step — the dominant NVE drift term
                    # at small dt; the velocity kicks walk the same way
                    # over hundreds of steps.  Compensation lives only
                    # within a block (rebins re-wrap positions anyway).
                    comp0 = jnp.zeros_like(st.positions)
                    vcomp0 = jnp.zeros_like(st.velocities)

                    def lf_step(carry, _):
                        s, comp, vcomp = carry
                        y = dt_f * s.velocities - comp
                        new_pos = s.positions + y
                        comp = (new_pos - s.positions) - y
                        new_pos = jnp.where(
                            s.valid[..., None], new_pos, s.positions
                        )
                        s = s._replace(positions=new_pos)
                        f = forces_of(s, aux, eaux)
                        yv = dt_f * f * s.inv_masses[..., None] - vcomp
                        new_vel = s.velocities + yv
                        vcomp = (new_vel - s.velocities) - yv
                        return (s._replace(
                            velocities=new_vel,
                            step=s.step + 1,
                        ), comp, vcomp), None

                    (st, _, _), _ = jax.lax.scan(
                        lf_step, (st, comp0, vcomp0), None, length=length
                    )
                    return st._replace(
                        overflow=st.overflow | _needs_rebin(st, config)
                    ), None

                return block

            st = state
            if blocks:
                st, _ = jax.lax.scan(lf_block(rebin_every), st, None, length=blocks)
            if rem:
                st, _ = lf_block(rem)(st, None)
            f_end = forces_of(
                st,
                aux_fn(st) if aux_fn is not None else None,
                extra_aux_fn(st) if extra_aux_fn is not None else None,
            )
            return st._replace(
                velocities=st.velocities
                - (0.5 * dt_f) * f_end * st.inv_masses[..., None]
            )

        f0 = forces_of(
            state,
            aux_fn(state) if aux_fn is not None else None,
            extra_aux_fn(state) if extra_aux_fn is not None else None,
        )
        carry = (state, f0, rng)
        records = None
        if blocks:
            carry, records = jax.lax.scan(
                block_of(rebin_every), carry, None, length=blocks
            )
        if rem:
            carry, _ = block_of(rem)(carry, None)
        if record:
            return carry[0], records
        return carry[0]

    energy = jax.jit(energy_of)

    return rollout, energy


def gather_dense_atoms(state: CellDenseState, num_atoms: int):
    """Slot layout → dense (N, …) arrays in original atom order (host)."""
    ids = np.asarray(state.atom_id).reshape(-1)
    keep = np.asarray(state.valid).reshape(-1)
    pos = np.zeros((num_atoms, 3), np.float32)
    vel = np.zeros((num_atoms, 3), np.float32)
    pos[ids[keep]] = np.asarray(state.positions).reshape(-1, 3)[keep]
    vel[ids[keep]] = np.asarray(state.velocities).reshape(-1, 3)[keep]
    return pos, vel


def gather_dense_fields(state: CellDenseState, num_atoms: int) -> dict:
    """Slot layout → EVERY per-atom field in original atom order (host):
    positions, velocities, masses, (half_sigma, twice_sqrt_eps), charges.
    The full inverse of `cell_dense_init` — what `reconfigure_dense_state`
    feeds back through a re-derived geometry."""
    ids = np.asarray(state.atom_id).reshape(-1)
    keep = np.asarray(state.valid).reshape(-1)
    sel = ids[keep]

    def take(a, fill=0.0):
        flat = np.asarray(a).reshape(len(keep), *np.asarray(a).shape[2:])
        out = np.full((num_atoms,) + flat.shape[1:], fill, flat.dtype)
        out[sel] = flat[keep]
        return out

    inv_m = take(state.inv_masses)
    return {
        "positions": take(state.positions),
        "velocities": take(state.velocities),
        "masses": 1.0 / np.maximum(inv_m, 1e-30),
        "half_sigma": take(state.half_sigma),
        "twice_sqrt_eps": take(state.twice_sqrt_eps),
        "charges": None if state.charges is None else take(state.charges),
    }


def reconfigure_dense_state(
    state: CellDenseState,
    config: CellDenseConfig,
    *,
    cells_multiple_of: int = 1,
    min_cells_per_dim: int = 3,
):
    """Host-side NPT geometry re-derive: (state, old config) → (state', config').

    The dense engines keep the cell COUNT static while the NPT box breathes;
    when the box drifts past the static-geometry guard (shrinks below
    M·(rc + skin), or grows until occupancy statistics waste capacity), the
    sticky overflow flag trips and the run must re-derive its geometry.  This
    helper is that protocol: gather every per-atom field from slot layout,
    re-run `suggest_cell_dense_config` at the CURRENT box, and re-init —
    `step` carries over, `overflow` resets (the tripped guard is the reason
    we are here), and velocities/params/charges survive exactly.

    cells_multiple_of: round the new cells_per_dim DOWN to this multiple
    (grid-sharded runs need M divisible by every mesh axis; the cell side
    only grows, so the rc+skin bound still holds).  Raises if the box cannot
    hold `min_cells_per_dim` cells — at that point the system belongs on the
    all-pairs engine, not a cell grid.

    Reference match: the reference re-derives its cell grid whenever nc
    changes (cells.jl:46-76, `set_cells!`); this is the same operation for a
    slot-grid state, kept OFF the compiled path (a geometry change is a
    recompile by construction — M and C are trace-time statics)."""
    n = int(config.num_atoms)
    box_now = float(np.asarray(_state_box(state, config)))
    fields = gather_dense_fields(state, n)
    new_config = suggest_cell_dense_config(
        n, box_now, config.cutoff, config.switch, config.skin, spill=config.spill,
        cells_multiple_of=cells_multiple_of,
    )
    m = new_config.cells_per_dim
    if m < min_cells_per_dim:
        raise ValueError(
            f"box {box_now:.3f} holds only {m} cells of side ≥ "
            f"{config.cutoff + config.skin} (multiple-of-{cells_multiple_of})"
        )
    params = LJParams(
        half_sigma=fields["half_sigma"], twice_sqrt_eps=fields["twice_sqrt_eps"]
    )
    new_state = cell_dense_init(
        fields["positions"], fields["velocities"], fields["masses"], params,
        new_config, charges=fields["charges"],
    )
    if bool(new_state.overflow):
        # Rare statistical outlier at the snapshot instant: widen and retry
        # (the suggest margin is deliberately tight — see its docstring).
        new_config = new_config._replace(capacity=new_config.capacity + 8)
        new_state = cell_dense_init(
            fields["positions"], fields["velocities"], fields["masses"], params,
            new_config, charges=fields["charges"],
        )
    return new_state._replace(step=state.step), new_config
