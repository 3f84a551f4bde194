"""Molecular systems on the dense-cell production engine.

The bridge the reference never built, one level further than `modelling`'s
System→arrays methods: a typed, charged, bonded System running on the *fast*
slot-grid engine (cell_dense.py and its GPU kernel), not just the
gather-based neighbor-list path.

Structure of a molecular force evaluation:

1. **Pair pass in slot space** — LJ (+ DSF Coulomb over a charge slot field)
   on the dense cell grid: `cell_dense_forces` or the GPU kernel, both of
   which carry charges and exclusion tags.
2. **Correction pass in atom space** — exclusions (1-2/1-3 removal, scaled
   1-4, reusing `apply_exclusion_corrections`) and bonded terms (harmonic
   bonds/angles, periodic torsions/impropers via `BondedSystem`) evaluated on
   (N, 3) positions scattered out of the slot grid by atom id, then gathered
   back into slot layout.  The correction set is O(N) small (a handful of
   terms per atom), so the scatter/gather round-trip costs far less than the
   pair pass it corrects.

The split keeps the hot pair kernel branch-free and mask-free (the design
rule of the whole engine) while making exclusions and bonded forces exact.

Parity anchor: the reference parses types/charges/bonded tables
(modelling.jl:145-203) and builds typed frames (modelling.jl:235-349) but
never connects them to its compute layer (SURVEY.md §1); this module is that
connection.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from emdee_tpu.core.types import ENERGIES, FORCES, VIRIALS, NonbondedOutput
from emdee_tpu.neighbors.cell_dense import (
    CellDenseConfig,
    CellDenseState,
    _state_box,
    cell_dense_init,
    make_cell_dense_sim,
    suggest_cell_dense_config,
)
from emdee_tpu.neighbors.neighbor_force import apply_exclusion_corrections
from emdee_tpu.potentials.lennard_jones import LennardJonesModel


def build_exclusion_tables(
    num_atoms, pairs, lj_scales, coulomb_scales=None, pad_e=None, band_e=None,
):
    """(N+1, E) atom-indexed exclusion tag tables (host-side, numpy).

    Row i lists atom i's exclusion partners as f32 ids (−1 pad) with the
    1−scale weights the kernel subtracts per matching pair.  Row N is the
    all-pad row indexed by invalid slots.  E = max partners per atom
    (`pad_e` to force a wider static width).

    band_e: cap the pair-pass tag width (the pair pass costs ~3E ops/pair,
    so protein-scale E≈16-24 would triple the hot loop).  A pair stays
    in-band only if BOTH atoms' rows have space (the pass checks whichever
    atom lands as the pair's center); the remainder is returned as leftover
    (pairs, lj_scales, coulomb_scales) for the slot-space correction term.
    With band_e set the return is ((ids, mlj, mcs), leftover)."""
    pairs = np.asarray(pairs)
    lj_scales = np.asarray(lj_scales, np.float32)
    cs = None if coulomb_scales is None else np.asarray(coulomb_scales, np.float32)
    n = num_atoms
    partners = [[] for _ in range(n)]
    leftover = []
    counts = np.zeros(n, np.int64)
    for k in range(len(pairs)):
        i, j = int(pairs[k, 0]), int(pairs[k, 1])
        if i >= n or j >= n:
            continue  # padding rows
        s_c = None if cs is None else cs[k]
        if band_e is not None and (counts[i] >= band_e or counts[j] >= band_e):
            leftover.append((i, j, lj_scales[k], 0.0 if s_c is None else s_c))
            continue
        partners[i].append((j, lj_scales[k], s_c))
        partners[j].append((i, lj_scales[k], s_c))
        counts[i] += 1
        counts[j] += 1
    e_n = max((len(p) for p in partners), default=0)
    e_n = max(e_n, 1)
    if pad_e is not None:
        if pad_e < e_n:
            raise ValueError(f"pad_e {pad_e} < max partners per atom {e_n}")
        e_n = pad_e
    ids = np.full((n + 1, e_n), -1.0, np.float32)
    mlj = np.zeros((n + 1, e_n), np.float32)
    mcs = np.zeros((n + 1, e_n), np.float32) if cs is not None else None
    for i, plist in enumerate(partners):
        for e, (j, s_lj, s_c) in enumerate(plist):
            ids[i, e] = float(j)
            mlj[i, e] = 1.0 - s_lj
            if mcs is not None:
                mcs[i, e] = 1.0 - s_c
    tabs = (
        jnp.asarray(ids),
        jnp.asarray(mlj),
        None if mcs is None else jnp.asarray(mcs),
    )
    if leftover:
        lo = np.asarray([(i, j) for i, j, _, _ in leftover], np.int32)
        lo_lj = np.asarray([s for _, _, s, _ in leftover], np.float32)
        lo_cs = None if cs is None else np.asarray([s for _, _, _, s in leftover], np.float32)
    else:
        lo, lo_lj, lo_cs = np.zeros((0, 2), np.int32), np.zeros(0, np.float32), (
            None if cs is None else np.zeros(0, np.float32)
        )
    if band_e is None:
        return tabs
    return tabs, (lo, lo_lj, lo_cs)


def _split_exclusive_terms(bonded, leftover_pairs, num_atoms):
    """Partition a BondedSystem's terms into (exclusive, shared) systems.

    A term is EXCLUSIVE when every one of its atoms appears in exactly one
    force row across ALL slot-space scatter sources (every bonded family
    plus the exclusion-leftover correction pairs).  Exclusive terms' scatter
    rows have globally unique targets, so they can be applied with a
    scatter-SET into zeros instead of a scatter-ADD, which needs no
    read-modify-write of its targets.

    Atom-space multiplicity is invariant under the per-rebin atom→slot
    remap (a bijection), so the split is computed once at build time.
    Returns (exclusive_or_None, shared_or_None)."""
    if bonded is None:
        return None, None
    counts = np.zeros(num_atoms + 1, np.int64)
    per_table = {}
    for name in ("bonds", "angles", "torsions", "impropers"):
        t = getattr(bonded, name)
        if t is None:
            continue
        atoms = np.asarray(t.atoms)
        valid = np.asarray(t.valid)
        rows = np.clip(atoms[valid].ravel(), 0, num_atoms)
        np.add.at(counts, rows, 1)
        per_table[name] = (atoms, valid)
    if leftover_pairs is not None and len(leftover_pairs):
        np.add.at(counts, np.clip(np.asarray(leftover_pairs).ravel(), 0, num_atoms), 1)
    counts[num_atoms] = 2  # pad row: never exclusive

    def take(t, keep):
        # Sub-table with only `keep` of the VALID terms (padded to /8).
        valid = np.asarray(t.valid)
        sel = np.zeros(len(valid), bool)
        sel[np.flatnonzero(valid)[keep]] = True
        nkeep = int(sel.sum())
        if nkeep == 0:
            return None
        cap = -(-nkeep // 8) * 8
        out = {}
        for field, arr in t._asdict().items():
            if field == "valid":
                out[field] = jnp.asarray(np.arange(cap) < nkeep)
                continue
            a = np.asarray(arr)[sel]
            pad_val = num_atoms if field == "atoms" else 0
            pad = np.full((cap - nkeep,) + a.shape[1:], pad_val, a.dtype)
            out[field] = jnp.asarray(np.concatenate([a, pad]))
        return type(t)(**out)

    excl_kw, shared_kw = {}, {}
    any_excl = False
    for name in ("bonds", "angles", "torsions", "impropers"):
        if name not in per_table:
            excl_kw[name] = shared_kw[name] = None
            continue
        atoms, valid = per_table[name]
        va = np.clip(atoms[valid], 0, num_atoms)
        is_excl = (counts[va] == 1).all(axis=1)
        excl_kw[name] = take(getattr(bonded, name), is_excl)
        shared_kw[name] = take(getattr(bonded, name), ~is_excl)
        any_excl = any_excl or excl_kw[name] is not None
    if not any_excl:
        return None, bonded
    excl = bonded._replace(**excl_kw)
    shared = bonded._replace(**shared_kw)
    if all(getattr(shared, f) is None for f in ("bonds", "angles", "torsions", "impropers")):
        shared = None
    return excl, shared


def _merged_slot_binder(excl_sys, shared_sys, corr_pairs, num_atoms):
    """ONE flat atom→slot gather for every per-rebin table rebinding.

    `BondedSystem.remap` per table plus the correction `bind` were each a
    separate scalar-row gather of the atom→slot map; XLA's per-gather fixed
    cost dominates the small tables (the same effect as the per-scatter cost
    `force_rows` documents).  All atom-index arrays are concatenated once at
    build time, so the per-rebin binding is one gather split back into the
    table shapes.  Returns bind(atom_slot) → (bx, bs, corr_slot_ij), any of
    which is None when absent; returns None if there is nothing to bind."""
    chunks = []
    plan = {}

    def add(arr):
        a = np.minimum(np.asarray(arr, np.int64).ravel(), num_atoms)
        start = sum(c.size for c in chunks)
        chunks.append(a)
        return (start, start + a.size)

    for label, sys_ in (("bx", excl_sys), ("bs", shared_sys)):
        if sys_ is None:
            continue
        tplan = {}
        for name in ("bonds", "angles", "torsions", "impropers"):
            t = getattr(sys_, name)
            if t is None:
                continue
            tplan[name] = (add(t.atoms), tuple(t.atoms.shape))
        if tplan:
            plan[label] = tplan
    corr_span = None
    if corr_pairs is not None and len(np.asarray(corr_pairs)):
        corr_span = (add(corr_pairs), tuple(np.asarray(corr_pairs).shape))
    if not chunks:
        return None
    flat = jnp.asarray(np.concatenate(chunks), jnp.int32)

    def bind(atom_slot):
        mapped = atom_slot[flat]

        def cut(span_shape):
            (a, b), shape = span_shape
            return mapped[a:b].reshape(shape)

        def rebind(sys_, tplan):
            return sys_._replace(**{
                name: getattr(sys_, name)._replace(atoms=cut(s))
                for name, s in tplan.items()
            })

        bx = rebind(excl_sys, plan["bx"]) if "bx" in plan else None
        bs = rebind(shared_sys, plan["bs"]) if "bs" in plan else None
        cb = cut(corr_span) if corr_span is not None else None
        return bx, bs, cb

    return bind


def make_exclusion_aux_fn(num_atoms, ids_tab, mlj_tab, mcs_tab):
    """aux_fn(state) → slot-space (ids, mlj, mcs) tags.

    ONE (M³·C)-row gather from a single column-packed atom-indexed table,
    re-run after every rebin (slot↔atom binding only changes there) —
    amortized over the rebin interval instead of a per-step atom-space round
    trip."""
    cols = [ids_tab, mlj_tab]
    if mcs_tab is not None:
        cols.append(mcs_tab)
    offs = np.cumsum([0] + [int(t.shape[-1]) for t in cols])
    packed = jnp.concatenate(cols, axis=-1)

    def aux_fn(state: CellDenseState):
        idx = jnp.minimum(state.atom_id, num_atoms)  # sentinel → pad row
        g = packed[idx]
        parts = [g[..., offs[i] : offs[i + 1]] for i in range(len(cols))]
        return parts[0], parts[1], parts[2] if mcs_tab is not None else None

    return aux_fn


def make_slot_pair_correction(
    num_atoms, pairs, lj_scales, coulomb_scales, model, params, coulomb, charges
):
    """Slot-space −(1−s)·(LJ [+ DSF]) correction for exclusion pairs beyond
    the kernel tag band.

    Like the bonded terms, the per-pair atom indices are remapped to SLOT
    indices once per rebin; every step then gathers only the P pair rows and
    scatter-adds their forces — no full-N atom-space round trip.  Per-pair
    LJ parameters and charge products are static (precomputed host-side).

    Returns (bind, force, energy_virial):
      bind(atom_slot) → (P, 2) slot indices;
      force(pos_ext, slot_ij, box) → (ns+1, 3) correction forces;
      energy_virial(pos_ext, slot_ij, box) → (pe, vir) scalars.
    """
    from emdee_tpu.core.pbc import minimum_image
    from emdee_tpu.potentials.lennard_jones import pair_interaction

    pairs_np = np.asarray(pairs, np.int64)
    pi, pj = pairs_np[:, 0], pairs_np[:, 1]
    hs = np.asarray(params.half_sigma, np.float32)
    tse = np.asarray(params.twice_sqrt_eps, np.float32)
    hs_i, tse_i = jnp.asarray(hs[pi]), jnp.asarray(tse[pi])
    hs_j, tse_j = jnp.asarray(hs[pj]), jnp.asarray(tse[pj])
    w_lj = jnp.asarray(1.0 - np.asarray(lj_scales, np.float32))
    pairs_j = jnp.asarray(pairs_np, jnp.int32)
    has_q = coulomb is not None and charges is not None
    if has_q:
        q_np = np.asarray(charges, np.float32)
        qi, qj = jnp.asarray(q_np[pi]), jnp.asarray(q_np[pj])
        cs = (
            np.asarray(coulomb_scales, np.float32)
            if coulomb_scales is not None
            else np.asarray(lj_scales, np.float32)
        )
        w_c = jnp.asarray(1.0 - cs)

    def bind(atom_slot):
        return atom_slot[pairs_j]

    def _terms(pos_ext, slot_ij, box):
        i, j = slot_ij[:, 0], slot_ij[:, 1]
        dv = box * minimum_image((pos_ext[i] - pos_ext[j]) / box)
        r2 = jnp.sum(dv * dv, axis=-1)
        e, mre = pair_interaction(r2, model, hs_i, tse_i, hs_j, tse_j)
        e = w_lj * e
        mre = w_lj * mre
        if has_q:
            from emdee_tpu.potentials.coulomb import coulomb_interaction

            e_c, mre_c = coulomb_interaction(r2, coulomb, qi, qj)
            e = e + w_c * e_c
            mre = mre + w_c * mre_c
        return i, j, dv, r2, e, mre

    def force_rows(pos_ext, slot_ij, box):
        """(idx, contrib) scatter rows — merged by the caller with the bonded
        rows into one scatter-add (one scatter's fixed cost instead of
        two)."""
        i, j, dv, r2, _, mre = _terms(pos_ext, slot_ij, box)
        f_ij = (mre / jnp.maximum(r2, 1e-30))[:, None] * dv
        return jnp.concatenate([i, j]), jnp.concatenate([-f_ij, f_ij])

    def force(pos_ext, slot_ij, box):
        idx, contrib = force_rows(pos_ext, slot_ij, box)
        return jnp.zeros_like(pos_ext).at[idx].add(contrib)
    force.rows = force_rows

    def energy_virial(pos_ext, slot_ij, box):
        _, _, _, _, e, mre = _terms(pos_ext, slot_ij, box)
        return -jnp.sum(e), -jnp.sum(mre)

    return bind, force, energy_virial


def slots_to_atoms(state: CellDenseState, num_atoms: int):
    """Scatter slot-layout per-atom vectors into (N, …) atom order (device).

    Invalid slots route to a trash row that is sliced off.  The inverse of
    the gather in `atoms_to_slots`; both are O(N) index ops that only run in
    the molecular correction pass, never in the pure-LJ hot loop.
    """
    ids = jnp.where(state.valid, state.atom_id, num_atoms).reshape(-1)
    flat = state.positions.reshape(-1, 3)
    pos = jnp.zeros((num_atoms + 1, 3), flat.dtype).at[ids].set(flat)
    return pos[:num_atoms], ids


def make_molecular_dense_sim(
    config: CellDenseConfig,
    model: LennardJonesModel,
    dt: float,
    num_atoms: int,
    *,
    params=None,  # LJParams in atom order (for exclusion corrections)
    charges=None,  # (N,) in atom order, or None
    coulomb=None,  # DSFCoulomb model, or None
    exclusion_pairs=None,  # (P, 2) int32 atom ids; (N, N) rows = padding
    exclusion_scales=None,  # (P,) LJ 1-4 scales (0 → full exclusion)
    exclusion_scales_coulomb=None,  # (P,) Coulomb 1-4 scales
    bonded=None,  # BondedSystem, or None
    backend: str = "auto",
    rebin: str = "shift",
    exclusion_mode: str = "kernel",
    exclusion_band: Optional[int] = None,
    thermostat=None,
    barostat=None,
):
    """(rollout, energy) closures for a molecular system in slot space.
    thermostat/barostat forward to `make_cell_dense_sim` (CSVR / Langevin /
    Berendsen on the production engine).

    Same contract as `make_cell_dense_sim` — this wraps it with the
    molecular hooks.  The state must be built by
    `cell_dense_init(..., charges=...)` when `coulomb` is given.

    exclusion_mode:
      'kernel'     — exclusions as per-pair tag comparisons inside the pair
                     pass (~3E ops/pair; slot tags rebuilt once per
                     rebin).  The fast path: no per-step atom-space round
                     trip.
      'correction' — atom-space correction pass after the pair pass
                     (scatter → `apply_exclusion_corrections` → gather);
                     the portable reference implementation.

    exclusion_band: cap the pair-pass tag width E (cost ~3E ops/pair;
    protein-scale E≈16-24 would triple the hot loop).  Pairs beyond the band
    are evaluated by a slot-space correction term (per-rebin slot bindings,
    per-pair gathers — no full-N round trip).  None = all pairs in-kernel.

    Note: the reported virial covers pair, exclusion AND bonded terms (bond
    stretches; angle/torsion terms are scale-invariant and contribute
    exactly zero to the isotropic virial).
    """
    if exclusion_mode not in ("kernel", "correction"):
        raise ValueError(f"unknown exclusion_mode {exclusion_mode!r}")
    box = jnp.float32(config.box)
    has_excl = exclusion_pairs is not None and exclusion_pairs.shape[0] > 0
    if has_excl and exclusion_scales is None:
        exclusion_scales = jnp.zeros(exclusion_pairs.shape[0], jnp.float32)
    if has_excl and params is None:
        raise ValueError("exclusion corrections need atom-ordered LJ params")
    q_at = jnp.asarray(charges, jnp.float32) if charges is not None else None
    bonded_force = bonded.force_fn() if bonded is not None else None

    if has_excl and exclusion_mode == "kernel":
        # Coulomb scales default to the LJ scales when unspecified — the
        # same fallback `apply_exclusion_corrections` uses, so the two
        # exclusion modes always agree.
        cs_for_tables = None
        if coulomb is not None:
            cs_for_tables = (
                exclusion_scales_coulomb
                if exclusion_scales_coulomb is not None
                else exclusion_scales
            )
        if exclusion_band is not None:
            tabs, leftover = build_exclusion_tables(
                num_atoms, exclusion_pairs, exclusion_scales, cs_for_tables,
                band_e=exclusion_band,
            )
            if leftover[0].shape[0] == 0:
                leftover = None
        else:
            leftover = None
            tabs = build_exclusion_tables(
                num_atoms, exclusion_pairs, exclusion_scales, cs_for_tables,
            )
        aux_fn = make_exclusion_aux_fn(num_atoms, *tabs)
        corr = None
        if leftover is not None:
            corr = make_slot_pair_correction(
                num_atoms, *leftover, model, params, coulomb, q_at,
            )

        # Exclusive-term split: terms whose atoms appear in no other scatter
        # row anywhere get the unique-target scatter-SET path.
        excl_force_sys, shared_force_sys = _split_exclusive_terms(
            bonded
            if bonded is not None and any(t is not None for t in bonded)
            else None,
            leftover[0] if leftover is not None else None,
            num_atoms,
        )

        extra_forces = extra_energy = extra_aux_fn = None
        if bonded is not None or corr is not None:
            # Slot-space bonded terms: the per-term atom indices are remapped
            # to SLOT indices once per rebin (`extra_aux_fn`), so every step
            # evaluates bonds/angles/torsions directly on the slot-layout
            # positions — per-term gathers/scatter-adds only, no full-N
            # atom-space scatter/gather round trip.
            ns = config.num_slots

            def _atom_slot(state):
                ids = jnp.where(state.valid, state.atom_id, num_atoms).reshape(-1)
                return (
                    jnp.full((num_atoms + 1,), ns, jnp.int32)
                    .at[ids]
                    .set(jnp.arange(ns, dtype=jnp.int32))
                )

            binder = _merged_slot_binder(
                excl_force_sys,
                shared_force_sys
                if shared_force_sys is not None
                and any(t is not None for t in shared_force_sys)
                else None,
                leftover[0] if corr is not None else None,
                num_atoms,
            )

            def extra_aux_fn(state):
                atom_slot = _atom_slot(state)
                # Invalid slots all target the pad row; whatever index lands
                # there only feeds `valid=False` terms, whose energy (and
                # therefore gradient) is select-masked to zero.  The FORCE
                # path rebinds the exclusive/shared split of the force system
                # and the correction pairs through ONE merged gather.
                if binder is None:
                    return ((None, None), None)
                bx, bs, cbind = binder(atom_slot)
                return ((bx, bs), cbind)

            def _pos_ext(state):
                return jnp.concatenate(
                    [state.positions.reshape(-1, 3), jnp.zeros((1, 3), jnp.float32)],
                    axis=0,
                )

            def extra_forces(state, eaux):
                from emdee_tpu.potentials.bonded import bonded_force_rows

                (bx, bs), cbind = eaux
                pos = _pos_ext(state)
                b = _state_box(state, config)
                # Hand gradients (one gather/scatter set vs autodiff's forward
                # + recomputed backward); exclusive terms (globally unique
                # scatter targets — see `_split_exclusive_terms`) go through
                # ONE scatter-set, everything else through ONE merged
                # scatter-add (one scatter's fixed cost for the small
                # tables).  The two row sets are disjoint except the pad
                # row, where every contribution is exactly zero.
                f = jnp.zeros_like(pos)
                if bx is not None:
                    idx, contrib = bonded_force_rows(pos, b, bx)
                    f = f.at[idx].set(contrib)
                idxs, contribs = [], []
                if bs is not None:
                    idx, contrib = bonded_force_rows(pos, b, bs)
                    idxs.append(idx)
                    contribs.append(contrib)
                if cbind is not None:
                    idx, contrib = corr[1].rows(pos, cbind, b)
                    idxs.append(idx)
                    contribs.append(contrib)
                if bx is None and not idxs:
                    return jnp.zeros_like(state.positions)
                if idxs:
                    f = f.at[jnp.concatenate(idxs)].add(
                        jnp.concatenate(contribs)
                    )
                return f[:-1].reshape(state.positions.shape)

            def extra_energy(state, eaux):
                _, cbind = eaux
                pos = _pos_ext(state)
                b = _state_box(state, config)
                pe = jnp.float32(0.0)
                vir = jnp.float32(0.0)
                if bonded is not None:
                    btabs_full = bonded.remap(_atom_slot(state))
                    pe = pe + btabs_full.energy(pos, b)
                    vir = vir + btabs_full.virial(pos, b)
                if cbind is not None:
                    pe_c, vir_c = corr[2](pos, cbind, b)
                    pe = pe + pe_c
                    vir = vir + vir_c
                return pe, vir

        return make_cell_dense_sim(
            config, model, dt, backend=backend, rebin=rebin, coulomb=coulomb,
            extra_forces=extra_forces, extra_energy=extra_energy, aux_fn=aux_fn,
            extra_aux_fn=extra_aux_fn, thermostat=thermostat, barostat=barostat,
        )

    def corrections_at(pos_at, outputs):
        out = NonbondedOutput(
            forces=jnp.zeros((num_atoms, 3), jnp.float32) if outputs & FORCES else None,
            energies=jnp.zeros(num_atoms, jnp.float32) if outputs & ENERGIES else None,
            virials=jnp.zeros(num_atoms, jnp.float32) if outputs & VIRIALS else None,
        )
        if has_excl:
            out = apply_exclusion_corrections(
                out, pos_at, box, model, params,
                exclusion_pairs, exclusion_scales,
                q_at if coulomb is not None else None,
                coulomb, exclusion_scales_coulomb,
                outputs=outputs,
            )
        return out

    extra_forces = None
    if has_excl or bonded is not None:

        def extra_forces(state, eaux=None):
            pos_at, ids = slots_to_atoms(state, num_atoms)
            f_at = corrections_at(pos_at, FORCES).forces
            if bonded_force is not None:
                f_at = f_at + bonded_force(pos_at, box)
            f_ext = jnp.concatenate([f_at, jnp.zeros((1, 3), f_at.dtype)], axis=0)
            return f_ext[ids].reshape(state.positions.shape)

    extra_energy = None
    if has_excl or bonded is not None:

        def extra_energy(state, eaux=None):
            pos_at, _ = slots_to_atoms(state, num_atoms)
            out = corrections_at(pos_at, ENERGIES | VIRIALS)
            pe = jnp.sum(out.energies)
            vir = jnp.sum(out.virials)
            if bonded is not None:
                pe = pe + bonded.energy(pos_at, box)
                vir = vir + bonded.virial(pos_at, box)
            return pe, vir

    return make_cell_dense_sim(
        config, model, dt, backend=backend, rebin=rebin, coulomb=coulomb,
        extra_forces=extra_forces, extra_energy=extra_energy,
        thermostat=thermostat, barostat=barostat,
    )


def dense_sim_from_system(
    system,
    *,
    cutoff: float,
    switch: float,
    dt: float,
    skin: float = 0.4,
    coulomb_alpha: float = 0.2,
    length_scale: float = 10.0,  # OpenMM-XML nm → PDB Å
    with_coulomb: bool = True,
    with_bonded: bool = True,
    backend: str = "auto",
    spill: bool = False,
    velocities=None,
    exclusion_mode: str = "kernel",
    exclusion_band="auto",
    thermostat=None,
    barostat=None,
):
    """One-call System → dense-engine simulation.

    exclusion_band="auto" caps the pair-pass tag width at 4 when the
    system's natural width exceeds 8 (protein-scale E would blow the
    ~3E-ops/pair hot-loop cost); the remainder runs through the slot-space
    pair correction.  Pass None to keep every pair in the pass, or an int to
    pick the band.

    Returns (state, rollout, energy, config).  Uses Å/amu/e units with
    kC = 1389.35456 (kJ/mol·Å·e²) so energies come out in kJ/mol when the
    force field is an OpenMM-style XML.
    """
    from emdee_tpu.modelling.bonded import build_bonded_system
    from emdee_tpu.potentials.coulomb import DSFCoulomb, KJMOL_ANGSTROM

    n = len(system)
    if system.box_lengths is None:
        raise ValueError("System has no periodic box")
    if not np.allclose(system.box_lengths, system.box_lengths[0]):
        raise NotImplementedError(
            f"non-cubic boxes not yet supported (got {system.box_lengths})"
        )
    box = float(system.box_lengths[0])
    params = system.lj_params(length_scale)
    pairs, lj_s, c_s = system.exclusions(coulomb=True)
    config = suggest_cell_dense_config(
        n, box, cutoff=cutoff, switch=switch, skin=skin, spill=spill
    )
    model = LennardJonesModel.create(cutoff, switch)
    coulomb = (
        DSFCoulomb.create(cutoff, coulomb_alpha, KJMOL_ANGSTROM)
        if with_coulomb
        else None
    )
    bonded = build_bonded_system(system, length_scale=length_scale) if with_bonded else None

    if exclusion_band == "auto":
        exclusion_band = None
        if exclusion_mode == "kernel" and len(pairs):
            tabs_probe = build_exclusion_tables(n, pairs, lj_s)
            e_nat = int(tabs_probe[0].shape[-1])
            if e_nat > 8:
                exclusion_band = 4
                import logging

                logging.getLogger(__name__).info(
                    "exclusion width E=%d > 8: capping kernel tags at band=4, "
                    "%s pairs via the slot-space correction", e_nat,
                    "remaining",
                )

    vel = velocities if velocities is not None else system.velocities

    # Constructed starting geometries routinely exceed the mean+2.5σ
    # occupancy margin (a compact peptide concentrates atoms far past the
    # solvent statistics — measured 101 vs capacity 88 at the 30-residue
    # fixture), so derive the init capacity from the ACTUAL binning and keep
    # the sticky flag as the in-run guard.
    if not spill:
        pos64 = np.asarray(system.positions, np.float64)
        m = config.cells_per_dim
        s = pos64 / box - np.floor(pos64 / box)
        v = np.clip(np.floor(m * s).astype(np.int64), 0, m - 1)
        occ = np.bincount(
            v[:, 0] + m * (v[:, 1] + m * v[:, 2]), minlength=m**3
        ).max()
        need = -(-int(occ) // 8) * 8
        if need > config.capacity:
            config = config._replace(capacity=need)

    state = cell_dense_init(
        np.asarray(system.positions, np.float32),
        np.asarray(vel, np.float32),
        np.asarray(system.masses, np.float32),
        params,
        config,
        charges=np.asarray(system.charges, np.float32) if with_coulomb else None,
    )
    rollout, energy = make_molecular_dense_sim(
        config, model, dt, n,
        params=params,
        charges=system.charges if with_coulomb else None,
        coulomb=coulomb,
        exclusion_pairs=jnp.asarray(pairs, jnp.int32),
        exclusion_scales=jnp.asarray(lj_s, jnp.float32),
        exclusion_scales_coulomb=jnp.asarray(c_s, jnp.float32),
        bonded=bonded,
        backend=backend,
        exclusion_mode=exclusion_mode,
        exclusion_band=exclusion_band,
        thermostat=thermostat,
        barostat=barostat,
    )
    return state, rollout, energy, config
