"""Bonded potentials: harmonic bonds, harmonic angles, periodic torsions.

The reference parses these tables from force-field XML (HARMONIC_BOND /
HARMONIC_ANGLE / PERIODIC_TORSION schemas, modelling.jl:46-69) but never
evaluates them (SURVEY.md §0).  This module completes the feature: energies
as pure jnp functions of positions; forces come from `jax.grad` — exact,
fused by XLA into the step, and free of hand-derived vector calculus.

Functional forms (OpenMM conventions, matching the XML units):
  bond:    E = ½ k (r − r₀)²
  angle:   E = ½ k (θ − θ₀)²
  torsion: E = Σ_n k_n (1 + cos(n φ − φ₀_n))

All terms take padded static-shape index arrays with a validity mask, so
they jit/scan like everything else.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from emdee_tpu.core.pbc import minimum_image


class BondTable(NamedTuple):
    atoms: jax.Array  # (B, 2) int32, pad rows = N
    length: jax.Array  # (B,) float32 r0
    k: jax.Array  # (B,) float32
    valid: jax.Array  # (B,) bool


class AngleTable(NamedTuple):
    atoms: jax.Array  # (A, 3) int32 — i, j (apex), k
    theta0: jax.Array  # (A,) float32 radians
    k: jax.Array  # (A,) float32
    valid: jax.Array  # (A,) bool


class TorsionTable(NamedTuple):
    atoms: jax.Array  # (T, 4) int32 — i, j, k, l
    periodicity: jax.Array  # (T, P) int32
    phase: jax.Array  # (T, P) float32 radians
    k: jax.Array  # (T, P) float32 (0 for unused terms)
    valid: jax.Array  # (T,) bool


def _disp(positions, box, i, j):
    return box * minimum_image((positions[i] - positions[j]) / box)


def bond_energy(positions, box, table: BondTable):
    n = positions.shape[0]
    i = jnp.minimum(table.atoms[:, 0], n - 1)
    j = jnp.minimum(table.atoms[:, 1], n - 1)
    rv = _disp(positions, box, i, j)
    r = jnp.sqrt(jnp.sum(rv * rv, axis=-1) + 1e-30)
    e = 0.5 * table.k * (r - table.length) ** 2
    return jnp.sum(jnp.where(table.valid, e, 0.0))


def angle_energy(positions, box, table: AngleTable):
    n = positions.shape[0]
    i = jnp.minimum(table.atoms[:, 0], n - 1)
    j = jnp.minimum(table.atoms[:, 1], n - 1)
    k = jnp.minimum(table.atoms[:, 2], n - 1)
    a = _disp(positions, box, i, j)
    b = _disp(positions, box, k, j)
    cos_t = jnp.sum(a * b, axis=-1) / jnp.sqrt(
        jnp.sum(a * a, axis=-1) * jnp.sum(b * b, axis=-1) + 1e-30
    )
    theta = jnp.arccos(jnp.clip(cos_t, -1.0, 1.0))
    e = 0.5 * table.k * (theta - table.theta0) ** 2
    return jnp.sum(jnp.where(table.valid, e, 0.0))


def torsion_energy(positions, box, table: TorsionTable):
    n = positions.shape[0]
    ii = jnp.minimum(table.atoms[:, 0], n - 1)
    jj = jnp.minimum(table.atoms[:, 1], n - 1)
    kk = jnp.minimum(table.atoms[:, 2], n - 1)
    ll = jnp.minimum(table.atoms[:, 3], n - 1)
    b1 = _disp(positions, box, jj, ii)
    b2 = _disp(positions, box, kk, jj)
    b3 = _disp(positions, box, ll, kk)
    # Pad rows clip every index to the same atom → b's of zero → 0/0 and
    # arctan2(0, 0), whose NaN PARTIALS poison jax.grad even though the
    # energy itself is `valid`-masked (0·NaN = NaN in the chain rule).
    # Substitute a non-degenerate frame for invalid rows before any math.
    val = table.valid[:, None]
    b1 = jnp.where(val, b1, jnp.asarray([1.0, 0.0, 0.0], b1.dtype))
    b2 = jnp.where(val, b2, jnp.asarray([0.0, 1.0, 0.0], b2.dtype))
    b3 = jnp.where(val, b3, jnp.asarray([0.0, 0.0, 1.0], b3.dtype))
    n1 = jnp.cross(b1, b2)
    n2 = jnp.cross(b2, b3)
    m1 = jnp.cross(
        n1, b2 / jnp.sqrt(jnp.sum(b2 * b2, axis=-1, keepdims=True) + 1e-30)
    )
    x = jnp.sum(n1 * n2, axis=-1)
    y = jnp.sum(m1 * n2, axis=-1)
    phi = jnp.arctan2(y, x)  # (T,)
    e_terms = table.k * (
        1.0 + jnp.cos(table.periodicity * phi[:, None] - table.phase)
    )  # (T, P)
    e = jnp.sum(e_terms, axis=-1)
    return jnp.sum(jnp.where(table.valid, e, 0.0))


def bond_virial(positions, box, table: BondTable):
    """Scalar bond virial Σ −r·dE/dr = Σ −k·r·(r − r₀) (the engine's pair
    convention, so P = (2K + W)/(3V) stays exact with bonded terms)."""
    n = positions.shape[0]
    i = jnp.minimum(table.atoms[:, 0], n - 1)
    j = jnp.minimum(table.atoms[:, 1], n - 1)
    rv = _disp(positions, box, i, j)
    r = jnp.sqrt(jnp.sum(rv * rv, axis=-1) + 1e-30)
    w = -table.k * r * (r - table.length)
    return jnp.sum(jnp.where(table.valid, w, 0.0))


class BondedSystem(NamedTuple):
    """All bonded terms of a typed system (static-shape tables)."""

    bonds: Optional[BondTable]
    angles: Optional[AngleTable]
    torsions: Optional[TorsionTable]
    impropers: Optional[TorsionTable]

    def energy(self, positions, box):
        e = jnp.asarray(0.0, positions.dtype)
        if self.bonds is not None:
            e = e + bond_energy(positions, box, self.bonds)
        if self.angles is not None:
            e = e + angle_energy(positions, box, self.angles)
        if self.torsions is not None:
            e = e + torsion_energy(positions, box, self.torsions)
        if self.impropers is not None:
            e = e + torsion_energy(positions, box, self.impropers)
        return e

    def virial(self, positions, box):
        """Total scalar virial of the bonded terms.

        Angles and torsions are functions of ANGLES only, which are invariant
        under isotropic scaling of all coordinates — their virial is exactly
        zero; only the bond-length terms contribute."""
        w = jnp.asarray(0.0, positions.dtype)
        if self.bonds is not None:
            w = w + bond_virial(positions, box, self.bonds)
        return w

    def force_fn(self):
        """forces(positions, box) = −∇E, via autodiff (exact)."""
        grad = jax.grad(lambda p, b: self.energy(p, b))

        def forces(positions, box):
            return -grad(positions, box)

        return forces

    def remap(self, index_map):
        """Tables with every atom index mapped through `index_map` (e.g. the
        per-rebin atom→slot binding; pad rows map through index_map's last
        row).  Parameters and validity are shared, not copied."""
        re = lambda t: None if t is None else t._replace(
            atoms=index_map[jnp.minimum(t.atoms, index_map.shape[0] - 1)]
        )
        return BondedSystem(
            bonds=re(self.bonds), angles=re(self.angles),
            torsions=re(self.torsions), impropers=re(self.impropers),
        )


# ---------------------------------------------------------------------------
# Analytic forces (hand gradients): one gather set + one scatter set, vs
# autodiff's forward + recomputed backward — halves the gather/scatter
# traffic that dominates bonded-term cost.  Differential-tested against
# jax.grad of the energies above.
# ---------------------------------------------------------------------------


def _scatter_add3(forces, idx, contrib):
    return forces.at[idx].add(contrib)


def bond_force_rows(positions, box, table: BondTable):
    """(idx, contrib) scatter rows of the bond forces — callers combine the
    rows of EVERY term family (and the exclusion leftover correction) into
    one scatter-add: XLA's per-scatter fixed cost dominates small tables."""
    n = positions.shape[0]
    i = jnp.minimum(table.atoms[:, 0], n - 1)
    j = jnp.minimum(table.atoms[:, 1], n - 1)
    rv = _disp(positions, box, i, j)
    r = jnp.sqrt(jnp.sum(rv * rv, axis=-1) + 1e-30)
    # E = ½k(r−r0)² ⇒ f_i = −k(r−r0)·r̂, f_j = +k(r−r0)·r̂.
    coef = jnp.where(table.valid, -table.k * (r - table.length) / r, 0.0)
    f_i = coef[:, None] * rv
    return jnp.concatenate([i, j]), jnp.concatenate([f_i, -f_i])


def bond_forces_into(forces, positions, box, table: BondTable):
    idx, contrib = bond_force_rows(positions, box, table)
    return _scatter_add3(forces, idx, contrib)


def angle_forces_into(forces, positions, box, table: AngleTable):
    idx, contrib = angle_force_rows(positions, box, table)
    return _scatter_add3(forces, idx, contrib)


def angle_force_rows(positions, box, table: AngleTable):
    n = positions.shape[0]
    i = jnp.minimum(table.atoms[:, 0], n - 1)
    j = jnp.minimum(table.atoms[:, 1], n - 1)
    k = jnp.minimum(table.atoms[:, 2], n - 1)
    a = _disp(positions, box, i, j)  # x_i − x_j
    b = _disp(positions, box, k, j)
    la = jnp.sqrt(jnp.sum(a * a, axis=-1) + 1e-30)
    lb = jnp.sqrt(jnp.sum(b * b, axis=-1) + 1e-30)
    ah = a / la[:, None]
    bh = b / lb[:, None]
    cos_t = jnp.clip(jnp.sum(ah * bh, axis=-1), -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 1e-12))
    # E = ½k(θ−θ0)²; ∂θ/∂x_i = (cosθ·â − b̂)/(|a| sinθ).
    dE = jnp.where(table.valid, table.k * (theta - table.theta0), 0.0)
    gi = (cos_t[:, None] * ah - bh) / (la * sin_t)[:, None]
    gk = (cos_t[:, None] * bh - ah) / (lb * sin_t)[:, None]
    f_i = -dE[:, None] * gi
    f_k = -dE[:, None] * gk
    return jnp.concatenate([i, k, j]), jnp.concatenate([f_i, f_k, -(f_i + f_k)])


def torsion_forces_into(forces, positions, box, table: TorsionTable):
    idx, contrib = torsion_force_rows(positions, box, table)
    return _scatter_add3(forces, idx, contrib)


def torsion_force_rows(positions, box, table: TorsionTable):
    n = positions.shape[0]
    ii = jnp.minimum(table.atoms[:, 0], n - 1)
    jj = jnp.minimum(table.atoms[:, 1], n - 1)
    kk = jnp.minimum(table.atoms[:, 2], n - 1)
    ll = jnp.minimum(table.atoms[:, 3], n - 1)
    b1 = _disp(positions, box, jj, ii)  # x_j − x_i
    b2 = _disp(positions, box, kk, jj)
    b3 = _disp(positions, box, ll, kk)
    val = table.valid[:, None]
    b1 = jnp.where(val, b1, jnp.asarray([1.0, 0.0, 0.0], b1.dtype))
    b2 = jnp.where(val, b2, jnp.asarray([0.0, 1.0, 0.0], b2.dtype))
    b3 = jnp.where(val, b3, jnp.asarray([0.0, 0.0, 1.0], b3.dtype))
    n1 = jnp.cross(b1, b2)
    n2 = jnp.cross(b2, b3)
    l2 = jnp.sqrt(jnp.sum(b2 * b2, axis=-1) + 1e-30)
    m1 = jnp.cross(n1, b2 / l2[:, None])
    x = jnp.sum(n1 * n2, axis=-1)
    y = jnp.sum(m1 * n2, axis=-1)
    phi = jnp.arctan2(y, x)
    # E = Σ_p k_p (1 + cos(p·φ − φ0_p)) ⇒ dE/dφ = −Σ k_p·p·sin(p·φ − φ0_p).
    dE = -jnp.sum(
        table.k * table.periodicity * jnp.sin(table.periodicity * phi[:, None] - table.phase),
        axis=-1,
    )
    dE = jnp.where(table.valid, dE, 0.0)
    # Standard dihedral gradient, signed for THIS φ convention
    # (φ = atan2((n1×b̂2)·n2, n1·n2) with b1 = x_j−x_i):
    #   ∂φ/∂x_i = +|b2|/|n1|² · n1,   ∂φ/∂x_l = −|b2|/|n2|² · n2
    # (differentially verified against jax.grad of torsion_energy);
    # f_j, f_k from torque balance.
    inv_n1 = 1.0 / (jnp.sum(n1 * n1, axis=-1) + 1e-30)
    inv_n2 = 1.0 / (jnp.sum(n2 * n2, axis=-1) + 1e-30)
    dphi_di = (l2 * inv_n1)[:, None] * n1
    dphi_dl = (-(l2 * inv_n2))[:, None] * n2
    s12 = (jnp.sum(b1 * b2, axis=-1) / (l2 * l2))[:, None]
    s32 = (jnp.sum(b3 * b2, axis=-1) / (l2 * l2))[:, None]
    dphi_dj = -(1.0 + s12) * dphi_di + s32 * dphi_dl
    dphi_dk = s12 * dphi_di - (1.0 + s32) * dphi_dl
    f_i = -dE[:, None] * dphi_di
    f_j = -dE[:, None] * dphi_dj
    f_k = -dE[:, None] * dphi_dk
    f_l = -dE[:, None] * dphi_dl
    return (
        jnp.concatenate([ii, jj, kk, ll]),
        jnp.concatenate([f_i, f_j, f_k, f_l]),
    )


def bonded_force_rows(positions, box, system: "BondedSystem"):
    """Concatenated (idx, contrib) scatter rows of every bonded term family.

    Callers fold these (plus any other slot-space per-pair rows, e.g. the
    exclusion leftover correction) into ONE `forces.at[idx].add(contrib)` —
    a single large scatter amortizes XLA's per-scatter fixed cost, which
    dominates the small tables."""
    idxs, contribs = [], []
    for table, rows in (
        (system.bonds, bond_force_rows),
        (system.angles, angle_force_rows),
        (system.torsions, torsion_force_rows),
        (system.impropers, torsion_force_rows),
    ):
        if table is not None:
            idx, contrib = rows(positions, box, table)
            idxs.append(idx)
            contribs.append(contrib)
    if not idxs:
        return (
            jnp.zeros((0,), jnp.int32),
            jnp.zeros((0, positions.shape[-1]), positions.dtype),
        )
    return jnp.concatenate(idxs), jnp.concatenate(contribs)


def bonded_forces_analytic(positions, box, system: "BondedSystem"):
    """−∇E of all bonded terms via hand gradients (one gather/scatter set)."""
    idx, contrib = bonded_force_rows(positions, box, system)
    return jnp.zeros_like(positions).at[idx].add(contrib)
