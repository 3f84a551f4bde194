"""Short-range electrostatics: damped-shifted-force (DSF) Coulomb.

Beyond-reference capability: the reference parses per-atom charges
(modelling.jl:323-327) but evaluates no electrostatics at all (SURVEY.md §0).
This module supplies the Wolf/Fennell-Gezelter damped-shifted-force form —
the standard cutoff-based Ewald substitute, smooth in both energy and force
at the cutoff, and a pure pair function that drops into every nonbonded path:

    g(r)  = erfc(αr)/r² + (2α/√π)·exp(−α²r²)/r
    E(r)  = kC·qᵢqⱼ·[ erfc(αr)/r − erfc(αrc)/rc + g(rc)·(r − rc) ]
    −r·E′ = kC·qᵢqⱼ·r·[ g(r) − g(rc) ]

with E(rc) = E′(rc) = 0 exactly.  α=0 reduces to plain shifted-force Coulomb.

Units: kC (`coulomb_constant`) converts q²/length to energy —
138.935456 for kJ/mol·nm·e (OpenMM), 1389.35456 for kJ/mol·Å·e, 1.0 for
reduced units.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.scipy.special import erfc

KJMOL_NM = 138.935456  # e²/(4πε0) in kJ/mol·nm
KJMOL_ANGSTROM = 1389.35456  # same, lengths in Å


class DSFCoulomb(NamedTuple):
    """Static DSF model constants (precomputed cutoff values)."""

    alpha: jax.Array
    rc: jax.Array
    rc2: jax.Array
    e_shift: jax.Array  # erfc(α·rc)/rc
    f_shift: jax.Array  # g(rc)
    kc: jax.Array  # Coulomb constant

    @classmethod
    def create(cls, cutoff: float, alpha: float = 0.2, coulomb_constant: float = 1.0,
               dtype=jnp.float32):
        import math

        rc = float(cutoff)
        a = float(alpha)
        erfc_rc = math.erfc(a * rc)
        g_rc = erfc_rc / rc**2 + (2.0 * a / math.sqrt(math.pi)) * math.exp(-(a * rc) ** 2) / rc
        return cls(
            alpha=jnp.asarray(a, dtype),
            rc=jnp.asarray(rc, dtype),
            rc2=jnp.asarray(rc * rc, dtype),
            e_shift=jnp.asarray(erfc_rc / rc, dtype),
            f_shift=jnp.asarray(g_rc, dtype),
            kc=jnp.asarray(coulomb_constant, dtype),
        )


def coulomb_consts(model: DSFCoulomb) -> tuple:
    """DSF constants as a hashable float tuple (alpha, rc, e_shift, f_shift,
    kc) — the compile-time-static form hand-written kernels consume."""
    return (
        float(model.alpha),
        float(model.rc),
        float(model.e_shift),
        float(model.f_shift),
        float(model.kc),
    )


_TWO_OVER_SQRT_PI = 1.1283791670955126


def erfc_chebyshev(x: jax.Array) -> jax.Array:
    """erfc(x) for x ≥ 0 from exp and arithmetic alone, with a fractional
    error below 1.2e-7 (Press et al., Numerical Recipes, §6.2 `erfcc`).
    For kernels whose compiler has no erfc primitive."""
    t = 1.0 / (1.0 + 0.5 * x)
    poly = -1.26551223 + t * (1.00002368 + t * (0.37409196 + t * (
        0.09678418 + t * (-0.18628806 + t * (0.27886807 + t * (
            -1.13520398 + t * (1.48851587 + t * (-0.82215223 + t * 0.17087277))))))))
    return t * jnp.exp(poly - x * x)


def coulomb_interaction(
    r2: jax.Array, model: DSFCoulomb, qi: jax.Array, qj: jax.Array, *,
    erfc_fn=erfc,
) -> Tuple[jax.Array, jax.Array]:
    """(E, −r·dE/dr) for the DSF pair at squared distance r².

    Zero at and beyond the cutoff (smoothly); callers mask invalid pairs by
    passing safe r² and zeroing, as with the LJ pair function.  `erfc_fn`
    lets a kernel substitute `erfc_chebyshev` where erfc does not lower.
    """
    r = jnp.sqrt(r2)
    rinv = 1.0 / r
    ar = model.alpha * r
    erfc_ar = erfc_fn(ar)
    gauss = _TWO_OVER_SQRT_PI * model.alpha * jnp.exp(-ar * ar)
    g_r = erfc_ar * rinv * rinv + gauss * rinv
    qq = model.kc * qi * qj
    inside = r2 < model.rc2
    energy = qq * (erfc_ar * rinv - model.e_shift + model.f_shift * (r - model.rc))
    minus_rE = qq * r * (g_r - model.f_shift)
    zero = jnp.zeros_like(energy)
    return jnp.where(inside, energy, zero), jnp.where(inside, minus_rE, zero)
