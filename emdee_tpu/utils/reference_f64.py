"""Float64 NumPy references for checks that run beside the device code.

`lj_interaction_f64` is the reference's pair math (lennard_jones.jl:25-42)
in float64; `sample_forces_f64` sums it by minimum image for a sample of
atoms against every atom — the plain reference a GPU run is checked against
at full size, where an O(N²) all-pairs oracle would not fit.
"""

from __future__ import annotations

import numpy as np


def lj_interaction_f64(r2, rc, rs, half_sigma_i, twice_sqrt_eps_i,
                       half_sigma_j, twice_sqrt_eps_j, parity_mode=False):
    """Scalar/array LJ pair math in float64 (lennard_jones.jl:25-42 semantics)."""
    rc2, rs2 = rc * rc, rs * rs
    inv_d2 = 1.0 / (rc2 - rs2)
    sigma = half_sigma_i + half_sigma_j
    eps4 = twice_sqrt_eps_i * twice_sqrt_eps_j
    s2 = sigma * sigma / r2
    s6 = s2 * s2 * s2
    e4s6 = eps4 * s6
    E = e4s6 * (s6 - 1.0)
    mrE = 6.0 * e4s6 * (2.0 * s6 - 1.0)
    x = (r2 - rs2) * inv_d2
    if parity_mode:
        x = x * 0.5 * (np.sign(x) - np.sign(x - 1.0))
    else:
        x = np.clip(x, 0.0, 1.0)
    g = 1.0 + x * x * x * (15.0 * x - 6.0 * x * x - 10.0)
    mrg = 60.0 * x * x * (1.0 - x) ** 2 * inv_d2 * r2
    return E * g, mrE * g + E * mrg


def sample_forces_f64(positions, box, rc, rs, half_sigma, twice_sqrt_eps, sample,
                      chunk: int = 8):
    """(S, 3) float64 LJ forces on atoms `sample` from every other atom,
    minimum image, true cutoff (`parity_mode=False`)."""
    pos = np.asarray(positions, np.float64)
    n = pos.shape[0]
    hs = np.broadcast_to(np.asarray(half_sigma, np.float64), (n,))
    te = np.broadcast_to(np.asarray(twice_sqrt_eps, np.float64), (n,))
    sample = np.asarray(sample)
    out = np.zeros((len(sample), 3))
    for a in range(0, len(sample), chunk):
        rows = sample[a : a + chunk]
        d = pos[rows][:, None, :] - pos[None, :, :]
        d -= box * np.round(d / box)
        r2 = np.einsum("sjk,sjk->sj", d, d)
        s, j = np.nonzero((r2 < rc * rc) & (rows[:, None] != np.arange(n)[None, :]))
        _, mre = lj_interaction_f64(r2[s, j], rc, rs, hs[rows[s]], te[rows[s]], hs[j], te[j])
        np.add.at(out, a + s, (mre / r2[s, j])[:, None] * d[s, j])
    return out
