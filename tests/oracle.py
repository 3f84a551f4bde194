"""Float64 NumPy all-pairs oracle.

The slow, obviously-correct golden reference every fast path must match
elementwise — the role `naively_compute_nonbonded!` plays in the reference
(nonbonded.jl:122-155), upgraded to float64 and symmetric tolerances
(the reference's one-sided `maximum(a .- b)` check is a latent weakness,
SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np

from emdee_tpu.utils.reference_f64 import lj_interaction_f64


def allpairs_oracle(positions, L, rc, rs, half_sigma, twice_sqrt_eps,
                    parity_mode=False, exclusion_scale=None):
    """O(N²) double loop in float64.

    Returns per-atom (forces (N,3), energies (N,), virials (N,)) with the
    reference's half-split convention (nonbonded.jl:142-145).
    exclusion_scale: optional dict {(i, j): scale} with i<j applying a scale
    factor to specific pairs (0 for exclusions, lj14scale for 1-4 pairs).
    """
    pos = np.asarray(positions, np.float64)
    n = pos.shape[0]
    hs = np.broadcast_to(np.asarray(half_sigma, np.float64), (n,))
    te = np.broadcast_to(np.asarray(twice_sqrt_eps, np.float64), (n,))
    forces = np.zeros((n, 3))
    energies = np.zeros(n)
    virials = np.zeros(n)
    s = pos / L
    for i in range(n - 1):
        ds = s[i] - s[i + 1 :]
        rv = L * (ds - np.round(ds))
        r2 = np.sum(rv * rv, axis=1)
        E, mrE = lj_interaction_f64(r2, rc, rs, hs[i], te[i], hs[i + 1 :], te[i + 1 :],
                                    parity_mode=parity_mode)
        if exclusion_scale:
            for j in range(i + 1, n):
                scale = exclusion_scale.get((i, j))
                if scale is not None:
                    E[j - i - 1] *= scale
                    mrE[j - i - 1] *= scale
        fij = (mrE / r2)[:, None] * rv
        forces[i] += fij.sum(axis=0)
        forces[i + 1 :] -= fij
        energies[i] += 0.5 * E.sum()
        energies[i + 1 :] += 0.5 * E
        virials[i] += 0.5 * mrE.sum()
        virials[i + 1 :] += 0.5 * mrE
    return forces, energies, virials
