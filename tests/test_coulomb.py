"""DSF Coulomb electrostatics tests."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from emdee_tpu.neighbors.api import NonbondedConfig, make_force_fn
from emdee_tpu.potentials.coulomb import DSFCoulomb, coulomb_interaction, erfc_chebyshev
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom
from emdee_tpu.utils.lattice import cubic_lattice
from tests.conftest import reference_data_path


def _dsf_f64(r, rc, alpha, qq):
    erfc = math.erfc
    g = lambda x: erfc(alpha * x) / x**2 + (2 * alpha / math.sqrt(math.pi)) * math.exp(
        -((alpha * x) ** 2)
    ) / x
    if r >= rc:
        return 0.0, 0.0
    e = qq * (erfc(alpha * r) / r - erfc(alpha * rc) / rc + g(rc) * (r - rc))
    mre = qq * r * (g(r) - g(rc))
    return e, mre


def test_dsf_matches_f64():
    model = DSFCoulomb.create(3.0, alpha=0.3, coulomb_constant=1.0)
    for r in (0.5, 1.0, 2.0, 2.9, 3.0, 4.0):
        e, mre = coulomb_interaction(jnp.float32(r * r), model, 0.8, -0.4)
        e64, mre64 = _dsf_f64(r, 3.0, 0.3, 0.8 * -0.4)
        assert float(e) == pytest.approx(e64, abs=2e-6), r
        assert float(mre) == pytest.approx(mre64, abs=2e-6), r


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (1.0, 3.0), (3.0, 6.0)])
def test_erfc_chebyshev_matches_erfc(lo, hi):
    """The kernel's erfc (exp and arithmetic only) keeps the float64 erfc's
    relative accuracy to ~1e-6 over the α·r range DSF evaluates."""
    x = np.linspace(lo, hi, 257)
    got = np.asarray(erfc_chebyshev(jnp.asarray(x, jnp.float32)), np.float64)
    want = np.array([math.erfc(v) for v in x])
    assert np.max(np.abs(got - want) / want) < 2e-6


@pytest.mark.parametrize("r", [0.8, 1.7, 2.9])
def test_dsf_with_kernel_erfc(r):
    """`coulomb_interaction(..., erfc_fn=erfc_chebyshev)` — the form the GPU
    kernel evaluates — agrees with the float64 DSF pair."""
    model = DSFCoulomb.create(3.0, alpha=0.3, coulomb_constant=1.0)
    e, mre = coulomb_interaction(
        jnp.float32(r * r), model, jnp.float32(1.0), jnp.float32(-0.5),
        erfc_fn=erfc_chebyshev,
    )
    e_ref, mre_ref = _dsf_f64(r, 3.0, 0.3, -0.5)
    assert float(e) == pytest.approx(e_ref, rel=1e-5, abs=1e-7)
    assert float(mre) == pytest.approx(mre_ref, rel=1e-5, abs=1e-7)


def test_dsf_smooth_at_cutoff():
    model = DSFCoulomb.create(3.0, alpha=0.25)
    eps = 1e-3
    e_lo, f_lo = coulomb_interaction(jnp.float32((3.0 - eps) ** 2), model, 1.0, 1.0)
    assert abs(float(e_lo)) < 1e-3
    assert abs(float(f_lo)) < 5e-3


def test_allpairs_with_charges_vs_bruteforce():
    rng = np.random.default_rng(5)
    n = 64
    pos, L = cubic_lattice(n, 0.3, jitter=0.2, seed=5)
    q = rng.choice([0.5, -0.5], size=n)
    q -= q.mean()
    cfg = NonbondedConfig(cutoff=2.5, switch=2.0, method="allpairs",
                          coulomb_alpha=0.3, coulomb_constant=1.0)
    nb = make_force_fn(cfg, lennard_jones_atom(np.ones(n), np.ones(n)), L, n,
                       charges=q)
    out = nb.compute(jnp.asarray(pos, jnp.float32), ())
    # Brute-force f64: LJ (true-cutoff) + DSF.
    from tests.oracle import lj_interaction_f64

    e_tot = 0.0
    f_ref = np.zeros((n, 3))
    for i in range(n):
        for j in range(i + 1, n):
            d = pos[i] - pos[j]
            d -= L * np.round(d / L)
            r2 = (d**2).sum()
            e, mre = lj_interaction_f64(r2, 2.5, 2.0, 0.5, 2.0, 0.5, 2.0)
            if r2 >= 2.5**2:
                e, mre = 0.0, 0.0
            ec, mrec = _dsf_f64(np.sqrt(r2), 2.5, 0.3, q[i] * q[j])
            e_tot += e + ec
            f = (mre + mrec) / r2 * d
            f_ref[i] += f
            f_ref[j] -= f
    assert float(out.energies.sum()) == pytest.approx(e_tot, abs=2e-3)
    np.testing.assert_allclose(np.asarray(out.forces), f_ref, atol=2e-3)


def test_neighborlist_with_charges_matches_allpairs():
    rng = np.random.default_rng(6)
    n = 1000
    pos, L = cubic_lattice(n, 0.5, jitter=0.15, seed=6)
    q = rng.choice([0.4, -0.4], size=n)
    q -= q.mean()
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    kw = dict(coulomb_alpha=0.25, coulomb_constant=1.0)
    ap = make_force_fn(NonbondedConfig(cutoff=2.5, switch=2.0, method="allpairs", **kw),
                       params, L, n, charges=q)
    nl = make_force_fn(NonbondedConfig(cutoff=2.5, switch=2.0, method="neighbor_list",
                                       skin=0.4, **kw), params, L, n, charges=q)
    pos_j = jnp.asarray(pos, jnp.float32)
    ref = ap.compute(pos_j, ())
    aux = nl.init(pos_j)
    out = nl.compute(pos_j, aux)
    np.testing.assert_allclose(np.asarray(out.forces), np.asarray(ref.forces),
                               rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(out.energies), np.asarray(ref.energies),
                               rtol=1e-4, atol=2e-4)


@pytest.mark.skipif(
    reference_data_path("dibenzo-p-dioxin-in-water.xml") is None,
    reason="reference fixtures not mounted",
)
def test_charged_molecular_system():
    """Full pipeline with electrostatics: water box with real charges and
    independent lj/coulomb 1-4 scaling."""
    from emdee_tpu.modelling.forcefield import ForceField
    from emdee_tpu.modelling.system import System
    from emdee_tpu.potentials.coulomb import KJMOL_ANGSTROM

    ff = ForceField(reference_data_path("dibenzo-p-dioxin-in-water.xml"))
    system = System(reference_data_path("dibenzo-p-dioxin-in-water.pdb"), ff)
    n = len(system)
    pairs, lj_s, c_s = system.exclusions(coulomb=True)
    assert not np.array_equal(lj_s, c_s)  # lj14=0.5 vs coulomb14=0.833…
    nb = make_force_fn(
        NonbondedConfig(cutoff=9.0, switch=8.0, method="allpairs",
                        coulomb_alpha=0.2, coulomb_constant=KJMOL_ANGSTROM),
        system.lj_params(length_scale=10.0), float(system.box_lengths[0]), n,
        exclusion_pairs=jnp.asarray(pairs), exclusion_scales=jnp.asarray(lj_s),
        charges=system.charges, exclusion_scales_coulomb=jnp.asarray(c_s),
    )
    out = nb.compute(jnp.asarray(system.positions, jnp.float32), ())
    e = float(out.energies.sum())
    assert np.isfinite(e)
    # Water with charges must be strongly cohesive (negative total energy).
    assert e < 0, e
