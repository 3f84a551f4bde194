"""The seeded flexible-water box (`modelling.water`): geometry, charges,
topology and the velocity draw."""

import numpy as np
import pytest

from emdee_tpu.modelling.water import (
    KB_KJMOL,
    Q_H,
    Q_O,
    R_OH,
    THETA_HOH,
    build_water_box,
    maxwell_boltzmann_kjmol,
)


@pytest.fixture(scope="module")
def box():
    return build_water_box(4, seed=5)


def test_water_geometry(box):
    """64 molecules at 0.0334 Å⁻³ with the SPC/E bond length and angle."""
    assert box.num_atoms == 192
    assert box.box == pytest.approx((64 / 0.0334) ** (1 / 3))
    x = box.positions.reshape(-1, 3, 3)
    d1, d2 = x[:, 1] - x[:, 0], x[:, 2] - x[:, 0]
    np.testing.assert_allclose(np.linalg.norm(d1, axis=1), R_OH, rtol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(d2, axis=1), R_OH, rtol=1e-12)
    cos = (d1 * d2).sum(1) / (R_OH * R_OH)
    np.testing.assert_allclose(np.arccos(cos), THETA_HOH, rtol=1e-9)
    # Seeded orientations: reproducible, and not all alike.
    again = build_water_box(4, seed=5)
    np.testing.assert_array_equal(again.positions, box.positions)
    assert not np.allclose(d1[0], d1[1])


def test_water_charges_and_topology(box):
    q = box.charges.reshape(-1, 3)
    np.testing.assert_allclose(q, np.tile([Q_O, Q_H, Q_H], (64, 1)))
    assert abs(float(box.charges.astype(np.float64).sum())) < 1e-5
    # Hydrogens carry no LJ well depth; oxygens the SPC/E one.
    eps = (0.5 * np.asarray(box.params.twice_sqrt_eps)) ** 2
    np.testing.assert_allclose(eps.reshape(-1, 3)[:, 1:], 0.0)
    assert eps[0] == pytest.approx(0.650, rel=1e-6)
    # 1-2 (two O-H) and 1-3 (H-H) exclusions, all within one molecule.
    pairs = box.exclusion_pairs
    assert pairs.shape == (192, 2)
    np.testing.assert_array_equal(pairs[:, 0] // 3, pairs[:, 1] // 3)
    assert int(np.asarray(box.bonded.bonds.valid).sum()) == 128
    assert int(np.asarray(box.bonded.angles.valid).sum()) == 64


def test_water_velocities(box):
    v = maxwell_boltzmann_kjmol(box.masses, 300.0, seed=2)
    m = box.masses[:, None]
    np.testing.assert_allclose((m * v).sum(0), 0.0, atol=1e-9)
    t = (m * v * v).sum() / (3 * box.num_atoms * KB_KJMOL)
    assert 200.0 < t < 400.0
