"""A periodic box of flexible three-site water, built from a seed.

No input files: SPC/E charges and O–O Lennard-Jones (Berendsen, Grigera &
Straatsma, J. Phys. Chem. 91, 6269 (1987)) on the SPC/E geometry, with
flexible O–H bonds and H–O–H angle carrying the SPC/Fw force constants (Wu,
Tepper & Voth, J. Chem. Phys. 124, 024503 (2006)).  Molecules sit on a
simple-cubic lattice with seeded random orientations.

Units: Å, amu, e, kJ/mol — the time unit is then 0.1 ps (1 kJ/mol =
1 amu·Å²/(0.1 ps)²), so a 0.5 fs step is dt = 0.005.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from emdee_tpu.core.types import LJParams
from emdee_tpu.potentials.bonded import AngleTable, BondedSystem, BondTable
from emdee_tpu.potentials.lennard_jones import lennard_jones_atom

KB_KJMOL = 0.0083144626  # Boltzmann constant, kJ/mol/K
FS = 0.01  # one femtosecond in the 0.1 ps time unit

Q_O, Q_H = -0.8476, 0.4238
SIGMA_O, EPSILON_O = 3.166, 0.650  # Å, kJ/mol
R_OH = 1.0  # Å
THETA_HOH = np.deg2rad(109.47)
K_BOND = 1059.162 * 4.184  # kJ/mol/Å², E = ½k(r − r₀)²
K_ANGLE = 75.90 * 4.184  # kJ/mol/rad², E = ½k(θ − θ₀)²
MASS_O, MASS_H = 15.9994, 1.008


class WaterBox(NamedTuple):
    positions: np.ndarray  # (N, 3) float64, atoms ordered O, H1, H2 per molecule
    masses: np.ndarray  # (N,)
    charges: np.ndarray  # (N,) float32
    params: LJParams  # per-atom (σ/2, 2√ε); hydrogens carry ε = 0
    bonded: BondedSystem
    exclusion_pairs: np.ndarray  # (3·molecules, 2) int32: O–H1, O–H2, H1–H2
    box: float

    @property
    def num_atoms(self) -> int:
        return self.positions.shape[0]


def _random_rotations(n: int, rng) -> np.ndarray:
    """(n, 3, 3) rotation matrices, uniform on SO(3) (unit quaternions)."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1)


def build_water_box(n_side: int, density: float = 0.0334, seed: int = 0) -> WaterBox:
    """n_side³ molecules at `density` molecules/Å³ in a cubic periodic box."""
    nmol = n_side**3
    box = float((nmol / density) ** (1.0 / 3.0))
    a = box / n_side
    grid = np.stack(
        np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1
    ).reshape(-1, 3)
    centers = (grid + 0.5) * a
    half = 0.5 * THETA_HOH
    local = np.array([
        [0.0, 0.0, 0.0],
        [R_OH * np.sin(half), R_OH * np.cos(half), 0.0],
        [-R_OH * np.sin(half), R_OH * np.cos(half), 0.0],
    ])
    rot = _random_rotations(nmol, np.random.default_rng(seed))
    pos = (centers[:, None, :] + np.einsum("mij,aj->mai", rot, local)).reshape(-1, 3)
    n = 3 * nmol

    o = 3 * np.arange(nmol)
    h1, h2 = o + 1, o + 2
    masses = np.tile([MASS_O, MASS_H, MASS_H], nmol)
    charges = np.tile([Q_O, Q_H, Q_H], nmol).astype(np.float32)
    params = lennard_jones_atom(
        np.tile([EPSILON_O, 0.0, 0.0], nmol), np.tile([SIGMA_O, 1.0, 1.0], nmol)
    )
    bond_atoms = np.concatenate([np.stack([o, h1], 1), np.stack([o, h2], 1)])
    bonded = BondedSystem(
        bonds=BondTable(
            atoms=jnp.asarray(bond_atoms, jnp.int32),
            length=jnp.full(2 * nmol, R_OH, jnp.float32),
            k=jnp.full(2 * nmol, K_BOND, jnp.float32),
            valid=jnp.ones(2 * nmol, bool),
        ),
        angles=AngleTable(
            atoms=jnp.asarray(np.stack([h1, o, h2], 1), jnp.int32),
            theta0=jnp.full(nmol, THETA_HOH, jnp.float32),
            k=jnp.full(nmol, K_ANGLE, jnp.float32),
            valid=jnp.ones(nmol, bool),
        ),
        torsions=None,
        impropers=None,
    )
    excl = np.concatenate([bond_atoms, np.stack([h1, h2], 1)]).astype(np.int32)
    assert pos.shape == (n, 3)
    return WaterBox(pos, masses, charges, params, bonded, excl, box)


def maxwell_boltzmann_kjmol(masses, temperature_k: float, seed: int = 0) -> np.ndarray:
    """(N, 3) velocities in Å per 0.1 ps at `temperature_k`, zero momentum."""
    m = np.asarray(masses, np.float64)[:, None]
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(m.shape[0], 3)) * np.sqrt(KB_KJMOL * temperature_k / m)
    v -= (m * v).sum(0) / m.sum()
    return v
