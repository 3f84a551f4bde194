"""Fidelity gates from BASELINE.md: bitwise-reproducibility of the engines
(SURVEY §5 — determinism is the answer to the reference's atomics/race
story) and the 1e-6 NVE drift target measured against the f64 oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from emdee_tpu.neighbors.cell_dense import (
    cell_dense_init,
    gather_dense_atoms,
    make_cell_dense_sim,
    suggest_cell_dense_config,
)
from emdee_tpu.potentials.lennard_jones import LennardJonesModel, lennard_jones_atom
from emdee_tpu.utils.lattice import cubic_lattice, fcc_lattice, maxwell_boltzmann


def _setup(n=2197, density=0.7, T=0.9, seed=5, skin=0.3):
    pos, L = cubic_lattice(n, density, jitter=0.1, seed=seed)
    vel = maxwell_boltzmann(n, T, seed=seed + 1)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = suggest_cell_dense_config(n, L, cutoff=2.5, switch=2.0, skin=skin)
    model = LennardJonesModel.create(2.5, 2.0)
    st = cell_dense_init(pos, vel, np.ones(n), params, config)
    return st, config, model, n


def _bits(a):
    return np.asarray(a).view(np.uint32 if np.asarray(a).dtype == np.float32 else None)


def test_bitwise_determinism_dense():
    """Two identical rollouts produce identical BITS — deterministic by
    construction (static rolls + ordered reductions, no atomics), now gated.
    """
    st, config, model, n = _setup()
    rollout, _ = make_cell_dense_sim(config, model, dt=0.002, backend="xla")
    a = rollout(st, num_steps=40, rebin_every=5)
    b = rollout(st, num_steps=40, rebin_every=5)
    np.testing.assert_array_equal(_bits(a.positions), _bits(b.positions))
    np.testing.assert_array_equal(_bits(a.velocities), _bits(b.velocities))
    np.testing.assert_array_equal(np.asarray(a.atom_id), np.asarray(b.atom_id))


@pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 (virtual) devices")
def test_bitwise_determinism_grid_sharded():
    from emdee_tpu.distributed.grid_sharded import (
        distribute_grid,
        make_grid_mesh,
        make_grid_sharded_sim,
    )

    n = 2048
    pos, L = cubic_lattice(n, 0.25, jitter=0.1, seed=5)
    vel = maxwell_boltzmann(n, 0.9, seed=6)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = suggest_cell_dense_config(n, L, cutoff=2.5, switch=2.0, skin=0.3)
    config = config._replace(cells_per_dim=max((config.cells_per_dim // 2) * 2, 4))
    model = LennardJonesModel.create(2.5, 2.0)
    st = cell_dense_init(pos, vel, np.ones(n), params, config)
    mesh = make_grid_mesh((2, 2, 2))
    st_sh = distribute_grid(st, config, mesh)
    rollout, _ = make_grid_sharded_sim(config, model, 0.002, mesh, backend="xla")
    a = rollout(st_sh, num_steps=20, rebin_every=5)
    b = rollout(st_sh, num_steps=20, rebin_every=5)
    np.testing.assert_array_equal(_bits(a.positions), _bits(b.positions))
    np.testing.assert_array_equal(_bits(a.velocities), _bits(b.velocities))


@pytest.mark.full
def test_nve_drift_1e6_f64_measured():
    """BASELINE fidelity target: NVE drift ≤ 1e-6 of KE on a ≥10k-atom
    rollout, energies measured in f64 (compensated measurement over the f32
    trajectory — the drift of the *dynamics*, not of the f32 energy sum)."""
    from tests.oracle import allpairs_oracle

    cells = 14  # 4·14³ = 10976 atoms
    pos, box = fcc_lattice(cells, density=0.8442)
    n = pos.shape[0]
    vel = maxwell_boltzmann(n, 0.7, seed=0)
    config = suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.3)
    model = LennardJonesModel.create(2.5, 2.0)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    state = cell_dense_init(pos, vel, np.ones(n), params, config)
    rollout, _ = make_cell_dense_sim(config, model, dt=0.004, backend="xla")
    state = rollout(state, num_steps=300, rebin_every=3)  # settle the melt
    assert not bool(state.overflow)

    def e_f64(st):
        p, v = gather_dense_atoms(st, n)
        _, e, _ = allpairs_oracle(
            p.astype(np.float64), float(box), 2.5, 2.0,
            0.5 * np.ones(n), 2.0 * np.ones(n),
        )
        pe = float(e.sum())
        ke = 0.5 * float((v.astype(np.float64) ** 2).sum())
        return pe, ke

    # dt=0.002 keeps the O(dt²) integrator drift below the gate; the
    # position/velocity roundoff walk that once dominated at small dt
    # (1.3-2.8e-6 over this window) is killed by the leapfrog's Kahan-
    # compensated drift+kick (r5).  Deterministic engine → a fixed value.
    run, _ = make_cell_dense_sim(config, model, dt=0.002, backend="xla")
    pe0, ke0 = e_f64(state)
    out = run(state, num_steps=500, rebin_every=4)
    assert not bool(out.overflow)
    pe1, ke1 = e_f64(out)
    drift = abs((pe1 + ke1) - (pe0 + ke0)) / ke0
    assert drift < 1.0e-6, drift
