"""Multi-device tests on the 8-way virtual CPU mesh (conftest sets
xla_force_host_platform_device_count=8) — distributed code tested without a
cluster (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from emdee_tpu.core.types import make_state
from emdee_tpu.distributed.domain import (
    ShardedState,
    distribute,
    gather_dense,
    make_sharded_step,
    redistribute,
    suggest_domain_config,
)
from emdee_tpu.distributed.mesh import make_mesh
from emdee_tpu.dynamics.verlet import nve_rollout
from emdee_tpu.neighbors.api import NonbondedConfig, make_force_fn
from emdee_tpu.potentials.lennard_jones import LennardJonesModel, lennard_jones_atom
from emdee_tpu.utils.lattice import cubic_lattice, maxwell_boltzmann

pytestmark = pytest.mark.skipif(
    jax.device_count() < 2, reason="needs multi-device (virtual) mesh"
)


def _system(n=4096, density=0.18, T=0.8, seed=7):
    # low density → big box → slabs wide enough for 4 devices
    pos, L = cubic_lattice(n, density, jitter=0.1, seed=seed)
    vel = maxwell_boltzmann(n, T, seed=seed + 1)
    return pos, vel, L


@pytest.mark.parametrize("ndev", [2, 4])
def test_distribute_roundtrip(ndev):
    pos, vel, L = _system(1024, density=0.06)
    n = pos.shape[0]
    mesh = make_mesh(ndev)
    config = suggest_domain_config(n, L, 2.5, ndev)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    st = distribute(pos, vel, np.ones(n), params, config, mesh)
    assert not bool(st.overflow)
    assert int(st.valid.sum()) == n
    # Every owned atom sits in its slab's slot block.
    ids = np.asarray(st.atom_id)
    valid = np.asarray(st.valid)
    z = np.asarray(st.positions)[:, 2]
    slot_slab = np.arange(len(ids)) // config.slot_capacity
    zslab = np.clip((z[valid] % L) / config.slab_width, 0, ndev - 1).astype(int)
    np.testing.assert_array_equal(slot_slab[valid], zslab)
    # Round trip recovers the original arrays.
    pos2, vel2 = gather_dense(st, n)
    np.testing.assert_allclose(pos2, pos.astype(np.float32), atol=1e-6)
    np.testing.assert_allclose(vel2, vel.astype(np.float32), atol=1e-6)


def test_sharded_forces_match_single_device():
    """Halo-exchanged sharded forces ≡ single-process all-pairs forces."""
    pos, vel, L = _system(2048, density=0.13)
    n = pos.shape[0]
    ndev = 4
    mesh = make_mesh(ndev)
    config = suggest_domain_config(n, L, 2.5, ndev)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    model = LennardJonesModel.create(2.5, 2.0)
    st = distribute(pos, vel, np.ones(n), params, config, mesh)
    rollout, energy_fn = make_sharded_step(config, mesh, model, dt=0.002)

    e_sharded, w_sharded = energy_fn(st)

    nb = make_force_fn(
        NonbondedConfig(cutoff=2.5, switch=2.0, method="allpairs"), params, L, n
    )
    ref = nb.compute(jnp.asarray(pos, jnp.float32), ())
    np.testing.assert_allclose(
        float(e_sharded), float(ref.energies.sum()), rtol=1e-5, atol=1e-3
    )
    np.testing.assert_allclose(
        float(w_sharded), float(ref.virials.sum()), rtol=1e-5, atol=1e-3
    )


def test_sharded_rollout_matches_single_device():
    """The full multi-chip NVE loop (redistribute + halo exchange + scan)
    reproduces the single-device trajectory."""
    pos, vel, L = _system(1500, density=0.12)
    n = pos.shape[0]
    ndev = 2
    mesh = make_mesh(ndev)
    config = suggest_domain_config(n, L, 2.5, ndev, resort_every=10)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    model = LennardJonesModel.create(2.5, 2.0)
    st = distribute(pos, vel, np.ones(n), params, config, mesh)
    rollout, energy_fn = make_sharded_step(config, mesh, model, dt=0.002)
    st = rollout(st, num_blocks=4)  # 40 steps
    assert not bool(st.overflow)
    assert int(st.step) == 40
    pos_sh, vel_sh = gather_dense(st, n)

    state = make_state(pos, vel, box=L)
    nb = make_force_fn(
        NonbondedConfig(cutoff=2.5, switch=2.0, method="allpairs"), params, L, n
    )
    ref, _, _ = nve_rollout(state, (), nb.force_fn, 0.002, 40)
    np.testing.assert_allclose(pos_sh, np.asarray(ref.positions), atol=5e-4)
    np.testing.assert_allclose(vel_sh, np.asarray(ref.velocities), atol=5e-4)


@pytest.mark.full
def test_sharded_energy_conservation():
    pos, vel, L = _system(3000, density=0.15)
    n = pos.shape[0]
    ndev = 4
    mesh = make_mesh(ndev)
    config = suggest_domain_config(n, L, 2.5, ndev, resort_every=10)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    model = LennardJonesModel.create(2.5, 2.0)
    st = distribute(pos, vel, np.ones(n), params, config, mesh)
    rollout, energy_fn = make_sharded_step(config, mesh, model, dt=0.002)

    def total_energy(s):
        ke = 0.5 * float(
            jnp.sum(jnp.where(s.valid[:, None], s.masses[:, None] * s.velocities**2, 0.0))
        )
        pe = float(energy_fn(s)[0])
        return ke + pe

    e0 = total_energy(st)
    st = rollout(st, num_blocks=10)  # 100 steps
    assert not bool(st.overflow)
    e1 = total_energy(st)
    assert abs(e1 - e0) / abs(e0) < 1e-4, (e0, e1)


def test_too_many_devices_rejected():
    with pytest.raises(ValueError, match="slab width"):
        suggest_domain_config(1000, 10.0, 2.5, 8)
