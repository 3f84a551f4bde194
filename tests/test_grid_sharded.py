"""3D grid-sharded dense-cell engine on the virtual 8-device CPU mesh:
(2,2,2), (2,4,1) and (8,1,1) decompositions must reproduce the single-chip
engine; Newton-3 reaction halos and shift-rebin migration included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from emdee_tpu.distributed.grid_sharded import (
    distribute_grid,
    gather_grid_atoms,
    make_grid_mesh,
    make_grid_sharded_sim,
    validate_grid_config,
)
from emdee_tpu.neighbors.cell_dense import (
    cell_dense_forces,
    cell_dense_init,
    gather_dense_atoms,
    make_cell_dense_sim,
    suggest_cell_dense_config,
)
from emdee_tpu.potentials.lennard_jones import LennardJonesModel, lennard_jones_atom
from emdee_tpu.utils.lattice import cubic_lattice, maxwell_boltzmann

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 (virtual) devices"
)


def _setup(n=4096, density=0.25, T=0.9, seed=21):
    pos, L = cubic_lattice(n, density, jitter=0.1, seed=seed)
    vel = maxwell_boltzmann(n, T, seed=seed + 1)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = suggest_cell_dense_config(n, L, cutoff=2.5, switch=2.0, skin=0.3)
    m = (config.cells_per_dim // 8) * 8
    if m < 8:
        m = 8
    config = config._replace(cells_per_dim=m)
    model = LennardJonesModel.create(2.5, 2.0)
    st = cell_dense_init(pos, vel, np.ones(n), params, config)
    assert not bool(st.overflow)
    return st, config, model, n


def test_validate():
    st, config, model, n = _setup()
    mesh = make_grid_mesh((2, 2, 2))
    assert validate_grid_config(config, mesh) == (config.cells_per_dim // 2,) * 3
    bad = config._replace(cells_per_dim=config.cells_per_dim + 1)
    with pytest.raises(ValueError, match="divide"):
        validate_grid_config(bad, mesh)


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 4, 1), (4, 1, 1)])
def test_grid_energy_matches_single_chip(shape):
    st, config, model, n = _setup()
    mesh = make_grid_mesh(shape)
    st_sh = distribute_grid(st, config, mesh)
    rollout, energy = make_grid_sharded_sim(config, model, 0.002, mesh, backend="xla")
    pe, vir, ke = energy(st_sh)

    _, e_ref, w_ref = cell_dense_forces(st, model, config, compute_energy=True)
    np.testing.assert_allclose(
        float(pe), float(jnp.where(st.valid, e_ref, 0).sum()), rtol=1e-5, atol=1e-2
    )
    np.testing.assert_allclose(
        float(vir), float(jnp.where(st.valid, w_ref, 0).sum()), rtol=1e-5, atol=1e-2
    )


@pytest.mark.parametrize("shape", [(2, 2, 2), (2, 4, 1)])
def test_grid_rollout_matches_single_chip(shape):
    st, config, model, n = _setup(n=2048, density=0.09)
    rollout_1, _ = make_cell_dense_sim(config, model, dt=0.002, backend="xla")
    ref = rollout_1(st, num_steps=30, rebin_every=5)
    assert not bool(ref.overflow)

    mesh = make_grid_mesh(shape)
    st_sh = distribute_grid(st, config, mesh)
    rollout_n, _ = make_grid_sharded_sim(config, model, 0.002, mesh, backend="xla")
    out = rollout_n(st_sh, num_steps=30, rebin_every=5)
    assert not bool(out.overflow)
    assert int(out.step) == 30

    p_ref, v_ref = gather_dense_atoms(ref, n)
    p_out, v_out = gather_grid_atoms(out, config, n)
    np.testing.assert_allclose(p_out, p_ref, atol=2e-4)
    np.testing.assert_allclose(v_out, v_ref, atol=2e-4)


@pytest.mark.full
def test_grid_energy_conservation():
    st, config, model, n = _setup(n=4096, density=0.25, T=0.8)
    mesh = make_grid_mesh((2, 2, 2))
    st_sh = distribute_grid(st, config, mesh)
    rollout, energy = make_grid_sharded_sim(config, model, 0.002, mesh, backend="xla")
    st_sh = rollout(st_sh, num_steps=100, rebin_every=2)  # settle hot start
    st_sh = st_sh._replace(overflow=jnp.asarray(False))
    pe0, _, ke0 = (float(x) for x in energy(st_sh))
    st_sh = rollout(st_sh, num_steps=200, rebin_every=5)
    assert not bool(st_sh.overflow)
    pe1, _, ke1 = (float(x) for x in energy(st_sh))
    assert abs((pe1 + ke1) - (pe0 + ke0)) / max(ke0, 1.0) < 5e-4


def test_grid_molecular_matches_single_chip():
    """Charged system with kernel-exclusion tags on the 3D grid-sharded
    engine ≡ the single-chip molecular engine (CPU mesh): exclusion tags,
    DSF charges in the halos, and the collectives together."""
    from emdee_tpu.neighbors.cell_dense_molecular import (
        build_exclusion_tables,
        make_molecular_dense_sim,
    )
    from emdee_tpu.potentials.coulomb import DSFCoulomb

    n = 2048
    pos, L = cubic_lattice(n, 0.09, jitter=0.1, seed=31)
    vel = maxwell_boltzmann(n, 0.9, seed=32)
    q = np.where(np.arange(n) % 2 == 0, 0.25, -0.25).astype(np.float32)
    q -= q.mean()
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = suggest_cell_dense_config(n, L, cutoff=2.5, switch=2.0, skin=0.3)
    m = max((config.cells_per_dim // 2) * 2, 4)
    config = config._replace(cells_per_dim=m)
    model = LennardJonesModel.create(2.5, 2.0)
    coul = DSFCoulomb.create(2.5, alpha=0.25, coulomb_constant=1.0)
    base = np.arange(0, n - 2, 3)
    pairs = np.concatenate(
        [np.stack([base, base + 1], 1), np.stack([base + 1, base + 2], 1)]
    )
    ljs = np.full(len(pairs), 0.5, np.float32)
    cs = np.full(len(pairs), 0.8, np.float32)
    tabs = build_exclusion_tables(n, pairs, ljs, cs)

    st = cell_dense_init(pos, vel, np.ones(n), params, config, charges=q)
    assert not bool(st.overflow)

    # Single-chip molecular reference (kernel-exclusion mode, XLA backend).
    rollout_1, energy_1 = make_molecular_dense_sim(
        config, model, 0.002, n, params=params, charges=q, coulomb=coul,
        exclusion_pairs=jnp.asarray(pairs, jnp.int32),
        exclusion_scales=jnp.asarray(ljs),
        exclusion_scales_coulomb=jnp.asarray(cs),
        backend="xla", exclusion_mode="kernel",
    )
    ref = rollout_1(st, num_steps=20, rebin_every=5)
    assert not bool(ref.overflow)
    pe_ref = float(energy_1(st)[0])

    mesh = make_grid_mesh((2, 2, 2))
    from emdee_tpu.distributed.grid_sharded import distribute_grid as dist

    st_sh = dist(st, config, mesh)
    rollout_n, energy_n = make_grid_sharded_sim(
        config, model, 0.002, mesh, backend="xla", coulomb=coul,
        excl_tables=tabs,
    )
    pe_sh = float(energy_n(st_sh)[0])
    assert pe_sh == pytest.approx(pe_ref, rel=1e-5, abs=1e-2)

    out = rollout_n(st_sh, num_steps=20, rebin_every=5)
    assert not bool(out.overflow)
    p_ref, v_ref = gather_dense_atoms(ref, n)
    p_out, v_out = gather_grid_atoms(out, config, n)
    np.testing.assert_allclose(p_out, p_ref, atol=2e-4)
    np.testing.assert_allclose(v_out, v_ref, atol=2e-4)


@pytest.mark.full
def test_grid_bonded_leftover_matches_single_chip():
    """Full molecular decomposition on the 3D grid-sharded engine — bonded
    terms (bonds/angles/torsions, owner-computes on the extended ghost grid)
    and beyond-band exclusion leftovers — ≡ the single-chip molecular engine
    with the same exclusion band, on the reference's dioxin-in-water fixture
    tiled 2× (12152 atoms, real amber-style topology, E up to 13)."""
    from tests.conftest import reference_data_path

    if reference_data_path("dibenzo-p-dioxin-in-water.xml") is None:
        pytest.skip("reference fixtures not mounted")
    from tests.test_cell_dense_molecular import _fixture_system, _tile_system

    from emdee_tpu.modelling.bonded import build_bonded_system
    from emdee_tpu.neighbors.cell_dense_molecular import (
        build_exclusion_tables,
        make_molecular_dense_sim,
    )
    from emdee_tpu.potentials.coulomb import KJMOL_ANGSTROM, DSFCoulomb

    system = _tile_system(_fixture_system(), reps=2)
    n = len(system)
    box = float(system.box_lengths[0])
    params = system.lj_params(10.0)
    q = np.asarray(system.charges, np.float32)
    pairs, ljs, cs = system.exclusions(coulomb=True)
    bonded = build_bonded_system(system, length_scale=10.0)
    rng = np.random.default_rng(44)
    vel = rng.normal(scale=0.05, size=(n, 3))

    config = suggest_cell_dense_config(n, box, cutoff=7.0, switch=6.0, skin=1.0)
    assert config.cells_per_dim == 6
    model = LennardJonesModel.create(7.0, 6.0)
    coul = DSFCoulomb.create(7.0, alpha=0.2, coulomb_constant=KJMOL_ANGSTROM)
    band = 4
    tabs, leftover = build_exclusion_tables(n, pairs, ljs, cs, band_e=band)
    assert leftover[0].shape[0] > 0  # the band must actually split something

    st = cell_dense_init(
        system.positions, vel, np.asarray(system.masses), params, config,
        charges=q,
    )
    assert not bool(st.overflow)

    rollout_1, energy_1 = make_molecular_dense_sim(
        config, model, 2e-4, n, params=params, charges=q, coulomb=coul,
        exclusion_pairs=jnp.asarray(pairs, jnp.int32),
        exclusion_scales=jnp.asarray(ljs, jnp.float32),
        exclusion_scales_coulomb=jnp.asarray(cs, jnp.float32),
        bonded=bonded, backend="xla", exclusion_mode="kernel",
        exclusion_band=band,
    )
    pe_ref, vir_ref, _ = (float(x) for x in energy_1(st))
    ref = rollout_1(st, num_steps=8, rebin_every=4)
    assert not bool(ref.overflow)

    mesh = make_grid_mesh((2, 2, 2))
    st_sh = distribute_grid(st, config, mesh)
    rollout_n, energy_n = make_grid_sharded_sim(
        config, model, 2e-4, mesh, backend="xla", coulomb=coul,
        excl_tables=tabs, bonded=bonded, excl_leftover=leftover,
        atom_params=params, atom_charges=q,
    )
    pe_sh, vir_sh, _ = (float(x) for x in energy_n(st_sh))
    assert pe_sh == pytest.approx(pe_ref, rel=2e-5, abs=0.5)
    assert vir_sh == pytest.approx(vir_ref, rel=2e-5, abs=0.5)

    out = rollout_n(st_sh, num_steps=8, rebin_every=4)
    assert not bool(out.overflow)
    p_ref, v_ref = gather_dense_atoms(ref, n)
    p_out, v_out = gather_grid_atoms(out, config, n)
    np.testing.assert_allclose(p_out % box, p_ref % box, atol=1e-3)
    np.testing.assert_allclose(v_out, v_ref, atol=1e-2)


import pytest as _pytest


@_pytest.mark.parametrize(
    "kind",
    [
        # Statistical relaxation gates are slow (207 s measured for csvr on
        # the CI box); the dense-engine thermostat relax test stays quick.
        _pytest.param("csvr", marks=_pytest.mark.full),
        _pytest.param("langevin", marks=_pytest.mark.full),
    ],
)
def test_grid_thermostat_relaxes_to_target(kind):
    """Thermostats on the 3D grid-sharded engine: CSVR (KE psum + replicated
    key → identical global rescale on all shards) and Langevin (per-shard
    noise via key fold-in).  Starting cold, the sharded rollout must heat to
    the target temperature — and NVE rollouts must be bitwise-unchanged by
    the rng plumbing."""
    import jax

    from emdee_tpu.neighbors.cell_dense import CSVRConfig, LangevinConfig

    st, config, model, n = _setup(n=1024, density=0.12, T=0.2)
    mesh = make_grid_mesh((2, 2, 2))
    st_sh = distribute_grid(st, config, mesh)
    thermostat = (
        CSVRConfig(temperature=1.0, tau=0.2)
        if kind == "csvr"
        else LangevinConfig(temperature=1.0, friction=2.0)
    )
    r_nvt, _ = make_grid_sharded_sim(
        config, model, 0.004, mesh, backend="xla", thermostat=thermostat,
    )
    out = r_nvt(st_sh, num_steps=500, rebin_every=5, rng=jax.random.PRNGKey(4))
    assert not bool(out.overflow)
    v = np.asarray(out.velocities)
    valid = np.asarray(out.valid)
    t1 = float((v[valid] ** 2).sum()) / (3.0 * n - 3.0)
    assert 0.8 < t1 < 1.25

    r_nve, _ = make_grid_sharded_sim(config, model, 0.004, mesh, backend="xla")
    a = r_nve(st_sh, num_steps=20, rebin_every=5)
    b = r_nve(st_sh, num_steps=20, rebin_every=5, rng=jax.random.PRNGKey(9))
    np.testing.assert_array_equal(np.asarray(a.positions), np.asarray(b.positions))


@pytest.mark.full
def test_grid_npt_relaxes_pressure():
    """Berendsen NPT on the 3D grid-sharded engine: pressure from a psum'd
    energy pass, μ-rescale of positions + the replicated dynamic box at
    rebin boundaries.  From a compressed liquid above the target pressure,
    the box must expand and the pressure must move toward the target."""
    import jax

    from emdee_tpu.neighbors.cell_dense import (
        BerendsenBarostatConfig,
        CSVRConfig,
        _state_box,
    )
    from emdee_tpu.utils.lattice import fcc_lattice

    pos, box = fcc_lattice(7, density=0.85)  # 1372 atoms, box ≈ 11.7
    n = pos.shape[0]
    vel = maxwell_boltzmann(n, 1.0, seed=31)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.35)
    assert config.cells_per_dim == 4  # h = box/4 ≈ 2.93 ≥ rc + skin
    model = LennardJonesModel.create(2.5, 2.0)
    st = cell_dense_init(pos, vel, np.ones(n), params, config)
    assert not bool(st.overflow)

    mesh = make_grid_mesh((2, 1, 1))
    st_sh = distribute_grid(st, config, mesh)
    target_p = 0.5
    nvt, energy = make_grid_sharded_sim(
        config, model, 0.004, mesh, backend="xla",
        thermostat=CSVRConfig(temperature=1.0, tau=0.2),
    )
    npt, _ = make_grid_sharded_sim(
        config, model, 0.004, mesh, backend="xla",
        thermostat=CSVRConfig(temperature=1.0, tau=0.2),
        barostat=BerendsenBarostatConfig(pressure=target_p, tau=0.4, kappa=1.0),
    )

    def pressure(state):
        pe, vir, ke = (float(x) for x in energy(state))
        b = float(_state_box(state, config))
        return (2.0 * ke + vir) / (3.0 * b**3)

    st_sh = nvt(st_sh, num_steps=300, rebin_every=5, rng=jax.random.PRNGKey(7))
    assert not bool(st_sh.overflow)
    p0 = pressure(st_sh)
    assert p0 > 1.5

    out = npt(st_sh, num_steps=600, rebin_every=5, rng=jax.random.PRNGKey(13))
    assert not bool(out.overflow)
    b1 = float(out.box)
    assert b1 > box * 1.01
    p1 = pressure(out)
    assert abs(p1 - target_p) < 0.5 * abs(p0 - target_p)


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret", "pallas_streaming"])
def test_grid_removed_backends_raise(backend):
    """Per-shard backends that no longer exist are refused, not resolved to
    something else."""
    st, config, model, n = _setup(n=512, density=0.1)
    with pytest.raises(ValueError, match="unknown grid-sharded backend"):
        make_grid_sharded_sim(config, model, 0.002, make_grid_mesh((2, 2, 2)),
                              backend=backend)
