"""Molecular systems on the dense-cell production engine: the typed/charged
System bridge (exclusions + DSF Coulomb + bonded terms) must reproduce the
neighbor-list/all-pairs path elementwise."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import reference_data_path

pytestmark = pytest.mark.skipif(
    reference_data_path("dibenzo-p-dioxin-in-water.xml") is None,
    reason="reference fixtures not mounted",
)


def _fixture_system():
    from emdee_tpu.modelling.forcefield import ForceField
    from emdee_tpu.modelling.system import System

    ff = ForceField(reference_data_path("dibenzo-p-dioxin-in-water.xml"))
    return System(reference_data_path("dibenzo-p-dioxin-in-water.pdb"), ff)


def _tile_system(system, reps=2):
    """Replicate a periodic System reps× along each axis (bigger fixture)."""
    n = len(system)
    box = float(system.box_lengths[0])
    positions, bonds, spans = [], [], []
    names, resnames, ff_types = [], [], []
    for k, (ix, iy, iz) in enumerate(itertools.product(range(reps), repeat=3)):
        off = np.array([ix, iy, iz], float) * box
        positions.append(np.asarray(system.positions) + off)
        bonds += [(a + k * n, b + k * n) for a, b in system.bonds]
        spans += [(lo + k * n, hi + k * n) for lo, hi in system.residue_spans]
        names += list(system.names)
        resnames += list(system.resnames)
        ff_types += list(system.ff_types)
    reps3 = reps**3
    from emdee_tpu.modelling.system import System

    return System(
        names=names,
        resnames=resnames,
        residue_spans=spans,
        positions=np.concatenate(positions),
        velocities=np.zeros((n * reps3, 3)),
        masses=np.tile(np.asarray(system.masses), reps3),
        bonds=bonds,
        ff_types=ff_types,
        charges=np.tile(np.asarray(system.charges), reps3),
        box_lengths=np.asarray([box * reps] * 3),
        force_field=system.force_field,
    )


def _list_path_reference(system, cutoff, switch, dt, steps, velocities):
    """Trajectory on the established neighbor-list/all-pairs molecular path."""
    from emdee_tpu.core.types import make_state
    from emdee_tpu.dynamics.verlet import nve_rollout
    from emdee_tpu.modelling.bonded import build_bonded_system
    from emdee_tpu.neighbors.api import NonbondedConfig, make_force_fn
    from emdee_tpu.potentials.coulomb import KJMOL_ANGSTROM

    n = len(system)
    box = float(system.box_lengths[0])
    params = system.lj_params(10.0)
    pairs, lj_s, c_s = system.exclusions(coulomb=True)
    nb = make_force_fn(
        NonbondedConfig(
            cutoff=cutoff, switch=switch, method="allpairs",
            coulomb_alpha=0.2, coulomb_constant=KJMOL_ANGSTROM,
        ),
        params, box, n,
        exclusion_pairs=jnp.asarray(pairs, jnp.int32),
        exclusion_scales=jnp.asarray(lj_s, jnp.float32),
        charges=jnp.asarray(system.charges, jnp.float32),
        exclusion_scales_coulomb=jnp.asarray(c_s, jnp.float32),
    )
    bonded = build_bonded_system(system, length_scale=10.0)
    bf = bonded.force_fn()

    def force_fn(positions, box_, aux):
        f, aux = nb.force_fn(positions, box_, aux)
        return f + bf(positions, box_), aux

    state = make_state(system.positions, velocities, box=box, masses=system.masses)
    final, _, _ = nve_rollout(state, nb.init(jnp.asarray(system.positions, jnp.float32)),
                              force_fn, dt, steps)
    e_tot = nb.compute(jnp.asarray(system.positions, jnp.float32), ())
    pe0 = float(jnp.sum(e_tot.energies)) + float(
        bonded.energy(jnp.asarray(system.positions, jnp.float32), jnp.float32(box))
    )
    return final, pe0


def test_molecular_dense_matches_list_path_dioxin():
    """The reference's golden system (1519 atoms, runtests.jl:48) runs NVE on
    the production dense-cell engine and matches the list path elementwise."""
    from emdee_tpu.neighbors.cell_dense import gather_dense_atoms
    from emdee_tpu.neighbors.cell_dense_molecular import dense_sim_from_system

    system = _fixture_system()
    n = len(system)
    box = float(system.box_lengths[0])
    rng = np.random.default_rng(42)
    vel = rng.normal(scale=0.05, size=(n, 3))
    dt, steps = 2e-4, 12

    state, rollout, energy, config = dense_sim_from_system(
        system, cutoff=7.0, switch=6.0, dt=dt, skin=1.0, velocities=vel,
    )
    assert not bool(state.overflow)
    pe_d, vir_d, ke_d = (float(x) for x in energy(state))

    ref, pe_ref = _list_path_reference(system, 7.0, 6.0, dt, steps, vel)
    # Total potential energy (LJ + DSF + exclusions + bonded).  The list
    # path's correction-pass subtraction of the huge overlapped bonded-pair
    # LJ terms leaves O(1 kJ/mol) cancellation residue (see
    # test_kernel_exclusions_match_correction_pass); the dense engine's
    # kernel-resident exclusion tags scale in-place, so the residual
    # difference here is the LIST path's noise, not ours.
    assert pe_d == pytest.approx(pe_ref, rel=3e-4)

    out = rollout(state, num_steps=steps, rebin_every=4)
    assert not bool(out.overflow)
    pos_d, vel_d = gather_dense_atoms(out, n)
    np.testing.assert_allclose(
        pos_d % box, np.asarray(ref.positions) % box, atol=2e-3
    )
    np.testing.assert_allclose(vel_d, np.asarray(ref.velocities), atol=1e-2)


def test_molecular_dense_spill_matches_list_path():
    """Boundary-spill balancing under the MOLECULAR engine (tags + coulomb +
    bonded): tight capacity, no overflow, trajectory matches the list path.
    This is the production geometry for real-unit water systems — spill cuts
    capacity from mean+2.5σ to mean+0.5σ and pair work scales as capacity²
    (spill cuts the capacity that pair work scales with quadratically)."""
    from emdee_tpu.neighbors.cell_dense import gather_dense_atoms
    from emdee_tpu.neighbors.cell_dense_molecular import dense_sim_from_system

    system = _fixture_system()
    n = len(system)
    box = float(system.box_lengths[0])
    rng = np.random.default_rng(42)
    vel = rng.normal(scale=0.05, size=(n, 3))
    dt, steps = 2e-4, 12

    state, rollout, energy, config = dense_sim_from_system(
        system, cutoff=7.0, switch=6.0, dt=dt, skin=1.0, velocities=vel,
        spill=True,
    )
    assert config.spill and not bool(state.overflow)
    pe_d = float(energy(state)[0])

    ref, pe_ref = _list_path_reference(system, 7.0, 6.0, dt, steps, vel)
    assert pe_d == pytest.approx(pe_ref, rel=3e-4)

    out = rollout(state, num_steps=steps, rebin_every=4)
    assert not bool(out.overflow)
    assert int(out.valid.sum()) == n
    pos_d, vel_d = gather_dense_atoms(out, n)
    np.testing.assert_allclose(
        pos_d % box, np.asarray(ref.positions) % box, atol=2e-3
    )
    np.testing.assert_allclose(vel_d, np.asarray(ref.velocities), atol=1e-2)


@pytest.mark.full
def test_kernel_exclusions_match_correction_pass():
    """The kernel-resident exclusion tags (per-pair id comparisons) and the
    atom-space correction pass are the same physics: identical energies and
    trajectories on the dioxin-water fixture."""
    from emdee_tpu.neighbors.cell_dense import gather_dense_atoms
    from emdee_tpu.neighbors.cell_dense_molecular import dense_sim_from_system

    system = _fixture_system()
    n = len(system)
    box = float(system.box_lengths[0])
    rng = np.random.default_rng(11)
    vel = rng.normal(scale=0.05, size=(n, 3))
    dt, steps = 2e-4, 10

    outs = {}
    for mode in ("kernel", "correction"):
        state, rollout, energy, config = dense_sim_from_system(
            system, cutoff=7.0, switch=6.0, dt=dt, skin=1.0, velocities=vel,
            exclusion_mode=mode,
        )
        pe = float(energy(state)[0])
        st = rollout(state, num_steps=steps, rebin_every=5)
        assert not bool(st.overflow)
        outs[mode] = (pe, *gather_dense_atoms(st, n))

    # The correction pass subtracts the huge overlapped-bonded-pair LJ terms
    # (~1e6 kJ/mol at 1 Å) computed with slightly different r² rounding than
    # the in-pass terms, leaving O(1) cancellation residue; the kernel tags
    # scale in-place (exactly zero).  Tolerances reflect that correction-mode
    # noise — the strong physics gate is kernel-mode vs the list path
    # (test_molecular_dense_matches_list_path_dioxin, which defaults to
    # kernel mode).
    pe_k, pos_k, vel_k = outs["kernel"]
    pe_c, pos_c, vel_c = outs["correction"]
    assert pe_k == pytest.approx(pe_c, rel=5e-4)
    np.testing.assert_allclose(pos_k % box, pos_c % box, atol=2e-3)
    np.testing.assert_allclose(vel_k, vel_c, atol=5e-2)


@pytest.mark.full
def test_molecular_dense_water_box_10k():
    """A ≥10k-atom water box (2×2×2 tiled fixture) on the dense engine:
    matches the list path and conserves energy over a short NVE window."""
    from emdee_tpu.neighbors.cell_dense import gather_dense_atoms
    from emdee_tpu.neighbors.cell_dense_molecular import dense_sim_from_system

    system = _tile_system(_fixture_system(), reps=2)
    n = len(system)
    assert n == 8 * 1519
    box = float(system.box_lengths[0])
    rng = np.random.default_rng(7)
    vel = rng.normal(scale=0.05, size=(n, 3))
    dt, steps = 2e-4, 6

    state, rollout, energy, config = dense_sim_from_system(
        system, cutoff=6.0, switch=5.0, dt=dt, skin=0.75, velocities=vel,
    )
    assert not bool(state.overflow)

    ref, pe_ref = _list_path_reference(system, 6.0, 5.0, dt, steps, vel)
    pe_d = float(energy(state)[0])
    assert pe_d == pytest.approx(pe_ref, rel=3e-4, abs=2e-2)

    out = rollout(state, num_steps=steps, rebin_every=4)
    assert not bool(out.overflow)
    pos_d, vel_d = gather_dense_atoms(out, n)
    np.testing.assert_allclose(pos_d % box, np.asarray(ref.positions) % box, atol=2e-3)
    np.testing.assert_allclose(vel_d, np.asarray(ref.velocities), rtol=2e-2, atol=3e-2)


@pytest.mark.full
def test_exclusion_band_split_matches_full_width():
    """Capping the kernel tag width (exclusion_band) and routing the
    remainder through the slot-space pair correction must reproduce the
    full-width kernel-tag path elementwise — the protein-scale E story."""
    from emdee_tpu.neighbors.cell_dense import gather_dense_atoms
    from emdee_tpu.neighbors.cell_dense_molecular import (
        build_exclusion_tables,
        dense_sim_from_system,
    )

    system = _fixture_system()
    n = len(system)
    pairs, lj_s, c_s = system.exclusions(coulomb=True)
    full = build_exclusion_tables(n, pairs, lj_s, c_s)
    e_full = int(full[0].shape[-1])
    assert e_full >= 3  # the band below must actually split something
    band = 2
    tabs, leftover = build_exclusion_tables(n, pairs, lj_s, c_s, band_e=band)
    assert int(tabs[0].shape[-1]) <= band and leftover[0].shape[0] > 0

    rng = np.random.default_rng(7)
    vel = rng.normal(scale=0.05, size=(n, 3))
    dt, steps = 2e-4, 8

    st_a, roll_a, energy_a, _ = dense_sim_from_system(
        system, cutoff=7.0, switch=6.0, dt=dt, skin=1.0, velocities=vel,
    )
    st_b, roll_b, energy_b, _ = dense_sim_from_system(
        system, cutoff=7.0, switch=6.0, dt=dt, skin=1.0, velocities=vel,
        exclusion_band=band,
    )
    # The slot-space correction recomputes the huge overlapped bonded-pair
    # LJ terms with minimum-image r² rounding vs the kernel's raw ghost
    # differences — the same O(1 kJ/mol) cancellation residue as the
    # atom-space correction pass (see test_kernel_exclusions_match_
    # correction_pass); tolerances match that test.
    box = float(system.box_lengths[0])
    pe_a, vir_a, _ = (float(x) for x in energy_a(st_a))
    pe_b, vir_b, _ = (float(x) for x in energy_b(st_b))
    assert pe_b == pytest.approx(pe_a, rel=5e-4)
    assert vir_b == pytest.approx(vir_a, rel=5e-3, abs=50.0)

    out_a = roll_a(st_a, num_steps=steps, rebin_every=4)
    out_b = roll_b(st_b, num_steps=steps, rebin_every=4)
    pa, va = gather_dense_atoms(out_a, n)
    pb, vb = gather_dense_atoms(out_b, n)
    np.testing.assert_allclose(pb % box, pa % box, atol=2e-3)
    np.testing.assert_allclose(vb, va, atol=5e-2)
