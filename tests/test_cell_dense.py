"""Dense-cell (gather-free) engine tests: equivalence with all-pairs, NVE
conservation, rebinning correctness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from emdee_tpu.core.types import make_state
from emdee_tpu.dynamics.verlet import nve_rollout
from emdee_tpu.neighbors.api import NonbondedConfig, make_force_fn
from emdee_tpu.neighbors.cell_dense import (
    cell_dense_forces,
    cell_dense_init,
    gather_dense_atoms,
    make_cell_dense_sim,
    suggest_cell_dense_config,
)
from emdee_tpu.potentials.lennard_jones import LennardJonesModel, lennard_jones_atom
from emdee_tpu.utils.lattice import cubic_lattice, fcc_lattice, maxwell_boltzmann


def _setup(n=1728, density=0.6, T=1.0, seed=11, skin=0.4):
    pos, L = cubic_lattice(n, density, jitter=0.15, seed=seed)
    vel = maxwell_boltzmann(n, T, seed=seed + 1)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = suggest_cell_dense_config(n, L, cutoff=2.5, switch=2.0, skin=skin)
    model = LennardJonesModel.create(2.5, 2.0)
    return pos, vel, L, params, config, model


def test_forces_match_allpairs():
    pos, vel, L, params, config, model = _setup()
    n = pos.shape[0]
    st = cell_dense_init(pos, vel, np.ones(n), params, config)
    assert not bool(st.overflow)
    forces, e, w = cell_dense_forces(st, model, config, compute_energy=True)

    nb = make_force_fn(
        NonbondedConfig(cutoff=2.5, switch=2.0, method="allpairs"), params, L, n
    )
    ref = nb.compute(jnp.asarray(pos, jnp.float32), ())

    ids = np.asarray(st.atom_id).reshape(-1)
    keep = np.asarray(st.valid).reshape(-1)
    f_dense = np.zeros((n, 3), np.float32)
    e_dense = np.zeros(n, np.float32)
    w_dense = np.zeros(n, np.float32)
    f_dense[ids[keep]] = np.asarray(forces).reshape(-1, 3)[keep]
    e_dense[ids[keep]] = np.asarray(e).reshape(-1)[keep]
    w_dense[ids[keep]] = np.asarray(w).reshape(-1)[keep]

    # Tolerances are f32 summation-order noise: verified against the f64
    # oracle the dense engine agrees to ~1e-4 absolute.
    np.testing.assert_allclose(f_dense, np.asarray(ref.forces), rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(e_dense, np.asarray(ref.energies), rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(w_dense, np.asarray(ref.virials), rtol=1e-4, atol=5e-4)


def test_rollout_matches_allpairs_trajectory():
    pos, vel, L, params, config, model = _setup(n=1000, density=0.5)
    n = pos.shape[0]
    st = cell_dense_init(pos, vel, np.ones(n), params, config)
    rollout, energy = make_cell_dense_sim(config, model, dt=0.002)
    st = rollout(st, num_steps=50)
    assert not bool(st.overflow)
    pos_d, vel_d = gather_dense_atoms(st, n)

    state = make_state(pos, vel, box=L)
    nb = make_force_fn(
        NonbondedConfig(cutoff=2.5, switch=2.0, method="allpairs"), params, L, n
    )
    ref, _, _ = nve_rollout(state, (), nb.force_fn, 0.002, 50)
    # The dense engine wraps positions only at rebins — compare modulo L.
    Lf = float(L)
    np.testing.assert_allclose(pos_d % Lf, np.asarray(ref.positions) % Lf, atol=5e-4)
    np.testing.assert_allclose(vel_d, np.asarray(ref.velocities), atol=5e-4)


@pytest.mark.full
def test_nve_conservation_with_rebinning():
    """Long enough that displacement-triggered rebins fire; energy must hold."""
    pos, vel, L, params, config, model = _setup(n=2197, density=0.7, T=1.2, skin=0.3)
    n = pos.shape[0]
    st = cell_dense_init(pos, vel, np.ones(n), params, config)
    rollout, energy = make_cell_dense_sim(config, model, dt=0.002)
    # Settle the violent jittered-lattice start (overlapping pairs make any
    # f32 integrator bleed energy in the first tens of steps — and atoms can
    # outrun the skin between rebins, so rebin every step here), then gate
    # NVE conservation over the production window.
    st = rollout(st, num_steps=200, rebin_every=1)
    st = st._replace(overflow=jnp.asarray(False))  # clear settle-phase staleness
    pe0, w0, ke0 = (float(x) for x in energy(st))
    from emdee_tpu.neighbors.cell_dense import suggest_rebin_interval

    k = suggest_rebin_interval(config.skin, 0.002, temperature=2.0 * ke0 / (3 * n))
    st = rollout(st, num_steps=500, rebin_every=k)
    assert not bool(st.overflow)
    assert int(st.step) == 700
    pe1, w1, ke1 = (float(x) for x in energy(st))
    # Drift relative to the energy *scale* (KE), not the near-cancelling total.
    drift = abs((pe1 + ke1) - (pe0 + ke0)) / ke0
    assert drift < 5e-4, (pe0 + ke0, pe1 + ke1, ke0)
    # No atoms lost through rebinning.
    assert int(st.valid.sum()) == n


def test_small_box_rejected():
    with pytest.raises(ValueError, match="all-pairs"):
        suggest_cell_dense_config(100, 6.0, cutoff=2.5, switch=2.0, skin=0.4)


def _by_atom(state, n, field):
    """Slot array → (N, …) array keyed by atom id."""
    ids = np.asarray(state.atom_id).reshape(-1)
    keep = np.asarray(state.valid).reshape(-1)
    a = np.asarray(field).reshape((-1,) + np.asarray(field).shape[2:])
    out = np.zeros((n,) + a.shape[1:], a.dtype)
    out[ids[keep]] = a[keep]
    return out


def test_rebin_shift_matches_sort():
    """The gather-free ±1-cell routing rebin is equivalent to the argsort
    rebin: same cell assignment, same per-atom fields, wrapped positions."""
    from emdee_tpu.neighbors.cell_dense import _rebin, _rebin_shift

    pos, vel, L, params, config, model = _setup(n=1728, density=0.6, seed=3)
    n = pos.shape[0]
    st = cell_dense_init(pos, vel, np.ones(n), params, config)
    # Drift every atom by up to ~0.45 (< cell_side) so many cross cells,
    # some across the periodic boundary.
    rng = np.random.default_rng(7)
    drift = jnp.asarray(rng.uniform(-0.45, 0.45, st.positions.shape), jnp.float32)
    st = st._replace(positions=st.positions + jnp.where(st.valid[..., None], drift, 0.0))
    f = jnp.where(st.valid[..., None], 0.1 * st.positions, 0.0)

    sa, fa = _rebin(st, config, forces=f)
    sb, fb = _rebin_shift(st, config, forces=f)
    assert not bool(sa.overflow) and not bool(sb.overflow)
    assert int(sb.valid.sum()) == n

    # Same cell for every atom.
    cell_a = np.repeat(np.arange(config.num_cells), config.capacity)
    cells_of = lambda s: _by_atom(s, n, jnp.where(s.valid, cell_a.reshape(s.valid.shape), 0))
    np.testing.assert_array_equal(cells_of(sa), cells_of(sb))
    # Same per-atom payloads, bit-exact (both transports are pure moves).
    for fld in ("positions", "velocities", "inv_masses", "half_sigma"):
        np.testing.assert_array_equal(
            _by_atom(sa, n, getattr(sa, fld)), _by_atom(sb, n, getattr(sb, fld))
        )
    np.testing.assert_array_equal(_by_atom(sa, n, fa), _by_atom(sb, n, fb))


def _drifted_state(n, seed, charges=False, varied_params=False):
    """A bound state drifted in slot space (after binning) so that a real
    fraction of atoms cross their cell faces, some across the periodic
    seam, exactly like motion between rebins."""
    pos, box = cubic_lattice(n, 0.65, jitter=0.2, seed=seed)
    vel = maxwell_boltzmann(n, 1.3, seed=seed + 1)
    rng = np.random.default_rng(seed)
    if varied_params:
        params = lennard_jones_atom(rng.uniform(0.8, 1.2, n), rng.uniform(0.9, 1.1, n))
    else:
        params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.35)
    q = rng.uniform(-0.5, 0.5, n).astype(np.float32) if charges else None
    st = cell_dense_init(pos, vel, np.ones(n), params, config, charges=q)
    assert not bool(st.overflow)
    vmax = float(jnp.max(jnp.abs(st.velocities)))
    drift = (0.45 * config.skin / vmax) * st.velocities
    st = st._replace(positions=jnp.where(st.valid[..., None], st.positions + drift, 0.0))
    return st, config


@pytest.mark.parametrize("case", ["plain", "all_fields", "uniform_fastpath"])
def test_rebin_shift_bitexact_vs_sort(case):
    """Per atom, the shift rebin (log-shift rounds, bf16 prefix-rank matrix
    product) reproduces the sort rebin bit for bit on every routed field:
    plain LJ, every optional field (charges, per-atom parameters, carried
    forces), and the uniform fast path that rebuilds constants instead of
    routing them."""
    from emdee_tpu.neighbors.cell_dense import _rebin, _rebin_shift

    full = case == "all_fields"
    st, config = _drifted_state(2500, seed=11, charges=full, varied_params=full)
    n = int(st.valid.sum())
    f = None
    if full:
        rng = np.random.default_rng(3)
        f = 0.1 * jnp.asarray(rng.normal(size=st.positions.shape), jnp.float32)
    kw = {"uniform_params": (0.5, 2.0), "uniform_mass": 1.0} if case == "uniform_fastpath" else {}
    if f is None:
        a, b = _rebin(st, config), _rebin_shift(st, config, **kw)
    else:
        (a, fa), (b, fb) = _rebin(st, config, forces=f), _rebin_shift(st, config, forces=f)
        np.testing.assert_array_equal(_by_atom(a, n, fa), _by_atom(b, n, fb))
    assert not bool(a.overflow) and not bool(b.overflow)
    assert int(b.valid.sum()) == n
    cell = np.repeat(np.arange(config.num_cells), config.capacity).reshape(st.valid.shape)
    np.testing.assert_array_equal(_by_atom(a, n, cell), _by_atom(b, n, cell))
    fields = ["positions", "velocities", "inv_masses", "half_sigma", "twice_sqrt_eps"]
    for fld in fields + (["charges"] if full else []):
        np.testing.assert_array_equal(
            _by_atom(a, n, getattr(a, fld)), _by_atom(b, n, getattr(b, fld)), err_msg=fld
        )
    # The rebin must have routed something for this to be a test.
    moved = int(jnp.sum((b.atom_id != st.atom_id) & b.valid))
    assert moved > 10, f"fixture too static: only {moved} slots changed"


def test_rollout_shift_rebin_matches_sort():
    """A short NVE rollout where only the rebin differs: the same cell
    assignment at every rebin, so the trajectories agree up to the f32 sum
    order of atoms within a cell."""
    n = 1500
    pos, box = cubic_lattice(n, 0.7, jitter=0.1, seed=7)
    vel = maxwell_boltzmann(n, 1.0, seed=8)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.35)
    model = LennardJonesModel.create(2.5, 2.0)
    st = cell_dense_init(pos, vel, np.ones(n), params, config)
    outs = {}
    for rebin in ("shift", "sort"):
        rollout, _ = make_cell_dense_sim(config, model, 0.004, backend="xla", rebin=rebin)
        out = rollout(st, num_steps=12, rebin_every=3)
        assert not bool(out.overflow)
        outs[rebin] = gather_dense_atoms(out, n)
    np.testing.assert_allclose(outs["shift"][0], outs["sort"][0], atol=1e-5)
    np.testing.assert_allclose(outs["shift"][1], outs["sort"][1], atol=1e-4)


def test_rebin_shift_flags_fast_atom():
    """An atom that jumps more than one cell between rebins must trip the
    sticky overflow flag (the shift rebin's staleness contract)."""
    from emdee_tpu.neighbors.cell_dense import _rebin_shift

    pos, vel, L, params, config, model = _setup(n=1728, density=0.6, seed=5)
    n = pos.shape[0]
    st = cell_dense_init(pos, vel, np.ones(n), params, config)
    jump = np.zeros(st.positions.shape, np.float32)
    jump[0, 0, 0] = 2.5 * config.cell_side  # two cells along x
    st = st._replace(positions=st.positions + jnp.asarray(jump))
    out = _rebin_shift(st, config)
    assert bool(out.overflow)


@pytest.mark.full
def test_squeeze_then_shrink_capacity():
    """spill_target squeezing at wide capacity, then shrink_capacity to the
    tight config, preserves the physics (trajectory matches all-pairs)."""
    from emdee_tpu.neighbors.cell_dense import shrink_capacity

    pos, L = cubic_lattice(1728, 0.75, jitter=0.12, seed=21)
    n = pos.shape[0]
    vel = maxwell_boltzmann(n, 1.0, seed=22)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    tight = suggest_cell_dense_config(n, L, cutoff=2.5, switch=2.0, skin=0.3, spill=True)
    squeeze_cfg = tight._replace(
        capacity=tight.capacity + 16, spill_target=tight.capacity
    )
    model = LennardJonesModel.create(2.5, 2.0)
    st = cell_dense_init(pos, vel, np.ones(n), params, squeeze_cfg)
    assert not bool(st.overflow)
    rollout_w, _ = make_cell_dense_sim(squeeze_cfg, model, dt=0.002)
    st = rollout_w(st, num_steps=40, rebin_every=4)
    assert not bool(st.overflow)
    st, config = shrink_capacity(st, squeeze_cfg, tight.capacity)
    assert config.capacity == tight.capacity and int(st.valid.sum()) == n

    rollout_t, _ = make_cell_dense_sim(config, model, dt=0.002)
    st = rollout_t(st, num_steps=30, rebin_every=5)
    assert not bool(st.overflow)
    assert int(st.valid.sum()) == n

    # Same 70 steps on the all-pairs reference.
    nb = make_force_fn(
        NonbondedConfig(cutoff=2.5, switch=2.0, method="allpairs"), params, L, n
    )
    state = make_state(pos, vel, box=L)
    ref, _, _ = nve_rollout(state, (), nb.force_fn, 0.002, 70)
    pos_d, vel_d = gather_dense_atoms(st, n)
    Lf = float(L)
    np.testing.assert_allclose(pos_d % Lf, np.asarray(ref.positions) % Lf, atol=5e-4)
    np.testing.assert_allclose(vel_d, np.asarray(ref.velocities), atol=5e-4)


def test_spill_rollout_matches_allpairs():
    """Boundary-spill balancing (tight capacity) preserves the physics."""
    pos, L = cubic_lattice(1728, 0.75, jitter=0.12, seed=9)
    n = pos.shape[0]
    vel = maxwell_boltzmann(n, 1.0, seed=10)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = suggest_cell_dense_config(
        n, L, cutoff=2.5, switch=2.0, skin=0.3, spill=True
    )
    assert config.spill and config.cell_side > 2.5 + config.skin
    model = LennardJonesModel.create(2.5, 2.0)
    rollout, energy = make_cell_dense_sim(config, model, dt=0.002)
    st2 = cell_dense_init(pos, vel, np.ones(n), params, config)
    assert not bool(st2.overflow)  # near-uniform lattice fits the tight cap

    nb = make_force_fn(
        NonbondedConfig(cutoff=2.5, switch=2.0, method="allpairs"), params, L, n
    )
    state = make_state(pos, vel, box=L)
    ref, _, _ = nve_rollout(state, (), nb.force_fn, 0.002, 60)

    st_run = rollout(st2, num_steps=60, rebin_every=5)
    assert not bool(st_run.overflow)
    assert int(st_run.valid.sum()) == n
    pos_d, vel_d = gather_dense_atoms(st_run, n)
    Lf = float(L)
    np.testing.assert_allclose(pos_d % Lf, np.asarray(ref.positions) % Lf, atol=5e-4)
    np.testing.assert_allclose(vel_d, np.asarray(ref.velocities), atol=5e-4)


def test_init_wraps_out_of_range_positions():
    """PDB files routinely contain coordinates just outside [0, L); binning
    wraps them to a cell but the STORED coordinate must be wrapped too, or
    every image-shift-based path (the GPU kernel, grid-sharded halos)
    places the atom a full box from its seam neighbors and silently drops
    those pairs (the XLA backend min-images each delta and masks the bug).
    Regression: shift a band of atoms by ±L at init and require identical
    forces from the kernel (interpret mode)."""
    from emdee_tpu.neighbors.cell_pair_kernel import cell_pair_forces, static_lj

    pos, vel, L, params, config, model = _setup(n=1728)
    n = pos.shape[0]
    rng = np.random.default_rng(7)
    shift = rng.choice([-1.0, 0.0, 1.0], size=n, p=[0.1, 0.8, 0.1])
    pos_off = np.asarray(pos, np.float64).copy()
    pos_off[:, 0] += shift * float(L)

    st_ref = cell_dense_init(pos, vel, np.ones(n), params, config)
    st_off = cell_dense_init(pos_off, vel, np.ones(n), params, config)
    assert not bool(st_ref.overflow) and not bool(st_off.overflow)
    # Same binning, same stored (wrapped) coordinates (up to the f32
    # rounding of the +-L shift, which steep LJ gradients amplify -- so the
    # force contract below compares against the min-image-robust XLA path on
    # the SAME state rather than across the two states).
    np.testing.assert_array_equal(
        np.asarray(st_ref.atom_id), np.asarray(st_off.atom_id)
    )
    np.testing.assert_allclose(
        np.asarray(st_ref.positions), np.asarray(st_off.positions), atol=1e-5
    )

    f_xla, _, _ = cell_dense_forces(st_off, model, config, compute_energy=True)
    f_ker = cell_pair_forces(st_off, config, static_lj(model), interpret=True)
    np.testing.assert_allclose(np.asarray(f_ker), np.asarray(f_xla), atol=1e-2)


def test_leapfrog_nve_matches_kdk():
    """The NVE fast path restructures velocity-Verlet as leapfrog inside the
    rollout (no force transport through the rebin — cell_dense.py rollout);
    trajectories must match the synced kick-drift-kick path (record=True
    keeps it) to f32 reassociation roundoff, and the returned velocities
    must be re-synced to integer steps."""
    pos, vel, L, params, config, model = _setup(n=1000, density=0.5)
    n = pos.shape[0]
    st = cell_dense_init(pos, vel, np.ones(n), params, config)
    assert not bool(st.overflow)
    rollout, energy = make_cell_dense_sim(config, model, dt=0.002, backend="xla")

    out_lf = rollout(st, num_steps=30, rebin_every=5)
    out_kdk, _ = rollout(st, num_steps=30, rebin_every=5, record=True)
    assert not bool(out_lf.overflow) and not bool(out_kdk.overflow)
    assert int(out_lf.step) == 30

    p_lf, v_lf = gather_dense_atoms(out_lf, n)
    p_kdk, v_kdk = gather_dense_atoms(out_kdk, n)
    np.testing.assert_allclose(p_lf, p_kdk, atol=5e-4)
    np.testing.assert_allclose(v_lf, v_kdk, atol=5e-4)

    # Energy bookkeeping sees synced velocities: total energy conserved.
    pe0, _, ke0 = (float(x) for x in energy(st))
    pe1, _, ke1 = (float(x) for x in energy(out_lf))
    assert abs((pe1 + ke1) - (pe0 + ke0)) / max(abs(pe0 + ke0), 1.0) < 2e-4
