"""The full-shell Pallas-Triton pair kernel (`cell_pair_kernel`) on the CPU:
interpret mode against XLA's `cell_dense_forces` and the float64 oracle, its
lowering for the GPU, its block choice, and the backend resolution that
selects it."""

from functools import partial

import jax
import numpy as np
import pytest

from emdee_tpu.neighbors import cell_dense, cell_pair_kernel
from emdee_tpu.neighbors.cell_dense import (
    cell_dense_forces,
    cell_dense_init,
    gather_dense_atoms,
    make_cell_dense_sim,
    resolve_dense_backend,
    suggest_cell_dense_config,
)
from emdee_tpu.neighbors.cell_dense_molecular import (
    build_exclusion_tables,
    make_exclusion_aux_fn,
)
from emdee_tpu.neighbors.cell_pair_kernel import block_size, cell_pair_forces, static_lj
from emdee_tpu.potentials.coulomb import DSFCoulomb, coulomb_consts
from emdee_tpu.potentials.lennard_jones import LennardJonesModel, lennard_jones_atom
from emdee_tpu.utils.lattice import cubic_lattice, maxwell_boltzmann

MODEL = LennardJonesModel.create(2.5, 2.0)
COUL = DSFCoulomb.create(2.5, 0.3, 1.0)


def _case(name):
    """(state, config, kernel kwargs, XLA args) for one kernel case."""
    n, density = 1000, 0.5
    rng = np.random.default_rng(3)
    if name == "empty_slots":
        n, density = 300, 0.15  # most slots empty
    pos, box = cubic_lattice(n, density, jitter=0.15, seed=3)
    vel = maxwell_boltzmann(n, 1.0, seed=4)
    if name == "uniform":
        params = lennard_jones_atom(np.ones(n), np.ones(n))
    else:
        params = lennard_jones_atom(rng.uniform(0.8, 1.2, n), rng.uniform(0.9, 1.1, n))
    config = suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.4)
    if name == "capacity_not_pow2":
        config = config._replace(capacity=40)  # three 16-slot blocks per cell
    q = rng.uniform(-0.5, 0.5, n).astype(np.float32) if name == "dsf_excl" else None
    st = cell_dense_init(pos, vel, np.ones(n), params, config, charges=q)
    assert not bool(st.overflow)
    kw, xla = {}, (None, None)
    if name == "uniform":
        kw["uniform_params"] = (0.5, 2.0)
    if name == "dsf_excl":
        base = np.arange(0, n - 1, 2)
        pairs = np.stack([base, base + 1], 1)
        scales = np.where(base % 4 == 0, 0.0, 0.5).astype(np.float32)
        aux = make_exclusion_aux_fn(n, *build_exclusion_tables(n, pairs, scales, scales))(st)
        kw["dsf"], kw["excl"] = coulomb_consts(COUL), aux
        xla = (COUL, aux)
    return st, config, kw, xla


CASES = ["uniform", "per_atom", "dsf_excl", "empty_slots", "capacity_not_pow2"]


@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_xla(name):
    st, config, kw, (coul, aux) = _case(name)
    f_k = cell_pair_forces(
        st, config, static_lj(MODEL), kw.get("dsf"), kw.get("excl"),
        uniform_params=kw.get("uniform_params"), interpret=True,
    )
    f_x = cell_dense_forces(st, MODEL, config, coul, aux)[0]
    valid = np.asarray(st.valid)
    f_k, f_x = np.asarray(f_k), np.asarray(f_x)
    # Both f32; only the summation order and the image arithmetic differ.
    scale = np.abs(f_x[valid]).max()
    assert np.abs(f_k[valid] - f_x[valid]).max() <= 1e-5 * scale
    assert np.all(f_k[~valid] == 0.0)


def test_kernel_matches_f64_oracle():
    from tests.oracle import allpairs_oracle

    n = 600
    pos, box = cubic_lattice(n, 0.4, jitter=0.1, seed=8)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.4)
    st = cell_dense_init(pos, np.zeros((n, 3)), np.ones(n), params, config)
    f = cell_pair_forces(st, config, static_lj(MODEL), interpret=True)
    ids = np.asarray(st.atom_id).reshape(-1)
    keep = np.asarray(st.valid).reshape(-1)
    f_at = np.zeros((n, 3))
    f_at[ids[keep]] = np.asarray(f).reshape(-1, 3)[keep]
    f_ref, _, _ = allpairs_oracle(pos, box, 2.5, 2.0, 0.5, 2.0)
    np.testing.assert_allclose(f_at, f_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["uniform", "dsf_excl"])
def test_kernel_lowers_for_gpu(name):
    """The Triton lowering accepts the kernel (every primitive it uses, every
    block a power of two) — what the GPU compiler sees first, checked
    without a GPU."""
    st, config, kw, _ = _case(name)
    fn = partial(
        cell_pair_forces, config=config, lj=static_lj(MODEL), dsf=kw.get("dsf"),
        uniform_params=kw.get("uniform_params"),
    )
    lowered = jax.jit(lambda s, e: fn(s, excl=e)).trace(st, kw.get("excl")).lower(
        lowering_platforms=("cuda",)
    )
    assert "cell_pair_forces" in lowered.as_text()


@pytest.mark.parametrize(
    "capacity,block", [(8, 16), (16, 16), (20, 32), (32, 32), (40, 16), (64, 64), (80, 16)]
)
def test_block_size(capacity, block):
    assert block_size(capacity) == block


def test_sim_triton_backend_matches_xla(monkeypatch):
    """`make_cell_dense_sim(backend="triton")` wires the kernel into the
    rollout: same trajectory as the XLA backend up to f32 summation order."""
    monkeypatch.setattr(
        cell_pair_kernel, "cell_pair_forces",
        partial(cell_pair_kernel.cell_pair_forces, interpret=True),
    )
    n = 1000
    pos, box = cubic_lattice(n, 0.5, jitter=0.15, seed=11)
    vel = maxwell_boltzmann(n, 1.0, seed=12)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    config = suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.4)
    st = cell_dense_init(pos, vel, np.ones(n), params, config)
    outs = {}
    for backend in ("xla", "triton"):
        rollout, energy = make_cell_dense_sim(
            config, MODEL, 0.002, backend=backend, uniform_params=(0.5, 2.0),
            uniform_mass=1.0,
        )
        out = rollout(st, num_steps=20, rebin_every=5)
        assert not bool(out.overflow)
        outs[backend] = (*gather_dense_atoms(out, n), float(energy(out)[0]))
    np.testing.assert_allclose(outs["triton"][0], outs["xla"][0], atol=1e-4)
    np.testing.assert_allclose(outs["triton"][1], outs["xla"][1], atol=1e-4)
    assert outs["triton"][2] == pytest.approx(outs["xla"][2], rel=1e-5)


@pytest.mark.parametrize("platform,expect", [("cpu", "xla"), ("gpu", "triton")])
def test_auto_backend_follows_platform(monkeypatch, platform, expect):
    monkeypatch.setattr(cell_dense.jax, "default_backend", lambda: platform)
    assert resolve_dense_backend("auto") == expect
    assert resolve_dense_backend("xla") == "xla"


@pytest.mark.parametrize(
    "backend", ["pallas", "pallas_interpret", "pallas_streaming", "interpret"]
)
def test_removed_backends_raise(backend):
    with pytest.raises(ValueError, match="unknown dense-cell backend"):
        resolve_dense_backend(backend)


@pytest.mark.parametrize("rebin", ["shift_pallas", "shift_xla", "kernel"])
def test_removed_rebins_raise(rebin):
    n = 200
    pos, box = cubic_lattice(n, 0.1, seed=1)
    config = suggest_cell_dense_config(n, box, cutoff=2.5, switch=2.0, skin=0.4)
    with pytest.raises(ValueError, match="unknown rebin"):
        make_cell_dense_sim(config, MODEL, 0.002, backend="xla", rebin=rebin)
