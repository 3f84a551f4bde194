"""Smoke run of the engine on the GPU through its user entry points.

    python chip_smoke.py              # one card: phases 1-4
    python chip_smoke.py --cards 4    # four cards: the grid-sharded path only

Phases, one line of readings each:

1. device — JAX's devices and version, the card's name and power limit;
   exits non-zero unless the platform is `gpu`.
2. 97,556-atom LJ melt (`bench.lj_melt`): 200 equilibration steps, 1,000
   timed NVE steps through `make_cell_dense_sim(backend="auto")`.
3. 1,000,188-atom LJ melt: 100 equilibration steps, 200 timed steps.
4. 98,304-atom flexible SPC/E water (`modelling.water`): charges, DSF
   Coulomb (cutoff 7 Å, switch 6 Å, α = 0.2/Å), 1-2/1-3 exclusions, bonds and
   angles; CSVR settle, then 200 timed NVE steps at 0.5 fs through
   `make_molecular_dense_sim(backend="auto")`.

Each phase times the resolved backend and the plain XLA engine, checks the
sticky overflow flag, the NVE drift (≤ 1e-4), the kept force path against
XLA's `cell_dense_forces` and XLA against a plain reference (≤ 1e-4), and the
shift rebin against the sort rebin.  Any failure exits non-zero.  The last
line is the JSON contract line and nothing else.

With `--cards 4`, the 1M melt and the water box run on
`make_grid_sharded_sim(backend="xla")` over a (4, 1, 1) mesh against the
single-card engine on the same XLA pair pass, from the same state: potential
energy and virial agree to 1e-5 relative at step 0 and after 100 steps.
The single card's `auto` path is timed beside both.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

import bench
from bench import FORCE_TOL, DRIFT_TOL

SHARDED_TOL = 1e-5
PE_LIST_TOL = 3e-4  # dense PE vs the neighbour-list path: the list path's
# correction pass subtracts the large excluded O–H/H–H Coulomb terms, and
# its f32 cancellation residue sets this tolerance (as in the tests).


def cache_entries(path: str) -> int:
    """Files in the compile-cache directory (0 if it does not exist yet)."""
    return sum(len(files) for _, _, files in os.walk(path))


def report(label: str, readings: dict):
    print(f"{label} {json.dumps(readings)}", flush=True)
    if readings.get("failures"):
        raise SystemExit(f"{label} failed: {readings['failures']}")


def phase_device(cards: int):
    import jax

    print(f"devices {jax.devices()}", flush=True)
    print(f"jax {jax.__version__}", flush=True)
    dev = bench.require_gpu()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(f"nvidia-smi {smi.stdout.strip() or smi.stderr.strip()}", flush=True)
    if len(jax.devices()) < cards:
        raise SystemExit(f"{cards} cards asked for, {len(jax.devices())} present")
    return dev


def water_system(n_side: int = 32, seed: int = 0, cells_multiple_of: int = 1):
    """(WaterBox, config, model, coulomb, sim kwargs) for the water box."""
    import jax.numpy as jnp

    from emdee_tpu.modelling.water import build_water_box
    from emdee_tpu.neighbors.cell_dense import suggest_cell_dense_config
    from emdee_tpu.potentials.coulomb import KJMOL_ANGSTROM, DSFCoulomb
    from emdee_tpu.potentials.lennard_jones import LennardJonesModel

    w = build_water_box(n_side, seed=seed)
    n = w.num_atoms
    config = suggest_cell_dense_config(
        n, w.box, 7.0, 6.0, skin=1.0, cells_multiple_of=cells_multiple_of
    )
    m = config.cells_per_dim
    s = w.positions / w.box - np.floor(w.positions / w.box)
    v = np.clip(np.floor(m * s).astype(np.int64), 0, m - 1)
    occ = np.bincount(v[:, 0] + m * (v[:, 1] + m * v[:, 2]), minlength=m**3).max()
    config = config._replace(capacity=max(config.capacity, -(-int(occ) // 8) * 8))
    model = LennardJonesModel.create(7.0, 6.0)
    coulomb = DSFCoulomb.create(7.0, 0.2, KJMOL_ANGSTROM)
    zeros = jnp.zeros(len(w.exclusion_pairs), jnp.float32)
    kw = dict(
        params=w.params, charges=w.charges, coulomb=coulomb,
        exclusion_pairs=jnp.asarray(w.exclusion_pairs), exclusion_scales=zeros,
        exclusion_scales_coulomb=zeros, bonded=w.bonded,
    )
    return w, config, model, coulomb, kw


def settled_water(w, config, model, kw, settle: int, dt: float, seed: int = 0):
    """Water state after a CSVR settle at 300 K (the lattice start relaxes
    and heats), re-packed so the timed window starts from a fresh rebin."""
    import jax

    from emdee_tpu.modelling.water import KB_KJMOL, maxwell_boltzmann_kjmol
    from emdee_tpu.neighbors.cell_dense import (
        CSVRConfig,
        cell_dense_init,
        gather_dense_atoms,
    )
    from emdee_tpu.neighbors.cell_dense_molecular import make_molecular_dense_sim

    n = w.num_atoms
    vel = maxwell_boltzmann_kjmol(w.masses, 300.0, seed=seed + 1)
    st = cell_dense_init(w.positions, vel, w.masses, w.params, config, charges=w.charges)
    roll_t, _ = make_molecular_dense_sim(
        config, model, dt, n, **kw,
        thermostat=CSVRConfig(temperature=KB_KJMOL * 300.0, tau=0.02),
    )
    st = roll_t(st, num_steps=settle, rebin_every=2, rng=jax.random.PRNGKey(seed))
    if bool(st.overflow):
        raise SystemExit("water: overflow while settling")
    pos, vel = gather_dense_atoms(st, n)
    st0 = cell_dense_init(pos, vel, w.masses, w.params, config, charges=w.charges)
    if bool(st0.overflow):
        raise SystemExit("water: capacity overflow after settling")
    return st0


def water_phase(n_side: int = 32, settle: int = 600, steps: int = 200,
                seed: int = 0) -> dict:
    import jax
    import jax.numpy as jnp

    from emdee_tpu.core.types import ENERGIES, FORCES
    from emdee_tpu.modelling.water import KB_KJMOL, MASS_H
    from emdee_tpu.neighbors.api import NonbondedConfig, make_force_fn
    from emdee_tpu.neighbors.cell_dense import (
        cell_dense_forces,
        resolve_dense_backend,
        suggest_rebin_interval,
    )
    from emdee_tpu.neighbors.cell_dense_molecular import (
        build_exclusion_tables,
        make_exclusion_aux_fn,
        make_molecular_dense_sim,
    )
    from emdee_tpu.neighbors.cell_pair_kernel import cell_pair_forces, static_lj
    from emdee_tpu.potentials.coulomb import KJMOL_ANGSTROM, coulomb_consts

    dt = 0.005  # 0.5 fs
    w, config, model, coulomb, kw = water_system(n_side, seed)
    n = w.num_atoms
    t0 = time.perf_counter()
    st0 = settled_water(w, config, model, kw, settle, dt, seed)
    setup_s = time.perf_counter() - t0
    rebin_every = suggest_rebin_interval(
        config.skin, dt, temperature=KB_KJMOL * 300.0, mass=MASS_H
    )
    backend = resolve_dense_backend("auto")
    rollout, energy = make_molecular_dense_sim(config, model, dt, n, **kw, backend=backend)
    secs, out = bench.timed_rollout(rollout, st0, steps, rebin_every)
    r = {
        "atoms": n, "cells_per_dim": config.cells_per_dim,
        "capacity": config.capacity, "backend": backend, "steps": steps,
        "rebin_every": rebin_every, "ms_per_step": 1e3 * secs / steps,
        "atom_steps_per_s": n * steps / secs, "overflow": bool(out.overflow),
        "drift": bench.rel_drift(energy, st0, out), "drift_tol": DRIFT_TOL,
        "setup_s": setup_s,
    }
    if backend != "xla":
        roll_x, _ = make_molecular_dense_sim(config, model, dt, n, **kw, backend="xla")
        secs_x, _ = bench.timed_rollout(roll_x, st0, steps, rebin_every)
        r["xla_ms_per_step"] = 1e3 * secs_x / steps

    zeros = np.zeros(len(w.exclusion_pairs), np.float32)
    tabs = build_exclusion_tables(n, w.exclusion_pairs, zeros, zeros)
    aux = jax.jit(make_exclusion_aux_fn(n, *tabs))(out)
    xla_forces = jax.jit(lambda s, a: cell_dense_forces(s, model, config, coulomb, a)[0])
    f_x = xla_forces(out, aux)
    forces = {"xla": xla_forces}
    if backend == "triton":
        lj, dsf = static_lj(model), coulomb_consts(coulomb)
        forces["triton"] = jax.jit(lambda s, a: cell_pair_forces(s, config, lj, dsf, a))
        r["kernel_vs_xla"] = bench.rel_max_diff(forces["triton"](out, aux), f_x, out.valid)
        r["kernel_vs_xla_tol"] = FORCE_TOL
    for name, fn in forces.items():
        r[f"force_pass_ms_{name}"] = bench.device_ms_per_call(fn, (out, aux))

    # XLA against the portable neighbour-list path (pair terms with the
    # exclusion correction pass), on the same atoms.
    p_at = jnp.asarray(bench.by_atom(out, n, out.positions))
    nb = make_force_fn(
        NonbondedConfig(cutoff=7.0, switch=6.0, method="neighbor_list",
                        coulomb_alpha=0.2, coulomb_constant=KJMOL_ANGSTROM),
        w.params, w.box, n,
        exclusion_pairs=kw["exclusion_pairs"], exclusion_scales=kw["exclusion_scales"],
        charges=jnp.asarray(w.charges), exclusion_scales_coulomb=kw["exclusion_scales"],
    )
    with jax.default_matmul_precision("highest"):
        ref = nb.compute(p_at, nb.init(p_at), outputs=FORCES | ENERGIES)
        pe_ref = float(jnp.sum(ref.energies)) + float(
            w.bonded.energy(p_at, jnp.float32(w.box))
        )
    f_ref = np.asarray(ref.forces)
    r["xla_vs_list"] = float(
        np.abs(bench.by_atom(out, n, f_x) - f_ref).max() / np.abs(f_ref).max()
    )
    r["xla_vs_list_tol"] = FORCE_TOL
    pe = float(energy(out)[0])
    r["pe_vs_list"] = abs(pe - pe_ref) / abs(pe_ref)
    r["pe_vs_list_tol"] = PE_LIST_TOL
    r.update(bench.rebin_check(out, config, n))

    fails = []
    if r["overflow"]:
        fails.append("overflow")
    if not r["drift"] <= DRIFT_TOL:
        fails.append("drift")
    for key in ("kernel_vs_xla", "xla_vs_list"):
        if key in r and not r[key] <= FORCE_TOL:
            fails.append(key)
    if not r["pe_vs_list"] <= PE_LIST_TOL:
        fails.append("pe_vs_list")
    if not r["rebin_shift_eq_sort"]:
        fails.append("rebin_shift_eq_sort")
    r["failures"] = fails
    return r


def sharded_pair(single, sharded, st, steps, rebin_every, auto_rollout):
    """Single-card (rollout, energy) against grid-sharded (rollout, energy,
    distribute) from the same state, both on the XLA pair pass so that only
    the decomposition differs: energies at step 0 and after `steps`.  The
    single card's `auto` rollout (the GPU kernel) is timed beside them."""
    from emdee_tpu.neighbors.cell_dense import resolve_dense_backend

    rollout1, energy1 = single
    rollout4, energy4, distribute = sharded
    st4 = distribute(st)

    def rel(a, b):
        return abs(a - b) / abs(b)

    e1 = [float(x) for x in energy1(st)]
    e4 = [float(x) for x in energy4(st4)]
    secs1, out1 = bench.timed_rollout(rollout1, st, steps, rebin_every)
    secs4, out4 = bench.timed_rollout(rollout4, st4, steps, rebin_every)
    secs_a, out_a = bench.timed_rollout(auto_rollout, st, steps, rebin_every)
    f1 = [float(x) for x in energy1(out1)]
    f4 = [float(x) for x in energy4(out4)]
    rels = {
        "pe_rel_step0": rel(e4[0], e1[0]), "vir_rel_step0": rel(e4[1], e1[1]),
        f"pe_rel_step{steps}": rel(f4[0], f1[0]),
        f"vir_rel_step{steps}": rel(f4[1], f1[1]),
    }
    flags = {
        "overflow_single": bool(out1.overflow), "overflow_sharded": bool(out4.overflow),
        "overflow_single_auto": bool(out_a.overflow),
    }
    fails = [k for k, v in rels.items() if not v <= SHARDED_TOL]
    fails += [k for k, v in flags.items() if v]
    return {
        **rels, "tol": SHARDED_TOL, **flags,
        "ms_per_step_single": 1e3 * secs1 / steps,
        "ms_per_step_sharded": 1e3 * secs4 / steps,
        "single_auto_backend": resolve_dense_backend("auto"),
        "ms_per_step_single_auto": 1e3 * secs_a / steps,
        "failures": fails,
    }


def cards_phase(mesh_shape=(4, 1, 1), lj_cells: int = 63, water_side: int = 32,
                steps: int = 100, settle_lj: int = 100, settle_water: int = 600) -> list:
    """The grid-sharded engine on a (4, 1, 1) mesh against the single-card
    engine.  (4, 1, 1) and (2, 2, 1) carry the same face area, 2M² cells of
    halo per card, but slabs need one exchanged axis instead of two, and
    the cards are joined all to all, so the mesh follows halo volume and
    message count alone."""
    import jax

    from emdee_tpu.distributed.grid_sharded import (
        distribute_grid,
        make_grid_mesh,
        make_grid_sharded_sim,
    )
    from emdee_tpu.modelling.water import KB_KJMOL, MASS_H
    from emdee_tpu.neighbors.cell_dense import (
        cell_dense_init,
        detect_uniform_params,
        gather_dense_atoms,
        make_cell_dense_sim,
        suggest_cell_dense_config,
        suggest_rebin_interval,
    )
    from emdee_tpu.neighbors.cell_dense_molecular import (
        build_exclusion_tables,
        make_molecular_dense_sim,
    )
    from emdee_tpu.potentials.lennard_jones import LennardJonesModel, lennard_jones_atom
    from emdee_tpu.utils.lattice import fcc_lattice, maxwell_boltzmann

    mesh = make_grid_mesh(mesh_shape, devices=jax.devices()[: int(np.prod(mesh_shape))])
    lcm = int(np.lcm.reduce(mesh_shape))
    results = []

    # LJ melt.
    dt = 0.005
    pos, box = fcc_lattice(lj_cells, density=0.8442)
    n = pos.shape[0]
    model = LennardJonesModel.create(2.5, 2.0)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    uni = detect_uniform_params(params)
    config = suggest_cell_dense_config(n, box, 2.5, 2.0, skin=0.35, cells_multiple_of=lcm)
    auto = make_cell_dense_sim(config, model, dt, uniform_params=uni, uniform_mass=1.0)
    single = make_cell_dense_sim(
        config, model, dt, backend="xla", uniform_params=uni, uniform_mass=1.0
    )
    st = cell_dense_init(pos, maxwell_boltzmann(n, 1.44, seed=0), np.ones(n), params, config)
    st = auto[0](st, num_steps=settle_lj, rebin_every=2)
    if bool(st.overflow):
        raise SystemExit("sharded LJ: overflow while equilibrating")
    p_eq, v_eq = gather_dense_atoms(st, n)
    st = cell_dense_init(p_eq, v_eq, np.ones(n), params, config)
    t_eq = float((v_eq.astype(np.float64) ** 2).sum() / (3.0 * n - 3.0))
    k = suggest_rebin_interval(config.skin, dt, temperature=t_eq)
    roll4, energy4 = make_grid_sharded_sim(config, model, dt, mesh, backend="xla")
    r = sharded_pair(
        single, (roll4, energy4, lambda s: distribute_grid(s, config, mesh)),
        st, steps, k, auto[0],
    )
    r = {"system": "lj_melt", "atoms": n, "cells_per_dim": config.cells_per_dim,
         "mesh": list(mesh_shape), **r}
    report("cards_lj", r)
    results.append(r)

    # Water box.
    dt = 0.005
    w, config, model, coulomb, kw = water_system(water_side, cells_multiple_of=lcm)
    n = w.num_atoms
    st = settled_water(w, config, model, kw, settle_water, dt)
    k = suggest_rebin_interval(config.skin, dt, temperature=KB_KJMOL * 300.0, mass=MASS_H)
    auto = make_molecular_dense_sim(config, model, dt, n, **kw)
    single = make_molecular_dense_sim(config, model, dt, n, **kw, backend="xla")
    zeros = np.zeros(len(w.exclusion_pairs), np.float32)
    roll4, energy4 = make_grid_sharded_sim(
        config, model, dt, mesh, backend="xla", coulomb=coulomb,
        excl_tables=build_exclusion_tables(n, w.exclusion_pairs, zeros, zeros),
        bonded=w.bonded,
    )
    r = sharded_pair(
        single, (roll4, energy4, lambda s: distribute_grid(s, config, mesh)),
        st, steps, k, auto[0],
    )
    r = {"system": "water", "atoms": n, "cells_per_dim": config.cells_per_dim,
         "mesh": list(mesh_shape), **r}
    report("cards_water", r)
    results.append(r)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cards", type=int, choices=(1, 4), default=1)
    args = parser.parse_args(argv)

    from emdee_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    print(f"compile_cache {cache} entries {cache_entries(cache)}", flush=True)
    dev = phase_device(args.cards)
    import jax

    if args.cards == 4:
        cards_phase()
    else:
        report("phase2_lj_97k", bench.lj_melt(100_000, equil_steps=200, steps=1000))
        report("phase3_lj_1m", bench.lj_melt(1_000_000, equil_steps=100, steps=200))
        report("phase4_water_98k", water_phase())
    print(f"compile_cache {cache} entries {cache_entries(cache)}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
