"""LJ-melt throughput on one GPU, and the checks every timed run passes.

The classic LJ melt (the standard MD throughput benchmark): FCC lattice at
reduced density 0.8442, T* = 1.44 hot start, rc = 2.5σ, rs = 2.0σ, skin 0.35,
dt = 0.005, uniform ε = σ = 1 — NVE on the dense-cell engine with its backend
resolved by `resolve_dense_backend("auto")`, the whole window one on-device
`lax.scan`.

Every run is checked before its number counts: the sticky overflow flag
(capacity and skin/2 staleness), the relative NVE drift of the total energy
over the window, the kept force path against XLA's `cell_dense_forces`, that
path against a float64 minimum-image sum for sampled atoms, and the shift
rebin against the sort rebin.  A failed check exits non-zero.

    python bench.py [n_target] [steps]

prints one JSON line.  `chip_smoke.py` runs the same phase at 97k and 1M.
"""

from __future__ import annotations

import glob
import json
import sys
import tempfile
import time

import numpy as np

DRIFT_TOL = 1e-4  # relative NVE total-energy drift over the timed window
FORCE_TOL = 1e-4  # max |ΔF| / max |F|


def require_gpu():
    """The first JAX device; exits non-zero unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform!r}")
    return dev


def device_ms_per_call(fn, args, calls: int = 10) -> float:
    """Device-busy ms per call of `fn(*args)`, from a profiler trace: the
    union of the intervals of every event on GPU 0's stream lines over
    `calls` warm calls, divided by `calls`."""
    import jax

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        jax.profiler.stop_trace()
        (path,) = glob.glob(f"{d}/**/*.xplane.pb", recursive=True)
        data = jax.profiler.ProfileData.from_file(path)
    spans, names = [], []
    for plane in data.planes:
        names.append(plane.name)
        if plane.name != "/device:GPU:0":
            continue
        for line in plane.lines:
            names.append(f"  {line.name}")
            if line.name.startswith("Stream"):
                spans += [(e.start_ns, e.end_ns) for e in line.events]
    if not spans:
        raise RuntimeError("no GPU stream events in the trace:\n" + "\n".join(names))
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy += hi - lo
    return busy / calls / 1e6


def wall_ms_per_call(fn, args, calls: int = 10) -> float:
    """Host-clock ms per call of `fn(*args)` after a warm call."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(calls):
        out = fn(*args)
    jax.block_until_ready(out)
    return 1e3 * (time.perf_counter() - t0) / calls


def timed_rollout(rollout, state, steps: int, rebin_every: int, repeats: int = 3):
    """(median seconds over `repeats` timed windows, final state); the first
    call compiles and is not timed."""
    import jax

    jax.block_until_ready(rollout(state, num_steps=steps, rebin_every=rebin_every))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = rollout(state, num_steps=steps, rebin_every=rebin_every)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def rel_drift(energy, st0, st1) -> float:
    pe0, _, ke0 = (float(x) for x in energy(st0))
    pe1, _, ke1 = (float(x) for x in energy(st1))
    return abs((pe1 + ke1) - (pe0 + ke0)) / abs(pe0 + ke0)


def rel_max_diff(a, b, valid) -> float:
    """max |a − b| / max |b| over live slots."""
    a = np.asarray(a)[np.asarray(valid)]
    b = np.asarray(b)[np.asarray(valid)]
    return float(np.abs(a - b).max() / np.abs(b).max())


def by_atom(state, num_atoms, field):
    """Slot array → (N, …) numpy array in atom order."""
    ids = np.asarray(state.atom_id).reshape(-1)
    keep = np.asarray(state.valid).reshape(-1)
    a = np.asarray(field)
    a = a.reshape((-1,) + a.shape[2:])
    out = np.zeros((num_atoms,) + a.shape[1:], a.dtype)
    out[ids[keep]] = a[keep]
    return out


def rebin_check(state, config, num_atoms) -> dict:
    """Shift rebin (`_rebin_shift`) against the sort rebin (`_rebin`) on the
    device: every atom in the same cell with bit-identical velocities and
    the same wrapped position (to a few ulps of the box: each rebin wraps
    in its own fusion, where the compiler may contract x − ⌊x/L⌋·L into an
    fma), and each rebin's ms/call."""
    import jax

    from emdee_tpu.neighbors.cell_dense import _rebin, _rebin_shift

    shift = jax.jit(lambda s: _rebin_shift(s, config))
    sort = jax.jit(lambda s: _rebin(s, config))
    a, b = shift(state), sort(state)
    cell = np.repeat(np.arange(config.num_cells), config.capacity).reshape(
        state.valid.shape
    )
    same = not bool(a.overflow) and not bool(b.overflow)
    for fa, fb in ((cell, cell), (a.velocities, b.velocities)):
        same = same and np.array_equal(
            by_atom(a, num_atoms, fa), by_atom(b, num_atoms, fb)
        )
    dpos = np.abs(
        by_atom(a, num_atoms, a.positions) - by_atom(b, num_atoms, b.positions)
    ).max()
    same = same and dpos <= 4 * np.spacing(np.float32(config.box))
    return {
        "rebin_shift_eq_sort": bool(same),
        "rebin_pos_maxdiff": float(dpos),
        "rebin_shift_ms": wall_ms_per_call(shift, (state,)),
        "rebin_sort_ms": wall_ms_per_call(sort, (state,)),
    }


def lj_melt(n_target: int, equil_steps: int, steps: int, *, compare: bool = True,
            samples: int = 1024, seed: int = 0) -> dict:
    """One LJ-melt phase: build, equilibrate, time `steps` NVE steps through
    the auto backend, then run every check.  Returns the phase's readings,
    with `failures` listing each check outside its tolerance."""
    import jax

    from emdee_tpu.neighbors.cell_dense import (
        cell_dense_forces,
        cell_dense_init,
        detect_uniform_params,
        gather_dense_atoms,
        make_cell_dense_sim,
        resolve_dense_backend,
        suggest_cell_dense_config,
        suggest_rebin_interval,
    )
    from emdee_tpu.neighbors.cell_pair_kernel import cell_pair_forces, static_lj
    from emdee_tpu.potentials.lennard_jones import LennardJonesModel, lennard_jones_atom
    from emdee_tpu.utils.lattice import fcc_lattice, maxwell_boltzmann
    from emdee_tpu.utils.reference_f64 import sample_forces_f64

    dt, rc, rs = 0.005, 2.5, 2.0
    cells = int(round((n_target / 4) ** (1 / 3)))
    pos, box = fcc_lattice(cells, density=0.8442)
    n = pos.shape[0]
    vel = maxwell_boltzmann(n, 1.44, seed=seed)
    model = LennardJonesModel.create(rc, rs)
    params = lennard_jones_atom(np.ones(n), np.ones(n))
    uni = detect_uniform_params(params)
    config = suggest_cell_dense_config(n, box, cutoff=rc, switch=rs, skin=0.35)
    backend = resolve_dense_backend("auto")
    sims = {}

    def sim(b):
        if b not in sims:
            sims[b] = make_cell_dense_sim(
                config, model, dt, backend=b, uniform_params=uni, uniform_mass=1.0
            )
        return sims[b]

    rollout, energy = sim(backend)
    state = cell_dense_init(pos, vel, np.ones(n), params, config)
    t0 = time.perf_counter()
    state = rollout(state, num_steps=equil_steps, rebin_every=2)
    if bool(state.overflow):
        raise SystemExit(f"{n}-atom melt: overflow while equilibrating")
    pos_eq, vel_eq = gather_dense_atoms(state, n)
    setup_s = time.perf_counter() - t0
    # Rebin cadence from the measured equilibrated temperature.
    t_eq = float((vel_eq.astype(np.float64) ** 2).sum() / (3.0 * n - 3.0))
    rebin_every = suggest_rebin_interval(config.skin, dt, temperature=t_eq)
    st0 = cell_dense_init(pos_eq, vel_eq, np.ones(n), params, config)

    secs, out = timed_rollout(rollout, st0, steps, rebin_every)
    r = {
        "atoms": n, "cells_per_dim": config.cells_per_dim,
        "capacity": config.capacity, "backend": backend, "steps": steps,
        "rebin_every": rebin_every, "ms_per_step": 1e3 * secs / steps,
        "atom_steps_per_s": n * steps / secs, "overflow": bool(out.overflow),
        "drift": rel_drift(energy, st0, out), "drift_tol": DRIFT_TOL,
        "setup_s": setup_s,
    }
    if compare and backend != "xla":
        secs_x, _ = timed_rollout(sim("xla")[0], st0, steps, rebin_every)
        r["xla_ms_per_step"] = 1e3 * secs_x / steps

    # Force checks on the final state: positions drifted since its rebin.
    xla_forces = jax.jit(lambda s: cell_dense_forces(s, model, config)[0])
    f_x = xla_forces(out)
    forces = {"xla": xla_forces}
    if backend == "triton":
        forces["triton"] = jax.jit(
            lambda s: cell_pair_forces(s, config, static_lj(model), uniform_params=uni)
        )
        r["kernel_vs_xla"] = rel_max_diff(forces["triton"](out), f_x, out.valid)
        r["kernel_vs_xla_tol"] = FORCE_TOL
    for name, fn in forces.items():
        r[f"force_pass_ms_{name}"] = device_ms_per_call(fn, (out,))
    sample = np.random.default_rng(seed).choice(n, size=min(samples, n), replace=False)
    p_at = by_atom(out, n, out.positions)
    f_ref = sample_forces_f64(p_at, box, rc, rs, 0.5, 2.0, sample)
    f_xs = by_atom(out, n, f_x)[sample]
    r["xla_vs_f64"] = float(np.abs(f_xs - f_ref).max() / np.abs(f_ref).max())
    r["xla_vs_f64_tol"] = FORCE_TOL
    r.update(rebin_check(out, config, n))

    fails = []
    if r["overflow"]:
        fails.append("overflow")
    if not r["drift"] <= DRIFT_TOL:
        fails.append("drift")
    for key in ("kernel_vs_xla", "xla_vs_f64"):
        if key in r and not r[key] <= FORCE_TOL:
            fails.append(key)
    if not r["rebin_shift_eq_sort"]:
        fails.append("rebin_shift_eq_sort")
    r["failures"] = fails
    return r


def main(n_target: int = 100_000, steps: int = 1000) -> dict:
    from emdee_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = require_gpu()
    r = lj_melt(n_target, equil_steps=200, steps=steps)
    result = {
        "metric": f"atom-steps/s ({r['atoms']}-atom LJ melt, rc=2.5, NVE, "
                  f"dense-cell engine, {r['backend']} pair pass)",
        "value": r["atom_steps_per_s"],
        "unit": "atom-steps/s",
        "ms_per_step": r["ms_per_step"],
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "failures": r["failures"],
    }
    print(json.dumps(result), flush=True)
    if r["failures"]:
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    main(
        int(sys.argv[1]) if len(sys.argv) > 1 else 100_000,
        int(sys.argv[2]) if len(sys.argv) > 2 else 1000,
    )
