"""Velocity-Verlet integration with `lax.scan` rollouts.

The reference has no integrator (SURVEY.md §0) — this supplies the missing
time loop, designed for an accelerator: one jitted step fuses the half-kicks, drift,
PBC wrap, and force evaluation; `nve_rollout` scans thousands of steps fully
on-device so the host never touches the loop.

Force-function contract (produced by `emdee_tpu.neighbors.api.make_force_fn`):
    force_fn(positions, box, aux) -> (forces, aux)
where `aux` is opaque integrator-carried state (e.g. the neighbor list, with
its displacement-triggered conditional rebuild inside).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from emdee_tpu.core.pbc import wrap
from emdee_tpu.core.types import State


class Trajectory(NamedTuple):
    """Per-record observables from a rollout (leading axis = records)."""

    step: jax.Array
    kinetic_energy: jax.Array
    potential_energy: Optional[jax.Array] = None
    virial: Optional[jax.Array] = None


def kinetic_energy(state: State) -> jax.Array:
    return 0.5 * jnp.sum(state.masses[:, None] * state.velocities**2)


def velocity_verlet_step(
    state: State,
    forces: jax.Array,
    aux: Any,
    force_fn: Callable,
    dt,
) -> Tuple[State, jax.Array, Any]:
    """One NVE velocity-Verlet step: kick–drift–(forces)–kick."""
    dt = jnp.asarray(dt, state.positions.dtype)
    inv_m = (1.0 / state.masses)[:, None]
    v_half = state.velocities + (0.5 * dt) * forces * inv_m
    new_pos = wrap(state.positions + dt * v_half, state.box)
    new_forces, aux = force_fn(new_pos, state.box, aux)
    new_vel = v_half + (0.5 * dt) * new_forces * inv_m
    new_state = state._replace(
        positions=new_pos, velocities=new_vel, step=state.step + 1
    )
    return new_state, new_forces, aux


@partial(jax.jit, static_argnames=("force_fn", "num_steps", "record_every", "energy_fn"))
def nve_rollout(
    state: State,
    aux: Any,
    force_fn: Callable,
    dt,
    num_steps: int,
    record_every: int = 0,
    energy_fn: Optional[Callable] = None,
) -> Tuple[State, Any, Optional[Trajectory]]:
    """Scan `num_steps` NVE steps on device.

    With record_every > 0, the scan is blocked into records: each outer
    iteration advances `record_every` steps then logs (E_kin, and E_pot/W via
    `energy_fn(positions, aux) -> (potential, virial)` if given).
    """
    forces0, aux = force_fn(state.positions, state.box, aux)

    def one_step(carry, _):
        st, f, ax = carry
        st, f, ax = velocity_verlet_step(st, f, ax, force_fn, dt)
        return (st, f, ax), None

    if record_every <= 0:
        (state, _, aux), _ = jax.lax.scan(
            one_step, (state, forces0, aux), None, length=num_steps
        )
        return state, aux, None

    num_records, rem = divmod(num_steps, record_every)
    if rem:
        raise ValueError("num_steps must be a multiple of record_every")

    def one_record(carry, _):
        carry, _ = jax.lax.scan(one_step, carry, None, length=record_every)
        st, _, ax = carry
        ke = kinetic_energy(st)
        if energy_fn is not None:
            pe, vir = energy_fn(st.positions, ax)
        else:
            pe = vir = None
        return carry, Trajectory(st.step, ke, pe, vir)

    (state, _, aux), traj = jax.lax.scan(
        one_record, (state, forces0, aux), None, length=num_records
    )
    return state, aux, traj
