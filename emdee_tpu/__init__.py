"""emdee_tpu — a molecular-dynamics framework in JAX.

A from-scratch re-design (JAX / XLA / Pallas) of the capabilities of the
reference engine craabreu/EmDee.jl (Julia + CUDA):

- Molecular system setup: OpenMM-style force-field XML parsing, PDB/XYZ input,
  bond perception, residue-template matching by colored-graph canonicalization
  (reference: src/modelling.jl, src/molecular_graphs.jl).
- Nonbonded Lennard-Jones force/energy/virial evaluation with a switched
  potential and minimum-image PBC (reference: src/lennard_jones.jl,
  src/nonbonded.jl).
- O(N) neighbor search via fixed-shape bin-and-sort cell lists (the
  fixed-shape replacement for the reference's linked-cell CUDA kernels,
  src/cells.jl), and a dense cell-slot engine whose pair pass runs as one
  Pallas-Triton kernel on the GPU.

Beyond reference parity the framework adds what a production MD engine needs
and the reference lacks: velocity-Verlet integrators with `lax.scan` rollouts,
observables, checkpoint/resume, trajectory I/O, bonded-force evaluation, and
multi-device spatial domain decomposition over a `jax.sharding.Mesh` with
halo exchange by collective permutes.

Everything device-side is float32 (matching the reference's device precision,
vec3.jl:3-7) and shape-static under `jax.jit`.
"""

from emdee_tpu.core.types import (
    State,
    LJParams,
    NonbondedOutput,
    FORCES,
    ENERGIES,
    VIRIALS,
    ALL_OUTPUTS,
)
from emdee_tpu.potentials.lennard_jones import (
    LennardJonesModel,
    lennard_jones_atom,
    pair_interaction,
)
from emdee_tpu.neighbors.allpairs import compute_nonbonded_allpairs
from emdee_tpu.neighbors.cell_list import CellList, build_cell_list
from emdee_tpu.neighbors.neighbor_list import NeighborList, build_neighbor_list
from emdee_tpu.neighbors.api import NonbondedConfig, make_force_fn
from emdee_tpu.neighbors.cell_dense import (
    BerendsenBarostatConfig,
    CellDenseConfig,
    CSVRConfig,
    LangevinConfig,
    cell_dense_init,
    gather_dense_atoms,
    gather_dense_fields,
    make_cell_dense_sim,
    reconfigure_dense_state,
    suggest_cell_dense_config,
    suggest_rebin_interval,
)
from emdee_tpu.neighbors.cell_dense_molecular import (
    dense_sim_from_system,
    make_molecular_dense_sim,
)
from emdee_tpu.dynamics.verlet import velocity_verlet_step, nve_rollout
from emdee_tpu.dynamics.langevin import nvt_rollout
from emdee_tpu.dynamics.bussi import csvr_rollout
from emdee_tpu.dynamics.npt import npt_rollout
from emdee_tpu.dynamics.minimize import FireConfig, fire_minimize

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy imports keep `import emdee_tpu` light: the modelling layer pulls in
    # XML/graph machinery only when actually used.
    if name == "ForceField":
        from emdee_tpu.modelling.forcefield import ForceField

        return ForceField
    if name == "System":
        from emdee_tpu.modelling.system import System

        return System
    raise AttributeError(f"module 'emdee_tpu' has no attribute {name!r}")

__all__ = [
    "State",
    "LJParams",
    "NonbondedOutput",
    "FORCES",
    "ENERGIES",
    "VIRIALS",
    "ALL_OUTPUTS",
    "LennardJonesModel",
    "lennard_jones_atom",
    "pair_interaction",
    "compute_nonbonded_allpairs",
    "CellList",
    "build_cell_list",
    "NeighborList",
    "build_neighbor_list",
    "make_force_fn",
    "NonbondedConfig",
    "BerendsenBarostatConfig",
    "CellDenseConfig",
    "CSVRConfig",
    "LangevinConfig",
    "cell_dense_init",
    "gather_dense_atoms",
    "gather_dense_fields",
    "reconfigure_dense_state",
    "make_cell_dense_sim",
    "suggest_cell_dense_config",
    "suggest_rebin_interval",
    "dense_sim_from_system",
    "make_molecular_dense_sim",
    "velocity_verlet_step",
    "nve_rollout",
    "nvt_rollout",
    "csvr_rollout",
    "npt_rollout",
    "fire_minimize",
    "FireConfig",
]
