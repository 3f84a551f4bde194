"""Device-mesh construction for spatial domain decomposition.

The reference is strictly single-GPU (SURVEY.md §2b: no MPI/NCCL, its only
"communication" is warp shuffles and atomics).  Here the scale-out axis is a
`jax.sharding.Mesh`: atoms are sharded into spatial slabs, ghost positions
move between devices by `ppermute`, and reductions are `psum` — one level up
the hierarchy from what shuffles+atomics do inside one GPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


ATOM_AXIS = "atoms"


def make_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1D mesh over the atom/slab axis.

    MD domain decomposition is communication-light (nearest-neighbor halos),
    so a 1D ring is the right first topology; `grid_sharded` gives the 3D
    decomposition.
    """
    if devices is None:
        devices = jax.devices()
        if num_devices is not None:
            devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (ATOM_AXIS,))
