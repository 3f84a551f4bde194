"""Test configuration: run on CPU with 8 virtual devices.

The reference's answer to "device code without a device" was to skip
(runtests.jl:55 gates on CUDA.functional()).  Here an 8-device mesh is
emulated on the CPU via XLA_FLAGS, so every sharding and collective runs
without a GPU, and the Pallas kernel runs in interpret mode (SURVEY.md §4).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest

REFERENCE_DATA = "/root/reference/test/data"


def pytest_addoption(parser):
    parser.addoption(
        "--full", action="store_true", default=False,
        help="run the full tier (expensive sharded/fidelity tests) too",
    )


def pytest_collection_modifyitems(config, items):
    """Two-tier suite: the default run is the QUICK tier (CI-friendly, keeps
    `pytest tests/ -x -q` a habit as the suite grows); `--full` (or
    EMDEE_TEST_FULL=1) adds the expensive long-rollout/sharded gates —
    run that tier before benching or shipping engine changes."""
    if config.getoption("--full") or os.environ.get("EMDEE_TEST_FULL"):
        return
    skip = pytest.mark.skip(
        reason="full-tier test — pass --full (or EMDEE_TEST_FULL=1)"
    )
    for item in items:
        if "full" in item.keywords:
            item.add_marker(skip)


def reference_data_path(name: str):
    path = os.path.join(REFERENCE_DATA, name)
    return path if os.path.exists(path) else None


@pytest.fixture(scope="session")
def lj_sample():
    """The reference's 800-atom LJ differential-test fixture
    (runtests.jl:58: L=10, rc=3, rs=2.5, uniform ε=σ=1), read from the
    reference mount when present.  Otherwise 800 of the 1000 sites of a unit
    simple-cubic lattice, chosen and jittered by ±0.02 from a fixed seed:
    the same N, L and density with no overlapping pair (every distance
    ≥ 0.96σ), so float32 stays within the oracle tolerance."""
    path = reference_data_path("lj_sample.xyz")
    if path is not None:
        from emdee_tpu.io.xyz import read_xyz

        _, pos, _ = read_xyz(path)
    else:
        rng = np.random.default_rng(20260816)
        grid = np.stack(np.meshgrid(*[np.arange(10)] * 3, indexing="ij"), -1)
        sites = (grid.reshape(-1, 3) + 0.5)[rng.permutation(1000)[:800]]
        pos = sites + rng.uniform(-0.02, 0.02, sites.shape)
    return pos, 10.0, 3.0, 2.5
