"""The entry scripts' shared pieces: the compile-cache helper, the GPU
requirement, and `chip_smoke.py` refusing to run without a GPU."""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest

import bench
from emdee_tpu.utils.compile_cache import compile_cache_dir, enable_compile_cache

ROOT = Path(__file__).resolve().parents[1]


def test_cache_dir_fixed_in_checkout_when_env_unset():
    path = compile_cache_dir({})
    assert path == str(ROOT / ".jax_cache")
    assert path == compile_cache_dir({"HOME": "/elsewhere", "TMPDIR": "/t"})
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_cache_dir_left_to_env_when_set():
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/some/cache"}) is None


@pytest.mark.parametrize("env_dir", [None, "/some/cache"])
def test_enable_compile_cache(monkeypatch, env_dir):
    """With the variable set, nothing is configured and its directory is
    reported; unset, JAX is pointed at the checkout's `.jax_cache/`."""
    updates = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.append((k, v)))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    got = enable_compile_cache()
    if env_dir is None:
        assert got == str(ROOT / ".jax_cache")
        assert updates == [("jax_compilation_cache_dir", got)]
    else:
        assert got == env_dir
        assert updates == []


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_require_gpu(monkeypatch, platform):
    dev = SimpleNamespace(platform=platform, device_kind="fake")
    monkeypatch.setattr(jax, "devices", lambda: [dev])
    if platform == "gpu":
        assert bench.require_gpu() is dev
    else:
        with pytest.raises(SystemExit, match="no GPU"):
            bench.require_gpu()


def _run_smoke(cwd, tmp_path):
    env = {
        "PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path),
        "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cache"),
    }
    return subprocess.run(
        [sys.executable, str(Path(cwd) / "chip_smoke.py")], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu(tmp_path):
    """On a CPU-only JAX the script exits non-zero before any phase and
    prints no contract line."""
    r = _run_smoke(ROOT, tmp_path)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_needs_the_repo(tmp_path):
    """Alone in a directory, without the package, the script fails."""
    alone = tmp_path / "alone"
    alone.mkdir()
    (alone / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    r = _run_smoke(alone, tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
