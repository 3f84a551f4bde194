"""JAX's persistent compilation cache for the entry scripts.

Where `JAX_COMPILATION_CACHE_DIR` is set, JAX already reads it and nothing
here changes it.  Otherwise the cache goes to a fixed `.jax_cache/` in the
checkout (listed in `.gitignore`): a fixed path, because the path is part of
the cache key and a directory that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

CHECKOUT = Path(__file__).resolve().parents[2]


def compile_cache_dir(environ=os.environ) -> Optional[str]:
    """The directory this checkout should set for the cache, or None when
    `JAX_COMPILATION_CACHE_DIR` already names one."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(CHECKOUT / ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on for this process; returns its directory."""
    import jax

    path = compile_cache_dir()
    if path is None:
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    jax.config.update("jax_compilation_cache_dir", path)
    return path
