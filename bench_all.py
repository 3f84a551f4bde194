"""Both LJ-melt cells under one contract: the 1,000,188-atom melt, then the
97,556-atom melt last.  Each prints one JSON line (see `bench.py` for the
checks every timed run passes); a failed check exits non-zero.

    python bench_all.py
"""

from __future__ import annotations

import json

import bench


def bench_1m(steps: int = 200) -> dict:
    """1M-atom LJ melt: 100 settle steps of the hot FCC start, then `steps`
    timed steps."""
    return bench.lj_melt(1_000_000, equil_steps=100, steps=steps)


def main():
    from emdee_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = bench.require_gpu()
    r = bench_1m()
    print(json.dumps({
        "variant": "1m_lj", "value": r["atom_steps_per_s"], "unit": "atom-steps/s",
        "ms_per_step": r["ms_per_step"], "backend": r["backend"],
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "failures": r["failures"],
    }), flush=True)
    if r["failures"]:
        raise SystemExit(1)
    bench.main()


if __name__ == "__main__":
    main()
