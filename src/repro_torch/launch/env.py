"""Pinned, reproducible launch environment of the port (port of
``repro/launch/env.py``).

Benchmark numbers compare across machines only when the allocator and
the collective library's settings are known.  This module is that
policy as code, two ways:

* ``python -m repro_torch.launch.env --shell`` prints ``export`` lines
  to ``eval`` before the Python process starts (``LD_PRELOAD`` takes
  effect only then); this path never imports torch;
* :func:`describe_env` snapshots the recorded variables at run time, so
  every benchmark row (``benchmarks/common.bench_meta``) and every
  ``Roofline`` records the environment it was measured under.

What it pins: tcmalloc preloaded when the library exists on the host
(as the reference does) and tcmalloc's large-allocation report moved out
of the logs.  Neither changes a number the port computes or checks.
What it records, beside ``LD_PRELOAD``: the CUDA caching allocator's
and cuBLAS's settings, the visible cards, NCCL's algorithm, protocol
and transport switches, and the CPU thread count.  Caller-set values
win: a variable already present is left alone, and ``LD_PRELOAD`` keeps
what it has.  Nothing applies the pinned environment implicitly.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

# candidate tcmalloc locations (Debian/Ubuntu multiarch, RH lib64)
TCMALLOC_PATHS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib64/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc.so.4",
)

ENV_DEFAULTS = {
    # tcmalloc: only report pathological (>60GB) single allocations
    "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "60000000000",
}

# the variables a benchmark row records (measurement provenance)
RECORDED_VARS = ("PYTORCH_CUDA_ALLOC_CONF", "CUBLAS_WORKSPACE_CONFIG",
                 "CUDA_VISIBLE_DEVICES", "NCCL_ALGO", "NCCL_PROTO",
                 "NCCL_P2P_DISABLE", "NCCL_IB_DISABLE", "OMP_NUM_THREADS",
                 "LD_PRELOAD")


def find_tcmalloc() -> Optional[str]:
    for p in TCMALLOC_PATHS:
        if os.path.exists(p):
            return p
    return None


def pinned_env(base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The pinned launch environment as a ``{var: value}`` delta over
    ``base`` (default ``os.environ``): only the variables that change.
    A variable already set in ``base`` is left alone; tcmalloc is
    appended to ``LD_PRELOAD`` unless it is there."""
    base = dict(os.environ if base is None else base)
    out: Dict[str, str] = {}
    for var, value in ENV_DEFAULTS.items():
        if var not in base:
            out[var] = value
    tcmalloc = find_tcmalloc()
    if tcmalloc and tcmalloc not in base.get("LD_PRELOAD", ""):
        preload = base.get("LD_PRELOAD", "")
        out["LD_PRELOAD"] = f"{preload}:{tcmalloc}".strip(":")
    return out


def apply_pinned_env() -> Dict[str, str]:
    """Apply :func:`pinned_env` to ``os.environ``; returns the delta.
    ``LD_PRELOAD`` only acts on processes started after this."""
    delta = pinned_env()
    os.environ.update(delta)
    return delta


def describe_env(base: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The recorded variables that are set, as ``{var: value}``."""
    base = os.environ if base is None else base
    return {var: base[var] for var in RECORDED_VARS if var in base}


def shell_lines() -> list:
    """``export`` lines of :func:`pinned_env`, sorted by variable."""
    return [f"export {var}={value!r}"
            for var, value in sorted(pinned_env().items())]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shell", action="store_true",
                    help="print export lines to eval before a launch")
    args = ap.parse_args(argv)
    if args.shell:
        for ln in shell_lines():
            print(ln)
    else:
        for var, value in sorted(describe_env().items()):
            print(f"{var}={value}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
