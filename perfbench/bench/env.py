"""The run's surroundings: the program on ``sys.path``, fixed cache
directories inside the checkout, the process's start time, and the
check that no JAX module and no module of the JAX package is loaded."""
from __future__ import annotations

import os
import sys
import time

from perfbench.bench.spec import ROOT

# top-level module names a run may not load (compared whole: the port's
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE = os.path.join(ROOT, "perfbench", ".cache")


def prepare() -> None:
    """The program's source on ``sys.path``; the nvcc build and Triton's
    cache at fixed paths inside the checkout, so that only a checkout's
    first run builds."""
    src = os.path.join(ROOT, "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(CACHE, "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")


def forbidden_loaded(names=None) -> list:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def process_start() -> float:
    """This process's start on the ``time.time()`` clock, from
    ``/proc/self/stat`` (the interpreter's own start included); the
    import time of this module where ``/proc`` is missing."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        hz = os.sysconf("SC_CLK_TCK")
        return time.time() - uptime + ticks / hz
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()
