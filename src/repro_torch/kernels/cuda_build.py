"""Build and load the port's CUDA C++ kernels (``repro_torch/csrc``).

Each ``.cu`` source is compiled by ``nvcc`` on its own into a shared
library with a plain C interface (``-gencode arch=compute_90a,
code=sm_90a -O3 -shared -Xcompiler -fPIC``) and loaded with
:mod:`ctypes`; pointers and the stream travel as ``c_void_p``.  The
parameter types of every ``extern "C"`` entry point are in
:data:`SIGNATURES`, which :func:`load` (and :func:`bind`, for a library
built another way) sets on the library; ``tests/test_torch_csrc.py``
holds them against the sources' declarations.  A
library is built at first use into the build directory
(``REPRO_TORCH_BUILD_DIR``, default ``build/kernels`` beside ``src/``,
which ``.gitignore`` lists) under a name that carries a hash of its
source and flags, so an edited source is rebuilt and an unchanged one is
reused.  :func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
ENV_BUILD_DIR = "REPRO_TORCH_BUILD_DIR"

_LIBS: dict = {}
_LOCK = threading.Lock()

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# every extern "C" entry point of csrc/ by source: its parameters' ctypes
# in order (each returns its cudaError_t as an int)
SIGNATURES = {
    "abs_histogram.cu": {
        "abs_histogram": (_P, _I, _LL, _P, _P),
        "fused_moments_hist": (_P, _P, _I, _I, _LL, _P, _P, _I, _P)},
    "compact_residual.cu": {
        "compact_stage": (_P, _P, _I, _I, _LL, _F, _I, _I, _LL, _P, _P, _P,
                          _P),
        "compact_resid": (_P, _P, _I, _I, _LL, _F, _I, _I, _LL, _LL, _P, _P,
                          _P),
        "compact_sweep": (_P, _P, _I, _I, _LL, _F, _I, _I, _LL, _LL, _P, _P,
                          _P, _P, _P, _P, _P, _P)},
    "tree_count.cu": {
        "tree_count": (_P, _P, _I, _I, _LL, _P, _I, _P, _I, _P, _P)},
}


def build_dir() -> str:
    env = os.environ.get(ENV_BUILD_DIR, "")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(CSRC)))
    return os.path.join(root, "build", "kernels")


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _lib_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(build_dir(), f"lib{stem}-{h.hexdigest()[:16]}.so")


def _compile_cmd(source: str, out: str) -> list:
    return [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
            os.path.join(CSRC, source)]


def build_all(sources=None) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all
    started together.  Returns ``{source: ptxas report}`` for the ones
    built now; raises with the compiler's output on failure."""
    sources = sources or sorted(f for f in os.listdir(CSRC)
                                if f.endswith(".cu"))
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    for src in sources:
        out = _lib_path(src)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[src] = (subprocess.Popen(_compile_cmd(src, tmp),
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    reports = {}
    for src, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, out)
        reports[src] = log
    return reports


def bind(lib, source: str):
    """Set the argument and return types of ``source``'s entry points
    (:data:`SIGNATURES`) on ``lib``, a library built from it (or from
    another version of it with the same interface); returns ``lib``."""
    for name, args in SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return lib


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (built first if missing), its
    entry points typed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            build_all([source])
            lib = bind(ctypes.CDLL(_lib_path(source)), source)
            _LIBS[source] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{rc}")
