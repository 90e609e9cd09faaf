"""Kernel backend resolution + block configuration (port of
``repro.kernels.ef_fused.tuning``).

Two backends, resolved from the DEVICE OF THE TENSOR and nothing else:

* ``cuda``  — the hand-written Hopper kernels (K1/K2 in Triton, K3 in
  CUDA C++) for tensors on the card;
* ``torch`` — the kernels' plain PyTorch versions, for tensors on the
  CPU.  They repeat each kernel's block structure, so the CPU path is
  the arithmetic the card runs.

There is no fallback from one to the other: a CUDA tensor launches its
kernel or raises.

The geometry follows the backend, so a CPU run and a card run of the
same call may stage differently: where a block selects more than its
staging width, the two keep different elements.  :func:`geometry_of`
makes a CPU run take the card's geometry, for a like-for-like
comparison of the two.  It exists for that check alone (the card-vs-CPU
phase of ``chip_smoke.py`` and its test); training never sets it.

Block heuristics (no measured autotune and no table files in this slice):

* ``cuda``: ``block = 1024`` (the f32 Triton minimum of the reference,
  ``tuning.py:230``) and ``stats_block = max(1024, min(4096,
  shape_class(d)))`` (``tuning.py:261``);
* ``torch``: the reference's ``interpret`` heuristic — a 2048 floor, at
  most 64 compaction blocks and at most 4 stats blocks
  (``tuning.py:225,247,260``) — so CPU geometry, and with it every
  staging truncation, equals the JAX reference run on the CPU.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch

BACKENDS = ("cuda", "torch")

# reference interpret-mode grid bounds (kept so CPU geometry matches)
MAX_INTERPRET_BLOCKS = 64
MAX_INTERPRET_STATS_BLOCKS = 4
INTERPRET_MIN_BLOCK = 2048
CUDA_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One resolved configuration of the fused EF pipeline.

    ``block`` drives K3 (compaction + residual), ``stats_block`` the
    reductions K1/K2, ``bcap_slack`` the staging-width multiplier of
    ``ops.fused_default_bcap``."""
    backend: str
    block: int
    stats_block: int
    bcap_slack: float = 2.0


def resolve_backend(x: torch.Tensor) -> str:
    """``cuda`` for a tensor on the card, ``torch`` for one on the CPU;
    raises on any other device."""
    if x.device.type == "cuda":
        return "cuda"
    if x.device.type == "cpu":
        return "torch"
    raise ValueError(f"no kernel backend for device {x.device}")


def shape_class(d: int) -> int:
    """pow2 ceiling of ``d`` — shapes in the same class share a config."""
    return max(1, 1 << (int(d) - 1).bit_length()) if d > 1 else 1


def bounded_block(d: int, max_blocks: int, base: int) -> int:
    """Smallest pow2 multiple of ``base`` with ``<= max_blocks`` blocks."""
    block = base
    while d > block * max_blocks:
        block *= 2
    return block


def choose_block(d: int, backend: str) -> int:
    """Compaction (K3) block size for a ``d``-element leaf."""
    if backend == "torch":
        return bounded_block(d, MAX_INTERPRET_BLOCKS, INTERPRET_MIN_BLOCK)
    _check(backend)
    return CUDA_BLOCK


def choose_stats_block(d: int, backend: str) -> int:
    """Reduction (K1/K2) block size for a ``d``-element leaf."""
    if backend == "torch":
        return bounded_block(d, MAX_INTERPRET_STATS_BLOCKS,
                             INTERPRET_MIN_BLOCK)
    _check(backend)
    return max(CUDA_BLOCK, min(4 * CUDA_BLOCK, shape_class(d)))


def _check(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"have {BACKENDS}")


_GEOMETRY: list = []   # backends whose geometry geometry_of() imposes


@contextmanager
def geometry_of(backend: str):
    """Inside the block, :func:`resolve_config` gives ``backend``'s
    geometry whatever device the tensors are on (the kernels still run
    by device: CPU tensors take the plain versions).

    For the card-vs-CPU comparison only.  The override is one
    process-wide stack, not per thread: it is not thread-safe, and
    every caller in the process sees it while the block is open."""
    _check(backend)
    _GEOMETRY.append(backend)
    try:
        yield
    finally:
        _GEOMETRY.pop()


def resolve_config(d: int, backend: str) -> KernelConfig:
    """The heuristic :class:`KernelConfig` of a ``d``-element leaf (the
    innermost :func:`geometry_of` backend's, when one is active)."""
    backend = _GEOMETRY[-1] if _GEOMETRY else backend
    return KernelConfig(backend=backend, block=choose_block(d, backend),
                        stats_block=choose_stats_block(d, backend))
