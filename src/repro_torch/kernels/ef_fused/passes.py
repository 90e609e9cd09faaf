"""Device-memory pass accounting for the compression pipelines (port of
``repro.kernels.ef_fused.passes``).

A "pass" is one full streaming traversal of a leaf-sized (``d``-element)
array by a kernel or elementwise op.  The pipeline entry points in
``ops.py`` are plain Python compositions of kernel launches, so every
call executes the ``record`` calls exactly once per pipeline invocation.
Wrap a call in :func:`count_passes` to read its pass count.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import List, Tuple

_STACK: List["PassLog"] = []


class PassLog:
    """Ordered (label, n_passes) records of one measured pipeline call."""

    def __init__(self) -> None:
        self.records: List[Tuple[str, int]] = []

    def total(self) -> int:
        return sum(n for _, n in self.records)

    def by_label(self) -> dict:
        out: dict = {}
        for label, n in self.records:
            out[label] = out.get(label, 0) + n
        return out


def record(label: str, n: int = 1) -> None:
    """Record ``n`` HBM passes under ``label`` (no-op outside a log)."""
    if _STACK and n:
        _STACK[-1].records.append((label, int(n)))


@contextmanager
def count_passes():
    """Collect :func:`record` calls issued while the context is active."""
    log = PassLog()
    _STACK.append(log)
    try:
        yield log
    finally:
        _STACK.pop()
