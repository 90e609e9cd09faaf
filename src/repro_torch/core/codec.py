"""Fixed-capacity sparse codec (port of ``repro.core.codec``).

A compressed gradient is a pair ``(values, indices)`` of static shape
``(k_cap,)``; padding slots carry ``indices == SENTINEL`` (= -1) and
``values == 0``.  The contract every producer and consumer relies on is
the JAX package's:

* **Sentinels** — a slot with ``index == SENTINEL`` is padding and the
  decoders skip it: slot ``j`` of a ``k``-slot pair goes to its own
  scratch column ``d + j``, cut off afterwards.  Distinct scratch
  columns keep the CUDA scatter free of contention: an adaptive-density
  wire block is mostly sentinels (its capacity is sized from the
  ceiling, 4× the budget), and one shared scratch column serialised
  millions of atomic adds.
* **Duplicates** — decoding scatter-*adds*, so a coordinate named by
  several slots accumulates.
* **Overflow** — :func:`compact_by_mask` never emits more than ``k_cap``
  real slots; the lowest indices win and the surplus stays in the
  caller's error-feedback residual.

Determinism: on the CPU ``index_add_`` accumulates in slot order, like
the JAX scatter-add, so decode is bit-equal to the reference even with
duplicates.  On CUDA ``index_add_`` adds with atomics: the result is
deterministic only when no index repeats within one call.  Every pair
the port produces is duplicate-free within itself (each segment's
indices are distinct and segments occupy disjoint column ranges; a
gTop-k re-encode is a top-k).  Indices repeat only ACROSS workers, so
the gathered block is decoded by :func:`decode_sum`: one duplicate-free
scatter per rank, in rank order — the same bits on the card and on the
CPU.
"""
from __future__ import annotations

import torch

SENTINEL = -1


def compact_by_mask(u: torch.Tensor, mask: torch.Tensor, k_cap: int):
    """Compact the masked elements of ``u`` into ``(k_cap,)`` buffers, in
    index order; on overflow the highest indices are dropped.  Returns
    ``(values, indices)`` with sentinel padding."""
    d = u.shape[0]
    m = mask.to(torch.int64)
    pos = torch.cumsum(m, 0) - 1
    keep = (m == 1) & (pos < k_cap)
    slot = torch.where(keep, pos, torch.full_like(pos, k_cap))
    values = torch.zeros(k_cap + 1, dtype=u.dtype, device=u.device)
    values.scatter_(0, slot, u)
    indices = torch.full((k_cap + 1,), SENTINEL, dtype=torch.int32,
                         device=u.device)
    indices.scatter_(0, slot, torch.arange(d, dtype=torch.int32,
                                           device=u.device))
    # slot k_cap is the scratch slot every dropped element wrote to
    return values[:k_cap], indices[:k_cap]


def _safe(values: torch.Tensor, indices: torch.Tensor, d: int):
    """A 1-D pair's scatter targets in a ``(d + k,)`` buffer: real slots
    their index, sentinel slot ``j`` the scratch column ``d + j`` (value
    0)."""
    sent = indices == SENTINEL
    scratch = d + torch.arange(indices.shape[0], device=indices.device)
    safe = torch.where(sent, scratch, indices.long())
    vals = torch.where(sent, torch.zeros_like(values), values)
    return safe, vals


def decode(values: torch.Tensor, indices: torch.Tensor, d: int
           ) -> torch.Tensor:
    """Scatter-add a pair back to a dense ``(d,)`` vector (sentinels
    skipped, duplicates accumulated in slot order on the CPU)."""
    safe, vals = _safe(values, indices, d)
    out = torch.zeros(d + indices.shape[0], dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, safe, vals)
    return out[:d]


def keep_mask(indices: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """DGC's rule for the coordinates a pair sent: ``1 − clip(decode(1,
    indices), 0, 1)``, a dense ``(d,)`` mask of 0 at every sent index and
    1 elsewhere (sentinels send nothing), as the reference writes it."""
    ones = torch.ones(indices.shape, dtype=dtype, device=indices.device)
    return 1.0 - torch.clamp(decode(ones, indices, d), 0.0, 1.0)


def decode_add(dense: torch.Tensor, values: torch.Tensor,
               indices: torch.Tensor) -> torch.Tensor:
    """Scatter-add a pair into a copy of ``dense`` (same semantics as
    :func:`decode`; ``dense`` supplies the base and the length)."""
    d = dense.shape[0]
    safe, vals = _safe(values.to(dense.dtype), indices, d)
    out = torch.cat([dense, dense.new_zeros(indices.shape[0])])
    out.index_add_(0, safe, vals)
    return out[:d]


def decode_sum(values: torch.Tensor, indices: torch.Tensor, d: int,
               dtype=torch.float32) -> torch.Tensor:
    """Sum of the decoded pairs of ``n`` ranks: ``(n, M, k)`` values and
    indices -> ``(M, d)``, in ``dtype``.  Rank ``r``'s pairs are added
    into one dense bucket with one scatter per row after ranks ``0..r-1``
    (each rank's indices are duplicate-free, so each scatter is
    deterministic on CUDA), never as an ``(n, M, d)`` stack."""
    n, rows, k = values.shape
    out = torch.zeros((rows, d + k), dtype=dtype, device=values.device)
    for r in range(n):
        for m in range(rows):
            safe, vals = _safe(values[r, m].to(dtype), indices[r, m], d)
            out[m].index_add_(0, safe, vals)
    return out[:, :d]


def offset_indices(indices: torch.Tensor, offset: int) -> torch.Tensor:
    """Shift the real indices by ``offset``; sentinels stay sentinels.
    Computed in int64, stored int32 (bucket-global indices reach 1.5e9
    on llama3.2-1b, 70% of the int32 range)."""
    shifted = (indices.long() + int(offset)).to(torch.int32)
    return torch.where(indices == SENTINEL, indices, shifted)


def nnz(indices: torch.Tensor) -> torch.Tensor:
    """Number of real (non-sentinel) slots; a duplicate counts per slot."""
    return torch.sum(indices != SENTINEL).to(torch.int32)
