"""Gaussian-k with error feedback, a frozen copy of the program's
selection rule (paper Algorithm 1 as the program's fused pipeline runs
it), written with plain PyTorch operations.

For one gradient leaf ``g`` and its residual ``e``:

1. ``u = f32(g) + f32(e)``; the start threshold ``t0 = |mean + (std +
   1e-12)·ndtri(1 - k/d)|`` from the population moments of ``u``.
2. Up to four refinements: while the count of ``|u| > t`` lies outside
   ``[2k/3, 4k/3]``, halve ``t`` (too few) or take ``1.5·t`` (too
   many); stop once inside.
3. The elements above the threshold, in index order, at most ``bcap`` a
   block of ``block`` elements (``bcap`` twice the expected selection of
   a block at ``k_cap``, at least 64, a multiple of 8) and at most
   ``k_cap = ceil(4k/3)`` in all, go on the wire as ``u`` rounded to the
   residual's dtype; every other element stays in the new residual
   ``e' = u`` rounded to that dtype.

The block is the program's fixed geometry for a leaf of ``d`` bf16
elements on the card: 2048, and 4096 from ``d`` above 2^28 (for f32
leaves 1024)."""
from __future__ import annotations

import math

import numpy as np
import torch


def block_of(d: int, dtype) -> int:
    if dtype == torch.float32:
        return 1024
    return 4096 if d > (1 << 28) else 2048


def bcap_of(k_cap: int, d: int, block: int, slack: float = 2.0) -> int:
    expected = k_cap * block / max(d, 1)
    return int(min(block, max(64, 8 * math.ceil(expected * slack / 8))))


def budgets(d: int, ratio: float):
    k = max(1, math.ceil(ratio * d))
    return k, min(d, math.ceil(4.0 * k / 3.0))


def threshold(u: torch.Tensor, k: int, refine_iters: int = 4) -> float:
    d = u.numel()
    s = u.sum(dtype=torch.float32).cpu()
    sq = (u * u).sum(dtype=torch.float32).cpu()
    mean = s / d
    std = torch.sqrt(torch.clamp(sq / d - mean * mean, min=0.0))
    p = np.float32(1.0 - k / d)
    q = torch.special.ndtri(torch.tensor(float(p), dtype=torch.float32))
    t = np.float32(max(float(torch.abs(q * (std + 1e-12) + mean)), 0.0))
    lo, hi = np.float32(2.0 * k / 3.0), np.float32(4.0 * k / 3.0)
    a = u.abs()
    for _ in range(refine_iters):
        est = np.float32(int((a > float(t)).sum()))
        if lo <= est <= hi:
            break
        t = np.float32(np.float32(0.5) * t) if est < lo else \
            np.float32(np.float32(1.5) * t)
    return float(t)


def compress(g: torch.Tensor, e: torch.Tensor, k: int, k_cap: int):
    """``(values, indices, e')`` of the flat leaf ``g`` against its
    residual ``e``; values and ``e'`` in ``e``'s dtype."""
    d = g.numel()
    u = g.float() + e.float()
    t = threshold(u, k)
    block = block_of(d, e.dtype)
    bcap = bcap_of(k_cap, d, block)
    nb = -(-d // block)
    mask = torch.zeros(nb * block, dtype=torch.bool, device=u.device)
    mask[:d] = u.abs() > t
    mask = mask.view(nb, block)
    staged = mask & (torch.cumsum(mask, 1) <= bcap)
    staged = staged.reshape(-1)[:d]
    sent = staged & (torch.cumsum(staged, 0) <= k_cap)
    idx = torch.nonzero(sent)[:, 0]
    values = u[idx].to(e.dtype)
    new_e = torch.where(sent, torch.zeros_like(u), u).to(e.dtype)
    return values, idx, new_e
