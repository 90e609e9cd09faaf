"""Numerics for the paper's contraction-bound analysis (§3.2, Fig. 3,
Fig. 5; port of ``repro/core/bounds.py``).

``gamma_exact``      exact ||u - Top_k(u)||^2 / ||u||^2          (Eq. 5)
``bound_classic``    1 - k/d   (Stich et al. / Alistarh et al.)  (Eq. 3)
``bound_paper``      (1 - k/d)^2                                 (Theorem 1)
``delta_paper``      delta = (2kd - k^2) / d^2                   (Eq. 12)
``pi_squared``       the sorted-normalised curve of Fig. 3(b)
``iterations_to_dense_rate``  T >= O(1/delta^2) comparison (Theorem 2)
"""
from __future__ import annotations

import torch


def gamma_exact(u: torch.Tensor, k: int) -> torch.Tensor:
    """Exact value of ||u - Top_k(u)||^2 / ||u||^2, summed in f64 for an
    f64 ``u`` and in f32 otherwise.  Only the top-k values enter, so
    ``torch.topk``'s tie order does not matter."""
    topv = torch.topk(torch.abs(u), k).values
    acc = torch.float64 if u.dtype == torch.float64 else torch.float32
    total = torch.sum(u.to(acc) ** 2)
    kept = torch.sum(topv.to(acc) ** 2)
    return (total - kept) / total


def bound_classic(k: int, d: int) -> float:
    return 1.0 - k / d


def bound_paper(k: int, d: int) -> float:
    return (1.0 - k / d) ** 2


def delta_paper(k: int, d: int) -> float:
    return (2.0 * k * d - k * k) / (d * d)


def pi_squared(u: torch.Tensor) -> torch.Tensor:
    """pi_(i)^2: sorted |u|/||u||_inf squared, descending (Fig. 3b)."""
    a = torch.sort(torch.abs(u), descending=True).values
    a = a / a[0]
    return a * a


def iterations_to_dense_rate(c: float, use_paper_bound: bool) -> float:
    """T after which the SGD term dominates (Theorem 2 discussion).

    classic: T >= O(c^2);  paper: T >= O(c^4 / (2c - 1)^2).
    """
    if use_paper_bound:
        return c ** 4 / (2 * c - 1) ** 2
    return c ** 2
