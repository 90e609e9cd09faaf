"""Sparsification operators (port of ``repro.core.compressors``).

Every compressor maps a flat vector ``u = g + e`` to a fixed-capacity
``(values, indices)`` pair (``codec.py``).  The key-sampled operators
(``needs_key``) take a ``repro_torch.prng`` key and draw exactly the
reference's ``jax.random`` bits, so their selections are the
reference's, index for index:

=============  ==========================================  ==========
name           selection rule                              k_cap
=============  ==========================================  ==========
``topk``       exact top-k by ``|u|``, ties to the lower   k
               index (``lax.top_k``'s order)
``gaussiank``  paper Algorithm 1: Gaussian-ppf threshold   ceil(4k/3)
               + ≤4 refinement steps (band [2k/3, 4k/3])
``gaussiank2`` the same with ``p = 1 - k/(2d)``            ceil(4k/3)
``trimmedk``   RedSync: 16 bisection steps of a threshold  2k
               between mean(|u|) and max(|u|)
``histk``      quarter-octave histogram threshold (K4d)    ceil(4k/3)
               + block compaction (K4c)
``randk``      k uniform indices without replacement: the  k
               top-k of one uniform per coordinate
``dgck``       DGC: threshold from a strided sample,       k
               exact top-k among the candidates above it
``rtopk``      rTop-k: exact top-k within a strided        k
               sample of ``4k`` coordinates
=============  ==========================================  ==========

Every top-k here follows ``lax.top_k``'s order: descending, and of equal
scores the lower index first.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import codec


class CompressorSpec(NamedTuple):
    name: str
    select: Callable  # (u, k, key) -> (values, indices)
    k_cap: Callable[[int, int], int]  # (k, d) -> capacity
    needs_key: bool = False


def topk_select(u: torch.Tensor, k: int, key=None):
    """Exact ``Top_k`` by ``|u|``.  A stable descending sort puts the
    lower index first among equal magnitudes — ``lax.top_k``'s order
    (``torch.topk`` breaks ties otherwise)."""
    _, order = torch.sort(torch.abs(u), descending=True, stable=True)
    idx = order[:k]
    return u[idx], idx.to(torch.int32)


def _traced(k) -> bool:
    """Whether ``k`` is a per-step budget from the allocator
    (``np.int32``, the reference's traced int32) rather than a static
    Python int.  The reference's arithmetic on the two differs: on an
    int the weakly typed floats compute in f64 and round once; on an
    int32 array every operation is f32."""
    return isinstance(k, (np.integer, np.ndarray))


def gaussian_ppf_p(k, d: int, two_sided: bool) -> np.float32:
    """The quantile ``p = 1 - k/d`` (``1 - k/(2d)`` two-sided) of
    Algorithm 1's start threshold, as the reference computes it for a
    static ``k`` (f64, rounded to f32) or a per-step one (f32:
    ``1 - f32(k) / f32(d)``)."""
    if _traced(k):
        c = np.float32(2.0 * d) if two_sided else np.float32(d)
        return np.float32(np.float32(1.0) - np.float32(k) / c)
    return np.float32(1.0 - (k / (2.0 * d) if two_sided else k / d))


def accept_band(k):
    """Algorithm 1's accept band ``[2k/3, 4k/3]`` as f32 edges: one
    rounding of the f64 value for a static ``k``, ``f32(2·k) / 3`` and
    ``f32(4·k) / 3`` for a per-step one."""
    if _traced(k):
        kf, three = np.float32(k), np.float32(3.0)
        return (np.float32(np.float32(2.0) * kf) / three,
                np.float32(np.float32(4.0) * kf) / three)
    return np.float32(2.0 * k / 3.0), np.float32(4.0 * k / 3.0)


def gaussian_threshold(u: torch.Tensor, k, refine_iters: int = 4,
                       two_sided: bool = False) -> torch.Tensor:
    """The ``|u|`` threshold selecting ~k elements (Algorithm 1 lines
    2-13), with the POPULATION std as in the reference.  ``k`` is a
    static int or an allocator's ``np.int32`` (f32 threshold math).

    A bf16 ``u`` follows the reference at bf16: its mean and population
    variance summed in f32 and rounded to bf16, the std a bf16 square
    root plus ``1e-12`` in bf16, ``ndtri`` of the f32 ``p`` in f32 (the
    CPU has no bf16 ``ndtri``; the reference's ``norm.ppf`` takes the
    f32 path too) and the threshold ``|q·sigma + mu|`` in f32 from the
    bf16 ``mu`` and ``sigma``; the refinement compares ``f32(|u|)`` with
    that f32 threshold against bf16 band edges."""
    if u.dtype == torch.bfloat16:
        return _gaussian_threshold_bf16(u, k, refine_iters, two_sided)
    mu = torch.mean(u)
    sigma = torch.std(u, unbiased=False) + 1e-12
    p = gaussian_ppf_p(k, u.shape[0], two_sided)
    q = torch.special.ndtri(torch.tensor(float(p), dtype=u.dtype,
                                         device=u.device))
    thres = torch.abs(q * sigma + mu)
    lo, hi = (torch.tensor(float(x), dtype=u.dtype, device=u.device)
              for x in accept_band(k))
    return _refine(torch.abs(u), thres, lo, hi, refine_iters)


def _refine(abs_u, thres, lo, hi, refine_iters: int) -> torch.Tensor:
    """Algorithm 1's refinement loop: halve below the band ``[lo, hi]``,
    ×1.5 above it, freeze once inside."""
    done = torch.zeros((), dtype=torch.bool, device=abs_u.device)
    for _ in range(refine_iters):
        est = torch.sum(abs_u > thres).to(torch.float32)
        new = torch.where(est < lo, 0.5 * thres,
                          torch.where(est > hi, 1.5 * thres, thres))
        in_band = (est >= lo) & (est <= hi)
        thres = torch.where(done, thres, new)
        done = done | in_band
    return thres


def _gaussian_threshold_bf16(u: torch.Tensor, k, refine_iters: int,
                             two_sided: bool) -> torch.Tensor:
    """:func:`gaussian_threshold` of a bf16 ``u``: an f32 threshold."""
    d = u.shape[0]
    x = u.to(torch.float32)
    m32 = torch.sum(x) / d
    mu = m32.to(u.dtype)
    var = (torch.sum(torch.square(x - m32)) / d).to(u.dtype)
    sigma = torch.sqrt(var) + 1e-12
    p = gaussian_ppf_p(k, d, two_sided)
    q = torch.special.ndtri(torch.tensor(float(p), dtype=torch.float32,
                                         device=u.device))
    thres = torch.abs(q * sigma.to(torch.float32) + mu.to(torch.float32))
    lo, hi = (torch.tensor(float(b), dtype=u.dtype,
                           device=u.device).to(torch.float32)
              for b in accept_band(k))
    return _refine(torch.abs(u).to(torch.float32), thres, lo, hi,
                   refine_iters)


def above(u: torch.Tensor, thres) -> torch.Tensor:
    """``|u| > thres`` compared as the reference compares it: a bf16
    ``u`` against an f32 threshold in f32 (torch would round a 0-d f32
    threshold to ``u``'s dtype first)."""
    a = torch.abs(u)
    if isinstance(thres, torch.Tensor) and thres.dtype != a.dtype:
        a = a.to(torch.promote_types(a.dtype, thres.dtype))
    return a > thres


def gaussiank_select(u: torch.Tensor, k: int, key=None,
                     refine_iters: int = 4, two_sided: bool = False):
    """``Gaussian_k`` (paper Algorithm 1): threshold + fixed-capacity
    compaction."""
    k_cap = gaussiank_cap(k, u.shape[0])
    thres = gaussian_threshold(u, k, refine_iters, two_sided)
    return codec.compact_by_mask(u, above(u, thres), k_cap)


def gaussiank_cap(k: int, d: int) -> int:
    # accept band upper edge (4k/3) — Algorithm 1 stops inside the band
    return min(d, int(math.ceil(4.0 * k / 3.0)))


def trimmed_threshold(u: torch.Tensor, k: int, iters: int = 16
                      ) -> torch.Tensor:
    """RedSync's threshold: bisect between ``mean(|u|)`` and ``max(|u|)``
    — raise it while more than ``1.25k`` elements exceed the midpoint,
    lower it while fewer than ``k`` do — and return the lower end.  All
    in f32 torch ops on ``u``'s device, with no host sync."""
    abs_u = torch.abs(u)
    lo = torch.mean(abs_u)
    hi = torch.max(abs_u)
    k_f = torch.tensor(float(k), dtype=u.dtype, device=u.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        est = torch.sum(abs_u > mid).to(u.dtype)
        # too many selected -> raise the threshold; too few -> lower it
        lo = torch.where(est > 1.25 * k_f, mid, lo)
        hi = torch.where(est < k_f, mid, hi)
    return lo


def trimmedk_select(u: torch.Tensor, k: int, key=None, iters: int = 16):
    """``Trimmed_k`` (RedSync, Fang et al. 2019): compact ``|u| >``
    :func:`trimmed_threshold` with a cap of ``2k`` (RedSync accepts
    thresholds that over-select).  Plain torch, as the reference is plain
    jnp: no kernel."""
    thres = trimmed_threshold(u, k, iters)
    return codec.compact_by_mask(u, torch.abs(u) > thres,
                                 min(u.shape[0], 2 * k))


def histk_select(u: torch.Tensor, k: int, key=None):
    """``Hist_k``: one-pass magnitude-histogram threshold + blocked
    compaction, through the K4d and K4c kernels (their plain versions on
    the CPU) at the reference's block of 2048."""
    # imported here: the kernels package builds on this module
    from repro_torch.kernels.histk import histk_select_kernel
    return histk_select_kernel(u, k)


def randk_select(u: torch.Tensor, k: int, key):
    """``Rand_k``: k uniform indices without replacement, the top-k of
    ``uniform(key, u.shape)`` in ``lax.top_k``'s order (one rank key per
    coordinate from the ``threefry_bits`` kernel on the card)."""
    idx = torch.topk(prng.rank_keys(key, u.shape[0], device=u.device),
                     k).indices
    return u[idx], idx.to(torch.int32)


def _strided_sample(key, d: int, s: int, device) -> torch.Tensor:
    """``s`` distinct indices in ``[0, d)``: a random-phase systematic
    sample, stride ``d // s`` from a phase drawn on the host
    (``randint(key, (), 0, d)``).  int64."""
    stride = max(1, d // s)
    offset = prng.randint_scalar(key, 0, d)
    return (offset + stride * torch.arange(s, device=device)) % d


def dgck_select(u: torch.Tensor, k: int, key, sample_ratio: float = 0.01):
    """``DGC_k``: the threshold is the ``ks``-th largest ``|u|`` of a
    strided sample; the candidates at or above it are compacted (capped
    at 2k) and the exact top-k of the candidates is kept.  The sizes are
    the reference's f64 arithmetic on Python ints."""
    d = u.shape[0]
    s = max(k, int(math.ceil(sample_ratio * d)))
    s = min(s, d)
    # bias the sampled threshold low (x1.5) so candidates over-cover k
    ks = max(1, min(s, int(math.ceil(1.5 * k * s / d))))
    samp = torch.abs(u[_strided_sample(key, d, s, u.device)])
    thres = torch.topk(samp, ks).values[-1]
    cand_cap = min(d, 2 * k)
    cvals, cidx = codec.compact_by_mask(u, torch.abs(u) >= thres, cand_cap)
    # exact top-k among the candidates (sentinel slots have value 0)
    vals, sel = topk_select(cvals, k)
    return vals, cidx[sel.long()]


def rtopk_sample_size(k: int, d: int, sample_mult: float = 4.0) -> int:
    """Static sample width ``r = clip(ceil(sample_mult·k), k, d)``."""
    return max(k, min(d, int(math.ceil(sample_mult * k))))


def rtopk_select(u: torch.Tensor, k: int, key, sample_mult: float = 4.0):
    """``rTop_k`` (Barnes et al. 2020): exact top-k within a strided
    sample of ``r`` coordinates — ``k`` distinct pairs, no sentinels."""
    d = u.shape[0]
    sidx = _strided_sample(key, d, rtopk_sample_size(k, d, sample_mult),
                           u.device)
    vals, sel = topk_select(u[sidx], k)
    return vals, sidx[sel.long()].to(torch.int32)


def rtopk_cap(k: int, d: int) -> int:
    # the in-sample top-k returns exactly k duplicate-free pairs
    return min(d, k)


_REGISTRY = {
    "topk": CompressorSpec("topk", topk_select, lambda k, d: k),
    "gaussiank": CompressorSpec("gaussiank", gaussiank_select, gaussiank_cap),
    "gaussiank2": CompressorSpec(
        "gaussiank2", partial(gaussiank_select, two_sided=True),
        gaussiank_cap),
    "trimmedk": CompressorSpec("trimmedk", trimmedk_select,
                               lambda k, d: min(d, 2 * k)),
    "histk": CompressorSpec("histk", histk_select, gaussiank_cap),
    "randk": CompressorSpec("randk", randk_select, lambda k, d: k,
                            needs_key=True),
    "dgck": CompressorSpec("dgck", dgck_select, lambda k, d: k,
                           needs_key=True),
    "rtopk": CompressorSpec("rtopk", rtopk_select, rtopk_cap,
                            needs_key=True),
}


def get_compressor(name: str) -> CompressorSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; have "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available() -> list:
    return sorted(_REGISTRY)

