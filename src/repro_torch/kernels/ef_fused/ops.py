"""Fused and unfused error-feedback compression pipelines (port of
``repro/kernels/ef_fused/ops.py``: ``fused_default_bcap``,
``_tree_thresholds``, ``_replay_refinement``,
``_gaussian_threshold_fused``, ``_hist_threshold_fused``, ``_resolve``,
``fused_pass_a``, ``fused_compress_ef``, ``unfused_compress_ef``).

Fused, per leaf, three launches on the card for Gaussian-k:

  K1 ``fused_moments``  → ``(s, sq)`` → Gaussian ppf threshold ``t0``
  K2 ``tree_count``     → counts at the 15 thresholds the refinement
                          loop can reach → replayed final threshold
  K3 ``compact_sweep``  → the staging rows, the new residual ``e'`` and
                          the ``(k_cap,)`` codec pair, in one sweep

and two for hist-k, where K1 with its histogram
(``fused_moments_hist``) gives the threshold and K2 is not run.  Under
adaptive density K1 runs before the rest, on its own
(:func:`fused_pass_a`), and its statistics come back through
``fused_compress_ef(..., stats=)``, which then skips its own K1.  The
K3 stage and residual launches (``compact_residual``) stay as the
counterparts of the reference's GPU lowering and the sweep's
cross-check on the card.  The threshold
glue between the launches (ppf, tree, replay, the histogram read-off)
runs on the host on a handful of scalars, so the card and the CPU path
derive the same threshold from the same statistics.

Unfused (:func:`unfused_compress_ef`, Algorithm 1 as the paper wrote
it): ``u = g + e`` written out, K4a ``moments`` and four K4b
``count_gt`` launches (or K4d ``abs_histogram`` for hist-k), K4c
``threshold_compact``, the assembly, a dense decode and ``e' = u −
decode``.  Same block policy, same threshold, same staging rows; for
f32 operands (and a bf16 ``g`` with an f32 ``e``: the same f32 ``u``)
both pipelines return the same pair and residual bit for bit wherever
their staging widths (2× and 4× the expected per-block selection)
truncate nothing.  With both operands bf16 the unfused ``u`` is rounded
to bf16 before it is selected from, as the reference's is.

Conservation ``decode(values, indices, d) + e' == g + e`` holds bit for
bit: every element is either on the wire (``e' = 0``, its value a copy
of ``u``) or left in the residual (``e' = u``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core.compressors import (accept_band, gaussian_ppf_p,
                                          gaussiank_cap)
from repro_torch.kernels.ef_fused import passes, tuning
from repro_torch.kernels.ef_fused.compact_residual import compact_sweep
from repro_torch.kernels.ef_fused.fused_moments import (fused_moments,
                                                        fused_moments_hist,
                                                        out_dtype)
from repro_torch.kernels.ef_fused.tree_count import tree_count

# compressor names whose selection the fused pipeline implements here
FUSED_COMPRESSORS = ("gaussiank", "gaussiank2", "histk")


def supports_fused(name: str) -> bool:
    return name in FUSED_COMPRESSORS


# staging slack of the unfused pipeline (the fused one takes
# KernelConfig.bcap_slack, 2×)
UNFUSED_BCAP_SLACK = 4.0


def fused_default_bcap(k_cap: int, d: int, block: int,
                       slack: float = 2.0) -> int:
    """Per-block staging width: ``slack``× the expected per-block
    selection, at least 64, at most ``block``, a multiple of 8."""
    expected = k_cap * block / max(d, 1)
    return int(min(block, max(64, 8 * math.ceil(expected * slack / 8))))


def _tree_thresholds(t0: np.float32, refine_iters: int):
    """Heap-ordered thresholds of the refinement tree, depth 0..R:
    ``heap[2i+1] = 0.5·heap[i]``, ``heap[2i+2] = 1.5·heap[i]`` as f32
    products — exactly what the sequential loop computes on any path.
    Returns ``(heap, n_internal = 2^R - 1)``."""
    n_full = 2 ** (refine_iters + 1) - 1
    heap = np.zeros(n_full, np.float32)
    heap[0] = t0
    half, three_halves = np.float32(0.5), np.float32(1.5)
    for i in range((n_full - 1) // 2):
        heap[2 * i + 1] = half * heap[i]
        heap[2 * i + 2] = three_halves * heap[i]
    return heap, 2 ** refine_iters - 1


def _replay_refinement(heap: np.ndarray, counts: np.ndarray, k,
                       refine_iters: int) -> np.float32:
    """Replay Algorithm 1's decisions on the count table: move to the
    half / 1.5× child while the count is outside ``[2k/3, 4k/3]``, freeze
    once inside.  The band edges compare in f32, computed as the
    reference computes them for a static or a per-step ``k``
    (``compressors.accept_band``)."""
    lo, hi = accept_band(k)
    idx, done = 0, False
    for _ in range(refine_iters):
        est = np.float32(counts[idx])
        in_band = bool(lo <= est <= hi)
        if not (done or in_band):
            idx = 2 * idx + 1 if est < lo else 2 * idx + 2
        done = done or in_band
    return heap[idx]


def gaussian_t0(s, sq, d: int, k, two_sided: bool) -> np.float32:
    """The ppf start threshold ``|mean + (std + 1e-12)·ndtri(p)|``, f32,
    with the population std ``sqrt(max(sq/d - mean², 0))`` — the
    reference's ``ops.py:154-158`` in the same operation order (``p``
    from ``compressors.gaussian_ppf_p``: f32 for a per-step ``k``)."""
    s = torch.as_tensor(s, dtype=torch.float32).cpu()
    sq = torch.as_tensor(sq, dtype=torch.float32).cpu()
    mean = s / d
    var = torch.clamp(sq / d - mean * mean, min=0.0)
    std = torch.sqrt(var)
    p = gaussian_ppf_p(k, d, two_sided)
    q = torch.special.ndtri(torch.tensor(float(p), dtype=torch.float32))
    t0 = torch.abs(q * (std + 1e-12) + mean)
    return np.float32(max(float(t0), 0.0))


def _gaussian_threshold_fused(g, e, d: int, k, *, stats_block: int,
                              refine_iters: int, two_sided: bool,
                              moments=None, num_warps=None) -> np.float32:
    if moments is None:
        s, sq, _ = fused_moments(g, e, block=stats_block,
                                 num_warps=num_warps)
        passes.record("moments", 1)
    else:
        s, sq = moments
    t0 = gaussian_t0(s, sq, d, k, two_sided)
    heap, n_cnt = _tree_thresholds(t0, refine_iters)
    # the heap stays on the host: K2 sorts it there, with no sync
    counts = tree_count(g, e, torch.from_numpy(heap[:n_cnt]),
                        block=stats_block)
    passes.record("tree_count", 1)
    return _replay_refinement(heap, counts.cpu().numpy(), k, refine_iters)


def _hist_threshold_fused(g, e, d: int, k, *, stats_block: int,
                          hist=None) -> np.float32:
    # the histogram K1 returns already counts only the d real elements
    from repro_torch.kernels.histk.ops import threshold_from_histogram
    if hist is None:
        _, _, _, hist = fused_moments_hist(g, e, block=stats_block)
        passes.record("moments+hist", 1)
    return threshold_from_histogram(hist, k)


def _resolve(g, e, name, k, k_cap, block, stats_block, bcap,
             slack: Optional[float] = None,
             num_warps: Optional[int] = None):
    """Backend + geometry: explicit ``block``/``stats_block``/``bcap``
    (and ``num_warps``) win; with both blocks given the ladder is
    skipped (``source="explicit"``), else ``tuning.resolve_config`` —
    the table, the cache, a measurement on the card, the heuristic —
    fills the rest; the default staging width takes ``slack`` (``None``:
    the config's).  Returns ``(d, k_cap, block, stats_block, bcap,
    cfg)``, ``cfg.num_warps`` what K1 launches with."""
    if not supports_fused(name):
        raise ValueError(f"compressor {name!r} has no fused pipeline; "
                         f"supported: {FUSED_COMPRESSORS}")
    if g.dim() != 1:
        raise ValueError(f"g must be 1-D, got shape {tuple(g.shape)}")
    d = g.shape[0]
    if e is not None and e.shape != g.shape:
        raise ValueError(f"e shape {tuple(e.shape)} != g shape "
                         f"{tuple(g.shape)}")
    backend = tuning.resolve_backend(g)
    if block is None or stats_block is None:
        cfg = tuning.resolve_config(d, backend, g.dtype)
    else:
        cfg = tuning.KernelConfig(backend=backend, block=block,
                                  stats_block=stats_block,
                                  source="explicit")
    if num_warps is not None:
        cfg = dataclasses.replace(cfg, num_warps=num_warps)
    block = cfg.block if block is None else block
    stats_block = cfg.stats_block if stats_block is None else stats_block
    k_cap = gaussiank_cap(k, d) if k_cap is None else k_cap
    if bcap is None:
        bcap = fused_default_bcap(k_cap, d, block,
                                  cfg.bcap_slack if slack is None else slack)
    return d, k_cap, block, stats_block, bcap, cfg


def compress_at_threshold(g, e, thres, *, k_cap: int, block: int, bcap: int,
                          out: Optional[torch.Tensor] = None):
    """K3's one sweep at a given threshold: the staging rows, the
    residual and the ``(k_cap,)`` codec pair in one pass, as the
    reference's sequential lowering makes them (``ops.py:365``:
    ``compact+residual``).  ``(values, indices, new_e)``, ``values`` and
    ``new_e`` in the promoted dtype of ``g`` and ``e``.  ``out`` receives
    ``e'`` (may be ``e`` — in place)."""
    thres = float(np.float32(max(float(thres), 0.0)))
    *_, new_e, values, indices = compact_sweep(
        g, e, thres, block=block, bcap=bcap, k_cap=k_cap, out=out)
    passes.record("compact+residual", 1)
    return values, indices, new_e


def fused_pass_a(g: torch.Tensor, e: Optional[torch.Tensor], name: str):
    """Pass A of the fused pipeline on its own: ``(sum, sumsq, absmax,
    hist)`` of ``u = g + e`` (``hist`` is None except for ``histk``),
    at the stats block :func:`fused_compress_ef` takes for this ``d``
    on this device.  Hand the result back through its ``stats=`` and
    that call launches no K1: K1 runs once per leaf.  The statistics
    are on ``g``'s device (0-d tensors and an int64 ``(BINS,)``
    histogram)."""
    _, _, _, stats_block, _, cfg = _resolve(g, e, name, 1, None, None,
                                            None, None)
    if name == "histk":
        out = fused_moments_hist(g, e, block=stats_block)
        passes.record("moments+hist", 1)
        return out
    s, sq, mx = fused_moments(g, e, block=stats_block,
                              num_warps=cfg.num_warps)
    passes.record("moments", 1)
    return s, sq, mx, None


def fused_compress_ef(g: torch.Tensor, e: Optional[torch.Tensor], name: str,
                      k, *, k_cap: Optional[int] = None,
                      block: Optional[int] = None,
                      stats_block: Optional[int] = None,
                      refine_iters: int = 4, bcap: Optional[int] = None,
                      out: Optional[torch.Tensor] = None, stats=None,
                      num_warps: Optional[int] = None):
    """One EF compression step on ``u = g + e`` (``e=None``: ``u = g``).

    Returns ``(values, indices, new_e)``: a ``(k_cap,)`` codec pair
    (int32 indices) and the ``(d,)`` residual, ``values`` and ``new_e``
    in the promoted dtype of ``g`` and ``e`` (``g``'s without ``e``;
    the reference's ``result_type(g, e)``), with ``decode(values,
    indices, d) + new_e == g + e`` bit for bit (``u`` formed in f32 and
    rounded once to that dtype, as torch's ``g + e`` rounds it).  CUDA
    tensors run the Hopper kernels (``g`` f32 or bf16, ``e`` f32, bf16
    or None), CPU tensors their plain versions; the backend is the
    tensor's device.  ``out`` receives ``new_e`` — pass ``e`` to update the
    residual in place (the residual launch reads each element before it
    writes it), or ``g`` when ``e`` is None.

    ``stats`` takes :func:`fused_pass_a`'s tuple for the same operands
    (on the device or already on the host) and skips K1.  ``k`` is a
    static int or the allocator's per-step ``np.int32``, for which the
    threshold arithmetic is f32 as in the reference; ``k_cap`` sizes
    the pair either way.  The geometry not given comes from
    :func:`_resolve` (``tuning``'s ladder); ``num_warps`` overrides
    the Triton K1's (Gaussian-k; hist-k's K1 is a CUDA kernel with a grid
    of its own)."""
    d, k_cap, block, stats_block, bcap, cfg = _resolve(
        g, e, name, k, k_cap, block, stats_block, bcap, None, num_warps)
    if name == "histk":
        thres = _hist_threshold_fused(
            g, e, d, k, stats_block=stats_block,
            hist=None if stats is None else stats[3])
    else:
        thres = _gaussian_threshold_fused(
            g, e, d, k, stats_block=stats_block, refine_iters=refine_iters,
            two_sided=(name == "gaussiank2"),
            moments=None if stats is None else stats[:2],
            num_warps=cfg.num_warps)
    return compress_at_threshold(g, e, thres, k_cap=k_cap, block=block,
                                 bcap=bcap, out=out)


def unfused_compress_ef(g: torch.Tensor, e: Optional[torch.Tensor],
                        name: str, k, *, k_cap: Optional[int] = None,
                        block: Optional[int] = None,
                        stats_block: Optional[int] = None,
                        refine_iters: int = 4, bcap: Optional[int] = None):
    """The pre-fusion pipeline over the K4 kernels: the fused pipeline's
    baseline and bit-exactness oracle.

    Writes ``u = g + e`` in the promoted dtype of ``g`` and ``e`` (bf16
    rounds it, as the reference's ``g.astype(result_type) + e`` does),
    runs the unfused threshold (K4a moments and
    ``refine_iters`` sequential K4b counts, or the K4d histogram for
    ``histk``), K4c block compaction, then pays the dense ``decode`` and
    the ``u − decode`` subtract for the residual: ~8 leaf-sized passes
    where the fused pipeline makes 3-4.  Same block policy (and K4a/K4b
    at K1/K2's warps) as :func:`fused_compress_ef`; the staging width
    defaults to the unfused 4× slack (``gaussian_topk.ops.default_bcap``),
    so the comparison measures both pipelines as shipped.  Returns ``(values, indices,
    new_e)`` like :func:`fused_compress_ef`; the decode and ``u −
    decode`` run in ``u``'s dtype.  With f32 operands, or a bf16 ``g``
    and an f32 ``e``, ``u`` is the fused pipeline's f32 ``u`` and the two
    agree bitwise; with both bf16 the rounded ``u`` can select other
    elements."""
    # the K4 modules build on this package's kernels: imported at the call
    from repro_torch.kernels.gaussian_topk.ops import (
        gaussian_threshold_kernel, select_by_threshold)
    from repro_torch.kernels.histk.ops import histk_threshold
    d, k_cap, block, stats_block, bcap, cfg = _resolve(
        g, e, name, k, k_cap, block, stats_block, bcap, UNFUSED_BCAP_SLACK)
    u = g
    if e is not None:
        u = g.to(out_dtype(g, e)) + e
        passes.record("residual_add", 1)
    if name == "histk":
        thres = histk_threshold(u, k, block=stats_block)
        passes.record("hist", 1)
    else:
        thres = gaussian_threshold_kernel(
            u, k, block=stats_block, refine_iters=refine_iters,
            two_sided=(name == "gaussiank2"), num_warps=cfg.num_warps)
        passes.record("moments", 1)
        passes.record("count_gt", refine_iters)
    values, indices = select_by_threshold(u, thres, k_cap, block=block,
                                          bcap=bcap)
    passes.record("compact", 1)
    dec = codec.decode(values.to(u.dtype), indices, d)
    passes.record("dense_decode", 1)
    new_e = u - dec
    passes.record("residual_subtract", 1)
    return values, indices, new_e
