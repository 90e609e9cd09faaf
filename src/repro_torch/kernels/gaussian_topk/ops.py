"""The unfused Gaussian-k selection pipeline built from the K4 kernels
(port of ``repro/kernels/gaussian_topk/ops.py``): paper Algorithm 1 as
the paper wrote it.

  1. K4a ``moments``            — ``(s, sq)`` → Gaussian ppf threshold
  2. K4b ``count_gt`` ×4        — the sequential refinement loop
  3. K4c ``threshold_compact``  — per-block staging rows
  4. ``assemble_staging``       — the rows into the ``(k_cap,)`` codec

The threshold glue runs in f32 on the host on the moments and counts,
with the same operations as the fused pipeline's ``gaussian_t0`` and
tree replay, so both pipelines reach the same threshold bit for bit.
Each count is one device-to-host copy: five host syncs per call.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compressors import gaussiank_cap
from repro_torch.kernels.ef_fused.compact_residual import assemble_staging
from repro_torch.kernels.ef_fused.ops import (UNFUSED_BCAP_SLACK,
                                              fused_default_bcap, gaussian_t0)
from repro_torch.kernels.gaussian_topk.count_gt import count_gt
from repro_torch.kernels.gaussian_topk.threshold_compact import \
    threshold_compact
from repro_torch.kernels.moments.moments import moments

__all__ = ["assemble_staging", "default_bcap", "gaussian_threshold_kernel",
           "select_by_threshold", "gaussiank_select_kernel"]


def default_bcap(k_cap: int, d: int, block: int) -> int:
    """Per-block staging width of the unfused compaction: 4× the expected
    per-block selection, at least 64, at most ``block``, a multiple of
    8."""
    return fused_default_bcap(k_cap, d, block, UNFUSED_BCAP_SLACK)


def gaussian_threshold_kernel(u: torch.Tensor, k, *, block: int = 2048,
                              refine_iters: int = 4,
                              two_sided: bool = False,
                              num_warps=None) -> np.float32:
    """Algorithm 1 lines 2-13 on flat ``u``: the ppf start threshold from
    K4a's moments, then ``refine_iters`` K4b counts — every one is made,
    also after the threshold froze inside the band ``[2k/3, 4k/3]``, as
    the reference's ``fori_loop`` makes them.  Halve below the band,
    ×1.5 above it, in f32.  ``num_warps`` reaches K4a (K4b's CUDA
    kernel takes no launch width)."""
    d = u.shape[0]
    s, sq, _ = moments(u, block=block, num_warps=num_warps)
    thres = gaussian_t0(s, sq, d, k, two_sided)
    lo, hi = np.float32(2.0 * k / 3.0), np.float32(4.0 * k / 3.0)
    half, three_halves = np.float32(0.5), np.float32(1.5)
    done = False
    for _ in range(refine_iters):
        est = np.float32(int(count_gt(u, float(thres), block=block)))
        in_band = bool(lo <= est <= hi)
        if not (done or in_band):
            thres = half * thres if est < lo else three_halves * thres
        done = done or in_band
    return np.float32(thres)


def select_by_threshold(u: torch.Tensor, thres, k_cap: int, *,
                        block: int = 2048, bcap=None):
    """Compact ``|u| > max(thres, 0)`` into the ``(k_cap,)`` codec pair
    through K4c and the staging assembly; the values in ``u``'s dtype
    (f32 or bf16)."""
    d = u.shape[0]
    if bcap is None:
        bcap = default_bcap(k_cap, d, block)
    thres = float(np.float32(max(float(thres), 0.0)))
    vals, offs, cnts = threshold_compact(u, thres, block=block, bcap=bcap)
    return assemble_staging(vals, offs, cnts, k_cap, block=block,
                            out_dtype=u.dtype)


def gaussiank_select_kernel(u: torch.Tensor, k: int, *, block: int = 2048,
                            refine_iters: int = 4, two_sided: bool = False):
    """The whole kernel-backed Gaussian-k compressor (drop-in for
    ``core.compressors.gaussiank_select``)."""
    thres = gaussian_threshold_kernel(u, k, block=block,
                                      refine_iters=refine_iters,
                                      two_sided=two_sided)
    return select_by_threshold(u, thres, gaussiank_cap(k, u.shape[0]),
                               block=block)
