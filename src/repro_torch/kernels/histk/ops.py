"""Hist-k: histogram-threshold top-k selection, two passes over ``u`` (one
histogram, one compaction) and no refinement loop (port of
``repro/kernels/histk/ops.py``).

The threshold is read off the histogram on the host: one device-to-host
copy of 128 counts per call.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.compressors import gaussiank_cap
from repro_torch.kernels.gaussian_topk.ops import select_by_threshold
from repro_torch.kernels.histk.hist import abs_histogram, bin_lower_edge


def threshold_from_histogram(h: torch.Tensor, k, pad: int = 0
                             ) -> np.float32:
    """Lower edge (f32) of the highest bin whose count from the top
    reaches ``k``; bin 0's edge when none does.  ``h`` holds integer
    ``(BINS,)`` counts; ``pad`` padding zeros counted in bin 0 are taken
    out first.  Counting in int64 keeps every bin exact, where the
    reference's f32 counts stop being exact above 2^24."""
    counts = h.detach().to(device="cpu", dtype=torch.int64).numpy().copy()
    counts[0] -= pad
    from_top = np.cumsum(counts[::-1])[::-1]
    reach = np.flatnonzero(from_top >= k)
    return bin_lower_edge(reach[-1] if reach.size else 0)


def histk_threshold(u: torch.Tensor, k, *, block: int = 2048
                    ) -> np.float32:
    """Threshold selecting ~k elements of flat ``u`` via one histogram
    pass (K4d)."""
    return threshold_from_histogram(abs_histogram(u, block=block), k)


def histk_cap(k: int, d: int) -> int:
    # one 2^(1/4) bin of slack above k (~19%) + rounding
    return gaussiank_cap(k, d)


def histk_select_kernel(u: torch.Tensor, k: int, *, block: int = 2048):
    """The whole hist-k compressor: histogram threshold (K4d) + block
    compaction (K4c) into the ``(histk_cap(k, d),)`` codec pair."""
    thres = histk_threshold(u, k, block=block)
    return select_by_threshold(u, thres, histk_cap(k, u.shape[0]),
                               block=block)
