"""K4d — the 128-bin ``|x|`` magnitude histogram of hist-k, and the bin
arithmetic it shares with K1's histogram.

Replaces the TPU kernel ``repro/kernels/histk/hist.py:abs_histogram``
(``pallas_call`` at line 62) and ports ``BINS``, ``bin_lower_edge`` and
``_bin_of`` of that module and ``abs_histogram_ref`` of ``ref.py``.

Bins are quarter octaves: bin ``b`` holds ``|x|`` from ``edge[b] =
2^(b/4 − 16)`` (rounded to f32) up to the next edge; everything below
``2^-16`` (zero and subnormals included) lands in bin 0, everything at or
above ``edge[127]`` in bin 127.  The reference computes the bin as
``floor((log2(max(|x|, 2^-17)) + 16)·4)``; ``log2`` implementations
disagree in the last ulp, so elements within a few ulps of an edge can
land in the neighbouring bin depending on the library.  The port bins by
integer arithmetic instead: the biased exponent ``E`` of ``|x|`` and the
count ``q`` of the three f32 edge mantissas (of 2^(1/4), 2^(1/2),
2^(3/4)) at or below its mantissa give ``b = 4·(E − 111) + q``, clamped
to [0, 127] — the exact position of ``|x|`` among the f32 edges, the
same on the card and on the CPU.

The kernel is K1's Triton statistics kernel (``kernels/ef_fused/
fused_moments.py``) with ``HAS_E=False, WITH_MOMENTS=False,
WITH_HIST=True``: one read of ``x`` (4 bytes per element, 0.32 ms for the
268,435,456-element leaf at 3.35 TB/s) plus one 512-byte row of partial
counts per block.  The rows are summed in int64 — the reference sums
them in f32, which stops being exact above 2^24 counts in a bin.

Counts are of the ``d`` real elements: the padding zeros of the last
block are taken out of bin 0 here (the reference leaves them in and
subtracts them in ``threshold_from_histogram``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ef_fused.fused_moments import (BINS, _blocks,
                                                        _check, launch_stats)

_LO_EXP = -16
_SCALE = 4            # bins per octave
# f32 mantissa bits of 2^(1/4), 2^(1/2), 2^(3/4): the in-octave edges
EDGE_MANTISSAS = (0x1837F0, 0x3504F3, 0x5744FD)
_EXP_OFFSET = 127 + _LO_EXP      # biased exponent of edge[0] = 2^-16

# edge[b] = 2^(b/4 - 16) rounded to f32; bitwise the reference's table
EDGES = (2.0 ** (np.arange(BINS, dtype=np.float64) / _SCALE + _LO_EXP)
         ).astype(np.float32)


def bin_lower_edge(b) -> np.float32:
    """Magnitude lower edge of bin ``b`` (an int in [0, BINS)) as f32."""
    return EDGES[int(b)]


def bin_of(x: torch.Tensor) -> torch.Tensor:
    """int32 bin of ``|x|`` for f32 ``x``: exponent and mantissa bits
    against the f32 edges, clamped to [0, BINS − 1]."""
    bits = x.to(torch.float32).abs().view(torch.int32)
    man = bits & 0x7FFFFF
    q = sum((man >= m).to(torch.int32) for m in EDGE_MANTISSAS)
    b = (bits >> 23) * _SCALE - _SCALE * _EXP_OFFSET + q
    return b.clamp_(0, BINS - 1)


def abs_histogram_plain(x: torch.Tensor, *, block: int) -> torch.Tensor:
    """Plain PyTorch version of K4d: the bins of the zero-padded
    ``(nblocks, block)`` view counted in int64, padding taken out of
    bin 0.  Returns ``(BINS,)`` int64."""
    xb = _blocks(x.to(torch.float32), block)
    h = torch.bincount(bin_of(xb).reshape(-1), minlength=BINS)
    h[0] -= xb.numel() - x.shape[0]
    return h


def abs_histogram(x: torch.Tensor, *, block: int = 2048) -> torch.Tensor:
    """``(BINS,)`` int64 histogram of ``|x|`` over the ``d`` elements of
    flat ``x``, blocked by ``block``.  CUDA tensors launch the Triton
    kernel (f32 only, ``block`` a power of two); CPU tensors take the
    plain version."""
    _check(x, None)
    if x.device.type != "cuda":
        return abs_histogram_plain(x, block=block)
    _, h = launch_stats("abs_histogram", x, None, block=block,
                        moments=False, hist=True)
    abs_histogram.launches += 1
    return h


abs_histogram.launches = 0
