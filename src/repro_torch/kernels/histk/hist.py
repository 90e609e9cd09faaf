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

The kernel is CUDA C++, ``repro_torch/csrc/abs_histogram.cu`` (its
header has the design in full; K1 with its histogram is the same
template with ``e`` and the moments switched on).  Bound: bytes, one
read of ``x`` (4 bytes per element in f32, 2 in bf16: 0.321 and 0.160
ms for the 268,435,456-element leaf at 3.35 TB/s).  The first port of K4d was
K1's Triton statistics kernel with the histogram switched on: one ``tl.histogram`` into a 512-byte int32 row
per block, the rows summed by torch.  It ran at 0.886 ms, 36% of the
bound (NVIDIA H100 80GB HBM3, 700 W; ``chip_smoke.py``): the per-element
votes and the 33-67 MB of rows, not the read of ``x``, set its time.
The CUDA kernel walks ``x`` with a persistent grid of float4 loads,
counts into per-lane uint32 sub-histograms in shared memory (no address
or bank conflict however crowded the bins) and adds each CTA's 128 sums
into the int64 output with integer ``atomicAdd``: no per-block rows, no
fold launch.  It runs at 0.380 ms beside the 0.321 ms bound (same card,
``chip_smoke.py``; the Triton design 0.879 ms in the same run).  The
reference sums f32 rows, which stops being exact above 2^24 counts in a
bin; the port counts in integers.

Counts are of the ``d`` real elements.  The kernel's geometry does not
depend on ``block``: integer counts are the same in any order, so the
kernel equals :func:`abs_histogram_plain` at every ``block``.  The plain
version keeps the reference's blocking and takes the padding zeros of
the last block out of bin 0 (the reference leaves them in and subtracts
them in ``threshold_from_histogram``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.ef_fused.fused_moments import (BINS, _blocks,
                                                        _check,
                                                        check_cuda_dtypes,
                                                        dtype_code)

SOURCE = "abs_histogram.cu"

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
    flat ``x``.  CUDA tensors launch the CUDA kernel (``x`` f32 or bf16,
    binned by its exact f32 value; its geometry does not depend on
    ``block``); CPU tensors take the plain version, blocked by
    ``block``."""
    _check(x, None)
    if x.device.type != "cuda":
        return abs_histogram_plain(x, block=block)
    check_cuda_dtypes("abs_histogram", x)
    h = torch.zeros(BINS, dtype=torch.int64, device=x.device)
    lib = cuda_build.load(SOURCE)
    with torch.cuda.device(x.device):
        rc = lib.abs_histogram(
            x.data_ptr(), dtype_code(x), x.shape[0], h.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(rc, "abs_histogram")
    abs_histogram.launches += 1
    return h


abs_histogram.launches = 0
