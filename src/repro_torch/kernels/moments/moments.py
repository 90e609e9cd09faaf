"""K4a — single-pass moments ``(sum, sumsq, absmax)`` of a materialised
vector: the statistics pass of the unfused Gaussian-k pipeline.

Replaces the TPU kernel ``repro/kernels/moments/moments.py:moments``
(``pallas_call`` at line 48) and ports ``ref.py:moments_ref``.

The kernel is K1's Triton statistics kernel (``kernels/ef_fused/
fused_moments.py``) with ``HAS_E=False``: the same per-block reduction
that K1 applies to ``g + e`` in registers, applied to a ``u`` that was
written to memory first.  So at the same block size the unfused
pipeline's ``(s, sq)`` are bitwise the fused pipeline's, and so is the
threshold built from them, when both launch with the same ``num_warps``
(the unfused pipeline passes the config's).  Bound: bytes, one read of
``x`` (4 bytes per element in f32, 2 in bf16: 0.32 and 0.16 ms for the
268,435,456-element leaf at 3.35 TB/s) plus a 12-byte partial row per
block, folded by torch in a fixed order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ef_fused.fused_moments import (_check, launch_stats,
                                                        moments_plain)

__all__ = ["moments", "moments_plain"]


def moments(x: torch.Tensor, *, block: int = 2048, num_warps=None):
    """``(sum, sumsq, absmax)`` of flat ``x`` as 0-d f32 tensors on
    ``x``'s device.  CUDA tensors launch the Triton kernel (f32 or bf16,
    ``block`` a power of two, ``num_warps`` as K1's: the in-block sum
    order follows it, so K1's bits need K1's warps); CPU tensors take
    the plain version."""
    _check(x, None)
    if x.device.type != "cuda":
        return moments_plain(x, block)
    stats = launch_stats("moments", x, None, block=block,
                         num_warps=num_warps)
    moments.launches += 1
    return stats


moments.launches = 0
