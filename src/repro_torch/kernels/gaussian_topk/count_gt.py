"""K4b — the number of elements with ``|x| > t``: one count of Algorithm
1's refinement loop (lines 6-7), which the unfused pipeline runs once
per refinement step.

Replaces the TPU kernel ``repro/kernels/gaussian_topk/count_gt.py:
count_gt`` (``pallas_call`` at line 34) and ports ``ref.py:
count_gt_ref``.

The kernel is K2's CUDA count kernel (``csrc/tree_count.cu``, wrapped
in ``kernels/ef_fused/tree_count.py``) with no ``e`` and one
threshold.  Bound: bytes, one read of ``x`` (4 bytes per element in
f32, 2 in bf16: 0.32 and 0.16 ms for the 268,435,456-element leaf at
3.35 TB/s).  Each CTA adds its count into the output with one integer
atomic, exact in any order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ef_fused.fused_moments import _blocks, _check
from repro_torch.kernels.ef_fused.tree_count import launch_counts

__all__ = ["count_gt", "count_gt_plain"]


def count_gt_plain(x: torch.Tensor, thres: float, *, block: int
                   ) -> torch.Tensor:
    """Plain PyTorch version of K4b: per-block counts of the zero-padded
    ``(nblocks, block)`` view, summed.  Returns a 0-d int32 tensor."""
    a = _blocks(x.to(torch.float32), block).abs()
    t = torch.tensor(thres, dtype=torch.float32, device=a.device)
    return (a > t).sum(dim=1).sum().to(torch.int32)


def count_gt(x: torch.Tensor, thres: float, *, block: int = 2048
             ) -> torch.Tensor:
    """``#{i : |x_i| > thres}`` of flat ``x`` as a 0-d int32 tensor on
    ``x``'s device (``thres`` an f32 host scalar).  CUDA tensors launch
    the CUDA kernel (``block`` does not reach it); CPU tensors take the
    plain version."""
    _check(x, None)
    if x.device.type != "cuda":
        return count_gt_plain(x, thres, block=block)
    counts = launch_counts("count_gt", x, None,
                           np.array([thres], dtype=np.float32))
    count_gt.launches += 1
    return counts[0]


count_gt.launches = 0
