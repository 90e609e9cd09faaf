"""``(mean, std, absmax)`` of a flat vector through the K4a moments
kernel (port of ``repro/kernels/moments/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.moments.moments import moments


def mean_std_absmax(u: torch.Tensor, *, block: int = 2048):
    """``(mean, std, absmax)`` of flat ``u`` as 0-d f32 tensors, with the
    population std ``sqrt(max(sq/d − mean², 0))``; the zero padding of
    the last block contributes nothing."""
    d = u.shape[0]
    s, sq, mx = moments(u, block=block)
    mean = s / d
    var = torch.clamp(sq / d - mean * mean, min=0.0)
    return mean, torch.sqrt(var), mx
