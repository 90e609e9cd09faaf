"""Momentum correction (Lin et al. 2018, DGC §3.1; port of
``repro/train/momentum_correction.py``) — the fix the paper (§4.4) names
for the residual staleness of TopK/GaussianK-SGD.

Momentum moves before the compression, per worker:

    v_t = mu * v_{t-1} + g_t        (local momentum)
    u_t = u_{t-1} + v_t             (local accumulation)
    send Comp_k(u_t); the selected coordinates are zeroed in v and u.

The server then applies plain SGD to the aggregated sparse tensor.
:func:`mc_compress_leaf` is the single-vector formulation; the train
step runs the row-wise one in ``dist/aggregate.bucket_compress``
(``momentum > 0``, the velocities in ``resid2``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import tree
from repro_torch.core import codec
from repro_torch.core.compressors import CompressorSpec


def mc_compress_leaf(g_flat: torch.Tensor, v_flat: torch.Tensor,
                     u_flat: torch.Tensor, spec: CompressorSpec, k: int,
                     momentum: float, key
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """One leaf of momentum-corrected compression (flat vectors).
    Returns ``(values, indices, new_v, new_u)``."""
    d = g_flat.shape[0]
    v = momentum * v_flat + g_flat
    u = u_flat + v
    vals, idx = spec.select(u, k, key)
    keep = codec.keep_mask(idx, d, vals.dtype)
    return vals, idx, (v * keep).to(v_flat.dtype), \
        (u * keep).to(u_flat.dtype)


def init_mc_state(params, model_size: int, dtype=torch.float32):
    """``(v, u)`` zero states, flat-padded like the error-feedback
    residuals, on each leaf's device."""
    def z(p):
        d_pad = -(-p.numel() // model_size) * model_size
        return torch.zeros((d_pad,), dtype=dtype, device=p.device)
    return tree.tree_map(z, params), tree.tree_map(z, params)
