"""Train state (port of ``repro/train/state.py``, lines 54-127): params,
optimizer state, step counter and the per-worker error-feedback
residual stored as ONE flat bucket of shape ``(workers, model_size *
d_row_total)`` (``dist/layout.py``).  A plain dict of tensors."""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch import tree
from repro_torch.core.compression import CompressionConfig, as_config
from repro_torch.dist.layout import BucketLayout, init_flat_residual
from repro_torch.optim import Optimizer
from repro_torch.slices import not_ported


def init_train_state(params, optimizer: Optimizer, *, workers: int,
                     model_size: int,
                     compression: Optional[CompressionConfig] = None,
                     layout: Optional[BucketLayout] = None
                     ) -> Dict[str, Any]:
    """``{"params", "opt", "step"[, "resid"]}``.  A sparse compressor
    with ``layout`` allocates the zero flat residual ``resid`` on the
    params' device; Dense-SGD allocates none."""
    compression = as_config(compression)
    if workers != 1:
        raise not_ported(f"{workers} data-parallel workers", "world")
    state: Dict[str, Any] = {"params": params,
                             "opt": optimizer.init(params), "step": 0}
    if not compression.dense:
        compression.require_slice1()
        if layout is None:
            raise not_ported("the per-leaf residual tree", "perleaf")
        if layout.model_size != model_size:
            raise ValueError(
                f"layout was built for model_size={layout.model_size}, "
                f"init_train_state got {model_size}")
        leaves = tree.leaves(params)
        if len(layout.segments) != len(leaves):
            raise ValueError(
                f"layout has {len(layout.segments)} segments for a "
                f"{len(leaves)}-leaf param tree; rebuild it from these "
                "params")
        state["resid"] = init_flat_residual(layout,
                                            device=leaves[0].device)[None]
    return state
