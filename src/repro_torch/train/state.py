"""Train state (port of ``repro/train/state.py``, lines 54-127): params,
optimizer state, step counter, the per-worker error-feedback
residuals, and under adaptive density the controller state ``adaptk``
(numpy arrays on the host, where the allocation runs).  A plain dict.

The residuals are stored as ONE flat bucket per worker of shape
``(workers, model_size * d_row_total)`` with a ``layout``
(``dist/layout.py``; the bucketed pipeline and the chunked schedule,
whose chunks are windows of it, so the state does not depend on the
chunk count), or as the per-leaf tree of ``(workers, d_pad)`` leaves
without one (the per-leaf loop, ``dist/aggregate.init_residuals``).

``workers`` is the number of data-parallel workers whose residuals this
state holds: all W of the mesh when they run in this process
(``LocalWire``), 1 per process under ``ProcessGroupWire``.  The workers
of one process share ONE copy of the params and the optimizer state:
the reference replicates them, and every worker computes the identical
update.  ``model_size`` is the mesh's model axis M: the buckets hold M
rows of ``d_row_total`` each.  A tensor-parallel rank holds one of them
(``rows=1``: ``(workers, d_row_total)`` buckets, or the per-leaf loop's
``(workers, d_row)`` leaves) and its own shards of the params and the
optimizer state (``dist/tensor_parallel.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import tree
from repro_torch.core import adaptk
from repro_torch.core.compression import CompressionConfig, as_config
from repro_torch.dist.aggregate import init_residuals
from repro_torch.dist.layout import BucketLayout, init_flat_residual
from repro_torch.optim import Optimizer


def init_train_state(params, optimizer: Optimizer, *, workers: int,
                     model_size: int,
                     compression: Optional[CompressionConfig] = None,
                     with_residual: bool = True,
                     resid_dtype: torch.dtype = torch.float32,
                     layout: Optional[BucketLayout] = None,
                     rows: Optional[int] = None,
                     whole=None) -> Dict[str, Any]:
    """``{"params", "opt", "step"[, "resid"[, "resid2"]][, "adaptk"]}``.
    A sparse compressor allocates the zero residuals ``resid`` of
    ``resid_dtype`` on the params' device (flat buckets with ``layout``,
    the per-leaf tree without), and ``resid2`` too for the two-level
    strategies (``hierarchical``, ``hier_gtopk``) and for momentum
    correction (the DGC velocities); Dense-SGD allocates none.  A
    ``density_policy`` adds the zero controller state ``adaptk``
    (``signal``, ``count``, and ``gnorm``/``gnorm0`` under a global-k
    policy).  ``with_residual=False`` allocates none of these three, as
    the reference's does (``repro/train/state.py:54-127``: a state for
    lowering only).  The bucketed step packs the gradients in the
    residual's dtype (``resid.dtype``): a bf16 residual compresses bf16
    buckets, whose wire values and ``e'`` are bf16.  ``rows=1`` allocates
    one row of the buckets (with a layout) or of each leaf (without one,
    sized from ``whole``, the whole params' shapes): a tensor-parallel
    rank's."""
    compression = as_config(compression)
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    if model_size < 1:
        raise ValueError(f"model_size must be >= 1, got {model_size}")
    state: Dict[str, Any] = {"params": params,
                             "opt": optimizer.init(params), "step": 0}
    if with_residual and not compression.dense:
        leaves = tree.leaves(params)
        if layout is None:
            if (rows is None) != (whole is None):
                raise ValueError("the per-leaf residual rows (rows=) are "
                                 "sized from the whole params (whole=)")

            def zeros():
                if rows is None:
                    return init_residuals(params, model_size, resid_dtype,
                                          workers=workers)
                return init_residuals(whole, model_size, resid_dtype,
                                      workers=workers, rows=rows,
                                      device=leaves[0].device)
        else:
            if layout.model_size != model_size:
                raise ValueError(
                    f"layout was built for model_size={layout.model_size}, "
                    f"init_train_state got {model_size}")
            if len(layout.segments) != len(leaves):
                raise ValueError(
                    f"layout has {len(layout.segments)} segments for a "
                    f"{len(leaves)}-leaf param tree; rebuild it from these "
                    "params")

            def zeros():
                return init_flat_residual(layout, resid_dtype,
                                          workers=workers,
                                          device=leaves[0].device,
                                          rows=rows)
        state["resid"] = zeros()
        if (compression.strategy in ("hierarchical", "hier_gtopk")
                or compression.momentum_correction > 0):
            state["resid2"] = zeros()
        policy = compression.density_policy
        if policy is not None:
            state["adaptk"] = adaptk.init_controller_state(
                len(leaves), global_k=policy.global_policy != "none")
    return state
