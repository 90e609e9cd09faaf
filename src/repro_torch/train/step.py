"""Train-step factory (port of ``repro/train/step.py``, lines 124-287):
the model loss, the compressed gradient aggregation (paper Eq. 2) and
the optimizer in one step, on one card.

  grads by autograd -> aggregate_bucketed (or the dense mean) ->
  optimizer.update

There is no ``shard_map``: this slice runs one worker (``mesh = (1,
1)``).  The residual bucket and the params are updated in place.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.core.compression import CompressionConfig, as_config
from repro_torch.dist import aggregate
from repro_torch.models import loss_fn
from repro_torch.optim import Optimizer
from repro_torch.slices import not_ported


def mesh_sizes(mesh) -> tuple:
    """``(data world, model size)`` of a mesh given as dims (``(D, M)`` or
    ``(P, D, M)``); this slice takes ``(1, 1)`` only."""
    dims = tuple(int(x) for x in mesh)
    if len(dims) not in (2, 3) or any(x != 1 for x in dims):
        raise not_ported(f"mesh {'x'.join(map(str, dims))}", "mesh")
    return 1, 1


def make_train_step(cfg, mesh, optimizer: Optimizer, lr_fn: Callable, *,
                    compression: Optional[CompressionConfig] = None,
                    layout=None, probe: Optional[Callable] = None):
    """Returns ``step_fn(state, batch) -> (state, metrics)``.

    ``compression`` names the compressor (``"none"`` = Dense-SGD),
    ratio and backend; ``layout`` (built from the same params and
    config) routes the aggregation through the flat bucket.  ``probe``
    is handed to :func:`~repro_torch.dist.aggregate.aggregate_bucketed`."""
    compression = as_config(compression)
    world, msize = mesh_sizes(mesh)
    dense = compression.dense
    if not dense:
        compression.require_slice1()
        if layout is None:
            raise not_ported("the per-leaf aggregation", "perleaf")
        if layout.model_size != msize:
            raise ValueError(f"layout model_size={layout.model_size} != "
                             f"mesh model axis {msize}")
        if layout.spec_name != compression.spec.name:
            raise ValueError(f"layout compressor {layout.spec_name!r} != "
                             f"{compression.spec.name!r}")
        if abs(layout.ratio - float(compression.ratio)) > 1e-12:
            raise ValueError(
                f"layout ratio {layout.ratio} != {compression.ratio}")
    def step_fn(state, batch):
        params = state["params"]
        leaves, td = tree.flatten(params)
        ps = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            l, metrics = loss_fn(tree.unflatten(td, ps), cfg, batch)
            grads = torch.autograd.grad(l, ps, allow_unused=True)
        # a leaf the loss does not reach (norm2 of a parallel block) has
        # a zero gradient, as under jax.grad
        grads = tree.unflatten(td, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(ps, grads)])
        metrics = {k: v.detach() for k, v in metrics.items()}
        if dense:
            agg = aggregate.aggregate_dense(grads, world)
            agg_metrics = {}
        else:
            res = aggregate.aggregate_bucketed(
                grads, state["resid"][0], layout, compression, world=world,
                probe=probe)
            agg, agg_metrics = res.agg, res.metrics
        del grads
        lr = lr_fn(state["step"])
        optimizer.update(params, state["opt"], agg, lr)
        state["step"] += 1
        metrics["lr"] = lr
        metrics.update(agg_metrics)
        return state, metrics

    return step_fn
