"""Train-step factory (port of ``repro/train/step.py``, lines 124-287):
the model loss, the compressed gradient aggregation (paper Eq. 2) and
the optimizer in one step, for the W data-parallel workers of a mesh.

  per local worker: its rows of the global batch -> grads by autograd
      -> pack + compress against its residual (under adaptive density:
      pass A of every worker, one allocation, then the compressions)
  the wire over the data axes (the bucket in chunks, the per-leaf loop,
      or the dense mean)
  optimizer.update, once: the workers of one process share the params

With a layout the bucket is cut into ``compression.chunks`` leaf-aligned
chunk groups (``layout.build_chunk_plan``; one group is the bucketed
pipeline, more the chunked schedule), and the backward releases each
group's gradients as one unit once the last of them exists (the
counterpart of the reference's custom-vjp seam): a gradient hook on
each param (``Tensor.register_hook``) collects its gradient, and the
hook that completes a group packs and compresses that chunk at once,
while the backward goes on; the last local worker's release of a chunk
runs that chunk's wire (on ``ProcessGroupWire`` its gathers are issued
asynchronously and waited for at the end).  The hooks sit on the
params themselves: the engine runs a param's gradient node as soon as
its gradient is complete (hooks on aliases of the params would wait for
the rest of the backward, since the engine runs the ready node created
last first).  A group with a param the loss does not reach is released
after the backward, that param's gradient zeros.  ``layout=None`` runs
the per-leaf loop (``aggregate_compressed``).

There is no ``shard_map``: the wire (``dist/wire.py``) runs either all W
workers in this process (``LocalWire``, the default) or this process's
one worker over ``torch.distributed`` (``ProcessGroupWire``).  Worker
``w`` (its joint rank over the data axes, row-major) takes rows ``[w·B/W,
(w+1)·B/W)`` of the global batch, as ``batch_specs`` shards the leading
dim over the joint data axes, whatever the model axis.  The residual
buckets and the params are updated in place.

The model axis ``M`` changes the numerics of the compression only, as
in the reference: every bucket is ``(M, d_row_total)`` rows, each
selecting its own ``ceil(k / M)``.  Under ``LocalWire`` (and a
``ProcessGroupWire`` of ``M = 1``) each worker holds all M rows and the
whole model.  Under a tensor-parallel ``ProcessGroupWire``
(``wire.tensor_parallel``, a launch of ``D·M`` processes) this process
is model rank ``r`` of its worker: ``state["params"]`` and the optimizer
state hold its shards (``dist/tensor_parallel.TensorParallel``), the
forward and backward are ``model.loss_fn``'s on them (``axis=``), the
gradient shards are relaid into row ``r`` (``tensor_parallel.ModelRow``),
row ``r`` is compressed against the residual row ``(1, d_row_total)``
and sent over the data group of the processes that share ``r``, and the
mean row is relaid back into the shards; the per-leaf loop does the
same a leaf at a time, over the whole params' per-leaf geometry
(``(workers, d_row)`` residual leaves).

The key-sampled compressors draw from the reference's keys: step ``t``
of worker ``w`` uses ``fold_in(fold_in(PRNGKey(seed), t), w)``, derived
on the host (``repro_torch.prng``).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch import prng, tree
from repro_torch.core.compression import CompressionConfig, as_config
from repro_torch.dist import aggregate
from repro_torch.dist.layout import build_chunk_plan, build_layout
from repro_torch.dist.wire import LocalWire
from repro_torch.launch.mesh import (data_world_size, model_axis_size,
                                     parse_mesh)
from repro_torch.models import loss_fn as model_loss_fn
from repro_torch.optim import Optimizer


def step_keys(seed: int, step: int, ranks) -> list:
    """The key-sampled compressors' keys of ``step`` for the workers of
    joint ranks ``ranks``: ``fold_in(fold_in(PRNGKey(seed), step),
    rank)``, as the reference's train step keys its workers."""
    key = prng.fold_in(prng.PRNGKey(seed), step)
    return [prng.fold_in(key, rank) for rank in ranks]


def make_train_step(cfg, mesh, optimizer: Optimizer, lr_fn: Callable, *,
                    compression: Optional[CompressionConfig] = None,
                    layout=None, probe: Optional[Callable] = None,
                    wire=None, seed: int = 0,
                    loss_fn: Optional[Callable] = None,
                    tensor_parallel=None, remat: bool = True):
    """Returns ``step_fn(state, batch) -> (state, metrics)``.

    ``mesh`` is a Mesh, ``"DxM"``/``"PxDxM"`` or a tuple of sizes;
    ``wire`` (default: a ``LocalWire`` over it) decides which of its
    workers this process runs, and ``state`` holds their residuals
    (``init_train_state(workers=wire.local_workers)``; on a
    tensor-parallel wire this rank's shards and residual row,
    ``rows=1``).  ``batch`` is the GLOBAL batch.  ``compression`` names
    the compressor (``"none"`` = Dense-SGD), ratio, strategy, wire dtype,
    backend and chunk count;
    ``layout`` (built from the same params and config) routes the
    aggregation through the flat bucket, ``None`` through the per-leaf
    loop.  ``probe`` is handed to the aggregation (``dist/aggregate.py``);
    with a layout it is also called as ``probe(rank, backward=True)``
    before a worker's backward, ``probe(rank, release=c)`` when chunk
    ``c``'s hook fires (before it compresses) and ``probe(rank,
    backward=False)`` after the backward.  ``seed``
    roots the key-sampled compressors' keys.  ``loss_fn(params, batch)
    -> (loss, metrics)`` replaces the model's loss (``cfg`` is then not
    read).  On a tensor-parallel wire ``tensor_parallel`` is the rank's
    ``dist/tensor_parallel.TensorParallel`` (built with its params, once).
    ``remat`` (the reference's default) rematerialises each layer-pattern
    period of the model's loss in the backward (``models.loss_fn``): the
    same gradients, bit for bit, in less memory.  Loss metrics are the
    mean over the workers."""
    compression = as_config(compression)
    mesh = parse_mesh(mesh)
    wire = LocalWire(mesh) if wire is None else wire
    if wire.mesh != mesh:
        raise ValueError(f"wire was built for {wire.mesh}, not {mesh}")
    world = data_world_size(mesh)
    msize = model_axis_size(mesh)
    dense = compression.dense
    loss = loss_fn or (lambda p, b: model_loss_fn(p, cfg, b,
                                                  remat=remat))
    rows = None
    if getattr(wire, "tensor_parallel", False):
        if tensor_parallel is None or loss_fn is not None:
            raise ValueError("a tensor-parallel step needs tensor_parallel="
                             " and runs the model's loss; loss_fn= is not "
                             "taken")
        axis = tensor_parallel.axis
        loss = lambda p, b: model_loss_fn(p, cfg, b, axis,  # noqa: E731
                                          remat=remat)
        if layout is not None:
            rows = tensor_parallel.rows(layout)
        elif not dense:
            # the per-leaf loop over the whole params' geometry
            leaf_layout = build_layout(tensor_parallel.whole, msize,
                                       compression)
            rows = tensor_parallel.rows(leaf_layout)
    if not dense and layout is not None:
        if layout.model_size != msize:
            raise ValueError(f"layout model_size={layout.model_size} != "
                             f"mesh model axis {msize}")
        if layout.spec_name != compression.spec.name:
            raise ValueError(f"layout compressor {layout.spec_name!r} != "
                             f"{compression.spec.name!r}")
        if abs(layout.ratio - float(compression.ratio)) > 1e-12:
            raise ValueError(
                f"layout ratio {layout.ratio} != {compression.ratio}")
        if layout.adaptive != compression.adaptive:
            raise ValueError("layout density mode does not match "
                             "density_policy; rebuild the layout")
    if compression.chunks > 1 and (dense or layout is None):
        raise ValueError(
            "chunks > 1 needs the bucketed sparse pipeline: pass "
            "layout= (the chunked schedule re-dispatches the flat "
            "wire block; the per-leaf and Dense-SGD paths have no "
            "bucket to chunk)")
    plan = (build_chunk_plan(layout, compression.chunks)
            if layout is not None and not dense else None)
    density_policy = compression.density_policy
    note = probe if probe is not None else (lambda *a, **k: None)

    def step_fn(state, batch):
        if (density_policy is not None and density_policy.ema > 0.0
                and "adaptk" not in state):
            raise ValueError(
                "density_policy.ema > 0 needs the controller state; "
                "allocate it via init_train_state(..., "
                "density_policy=...) — without it the EMA would be "
                "silently disabled")
        params = state["params"]
        leaves, td = tree.flatten(params)
        B = int(next(iter(batch.values())).shape[0])
        if B % world:
            raise ValueError(f"global batch {B} does not split over "
                             f"{world} workers")
        per = B // world
        worker_metrics = []

        def local_batch(w):
            rank = wire.ranks[w]
            return {k: v[rank * per:(rank + 1) * per]
                    for k, v in batch.items()}

        def zeros_for_none(ps, grads):
            # a leaf the loss does not reach (norm2 of a parallel block)
            # has a zero gradient, as under jax.grad
            return [torch.zeros_like(p) if g is None else g
                    for p, g in zip(ps, grads)]

        def grads_of(w):
            ps = [p.detach().requires_grad_(True) for p in leaves]
            with torch.enable_grad():
                l, metrics = loss(tree.unflatten(td, ps), local_batch(w))
                grads = torch.autograd.grad(l, ps, allow_unused=True)
            worker_metrics.append({k: v.detach() for k, v in metrics.items()})
            return tree.unflatten(td, zeros_for_none(ps, grads))

        def backward_releasing(run, w):
            """Worker ``w``'s backward, each chunk group released to
            ``run`` as soon as its gradients exist."""
            rank = wire.ranks[w]
            ps = [p.detach().requires_grad_(True) for p in leaves]
            got = [None] * len(ps)
            left = [g.seg_hi - g.seg_lo for g in plan.groups]

            def release(g):
                left[g.index] = -1
                note(rank, release=g.index)
                grads = got[g.seg_lo:g.seg_hi]
                got[g.seg_lo:g.seg_hi] = [None] * len(grads)
                run.release(w, g.index,
                            zeros_for_none(ps[g.seg_lo:g.seg_hi], grads))

            def hook(j, g):
                def collect(grad):
                    got[j] = grad
                    left[g.index] -= 1
                    if left[g.index] == 0:
                        release(g)
                return collect

            handles = [ps[j].register_hook(hook(j, g)) for g in plan.groups
                       for j in range(g.seg_lo, g.seg_hi)]
            try:
                with torch.enable_grad():
                    l, metrics = loss(tree.unflatten(td, ps),
                                      local_batch(w))
                    note(rank, backward=True)
                    torch.autograd.grad(l, ps, allow_unused=True)
                note(rank, backward=False)
            finally:
                for h in handles:
                    h.remove()
            worker_metrics.append({k: v.detach() for k, v in metrics.items()})
            for g in plan.groups:
                if left[g.index] >= 0:
                    release(g)      # the loss does not reach a param of it

        workers = range(wire.local_workers)
        agg_kw = dict(wire=wire, resid2=state.get("resid2"), probe=probe,
                      adapt_state=state.get("adaptk"), step=state["step"],
                      keys=step_keys(seed, state["step"], wire.ranks))
        if dense:
            agg = aggregate.aggregate_dense([grads_of(w) for w in workers],
                                            wire)
            agg_metrics = {}
        else:
            if plan is not None:
                n = wire.local_workers
                held = None if rows is None else rows.held(layout)
                run = aggregate.ChunkedAggregation(
                    layout, plan, compression,
                    E=aggregate.flat_windows(state["resid"], layout, plan,
                                             n, held),
                    R2=(None if "resid2" not in state else
                        aggregate.flat_windows(state["resid2"], layout,
                                               plan, n, held)),
                    resid=state["resid"], rows=rows, **agg_kw)
                for w in workers:
                    backward_releasing(run, w)
                res = run.finish(td)
            else:
                res = aggregate.aggregate_compressed(
                    [functools.partial(grads_of, w) for w in workers],
                    state["resid"], compression, model_size=msize,
                    layout=None if rows is None else leaf_layout,
                    rows=rows, **agg_kw)
            agg, agg_metrics = res.agg, res.metrics
            if res.adapt_state is not None and "adaptk" in state:
                state["adaptk"] = res.adapt_state
        metrics = {k: wire.pmean([m[k] for m in worker_metrics],
                                 wire.data_axes)[0]
                   for k in worker_metrics[0]}
        lr = lr_fn(state["step"])
        optimizer.update(params, state["opt"], agg, lr)
        state["step"] += 1
        metrics["lr"] = lr
        metrics.update(agg_metrics)
        return state, metrics

    return step_fn
