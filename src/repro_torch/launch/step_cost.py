"""The cost of one training step, counted from the step itself — the
port's counterpart of ``repro/launch/hlo_cost.py``, which parses the
compiled HLO.  Torch compiles no HLO, so the three roofline inputs come
from three other sources:

  flops      one worker's forward plus backward under
             ``torch.utils.flop_counter.FlopCounterMode`` (its registry:
             matmuls, batched matmuls, convolutions, attention), on meta
             tensors or on the card; the ops it has no formula for and
             that are not pointwise are recorded, not guessed
  bytes      declared from the step's state: params, gradient, momentum,
             residual and the bucket, each read or written as the step
             does, and the K1-K3 compression at ``chip_smoke.py``'s
             per-element accounting
  coll/msgs  the step's aggregation run through a counting wire
             (:class:`ByteCountingWire`): one message a codec-pair
             collective call, and the bytes each worker receives (an
             all-gather's whole gathered block, a gTop-k round's pair)

A model with a recurrent layer (Mamba, mLSTM, sLSTM) runs a Python loop
over time, too slow on meta tensors at thousands of steps, so
:func:`count_flops` counts such a model piece by piece: the head and
loss, and each layer's FFN and non-recurrent core at the real shape,
and each recurrent core at two short sequences, extended linearly (a
recurrence's cost is linear in the sequence: exact).

:func:`count_temp_bytes` counts the fourth input the dry run needs, the
live bytes one call allocates (activations, saved tensors, gradients,
the head's logits, a prefill's cache), at one card's share: under a
dispatch mode (:class:`LiveBytes`) that adds each new storage when an
op returns it and takes it off when it dies, on meta tensors.  What a
kernel allocates inside itself and frees before it returns (a fused
op's workspace) is not seen.
"""
from __future__ import annotations

import weakref
from typing import Dict, Optional

import torch

from repro_torch.benchmarks.common import CountingWire

# the two short sequences a recurrent core is counted at
FIT_SEQS = (16, 32)

# bytes an element of the bucket moves a step under the fused Gaussian-k
# compression, K1 + K2 + both K3 launches (chip_smoke.LEAF_BYTES)
COMPRESS_BYTES_PER_ELEM = 8 + 8 + 8 + 12


class ByteCountingWire(CountingWire):
    """A :class:`CountingWire` that also sums the bytes one worker
    receives: an ``all_gather`` brings the whole gathered block (the
    payload times the group size), a ``ppermute`` one payload."""

    def __init__(self, inner):
        super().__init__(inner)
        self.bytes = 0

    @staticmethod
    def _nbytes(payload) -> int:
        parts = payload if isinstance(payload, tuple) else (payload,)
        return sum(p.numel() * p.element_size() for p in parts)

    def all_gather(self, xs, axis, async_op: bool = False):
        self.bytes += self._nbytes(xs[0]) * self.inner.axis_size(axis)
        return super().all_gather(xs, axis, async_op=async_op)

    def ppermute(self, xs, axis, perm):
        self.bytes += self._nbytes(xs[0])
        return super().ppermute(xs, axis, perm)


def count_wire_collectives(wire: ByteCountingWire, steps: int = 1
                           ) -> Dict[str, float]:
    """``{"messages", "bytes"}`` a step of a counting wire that ran
    ``steps`` steps: the codec-pair collective calls (values and indices
    travel in one call, so this is the reference's ``messages``) and one
    worker's received bytes."""
    return {"messages": wire.messages / steps, "bytes": wire.bytes / steps}


def wire_cost(grads, layout, config, wire) -> Dict[str, float]:
    """Run one bucketed aggregation of ``grads`` (one tree a local worker
    of ``wire``, zero residuals) through a :class:`ByteCountingWire`
    around ``wire``; returns its :func:`count_wire_collectives`."""
    from repro_torch import tree
    from repro_torch.dist.aggregate import aggregate_bucketed

    counting = ByteCountingWire(wire)
    device = tree.leaves(grads[0])[0].device
    resid = torch.zeros((wire.local_workers, layout.flat_size),
                        device=device)
    # the two-level strategies keep the pod residual in resid2
    resid2 = (torch.zeros_like(resid)
              if config.strategy in ("hierarchical", "hier_gtopk") else None)
    aggregate_bucketed(grads, resid, layout, config, wire=counting,
                       resid2=resid2)
    return count_wire_collectives(counting)


def _recurrent(cfg) -> bool:
    return any(cfg.block_kind(i) in ("mamba", "mlstm", "slstm")
               for i in range(cfg.num_layers))


class _OpRecorder(torch.utils._python_dispatch.TorchDispatchMode):
    """The ops a region runs that have no FLOP formula and are not
    pointwise or views: what ``FlopCounterMode`` leaves out."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        packet = func.overloadpacket
        if packet not in flop_registry and not func.is_view and \
                torch.Tag.pointwise not in func.tags:
            self.ops.add(str(packet).replace("aten.", ""))
        return func(*args, **(kwargs or {}))


def _inputs(cfg, batch: int, seq: int, kind: str, device):
    from repro_torch.configs.shapes import InputShape, input_specs
    specs = input_specs(cfg, InputShape("cost", seq, batch, kind))
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in specs.items()}


def _counted(fn, inputs, train: bool, ops: set) -> float:
    """FLOPs of ``fn()`` (a scalar), and with ``train`` of its backward
    to ``inputs``; the uncounted ops go into ``ops``."""
    from torch.utils.flop_counter import FlopCounterMode

    rec = _OpRecorder()
    with FlopCounterMode(display=False) as fc, rec:
        out = fn()
        if train:
            torch.autograd.grad(out, inputs, allow_unused=True)
    ops |= rec.ops
    return float(fc.get_total_flops())


def _whole(cfg, params, batch: int, seq: int, kind: str, device,
           ops: set, remat: bool = False) -> float:
    from repro_torch import tree
    from repro_torch.models.model import (decode_step, forward, init_cache,
                                          loss_fn)

    if kind == "train":
        b = _inputs(cfg, batch, seq, kind, device)
        return _counted(lambda: loss_fn(params, cfg, b, remat=remat)[0],
                        tree.leaves(params), True, ops)
    if kind == "prefill":
        b = _inputs(cfg, batch, seq, kind, device)
        return _counted(lambda: forward(params, cfg, b.get("tokens"),
                                        embeds=b.get("embeds"),
                                        remat=False).sum(),
                        [], False, ops)
    cache = init_cache(cfg, batch, seq, device=device)
    tok = torch.zeros((batch, 1), dtype=torch.int64, device=device)
    return _counted(lambda: decode_step(params, cfg, cache, seq - 1,
                                        tok)[0].sum(), [], False, ops)


def _piecewise(cfg, params, batch: int, seq: int, train: bool, device,
               ops: set, remat: bool = False) -> float:
    """Forward (and backward) FLOPs of the model summed over its pieces:
    the head with the loss, then per layer its core and its FFN, each
    from a hidden state of ``(batch, seq, d_model)``; a recurrent core
    at :data:`FIT_SEQS`, extended linearly to ``seq``.  With ``remat``
    (and ``train``) every layer of the stacked periods adds its forward
    once more, the backward's recompute, but for the period's last
    piece (the last layer's FFN, or its core without one): that piece
    is counted under a checkpoint of its own, whose recompute stops, as
    the period's does, at the last tensor the backward keeps (its output
    projection is not recomputed)."""
    from torch.utils.checkpoint import checkpoint
    from repro_torch import tree
    from repro_torch.models import model as mdl

    adt = getattr(torch, cfg.activation_dtype)

    def piece(fn, p, s, train=train):
        h = torch.zeros((batch, s, cfg.d_model), dtype=adt, device=device,
                        requires_grad=train)
        return _counted(lambda: fn(p, h), [h] + tree.leaves(p), train, ops)

    def counted(fn, p, recurrent, train=train):
        if not recurrent:
            return piece(fn, p, seq, train)
        s1, s2 = FIT_SEQS
        f1, f2 = (piece(fn, p, s, train) for s in (s1, s2))
        return f1 + (f2 - f1) * (seq - s1) / (s2 - s1)

    def head(p, h):
        return torch.logsumexp(mdl._head(p, cfg, h).float(), dim=-1).sum()

    total = piece(head, {k: params[k] for k in ("final_norm", "lm_head")},
                  seq)
    period = cfg.pattern_period
    reps = cfg.num_layers // period
    layers = [(mdl._unbind(params["stack"][pos])[0], pos, reps)
              for pos in range(period if reps else 0)]
    layers += [(p, reps * period + i, 1)
               for i, p in enumerate(params["tail"])]
    for p, index, times in layers:
        kind, ffn = cfg.layer_sig(index)
        recurrent = kind in ("mamba", "mlstm", "slstm")

        def core(q, h, kind=kind):
            return mdl._apply_core(q, h, cfg, kind)[0].sum()

        def ffn_sum(q, h, ffn=ffn):
            out, aux = mdl._ffn(q, h, cfg, ffn)
            return out.sum() if aux is None else out.sum() + aux

        def rematerialised(fn):
            return lambda q, h: checkpoint(fn, q, h, use_reentrant=False,
                                           preserve_rng_state=False)

        parts = [(core, p["core"], recurrent)]
        if ffn != "none":
            parts.append((ffn_sum, p["ffn"], False))
        f = 0.0
        for n, (fn, q, rec) in enumerate(parts):
            if not (remat and train and index < reps * period):
                f += counted(fn, q, rec)
            elif index == period - 1 and n == len(parts) - 1:
                f += counted(rematerialised(fn), q, rec)
            else:
                f += counted(fn, q, rec) + counted(fn, q, rec, False)
        total += times * f
    return total


def count_flops(cfg, batch: int, seq: int, *, kind: str = "train",
                params=None, device="meta", remat: bool = False) -> dict:
    """FLOPs of one ``kind`` call (``train``: forward plus backward;
    ``prefill``: forward; ``decode``: one token against a cache of
    ``seq``) on ``batch`` sequences of ``seq``, as ``FlopCounterMode``
    counts them.  ``remat`` counts a train call as the trainer runs it
    at full width (``models.loss_fn(remat=True)``): the backward's
    recompute adds one forward of every rematerialised layer-pattern
    period, as the reference's ``hlo_cost`` counts the compiled
    program's recompute.  ``params`` default to the arch's on the meta
    device (nothing allocated).  Returns ``{"flops", "method",
    "uncounted_ops"}``; ``method`` is ``whole`` (one call), or
    ``piecewise`` for a train or prefill call of a model with a
    recurrent layer at a sequence above :data:`FIT_SEQS`."""
    from repro_torch import tree
    from repro_torch.models import init_params

    device = torch.device(device)
    if params is None:
        params = init_params(cfg, 0, "meta")
    leaves = tree.leaves(params)
    train = kind == "train"
    for leaf in leaves:
        leaf.requires_grad_(train)
    ops: set = set()
    try:
        if kind == "decode" or not _recurrent(cfg) or seq <= FIT_SEQS[-1]:
            flops = _whole(cfg, params, batch, seq, kind, device, ops,
                           remat)
            method = "whole"
        else:
            flops = _piecewise(cfg, params, batch, seq, train, device, ops,
                               remat)
            method = "piecewise"
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
    return {"flops": flops, "method": method, "uncounted_ops": sorted(ops)}


class LiveBytes(torch.utils._python_dispatch.TorchDispatchMode):
    """The bytes of the storages the ops under it create that are alive
    at once: ``live`` now, ``peak`` the most.  A storage is counted
    once, when an op first returns a tensor on it (views and in-place
    results share one seen before), and taken off when it dies (a weak
    reference's callback).  The storages of the inputs it first meets
    are the caller's: they count nothing."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._refs: dict = {}

    def _gone(self, key: int, nbytes: int):
        def drop(_ref):
            self._refs.pop(key, None)
            self.live -= nbytes
        return drop

    def _track(self, t: torch.Tensor, new: bool) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._refs:
            return
        nbytes = st.nbytes() if new else 0
        self._refs[key] = weakref.ref(st, self._gone(key, nbytes))
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in _tensors(args + tuple(kwargs.values())):
            self._track(t, False)
        out = func(*args, **kwargs)
        for t in _tensors(out if isinstance(out, (tuple, list)) else (out,)):
            self._track(t, True)
        return out


def _tensors(xs):
    """The tensors among an op's arguments or results (a tensor list is
    an aten op's only nesting)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (tuple, list)):
            yield from (t for t in x if isinstance(t, torch.Tensor))


class MetaAxis:
    """Model rank 0 of ``size`` on meta tensors: the collectives of
    ``dist/tensor_parallel.ModelAxis`` allocating what the wire's do
    (a gather ``size`` times its input, a reduction a copy) and moving
    nothing."""

    def __init__(self, size: int):
        self.rank, self.size = 0, size

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return t.new_empty((self.size,) + tuple(t.shape))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return torch.empty_like(t, memory_format=torch.contiguous_format)

    amax = all_reduce


def _rank_params(cfg, params, model_size: int):
    """Model rank 0's shards of the whole ``params`` (their shapes, on
    meta) under the tensor-parallel placement."""
    from repro_torch import tree
    from repro_torch.dist.tensor_parallel import check_split
    if model_size == 1:
        return params
    leaves, td = tree.flatten(params)
    return tree.unflatten(td, [
        torch.empty(pl.shard_shape, dtype=p.dtype, device="meta")
        for p, pl in zip(leaves, check_split(cfg, params, model_size))])


def _live_peak(fn) -> int:
    mode = LiveBytes()
    with mode:
        fn()
    return mode.peak


def _temp_whole(cfg, params, batch: int, seq: int, kind: str, axis,
                remat: bool) -> int:
    from repro_torch import tree
    from repro_torch.models.model import (decode_step, init_cache, loss_fn,
                                          prefill)
    b = _inputs(cfg, batch, seq, kind, "meta")
    if kind == "train":
        leaves = tree.leaves(params)

        def step():
            loss = loss_fn(params, cfg, b, axis, remat=remat)[0]
            torch.autograd.grad(loss, leaves, allow_unused=True)
        return _live_peak(step)
    if kind == "prefill":
        return _live_peak(lambda: prefill(
            params, cfg, b.get("tokens"), embeds=b.get("embeds"),
            axis=axis))
    cache = init_cache(cfg, batch, seq, device="meta", axis=axis)
    tok = torch.zeros((batch, 1), dtype=torch.int64, device="meta")
    return _live_peak(lambda: decode_step(params, cfg, cache, seq - 1, tok,
                                          axis=axis))


def _temp_piecewise(cfg, params, batch: int, seq: int, train: bool, axis,
                    remat: bool) -> int:
    """A recurrent arch's train or prefill temporaries from its pieces
    (each counted as :func:`_piecewise` counts its FLOPs, a recurrent
    core at :data:`FIT_SEQS` extended linearly): the bytes kept across
    the call (a train step's period inputs under ``remat``, its tail
    layers' pieces and, without ``remat``, every layer's; a prefill's
    cache) plus the largest of the head's piece and, for a train step,
    one period's pieces summed (its recompute), for a prefill its
    largest piece."""
    from repro_torch import tree
    from repro_torch.models import model as mdl

    adt = getattr(torch, cfg.activation_dtype)
    h_bytes = batch * seq * cfg.d_model * torch.empty(
        (), dtype=adt).element_size()

    def piece(fn, p, s):
        h = torch.empty((batch, s, cfg.d_model), dtype=adt, device="meta",
                        requires_grad=train)
        leaves = [h] + tree.leaves(p)

        def run():
            out = fn(p, h)
            if train:
                torch.autograd.grad(out, leaves, allow_unused=True)
        return _live_peak(run)

    def counted(fn, p, recurrent):
        if not recurrent:
            return piece(fn, p, seq)
        s1, s2 = FIT_SEQS
        b1, b2 = (piece(fn, p, s) for s in (s1, s2))
        return int(b1 + (b2 - b1) * (seq - s1) / (s2 - s1))

    def head(p, h):
        return torch.logsumexp(mdl._head(p, cfg, h, axis).float(),
                               dim=-1).sum()

    top = counted(head, {k: params[k] for k in ("final_norm", "lm_head")},
                  False)
    period = cfg.pattern_period
    reps = cfg.num_layers // period
    layers = [(mdl._unbind(params["stack"][pos])[0], pos)
              for pos in range(period if reps else 0)]
    tail = [(p, reps * period + i) for i, p in enumerate(params["tail"])]

    def layer_bytes(p, index):
        kind, ffn = cfg.layer_sig(index)
        total = counted(lambda q, h: mdl._apply_core(q, h, cfg, kind,
                                                     axis)[0].sum(),
                        p["core"], kind in ("mamba", "mlstm", "slstm"))
        if ffn != "none":
            total += counted(lambda q, h: mdl._ffn(q, h, cfg, ffn,
                                                   axis)[0].sum(),
                             p["ffn"], False)
        return total

    body = [layer_bytes(p, i) for p, i in layers]
    tails = [layer_bytes(p, i) for p, i in tail]
    if not train:
        cache = mdl.init_cache(cfg, batch, seq, device="meta", axis=axis)
        kept = sum(int(x.untyped_storage().nbytes())
                   for x in tree.leaves(cache)) + h_bytes
        return kept + max([top] + body + tails)
    if remat:
        shard = axis.size if cfg.shard_activations and axis else 1
        kept = reps * h_bytes // shard + sum(tails)
        return kept + max(top, sum(body))
    return reps * sum(body) + sum(tails) + top


def count_temp_bytes(cfg, batch: int, seq: int, *, kind: str = "train",
                     params=None, remat: bool = False,
                     model_size: int = 1) -> dict:
    """The live bytes one ``kind`` call allocates on one card (its
    temporaries: a train step's activations, saved tensors, gradients
    and logits; a prefill's cache and transients; a decode step's, its
    cache given), counted on meta tensors by :class:`LiveBytes` at
    ``batch`` sequences of ``seq`` on model rank 0's shards of a model
    axis of ``model_size`` (:class:`MetaAxis`; ``cfg.shard_activations``
    as the config says).  ``remat`` as in :func:`count_flops`.

    A train step also packs its gradients into the bucket: every
    gradient shard is alive beside the rank's bucket row (``d_row_total``
    columns, the residual in the params' dtype) while it is packed
    (``dist/aggregate.ChunkedAggregation.release``), the step's peak
    wherever the activations are small beside the gradients; the count
    is the larger of the two.  Returns ``{"temp_bytes", "method"}``:
    ``whole``, or ``piecewise`` where :func:`count_flops` goes piecewise
    (:func:`_temp_piecewise`)."""
    from repro_torch import tree
    from repro_torch.models import init_params

    if params is None:
        params = init_params(cfg, 0, "meta")
    # a leaf's row is ceil(size / M) columns (``dist.layout.flat_dims``)
    bucket_cols = sum(-(-x.numel() // model_size)
                      for x in tree.leaves(params))
    params = _rank_params(cfg, params, model_size)
    axis = MetaAxis(model_size) if model_size > 1 else None
    train = kind == "train"
    leaves = tree.leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(train)
    try:
        if kind == "decode" or not _recurrent(cfg) or seq <= FIT_SEQS[-1]:
            n = _temp_whole(cfg, params, batch, seq, kind, axis, remat)
            method = "whole"
        else:
            n = _temp_piecewise(cfg, params, batch, seq, train, axis,
                                remat)
            method = "piecewise"
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
    if train:
        itemsize = getattr(torch, cfg.param_dtype).itemsize
        n = max(n, sum(x.numel() * x.element_size() for x in leaves)
                + bucket_cols * itemsize)
    return {"temp_bytes": int(n), "method": method}


def state_bytes(n_params: int, bucket_elems: int = 0, *, workers: int = 1,
                param_bytes: int = 4, bucket_bytes: int = 4
                ) -> Dict[str, float]:
    """Bytes a training step moves on one card for its state, declared:
    the forward reads the params (``param_bytes`` an element, as are the
    gradient, the momentum and the mean); the backward writes the
    gradient, which the pack reads into a bucket of ``bucket_elems``
    elements of ``bucket_bytes`` (the residual's dtype) a worker (one
    write); the compression moves :data:`COMPRESS_BYTES_PER_ELEM` an f32
    element of the bucket, in proportion at another size; the update
    reads the mean and the params, writes the params, and reads and
    writes the momentum.  ``workers`` workers share the card
    (``LocalWire``).  Activations are not counted."""
    P = float(n_params) * param_bytes
    out = {"params": P * workers + 2 * P,      # forward reads, update r/w
           "grads": 2 * P * workers,           # backward writes, pack reads
           "momentum": 2 * P,
           "update_mean": P,
           "bucket": float(bucket_elems) * bucket_bytes * workers,
           "compress": (float(bucket_elems) * COMPRESS_BYTES_PER_ELEM
                        * bucket_bytes / 4 * workers)}
    out["total"] = sum(out.values())
    return out


def step_cost(cfg, *, batch: int, seq: int, layout=None, workers: int = 1,
              wire_counts: Optional[Dict[str, float]] = None,
              params=None, remat: bool = False) -> dict:
    """The three roofline inputs of one data-parallel train step on one
    card running ``workers`` workers, each on ``batch // workers`` of the
    global ``batch``: FLOPs (:func:`count_flops` of one worker, times the
    workers; ``remat`` as the step is trained), bytes
    (:func:`state_bytes`, the params at their element size and an f32
    bucket) and, when given, the counted wire
    (``wire_counts`` from :func:`count_wire_collectives`)."""
    from repro_torch import tree
    from repro_torch.models import init_params

    if params is None:
        params = init_params(cfg, 0, "meta")
    leaves = tree.leaves(params)
    n = sum(int(x.numel()) for x in leaves)
    per = count_flops(cfg, batch // workers, seq, params=params,
                      remat=remat)
    sb = state_bytes(n, layout.flat_size if layout is not None else 0,
                     workers=workers, param_bytes=leaves[0].element_size())
    wc = wire_counts or {"messages": 0.0, "bytes": 0.0}
    return {"flops": per["flops"] * workers,
            "flops_per_worker": per["flops"],
            "flops_method": per["method"],
            "uncounted_ops": per["uncounted_ops"],
            "bytes_accessed": sb["total"], "state_bytes": sb,
            "coll_bytes": float(wc["bytes"]),
            "n_messages": float(wc["messages"]), "n_params": n}
