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
"""
from __future__ import annotations

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
           ops: set) -> float:
    from repro_torch import tree
    from repro_torch.models.model import (decode_step, forward, init_cache,
                                          loss_fn)

    if kind == "train":
        b = _inputs(cfg, batch, seq, kind, device)
        return _counted(lambda: loss_fn(params, cfg, b)[0],
                        tree.leaves(params), True, ops)
    if kind == "prefill":
        b = _inputs(cfg, batch, seq, kind, device)
        return _counted(lambda: forward(params, cfg, b.get("tokens"),
                                        embeds=b.get("embeds")).sum(),
                        [], False, ops)
    cache = init_cache(cfg, batch, seq, device=device)
    tok = torch.zeros((batch, 1), dtype=torch.int64, device=device)
    return _counted(lambda: decode_step(params, cfg, cache, seq - 1,
                                        tok)[0].sum(), [], False, ops)


def _piecewise(cfg, params, batch: int, seq: int, train: bool, device,
               ops: set) -> float:
    """Forward (and backward) FLOPs of the model summed over its pieces:
    the head with the loss, then per layer its core and its FFN, each
    from a hidden state of ``(batch, seq, d_model)``; a recurrent core
    at :data:`FIT_SEQS`, extended linearly to ``seq``."""
    from repro_torch import tree
    from repro_torch.models import model as mdl

    adt = getattr(torch, cfg.activation_dtype)

    def piece(fn, p, s):
        h = torch.zeros((batch, s, cfg.d_model), dtype=adt, device=device,
                        requires_grad=train)
        return _counted(lambda: fn(p, h), [h] + tree.leaves(p), train, ops)

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

        def core(q, h, kind=kind):
            return mdl._apply_core(q, h, cfg, kind)[0].sum()

        def ffn_sum(q, h, ffn=ffn):
            out, aux = mdl._ffn(q, h, cfg, ffn)
            return out.sum() if aux is None else out.sum() + aux

        if kind in ("mamba", "mlstm", "slstm"):
            s1, s2 = FIT_SEQS
            f1, f2 = (piece(core, p["core"], s) for s in (s1, s2))
            f = f1 + (f2 - f1) * (seq - s1) / (s2 - s1)
        else:
            f = piece(core, p["core"], seq)
        if ffn != "none":
            f += piece(ffn_sum, p["ffn"], seq)
        total += times * f
    return total


def count_flops(cfg, batch: int, seq: int, *, kind: str = "train",
                params=None, device="meta") -> dict:
    """FLOPs of one ``kind`` call (``train``: forward plus backward;
    ``prefill``: forward; ``decode``: one token against a cache of
    ``seq``) on ``batch`` sequences of ``seq``, as ``FlopCounterMode``
    counts them.  ``params`` default to the arch's on the meta device
    (nothing allocated).  Returns ``{"flops", "method",
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
            flops = _whole(cfg, params, batch, seq, kind, device, ops)
            method = "whole"
        else:
            flops = _piecewise(cfg, params, batch, seq, train, device, ops)
            method = "piecewise"
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
    return {"flops": flops, "method": method, "uncounted_ops": sorted(ops)}


def state_bytes(n_params: int, bucket_elems: int = 0, *, workers: int = 1,
                param_bytes: int = 4) -> Dict[str, float]:
    """Bytes a training step moves on one card for its state, declared:
    the forward reads the params; the backward writes the gradient, which
    the pack reads into a bucket of ``bucket_elems`` f32 elements a
    worker (one write); the compression moves
    :data:`COMPRESS_BYTES_PER_ELEM` an element of the bucket; the update
    reads the mean and the params, writes the params, and reads and
    writes the momentum.  ``workers`` workers share the card
    (``LocalWire``).  Activations are not counted."""
    P = float(n_params) * param_bytes
    out = {"params": P * workers + 2 * P,      # forward reads, update r/w
           "grads": 2 * P * workers,           # backward writes, pack reads
           "momentum": 2 * P,
           "update_mean": P,
           "bucket": float(bucket_elems) * 4 * workers,
           "compress": (float(bucket_elems) * COMPRESS_BYTES_PER_ELEM
                        * workers)}
    out["total"] = sum(out.values())
    return out


def step_cost(cfg, *, batch: int, seq: int, layout=None, workers: int = 1,
              wire_counts: Optional[Dict[str, float]] = None,
              params=None) -> dict:
    """The three roofline inputs of one data-parallel train step on one
    card running ``workers`` workers, each on ``batch // workers`` of the
    global ``batch``: FLOPs (:func:`count_flops` of one worker, times the
    workers), bytes (:func:`state_bytes`) and, when given, the counted
    wire (``wire_counts`` from :func:`count_wire_collectives`)."""
    from repro_torch import tree
    from repro_torch.models import init_params

    if params is None:
        params = init_params(cfg, 0, "meta")
    n = sum(int(x.numel()) for x in tree.leaves(params))
    per = count_flops(cfg, batch // workers, seq, params=params)
    sb = state_bytes(n, layout.flat_size if layout is not None else 0,
                     workers=workers)
    wc = wire_counts or {"messages": 0.0, "bytes": 0.0}
    return {"flops": per["flops"] * workers,
            "flops_per_worker": per["flops"],
            "flops_method": per["method"],
            "uncounted_ops": per["uncounted_ops"],
            "bytes_accessed": sb["total"], "state_bytes": sb,
            "coll_bytes": float(wc["bytes"]),
            "n_messages": float(wc["messages"]), "n_params": n}
