"""Topology-aware wire-strategy tuner (port of ``repro/dist/tuner.py``).

``--strategy auto`` asks which wire pattern moves this layout's step
fastest on this interconnect.  The tuner prices every candidate in
``core.compression.STRATEGIES`` under three terms:

1. **alpha** — the per-message latency.  Message counts follow the wire
   model (``layout.collective_count``): one codec-pair exchange is
   :data:`MSGS_PER_PAIR` array messages (values and indices).  A joint
   all-gather is one dispatch paying the slowest participating axis's
   alpha; every gTop-k round is its own dispatch.
2. **beta** — the bytes over each mesh axis divided by that axis's
   rate, from ``layout.pair_bits`` and the ring decomposition of each
   collective.
3. **merge compute** — the serialized decode/merge work between rounds,
   priced at ``HardwareSpec.hbm_bw``: a gather decodes all pairs once;
   every gTop-k merge round re-selects an exact top-k over the bucket
   (:data:`TOPK_PASSES_PER_LOG2D` · log2(d_row) sweeps); the
   hierarchical second-level compress is a threshold selection
   (:data:`COMPRESS_PASSES` sweeps).

For a two-level mesh the four strategies enumerate the {gather, gtopk}
choice per level; exact ties resolve by :data:`TIE_RANK`.  The pricing
is float arithmetic in the reference's order, so every prediction is
the reference's double.

The measuring half (:func:`measure_wire_time`, :func:`measure_wire_pattern`)
times the live wire — ``LocalWire`` or ``ProcessGroupWire`` — for the
multi-process validation leg (``launch/multihost.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.dist.layout import BucketLayout, _log2_exact
from repro_torch.launch.topo import Topology

__all__ = [
    "MSGS_PER_PAIR", "TOPK_PASSES_PER_LOG2D", "COMPRESS_PASSES",
    "TIE_RANK", "WirePrediction", "TunerDecision",
    "candidate_strategies", "predict_wire_time", "choose_strategy",
    "measure_wire_time", "measure_wire_pattern",
]

# one codec-pair exchange moves two arrays: values + indices
MSGS_PER_PAIR = 2

# merge-compute model, in full sweeps of the dense bucket at hbm_bw:
# the exact top-k re-selection of a gTop-k merge round (sort class,
# grows with log2 of the row length) ...
TOPK_PASSES_PER_LOG2D = 0.5
# ... and the threshold-based second-level compress of the hierarchical
# family (read mean + residual, write residual)
COMPRESS_PASSES = 3.0

# exact-tie preference, best first: the member of each tie that scales
# better when the mesh deepens or widens under the same topology
TIE_RANK = {"hier_gtopk": 0, "hierarchical": 1, "allgather": 2, "gtopk": 3}


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclass(frozen=True)
class WirePrediction:
    """Predicted per-step wire cost of one strategy under a topology."""
    strategy: str
    wire_s: float                      # alpha + beta terms
    merge_s: float                     # serialized merge compute
    messages: int                      # collective dispatches x arrays
    bytes_on_wire: float               # per-worker payload total
    axis_wire_s: Tuple[Tuple[str, float], ...] = ()

    @property
    def total_s(self) -> float:
        return self.wire_s + self.merge_s

    def to_dict(self) -> dict:
        return {"strategy": self.strategy, "wire_s": self.wire_s,
                "merge_s": self.merge_s, "total_s": self.total_s,
                "messages": self.messages,
                "bytes_on_wire": self.bytes_on_wire,
                "axis_wire_s": dict(self.axis_wire_s)}


@dataclass(frozen=True)
class TunerDecision:
    strategy: str
    predictions: Tuple[WirePrediction, ...]   # sorted best-first
    topology: str = "default"

    @property
    def considered(self) -> Tuple[str, ...]:
        return tuple(p.strategy for p in self.predictions)

    @property
    def best(self) -> WirePrediction:
        return self.predictions[0]

    def to_dict(self) -> dict:
        return {"strategy": self.strategy, "topology": self.topology,
                "predictions": [p.to_dict() for p in self.predictions]}


def candidate_strategies(axis_sizes: Sequence[int]) -> Tuple[str, ...]:
    """Strategies valid on a mesh with these data-axis sizes (outermost
    first): ``allgather`` always; ``gtopk`` when every axis is a power of
    two; the two-level ones with >= 2 data axes, the hybrid also needing
    a power-of-two pod count."""
    sizes = [int(n) for n in axis_sizes]
    cands = ["allgather"]
    world = math.prod(sizes) if sizes else 1
    if world >= 2 and all(_is_pow2(n) for n in sizes):
        cands.append("gtopk")
    if len(sizes) > 1:
        cands.append("hierarchical")
        if _is_pow2(sizes[0]):
            cands.append("hier_gtopk")
    return tuple(cands)


def _ring_gather(axes, pair_bytes: float, topo: Topology):
    """(seconds, messages, bytes, per-axis seconds) of ONE joint ring
    all-gather of a codec pair over ``axes`` (outermost first):
    innermost axes move first, axis ``i`` moving ``(n_i - 1) * block_i``
    bytes; one dispatch pays the slowest axis's alpha once an array."""
    live = [(ax, n) for ax, n in axes if n > 1]
    if not live:
        return 0.0, 0, 0.0, {}
    alpha = max(topo.link(ax).alpha_s for ax, _ in live)
    per_axis: Dict[str, float] = {}
    t = MSGS_PER_PAIR * alpha
    moved_total = 0.0
    block = float(pair_bytes)
    for ax, n in reversed(live):
        moved = (n - 1) * block
        dt = moved / topo.link(ax).beta_Bps
        per_axis[ax] = per_axis.get(ax, 0.0) + dt
        t += dt
        moved_total += moved
        block *= n
    return t, MSGS_PER_PAIR, moved_total, per_axis


def _gtopk_rounds(axes, pair_bytes: float, topo: Topology):
    """(seconds, messages, bytes, per-axis seconds) of the
    recursive-doubling rounds over ``axes``: log2(n) rounds an axis,
    each its own dispatch of one codec pair."""
    t, msgs, moved = 0.0, 0, 0.0
    per_axis: Dict[str, float] = {}
    for ax, n in axes:
        if n <= 1:
            continue
        rounds = _log2_exact(int(n), f"axis {ax!r} size")
        link = topo.link(ax)
        dt = rounds * link.time_s(MSGS_PER_PAIR, pair_bytes)
        per_axis[ax] = per_axis.get(ax, 0.0) + dt
        t += dt
        msgs += rounds * MSGS_PER_PAIR
        moved += rounds * pair_bytes
    return t, msgs, moved, per_axis


def predict_wire_time(strategy: str, axes: Sequence[Tuple[str, int]],
                      pair_bytes: float, dense_bytes: float,
                      topo: Topology, *,
                      d_row: Optional[int] = None) -> WirePrediction:
    """Price one strategy's per-step wire stage.

    ``axes``: data axes as ``(name, size)`` pairs, outermost first.
    ``pair_bytes``: one worker's codec-pair payload
    (``layout.pair_bits / 8``).  ``dense_bytes``: the decoded bucket
    (``model_size * d_row_total * 4``), the unit of the merge sweeps.
    ``d_row`` sizes the top-k sort term (default ``dense_bytes / 4``)."""
    live = [(ax, int(n)) for ax, n in axes]
    world = math.prod(n for _, n in live) if live else 1
    hbm = topo.hardware.hbm_bw
    d_eff = int(d_row) if d_row else max(2, int(dense_bytes // 4))
    sweep = dense_bytes / hbm                       # one full-bucket pass
    pair_pass = pair_bytes / hbm

    def decode_sum(n_pairs):
        # fused decode+sum of n pairs: one dense accumulation pass plus
        # the pair reads
        return sweep + n_pairs * pair_pass

    # exact top-k re-encode of a merge round (sort class) vs the
    # threshold-based second-level compress (no sort)
    reencode = (2.0 + TOPK_PASSES_PER_LOG2D * math.log2(d_eff)) * sweep \
        + pair_pass
    round_merge = reencode + decode_sum(1)
    compress2 = COMPRESS_PASSES * sweep + pair_pass

    if strategy == "allgather":
        wire, msgs, moved, per_axis = _ring_gather(live, pair_bytes, topo)
        merge = decode_sum(world) if world > 1 else 0.0
    elif strategy == "gtopk":
        wire, msgs, moved, per_axis = _gtopk_rounds(live, pair_bytes, topo)
        rounds = sum(_log2_exact(n, "axis size") for _, n in live if n > 1)
        merge = (decode_sum(2) + (rounds - 1) * round_merge
                 if rounds else 0.0)
    elif strategy in ("hierarchical", "hier_gtopk"):
        if len(live) < 2:
            raise ValueError(f"{strategy} needs >= 2 data axes, got {live}")
        outer, inner = live[0], live[1:]
        n_pods = outer[1]
        n_inner = max(1, world // n_pods)
        w_in, m_in, b_in, ax_in = _ring_gather(inner, pair_bytes, topo)
        merge = (decode_sum(n_inner) if n_inner > 1 else 0.0) + compress2
        if strategy == "hierarchical":
            w_out, m_out, b_out, ax_out = _ring_gather([outer], pair_bytes,
                                                       topo)
            merge += decode_sum(n_pods) if n_pods > 1 else 0.0
        else:
            w_out, m_out, b_out, ax_out = _gtopk_rounds([outer], pair_bytes,
                                                        topo)
            r_out = _log2_exact(n_pods, "pod-axis size")
            merge += (decode_sum(2) + (r_out - 1) * round_merge
                      if r_out else 0.0)
        wire, msgs, moved = w_in + w_out, m_in + m_out, b_in + b_out
        per_axis = dict(ax_in)
        for ax, dt in ax_out.items():
            per_axis[ax] = per_axis.get(ax, 0.0) + dt
    else:
        raise ValueError(f"unknown strategy {strategy!r}")

    return WirePrediction(strategy, wire, merge, msgs, moved,
                          tuple(sorted(per_axis.items())))


def choose_strategy(layout: BucketLayout,
                    axes: Sequence[Tuple[str, int]],
                    topo: Topology,
                    codec_dtype=None) -> TunerDecision:
    """The fastest valid strategy for this layout on this topology:
    candidates filtered by mesh validity, priced by
    :func:`predict_wire_time` and sorted by ``(total_s, TIE_RANK)``."""
    live = [(str(ax), int(n)) for ax, n in axes]
    cands = candidate_strategies([n for _, n in live])
    pair_bytes = layout.pair_bits(codec_dtype) / 8.0
    dense_bytes = float(layout.model_size) * layout.d_row_total * 4.0
    preds = [predict_wire_time(s, live, pair_bytes, dense_bytes, topo,
                               d_row=layout.d_row_total) for s in cands]
    preds.sort(key=lambda p: (p.total_s, TIE_RANK.get(p.strategy, 99)))
    return TunerDecision(preds[0].strategy, tuple(preds),
                         topology=topo.name)


# ---------------------------------------------------------------------------
# live measurement (the multi-process validation leg)
# ---------------------------------------------------------------------------

def _axis_info(mesh, wire):
    from repro_torch.launch.mesh import data_axes_of
    axes = tuple(data_axes_of(mesh))
    return axes, mesh.sizes, wire.axis_size(axes)


def measure_wire_time(mesh, wire, layout: BucketLayout, spec,
                      strategy: str, *, codec_dtype=None, reps: int = 5,
                      seed: int = 0, device="cuda") -> float:
    """Seconds of one wire stage (compress output -> aggregated mean) of
    ``strategy`` over ``wire`` — what :func:`predict_wire_time` models:
    every worker's pair encodes the same random ``(M, d_row_total)``
    bucket (``encode_bucket_topk``), then ``_gtopk_reduce_bucket``, or
    ``_gather_mean``, or the two-level path with the pod mean
    re-compressed by ``bucket_compress`` (reference backend, key fold
    1).  Timed as :func:`repro_torch.launch.topo._best_of` times (the
    device synchronised, the slowest rank's time)."""
    import torch

    from repro_torch import prng
    from repro_torch.devices import resolve_device
    from repro_torch.dist.aggregate import (_gather_mean,
                                            _gtopk_reduce_bucket,
                                            bucket_compress,
                                            encode_bucket_topk)
    from repro_torch.launch.topo import _best_of

    device = resolve_device(device)
    axes, sizes, world = _axis_info(mesh, wire)
    if strategy in ("hierarchical", "hier_gtopk") and len(axes) < 2:
        raise ValueError(f"{strategy} needs >= 2 data axes on this mesh")
    M, D = layout.model_size, layout.d_row_total
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    G = torch.randn((M, D), generator=gen, device=device)
    v, i = encode_bucket_topk(G, layout, codec_dtype)
    n = wire.local_workers
    values, indices = [v] * n, [i] * n
    key = prng.PRNGKey(seed)

    def stage():
        if strategy == "gtopk":
            dense, _ = _gtopk_reduce_bucket(values, indices, axes, layout,
                                            wire, codec_dtype)
            return [x / world for x in dense]
        if strategy == "allgather":
            return _gather_mean(values, indices, axes, world, D, wire)
        outer, inner = axes[0], axes[1:]
        n_pods = sizes[outer]
        means = _gather_mean(values, indices, inner, world // n_pods, D,
                             wire)
        pairs = [bucket_compress(mean, torch.zeros_like(mean), layout,
                                 spec, key, codec_dtype=codec_dtype,
                                 backend="reference", key_fold=1)[:2]
                 for mean in means]
        v2, i2 = [p[0] for p in pairs], [p[1] for p in pairs]
        if strategy == "hier_gtopk":
            dense2, _ = _gtopk_reduce_bucket(v2, i2, (outer,), layout, wire,
                                             codec_dtype)
            return [x / n_pods for x in dense2]
        return _gather_mean(v2, i2, outer, n_pods, D, wire)

    return _best_of(stage, reps, device, wire)


def measure_wire_pattern(mesh, wire, pair_bytes: float, strategy: str, *,
                         reps: int = 7, device="cuda") -> float:
    """Seconds of ``strategy``'s bare collective pattern over ``wire`` —
    the dispatches :func:`predict_wire_time`'s ``wire_s`` prices: values
    and indices as separate messages of the modelled payload, the gTop-k
    rounds of ``gtopk_round_plan``, no decode or merge — minus a null
    baseline that makes and touches the same tensors.  Each collective
    reads a fixed 8-element window of what it got (summing the whole
    gathered block would add a dense sweep against the gathers).  Timed
    as :func:`repro_torch.launch.topo._best_of` times."""
    import torch

    from repro_torch.devices import resolve_device
    from repro_torch.dist.aggregate import gtopk_round_plan
    from repro_torch.launch.topo import _best_of

    device = resolve_device(device)
    axes, sizes, _ = _axis_info(mesh, wire)
    if strategy in ("hierarchical", "hier_gtopk") and len(axes) < 2:
        raise ValueError(f"{strategy} needs >= 2 data axes")
    if strategy not in TIE_RANK:
        raise ValueError(f"unknown strategy {strategy!r}")
    words = max(1, int(pair_bytes) // (2 * 4))   # two arrays = one pair
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    v0 = torch.randn((words,), generator=gen, device=device)
    i0 = torch.arange(words, dtype=torch.int32, device=device)
    n = wire.local_workers

    def rounds_over(v, i, ax_list):
        for ax in ax_list:
            if sizes[ax] <= 1:
                continue
            for _, mask, _ in gtopk_round_plan([sizes[ax]]):
                perm = [(j, j ^ mask) for j in range(sizes[ax])]
                v = wire.ppermute(v, ax, perm)
                i = wire.ppermute(i, ax, perm)
        return [v, i]

    def gather_over(v, i, ax_list):
        live = tuple(a for a in ax_list if sizes[a] > 1)
        if not live:
            return [v, i]
        return [wire.all_gather(v, live), wire.all_gather(i, live)]

    def consume(groups):
        return sum(a.reshape(-1)[:8].float().sum() for g in groups
                   for a in g)

    def body():
        v, i = [v0 * 1.0] * n, [i0] * n
        if strategy == "allgather":
            return consume(gather_over(v, i, axes))
        if strategy == "gtopk":
            return consume(rounds_over(v, i, axes))
        got = gather_over(v, i, axes[1:])
        if strategy == "hier_gtopk":
            return consume(got + rounds_over(v, i, axes[:1]))
        return consume(got + gather_over(v, i, axes[:1]))

    def null():
        return consume([[v0 * 1.0] * n, [i0] * n])

    return max(_best_of(body, reps, device, wire)
               - _best_of(null, reps, device, wire), 1e-9)
