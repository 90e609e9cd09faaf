"""Eq. (2) sparse aggregation over the flat bucket, on W data-parallel
workers (port of ``repro/dist/aggregate.py``: ``AggregateResult``,
``bucket_compress`` fixed-k and dynamic-k with its fused and reference
branches and ``_wire_cast_fixup``, the adaptive-density pieces
``_stats_reduce`` / ``pass_a_stats_rows`` / ``_compress_rows_dynamic`` /
``_adaptive_allocation``, the gTop-k pieces ``encode_rows_topk`` /
``encode_bucket_topk`` / ``gtopk_round_plan`` / ``_gtopk_reduce_rounds``
/ ``_gtopk_reduce_bucket`` / ``gtopk_simulate``, ``_gather_mean``,
``aggregate_dense``, ``_wire_config`` and ``aggregate_bucketed`` for the
four wire strategies, with the keyed compressors' per-segment keys and
DGC momentum correction).

Per step and per worker: pack the worker's gradients into the
``(model_size, d_row_total)`` bucket and compress it against the
worker's residual (the fused kernels, one segment at a time).  Then the
wire, over the data axes of the mesh (``dist/wire.py``):

``allgather``     all-gather every worker's pair, decode the gathered
                  block rank by rank into one dense bucket, divide by W;
``gtopk``         ``log2(W)`` rounds of XOR-partner exchanges of one
                  pair each, decode-add, re-select top-``k_cap`` per
                  segment; each round's re-selection drop, divided by
                  the number of workers that made the same merge, goes
                  back into the worker's residual;
``hierarchical``  gather within the pod (the inner data axes), compress
                  the pod mean again against the second residual
                  ``resid2``, gather that across pods;
``hier_gtopk``    the same pod level, then gTop-k across the pods, its
                  drops credited into ``resid2`` undivided.

The code is written per worker: every per-worker value is a list with
one entry per worker this process runs (all W under ``LocalWire``, one
under ``ProcessGroupWire``).  The residual buckets are updated in place.
A worker's gradients are packed and compressed as soon as they exist
and dropped after, so one process holding W workers keeps one worker's
gradients at a time; the gathered block is decoded into ONE dense
bucket, never into a ``(W, M, D)`` stack.

The key-sampled compressors (``randk``, ``dgck``, ``rtopk``) are keyed
as the reference keys them: a worker's step key, folded with each
segment's stable salt (``layout.leaf_key_salt``) and, at the second
level of the two-level strategies, with 1; the rows of a segment take
``split(segment key, M)``, even at ``M = 1``.

``momentum_correction > 0`` is DGC's client-side momentum (Lin et al.
2018, §3.1): ``v = μ·v + g``, ``u = e + v``; the coordinates that reach
the wire are zeroed in ``v``.  ``resid2`` holds ``v`` (so momentum
correction excludes the two-level strategies), and the compression takes
the reference branch, as in the reference.

Adaptive density (``config.density_policy``) puts a barrier across the
workers: every worker's pass-A statistics feed one allocation (the
``pmean`` of the stacked per-leaf signals) before any worker compresses.
So that W workers still hold one gradient bucket at a time, each
worker's ``u = G + E`` is written into its residual rows as soon as its
gradients exist, pass A (K1) runs on ``u`` alone, ``G`` is dropped, and
``u`` is compressed in place after the allocation.  The kernels form
``g + e`` in f32 before anything else, so this is bitwise the same as
compressing ``(G, E)``.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import prng, tree
from repro_torch.core import adaptk, codec
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.compressors import CompressorSpec
from repro_torch.core.error_feedback import resolve_backend
from repro_torch.dist.layout import (STRATEGIES, BucketLayout, _log2_exact,
                                     pack_grads, unpack_tree)
from repro_torch.dist.wire import LocalWire
from repro_torch.kernels.ef_fused.segmented import (segmented_compress_ef,
                                                    segmented_pass_a,
                                                    stats_to_host)
from repro_torch.launch.mesh import make_mesh


class AggregateResult(NamedTuple):
    """``agg`` averaged gradient tree (the same on every worker);
    ``resid`` new flat residual(s); ``resid2`` second-level residual(s)
    or, under momentum correction, the velocities (else None);
    ``adapt_state`` the adaptive controller state (None unless adaptive
    with a state); ``metrics``."""
    agg: Any
    resid: Any
    resid2: Any
    adapt_state: Any
    metrics: dict


def _one_data_axis_wire(workers: int) -> LocalWire:
    return LocalWire(make_mesh((workers, 1), ("data", "model")))


def aggregate_dense(grads, wire):
    """Dense-SGD baseline: the mean over the data axes.  ``grads`` holds
    one gradient tree per local worker of ``wire``; returns the mean tree
    (the same on every worker; at world 1 the worker's own tree)."""
    if wire.world == 1:
        return grads[0]
    per_worker = [tree.flatten(g) for g in grads]
    td = per_worker[0][1]
    out = [wire.pmean([leaves[i] for leaves, _ in per_worker],
                      wire.data_axes)[0]
           for i in range(len(per_worker[0][0]))]
    return tree.unflatten(td, out)


# ---------------------------------------------------------------------------
# worker-local compression
# ---------------------------------------------------------------------------


def _compress_rows_reference(u_rows, select, codec_dtype=None, keys=None):
    """Reference branch over the ``(M, d_row)`` rows of ``u = e + g``:
    ``select(row, key)`` per row (``keys[r]``, or None), the wire cast,
    ``e' = u - decode(cast values)``."""
    d_row = u_rows.shape[1]
    pairs = [select(u_rows[r], None if keys is None else keys[r])
             for r in range(u_rows.shape[0])]
    values = torch.stack([p[0] for p in pairs])
    indices = torch.stack([p[1] for p in pairs])
    if codec_dtype is not None:
        values = values.to(codec_dtype)
    decoded = torch.stack([codec.decode(values[r].to(u_rows.dtype),
                                        indices[r], d_row)
                           for r in range(u_rows.shape[0])])
    return values, indices, u_rows - decoded


def _row_budget(k, model_size: int, d_row: int) -> np.int32:
    """A leaf's per-step budget split over the model shards, as the
    reference's traced int32: ``clip(ceil(k / M), 1, d_row)``."""
    return np.int32(min(max((int(k) + model_size - 1) // model_size, 1),
                        d_row))


def _compress_rows_dynamic(u_rows, spec: CompressorSpec, k, k_cap: int,
                           codec_dtype=None, keys=None):
    """Reference branch with a per-step leaf budget ``k``: each row
    selects ``adaptk.select_dynamic`` at ``k_row = ceil(k / M)`` into
    the static capacity ``k_cap`` (with its key from ``keys``)."""
    k_row = _row_budget(k, u_rows.shape[0], u_rows.shape[1])
    return _compress_rows_reference(
        u_rows, lambda r, key: adaptk.select_dynamic(spec, r, k_row, k_cap,
                                                     key),
        codec_dtype, keys)


def _zero_velocity(V_rows: torch.Tensor, indices: torch.Tensor) -> None:
    """``v' = v · codec.keep_mask(indices)`` in place, row by row: the
    coordinates a row sent are multiplied by 0, the rest by 1.  Dense,
    with no host sync."""
    for r in range(V_rows.shape[0]):
        V_rows[r].mul_(codec.keep_mask(indices[r], V_rows.shape[1],
                                       V_rows.dtype))


def _segment_keys(key, s, key_fold, M: int):
    """The rows' keys of segment ``s``: ``split(fold_in(key, salt)[,
    key_fold], M)``; None without a key."""
    if key is None:
        return None
    seg = prng.fold_in(key, s.salt)
    if key_fold is not None:
        seg = prng.fold_in(seg, key_fold)
    return prng.split(seg, M)


def _wire_cast_fixup(values, indices, new_e_rows, codec_dtype):
    """Down-cast the wire values and add the cast error into the new
    residual rows in place, with a k-sized scatter
    (``e' += decode(values − cast(values))``).  Returns ``(wire values,
    indices, new_e_rows)``."""
    if codec_dtype is None:
        return values, indices, new_e_rows
    wire = values.to(codec_dtype)
    diff = values - wire.to(values.dtype)
    for r in range(values.shape[0]):
        real = indices[r] != codec.SENTINEL
        new_e_rows[r].index_add_(0, indices[r][real].long(), diff[r][real])
    return wire, indices, new_e_rows


def bucket_compress(G: Optional[torch.Tensor], E: torch.Tensor,
                    layout: BucketLayout, spec: CompressorSpec, key=None, *,
                    backend: str = "auto", codec_dtype=None,
                    momentum: float = 0.0, V: Optional[torch.Tensor] = None,
                    k_alloc=None, seg_stats=None, key_fold=None):
    """Worker-local EF compression of the packed bucket.

    ``G``/``E`` are ``(model_size, d_row_total)`` buckets; ``G=None``
    means ``E`` already holds ``u = G + E``.  Returns ``(values, indices,
    new_E)`` with ONE ``(model_size, k_cap_total)`` codec pair whose
    indices are bucket-global and whose values are ``codec_dtype`` (f32
    when None).  Selection runs per leaf segment with the segment's own
    plan.  ``new_E`` IS ``E``, overwritten in place; ``G`` is only read.

    ``key`` (a ``prng`` key, the worker's) keys the key-sampled
    compressors: segment ``s`` folds in its salt, then ``key_fold`` when
    given, and its rows take ``split(·, M)``.  ``momentum > 0`` is DGC
    momentum correction against the velocity bucket ``V`` (``G`` given):
    ``V = μ·V + G`` and ``u = E + V`` per segment, then the coordinates
    sent are zeroed in ``V``, in place; it takes the reference branch.

    ``k_alloc`` (the allocator's per-segment ``np.int32`` budgets)
    switches to the dynamic-k path, ``k_row = ceil(k / M)`` per segment;
    ``seg_stats`` hands the segments' pass-A statistics to the fused
    branch (``segmented_pass_a`` of the same operands), which then
    launches no K1."""
    segs = layout.segments
    M = layout.model_size
    adaptive = k_alloc is not None
    if momentum > 0.0 and (G is None or V is None):
        raise ValueError("momentum correction needs the gradients G and "
                         "the velocity bucket V")
    vals, idcs, new_e_blocks = [], [], []
    if momentum == 0.0 and resolve_backend(backend, spec):
        ks = ([_row_budget(k_alloc[i], M, s.d_row)
               for i, s in enumerate(segs)]
              if adaptive else [s.k_row for s in segs])
        triples = segmented_compress_ef(
            E if G is None else G, None if G is None else E,
            [(s.row_off, s.d_row) for s in segs], spec.name, ks,
            [s.k_cap for s in segs], stats=seg_stats, out2d=E)
        for s, (v, i, ne) in zip(segs, triples):
            v, i, ne = _wire_cast_fixup(v, i, ne, codec_dtype)
            vals.append(v)
            idcs.append(codec.offset_indices(i, s.row_off))
            new_e_blocks.append(ne)
    else:
        for si, s in enumerate(segs):
            cols = slice(s.row_off, s.row_off + s.d_row)
            keys = _segment_keys(key, s, key_fold, M)
            if momentum > 0.0:
                vel = V[:, cols].mul_(momentum).add_(G[:, cols])
                u = E[:, cols] + vel
            else:
                u = E[:, cols] if G is None else E[:, cols] + G[:, cols]
            if adaptive:
                v, i, ne = _compress_rows_dynamic(u, spec, k_alloc[si],
                                                  s.k_cap, codec_dtype, keys)
            else:
                v, i, ne = _compress_rows_reference(
                    u, lambda r, k, s=s: spec.select(r, s.k_row, k),
                    codec_dtype, keys)
            if momentum > 0.0:
                # wire-exchanged coordinates stop accumulating velocity
                _zero_velocity(vel, i)
            vals.append(v)
            idcs.append(codec.offset_indices(i, s.row_off))
            new_e_blocks.append(ne)
    values = torch.cat(vals, dim=1)
    indices = torch.cat(idcs, dim=1)
    for s, blk in zip(segs, new_e_blocks):
        cols = slice(s.row_off, s.row_off + s.d_row)
        if blk.data_ptr() != E[:, cols].data_ptr():
            E[:, cols].copy_(blk)
    return values, indices, E


# ---------------------------------------------------------------------------
# adaptive density: pass A, the signal, the allocation
# ---------------------------------------------------------------------------


def _stats_reduce(row_stats):
    """Leaf-level ``(s, sq, mx)`` (np.float32) of per-row pass-A tuples on
    the host: the rows' sums added in row order, the max of the maxes."""
    s = sq = np.float32(0.0)
    for st in row_stats:
        s = np.float32(s + np.float32(st[0]))
        sq = np.float32(sq + np.float32(st[1]))
    mx = max(np.float32(st[2]) for st in row_stats)
    return s, sq, mx


def pass_a_stats_rows(u_rows: torch.Tensor) -> tuple:
    """The reference backend's pass A of one leaf's ``(M, d_row)`` rows
    of ``u``: ``(sum(u), sum(u²), max|u|)`` as 0-d tensors on ``u``'s
    device (zero padding adds nothing)."""
    return (torch.sum(u_rows), torch.sum(u_rows * u_rows),
            torch.amax(torch.abs(u_rows)))


def _pass_a(u: torch.Tensor, layout: BucketLayout, spec: CompressorSpec,
            fused: bool):
    """Pass A of one worker over its bucket of ``u``: ``(seg_stats,
    moments)`` with ``seg_stats`` the fused branch's per-segment row
    statistics on the host (None on the reference branch) and
    ``moments`` each segment's ``(s, sq, mx)``.  One device-to-host copy
    of the statistics (two for hist-k's histograms)."""
    segs = layout.segments
    if fused:
        seg_stats = stats_to_host(segmented_pass_a(
            u, None, [(s.row_off, s.d_row) for s in segs], spec.name))
        return seg_stats, [_stats_reduce(rows) for rows in seg_stats]
    stacked = torch.stack([torch.stack(pass_a_stats_rows(
        u[:, s.row_off:s.row_off + s.d_row])) for s in segs]).cpu().numpy()
    return None, [tuple(np.float32(x) for x in row) for row in stacked]


def _adaptive_allocation(adapt_state, sigs, sqs, dims, ratio, policy, step,
                         lo, hi, wire):
    """The allocation, once for all workers: the ``pmean`` over the data
    axes of each worker's stacked per-leaf signal (plus its ``Σ u²``
    lane under a global-k policy, in the same collective), the EMA
    blend, the budget (× the warmup, × the global-k scale) and the
    budget-exact split.  ``sigs``/``sqs`` hold one list per local
    worker.  Returns ``(k_alloc, K_eff, new_adapt_state)``."""
    globalk = policy.global_policy != "none"
    stacks = []
    for sig, sq in zip(sigs, sqs):
        lane = np.asarray(sig, np.float32)
        if globalk:
            tot = np.float32(0.0)
            for x in sq:
                tot = np.float32(tot + x)
            lane = np.concatenate([lane, [tot]]).astype(np.float32)
        stacks.append(torch.from_numpy(lane))
    red = wire.pmean(stacks, wire.data_axes)[0].numpy()
    signal = red[:-1] if globalk else red
    signal, new_adapt = adaptk.blend_signal(adapt_state, signal, policy.ema)
    K = adaptk.budget(dims, ratio, policy, step)
    if globalk:
        scale, upd = adaptk.global_scale(
            new_adapt if new_adapt is not None else adapt_state, red[-1],
            policy)
        K = adaptk.scale_budget(K, scale)
        if new_adapt is not None:
            new_adapt = {**new_adapt, **upd}
    k_alloc, K_eff = adaptk.allocate(K, signal, lo, hi)
    return k_alloc, K_eff, new_adapt


# ---------------------------------------------------------------------------
# gTop-k recursive doubling
# ---------------------------------------------------------------------------


def _topk_lax(row: torch.Tensor, k: int) -> torch.Tensor:
    """The indices ``lax.top_k(|row|, k)`` returns: the ``k`` largest
    magnitudes, ties at the k-th magnitude to the lower indices, ordered
    by descending magnitude then ascending index (``torch.topk`` breaks
    ties otherwise)."""
    mag = row.abs()
    kth = torch.topk(mag, k, sorted=False).values.min()
    above = torch.nonzero(mag > kth).flatten()
    need, ties, start, step = k - above.numel(), [], 0, 1 << 24
    while need > 0 and start < mag.numel():
        # the first `need` positions at the k-th magnitude
        hit = torch.nonzero(mag[start:start + step] == kth).flatten()[:need]
        ties.append(hit + start)
        need -= hit.numel()
        start += step
    if need > 0:    # only a NaN compares unequal to itself
        raise ValueError("gTop-k re-selection over a non-finite partial")
    idx, _ = torch.sort(torch.cat([above] + ties))
    order = torch.sort(mag[idx], descending=True, stable=True).indices
    return idx[order]


def encode_rows_topk(dense_rows: torch.Tensor, k_cap: int, codec_dtype=None):
    """Re-encode a dense ``(model_size, d_row)`` partial as fixed-capacity
    ``(model_size, k_cap)`` pairs — the gTop-k merge re-selection: per
    row the exact top-``k_cap`` by magnitude in ``lax.top_k``'s order.
    Where a row holds fewer than ``k_cap`` non-zeros the surplus slots
    carry real indices with value 0.  ``codec_dtype`` down-casts the
    values."""
    vals, idcs = [], []
    for row in dense_rows:
        idx = _topk_lax(row, k_cap)
        vals.append(row[idx])
        idcs.append(idx.to(torch.int32))
    values = torch.stack(vals)
    if codec_dtype is not None:
        values = values.to(codec_dtype)
    return values, torch.stack(idcs)


def encode_bucket_topk(dense_bucket: torch.Tensor, layout: BucketLayout,
                       codec_dtype=None):
    """Per-segment gTop-k re-selection over the packed bucket, merged into
    ONE ``(model_size, k_cap_total)`` wire block with bucket-global
    indices."""
    vs, is_ = [], []
    for s in layout.segments:
        v, i = encode_rows_topk(
            dense_bucket[:, s.row_off:s.row_off + s.d_row], s.k_cap,
            codec_dtype)
        vs.append(v)
        is_.append(codec.offset_indices(i, s.row_off))
    return torch.cat(vs, dim=1), torch.cat(is_, dim=1)


def gtopk_round_plan(axis_sizes):
    """Static recursive-doubling schedule over the joint data world:
    ``[(axis_pos, xor_mask, group_size), ...]``, one entry per round.
    The joint rank is row-major, so halving walks the axes from last to
    first; ``group_size = 2**round`` workers already share the partial
    when the round starts.  Every axis size must be a power of two."""
    plan = []
    group = 1
    for pos in range(len(axis_sizes) - 1, -1, -1):
        n = axis_sizes[pos]
        _log2_exact(n, f"data axis size (axis {pos})")
        mask = 1
        while mask < n:
            plan.append((pos, mask, group))
            group *= 2
            mask *= 2
    return plan


def _scatter_add(buf: torch.Tensor, values, indices) -> None:
    """``buf[m, indices[m]] += values[m]`` per row, in place, into a
    ``(M, d + k)`` buffer whose last ``k`` columns take the sentinel
    slots of the ``k``-slot pair (``codec._safe``); each row's indices
    are distinct."""
    d = buf.shape[1] - values.shape[-1]
    for m in range(buf.shape[0]):
        safe, vals = codec._safe(values[m].to(buf.dtype), indices[m], d)
        buf[m].index_add_(0, safe, vals)


def _decoded(values, indices, d: int, dtype) -> torch.Tensor:
    """A pair decoded into a new ``(M, d + k)`` buffer (see
    :func:`_scatter_add`); ``[:, :d]`` is the dense rows."""
    buf = torch.zeros((values.shape[0], d + values.shape[-1]), dtype=dtype,
                      device=values.device)
    _scatter_add(buf, values, indices)
    return buf


def _gtopk_reduce_rounds(values, indices, axes, d_row: int, encode, wire,
                         dtype=torch.float32):
    """The recursive-doubling XOR-merge loop over the workers' pairs
    (lists, one entry per local worker).  Returns ``(dense_sums, drops)``
    as ``(M, d_row)`` views: the pruned sum every worker converges to,
    and each worker's residual credit (None when no round re-selected).

    Round 0 sends the worker's own pair as it is (it already is the
    top-``k_cap`` encoding of its partial).  A later round re-encodes the
    partial, credits ``(dense − sent) / group`` and keeps ``sent``; the
    partner's pair is then added in.  The same operations as the
    reference's, done in place: ``dense − sent`` is ``dense[i] += −v``
    at the sent slots, and ``sent + decode(received)`` is a scatter-add
    into ``sent``."""
    sizes = [wire.axis_size(a) for a in axes]
    plan = gtopk_round_plan(sizes)
    n = len(values)
    dense = [_decoded(values[w], indices[w], d_row, dtype) for w in range(n)]
    drop: List[Optional[torch.Tensor]] = [None] * n
    cur = list(zip(values, indices))
    for r, (pos, mask, group) in enumerate(plan):
        if r > 0:
            for w in range(n):
                v, i = encode(dense[w][:, :d_row])
                diff = dense[w]
                _scatter_add(diff, -v.to(dtype), i)
                diff.div_(group)
                if drop[w] is None:
                    drop[w] = diff
                else:
                    drop[w].add_(diff)
                del diff
                dense[w] = _decoded(v, i, d_row, dtype)
                cur[w] = (v, i)
        perm = [(j, j ^ mask) for j in range(sizes[pos])]
        got = wire.ppermute(cur, axes[pos], perm)
        for w in range(n):
            _scatter_add(dense[w], got[w][0], got[w][1])
    return ([x[:, :d_row] for x in dense],
            [None if x is None else x[:, :d_row] for x in drop])


def _gtopk_reduce_bucket(values, indices, axes, layout: BucketLayout, wire,
                         codec_dtype=None, dtype=torch.float32):
    """Bucketed recursive doubling: every round exchanges ONE merged
    ``(model_size, k_cap_total)`` wire block; re-selection stays per
    segment (:func:`encode_bucket_topk`)."""
    return _gtopk_reduce_rounds(
        values, indices, axes, layout.d_row_total,
        lambda dense: encode_bucket_topk(dense, layout, codec_dtype), wire,
        dtype)


def gtopk_simulate(partials, k_cap: int, codec_dtype=None):
    """Single-process reference of the gTop-k reduction: the same
    XOR-partner merge tree over a list of ``(model_size, d_row)`` dense
    partials, one per worker, written out densely as the reference's
    ``gtopk_simulate``.  Returns ``(final, drops)``."""
    W = len(partials)
    _log2_exact(W)
    d_row = partials[0].shape[-1]
    dtype = partials[0].dtype
    partials = list(partials)
    drops = [torch.zeros_like(partials[0]) for _ in range(W)]
    mask, group = 1, 1
    while mask < W:
        sent = []
        for w in range(W):
            v, i = encode_rows_topk(partials[w], k_cap, codec_dtype)
            sent.append(_decoded(v, i, d_row, dtype)[:, :d_row])
            drops[w] = drops[w] + (partials[w] - sent[w]) / group
        partials = [sent[w] + sent[w ^ mask] for w in range(W)]
        mask *= 2
        group *= 2
    return partials[0], drops


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------


def _gather_mean(values, indices, axis, n: int, d_row: int, wire,
                 dtype=torch.float32) -> list:
    """All-gather the workers' pairs over ``axis`` and decode-average:
    one ``(model_size, d_row)`` mean per local worker (workers of one
    group share it).  The gathered block is decoded rank by rank into
    one bucket and divided by ``n`` (at ``n == 1`` the division is the
    identity and is skipped)."""
    gathered = wire.all_gather(list(zip(values, indices)), axis)
    means = {}
    for v_all, i_all in gathered:
        key = (id(v_all), id(i_all))
        if key not in means:
            total = codec.decode_sum(v_all, i_all, d_row, dtype)
            means[key] = total if n == 1 else total.div_(n)
    return [means[(id(v), id(i))] for v, i in gathered]


def _wire_config(strategy: str, wire, with_resid2: bool, mc: float,
                 adaptive: bool, spec: CompressorSpec):
    """Validate the wire configuration.  Returns ``(strategy, hier,
    gtopk, outer_gtopk, outer_axis, inner_axes, n_pods, n_inner,
    world)``; the world is the wire's (the bound axes'), and the
    two-level strategies fall back to ``allgather`` on a mesh with one
    data axis or without ``resid2``.  Adaptive density refuses momentum
    correction ``mc`` and a compressor without a dynamic-k path, and
    momentum correction refuses the two-level strategies and a missing
    ``resid2``, in the reference's words."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; have {STRATEGIES}")
    if adaptive and mc > 0.0:
        raise ValueError("momentum_correction is fixed-k only (the DGC "
                         "velocity update needs the static-k path); "
                         "disable it or density_policy")
    if adaptive and not adaptk.supports_dynamic(spec):
        raise ValueError(
            f"compressor {spec.name!r} bakes its per-step budget k into "
            f"static sample/candidate shapes, so it has no dynamic-k path; "
            f"adaptive density supports {adaptk.DYNAMIC_COMPRESSORS}.  Run "
            f"{spec.name!r} fixed-k instead: drop --density-policy on the "
            f"CLI (density_policy=None here)")
    axes = wire.data_axes
    hier = (strategy in ("hierarchical", "hier_gtopk") and len(axes) > 1
            and with_resid2)
    if strategy in ("hierarchical", "hier_gtopk") and not hier:
        strategy = "allgather"
    outer_gtopk = strategy == "hier_gtopk"
    gtopk = strategy == "gtopk"
    world = wire.axis_size(axes)
    if gtopk:
        _log2_exact(world)
    if hier:
        outer_axis, inner_axes = axes[0], axes[1:]
        n_pods = wire.axis_size(outer_axis)
        n_inner = max(1, world // n_pods)
        if outer_gtopk:
            _log2_exact(n_pods, "pod-axis size")
    else:
        outer_axis, inner_axes = None, axes
        n_pods, n_inner = 1, world
    if mc > 0.0 and hier:
        raise ValueError("momentum_correction reuses resid2 as the DGC "
                         "velocity state; combine it with the flat or "
                         "gtopk path, not hierarchical aggregation")
    if mc > 0.0 and not with_resid2:
        raise ValueError("momentum_correction needs a velocity state: "
                         "init_train_state allocates resid2 whenever "
                         "momentum_correction > 0 (or "
                         "strategy='hierarchical') in its compression "
                         "config")
    return strategy, hier, gtopk, outer_gtopk, outer_axis, inner_axes, \
        n_pods, n_inner, world


def _rows(resid: torch.Tensor, layout: BucketLayout, workers: int):
    """``(workers, M, D)`` view of a ``(workers, flat)`` or, for one
    worker, ``(flat,)`` residual."""
    M, D = layout.model_size, layout.d_row_total
    if resid.dim() == 1:
        if workers != 1:
            raise ValueError(f"a (flat,) residual holds one worker, the "
                             f"wire runs {workers} here")
        return resid.view(1, M, D)
    if resid.shape[0] != workers:
        raise ValueError(f"residual has {resid.shape[0]} worker rows, the "
                         f"wire runs {workers} workers here")
    return resid.view(workers, M, D)


def _worker_grads(entry, seen: dict):
    """One worker's gradient tree (``entry`` or what it returns); the
    first records the dense baseline's bits, from the RUNTIME grad
    dtypes, and an empty tree of the gradients' structure and dtypes
    (for ``unpack_tree``) into ``seen``."""
    g = entry() if callable(entry) else entry
    if "like" not in seen:
        leaves, td = tree.flatten(g)
        seen["bits_dense"] = float(sum(2 * x.numel() * x.element_size() * 8
                                       for x in leaves))
        seen["like"] = tree.unflatten(td, [torch.empty(0, dtype=x.dtype)
                                           for x in leaves])
    return g


def _compress_workers(grads, E_rows, layout: BucketLayout,
                      config: CompressionConfig, wire, probe, seen: dict,
                      keys, V_rows=None):
    """Fixed k: pack and compress each local worker's gradients against
    its residual rows ``E_rows[w]`` (updated in place), with its key
    ``keys[w]`` and, under momentum correction, its velocity rows
    ``V_rows[w]`` (updated in place).  ``grads`` holds one entry per
    local worker: a gradient tree, or a callable returning it (called in
    worker order, so only one worker's gradients are alive at a time).
    Returns per-worker lists of the wire pairs."""
    mc = config.momentum_correction
    values, indices = [], []
    for w, entry in enumerate(grads):
        g = _worker_grads(entry, seen)
        G = pack_grads(layout, g, E_rows.dtype)
        del g
        v, i, new_E = bucket_compress(G, E_rows[w], layout, config.spec,
                                      keys[w], backend=config.backend,
                                      codec_dtype=config.codec_dtype,
                                      momentum=mc,
                                      V=V_rows[w] if mc > 0.0 else None)
        if probe is not None:
            probe(wire.ranks[w], G=G, values=v, indices=i, new_E=new_E)
        del G
        values.append(v)
        indices.append(i)
    return values, indices


def _compress_workers_adaptive(grads, E_rows, layout: BucketLayout,
                               config: CompressionConfig, wire, probe,
                               seen: dict, adapt_state, step, keys):
    """Adaptive density: per local worker, in worker order, ``E_rows[w]
    += G`` (``u`` in place), pass A on ``u``, ``G`` dropped; then the
    allocation across all workers; then each worker's ``u`` compressed
    with the allocated budgets and its pass-A statistics (no second K1).
    Returns the wire pairs, ``k_alloc``, ``K_eff`` and the new
    controller state."""
    spec, policy = config.spec, config.density_policy
    fused = resolve_backend(config.backend, spec)
    segs = layout.segments
    stats, sigs, sqs = [], [], []
    for w, entry in enumerate(grads):
        g = _worker_grads(entry, seen)
        G = pack_grads(layout, g, E_rows.dtype)
        del g
        u = E_rows[w].add_(G)
        del G
        st, moments = _pass_a(u, layout, spec, fused)
        stats.append(st)
        sigs.append([adaptk.leaf_signal(policy.policy, s.size, *m)
                     for s, m in zip(segs, moments)])
        sqs.append([m[1] for m in moments])
        if probe is not None:
            probe(wire.ranks[w], u=u)
    k_alloc, K_eff, new_adapt = _adaptive_allocation(
        adapt_state, sigs, sqs, [s.size for s in segs], layout.ratio,
        policy, step, [s.k_lo for s in segs], [s.k_hi for s in segs], wire)
    if probe is not None:
        probe(None, k_alloc=k_alloc, K_eff=K_eff)
    values, indices = [], []
    for w in range(len(grads)):
        v, i, new_E = bucket_compress(None, E_rows[w], layout, spec,
                                      keys[w], backend=config.backend,
                                      codec_dtype=config.codec_dtype,
                                      k_alloc=k_alloc, seg_stats=stats[w])
        if probe is not None:
            probe(wire.ranks[w], G=None, values=v, indices=i, new_E=new_E)
        values.append(v)
        indices.append(i)
    return values, indices, k_alloc, K_eff, new_adapt


def aggregate_bucketed(grads, resid: torch.Tensor, layout: BucketLayout,
                       config: CompressionConfig, *, wire=None,
                       resid2: Optional[torch.Tensor] = None,
                       probe: Optional[Callable] = None, adapt_state=None,
                       step=None, keys=None) -> AggregateResult:
    """Eq. (2) sparse aggregation over the bucketed pipeline.

    ``grads`` holds one entry per local worker of ``wire`` (a gradient
    tree or a callable returning one, called in worker order so that one
    worker's gradients are alive at a time); a
    bare tree is the one worker's.  ``resid`` (and ``resid2``) are the
    ``(workers, model_size * d_row_total)`` residuals of those workers,
    or ``(flat,)`` for one, updated in place.  ``wire`` defaults to one
    data axis of that many workers in this process.  ``keys`` holds each
    local worker's ``prng`` key (the reference's per-worker step key),
    which the key-sampled compressors need; ``config.momentum_correction``
    needs ``resid2``, which then holds the velocities.

    ``config.density_policy`` switches to adaptive density (the layout
    must be built with the same policy): ``adapt_state`` is the
    controller state (``init_controller_state``; None runs stateless)
    and ``step`` the step index the density warmup reads.  The metrics
    then add ``k_total`` (the step's ``K_eff``) and ``density_budget``.

    Returns an :class:`AggregateResult` whose ``agg`` leaves are views
    into the decoded mean bucket (model_size 1), the same on every
    worker.  ``probe``, when given, is called as ``probe(rank, G=,
    values=, indices=, new_E=)`` right after each local worker's
    compression (under adaptive density with ``G=None``, after
    ``probe(rank, u=)`` once its pass A has run on ``u`` and
    ``probe(None, k_alloc=, K_eff=)`` once the allocation is made), and
    as ``probe(None, mean=, resid=, resid2=)`` once the wire has run —
    hooks for checks such as conservation."""
    spec = config.spec
    policy = config.density_policy
    adaptive = policy is not None
    if isinstance(grads, dict):
        grads = [grads]
    workers = len(grads)
    if wire is None:
        wire = _one_data_axis_wire(workers)
    strategy, hier, gtopk, outer_gtopk, outer_axis, inner_axes, n_pods, \
        n_inner, world = _wire_config(config.strategy, wire,
                                      resid2 is not None,
                                      config.momentum_correction, adaptive,
                                      spec)
    config.require_ported()
    if layout.spec_name != spec.name:
        raise ValueError(f"layout was built for compressor "
                         f"{layout.spec_name!r}, got {spec.name!r}")
    if layout.adaptive != adaptive:
        raise ValueError(
            f"layout adaptive={layout.adaptive} does not match "
            f"density_policy={'set' if adaptive else 'None'}; rebuild the "
            "layout with the matching density_policy")
    if workers != wire.local_workers:
        raise ValueError(f"got gradients of {workers} workers, the wire "
                         f"runs {wire.local_workers} here")
    if keys is None:
        if spec.needs_key:
            raise ValueError(f"compressor {spec.name!r} samples with a "
                             "key: pass keys=, one prng key per worker")
        keys = [None] * workers
    elif len(keys) != workers:
        raise ValueError(f"got {len(keys)} keys for {workers} workers")
    E_rows = _rows(resid, layout, workers)
    R2_rows = None if resid2 is None else _rows(resid2, layout, workers)
    D = layout.d_row_total
    codec_dtype = config.codec_dtype

    seen = {}
    new_adapt = adapt_state
    if adaptive:
        values, indices, k_alloc, K_eff, new_adapt = \
            _compress_workers_adaptive(grads, E_rows, layout, config, wire,
                                       probe, seen, adapt_state, step, keys)
    else:
        k_alloc = None
        values, indices = _compress_workers(grads, E_rows, layout, config,
                                            wire, probe, seen, keys, R2_rows)
    nnz = [codec.nnz(i).to(torch.float32) for i in indices]

    if gtopk:
        sums, drops = _gtopk_reduce_bucket(values, indices, wire.data_axes,
                                           layout, wire, codec_dtype)
        mean = sums[0].div_(world)
        del sums
        for w, drop in enumerate(drops):
            if drop is not None:
                E_rows[w].add_(drop)
        del drops
    else:
        means = _gather_mean(values, indices, inner_axes, n_inner, D, wire)
        mean = means[0]
    del values, indices

    if hier:
        # second level: compress the pod mean against resid2, then one
        # more gather (or gTop-k) across the pods
        v2s, i2s = [], []
        for w in range(workers):
            v2, i2, _ = bucket_compress(means[w], R2_rows[w], layout, spec,
                                        keys[w], backend=config.backend,
                                        codec_dtype=codec_dtype,
                                        k_alloc=k_alloc, key_fold=1)
            v2s.append(v2)
            i2s.append(i2)
            nnz[w] = nnz[w] + codec.nnz(i2).to(torch.float32)
        del means, mean
        if outer_gtopk:
            sums, drops = _gtopk_reduce_bucket(v2s, i2s, (outer_axis,),
                                               layout, wire, codec_dtype)
            mean = sums[0].div_(n_pods)
            del sums
            for w, drop in enumerate(drops):
                if drop is not None:
                    R2_rows[w].add_(drop)
            del drops
        else:
            mean = _gather_mean(v2s, i2s, outer_axis, n_pods, D, wire)[0]
        del v2s, i2s
    elif not gtopk:
        del means

    new_resid = E_rows.reshape(resid.shape)
    new_resid2 = None if resid2 is None else R2_rows.reshape(resid2.shape)
    if probe is not None:
        probe(None, mean=mean, resid=new_resid, resid2=new_resid2)
    agg = unpack_tree(layout, mean, like=seen["like"])
    M = layout.model_size
    sparse_bits = layout.comm_bits_sparse(strategy, world, n_pods,
                                          codec_dtype)
    metrics = {
        "density": wire.pmean([x / layout.d_total for x in nnz],
                              wire.data_axes)[0],
        "density_cap": M * layout.k_cap_total / layout.d_total,
        "comm_bits_sparse": sparse_bits,
        "comm_bits_dense": seen["bits_dense"],
        "wire_bytes": sparse_bits / 8.0,
        "collectives_per_step": float(layout.collectives(strategy, world,
                                                         n_pods)),
    }
    if adaptive:
        metrics["k_total"] = float(K_eff)
        metrics["density_budget"] = float(np.float32(K_eff)
                                          / np.float32(layout.d_total))
    return AggregateResult(agg, new_resid, new_resid2,
                           new_adapt if adaptive else None, metrics)
