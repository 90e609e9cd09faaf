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
DGC momentum correction; the chunked schedule
``aggregate_bucketed_chunked``; the per-leaf ``init_residuals`` and
``aggregate_compressed``).

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

A tensor-parallel rank holds one model row of every bucket
(:class:`AllRows` is the one-process default, which holds all ``M``;
``dist/tensor_parallel.ModelRow`` the rank's): the rank compresses row
``r`` at the row's own budget and keys, its pass-A statistics are
gathered over the model group for the allocation, and its nnz summed
over it for the density, so each row is bitwise the one-process
bucket's.

The chunked schedule and the per-leaf loop dispatch the same arithmetic
at other granularities (:class:`ChunkedAggregation`): the bucket is cut
into leaf-aligned chunk groups (``layout.build_chunk_plan``; per leaf,
one group a leaf), and each chunk runs its own pack, compression and
wire on its window of the residual (``layout.chunk_view``).  Selection,
keys and the codec's index space are per segment, so every chunk's
results are the bits of the same columns of the bucketed run; only the
number of collectives changes (N, or L, a wire level).  A chunk is
packed and compressed as soon as its gradients are released (the train
step releases them from autograd hooks, during the backward), and its
wire runs once every local worker has released it.  Under adaptive
density the allocation needs every chunk's pass A first, so the
compressions and the wire wait for it.
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
from repro_torch.dist.layout import (STRATEGIES, BucketLayout, ChunkPlan,
                                     _log2_exact, build_chunk_plan,
                                     build_layout, chunk_view, flat_dims,
                                     pack_grads, unpack_tree,
                                     validate_chunk_plan)
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
                           codec_dtype=None, keys=None, model_size=None):
    """Reference branch with a per-step leaf budget ``k``: each row
    selects ``adaptk.select_dynamic`` at ``k_row = ceil(k / M)`` into
    the static capacity ``k_cap`` (with its key from ``keys``); ``M`` is
    ``model_size``, by default the number of rows given."""
    M = u_rows.shape[0] if model_size is None else model_size
    k_row = _row_budget(k, M, u_rows.shape[1])
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


def _segment_keys(key, s, key_fold, M: int, row=None):
    """The rows' keys of segment ``s``: ``split(fold_in(key, salt)[,
    key_fold], M)``, or of model row ``row`` alone; None without a
    key."""
    if key is None:
        return None
    seg = prng.fold_in(key, s.salt)
    if key_fold is not None:
        seg = prng.fold_in(seg, key_fold)
    keys = prng.split(seg, M)
    return keys if row is None else keys[row:row + 1]


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
                    k_alloc=None, seg_stats=None, key_fold=None,
                    row=None):
    """Worker-local EF compression of the packed bucket.

    ``G``/``E`` are ``(model_size, d_row_total)`` buckets, or with
    ``row`` the ``(1, d_row_total)`` model row ``row`` of them alone (a
    tensor-parallel rank's; budgets and keys are the row's); ``G=None``
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
            keys = _segment_keys(key, s, key_fold, M, row)
            if momentum > 0.0:
                vel = V[:, cols].mul_(momentum).add_(G[:, cols])
                u = E[:, cols] + vel
            else:
                u = E[:, cols] if G is None else E[:, cols] + G[:, cols]
            if adaptive:
                v, i, ne = _compress_rows_dynamic(u, spec, k_alloc[si],
                                                  s.k_cap, codec_dtype, keys,
                                                  M)
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
# which rows of the bucket this process holds
# ---------------------------------------------------------------------------


class AllRows:
    """This process holds all ``M`` model rows of every bucket: it packs
    whole gradient leaves into them and unpacks whole leaves.  A
    tensor-parallel rank holds one row instead
    (``dist/tensor_parallel.ModelRow``, the same methods)."""

    row = None

    def held(self, layout: BucketLayout) -> int:
        """The number of bucket rows held."""
        return layout.model_size

    def pack(self, view: BucketLayout, seg_lo: int, leaves, dtype):
        """The chunk ``view`` (its first segment global ``seg_lo``) of
        the gradient ``leaves`` as its held rows."""
        return pack_grads(view, leaves, dtype)

    def unpack(self, view: BucketLayout, seg_lo: int, mean, like) -> list:
        """The held rows ``mean`` of the chunk back into its leaves."""
        return unpack_tree(view, mean, like=like)

    def all_rows(self, row_stats: list) -> list:
        """Per segment, every model row's pass-A ``(s, sq, mx)``, in row
        order, from the held rows' ``row_stats``."""
        return row_stats

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """A per-worker count summed over the model rows."""
        return x


ALL_ROWS = AllRows()


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


def pass_a_stats_rows(u_rows: torch.Tensor) -> torch.Tensor:
    """The reference backend's pass A of one leaf's ``(M, d_row)`` rows
    of ``u``: ``(M, 3)`` rows of ``(sum(u), sum(u²), max|u|)`` on
    ``u``'s device (zero padding adds nothing); :func:`_stats_reduce`
    makes them the leaf's, as it does the fused branch's."""
    return torch.stack([torch.sum(u_rows, dim=1),
                        torch.sum(u_rows * u_rows, dim=1),
                        torch.amax(torch.abs(u_rows), dim=1)], dim=1)


def _pass_a(u: torch.Tensor, layout: BucketLayout, spec: CompressorSpec,
            fused: bool, rows=None):
    """Pass A of one worker over its bucket of ``u``: ``(seg_stats,
    moments)`` with ``seg_stats`` the fused branch's per-segment row
    statistics on the host (None on the reference branch) and
    ``moments`` each segment's ``(s, sq, mx)``, reduced over the rows
    in row order.  One device-to-host copy of the statistics (two for
    hist-k's histograms).  ``rows`` (an :class:`AllRows`) brings the
    rows this process does not hold."""
    segs = layout.segments
    rows = ALL_ROWS if rows is None else rows
    if fused:
        seg_stats = stats_to_host(segmented_pass_a(
            u, None, [(s.row_off, s.d_row) for s in segs], spec.name))
        row_stats = [[tuple(np.float32(x) for x in st[:3]) for st in r]
                     for r in seg_stats]
    else:
        seg_stats = None
        stacked = torch.stack([pass_a_stats_rows(
            u[:, s.row_off:s.row_off + s.d_row]) for s in segs]).cpu()
        row_stats = [[tuple(np.float32(x) for x in st) for st in r]
                     for r in stacked.numpy()]
    return seg_stats, [_stats_reduce(r) for r in rows.all_rows(row_stats)]


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
                 dtype=torch.float32, async_op: bool = False):
    """All-gather the workers' pairs over ``axis`` and decode-average:
    one ``(model_size, d_row)`` mean per local worker (workers of one
    group share it).  The gathered block is decoded rank by rank into
    one bucket and divided by ``n`` (at ``n == 1`` the division is the
    identity and is skipped).  With ``async_op`` the gather is only
    issued: returns a callable that waits for it and decodes."""
    pending = wire.all_gather(list(zip(values, indices)), axis,
                              async_op=async_op)

    def decode():
        gathered = pending.wait() if async_op else pending
        means = {}
        for v_all, i_all in gathered:
            key = (id(v_all), id(i_all))
            if key not in means:
                total = codec.decode_sum(v_all, i_all, d_row, dtype)
                means[key] = total if n == 1 else total.div_(n)
        return [means[(id(v), id(i))] for v, i in gathered]

    return decode if async_op else decode()


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


def _rows(resid: torch.Tensor, layout: BucketLayout, workers: int,
          held=None):
    """``(workers, M, D)`` view of a ``(workers, flat)`` or, for one
    worker, ``(flat,)`` residual; ``M`` is ``held`` when given (the rows
    this process holds)."""
    M = layout.model_size if held is None else held
    D = layout.d_row_total
    if resid.dim() == 1:
        if workers != 1:
            raise ValueError(f"a (flat,) residual holds one worker, the "
                             f"wire runs {workers} here")
        return resid.view(1, M, D)
    if resid.shape[0] != workers:
        raise ValueError(f"residual has {resid.shape[0]} worker rows, the "
                         f"wire runs {workers} workers here")
    return resid.view(workers, M, D)


def _workers_and_wire(grads, wire):
    """``grads`` as a list of per-worker entries (a bare tree is the one
    worker's) and the wire (default: one data axis of that many
    workers in this process)."""
    if isinstance(grads, dict):
        grads = [grads]
    return grads, (_one_data_axis_wire(len(grads)) if wire is None
                   else wire)


def _validate(config: CompressionConfig, layout: BucketLayout, wire,
              workers: int, with_resid2: bool, keys):
    """The checks every sparse aggregation makes: the wire configuration
    (``_wire_config``'s tuple), the layout against the config, the
    workers against the wire and one key per worker (None for all when
    the compressor samples no key).  Returns ``(wire tuple, keys)``."""
    spec = config.spec
    adaptive = config.density_policy is not None
    wcfg = _wire_config(config.strategy, wire, with_resid2,
                        config.momentum_correction, adaptive, spec)
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
    return wcfg, keys


def aggregate_bucketed(grads, resid: torch.Tensor, layout: BucketLayout,
                       config: CompressionConfig, *, wire=None,
                       resid2: Optional[torch.Tensor] = None,
                       probe: Optional[Callable] = None, adapt_state=None,
                       step=None, keys=None,
                       rows: Optional[AllRows] = None) -> AggregateResult:
    """Eq. (2) sparse aggregation over the bucketed pipeline: one
    compress + wire chain a step (:func:`aggregate_bucketed_chunked` at
    one chunk).

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
    worker.  ``probe`` is :class:`ChunkedAggregation`'s (chunk 0): hooks
    for checks such as conservation; so is ``rows``."""
    return aggregate_bucketed_chunked(
        grads, resid, layout, build_chunk_plan(layout, 1), config,
        wire=wire, resid2=resid2, probe=probe, adapt_state=adapt_state,
        step=step, keys=keys, rows=rows)


# ---------------------------------------------------------------------------
# the chunked schedule and the per-leaf loop
# ---------------------------------------------------------------------------


class ChunkedAggregation:
    """One step of the aggregation dispatched chunk by chunk.

    ``E`` (and ``R2``) hold, per local worker, each chunk group's
    ``(model_size, d_row)`` residual window, updated in place: views
    into the flat bucket (the chunked schedule) or the per-leaf residual
    rows (the per-leaf loop).  :meth:`release` takes one local worker's
    gradient leaves of one chunk: it packs them into the chunk's bucket
    and compresses it against the window (adaptive density: writes ``u``
    into the window and runs pass A), and once every local worker has
    released the chunk it runs the chunk's wire.  :meth:`finish` (after
    every release) makes the allocation and the compressions that wait
    for it, waits for the chunks' gathers and returns the
    :class:`AggregateResult`; its ``agg`` leaves are views into the
    chunks' means.

    ``rows`` says which model rows of the buckets this process holds
    (:class:`AllRows` by default; a tensor-parallel rank's
    ``ModelRow``): it packs the released leaves into them, brings the
    other rows' pass-A statistics and unpacks the means.

    ``probe``, when given, is called as ``probe(rank, chunk=, G=,
    values=, indices=, new_E=)`` after each compression (adaptive:
    ``G=None``, after ``probe(rank, chunk=, u=)`` once the chunk's pass
    A has run, and ``probe(None, k_alloc=, K_eff=)`` after the
    allocation), and ``probe(None, means=, resid=, resid2=)`` at the
    end, ``means`` the chunks' ``(model_size, d_row)`` means."""

    def __init__(self, layout: BucketLayout, plan: ChunkPlan,
                 config: CompressionConfig, *, wire, E, R2=None,
                 probe: Optional[Callable] = None, adapt_state=None,
                 step=None, keys=None, resid=None, resid2=None,
                 rows: Optional[AllRows] = None):
        validate_chunk_plan(layout, plan)
        workers = len(E)
        (self.strategy, self.hier, self.gtopk, self.outer_gtopk,
         self.outer_axis, self.inner_axes, self.n_pods, self.n_inner,
         self.world), self.keys = _validate(config, layout, wire, workers,
                                            R2 is not None, keys)
        self.layout, self.plan, self.config, self.wire = (layout, plan,
                                                          config, wire)
        self.spec, self.policy = config.spec, config.density_policy
        self.mc = config.momentum_correction
        self.fused = resolve_backend(config.backend, self.spec)
        self.E, self.R2, self.probe = E, R2, probe
        self.rows = ALL_ROWS if rows is None else rows
        self.resid, self.resid2 = resid, resid2
        self.adapt_state, self.step = adapt_state, step
        self.views = [chunk_view(layout, g) for g in plan.groups]
        n = plan.n_chunks
        self.got = [[False] * n for _ in range(workers)]
        self.count = [0] * n
        self.pairs = [[None] * workers for _ in range(n)]
        self.means = [None] * n
        self.nnz = [torch.zeros((), dtype=torch.float32, device=e[0].device)
                    for e in E]
        self.dtypes = [None] * len(layout.segments)
        self.bits_dense = 0.0
        self.stats = [[None] * n for _ in range(workers)]
        self.moments = [[None] * n for _ in range(workers)]
        self.k_alloc = self.K_eff = None

    def _note(self, rank, **kw):
        if self.probe is not None:
            self.probe(rank, **kw)

    def release(self, w: int, c: int, leaves) -> None:
        """Local worker ``w``'s gradient leaves of chunk ``c`` (in segment
        order; a leaf the loss does not reach is zeros)."""
        grp, view = self.plan.groups[c], self.views[c]
        if self.got[w][c]:
            raise ValueError(f"chunk {c} of worker {w} released twice")
        if len(leaves) != grp.seg_hi - grp.seg_lo:
            raise ValueError(f"chunk {c} has {grp.seg_hi - grp.seg_lo} "
                             f"leaves, got {len(leaves)}")
        self.got[w][c] = True
        for j, g in enumerate(leaves, grp.seg_lo):
            if self.dtypes[j] is None:
                # the dense baseline's bits, from the runtime grad dtypes
                self.dtypes[j] = g.dtype
                self.bits_dense += (2 * self.layout.segments[j].size
                                    * g.element_size() * 8)
        E = self.E[w][c]
        G = self.rows.pack(view, grp.seg_lo, leaves, E.dtype)
        del leaves
        rank = self.wire.ranks[w]
        if self.policy is not None:
            u = E.add_(G)
            del G
            self.stats[w][c], self.moments[w][c] = _pass_a(
                u, view, self.spec, self.fused, self.rows)
            self._note(rank, chunk=c, u=u)
        else:
            v, i, _ = bucket_compress(
                G, E, view, self.spec, self.keys[w],
                backend=self.config.backend,
                codec_dtype=self.config.codec_dtype, momentum=self.mc,
                V=self.R2[w][c] if self.mc > 0.0 else None,
                row=self.rows.row)
            self._note(rank, chunk=c, G=G, values=v, indices=i, new_E=E)
            del G
            self.pairs[c][w] = (v, i)
            self.nnz[w] += codec.nnz(i).to(torch.float32)
        self.count[c] += 1
        if self.policy is None and self.count[c] == len(self.E):
            self._wire(c)

    def _wire(self, c: int) -> None:
        """Chunk ``c``'s wire over the local workers' pairs: the gather
        (its last level issued asynchronously) or the gTop-k rounds,
        with the two-level strategies' second compression and level."""
        view, wire = self.views[c], self.wire
        D, cd = view.d_row_total, self.config.codec_dtype
        values = [p[0] for p in self.pairs[c]]
        indices = [p[1] for p in self.pairs[c]]
        self.pairs[c] = None
        grp = self.plan.groups[c]
        ka = (None if self.k_alloc is None
              else self.k_alloc[grp.seg_lo:grp.seg_hi])
        if self.gtopk:
            sums, drops = _gtopk_reduce_bucket(values, indices,
                                               wire.data_axes, view, wire,
                                               cd)
            mean = sums[0].div_(self.world)
            for w, drop in enumerate(drops):
                if drop is not None:
                    self.E[w][c].add_(drop)
            self.means[c] = mean
        elif not self.hier:
            self.means[c] = _gather_mean(values, indices, self.inner_axes,
                                         self.n_inner, D, wire,
                                         async_op=True)
        else:
            means = _gather_mean(values, indices, self.inner_axes,
                                 self.n_inner, D, wire)
            del values, indices
            v2s, i2s = [], []
            for w in range(len(self.E)):
                v2, i2, _ = bucket_compress(
                    means[w], self.R2[w][c], view, self.spec, self.keys[w],
                    backend=self.config.backend, codec_dtype=cd,
                    k_alloc=ka, key_fold=1, row=self.rows.row)
                v2s.append(v2)
                i2s.append(i2)
                self.nnz[w] += codec.nnz(i2).to(torch.float32)
            del means
            if self.outer_gtopk:
                sums, drops = _gtopk_reduce_bucket(
                    v2s, i2s, (self.outer_axis,), view, wire, cd)
                self.means[c] = sums[0].div_(self.n_pods)
                for w, drop in enumerate(drops):
                    if drop is not None:
                        self.R2[w][c].add_(drop)
            else:
                self.means[c] = _gather_mean(v2s, i2s, self.outer_axis,
                                             self.n_pods, D, wire,
                                             async_op=True)

    def _allocate(self) -> None:
        """Adaptive density: ONE allocation over every chunk's pass-A
        signals in global segment order, then each chunk's compressions
        (with its budgets and statistics) and wire."""
        segs = self.layout.segments
        sigs, sqs = [], []
        for w in range(len(self.E)):
            moments = [m for c in range(self.plan.n_chunks)
                       for m in self.moments[w][c]]
            sigs.append([adaptk.leaf_signal(self.policy.policy, s.size, *m)
                         for s, m in zip(segs, moments)])
            sqs.append([m[1] for m in moments])
        self.k_alloc, self.K_eff, self.adapt_state = _adaptive_allocation(
            self.adapt_state, sigs, sqs, [s.size for s in segs],
            self.layout.ratio, self.policy, self.step,
            [s.k_lo for s in segs], [s.k_hi for s in segs], self.wire)
        self._note(None, k_alloc=self.k_alloc, K_eff=self.K_eff)
        for c, (grp, view) in enumerate(zip(self.plan.groups, self.views)):
            for w in range(len(self.E)):
                v, i, new_E = bucket_compress(
                    None, self.E[w][c], view, self.spec, self.keys[w],
                    backend=self.config.backend,
                    codec_dtype=self.config.codec_dtype,
                    k_alloc=self.k_alloc[grp.seg_lo:grp.seg_hi],
                    seg_stats=self.stats[w][c], row=self.rows.row)
                self._note(self.wire.ranks[w], chunk=c, G=None, values=v,
                           indices=i, new_E=new_E)
                self.pairs[c][w] = (v, i)
                self.nnz[w] += codec.nnz(i).to(torch.float32)
                self.stats[w][c] = None
            self._wire(c)

    def finish(self, treedef) -> AggregateResult:
        """The step's result once every chunk of every local worker is
        released; ``treedef`` is the gradient tree's structure."""
        missing = [(w, c) for w, got in enumerate(self.got)
                   for c, ok in enumerate(got) if not ok]
        if missing:
            raise ValueError(f"chunks not released (worker, chunk): "
                             f"{missing}")
        if self.policy is not None:
            self._allocate()
        means = [m()[0] if callable(m) else m for m in self.means]
        self.means = None
        leaves = []
        for grp, view, mean in zip(self.plan.groups, self.views, means):
            like = [torch.empty(0, dtype=self.dtypes[j])
                    for j in range(grp.seg_lo, grp.seg_hi)]
            leaves.extend(self.rows.unpack(view, grp.seg_lo, mean, like))
        self._note(None, means=means, resid=self.resid, resid2=self.resid2)
        layout, wire = self.layout, self.wire
        M = layout.model_size
        sparse_bits = layout.comm_bits_sparse(self.strategy, self.world,
                                              self.n_pods,
                                              self.config.codec_dtype)
        metrics = {
            "density": wire.pmean([self.rows.total(x) / layout.d_total
                                   for x in self.nnz], wire.data_axes)[0],
            "density_cap": M * layout.k_cap_total / layout.d_total,
            "comm_bits_sparse": sparse_bits,
            "comm_bits_dense": self.bits_dense,
            "wire_bytes": sparse_bits / 8.0,
            "collectives_per_step": float(self.plan.collectives(
                self.strategy, self.world, self.n_pods)),
        }
        adaptive = self.policy is not None
        if adaptive:
            metrics["k_total"] = float(self.K_eff)
            metrics["density_budget"] = float(np.float32(self.K_eff)
                                              / np.float32(layout.d_total))
        return AggregateResult(tree.unflatten(treedef, leaves), self.resid,
                               self.resid2,
                               self.adapt_state if adaptive else None,
                               metrics)


def _entries(entry):
    """One worker's gradient leaves and tree structure (``entry`` is a
    tree or a callable returning it)."""
    return tree.flatten(entry() if callable(entry) else entry)


def _feed(run: ChunkedAggregation, grads, first=None) -> Any:
    """Release every chunk of every local worker, in worker order (one
    worker's gradients alive at a time; ``first``, when given, a list
    holding worker 0's flattened gradients, emptied here); returns the
    tree structure."""
    td = None
    for w, entry in enumerate(grads):
        leaves, td = first.pop() if w == 0 and first else _entries(entry)
        if len(leaves) != len(run.layout.segments):
            raise ValueError(f"tree has {len(leaves)} leaves, layout has "
                             f"{len(run.layout.segments)} segments")
        for c, grp in enumerate(run.plan.groups):
            run.release(w, c, leaves[grp.seg_lo:grp.seg_hi])
        del leaves
    return td


def flat_windows(resid: torch.Tensor, layout: BucketLayout,
                 plan: ChunkPlan, workers: int, held=None) -> list:
    """Per local worker, each chunk group's ``(model_size, d_row)``
    window of a ``(workers, flat)`` (or ``(flat,)``) residual: views
    (``(held, d_row)`` when the residual holds ``held`` rows)."""
    rows = _rows(resid, layout, workers, held)
    return [[rows[w][:, g.row_off:g.row_off + g.d_row] for g in plan.groups]
            for w in range(workers)]


def aggregate_bucketed_chunked(grads, resid: torch.Tensor,
                               layout: BucketLayout, plan: ChunkPlan,
                               config: CompressionConfig, *, wire=None,
                               resid2: Optional[torch.Tensor] = None,
                               probe: Optional[Callable] = None,
                               adapt_state=None, step=None,
                               keys=None, rows: Optional[AllRows] = None
                               ) -> AggregateResult:
    """:func:`aggregate_bucketed` dispatched as ``plan.n_chunks``
    compress + wire chains, one a chunk group of ``plan`` (which must
    tile ``layout``): the same arguments and bitwise the same results for
    any plan; ``metrics["collectives_per_step"]`` is
    ``plan.collectives(...)``.  ``rows``: :class:`ChunkedAggregation`'s.  The gradients are released here chunk
    after chunk, worker by worker; the train step releases them during
    the backward instead (:class:`ChunkedAggregation`)."""
    grads, wire = _workers_and_wire(grads, wire)
    workers = len(grads)
    rows = ALL_ROWS if rows is None else rows
    held = rows.held(layout)
    run = ChunkedAggregation(
        layout, plan, config, wire=wire,
        E=flat_windows(resid, layout, plan, workers, held),
        R2=(None if resid2 is None
            else flat_windows(resid2, layout, plan, workers, held)),
        probe=probe, adapt_state=adapt_state, step=step, keys=keys,
        resid=resid, resid2=resid2, rows=rows)
    return run.finish(_feed(run, grads))


def init_residuals(params, model_size: int, dtype=torch.float32,
                   workers: Optional[int] = None, rows: Optional[int] = None,
                   device=None):
    """Zero per-leaf error-feedback residuals on the params' device (or
    ``device``): one flat-padded ``(d_pad,)`` vector a leaf (``d_pad =
    ceil(size / model_size) * model_size``), or ``(workers, d_pad)`` with
    one row a worker.  ``rows`` holds that many of each leaf's
    ``model_size`` rows (``rows · d_row`` a worker; a tensor-parallel
    rank's one, ``params`` then the whole params' shapes).  The bucketed
    pipeline keeps the same values in one flat buffer
    (``layout.init_flat_residual``)."""
    def zero(p):
        d_pad, d_row = flat_dims(int(p.numel()), model_size)
        n = d_pad if rows is None else rows * d_row
        shape = (n,) if workers is None else (workers, n)
        return torch.zeros(shape, dtype=dtype,
                           device=p.device if device is None else device)

    return tree.tree_map(zero, params)


def leaf_windows(resid, layout: BucketLayout, workers: int,
                 held: Optional[int] = None) -> list:
    """Per local worker, each leaf's ``(model_size, d_row)`` rows of a
    per-leaf residual tree (``(workers, d_pad)`` leaves, or ``(d_pad,)``
    for one worker): views (``(held, d_row)`` when the residual holds
    ``held`` rows of each leaf)."""
    held = layout.model_size if held is None else held
    leaves = tree.leaves(resid)
    if len(leaves) != len(layout.segments):
        raise ValueError(f"residual tree has {len(leaves)} leaves, the "
                         f"gradients {len(layout.segments)}")
    out = []
    for w in range(workers):
        row = []
        for s, e in zip(layout.segments, leaves):
            if e.dim() == 1 and workers != 1:
                raise ValueError(f"a (d_pad,) residual holds one worker, "
                                 f"the wire runs {workers} here")
            e = e if e.dim() == 1 else e[w]
            if e.shape != (held * s.d_row,):
                raise ValueError(f"leaf {s.name!r}: residual rows of shape "
                                 f"{tuple(e.shape)}, expected "
                                 f"({held * s.d_row},)")
            row.append(e.view(held, s.d_row))
        out.append(row)
    return out


def aggregate_compressed(grads, resid, config: CompressionConfig, *,
                         model_size: int = 1, wire=None, resid2=None,
                         probe: Optional[Callable] = None, adapt_state=None,
                         step=None, keys=None,
                         layout: Optional[BucketLayout] = None,
                         rows: Optional[AllRows] = None) -> AggregateResult:
    """Eq. (2) sparse aggregation, one compress + wire chain per gradient
    leaf (the per-leaf loop; :func:`aggregate_bucketed` sends one).

    ``grads`` as :func:`aggregate_bucketed`'s; ``resid`` (and ``resid2``)
    are per-leaf residual trees of ``(workers, d_pad)`` leaves (or
    ``(d_pad,)`` for one worker, :func:`init_residuals`), updated in
    place.  Each leaf is compressed with its own plan, keyed with its
    salt (``layout.leaf_key_salt`` of its path), and sent on its own
    wire: bitwise the bucketed results, with
    ``metrics["collectives_per_step"]`` L a wire level.  The leaves run
    as the one-segment chunks of :class:`ChunkedAggregation`.  The
    leaves' geometry is the layout of the gradients' shapes at
    ``model_size`` unless ``layout`` (built from the same config) is
    given: a tensor-parallel rank's gradients are shards, so it passes
    the whole params' layout and its ``rows`` (``ModelRow``; the
    residual leaves then hold its one row, ``(workers, d_row)``)."""
    grads, wire = _workers_and_wire(grads, wire)
    workers = len(grads)
    first = [_entries(grads[0])]
    if layout is None:
        layout = build_layout(tree.unflatten(first[0][1], first[0][0]),
                              model_size, config)
    plan = build_chunk_plan(layout, len(layout.segments))
    held = None if rows is None else rows.held(layout)
    run = ChunkedAggregation(
        layout, plan, config, wire=wire,
        E=leaf_windows(resid, layout, workers, held),
        R2=None if resid2 is None else leaf_windows(resid2, layout,
                                                    workers, held),
        probe=probe, adapt_state=adapt_state, step=step, keys=keys,
        resid=resid, resid2=resid2, rows=rows)
    return run.finish(_feed(run, grads, first))
