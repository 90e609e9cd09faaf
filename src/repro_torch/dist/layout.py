"""Flat bucketed gradient layout — one wire message per step (port of
``repro/dist/layout.py``: ``build_layout`` fixed-k and adaptive,
``rebudget_layout``, ``leaf_plan``, ``leaf_plan_adaptive``, ``LeafSegment``,
``BucketLayout`` and its accounting, the wire model
``strategy_wire_pairs`` / ``collective_count`` / ``resolve_strategy``,
``pack_grads``, ``unpack_tree``, ``init_flat_residual``,
``pack_residual_arrays`` / ``unpack_residual_arrays``,
``leaf_key_salt``, and the chunked schedule's ``ChunkGroup`` /
``ChunkPlan`` / ``build_chunk_plan`` / ``validate_chunk_plan`` /
``chunk_view``).

Every leaf's zero-padded ``(model_size, d_row)`` rows occupy a static
column range ``[row_off, row_off + d_row)`` of one ``(model_size,
d_row_total)`` gradient/residual bucket, and its codec pair the range
``[cap_off, cap_off + k_cap)`` of one ``(model_size, k_cap_total)`` wire
block.  Segment order is the JAX flatten order (``repro_torch.tree``,
dict keys sorted); names are '/'-joined paths; ``k = ceil(ratio·size)``
is taken per WHOLE leaf, so the scan-stacked ``(L, ...)`` leaves keep
the reference's per-leaf budget.

Bucket-global wire indices are int32, so ``d_row_total`` must stay below
``2**31``; llama3.2-1b's bucket is 1,498,482,688 columns.
"""
from __future__ import annotations

import hashlib
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch import tree
from repro_torch.core import adaptk
from repro_torch.core.compression import STRATEGIES, CompressionConfig
from repro_torch.core.compressors import CompressorSpec
from repro_torch.devices import resolve_device

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _itemsize(name: str) -> int:
    return _ITEMSIZE.get(name, torch.empty((), dtype=getattr(
        torch, name)).element_size())


def _log2_exact(n: int, what: str = "world size") -> int:
    """log2 of a power of two; raises for anything else (the XOR pairing
    of the recursive-doubling tree needs exact halving at every round)."""
    if n < 1 or n & (n - 1):
        raise ValueError(
            f"gtopk strategy needs a power-of-two {what}, got {n}; "
            "use strategy='allgather' on ragged meshes")
    return n.bit_length() - 1


def resolve_strategy(strategy: str, hierarchical: bool = False) -> str:
    """Fold the ``--hierarchical`` flag into the strategy vocabulary: it
    promotes the default ``"allgather"`` only — an explicitly chosen
    strategy wins.  Raises on unknown strategies."""
    if hierarchical and strategy == "allgather":
        strategy = "hierarchical"
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; have {STRATEGIES}")
    return strategy


def strategy_wire_pairs(strategy: str, world: int, n_pods: int = 1) -> int:
    """Number of ``(k_cap,)`` codec pairs a worker moves per wire row:

      allgather     ``W``
      hierarchical  ``W_inner + P_pod`` (pod gather + pod-mean gather)
      gtopk         ``log2(W)``         (one pair sent per round)
      hier_gtopk    ``W_inner + log2(P_pod)``
    """
    if strategy == "gtopk":
        return _log2_exact(world)
    if strategy == "hierarchical":
        return max(1, world // n_pods) + n_pods
    if strategy == "hier_gtopk":
        return max(1, world // n_pods) + _log2_exact(n_pods,
                                                     "pod-axis size")
    if strategy == "allgather":
        return world
    raise ValueError(f"unknown strategy {strategy!r}; have {STRATEGIES}")


def collective_count(strategy: str, world: int, n_pods: int = 1,
                     leaves: int = 1) -> int:
    """Codec-pair collectives per step: one per wire level for the
    gathers, one per round for gTop-k; ``leaves`` models the per-leaf
    loop (the bucketed pipeline is ``leaves=1``)."""
    if strategy == "gtopk":
        return leaves * _log2_exact(world)
    if strategy == "hierarchical":
        return leaves * 2
    if strategy == "hier_gtopk":
        return leaves * (1 + _log2_exact(n_pods, "pod-axis size"))
    if strategy == "allgather":
        return leaves
    raise ValueError(f"unknown strategy {strategy!r}; have {STRATEGIES}")


def flat_dims(size: int, model_size: int) -> Tuple[int, int]:
    """(padded flat length, per-model-shard row length) for a leaf."""
    d_pad = -(-size // model_size) * model_size
    return d_pad, d_pad // model_size


def row_budget(k: int, model_size: int, d_row: int) -> int:
    """Per-row share ``ceil(k / model_size)`` clamped to ``[1, d_row]``."""
    return min(d_row, max(1, -(-k // model_size)))


def leaf_plan(size: int, model_size: int, ratio: float,
              spec: CompressorSpec) -> Tuple[int, int, int, int]:
    """(d_pad, d_row, k_row, k_cap_row) for one leaf."""
    d_pad, d_row = flat_dims(size, model_size)
    k = max(1, math.ceil(ratio * size))
    k_row = row_budget(k, model_size, d_row)
    k_cap = min(d_row, spec.k_cap(k_row, d_row))
    return d_pad, d_row, k_row, k_cap


def leaf_plan_adaptive(size: int, model_size: int, ratio: float,
                       spec: CompressorSpec, policy: adaptk.DensityPolicy):
    """(d_pad, d_row, k_lo, k_hi, k_cap_row) for one leaf under an
    adaptive density policy: the allocator's leaf-level clamps and the
    codec row capacity sized from the ceiling ``k_hi``, so the per-step
    ``k`` moves anywhere inside the clamp with no shape change."""
    d_pad, d_row = flat_dims(size, model_size)
    k_lo, k_hi = adaptk.leaf_bounds(size, ratio, policy)
    k_cap = min(d_row, spec.k_cap(row_budget(k_hi, model_size, d_row),
                                  d_row))
    return d_pad, d_row, k_lo, k_hi, k_cap


def leaf_path_name(path) -> str:
    return tree.path_name(path)


def leaf_key_salt(name: str) -> int:
    """Stable 31-bit salt of a leaf-path name (blake2s, as the reference)."""
    digest = hashlib.blake2s(name.encode(), digest_size=4).digest()
    return int.from_bytes(digest, "big") & 0x7FFFFFFF


class LeafSegment(NamedTuple):
    """Static geometry of one gradient leaf inside the bucket."""
    name: str
    shape: Tuple[int, ...]
    dtype: str
    size: int
    d_pad: int
    d_row: int
    row_off: int
    k_row: int
    k_cap: int
    cap_off: int
    k_lo: int
    k_hi: int
    salt: int


class BucketLayout(NamedTuple):
    """Static bucket geometry for one (params, model_size, ratio, spec)."""
    segments: Tuple[LeafSegment, ...]
    model_size: int
    ratio: float
    spec_name: str
    adaptive: bool
    d_row_total: int
    k_cap_total: int

    @property
    def d_total(self) -> int:
        return sum(s.size for s in self.segments)

    @property
    def flat_size(self) -> int:
        return self.model_size * self.d_row_total

    def pair_bits(self, codec_dtype=None) -> int:
        """Wire bits of ONE bucketed codec pair (all leaves, all rows):
        ``codec_dtype`` values (f32 by default) + int32 indices."""
        val_bits = (_itemsize(_dtype_name(codec_dtype)) * 8 if codec_dtype
                    else 32)
        return self.model_size * self.k_cap_total * (val_bits + 32)

    def comm_bits_sparse(self, strategy: str, world: int, n_pods: int = 1,
                         codec_dtype=None) -> float:
        levels = strategy_wire_pairs(strategy, world, n_pods)
        return float(levels * self.pair_bits(codec_dtype))

    def comm_bits_dense(self) -> float:
        """Dense ring-all-reduce baseline (2·d per worker) in bits, from
        the dtypes frozen into the layout."""
        return float(sum(2 * s.size * _itemsize(s.dtype) * 8
                         for s in self.segments))

    def collectives(self, strategy: str, world: int, n_pods: int = 1) -> int:
        return collective_count(strategy, world, n_pods, leaves=1)


def build_layout(params, model_size: int, ratio,
                 spec: Optional[CompressorSpec] = None,
                 density_policy=None) -> BucketLayout:
    """The static bucket geometry of a param/grad tree.

    ``ratio`` is the density or a :class:`CompressionConfig` supplying
    ratio, spec and density policy.  With a ``density_policy`` (a
    :class:`~repro_torch.core.adaptk.DensityPolicy`) each segment's
    ``k_lo``/``k_hi`` are the allocator's clamps and ``k_row``/``k_cap``
    come from the ceiling; the layout is ``adaptive``.  Raises on a salt
    collision and on a bucket too wide for int32 indices."""
    if isinstance(ratio, CompressionConfig):
        if spec is not None or density_policy is not None:
            raise TypeError("build_layout: pass EITHER a CompressionConfig "
                            "OR (ratio, spec, density_policy), not both")
        cfg = ratio
        if cfg.dense:
            raise ValueError("cannot build a BucketLayout for Dense-SGD "
                             "(compressor='none')")
        ratio, spec, density_policy = cfg.ratio, cfg.spec, cfg.density_policy
    elif spec is None:
        raise TypeError("build_layout needs a CompressorSpec when called "
                        "with a plain ratio")
    leaves, _ = tree.flatten_with_path(params)
    if not leaves:
        raise ValueError("cannot build a BucketLayout over an empty tree")
    segments = []
    row_off = cap_off = 0
    seen_salts = {}
    for path, leaf in leaves:
        name = leaf_path_name(path)
        size = int(leaf.numel())
        if density_policy is not None:
            d_pad, d_row, k_lo, k_hi, k_cap = leaf_plan_adaptive(
                size, model_size, ratio, spec, density_policy)
            k_row = row_budget(k_hi, model_size, d_row)
        else:
            d_pad, d_row, k_row, k_cap = leaf_plan(size, model_size, ratio,
                                                   spec)
            k_lo = k_hi = max(1, math.ceil(ratio * size))
        salt = leaf_key_salt(name)
        if salt in seen_salts:
            raise ValueError(
                f"leaf-path salt collision: {name!r} and "
                f"{seen_salts[salt]!r} both hash to {salt}")
        seen_salts[salt] = name
        segments.append(LeafSegment(
            name=name, shape=tuple(leaf.shape),
            dtype=_dtype_name(leaf.dtype), size=size, d_pad=d_pad,
            d_row=d_row, row_off=row_off, k_row=k_row, k_cap=k_cap,
            cap_off=cap_off, k_lo=int(k_lo), k_hi=int(k_hi), salt=salt))
        row_off += d_row
        cap_off += k_cap
    if row_off >= 2 ** 31:
        raise ValueError(f"bucket of {row_off} columns overflows the int32 "
                         "wire indices")
    return BucketLayout(segments=tuple(segments), model_size=model_size,
                        ratio=float(ratio), spec_name=spec.name,
                        adaptive=density_policy is not None,
                        d_row_total=row_off,
                        k_cap_total=cap_off)


def rebudget_layout(layout: BucketLayout, ratio: float,
                    spec: CompressorSpec) -> BucketLayout:
    """The same bucket re-budgeted at another ``(ratio, spec)``: the
    serve publisher's delta layout.  Row geometry (``d_row``,
    ``row_off``, names, salts, segment order) depends only on the leaf
    sizes and ``model_size`` and is carried over, so a bucket packed
    under ``layout`` is one under the new layout too; ``k_row``,
    ``k_cap`` and ``cap_off`` are recomputed fixed-k (the publisher never
    runs adaptive density).  Takes a plain ratio only, as the
    reference."""
    if isinstance(ratio, CompressionConfig):
        raise TypeError("rebudget_layout takes a plain ratio + spec "
                        "(build_layout accepts the config spelling)")
    segments, cap_off = [], 0
    for s in layout.segments:
        k = max(1, math.ceil(ratio * s.size))
        k_row = row_budget(k, layout.model_size, s.d_row)
        k_cap = min(s.d_row, spec.k_cap(k_row, s.d_row))
        segments.append(s._replace(k_row=k_row, k_cap=k_cap,
                                   cap_off=cap_off, k_lo=k, k_hi=k))
        cap_off += k_cap
    return BucketLayout(segments=tuple(segments),
                        model_size=layout.model_size, ratio=float(ratio),
                        spec_name=spec.name, adaptive=False,
                        d_row_total=layout.d_row_total, k_cap_total=cap_off)


def pack_grads(layout: BucketLayout, grads, dtype) -> torch.Tensor:
    """Pack a gradient tree into a new ``(model_size, d_row_total)``
    bucket: each leaf flattened, zero-padded to ``d_pad``, cast to
    ``dtype`` and copied into its row block."""
    leaves = tree.leaves(grads)
    if len(leaves) != len(layout.segments):
        raise ValueError(f"tree has {len(leaves)} leaves, layout has "
                         f"{len(layout.segments)} segments")
    M = layout.model_size
    bucket = torch.empty((M, layout.d_row_total), dtype=dtype,
                         device=leaves[0].device)
    for seg, g in zip(layout.segments, leaves):
        if int(g.numel()) != seg.size:
            raise ValueError(f"leaf {seg.name!r}: size {g.numel()} != "
                             f"layout size {seg.size}")
        dst = bucket[:, seg.row_off:seg.row_off + seg.d_row]
        flat = g.reshape(-1)
        if seg.d_pad != seg.size:
            flat = torch.nn.functional.pad(flat, (0, seg.d_pad - seg.size))
        dst.copy_(flat.view(M, seg.d_row))
    return bucket


def unpack_tree(layout: BucketLayout, bucket: torch.Tensor, *, like):
    """Slice the ``(model_size, d_row_total)`` bucket back into the leaf
    tree of ``like``, in ``like``'s dtypes.  With ``model_size == 1`` and
    matching dtypes each leaf is a VIEW into the bucket (no copy)."""
    like_leaves, treedef = tree.flatten(like)
    out = []
    for seg, ref in zip(layout.segments, like_leaves):
        block = bucket[:, seg.row_off:seg.row_off + seg.d_row]
        flat = block[0] if layout.model_size == 1 else block.reshape(-1)
        out.append(flat[:seg.size].view(seg.shape).to(ref.dtype))
    return tree.unflatten(treedef, out)


# ---------------------------------------------------------------------------
# the chunked schedule's geometry
# ---------------------------------------------------------------------------


class ChunkGroup(NamedTuple):
    """One contiguous run ``[seg_lo, seg_hi)`` of the layout's segments:
    its column window ``[row_off, row_off + d_row)`` of the bucket and
    ``[cap_off, cap_off + k_cap)`` of the wire block."""
    index: int
    seg_lo: int
    seg_hi: int
    row_off: int
    d_row: int
    cap_off: int
    k_cap: int


class ChunkPlan(NamedTuple):
    """The layout cut into ``n_chunks`` leaf-aligned groups.  A cut never
    splits a segment (selection, keys and the codec's index space are
    per segment), so each segment computes what it computes unchunked;
    only the wire's dispatch changes.  ``n_chunks`` is clamped to the
    segment count; ``requested`` is the caller's ask."""
    n_chunks: int
    requested: int
    groups: Tuple[ChunkGroup, ...]

    def collectives(self, strategy: str, world: int, n_pods: int = 1) -> int:
        """Codec-pair collectives a step: the unchunked count per chunk."""
        return self.n_chunks * collective_count(strategy, world, n_pods,
                                                leaves=1)


def build_chunk_plan(layout: BucketLayout, n_chunks: int) -> ChunkPlan:
    """Cut the layout's segments into ``n_chunks`` contiguous groups of
    about equal bucket width: boundary ``j`` falls on the first segment
    whose cumulative ``d_row`` reaches ``j/n`` of the total, leaving a
    segment for every later group.  ``n_chunks`` is clamped to the
    segment count; 1 is the unchunked schedule."""
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    segs = layout.segments
    n = min(int(n_chunks), len(segs))
    cums, tot = [], 0
    for s in segs:
        tot += s.d_row
        cums.append(tot)
    bounds = [0]
    for j in range(1, n):
        target = j * tot / n
        lo, hi = bounds[-1] + 1, len(segs) - (n - j)
        cut = hi
        for i in range(lo, hi + 1):
            if cums[i - 1] >= target:
                cut = i
                break
        bounds.append(cut)
    bounds.append(len(segs))
    groups = []
    for c in range(n):
        first, last = segs[bounds[c]], segs[bounds[c + 1] - 1]
        groups.append(ChunkGroup(
            index=c, seg_lo=bounds[c], seg_hi=bounds[c + 1],
            row_off=first.row_off,
            d_row=last.row_off + last.d_row - first.row_off,
            cap_off=first.cap_off,
            k_cap=last.cap_off + last.k_cap - first.cap_off))
    return ChunkPlan(n_chunks=n, requested=int(n_chunks),
                     groups=tuple(groups))


def validate_chunk_plan(layout: BucketLayout, plan: ChunkPlan) -> None:
    """Raise unless ``plan`` tiles ``layout`` exactly: a plan of another
    layout would put the chunks' residual windows in the wrong place."""
    if not plan.groups or plan.n_chunks != len(plan.groups):
        raise ValueError(f"malformed ChunkPlan: n_chunks={plan.n_chunks}, "
                         f"{len(plan.groups)} groups")
    seg, row, cap = 0, 0, 0
    for g in plan.groups:
        if (g.seg_lo, g.row_off, g.cap_off) != (seg, row, cap):
            raise ValueError(
                f"chunk {g.index} starts at (seg={g.seg_lo}, "
                f"row={g.row_off}, cap={g.cap_off}), expected "
                f"({seg}, {row}, {cap}) — plan does not tile this layout")
        if g.seg_hi <= g.seg_lo:
            raise ValueError(f"chunk {g.index} is empty")
        seg, row, cap = g.seg_hi, g.row_off + g.d_row, g.cap_off + g.k_cap
    if (seg, row, cap) != (len(layout.segments), layout.d_row_total,
                           layout.k_cap_total):
        raise ValueError(
            f"plan covers (seg={seg}, row={row}, cap={cap}) but layout "
            f"has ({len(layout.segments)}, {layout.d_row_total}, "
            f"{layout.k_cap_total}) — plan built from a different layout?")


def chunk_view(layout: BucketLayout, group: ChunkGroup) -> BucketLayout:
    """The group's window as a layout of its own: its segments keep their
    names, salts, plans and order, with ``row_off``/``cap_off`` rebased
    to the window.  Every bucketed primitive works segment by segment
    over ``[row_off, row_off + d_row)``, so running it on the view over
    the window gives the bits of the same columns of the whole bucket."""
    segs = tuple(
        s._replace(row_off=s.row_off - group.row_off,
                   cap_off=s.cap_off - group.cap_off)
        for s in layout.segments[group.seg_lo:group.seg_hi])
    return BucketLayout(segments=segs, model_size=layout.model_size,
                        ratio=layout.ratio, spec_name=layout.spec_name,
                        adaptive=layout.adaptive,
                        d_row_total=group.d_row, k_cap_total=group.k_cap)


def init_flat_residual(layout: BucketLayout, dtype=torch.float32,
                       device="cuda", workers: Optional[int] = None,
                       rows: Optional[int] = None) -> torch.Tensor:
    """Zero flat residual bucket, ``(model_size * d_row_total,)`` — or
    ``(workers, model_size * d_row_total)``, one row per worker — on
    ``device`` (the card unless told ``"cpu"``; raises without a GPU).
    ``rows`` (default ``model_size``) is the number of the bucket's rows
    held: a tensor-parallel rank holds 1."""
    flat = (layout.model_size if rows is None else rows) * layout.d_row_total
    shape = (flat,) if workers is None else (workers, flat)
    return torch.zeros(shape, dtype=dtype, device=resolve_device(device))


def pack_residual_arrays(layout: BucketLayout, arrays: Sequence):
    """Pack per-leaf flat-padded residual arrays (numpy, each ``(...,
    d_pad)``, segment order, any leading dims such as the worker axis)
    into the flat bucket ``(..., model_size * d_row_total)``.  Raises on
    count or shape mismatches."""
    import numpy as np
    if len(arrays) != len(layout.segments):
        raise ValueError(f"got {len(arrays)} residual arrays for "
                         f"{len(layout.segments)} layout segments")
    blocks, lead = [], None
    for seg, a in zip(layout.segments, arrays):
        a = np.asarray(a)
        if a.ndim < 1 or a.shape[-1] != seg.d_pad:
            raise ValueError(
                f"segment {seg.name!r}: residual shape {a.shape} does not "
                f"end in d_pad={seg.d_pad}")
        if lead is None:
            lead = a.shape[:-1]
        elif a.shape[:-1] != lead:
            raise ValueError(
                f"segment {seg.name!r}: leading dims {a.shape[:-1]} != "
                f"{lead} of earlier segments")
        blocks.append(a.reshape(lead + (layout.model_size, seg.d_row)))
    packed = np.concatenate(blocks, axis=-1)
    return packed.reshape(lead + (layout.flat_size,))


def unpack_residual_arrays(layout: BucketLayout, flat):
    """Inverse of :func:`pack_residual_arrays`: the flat bucket back into
    per-leaf ``(..., d_pad)`` numpy arrays in segment order."""
    import numpy as np
    flat = np.asarray(flat)
    if flat.shape[-1] != layout.flat_size:
        raise ValueError(f"flat residual has trailing dim {flat.shape[-1]}, "
                         f"layout expects {layout.flat_size}")
    lead = flat.shape[:-1]
    rows = flat.reshape(lead + (layout.model_size, layout.d_row_total))
    return [rows[..., seg.row_off:seg.row_off + seg.d_row].reshape(
        lead + (seg.d_pad,)) for seg in layout.segments]
