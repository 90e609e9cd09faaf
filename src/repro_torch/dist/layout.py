"""Flat bucketed gradient layout — one wire message per step (port of
``repro/dist/layout.py``: ``build_layout`` fixed-k, ``LeafSegment``,
``BucketLayout`` and its accounting, ``pack_grads``, ``unpack_tree``,
``init_flat_residual``, ``leaf_key_salt``).

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
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.core.compression import CompressionConfig, STRATEGIES
from repro_torch.core.compressors import CompressorSpec
from repro_torch.devices import resolve_device
from repro_torch.slices import not_ported

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _itemsize(name: str) -> int:
    return _ITEMSIZE.get(name, torch.empty((), dtype=getattr(
        torch, name)).element_size())


def _allgather_only(strategy: str) -> None:
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; have {STRATEGIES}")
    if strategy != "allgather":
        raise not_ported(f"the wire accounting of {strategy!r}", strategy)


def strategy_wire_pairs(strategy: str, world: int) -> int:
    """Number of ``(k_cap,)`` codec pairs a worker moves per wire row:
    one per worker under ``allgather``."""
    _allgather_only(strategy)
    return world


def collective_count(strategy: str, world: int) -> int:
    """Codec-pair collectives the bucketed pipeline dispatches per step:
    one all-gather."""
    _allgather_only(strategy)
    return 1


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

    def pair_bits(self) -> int:
        """Bits of one wire pair block: f32 values + int32 indices."""
        return self.model_size * self.k_cap_total * (32 + 32)

    def comm_bits_sparse(self, strategy: str, world: int) -> float:
        levels = strategy_wire_pairs(strategy, world)
        return float(levels * self.pair_bits())

    def comm_bits_dense(self) -> float:
        return float(sum(2 * s.size * _itemsize(s.dtype) * 8
                         for s in self.segments))

    def collectives(self, strategy: str, world: int) -> int:
        return collective_count(strategy, world)


def build_layout(params, model_size: int, ratio,
                 spec: Optional[CompressorSpec] = None,
                 density_policy=None) -> BucketLayout:
    """The static bucket geometry of a param/grad tree, fixed-k.

    ``ratio`` is the density or a :class:`CompressionConfig` supplying
    ratio, spec and density policy.  Raises on a salt collision and on a
    bucket too wide for int32 indices."""
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
    if density_policy is not None:
        raise not_ported("an adaptive-density layout", "density_policy")
    leaves, _ = tree.flatten_with_path(params)
    if not leaves:
        raise ValueError("cannot build a BucketLayout over an empty tree")
    segments = []
    row_off = cap_off = 0
    seen_salts = {}
    for path, leaf in leaves:
        name = leaf_path_name(path)
        size = int(leaf.numel())
        d_pad, d_row, k_row, k_cap = leaf_plan(size, model_size, ratio, spec)
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
                        adaptive=False, d_row_total=row_off,
                        k_cap_total=cap_off)


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


def init_flat_residual(layout: BucketLayout, dtype=torch.float32,
                       device="cuda") -> torch.Tensor:
    """Zero flat residual bucket, ``(model_size * d_row_total,)``, on
    ``device`` (the card unless told ``"cpu"``; raises without a GPU)."""
    return torch.zeros((layout.flat_size,), dtype=dtype,
                       device=resolve_device(device))
