"""Eq. (2) sparse aggregation over the flat bucket (port of
``repro/dist/aggregate.py``: ``AggregateResult``, ``bucket_compress``
fixed-k with its fused and reference branches, ``_gather_mean``,
``aggregate_dense``, ``aggregate_bucketed`` for ``allgather``).

This slice runs at world size 1: the all-gather of the one wire block
is the identity and ``_gather_mean`` decodes the local pair and divides
by 1.  Its signature already takes the world size and the wire block, so
the multi-GPU slice plugs an NCCL ``all_gather_into_tensor`` in front of
the decode.

Memory: the new residual overwrites the residual bucket in place — the
reference's ``new_E`` without a second 6 GB buffer on llama3.2-1b.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import codec
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.compressors import CompressorSpec
from repro_torch.core.error_feedback import resolve_backend
from repro_torch.dist.layout import BucketLayout, pack_grads, unpack_tree
from repro_torch.kernels.ef_fused.segmented import segmented_compress_ef
from repro_torch.slices import not_ported


class AggregateResult(NamedTuple):
    """``agg`` averaged gradient tree; ``resid`` new flat residual;
    ``resid2`` second-level residual (None in this slice);
    ``adapt_state`` adaptive controller state (None); ``metrics``."""
    agg: Any
    resid: Any
    resid2: Any
    adapt_state: Any
    metrics: dict


def aggregate_dense(grads, world: int = 1):
    """Dense-SGD baseline: the mean over the workers (world 1: identity)."""
    if world != 1:
        raise not_ported("dense all-reduce over several cards", "world")
    return grads


def _compress_rows_reference(g_rows, e_rows, spec: CompressorSpec,
                             k_row: int):
    """Reference branch: ``u = e + g``, the registry select per row,
    ``e' = u - decode``."""
    u_rows = e_rows + g_rows
    d_row = u_rows.shape[1]
    pairs = [spec.select(u_rows[r], k_row, None)
             for r in range(u_rows.shape[0])]
    values = torch.stack([p[0] for p in pairs])
    indices = torch.stack([p[1] for p in pairs])
    decoded = torch.stack([codec.decode(values[r], indices[r], d_row)
                           for r in range(u_rows.shape[0])])
    return values, indices, u_rows - decoded


def bucket_compress(G: torch.Tensor, E: torch.Tensor, layout: BucketLayout,
                    spec: CompressorSpec, *, backend: str = "auto"):
    """Worker-local EF compression of the packed bucket, fixed-k.

    ``G``/``E`` are ``(model_size, d_row_total)`` buckets; returns
    ``(values, indices, new_E)`` with ONE ``(model_size, k_cap_total)``
    codec pair whose indices are bucket-global.  Selection runs per leaf
    segment with the segment's own plan.  ``new_E`` IS ``E``, overwritten
    in place.  (The reference's key, momentum-correction and dynamic-k
    arguments arrive with the slices that port them.)"""
    segs = layout.segments
    vals, idcs, new_e_blocks = [], [], []
    if resolve_backend(backend, spec):
        triples = segmented_compress_ef(
            G, E, [(s.row_off, s.d_row) for s in segs], spec.name,
            [s.k_row for s in segs], [s.k_cap for s in segs])
        for s, (v, i, ne) in zip(segs, triples):
            vals.append(v)
            idcs.append(codec.offset_indices(i, s.row_off))
            new_e_blocks.append(ne)
    else:
        for s in segs:
            cols = slice(s.row_off, s.row_off + s.d_row)
            v, i, ne = _compress_rows_reference(G[:, cols], E[:, cols], spec,
                                                s.k_row)
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


def _gather_mean(values: torch.Tensor, indices: torch.Tensor, world: int,
                 d_row: int, dtype=torch.float32) -> torch.Tensor:
    """All-gather the ``(model_size, k_cap_total)`` pairs of ``world``
    workers and decode-average them into ``(model_size, d_row)``.  At
    world 1 the gather is the identity and the mean is the decoded local
    pair: dividing by 1 is exact, so that 6 GB pass is not made."""
    if world != 1:
        raise not_ported("the sparse all-gather over several cards",
                         "world")
    rows = [codec.decode(values[r].to(dtype), indices[r], d_row)
            for r in range(values.shape[0])]
    return torch.stack(rows) if len(rows) > 1 else rows[0][None]


def aggregate_bucketed(grads, resid: torch.Tensor, layout: BucketLayout,
                       config: CompressionConfig, *, world: int = 1,
                       probe: Optional[Callable] = None) -> AggregateResult:
    """Eq. (2) sparse aggregation over the bucketed pipeline.

    ``resid`` is the flat ``(model_size * d_row_total,)`` residual;
    returns an :class:`AggregateResult` whose ``agg`` leaves are views
    into the decoded mean bucket (model_size 1).  The new residual
    overwrites ``resid`` in place.  ``probe``, when given, is called
    as ``probe(G, values, indices, mean, new_E)`` before returning — a
    hook for checks such as bucket conservation."""
    config.require_slice1()
    spec = config.spec
    if layout.spec_name != spec.name:
        raise ValueError(f"layout was built for compressor "
                         f"{layout.spec_name!r}, got {spec.name!r}")
    if layout.adaptive:
        raise not_ported("an adaptive-density layout", "density_policy")
    M, D = layout.model_size, layout.d_row_total
    G = pack_grads(layout, grads, resid.dtype)
    E = resid.view(M, D)
    values, indices, new_E = bucket_compress(
        G, E, layout, spec, backend=config.backend)
    nnz_local = codec.nnz(indices).to(torch.float32)
    mean = _gather_mean(values, indices, world, D, torch.float32)
    if probe is not None:
        probe(G, values, indices, mean, new_E)
    del G
    agg = unpack_tree(layout, mean, like=grads)
    sparse_bits = layout.comm_bits_sparse(config.strategy, world)
    metrics = {
        "density": nnz_local / layout.d_total,
        "density_cap": M * layout.k_cap_total / layout.d_total,
        "comm_bits_sparse": sparse_bits,
        "comm_bits_dense": layout.comm_bits_dense(),
        "wire_bytes": sparse_bits / 8.0,
        "collectives_per_step": float(layout.collectives(config.strategy,
                                                         world)),
    }
    return AggregateResult(agg, new_E.reshape(-1), None, None, metrics)
