"""Segment-aware fused pipeline over a packed bucket (port of
``repro/kernels/ef_fused/segmented.py``: ``rows_compress_ef``,
``segmented_compress_ef``).

The bucketed aggregation packs every gradient leaf's ``(model_size,
d_row)`` rows into one ``(model_size, d_row_total)`` bucket.  Each
column segment runs :func:`~repro_torch.kernels.ef_fused.ops.
fused_compress_ef` per row with its OWN block configuration, so every
row is bit-identical to the per-leaf pipeline on the same values.  A
row of a segment is a contiguous view into the bucket: the kernels read
it and write the new residual into the residual bucket in place, with no
pad or copy.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels.ef_fused.ops import fused_compress_ef


def rows_compress_ef(g_rows: torch.Tensor, e_rows: torch.Tensor, name: str,
                     k, *, k_cap: int, out_rows: torch.Tensor):
    """Fused EF compression of one ``(model_size, d_row)`` row block:
    ``(values (M, k_cap), indices (M, k_cap), out_rows)``, the new
    residual rows written into ``out_rows`` (may be ``e_rows``)."""
    outs = [fused_compress_ef(g_rows[r], e_rows[r], name, k, k_cap=k_cap,
                              out=out_rows[r])
            for r in range(g_rows.shape[0])]
    values = torch.stack([o[0] for o in outs])
    indices = torch.stack([o[1] for o in outs])
    return values, indices, out_rows


def segmented_compress_ef(g2d: torch.Tensor, e2d: torch.Tensor,
                          segments: Sequence[Tuple[int, int]], name: str,
                          ks: Sequence, k_caps: Sequence[int]):
    """Fused threshold-compact + residual write over the bucket, one
    ``(start, length)`` column segment at a time with its own budget
    ``ks[i]`` and capacity ``k_caps[i]``.  The new residual overwrites
    ``e2d`` in place.  Returns the per-segment ``(values, indices,
    new_e_rows)`` triples in segment order (``new_e_rows`` are views
    into ``e2d``)."""
    out = []
    for i, (start, length) in enumerate(segments):
        cols = slice(start, start + length)
        out.append(rows_compress_ef(
            g2d[:, cols], e2d[:, cols], name, ks[i], k_cap=k_caps[i],
            out_rows=e2d[:, cols]))
    return out
