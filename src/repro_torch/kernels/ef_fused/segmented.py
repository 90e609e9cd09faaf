"""Segment-aware fused pipeline over a packed bucket (port of
``repro/kernels/ef_fused/segmented.py``: ``rows_pass_a``,
``rows_compress_ef``, ``segmented_pass_a``, ``segmented_compress_ef``).

The bucketed aggregation packs every gradient leaf's ``(model_size,
d_row)`` rows into one ``(model_size, d_row_total)`` bucket.  Each
column segment runs :func:`~repro_torch.kernels.ef_fused.ops.
fused_compress_ef` per row with its OWN block configuration, so every
row is bit-identical to the per-leaf pipeline on the same values.  A
row of a segment is a contiguous view into the bucket: the kernels read
it and write the new residual into the residual bucket in place, with no
pad or copy.

Under adaptive density, pass A (K1) runs first over every segment
(:func:`segmented_pass_a`); :func:`stats_to_host` brings all of its
statistics to the host in one copy a kind, and the compression takes
them back through ``stats=`` and launches no K1 of its own.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.ef_fused.ops import fused_compress_ef, fused_pass_a


def rows_pass_a(g_rows: torch.Tensor, e_rows: Optional[torch.Tensor],
                name: str) -> list:
    """Per-row :func:`fused_pass_a` tuples of ``u = g + e`` for one
    ``(model_size, d_row)`` row block (``e_rows=None``: ``u = g``)."""
    return [fused_pass_a(g_rows[r], None if e_rows is None else e_rows[r],
                         name)
            for r in range(g_rows.shape[0])]


def segmented_pass_a(g2d: torch.Tensor, e2d: Optional[torch.Tensor],
                     segments: Sequence[Tuple[int, int]],
                     name: str) -> List[list]:
    """Pass A over the packed bucket: per ``(start, length)`` column
    segment, the per-row pass-A tuples of its rows, each at the
    segment's own block configuration."""
    return [rows_pass_a(g2d[:, start:start + length],
                        None if e2d is None
                        else e2d[:, start:start + length], name)
            for start, length in segments]


def stats_to_host(seg_stats: List[list]) -> List[list]:
    """:func:`segmented_pass_a`'s statistics on the host: the ``(s, sq,
    mx)`` of every row of every segment stacked and copied in ONE
    device-to-host copy (and the hist-k histograms in one more), then
    handed back in the same nested shape (0-d f32 and ``(BINS,)`` int64
    CPU tensors)."""
    flat = [t for rows in seg_stats for t in rows]
    moments = torch.stack([torch.stack(t[:3]) for t in flat]).cpu()
    hists = ([None] * len(flat) if flat[0][3] is None
             else list(torch.stack([t[3] for t in flat]).cpu()))
    out, i = [], 0
    for rows in seg_stats:
        out.append([(*moments[i + r], hists[i + r])
                    for r in range(len(rows))])
        i += len(rows)
    return out


def rows_compress_ef(g_rows: torch.Tensor, e_rows: Optional[torch.Tensor],
                     name: str, k, *, k_cap: int, out_rows: torch.Tensor,
                     row_stats=None):
    """Fused EF compression of one ``(model_size, d_row)`` row block:
    ``(values (M, k_cap), indices (M, k_cap), out_rows)``, the new
    residual rows written into ``out_rows`` (may be ``e_rows``, or
    ``g_rows`` when ``e_rows`` is None).  ``row_stats`` holds the rows'
    :func:`rows_pass_a` tuples."""
    outs = [fused_compress_ef(g_rows[r],
                              None if e_rows is None else e_rows[r], name,
                              k, k_cap=k_cap, out=out_rows[r],
                              stats=None if row_stats is None
                              else row_stats[r])
            for r in range(g_rows.shape[0])]
    values = torch.stack([o[0] for o in outs])
    indices = torch.stack([o[1] for o in outs])
    return values, indices, out_rows


def segmented_compress_ef(g2d: torch.Tensor, e2d: Optional[torch.Tensor],
                          segments: Sequence[Tuple[int, int]], name: str,
                          ks: Sequence, k_caps: Sequence[int], *,
                          stats: Optional[Sequence] = None,
                          out2d: Optional[torch.Tensor] = None):
    """Fused threshold-compact + residual write over the bucket, one
    ``(start, length)`` column segment at a time with its own budget
    ``ks[i]`` and capacity ``k_caps[i]`` (``stats[i]``: the segment's
    :func:`segmented_pass_a` tuples).  The new residual overwrites
    ``out2d`` in place (default ``e2d``; with ``e2d=None``, ``g2d`` holds
    ``u`` and is the natural target).  Returns the per-segment
    ``(values, indices, new_e_rows)`` triples in segment order
    (``new_e_rows`` are views into ``out2d``)."""
    out2d = e2d if out2d is None else out2d
    out = []
    for i, (start, length) in enumerate(segments):
        cols = slice(start, start + length)
        out.append(rows_compress_ef(
            g2d[:, cols], None if e2d is None else e2d[:, cols], name,
            ks[i], k_cap=k_caps[i], out_rows=out2d[:, cols],
            row_stats=None if stats is None else stats[i]))
    return out
