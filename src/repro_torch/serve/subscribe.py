"""Train-to-serve weight-delta streaming, replica side (port of
``repro/serve/subscribe.py``).

The serving replica holds live params and ingests
:class:`~repro_torch.serve.publish.DeltaMessage`s between decode steps.
A delta is O(k): per leaf segment, the ``[cap_off, cap_off + k_cap)``
columns of the wire pair are rebased to leaf-local indices (sentinels
kept) and scatter-added into the leaf's rows with the same
``codec.decode_add`` the publisher used to advance ``pub``, which makes
the publisher's ``pub`` and the packed replica bitwise equal at every
publish when the leaf dtype is the stream's.  A resync replaces the
whole tree with the dense bucket: replica == trainer exactly.

Every function here is out of place and returns storage of its own: a
delta builds new leaves, and a resync copies the message's bucket
(whose storage is the publisher's ``pub``) before slicing it into
leaves, so the replica never shares storage with the publisher's state
or the trainer.

A replica placed over the mesh (``placed``, a
``serve/steps.ServePlacement``) holds each rank's at-rest pieces: a
delta's pairs are mapped through the placement into the rank's piece
(the pairs another rank holds become sentinels) and added there; a
resync cuts the rank's piece out of the dense bucket.  The pieces land
in the rank's placement, as the reference's ``out_shardings``, and are
bitwise the cut of the one-process replica after the same message:
each leaf's indices are distinct and the add is elementwise.
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core import codec
from repro_torch.dist.layout import BucketLayout, unpack_tree
from repro_torch.serve.publish import DELTA, RESYNC, DeltaMessage


def _apply_piece(leaf, seg, v, i, placed):
    """One segment's pairs ``(v, i)`` (leaf-row-local indices, one row a
    model row of the layout) added into this rank's piece ``leaf``."""
    M = v.shape[0]
    whole = i.long() + seg.d_row * torch.arange(
        M, device=i.device)[:, None]
    whole = torch.where((i == codec.SENTINEL) | (whole >= seg.size),
                        torch.full_like(whole, -1), whole)
    local = placed.locate(seg.name, whole.reshape(-1))
    acc = torch.promote_types(leaf.dtype, v.dtype)
    new = codec.decode_add(leaf.reshape(-1).to(acc),
                           v.reshape(-1).to(acc), local)
    return new.view(leaf.shape).to(leaf.dtype)


def apply_delta(params, layout: BucketLayout, values: torch.Tensor,
                indices: torch.Tensor, placed=None):
    """Scatter-add one ``(model_size, k_cap_total)`` codec pair into a new
    param tree.  Each leaf is padded to its ``(model_size, d_row)`` rows
    in ``promote_types(leaf, values)``, decoded into row by row, and cast
    back to the leaf dtype.  With ``placed``, ``params`` are a placed
    rank's pieces, each given the pairs that fall in it."""
    leaves, td = tree.flatten(params)
    if len(leaves) != len(layout.segments):
        raise ValueError(f"tree has {len(leaves)} leaves, layout has "
                         f"{len(layout.segments)} segments")
    M = layout.model_size
    out = []
    for seg, leaf in zip(layout.segments, leaves):
        cols = slice(seg.cap_off, seg.cap_off + seg.k_cap)
        v = values[:, cols]
        i = codec.offset_indices(indices[:, cols], -seg.row_off)
        if placed is not None:
            out.append(_apply_piece(leaf, seg, v, i, placed))
            continue
        acc = torch.promote_types(leaf.dtype, values.dtype)
        flat = leaf.reshape(-1).to(acc)
        if seg.d_pad != seg.size:
            flat = torch.nn.functional.pad(flat, (0, seg.d_pad - seg.size))
        rows = flat.view(M, seg.d_row)
        new = [codec.decode_add(rows[m], v[m].to(acc), i[m])
               for m in range(M)]
        new_flat = new[0] if M == 1 else torch.cat(new)
        out.append(new_flat[:seg.size].view(seg.shape).to(leaf.dtype))
    return tree.unflatten(td, out)


def bucket_leaves(layout: BucketLayout, bucket: torch.Tensor):
    """The whole leaves of a packed bucket, segment by segment, as flat
    views."""
    for seg in layout.segments:
        block = bucket[:, seg.row_off:seg.row_off + seg.d_row]
        flat = block[0] if layout.model_size == 1 else block.reshape(-1)
        yield flat[:seg.size]


def resync_pieces(params, layout: BucketLayout, leaves, placed):
    """A placed replica's pieces cut out of the whole leaves ``leaves``
    (flat, in segment order; consumed one at a time, so a caller may
    produce each as it is cut), each in storage of its own."""
    pairs, td = tree.flatten_with_path(params)
    return tree.unflatten(td, [
        placed.cut(path, flat.view(seg.shape)).to(ref.dtype)
        for seg, (path, ref), flat in zip(layout.segments, pairs, leaves)])


def apply_resync(params, layout: BucketLayout, bucket: torch.Tensor,
                 placed=None):
    """The tree of ``params`` filled from the dense published bucket
    (bit-exact), in a copy of the bucket: no leaf shares storage with
    ``bucket``.  With ``placed``, each leaf is the rank's piece cut out
    of the bucket."""
    if placed is None:
        return unpack_tree(layout, bucket.clone(), like=params)
    return resync_pieces(params, layout, bucket_leaves(layout, bucket),
                         placed)


def apply_message(params, layout: BucketLayout, msg: DeltaMessage,
                  placed=None):
    """Dispatch one :class:`DeltaMessage` onto the replica params (a
    placed rank's pieces with ``placed``)."""
    if msg.kind == RESYNC:
        return apply_resync(params, layout, msg.bucket, placed)
    if msg.kind == DELTA:
        return apply_delta(params, layout, msg.values, msg.indices, placed)
    raise ValueError(f"unknown DeltaMessage kind {msg.kind!r}")


def make_apply_delta(layout: BucketLayout, device="cuda", placed=None):
    """``apply(params, values, indices)`` pinned to ``device`` (the card
    unless told ``"cpu"``): the wire pair is moved there and the new
    leaves land there, ready for the next decode step (with ``placed``,
    in the rank's placement).  The in-loop form the serving driver calls
    between decode steps."""
    from repro_torch.devices import resolve_device
    device = resolve_device(device)

    def apply(params, values, indices):
        for leaf in tree.leaves(params):
            # "cuda" pins the current card: any index matches it
            if leaf.device.type != device.type or device.index not in (
                    None, leaf.device.index):
                raise ValueError(f"replica leaf on {leaf.device}, apply "
                                 f"pinned to {device}")
        with torch.no_grad():
            return apply_delta(params, layout, values.to(device),
                               indices.to(device), placed)

    return apply
