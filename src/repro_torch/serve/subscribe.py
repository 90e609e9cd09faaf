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
"""
from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.core import codec
from repro_torch.dist.layout import BucketLayout, unpack_tree
from repro_torch.serve.publish import DELTA, RESYNC, DeltaMessage


def apply_delta(params, layout: BucketLayout, values: torch.Tensor,
                indices: torch.Tensor):
    """Scatter-add one ``(model_size, k_cap_total)`` codec pair into a new
    param tree.  Each leaf is padded to its ``(model_size, d_row)`` rows
    in ``promote_types(leaf, values)``, decoded into row by row, and cast
    back to the leaf dtype."""
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


def apply_resync(params, layout: BucketLayout, bucket: torch.Tensor):
    """The tree of ``params`` filled from the dense published bucket
    (bit-exact), in a copy of the bucket: no leaf shares storage with
    ``bucket``."""
    return unpack_tree(layout, bucket.clone(), like=params)


def apply_message(params, layout: BucketLayout, msg: DeltaMessage):
    """Dispatch one :class:`DeltaMessage` onto the replica params."""
    if msg.kind == RESYNC:
        return apply_resync(params, layout, msg.bucket)
    if msg.kind == DELTA:
        return apply_delta(params, layout, msg.values, msg.indices)
    raise ValueError(f"unknown DeltaMessage kind {msg.kind!r}")


def make_apply_delta(layout: BucketLayout, device="cuda"):
    """``apply(params, values, indices)`` pinned to ``device`` (the card
    unless told ``"cpu"``): the wire pair is moved there and the new
    leaves land there, ready for the next decode step.  The in-loop form
    the serving driver calls between decode steps."""
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
                               indices.to(device))

    return apply
