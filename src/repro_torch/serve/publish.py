"""Train-to-serve compressed weight-delta streaming, publisher side
(port of ``repro/serve/publish.py``).

The trainer keeps a *published view* ``pub`` of its parameters: a
``(model_size, d_row_total)`` bucket under the same :class:`BucketLayout`
geometry the gradient wire uses (typically ``rebudget_layout`` of the
training layout at a serve-side ratio).  Every publish tick encodes the
weight delta ``params - pub`` through the fixed-capacity sentinel codec
with its own error-feedback residual:

    P = pack_grads(layout, params);  G = P - pub - resid
    wire = select(G + resid);  resid' = (G + resid) - decode(wire)
    pub' = pub + decode(wire)

``pub`` equals the packed replica params bitwise at every publish,
because the replica applies the same ``codec.decode_add`` to the same
wire pairs (``serve/subscribe.py``).  Every ``resync_every``-th publish
(and always at ``seq == 0``) ships the dense bucket and zeroes the
residual, so the replica equals the trainer exactly at that epoch.

The state is ``{"pub", "resid", "seq"}``: two buckets on the params'
device and the publish counter as a host int (``publish/seq``, an int32
scalar, in a checkpoint).  :func:`publish` and :func:`encode_delta`
CONSUME the state they are given: the residual bucket is updated in
place by ``bucket_compress``, so a caller keeps only the returned
state.  Everything returned is storage of its own: ``pub``, the
residual, the message's tensors and the params share none (``pub`` is
advanced out of place, and a resync's bucket is a copy of it).  The
params are packed on their own device, never copied to the host.

The publisher is fixed-k only: adaptive density and momentum correction
are gradient-stream semantics, so a config carrying either is rejected.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import prng, tree
from repro_torch.core import codec
from repro_torch.core.compression import CompressionConfig, as_config
from repro_torch.dist.aggregate import bucket_compress
from repro_torch.dist.layout import BucketLayout, pack_grads

# DeltaMessage.kind values
RESYNC = 0   # dense full bucket; replica := trainer exactly
DELTA = 1    # one (values, indices) codec pair over the whole bucket


class DeltaMessage(NamedTuple):
    """One publish on the wire.  ``kind == DELTA``: ``values`` /
    ``indices`` are a ``(model_size, k_cap_total)`` codec pair with
    bucket-global indices (``bucket`` None).  ``kind == RESYNC``:
    ``bucket`` is the dense ``(model_size, d_row_total)`` packed params
    (the pair None)."""
    seq: int
    kind: int
    values: Optional[torch.Tensor]
    indices: Optional[torch.Tensor]
    bucket: Optional[torch.Tensor]


def message_bits(msg: DeltaMessage) -> int:
    """Wire footprint of one message in bits: values + int32 indices for
    a delta, the dense bucket for a resync."""
    if msg.kind == RESYNC:
        return int(msg.bucket.numel()) * msg.bucket.element_size() * 8
    return int(msg.values.numel()) * (msg.values.element_size() * 8 + 32)


def publisher_config(config) -> CompressionConfig:
    """Validate a config for the publisher (fixed-k, non-dense)."""
    config = as_config(config)
    if config.dense:
        raise ValueError("publisher needs a sparse CompressionConfig "
                         "(compressor='none' has no delta stream)")
    if config.density_policy is not None:
        raise ValueError("publisher is fixed-k only: adaptive density is "
                         "a gradient-stream feature (drop density_policy)")
    if config.momentum_correction > 0:
        raise ValueError("publisher is fixed-k only: momentum correction "
                         "is a gradient-stream feature (set it to 0)")
    return config


def init_publisher_state(layout: BucketLayout, dtype=torch.float32,
                         device="cuda", rows: Optional[int] = None) -> dict:
    """``{"pub", "resid", "seq"}``: the published view and the delta
    stream's residual (zero ``(model_size, d_row_total)`` buckets on
    ``device``, the card unless told ``"cpu"``; ``rows`` rows of them, a
    tensor-parallel rank's one) and the host publish counter.  ``seq ==
    0`` forces the first publish to resync."""
    from repro_torch.devices import resolve_device
    device = resolve_device(device)
    shape = (layout.model_size if rows is None else rows,
             layout.d_row_total)
    return {"pub": torch.zeros(shape, dtype=dtype, device=device),
            "resid": torch.zeros(shape, dtype=dtype, device=device),
            "seq": 0}


def encode_delta(state: dict, P: torch.Tensor, layout: BucketLayout,
                 config: CompressionConfig, key, row: Optional[int] = None):
    """One delta encode against packed params ``P``: ``(new_state,
    (values, indices))``.  ``G = P - pub - resid`` in that order (formed
    in ``P``'s storage, which this call takes over), then
    ``bucket_compress(G, resid)`` forms ``u = G + resid`` as the
    reference does: ``decode(wire) + resid' == u``, which is ``P - pub``
    only up to f32 rounding.  ``state["resid"]`` is overwritten in
    place (the state is consumed); ``pub`` is advanced out of place.
    With ``row``, the state and ``P`` are model row ``row`` alone (a
    tensor-parallel rank's), encoded as that row of the whole bucket."""
    pub, resid = state["pub"], state["resid"]
    G = P.sub_(pub).sub_(resid)
    values, indices, new_resid = bucket_compress(
        G, resid, layout, config.spec, key, backend=config.backend,
        codec_dtype=config.codec_dtype, row=row)
    del G
    vals = values.to(pub.dtype)
    if pub.shape[0] == 1:
        # one row: its own (1, d) view, no second copy of the bucket
        new_pub = codec.decode_add(pub[0], vals[0], indices[0])[None]
    else:
        new_pub = torch.empty_like(pub)
        for m in range(pub.shape[0]):
            new_pub[m] = codec.decode_add(pub[m], vals[m], indices[m])
    return ({"pub": new_pub, "resid": new_resid.to(resid.dtype),
             "seq": state["seq"] + 1},
            (values, indices))


def resyncs_at(seq: int, resync_every: int) -> bool:
    """Whether publish ``seq`` ships the dense bucket: the first, and
    with ``resync_every > 0`` every ``resync_every``-th."""
    return seq == 0 or (resync_every > 0 and seq % resync_every == 0)


def publish(state: dict, params, layout: BucketLayout, config, key=None,
            *, resync_every: int = 0, rows=None):
    """One publish tick: ``(new_state, DeltaMessage)``.  Resyncs (the
    dense bucket, the residual zeroed) at ``seq == 0`` and, with
    ``resync_every > 0``, at every ``seq % resync_every == 0``; every
    other tick streams a delta keyed ``fold_in(key, seq)`` (``key``
    defaults to ``PRNGKey(0)``).  Consumes ``state``.  A resync's
    ``pub`` and message bucket are two new tensors.

    ``rows`` (a tensor-parallel rank's ``ModelRow``) packs the rank's
    param shards into its model row by the gradients' relayout: the
    state, ``P`` and the message are that row of the one-process
    ``(model_size, ...)`` ones, bitwise."""
    config = publisher_config(config)
    if rows is None:
        P = pack_grads(layout, params, state["pub"].dtype)
    else:
        P = rows.pack(layout, 0, tree.leaves(params), state["pub"].dtype)
    seq = int(state["seq"])
    if resyncs_at(seq, resync_every):
        state["resid"].zero_()
        # the message's bucket and the new view hold the same bits in
        # storage of their own
        new_state = {"pub": P.clone(), "resid": state["resid"],
                     "seq": seq + 1}
        return new_state, DeltaMessage(seq=seq, kind=RESYNC, values=None,
                                       indices=None, bucket=P)
    if key is None:
        key = prng.PRNGKey(0)
    new_state, (values, indices) = encode_delta(
        state, P, layout, config, prng.fold_in(key, seq),
        None if rows is None else rows.row)
    return new_state, DeltaMessage(seq=seq, kind=DELTA, values=values,
                                   indices=indices, bucket=None)
