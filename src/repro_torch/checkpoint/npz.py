"""Flat-key npz checkpoints of a train state (port of
``repro/checkpoint/npz.py``: ``save_state``, ``load_state``).

The keys are the reference's: each leaf's path from the state's root,
dict keys in sorted order joined with ``/`` (``params/embed``,
``opt/m/stack/0/ffn/w_up``, ``step``, ``resid``, ``resid2``,
``adaptk/signal``, ``adaptk/count``, ``adaptk/gnorm``, and the serve
publisher's ``publish/pub``, ``publish/resid``, ``publish/seq``).
Tensors and the adaptive controller's numpy arrays are stored as numpy
arrays and Python integers (the step counter, AdamW's ``t``, the
publisher's ``seq``) as int32 scalars, so a state saved by the JAX
package loads into the port with numpy alone, and the other way round.
A bf16 tensor is stored as the reference stores one: numpy has no bf16,
so the entry is its 16-bit patterns as ``|V2`` with no dtype named; it
loads bit for bit into a bf16 leaf only (any other leaf raises), and an
f32 entry into a bf16 leaf is rounded to nearest even, as the
reference's ``astype``.  The flat residuals are the ``(workers, model_size *
d_row_total)`` buckets (``resid``, ``resid2``); the per-leaf pipeline's
are ``(workers, d_pad)`` leaves (``resid/<leaf path>``).  With
``layout=``, a per-leaf checkpoint loads into a state with flat buckets
(the reference's ``_migrate_legacy_residual``).
"""
from __future__ import annotations

import os
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree

_SEP = "/"

# global-k controller scalars absent from checkpoints written before the
# controller existed: zero-filled on load, as the reference does — they
# self-seed from their first positive observation (core/adaptk.py
# ``global_scale``), so the migrated state is exact
_GLOBALK_KEYS = ("adaptk/gnorm", "adaptk/gnorm0")
# the serve publisher's state (``publish/pub``, ``publish/resid``,
# ``publish/seq``) absent from checkpoints written without it:
# zero-filled, as the reference does — ``publish/seq == 0`` makes the
# next publish a resync, so the zeroed view is never streamed against
_PUBLISH_PREFIX = "publish" + _SEP
# the residuals: a flat bucket each, or a tree of per-leaf entries below
_RESID_KEYS = ("resid", "resid2")
# how numpy stores a bf16 leaf, which it has no dtype for: raw 16 bits
_BF16_ENTRY = np.dtype("V2")


def _key(path) -> str:
    return _SEP.join(str(p) for p in path)


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            # the reference's np.asarray of a bf16 leaf: its 16-bit
            # patterns, saved with no dtype named (|V2)
            return leaf.view(torch.int16).numpy().view(_BF16_ENTRY)
        return leaf.numpy()
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def save_state(path: str, state: Any) -> None:
    """Write ``state`` to ``path`` (npz), atomically."""
    flat = {_key(p): _to_numpy(leaf)
            for p, leaf in tree.flatten_with_path(state)[0]}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def _migrate_legacy_residual(flat: dict, key: str, layout):
    """A per-leaf residual (``<key>/<leaf path>`` entries, segment order)
    packed into the flat bucket; raises for a missing leaf."""
    from repro_torch.dist.layout import pack_residual_arrays

    arrays = []
    for seg in layout.segments:
        legacy = f"{key}{_SEP}{seg.name}"
        if legacy not in flat:
            raise KeyError(
                f"checkpoint has neither a flat {key!r} buffer nor the "
                f"per-leaf entry {legacy!r} (truncated or incompatible "
                "checkpoint)")
        arrays.append(flat[legacy])
    return pack_residual_arrays(layout, arrays)


def load_state(path: str, like: Any, *,
               worker_rows: Optional[Sequence[int]] = None,
               layout=None,
               shard: Optional[Callable[[str, Any], Any]] = None) -> Any:
    """Restore into the structure of ``like``: each tensor leaf is
    overwritten in place (shape checked, cast to its dtype), each numpy
    or integer leaf replaced (numpy: shape checked, cast to its dtype).
    ``worker_rows`` picks rows of the checkpoint's worker axis for the
    residuals — a process that runs one worker of a W-worker checkpoint
    passes its rank.  ``layout`` (the state's ``BucketLayout``) lets a
    per-leaf checkpoint's residuals load into the flat buckets,
    bitwise.  ``shard(key, array)`` cuts each entry to what ``like``
    holds: a tensor-parallel rank's shards (by the placement of each
    leaf) and residual row, of the buckets or of each per-leaf residual
    (``dist/tensor_parallel.state_shard_fn``), so a tensor-parallel run
    loads a whole checkpoint of either form (a per-leaf one into its
    buckets through ``layout``); a tensor-parallel save gathers them
    first (``gather_state``), so the keys and shapes are the one-process
    run's at the same mesh.  The global-k scalars
    ``adaptk/gnorm`` and ``adaptk/gnorm0`` and the publisher's
    ``publish/...`` entries are zero-filled when the checkpoint lacks
    them."""
    with np.load(path) as data:
        flat = dict(data)
    pairs, td = tree.flatten_with_path(like)
    out = []
    for p, leaf in pairs:
        key = _key(p)
        filled = False
        if key not in flat and (key in _GLOBALK_KEYS
                                or key.startswith(_PUBLISH_PREFIX)):
            # zero-filled in the state's own shape: nothing to cut
            arr, filled = np.zeros(tuple(np.shape(leaf)), np.float32), True
        elif key not in flat and layout is not None and key in _RESID_KEYS:
            arr = _migrate_legacy_residual(flat, key, layout)
        elif key not in flat:
            raise KeyError(f"checkpoint {path!r} has no entry {key!r}")
        else:
            arr = flat[key]
        if worker_rows is not None and key.split(_SEP)[0] in _RESID_KEYS:
            arr = arr[list(worker_rows)]
        if shard is not None and not filled:
            arr = shard(key, arr)
        bf16 = arr.dtype == _BF16_ENTRY
        if bf16 and not (isinstance(leaf, torch.Tensor)
                         and leaf.dtype == torch.bfloat16):
            raise ValueError(
                f"{key}: the checkpoint holds bf16 bits (|V2), the state "
                f"a {getattr(leaf, 'dtype', type(leaf).__name__)} leaf; "
                "a |V2 entry loads only into a bf16 tensor")
        if isinstance(leaf, torch.Tensor):
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"state shape {tuple(leaf.shape)}")
            arr = np.ascontiguousarray(arr)
            src = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                   if bf16 else torch.from_numpy(arr))
            with torch.no_grad():
                leaf.copy_(src)
            out.append(leaf)
        elif isinstance(leaf, np.ndarray):
            if arr.shape != leaf.shape:
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"state shape {leaf.shape}")
            out.append(arr.astype(leaf.dtype))
        else:
            if arr.shape != ():
                raise ValueError(f"{key}: expected a scalar, got shape "
                                 f"{arr.shape}")
            out.append(type(leaf)(arr))
    return tree.unflatten(td, out)
