"""Per-leaf partition specs over the mesh (port of
``repro/dist/sharding.py``: ``param_spec``, ``param_specs``,
``train_state_specs``, ``batch_specs``, ``cache_specs``).

A spec is a tuple with one entry a dim of the leaf: an axis name (or a
tuple of axis names) that shards the dim, or ``None``; ``()`` is a
replicated leaf.  It equals the reference's ``PartitionSpec`` entry for
entry.  The functions read a leaf's path (the tuple of dict keys and
sequence indices of ``repro_torch.tree``) and its shape alone, so they
work on meta tensors.  The tree-wide ones return a dict from each
leaf's '/'-joined path (``tree.path_name``, the layout's segment names)
to its spec, in flatten order: a tree of tuples would not flatten back
to one spec a leaf.

Training shards every param leaf over the ``model`` axis only.  The
rules are name-based with a divisibility guard: a dim is sharded only
when its size is a positive multiple of the axis size, so a leaf that
divides nowhere stays replicated (norms, biases, gates).  The
projections that produce the hidden features (``wq``, ``wk``, ``wv``,
``w_gate``, ``w_up``, ``in_proj``, ...) shard their output dim, the ones
that consume them (``wo``, ``out_proj``, ``w_down``, ``dt_proj``) their
contraction dim: a block's pair of matmuls needs one all-reduce, the
Megatron split.  ``lm_head`` shards the vocab dim.  The leading dim of a
leaf under ``params["stack"]`` (the scan stacking) is never sharded.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch import tree

Spec = Tuple  # one entry a dim: an axis name, a tuple of them, or None

# weights whose contraction (input) dim is model-sharded: the second
# matmul of a Megatron pair; every other leaf of 2+ dims prefers its
# trailing (output) dim
_IN_DIM_SHARDED = frozenset({"wo", "out_proj", "w_down", "dt_proj"})


def _leaf_name(path) -> str:
    for key in reversed(tuple(path)):
        if isinstance(key, str):
            return key
    return ""


def _stacked(path) -> bool:
    return bool(path) and str(path[0]) == "stack"


def _divisible(size: int, n: int) -> bool:
    return size >= n and size % n == 0


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(x) for x in getattr(leaf, "shape", leaf))


def param_spec(path, leaf, model_axis: str = "model",
               model_size: int = 1) -> Spec:
    """The spec of one param leaf (a tensor or a shape) over the model
    axis: its preferred dim if that divides by ``model_size``, else the
    largest other dim that does (never the stacked dim), else ``()``."""
    shape = _shape(leaf)
    ndim = len(shape)
    lo = 1 if _stacked(path) else 0
    if model_size <= 1 or ndim - lo < 2:
        return ()
    prefer = ndim - 2 if _leaf_name(path) in _IN_DIM_SHARDED else ndim - 1
    candidates = [prefer] + sorted((d for d in range(lo, ndim)
                                    if d != prefer), key=lambda d: -shape[d])
    for dim in candidates:
        if dim >= lo and _divisible(shape[dim], model_size):
            spec = [None] * ndim
            spec[dim] = model_axis
            return tuple(spec)
    return ()


def by_leaf(leaves, spec_of) -> dict:
    """``{path name: spec_of(path, leaf)}`` over a tree, in flatten
    order."""
    return {tree.path_name(p): spec_of(p, leaf)
            for p, leaf in tree.flatten_with_path(leaves)[0]}


def param_specs(params, model_axis: str = "model",
                model_size: int = 1) -> dict:
    """:func:`param_spec` of every leaf of ``params``, by path name."""
    return by_leaf(params, lambda p, leaf: param_spec(p, leaf, model_axis,
                                                      model_size))


def _joint(data_axes: Sequence[str]):
    data_axes = tuple(data_axes)
    return data_axes if len(data_axes) > 1 else data_axes[0]


def train_state_specs(state, joint):
    """Specs of a train state: the residuals (``resid``, ``resid2``,
    flat buckets or per-leaf trees, ``(workers, ...)``) shard their
    worker axis over the joint data axes; params, optimizer state, the
    step and the controller are replicated.  ``joint`` is one data-axis
    name or the tuple of them."""
    return by_leaf(state, lambda p, _: (joint,)
                   if str(p[0]) in ("resid", "resid2") else ())


def batch_specs(batch, joint):
    """Every batch leaf shards its leading (batch) dim over the joint
    data axes: one micro-batch a data-parallel worker."""
    return by_leaf(batch, lambda p, _: (joint,))


def cache_specs(cache, data_axes: Sequence[str], data_size: int,
                model_axis: str = "model", model_size: int = 1):
    """Serve-time cache specs: the batch dim (the first after a stacked
    dim) over the joint data axes when it divides, and the largest
    remaining dim that divides over ``model``.  These are the
    reference's at-rest specs, for GSPMD to reshard as it computes: for
    a KV cache ``(B, S, KV, hd)`` the model axis often lands on ``S``.
    The port places a cache by heads instead (``models.init_cache`` with
    a model axis: the KV heads, Mamba's ``d_inner``, the xLSTM heads),
    like its Mamba and sLSTM params: a rank's attention over its own
    heads then reads only its own cache."""
    joint = _joint(data_axes)

    def spec_of(path, leaf):
        shape = _shape(leaf)
        ndim = len(shape)
        spec: list = [None] * ndim
        batch_dim = 1 if _stacked(path) else 0
        if batch_dim < ndim and data_size > 1 and \
                _divisible(shape[batch_dim], data_size):
            spec[batch_dim] = joint
        if model_size > 1:
            for dim in sorted(range(batch_dim + 1, ndim),
                              key=lambda d: -shape[d]):
                if _divisible(shape[dim], model_size):
                    spec[dim] = model_axis
                    break
        return tuple(spec)

    return by_leaf(cache, spec_of)


def sharded_dim(spec: Spec) -> Optional[int]:
    """The dim a spec shards over the model axis, or None."""
    for d, entry in enumerate(spec):
        if entry is not None:
            return d
    return None
