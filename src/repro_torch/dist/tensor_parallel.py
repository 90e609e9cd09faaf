"""Tensor parallelism over the model axis: each process of a ``DxM``
launch holds one model rank's shard of every param leaf, by the specs of
``dist/sharding.py`` (the reference's layout under GSPMD, made physical).

* The collectives of the forward and backward as autograd functions
  (:func:`copy_to_model`: identity forward, all-reduce backward;
  :func:`reduce_from_model`: all-reduce forward, identity backward;
  :func:`gather_from_model`: the shards' concatenation forward, the own
  slice backward; :func:`local_columns`: this rank's columns of a
  replicated bias).  ``torch.distributed`` collectives carry no gradient
  of their own.  The model's forward (``models/model.py``,
  ``models/layers.py``) calls them with its ``axis``; with ``None`` (one
  process holding the whole model) they are identities.
* :class:`TensorParallel`: a rank's model axis and the checked specs of
  its params, built once (:func:`require_dense`, :func:`check_split`);
  its shards, its :class:`ModelRow` and its checkpoint cut.
* :func:`gather_state`: a rank's train state back to the whole one (the
  checkpoint's).
* The relayout (:class:`LeafRelayout`, :class:`ModelRow`).  The
  compression works on the reference's rows: row ``r`` of a leaf is the
  flat slice ``[r·d_row, (r+1)·d_row)`` of the whole leaf, which is model
  rank ``r``'s shard only for a leaf sharded on its leading dim.  So the
  gradient shards are moved into the rows by one ``all_to_all`` over
  the model group a sharded leaf, and the mean rows back into shards by
  the inverse one; a replicated leaf's row is a slice of it, and its
  mean is the model group's all-gather of the rows.  The plan is static
  and built once from the layout and the specs.  Its transient is one
  leaf's row a rank (the received pieces), beside the bucket row.

A sharded leaf of global shape ``S`` split on dim ``d`` is ``(a, n, b)``
with ``a = prod(S[:d])``, ``n = S[d]``, ``b = prod(S[d+1:])``; its flat
order is ``a·M`` pieces of ``(n/M)·b`` elements, piece ``p = i·M + s``
held by shard ``s`` at its own offset ``i·(n/M)·b``.  Row ``r`` holds the
pieces ``[r·a, (r+1)·a)``: shard ``s`` sends row ``r`` the pieces ``i``
with ``(i·M + s) // a == r``, one contiguous run of its buffer.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.dist.layout import BucketLayout, LeafSegment
from repro_torch.dist.sharding import param_specs, sharded_dim
from repro_torch.slices import not_ported


class ModelAxis:
    """This process's place on the model axis and its collectives: a
    tensor-parallel :class:`~repro_torch.dist.wire.ProcessGroupWire`'s
    model group."""

    def __init__(self, wire):
        if not getattr(wire, "tensor_parallel", False):
            raise ValueError("ModelAxis needs a ProcessGroupWire of a "
                             "launch with a model axis above 1")
        self.wire = wire
        self.rank, self.size = wire.model_rank, wire.model_size

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(M, *t.shape)``, every rank's ``t`` in rank order."""
        return self.wire.model_gather(t)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the model group, the same on every rank."""
        return self.wire.model_all_reduce(t, "sum")

    def amax(self, t: torch.Tensor) -> torch.Tensor:
        return self.wire.model_all_reduce(t, "max")

    def all_to_all(self, send, out_splits, in_splits) -> torch.Tensor:
        return self.wire.model_all_to_all(send, out_splits, in_splits)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.n = axis, x.shape[-1]
        parts = axis.gather(x)
        return torch.cat(list(parts.unbind(0)), dim=-1)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.axis.rank, ctx.n
        return g[..., r * n:(r + 1) * n].contiguous(), None


def copy_to_model(x: torch.Tensor, axis: Optional[ModelAxis]
                  ) -> torch.Tensor:
    """The input of a column-parallel matmul: identity forward, the
    gradient all-reduced over the model group backward."""
    return x if axis is None else _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Optional[ModelAxis]
                      ) -> torch.Tensor:
    """A row-parallel matmul's partial sums all-reduced; the gradient
    passes through."""
    return x if axis is None else _ReduceFromModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: Optional[ModelAxis]
                      ) -> torch.Tensor:
    """The shards of the last dim concatenated in rank order; backward
    takes this rank's slice."""
    return x if axis is None else _GatherFromModel.apply(x, axis)


def local_columns(b: torch.Tensor, axis: Optional[ModelAxis]
                  ) -> torch.Tensor:
    """This rank's slice of the last dim of a replicated ``b`` (the bias
    of a column-parallel matmul).  Its gradient, nonzero on this rank's
    slice alone, is all-reduced: every rank holds the whole one, as for
    any replicated leaf."""
    if axis is None:
        return b
    n = b.shape[-1] // axis.size
    return copy_to_model(b, axis).narrow(-1, axis.rank * n, n)


# ---------------------------------------------------------------------------
# params: specs, shards, the split check
# ---------------------------------------------------------------------------


def shard(full: torch.Tensor, spec, rank: int, model_size: int):
    """Model rank ``rank``'s shard of one leaf (a copy of its own)."""
    d = sharded_dim(spec)
    if d is None:
        return full.clone()
    n = full.shape[d] // model_size
    return full.narrow(d, rank * n, n).contiguous()


def shard_params(params, specs: Sequence, rank: int, model_size: int):
    """The tree of this rank's shards of ``params`` (full leaves)."""
    leaves, td = tree.flatten(params)
    return tree.unflatten(td, [shard(p, s, rank, model_size)
                               for p, s in zip(leaves, specs)])


def gather_leaf(local: torch.Tensor, spec, axis: ModelAxis) -> torch.Tensor:
    """The whole leaf from every rank's shard (a replicated leaf as
    it is)."""
    d = sharded_dim(spec)
    if d is None:
        return local
    return torch.cat(list(axis.gather(local).unbind(0)), dim=d)


# the dense decoder's Megatron split: leaf name -> the dim of its
# unstacked shape that must be sharded, and whether it holds whole heads
_TP_DIMS = {"wq": (1, True), "wk": (1, True), "wv": (1, True),
            "wo": (0, True), "w_gate": (1, False), "w_up": (1, False),
            "w_down": (0, False)}


def check_split(cfg, params, model_size: int) -> list:
    """The specs of ``params`` (full shapes) at ``model_size``, after
    checking that they are the dense decoder's Megatron split: ``embed``
    on ``d_model``, ``lm_head`` on the vocab, the column- and row-parallel
    projections on their output and input dims, every other leaf
    replicated.  Raises ``ValueError`` naming the leaf for a split that
    cuts inside an attention head or leaves a split weight replicated
    (never gathers instead)."""
    M = model_size
    out = []
    for (path, leaf), spec in zip(
            tree.flatten_with_path(params)[0],
            param_specs(params, "model", M).values()):
        name = tree.path_name(path)
        shape = tuple(leaf.shape)
        lo = 1 if path[0] == "stack" else 0
        key = path[-1]
        if key in ("embed", "lm_head"):
            want = lo + 1
        elif key in _TP_DIMS:
            want = lo + _TP_DIMS[key][0]
        else:
            want = None
        got = sharded_dim(spec)
        if got != want:
            have = "replicated" if got is None else f"split on dim {got}"
            need = "replicated" if want is None else f"split on dim {want}"
            raise ValueError(
                f"tensor parallelism at M={M}: leaf {name!r} {shape} is "
                f"{have} by the sharding rules; the dense decoder's "
                f"Megatron split needs it {need}")
        if key in _TP_DIMS and _TP_DIMS[key][1]:
            cols = shape[want] // M
            if cols % cfg.hd:
                raise ValueError(
                    f"tensor parallelism at M={M} would split leaf "
                    f"{name!r} {shape} into {M} shards of {cols} along "
                    f"dim {want}, inside an attention head of {cfg.hd}")
        out.append(spec)
    return out


def require_dense(cfg) -> None:
    """Raise for a config whose blocks have no tensor-parallel form: the
    MoE, Mamba and xLSTM blocks (attention and the MLP, biased or not,
    have one)."""
    kinds = {cfg.layer_sig(i) for i in range(cfg.num_layers)}
    other = sorted({k for sig in kinds for k in sig}
                   - {"attn", "swa", "mlp", "none"})
    if other:
        raise not_ported(f"tensor parallelism of {cfg.name} "
                         f"({', '.join(other)})", "model_placement")


class TensorParallel:
    """A tensor-parallel rank's setup, made once: its model ``axis`` over
    ``wire``'s model group, and the ``specs`` of ``params`` (``cfg``'s
    whole params, tensors or meta), in flatten order and ``by_name``,
    after :func:`require_dense` and :func:`check_split`."""

    def __init__(self, cfg, wire, params):
        require_dense(cfg)
        self.axis = ModelAxis(wire)
        self.specs = check_split(cfg, params, self.axis.size)
        self.by_name = dict(zip(
            (tree.path_name(p) for p, _ in tree.flatten_with_path(
                params)[0]), self.specs))

    def shard(self, params):
        """This rank's shards of the whole ``params``."""
        return shard_params(params, self.specs, self.axis.rank,
                            self.axis.size)

    def rows(self, layout: BucketLayout) -> "ModelRow":
        """This rank's row of ``layout``'s buckets."""
        return ModelRow(layout, self.specs, self.axis)

    def state_shard(self):
        """``load_state``'s ``shard=``: a whole checkpoint cut to this
        rank (:func:`state_shard_fn`)."""
        return state_shard_fn(self.by_name, self.axis.rank, self.axis.size)

    def gather_state(self, state: dict) -> dict:
        """The model group's states as one whole (:func:`gather_state`);
        a collective."""
        return gather_state(state, self.by_name, self.axis)


# ---------------------------------------------------------------------------
# the relayout between shards and the bucket's rows
# ---------------------------------------------------------------------------


def _first_piece(s: int, r: int, a: int, M: int) -> int:
    """The first ``i`` of shard ``s`` whose piece ``i·M + s`` lies in a
    row ``>= r`` (clamped to ``[0, a]``)."""
    return min(a, max(0, -(-(r * a - s) // M)))


class LeafRelayout:
    """The static moves of one leaf between model rank ``rank``'s shard
    and its row of the ``(M, d_row)`` rows (module docstring)."""

    def __init__(self, seg: LeafSegment, spec, rank: int, model_size: int):
        self.seg, self.rank, self.M = seg, rank, model_size
        self.dim = sharded_dim(spec)
        if self.dim is None:
            return
        shape, M, r = seg.shape, model_size, rank
        a = math.prod(shape[:self.dim])
        self.a = a
        self.piece = shape[self.dim] // M * math.prod(shape[self.dim + 1:])
        self.shard_shape = (shape[:self.dim] + (shape[self.dim] // M,)
                            + shape[self.dim + 1:])
        # pieces this shard sends to each row / this row gets from each
        # shard (both runs ordered by the shard's own i)
        self.send = [_first_piece(r, q + 1, a, M) - _first_piece(r, q, a, M)
                     for q in range(M)]
        got = [_first_piece(s, r + 1, a, M) - _first_piece(s, r, a, M)
               for s in range(M)]
        self.recv = got
        offs = np.concatenate([[0], np.cumsum(got)[:-1]])
        p = r * a + np.arange(a)
        pos = offs[p % M] + (p // M) - np.array(
            [_first_piece(s, r, a, M) for s in range(M)])[p % M]
        self._perm = torch.from_numpy(pos.astype(np.int64))
        self._perms = {}

    def _perm_on(self, device) -> torch.Tensor:
        if device not in self._perms:
            self._perms[device] = self._perm.to(device)
        return self._perms[device]

    def to_row(self, g: torch.Tensor, out: torch.Tensor,
               axis: ModelAxis) -> None:
        """Write this rank's row of the leaf whose shard gradient is
        ``g`` into ``out`` (a contiguous ``(d_row,)`` view, cast to its
        dtype)."""
        seg = self.seg
        if self.dim is None:
            flat = g.reshape(-1)
            lo = min(self.rank * seg.d_row, seg.size)
            hi = min(lo + seg.d_row, seg.size)
            out[:hi - lo].copy_(flat[lo:hi])
            out[hi - lo:].zero_()
            return
        pl = self.piece
        recv = axis.all_to_all(g.reshape(-1).to(out.dtype),
                               [c * pl for c in self.recv],
                               [c * pl for c in self.send])
        torch.index_select(recv.view(self.a, pl), 0,
                           self._perm_on(recv.device),
                           out=out.view(self.a, pl))

    def from_row(self, row: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
        """This rank's shard (or, replicated, the whole leaf) of the
        leaf whose row on this rank is ``row`` ``(d_row,)``."""
        seg = self.seg
        if self.dim is None:
            rows = axis.gather(row.contiguous())
            return rows.reshape(-1)[:seg.size].view(seg.shape)
        pl = self.piece
        send = torch.empty((self.a, pl), dtype=row.dtype, device=row.device)
        send.index_copy_(0, self._perm_on(row.device), row.view(self.a, pl))
        recv = axis.all_to_all(send.view(-1), [c * pl for c in self.send],
                               [c * pl for c in self.recv])
        return recv.view(self.shard_shape)


class ModelRow:
    """A tensor-parallel rank's model row of the buckets: the methods of
    ``dist/aggregate.AllRows`` over this rank's row ``row``, moving the
    gradient shards into it and the means back by the relayout."""

    def __init__(self, layout: BucketLayout, specs: Sequence,
                 axis: ModelAxis):
        if layout.model_size != axis.size:
            raise ValueError(f"layout model_size={layout.model_size} != "
                             f"the model group's {axis.size}")
        if len(specs) != len(layout.segments):
            raise ValueError(f"{len(specs)} specs for "
                             f"{len(layout.segments)} layout segments")
        self.axis, self.row = axis, axis.rank
        self.plans: List[LeafRelayout] = [
            LeafRelayout(seg, spec, axis.rank, axis.size)
            for seg, spec in zip(layout.segments, specs)]

    def held(self, layout: BucketLayout) -> int:
        return 1

    def pack(self, view: BucketLayout, seg_lo: int, leaves, dtype):
        bucket = torch.empty((1, view.d_row_total), dtype=dtype,
                             device=leaves[0].device)
        for j, (seg, g) in enumerate(zip(view.segments, leaves)):
            self.plans[seg_lo + j].to_row(
                g, bucket[0, seg.row_off:seg.row_off + seg.d_row], self.axis)
        return bucket

    def unpack(self, view: BucketLayout, seg_lo: int, mean, like) -> list:
        return [self.plans[seg_lo + j].from_row(
            mean[0, seg.row_off:seg.row_off + seg.d_row],
            self.axis).to(ref.dtype)
            for j, (seg, ref) in enumerate(zip(view.segments, like))]

    def all_rows(self, row_stats: list) -> list:
        mine = torch.tensor([list(rows[0]) for rows in row_stats],
                            dtype=torch.float32)
        every = self.axis.gather(mine).numpy()
        return [[tuple(np.float32(x) for x in every[m, si])
                 for m in range(self.axis.size)]
                for si in range(len(row_stats))]

    def total(self, x: torch.Tensor) -> torch.Tensor:
        return self.axis.all_reduce(x)


# ---------------------------------------------------------------------------
# checkpoints: the whole state from the shards and back
# ---------------------------------------------------------------------------


def _param_name(key: str, names) -> str:
    """The param leaf a state key holds (``params/<name>``,
    ``opt/m/<name>``, ...), or None."""
    parts = key.split("/")
    for cut in range(1, len(parts)):
        name = "/".join(parts[cut:])
        if name in names:
            return name
    return None


def gather_state(state: dict, specs: dict, axis: ModelAxis) -> dict:
    """The model group's shards of a train state as one whole state:
    params and optimizer leaves by their ``specs`` (``{param path name:
    spec}``), the residual rows ``(workers, d_row_total)`` as the
    ``(workers, M·d_row_total)`` buckets the checkpoint keys document."""
    pairs, td = tree.flatten_with_path(state)
    out = []
    for path, leaf in pairs:
        key = tree.path_name(path)
        name = _param_name(key, specs)
        if str(path[0]) in ("resid", "resid2"):
            rows = axis.gather(leaf)                    # (M, workers, D)
            leaf = rows.transpose(0, 1).reshape(leaf.shape[0], -1)
        elif name is not None and isinstance(leaf, torch.Tensor):
            leaf = gather_leaf(leaf, specs[name], axis)
        out.append(leaf)
    return tree.unflatten(td, out)


def state_shard_fn(specs: dict, rank: int, model_size: int):
    """``shard(key, array) -> array`` for ``checkpoint.load_state``: a
    whole checkpoint's entry cut to model rank ``rank``'s part (params and
    optimizer leaves by their specs, the residual buckets to their row
    ``rank``)."""
    def cut(key: str, arr):
        if key.split("/")[0] in ("resid", "resid2"):
            w = arr.shape[0]
            return np.ascontiguousarray(
                arr.reshape(w, model_size, -1)[:, rank])
        name = _param_name(key, specs)
        if name is None:
            return arr
        d = sharded_dim(specs[name])
        if d is None:
            return arr
        n = arr.shape[d] // model_size
        return np.ascontiguousarray(
            np.take(arr, np.arange(rank * n, (rank + 1) * n), axis=d))
    return cut
