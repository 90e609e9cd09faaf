"""Tensor parallelism over the model axis: each process of a ``DxM``
launch holds one model rank's shard of every split param leaf, by the
port's physical placement of every block kind.

* The collectives of the forward and backward as autograd functions
  (:func:`copy_to_model`: identity forward, all-reduce backward;
  :func:`reduce_from_model`: all-reduce forward, identity backward;
  :func:`gather_from_model`: the shards' concatenation forward, the own
  slice backward; :func:`split_to_model`: the own slice forward, the
  slices' concatenation backward; :func:`local_columns`: this rank's
  columns of a replicated vector).  ``torch.distributed`` collectives
  carry no gradient of their own.  The model's forward (``models/*.py``) calls
  them with its ``axis``; with ``None`` (one process holding the whole
  model) they are identities.
* The placement (:class:`Placement`, :func:`placement`,
  :func:`check_split`): for each leaf, keyed by its block kind and
  name, a view of its shape and the dim of that view that is split; the
  Megatron split of every block (attention and sLSTM/mLSTM by heads,
  the MLPs and the experts by hidden units, Mamba by channels, with
  ``in_proj`` viewed as ``(D, 2, d_inner)`` so that each rank holds its
  channels of both ``x`` and ``z``).  The reference's specs
  (``dist/sharding.py``) are at-rest layouts for GSPMD, which may insert
  any collective; they give Mamba's and sLSTM's leaves no local
  computation, so the placement is the port's own and agrees with the
  specs only on the dense decoder's leaves.
* :class:`TensorParallel`: a rank's model axis and the checked
  placements of its params, built once; its shards, its
  :class:`ModelRow` and its checkpoint cut.
* :func:`gather_state`: a rank's train state back to the whole one (the
  checkpoint's).
* The relayout (:class:`LeafRelayout`, :class:`ModelRow`).  The
  compression works on the reference's rows: row ``r`` of a leaf is the
  flat slice ``[r·d_row, (r+1)·d_row)`` of the whole leaf, whatever
  rank holds which elements.  So the gradient shards are moved into the
  rows by one ``all_to_all`` over the model group a split leaf, and the
  mean rows back into shards by the inverse one; a replicated leaf's row
  is a slice of it, and its mean is the model group's all-gather of the
  rows.  The plan is static and built once from the layout and the
  placements.  Its transient is one leaf's row a rank (the received
  pieces), beside the bucket row.

A leaf split on dim ``d`` of its view ``S`` is ``(a, n, b)`` with ``a =
prod(S[:d])``, ``n = S[d]``, ``b = prod(S[d+1:])``; its flat order is
``a·M`` pieces of ``(n/M)·b`` elements, piece ``p = i·M + s`` held by
shard ``s`` at its own offset ``i·(n/M)·b``.  Row ``r`` holds the
pieces ``[r·a, (r+1)·a)``: shard ``s`` sends row ``r`` the pieces ``i``
with ``(i·M + s) // a == r``, one contiguous run of its buffer.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree
from repro_torch.dist.layout import BucketLayout, LeafSegment


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


class _SplitToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        n = x.shape[-1] // axis.size
        return x[..., axis.rank * n:(axis.rank + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = ctx.axis.gather(g.contiguous())
        return torch.cat(list(parts.unbind(0)), dim=-1), None


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


def split_to_model(x: torch.Tensor, axis: Optional[ModelAxis]
                   ) -> torch.Tensor:
    """This rank's ``1 / M`` slice of the last dim of a replicated
    ``x``, as a copy of its own (a view would keep the whole storage
    alive); backward, the gradient slices of every rank concatenated in
    rank order.  The inverse of :func:`gather_from_model`."""
    return x if axis is None else _SplitToModel.apply(x, axis)


def local_columns(b: torch.Tensor, axis: Optional[ModelAxis]
                  ) -> torch.Tensor:
    """This rank's slice of the last dim of a replicated ``b`` (the bias
    of a column-parallel matmul, a per-channel or per-head vector).  Its gradient, nonzero on this rank's
    slice alone, is all-reduced: every rank holds the whole one, as for
    any replicated leaf."""
    if axis is None:
        return b
    n = b.shape[-1] // axis.size
    return copy_to_model(b, axis).narrow(-1, axis.rank * n, n)


# ---------------------------------------------------------------------------
# params: the placement, shards, the split check
# ---------------------------------------------------------------------------


class Placement(NamedTuple):
    """One param leaf's physical split over the model axis: the whole
    leaf of ``shape`` is viewed as ``view`` (the same elements, one dim
    factored where the block needs it) and cut into ``M`` equal slices
    of ``view``'s dim ``dim``; model rank ``r`` holds slice ``r``,
    stored as ``shard_shape`` (the view's slice with its dims merged
    back).  ``dim`` None: every rank holds the whole leaf."""
    shape: tuple
    view: tuple
    dim: Optional[int]
    shard_shape: tuple

    @property
    def replicated(self) -> bool:
        return self.dim is None


def _shard_shape(shape, view, dim: int, M: int) -> tuple:
    """``shape`` with the dim that holds ``view``'s dim ``dim`` cut by
    ``M`` (``view`` refines ``shape``: the same elements, a dim of
    ``shape`` factored)."""
    before = math.prod(view[:dim])
    k = max(i for i in range(len(shape)) if math.prod(shape[:i]) <= before)
    return shape[:k] + (shape[k] // M,) + shape[k + 1:]


# the split of each leaf a block kind holds, by leaf name: (dim of the
# unstacked leaf's view, the run of elements a shard must hold whole,
# what that dim counts); a leaf absent from its kind's table is
# replicated (norms, biases, the router, the Mamba per-channel vectors:
# the column-parallel blocks take their slice, ``local_columns``)
def _rules(cfg) -> dict:
    hd = cfg.hd

    def heads(dim, kind):
        return (dim, hd, f"{kind} head")

    mlp = {"w_gate": (1, 1, "hidden units"), "w_up": (1, 1, "hidden units"),
           "w_down": (0, 1, "hidden units")}
    ch = (1, 1, "channels")
    return {
        "top": {"embed": (1, 1, "d_model columns"),
                "lm_head": (1, 1, "vocab entries")},
        "attn": {"wq": heads(1, "attention"), "wk": heads(1, "attention"),
                 "wv": heads(1, "attention"), "wo": heads(0, "attention")},
        "mlp": mlp,
        "moe": {"w_gate": (2, 1, "expert hidden units"),
                "w_up": (2, 1, "expert hidden units"),
                "w_down": (1, 1, "expert hidden units")},
        # in_proj (D, 2·di) is x and z side by side: viewed (D, 2, di),
        # each rank holds its channels of both
        "mamba": {"in_proj": (2, 1, "channels"), "conv_w": ch,
                  "x_proj": (0, 1, "channels"), "dt_proj": ch,
                  "A_log": (0, 1, "channels"),
                  "out_proj": (0, 1, "channels")},
        "mlstm": {"wq": heads(1, "mLSTM"), "wk": heads(1, "mLSTM"),
                  "wv": heads(1, "mLSTM"), "wo_gate": heads(1, "mLSTM"),
                  "wi": (1, 1, "heads"), "wf": (1, 1, "heads"),
                  "out_proj": heads(0, "mLSTM")},
        "slstm": dict({f"w{g}": heads(1, "sLSTM") for g in "ifzo"},
                      **{f"r{g}": (0, 1, "heads") for g in "ifzo"},
                      out_proj=heads(0, "sLSTM")),
    }


def _views(kind: str, name: str, shape: tuple) -> tuple:
    """The unstacked leaf's view: Mamba's ``in_proj`` as ``(D, 2,
    di)``, every other leaf as its shape."""
    if kind == "mamba" and name == "in_proj":
        return (shape[0], 2, shape[1] // 2)
    return shape


def leaf_kind(cfg, path) -> str:
    """The placement table a param path reads: ``"top"`` (embed, head,
    final norm), the block kind of its layer's core (``swa`` as
    ``attn``), its FFN kind (an MoE's shared experts as ``mlp``), or
    ``"norm"``."""
    head = str(path[0])
    if head not in ("stack", "tail"):
        return "top"
    layer = int(path[1])
    if head == "tail":
        layer += cfg.num_layers // cfg.pattern_period * cfg.pattern_period
    part = path[2]
    if part == "core":
        kind = cfg.block_kind(layer)
        return "attn" if kind == "swa" else kind
    if part == "ffn":
        ffn = cfg.ffn_kind(layer)
        return "mlp" if ffn == "moe" and path[3] == "shared" else ffn
    return "norm"


def placement(cfg, path, shape, model_size: int) -> Placement:
    """The :class:`Placement` of the param leaf at ``path`` of whole
    ``shape`` (stacked leaves carry their leading ``reps``) over a model
    axis of ``model_size``.  Raises ``ValueError`` naming the leaf when
    ``model_size`` does not divide the dim it splits, or would cut inside
    a head (never gathers instead)."""
    shape, M = tuple(int(x) for x in shape), model_size
    name = tree.path_name(path)
    kind = leaf_kind(cfg, path)
    rule = _rules(cfg).get(kind, {}).get(path[-1])
    if M == 1 or rule is None:
        return Placement(shape, shape, None, shape)
    lead = shape[:1] if str(path[0]) == "stack" else ()
    view = lead + _views(kind, path[-1], shape[len(lead):])
    dim, unit, what = rule
    dim += len(lead)
    n = view[dim]
    if n % M:
        raise ValueError(
            f"tensor parallelism at M={M}: leaf {name!r} {shape} has "
            f"{n // unit} {what if unit == 1 else what + 's'} along dim "
            f"{dim} of its view {view}, which do not split into {M} "
            "shards")
    if (n // M) % unit:
        raise ValueError(
            f"tensor parallelism at M={M} would split leaf {name!r} "
            f"{shape} into {M} shards of {n // M} along dim {dim}, "
            f"inside an {what} of {unit}")
    return Placement(shape, view, dim, _shard_shape(shape, view, dim, M))


def check_split(cfg, params, model_size: int) -> List[Placement]:
    """The :class:`Placement` of every leaf of ``params`` (whole shapes,
    tensors or meta) at ``model_size``, in flatten order: the Megatron
    split of every block kind (attention by heads, the MLPs and the
    experts by hidden units, Mamba by channels, mLSTM and sLSTM by
    heads, ``embed`` on ``d_model``, ``lm_head`` on the vocab), every
    other leaf replicated.  Raises ``ValueError`` naming the first leaf
    that ``model_size`` does not split (:func:`placement`)."""
    return [placement(cfg, path, leaf.shape, model_size)
            for path, leaf in tree.flatten_with_path(params)[0]]


def shard(full: torch.Tensor, pl: Placement, rank: int, model_size: int):
    """Model rank ``rank``'s shard of one whole leaf (a copy of its
    own)."""
    if pl.replicated:
        return full.clone()
    n = pl.view[pl.dim] // model_size
    return full.reshape(pl.view).narrow(pl.dim, rank * n, n) \
        .contiguous().view(pl.shard_shape)


def shard_params(params, placements: Sequence[Placement], rank: int,
                 model_size: int):
    """The tree of this rank's shards of ``params`` (whole leaves)."""
    leaves, td = tree.flatten(params)
    return tree.unflatten(td, [shard(p, pl, rank, model_size)
                               for p, pl in zip(leaves, placements)])


def gather_leaf(local: torch.Tensor, pl: Placement,
                axis: ModelAxis) -> torch.Tensor:
    """The whole leaf from every rank's shard (a replicated leaf as
    it is)."""
    if pl.replicated:
        return local
    view = list(pl.view)
    view[pl.dim] //= axis.size
    return torch.cat([p.reshape(view) for p in axis.gather(local).unbind(0)],
                     dim=pl.dim).reshape(pl.shape)


class TensorParallel:
    """A tensor-parallel rank's setup, made once: its model ``axis`` over
    ``wire``'s model group, the ``placements`` of ``params`` (``cfg``'s
    whole params, tensors or meta; :func:`check_split`) in flatten
    order and ``by_name``, and ``whole``, the whole params' shapes (meta
    tensors)."""

    def __init__(self, cfg, wire, params):
        self.axis = ModelAxis(wire)
        self.placements = check_split(cfg, params, self.axis.size)
        self.by_name = dict(zip(
            (tree.path_name(p) for p, _ in tree.flatten_with_path(
                params)[0]), self.placements))
        self.whole = tree.tree_map(
            lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"),
            params)

    def shard(self, params):
        """This rank's shards of the whole ``params``."""
        return shard_params(params, self.placements, self.axis.rank,
                            self.axis.size)

    def rows(self, layout: BucketLayout) -> "ModelRow":
        """This rank's row of ``layout``'s buckets (the layout of the
        whole params: the bucketed one, or the per-leaf loop's)."""
        return ModelRow(layout, self.placements, self.axis)

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

    def __init__(self, seg: LeafSegment, pl: Placement, rank: int,
                 model_size: int):
        if tuple(seg.shape) != pl.shape:
            raise ValueError(f"leaf {seg.name!r}: layout shape "
                             f"{tuple(seg.shape)} != placement {pl.shape}")
        self.seg, self.rank, self.M = seg, rank, model_size
        self.dim = pl.dim
        if self.dim is None:
            return
        view, M, r = pl.view, model_size, rank
        a = math.prod(view[:self.dim])
        self.a = a
        self.piece = view[self.dim] // M * math.prod(view[self.dim + 1:])
        self.shard_shape = pl.shard_shape
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

    def __init__(self, layout: BucketLayout, placements: Sequence,
                 axis: ModelAxis):
        if layout.model_size != axis.size:
            raise ValueError(f"layout model_size={layout.model_size} != "
                             f"the model group's {axis.size}")
        if len(placements) != len(layout.segments):
            raise ValueError(f"{len(placements)} placements for "
                             f"{len(layout.segments)} layout segments")
        self.axis, self.row = axis, axis.rank
        self.plans: List[LeafRelayout] = [
            LeafRelayout(seg, pl, axis.rank, axis.size)
            for seg, pl in zip(layout.segments, placements)]

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


def gather_state(state: dict, placements: dict, axis: ModelAxis) -> dict:
    """The model group's shards of a train state as one whole state:
    params and optimizer leaves by their ``placements`` (``{param path
    name: Placement}``), the residual rows (``(workers, d_row_total)``
    buckets, or the per-leaf loop's ``(workers, d_row)`` leaves) as the
    ``(workers, M·d_row_total)`` buckets (``(workers, d_pad)`` leaves)
    the checkpoint keys document, and the publisher's row buckets
    (``publish/pub``, ``publish/resid``) as its ``(M, d_row_total)``."""
    pairs, td = tree.flatten_with_path(state)
    out = []
    for path, leaf in pairs:
        key = tree.path_name(path)
        name = _param_name(key, placements)
        if str(path[0]) in ("resid", "resid2"):
            rows = axis.gather(leaf)                    # (M, workers, D)
            leaf = rows.transpose(0, 1).reshape(leaf.shape[0], -1)
        elif str(path[0]) == "publish" and isinstance(leaf, torch.Tensor):
            leaf = axis.gather(leaf).reshape(axis.size, -1)
        elif name is not None and isinstance(leaf, torch.Tensor):
            leaf = gather_leaf(leaf, placements[name], axis)
        out.append(leaf)
    return tree.unflatten(td, out)


def state_shard_fn(placements: dict, rank: int, model_size: int):
    """``shard(key, array) -> array`` for ``checkpoint.load_state``: a
    whole checkpoint's entry cut to model rank ``rank``'s part (params and
    optimizer leaves by their placements, the residual buckets, or the
    per-leaf residuals, and the publisher's buckets to their row
    ``rank``)."""
    def cut(key: str, arr):
        if key.split("/")[0] in ("resid", "resid2"):
            w = arr.shape[0]
            return np.ascontiguousarray(
                arr.reshape(w, model_size, -1)[:, rank])
        if key.split("/")[0] == "publish" and np.ndim(arr) == 2:
            return np.ascontiguousarray(arr[rank:rank + 1])
        name = _param_name(key, placements)
        if name is None or placements[name].replicated:
            return arr
        pl = placements[name]
        n = pl.view[pl.dim] // model_size
        part = np.take(arr.reshape(pl.view),
                       np.arange(rank * n, (rank + 1) * n), axis=pl.dim)
        return np.ascontiguousarray(part).reshape(pl.shard_shape)
    return cut
