"""Serve-step factories: prefill and decode on one device or placed over
the mesh, and the serving specs (port of ``repro/serve/steps.py``:
``make_prefill_step``, ``make_decode_step``, ``serve_param_specs``,
``serve_constrain`` and the spec half of ``decode_shardings``).

The reference jits both steps with explicit shardings over a mesh.
Here a step runs either on one device, the card unless told ``"cpu"``,
where a mesh is the same function computed on the whole batch with the
whole model, or on one rank of a ``torchrun`` launch of ``D·M``
processes, placed by :class:`ServePlacement`:

* **the model axis**: the rank holds model rank ``r``'s shards by the
  training placement (``dist/tensor_parallel.placement``) and runs the
  model given its ``axis``; its cache holds its heads and channels;
* **the data axis**: in mode ``"2d"`` (the reference's default) each
  rank keeps ``1 / D`` of its model shard at rest (:func:`at_rest_data_dim`)
  and gathers a block's pieces over its data group just before the
  block runs (``serve_constrain``'s counterpart: one all-gather a
  layer-pattern period, a tail layer, the embedding and the head), the
  gathered block freed after it; ``"model-only"`` keeps the whole model
  shard.  A gather is a copy, so both modes give the same bits;
* **the batch**: split over the data groups where ``D`` divides it,
  else every data group serves the whole batch (the reference's
  ``P(joint)`` / ``P()`` token spec).  An MoE layer routes its data
  group's whole batch, so its capacity is the batch's as in one
  process; the last position's logits are gathered over the data group,
  so every rank holds the whole batch's.

The specs the reference places its params and caches by stay computed
as tuples of ``repro_torch.dist.sharding`` (:func:`serve_param_specs`,
:func:`decode_specs`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch import tree
from repro_torch.devices import resolve_device
from repro_torch.dist import sharding as shd
from repro_torch.dist.tensor_parallel import (ModelAxis, Placement,
                                              check_split)
from repro_torch.launch.mesh import (data_axes_of, data_world_size,
                                     model_axis_size, parse_mesh)
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.models.config import ModelConfig

MODES = ("2d", "model-only")


def serve_param_spec(path, shape, joint, data_size: int, model_size: int,
                     mode: str = "2d") -> tuple:
    """One leaf's serving spec: the model axis by the train rules and,
    in ``"2d"``, ``joint`` (the data axes) on the largest remaining dim
    that ``data_size`` divides."""
    shape = tuple(int(x) for x in shape)
    base = shd.param_spec(path, shape, "model", model_size)
    spec = list(base) + [None] * (len(shape) - len(base))
    if mode == "2d":
        for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
            if spec[d] is None and shape[d] % data_size == 0 and \
                    shape[d] >= data_size:
                spec[d] = joint
                break
    return tuple(spec)


def serve_param_specs(params, mesh, mode: str = "2d"):
    """Param specs for serving.  ``"2d"``: the model axis by the train
    rules plus the joint data axes on the largest remaining dim that
    divides (ZeRO-3-style at rest); ``"model-only"``: the model axis
    alone.  ``params`` may be meta tensors; returns ``{path name:
    spec}``, as ``dist.sharding.param_specs``."""
    mesh = parse_mesh(mesh)
    data_axes = data_axes_of(mesh)
    joint = data_axes if len(data_axes) > 1 else data_axes[0]
    dsize, msize = data_world_size(mesh), model_axis_size(mesh)
    return shd.by_leaf(params, lambda path, leaf: serve_param_spec(
        path, leaf.shape, joint, dsize, msize, mode))


def decode_specs(cfg: ModelConfig, mesh, batch: int, s_max: int,
                 cache_dtype=None):
    """``(param specs, cache specs, token spec)`` for decode: the specs
    of the reference's ``decode_shardings``, from meta shapes."""
    mesh = parse_mesh(mesh)
    data_axes = data_axes_of(mesh)
    dsize = data_world_size(mesh)
    joint = data_axes if len(data_axes) > 1 else data_axes[0]
    pspecs = serve_param_specs(init_params(cfg, 0, "meta"), mesh)
    cspecs = shd.cache_specs(
        init_cache(cfg, batch, s_max, cache_dtype, device="meta"),
        data_axes, dsize, "model", model_axis_size(mesh))
    tok_spec = (joint,) if batch % dsize == 0 and batch >= dsize else ()
    return pspecs, cspecs, tok_spec


def _cut_dim(pl: Placement) -> Optional[int]:
    """The dim of ``pl.shard_shape`` that the model axis cuts."""
    if pl.replicated:
        return None
    return next(d for d, (a, b) in enumerate(zip(pl.shard_shape, pl.shape))
                if a != b)


def at_rest_data_dim(path, shape, pl: Placement, data_size: int,
                     model_size: int) -> Optional[int]:
    """The dim of a model rank's shard (``pl.shard_shape``) that mode
    ``"2d"`` cuts into ``data_size`` pieces, or None (the shard is kept
    whole on every rank of the data group).  Where the placement is the
    reference's model spec (the same view and split dim: every leaf but
    the ones the port places itself, ``dist/tensor_parallel.py``), the
    dim the reference's ``serve_param_specs`` puts the data axes on;
    elsewhere the largest dim of the shard besides the model's that
    ``data_size`` divides.  Never a leaf's stacked dim: a rank gathers
    one layer at a time, so each rank holds a piece of every layer
    (where the reference picks the stacked dim, the next such dim)."""
    if data_size == 1:
        return None
    shape = tuple(int(x) for x in shape)
    lo = 1 if str(path[0]) == "stack" else 0
    model_spec = shd.param_spec(path, shape, "model", model_size)
    if pl.view == pl.shape and pl.dim == shd.sharded_dim(model_spec):
        spec = serve_param_spec(path, shape, "data", data_size, model_size)
        if "data" not in spec:
            return None
        if spec.index("data") >= lo:
            return spec.index("data")
    ss, cut = pl.shard_shape, _cut_dim(pl)
    for d in sorted(range(lo, len(ss)), key=lambda d: -ss[d]):
        if d != cut and ss[d] % data_size == 0 and ss[d] >= data_size:
            return d
    return None


class LeafPlace(NamedTuple):
    """Where a serving rank's piece of one leaf comes from: the model
    placement ``pl``, the dim ``data_dim`` of the shard cut over the
    data axis (None: the whole shard), and whether the leaf is stacked
    (its leading dim the layer pattern's reps)."""
    pl: Placement
    data_dim: Optional[int]
    stacked: bool


def _anb(shape, dim: int) -> tuple:
    return (math.prod(shape[:dim]), shape[dim], math.prod(shape[dim + 1:]))


def _own(i: torch.Tensor, n: int, b: int, parts: int, part: int):
    """Flat indices ``i`` of an ``(a, n, b)`` array -> ``(their index in
    slice ``part`` of ``parts`` along ``n``, whether they fall in it)``."""
    q = torch.div(i, b, rounding_mode="floor")
    ib = i - q * b
    ia = torch.div(q, n, rounding_mode="floor")
    iq = q - ia * n
    m = n // parts
    return (ia * m + iq % m) * b + ib, torch.div(
        iq, m, rounding_mode="floor") == part


class ServePlacement:
    """A serving rank's place on the mesh, made once from ``params``
    (the whole params' shapes: meta tensors will do) and ``wire`` (the
    launch's ``ProcessGroupWire``): its model ``axis`` (None at ``M =
    1``) and ``placements`` (``check_split``: serving refuses the splits
    training refuses, naming the leaf), its data group (``wire``'s joint
    data axes: ``data_size``, ``data_rank``), and each leaf's
    :class:`LeafPlace` (``places``, by path name) in ``mode``.

    ``timer`` (a ``launch/serve._Timer``, set by ``launch/serve.py``)
    times each block's gather under ``"gather_" + phase``."""

    def __init__(self, cfg: ModelConfig, wire, params, mode: str = "2d"):
        if mode not in MODES:
            raise ValueError(f"serving mode must be one of {MODES}, got "
                             f"{mode!r}")
        self.wire = wire
        M, D = wire.model_size, wire.world
        self.axis = ModelAxis(wire) if M > 1 else None
        self.model_rank, self.model_size = wire.model_rank, M
        self.data_rank, self.data_size = wire.rank, D
        pairs = tree.flatten_with_path(params)[0]
        self.placements = check_split(cfg, params, M)
        self.places = {}
        for (path, leaf), pl in zip(pairs, self.placements):
            ddim = (at_rest_data_dim(path, leaf.shape, pl, D, M)
                    if mode == "2d" else None)
            self.places[tree.path_name(path)] = LeafPlace(
                pl, ddim, str(path[0]) == "stack")
        self.gathers = any(p.data_dim is not None
                           for p in self.places.values())
        self.timer, self.phase = None, ""

    # -- pieces at rest --

    def cut(self, path, x: torch.Tensor, model_rank: Optional[int] = None,
            data_rank: Optional[int] = None) -> torch.Tensor:
        """The at-rest piece of the whole leaf ``x`` at ``path`` (for a
        stacked leaf, any number of its reps), in storage of its own;
        this rank's unless ``model_rank`` / ``data_rank`` name another."""
        place = self.places[tree.path_name(path)]
        r = self.model_rank if model_rank is None else model_rank
        j = self.data_rank if data_rank is None else data_rank
        pl = place.pl
        if not pl.replicated:
            lead = (x.shape[0],) if place.stacked else ()
            k = len(lead)
            n = pl.view[pl.dim] // self.model_size
            x = x.reshape(lead + pl.view[k:]).narrow(pl.dim, r * n, n) \
                .reshape(lead + pl.shard_shape[k:])
        if place.data_dim is not None:
            n = x.shape[place.data_dim] // self.data_size
            x = x.narrow(place.data_dim, j * n, n)
        return x.clone(memory_format=torch.contiguous_format)

    def cut_tree(self, params, **kw):
        """:meth:`cut` of every leaf of the whole ``params``."""
        pairs, td = tree.flatten_with_path(params)
        return tree.unflatten(td, [self.cut(p, x, **kw) for p, x in pairs])

    def locate(self, name: str, idx: torch.Tensor) -> torch.Tensor:
        """Flat indices of the whole leaf ``name`` (int64; negative for
        none) -> their flat index in this rank's piece, or -1 where they
        fall in another rank's."""
        place = self.places[name]
        pl = place.pl
        ok = idx >= 0
        if not pl.replicated:
            _, n, b = _anb(pl.view, pl.dim)
            idx, mine = _own(idx, n, b, self.model_size, self.model_rank)
            ok &= mine
        if place.data_dim is not None:
            _, n, b = _anb(pl.shard_shape, place.data_dim)
            idx, mine = _own(idx, n, b, self.data_size, self.data_rank)
            ok &= mine
        return torch.where(ok, idx, torch.full_like(idx, -1))

    # -- the data group --

    def constrain(self, sub, prefix: tuple, rep: Optional[int] = None):
        """The model shards of the block ``sub`` (this rank's pieces of
        the params at ``prefix``; with ``rep``, of that rep of the
        stacked leaves): the pieces cut over the data axis gathered in
        one all-gather over the data group, the others as they are."""
        pairs, td = tree.flatten_with_path(sub)
        leaves, dims = [], []
        for path, x in pairs:
            place = self.places[tree.path_name(prefix + path)]
            d = place.data_dim
            if rep is not None:
                x = x[rep]
                d = None if d is None else d - 1
            leaves.append(x)
            dims.append(d)
        cut = [i for i, d in enumerate(dims) if d is not None]
        if cut:
            t0 = self.timer.mark() if self.timer else None
            (got,) = self.wire.all_gather(
                [tuple(leaves[i].contiguous() for i in cut)],
                self.wire.data_axes)
            for i, g in zip(cut, got):
                leaves[i] = torch.cat(list(g.unbind(0)), dim=dims[i])
            if self.timer:
                self.timer.add("gather_" + self.phase, t0)
        return tree.unflatten(td, leaves)

    def splits(self, batch: int) -> bool:
        """Whether the data groups split a batch of ``batch`` sequences
        (``D`` divides it), else each serves the whole batch."""
        return self.data_size > 1 and batch % self.data_size == 0

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The data group's rows of ``x`` (dim 0), in data-rank order."""
        (g,) = self.wire.all_gather([x.contiguous()], self.wire.data_axes)
        return g.reshape((-1,) + tuple(x.shape[1:]))

    def own_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This data group's rows of the whole batch ``x``."""
        b = x.shape[0] // self.data_size
        return x[self.data_rank * b:(self.data_rank + 1) * b]

    def step_kw(self, batch: int) -> dict:
        """The model's serving keywords for a batch of ``batch``."""
        return {"axis": self.axis,
                "constrain": self.constrain if self.gathers else None,
                "batch_group": self if self.splits(batch) else None}


def make_prefill_step(cfg: ModelConfig, device="cuda", *,
                      s_max: Optional[int] = None, cache_dtype=None,
                      placed: Optional[ServePlacement] = None):
    """``prefill_step(params, prompt) -> (logits, cache)``: ``prompt``
    the (B, T) tokens, or for an ``embeds`` frontend the (B, T,
    d_model) embeddings, moved to ``device``; ``logits`` the last
    position's (B, 1, vocab); the cache sized for ``s_max``.  With
    ``placed`` (a :class:`ServePlacement`), ``params`` are the rank's
    pieces, the cache is its own rows and heads, and the logits are the
    whole batch's."""
    device = resolve_device(device)
    kw = "embeds" if cfg.frontend == "embeds" else "tokens"

    def step(params, prompt):
        prompt = prompt.to(device)
        extra = {}
        if placed is not None:
            placed.phase = "prefill"
            extra = placed.step_kw(prompt.shape[0])
            if extra["batch_group"] is not None:
                prompt = placed.own_rows(prompt)
        logits, cache, _ = prefill(params, cfg, s_max=s_max,
                                   cache_dtype=cache_dtype,
                                   **{kw: prompt}, **extra)
        if extra.get("batch_group") is not None:
            logits = placed.gather_rows(logits)
        return logits, cache

    return step


def make_decode_step(cfg: ModelConfig, device="cuda", *,
                     placed: Optional[ServePlacement] = None):
    """``step(params, cache, pos, tok) -> (logits, cache)``: one token a
    sequence (``tok`` (B, 1), moved to ``device``; for an ``embeds``
    frontend a (B, 1, d_model) ``tok`` is an embedding) at absolute
    position ``pos`` against the cache, which is updated in place.
    With ``placed``, as :func:`make_prefill_step`: ``tok`` is the whole
    batch's and the logits are the whole batch's."""
    device = resolve_device(device)

    def step(params, cache, pos, tok):
        kw = ("embeds" if cfg.frontend == "embeds" and tok.ndim == 3
              else "tokens")
        tok = tok.to(device)
        extra = {}
        if placed is not None:
            placed.phase = "decode"
            extra = placed.step_kw(tok.shape[0])
            if extra["batch_group"] is not None:
                tok = placed.own_rows(tok)
        logits, cache = decode_step(params, cfg, cache, int(pos),
                                    **{kw: tok}, **extra)
        if extra.get("batch_group") is not None:
            logits = placed.gather_rows(logits)
        return logits, cache

    return step
