"""Decoder LM of every assigned architecture family: init, forward and
loss, and the serving entry points, the serve cache, ``prefill`` and
``decode_step`` (port of ``repro/models/model.py``, lines 39-409), plus
the weight converter.

A model is a cycled ``block_pattern`` (attn / swa / mamba / mlstm /
slstm) crossed with a cycled ``ffn_pattern`` (mlp / moe / none); the
MoE layers add their load-balance loss to the cross-entropy.  An
``embeds`` frontend (audio / VLM: precomputed frame or patch
embeddings) feeds ``(B, T, d_model)`` embeddings where a token model
looks its tokens up; decode feeds its generated tokens through
``embed`` either way.

Params keep the JAX package's tree leaf for leaf: ``embed``,
``final_norm``, ``lm_head``, ``stack`` (one dict per position of the
layer pattern, each leaf carrying a leading ``reps`` axis — the
``lax.scan`` stacking) and ``tail``.  The selection of the compressed
pipeline runs over whole leaves, so a per-layer split would change every
``k``; the forward therefore ``unbind``s each stacked leaf once per step
(one stacked gradient per leaf in the backward, no per-layer copies).

Training rematerialises each layer-pattern period, as the reference's
``forward(remat=True)`` wraps each period of its scan in
``jax.checkpoint`` (``model.py:144-176``): ``loss_fn`` and ``forward``
run each of the ``reps`` periods through ``torch.utils.checkpoint``
(non-reentrant), which keeps the period's input ``h`` and recomputes its
activations in the backward, one period at a time.  The tail layers are
not rematerialised (the reference's ``:181-187``); ``prefill`` and
``decode_step`` never are.  The recompute runs the same operations on
the same inputs, so the loss and the gradients are those of
``remat=False`` bit for bit; under tensor parallelism it re-issues the
period's forward all-reduces inside the backward, in the same order on
every rank.  It is what lets llama3.2-1b train at 8 × 1024 on one
card: without it each layer keeps ~3 GB of activations there (the f32
attention probabilities, the MLP's), ~50 GB for 16 layers beside the
training state; with it the peak is one period's recompute.  Under
tensor parallelism ``cfg.shard_activations`` keeps each period's input
as the rank's ``1 / M`` slice of ``d_model`` (:func:`_forward`).

Caches keep the reference's tree: ``{"stack": [one dict a position of
the layer pattern, leaves (reps, B, ...)], "tail": [one dict a tail
layer]}``; an attention layer's dict holds ``k`` and ``v`` (post-RoPE
keys) ``(B, n, KV, hd)``, with ``n`` ``s_max`` or, for a
sliding-window layer, ``min(sliding_window, s_max)`` (a ring indexed by
``pos % n``); a Mamba layer's ``ssm`` ``(B, d_inner, n)`` f32 and
``conv`` ``(B, W, d_inner)``; an mLSTM's ``C``, ``n``, ``m`` and an
sLSTM's ``h``, ``c``, ``n``, ``m``, f32.  Unlike the reference's
functional updates, ``prefill`` fills a new cache and ``decode_step``
writes every layer's slot or recurrent state IN PLACE and returns the
same cache.

``loss_fn``, ``prefill`` and ``decode_step`` also run on one model
rank's shards (tensor parallelism over the model axis: ``axis``, a
``dist/tensor_parallel.ModelAxis``), for every block kind, each split
Megatron-wise by the placement of ``dist/tensor_parallel.py``: attention
and the MLP (``layers.py``), the MoE experts by hidden units with the
routing on every rank (``moe.py``), Mamba by channels (``ssm.py``),
mLSTM and sLSTM by heads (``xlstm.py``); ``embed`` split on ``d_model``
(the lookup gathers the hidden width), ``lm_head`` on the vocab (the
cross-entropy reduces over the model group; serving gathers the last
position's logits). The residual stream and the norms are replicated; a
rank's serve cache holds its own heads and channels.
"""
from __future__ import annotations

import sys
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import prng, tree
from repro_torch.devices import resolve_device
from repro_torch.dist.tensor_parallel import (copy_to_model,
                                              gather_from_model,
                                              reduce_from_model,
                                              split_to_model)
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.config import ModelConfig


def _init_block(key, cfg: ModelConfig, kind: str, ffn: str, dtype, device):
    kb, kf = prng.split(key)
    p: Dict[str, Any] = {"norm1": L.init_rmsnorm(cfg.d_model, dtype, device)}
    if kind in ("attn", "swa"):
        p["core"] = L.init_attention(kb, cfg, dtype, device)
    elif kind == "mamba":
        p["core"] = S.init_mamba(kb, cfg, dtype, device)
    elif kind == "mlstm":
        p["core"] = X.init_mlstm(kb, cfg, dtype, device)
    elif kind == "slstm":
        p["core"] = X.init_slstm(kb, cfg, dtype, device)
    else:
        raise ValueError(kind)
    if ffn == "mlp":
        p["norm2"] = L.init_rmsnorm(cfg.d_model, dtype, device)
        p["ffn"] = L.init_mlp(kf, cfg.d_model, cfg.d_ff, dtype, device)
    elif ffn == "moe":
        p["norm2"] = L.init_rmsnorm(cfg.d_model, dtype, device)
        p["ffn"] = M.init_moe(kf, cfg, dtype, device)
    return p


def _whole(path, leaf):
    return leaf


def _init_stacked(keys, cfg: ModelConfig, kind: str, ffn: str, dtype,
                  device, cut=_whole, prefix=()):
    """One position of the layer pattern over its ``len(keys)`` reps:
    each rep drawn from its own key (the reference ``vmap``s
    ``_init_block`` over them) and copied into ``(reps, ...)`` leaves,
    rep by rep (no stack of per-rep copies).  ``cut(path, leaf)`` keeps
    its part of each rep's leaf, given as ``(1, ...)``."""
    rep, td = tree.flatten_with_path(_init_block(keys[0], cfg, kind, ffn,
                                                 dtype, device))
    out = []
    for path, x in rep:
        kept = cut(prefix + path, torch.empty((1,) + x.shape, dtype=x.dtype,
                                              device="meta"))
        out.append(torch.empty((len(keys),) + kept.shape[1:],
                               dtype=x.dtype, device=device))
    for r, key in enumerate(keys):
        if r:
            rep = tree.flatten_with_path(_init_block(key, cfg, kind, ffn,
                                                     dtype, device))[0]
        for o, (path, x) in zip(out, rep):
            o[r].copy_(cut(prefix + path, x[None])[0])
        del rep
    return tree.unflatten(td, out)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda", *,
                cut=None) -> Dict[str, Any]:
    """Random params on ``device`` (the card unless told ``"cpu"``;
    raises without a GPU), drawn from ``repro_torch.prng`` with the
    reference's key tree from ``PRNGKey(seed)``: the reference's
    ``init_params(cfg, PRNGKey(seed))`` within ``normal``'s tolerance
    (rtol 1e-5).  On the card the draws are ``threefry_bits`` launches,
    one a weight matrix a layer.  On the ``meta`` device it returns the
    shapes alone.

    ``cut(path, leaf)`` keeps a part of each leaf as it is drawn (a
    serving rank's piece, ``serve/steps.ServePlacement.cut``): a leaf
    under ``stack`` is handed over one rep at a time, as ``(1, ...)``,
    so the transient is one block, or one leaf outside the stack; the
    parts kept are the cut of the whole draw, bitwise."""
    cfg.validate()
    device = resolve_device(device)
    cut = cut or _whole
    dtype = getattr(torch, cfg.param_dtype)
    period = cfg.pattern_period
    reps, tail = divmod(cfg.num_layers, period)
    k_embed, k_head, k_layers = prng.split(prng.PRNGKey(seed), 3)
    params: Dict[str, Any] = {
        "embed": cut(("embed",), L.dense_init(
            k_embed, (cfg.vocab_size, cfg.d_model), dtype,
            fan_in=cfg.vocab_size, scale=1.0, device=device)),
        "final_norm": {"scale": cut(("final_norm", "scale"), L.init_rmsnorm(
            cfg.d_model, dtype, device)["scale"])},
        "lm_head": cut(("lm_head",), L.dense_init(
            k_head, (cfg.d_model, cfg.vocab_size), dtype,
            fan_in=cfg.d_model, device=device)),
    }
    lkeys = prng.split(k_layers, cfg.num_layers)
    params["stack"] = [
        _init_stacked([lkeys[r * period + pos] for r in range(reps)], cfg,
                      *cfg.layer_sig(pos), dtype, device, cut,
                      ("stack", pos))
        for pos in range(period if reps else 0)]
    params["tail"] = []
    for i in range(tail):
        pairs, td = tree.flatten_with_path(_init_block(
            lkeys[reps * period + i], cfg, *cfg.layer_sig(reps * period + i),
            dtype, device))
        params["tail"].append(tree.unflatten(
            td, [cut(("tail", i) + path, x) for path, x in pairs]))
    return params


def param_count(params) -> int:
    """The number of parameters in ``params`` (tensors, or meta)."""
    return sum(int(x.numel()) for x in tree.leaves(params))


def _apply_core(p, h, cfg: ModelConfig, kind: str, axis=None):
    """Full-sequence core: ``(out, cache contribution)`` — the
    attention's post-RoPE ``(k, v)``, a Mamba layer's ``(ssm state, conv
    tail)``, an xLSTM layer's final state."""
    if kind in ("attn", "swa"):
        window = cfg.sliding_window if kind == "swa" else 0
        return L.attention(p, h, cfg, window=window, axis=axis)
    if kind == "mamba":
        out, ssm_state, conv_tail = S.mamba_forward(p, h, cfg, axis=axis)
        return out, (ssm_state, conv_tail)
    if kind == "mlstm":
        return X.mlstm_forward(p, h, cfg, axis=axis)
    if kind == "slstm":
        return X.slstm_forward(p, h, cfg, axis=axis)
    raise ValueError(kind)


def _ffn(p, x, cfg: ModelConfig, ffn: str, axis=None, batch_group=None):
    """``(out, aux)`` of the layer's FFN; ``aux`` is None but for MoE.
    With ``batch_group`` (a serving data group that splits the batch:
    ``gather_rows``, ``own_rows``) an MoE layer routes the group's whole
    batch and keeps its own rows, so that the experts' capacity is the
    whole batch's, as in one process."""
    if ffn == "moe":
        if batch_group is None:
            return M.moe_ffn(p, x, cfg, axis)
        out, aux = M.moe_ffn(p, batch_group.gather_rows(x), cfg, axis)
        return batch_group.own_rows(out), aux
    return L.mlp(p, x, axis), None


def _apply_block(p, h, cfg: ModelConfig, kind: str, ffn: str, axis=None,
                 batch_group=None):
    """Returns ``(h, aux, cache contribution)``: the block's output, its
    MoE load-balance loss (None without MoE) and its core's cache
    contribution (what a prefill stores)."""
    normed = L.rmsnorm(p["norm1"], h)
    core_out, contrib = _apply_core(p["core"], normed, cfg, kind, axis)
    if cfg.parallel_block and ffn != "none":
        f_out, aux = _ffn(p["ffn"], normed, cfg, ffn, axis, batch_group)
        return h + core_out + f_out, aux, contrib
    h = h + core_out
    aux = None
    if ffn != "none":
        f_out, aux = _ffn(p["ffn"], L.rmsnorm(p["norm2"], h), cfg, ffn,
                          axis, batch_group)
        h = h + f_out
    return h, aux, contrib


def _unbind(stacked) -> list:
    """A stacked layer dict as a list of per-rep dicts of views."""
    leaves, td = tree.flatten(stacked)
    parts = [x.unbind(0) for x in leaves]
    reps = len(parts[0]) if parts else 0
    return [tree.unflatten(td, [p[r] for p in parts]) for r in range(reps)]


def _embed_input(params, cfg: ModelConfig, tokens, embeds, axis=None):
    """The residual stream's input: the embeddings given, or the
    tokens' rows of ``embed`` (with ``axis``, the shards of the hidden
    width gathered over the model group).  F.embedding, not
    ``params["embed"][tokens]``: the indexing's backward (``index_put_``
    with accumulate) adds repeated tokens' rows in a thread-dependent
    order on the CPU and with atomics on the card; embedding's backward
    is deterministic on both."""
    adt = getattr(torch, cfg.activation_dtype)
    if embeds is not None:
        return embeds.to(adt)
    return gather_from_model(F.embedding(tokens, params["embed"]),
                             axis).to(adt)


def _head(params, cfg: ModelConfig, h, axis=None):
    adt = getattr(torch, cfg.activation_dtype)
    h = copy_to_model(L.rmsnorm(params["final_norm"], h), axis)
    return h @ params["lm_head"].to(adt)


def _period(h, reps_p, cfg: ModelConfig, axis=None):
    """One layer-pattern period on ``h`` (``reps_p``: one param dict a
    position of the pattern): ``(h, aux)``, ``aux`` the period's MoE
    load-balance losses summed (0 without MoE)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for pos, p in enumerate(reps_p):
        kind, ffn = cfg.layer_sig(pos)
        h, a, _ = _apply_block(p, h, cfg, kind, ffn, axis)
        if a is not None:
            aux = aux + a
    return h, aux


def _sharded_period(h_shard, reps_p, cfg: ModelConfig, axis):
    """:func:`_period` of the period's input kept as this model rank's
    slice of ``d_model`` (``cfg.shard_activations``): the slices are
    gathered into the whole ``h`` first, in the recompute too."""
    return _period(gather_from_model(h_shard, axis), reps_p, cfg, axis)


def _forward(params, cfg: ModelConfig, tokens=None, embeds=None,
             axis=None, remat: bool = True):
    """Full-sequence forward -> ``(logits (B, T, vocab), aux)``: ``aux``
    the MoE layers' load-balance loss, summed a period at a time over
    the reps and then over the tail as the reference's scan sums it (0
    without MoE).  With ``axis``, this model rank's vocab columns of the
    logits.  With ``remat``, each period is a checkpointed region whose
    inputs are ``h`` and the period's views of the stacked params, and
    whose outputs are ``h`` and the period's aux; the forward draws no
    random numbers, so no RNG state is kept for the recompute.  With
    ``cfg.shard_activations`` and ``axis``, the checkpoint keeps this
    rank's ``d_model / M`` slice of each period's input ``h`` (a copy of
    its own, :func:`~repro_torch.dist.tensor_parallel.split_to_model`)
    and gathers the whole ``h`` as its first operation, the reference's
    model-sharded layer-boundary carry (``model.py:162-168``); both are
    exact copies, so the loss and every gradient keep their bits.  The
    tail layers are not touched, as in the reference."""
    h = _embed_input(params, cfg, tokens, embeds, axis)
    period = cfg.pattern_period
    reps = cfg.num_layers // period
    per_pos = [_unbind(sp) for sp in params["stack"]]
    sharded = cfg.shard_activations and axis is not None
    rep_aux = []
    for r in range(reps):
        reps_p = [per_pos[pos][r] for pos in range(period)]
        if remat:
            h, a_rep = checkpoint(_sharded_period if sharded else _period,
                                  split_to_model(h, axis) if sharded else h,
                                  reps_p, cfg, axis, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            h, a_rep = _period(h, reps_p, cfg, axis)
        rep_aux.append(a_rep)
    aux = (torch.stack(rep_aux).sum() if rep_aux else
           torch.zeros((), dtype=torch.float32, device=h.device))
    base = reps * period
    for i, p in enumerate(params["tail"]):
        h, a, _ = _apply_block(p, h, cfg, *cfg.layer_sig(base + i),
                               axis=axis)
        if a is not None:
            aux = aux + a
    return _head(params, cfg, h, axis), aux


def forward(params, cfg: ModelConfig, tokens=None, *, embeds=None,
            remat: bool = True) -> torch.Tensor:
    """Full-sequence forward of ``tokens`` (B, T) or ``embeds`` (B, T,
    d_model) -> logits ``(B, T, vocab)``; ``remat`` as in
    :func:`_forward`."""
    return _forward(params, cfg, tokens, embeds, remat=remat)[0]


def _vocab_parallel_ll(logits, labels, axis):
    """``log softmax`` at ``labels`` from this rank's columns ``[lo, lo +
    V)`` of the logits: the max and the sum of exponentials reduced over
    the model group, the picked logit from the rank that owns the
    label."""
    V = logits.shape[-1]
    m = axis.amax(torch.amax(logits.detach(), dim=-1))
    lse = m + torch.log(reduce_from_model(
        torch.sum(torch.exp(logits - m[..., None]), dim=-1), axis))
    labels = labels - axis.rank * V
    own = (labels >= 0) & (labels < V)
    picked = torch.gather(logits, -1, labels.clamp(0, V - 1)[..., None])
    picked = reduce_from_model(
        torch.where(own, picked[..., 0], torch.zeros_like(picked[..., 0])),
        axis)
    return picked - lse


def loss_fn(params, cfg: ModelConfig, batch, axis=None,
            remat: bool = True) -> tuple:
    """Cross-entropy plus the MoE load-balance loss of ``batch =
    {"tokens" or "embeds", "labels"[, "loss_mask"]}``: ``(loss, {"ce",
    "aux", "loss"})`` as in ``model.py:192-212``.  With ``axis``, on this
    model rank's shards, the same on every rank.  ``remat`` (the
    reference's default, True) rematerialises each layer-pattern period
    in the backward (:func:`_forward`); the result is the same bits."""
    logits, aux = _forward(params, cfg, batch.get("tokens"),
                           batch.get("embeds"), axis, remat)
    logits = logits.to(torch.float32)
    labels = batch["labels"].long()
    if axis is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None])[..., 0] - lse
    else:
        ll = _vocab_parallel_ll(logits, labels, axis)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(ll)
    ce = -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    loss = ce + aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _cache_len(cfg: ModelConfig, kind: str, s_max: int) -> int:
    if kind == "swa":
        return min(cfg.sliding_window, s_max)
    return s_max


def _init_layer_cache(cfg: ModelConfig, kind: str, B: int, s_max: int,
                      dtype, device, lead=(), model_size: int = 1):
    """One layer's zero cache, ``lead`` dims first (the recurrent
    states in f32, as the reference keeps them), of a model rank's
    ``1 / model_size`` of the KV heads, Mamba channels or xLSTM heads."""
    lead = tuple(lead)
    M = model_size
    if kind in ("attn", "swa"):
        shape = lead + (B, _cache_len(cfg, kind, s_max),
                        cfg.num_kv_heads // M, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if kind == "mamba":
        di = cfg.d_inner // M
        return {"ssm": torch.zeros(lead + (B, di, cfg.ssm_state_dim),
                                   dtype=torch.float32, device=device),
                "conv": torch.zeros(lead + (B, cfg.ssm_conv_width, di),
                                    dtype=dtype, device=device)}
    if kind == "mlstm":
        return X.mlstm_init_state(B, cfg, device, lead,
                                  heads=cfg.num_heads // M)
    if kind == "slstm":
        return X.slstm_init_state(B, cfg, device, lead,
                                  heads=cfg.num_heads // M)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, B: int, s_max: int, dtype=None,
               device="cuda", axis=None):
    """The zero serve cache of ``B`` sequences of up to ``s_max``
    positions, in ``dtype`` (the activation dtype by default; the
    recurrent states are f32), on ``device`` (the card unless told
    ``"cpu"``).  With ``axis``, a model rank's cache, placed like its
    params (``dist/tensor_parallel.placement``): the KV caches on their
    KV-head dim, Mamba's ``ssm`` and ``conv`` on ``d_inner``, the mLSTM
    and sLSTM states on their head dim."""
    device = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.activation_dtype)
    M = 1 if axis is None else axis.size
    period = cfg.pattern_period
    reps, tail = divmod(cfg.num_layers, period)
    stack = [_init_layer_cache(cfg, cfg.block_kind(pos), B, s_max, dtype,
                               device, lead=(reps,), model_size=M)
             for pos in range(period if reps else 0)]
    tail_caches = [_init_layer_cache(cfg, cfg.block_kind(reps * period + i),
                                     B, s_max, dtype, device, model_size=M)
                   for i in range(tail)]
    return {"stack": stack, "tail": tail_caches}


def _store_prefill(kind: str, contrib, cache):
    """Write a full-sequence cache contribution into one layer's (zero)
    cache, in place.  A ring shorter than the prompt keeps the last
    ``n`` entries at their absolute positions modulo ``n``; a Mamba
    layer's conv tail goes to the buffer's last slots (``W - len`` on);
    a recurrent state is copied."""
    if kind in ("attn", "swa"):
        k, v = contrib
        n = cache["k"].shape[1]
        T = k.shape[1]
        if T >= n:
            ring = torch.arange(T - n, T, device=k.device) % n
            cache["k"].index_copy_(1, ring, k[:, -n:].to(cache["k"].dtype))
            cache["v"].index_copy_(1, ring, v[:, -n:].to(cache["v"].dtype))
        else:
            cache["k"][:, :T].copy_(k)
            cache["v"][:, :T].copy_(v)
        return cache
    if kind == "mamba":
        ssm_state, conv_tail = contrib
        cache["ssm"].copy_(ssm_state)
        W = cache["conv"].shape[1]
        cache["conv"][:, W - conv_tail.shape[1]:].copy_(conv_tail)
        return cache
    for name, x in contrib.items():
        cache[name].copy_(x)
    return cache


def _layers(params, cache, cfg: ModelConfig, constrain=None):
    """``(p, c, kind, ffn)`` of every layer in execution order: the
    stacked positions rep by rep, then the tail; ``p`` and ``c`` are
    views into the stacked leaves.  With ``constrain`` (serving's
    counterpart of the reference's ``serve_constrain``), each rep's
    params come from ``constrain(params["stack"], ("stack",), r)`` and
    each tail layer's from ``constrain(p, ("tail", i))``."""
    period = cfg.pattern_period
    reps = cfg.num_layers // period
    cache_pos = [_unbind(sc) for sc in cache["stack"]]
    per_pos = None if constrain else [_unbind(sp) for sp in params["stack"]]
    for r in range(reps):
        rep = (constrain(params["stack"], ("stack",), r) if constrain
               else [pp[r] for pp in per_pos])
        for pos in range(period):
            yield (rep[pos], cache_pos[pos][r]) + cfg.layer_sig(pos)
    base = reps * period
    for i, (p, c) in enumerate(zip(params["tail"], cache["tail"])):
        if constrain is not None:
            p = constrain(p, ("tail", i))
        yield (p, c) + cfg.layer_sig(base + i)


def _serve_input(params, cfg: ModelConfig, tokens, embeds, axis,
                 constrain):
    if embeds is None and constrain is not None:
        params = constrain({"embed": params["embed"]}, ())
    return _embed_input(params, cfg, tokens, embeds, axis)


def _serve_head(params, cfg: ModelConfig, h, axis, constrain):
    """The logits of ``h`` over the whole vocabulary: with ``axis``,
    every model rank's columns gathered in rank order."""
    if constrain is not None:
        params = constrain({"final_norm": params["final_norm"],
                            "lm_head": params["lm_head"]}, ())
    return gather_from_model(_head(params, cfg, h, axis), axis)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens=None, *, embeds=None,
            s_max=None, cache_dtype=None, axis=None, constrain=None,
            batch_group=None):
    """Run the prompt, ``tokens`` (B, T) or ``embeds`` (B, T, d_model):
    ``(last-position logits (B, 1, vocab), cache, next position T)``,
    the cache sized for ``s_max`` positions (T by default) on the
    prompt's device.

    Serving placed over the mesh (``serve/steps.py``) passes this model
    rank's ``axis`` (the cache is its heads' and channels', the logits
    are gathered to the whole vocabulary), ``constrain`` (a block's data
    pieces gathered before it runs) and ``batch_group`` (the data group
    whose whole batch an MoE layer routes)."""
    prompt = embeds if embeds is not None else tokens
    h = _serve_input(params, cfg, tokens, embeds, axis, constrain)
    B, T = prompt.shape[:2]
    s_max = s_max or T
    cache = init_cache(cfg, B, s_max, cache_dtype, device=prompt.device,
                       axis=axis)
    for p, c, kind, ffn in _layers(params, cache, cfg, constrain):
        h, _, contrib = _apply_block(p, h, cfg, kind, ffn, axis,
                                     batch_group)
        _store_prefill(kind, contrib, c)
    return _serve_head(params, cfg, h[:, -1:], axis, constrain), cache, T


def _decode_core(p, normed, cfg: ModelConfig, kind: str, cache, pos: int,
                 axis=None):
    """One token through a layer's core, its cache updated in place."""
    if kind in ("attn", "swa"):
        n = cache["k"].shape[1]
        # sliding-window layers write their ring at pos % n;
        # full-attention layers at the absolute position
        write_idx = pos % n if kind == "swa" else pos
        out, _, _ = L.attention_decode(p, normed, cache["k"], cache["v"],
                                       pos, write_idx, cfg, axis)
        return out
    if kind == "mamba":
        out, ssm, conv = S.mamba_decode(p, normed, cache["ssm"],
                                        cache["conv"], cfg, axis)
        new = {"ssm": ssm, "conv": conv}
    elif kind == "mlstm":
        out, new = X.mlstm_forward(p, normed, cfg, state=cache, axis=axis)
    elif kind == "slstm":
        out, new = X.slstm_forward(p, normed, cfg, state=cache, axis=axis)
    else:
        raise ValueError(kind)
    for name, x in new.items():
        cache[name].copy_(x)
    return out


def _decode_block(p, h, cfg: ModelConfig, kind: str, ffn: str, cache,
                  pos: int, axis=None, batch_group=None):
    normed = L.rmsnorm(p["norm1"], h)
    core_out = _decode_core(p["core"], normed, cfg, kind, cache, pos, axis)
    if cfg.parallel_block and ffn != "none":
        return h + core_out + _ffn(p["ffn"], normed, cfg, ffn, axis,
                                   batch_group)[0]
    h = h + core_out
    if ffn != "none":
        h = h + _ffn(p["ffn"], L.rmsnorm(p["norm2"], h), cfg, ffn, axis,
                     batch_group)[0]
    return h


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache, pos: int, tokens=None, *,
                embeds=None, axis=None, constrain=None, batch_group=None):
    """One decode step: ``tokens`` (B, 1) or ``embeds`` (B, 1, d_model)
    at absolute position ``pos`` (a Python int).  Returns ``(logits (B,
    1, vocab), cache)``, the cache updated in place.  ``axis``,
    ``constrain`` and ``batch_group`` as in :func:`prefill`."""
    h = _serve_input(params, cfg, tokens, embeds, axis, constrain)
    pos = int(pos)
    for p, c, kind, ffn in _layers(params, cache, cfg, constrain):
        h = _decode_block(p, h, cfg, kind, ffn, c, pos, axis, batch_group)
    return _serve_head(params, cfg, h, axis, constrain), cache


def _from_numpy(a) -> torch.Tensor:
    """A numpy array as a CPU tensor; a bf16 array (``ml_dtypes``'
    ``bfloat16``, which numpy knows only by name) through its 16-bit
    pattern, bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a, copy=True).view(np.uint16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; a bf16 tensor through its 16-bit
    pattern, as ``ml_dtypes.bfloat16`` when the caller has loaded that
    module (JAX does), else as the ``np.uint16`` bits.  The port never
    imports it: the card's machine may not have it."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    bits = t.view(torch.uint16).numpy()
    bf16 = getattr(sys.modules.get("ml_dtypes"), "bfloat16", None)
    return bits if bf16 is None else bits.view(bf16)


def from_jax_params(np_tree, device="cuda") -> Dict[str, Any]:
    """The JAX param tree as numpy arrays (``jax.tree.map(np.asarray,
    params)``) -> the port's params on ``device``: same leaves, shapes,
    names and dtypes, bf16 leaves bit for bit.  The card unless told
    ``"cpu"``; raises without a GPU."""
    device = resolve_device(device)
    return tree.tree_map(lambda a: _from_numpy(a).to(device), np_tree)


def to_numpy_tree(params) -> Dict[str, Any]:
    """The port's params -> the same tree of numpy arrays (bf16 leaves as
    :func:`_to_numpy` gives them)."""
    return tree.tree_map(_to_numpy, params)
