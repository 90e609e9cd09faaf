"""Dense decoder LM: init, forward and loss, and the serving entry
points, a KV cache, ``prefill`` and ``decode_step`` (port of the dense
path of ``repro/models/model.py``, lines 39-409), plus the weight
converter.

Params keep the JAX package's tree leaf for leaf: ``embed``,
``final_norm``, ``lm_head``, ``stack`` (one dict per position of the
layer pattern, each leaf carrying a leading ``reps`` axis — the
``lax.scan`` stacking) and ``tail``.  The selection of the compressed
pipeline runs over whole leaves, so a per-layer split would change every
``k``; the forward therefore ``unbind``s each stacked leaf once per step
(one stacked gradient per leaf in the backward, no per-layer copies).

No rematerialisation in this slice: llama3.2-1b's activations at batch
8 × 128 tokens are a few GB beside ~36 GB of f32 state.

Caches keep the reference's tree: ``{"stack": [one dict a position of
the layer pattern, leaves (reps, B, n, KV, hd)], "tail": [one dict a
tail layer, leaves (B, n, KV, hd)]}`` with ``k`` and ``v`` (post-RoPE
keys).  ``n`` is ``s_max``, or ``min(sliding_window, s_max)`` for a
sliding-window layer, whose cache is a ring indexed by ``pos % n``.
Unlike the reference's functional updates, ``prefill`` fills a new
cache and ``decode_step`` writes its one slot a layer IN PLACE and
returns the same cache.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import prng, tree
from repro_torch.devices import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.slices import not_ported

_BLOCKS = ("attn", "swa")
_FFNS = ("mlp", "none")


def require_dense(cfg: ModelConfig) -> ModelConfig:
    """Raise for an architecture this slice does not build."""
    kinds = set(cfg.block_pattern)
    ffns = set(cfg.ffn_pattern)
    if (cfg.frontend != "tokens" or not kinds <= set(_BLOCKS)
            or not ffns <= set(_FFNS)):
        raise not_ported(f"architecture {cfg.name!r} ({cfg.arch_type}: "
                         f"blocks {sorted(kinds)}, ffn {sorted(ffns)}, "
                         f"frontend {cfg.frontend})", "arch")
    return cfg


def _init_block(key, cfg: ModelConfig, kind: str, ffn: str, dtype, device):
    kb, kf = prng.split(key)
    p: Dict[str, Any] = {"norm1": L.init_rmsnorm(cfg.d_model, dtype, device)}
    p["core"] = L.init_attention(kb, cfg, dtype, device)
    if ffn == "mlp":
        p["norm2"] = L.init_rmsnorm(cfg.d_model, dtype, device)
        p["ffn"] = L.init_mlp(kf, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def _init_stacked(keys, cfg: ModelConfig, kind: str, ffn: str, dtype,
                  device):
    """One position of the layer pattern over its ``len(keys)`` reps:
    each rep drawn from its own key (the reference ``vmap``s
    ``_init_block`` over them) and copied into ``(reps, ...)`` leaves,
    rep by rep (no stack of per-rep copies)."""
    rep, td = tree.flatten(_init_block(keys[0], cfg, kind, ffn, dtype,
                                       device))
    out = [torch.empty((len(keys),) + x.shape, dtype=x.dtype, device=device)
           for x in rep]
    for r, key in enumerate(keys):
        if r:
            rep = tree.leaves(_init_block(key, cfg, kind, ffn, dtype,
                                          device))
        for o, x in zip(out, rep):
            o[r].copy_(x)
    return tree.unflatten(td, out)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"
                ) -> Dict[str, Any]:
    """Random params on ``device`` (the card unless told ``"cpu"``;
    raises without a GPU), drawn from ``repro_torch.prng`` with the
    reference's key tree from ``PRNGKey(seed)``: the reference's
    ``init_params(cfg, PRNGKey(seed))`` within ``normal``'s tolerance
    (rtol 1e-5).  On the card the draws are ``threefry_bits`` launches,
    one a weight matrix a layer.  On the ``meta`` device it returns the
    shapes alone."""
    require_dense(cfg.validate())
    device = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    period = cfg.pattern_period
    reps, tail = divmod(cfg.num_layers, period)
    k_embed, k_head, k_layers = prng.split(prng.PRNGKey(seed), 3)
    params: Dict[str, Any] = {
        "embed": L.dense_init(k_embed, (cfg.vocab_size, cfg.d_model), dtype,
                              fan_in=cfg.vocab_size, scale=1.0,
                              device=device),
        "final_norm": L.init_rmsnorm(cfg.d_model, dtype, device),
        "lm_head": L.dense_init(k_head, (cfg.d_model, cfg.vocab_size),
                                dtype, fan_in=cfg.d_model, device=device),
    }
    lkeys = prng.split(k_layers, cfg.num_layers)
    params["stack"] = [
        _init_stacked([lkeys[r * period + pos] for r in range(reps)], cfg,
                      *cfg.layer_sig(pos), dtype, device)
        for pos in range(period if reps else 0)]
    params["tail"] = [
        _init_block(lkeys[reps * period + i], cfg,
                    *cfg.layer_sig(reps * period + i), dtype, device)
        for i in range(tail)]
    return params


def _apply_block(p, h, cfg: ModelConfig, kind: str, ffn: str):
    """Returns ``(h, (k, v))``: the block's output and its attention's
    post-RoPE keys and values (a prefill's cache contribution)."""
    normed = L.rmsnorm(p["norm1"], h)
    window = cfg.sliding_window if kind == "swa" else 0
    core_out, kv = L.attention(p["core"], normed, cfg, window=window)
    if cfg.parallel_block and ffn != "none":
        return h + core_out + L.mlp(p["ffn"], normed), kv
    h = h + core_out
    if ffn == "mlp":
        h = h + L.mlp(p["ffn"], L.rmsnorm(p["norm2"], h))
    return h, kv


def _unbind(stacked) -> list:
    """A stacked layer dict as a list of per-rep dicts of views."""
    leaves, td = tree.flatten(stacked)
    parts = [x.unbind(0) for x in leaves]
    reps = len(parts[0]) if parts else 0
    return [tree.unflatten(td, [p[r] for p in parts]) for r in range(reps)]


def forward(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward -> f32 logits ``(B, T, vocab)``."""
    require_dense(cfg)
    adt = getattr(torch, cfg.activation_dtype)
    # F.embedding, not params["embed"][tokens]: the indexing's backward
    # (index_put_ with accumulate) adds repeated tokens' rows in a
    # thread-dependent order on the CPU; embedding's backward is
    # deterministic on the CPU and on the card
    h = torch.nn.functional.embedding(tokens, params["embed"]).to(adt)
    period = cfg.pattern_period
    reps = cfg.num_layers // period
    per_pos = [_unbind(sp) for sp in params["stack"]]
    for r in range(reps):
        for pos in range(period):
            kind, ffn = cfg.layer_sig(pos)
            h, _ = _apply_block(per_pos[pos][r], h, cfg, kind, ffn)
    base = reps * period
    for i, p in enumerate(params["tail"]):
        h, _ = _apply_block(p, h, cfg, *cfg.layer_sig(base + i))
    h = L.rmsnorm(params["final_norm"], h)
    return h @ params["lm_head"].to(adt)


def loss_fn(params, cfg: ModelConfig, batch) -> tuple:
    """Cross-entropy of ``batch = {"tokens", "labels"[, "loss_mask"]}``:
    ``(loss, {"ce", "aux", "loss"})`` as in ``model.py:192-212``."""
    logits = forward(params, cfg, batch["tokens"]).to(torch.float32)
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None])[..., 0]
    ll = picked - lse
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones_like(ll)
    ce = -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
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
                      dtype, device, lead=()):
    """Zero ``k``/``v`` of one attention layer, ``lead + (B, n, KV,
    hd)``."""
    shape = tuple(lead) + (B, _cache_len(cfg, kind, s_max),
                           cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, B: int, s_max: int, dtype=None,
               device="cuda"):
    """The zero serve cache of ``B`` sequences of up to ``s_max``
    positions, in ``dtype`` (the activation dtype by default), on
    ``device`` (the card unless told ``"cpu"``)."""
    require_dense(cfg)
    device = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.activation_dtype)
    period = cfg.pattern_period
    reps, tail = divmod(cfg.num_layers, period)
    stack = [_init_layer_cache(cfg, cfg.block_kind(pos), B, s_max, dtype,
                               device, lead=(reps,))
             for pos in range(period if reps else 0)]
    tail_caches = [_init_layer_cache(cfg, cfg.block_kind(reps * period + i),
                                     B, s_max, dtype, device)
                   for i in range(tail)]
    return {"stack": stack, "tail": tail_caches}


def _store_prefill(kv, cache):
    """Write a full-sequence ``(k, v)`` into one layer's (zero) cache, in
    place.  A ring shorter than the prompt keeps the last ``n`` entries
    at their absolute positions modulo ``n``."""
    k, v = kv
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


def _layers(params, cache, cfg: ModelConfig):
    """``(p, c, kind, ffn)`` of every layer in execution order: the
    stacked positions rep by rep, then the tail; ``p`` and ``c`` are
    views into the stacked leaves."""
    period = cfg.pattern_period
    reps = cfg.num_layers // period
    per_pos = [_unbind(sp) for sp in params["stack"]]
    cache_pos = [_unbind(sc) for sc in cache["stack"]]
    for r in range(reps):
        for pos in range(period):
            yield (per_pos[pos][r], cache_pos[pos][r]) + cfg.layer_sig(pos)
    base = reps * period
    for i, (p, c) in enumerate(zip(params["tail"], cache["tail"])):
        yield (p, c) + cfg.layer_sig(base + i)


@torch.no_grad()
def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            s_max=None, cache_dtype=None):
    """Run the prompt ``tokens`` (B, T): ``(last-position logits (B, 1,
    vocab), cache, next position T)``, the cache sized for ``s_max``
    positions (T by default) on the tokens' device."""
    require_dense(cfg)
    adt = getattr(torch, cfg.activation_dtype)
    h = torch.nn.functional.embedding(tokens, params["embed"]).to(adt)
    B, T = tokens.shape
    s_max = s_max or T
    cache = init_cache(cfg, B, s_max, cache_dtype, device=tokens.device)
    for p, c, kind, ffn in _layers(params, cache, cfg):
        h, kv = _apply_block(p, h, cfg, kind, ffn)
        _store_prefill(kv, c)
    h = L.rmsnorm(params["final_norm"], h[:, -1:])
    return h @ params["lm_head"].to(adt), cache, T


def _decode_block(p, h, cfg: ModelConfig, kind: str, ffn: str, cache,
                  pos: int):
    normed = L.rmsnorm(p["norm1"], h)
    n = cache["k"].shape[1]
    # sliding-window layers write their ring at pos % n; full-attention
    # layers at the absolute position
    write_idx = pos % n if kind == "swa" else pos
    core_out, _, _ = L.attention_decode(p["core"], normed, cache["k"],
                                        cache["v"], pos, write_idx, cfg)
    if cfg.parallel_block and ffn != "none":
        return h + core_out + L.mlp(p["ffn"], normed)
    h = h + core_out
    if ffn == "mlp":
        h = h + L.mlp(p["ffn"], L.rmsnorm(p["norm2"], h))
    return h


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache, pos: int,
                tokens: torch.Tensor):
    """One decode step: ``tokens`` (B, 1) at absolute position ``pos`` (a
    Python int).  Returns ``(logits (B, 1, vocab), cache)``, the cache
    updated in place."""
    require_dense(cfg)
    adt = getattr(torch, cfg.activation_dtype)
    h = torch.nn.functional.embedding(tokens, params["embed"]).to(adt)
    pos = int(pos)
    for p, c, kind, ffn in _layers(params, cache, cfg):
        h = _decode_block(p, h, cfg, kind, ffn, c, pos)
    h = L.rmsnorm(params["final_norm"], h)
    return h @ params["lm_head"].to(adt), cache


def from_jax_params(np_tree, device="cuda") -> Dict[str, Any]:
    """The JAX param tree as numpy arrays (``jax.tree.map(np.asarray,
    params)``) -> the port's params on ``device``: same leaves, shapes,
    names.  The card unless told ``"cpu"``; raises without a GPU."""
    device = resolve_device(device)
    return tree.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device),
        np_tree)


def to_numpy_tree(params) -> Dict[str, Any]:
    """The port's params -> the same tree of numpy arrays."""
    return tree.tree_map(lambda t: t.detach().cpu().numpy(), params)
