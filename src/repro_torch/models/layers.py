"""Dense-decoder layers: RMSNorm, RoPE, GQA attention (full-causal and
sliding-window, and its one-token decode against a KV cache), SwiGLU MLP
(port of ``repro/models/layers.py``, lines 20-199).

Plain functions on tensors with the JAX package's layouts: params are
nested dicts, weights are ``(in, out)`` and applied as ``x @ W``, q/k/v
are ``(B, T, heads, hd)``.  The JAX code computes these with plain jnp,
so the port does too with plain torch ops — no fused attention: the
softmax is taken in f32 over ``-1e30``-masked logits exactly as
``layers._sdpa`` writes it, query block by query block above 1024
tokens as ``layers._sdpa_chunked`` takes it.

Under tensor parallelism (``axis``, a ``dist/tensor_parallel.ModelAxis``)
``attention``, ``attention_decode`` and ``mlp`` run on one model rank's
shards, the Megatron
split: ``wq``/``wk``/``wv`` and ``w_gate``/``w_up`` hold this rank's
heads and hidden units (column-parallel), ``wo`` and ``w_down`` the
matching rows, so each layer all-reduces its partial sums once, before
``bo``.  The biases of the column-parallel matmuls are replicated, and
each rank adds its slice.  ``axis=None`` is the whole model.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.dist.tensor_parallel import (copy_to_model, local_columns,
                                              reduce_from_model)
from repro_torch.models.config import ModelConfig


def dense_init(key, shape, dtype, *, fan_in: int,
               scale: Optional[float] = None, device) -> torch.Tensor:
    """``scale · normal(key, shape)`` with ``scale = 1/sqrt(fan_in)`` by
    default: the reference's ``_dense_init``, drawn from
    ``repro_torch.prng`` (within ``normal``'s tolerance of the
    reference's weights).  On the ``meta`` device, the shape alone."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = prng.normal(key, shape, device=device)
    return x.mul_(scale).to(dtype)


def init_attention(key, cfg: ModelConfig, dtype, device=None):
    hd, H, KV, D = cfg.hd, cfg.num_heads, cfg.num_kv_heads, cfg.d_model
    ks = prng.split(key, 4)
    p = {
        "wq": dense_init(ks[0], (D, H * hd), dtype, fan_in=D, device=device),
        "wk": dense_init(ks[1], (D, KV * hd), dtype, fan_in=D,
                         device=device),
        "wv": dense_init(ks[2], (D, KV * hd), dtype, fan_in=D,
                         device=device),
        "wo": dense_init(ks[3], (H * hd, D), dtype, fan_in=H * hd,
                         device=device),
    }
    if cfg.use_bias:
        for name, n in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd),
                        ("bo", D)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def init_mlp(key, d_model: int, d_ff: int, dtype, device=None):
    k1, k2, k3 = prng.split(key, 3)
    return {
        "w_gate": dense_init(k1, (d_model, d_ff), dtype, fan_in=d_model,
                             device=device),
        "w_up": dense_init(k2, (d_model, d_ff), dtype, fan_in=d_model,
                           device=device),
        "w_down": dense_init(k3, (d_ff, d_model), dtype, fan_in=d_ff,
                             device=device),
    }


def init_rmsnorm(d: int, dtype, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.to(torch.float32)
    x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * p["scale"].to(torch.float32)).to(dt)


def rope_angles(positions: torch.Tensor, hd: int, theta: float):
    """positions: (...,) int -> cos/sin of shape (..., hd//2)."""
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    # torch.full, not torch.tensor: no host-to-device copy (which would
    # wait for the card) in every decode step's layers
    inv = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                     device=positions.device), exps)
    ang = positions[..., None].to(torch.float32) * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Half-split RoPE. x: (..., T, heads, hd); cos/sin: (..., T, hd//2)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def _qkv(p, x, cfg: ModelConfig, axis=None):
    """q, k, v ``(B, T, heads, hd)``: all heads, or this model rank's."""
    B, T, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.use_bias:
        q = q + local_columns(p["bq"], axis)
        k = k + local_columns(p["bk"], axis)
        v = v + local_columns(p["bv"], axis)
    return (q.reshape(B, T, -1, cfg.hd), k.reshape(B, T, -1, cfg.hd),
            v.reshape(B, T, -1, cfg.hd))


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q: (B,T,H,hd), k/v: (B,S,KV,hd), mask: (T,S) bool (or (1,S) for a
    decode step) — einsum, f32 softmax over ``-1e30``-masked logits
    (``layers.py:93-108``)."""
    hd = q.shape[-1]
    rep = cfg.num_heads // cfg.num_kv_heads
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    logits = logits.to(torch.float32)
    if mask is not None:
        logits = logits.masked_fill(~mask[None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


# the query length above which full-sequence attention runs query block
# by query block (the reference's ``layers._SDPA_CHUNK``): only one
# ``(B, H, chunk, S)`` block of f32 logits is live at a time
_SDPA_CHUNK = 1024


def _sdpa_chunked(q, k, v, cfg: ModelConfig, window: int, chunk: int):
    """Query-blocked causal attention (``layers.py:116-143``): ``_sdpa``
    on each block of ``chunk`` query rows against all ``S`` keys, under
    those rows' mask, the blocks' outputs concatenated along T.  Every
    row's softmax runs over the same ``S`` keys as in one block (the
    masked keys of early blocks are not dropped), so the result is the
    one-block ``_sdpa``'s."""
    B, T = q.shape[:2]
    S = k.shape[1]
    assert T % chunk == 0, (T, chunk)
    kpos = torch.arange(S, device=q.device)[None, :]
    outs = []
    for start in range(0, T, chunk):
        qpos = torch.arange(start, start + chunk,
                            device=q.device)[:, None] + (S - T)
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        outs.append(_sdpa(q[:, start:start + chunk], k, v, mask, cfg))
    return torch.cat(outs, dim=1)


def causal_mask(T: int, S: int, window: int = 0, device=None):
    """(T, S) bool; queries are the last T positions of the S keys."""
    qpos = torch.arange(T, device=device)[:, None] + (S - T)
    kpos = torch.arange(S, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def attention(p, x, cfg: ModelConfig, *, window: int = 0, axis=None):
    """Training and prefill self-attention over the full sequence:
    ``(out, (k, v))`` with the post-RoPE keys and the values, which a
    prefill stores as its cache (the training path drops them; they are
    the tensors the backward keeps anyway).  Above :data:`_SDPA_CHUNK`
    tokens, when it divides T, the reference's condition, the queries
    run block by block (:func:`_sdpa_chunked`): the forward's f32
    logits and their masked copy are one block's, not ``(B, H, T, T)``.
    Under autograd every block's softmax output stays saved for the
    backward, so a training step keeps the ``T x T`` probabilities
    either way.  With ``axis``, this model rank's heads (module
    docstring)."""
    B, T, D = x.shape
    x = copy_to_model(x, axis)
    q, k, v = _qkv(p, x, cfg, axis)
    positions = torch.arange(T, device=x.device)
    cos, sin = rope_angles(positions, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if T > _SDPA_CHUNK and T % _SDPA_CHUNK == 0:
        out = _sdpa_chunked(q, k, v, cfg, window, _SDPA_CHUNK)
    else:
        out = _sdpa(q, k, v, causal_mask(T, T, window, device=x.device),
                    cfg)
    out = reduce_from_model(out.reshape(B, T, -1) @ p["wo"], axis)
    if cfg.use_bias:
        out = out + p["bo"]
    return out, (k, v)


def attention_decode(p, x, cache_k, cache_v, pos: int, write_idx: int,
                     cfg: ModelConfig, axis=None):
    """One-token decode: ``x`` (B,1,D) against the cache (B,S,KV,hd).

    ``pos`` is the absolute position (RoPE and the causal mask);
    ``write_idx`` the cache slot written (``pos`` for a full cache,
    ``pos % window`` for a sliding-window ring).  Keys are cached
    post-RoPE, so attention over a ring-permuted cache is exact (the
    softmax does not depend on the slots' order); the mask ``slot <=
    pos`` hides the slots not yet written.  The cache is written IN
    PLACE (slot ``write_idx`` of ``cache_k``/``cache_v``) and returned:
    ``(out, cache_k, cache_v)``.  With ``axis``, this model rank's
    heads against its heads' cache (``KV / M`` of them)."""
    B = x.shape[0]
    q, k, v = _qkv(p, copy_to_model(x, axis), cfg, axis)
    positions = torch.full((1,), int(pos), device=x.device)
    cos, sin = rope_angles(positions, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    cache_k[:, write_idx].copy_(k[:, 0])
    cache_v[:, write_idx].copy_(v[:, 0])
    S = cache_k.shape[1]
    mask = (torch.arange(S, device=x.device) <= pos)[None, :]
    out = _sdpa(q, cache_k.to(q.dtype), cache_v.to(q.dtype), mask, cfg)
    out = reduce_from_model(out.reshape(B, 1, -1) @ p["wo"], axis)
    if cfg.use_bias:
        out = out + p["bo"]
    return out, cache_k, cache_v


def mlp_partial(p, x):
    """SwiGLU over the hidden units ``p`` holds: the whole output, or
    under tensor parallelism this rank's partial sum (the caller's
    ``x`` has been through ``copy_to_model``)."""
    return (torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])) \
        @ p["w_down"]


def mlp(p, x, axis=None):
    """SwiGLU; with ``axis``, this model rank's hidden units."""
    return reduce_from_model(mlp_partial(p, copy_to_model(x, axis)), axis)
