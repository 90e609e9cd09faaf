"""Serve-step factories: prefill and decode on one device (port of
``repro/serve/steps.py``: ``make_prefill_step``, ``make_decode_step``).

The reference jits both with explicit shardings over a mesh
(``serve_param_specs``, ``serve_constrain``, ``decode_shardings``).
Those are sharding only and wait for the model axis (slice 2c); here
every step runs on one device, the card unless told ``"cpu"``, and a
data axis of the mesh is the same function computed on the whole
batch.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.devices import resolve_device
from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, device="cuda", *,
                      s_max: Optional[int] = None, cache_dtype=None):
    """``prefill_step(params, prompt) -> (logits, cache)``: ``prompt``
    the (B, T) tokens, or for an ``embeds`` frontend the (B, T,
    d_model) embeddings, moved to ``device``; ``logits`` the last
    position's (B, 1, vocab); the cache sized for ``s_max``."""
    device = resolve_device(device)
    kw = "embeds" if cfg.frontend == "embeds" else "tokens"

    def step(params, prompt):
        logits, cache, _ = prefill(params, cfg, s_max=s_max,
                                   cache_dtype=cache_dtype,
                                   **{kw: prompt.to(device)})
        return logits, cache

    return step


def make_decode_step(cfg: ModelConfig, device="cuda"):
    """``step(params, cache, pos, tok) -> (logits, cache)``: one token a
    sequence (``tok`` (B, 1), moved to ``device``; for an ``embeds``
    frontend a (B, 1, d_model) ``tok`` is an embedding) at absolute
    position ``pos`` against the cache, which is updated in place."""
    device = resolve_device(device)

    def step(params, cache, pos, tok):
        kw = ("embeds" if cfg.frontend == "embeds" and tok.ndim == 3
              else "tokens")
        return decode_step(params, cfg, cache, int(pos),
                           **{kw: tok.to(device)})

    return step
