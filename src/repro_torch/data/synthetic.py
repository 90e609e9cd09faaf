"""Deterministic synthetic LM data (port of ``repro/data/synthetic.py``,
``lm_batch``/``batch_for``).

``lm_batch`` is the reference's seeded affine-recurrence token stream
with sparse noise — next-token structure exists, so the loss falls —
drawn from a ``torch.Generator`` seeded by ``(seed, step)``.  The bits
differ from ``jax.random``'s; the recurrence is the same.  Tests that
compare with the reference feed both packages the same numpy batch.
"""
from __future__ import annotations

import torch

from repro_torch.devices import resolve_device


def lm_batch(step: int, *, global_batch: int, seq_len: int, vocab: int,
             seed: int = 0, device="cuda"):
    """``{"tokens", "labels"}`` int64 ``(B, S)`` on ``device`` (the card
    unless told ``"cpu"``; raises without a GPU); labels are the tokens
    shifted by one."""
    device = resolve_device(device)
    gen = torch.Generator(device="cpu")
    gen.manual_seed((int(seed) << 32) ^ (int(step) & 0xFFFFFFFF))
    start = torch.randint(0, vocab, (global_batch,), generator=gen)
    mult = 31 % vocab
    # affine recurrence with sparse noise: t_{i+1} = (a*t_i + 7 + eps) % V
    bern = torch.rand((global_batch, seq_len + 1), generator=gen) < 0.1
    noise = bern.long() * torch.randint(0, vocab, (global_batch, seq_len + 1),
                                        generator=gen)
    toks = torch.empty((global_batch, seq_len + 1), dtype=torch.int64)
    t = start
    for i in range(seq_len + 1):
        t = (t * mult + 7 + noise[:, i]) % vocab
        toks[:, i] = t
    return {"tokens": toks[:, :-1].to(device),
            "labels": toks[:, 1:].to(device)}


def batch_for(cfg, step: int, *, global_batch: int, seq_len: int,
              seed: int = 0, device="cuda"):
    if cfg.frontend != "tokens":
        from repro_torch.slices import not_ported
        raise not_ported(f"the {cfg.frontend!r} frontend", "arch")
    return lm_batch(step, global_batch=global_batch, seq_len=seq_len,
                    vocab=cfg.vocab_size, seed=seed, device=device)
