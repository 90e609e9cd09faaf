"""Deterministic synthetic data (port of ``repro/data/synthetic.py``,
``lm_batch``/``embeds_batch``/``batch_for``/``mnist_like``).

``lm_batch`` is the reference's seeded affine-recurrence token stream
with sparse noise — next-token structure exists, so the loss falls —
drawn from the port's ``jax.random``-exact PRNG (``repro_torch.prng``):
the same ``(seed, step)`` gives the reference's tokens, bit for bit.
``mnist_like`` is the paper-fidelity FNN-3 benchmarks' classification
set, class-conditional Gaussian blobs in 784-D: the reference's labels
exactly, its inputs within ``prng.normal``'s tolerance.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.devices import resolve_device


def lm_batch(step: int, *, global_batch: int, seq_len: int, vocab: int,
             seed: int = 0, device="cuda"):
    """``{"tokens", "labels"}`` int64 ``(B, S)`` on ``device`` (the card
    unless told ``"cpu"``; raises without a GPU); labels are the tokens
    shifted by one.  The ``B·(S+1)`` draws and the recurrence run on the
    host, as a data loader's would, and the batch is copied over."""
    device = resolve_device(device)
    B, n = global_batch, seq_len + 1
    key = prng.fold_in(prng.PRNGKey(seed), step)
    k1, k2, k3 = prng.split(key, 3)
    start = prng.randint(k1, (B, 1), 0, vocab, device="cpu")[:, 0]
    mult = 31 % vocab
    # affine recurrence with sparse noise: t_{i+1} = (a*t_i + 7 + eps) % V
    noise = (prng.bernoulli(k2, 0.1, (B, n), device="cpu").long()
             * prng.randint(k3, (B, n), 0, vocab, device="cpu"))
    toks = torch.empty((B, n), dtype=torch.int64)
    t = start
    for i in range(n):
        t = (t * mult + 7 + noise[:, i]) % vocab
        toks[:, i] = t
    return {"tokens": toks[:, :-1].to(device),
            "labels": toks[:, 1:].to(device)}


def embeds_batch(step: int, *, global_batch: int, seq_len: int,
                 d_model: int, vocab: int, seed: int = 0, device="cuda"):
    """The audio/VLM frontend's stand-in: ``{"embeds": (B, S, d_model)
    f32 frame or patch embeddings, "labels": (B, S) int64 tokens}`` on
    ``device`` (the card unless told ``"cpu"``), drawn from
    ``fold_in(PRNGKey(seed), step)`` as the reference draws them: the
    labels bitwise, the embeddings within ``prng.normal``'s
    tolerance."""
    device = resolve_device(device)
    key = prng.fold_in(prng.PRNGKey(seed), step)
    k1, k2 = prng.split(key)
    return {"embeds": prng.normal(k1, (global_batch, seq_len, d_model),
                                  device=device),
            "labels": prng.randint(k2, (global_batch, seq_len), 0, vocab,
                                   device=device)}


def batch_for(cfg, step: int, *, global_batch: int, seq_len: int,
              seed: int = 0, device="cuda"):
    """The batch of ``step`` for ``cfg``'s frontend: ``embeds_batch``
    for ``embeds``, ``lm_batch`` for tokens."""
    if cfg.frontend == "embeds":
        return embeds_batch(step, global_batch=global_batch,
                            seq_len=seq_len, d_model=cfg.d_model,
                            vocab=cfg.vocab_size, seed=seed, device=device)
    return lm_batch(step, global_batch=global_batch, seq_len=seq_len,
                    vocab=cfg.vocab_size, seed=seed, device=device)


def mnist_like(step: int, *, batch: int, num_classes: int = 10,
               dim: int = 784, seed: int = 0, device="cuda"):
    """``{"x": (batch, dim) f32, "y": (batch,) int64}`` on ``device`` (the
    card unless told ``"cpu"``): class-conditional Gaussian blobs, the
    class means fixed by ``seed``, drawn where they are used."""
    device = resolve_device(device)
    means = prng.normal(prng.PRNGKey(seed), (num_classes, dim),
                        device=device)
    key = prng.fold_in(prng.PRNGKey(seed + 1), step)
    k1, k2 = prng.split(key)
    y = prng.randint(k1, (batch,), 0, num_classes, device=device)
    x = means[y] + 0.8 * prng.normal(k2, (batch, dim), device=device)
    return {"x": x, "y": y}
