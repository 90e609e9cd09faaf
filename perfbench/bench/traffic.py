"""The traffic: a seeded token stream with next-token structure, made on
the device in a few large calls.

Each row follows the affine recurrence ``t[i+1] = (31·t[i] + 7 +
eps[i]) mod V`` with sparse noise (``eps`` uniform on ``[0, V)`` with
probability 0.1, else 0), the stream of the program's ``lm_batch``.
The recurrence is solved by a log-depth scan of affine maps, so a batch
costs ~13 elementwise passes on the card and no host loop.  Every row
starts from its own uniform token, so the rows of a ring all differ.
"""
from __future__ import annotations

import torch

MULT, INC, NOISE_P = 31, 7, 0.1


def seeded(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for stream ``salt`` of ``seed`` (any
    whole number)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(salt) * 7_919) % (1 << 63))
    return g


def token_rows(gen: torch.Generator, rows: int, n: int, vocab: int,
               device) -> torch.Tensor:
    """``(rows, n)`` int64 tokens of the recurrence."""
    start = torch.randint(0, vocab, (rows, 1), generator=gen, device=device)
    hit = torch.rand((rows, n), generator=gen, device=device) < NOISE_P
    eps = torch.randint(0, vocab, (rows, n), generator=gen, device=device)
    # t[i+1] = a·t[i] + b[i]: scan the maps (a, b) so that position i
    # holds the composition of maps 0..i, then apply it to the start
    a = torch.full((rows, n), MULT % vocab, dtype=torch.int64, device=device)
    b = (INC + eps * hit) % vocab
    step = 1
    while step < n:
        a2, b2 = a[:, step:], b[:, step:]
        a1, b1 = a[:, :-step], b[:, :-step]
        a = torch.cat([a[:, :step], (a2 * a1) % vocab], dim=1)
        b = torch.cat([b[:, :step], (a2 * b1 + b2) % vocab], dim=1)
        step *= 2
    return (a * start + b) % vocab


def make_ring(seed: int, traffic: dict, vocab: int, device) -> list:
    """``traffic["ring"]`` distinct global batches ``{"tokens", "labels"}``
    of ``workers · batch_per_worker`` rows of ``seq_len`` tokens, labels
    the tokens shifted by one; batch ``i`` from its own stream, so any
    batch can be made again alone (:func:`make_batch`)."""
    return [make_batch(seed, traffic, vocab, device, i)
            for i in range(int(traffic["ring"]))]


def make_batch(seed: int, traffic: dict, vocab: int, device, i: int):
    rows = int(traffic["workers"]) * int(traffic["batch_per_worker"])
    n = int(traffic["seq_len"]) + 1
    toks = token_rows(seeded(seed, 1 + i, device), rows, n, vocab, device)
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}
