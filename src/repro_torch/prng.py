"""``jax.random``'s threefry2x32 PRNG in torch, bit for bit (the
draws the reference's ``randk``/``dgck``/``rtopk``, its train step and
its synthetic data make).

The port follows ``jax/_src/prng.py`` and ``jax/_src/random.py`` under
the **partitionable** threefry scheme (``jax_threefry_partitionable``,
the default from jax 0.5 on); jax below 0.5 defaults to the original
scheme, whose ``split`` and ``random_bits`` differ (``fold_in`` does
not), so comparing with such a jax needs
``jax.config.update("jax_threefry_partitionable", True)``.  64-bit mode
is off, as in the reference.

A key is a pair of Python ints ``(k0, k1)``, each in ``[0, 2^32)``:
``PRNGKey``, ``fold_in`` and ``split`` hash on the host, so deriving the
keys of a step costs the card nothing and adds no host sync.  Scalar
draws (``randint_scalar``, the strided sample's random phase) are on the
host too.  Bulk draws fill a tensor on ``device`` through
``kernels/prng.threefry_bits``: the Triton kernel on the card, its plain
int64 version on the CPU.

========================  ============================================
``PRNGKey(seed)``         ``(0, seed mod 2^32)`` (``threefry_seed`` of
                          an int32 seed: the high word is 0 and a
                          negative seed wraps)
``fold_in(key, data)``    ``threefry2x32(key, (0, data))``
``split(key, n)``         key ``i`` is ``threefry2x32(key, (0, i))``
``bits(key, shape)``      draw ``i`` is ``y0 ^ y1`` of ``threefry2x32(
                          key, (i >> 32, i & 0xFFFFFFFF))``
``uniform``               ``(bits >> 9) | 0x3F800000`` as f32, minus 1,
                          scaled into ``[minval, maxval)`` (bit-exact)
``randint``               two keys, high and low draws reduced modulo
                          the span with jax's ``multiplier`` (exact)
``bernoulli``             ``uniform < p`` (exact)
``normal``                ``√2 · erfinv(uniform(nextafter(-1, 0), 1))``:
                          torch's ``erfinv`` is not XLA's f32
                          polynomial, so within a tolerance
``gumbel``                ``−log(−log(uniform(tiny, 1)))`` (jax's
                          default ``"low"`` mode): the uniform exact,
                          torch's ``log`` within an ulp of XLA's
``categorical``           ``argmax(gumbel(key, logits.shape) +
                          logits)`` over the last axis, first index
                          of a tie
========================  ============================================
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.prng.threefry import (MASK, PARITY, ROT0, ROT1,
                                               threefry_bits)

Key = Tuple[int, int]
Shape = Union[int, Sequence[int]]


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: Key, x0: int, x1: int) -> Key:
    """The threefry2x32 hash of one counter pair, on the host."""
    k0, k1 = key[0] & MASK, key[1] & MASK
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0, x1 = (x0 + ks[0]) & MASK, (x1 + ks[1]) & MASK
    for g in range(5):
        for r in (ROT0 if g % 2 == 0 else ROT1):
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & MASK
    return x0, x1


def PRNGKey(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: the seed as int32, high word 0."""
    return 0, int(seed) & MASK


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``, ``data`` taken as uint32."""
    return threefry2x32(key, 0, int(data) & MASK)


def split(key: Key, n: int = 2) -> List[Key]:
    """``jax.random.split(key, n)`` (partitionable): ``n`` keys."""
    return [threefry2x32(key, 0, i) for i in range(n)]


def _size(shape: Shape) -> Tuple[Tuple[int, ...], int]:
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return shape, math.prod(shape)


def bits32(key: Key, shape: Shape, *, device) -> torch.Tensor:
    """The 32-bit draws of ``jax.random.bits(key, shape)`` as an int32
    tensor on ``device`` holding their uint32 patterns."""
    shape, n = _size(shape)
    out = torch.empty(n, dtype=torch.int32, device=device)
    return threefry_bits(key, out).view(shape)


def bits(key: Key, shape: Shape, *, device) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as int64 values in
    ``[0, 2^32)``."""
    return bits32(key, shape, device=device).long().bitwise_and_(MASK)


def rank_keys(key: Key, n: int, *, device) -> torch.Tensor:
    """One distinct int64 key per coordinate whose descending order is
    ``lax.top_k``'s order of ``uniform(key, (n,))``: the larger uniform
    first, and of equal ones the lower index (``kernels/prng``)."""
    out = torch.empty(n, dtype=torch.int64, device=device)
    return threefry_bits(key, out)


def _unit(b32: torch.Tensor) -> torch.Tensor:
    """``[0, 1)`` floats from int32 draws: ``(bits >> 9) | 0x3F800000``
    bit-cast to f32, minus 1."""
    m = torch.bitwise_right_shift(b32, 9).bitwise_and_(0x7FFFFF)
    return m.bitwise_or_(0x3F800000).view(torch.float32).sub_(1.0)


def uniform(key: Key, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0, *, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.  XLA
    fuses ``x * (maxval - minval) + minval`` into one FMA; the port forms
    it in f64 (the product is exact there) and rounds once to f32, which
    can differ from the FMA only where the f64 sum lands on an f32
    rounding midpoint."""
    lo, hi = np.float32(minval), np.float32(maxval)
    x = _unit(bits32(key, shape, device=device))
    if (lo, hi) == (0.0, 1.0):
        return x       # x * 1 + 0 and max(0, x) are x
    span = float(np.float32(hi - lo))
    y = x.double().mul_(span).add_(float(lo)).float()
    return torch.clamp_min_(y, float(lo))


def _randint_span(minval: int, maxval: int) -> Tuple[int, int]:
    """jax's ``span`` and ``multiplier`` for an int32 draw in
    ``[minval, maxval)``, as Python ints (uint32 arithmetic)."""
    for v in (minval, maxval):
        if not -2 ** 31 <= v < 2 ** 31:
            raise ValueError(f"randint bounds must be int32, got {v}")
    span = 1 if maxval <= minval else (maxval - minval) & MASK
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK) % span
    return span, mult


def randint(key: Key, shape: Shape, minval: int, maxval: int, *,
            device) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) as an
    int64 tensor."""
    span, mult = _randint_span(int(minval), int(maxval))
    k1, k2 = split(key)
    hi = bits(k1, shape, device=device).remainder_(span)
    lo = bits(k2, shape, device=device).remainder_(span)
    off = hi.mul_(mult).add_(lo).bitwise_and_(MASK).remainder_(span)
    return off.add_(int(minval))


def randint_scalar(key: Key, minval: int, maxval: int) -> int:
    """``jax.random.randint(key, (), minval, maxval)``, on the host."""
    span, mult = _randint_span(int(minval), int(maxval))
    k1, k2 = split(key)
    hi = _bits_host(k1) % span
    lo = _bits_host(k2) % span
    return int(minval) + ((hi * mult + lo) & MASK) % span


def _bits_host(key: Key) -> int:
    """``jax.random.bits(key, ())``: counter 0."""
    y0, y1 = threefry2x32(key, 0, 0)
    return y0 ^ y1


def bernoulli(key: Key, p: float, shape: Shape, *, device) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (f32 ``p``): bool."""
    return uniform(key, shape, device=device) < float(np.float32(p))


NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(key: Key, shape: Shape = (), *, device) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (f32), within the difference of
    torch's ``erfinv`` from XLA's f32 ``erf_inv`` polynomial."""
    u = uniform(key, shape, NORMAL_LO, 1.0, device=device)
    return torch.special.erfinv(u).mul_(
        torch.tensor(np.float32(np.sqrt(2)), device=device))


F32_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key: Key, shape: Shape = (), *, device) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (f32, ``mode="low"``):
    ``−log(−log(u))`` of ``u = uniform(key, shape, tiny, 1)``."""
    u = uniform(key, shape, F32_TINY, 1.0, device=device)
    return torch.log(u).neg_().log_().neg_()


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis, with
    replacement (the Gumbel-max trick): int64 indices of shape
    ``logits.shape[:-1]``."""
    g = gumbel(key, tuple(logits.shape), device=logits.device)
    return torch.argmax(g + logits, dim=-1)
