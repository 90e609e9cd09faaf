"""Float32 ``exp`` and ``log`` the way the JAX package computes them on
the CPU.

The DGC density warmup (``optim/schedules.py``) takes an f32 ``log`` and
``exp`` on the host.  XLA's CPU ``exp`` and ``log`` are Cephes
polynomials evaluated with fused multiply-adds, not correctly rounded:
they differ from numpy's and torch's in the last bit for roughly one
input in ten.  :func:`exp` and :func:`log` are those polynomials in the
compiler's order, on :func:`fma` (``tests/test_torch_adaptk.py`` holds
them bitwise against ``jnp.exp`` and ``jnp.log`` on 300,000 inputs
each).  Every function takes and returns numpy float32 (arrays or
scalars).
"""
from __future__ import annotations

import numpy as np

F32 = np.float32


def fma(a, b, c):
    """``a·b + c`` rounded once to f32 (a fused multiply-add): the f32
    product is exact in f64, the f64 sum's rounding error is recovered
    exactly (TwoSum), and a sum that lands exactly halfway between two
    f32 values is rounded by the sign of that error."""
    a, b, c = (np.asarray(x, F32).astype(np.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    z = s - p
    err = (p - (s - z)) + (c - z)          # s + err == a·b + c exactly
    r = s.astype(F32)
    rd = r.astype(np.float64)
    other = np.nextafter(r, np.where(s > rd, F32(np.inf),
                                     F32(-np.inf))).astype(np.float64)
    tie = (s != rd) & (s + s == rd + other)
    past = tie & (err != 0) & ((err > 0) == (other > rd))
    return np.where(past, other.astype(F32), r).astype(F32)[()]


# Cephes coefficients, as XLA's CPU backend spells them
_EXP_P = tuple(F32(v) for v in (1.9875691500e-4, 1.3981999507e-3,
                                8.3334519073e-3, 4.1665795894e-2,
                                1.6666665459e-1, 5.0000001201e-1))
_LOG_P = tuple(F32(v) for v in (7.0376836292e-2, -1.1514610310e-1,
                                1.1676998740e-1, -1.2420140846e-1,
                                1.4249322787e-1, -1.6668057665e-1,
                                2.0000714765e-1, -2.4999993993e-1,
                                3.3333331174e-1))


def exp(x):
    """XLA's CPU f32 ``exp``: ``2^n · p(r)`` with ``n = floor(x·log2(e)
    + 1/2)``, ``r = x − n·ln 2`` in two fused steps and a degree-7
    polynomial."""
    x = np.clip(np.asarray(x, F32), F32(-88.3762626647950),
                F32(88.3762626647949))
    n = np.floor(fma(x, F32(1.44269504088896341), F32(0.5)))
    r = fma(n, F32(-0.693359375), x)
    r = fma(n, F32(2.12194440e-4), r)
    z = (r * r).astype(F32)
    y = np.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = fma(y, r, c)
    y = (fma(y, z, r) + F32(1.0)).astype(F32)
    return np.ldexp(y, n.astype(np.int32)).astype(F32)[()]


def log(x):
    """XLA's CPU f32 ``log`` of positive normal ``x``: the mantissa
    shifted to ``[sqrt(1/2), sqrt(2))`` minus 1, a degree-9 polynomial,
    and the exponent's ``ln 2`` added back in two parts."""
    x = np.asarray(x, F32)
    if not np.all(np.isfinite(x) & (x >= np.finfo(F32).tiny)):
        raise ValueError("log: only positive normal f32 inputs are "
                         "supported")
    m, e = np.frexp(x)
    m, e = m.astype(F32), e.astype(F32)
    small = m < F32(0.707106781186547524)
    e = (e - np.where(small, F32(1.0), F32(0.0))).astype(F32)
    t = ((m - F32(1.0)).astype(F32)
         + np.where(small, m, F32(0.0))).astype(F32)
    t2 = (t * t).astype(F32)
    t3 = (t2 * t).astype(F32)
    p = _LOG_P
    y, y1, y2 = fma(t, p[0], p[1]), fma(t, p[3], p[4]), fma(t, p[6], p[7])
    y, y1, y2 = fma(y, t, p[2]), fma(y1, t, p[5]), fma(y2, t, p[8])
    y = fma(fma(y, t3, y1), t3, y2)
    y = fma(y, t3, (e * F32(-2.12194440e-4)).astype(F32))
    t = (fma(t2, F32(-0.5), t) + y).astype(F32)
    return fma(e, F32(0.693359375), t)
