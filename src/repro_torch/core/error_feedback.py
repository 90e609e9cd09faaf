"""Error feedback for sparsified SGD — paper Eq. (2) (port of
``repro.core.error_feedback``).

    x_{t+1} = x_t - eta/P * sum_p Comp_k(g_t^p + e_t^p)
    e_{t+1}^p = g_t^p + e_t^p - Comp_k(g_t^p + e_t^p)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import tree
from repro_torch.core import codec
from repro_torch.core.compressors import CompressorSpec


def init_residual(grads_like) -> dict:
    """The zero residual tree of a gradient tree: each leaf's shape,
    dtype and device."""
    return tree.tree_map(torch.zeros_like, grads_like)


BACKENDS = ("auto", "fused", "reference")


def supports_fused(spec: CompressorSpec) -> bool:
    """True when ``spec`` has a fused pipeline here."""
    from repro_torch.kernels.ef_fused.ops import supports_fused as _fused
    return _fused(spec.name)


def resolve_backend(backend: str, spec: CompressorSpec,
                    split: bool = True) -> bool:
    """Whether a compression call takes the fused path: ``"auto"`` when
    the compressor has one and ``(g, e)`` arrive unsummed, ``"fused"``
    always (raising on unsupported compressors), ``"reference"`` never."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if backend == "reference":
        return False
    if backend == "fused":
        if not supports_fused(spec):
            raise ValueError(
                f"compressor {spec.name!r} has no fused pipeline; "
                "use backend='auto' or 'reference'")
        return True
    return supports_fused(spec) and split


def compress_with_ef(u: torch.Tensor, spec: CompressorSpec, k: int,
                     key=None, *, e: Optional[torch.Tensor] = None,
                     backend: str = "auto"):
    """One EF compression step: ``(values, indices, residual)`` with
    ``decode(values, indices) + residual == u (+ e)`` exactly."""
    if resolve_backend(backend, spec, split=e is not None):
        from repro_torch.kernels.ef_fused.ops import fused_compress_ef
        return fused_compress_ef(u, e, spec.name, k)
    if e is not None:
        u = u + e
    values, indices = spec.select(u, k, key)
    residual = u - codec.decode(values, indices, u.shape[0])
    return values, indices, residual
