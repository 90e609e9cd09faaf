"""One frozen config for every compression consumer (port of
``repro.core.compression``).

:class:`CompressionConfig` carries what to compress with and how to move
it; construction validates it as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.adaptk import DensityPolicy
from repro_torch.core.compressors import CompressorSpec, get_compressor
from repro_torch.core.error_feedback import BACKENDS

STRATEGIES = ("allgather", "gtopk", "hierarchical", "hier_gtopk")

# compressor spelling for Dense-SGD (no sparsification, dense mean)
DENSE = "none"


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """``compressor`` registry name or ``"none"``; ``ratio`` density k/d
    per leaf; ``strategy`` wire pattern; ``codec_dtype`` wire dtype of
    the values (None = f32; a torch float dtype or its name, such as
    ``torch.bfloat16`` or ``"float16"``); ``momentum_correction`` DGC
    factor; ``backend`` auto | fused | reference; ``density_policy``
    adaptive density, a :class:`~repro_torch.core.adaptk.DensityPolicy`
    (None = fixed k); ``chunks`` wire chunk count."""

    compressor: str = "gaussiank"
    ratio: float = 0.001
    strategy: str = "allgather"
    codec_dtype: Optional[Any] = None
    momentum_correction: float = 0.0
    backend: str = "auto"
    density_policy: Optional[DensityPolicy] = None
    chunks: int = 1

    def __post_init__(self):
        if self.compressor is None:
            object.__setattr__(self, "compressor", DENSE)
        if isinstance(self.codec_dtype, str):
            object.__setattr__(self, "codec_dtype",
                               getattr(torch, self.codec_dtype, None))
        if self.codec_dtype is not None and not (
                isinstance(self.codec_dtype, torch.dtype)
                and self.codec_dtype.is_floating_point):
            raise ValueError("codec_dtype must be a torch float dtype, got "
                             f"{self.codec_dtype!r}")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"have {STRATEGIES}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; "
                             f"have {BACKENDS}")
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if self.momentum_correction < 0.0 or self.momentum_correction >= 1.0:
            raise ValueError("momentum_correction must be in [0, 1), "
                             f"got {self.momentum_correction}")
        if not self.dense:
            get_compressor(self.compressor)   # raises on unknown names
            if not 0.0 < self.ratio <= 1.0:
                raise ValueError(f"ratio must be in (0, 1], got {self.ratio}")
        else:
            if self.density_policy is not None:
                raise ValueError("density_policy has no meaning for "
                                 "Dense-SGD (compressor='none')")
            if self.momentum_correction:
                raise ValueError("momentum_correction rides the sparse EF "
                                 "pipeline; meaningless for Dense-SGD")
        if self.density_policy is not None \
                and not isinstance(self.density_policy, DensityPolicy):
            raise TypeError("density_policy must be a DensityPolicy "
                            "(core.adaptk.make_policy), got "
                            f"{type(self.density_policy).__name__}")

    @property
    def dense(self) -> bool:
        return self.compressor == DENSE

    @property
    def spec(self) -> Optional[CompressorSpec]:
        return None if self.dense else get_compressor(self.compressor)

    @property
    def adaptive(self) -> bool:
        return self.density_policy is not None

    def replace(self, **changes) -> "CompressionConfig":
        return dataclasses.replace(self, **changes)


def as_config(value) -> CompressionConfig:
    """Coerce ``None`` (defaults) or a config; reject everything else."""
    if value is None:
        return CompressionConfig()
    if isinstance(value, CompressionConfig):
        return value
    raise TypeError("expected a CompressionConfig (or None), got "
                    f"{type(value).__name__}")
