"""Top-k sparsification with error feedback: codec, compressors, EF
dispatch, the compression config, the adaptive density policies and the
contraction bounds (port of ``repro.core``)."""
from repro_torch.core import (adaptk, bounds, codec, compression,
                              compressors, error_feedback)
from repro_torch.core.adaptk import DensityPolicy, make_policy
from repro_torch.core.codec import (SENTINEL, compact_by_mask, decode,
                                    decode_add, nnz)
from repro_torch.core.compression import STRATEGIES, CompressionConfig
from repro_torch.core.compressors import available, get_compressor
from repro_torch.core.error_feedback import (BACKENDS, compress_with_ef,
                                             init_residual, resolve_backend,
                                             supports_fused)

__all__ = [
    "adaptk", "bounds", "codec", "compression", "compressors",
    "error_feedback", "DensityPolicy", "make_policy",
    "SENTINEL", "compact_by_mask", "decode", "decode_add", "nnz",
    "STRATEGIES", "CompressionConfig", "available", "get_compressor",
    "BACKENDS", "compress_with_ef", "init_residual", "resolve_backend",
    "supports_fused",
]
