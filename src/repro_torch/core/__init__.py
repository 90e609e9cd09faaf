"""Top-k sparsification with error feedback: codec, compressors, EF
dispatch and the compression config (port of ``repro.core``)."""
from repro_torch.core import codec, compression, compressors, error_feedback
from repro_torch.core.codec import (SENTINEL, compact_by_mask, decode,
                                    decode_add, nnz)
from repro_torch.core.compression import STRATEGIES, CompressionConfig
from repro_torch.core.compressors import available, get_compressor
from repro_torch.core.error_feedback import (BACKENDS, compress_with_ef,
                                             resolve_backend, supports_fused)

__all__ = [
    "codec", "compression", "compressors", "error_feedback",
    "SENTINEL", "compact_by_mask", "decode", "decode_add", "nnz",
    "STRATEGIES", "CompressionConfig", "available", "get_compressor",
    "BACKENDS", "compress_with_ef", "resolve_backend", "supports_fused",
]
