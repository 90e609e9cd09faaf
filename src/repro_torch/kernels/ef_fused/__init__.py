"""Fused error-feedback compression pipeline (port of
``repro.kernels.ef_fused``): K1 ``fused_moments`` in Triton, K1 with the
hist-k histogram, K2 ``tree_count`` and K3 ``compact_residual`` (the one
sweep, and the stage and residual launches) in CUDA C++, the threshold
glue and the segmented bucket walk in torch; and the unfused pipeline
over the K4 kernels."""
from repro_torch.kernels.ef_fused.ops import (FUSED_COMPRESSORS,
                                              compress_at_threshold,
                                              fused_compress_ef,
                                              fused_default_bcap,
                                              fused_pass_a, supports_fused,
                                              unfused_compress_ef)
from repro_torch.kernels.ef_fused.passes import count_passes
from repro_torch.kernels.ef_fused.segmented import (rows_compress_ef,
                                                    rows_pass_a,
                                                    segmented_compress_ef,
                                                    segmented_pass_a,
                                                    stats_to_host)
from repro_torch.kernels.ef_fused.tuning import (BACKENDS, KernelConfig,
                                                 choose_block,
                                                 choose_stats_block,
                                                 resolve_backend,
                                                 resolve_config)

__all__ = ["FUSED_COMPRESSORS", "choose_block", "choose_stats_block",
           "compress_at_threshold", "fused_compress_ef",
           "fused_default_bcap", "fused_pass_a", "supports_fused",
           "unfused_compress_ef", "count_passes", "rows_compress_ef",
           "rows_pass_a", "segmented_compress_ef", "segmented_pass_a",
           "stats_to_host", "BACKENDS",
           "KernelConfig", "resolve_backend", "resolve_config"]
