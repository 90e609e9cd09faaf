"""Distributed layer (port of ``repro.dist``): the static bucket layout,
the Eq.-2 aggregation over it for the four wire strategies, the
reference's partition specs (``sharding``), and the wire itself
(``wire.py``: W workers in one process, or one per process over
``torch.distributed``)."""
from repro_torch.dist import aggregate, layout, sharding
from repro_torch.dist.aggregate import (AggregateResult, aggregate_bucketed,
                                        aggregate_bucketed_chunked,
                                        aggregate_compressed,
                                        aggregate_dense, bucket_compress,
                                        gtopk_simulate, init_residuals)
from repro_torch.dist.layout import (STRATEGIES, BucketLayout, ChunkPlan,
                                     LeafSegment, build_chunk_plan,
                                     build_layout, chunk_view,
                                     collective_count, init_flat_residual,
                                     leaf_key_salt, pack_grads,
                                     pack_residual_arrays, rebudget_layout,
                                     resolve_strategy, strategy_wire_pairs,
                                     unpack_residual_arrays, unpack_tree,
                                     validate_chunk_plan)
from repro_torch.dist.sharding import (cache_specs, param_spec, param_specs,
                                       train_state_specs)

__all__ = ["aggregate", "layout", "sharding", "STRATEGIES",
           "AggregateResult", "aggregate_bucketed",
           "aggregate_bucketed_chunked", "aggregate_compressed",
           "aggregate_dense", "bucket_compress", "gtopk_simulate",
           "init_residuals", "resolve_strategy", "strategy_wire_pairs",
           "BucketLayout", "ChunkPlan", "LeafSegment", "build_chunk_plan",
           "build_layout", "chunk_view", "collective_count",
           "init_flat_residual", "leaf_key_salt", "pack_grads",
           "pack_residual_arrays", "rebudget_layout",
           "unpack_residual_arrays", "unpack_tree", "validate_chunk_plan",
           "cache_specs", "param_spec", "param_specs", "train_state_specs"]
