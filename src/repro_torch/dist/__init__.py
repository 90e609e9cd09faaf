"""Distributed layer (port of ``repro.dist``): the static bucket layout,
the Eq.-2 aggregation over it for the four wire strategies, and the wire
itself (``wire.py``: W workers in one process, or one per process over
``torch.distributed``)."""
from repro_torch.dist import aggregate, layout
from repro_torch.dist.aggregate import (AggregateResult, aggregate_bucketed,
                                        aggregate_dense, bucket_compress)
from repro_torch.dist.layout import (BucketLayout, LeafSegment, build_layout,
                                     collective_count, init_flat_residual,
                                     leaf_key_salt, pack_grads,
                                     rebudget_layout, strategy_wire_pairs,
                                     unpack_tree)

__all__ = ["aggregate", "layout", "AggregateResult", "aggregate_bucketed",
           "aggregate_dense", "bucket_compress", "BucketLayout",
           "LeafSegment", "build_layout", "collective_count",
           "init_flat_residual", "leaf_key_salt", "pack_grads",
           "rebudget_layout", "strategy_wire_pairs", "unpack_tree"]
