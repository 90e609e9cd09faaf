"""Serving and the train-to-serve weight-delta stream (port of
``repro.serve``): the publisher, the replica's apply, and the serve
steps on one device or placed over the mesh's data and model axes
(``ServePlacement``), with the reference's serving specs as tuples
(``serve_param_specs``, ``decode_specs``)."""
from repro_torch.serve.publish import (DELTA, RESYNC, DeltaMessage,
                                       encode_delta, init_publisher_state,
                                       message_bits, publish,
                                       publisher_config, resyncs_at)
from repro_torch.serve.steps import (ServePlacement, decode_specs,
                                     make_decode_step, make_prefill_step,
                                     serve_param_specs)
from repro_torch.serve.subscribe import (apply_delta, apply_message,
                                         apply_resync, make_apply_delta)

__all__ = ["DELTA", "RESYNC", "DeltaMessage", "ServePlacement",
           "apply_delta", "apply_message", "apply_resync", "decode_specs",
           "encode_delta", "init_publisher_state", "make_apply_delta",
           "make_decode_step", "make_prefill_step", "message_bits",
           "publish", "publisher_config", "resyncs_at", "serve_param_specs"]
