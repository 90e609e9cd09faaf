"""Serving and the train-to-serve weight-delta stream (port of
``repro.serve``; of its sharding pieces, the specs alone:
``serve_param_specs`` and ``decode_specs``, the spec half of
``decode_shardings``)."""
from repro_torch.serve.publish import (DELTA, RESYNC, DeltaMessage,
                                       encode_delta, init_publisher_state,
                                       message_bits, publish,
                                       publisher_config)
from repro_torch.serve.steps import (decode_specs, make_decode_step,
                                     make_prefill_step, serve_param_specs)
from repro_torch.serve.subscribe import (apply_delta, apply_message,
                                         apply_resync, make_apply_delta)

__all__ = ["DELTA", "RESYNC", "DeltaMessage", "apply_delta", "apply_message",
           "apply_resync", "decode_specs", "encode_delta",
           "init_publisher_state", "make_apply_delta", "make_decode_step",
           "make_prefill_step", "message_bits", "publish",
           "publisher_config", "serve_param_specs"]
