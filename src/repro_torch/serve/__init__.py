"""Serving and the train-to-serve weight-delta stream (port of
``repro.serve``, without its sharding-only ``serve_param_specs`` and
``decode_shardings``, which wait for the model axis)."""
from repro_torch.serve.publish import (DELTA, RESYNC, DeltaMessage,
                                       encode_delta, init_publisher_state,
                                       message_bits, publish,
                                       publisher_config)
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.serve.subscribe import (apply_delta, apply_message,
                                         apply_resync, make_apply_delta)

__all__ = ["DELTA", "RESYNC", "DeltaMessage", "apply_delta", "apply_message",
           "apply_resync", "encode_delta", "init_publisher_state",
           "make_apply_delta", "make_decode_step", "make_prefill_step",
           "message_bits", "publish", "publisher_config"]
