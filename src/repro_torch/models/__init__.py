"""The port's models (``repro.models``): the decoder LM of every
assigned architecture family and its config."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (decode_step, forward, from_jax_params,
                                      init_cache, init_params, loss_fn,
                                      param_count, prefill, to_numpy_tree)

__all__ = ["ModelConfig", "decode_step", "forward", "from_jax_params",
           "init_cache", "init_params", "loss_fn", "param_count", "prefill",
           "to_numpy_tree"]
