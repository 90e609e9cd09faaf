"""Dense decoder LM of the port (``repro.models`` dense path)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (forward, from_jax_params, init_params,
                                      loss_fn, to_numpy_tree)

__all__ = ["ModelConfig", "forward", "from_jax_params", "init_params",
           "loss_fn", "to_numpy_tree"]
