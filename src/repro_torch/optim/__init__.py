from repro_torch.optim.optimizers import Optimizer, adamw, sgd_momentum
from repro_torch.optim.schedules import (constant, cosine, density_warmup,
                                         step_decay, warmup_cosine)

__all__ = ["Optimizer", "adamw", "sgd_momentum", "constant", "cosine",
           "density_warmup", "step_decay", "warmup_cosine"]
