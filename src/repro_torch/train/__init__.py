from repro_torch.train.state import init_train_state
from repro_torch.train.step import make_train_step

__all__ = ["init_train_state", "make_train_step"]
