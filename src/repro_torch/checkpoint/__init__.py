"""Checkpoints of the port (``repro.checkpoint`` counterpart)."""
from repro_torch.checkpoint.npz import load_state, save_state

__all__ = ["load_state", "save_state"]
