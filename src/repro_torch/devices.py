"""Where the port's entry points put their tensors: on the card unless
the caller names the CPU.  Nothing drops to the CPU by itself."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`.  Raises when it names CUDA
    and no GPU is visible, rather than running the kernels' plain
    versions on the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no GPU is visible; pass "
                           "device='cpu' to run on the CPU")
    return device
