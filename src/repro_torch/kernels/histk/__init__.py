"""Hist-k selection (port of ``repro.kernels.histk``): the K4d histogram
kernel and the threshold read off it."""
from repro_torch.kernels.histk.ops import (histk_cap, histk_select_kernel,
                                           histk_threshold)

__all__ = ["histk_cap", "histk_select_kernel", "histk_threshold"]
