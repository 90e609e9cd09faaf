"""The unfused Gaussian-k selection pipeline (port of
``repro.kernels.gaussian_topk``): the K4b count and K4c compaction
kernels and the threshold loop around them."""
from repro_torch.kernels.gaussian_topk.ops import (gaussian_threshold_kernel,
                                                   gaussiank_select_kernel,
                                                   select_by_threshold)

__all__ = ["gaussian_threshold_kernel", "gaussiank_select_kernel",
           "select_by_threshold"]
