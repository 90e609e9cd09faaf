"""Single-pass moments (port of ``repro.kernels.moments``): the K4a
kernel and ``mean_std_absmax``."""
from repro_torch.kernels.moments.ops import mean_std_absmax

__all__ = ["mean_std_absmax"]
