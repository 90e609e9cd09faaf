"""Bulk threefry2x32 draws for ``repro_torch.prng``: the Triton
``threefry_bits`` kernel and its plain PyTorch version."""
from repro_torch.kernels.prng.threefry import (threefry_bits,
                                               threefry_bits_plain)

__all__ = ["threefry_bits", "threefry_bits_plain"]
