"""Hand-written Hopper kernels of the port and their plain PyTorch
versions.  ``cuda_build`` compiles the CUDA C++ sources of ``csrc/`` at
first use; Triton kernels compile at their first launch."""
