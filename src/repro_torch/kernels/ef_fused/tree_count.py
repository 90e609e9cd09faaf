"""K2 — the refinement loop of Algorithm 1 in ONE pass: int32 counts of
``|g + e| > t_j`` for every threshold of the refinement tree.

Replaces the TPU kernel ``repro/kernels/ef_fused/tree_count.py:
tree_count`` (``pallas_call`` at line 93).  With ``refine_iters = 4``
the tree has ``n_t = 2^4 - 1 = 15`` internal nodes; the counts let
``ops._replay_refinement`` replay the sequential loop's decisions
exactly without touching device memory again.  The same kernel with one
threshold is the unfused pipeline's K4b ``count_gt``
(``kernels/gaussian_topk/count_gt.py``).

The kernel is CUDA C++ in ``repro_torch/csrc/tree_count.cu`` (its
header says what bounds it, 0.64 ms at f32 and 0.32 ms at bf16 for the
268,435,456-element leaf, and how the design answers); this module
builds it at first use (``kernels/cuda_build.py``), sorts the
thresholds and removes their duplicates on the host (the kernel takes
them in its parameters and maps its counts back to the caller's order),
launches on the current stream and counts launches.  Either operand may
be f32 or bf16; both are widened to f32 before the add and the
comparisons, as the reference's ``_load_u`` does (``tree_count.py:
36-38``).  The count is an exact integer in any order, so the kernel's
grid is its own: the stats block reaches only the plain version, whose
per-block sums it shapes.

Thresholds given on the host cost no sync; a CUDA tensor of thresholds
is copied to the host first (the fused pipeline passes its heap from
the host).

The plain version, :func:`tree_count_plain`, counts with torch ops block
by block; the wrapper takes it for CPU tensors only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.ef_fused.fused_moments import (_blocks, _check,
                                                        check_cuda_dtypes,
                                                        dtype_code)

SOURCE = "tree_count.cu"
MAX_THRESHOLDS = 128


def tree_count_plain(g: torch.Tensor, e, thresholds: torch.Tensor, *,
                     block: int) -> torch.Tensor:
    """Plain PyTorch version of K2: per-block counts summed over blocks.
    Returns an ``(n_t,)`` int32 tensor."""
    u = g.to(torch.float32)
    if e is not None:
        u = u + e.to(torch.float32)
    a = _blocks(u, block).abs()
    t = torch.as_tensor(thresholds).to(device=a.device, dtype=torch.float32)
    counts = [(a > t[j]).sum(dim=1).sum() for j in range(t.shape[0])]
    return torch.stack(counts).to(torch.int32)


def _host_thresholds(thresholds) -> np.ndarray:
    if isinstance(thresholds, torch.Tensor):
        thresholds = thresholds.detach().to("cpu", torch.float32).numpy()
    return np.ascontiguousarray(thresholds, dtype=np.float32).reshape(-1)


def launch_counts(name: str, g: torch.Tensor, e, thresholds) -> torch.Tensor:
    """Launch the count kernel on CUDA ``g`` (and ``e``) for 1..128
    thresholds (a tensor on either device or an array): the ``(n_t,)``
    int32 counts in the thresholds' order.  The wrapper that calls this
    counts the launch."""
    check_cuda_dtypes(name, g, e)
    t = _host_thresholds(thresholds)
    n_t = t.shape[0]
    if not 0 < n_t <= MAX_THRESHOLDS:
        raise ValueError(f"need 1..{MAX_THRESHOLDS} thresholds, got {n_t}")
    uniq, slot = np.unique(t, return_inverse=True)
    uniq = np.ascontiguousarray(uniq, dtype=np.float32)
    slot = np.ascontiguousarray(slot.reshape(-1), dtype=np.int32)
    out = torch.empty((n_t,), dtype=torch.int32, device=g.device)
    lib = cuda_build.load(SOURCE)
    with torch.cuda.device(g.device):
        rc = lib.tree_count(
            g.data_ptr(), None if e is None else e.data_ptr(),
            dtype_code(g), dtype_code(g if e is None else e), g.shape[0],
            uniq.ctypes.data, uniq.shape[0], slot.ctypes.data, n_t,
            out.data_ptr(), torch.cuda.current_stream(g.device).cuda_stream)
    cuda_build.check(rc, name)
    return out


def tree_count(g: torch.Tensor, e, thresholds, *,
               block: int) -> torch.Tensor:
    """Counts of ``|g + e| > thresholds[j]``, an ``(n_t,)`` int32 tensor on
    ``g``'s device.  CUDA tensors launch the CUDA kernel (``block`` does
    not reach it); CPU tensors take the plain version."""
    _check(g, e)
    n_t = int(np.shape(thresholds)[0])
    if not 0 < n_t <= MAX_THRESHOLDS:
        raise ValueError(f"need 1..{MAX_THRESHOLDS} thresholds, got {n_t}")
    if g.device.type != "cuda":
        return tree_count_plain(g, e, thresholds, block=block)
    counts = launch_counts("tree_count", g, e, thresholds)
    tree_count.launches += 1
    return counts


tree_count.launches = 0
