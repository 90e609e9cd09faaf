"""K2 — the refinement loop of Algorithm 1 in ONE pass: int32 counts of
``|g + e| > t_j`` for every threshold of the refinement tree.

Replaces the TPU kernel ``repro/kernels/ef_fused/tree_count.py:
tree_count`` (``pallas_call`` at line 93).  With ``refine_iters = 4``
the tree has ``n_t = 2^4 - 1 = 15`` internal nodes; the counts let
``ops._replay_refinement`` replay the sequential loop's decisions
exactly without touching device memory again.  The same kernel with one
threshold is the unfused pipeline's K4b ``count_gt``
(``kernels/gaussian_topk/count_gt.py``).

What bounds it on the card: bytes.  Each element is read once
(``8·d`` bytes of f32 ``g`` and ``e``, ``4·d`` of bf16) and compared with
15 thresholds — ~17 operations on 8 bytes, below the f32 balance point,
so the floor is the same as K1's for the largest leaf: 0.64 ms at 3.35
TB/s in f32, 0.32 ms in bf16.  Either operand may be f32 or bf16; both
are widened to f32 before the add and the comparisons, as the
reference's ``_load_u`` does (``tree_count.py:36-38``).

Design: a Triton reduction.  The thresholds (padded to a power of two
with ``+inf``, which no finite ``|u|`` exceeds) live in registers; each
program walks its ``stats_block`` in tiles of ``TILE`` elements, loads
each tile straight into the 2-D ``(NT, TILE)`` layout of the comparison
(a 1-D load broadcast to 2-D costs a layout conversion through shared
memory per tile) and adds the comparison into a register accumulator of
that shape, so the cross-thread reduction to ``NT`` counts happens once
per program rather than once per tile: with 15 thresholds the
compare-and-add work per element is what competes with the loads.  Each program writes its own row of counts; the wrapper sums
the rows in integers, which is exact in any order.

The plain version, :func:`tree_count_plain`, counts with torch ops block
by block; the wrapper takes it for CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ef_fused.fused_moments import (_blocks, _check,
                                                        check_cuda_dtypes)

tl = None      # triton.language, bound at the first launch
_KERNEL = []
TILE = 512


def _tree_count_kernel(g_ptr, e_ptr, t_ptr, part_ptr, d,
                       HAS_E: "tl.constexpr", BLOCK: "tl.constexpr",
                       TILE: "tl.constexpr", NT: "tl.constexpr"):
    pid = tl.program_id(0)
    tj = tl.arange(0, NT)
    t = tl.load(t_ptr + tj[:, None])                 # (NT, 1)
    acc = tl.zeros((NT, TILE), dtype=tl.int32)
    base = pid.to(tl.int64) * BLOCK
    for start in range(0, BLOCK, TILE):
        # loaded straight into the 2-D layout of the comparison: no
        # register-layout conversion through shared memory per tile
        offs = base + start + tl.arange(0, TILE)[None, :]   # (1, TILE)
        m = offs < d
        x = tl.load(g_ptr + offs, mask=m, other=0.0).to(tl.float32)
        if HAS_E:
            x = x + tl.load(e_ptr + offs, mask=m,
                            other=0.0).to(tl.float32)
        acc += ((tl.abs(x) > t) & m).to(tl.int32)
    # one cross-thread reduction per program, not one per tile
    tl.store(part_ptr + pid.to(tl.int64) * NT + tj, tl.sum(acc, axis=1))


def _kernel():
    if not _KERNEL:
        global tl
        import triton
        import triton.language
        tl = triton.language
        _KERNEL.append(triton.jit(_tree_count_kernel))
    return _KERNEL[0]


def tree_count_plain(g: torch.Tensor, e, thresholds: torch.Tensor, *,
                     block: int) -> torch.Tensor:
    """Plain PyTorch version of K2: per-block counts summed over blocks.
    Returns an ``(n_t,)`` int32 tensor."""
    u = g.to(torch.float32)
    if e is not None:
        u = u + e.to(torch.float32)
    a = _blocks(u, block).abs()
    t = thresholds.to(device=a.device, dtype=torch.float32)
    counts = [(a > t[j]).sum(dim=1).sum() for j in range(t.shape[0])]
    return torch.stack(counts).to(torch.int32)


def launch_counts(name: str, g: torch.Tensor, e, thresholds: torch.Tensor,
                  *, block: int, num_warps=None) -> torch.Tensor:
    """Launch the count kernel on CUDA ``g`` (and ``e``) for 1..128
    thresholds with ``num_warps`` warps a program (``None``: 8 for
    blocks of 4096 and more, else 4): the ``(n_t,)`` int32 counts,
    summed over the blocks.  The wrapper that calls this counts the
    launch."""
    check_cuda_dtypes(name, g, e)
    n_t = int(thresholds.shape[0])
    nt = max(2, 1 << (n_t - 1).bit_length())
    tile = min(TILE, 8192 // nt)     # accumulator: <= 8192 int32 a program
    if block < tile or block & (block - 1):
        raise ValueError(f"stats block must be a power of two >= {tile}, "
                         f"got {block}")
    t = torch.full((nt,), float("inf"), dtype=torch.float32, device=g.device)
    t[:n_t] = thresholds.to(device=g.device, dtype=torch.float32)
    d = g.shape[0]
    nb = max(1, -(-d // block))
    parts = torch.empty((nb, nt), dtype=torch.int32, device=g.device)
    kern = _kernel()
    with torch.cuda.device(g.device):
        kern[(nb,)](g, g if e is None else e, t, parts, d,
                    HAS_E=e is not None, BLOCK=block, TILE=tile, NT=nt,
                    num_warps=num_warps or (8 if block >= 4096 else 4))
    return parts[:, :n_t].sum(dim=0).to(torch.int32)


def tree_count(g: torch.Tensor, e, thresholds: torch.Tensor, *,
               block: int, num_warps=None) -> torch.Tensor:
    """Counts of ``|g + e| > thresholds[j]``, an ``(n_t,)`` int32 tensor on
    ``g``'s device.  CUDA tensors launch the Triton kernel with
    ``num_warps`` warps or, unless given, 8 for blocks of 4096 and more,
    else 4 (the faster of the two on an H100 for each); CPU tensors take
    the plain version."""
    _check(g, e)
    n_t = int(thresholds.shape[0])
    if not 0 < n_t <= 128:
        raise ValueError(f"need 1..128 thresholds, got {n_t}")
    if g.device.type != "cuda":
        return tree_count_plain(g, e, thresholds, block=block)
    counts = launch_counts("tree_count", g, e, thresholds, block=block,
                           num_warps=num_warps)
    tree_count.launches += 1
    return counts


tree_count.launches = 0
