"""K1 — pass A of the fused EF pipeline: sum, sum of squares and abs-max
of ``u = g + e``, one read of the operands, ``u`` never written.

Replaces the TPU kernel ``repro/kernels/ef_fused/fused_moments.py:
fused_moments`` (``pallas_call`` at line 144; ``_kernel`` /
``_partials_kernel``).  The hist-k histogram (``with_hist``) lands with
the hist-k slice.

What bounds it on the card: bytes.  It reads 8 bytes per element
(``g`` and ``e`` in f32) and does ~5 flops on them, far below the H100's
~20 flops per byte of f32 balance, so the floor is ``8·d`` bytes over
the memory rate (0.64 ms for the 268,435,456-element leaf at
3.35 TB/s).

Design: a Triton streaming reduction.  Each program loads one
``stats_block`` of ``g`` and ``e`` with masked 16-byte vector loads
(the ragged tail reads as 0, which is what the reference's zero padding
contributes), forms ``u`` in registers and reduces it with ``tl.sum`` /
``tl.max`` (warp-shuffle trees).  It writes ONE partial row ``(s, sq,
mx)``; no float atomics.  The wrapper folds the rows with torch's
reductions, which are deterministic, so a rerun on the same inputs gives
the same threshold.  Bit-equality with JAX is not a goal: XLA orders
the in-block sum its own way, so ``s``/``sq`` are held within a stated
tolerance (``tests/test_torch_kernels.py``).

The plain version, :func:`fused_moments_plain`, runs the same blocks
with torch ops; the wrapper takes it for CPU tensors only.
"""
from __future__ import annotations

import torch

tl = None      # triton.language, bound at the first launch
_KERNEL = []   # the jitted kernel, built once at the first launch


def _moments_kernel(g_ptr, e_ptr, part_ptr, d, HAS_E: "tl.constexpr",
                    BLOCK: "tl.constexpr"):
    pid = tl.program_id(0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < d
    x = tl.load(g_ptr + offs, mask=m, other=0.0)
    if HAS_E:
        x = x + tl.load(e_ptr + offs, mask=m, other=0.0)
    s = tl.sum(x, axis=0)
    sq = tl.sum(x * x, axis=0)
    mx = tl.max(tl.abs(x), axis=0)
    row = part_ptr + pid.to(tl.int64) * 3
    tl.store(row, s)
    tl.store(row + 1, sq)
    tl.store(row + 2, mx)


def _kernel():
    if not _KERNEL:
        global tl
        import triton
        import triton.language
        tl = triton.language
        _KERNEL.append(triton.jit(_moments_kernel))
    return _KERNEL[0]


def _check(g, e):
    if g.dim() != 1 or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous 1-D tensor, got shape "
                         f"{tuple(g.shape)}")
    if e is not None and (e.shape != g.shape or e.device != g.device
                          or not e.is_contiguous()):
        raise ValueError("e must be a contiguous tensor shaped and placed "
                         "like g")


def _check_cuda_f32(name, *xs):
    for x in xs:
        if x is not None and x.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                            f"{x.dtype}")


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """``x`` zero-padded to whole blocks, as ``(nblocks, block)``."""
    d = x.shape[0]
    nb = max(1, -(-d // block))
    return torch.nn.functional.pad(x, (0, nb * block - d)).view(nb, block)


def fused_moments_plain(g: torch.Tensor, e=None, *, block: int):
    """Plain PyTorch version of K1: per-block ``(s, sq, mx)`` rows of
    ``u = g + e`` folded in block order.  Returns three 0-d f32 tensors."""
    u = g.to(torch.float32)
    if e is not None:
        u = u + e.to(torch.float32)
    x = _blocks(u, block)
    s_rows = x.sum(dim=1)
    sq_rows = (x * x).sum(dim=1)
    mx_rows = x.abs().amax(dim=1)
    # cumsum folds left to right on the CPU — the reference's own
    # sequential-grid accumulation order
    return (torch.cumsum(s_rows, 0)[-1], torch.cumsum(sq_rows, 0)[-1],
            mx_rows.amax())


def fused_moments(g: torch.Tensor, e=None, *, block: int):
    """``(sum, sumsq, absmax)`` of ``u = g + e`` as 0-d f32 tensors on
    ``g``'s device.  CUDA tensors launch the Triton kernel (f32 only,
    ``block`` a power of two); CPU tensors take the plain version."""
    _check(g, e)
    if g.device.type != "cuda":
        return fused_moments_plain(g, e, block=block)
    _check_cuda_f32("fused_moments", g, e)
    if block < 16 or block & (block - 1):
        raise ValueError(f"stats block must be a power of two >= 16, got "
                         f"{block}")
    d = g.shape[0]
    nb = max(1, -(-d // block))
    parts = torch.empty((nb, 3), dtype=torch.float32, device=g.device)
    kern = _kernel()
    with torch.cuda.device(g.device):
        kern[(nb,)](g, g if e is None else e, parts, d, HAS_E=e is not None,
                    BLOCK=block, num_warps=4)
    fused_moments.launches += 1
    # deterministic fold of the per-block rows (no float atomics)
    return parts[:, 0].sum(), parts[:, 1].sum(), parts[:, 2].amax()


fused_moments.launches = 0
