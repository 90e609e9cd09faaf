"""K1 — pass A of the fused EF pipeline: sum, sum of squares and abs-max
of ``u = g + e`` and, for hist-k, the 128-bin ``|u|`` histogram; one read
of the operands, ``u`` never written.

Replaces the TPU kernel ``repro/kernels/ef_fused/fused_moments.py:
fused_moments`` (``pallas_call`` at line 144; ``_kernel`` /
``_partials_kernel``), its ``with_hist`` branch included
(:func:`fused_moments_hist`).  Two kernels: the moments alone are a
Triton kernel, which specialised by its ``constexpr`` switches is also
the unfused pipeline's K4a ``moments`` (``HAS_E=False``, wrapper at the
reference's path, ``kernels/moments``); the moments with the histogram
are CUDA C++, one template with K4d ``abs_histogram`` in
``csrc/abs_histogram.cu`` (its header has the design), built at first use
by ``kernels/cuda_build.py``.

What bounds both on the card: bytes.  They read 8 bytes per element
(``g`` and ``e`` in f32; 4 with both in bf16) and do ~5 flops on them
(~10 integer operations more with the histogram), far below the H100's
~20 flops per byte of f32 balance, so the floor is the operands' bytes
over the memory rate (0.64 ms for the 268,435,456-element leaf at 3.35
TB/s in f32, 0.32 ms in bf16).

The Triton kernel (:func:`fused_moments`): a streaming reduction.  Each
program loads one ``stats_block`` of ``g`` and ``e`` with masked 16-byte
vector loads (the ragged tail reads as 0, which is what the reference's
zero padding contributes), each operand in its own dtype (f32 or bf16: 4
or 8 elements a load), widens both to f32 and forms ``u = f32(g) +
f32(e)`` in registers, as the reference's kernel does
(``repro/kernels/ef_fused/fused_moments.py:56-59``), and reduces it with
``tl.sum`` / ``tl.max`` (warp-shuffle trees) with ``num_warps`` warps.
It writes ONE partial row ``(s, sq, mx)``; no float atomics.

The CUDA kernel (:func:`fused_moments_hist`): a persistent grid of at
most one CTA per SM walks ``g`` and ``e`` in 16-byte loads, bins each
``u`` by the integer bin function of ``kernels/histk/hist.py`` into
per-lane shared-memory counters (the exact position of ``|u|`` among the
f32 bin edges; no ``log2``, so the card and the CPU bin every element
alike), adds each CTA's 128 sums into the int64 histogram with integer
atomics, and writes one f64 ``(s, sq, mx)`` row a CTA.  There are no
per-block rows and no padding in bin 0.  Its grid is its own: the stats
block reaches only the plain version, and ``num_warps`` only the Triton
kernel.  Its first design was the Triton kernel with a ``tl.histogram``
of each block into a 512-byte row: at bf16 it ran at 32% of its bound
(``PERF.md``).

Either way the wrapper folds the rows with torch's reductions, which are
deterministic, so a rerun on the same inputs gives the same threshold.
Bit-equality with JAX is not a goal: XLA orders the in-block sum its own
way, so ``s``/``sq`` are held within a stated tolerance
(``tests/test_torch_kernels.py``); ``mx`` and the histogram are exact.

The plain versions (``*_plain``) run the reference's blocks with torch
ops; the wrappers take them for CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build

tl = None      # triton.language, bound at the first launch
_KERNEL = []   # the jitted kernel, built once at the first launch
BINS = 128     # hist-k bins (kernels/histk/hist.py)
SOURCE = "abs_histogram.cu"   # K1 with its histogram, beside K4d


def _moments_kernel(g_ptr, e_ptr, part_ptr, d, HAS_E: "tl.constexpr",
                    BLOCK: "tl.constexpr"):
    pid = tl.program_id(0)
    offs = pid.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < d
    x = tl.load(g_ptr + offs, mask=m, other=0.0).to(tl.float32)
    if HAS_E:
        x = x + tl.load(e_ptr + offs, mask=m, other=0.0).to(tl.float32)
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


# the operand dtypes the card's EF kernels load; each forms u in f32
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def out_dtype(g: torch.Tensor, e) -> torch.dtype:
    """The dtype of ``e'`` and of the wire values: the promoted type of
    ``g`` and ``e`` (``g``'s without ``e``), the reference's
    ``result_type(g, e)``."""
    return g.dtype if e is None else torch.promote_types(g.dtype, e.dtype)


def check_cuda_dtypes(name, *xs):
    """Raise ``TypeError`` unless every operand given is f32 or bf16."""
    for x in xs:
        if x is not None and x.dtype not in KERNEL_DTYPES:
            raise TypeError(f"{name}: the CUDA kernels take float32 or "
                            f"bfloat16 operands, got {x.dtype}")


def dtype_code(x) -> int:
    """The C kernels' operand type: 0 f32, 1 bf16 (checked before)."""
    return int(x.dtype == torch.bfloat16)


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    """``x`` zero-padded to whole blocks, as ``(nblocks, block)``."""
    d = x.shape[0]
    nb = max(1, -(-d // block))
    return torch.nn.functional.pad(x, (0, nb * block - d)).view(nb, block)


def launch_stats(name: str, g: torch.Tensor, e, *, block: int,
                 num_warps=None):
    """Launch the Triton statistics kernel on CUDA ``g`` (and ``e``) with
    ``num_warps`` warps a program (``None``: 4): returns the folded
    ``(s, sq, mx)``.  The wrapper that calls this counts the launch."""
    check_cuda_dtypes(name, g, e)
    if block < 16 or block & (block - 1):
        raise ValueError(f"stats block must be a power of two >= 16, got "
                         f"{block}")
    d = g.shape[0]
    nb = max(1, -(-d // block))
    parts = torch.empty((nb, 3), dtype=torch.float32, device=g.device)
    kern = _kernel()
    with torch.cuda.device(g.device):
        kern[(nb,)](g, g if e is None else e, parts, d,
                    HAS_E=e is not None, BLOCK=block,
                    num_warps=num_warps or 4)
    # deterministic folds of the per-block rows (no float atomics)
    return parts[:, 0].sum(), parts[:, 1].sum(), parts[:, 2].amax()


def moments_plain(x: torch.Tensor, block: int):
    """Per-block ``(s, sq, mx)`` rows of ``x`` folded in block order: the
    plain version of the kernel's moments.  Returns three 0-d f32
    tensors."""
    xb = _blocks(x.to(torch.float32), block)
    s_rows = xb.sum(dim=1)
    sq_rows = (xb * xb).sum(dim=1)
    mx_rows = xb.abs().amax(dim=1)
    # cumsum folds left to right on the CPU — the reference's own
    # sequential-grid accumulation order
    return (torch.cumsum(s_rows, 0)[-1], torch.cumsum(sq_rows, 0)[-1],
            mx_rows.amax())


def _u(g, e):
    u = g.to(torch.float32)
    return u if e is None else u + e.to(torch.float32)


def fused_moments_plain(g: torch.Tensor, e=None, *, block: int):
    """Plain PyTorch version of K1: per-block ``(s, sq, mx)`` rows of
    ``u = g + e`` folded in block order.  Returns three 0-d f32 tensors."""
    return moments_plain(_u(g, e), block)


def fused_moments(g: torch.Tensor, e=None, *, block: int, num_warps=None):
    """``(sum, sumsq, absmax)`` of ``u = g + e`` as 0-d f32 tensors on
    ``g``'s device.  CUDA tensors launch the Triton kernel (``g`` and
    ``e`` each f32 or bf16, ``block`` a power of two, ``num_warps`` warps
    a program, 4 unless given); CPU tensors take the plain version."""
    _check(g, e)
    if g.device.type != "cuda":
        return fused_moments_plain(g, e, block=block)
    stats = launch_stats("fused_moments", g, e, block=block,
                         num_warps=num_warps)
    fused_moments.launches += 1
    return stats


def fused_moments_hist_plain(g: torch.Tensor, e=None, *, block: int):
    """Plain PyTorch version of K1 with the histogram: ``(s, sq, mx,
    hist)``, ``hist`` the int64 ``(BINS,)`` counts of the ``d`` real
    elements of ``|u|``."""
    # imported here: the histk package builds on this module's kernel
    from repro_torch.kernels.histk.hist import abs_histogram_plain
    u = _u(g, e)
    return (*moments_plain(u, block), abs_histogram_plain(u, block=block))


def fused_moments_hist(g: torch.Tensor, e=None, *, block: int):
    """``(sum, sumsq, absmax, hist)`` of ``u = g + e`` in one pass:
    the reference's ``fused_moments(..., with_hist=True)``.  ``hist`` is
    the int64 ``(BINS,)`` histogram of the ``d`` real elements.  CUDA
    tensors launch the CUDA kernel (``g`` and ``e`` each f32 or bf16; its
    grid is its own, ``block`` does not reach it); CPU tensors take the
    plain version, blocked by ``block``."""
    _check(g, e)
    if g.device.type != "cuda":
        return fused_moments_hist_plain(g, e, block=block)
    check_cuda_dtypes("fused_moments_hist", g, e)
    dev = g.device
    h = torch.zeros(BINS, dtype=torch.int64, device=dev)
    # one f64 (s, sq, mx) row a CTA, at most one CTA an SM; the kernel
    # writes every row (zeros past its grid)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = torch.empty((sms, 3), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        rc = cuda_build.load(SOURCE).fused_moments_hist(
            g.data_ptr(), None if e is None else e.data_ptr(),
            dtype_code(g), dtype_code(g if e is None else e), g.shape[0],
            h.data_ptr(), rows.data_ptr(), sms,
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(rc, "fused_moments_hist")
    fused_moments_hist.launches += 1
    # deterministic folds of the rows, rounded once to f32
    sums = rows[:, :2].sum(dim=0).to(torch.float32)
    return sums[0], sums[1], rows[:, 2].amax().to(torch.float32), h


fused_moments.launches = 0
fused_moments_hist.launches = 0
