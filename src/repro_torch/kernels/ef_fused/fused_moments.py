"""K1 — pass A of the fused EF pipeline: sum, sum of squares and abs-max
of ``u = g + e`` and, for hist-k, the 128-bin ``|u|`` histogram; one read
of the operands, ``u`` never written.

Replaces the TPU kernel ``repro/kernels/ef_fused/fused_moments.py:
fused_moments`` (``pallas_call`` at line 144; ``_kernel`` /
``_partials_kernel``), its ``with_hist`` branch included
(:func:`fused_moments_hist`).  The same Triton kernel, specialised by
its ``constexpr`` switches, is also the unfused pipeline's K4a
``moments`` (``HAS_E=False``), whose wrapper lives at the reference's
path (``kernels/moments``).  K4d ``abs_histogram``, the histogram of a
materialised ``u``, was this kernel too in the first port; it is now a CUDA
C++ kernel of its own (``csrc/abs_histogram.cu``, wrapped in
``kernels/histk/hist.py``), and K1 keeps its Triton histogram.

What bounds it on the card: bytes.  It reads 8 bytes per element
(``g`` and ``e`` in f32; 4 with both in bf16) and does ~5 flops on them
(~15 integer operations more with the histogram), far below the H100's
~20 flops per byte of f32 balance, so the floor is the operands' bytes
over the memory rate (0.64 ms for the 268,435,456-element leaf at 3.35
TB/s in f32, 0.32 ms in bf16).  The histogram adds one 512-byte row of
partial counts per program: 33.5 MB at that leaf with 4096-element
blocks, 2% of the bytes read.

Design: a Triton streaming reduction.  Each program loads one
``stats_block`` of ``g`` and ``e`` with masked 16-byte vector loads
(the ragged tail reads as 0, which is what the reference's zero padding
contributes), each operand in its own dtype (f32 or bf16: 4 or 8
elements a load), widens both to f32 and forms ``u = f32(g) + f32(e)``
in registers, as the reference's kernel does
(``repro/kernels/ef_fused/fused_moments.py:56-59``), and reduces it
with ``tl.sum`` / ``tl.max`` (warp-shuffle trees).  It writes ONE
partial row ``(s, sq, mx)``; no float atomics.  The wrapper folds the rows with torch's
reductions, which are deterministic, so a rerun on the same inputs gives
the same threshold.  Bit-equality with JAX is not a goal: XLA orders
the in-block sum its own way, so ``s``/``sq`` are held within a stated
tolerance (``tests/test_torch_kernels.py``).

With ``WITH_HIST`` each program bins its elements with the integer bin
function of ``kernels/histk/hist.py`` (exponent and mantissa bits of
``|u|`` against the f32 bin edges; no ``log2``, so the card and the CPU
bin every element alike) and reduces them with ``tl.histogram`` into one
int32 row of 128 counts.  The wrapper sums the rows in int64 (exact in
any order) and takes the padding zeros, which land in bin 0, back out.

The plain versions (``*_plain``) run the same blocks with torch ops; the
wrappers take them for CPU tensors only.
"""
from __future__ import annotations

import torch

tl = None      # triton.language, bound at the first launch
_KERNEL = []   # the jitted kernel, built once at the first launch
BINS = 128     # hist-k bins (kernels/histk/hist.py)


def _moments_kernel(g_ptr, e_ptr, part_ptr, hist_ptr, d,
                    HAS_E: "tl.constexpr", WITH_HIST: "tl.constexpr",
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
    if WITH_HIST:
        # histk/hist.py:bin_of — 4·(biased exponent − 111) plus the
        # number of the f32 edge mantissas of 2^(1/4), 2^(1/2), 2^(3/4)
        # at or below the mantissa, clamped to [0, 127]
        bits = tl.abs(x).to(tl.int32, bitcast=True)
        man = bits & 0x7FFFFF
        q = ((man >= 0x1837F0).to(tl.int32) + (man >= 0x3504F3).to(tl.int32)
             + (man >= 0x5744FD).to(tl.int32))
        b = (bits >> 23) * 4 - 444 + q
        b = tl.minimum(tl.maximum(b, 0), 127)
        h = tl.histogram(b, 128)
        tl.store(hist_ptr + pid.to(tl.int64) * 128 + tl.arange(0, 128), h)


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


def launch_stats(name: str, g: torch.Tensor, e, *, block: int, hist: bool,
                 num_warps=None):
    """Launch the statistics kernel on CUDA ``g`` (and ``e``) with
    ``num_warps`` warps a program (``None``: 4): returns the folded
    ``(s, sq, mx)`` and the int64 ``(BINS,)`` histogram of the ``d`` real
    elements (or ``None``).  The wrapper that calls this counts the
    launch."""
    check_cuda_dtypes(name, g, e)
    if block < 16 or block & (block - 1):
        raise ValueError(f"stats block must be a power of two >= 16, got "
                         f"{block}")
    d = g.shape[0]
    nb = max(1, -(-d // block))
    parts = torch.empty((nb, 3), dtype=torch.float32, device=g.device)
    hparts = (torch.empty((nb, BINS), dtype=torch.int32, device=g.device)
              if hist else g)
    kern = _kernel()
    with torch.cuda.device(g.device):
        kern[(nb,)](g, g if e is None else e, parts, hparts, d,
                    HAS_E=e is not None, WITH_HIST=hist, BLOCK=block,
                    num_warps=num_warps or 4)
    # deterministic folds of the per-block rows (no float atomics)
    stats = parts[:, 0].sum(), parts[:, 1].sum(), parts[:, 2].amax()
    h = None
    if hist:
        h = hparts.sum(dim=0, dtype=torch.int64)
        h[0] -= nb * block - d        # the padding zeros landed in bin 0
    return stats, h


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
    stats, _ = launch_stats("fused_moments", g, e, block=block, hist=False,
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


def fused_moments_hist(g: torch.Tensor, e=None, *, block: int,
                       num_warps=None):
    """``(sum, sumsq, absmax, hist)`` of ``u = g + e`` in one pass:
    the reference's ``fused_moments(..., with_hist=True)``.  ``hist`` is
    the int64 ``(BINS,)`` histogram of the ``d`` real elements (padding
    already taken out of bin 0).  CUDA tensors launch the Triton kernel
    (``num_warps`` as in :func:`fused_moments`); CPU tensors take the
    plain version."""
    _check(g, e)
    if g.device.type != "cuda":
        return fused_moments_hist_plain(g, e, block=block)
    stats, h = launch_stats("fused_moments_hist", g, e, block=block,
                            hist=True, num_warps=num_warps)
    fused_moments_hist.launches += 1
    return (*stats, h)


fused_moments.launches = 0
fused_moments_hist.launches = 0
