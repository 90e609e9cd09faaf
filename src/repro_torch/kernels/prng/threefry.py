"""``threefry_bits`` — bulk threefry2x32 draws, counter by counter, as
``jax.random`` computes them under its partitionable scheme.

Not the port of a ``pl.pallas_call``: the reference's draws are XLA's
threefry, which XLA fuses into the consumer.  The port needs a kernel of
its own because ``randk`` draws one uniform per coordinate of every leaf,
1.24 B a step for llama3.2-1b, and the plain version below spends ~150
full passes of 8-byte integers on each draw.

Counter ``i`` of a draw of ``n`` values is the 64-bit pair ``(hi, lo) =
(i >> 32, i & 0xFFFFFFFF)`` (``prng.iota_2x32_shape``); the hash of that
pair under the key gives two words ``(y0, y1)`` and the 32-bit draw is
``y0 ^ y1`` (``_threefry_random_bits_partitionable``).  Two outputs:

* ``bits``: the draw, its uint32 pattern in an int32 tensor;
* ``rank``: an int64 key ``((y0 ^ y1) >> 9) << 32 | (0xFFFFFFFF - i)``
  that orders the coordinates as ``lax.top_k`` orders ``uniform``
  draws: a uniform is ``(bits >> 9) · 2^-23`` exactly, and equal draws
  (23 bits give only 2^23 values, so a 262,668,288-element leaf is full
  of ties) put the lower index first.  Every key is distinct, so
  ``torch.topk`` of the keys is ``lax.top_k`` of the uniforms.

What bounds it on the card: integer operations.  There are no loads;
each draw writes 4 bytes (bits) or 8 (rank) and costs 73 32-bit integer
operations: the two first key adds, 20 rounds of add, rotate (one funnel
shift) and xor, two adds at each of the 5 key injections and the final
xor.  An H100 SM issues at most 128 thread-instructions a clock (4
schedulers of 32 lanes), 33.5 T a second over 132 SMs at 1.98 GHz, so
268,435,456 draws take at least 0.59 ms of operations against 0.32 ms
for their 1 GiB of writes at 3.35 TB/s.

Design: one Triton program per ``BLOCK`` counters, the whole hash in
uint32 registers (adds wrap, ``>>`` is logical), one coalesced store.
The key words travel as int32 scalars and are bit-cast back to uint32
in the kernel; the counters are int64, so a launch covers any ``n``.

The plain version, :func:`threefry_bits_plain`, is the same hash in
int64 torch ops masked to 32 bits (``torch.uint32`` lacks shifts and
adds on some backends).  The wrapper takes it for CPU tensors only, in
chunks of ``CHUNK`` counters so that its int64 temporaries stay bounded;
threefry is counter-based, so the chunks are exact.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
ROT0 = (13, 15, 26, 6)
ROT1 = (17, 29, 16, 24)
PARITY = 0x1BD11BDA
BLOCK = 1024
CHUNK = 1 << 22         # the plain version's counters per chunk

tl = None      # triton.language, bound at the first launch
_KERNEL = []


def _threefry_kernel(out_ptr, k0, k1, n, RANK: "tl.constexpr",
                     BLOCK: "tl.constexpr"):
    i = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = i < n
    x0 = (i >> 32).to(tl.uint32)
    x1 = (i & 0xFFFFFFFF).to(tl.uint32)
    ks0 = k0.to(tl.uint32, bitcast=True)
    ks1 = k1.to(tl.uint32, bitcast=True)
    ks2 = ks0 ^ ks1 ^ 0x1BD11BDA
    x0 = x0 + ks0
    x1 = x1 + ks1
    # 5 groups of 4 rounds, the key injected after each group
    x0 = x0 + x1
    x1 = ((x1 << 13) | (x1 >> 19)) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << 15) | (x1 >> 17)) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << 26) | (x1 >> 6)) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << 6) | (x1 >> 26)) ^ x0
    x0 = x0 + ks1
    x1 = x1 + ks2 + 1
    x0 = x0 + x1
    x1 = ((x1 << 17) | (x1 >> 15)) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << 29) | (x1 >> 3)) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << 16) | (x1 >> 16)) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << 24) | (x1 >> 8)) ^ x0
    x0 = x0 + ks2
    x1 = x1 + ks0 + 2
    x0 = x0 + x1
    x1 = ((x1 << 13) | (x1 >> 19)) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << 15) | (x1 >> 17)) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << 26) | (x1 >> 6)) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << 6) | (x1 >> 26)) ^ x0
    x0 = x0 + ks0
    x1 = x1 + ks1 + 3
    x0 = x0 + x1
    x1 = ((x1 << 17) | (x1 >> 15)) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << 29) | (x1 >> 3)) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << 16) | (x1 >> 16)) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << 24) | (x1 >> 8)) ^ x0
    x0 = x0 + ks1
    x1 = x1 + ks2 + 4
    x0 = x0 + x1
    x1 = ((x1 << 13) | (x1 >> 19)) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << 15) | (x1 >> 17)) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << 26) | (x1 >> 6)) ^ x0
    x0 = x0 + x1
    x1 = ((x1 << 6) | (x1 >> 26)) ^ x0
    x0 = x0 + ks2
    x1 = x1 + ks0 + 5
    bits = x0 ^ x1
    if RANK:
        key = ((bits >> 9).to(tl.int64) << 32) | (0xFFFFFFFF - i)
        tl.store(out_ptr + i, key, mask=m)
    else:
        tl.store(out_ptr + i, bits.to(tl.int32, bitcast=True), mask=m)


def _kernel():
    if not _KERNEL:
        global tl
        import triton
        import triton.language
        tl = triton.language
        _KERNEL.append(triton.jit(
            _threefry_kernel, do_not_specialize=["k0", "k1", "n"]))
    return _KERNEL[0]


def _rounds(x0: torch.Tensor, x1: torch.Tensor, rots) -> None:
    """Four threefry rounds on int64 words in ``[0, 2^32)``, in place."""
    for r in rots:
        x0.add_(x1).bitwise_and_(MASK)
        hi = torch.bitwise_left_shift(x1, r).bitwise_and_(MASK)
        x1.bitwise_right_shift_(32 - r).bitwise_or_(hi).bitwise_xor_(x0)


def threefry2x32_plain(key, x0: torch.Tensor, x1: torch.Tensor):
    """threefry2x32 of the counter words ``(x0, x1)`` (int64 tensors in
    ``[0, 2^32)``, not modified) under ``key = (k0, k1)``: the two hashed
    words, int64 in ``[0, 2^32)``, in plain torch ops."""
    k0, k1 = int(key[0]) & MASK, int(key[1]) & MASK
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + ks[0]).bitwise_and_(MASK)
    x1 = (x1 + ks[1]).bitwise_and_(MASK)
    for g in range(5):
        _rounds(x0, x1, ROT0 if g % 2 == 0 else ROT1)
        x0.add_(ks[(g + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(g + 2) % 3] + g + 1).bitwise_and_(MASK)
    return x0, x1


def threefry_bits_plain(key, start: int, n: int, *, rank: bool = False,
                        device="cpu") -> torch.Tensor:
    """Plain PyTorch version of the kernel: counters ``start .. start +
    n - 1`` hashed under ``key``.  Returns the draws as int32 (their
    uint32 patterns), or the int64 rank keys when ``rank``."""
    i = torch.arange(start, start + n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32_plain(key, torch.bitwise_right_shift(i, 32),
                                torch.bitwise_and(i, MASK))
    bits = y0.bitwise_xor_(y1)
    if rank:
        return bits.bitwise_right_shift_(9).bitwise_left_shift_(32) \
            .bitwise_or_(MASK - i)
    # the uint32 pattern as a two's-complement int32
    return bits.add_(1 << 31).bitwise_and_(MASK).sub_(1 << 31) \
        .to(torch.int32)


def _signed32(x: int) -> int:
    x &= MASK
    return x - (1 << 32) if x > 0x7FFFFFFF else x


def threefry_bits(key, out: torch.Tensor) -> torch.Tensor:
    """Fill the 1-D ``out`` with the draws of counters ``0 .. n - 1``
    under ``key``: int32 ``out`` takes the 32-bit draws, int64 ``out``
    the rank keys.  A CUDA ``out`` launches the Triton kernel (one
    launch, counted in ``threefry_bits.launches``); a CPU ``out`` takes
    the plain version, ``CHUNK`` counters at a time.  Returns ``out``."""
    if out.dim() != 1 or not out.is_contiguous():
        raise ValueError("threefry_bits fills a contiguous 1-D tensor")
    if out.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"threefry_bits: out must be int32 (bits) or "
                         f"int64 (rank keys), got {out.dtype}")
    rank = out.dtype == torch.int64
    n = out.shape[0]
    if rank and n > 1 << 32:
        raise ValueError("rank keys number the counters in 32 bits")
    if out.device.type != "cuda":
        for a in range(0, n, CHUNK):
            b = min(a + CHUNK, n)
            out[a:b] = threefry_bits_plain(key, a, b - a, rank=rank,
                                           device=out.device)
        return out
    if n == 0:
        return out
    kern = _kernel()
    with torch.cuda.device(out.device):
        kern[(-(-n // BLOCK),)](out, _signed32(key[0]), _signed32(key[1]),
                                n, RANK=rank, BLOCK=BLOCK, num_warps=4)
    threefry_bits.launches += 1
    return out


threefry_bits.launches = 0
