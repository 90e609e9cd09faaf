"""K4c — threshold compaction of a materialised vector into per-block
staging rows: the compaction pass of the unfused pipeline.

Replaces the TPU kernel ``repro/kernels/gaussian_topk/
threshold_compact.py:threshold_compact`` (``pallas_call`` at line 54).
For each ``block``-element block it writes the elements with ``|x| >
thres`` in index order into a ``bcap``-wide row of values and in-block
offsets (the rest padded with 0 / ``SENTINEL``) and the uncapped count.

The TPU built each row with a one-hot ``(bcap, block)`` MXU matmul.  The
card has no reason to: the kernel is K3's CUDA ``stage_kernel``
(``csrc/compact_residual.cu``, which also replaces the K3 stage launch
``ef_fused/compact_residual.py:191``) instantiated with ``HAS_E =
false``, with exact integer offsets.  Bound: bytes, one read of ``x``
(4 bytes per element in f32, 2 in bf16) plus the staging rows (8 bytes
per slot) and counts: 0.361 ms for the 268,435,456-element f32 leaf
with block 1024 and ``bcap`` 64 at 3.35 TB/s (0.180 ms in bf16 at block
2048).  The first port (one CTA of 256 threads per block, a
ballot scan with two barriers per chunk) ran at 0.852 ms, 42% of it
(NVIDIA H100 80GB HBM3, 700 W; ``chip_smoke.py``): reading half the
bytes of the K3 stage launch made it only 15% faster, so short CTAs,
barriers and too few bytes in flight bound it.  The kernel now runs
one warp per block, 8 blocks a CTA, 16-byte loads all issued
before the scan, in-order positions from warp ballots, no shared memory
and no barrier; a view that is not 16-byte aligned takes the scalar-load
instantiation of the same kernel.  It runs at 0.441 ms beside the 0.361
ms bound, 0.404 ms at block 2048 beside 0.341 (same card,
``chip_smoke.py``; the first design 0.840 ms in the same run).  Where a
block selects more than ``bcap`` elements its row keeps the lowest
in-block indices.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_build
from repro_torch.kernels.ef_fused.compact_residual import (
    SOURCE, _geometry, _stream, compact_stage_plain)
from repro_torch.kernels.ef_fused.fused_moments import (_check,
                                                        check_cuda_dtypes,
                                                        dtype_code)

__all__ = ["threshold_compact", "threshold_compact_plain"]


def _check_bcap(bcap: int) -> None:
    if bcap % 8:
        raise ValueError(f"bcap must be a multiple of 8, got {bcap}")


def threshold_compact_plain(x: torch.Tensor, thres: float, *, block: int,
                            bcap: int):
    """Plain PyTorch version of K4c: ``(vals (nb, bcap) f32, offs (nb,
    bcap) int32, cnt (nb,) int32)`` over the zero-padded ``(nblocks,
    block)`` view of ``x``."""
    _check_bcap(bcap)
    return compact_stage_plain(x, None, thres, block=block, bcap=bcap)


def threshold_compact(x: torch.Tensor, thres: float, *, block: int = 2048,
                      bcap: int):
    """Per-block staging rows of ``|x| > thres`` for flat ``x``.  CUDA
    tensors launch the CUDA kernel (``x`` f32 or bf16, compared in f32;
    the staged values f32); CPU tensors take the plain version."""
    _check(x, None)
    if x.device.type != "cuda":
        return threshold_compact_plain(x, thres, block=block, bcap=bcap)
    check_cuda_dtypes("threshold_compact", x)
    _check_bcap(bcap)
    nb = _geometry(x, block, bcap)
    vals = torch.empty((nb, bcap), dtype=torch.float32, device=x.device)
    offs = torch.empty((nb, bcap), dtype=torch.int32, device=x.device)
    cnt = torch.empty((nb,), dtype=torch.int32, device=x.device)
    lib = cuda_build.load(SOURCE)
    with torch.cuda.device(x.device):
        rc = lib.compact_stage(
            x.data_ptr(), None, dtype_code(x), dtype_code(x), x.shape[0],
            float(thres), block, bcap, nb, vals.data_ptr(), offs.data_ptr(),
            cnt.data_ptr(), _stream(x))
    cuda_build.check(rc, "threshold_compact")
    threshold_compact.launches += 1
    return vals, offs, cnt


threshold_compact.launches = 0
