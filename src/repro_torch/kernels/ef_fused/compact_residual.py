"""K3 — pass B of the fused EF pipeline: threshold compaction into
per-block staging rows, the residual write and the staging assembly into
the fixed ``(k_cap,)`` codec.

Replaces the TPU kernel ``repro/kernels/ef_fused/compact_residual.py:
compact_residual`` (``pallas_call`` at lines 191, 208 and 237) and
ports ``repro/kernels/gaussian_topk/ops.py:assemble_staging``.  The
kernels are CUDA C++ in ``repro_torch/csrc/compact_residual.cu`` (its
header says what bounds them and how the design answers); this module
builds them at first use (``kernels/cuda_build.py``), checks the
operands, launches on the current stream and counts launches.

The fused pipeline runs :func:`compact_sweep`, the TPU kernel's one
sequential sweep (``_kernel``, ``pallas_call`` at line 237) in one
launch: the staging rows, ``e'`` and the codec pair, each warp finding
the staged slots before its blocks by a decoupled look-back.  The two
launches of the reference's GPU lowering stay as its counterparts of
lines 191 and 208 and as the sweep's cross-check on the card:

1. :func:`compact_stage` writes each block's ``(vals, offs, cnt)``;
2. :func:`exclusive_enc`, the exact int64 exclusive cumsum of
   ``min(cnt, bcap)`` (``enc_before``);
3. :func:`compact_resid` re-streams ``g``/``e``, recomputes each
   element's in-block position and writes ``e'``;
4. :func:`assemble_staging` gathers the pair from the rows.

Operands: ``g`` f32 or bf16, ``e`` f32, bf16 or None.  ``u = f32(g) +
f32(e)`` is formed and compared in f32, as the reference's ``_load_u``
does (``compact_residual.py:81-85``); the staging rows hold those f32
values; ``e'`` is written in the promoted dtype of ``g`` and ``e``
(:func:`~repro_torch.kernels.ef_fused.fused_moments.out_dtype`), rounded
once to nearest even, and :func:`assemble_staging` casts the wire values
to it: the reference's ``out_dtype = result_type(g, e)``.

The plain versions (``*_plain``) compute the same with torch ops over
the zero-padded ``(nblocks, block)`` view; the wrappers take them for
CPU tensors only.
"""
from __future__ import annotations

import torch

from repro_torch.core.codec import SENTINEL
from repro_torch.kernels import cuda_build
from repro_torch.kernels.ef_fused.fused_moments import (_blocks, _check,
                                                        check_cuda_dtypes,
                                                        dtype_code,
                                                        out_dtype)

SOURCE = "compact_residual.cu"


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _geometry(g: torch.Tensor, block: int, bcap: int) -> int:
    if block < 1 or bcap < 1 or bcap > block:
        raise ValueError(f"need 1 <= bcap <= block, got block={block} "
                         f"bcap={bcap}")
    return max(1, -(-g.shape[0] // block))


def _select(x: torch.Tensor, thres: float, bcap: int):
    """Per-block mask, in-block position, keep and uncapped count."""
    mask = x.abs() > thres
    cnt = mask.sum(dim=1, dtype=torch.int32)
    pos = torch.cumsum(mask, dim=1, dtype=torch.int64) - 1
    keep = mask & (pos < bcap)
    return pos, keep, cnt


def _u(g, e):
    u = g.to(torch.float32)
    return u if e is None else u + e.to(torch.float32)


def compact_stage_plain(g, e, thres: float, *, block: int, bcap: int):
    """Plain PyTorch version of the stage kernel: ``(vals (nb, bcap) f32,
    offs (nb, bcap) int32, cnt (nb,) int32)``."""
    nb = _geometry(g, block, bcap)
    x = _blocks(_u(g, e), block)
    pos, keep, cnt = _select(x, thres, bcap)
    slot = torch.where(keep, pos, torch.full_like(pos, bcap))
    vals = torch.zeros((nb, bcap + 1), dtype=torch.float32, device=g.device)
    vals.scatter_(1, slot, x)
    offs = torch.full((nb, bcap + 1), SENTINEL, dtype=torch.int32,
                      device=g.device)
    iota = torch.arange(block, dtype=torch.int32, device=g.device)
    offs.scatter_(1, slot, iota.expand(nb, block))
    # column bcap is the scratch slot every unkept element wrote to
    return vals[:, :bcap].contiguous(), offs[:, :bcap].contiguous(), cnt


def _check_out(g, e, out):
    """``out`` must be a contiguous tensor shaped and placed like ``g``,
    of :func:`out_dtype` ``(g, e)``."""
    if (out.shape != g.shape or out.device != g.device
            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous tensor shaped and placed "
                         "like g")
    if out.dtype != out_dtype(g, e):
        raise TypeError(f"out must be {out_dtype(g, e)} (the promoted "
                        f"dtype of g and e), got {out.dtype}")


def compact_resid_plain(g, e, thres: float, enc_before: torch.Tensor, *,
                        block: int, bcap: int, k_cap: int, out=None):
    """Plain PyTorch version of the residual kernel: ``e' = 0`` where the
    element survives to the wire, else ``u`` (f32) rounded once to
    :func:`out_dtype` ``(g, e)``; ``(d,)``."""
    d = g.shape[0]
    x = _blocks(_u(g, e), block)
    pos, keep, _ = _select(x, thres, bcap)
    on_wire = keep & (enc_before.to(torch.int64)[:, None] + pos < k_cap)
    new_e = torch.where(on_wire, torch.zeros_like(x), x).reshape(-1)[:d]
    new_e = new_e.to(out_dtype(g, e))
    if out is None:
        return new_e
    _check_out(g, e, out)
    out.copy_(new_e)
    return out


def compact_stage(g: torch.Tensor, e, thres: float, *, block: int,
                  bcap: int):
    """Stage launch: per-block staging rows and uncapped counts."""
    _check(g, e)
    if g.device.type != "cuda":
        return compact_stage_plain(g, e, thres, block=block, bcap=bcap)
    check_cuda_dtypes("compact_stage", g, e)
    nb = _geometry(g, block, bcap)
    vals = torch.empty((nb, bcap), dtype=torch.float32, device=g.device)
    offs = torch.empty((nb, bcap), dtype=torch.int32, device=g.device)
    cnt = torch.empty((nb,), dtype=torch.int32, device=g.device)
    lib = cuda_build.load(SOURCE)
    with torch.cuda.device(g.device):
        rc = lib.compact_stage(
            g.data_ptr(), None if e is None else e.data_ptr(),
            dtype_code(g), dtype_code(g if e is None else e), g.shape[0],
            float(thres), block, bcap, nb, vals.data_ptr(), offs.data_ptr(),
            cnt.data_ptr(), _stream(g))
    cuda_build.check(rc, "compact_stage")
    compact_stage.launches += 1
    return vals, offs, cnt


def compact_resid(g: torch.Tensor, e, thres: float,
                  enc_before: torch.Tensor, *, block: int, bcap: int,
                  k_cap: int, out=None) -> torch.Tensor:
    """Residual launch: ``e'`` as a ``(d,)`` tensor of :func:`out_dtype`
    ``(g, e)``, written into ``out`` when given (``out`` may be ``e``
    itself — in place — when ``e`` has that dtype)."""
    _check(g, e)
    if g.device.type != "cuda":
        return compact_resid_plain(g, e, thres, enc_before, block=block,
                                   bcap=bcap, k_cap=k_cap, out=out)
    check_cuda_dtypes("compact_resid", g, e)
    nb = _geometry(g, block, bcap)
    if (enc_before.shape != (nb,) or enc_before.dtype != torch.int64
            or enc_before.device != g.device
            or not enc_before.is_contiguous()):
        raise ValueError("enc_before must be a contiguous int64 (nblocks,) "
                         "tensor on g's device")
    if out is None:
        out = torch.empty_like(g, dtype=out_dtype(g, e))
    else:
        _check_out(g, e, out)
    lib = cuda_build.load(SOURCE)
    with torch.cuda.device(g.device):
        rc = lib.compact_resid(
            g.data_ptr(), None if e is None else e.data_ptr(),
            dtype_code(g), dtype_code(g if e is None else e), g.shape[0],
            float(thres), block, bcap, int(k_cap), nb,
            enc_before.data_ptr(), out.data_ptr(), _stream(g))
    cuda_build.check(rc, "compact_resid")
    compact_resid.launches += 1
    return out


compact_stage.launches = 0
compact_resid.launches = 0


def exclusive_enc(cnt: torch.Tensor, bcap: int) -> torch.Tensor:
    """Exact int64 exclusive cumsum of the capped per-block counts."""
    capped = torch.clamp(cnt.to(torch.int64), max=bcap)
    return torch.cumsum(capped, 0) - capped


def compact_residual(g: torch.Tensor, e, thres: float, *, block: int,
                     bcap: int, k_cap: int, out=None):
    """Both launches: ``(vals, offs, cnt, new_e)``; the staging rows
    ``vals`` f32 (copies of ``u``), ``new_e`` of :func:`out_dtype`."""
    vals, offs, cnt = compact_stage(g, e, thres, block=block, bcap=bcap)
    new_e = compact_resid(g, e, thres, exclusive_enc(cnt, bcap),
                          block=block, bcap=bcap, k_cap=k_cap, out=out)
    return vals, offs, cnt, new_e


def assemble_staging(vals: torch.Tensor, offs: torch.Tensor,
                     cnts: torch.Tensor, k_cap: int, *, block: int,
                     out_dtype=torch.float32):
    """Staging rows into the fixed ``(k_cap,)`` codec (port of
    ``repro/kernels/gaussian_topk/ops.py:assemble_staging``), the values
    cast from the f32 rows to ``out_dtype`` at the end: block
    entries land at slot ``cumsum(min(cnt, bcap)) + j``; anything at or
    past ``k_cap`` is dropped.  Written as a GATHER over the ``k_cap``
    output slots (each finds its block by a binary search of the running
    counts) rather than the reference's scatter of all ``nblocks·bcap``
    staging entries: the same pair, with ``k``-sized instead of
    ``d/16``-sized work.  The reference also cuts indices ``>= d``; that
    cut cannot fire: a padding element is 0 and the threshold is
    ``>= 0``, so no padding element is ever staged.  Global indices are computed in
    int64, stored int32."""
    nblocks, bcap = vals.shape
    dev = vals.device
    enc = torch.clamp(cnts.to(torch.int64), max=bcap)
    ends = torch.cumsum(enc, 0)                      # inclusive
    slot = torch.arange(k_cap, dtype=torch.int64, device=dev)
    row = torch.searchsorted(ends, slot, right=True).clamp_(max=nblocks - 1)
    j = (slot - (ends[row] - enc[row])).clamp_(0, bcap - 1)
    flat = row * bcap + j
    valid = slot < ends[-1]
    values = torch.where(valid, vals.reshape(-1)[flat],
                         torch.zeros((), dtype=vals.dtype, device=dev))
    gidx = row * block + offs.reshape(-1)[flat].to(torch.int64)
    indices = torch.where(valid, gidx, SENTINEL).to(torch.int32)
    return values.to(out_dtype), indices


def compact_sweep_plain(g, e, thres: float, *, block: int, bcap: int,
                        k_cap: int, out=None):
    """Plain PyTorch version of the one sweep: the stage rows, their
    exact exclusive cumsum, the residual and the staging assembly,
    composed: ``(vals, offs, cnt, new_e, values, indices)``."""
    vals, offs, cnt = compact_stage_plain(g, e, thres, block=block,
                                          bcap=bcap)
    new_e = compact_resid_plain(g, e, thres, exclusive_enc(cnt, bcap),
                                block=block, bcap=bcap, k_cap=k_cap, out=out)
    values, indices = assemble_staging(vals, offs, cnt, k_cap, block=block,
                                       out_dtype=out_dtype(g, e))
    return vals, offs, cnt, new_e, values, indices


def compact_sweep(g: torch.Tensor, e, thres: float, *, block: int,
                  bcap: int, k_cap: int, out=None):
    """The TPU kernel's one sweep (``compact_residual.py:237``, ``_kernel``)
    in one launch: ``(vals, offs, cnt, new_e, values, indices)``, the
    staging rows, ``e'`` of :func:`out_dtype` ``(g, e)`` (written into
    ``out`` when given; ``out`` may be ``e`` itself — in place — or ``g``
    without ``e``) and the ``(k_cap,)`` codec pair, bitwise the stage and
    residual launches and :func:`assemble_staging`.  Each warp finds its
    ``enc_before`` by a decoupled look-back over its predecessors' status
    words; the wrapper allocates them (and the ticket) with the outputs
    and the kernel's entry point zeroes them and pre-fills the pair with
    0 / ``SENTINEL``.  CPU tensors take :func:`compact_sweep_plain`."""
    _check(g, e)
    if g.device.type != "cuda":
        return compact_sweep_plain(g, e, thres, block=block, bcap=bcap,
                                   k_cap=k_cap, out=out)
    check_cuda_dtypes("compact_sweep", g, e)
    nb = _geometry(g, block, bcap)
    if out is None:
        out = torch.empty_like(g, dtype=out_dtype(g, e))
    else:
        _check_out(g, e, out)
    dev = g.device
    vals = torch.empty((nb, bcap), dtype=torch.float32, device=dev)
    offs = torch.empty((nb, bcap), dtype=torch.int32, device=dev)
    cnt = torch.empty((nb,), dtype=torch.int32, device=dev)
    values = torch.empty((k_cap,), dtype=out.dtype, device=dev)
    indices = torch.empty((k_cap,), dtype=torch.int32, device=dev)
    scratch = torch.empty((nb + 1,), dtype=torch.int64, device=dev)
    lib = cuda_build.load(SOURCE)
    with torch.cuda.device(dev):
        rc = lib.compact_sweep(
            g.data_ptr(), None if e is None else e.data_ptr(),
            dtype_code(g), dtype_code(g if e is None else e), g.shape[0],
            float(thres), block, bcap, int(k_cap), nb, vals.data_ptr(),
            offs.data_ptr(), cnt.data_ptr(), out.data_ptr(),
            values.data_ptr(), indices.data_ptr(), scratch.data_ptr(),
            _stream(g))
    cuda_build.check(rc, "compact_sweep")
    compact_sweep.launches += 1
    return vals, offs, cnt, out, values, indices


compact_sweep.launches = 0
