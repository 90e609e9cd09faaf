"""Time this tree's K1 with its histogram (CUDA), K3 residual launch, K3
one sweep and K4d against another tree's, on one card.

    git archive <commit> | tar -x -C build/parent
    PYTHONPATH=src python -m repro_torch.launch.compare_kernels \\
        [--parent build/parent] [--json compare_kernels.json] \\
        [--sweep-blocks 1,2,4,8]

The other tree's ``kernels/ef_fused/fused_moments.py`` is loaded from its
file for its Triton K1 with the histogram (``launch_stats(name, g, e, *,
block, hist=True, num_warps)``, which imports nothing of either tree),
and its ``csrc/compact_residual.cu`` and ``csrc/abs_histogram.cu`` are
built with the port's ``nvcc`` flags into ``<build dir>/compare/`` and
called through the same C entry points as this tree's (the interface is
``kernels/cuda_build.SIGNATURES``).  Inputs are ``chip_smoke.py``'s: ``g``
and ``e`` from seed 2, ``1e-3`` and ``5e-4`` of N(0, 1), drawn in f32 and
cast, at d = 268,435,456 with both operands f32 and both bf16 and at 2^29
with both f32 (phase 11a's size); the table's geometry; the fused
Gaussian-k threshold at ``k = d / 1000``, ``enc_before`` the exact cumsum
of the stage launch's counts.  First every pair is held equal: both K1s'
histograms bitwise the plain version's and their moments within
``chip_smoke.check_moments``' tolerances (``s`` within ``1e-5·Σ|u|``,
``sq`` within rtol 1e-5, absmax exact); both residual launches' ``e'``,
both sweeps' outputs and both K4d histograms (of ``u`` in the promoted
dtype) bitwise each other and the plain versions.  Then each pair is
timed in 4 rounds of old, new, new, old (CUDA-event medians of 20
launches): K1 through its wrappers (the launch and its folds), the
others through their C entry points on preallocated outputs.  With
``--sweep-blocks`` the sweep is also built from this tree's source with
each ``SWEEP_BLOCKS`` (selection blocks a warp takes with one ticket) and
every variant, held bitwise first, is timed twice at 2^28 in both dtypes,
in order and in reverse order.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess


def _time_ms(fn, n: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _rounds(old, new) -> dict:
    ms = {"old": [], "new": []}
    for _ in range(4):
        for which in ("old", "new", "new", "old"):
            ms[which].append(_time_ms(old if which == "old" else new))
    return {"ms": ms, "median_old": statistics.median(ms["old"]),
            "median_new": statistics.median(ms["new"])}


def _load_parent_k1(parent: str):
    path = os.path.join(parent, "src", "repro_torch", "kernels", "ef_fused",
                        "fused_moments.py")
    spec = importlib.util.spec_from_file_location("parent_fused_moments",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build_parent(parent: str) -> dict:
    """``{source: loaded library}`` of the other tree's K3 and histogram
    sources, typed by this tree's signature table."""
    from repro_torch.kernels import cuda_build
    csrc = os.path.join(parent, "src", "repro_torch", "csrc")
    out_dir = os.path.join(cuda_build.build_dir(), "compare")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for src in ("compact_residual.cu", "abs_histogram.cu"):
        so = os.path.join(out_dir, f"parent-{src}.so")
        procs[src] = (subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", so,
             os.path.join(csrc, src)]), so)
    libs = {}
    for src, (p, so) in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed on the other tree's {src}")
        lib = ctypes.CDLL(so)
        for name, args in cuda_build.SIGNATURES[src].items():
            fn = getattr(lib, name, None)
            if fn is not None:   # an entry point the other tree has
                fn.argtypes, fn.restype = list(args), ctypes.c_int
        libs[src] = lib
    return libs


def _same_bits(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def _check_moments(tag, got, plain, sum_abs) -> float:
    (s, sq, mx), (ps, psq, pmx) = ([float(x) for x in t]
                                   for t in (got, plain))
    assert abs(s - ps) <= 1e-5 * sum_abs, (tag, "s", s, ps)
    assert abs(sq - psq) <= 1e-5 * abs(psq), (tag, "sq", sq, psq)
    assert mx == pmx, (tag, "absmax", mx, pmx)
    return max(abs(s - ps), abs(sq - psq))


def _build_variants(blocks: list) -> dict:
    """``{SWEEP_BLOCKS: loaded library}`` of this tree's
    ``compact_residual.cu`` with each value."""
    from repro_torch.kernels import cuda_build
    from repro_torch.launch.tune_kernels import _build, _variant
    libs = _build({f"sweep{n}": _variant("compact_residual.cu",
                                         {"SWEEP_BLOCKS": n})
                   for n in blocks})
    return {n: cuda_build.bind(libs[f"sweep{n}"], "compact_residual.cu")
            for n in blocks}


def _sweep_call(lib, g, e, thres, block, bcap, k_cap, outs):
    """A call of ``lib``'s sweep on ``g``, ``e`` into ``outs`` (rows,
    counts, ``e'``, the pair, the scratch words)."""
    import torch

    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.ef_fused.fused_moments import dtype_code
    nb = -(-g.shape[0] // block)
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: cuda_build.check(lib.compact_sweep(
        g.data_ptr(), e.data_ptr(), dtype_code(g), dtype_code(e),
        g.shape[0], thres, block, bcap, k_cap, nb,
        *(x.data_ptr() for x in outs), stream), "compact_sweep")


def _sweep_outs(g, e, block, bcap, k_cap) -> list:
    import torch

    from repro_torch.kernels.ef_fused.fused_moments import out_dtype
    nb, dev, od = -(-g.shape[0] // block), g.device, out_dtype(g, e)
    return [torch.empty((nb, bcap), dtype=torch.float32, device=dev),
            torch.empty((nb, bcap), dtype=torch.int32, device=dev),
            torch.empty((nb,), dtype=torch.int32, device=dev),
            torch.empty_like(g, dtype=od),
            torch.empty((k_cap,), dtype=od, device=dev),
            torch.empty((k_cap,), dtype=torch.int32, device=dev),
            torch.empty((nb + 1,), dtype=torch.int64, device=dev)]


def _time_variants(variants, tag, g, e, thres, block, bcap, k_cap,
                   want) -> dict:
    """Each ``SWEEP_BLOCKS`` variant through its C entry point, bitwise
    ``want`` (this tree's sweep), then timed in order and in reverse
    order."""
    outs = _sweep_outs(g, e, block, bcap, k_cap)
    for n, lib in variants.items():
        _sweep_call(lib, g, e, thres, block, bcap, k_cap, outs)()
        assert all(_same_bits(a, b) for a, b in zip(want, outs)), (tag, n)
    ms = {n: [] for n in variants}
    order = list(variants)
    for n in order + order[::-1]:
        ms[n].append(_time_ms(_sweep_call(variants[n], g, e, thres, block,
                                          bcap, k_cap, outs)))
    print(f"K3 sweep variants {tag} (SWEEP_BLOCKS: ms in order, in "
          f"reverse): " + ", ".join(f"{n}: {[round(x, 4) for x in v]}"
                                    for n, v in ms.items()), flush=True)
    return {"kernel": "K3 sweep SWEEP_BLOCKS variants", "case": tag,
            "ms": {str(n): v for n, v in ms.items()}}


def compare(d, dt, old_k1, parent, variants) -> list:
    """Every pair at one size and operand dtype (both operands ``dt``):
    held equal, then timed in rounds (and the sweep's ``variants``, if
    any).  Returns the rows."""
    import torch

    from repro_torch.core.compressors import gaussiank_cap
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.ef_fused import compact_residual as cr
    from repro_torch.kernels.ef_fused import fused_moments as fm
    from repro_torch.kernels.ef_fused import ops, tuning
    from repro_torch.kernels.histk import hist

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    g = torch.randn(d, generator=gen, device="cuda").mul_(1e-3).to(dt)
    e = torch.randn(d, generator=gen, device="cuda").mul_(5e-4).to(dt)
    cfg = tuning.resolve_config(d, "cuda", dt)
    sb, block, w = cfg.stats_block, cfg.block, cfg.num_warps
    k = max(1, d // 1000)
    k_cap = gaussiank_cap(k, d)
    bcap = ops.fused_default_bcap(k_cap, d, block, cfg.bcap_slack)
    thres = float(ops._gaussian_threshold_fused(
        g, e, d, k, stats_block=sb, refine_iters=4, two_sided=False,
        num_warps=w))
    tag = f"d={d} {str(dt).replace('torch.', '')}"
    nb = -(-d // block)
    stream = torch.cuda.current_stream().cuda_stream
    dc = fm.dtype_code(g)
    rows = []

    # K1 with its histogram: the other tree's Triton kernel, this tree's
    # CUDA kernel
    def k1_old():
        return old_k1.launch_stats("fused_moments_hist", g, e, block=sb,
                                   hist=True, num_warps=w)

    def k1_new():
        return fm.fused_moments_hist(g, e, block=sb)

    plain = fm.fused_moments_hist_plain(g, e, block=sb)
    sum_abs = float((g.double() + e.double()).abs().sum())
    (s, sq, mx), h = k1_old()
    new_out = k1_new()
    assert torch.equal(h, plain[3]) and torch.equal(new_out[3], plain[3]), (
        tag, "K1 histogram")
    errs = {"old": _check_moments(tag, (s, sq, mx), plain[:3], sum_abs),
            "new": _check_moments(tag, new_out[:3], plain[:3], sum_abs)}
    again = k1_new()
    assert all(_same_bits(a, b) for a, b in zip(new_out, again)), (
        tag, "K1 rerun")
    del plain, new_out, again
    rows.append({"kernel": "K1 fused_moments_hist", "case": tag,
                 "old": "Triton (other tree)", "new": "CUDA",
                 "max_abs_err": errs, **_rounds(k1_old, k1_new)})

    # the K3 residual launch, both trees', into their own outputs
    _, _, cnt = cr.compact_stage(g, e, thres, block=block, bcap=bcap)
    enc = cr.exclusive_enc(cnt, bcap)
    outs = {t: torch.empty_like(g, dtype=fm.out_dtype(g, e))
            for t in ("old", "new")}
    libs = {"old": parent["compact_residual.cu"],
            "new": cuda_build.load("compact_residual.cu")}

    def resid(t):
        return lambda: cuda_build.check(libs[t].compact_resid(
            g.data_ptr(), e.data_ptr(), dc, dc, d, thres, block, bcap,
            k_cap, nb, enc.data_ptr(), outs[t].data_ptr(), stream),
            f"compact_resid ({t})")

    resid("old")()
    resid("new")()
    want = cr.compact_resid_plain(g, e, thres, enc, block=block, bcap=bcap,
                                  k_cap=k_cap)
    assert _same_bits(outs["old"], want) and _same_bits(outs["new"], want), (
        tag, "K3 residual")
    del want
    rows.append({"kernel": "K3 compact_resid", "case": tag, "block": block,
                 "bcap": bcap, "k_cap": k_cap, "old": "other tree",
                 "new": "this tree",
                 **_rounds(resid("old"), resid("new"))})
    del outs

    # the K3 one sweep, both trees'
    souts = {t: _sweep_outs(g, e, block, bcap, k_cap) for t in libs}
    for t in libs:
        _sweep_call(libs[t], g, e, thres, block, bcap, k_cap, souts[t])()
    want = cr.compact_sweep(g, e, thres, block=block, bcap=bcap,
                            k_cap=k_cap)
    for t in libs:
        assert all(_same_bits(a, b) for a, b in zip(want, souts[t])), (
            tag, "K3 sweep", t)
    rows.append({"kernel": "K3 compact_sweep", "case": tag, "old":
                 "other tree", "new": "this tree", **_rounds(
                     _sweep_call(libs["old"], g, e, thres, block, bcap,
                                 k_cap, souts["old"]),
                     _sweep_call(libs["new"], g, e, thres, block, bcap,
                                 k_cap, souts["new"]))})
    if variants:
        rows.append(_time_variants(variants, tag, g, e, thres, block, bcap,
                                   k_cap, want))
    del souts, want

    # K4d on u in the promoted dtype
    u = g + e
    hs = {t: torch.zeros(hist.BINS, dtype=torch.int64, device="cuda")
          for t in libs}
    hlibs = {"old": parent["abs_histogram.cu"],
             "new": cuda_build.load("abs_histogram.cu")}

    def k4d(t):
        def run():
            hs[t].zero_()
            cuda_build.check(hlibs[t].abs_histogram(
                u.data_ptr(), dc, d, hs[t].data_ptr(), stream),
                f"abs_histogram ({t})")
        return run

    k4d("old")()
    k4d("new")()
    want = hist.abs_histogram_plain(u, block=sb)
    assert torch.equal(hs["old"], want) and torch.equal(hs["new"], want), (
        tag, "K4d")
    rows.append({"kernel": "K4d abs_histogram", "case": tag,
                 "old": "other tree", "new": "this tree",
                 **_rounds(k4d("old"), k4d("new"))})
    for row in rows:
        if "median_old" in row:
            print(f"{row['kernel']} {tag}: {row['old']} "
                  f"{row['median_old']:.4f} ms, {row['new']} "
                  f"{row['median_new']:.4f} ms (rounds "
                  f"{[round(x, 4) for x in row['ms']['old']]} / "
                  f"{[round(x, 4) for x in row['ms']['new']]})", flush=True)
    return rows


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="build/parent",
                    help="root of the other tree (its src/repro_torch)")
    ap.add_argument("--d", type=int, default=268_435_456)
    ap.add_argument("--json", default="")
    ap.add_argument("--sweep-blocks", default="",
                    help="comma-separated SWEEP_BLOCKS variants to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: needs a GPU")
    from repro_torch.kernels import cuda_build
    cuda_build.build_all()
    old_k1 = _load_parent_k1(args.parent)
    parent = _build_parent(args.parent)
    variants = _build_variants(
        [int(x) for x in args.sweep_blocks.split(",") if x])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    rows = []
    for d, dt in ((args.d, torch.float32), (args.d, torch.bfloat16),
                  (2 * args.d, torch.float32)):
        rows += compare(d, dt, old_k1, parent,
                        variants if d == args.d else {})
        torch.cuda.empty_cache()
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
