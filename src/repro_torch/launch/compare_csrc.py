"""Time the f32 launches of the CUDA kernels built from another tree's
``csrc`` (before the operand-type arguments of the bf16 port: its C entry
points ``compact_stage_f32``, ``compact_resid_f32`` and
``abs_histogram_f32``) against this tree's, on one card.

    git archive <commit> | tar -x -C build/parent
    PYTHONPATH=src python -m repro_torch.launch.compare_csrc \\
        [--parent build/parent]

Both trees' ``compact_residual.cu`` and ``abs_histogram.cu`` are built
with the port's ``nvcc`` flags into ``<build dir>/compare/``.  Inputs are
those of ``chip_smoke.py`` at the 268,435,456-element leaf (``g`` and
``e`` from seed 2, block 1024, bcap 64, a threshold keeping 0.1%).  The
two trees' staging rows, counts and residuals are checked equal first;
then the K3 stage, the K3 residual and K4d are each timed in 4 rounds of
parent, change, change, parent (CUDA-event medians of 20 launches).
Needs a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess


def _build(parent_csrc: str) -> dict:
    """``{(tree, source): loaded library}`` for both trees."""
    from repro_torch.kernels import cuda_build
    out_dir = os.path.join(cuda_build.build_dir(), "compare")
    os.makedirs(out_dir, exist_ok=True)
    procs, paths = [], {}
    for tree, csrc in (("parent", parent_csrc), ("change", cuda_build.CSRC)):
        for src in ("compact_residual.cu", "abs_histogram.cu"):
            so = os.path.join(out_dir, f"{tree}-{src}.so")
            procs.append(subprocess.Popen(
                [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", so,
                 os.path.join(csrc, src)]))
            paths[(tree, src)] = so
    for p in procs:
        if p.wait() != 0:
            raise RuntimeError("nvcc failed")
    return {k: ctypes.CDLL(v) for k, v in paths.items()}


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


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="build/parent",
                    help="root of the other tree (its src/repro_torch/csrc)")
    ap.add_argument("--d", type=int, default=268_435_456)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_csrc: needs a GPU")
    libs = _build(os.path.join(args.parent, "src", "repro_torch", "csrc"))
    p, f, i, ll = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                   ctypes.c_longlong)
    old = libs["parent", "compact_residual.cu"]
    new = libs["change", "compact_residual.cu"]
    old.compact_stage_f32.argtypes = [p, p, ll, f, i, i, ll, p, p, p, p]
    old.compact_resid_f32.argtypes = [p, p, ll, f, i, i, ll, ll, p, p, p]
    new.compact_stage.argtypes = [p, p, i, i, ll, f, i, i, ll, p, p, p, p]
    new.compact_resid.argtypes = [p, p, i, i, ll, f, i, i, ll, ll, p, p, p]
    libs["parent", "abs_histogram.cu"].abs_histogram_f32.argtypes = [
        p, ll, p, p]
    libs["change", "abs_histogram.cu"].abs_histogram.argtypes = [
        p, i, ll, p, p]
    d, block, bcap = args.d, 1024, 64
    nb = -(-d // block)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    g = torch.randn(d, generator=gen, device="cuda").mul_(1e-3)
    e = torch.randn(d, generator=gen, device="cuda").mul_(5e-4)
    u = g + e
    thres = float(u.abs().kthvalue(d - d // 1000).values)
    k_cap = -(-4 * (d // 1000) // 3)
    vals = torch.empty((nb, bcap), device="cuda")
    offs = torch.empty((nb, bcap), dtype=torch.int32, device="cuda")
    cnt = torch.empty(nb, dtype=torch.int32, device="cuda")
    out = torch.empty_like(g)
    h = torch.zeros(128, dtype=torch.int64, device="cuda")
    s = torch.cuda.current_stream().cuda_stream
    ptrs = (g.data_ptr(), e.data_ptr())
    rows = (vals.data_ptr(), offs.data_ptr(), cnt.data_ptr(), s)

    def stage(tree):
        if tree == "parent":
            return lambda: old.compact_stage_f32(*ptrs, d, thres, block,
                                                 bcap, nb, *rows)
        return lambda: new.compact_stage(*ptrs, 0, 0, d, thres, block, bcap,
                                         nb, *rows)

    stage("change")()
    capped = torch.clamp(cnt.long(), max=bcap)
    enc = torch.cumsum(capped, 0) - capped

    def resid(tree):
        tail = (enc.data_ptr(), out.data_ptr(), s)
        if tree == "parent":
            return lambda: old.compact_resid_f32(*ptrs, d, thres, block,
                                                 bcap, k_cap, nb, *tail)
        return lambda: new.compact_resid(*ptrs, 0, 0, d, thres, block, bcap,
                                         k_cap, nb, *tail)

    def hist(tree):
        lib = libs[tree, "abs_histogram.cu"]
        if tree == "parent":
            return lambda: lib.abs_histogram_f32(u.data_ptr(), d,
                                                 h.data_ptr(), s)
        return lambda: lib.abs_histogram(u.data_ptr(), 0, d, h.data_ptr(),
                                         s)

    got = {}
    for tree in ("parent", "change"):
        stage(tree)()
        resid(tree)()
        h.zero_()
        hist(tree)()
        torch.cuda.synchronize()
        got[tree] = [x.clone() for x in (vals, offs, cnt, out, h)]
    if not all(torch.equal(a, b) for a, b in zip(got["parent"],
                                                  got["change"])):
        raise SystemExit("compare_csrc: the two trees' outputs differ")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for name, make in (("K3 stage f32", stage), ("K3 residual f32", resid),
                       ("K4d f32", hist)):
        ms = {"parent": [], "change": []}
        for _ in range(4):
            for tree in ("parent", "change", "change", "parent"):
                ms[tree].append(_time_ms(make(tree)))
        print(name, {k: [round(x, 4) for x in v] for k, v in ms.items()},
              "medians", {k: round(statistics.median(v), 4)
                          for k, v in ms.items()}, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
