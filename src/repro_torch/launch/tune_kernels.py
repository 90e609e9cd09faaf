"""Time design variants of two CUDA kernels on the card: the stage kernel
(the K3 stage launch with ``e``, K4c ``threshold_compact`` without) and
K4d's histogram.

    PYTHONPATH=src python -m repro_torch.launch.tune_kernels

Each variant is the kernel's own source (``repro_torch/csrc``) with a
``#define`` value or one device function replaced by text.  It is built
with the port's ``nvcc`` flags into ``<build dir>/tune/`` (all variants
compiled at once) and called through the same C entry point as the
wrapper.  Before it is timed, each variant is checked bitwise against
the kernel's plain version.  The first variant of each kernel is the
source as it stands.  Inputs are those of ``chip_smoke.py`` at the
268,435,456-element leaf: ``g`` and ``e`` from seed 2, the fused
Gaussian-k threshold, the leaf's block from ``ef_fused.tuning`` (the
checked-in table's) and its staging width.  Every variant
is timed twice (CUDA-event medians), in order and in reverse order, and
the line gives both.  The last line is one JSON object.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys

STAGE = [   # (label, #define values)
    ("as built", {}),
    ("4 warps (blocks) a CTA", {"STAGE_WARPS": 4}),
    ("16 warps (blocks) a CTA", {"STAGE_WARPS": 16}),
    ("4 float4 a lane a chunk", {"STAGE_VPL": 4}),
    ("16 float4 a lane a chunk", {"STAGE_VPL": 16}),
]

_PLAIN_COUNT = """__device__ __forceinline__ void count(unsigned* h, float v) {
  h[bin_of(v) * 32] += 1u;
}
"""
# one histogram per warp (lane 0's column): the lanes with the same bin
# elect a leader, which adds their number
_MATCH_COUNT = """__device__ __forceinline__ void count(unsigned* h, float v) {
  const int b = bin_of(v);
  const unsigned peers = __match_any_sync(__activemask(), b);
  const int lane = threadIdx.x & 31;
  if (lane == __ffs(peers) - 1) atomicAdd(h - lane + b * 32, __popc(peers));
}
"""
HIST = [    # (label, #define values, replacement of count())
    ("as built", {}, None),
    ("4 float4 a lane in flight", {"HIST_U": 4}, None),
    ("16 float4 a lane in flight", {"HIST_U": 16}, None),
    ("per-lane counters, plain increment", {}, _PLAIN_COUNT),
    ("per-warp histogram, __match_any_sync leader adds __popc", {},
     _MATCH_COUNT),
]


def _variant(source: str, defines: dict, count=None) -> str:
    from repro_torch.kernels import cuda_build
    with open(os.path.join(cuda_build.CSRC, source)) as f:
        s = f.read()
    for name, value in defines.items():
        s, n = re.subn(rf"^#define {name} \d+", f"#define {name} {value}",
                       s, flags=re.M)
        assert n == 1, (source, name)
    if count is not None:
        s, n = re.subn(r"__device__ __forceinline__ void count\(unsigned\* h,"
                       r" float v\) \{.*?\n\}\n", count, s, flags=re.S)
        assert n == 1, (source, "count")
    return s


def _build(variants: dict) -> dict:
    """``{name: source text}`` -> ``{name: loaded library}``."""
    from repro_torch.kernels import cuda_build
    out_dir = os.path.join(cuda_build.build_dir(), "tune")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        src = os.path.join(out_dir, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def _time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
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

    from repro_torch.core.compressors import gaussiank_cap
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.ef_fused import compact_residual as cr
    from repro_torch.kernels.ef_fused import ops, tuning
    from repro_torch.kernels.histk import hist

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d", type=int, default=268_435_456)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tune_kernels: needs a GPU")
    d = args.d
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    g = torch.randn(d, generator=gen, device="cuda").mul_(1e-3)
    e = torch.randn(d, generator=gen, device="cuda").mul_(5e-4)
    u = g + e
    k = math.ceil(0.001 * d)
    cfg = tuning.resolve_config(d, "cuda")
    block, k_cap = cfg.block, gaussiank_cap(k, d)
    bcap = ops.fused_default_bcap(k_cap, d, block, cfg.bcap_slack)
    thres = float(ops._gaussian_threshold_fused(
        g, e, d, k, stats_block=cfg.stats_block, refine_iters=4,
        two_sided=False, num_warps=cfg.num_warps))
    nb = -(-d // block)

    libs = _build({**{f"stage{i}": _variant("compact_residual.cu", dfn)
                      for i, (_, dfn) in enumerate(STAGE)},
                   **{f"hist{i}": _variant("abs_histogram.cu", dfn, count)
                      for i, (_, dfn, count) in enumerate(HIST)}})
    stream = torch.cuda.current_stream().cuda_stream
    vals = torch.empty((nb, bcap), dtype=torch.float32, device="cuda")
    offs = torch.empty((nb, bcap), dtype=torch.int32, device="cuda")
    cnt = torch.empty((nb,), dtype=torch.int32, device="cuda")
    h = torch.zeros(hist.BINS, dtype=torch.int64, device="cuda")

    def stage(lib, with_e):
        def run():
            cuda_build.check(lib.compact_stage(
                g.data_ptr() if with_e else u.data_ptr(),
                e.data_ptr() if with_e else None, 0, 0, d, thres, block,
                bcap, nb,
                vals.data_ptr(), offs.data_ptr(), cnt.data_ptr(), stream),
                "stage variant")
        return run

    def histogram(lib):
        def run():
            h.zero_()
            cuda_build.check(lib.abs_histogram(
                u.data_ptr(), 0, d, h.data_ptr(), stream),
                "histogram variant")
        return run

    want = {True: cr.compact_stage_plain(g, e, thres, block=block,
                                         bcap=bcap),
            False: cr.compact_stage_plain(u, None, thres, block=block,
                                          bcap=bcap)}
    want_h = hist.abs_histogram_plain(u, block=4096)
    staged = int(want[True][2].sum())
    runs = {}
    for n, lib in libs.items():
        if n.startswith("stage"):
            cuda_build.bind(lib, "compact_residual.cu")
            for with_e in (True, False):
                stage(lib, with_e)()
                got = (vals, offs, cnt)
                for a, b in zip(got, want[with_e]):
                    same = torch.equal(a.view(torch.int32),
                                       b.view(torch.int32))
                    assert same, (n, with_e)
                runs[(n, with_e)] = stage(lib, with_e)
        else:
            cuda_build.bind(lib, "abs_histogram.cu")
            histogram(lib)()
            assert torch.equal(h, want_h), n
            runs[(n, None)] = histogram(lib)
    del want, want_h
    order = list(runs)
    times = {key: [] for key in order}
    for seq in (order, order[::-1]):
        for key in seq:
            times[key].append(_time_ms(runs[key]))

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "d": d, "block": block, "bcap": bcap, "thres": thres,
           "staged": staged, "stage": [], "hist": []}
    print(f"{smi}; d={d:,}, block {block}, bcap {bcap}, threshold "
          f"{thres:.6g} ({staged:,} over it); ms as (in order, reverse "
          "order)")
    for j, (label, _) in enumerate(STAGE):
        k3, k4c = times[(f"stage{j}", True)], times[(f"stage{j}", False)]
        out["stage"].append({"variant": label, "k3_stage_ms": k3,
                             "k4c_ms": k4c})
        print(f"  stage  {label:<40s} K3 stage {k3[0]:.4f} {k3[1]:.4f}  "
              f"K4c {k4c[0]:.4f} {k4c[1]:.4f}")
    for j, (label, _, _) in enumerate(HIST):
        t = times[(f"hist{j}", None)]
        out["hist"].append({"variant": label, "ms": t})
        print(f"  K4d    {label:<56s} {t[0]:.4f} {t[1]:.4f}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
