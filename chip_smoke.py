#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --kernels-only  # phases 1-2 at small sizes
    python3 chip_smoke.py --serve-only    # phases 1 and 10
    python3 chip_smoke.py --arch-only     # phases 1 and 11
    python3 chip_smoke.py --model-axis-only  # phase 1, 2's M = 2 rows, 12
    python3 chip_smoke.py --tensor-parallel-only  # phases 1 and 12b
                                          # (NCCL when two cards are visible)
    python3 chip_smoke.py --tuner-only    # phases 1 and 13

Phases (any failure exits non-zero; nothing is wrapped to pass):

1. environment: card name and power limit, torch/CUDA versions, the
   kernels built from this checkout's sources (``nvcc`` for the CUDA
   C++, Triton's JIT for the rest) and the build time;
2. every kernel against its plain PyTorch version on the card, at d in
   {2048, 1,000,003, 268,435,456} (the last is the largest llama3.2-1b
   leaf, ``stack/0/ffn/w_gate``; the largest leaf the kernels meet,
   jamba-1.5-large's 536,870,912-element ``embed``, is phase 11a's):
   K1 ``fused_moments`` with and without
   its histogram, K2 ``tree_count``, the K3 stage and residual launches,
   and the unfused pipeline's K4a ``moments``, K4b ``count_gt``, K4c
   ``threshold_compact`` and K4d ``abs_histogram`` (integer outputs and
   copies of ``u`` bitwise, moments within tolerance); the unfused
   pipeline against the fused one, bitwise, for gaussiank, gaussiank2
   and histk; the K3 stage, K4c and K4d bitwise on views at storage
   offsets 1 and 3 (the scalar-load path), blocks 1024/2048/4096/1001,
   thresholds 0 (blocks overflow) and above ``max|u|`` (nothing
   selected), and K4d on one-bin, all-zero and zero/subnormal/inf/
   ``>= edge[127]`` inputs; K1, K2 and both K3 launches on every row of
   an ``(M, d_row_total)`` bucket at M = 2 (the 1,000,003- and the
   268,435,456-element leaves' rows, at ``ceil(k / 2)`` each, as segment
   windows at their storage offsets).  At the largest size each kernel is timed
   with CUDA events (median after warm-up), K4c at block 2048 too, and
   so are the whole pipelines beside exact top-k (``torch.topk``, the
   paper's yardstick): fused Gaussian-k, fused hist-k, unfused
   Gaussian-k, unfused hist-k and the registry's ``histk_select_kernel``
   — the paper's Fig. 4 comparison;
3. the paths at full width, each with every kernel's launch counter set
   to 0 just before it and read just after:
   3.  ``repro_torch.launch.train.run`` on llama3.2-1b (16 layers,
       d_model 2048, vocab 128256, random weights from seed 0) for 3
       steps of Gaussian-k at 0.001, fixed-k, bucketed, allgather,
       world 1 (K1, K2, K3);
   3b. the same for 3 steps of hist-k on the fused backend (K1 with its
       histogram, K3; no K2);
   3c. the same for 2 steps of hist-k on the reference backend (K4d,
       K4c), with its peak memory;
   3d. ``unfused_compress_ef`` on the 268,435,456-element leaf for
       gaussiank and histk (K4a, K4b ×4, K4c, K4d);
   3e. the same for 2 steps of trimmed-k (plain torch: no kernel may
       launch), with its peak memory;
4. card against CPU on a small config (2 layers, d_model 64): 2 steps
   on each from the same params and batches, the CPU at the card's
   block geometry, for gaussiank, histk (both backends) and trimmedk,
   losses within rtol 1e-4;
5. the data-parallel wire, each path with the launch counters set to 0
   just before it and read just after:
   5a. ``train.run`` with ``--host-devices 4 --mesh 4x1 --strategy
       allgather`` at full llama3.2-1b width and depth, 3 steps (48
       launches a step of K1, K2, the K3 stage and the K3 residual;
       every worker's step-0 bucket conserves bitwise; peak memory, step
       ms and the wire's ms by CUDA events);
   5b. ``gtopk`` (``--mesh 4x1``), ``hierarchical`` and ``hier_gtopk``
       (``--mesh 2x2x1``) at full width with ``num_layers`` cut to 4 (the
       per-worker gTop-k buffers of 16 layers exceed the card), 2 steps
       each: 48 or 96 launches a step; gTop-k's step-0 conservation
       ``sum_w e'_w + W*mean == sum_w G_w`` within ``2**-19 *
       sum_w |G_w|`` per element; the wire accounting equal the layout's;
   5c. two processes over ``torch.distributed`` (NCCL with a card each
       when two cards are visible, else gloo staged through host memory
       on the one card), 2 steps of allgather and of gtopk at full width
       with 2 layers: params, momentum and residuals (sha256) and losses
       equal ``LocalWire``'s; the line names the backend;
   5d. each strategy with 4 workers on the small config, card against
       CPU at the card's block geometry, losses within rtol 1e-4;
6. adaptive layer-wise density (slice 3), each path with the launch
   counters set to 0 just before it and read just after
   (``phase6_adaptive``): 6a llama3.2-1b's own default (no
   ``--density-policy``: ``variance``) at full width and depth, 3 steps,
   K1 (pass A, once a segment row: no second K1 in the compression), K2
   and the K3 launches 12 a step each, ``k_total`` the host's budget,
   ``sum(k) == K_eff``, every worker's ``u`` conserving bitwise at step
   0; 6b hist-k ``absmax`` with EMA; 6c ``uniform`` with the DGC warmup
   and the norm-decay global-k controller; 6d four workers on the card,
   allgather at full depth and hierarchical at 4 layers; 6e card against
   CPU on the small config for each policy, allocations equal;
7. slice 4, the PRNG, the key-sampled compressors and DGC momentum
   correction (``phase7_keyed``): 7a the ``threefry_bits`` kernel
   bitwise against its plain version (2^26 counters and counts off the
   block; draws and rank keys) and jax.random's known
   answers drawn on the card, then timed at 268,435,456 draws; 7b
   llama3.2-1b at full width and depth, 4 steps each (1-3 steady) of
   randk fixed-k and ``variance``, dgck, rtopk fixed-k and ``variance``,
   and Gaussian-k and hist-k under momentum correction 0.9 (step and
   compress ms, peak memory, step-0 conservation, ``v'`` and ``e'`` zero
   at every sent index); 7c card against CPU on the small config; 7d
   four workers on the card at 4 layers (randk over allgather, momentum
   correction over gTop-k);
8. slice 4b, the paper's experiments (``phase8_paper``): 8a FNN-3's
   ``simulate_sparsified_sgd`` card against CPU (W = 4, 5 steps; losses
   within rtol 1e-4, the wire equal or within 1% a step for Gaussian-k)
   and the card's step ms and idle share at W = 16; 8b each simulation
   benchmark's ``run(smoke=True)`` with its program invariants; 8c the fig4
   benchmark at its smoke shapes, every K1-K4d launched and the pass
   counts against the JAX package's baseline;
9. slices 6 and 2b, the chunked schedule and the per-leaf loop
   (``phase9_chunked``): 9a llama3.2-1b at full width and depth, 3
   steps each of chunks 1, 4 and 12 and per leaf (states bitwise chunks
   1's, compared on the card; 12 launches a step of K1, K2 and both K3;
   step ms, peak memory, each chunk's release as a fraction of the
   backward); 9b ``variance`` at chunks 4 (one allocation a step); 9c
   four workers on the card, each strategy at chunks 3 and per leaf
   against bucketed; 9d two processes at chunks 3 against 5c's
   ``LocalWire`` run (asynchronous gathers counted); 9e card against
   CPU; 9f the overlap benchmark's and Fig. 4's dispatch counts against
   their baselines;
10. slice 7, serving and the train-to-serve weight-delta stream
   (``phase10_serve``): 10a ``launch.serve.run`` on llama3.2-1b at full
   width and depth (12 requests, waves of 8, prompt 64, gen 16, a delta
   every 4 decode steps at 0.01, a resync every 3rd): at every publish
   ``pub`` equals the packed replica bitwise, the replica equals the
   trainer at a resync, the staleness equals the residual within 1e-5 at
   a delta, the message sizes are the layout's and trainer, replica,
   ``pub`` and ``resid`` share no storage; prefill, decode-step, publish
   and apply ms (CUDA events), peak memory, and tokens/s frozen and
   streaming; 10b the trainer with ``--publish-every 1 --resync-every
   2``, 4 steps at full width and depth (12 launches a step of K1, K2
   and both K3; 2 deltas + 2 resyncs of the layout's bits) and, on the
   small config, a resumed run's checkpoint bitwise a straight run's;
   10c a ``gaussiank`` publisher through the library on llama3.2-1b (K1,
   K2 and both K3 12 a delta); 10d the small config with a wrapping
   sliding-window ring card against CPU (logits within rtol 1e-4, tokens
   equal, both publishers bitwise); 10e the ``serve_staleness`` driver's
   deterministic rows against ``benchmarks/baselines/serve.json``;
11. slice 8, the MoE, Mamba-hybrid and xLSTM blocks and the ``embeds``
   frontend (``phase11_archs``): 11a K1, K2 and both K3 launches at
   d = 536,870,912 (jamba-1.5-large's ``embed``, the largest leaf the
   kernels meet) bitwise their plain versions (moments within
   tolerance), timed; 11b ``launch.train.run`` at full width,
   Gaussian-k fused, batch 8 x 128, on deepseek-moe-16b (2 layers),
   jamba-1.5-large (1 layer: Mamba + MLP), musicgen-medium and
   xlstm-125m, one K1, K2 and K3 pair a leaf a step; 11c
   ``launch.serve.run`` on the same four (8 sequences, prompt 64, 8 new
   tokens); 11d the smoke variants card against CPU (losses, prefill
   and decode logits, greedy tokens) and jamba-smoke at chunks 3 and per
   leaf bitwise its bucketed run;
12. slice 2c, the model axis (``phase12_model_axis``): 12a
   ``train.run`` at ``--mesh 4x2 --host-devices 8``, the reference's
   default mesh, at full llama3.2-1b width and depth (96 launches a
   step of each Gaussian-k kernel, every worker's two-row bucket
   conserving bitwise; step ms, peak memory); 12b the tensor-parallel
   step at ``--mesh 1x2`` in two processes (NCCL with a card each, else
   gloo on the one card), each rank holding its shards: 12 launches a
   step a rank of each kernel, the losses the one-process ``--mesh
   1x2`` run's within rtol 1e-6, step ms, relayout ms and each rank's
   peak memory; on one shared random gradient, the relayout both ways
   and each row's compression bitwise the one-process bucket's row;
13. slice 9, the launch and tuning stack (``phase13_tuner``): 13a the
   tuner benchmark's rows against ``benchmarks/baselines/tuner.json``; 13b
   ``measure_hardware`` on the card (1 GiB copy, at most 105% of 3.35
   TB/s); 13c ``launch.multihost`` coordinate and validate under
   ``torchrun`` in 2 processes at the reference's factors, the measured
   topology saved; 13d ``--strategy auto`` at full width, ``4x1`` on
   13c's topology and ``2x2x1`` (4 layers) on the reference's ``asym``
   descriptor (``hier_gtopk``), each bitwise the run that names the
   chosen strategy, 48 and 96 launches a step of each Gaussian-k
   kernel; 13e ``step_cost`` and the roofline of the 4x1 step, and the
   share of the f32 peak of the forward plus backward and of the step;
   13f ``dryrun`` on meta for all ten archs at ``4x2`` and
   ``table2_scaling``'s rows.

Every trainer path draws its params on the card (``init_params``: one
``threefry_bits`` launch a weight matrix), counted once a path beside the
per-step launches.

The line before the last is ``nvidia-smi``'s name and power limit, the
one before it the ``{"kernels": [...]}`` JSON; the last line is
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_OPS_PER_S = 67e12         # f32 outside the tensor cores
# 32-bit integer operations outside the tensor cores, at the SM's issue
# limit: 4 schedulers x 32 lanes a clock (the 64 INT32 lanes plus integer
# work the compiler moves to the FMA pipe; a 64-lane rate was beaten by
# threefry_bits itself) x 132 SMs x 1.98 GHz boost
INT32_OPS_PER_S = 128 * 132 * 1.98e9
THREEFRY_OPS = 73             # 32-bit integer operations a draw
BIG_LEAF = 268_435_456        # llama3.2-1b stack/0/ffn/w_gate (16x2048x8192)
HUGE_LEAF = 536_870_912       # jamba-1.5-large embed (65536x8192), phase 11a
RATIO = 0.001


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median ms of ``fn`` between CUDA events, after ``warmup`` calls."""
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


def bound(nbytes: float, nops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


KERNELS = {   # key: (name, route, source, replaces)
    "fused_moments": ("fused_moments (K1)", "triton",
                      "src/repro_torch/kernels/ef_fused/fused_moments.py",
                      "src/repro/kernels/ef_fused/fused_moments.py:144"),
    "fused_moments_hist": ("fused_moments with histogram (K1, hist-k)",
                           "triton",
                           "src/repro_torch/kernels/ef_fused/"
                           "fused_moments.py",
                           "src/repro/kernels/ef_fused/fused_moments.py:144"),
    "tree_count": ("tree_count (K2)", "triton",
                   "src/repro_torch/kernels/ef_fused/tree_count.py",
                   "src/repro/kernels/ef_fused/tree_count.py:93"),
    "compact_stage": ("compact_residual stage (K3)", "cuda",
                      "src/repro_torch/csrc/compact_residual.cu",
                      "src/repro/kernels/ef_fused/compact_residual.py:191"),
    "compact_resid": ("compact_residual residual (K3)", "cuda",
                      "src/repro_torch/csrc/compact_residual.cu",
                      "src/repro/kernels/ef_fused/compact_residual.py:208"),
    "moments": ("moments (K4a)", "triton",
                "src/repro_torch/kernels/moments/moments.py",
                "src/repro/kernels/moments/moments.py:48"),
    "count_gt": ("count_gt (K4b)", "triton",
                 "src/repro_torch/kernels/gaussian_topk/count_gt.py",
                 "src/repro/kernels/gaussian_topk/count_gt.py:34"),
    "threshold_compact": ("threshold_compact (K4c)", "cuda",
                          "src/repro_torch/csrc/compact_residual.cu",
                          "src/repro/kernels/gaussian_topk/"
                          "threshold_compact.py:54"),
    "abs_histogram": ("abs_histogram (K4d)", "cuda",
                      "src/repro_torch/csrc/abs_histogram.cu",
                      "src/repro/kernels/histk/hist.py:62"),
    # port-only: the reference's draws are XLA's threefry (no pallas_call)
    "threefry_bits": ("threefry_bits (PRNG, port-only)", "triton",
                      "src/repro_torch/kernels/prng/threefry.py",
                      "src/repro/core/compressors.py:64 (jax.random.uniform "
                      "in randk_select: XLA's threefry, no pallas_call)"),
}


# the kernels of the Gaussian-k fused path, one launch per leaf each
MAIN_KERNELS = ("fused_moments", "tree_count", "compact_stage",
                "compact_resid")


def counters():
    """Every kernel wrapper, by its ``KERNELS`` key."""
    from repro_torch.kernels.ef_fused import compact_residual as cr
    from repro_torch.kernels.ef_fused import fused_moments as fm
    from repro_torch.kernels.ef_fused import tree_count as tc
    from repro_torch.kernels.gaussian_topk import count_gt as cg
    from repro_torch.kernels.gaussian_topk import threshold_compact as thc
    from repro_torch.kernels.histk import hist
    from repro_torch.kernels.moments import moments as mom
    from repro_torch.kernels.prng import threefry
    return {"fused_moments": fm.fused_moments,
            "fused_moments_hist": fm.fused_moments_hist,
            "tree_count": tc.tree_count,
            "compact_stage": cr.compact_stage,
            "compact_resid": cr.compact_resid,
            "moments": mom.moments,
            "count_gt": cg.count_gt,
            "threshold_compact": thc.threshold_compact,
            "abs_histogram": hist.abs_histogram,
            "threefry_bits": threefry.threefry_bits}


def build(cuda_build, torch) -> float:
    """Build the CUDA libraries (one nvcc per source, all started
    together, from a thread) while Triton compiles every specialisation
    of the Triton kernels on tiny inputs; returns the seconds taken."""
    t0 = time.time()
    err, reports = [], {}

    def nvcc():
        try:
            reports.update(cuda_build.build_all())
        except Exception as ex:  # noqa: BLE001 — re-raised below
            err.append(ex)

    th = threading.Thread(target=nvcc)
    th.start()
    k = counters()
    x = torch.ones(4096, device="cuda")
    for d in (4096, 4095):
        k["fused_moments"](x[:d], x[:d], block=1024)
        k["fused_moments_hist"](x[:d], x[:d], block=1024)
        k["tree_count"](x[:d], x[:d], torch.ones(15, device="cuda"),
                        block=1024)
        k["moments"](x[:d], block=1024)
        k["count_gt"](x[:d], 0.5, block=1024)
        for dt in (torch.int32, torch.int64):
            k["threefry_bits"]((1, 2), torch.empty(d, dtype=dt,
                                                   device="cuda"))
    torch.cuda.synchronize()
    th.join()
    if err:
        raise err[0]
    for src, rep in reports.items():
        log(f"nvcc {src}: ptxas report follows")
        log(rep.strip())
    return time.time() - t0


def check_moments(d, what, got, plain, sum_abs):
    """K1/K4a moments against the plain version: ``s`` within
    ``1e-5·Σ|u|``, ``sq`` within rtol 1e-5, absmax exact.  Returns the
    larger error."""
    (s, sq, mx), (ps, psq, pmx) = got, plain
    err_s, err_sq = abs(float(s) - float(ps)), abs(float(sq) - float(psq))
    assert err_s <= 1e-5 * sum_abs, (d, what, "s", float(s), float(ps))
    assert err_sq <= 1e-5 * abs(float(psq)), (d, what, "sq", float(sq),
                                              float(psq))
    assert float(mx) == float(pmx), (d, what, "absmax", float(mx),
                                     float(pmx))
    return max(err_s, err_sq)


def same_bits(a, b) -> bool:
    """Bitwise equality: same shape and dtype, f32 compared as int32."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def check_edge_cases(d, g, e, u, thres, bcap, ubcap) -> str:
    """K3 stage, K4c and K4d against their plain versions, bitwise, on
    the cases the kernels treat apart: contiguous views at storage
    offsets 0, 1 and 3 (1 and 3 take the scalar-load path), blocks 1024,
    2048, 4096 and 1001 (not a multiple of 4), at the final threshold,
    at 0 (every non-zero element is counted; nearly every block
    overflows its staging width) and just above ``max|u|`` (nothing
    selected); K4d also on one magnitude (one bin), all zeros, and
    zeros, subnormals, infinities and values at or above ``edge[127]``.
    Returns a summary."""
    import torch

    from repro_torch.kernels.ef_fused import compact_residual as cr
    from repro_torch.kernels.ef_fused.fused_moments import _blocks
    from repro_torch.kernels.gaussian_topk import threshold_compact as thc
    from repro_torch.kernels.histk import hist

    top = u.abs().max()
    above = float(torch.nextafter(top, torch.full_like(top, math.inf)))
    full = 0
    for off in (0, 1, 3):
        gv, ev, uv = g[off:], e[off:], u[off:]
        assert uv.storage_offset() == off and uv.is_contiguous()
        for block in (1024, 2048, 4096, 1001):
            for t in (thres, 0.0, above):
                got = cr.compact_stage(gv, ev, t, block=block, bcap=bcap)
                want = cr.compact_stage_plain(gv, ev, t, block=block,
                                              bcap=bcap)
                for a, b, what in zip(got, want, ("values", "offsets",
                                                  "counts")):
                    assert same_bits(a, b), (d, "K3 stage", off, block, t,
                                             what)
                got = thc.threshold_compact(uv, t, block=block, bcap=ubcap)
                want = thc.threshold_compact_plain(uv, t, block=block,
                                                   bcap=ubcap)
                for a, b, what in zip(got, want, ("values", "offsets",
                                                  "counts")):
                    assert same_bits(a, b), (d, "K4c", off, block, t, what)
                cnt = want[2]
                if t == 0.0:   # every non-zero element is counted
                    nonzero = (_blocks(uv, block) != 0).sum(dim=1)
                    assert torch.equal(cnt.long(), nonzero), (d, "at 0")
                    full += int((cnt > ubcap).sum())
                elif t == above:
                    assert int(cnt.max()) == 0, (d, "nothing above max")
    mixed = u.clone()
    mixed[0::6] = 0.0
    mixed[1::6] = -1e-40                       # subnormal
    mixed[2::6] = float(hist.EDGES[127])
    mixed[3::6] = -3e38
    mixed[4::12] = math.inf
    inputs = {"u": u, "one magnitude": torch.full_like(u, 0.37),
              "zeros": torch.zeros_like(u), "mixed": mixed}
    for name, x in inputs.items():
        for off in (0, 1, 3):
            h = hist.abs_histogram(x[off:])
            assert torch.equal(h, hist.abs_histogram_plain(x[off:],
                                                           block=4096)), (
                d, "K4d", name, off)
            assert int(h.sum()) == d - off, (d, "K4d total", name, off)
    del mixed, inputs
    return (f"K3 stage, K4c and K4d bitwise at storage offsets 0/1/3, "
            f"blocks 1024/2048/4096/1001, thresholds final/0/above max "
            f"({full} overflowing rows at threshold 0); K4d on one "
            f"magnitude, zeros, and zeros/subnormals/inf/>= edge[127]")


def check_main_kernels(g, e, k: int, label):
    """K1, K2 and both K3 launches of the Gaussian-k path on ``(g, e)``
    (views allowed) at budget ``k`` against their plain versions on the
    card: moments within tolerance, counts, staging and residual
    bitwise, and the fused pipeline's conservation bitwise.  Returns
    what the further checks and the timings reuse."""
    import types

    import torch

    from repro_torch.core import codec
    from repro_torch.core.compressors import gaussiank_cap
    from repro_torch.kernels.ef_fused import compact_residual as cr
    from repro_torch.kernels.ef_fused import fused_moments as fm
    from repro_torch.kernels.ef_fused import ops, tuning
    from repro_torch.kernels.ef_fused import tree_count as tc
    from repro_torch.kernels.gaussian_topk import ops as gops

    d = g.numel()
    cfg = tuning.resolve_config(d, "cuda")
    sb, block = cfg.stats_block, cfg.block
    k_cap = gaussiank_cap(k, d)
    bcap = ops.fused_default_bcap(k_cap, d, block, cfg.bcap_slack)
    # K1
    s, sq, mx = fm.fused_moments(g, e, block=sb)
    ps, psq, pmx = fm.fused_moments_plain(g, e, block=sb)
    sum_abs = float((g + e).abs().double().sum())
    k1_err = check_moments(label, "K1", (s, sq, mx), (ps, psq, pmx),
                           sum_abs)
    # K2 at the refinement tree of the plain moments
    t0 = ops.gaussian_t0(ps, psq, d, k, False)
    heap, n_cnt = ops._tree_thresholds(t0, 4)
    thr = torch.from_numpy(heap[:n_cnt]).cuda()
    cnt_k = tc.tree_count(g, e, thr, block=sb)
    cnt_p = tc.tree_count_plain(g, e, thr, block=sb)
    assert torch.equal(cnt_k, cnt_p), (label, "K2", cnt_k, cnt_p)
    thres = float(ops._replay_refinement(heap, cnt_p.cpu().numpy(), k, 4))
    # K3 at that same threshold
    vk, ok, ck = cr.compact_stage(g, e, thres, block=block, bcap=bcap)
    vp, op, cp = cr.compact_stage_plain(g, e, thres, block=block, bcap=bcap)
    assert torch.equal(ck, cp), (label, "K3 counts")
    assert torch.equal(ok, op), (label, "K3 offsets")
    assert same_bits(vk, vp), (label, "K3 staged values")
    enc = cr.exclusive_enc(cp, bcap)
    rk = cr.compact_resid(g, e, thres, enc, block=block, bcap=bcap,
                          k_cap=k_cap)
    rp = cr.compact_resid_plain(g, e, thres, enc, block=block, bcap=bcap,
                                k_cap=k_cap)
    assert same_bits(rk, rp), (label, "K3 residual")
    # the pipeline: conservation decode(v, i) + e' == g + e, bitwise
    v, i, ne = ops.fused_compress_ef(g, e, "gaussiank", k)
    assert torch.equal(codec.decode(v, i, d) + ne, g + e), (label,
                                                            "conserve")
    nnz = int(codec.nnz(i))
    log(f"  {label}: K1 max error {k1_err:.3g}, absmax exact; K2 counts "
        f"exact {cnt_k.tolist()[:3]}...; K3 staging + residual bitwise "
        f"(block {block}, bcap {bcap}, {int(ck.sum())} over threshold "
        f"{thres:.6g}); pipeline conserves bitwise, {nnz}/{k_cap} slots "
        f"for k={k}")
    return types.SimpleNamespace(
        sb=sb, block=block, k_cap=k_cap, bcap=bcap,
        ubcap=gops.default_bcap(k_cap, d, block), s=s, sq=sq, ps=ps,
        psq=psq, pmx=pmx, sum_abs=sum_abs, k1_err=k1_err, heap=heap,
        thr=thr, cnt_k=cnt_k, thres=thres, vk=vk, ok=ok, ck=ck, enc=enc)


def check_model_rows(torch, model_size: int = 2) -> None:
    """Phase 2 at a model axis of ``model_size``: K1, K2 and both K3
    launches against their plain versions on every row of an ``(M,
    d_row_total)`` bucket of two segments, the 1,000,003- and the
    268,435,456-element leaf (``layout.flat_dims``: 500,002 and
    134,217,728 columns a row at M = 2), each row at its own budget
    ``ceil(k / M)``, as the main path's segment windows (storage offset
    ``r·d_row_total + row_off``) give them to the kernels."""
    from repro_torch.dist.layout import flat_dims, row_budget
    M = model_size
    sizes = (1_000_003, BIG_LEAF)
    d_rows = [flat_dims(n, M)[1] for n in sizes]
    D = sum(d_rows)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    G = torch.randn((M, D), generator=gen, device="cuda").mul_(1e-3)
    E = torch.randn((M, D), generator=gen, device="cuda").mul_(5e-4)
    off = 0
    for n, d_row in zip(sizes, d_rows):
        k_row = row_budget(max(1, math.ceil(RATIO * n)), M, d_row)
        for r in range(M):
            check_main_kernels(G[r, off:off + d_row], E[r, off:off + d_row],
                               k_row, f"row {r} of {M}, {n:,}-element leaf")
        off += d_row
    del G, E
    torch.cuda.empty_cache()


def check_kernels(d: int, seed: int, rows: dict, timed: bool):
    """Phase 2 at one size: each kernel against its plain version on the
    card (moments within tolerance, everything else bitwise), the
    pipelines' conservation, unfused against fused bitwise, and
    (``timed``) the times that go into the kernels line."""
    import torch

    from repro_torch.core import codec
    from repro_torch.kernels.ef_fused import compact_residual as cr
    from repro_torch.kernels.ef_fused import fused_moments as fm
    from repro_torch.kernels.ef_fused import ops
    from repro_torch.kernels.ef_fused import tree_count as tc
    from repro_torch.kernels.gaussian_topk import count_gt as cg
    from repro_torch.kernels.gaussian_topk import ops as gops
    from repro_torch.kernels.gaussian_topk import threshold_compact as thc
    from repro_torch.kernels.histk import hist
    from repro_torch.kernels.histk import ops as hops
    from repro_torch.kernels.moments import moments as mom

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    g = torch.randn(d, generator=gen, device="cuda").mul_(1e-3)
    e = torch.randn(d, generator=gen, device="cuda").mul_(5e-4)
    k = max(1, math.ceil(RATIO * d))
    c = check_main_kernels(g, e, k, f"d={d:>11,}")
    sb, block, k_cap, bcap, ubcap = c.sb, c.block, c.k_cap, c.bcap, c.ubcap
    s, sq, ps, psq, pmx = c.s, c.sq, c.ps, c.psq, c.pmx
    sum_abs, k1_err, heap, thr, cnt_k = (c.sum_abs, c.k1_err, c.heap,
                                         c.thr, c.cnt_k)
    thres, vk, ok, ck, enc = c.thres, c.vk, c.ok, c.ck, c.enc
    nb, nbs = -(-d // block), -(-d // sb)
    del c

    # K1 with its histogram, and K4d on the materialised u
    u = g + e
    hs = fm.fused_moments_hist(g, e, block=sb)
    hp = hist.abs_histogram_plain(u, block=sb)
    assert torch.equal(hs[3], hp), (d, "K1 histogram")
    assert int(hs[3].sum()) == d, (d, "K1 histogram total")
    k1h_err = check_moments(d, "K1 hist", hs[:3], (ps, psq, pmx), sum_abs)
    h4 = hist.abs_histogram(u, block=sb)
    assert torch.equal(h4, hp), (d, "K4d histogram")
    # K4a: the same per-block sums as K1, so bitwise K1's
    m4 = mom.moments(u, block=sb)
    k4a_err = check_moments(d, "K4a", m4, fm.moments_plain(u, sb), sum_abs)
    assert same_bits(m4[0], s) and same_bits(m4[1], sq), (
        d, "K4a vs K1", [float(x) for x in m4], float(s), float(sq))
    # K4b at the tree's root (K2's first count) and the final threshold
    for t in (float(heap[0]), thres):
        c4 = cg.count_gt(u, t, block=sb)
        assert torch.equal(c4, cg.count_gt_plain(u, t, block=sb)), (
            d, "K4b", t)
    assert int(cg.count_gt(u, float(heap[0]), block=sb)) == int(cnt_k[0])
    # K4c at the final threshold and the unfused staging width
    st4 = thc.threshold_compact(u, thres, block=block, bcap=ubcap)
    stp = thc.threshold_compact_plain(u, thres, block=block, bcap=ubcap)
    for a, b, what in zip(st4, stp, ("values", "offsets", "counts")):
        assert same_bits(a, b), (d, "K4c", what)
    if ubcap == bcap:
        for a, b in zip(st4, (vk, ok, ck)):
            assert same_bits(a, b), (d, "K4c vs K3 stage")
    # the registry's hist-k geometry (block 2048 for both launches)
    th = float(hops.histk_threshold(u, k, block=2048))
    hb = gops.default_bcap(hops.histk_cap(k, d), d, 2048)
    assert torch.equal(hist.abs_histogram(u, block=2048),
                       hist.abs_histogram_plain(u, block=2048)), (
        d, "K4d block 2048")
    for a, b in zip(thc.threshold_compact(u, th, block=2048, bcap=hb),
                    thc.threshold_compact_plain(u, th, block=2048,
                                                bcap=hb)):
        assert same_bits(a, b), (d, "K4c block 2048")
    edge_summary = check_edge_cases(d, g, e, u, thres, bcap, ubcap)
    # unfused against fused, bitwise, and conservation.  Each pipeline
    # takes its own default staging width (2x and 4x the expected
    # per-block selection); at the card's block of 1024 both are 64 at
    # these sizes, so they truncate alike.
    assert ubcap == bcap, (d, "staging widths", bcap, ubcap)
    for name in ("gaussiank", "gaussiank2", "histk"):
        fv, fi, fne = ops.fused_compress_ef(g, e, name, k)
        uv, ui, une = ops.unfused_compress_ef(g, e, name, k)
        assert same_bits(fv, uv) and same_bits(fi, ui), (d, name, "wire")
        assert same_bits(fne, une), (d, name, "residual")
        assert torch.equal(codec.decode(fv, fi, d) + fne, u), (
            d, name, "conserve")
        del fv, fi, fne, uv, ui, une
    log(f"  d={d:>11,}: K1 histogram and K4d bitwise the plain version "
        f"(bins {int((hp > 0).sum())} occupied); K4a bitwise K1's sums; "
        f"K4b, K4c (bcap {ubcap}) bitwise; K4c/K4d at block 2048 bitwise; "
        f"unfused == fused bitwise for gaussiank, gaussiank2, histk")
    log(f"  d={d:>11,}: {edge_summary}")
    if not timed:
        return

    def pipeline_plain():
        a, b, _ = fm.fused_moments_plain(g, e, block=sb)
        h, n = ops._tree_thresholds(ops.gaussian_t0(a, b, d, k, False), 4)
        c = tc.tree_count_plain(g, e, torch.from_numpy(h[:n]).cuda(),
                                block=sb)
        t = float(ops._replay_refinement(h, c.cpu().numpy(), k, 4))
        vv, oo, cc = cr.compact_stage_plain(g, e, t, block=block, bcap=bcap)
        nn = cr.compact_resid_plain(g, e, t, cr.exclusive_enc(cc, bcap),
                                    block=block, bcap=bcap, k_cap=k_cap)
        return cr.assemble_staging(vv, oo, cc, k_cap, block=block), nn

    it, pit = (20, 5) if d < BIG_LEAF else (10, 3)
    out = torch.empty_like(g)
    ms = {
        "fused_moments": (lambda: fm.fused_moments(g, e, block=sb),
                          lambda: fm.fused_moments_plain(g, e, block=sb)),
        "fused_moments_hist": (
            lambda: fm.fused_moments_hist(g, e, block=sb),
            lambda: fm.fused_moments_hist_plain(g, e, block=sb)),
        "tree_count": (lambda: tc.tree_count(g, e, thr, block=sb),
                       lambda: tc.tree_count_plain(g, e, thr, block=sb)),
        "compact_stage": (
            lambda: cr.compact_stage(g, e, thres, block=block, bcap=bcap),
            lambda: cr.compact_stage_plain(g, e, thres, block=block,
                                           bcap=bcap)),
        "compact_resid": (
            lambda: cr.compact_resid(g, e, thres, enc, block=block,
                                     bcap=bcap, k_cap=k_cap, out=out),
            lambda: cr.compact_resid_plain(g, e, thres, enc, block=block,
                                           bcap=bcap, k_cap=k_cap)),
        "moments": (lambda: mom.moments(u, block=sb),
                    lambda: fm.moments_plain(u, sb)),
        "count_gt": (lambda: cg.count_gt(u, thres, block=sb),
                     lambda: cg.count_gt_plain(u, thres, block=sb)),
        "threshold_compact": (
            lambda: thc.threshold_compact(u, thres, block=block, bcap=ubcap),
            lambda: thc.threshold_compact_plain(u, thres, block=block,
                                                bcap=ubcap)),
        "abs_histogram": (lambda: hist.abs_histogram(u, block=sb),
                          lambda: hist.abs_histogram_plain(u, block=sb)),
    }
    ms = {n: (time_ms(a, it), time_ms(b, pit)) for n, (a, b) in ms.items()}
    nt = thr.numel()
    # (bytes: each input of the function read once and each of its
    # outputs written once; ops; bytes of the per-program partial rows
    # the design writes and folds — for K4d the 1 KB of integer atomic
    # adds each of its CTAs, at most one per SM, makes into the output —
    # an overhead of the design that the bound does not count)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    work = {
        "fused_moments": (8 * d + 12, 5 * d, 12 * nbs),
        "fused_moments_hist": (8 * d + 12 + 8 * 128, 20 * d,
                               (12 + 4 * 128) * nbs),
        "tree_count": (8 * d + 8 * nt, 17 * d,
                       4 * max(2, 1 << (nt - 1).bit_length()) * nbs),
        "compact_stage": (8 * d + 8 * nb * bcap + 4 * nb, 3 * d, 0),
        "compact_resid": (12 * d + 8 * nb, 3 * d, 0),
        "moments": (4 * d + 12, 5 * d, 12 * nbs),
        "count_gt": (4 * d + 8, 3 * d, 4 * 2 * nbs),
        "threshold_compact": (4 * d + 8 * nb * ubcap + 4 * nb, 3 * d, 0),
        "abs_histogram": (4 * d + 8 * 128, 15 * d, 8 * 128 * sms),
    }
    errs = {"fused_moments": k1_err, "fused_moments_hist": k1h_err,
            "moments": k4a_err}
    for name, (k_ms, p_ms) in ms.items():
        fn_bytes, ops_n, rows_bytes = work[name]
        b_ms, b_by = bound(fn_bytes, ops_n)
        rows[name].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=errs.get(name, 0.0),
                          d=d, partial_rows_bytes=rows_bytes)
    log(f"  times at d={d:,} (ms, median): " + ", ".join(
        f"{n} {a:.4f} (plain {b:.3f})" for n, (a, b) in ms.items()))
    # K4c at the registry's hist-k block (path B's geometry) as well
    nb2, bcap2 = -(-d // 2048), gops.default_bcap(k_cap, d, 2048)
    rows["threshold_compact"].update(
        ms_block_2048=time_ms(lambda: thc.threshold_compact(
            u, thres, block=2048, bcap=bcap2), it),
        bound_ms_block_2048=bound(4 * d + 8 * nb2 * bcap2 + 4 * nb2,
                                  3 * d)[0], bcap_block_2048=bcap2)
    log("  K4c at block 2048, bcap {}: {:.4f} ms (bound {:.4f})".format(
        bcap2, rows["threshold_compact"]["ms_block_2048"],
        rows["threshold_compact"]["bound_ms_block_2048"]))

    # the pipelines beside exact top-k: the paper's Fig. 4 on this card.
    # bytes per element of each pipeline's own passes (a read or write
    # of a leaf-sized f32 array is 4 bytes)
    u_abs = u.abs()
    ef, sel = 12 * d + 8 * k_cap, 4 * d + 8 * k_cap
    pipes = {   # name: (call, bytes of the function's own inputs and
        #               outputs, bytes per element of its passes)
        "fused gaussiank (K1, K2, K3 stage, K3 residual)": (
            lambda: ops.fused_compress_ef(g, e, "gaussiank", k), ef, 36),
        "fused histk (K1 with histogram, K3 stage, K3 residual)": (
            lambda: ops.fused_compress_ef(g, e, "histk", k), ef, 28),
        "unfused gaussiank (add, K4a, K4b x4, K4c, decode, subtract)": (
            lambda: ops.unfused_compress_ef(g, e, "gaussiank", k), ef, 52),
        "unfused histk (add, K4d, K4c, decode, subtract)": (
            lambda: ops.unfused_compress_ef(g, e, "histk", k), ef, 36),
        "histk_select_kernel on u (K4d, K4c at block 2048)": (
            lambda: hops.histk_select_kernel(u, k), sel, 8),
        "torch.topk(|u|, k) on a precomputed |u|": (
            lambda: torch.topk(u_abs, k), sel, 4),
    }
    prows = []
    for name, (fn, fn_bytes, bpe) in pipes.items():
        t = time_ms(fn, it)
        b_ms, b_by = bound(fn_bytes, 3 * d)
        prows.append({"name": name, "d": d, "k": k, "ms": t,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "passes_bound_ms": bpe * d / HBM_BYTES_PER_S * 1e3})
    prows[0]["plain_ms"] = time_ms(pipeline_plain, pit)
    rows["pipelines"] = prows
    log("  pipelines at d={:,}, k={:,} (ms, median): ".format(d, k)
        + "; ".join(f"{r['name']} {r['ms']:.3f} (bound "
                    f"{r['bound_ms']:.3f}, passes {r['passes_bound_ms']:.3f})"
                    for r in prows))
    del u_abs, out


# bytes per element of the leaf-sized arrays each kernel reads and writes
# (staging rows and partial rows not counted): the per-step bound of a
# path is these over all the step's elements at the memory rate
LEAF_BYTES = {"fused_moments": 8, "fused_moments_hist": 8, "tree_count": 8,
              "compact_stage": 8, "compact_resid": 12, "moments": 4,
              "count_gt": 4, "threshold_compact": 4, "abs_histogram": 4,
              "threefry_bits": 8}
# adaptive density compresses u = G + E in place: the kernels read u alone
ADAPTIVE_LEAF_BYTES = {"fused_moments": 4, "fused_moments_hist": 4,
                       "tree_count": 4, "compact_stage": 4,
                       "compact_resid": 8}


def init_draws(cfg) -> int:
    """``threefry_bits`` launches of ``init_params(cfg, seed)`` on the
    card: one a weight matrix (the embedding, the head, and a layer's
    core matrices — four of attention, five of Mamba, seven of mLSTM,
    nine of sLSTM — and its FFN's: three of an MLP, four of MoE and three
    more with shared experts)."""
    core = {"attn": 4, "swa": 4, "mamba": 5, "mlstm": 7, "slstm": 9}
    ffn = {"mlp": 3, "none": 0,
           "moe": 4 + 3 * bool(cfg.num_shared_experts)}
    return 2 + sum(core[k] + ffn[f] for k, f in
                   map(cfg.layer_sig, range(cfg.num_layers)))


def batch_draws(cfg) -> int:
    """``threefry_bits`` launches of ``batch_for`` on the card a step:
    an ``embeds`` batch draws its embeddings (one) and labels (two);
    ``lm_batch`` draws on the host."""
    return 3 if cfg.frontend == "embeds" else 0


def zeroed(run):
    """Run one path with every launch counter set to 0 just before it and
    read just after: ``(launches by kernel, run's result)``."""
    funcs = counters()
    for f in funcs.values():
        f.launches = 0
    out = run()
    return {n: f.launches for n, f in funcs.items()}, out


def drive(label, run, expect, steps, once=None):
    """Run one path with every launch counter set to 0 just before and
    read just after; check the counts against ``expect`` per step plus
    ``once`` (launches made once a run: the params' draws) — a kernel
    missing from both must not launch."""
    launches, out = zeroed(run)
    once = once or {}
    want = {n: expect.get(n, 0) * steps + once.get(n, 0) for n in launches}
    assert launches == want, (label, "launches", launches, want)
    for n, c in expect.items():
        assert c > 0 and launches[n] > 0, (label, n)
    return launches, out


def conserves(G, values, indices, new_E, label, torch) -> None:
    """``decode(values, indices) + new_E == G`` bitwise, one 1 GiB column
    slice at a time (not one 6 GB decode); ``G`` may be a host copy."""
    step = 1 << 28
    D = G.shape[1]
    dev = new_E.device
    for m in range(G.shape[0]):
        v, i = values[m].float(), indices[m].long()
        for a in range(0, D, step):
            b = min(a + step, D)
            sel = (i >= a) & (i < b)
            dec = torch.zeros(b - a, device=dev)
            dec.index_add_(0, i[sel] - a, v[sel])
            assert torch.equal(dec + new_E[m, a:b], G[m, a:b].to(dev)), (
                label, "conservation", m, a)


class CompressTimer:
    """Times every ``dist.aggregate.bucket_compress`` call between CUDA
    events while active (the module attribute is swapped and restored);
    ``per_step(steps)`` sums the calls of each step."""

    def __init__(self, torch):
        self.torch, self.events = torch, []

    def __enter__(self):
        from repro_torch.dist import aggregate
        self.mod, self.orig = aggregate, aggregate.bucket_compress

        def timed(*a, **k):
            ev = [self.torch.cuda.Event(enable_timing=True)
                  for _ in range(2)]
            ev[0].record()
            out = self.orig(*a, **k)
            ev[1].record()
            self.events.append(ev)
            return out

        aggregate.bucket_compress = timed
        return self

    def __exit__(self, *exc):
        self.mod.bucket_compress = self.orig

    def per_step(self, steps):
        self.torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in self.events]
        per = max(1, len(ms) // steps)
        return [sum(ms[i:i + per]) for i in range(0, per * steps, per)]


def train_path(label, argv, expect, steps, torch, workers=1, cfg=None,
               global_check=False, levels=1, leaf_bytes=None, bounds=None,
               runner=None, mc_check=""):
    """One trainer path at full width (``workers`` of them in this
    process): returns its launches, records, peak memory, each launched
    kernel's bound per step (``leaf_bytes``, default ``LEAF_BYTES``,
    over the bucket's columns and the workers) and the wire's ms per
    step; checks the per-step launches, each worker's bucket
    conservation at step 0, finite losses and density <= cap.
    ``global_check`` also holds gTop-k's conservation across the workers
    at step 0: ``sum_w e'_w + W * mean == sum_w G_w`` within ``2**-19 *
    sum_w |G_w|`` per element (f32 rounding of the sums); returns the
    largest difference seen and the bound's largest value.

    Under adaptive density (``bounds``: the layout's per-segment
    ``(k_lo, k_hi)``) the step-0 check holds each worker's ``u`` (copied
    to the host after its pass A, before it is compressed in place), and
    every step's allocation is checked: ``sum(k) == K_eff``, ``k_lo <= k
    <= k_hi``; the allocations come back in ``extra["allocs"]``, and the
    peak memory of the steps after step 0 (the host copies are not on
    the card) as ``extra["peak_after0"]``.

    ``runner(steps, probe)``, when given, trains instead of the CLI and
    returns the records (momentum correction has no flag).  ``mc_check``
    holds, at step 0, momentum correction's zeroing at every index a
    worker sent: ``"v"`` of the velocities ``resid2``, ``"ev"`` of the
    residual too (not under gTop-k, whose merge drops land in it).
    The per-step ``bucket_compress`` ms (CUDA events) come back in
    ``extra["compress_ms"]``."""
    import numpy as np

    from repro_torch.launch import train
    funcs = counters()
    seen, G_cols, wire_ev, last, allocs = [], [], [], [None], []
    acc, u_host, peaks = {}, {}, {}

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def probe(rank, G=None, values=None, indices=None, new_E=None,
              means=None, resid=None, resid2=None, u=None, k_alloc=None,
              K_eff=None, chunk=None, backward=None, release=None):
        if backward is not None or release is not None:
            return      # the backward's ends and the chunk hook
        if rank is None and k_alloc is not None:
            k = np.asarray(k_alloc)
            lo, hi = (np.asarray(b) for b in bounds)
            assert int(k.sum()) == int(K_eff), (label, "sum(k)", K_eff)
            assert np.all(lo <= k) and np.all(k <= hi), (label, "bounds")
            allocs.append((k.copy(), int(K_eff)))
            return
        if rank is None:
            if mc_check and not seen:
                R2 = resid2.view(workers, -1)
                E = resid.view(workers, -1)
                for w, idx in acc.pop("sel").items():
                    assert bool((R2[w, idx] == 0).all()), (label, "v'", w)
                    if "e" in mc_check:
                        assert bool((E[w, idx] == 0).all()), (label, "e'",
                                                              w)
            seen.append({n: f.launches for n, f in funcs.items()})
            wire_ev.append((last[0], event()))
            if len(seen) == 1:
                # step 0's peak (its checks included), then the rest's
                peaks["step0"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            if global_check and len(seen) == 1:
                (mean,) = means         # the bucket is one chunk
                E = resid.view(workers, *mean.shape)
                lhs = E.sum(dim=0) + workers * mean
                diff = (lhs - acc["G"]).abs()
                acc["err"] = float(diff.max())
                acc["tol"] = float(acc["absG"].max()) * 2.0 ** -19
                assert bool((diff <= 2.0 ** -19 * acc["absG"]).all()), (
                    label, "gTop-k conservation", acc["err"], acc["tol"])
                del acc["G"], acc["absG"], lhs, diff
            return
        if u is not None:   # adaptive: u = G + E after this worker's pass A
            if not seen:
                u_host[rank] = u.to("cpu", copy=True)
            return
        if not seen:   # step 0: the residual was zero, u == G
            G_cols.append(new_E.shape[1])
            if G is None:
                G = u_host.pop(rank)
            conserves(G, values, indices, new_E, label, torch)
            if mc_check:
                i = indices.reshape(-1).long()
                acc.setdefault("sel", {})[rank] = i[i >= 0]
            if global_check:
                if "G" in acc:
                    acc["G"] += G
                    acc["absG"] += G.abs()
                else:
                    acc["G"], acc["absG"] = G.clone(), G.abs()
        last[0] = event()

    # the params are drawn on the card before step 0
    from repro_torch.configs import get_config
    once = {"threefry_bits": init_draws(cfg or get_config("llama3.2-1b"))}
    torch.cuda.reset_peak_memory_stats()
    timer = CompressTimer(torch)
    with timer:
        launches, records = drive(
            label, (lambda: runner(steps, probe)) if runner else
            (lambda: train.run(argv + ["--steps", str(steps),
                                       "--log-every", "1"], probe=probe,
                                   cfg=cfg)),
            expect, steps, once)
    peaks["after0"] = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    wire_ms = [a.elapsed_time(b) for a, b in wire_ev]
    for s, snap in enumerate(seen):
        for n in set(expect) | set(once):
            assert snap[n] == expect.get(n, 0) * (s + 1) + once.get(n, 0), (
                label, "per-step", s, n, snap)
    losses = [r["loss"] for r in records]
    assert all(math.isfinite(x) for x in losses), (label, losses)
    for r in records:
        # randk, dgck and rtopk send exactly their capacity: up to the
        # f32 rounding of nnz / d, density is the cap
        assert r["density"] <= levels * r["density_cap"] * (1 + 2**-22), (
            label, r)
    if bounds is not None:
        assert len(allocs) == steps, (label, "allocations", len(allocs))
        for r, (k, K_eff) in zip(records, allocs):
            assert r["k_total"] == K_eff, (label, r["k_total"], K_eff)
    step_ms = [r["ms"] for r in records]
    cols = G_cols[0]
    # each of the 12 leaves' launches reads and writes its columns once
    step_bound = {n: (leaf_bytes or LEAF_BYTES)[n] * cols * (c // 12)
                  / HBM_BYTES_PER_S * 1e3 for n, c in expect.items()}
    peak = max(peaks["after0"], peaks["step0"])
    log(f"  {label}: losses {losses}; step ms "
        f"{[round(x, 1) for x in step_ms]}; wire ms "
        f"{[round(x, 2) for x in wire_ms]}; peak memory "
        f"{peak / 2**30:.2f} GiB (steps 1-: "
        f"{peaks['after0'] / 2**30:.2f} GiB); density "
        f"{[round(r['density'], 6) for r in records]} (cap "
        f"{records[0]['density_cap']:.6f}); launches {launches}; every "
        f"worker's step-0 bucket conserves bitwise; per-step bound ms over "
        f"{cols:,} columns {step_bound}")
    if global_check:
        log(f"  {label}: step 0 sum_w e'_w + W*mean == sum_w G_w, largest "
            f"difference {acc['err']:.3g} (bound 2**-19 * sum_w |G_w|, "
            f"largest {acc['tol']:.3g})")
    extra = {"wire_ms": wire_ms, "compress_ms": timer.per_step(steps),
             "conservation": dict(
        (k, acc[k]) for k in ("err", "tol") if k in acc),
        "allocs": allocs, "peak_after0": peaks["after0"]}
    return launches, records, peak, step_bound, extra


PG_STRATEGIES = ("allgather", "gtopk")


def train_lib(cfg, mesh, strategy, steps, batch, seq, wire, device,
              chunks=1):
    """Train ``steps`` steps of Gaussian-k at ``RATIO`` (at ``chunks``)
    through the library entry points (``init_train_state``,
    ``make_train_step``) on ``wire``; returns the losses, the final state
    and each step's ms (host clock around a synchronised step)."""
    import torch

    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data import batch_for
    from repro_torch.dist.layout import build_layout
    from repro_torch.models import init_params
    from repro_torch.optim import constant, sgd_momentum
    from repro_torch.train import init_train_state, make_train_step
    params = init_params(cfg, 0, device)
    comp = CompressionConfig(ratio=RATIO, strategy=strategy, chunks=chunks)
    layout = build_layout(params, 1, comp)
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=wire.local_workers,
                             model_size=1, compression=comp, layout=layout)
    step = make_train_step(cfg, mesh, opt, constant(0.1), compression=comp,
                           layout=layout, wire=wire)
    losses, ms = [], []
    for i in range(steps):
        b = batch_for(cfg, i, global_batch=batch, seq_len=seq, device=device)
        t0 = time.perf_counter()
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, state, ms


def digests(state, ranks) -> dict:
    """sha256 of the params, of the optimizer state and of each residual
    row (row ``j`` of the state is worker ``ranks[j]``'s)."""
    import hashlib

    from repro_torch import tree
    out = {}
    for key in ("params", "opt"):
        h = hashlib.sha256()
        for leaf in tree.leaves(state[key]):
            h.update(leaf.detach().cpu().numpy())
        out[key] = h.hexdigest()
    for j, rank in enumerate(ranks):
        out[f"resid/{rank}"] = hashlib.sha256(
            state["resid"][j].cpu().numpy()).hexdigest()
    return out


def llama_layers(n):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3.2-1b"),
                               num_layers=n).validate()


def pg_child(rank, world, backend, port, cfg, steps, batch, seq, queue,
             chunks=1):
    """Phases 5c and 9d, one rank: ``ProcessGroupWire`` over ``backend``,
    each of ``PG_STRATEGIES`` trained ``steps`` steps at ``chunks``; puts
    ``(rank, results)`` on ``queue``."""
    import traceback
    try:
        sys.path.insert(0, os.path.join(HERE, "src"))
        import torch
        import torch.distributed as dist

        from repro_torch.dist.wire import (ProcessGroupWire,
                                           init_process_group)
        from repro_torch.launch.mesh import parse_mesh
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        nccl = backend == "nccl"
        init_process_group(backend, rank=rank, world_size=world,
                           local_rank=rank if nccl else 0,
                           local_world_size=world,
                           init_method=f"tcp://127.0.0.1:{port}")
        device = torch.device("cuda", rank if nccl else 0)
        mesh = parse_mesh(f"{world}x1")
        wire = ProcessGroupWire(mesh)
        funcs = counters()
        out = {}
        for strategy in PG_STRATEGIES:
            for f in funcs.values():
                f.launches = 0
            issued = wire.async_ops
            losses, state, ms = train_lib(cfg, mesh, strategy, steps, batch,
                                          seq, wire, device, chunks)
            out[strategy] = {"losses": losses,
                             "digests": digests(state, [rank]),
                             "launches": {n: f.launches
                                          for n, f in funcs.items()},
                             "backend": wire.backend,
                             "async_ops": wire.async_ops - issued,
                             "step_ms": ms}
            del state
            torch.cuda.empty_cache()
        dist.destroy_process_group()
        queue.put((rank, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


PG_STEPS, PG_BATCH, PG_SEQ = 2, 4, 128


def pg_ranks(torch, cfg, chunks=1) -> tuple:
    """Two ranks spawned over ``torch.distributed`` (NCCL with a card each
    when there are two cards, else gloo staged through host memory on
    the one card), each training ``PG_STRATEGIES`` of ``cfg`` at
    ``chunks`` (``pg_child``); returns ``(backend, results by rank)``."""
    return spawn_ranks(torch, pg_child, lambda backend, port: (
        cfg, PG_STEPS, PG_BATCH, PG_SEQ), chunks=chunks)


def spawn_ranks(torch, target, args_of, **kw) -> tuple:
    """Two ranks of ``target(rank, 2, backend, port, *args_of(backend,
    port), queue, **kw)`` spawned (NCCL with a card each when there are
    two cards, else gloo on the one card), each putting ``(rank,
    results)`` on the queue; returns ``(backend, results by rank)``."""
    import multiprocessing as mp
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target,
                         args=(r, 2, backend, port, *args_of(backend, port),
                               queue), kwargs=kw) for r in range(2)]
    for p in procs:
        p.start()
    import queue as queue_mod
    got, deadline = {}, time.time() + 600
    try:
        while len(got) < len(procs):
            try:
                rank, out = queue.get(timeout=5)
                got[rank] = out
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if not p.is_alive() and p.exitcode != 0]
                assert not dead and time.time() < deadline, (
                    "ranks ended without a result", dead)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join()
    for rank, out in got.items():
        assert "error" not in out, (rank, out.get("error"))
    for p in procs:
        assert p.exitcode == 0, ("rank exit code", p.exitcode)
    return backend, got


def check_ranks(cfg, backend, got, ref) -> dict:
    """Each rank's losses, params, momentum and own residual (sha256)
    equal ``ref``'s (the ``LocalWire`` run), and its launches 12 a step
    of each Gaussian-k kernel plus its params' draws; returns the
    launches summed over the ranks."""
    pg_launches = {n: 0 for n in counters()}
    draws = {"threefry_bits": init_draws(cfg)}   # each run draws its params
    for strategy in PG_STRATEGIES:
        want = ref[strategy]
        for rank in range(2):
            res = got[rank][strategy]
            assert res["backend"] == backend, res["backend"]
            assert res["losses"] == want["losses"], (
                strategy, rank, res["losses"], want["losses"])
            for key in ("params", "opt", f"resid/{rank}"):
                assert res["digests"][key] == want["digests"][key], (
                    strategy, rank, key)
            for n, c in res["launches"].items():
                assert c == (12 * PG_STEPS if n in MAIN_KERNELS else
                             draws.get(n, 0)), (strategy, rank, n, c)
                pg_launches[n] += c
    return pg_launches


def phase5c(torch, by_path, cfg) -> tuple:
    """The process-group wire on the card against ``LocalWire``: 2 ranks
    (:func:`pg_ranks`), 2 steps of each of ``PG_STRATEGIES`` of ``cfg``;
    params, optimizer state, residuals (sha256) and losses must be
    equal.  Returns the summary and the ``LocalWire`` run's digests."""
    from repro_torch.dist.wire import LocalWire
    from repro_torch.launch.mesh import parse_mesh
    cards = torch.cuda.device_count()
    mesh = parse_mesh("2x1")
    funcs = counters()
    ref = {}
    draws = {"threefry_bits": init_draws(cfg)}
    for strategy in PG_STRATEGIES:
        for f in funcs.values():
            f.launches = 0
        losses, state, _ = train_lib(cfg, mesh, strategy, PG_STEPS,
                                     PG_BATCH, PG_SEQ, LocalWire(mesh),
                                     torch.device("cuda"))
        ref[strategy] = {"losses": losses, "digests": digests(state, [0, 1]),
                         "launches": {n: f.launches
                                      for n, f in funcs.items()}}
        for n, c in ref[strategy]["launches"].items():
            assert c == (2 * 12 * PG_STEPS if n in MAIN_KERNELS else
                         draws.get(n, 0)), (strategy, "local", n, c)
        del state
        torch.cuda.empty_cache()
    backend, got = pg_ranks(torch, cfg)
    by_path["5c process group, 2 ranks"] = check_ranks(cfg, backend, got,
                                                       ref)
    by_path["5c LocalWire W=2"] = {n: sum(ref[s]["launches"][n]
                                          for s in PG_STRATEGIES)
                                   for n in funcs}
    where = ("one card per rank" if backend == "nccl" else
             "both ranks on cuda:0, collectives staged through host memory")
    log(f"  5c: backend {backend} ({cards} card(s) visible; {where}"
        f"): params, momentum, each rank's residual (sha256) and losses "
        f"equal LocalWire's for {', '.join(PG_STRATEGIES)}; losses "
        f"{ {s: ref[s]['losses'] for s in PG_STRATEGIES} }")
    return {"backend": backend, "cards": cards, "layers": cfg.num_layers,
            "losses": {s: ref[s]["losses"] for s in PG_STRATEGIES}}, ref


def adaptive_layout(cfg, compressor, policy):
    """The adaptive layout of ``cfg`` (built on the meta device: no
    memory), for the host-side budget and the allocator's bounds."""
    from repro_torch.core.compressors import get_compressor
    from repro_torch.dist.layout import build_layout
    from repro_torch.models import init_params
    return build_layout(init_params(cfg, 0, "meta"), 1, RATIO,
                        get_compressor(compressor), density_policy=policy)


def phase6_adaptive(torch, by_path, llama_adaptive, fixed_step_ms,
                    fixed_peak, base, cfg) -> dict:
    """Phase 6, adaptive layer-wise density (slice 3), each path with the
    launch counters set to 0 just before it and read just after:

    6a. llama3.2-1b's own default (no ``--density-policy``: ``variance``)
        at full width and depth, Gaussian-k fused, 3 steps: K1 (pass A,
        once a segment), K2 and the K3 launches 12 a step each; every
        step's ``k_total`` the budget reckoned on the host, ``sum(k) ==
        K_eff``, ``k`` within the bounds; step-0 conservation bitwise;
    6b. hist-k fused, ``absmax`` with EMA 0.5: K1 with histogram and K3,
        12 a step, no K2;
    6c. ``uniform`` with the DGC warmup (2 steps from 16x) and the
        norm-decay global-k controller: ``k_total`` the f32 warmup budget
        at step 0, then at most the budget and at least its floor share;
    6d. four workers on the card, ``variance``: allgather at full depth
        (48 launches a step), hierarchical at 4 layers (96); step-0
        conservation of every worker bitwise;
    6e. card against CPU on the small config, the CPU at the card's block
        geometry, for each policy with gaussiank and histk fused and topk
        on the reference backend: losses within rtol 1e-4, the
        allocations equal as integers."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import adaptk
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data import lm_batch
    from repro_torch import tree
    from repro_torch.dist.layout import build_layout
    from repro_torch.kernels.ef_fused import tuning
    from repro_torch.optim import constant, sgd_momentum
    from repro_torch.train import init_train_state, make_train_step

    out = {}
    llama = get_config("llama3.2-1b")

    def bounds_of(lay):
        return ([s.k_lo for s in lay.segments],
                [s.k_hi for s in lay.segments])

    def summary(records, peak, extra, bnd):
        return {"losses": [r["loss"] for r in records],
                "step_ms": [r["ms"] for r in records],
                "wire_ms": extra["wire_ms"],
                "peak_mem_gib": peak / 2**30,
                "peak_mem_after_step0_gib": extra["peak_after0"] / 2**30,
                "k_total": [r["k_total"] for r in records],
                "density": [r["density"] for r in records],
                "density_cap": records[0]["density_cap"],
                "step_bound_ms": bnd}

    log("phase 6a: llama3.2-1b at full width and depth with its default "
        "density policy (variance), Gaussian-k fused, 3 steps")
    pol = adaptk.make_policy("variance")
    lay = adaptive_layout(llama, "gaussiank", pol)
    K = int(adaptk.budget([s.size for s in lay.segments], RATIO, pol))
    main4 = {n: 12 for n in MAIN_KERNELS}
    by_path["6a adaptive variance"], records, peak, bnd, extra = train_path(
        "6a adaptive variance", llama_adaptive, main4, 3, torch,
        leaf_bytes=ADAPTIVE_LEAF_BYTES, bounds=bounds_of(lay))
    assert [k for _, k in extra["allocs"]] == [K] * 3, (extra["allocs"], K)
    out["6a"] = summary(records, peak, extra, bnd)
    out["6a"]["budget"] = K
    ad, fx = (statistics.median(x[1:]) for x in (out["6a"]["step_ms"],
                                                  fixed_step_ms))
    out["6a"]["step_over_fixed"] = ad / fx
    log(f"  6a: k_total {K} every step (the host's budget); median step "
        f"{ad:.1f} ms against fixed-k {fx:.1f} ms in this run "
        f"({ad / fx:.3f}x); peak {peak / 2**30:.2f} GiB against fixed-k "
        f"{fixed_peak:.2f}")
    del records
    torch.cuda.empty_cache()

    log("phase 6b: hist-k fused, --density-policy absmax --density-ema "
        "0.5, 3 steps")
    pol = adaptk.make_policy("absmax", ema=0.5)
    lay = adaptive_layout(llama, "histk", pol)
    by_path["6b adaptive histk absmax"], records, peak, bnd, extra = \
        train_path("6b adaptive histk absmax", llama_adaptive + [
            "--compressor", "histk", "--density-policy", "absmax",
            "--density-ema", "0.5"],
            {"fused_moments_hist": 12, "compact_stage": 12,
             "compact_resid": 12}, 3, torch,
            leaf_bytes=ADAPTIVE_LEAF_BYTES, bounds=bounds_of(lay))
    out["6b"] = summary(records, peak, extra, bnd)
    del records
    torch.cuda.empty_cache()

    log("phase 6c: uniform, --density-warmup 2 --density-warmup-mult 16 "
        "--global-k-policy normdecay, 3 steps")
    pol = adaptk.make_policy("uniform", warmup_steps=2, warmup_mult=16.0,
                             global_policy="normdecay")
    lay = adaptive_layout(llama, "gaussiank", pol)
    dims = [s.size for s in lay.segments]
    by_path["6c adaptive warmup normdecay"], records, peak, bnd, extra = \
        train_path("6c adaptive warmup normdecay", llama_adaptive + [
            "--density-policy", "uniform", "--density-warmup", "2",
            "--density-warmup-mult", "16", "--global-k-policy",
            "normdecay"], main4, 3, torch,
            leaf_bytes=ADAPTIVE_LEAF_BYTES, bounds=bounds_of(lay))
    budgets = [int(adaptk.budget(dims, RATIO, pol, s)) for s in range(3)]
    ks = [k for _, k in extra["allocs"]]
    # step 0: the controller's first observation is its reference (scale
    # 1); after it the scale lies in [global_floor, 1]
    assert ks[0] == budgets[0], (ks, budgets)
    for k, b in zip(ks, budgets):
        assert math.floor(b * pol.global_floor) <= k <= b, (ks, budgets)
    out["6c"] = summary(records, peak, extra, bnd)
    out["6c"]["budgets"] = budgets
    log(f"  6c: k_total {ks} against the f32 warmup budgets {budgets}")
    del records
    torch.cuda.empty_cache()

    pol = adaptk.make_policy("variance")
    for strategy, mesh_s, layers, per in (("allgather", "4x1", 16, 48),
                                          ("hierarchical", "2x2x1", 4, 96)):
        c = llama if layers == 16 else llama_layers(layers)
        log(f"phase 6d: {strategy}, --mesh {mesh_s}, 4 workers, variance, "
            f"full width with {layers} layers, 2 steps")
        label = f"6d adaptive {strategy} W=4"
        by_path[label], records, peak, bnd, extra = train_path(
            label, llama_adaptive + ["--host-devices", "4", "--mesh",
                                     mesh_s, "--strategy", strategy],
            {n: per for n in MAIN_KERNELS}, 2, torch, workers=4,
            cfg=None if layers == 16 else c,
            levels=2 if strategy == "hierarchical" else 1,
            leaf_bytes=ADAPTIVE_LEAF_BYTES,
            bounds=bounds_of(adaptive_layout(c, "gaussiank", pol)))
        out[label] = summary(records, peak, extra, bnd)
        out[label]["layers"] = layers
        assert peak < 80e9, (label, "peak memory", peak)
        del records
        torch.cuda.empty_cache()

    small = {}
    for name, backend in (("gaussiank", "fused"), ("histk", "fused"),
                          ("topk", "reference")):
        for policy in adaptk.POLICIES:
            comp = CompressionConfig(compressor=name, ratio=0.01,
                                     backend=backend,
                                     density_policy=adaptk.make_policy(
                                         policy))
            got = {}
            for dev in ("cuda", "cpu"):
                params = tree.tree_map(lambda x: x.clone().to(dev), base)
                layout = build_layout(params, 1, comp)
                opt = sgd_momentum(0.9)
                state = init_train_state(params, opt, workers=1,
                                         model_size=1, compression=comp,
                                         layout=layout)
                ks = []
                step = make_train_step(
                    cfg, (1, 1), opt, constant(0.1), compression=comp,
                    layout=layout,
                    probe=lambda rank, **kw: ks.append(kw["k_alloc"])
                    if "k_alloc" in kw else None)
                ls = []
                with tuning.geometry_of("cuda"):
                    for i in range(2):
                        b = lm_batch(i, global_batch=4, seq_len=16,
                                     vocab=cfg.vocab_size, device=dev)
                        state, m = step(state, b)
                        ls.append(float(m["loss"]))
                got[dev] = (ls, ks)
            np.testing.assert_allclose(got["cuda"][0], got["cpu"][0],
                                       rtol=1e-4)
            for a, b in zip(got["cuda"][1], got["cpu"][1]):
                np.testing.assert_array_equal(a, b)
            small[f"{name} {backend} {policy}"] = {
                "cuda": got["cuda"][0], "cpu": got["cpu"][0],
                "k_total": [int(k.sum()) for k in got["cuda"][1]]}
            log(f"phase 6e: {name} ({backend}), {policy}: card "
                f"{got['cuda'][0]} vs CPU {got['cpu'][0]} within rtol "
                "1e-4, allocations equal")
    out["6e"] = small
    return out


# jax.random's answers in its partitionable threefry scheme (jax >= 0.5's
# default), hard-coded: the card's machine has no jax
PRNG_KNOWN = {"split(PRNGKey(0), 3)[1]": (928981903, 3453687069),
              "fold_in(PRNGKey(0), 5)": (1524306142, 1887795613),
              "bits(PRNGKey(42), (4,))": [2098992034, 2919706841,
                                          2646866425, 2409546199],
              "randint(PRNGKey(7), (4,), 0, 262668288)": [
                  10325791, 133713254, 116150652, 246431725],
              "uniform(PRNGKey(0), (3,))": [0.9476670, 0.9785799,
                                            0.3322915]}


def phase7a_prng(torch, rows, timed) -> dict:
    """The ``threefry_bits`` kernel bitwise against its plain version on
    the card (draws and rank keys, 2^26 counters, counts that are not
    multiples of the block, and the main path's two largest leaf rows:
    embed's 262,668,288 and w_gate's 268,435,456), the PRNG's known
    answers drawn on the card, and (``timed``) the kernel's ms at
    268,435,456 draws beside its plain version's and its bound."""
    import numpy as np

    from repro_torch import prng
    from repro_torch.kernels.prng import threefry
    key = prng.fold_in(prng.PRNGKey(0), 7)
    sizes = (1 << 26, (1 << 26) + 77, 1_000_003, 128256 * 2048, BIG_LEAF)
    for n in sizes:
        for dt in (torch.int32, torch.int64):
            out = torch.empty(n, dtype=dt, device="cuda")
            threefry.threefry_bits(key, out)
            plain = threefry.threefry_bits_plain(
                key, 0, n, rank=dt == torch.int64, device="cuda")
            assert torch.equal(out, plain), ("threefry_bits", n, dt)
            del out, plain
    torch.cuda.empty_cache()
    k0 = prng.PRNGKey(0)
    got = {"split(PRNGKey(0), 3)[1]": prng.split(k0, 3)[1],
           "fold_in(PRNGKey(0), 5)": prng.fold_in(k0, 5),
           "bits(PRNGKey(42), (4,))": prng.bits(
               prng.PRNGKey(42), (4,), device="cuda").tolist(),
           "randint(PRNGKey(7), (4,), 0, 262668288)": prng.randint(
               prng.PRNGKey(7), (4,), 0, 262668288, device="cuda").tolist()}
    for name, want in got.items():
        assert want == PRNG_KNOWN[name], (name, want)
    u = prng.uniform(k0, (3,), device="cuda").cpu().numpy()
    np.testing.assert_allclose(u, PRNG_KNOWN["uniform(PRNGKey(0), (3,))"],
                               rtol=0, atol=5e-8)
    log(f"phase 7a: threefry_bits bitwise its plain version at "
        f"{list(sizes)} counters (int32 draws and int64 rank "
        f"keys); the known answers of jax.random equal: {got}, uniform "
        f"{u.tolist()}")
    out = {"known_answers": got}
    if not timed:
        return out
    n = BIG_LEAF
    buf = torch.empty(n, dtype=torch.int32, device="cuda")
    k_ms = time_ms(lambda: threefry.threefry_bits(key, buf), 20)
    keys = torch.empty(n, dtype=torch.int64, device="cuda")
    r_ms = time_ms(lambda: threefry.threefry_bits(key, keys), 20)
    assert torch.equal(keys, threefry.threefry_bits_plain(
        key, 0, n, rank=True, device="cuda")), ("threefry_bits timed", n)
    del keys
    torch.cuda.empty_cache()
    p_ms = time_ms(lambda: threefry.threefry_bits_plain(key, 0, n,
                                                        device="cuda"),
                   3, warmup=1)
    # the timed launches' draws, bitwise the plain version's
    plain = threefry.threefry_bits_plain(key, 0, n, device="cuda")
    assert torch.equal(buf, plain), ("threefry_bits timed", n)
    err = float((plain.long() - buf.long()).abs().max())
    del plain, buf
    torch.cuda.empty_cache()
    t_bytes = 4 * n / HBM_BYTES_PER_S * 1e3
    t_ops = THREEFRY_OPS * n / INT32_OPS_PER_S * 1e3
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")
    rows["threefry_bits"].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                 bound_by=b_by, max_abs_err=err,
                                 library_ms=None, ms_rank_keys=r_ms)
    log(f"  threefry_bits at {n:,} draws: {k_ms:.3f} ms (rank keys "
        f"{r_ms:.3f} ms), plain {p_ms:.1f} ms, bound {b_ms:.3f} ms "
        f"({b_by}: {THREEFRY_OPS} INT32 operations a draw at "
        f"{INT32_OPS_PER_S / 1e12:.1f} T/s; the 1 GiB of writes takes "
        f"{t_bytes:.3f} ms)")
    out.update(ms=k_ms, ms_rank_keys=r_ms, plain_ms=p_ms, bound_ms=b_ms)
    return out


def mc_runner(torch, cfg, compressor, mesh="1x1", workers=1):
    """``runner`` for :func:`train_path`: DGC momentum correction 0.9
    through the library entry points (``CompressionConfig``,
    ``init_train_state``, ``make_train_step``), plain SGD on the server,
    batch 8 x 128 from ``batch_for``."""
    def run(steps, probe):
        from repro_torch.core.compression import CompressionConfig
        from repro_torch.data import batch_for
        from repro_torch.dist.layout import build_layout
        from repro_torch.dist.wire import LocalWire
        from repro_torch.launch.mesh import parse_mesh
        from repro_torch.models import init_params
        from repro_torch.optim import constant, sgd_momentum
        from repro_torch.train import init_train_state, make_train_step
        strategy = "gtopk" if workers > 1 else "allgather"
        comp = CompressionConfig(compressor=compressor, ratio=RATIO,
                                 strategy=strategy, momentum_correction=0.9)
        params = init_params(cfg, 0, "cuda")
        layout = build_layout(params, 1, comp)
        opt = sgd_momentum(0.0)
        state = init_train_state(params, opt, workers=workers, model_size=1,
                                 compression=comp, layout=layout)
        step = make_train_step(cfg, mesh, opt, constant(0.1),
                               compression=comp, layout=layout, probe=probe,
                               wire=LocalWire(parse_mesh(mesh)))
        records = []
        for i in range(steps):
            b = batch_for(cfg, i, global_batch=8, seq_len=128,
                          device="cuda")
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            rec = {"step": i, "ms": (time.perf_counter() - t0) * 1e3}
            rec.update({k: float(v) for k, v in m.items()})
            records.append(rec)
        return records
    return run


def phase7_keyed(torch, by_path, rows, base, cfg) -> dict:
    """Phase 7, slice 4: the PRNG, the key-sampled compressors and DGC
    momentum correction on the card.

    7a. :func:`phase7a_prng`;
    7b. llama3.2-1b at full width and depth, world 1, 4 steps each (step
        0 warms up; 1-3 are the steady ones), with the launch counters set
        to 0 just before each path and read just after: ``randk`` fixed-k
        (12 ``threefry_bits`` a step: one per leaf row) and with the
        arch's ``variance`` policy, ``dgck`` (fixed-k: no dynamic-k path),
        ``rtopk`` fixed-k and ``variance`` (plain torch: no kernel),
        Gaussian-k with momentum correction 0.9 (the reference branch,
        plain torch) and hist-k with momentum correction 0.9 (12 K4d and
        12 K4c a step); step-0 conservation bitwise, under momentum
        correction ``v'`` and ``e'`` zero at every sent index, finite
        losses; step ms, compress ms and peak memory;
    7c. card against CPU on the small config (2 layers, d_model 64), 2
        steps each, the CPU at the card's block geometry: losses within
        rtol 1e-4, the allocations equal; ``randk``'s wire indices
        bitwise every step (its draws do not depend on the values); and
        for every path the card's step-0 compression input replayed
        through ``bucket_compress`` on the CPU with the same key gives
        the card's wire pair and new residual bitwise, under momentum
        correction step 1's too (from the card's ``e`` and ``v`` after
        step 0: the first step where ``mu * v`` is not 0), with ``v'``
        (the gradients themselves differ in the last bits between the
        two devices, which can move a value-dependent selection);
    7d. four workers on the card (``LocalWire``) at full width with 4
        layers, 2 steps: ``randk`` fixed-k over allgather (48
        ``threefry_bits`` a step) and Gaussian-k with momentum correction
        0.9 over gTop-k (``v'`` zero at every sent index, gTop-k's
        conservation across the workers)."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import adaptk
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.compressors import get_compressor
    from repro_torch.data import lm_batch
    from repro_torch.dist import aggregate
    from repro_torch.dist.layout import build_layout
    from repro_torch.kernels.ef_fused import tuning
    from repro_torch.optim import constant, sgd_momentum
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.step import step_keys

    out = {"7a": phase7a_prng(torch, rows, timed=True)}
    llama = get_config("llama3.2-1b")
    pol = adaptk.make_policy("variance")
    base_argv = ["--arch", "llama3.2-1b", "--mesh", "1x1", "--batch", "8",
                 "--seq", "128"]
    fixed = ["--density-policy", "none"]
    draws = {"threefry_bits": 12}
    paths = (   # label, argv or None (MC), expect, compressor, adaptive
        ("7b randk fixed-k", fixed + ["--compressor", "randk"], draws,
         "randk", False),
        ("7b randk variance", ["--compressor", "randk"], draws, "randk",
         True),
        ("7b dgck", ["--compressor", "dgck"], {}, "dgck", False),
        ("7b rtopk fixed-k", fixed + ["--compressor", "rtopk"], {}, "rtopk",
         False),
        ("7b rtopk variance", ["--compressor", "rtopk"], {}, "rtopk", True),
        ("7b gaussiank MC 0.9", None, {}, "gaussiank", False),
        ("7b histk MC 0.9", None, {"abs_histogram": 12,
                                   "threshold_compact": 12}, "histk",
         False))
    for label, argv, expect, name, adaptive in paths:
        log(f"phase {label}: llama3.2-1b at full width and depth, 4 steps")
        bnds = None
        if adaptive:
            lay = adaptive_layout(llama, name, pol)
            bnds = ([s.k_lo for s in lay.segments],
                    [s.k_hi for s in lay.segments])
        by_path[label], records, peak, _, extra = train_path(
            label, base_argv + (argv or []), expect, 4, torch,
            bounds=bnds, runner=None if argv else mc_runner(torch, llama,
                                                            name),
            mc_check="" if argv else "ev")
        steady = [r["ms"] for r in records[1:]]
        out[label] = {"losses": [r["loss"] for r in records],
                      "step_ms": [r["ms"] for r in records],
                      "compress_ms": extra["compress_ms"],
                      "steady_step_ms": statistics.median(steady),
                      "steady_compress_ms": statistics.median(
                          extra["compress_ms"][1:]),
                      "peak_mem_gib": peak / 2**30,
                      "density": [r["density"] for r in records],
                      "density_cap": records[0]["density_cap"]}
        if adaptive:
            out[label]["k_total"] = [r["k_total"] for r in records]
        assert peak < 80e9, (label, "peak memory", peak)
        log(f"  {label}: steady step {out[label]['steady_step_ms']:.1f} ms, "
            f"compress {out[label]['steady_compress_ms']:.1f} ms (medians "
            f"of steps 1-3), peak {peak / 2**30:.2f} GiB")
        del records
        torch.cuda.empty_cache()

    small = {}
    cases = (("randk", None, 0.0), ("randk", "variance", 0.0),
             ("dgck", None, 0.0), ("rtopk", None, 0.0),
             ("rtopk", "variance", 0.0), ("gaussiank", None, 0.9),
             ("histk", None, 0.9))
    for name, policy, mc in cases:
        comp = CompressionConfig(
            compressor=name, ratio=0.01, momentum_correction=mc,
            density_policy=adaptk.make_policy(policy) if policy else None)
        got = {}
        for dev in ("cuda", "cpu"):
            params = tree.tree_map(lambda x: x.clone().to(dev), base)
            layout = build_layout(params, 1, comp)
            opt = sgd_momentum(0.0 if mc else 0.9)
            state = init_train_state(params, opt, workers=1, model_size=1,
                                     compression=comp, layout=layout)
            # per step: the compression's input (G, or u under a policy),
            # its wire pair and e', and the state's residuals after it
            rec = {"idx": [], "alloc": [], "in": [], "out": [], "E": [],
                   "V": []}

            def probe(rank, G=None, u=None, values=None, indices=None,
                      new_E=None, k_alloc=None, rec=rec, **_):
                if k_alloc is not None:
                    rec["alloc"].append(np.asarray(k_alloc).copy())
                if u is not None:
                    rec["in"].append(u.cpu().clone())
                if indices is not None:
                    if G is not None:
                        rec["in"].append(G.cpu().clone())
                    rec["out"].append([x.cpu().clone()
                                       for x in (values, indices, new_E)])
                    rec["idx"].append(indices.cpu().clone())

            step = make_train_step(cfg, (1, 1), opt, constant(0.1),
                                   compression=comp, layout=layout,
                                   probe=probe)
            ls = []
            with tuning.geometry_of("cuda"):
                for i in range(2):
                    b = lm_batch(i, global_batch=4, seq_len=16,
                                 vocab=cfg.vocab_size, device=dev)
                    state, m = step(state, b)
                    ls.append(float(m["loss"]))
                    rec["E"].append(state["resid"].cpu().clone())
                    if mc:
                        rec["V"].append(state["resid2"].cpu().clone())
            got[dev] = (ls, rec, layout)
        label = f"{name} {policy or 'fixed-k'} mc={mc}"
        (lc, rc, _), (lp, rp, lay_cpu) = got["cuda"], got["cpu"]
        np.testing.assert_allclose(lc, lp, rtol=1e-4)
        for a, b in zip(rc["alloc"], rp["alloc"]):
            np.testing.assert_array_equal(a, b)
        if name == "randk":
            for a, b in zip(rc["idx"], rp["idx"]):
                assert torch.equal(a, b), (label, "randk indices")
        # the card's compression input through the CPU's bucket_compress
        # with the same key: step 0, and under momentum correction step 1
        # too, from the card's e and v after step 0 (v is 0 before step 0,
        # so only step 1 exercises mu * v)
        D = lay_cpu.d_row_total
        zeros = torch.zeros((1, D))
        for t in range(2 if mc else 1):
            E = rc["E"][t - 1].view(1, D).clone() if t else zeros.clone()
            V = (rc["V"][t - 1].view(1, D).clone() if t else zeros.clone()
                 ) if mc else None
            with tuning.geometry_of("cuda"):
                if policy:
                    v, i, ne = aggregate.bucket_compress(
                        None, rc["in"][t].view(1, D).clone(), lay_cpu,
                        get_compressor(name), step_keys(0, t, [0])[0],
                        k_alloc=rc["alloc"][t])
                else:
                    v, i, ne = aggregate.bucket_compress(
                        rc["in"][t].view(1, D), E, lay_cpu,
                        get_compressor(name), step_keys(0, t, [0])[0],
                        momentum=mc, V=V)
            for a, b, what in zip((v, i, ne), rc["out"][t],
                                  ("values", "indices", "e'")):
                assert torch.equal(a, b.view(a.shape)), (label, "replay",
                                                         t, what)
            if mc:
                assert torch.equal(V, rc["V"][t].view(1, D)), (
                    label, "replay", t, "v'")
        small[label] = {"cuda": lc, "cpu": lp}
        log(f"phase 7c: {label}: card {lc} vs CPU {lp} within rtol 1e-4; "
            f"the card's step-0 wire pair and e' bitwise the CPU's "
            f"bucket_compress of the same input"
            + (", and step 1's and v' from the card's e and v"
               if mc else "")
            + ("; indices bitwise every step" if name == "randk" else ""))
    out["7c"] = small

    cfg4 = llama_layers(4)
    log("phase 7d: randk fixed-k, --host-devices 4 --mesh 4x1 --strategy "
        "allgather, full width with 4 layers, 2 steps")
    label = "7d randk allgather W=4"
    by_path[label], records, peak, _, extra = train_path(
        label, base_argv + fixed + ["--compressor", "randk",
                                    "--host-devices", "4", "--mesh", "4x1",
                                    "--strategy", "allgather"],
        {"threefry_bits": 48}, 2, torch, workers=4, cfg=cfg4)
    out[label] = {"losses": [r["loss"] for r in records],
                  "step_ms": [r["ms"] for r in records],
                  "compress_ms": extra["compress_ms"],
                  "wire_ms": extra["wire_ms"],
                  "peak_mem_gib": peak / 2**30}
    del records
    torch.cuda.empty_cache()
    log("phase 7d: gaussiank with momentum correction 0.9, 4 workers, "
        "gtopk, full width with 4 layers, 2 steps")
    label = "7d gaussiank MC 0.9 gtopk W=4"
    by_path[label], records, peak, _, extra = train_path(
        label, [], {}, 2, torch, workers=4, cfg=cfg4, global_check=True,
        runner=mc_runner(torch, cfg4, "gaussiank", mesh="4x1", workers=4),
        mc_check="v")
    out[label] = {"losses": [r["loss"] for r in records],
                  "step_ms": [r["ms"] for r in records],
                  "compress_ms": extra["compress_ms"],
                  "wire_ms": extra["wire_ms"],
                  "peak_mem_gib": peak / 2**30,
                  "conservation": extra["conservation"]}
    del records
    torch.cuda.empty_cache()
    return out


PAPER_SIM = (   # phase 8a: (compressor, density policy?) card vs CPU
    ("none", False), ("topk", False), ("gaussiank", False),
    ("randk", False), ("rtopk", False), ("gaussiank", True))
# the wire of these is k a leaf and worker, whatever the data
EXACT_COMM = ("none", "topk", "randk", "rtopk")
# phase 8c: the TPU kernels' counterparts the fig4 benchmark must launch
FIG4_KERNELS = ("fused_moments", "fused_moments_hist", "tree_count",
                "compact_stage", "compact_resid", "moments", "count_gt",
                "threshold_compact", "abs_histogram")


def sim_idle(torch, sim, workers, steps) -> dict:
    """Step ms of the card's simulation (host clock, synchronised) and,
    over one more profiled run, the device's busy ms and idle share."""
    t0 = time.perf_counter()
    sim("gaussiank", workers=workers, ratio=0.005, steps=steps,
        device="cuda")
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sim("gaussiank", workers=workers, ratio=0.005, steps=steps,
            device="cuda")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    from repro_torch.launch.profile import device_kernels
    busy = sum(ms for _, ms, _ in device_kernels(prof))
    return {"workers": workers, "steps": steps, "step_ms": step_ms,
            "profiled_wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall}


def phase8_paper(torch, by_path) -> dict:
    """Phase 8, slice 4b: the paper's experiments on the card.

    8a. ``simulate_sparsified_sgd`` (FNN-3, W = 4, 5 steps, ratio 0.005)
        on the card and on the CPU from the same seed, for ``none``,
        ``topk``, ``gaussiank``, ``randk``, ``rtopk`` and ``gaussiank``
        under ``variance`` with ``normdecay``: losses within rtol 1e-4,
        the wire equal for ``none``/``topk``/``randk``/``rtopk`` and
        within 1% a step for Gaussian-k; then the card's step ms and
        idle share at W = 16 (Fig. 1/6's workers);
    8b. each simulation benchmark's ``run(smoke=True)`` on the card, its
        rows printed; the program invariants enforced (fig5's Theorem 1
        ordering, fig10's ``budget_exact``, rTop-k's ``comm_exact``,
        normdecay never above its twin), the research claims printed;
    8c. the fig4 benchmark at its smoke shapes: K1, K1 with histogram, K2,
        the K3 stage and residual, K4a, K4b, K4c and K4d each launched;
        the pass counts against ``benchmarks/baselines/fig4.json``
        (unfused equal; fused one fewer: the baseline's interpret
        backend adds ``u = g + e`` as a pass of its own).
    """
    import numpy as np

    from repro_torch.benchmarks import common
    from repro_torch.benchmarks import fig4_selection_speed as fig4
    from repro_torch.core import adaptk

    t_start = time.time()
    out = {"8a": {}, "8b": {}}
    vn = adaptk.make_policy("variance", global_policy="normdecay",
                            global_ema=0.5, global_floor=0.25)
    for name, adaptive in PAPER_SIM:
        label = name + (" variance normdecay" if adaptive else "")
        pol = vn if adaptive else None
        res = {}
        for dev in ("cuda", "cpu"):
            def sim(dev=dev):
                return common.simulate_sparsified_sgd(
                    name, workers=4, ratio=0.005, steps=5, seed=0,
                    density_policy=pol, device=dev)
            t0 = time.perf_counter()
            if dev == "cuda":
                by_path[f"8a {label}"], res[dev] = zeroed(sim)
            else:
                res[dev] = sim()
            res[dev + "_s"] = time.perf_counter() - t0
        (lc, _, cc, _), (lh, _, ch, _) = res["cuda"], res["cpu"]
        np.testing.assert_allclose(lc, lh, rtol=1e-4)
        if name in EXACT_COMM:
            assert cc == ch, (label, "comm", cc, ch)
        else:
            for a, b in zip(cc, ch):
                assert abs(a - b) <= 0.01 * b, (label, "comm", cc, ch)
        out["8a"][label] = {"losses_card": lc, "losses_cpu": lh,
                            "comm_card": cc, "comm_cpu": ch,
                            "card_s": res["cuda_s"], "cpu_s": res["cpu_s"]}
        log(f"phase 8a: {label}: card {lc} vs CPU {lh} within rtol 1e-4; "
            f"comm {cc} (CPU {ch}); card {res['cuda_s']:.2f} s, CPU "
            f"{res['cpu_s']:.2f} s; launches "
            f"{ {n: c for n, c in by_path[f'8a {label}'].items() if c} }")
    out["8a_s"] = time.time() - t_start
    t0 = time.time()
    out["8a"]["idle"] = sim_idle(torch, common.simulate_sparsified_sgd, 16,
                                 3)
    out["idle_s"] = time.time() - t0
    log(f"phase 8a: gaussiank W=16 on the card: {out['8a']['idle']} "
        f"({out['idle_s']:.1f} s with the profiler)")
    t8b = time.time()

    import importlib
    for mod in ("fig5_bound", "fig2_histograms", "fig1_fig6_convergence",
                "fig10_sensitivity", "fig_rtopk"):
        t0 = time.time()
        drv = importlib.import_module(f"repro_torch.benchmarks.{mod}")
        by_path[f"8b {mod}"], rows = zeroed(
            lambda: drv.run(smoke=True, device="cuda"))
        wall = time.time() - t0
        for r in rows:
            log("  " + ",".join(str(x) for x in r))
        derived = {r[0]: r[2] for r in rows}
        for row, text in derived.items():
            if row.startswith("fig10/adaptk/") and not row.endswith(
                    "train_variance"):
                assert "budget_exact=True" in text, (row, text)
            if row.startswith("rtopk/ratio="):
                assert "comm_exact=True" in text, (row, text)
            if row == "rtopk/globalk/normdecay":
                assert "never_above_base=True" in text, (row, text)
        out["8b"][mod] = {"rows": rows, "wall_s": wall}
        log(f"phase 8b: {mod} run(smoke=True) on the card in {wall:.1f} s "
            "(invariants held; claims printed above)")

    out["8b_s"] = time.time() - t8b
    t8c = time.time()
    with open(os.path.join(HERE, "benchmarks", "baselines",
                           "fig4.json")) as f:
        base = {(r["shape"], r["method"]): r["passes"]
                for r in json.load(f)["rows"]}
    by_path["8c fig4"], (rows, data) = zeroed(
        lambda: fig4.collect(smoke=True, device="cuda"))
    for r in rows:
        log("  " + ",".join(str(x) for x in r))
    launched = by_path["8c fig4"]
    for n in FIG4_KERNELS:
        assert launched[n] > 0, ("8c fig4", n, launched)
    for r in data["rows"]:
        want = base[(r["shape"], r["method"])]
        if r["method"].endswith("-fused"):
            want -= 1
        assert r["passes"] == want, ("8c passes", r, want)
    out["8c"] = {"rows": rows, "bench": data["rows"]}
    log(f"phase 8c: fig4 smoke launched {launched}; passes "
        f"{[(r['method'], r['passes']) for r in data['rows'][:5]]} "
        "(baseline: unfused equal, fused one more for the interpret "
        "backend's operand add)")
    out["8c_s"] = time.time() - t8c
    out["phase8_s"] = time.time() - t_start
    log(f"phase 8 took {out['phase8_s']:.1f} s (8a {out['8a_s']:.1f}, "
        f"the W=16 profile {out['idle_s']:.1f}, 8b {out['8b_s']:.1f}, 8c "
        f"{out['8c_s']:.1f})")
    return out


def run_steps(torch, cfg, comp, *, perleaf=False, mesh="1x1", steps=3,
              batch=8, seq=128, probe=None, device="cuda", params=None):
    """``steps`` steps of ``cfg`` from ``init_params(cfg, 0)`` (or a copy
    of ``params`` on ``device``) through the library entry points (a
    ``LocalWire`` of the mesh's workers), the bucketed/chunked pipeline
    or the per-leaf loop; returns the records (each with its step ms,
    host clock around a synchronised step), the state and the layout."""
    from repro_torch.data import batch_for
    from repro_torch.dist.layout import build_layout
    from repro_torch.launch.mesh import data_world_size, parse_mesh
    from repro_torch.models import init_params
    from repro_torch.optim import constant, sgd_momentum
    from repro_torch.train import init_train_state, make_train_step
    if params is None:
        params = init_params(cfg, 0, device)
    else:
        from repro_torch import tree
        params = tree.tree_map(lambda x: x.clone().to(device), params)
    layout = build_layout(params, 1, comp)
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt,
                             workers=data_world_size(parse_mesh(mesh)),
                             model_size=1, compression=comp,
                             layout=None if perleaf else layout)
    step = make_train_step(cfg, mesh, opt, constant(0.1), compression=comp,
                           layout=None if perleaf else layout, probe=probe)
    recs = []
    for i in range(steps):
        b = batch_for(cfg, i, global_batch=batch, seq_len=seq,
                      device=device)
        t0 = time.perf_counter()
        state, m = step(state, b)
        if device != "cpu":
            torch.cuda.synchronize()
        rec = {k: float(v) for k, v in m.items()}
        rec["ms"] = (time.perf_counter() - t0) * 1e3
        recs.append(rec)
    return recs, state, layout


def state_equal(torch, a, b, layout) -> None:
    """Two train states bitwise equal on the card: params, momentum,
    ``resid`` and ``resid2`` (a per-leaf residual tree against the flat
    bucket's columns), the controller state."""
    from repro_torch import tree
    for key in ("params", "opt"):
        for x, y in zip(tree.leaves(a[key]), tree.leaves(b[key])):
            assert same_bits(x, y), ("state", key)
    for key in ("resid", "resid2"):
        assert (key in a) == (key in b), key
        if key not in a:
            continue
        x, y = a[key], b[key]
        if not isinstance(x, torch.Tensor):
            x, y = y, x
        if isinstance(y, torch.Tensor):
            assert same_bits(x, y), ("state", key)
            continue
        rows = x.view(x.shape[0], -1)      # (workers, flat), model_size 1
        for s, leaf in zip(layout.segments, tree.leaves(y)):
            assert same_bits(rows[:, s.row_off:s.row_off + s.d_row],
                             leaf), ("state", key, s.name)
    for k in a.get("adaptk", {}):
        assert (a["adaptk"][k] == b["adaptk"][k]).all(), ("adaptk", k)


def release_probe(torch):
    """A probe that records CUDA events at each worker's backward ends
    and at each chunk's hook (``profile.release_fractions`` reads them),
    and each step's allocations; returns ``(probe, events, allocs)``."""
    events, allocs = [], []

    def probe(rank, backward=None, release=None, k_alloc=None, K_eff=None,
              **_):
        if backward is not None or release is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((rank, release if release is not None else
                           "start" if backward else "end", ev))
        if k_alloc is not None:
            allocs.append((list(map(int, k_alloc)), int(K_eff)))
    return probe, events, allocs


def variant_runs(torch, by_path, label, cfg, variants, *, mesh="1x1",
                 steps=3, expect=None, ref_key="chunks 1"):
    """Run each ``(name, comp, perleaf)`` of ``variants`` with the launch
    counters set to 0 just before and read just after (``expect`` a step
    plus the params' draws), the first one the reference the others'
    states must equal bitwise (held on the card meanwhile).  Returns
    ``{name: summary}``."""
    from repro_torch.dist.layout import build_chunk_plan
    from repro_torch.launch.profile import release_fractions
    out, ref = {}, None
    once = {"threefry_bits": init_draws(cfg)}
    for name, comp, perleaf in variants:
        probe, events, allocs = release_probe(torch)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        launches, (recs, state, layout) = drive(
            f"{label} {name}", lambda: run_steps(
                torch, cfg, comp, perleaf=perleaf, mesh=mesh, steps=steps,
                probe=probe), expect, steps, once)
        peak = torch.cuda.max_memory_allocated() - held
        by_path[f"{label} {name}"] = launches
        n = (len(layout.segments) if perleaf else
             build_chunk_plan(layout, comp.chunks).n_chunks)
        torch.cuda.synchronize()
        # the last step's events (as many a step)
        rel = release_fractions(events[len(events) - len(events) // steps:])
        summary = {"losses": [r["loss"] for r in recs],
                   "step_ms": [r["ms"] for r in recs],
                   "peak_gib": peak / 2 ** 30,
                   "collectives_per_step": recs[0]["collectives_per_step"],
                   "dispatches": n, "allocations": len(allocs),
                   "k_total": [r.get("k_total") for r in recs],
                   "release_fractions": {
                       r: {c: round(f, 4) for c, f in v["released"].items()}
                       for r, v in rel.items()},
                   "backward_ms": {r: v["backward_ms"]
                                   for r, v in rel.items()},
                   "wall_s": time.time() - t0}
        if ref is None:
            ref, ref_recs, ref_allocs = state, recs, allocs
            base_coll = recs[0]["collectives_per_step"]
        else:
            state_equal(torch, ref, state, layout)
            for r, q in zip(ref_recs, recs):
                for k in r:
                    if k not in ("ms", "collectives_per_step"):
                        assert r[k] == q[k], (label, name, k, r[k], q[k])
            assert allocs == ref_allocs, (label, name, "allocations")
            del state
        for r in recs:
            assert r["collectives_per_step"] == base_coll * n, (
                label, name, r["collectives_per_step"], n)
        if comp.adaptive:
            assert len(allocs) == steps, (label, name, "allocations")
            for (k, K), r in zip(allocs, recs):
                assert sum(k) == K == r["k_total"], (label, name, K)
        out[name] = summary
        torch.cuda.empty_cache()
        bwd = summary["backward_ms"]
        log(f"  {label} {name}: losses {summary['losses']}; step ms "
            f"{[round(x, 1) for x in summary['step_ms']]}; peak "
            f"{summary['peak_gib']:.2f} GiB; collectives a step "
            f"{summary['collectives_per_step']:.0f}; launches "
            f"{ {k: c for k, c in launches.items() if c} }"
            + ("" if name == ref_key else
               f"; params, momentum, residuals bitwise {ref_key}'s")
            + (f"; release fractions of the backward (last step) "
               f"{summary['release_fractions']}, backward ms "
               f"{ {r: round(v, 1) for r, v in bwd.items()} }"
               if summary["release_fractions"] else ""))
    del ref
    torch.cuda.empty_cache()
    return out


def phase9_chunked(torch, by_path, ref5c, small_cfg, small_base) -> dict:
    """Phase 9, slices 6 and 2b: the chunked schedule and the per-leaf
    loop, each path with the launch counters set to 0 just before it and
    read just after.

    9a. llama3.2-1b at full width and depth (batch 8 x 128, Gaussian-k
        fused at ``RATIO``, world 1), 3 steps each of chunks 1, chunks 4,
        chunks L (one a leaf) and the per-leaf loop: params, momentum and
        residuals bitwise chunks 1's (``torch.equal`` of the int32 views
        on the card), the metrics equal, ``collectives_per_step`` N (or
        L), K1, K2 and both K3 launches 12 a step; step ms, peak GiB and
        each chunk's release as a fraction of the backward's span;
    9b. the same at llama3.2-1b's default ``variance``, chunks 1 and 4:
        one allocation a step, equal, ``sum(k) == K_eff == k_total``, the
        state bitwise;
    9c. four workers on the card (``LocalWire``) at full width with 4
        layers, each strategy bucketed, at chunks 3 and per leaf, 2 steps:
        states bitwise the bucketed run's;
    9d. two processes over ``torch.distributed`` (as 5c: NCCL with two
        cards, else gloo) at chunks 3, allgather and gtopk: sha256 and
        losses equal 5c's ``LocalWire`` (chunks 1) run; whether the
        chunks' gathers ran asynchronously;
    9e. the small config card against CPU (the card's block geometry),
        chunked and per leaf, W = 1 and W = 4 gtopk, losses within rtol
        1e-4;
    9f. ``overlap_schedule.run(smoke=True)`` on the card, its dispatch
        rows against ``benchmarks/baselines/overlap.json``, and fig4's
        dispatch rows against ``benchmarks/baselines/fig4.json``."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import adaptk
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.kernels.ef_fused import tuning
    t_start = time.time()
    out = {}
    cfg = get_config("llama3.2-1b")
    main12 = {n: 12 for n in MAIN_KERNELS}
    fixed = CompressionConfig(ratio=RATIO)
    log("phase 9a: llama3.2-1b at full width and depth, Gaussian-k fused, "
        "world 1, 3 steps each: chunks 1, 4, 12 (one a leaf), per leaf")
    out["9a"] = variant_runs(torch, by_path, "9a", cfg, [
        ("chunks 1", fixed, False),
        ("chunks 4", fixed.replace(chunks=4), False),
        ("chunks 12", fixed.replace(chunks=12), False),
        ("perleaf", fixed, True)], expect=main12)
    out["9a_s"] = time.time() - t_start

    t0 = time.time()
    vpol = adaptk.make_policy(cfg.density_policy)
    var = CompressionConfig(ratio=RATIO, density_policy=vpol)
    log(f"phase 9b: llama3.2-1b's default {cfg.density_policy} at chunks 1 "
        "and 4, 3 steps each")
    out["9b"] = variant_runs(torch, by_path, "9b", cfg, [
        ("chunks 1", var, False), ("chunks 4", var.replace(chunks=4),
                                   False)], expect=main12)
    out["9b_s"] = time.time() - t0

    t0 = time.time()
    cfg4 = llama_layers(4)
    out["9c"] = {}
    for strategy, mesh in (("allgather", "4x1"), ("gtopk", "4x1"),
                           ("hierarchical", "2x2x1"),
                           ("hier_gtopk", "2x2x1")):
        # the two-level strategies compress the pod mean a second time
        levels = 2 if strategy.startswith("hier") else 1
        comp = CompressionConfig(ratio=RATIO, strategy=strategy)
        log(f"phase 9c: {strategy}, --mesh {mesh}, 4 workers, full width "
            "with 4 layers, 2 steps each: bucketed, chunks 3, per leaf")
        out["9c"][strategy] = variant_runs(
            torch, by_path, f"9c {strategy}", cfg4, [
                ("bucketed", comp, False),
                ("chunks 3", comp.replace(chunks=3), False),
                ("perleaf", comp, True)], mesh=mesh, steps=2,
            expect={n: 48 * levels for n in MAIN_KERNELS},
            ref_key="bucketed")
    out["9c_s"] = time.time() - t0

    t0 = time.time()
    cfg2 = llama_layers(2)
    backend, got = pg_ranks(torch, cfg2, chunks=3)
    by_path["9d process group, 2 ranks, chunks 3"] = check_ranks(
        cfg2, backend, got, ref5c)
    async_ops = {s: [got[r][s]["async_ops"] for r in range(2)]
                 for s in PG_STRATEGIES}
    # allgather's three chunk gathers a step are issued asynchronously;
    # gTop-k's rounds exchange pairs with blocking sends and receives
    assert async_ops["allgather"] == [3 * PG_STEPS] * 2, async_ops
    assert async_ops["gtopk"] == [0, 0], async_ops
    ms = {s: [got[r][s]["step_ms"] for r in range(2)] for s in PG_STRATEGIES}
    out["9d"] = {"backend": backend, "async_ops": async_ops,
                 "step_ms": ms,
                 "losses": {s: got[0][s]["losses"] for s in PG_STRATEGIES}}
    out["9d_s"] = time.time() - t0
    log(f"phase 9d: 2 ranks over {backend} at chunks 3: params, momentum, "
        f"each rank's residual (sha256) and losses equal 5c's LocalWire "
        f"chunks-1 run for {', '.join(PG_STRATEGIES)}; asynchronous "
        f"gathers a rank {async_ops} (allgather: yes, 3 a step; gtopk: "
        f"none, its rounds block); step ms by rank "
        f"{ {s: [[round(x, 1) for x in r] for r in v]
             for s, v in ms.items()} }")

    t0 = time.time()
    out["9e"] = {}
    for label, mesh, strategy in (("W=1 gaussiank", "1x1", "allgather"),
                                  ("W=4 gtopk", "4x1", "gtopk")):
        comp = CompressionConfig(ratio=0.01, strategy=strategy)
        for name, c, perleaf in (("chunks 3", comp.replace(chunks=3),
                                  False), ("perleaf", comp, True)):
            ls = {}
            for dev in ("cuda", "cpu"):
                with tuning.geometry_of("cuda"):
                    recs, _, _ = run_steps(
                        torch, small_cfg, c, perleaf=perleaf, mesh=mesh,
                        steps=2, batch=8, seq=16, device=dev,
                        params=small_base)
                ls[dev] = [r["loss"] for r in recs]
            np.testing.assert_allclose(ls["cuda"], ls["cpu"], rtol=1e-4)
            out["9e"][f"{label} {name}"] = ls
            log(f"phase 9e: {label} {name}: card {ls['cuda']} vs CPU "
                f"{ls['cpu']} within rtol 1e-4")
    out["9e_s"] = time.time() - t0

    t0 = time.time()
    from repro_torch.benchmarks import fig4_selection_speed as fig4
    from repro_torch.benchmarks import overlap_schedule
    by_path["9f overlap_schedule"], rows = zeroed(
        lambda: overlap_schedule.run(smoke=True, device="cuda"))
    for r in rows:
        log("  " + ",".join(str(x) for x in r))
    got_rows = {r[0]: r[2] for r in rows}
    for name in ("overlap", "fig4"):
        with open(os.path.join(HERE, "benchmarks", "baselines",
                               f"{name}.json")) as f:
            base = [r for r in json.load(f)["rows"]
                    if r["method"].startswith("dispatch")]
        if name == "fig4":
            drows, _ = fig4._dispatch_rows(torch.device("cuda"))
            got_rows.update({r[0]: r[2] for r in drows})
        for r in base:
            text = got_rows[f"{name}/{r['method']}/{r['shape']}"]
            assert text.startswith(f"collectives={r['passes']}"), (r, text)
    out["9f"] = {"rows": rows}
    out["9f_s"] = time.time() - t0
    log("phase 9f: overlap_schedule run(smoke=True) on the card; its "
        "dispatch rows and fig4's equal the baselines (overlap 1/2/4, "
        "2/4/8, 3/6/12; fig4 per leaf 8 and 16, bucketed 1 and 2)")
    out["phase9_s"] = time.time() - t_start
    log(f"phase 9 took {out['phase9_s']:.1f} s (9a {out['9a_s']:.1f}, 9b "
        f"{out['9b_s']:.1f}, 9c {out['9c_s']:.1f}, 9d {out['9d_s']:.1f}, "
        f"9e {out['9e_s']:.1f}, 9f {out['9f_s']:.1f})")
    return out


# -- phase 10: serving and the weight-delta stream (slice 7) --

SERVE_ARGV = ["--arch", "llama3.2-1b", "--mesh", "1x1", "--requests", "12",
              "--max-batch", "8", "--prompt-len", "64", "--gen", "16"]
STREAM_ARGV = ["--publish-every", "4", "--publish-ratio", "0.01",
               "--resync-every", "3"]


def storage_disjoint(groups) -> None:
    """No storage of one named group of tensors overlaps another's
    (``data_ptr`` ranges of the untyped storages)."""
    spans = []
    for name, ts in groups.items():
        for t in ts:
            s = t.untyped_storage()
            spans.append((s.data_ptr(), s.data_ptr() + s.nbytes(), name))
    spans.sort()
    for i, (a0, a1, na) in enumerate(spans):
        for b0, b1, nb in spans[i + 1:]:
            if b0 >= a1:
                break
            assert na == nb, ("shared storage", na, nb)


def stream_checker(torch, label, counts):
    """A ``probe`` for every publish: ``pub`` equals the packed replica
    bitwise; at a resync the replica equals the trainer bitwise and the
    message is ``M·d_row_total·32`` bits; at a delta ``|pack(trainer) -
    pack(replica) - resid| <= 1e-5`` and the message is the layout's
    ``pair_bits``; trainer, replica, ``pub`` and ``resid`` share no
    storage.  ``counts`` collects the kinds, the largest gap and, per
    publish, the peak memory since the previous probe (the probe's own
    buckets left out: the peak statistics are reset as it returns)."""
    from repro_torch import tree
    from repro_torch.dist.layout import pack_grads
    from repro_torch.serve import RESYNC, message_bits

    def probe(event, msg, layout, state, trainer, replica):
        counts.setdefault("peaks", []).append(
            (msg.kind, torch.cuda.max_memory_allocated()))
        R = pack_grads(layout, replica, torch.float32)
        assert torch.equal(state["pub"], R), (label, "pub", msg.seq)
        if msg.kind == RESYNC:
            for a, b in zip(tree.leaves(replica), tree.leaves(trainer)):
                assert torch.equal(a, b), (label, "resync", msg.seq)
            assert message_bits(msg) == (layout.model_size
                                         * layout.d_row_total * 32)
        else:
            gap = pack_grads(layout, trainer, torch.float32).sub_(R).sub_(
                state["resid"]).abs_().max().item()
            assert gap <= 1e-5, (label, "gap", msg.seq, gap)
            counts["gap"] = max(counts.get("gap", 0.0), gap)
            assert message_bits(msg) == layout.pair_bits()
        del R
        storage_disjoint({"trainer": tree.leaves(trainer),
                          "replica": tree.leaves(replica),
                          "pub": [state["pub"]], "resid": [state["resid"]]})
        counts.setdefault("kinds", []).append(msg.kind)
        torch.cuda.reset_peak_memory_stats()

    return probe


def med(xs):
    return statistics.median(xs) if xs else None


def phase10_serve(torch, by_path) -> dict:
    """Phase 10, slice 7: serving and the train-to-serve weight-delta
    stream, each path with the launch counters set to 0 just before it
    and read just after.

    10a. ``repro_torch.launch.serve.run`` on llama3.2-1b at full width
         and depth (random weights from seed 0), 12 requests in waves of
         8, prompts of 64, up to 16 tokens, ``--publish-every 4
         --publish-ratio 0.01 --resync-every 3``: at every publish
         ``pub`` equals the packed replica bitwise, the replica equals
         the trainer at a resync, the staleness equals the residual
         within 1e-5 at a delta, the message sizes the layout's, and
         trainer, replica, ``pub`` and ``resid`` share no storage; the
         launches are the init's and two ``threefry_bits`` a wave (the
         prompts); prefill, decode-step, publish and apply ms (CUDA
         events, median), peak memory; then unprobed runs frozen
         (``--publish-every 0``) and streaming for their tokens/s;
    10b. ``train.run`` at full width and depth, Gaussian-k fixed-k at
         0.001, ``--publish-every 1 --resync-every 2``, 4 steps: 12
         launches a step of K1, K2 and both K3 (the ``topk`` publisher
         launches none), 2 deltas + 2 resyncs of the layout's bits; the
         checkpoint and resume on the small config on the card: 3 steps
         and a resumed fourth save what 4 straight steps save, bitwise
         (a full-width checkpoint of params, momentum, residual and the
         publisher's two buckets would be ~30 GB);
    10c. a ``gaussiank`` publisher through the library on llama3.2-1b,
         3 ticks (resync, delta, delta): K1, K2 and both K3 launched 12
         times a delta, the invariants of 10a;
    10d. the small config with a sliding-window layer (window 4 below
         the prompt's 8) card against CPU: prefill and decode logits
         within rtol 1e-4, tokens equal; the ``topk`` publisher's and
         (at the card's block geometry) the ``gaussiank`` publisher's
         messages, ``pub`` and ``resid`` bitwise;
    10e. the ``serve_staleness`` driver on the card: its deterministic
         rows equal ``benchmarks/baselines/serve.json``'s."""
    import tempfile

    import numpy as np

    from repro_torch import prng, tree
    from repro_torch.configs import get_config
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.compressors import get_compressor
    from repro_torch.dist.layout import build_layout, rebudget_layout
    from repro_torch.kernels.ef_fused import tuning
    from repro_torch.launch import serve, train
    from repro_torch.models import (ModelConfig, decode_step, init_params,
                                    prefill)
    from repro_torch.serve import apply_message, init_publisher_state, \
        publish
    t_start = time.time()
    out = {}
    cfg = get_config("llama3.2-1b")
    main12 = {n: 12 for n in MAIN_KERNELS}

    log("phase 10a: launch.serve.run on llama3.2-1b at full width and "
        "depth, 12 requests, waves of 8, prompt 64, gen 16, "
        "--publish-every 4 --publish-ratio 0.01 --resync-every 3")
    counts = {}
    torch.cuda.reset_peak_memory_stats()
    launches, got = zeroed(lambda: serve.run(
        SERVE_ARGV + STREAM_ARGV, probe=stream_checker(torch, "10a",
                                                       counts)))
    peak = torch.cuda.max_memory_allocated()
    want = {n: 0 for n in launches}
    want["threefry_bits"] = init_draws(cfg) + 2 * got["waves"]
    assert launches == want, ("10a launches", launches, want)
    by_path["10a serve, topk stream"] = launches
    assert counts["kinds"][0] == 0 and got["resyncs"] >= 2 and \
        got["deltas"] >= 2, counts
    assert got["done"] == 12 and math.isfinite(got["staleness"])
    times = got["times"]
    a = {"prefill_ms": times["prefill"],
         "decode_ms_median": med(times["decode"]),
         "decode_steps": got["decode_steps"],
         "publish_delta_ms": times.get("publish_delta", []),
         "apply_delta_ms": times.get("apply_delta", []),
         "publish_resync_ms": times.get("publish_resync", []),
         "apply_resync_ms": times.get("apply_resync", []),
         "drift_ms_median": med(times.get("drift", [])),
         "deltas": got["deltas"], "resyncs": got["resyncs"],
         "wire_mib": got["wire_mib"], "staleness": got["staleness"],
         "largest_gap": counts.get("gap"),
         # the peak up to each publish's probe, by the message's kind
         "peak_gib_by_publish": [(k, v / 2**30) for k, v in counts["peaks"]],
         "peak_gib": max(peak, *(v for _, v in counts["peaks"])) / 2**30,
         "tok_s_probed": got["tok_s"]}
    del got
    torch.cuda.empty_cache()
    for name, extra in (("frozen", ["--publish-every", "0"]),
                        ("streaming", STREAM_ARGV)):
        torch.cuda.reset_peak_memory_stats()
        run = serve.run(SERVE_ARGV + extra)
        a[f"tok_s_{name}"] = run["tok_s"]
        a[f"seconds_{name}"] = run["seconds"]
        a[f"peak_gib_{name}"] = torch.cuda.max_memory_allocated() / 2**30
        a[f"decode_ms_median_{name}"] = med(run["times"]["decode"])
        del run
        torch.cuda.empty_cache()
    out["10a"] = a
    log(f"  10a: every publish: pub == pack(replica) bitwise, replica == "
        f"trainer at the {a['resyncs']} resyncs, |gap - resid| <= "
        f"{a['largest_gap']:.3g} at the {a['deltas']} deltas, no shared "
        f"storage; launches {launches}; prefill ms "
        f"{[round(x, 2) for x in a['prefill_ms']]}, decode step median "
        f"{a['decode_ms_median']:.3f} ms over {a['decode_steps']} steps, "
        f"publish ms delta {[round(x, 1) for x in a['publish_delta_ms']]} "
        f"resync {[round(x, 1) for x in a['publish_resync_ms']]}, apply ms "
        f"delta {[round(x, 1) for x in a['apply_delta_ms']]} resync "
        f"{[round(x, 1) for x in a['apply_resync_ms']]}; peak "
        f"{a['peak_gib']:.2f} GiB (up to each publish, by kind: "
        f"{[(k, round(v, 2)) for k, v in a['peak_gib_by_publish']]}); "
        f"tokens/s frozen {a['tok_s_frozen']:.1f}"
        f", streaming {a['tok_s_streaming']:.1f} (probed "
        f"{a['tok_s_probed']:.1f}); {a['wire_mib']:.3f} MiB on the wire")
    out["10a_s"] = time.time() - t_start

    t0 = time.time()
    log("phase 10b: train.run at full width and depth, Gaussian-k fixed-k, "
        "--publish-every 1 --resync-every 2, 4 steps")
    meta = init_params(cfg, 0, "meta")
    pub_layout = rebudget_layout(
        build_layout(meta, 1, RATIO, get_compressor("gaussiank")), 0.01,
        get_compressor("topk"))
    by_path["10b train --publish-every 1"], records, peak, _, _ = \
        train_path("10b publish", ["--arch", "llama3.2-1b", "--mesh", "1x1",
                                   "--density-policy", "none", "--batch",
                                   "8", "--seq", "128", "--publish-every",
                                   "1", "--resync-every", "2"],
                   main12, 4, torch)
    kinds = [r["publish_kind"] for r in records]
    bits = [r["publish_bits"] for r in records]
    want_bits = [pub_layout.d_row_total * 32, pub_layout.pair_bits()] * 2
    assert kinds == [0, 1, 0, 1] and bits == want_bits, (kinds, bits)
    mib = sum(bits) / 8 / 2 ** 20
    b = {"losses": [r["loss"] for r in records],
         "step_ms": [r["ms"] for r in records], "peak_gib": peak / 2**30,
         "published_mib": mib}
    del records
    torch.cuda.empty_cache()
    small = ModelConfig(name="sys", arch_type="dense", num_layers=2,
                        d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                        vocab_size=64).validate()
    with tempfile.TemporaryDirectory() as tmp:
        x, ca, cb = (os.path.join(tmp, n) for n in ("x.npz", "a.npz",
                                                    "b.npz"))
        base = ["--arch", "sys", "--mesh", "1x1", "--density-policy",
                "none", "--batch", "4", "--seq", "16", "--publish-every", "1",
                "--resync-every", "2"]
        train.run(base + ["--steps", "4", "--checkpoint", x], cfg=small)
        train.run(base + ["--steps", "3", "--checkpoint", ca], cfg=small)
        recs = train.run(base + ["--steps", "1", "--resume", ca,
                                 "--checkpoint", cb], cfg=small)
        assert [r["publish_kind"] for r in recs] == [1]
        with np.load(x) as s, np.load(cb) as r:
            assert sorted(s.files) == sorted(r.files)
            assert int(r["publish/seq"]) == 4
            for k in s.files:
                assert np.array_equal(s[k], r[k]), ("10b resume", k)
    log(f"  10b: K1, K2 and both K3 12 a step; published 2 deltas + 2 "
        f"resyncs ({mib:.3f} MiB, the layout's); steps ms "
        f"{[round(v, 1) for v in b['step_ms']]}; peak {b['peak_gib']:.2f} "
        f"GiB; small config on the card: 3 steps + a resumed fourth save "
        f"what 4 straight steps save, publish/ included, bitwise")
    out["10b"] = b
    out["10b_s"] = time.time() - t0

    t0 = time.time()
    log("phase 10c: a gaussiank publisher through the library on "
        "llama3.2-1b, 3 ticks (resync, delta, delta)")
    trainer = init_params(cfg, 0, "cuda")
    config = CompressionConfig(compressor="gaussiank", ratio=0.01)
    layout = build_layout(trainer, 1, config)
    counts = {}
    check = stream_checker(torch, "10c", counts)

    def ticks():
        nonlocal trainer
        state = init_publisher_state(layout)
        replica = tree.tree_map(torch.clone, trainer)
        per, ms = [], []
        for t in range(3):
            trainer = serve.drift(trainer, 4 * t)
            before = {n: f.launches for n, f in counters().items()}
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            state, msg = publish(state, trainer, layout, config,
                                 prng.PRNGKey(5), resync_every=3)
            ev[1].record()
            replica = apply_message(replica, layout, msg)
            ev[2].record()
            per.append({n: f.launches - before[n]
                        for n, f in counters().items()})
            check("publish", msg, layout, state, trainer, replica)
            ms.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
        return per, ms

    launches, (per, ms) = zeroed(ticks)
    by_path["10c gaussiank publisher"] = launches
    assert counts["kinds"] == [0, 1, 1], counts
    assert per[0] == {n: 0 for n in per[0]}, per[0]
    for p in per[1:]:
        assert p == {n: main12.get(n, 0) for n in p}, p
    del trainer
    torch.cuda.empty_cache()
    out["10c"] = {"publish_ms": [m[0] for m in ms],
                  "apply_ms": [m[1] for m in ms],
                  "largest_gap": counts["gap"]}
    log(f"  10c: launches a tick {per}; publish ms "
        f"{[round(m[0], 1) for m in ms]}, apply ms "
        f"{[round(m[1], 1) for m in ms]}; the invariants of 10a hold "
        f"(largest gap {counts['gap']:.3g})")
    out["10c_s"] = time.time() - t0

    t0 = time.time()
    sw = ModelConfig(name="sw", arch_type="dense", num_layers=2, d_model=64,
                     num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
                     block_pattern=("swa", "attn"),
                     sliding_window=4).validate()
    base = init_params(sw, 0, "cpu")
    prompt = prng.randint(prng.PRNGKey(4), (2, 8), 0, 64, device="cpu")
    res = {}
    for dev in ("cuda", "cpu"):
        p = tree.tree_map(lambda v: v.to(dev), base)
        logits, cache, _ = prefill(p, sw, prompt.to(dev), s_max=16)
        ls, toks = [logits.cpu()], []
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        for pos in range(8, 16):
            toks.append(tok.cpu())
            logits, cache = decode_step(p, sw, cache, pos, tok)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            ls.append(logits.cpu())
        res[dev] = (torch.stack(ls), torch.cat(toks, dim=1))
    np.testing.assert_allclose(res["cuda"][0].numpy(), res["cpu"][0].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert torch.equal(res["cuda"][1], res["cpu"][1])
    err = float((res["cuda"][0] - res["cpu"][0]).abs().max())
    for name, backend in (("topk", "auto"), ("gaussiank", "fused")):
        comp = CompressionConfig(compressor=name, ratio=0.01,
                                 backend=backend)
        lay = build_layout(base, 1, comp)
        st = {d: init_publisher_state(lay, device=d)
              for d in ("cuda", "cpu")}
        cur = base
        with tuning.geometry_of("cuda"):
            for t in range(6):
                cur = tree.tree_map(
                    lambda v: v + 0.01 * torch.sin(v * float(t + 1)), cur)
                msgs = {}
                for d in ("cuda", "cpu"):
                    st[d], msgs[d] = publish(
                        st[d], tree.tree_map(lambda v: v.to(d), cur), lay,
                        comp, prng.PRNGKey(7), resync_every=4)
                assert msgs["cuda"].kind == msgs["cpu"].kind, (name, t)
                for u, w in zip(msgs["cuda"][2:], msgs["cpu"][2:]):
                    assert (u is None) == (w is None), (name, t)
                    if u is not None:
                        assert torch.equal(u.cpu(), w), (name, t)
                for k in ("pub", "resid"):
                    assert torch.equal(st["cuda"][k].cpu(), st["cpu"][k]), (
                        name, t, k)
    out["10d"] = {"max_abs_logit_err": err}
    log(f"phase 10d: small config with an swa ring (window 4, prompt 8) "
        f"card vs CPU: prefill + 8 decode logits within rtol 1e-4 (largest "
        f"difference {err:.3g}), tokens equal; the topk and gaussiank "
        f"(card geometry) publishers' messages, pub and resid bitwise over "
        f"6 ticks")
    out["10d_s"] = time.time() - t0

    t0 = time.time()
    from repro_torch.benchmarks import serve_staleness as sv
    by_path["10e serve_staleness"], (rows, data) = zeroed(
        lambda: sv.collect(smoke=True, device="cuda"))
    with open(os.path.join(HERE, "benchmarks", "baselines",
                           "serve.json")) as f:
        base_rows = json.load(f)["rows"]
    got_rows = {(r["shape"], r["method"]): r["passes"] for r in data["rows"]}
    for r in base_rows:
        assert got_rows[(r["shape"], r["method"])] == r["passes"], r
    out["10e"] = {"rows": rows}
    log("phase 10e: serve_staleness on the card; its rows equal the "
        "baseline's (delta wire 768/768/2944 bits, resync-exact 1, "
        "gap-vs-resid 1, 32 tokens each way): "
        + "; ".join(f"{r[0]} {r[2]}" for r in rows))
    out["10e_s"] = time.time() - t0
    out["phase10_s"] = time.time() - t_start
    log(f"phase 10 took {out['phase10_s']:.1f} s (10a {out['10a_s']:.1f}, "
        f"10b {out['10b_s']:.1f}, 10c {out['10c_s']:.1f}, 10d "
        f"{out['10d_s']:.1f}, 10e {out['10e_s']:.1f})")
    return out


# the configs of phase 11 at full width: (arch, num_layers kept or None
# for the whole model, train steps)
ARCH_PATHS = (("deepseek-moe-16b", 2, 3), ("jamba-1.5-large-398b", 1, 2),
              ("musicgen-medium", None, 3), ("xlstm-125m", None, 3))
SMOKE_ARCHS = ("deepseek-moe-16b", "phi3.5-moe-42b-a6.6b",
               "jamba-1.5-large-398b", "xlstm-125m", "musicgen-medium")


def full_width(arch, layers):
    """``arch``'s config at full width, ``num_layers`` cut to ``layers``
    (None: the whole model)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers).validate()
    return cfg


def phase11a_huge_leaf(torch, rows) -> dict:
    """11a: K1, K2 and both K3 launches at d = ``HUGE_LEAF`` (jamba's
    ``embed``, the largest leaf the kernels meet) against their plain
    versions on the card — counts, staging and residual bitwise, the
    moments within tolerance, the pipeline conserving — then each timed
    with CUDA events beside its plain version and its bound; the times go
    into the kernel rows as ``*_536m``."""
    from repro_torch.core import codec
    from repro_torch.core.compressors import gaussiank_cap
    from repro_torch.kernels.ef_fused import compact_residual as cr
    from repro_torch.kernels.ef_fused import fused_moments as fm
    from repro_torch.kernels.ef_fused import ops, tuning
    from repro_torch.kernels.ef_fused import tree_count as tc

    d = HUGE_LEAF
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    g = torch.randn(d, generator=gen, device="cuda").mul_(1e-3)
    e = torch.randn(d, generator=gen, device="cuda").mul_(5e-4)
    k = math.ceil(RATIO * d)
    cfg = tuning.resolve_config(d, "cuda")
    sb, block = cfg.stats_block, cfg.block
    k_cap = gaussiank_cap(k, d)
    bcap = ops.fused_default_bcap(k_cap, d, block, cfg.bcap_slack)
    nb, nbs = -(-d // block), -(-d // sb)

    s, sq, mx = fm.fused_moments(g, e, block=sb)
    ps, psq, pmx = fm.fused_moments_plain(g, e, block=sb)
    sum_abs = float((g + e).abs().double().sum())
    k1_err = check_moments(d, "K1", (s, sq, mx), (ps, psq, pmx), sum_abs)
    t0 = ops.gaussian_t0(ps, psq, d, k, False)
    heap, n_cnt = ops._tree_thresholds(t0, 4)
    thr = torch.from_numpy(heap[:n_cnt]).cuda()
    cnt_k = tc.tree_count(g, e, thr, block=sb)
    assert torch.equal(cnt_k, tc.tree_count_plain(g, e, thr, block=sb)), (
        d, "K2")
    thres = float(ops._replay_refinement(heap, cnt_k.cpu().numpy(), k, 4))
    vk, ok, ck = cr.compact_stage(g, e, thres, block=block, bcap=bcap)
    vp, op, cp = cr.compact_stage_plain(g, e, thres, block=block, bcap=bcap)
    assert torch.equal(ck, cp) and torch.equal(ok, op), (d, "K3 stage")
    assert same_bits(vk, vp), (d, "K3 staged values")
    del vp, op
    enc = cr.exclusive_enc(cp, bcap)
    rk = cr.compact_resid(g, e, thres, enc, block=block, bcap=bcap,
                          k_cap=k_cap)
    rp = cr.compact_resid_plain(g, e, thres, enc, block=block, bcap=bcap,
                                k_cap=k_cap)
    assert same_bits(rk, rp), (d, "K3 residual")
    del rk, rp
    v, i, ne = ops.fused_compress_ef(g, e, "gaussiank", k)
    assert torch.equal(codec.decode(v, i, d) + ne, g + e), (d, "conserve")
    nnz = int(codec.nnz(i))
    del v, i, ne
    torch.cuda.empty_cache()
    log(f"  d={d:,}: K1 max error {k1_err:.3g}, absmax exact; K2 counts "
        f"exact {cnt_k.tolist()[:3]}...; K3 staging + residual bitwise "
        f"(block {block}, bcap {bcap}, {int(ck.sum())} over threshold "
        f"{thres:.6g}); pipeline conserves bitwise, {nnz}/{k_cap} slots")

    out = torch.empty_like(g)
    ms = {
        "fused_moments": (lambda: fm.fused_moments(g, e, block=sb),
                          lambda: fm.fused_moments_plain(g, e, block=sb)),
        "tree_count": (lambda: tc.tree_count(g, e, thr, block=sb),
                       lambda: tc.tree_count_plain(g, e, thr, block=sb)),
        "compact_stage": (
            lambda: cr.compact_stage(g, e, thres, block=block, bcap=bcap),
            lambda: cr.compact_stage_plain(g, e, thres, block=block,
                                           bcap=bcap)),
        "compact_resid": (
            lambda: cr.compact_resid(g, e, thres, enc, block=block,
                                     bcap=bcap, k_cap=k_cap, out=out),
            lambda: cr.compact_resid_plain(g, e, thres, enc, block=block,
                                           bcap=bcap, k_cap=k_cap)),
    }
    ms = {n: (time_ms(a, 10), time_ms(b, 3)) for n, (a, b) in ms.items()}
    nt = thr.numel()
    work = {"fused_moments": (8 * d + 12, 5 * d),
            "tree_count": (8 * d + 8 * nt, 17 * d),
            "compact_stage": (8 * d + 8 * nb * bcap + 4 * nb, 3 * d),
            "compact_resid": (12 * d + 8 * nb, 3 * d)}
    res = {}
    for name, (k_ms, p_ms) in ms.items():
        b_ms, b_by = bound(*work[name])
        res[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
        rows[name].update(ms_536m=k_ms, plain_ms_536m=p_ms,
                          bound_ms_536m=b_ms, d_536m=d)
    rows["fused_moments"]["max_abs_err_536m"] = k1_err
    log(f"  times at d={d:,} (ms, median): " + ", ".join(
        f"{n} {r['ms']:.4f} (plain {r['plain_ms']:.3f}, bound "
        f"{r['bound_ms']:.4f})" for n, r in res.items()))
    del g, e, out
    torch.cuda.empty_cache()
    return {"d": d, "k": k, "nnz": nnz, "k1_max_err": k1_err,
            "kernels": res}


def phase11_archs(torch, by_path, rows) -> dict:
    """Phase 11, slice 8: the MoE, Mamba-hybrid and xLSTM blocks and the
    ``embeds`` frontend, each path with the launch counters set to 0
    just before it and read just after.

    11a. K1, K2 and both K3 launches at d = 536,870,912 against their
         plain versions, timed (``phase11a_huge_leaf``);
    11b. ``launch.train.run`` at full width, Gaussian-k fused at 0.001
         (the CLI's default), world 1, batch 8 x 128: deepseek-moe-16b
         with 2 layers, jamba-1.5-large with 1 (layer 0: Mamba + MLP),
         musicgen-medium and xlstm-125m whole, 3 steps each (2 for
         jamba); one K1, K2, K3 stage and K3 residual launch a leaf a
         step (and an ``embeds`` batch's three draws a step); step ms and
         the compression's ms within it (CUDA events around
         ``bucket_compress``), losses, peak memory;
    11c. ``launch.serve.run`` on the same four configs: 8 sequences,
         prompt 64, up to 8 new tokens (KV, Mamba and xLSTM caches,
         musicgen's embeddings prompt); prefill ms, decode ms a step,
         peak memory; the launches the params' and the prompts' draws;
    11d. card against CPU on the smoke variants of deepseek-moe-16b,
         phi3.5-moe, jamba-1.5-large (Mamba, attention, MLP and MoE
         layers), xlstm-125m and musicgen-medium: 2 train steps each
         (the CPU at the card's block geometry), losses within rtol
         1e-4; prefill and 4 decode steps, logits within rtol 1e-5
         (atol 1e-5), the greedy tokens equal; jamba-smoke at chunks 3
         and per leaf bitwise its bucketed run on the card."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data import batch_for
    from repro_torch.kernels.ef_fused import tuning
    from repro_torch.launch import serve, train
    from repro_torch.models import decode_step, init_params, prefill
    t_start = time.time()
    out = {}

    log(f"phase 11a: K1, K2 and both K3 launches at d={HUGE_LEAF:,} (jamba "
        "embed) against their plain versions")
    out["11a"] = phase11a_huge_leaf(torch, rows)
    out["11a_s"] = time.time() - t_start

    t0 = time.time()
    out["11b"] = {}
    for arch, layers, steps in ARCH_PATHS:
        cfg = full_width(arch, layers)
        n_leaves = len(tree.leaves(init_params(cfg, 0, "meta")))
        label = f"11b {arch}" + (f" ({layers} layers)" if layers else "")
        log(f"phase {label}: train.run at full width, Gaussian-k fused, "
            f"{steps} steps of 8 x 128, {n_leaves} leaves")
        expect = {n: n_leaves for n in MAIN_KERNELS}
        if batch_draws(cfg):
            expect["threefry_bits"] = batch_draws(cfg)
        torch.cuda.reset_peak_memory_stats()
        timer = CompressTimer(torch)
        with timer:
            launches, recs = drive(
                label, lambda: train.run(
                    ["--arch", arch, "--mesh", "1x1", "--batch", "8",
                     "--seq", "128", "--steps", str(steps), "--log-every",
                     "1"], cfg=cfg),
                expect, steps, {"threefry_bits": init_draws(cfg)})
        peak = torch.cuda.max_memory_allocated()
        compress_ms = timer.per_step(steps)
        by_path[label] = launches
        losses = [r["loss"] for r in recs]
        assert all(math.isfinite(x) for x in losses), (label, losses)
        for r in recs:
            assert 0 < r["density"] <= r["density_cap"], (label, r)
        out["11b"][arch] = {
            "num_layers": cfg.num_layers, "leaves": n_leaves,
            "params": sum(math.prod(x.shape) for x in tree.leaves(
                init_params(cfg, 0, "meta"))),
            "losses": losses, "step_ms": [r["ms"] for r in recs],
            "compress_ms": compress_ms, "peak_gib": peak / 2 ** 30,
            "launches": launches}
        log(f"  {label}: losses {losses}; step ms "
            f"{[round(r['ms'], 1) for r in recs]} (compression "
            f"{[round(x, 1) for x in compress_ms]}); peak {peak / 2**30:.2f} "
            f"GiB; launches {({n: c for n, c in launches.items() if c})}")
        del recs
        torch.cuda.empty_cache()
    out["11b_s"] = time.time() - t0

    t0 = time.time()
    out["11c"] = {}
    for arch, layers, _ in ARCH_PATHS:
        cfg = full_width(arch, layers)
        label = f"11c {arch}"
        log(f"phase {label}: serve.run at full width, 8 sequences, prompt "
            "64, up to 8 new tokens")
        prompt_draws = 1 if cfg.frontend == "embeds" else 2
        torch.cuda.reset_peak_memory_stats()
        launches, got = zeroed(lambda: serve.run(
            ["--arch", arch, "--mesh", "1x1", "--requests", "8",
             "--max-batch", "8", "--prompt-len", "64", "--gen", "8"],
            cfg=cfg))
        peak = torch.cuda.max_memory_allocated()
        want = {n: 0 for n in launches}
        want["threefry_bits"] = init_draws(cfg) + prompt_draws * got["waves"]
        assert launches == want, (label, launches, want)
        by_path[label] = launches
        assert got["done"] == 8 and got["waves"] == 1, (label, got)
        toks = got["tokens"][0]
        assert toks.shape[0] == 8 and bool((toks >= 0).all()) and bool(
            (toks < cfg.vocab_size).all()), (label, toks)
        times = got["times"]
        out["11c"][arch] = {"prefill_ms": times["prefill"],
                            "decode_ms_median": med(times["decode"]),
                            "decode_steps": got["decode_steps"],
                            "tok_s": got["tok_s"],
                            "peak_gib": peak / 2 ** 30}
        log(f"  {label}: prefill ms {[round(x, 2) for x in times['prefill']]}"
            f", decode step median {med(times['decode']):.3f} ms over "
            f"{got['decode_steps']} steps, {got['tok_s']:.1f} tok/s; peak "
            f"{peak / 2**30:.2f} GiB; tokens {toks[:2].tolist()}")
        del got
        torch.cuda.empty_cache()
    out["11c_s"] = time.time() - t0

    t0 = time.time()
    out["11d"] = {}
    comp = CompressionConfig(compressor="gaussiank", ratio=0.01)
    for arch in SMOKE_ARCHS:
        cfg = get_config(arch).reduced()
        base = init_params(cfg, 0, "cpu")
        losses = {}
        for dev in ("cuda", "cpu"):
            # the CPU run takes the card's block geometry: both stage alike
            with tuning.geometry_of("cuda"):
                launches, (recs, _, _) = zeroed(lambda: run_steps(
                    torch, cfg, comp, steps=2, batch=4, seq=16, device=dev,
                    params=base))
            if dev == "cuda":
                by_path[f"11d {arch} train"] = launches
            losses[dev] = [r["loss"] for r in recs]
        np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)

        kw = "embeds" if cfg.frontend == "embeds" else "tokens"
        prompt = batch_for(cfg, 0, global_batch=2, seq_len=8,
                           device="cpu")[kw]
        logits, caches, toks = {}, {}, {}
        for dev in ("cuda", "cpu"):
            params = tree.tree_map(lambda x: x.to(dev), base)
            lg, caches[dev], _ = prefill(params, cfg, s_max=12,
                                         **{kw: prompt.to(dev)})
            logits[dev], toks[dev] = [lg.cpu()], []
            for pos in range(8, 12):
                tok = torch.argmax(lg[:, -1], dim=-1)[:, None]
                toks[dev].append(tok.cpu())
                lg, _ = decode_step(params, cfg, caches[dev], pos, tok)
                logits[dev].append(lg.cpu())
        err = 0.0
        for a, b in zip(logits["cuda"], logits["cpu"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)
            err = max(err, float((a - b).abs().max()))
        for a, b in zip(toks["cuda"], toks["cpu"]):
            assert torch.equal(a, b), (arch, "tokens")
        out["11d"][arch] = {"losses": losses, "max_abs_logit_err": err}
        log(f"phase 11d {cfg.name}: card {losses['cuda']} vs CPU "
            f"{losses['cpu']} within rtol 1e-4; prefill + 4 decode logits "
            f"within rtol 1e-5, atol 1e-5 (largest difference {err:.3g}), "
            f"greedy tokens equal")
        del caches

    cfg = get_config("jamba-1.5-large-398b").reduced()
    n_leaves = len(tree.leaves(init_params(cfg, 0, "meta")))
    comp = CompressionConfig(ratio=RATIO)
    out["11d"]["jamba chunks"] = variant_runs(
        torch, by_path, "11d jamba-smoke", cfg,
        [("chunks 1", comp, False),
         ("chunks 3", CompressionConfig(ratio=RATIO, chunks=3), False),
         ("per leaf", comp, True)],
        steps=2, expect={n: n_leaves for n in MAIN_KERNELS})
    out["11d_s"] = time.time() - t0
    out["phase11_s"] = time.time() - t_start
    log(f"phase 11 took {out['phase11_s']:.1f} s (11a {out['11a_s']:.1f}, "
        f"11b {out['11b_s']:.1f}, 11c {out['11c_s']:.1f}, 11d "
        f"{out['11d_s']:.1f})")
    return out


TP_STEPS = 3


def tp_shared_gradient(torch, rank, backend, port) -> dict:
    """12b's check of the relayout and of the row's compression at full
    width, in a process group of its own on ``port``: one shared random
    gradient of llama3.2-1b (drawn alike on both ranks from one seed)
    cut to this rank's shards and moved into its row by ``ModelRow``,
    held against the one-process ``(2, d_row_total)`` bucket bitwise:
    the row equal to the bucket's row ``rank``, the bucket's row moved
    back equal to the shards, and ``bucket_compress`` of the row (K1-K3)
    equal to the whole bucket's row ``rank`` in values, indices, ``e'``
    and nnz.  Returns the relayout's ms each way and the row's nnz."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core import codec
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.dist import aggregate
    from repro_torch.dist import tensor_parallel as tpm
    from repro_torch.dist.layout import build_layout, pack_grads
    from repro_torch.dist.wire import ProcessGroupWire, init_process_group
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models import init_params

    os.environ["MASTER_PORT"] = str(port)
    init_process_group(backend, rank=rank, world_size=2, local_rank=rank,
                       local_world_size=2)
    try:
        cfg = get_config("llama3.2-1b")
        meta = init_params(cfg, 0, "meta")
        tp = tpm.TensorParallel(cfg, ProcessGroupWire(parse_mesh("1x2")),
                                meta)
        M, r = tp.axis.size, tp.axis.rank
        comp = CompressionConfig(compressor="gaussiank", ratio=RATIO)
        layout = build_layout(meta, M, comp)
        dev = torch.device("cuda", torch.cuda.current_device())
        gen = torch.Generator(device=dev)
        gen.manual_seed(29)
        grads = [torch.randn(p.shape, generator=gen, device=dev).mul_(1e-3)
                 for p in tree.leaves(meta)]
        full = pack_grads(layout, grads, torch.float32)
        local = [tpm.shard(g, s, r, M) for g, s in zip(grads, tp.specs)]
        del grads
        rows = tp.rows(layout)
        ev = [torch.cuda.Event(enable_timing=True) for _ in "abc"]
        ev[0].record()
        mine = rows.pack(layout, 0, local, torch.float32)
        ev[1].record()
        back = rows.unpack(layout, 0, full[r:r + 1], local)
        ev[2].record()
        assert torch.equal(mine[0], full[r]), "relayout into the row"
        for a, b, seg in zip(back, local, layout.segments):
            assert torch.equal(a, b), ("relayout back", seg.name)
        del back
        E = torch.randn((M, layout.d_row_total), generator=gen,
                        device=dev).mul_(5e-4)
        E_row = E[r:r + 1].clone()
        want = aggregate.bucket_compress(full, E, layout, comp.spec)
        got = aggregate.bucket_compress(mine, E_row, layout, comp.spec,
                                        row=r)
        for a, b, what in zip(got, want, ("values", "indices", "e'")):
            assert torch.equal(a[0], b[r]), ("row compression", what)
        nnz = codec.nnz(got[1]).float()
        assert torch.equal(rows.total(nnz), codec.nnz(want[1]).float()), \
            "nnz over the model group"
        torch.cuda.synchronize()
        return {"pack_ms": ev[0].elapsed_time(ev[1]),
                "unpack_ms": ev[1].elapsed_time(ev[2]), "nnz": int(nnz)}
    finally:
        torch.distributed.destroy_process_group()


def tp_child(rank, world, backend, port, argv, check_port, queue):
    """Phase 12b, one rank of the tensor-parallel launch: ``train.run``
    under a ``torchrun``-style environment (``argv`` at ``--mesh 1x2``),
    its launches counted from 0, the relayout's ms a step (CUDA events
    around ``ModelRow.pack`` and ``ModelRow.unpack``) and its peak
    memory; then :func:`tp_shared_gradient` on ``check_port``; puts
    ``(rank, results)`` on ``queue``."""
    import traceback
    try:
        sys.path.insert(0, os.path.join(HERE, "src"))
        import torch
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        from repro_torch.dist import tensor_parallel as tpm
        from repro_torch.launch import train
        events = {"pack": [], "unpack": []}
        origs = {n: getattr(tpm.ModelRow, n) for n in events}

        def timed(name):
            def call(self, *a, **k):
                ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
                ev[0].record()
                out = origs[name](self, *a, **k)
                ev[1].record()
                events[name].append(ev)
                return out
            return call

        for n in events:
            setattr(tpm.ModelRow, n, timed(n))
        if backend == "nccl":
            torch.cuda.set_device(rank)
        funcs = counters()
        for f in funcs.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        try:
            recs = train.run(argv + ["--steps", str(TP_STEPS),
                                     "--dist-backend", backend])
        finally:
            for n, f in origs.items():
                setattr(tpm.ModelRow, n, f)
        torch.cuda.synchronize()
        launches = {n: f.launches for n, f in funcs.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms = {n: [a.elapsed_time(b) for a, b in ev]
              for n, ev in events.items()}
        shared = tp_shared_gradient(torch, rank, backend, check_port)
        queue.put((rank, {
            "losses": [r["loss"] for r in recs],
            "step_ms": [r["ms"] for r in recs],
            "density": [r["density"] for r in recs],
            "density_cap": recs[0]["density_cap"],
            "launches": launches,
            "pack_ms": ms["pack"], "unpack_ms": ms["unpack"],
            "peak_gib": peak, "shared_gradient": shared,
            "device": torch.cuda.current_device()}))
    except BaseException:  # noqa: BLE001 — reported to the parent
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def phase12_model_axis(torch, by_path, llama) -> dict:
    """Slice 2c, the model axis, each path with the launch counters set
    to 0 just before it and read just after (:func:`phase12a`,
    :func:`phase12b`):

    12a. ``train.run`` at ``--mesh 4x2 --host-devices 8`` (the
         reference's default mesh, in this process) on llama3.2-1b at
         full width and depth, Gaussian-k fixed-k at 0.001, 8 x 128, 3
         steps: 96 launches a step of K1, K2 and both K3 (4 workers x 12
         leaves x 2 rows), every worker's step-0 ``(2, d_row_total)``
         bucket conserving bitwise; step ms and peak memory;
    12b. the tensor-parallel step at ``--mesh 1x2``: two processes
         (``tp_child``; NCCL with a card each when two are visible, else
         gloo on the one card, staged through host memory), each holding
         its half of every split leaf, 3 steps: 12 launches a step of
         each kernel a rank (one a row a leaf), the losses those of the
         one-process ``--mesh 1x2`` run within rtol 1e-6 (run first,
         24 launches a step); step ms, the relayout's ms (shards into
         the row and the mean row back) and each rank's peak memory;
         then, on one shared random gradient at full width, the
         relayout both ways and the row's compression bitwise the
         one-process bucket's row (:func:`tp_shared_gradient`)."""
    return {"12a": phase12a(torch, by_path, llama),
            "12b": phase12b(torch, by_path, llama)}


def phase12a(torch, by_path, llama) -> dict:
    """12a of :func:`phase12_model_axis`."""
    label = "12a mesh 4x2"
    log("phase 12a: llama3.2-1b at full width and depth, --mesh 4x2 in "
        "this process (--host-devices 8), Gaussian-k fixed-k, 3 steps")
    by_path[label], records, peak, bnd, extra = train_path(
        label, llama + ["--host-devices", "8", "--mesh", "4x2"],
        {n: 96 for n in MAIN_KERNELS}, 3, torch, workers=4)
    assert peak < 80e9, (label, "peak memory", peak)
    out = {"losses": [r["loss"] for r in records],
           "step_ms": [r["ms"] for r in records],
           "wire_ms": extra["wire_ms"],
           "compress_ms": extra["compress_ms"],
           "peak_mem_gib": peak / 2**30,
           "density": [r["density"] for r in records],
           "density_cap": records[0]["density_cap"],
           "step_bound_ms": bnd}
    del records
    torch.cuda.empty_cache()
    return out


def phase12b(torch, by_path, llama) -> dict:
    """12b of :func:`phase12_model_axis`."""
    import numpy as np
    label = "12b one process, mesh 1x2"
    log("phase 12b: the one-process --mesh 1x2 run the tensor-parallel "
        "ranks are held to, 3 steps")
    by_path[label], records, peak1, _, _ = train_path(
        label, llama + ["--host-devices", "2", "--mesh", "1x2"],
        {n: 24 for n in MAIN_KERNELS}, TP_STEPS, torch)
    ref = [r["loss"] for r in records]
    del records
    torch.cuda.empty_cache()
    log("phase 12b: the tensor-parallel step, --mesh 1x2 in 2 processes, "
        "full width and depth, 3 steps")
    from repro_torch.configs import get_config
    argv = llama + ["--mesh", "1x2", "--log-every", "1"]
    t0 = time.time()
    check_port = []

    def args_of(backend, port):
        # one port for both ranks' check group, not the launch's
        while not check_port or check_port[0] == port:
            check_port[:] = [free_port()]
        return argv, check_port[0]

    backend, got = spawn_ranks(torch, tp_child, args_of)
    draws = init_draws(get_config("llama3.2-1b"))
    ranks = {}
    for rank in range(2):
        res = got[rank]
        want = {n: (12 * TP_STEPS if n in MAIN_KERNELS else
                    draws if n == "threefry_bits" else 0)
                for n in res["launches"]}
        assert res["launches"] == want, (rank, res["launches"], want)
        np.testing.assert_allclose(res["losses"], ref, rtol=1e-6)
        assert all(math.isfinite(x) for x in res["losses"])
        assert len(res["pack_ms"]) == len(res["unpack_ms"]) == TP_STEPS
        by_path[f"12b tensor parallel, rank {rank}"] = res["launches"]
        relayout = [a + b for a, b in zip(res["pack_ms"],
                                          res["unpack_ms"])]
        ranks[rank] = {k: res[k] for k in ("losses", "step_ms", "pack_ms",
                                           "unpack_ms", "peak_gib",
                                           "density", "device",
                                           "shared_gradient")}
        ranks[rank]["relayout_ms"] = relayout
        log(f"  12b rank {rank} (cuda:{res['device']}): losses "
            f"{res['losses']} (one process {ref}); step ms "
            f"{[round(x, 1) for x in res['step_ms']]}; relayout ms "
            f"{[round(x, 1) for x in relayout]} (into the row "
            f"{[round(x, 1) for x in res['pack_ms']]}, back "
            f"{[round(x, 1) for x in res['unpack_ms']]}); peak "
            f"{res['peak_gib']:.2f} GiB; launches {res['launches']}; "
            f"shared gradient bitwise (relayout and row compression): "
            f"{res['shared_gradient']}")
    return {"backend": backend, "cards": torch.cuda.device_count(),
            "one_process_losses": ref,
            "one_process_peak_gib": peak1 / 2**30, "ranks": ranks,
            "wall_s": time.time() - t0}


# -- phase 13: the launch and tuning stack (slice 9) --

TUNE_STEPS = 2


def phase13_tuner(torch, by_path, llama) -> dict:
    """Slice 9, the launch and tuning stack (``phase13a`` .. ``phase13f``):

    13a. ``benchmarks.tuner_decision``'s rows equal
         ``benchmarks/baselines/tuner.json`` (the choice and ``passes``
         exactly, ``ms`` within 1e-12 relative);
    13b. ``launch.topo.measure_hardware`` on the card (an 8192-square
         f32 matmul, TF32 off; ``x + 1`` over 1024 MiB) against
         ``H100_SXM``: the copy rate may read at most 105% of 3.35 TB/s;
    13c. ``launch.multihost --mode coordinate`` and ``--mode validate``
         under ``torchrun`` in 2 processes (NCCL with a card each when
         two are visible, else gloo on the one card, staged through the
         host): every rank's ``COORDINATE OK``, the reference's validate
         asserts at its factors (2 and 4), the decision
         ``choose_strategy``'s on the measured topology, which is saved
         for 13d;
    13d. ``launch.train.run`` at full llama3.2-1b width, Gaussian-k
         fixed-k at 0.001, fused, 8 x 128, ``--strategy auto`` against
         the strategy it chose, 2 steps each: ``--mesh 4x1
         --host-devices 4 --topology <13c's>`` at 16 layers (48
         launches a step of K1, K2 and both K3), and ``--mesh 2x2x1
         --host-devices 4 --topology <the reference's asym>`` at 4
         layers (5b's cut: the per-worker gTop-k buffers of 16 layers
         exceed the card), which must choose ``hier_gtopk`` (96 a step:
         the pod means are compressed again, 5b's count); the printed
         decision ``choose_strategy``'s on the run's layout, the losses
         and every step's residual digests bitwise; step ms, peak
         memory;
    13e. ``launch.step_cost`` and ``launch.roofline`` on 13d's 4x1 step:
         the counted FLOPs against 6·N·tokens, the wire counted through
         ``ByteCountingWire`` during the explicit run, the roofline
         under ``H100_SXM``, and the share of the f32 peak,
         ``model_flops / (s x 67e12)``, of the forward plus backward
         alone at world 1 (CUDA events) and of the 4x1 step;
    13f. ``launch.dryrun`` on the meta device for all ten archs x their
         input shapes at ``4x2`` (every applicable cell ``OK``) and
         ``benchmarks.table2_scaling``'s rows (merge rows on the card)."""
    out = {"13a": phase13a(), "13b": phase13b(torch)}
    out["13c"], topo_path = phase13c(torch)
    out["13d"], cost_in = phase13d(torch, by_path, llama, topo_path)
    out["13e"] = phase13e(torch, cost_in)
    out["13f"] = phase13f()
    return out


def phase13a() -> dict:
    from repro_torch.benchmarks import tuner_decision
    _, doc = tuner_decision.collect()
    with open(os.path.join(HERE, "benchmarks", "baselines",
                           "tuner.json")) as f:
        base = json.load(f)
    bad = tuner_decision.baseline_mismatches(doc["rows"], base["rows"])
    assert not bad, ("13a tuner rows", bad[:3])
    log(f"phase 13a: tuner_decision's {len(doc['rows'])} rows equal "
        "benchmarks/baselines/tuner.json")
    return {"rows": len(doc["rows"])}


def phase13b(torch) -> dict:
    from repro_torch.launch.topo import H100_SXM, measure_hardware
    hw = measure_hardware(reps=5, n=8192, copy_mb=1024, device="cuda")
    log(f"phase 13b: measured f32 matmul {hw.peak_flops / 1e12:.2f} "
        f"TFLOP/s (H100_SXM {H100_SXM.peak_flops / 1e12:.0f}), copy "
        f"{hw.hbm_bw / 1e12:.3f} TB/s (H100_SXM "
        f"{H100_SXM.hbm_bw / 1e12:.2f}) on {nvidia_smi()}")
    assert hw.hbm_bw <= 1.05 * H100_SXM.hbm_bw, ("13b copy rate", hw)
    return hw.to_dict()


def torchrun(args, timeout: int = 300) -> str:
    """``torchrun --standalone --nproc-per-node 2 -m <args>`` from the
    checkout; returns its output, raising unless it exits 0."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m"] + args
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                         text=True, timeout=timeout)
    text = out.stdout + out.stderr
    assert out.returncode == 0, (cmd, text[-4000:])
    return text


def phase13c(torch) -> tuple:
    import tempfile

    from repro_torch.dist.tuner import choose_strategy
    from repro_torch.launch.multihost import _validate_layout
    from repro_torch.launch.topo import Topology, save_topology
    t0 = time.time()
    text = torchrun(["repro_torch.launch.multihost", "--mode", "coordinate"])
    for rank in range(2):
        assert f"COORDINATE OK p{rank}" in text, text[-3000:]
    # the two ranks share one pipe, so their lines may interleave
    coord, dec = [], json.JSONDecoder()
    for rank in range(2):
        at = text.index(f"coordinate p{rank}: ") + len(f"coordinate p{rank}: ")
        coord.append(dec.raw_decode(text, at)[0])
        assert coord[-1]["process_id"] == rank, coord[-1]
    t1 = time.time()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    report = os.path.join(tmp, "validate.json")
    text = torchrun(["repro_torch.launch.multihost", "--mode", "validate",
                     "--json", report])
    assert "VALIDATE OK" in text, text[-3000:]
    with open(report) as f:
        rep = json.load(f)
    topo = Topology.from_dict(rep["topology"])
    want = choose_strategy(_validate_layout(0.05), [("data", 2)], topo)
    assert rep["decision"] == json.loads(json.dumps(want.to_dict())), (
        "13c decision", rep["decision"], want.to_dict())
    path = os.path.join(tmp, "topology.json")
    save_topology(topo, path)
    backend = coord[0]["backend"]
    for r in rep["strategies"]:
        log(f"  13c {r['strategy']}: predicted "
            f"{r['predicted_s'] * 1e6:.1f} us, measured "
            f"{r['measured_s'] * 1e6:.1f} us, ratio {r['ratio']:.3f}")
    log(f"phase 13c: coordinate ({backend}, {t1 - t0:.1f} s) and validate "
        f"({time.time() - t1:.1f} s) in 2 processes: chose "
        f"{rep['decision']['strategy']}; link "
        f"{topo.link('data').to_dict()}; hardware "
        f"{topo.hardware.to_dict()}; saved to {path}")
    return {"backend": backend, "coordinate": coord,
            "validate": rep, "wall_s": time.time() - t0}, path


def device_digest(torch, t) -> tuple:
    """A digest of ``t``'s bits on the card: the sum of its int32 words
    and their sum weighted by ``1 + index % 65521`` (int64, wrapping)."""
    x = t.detach().reshape(-1).view(torch.int32)
    s1 = s2 = 0
    step = 1 << 26
    for a in range(0, x.numel(), step):
        c = x[a:a + step].to(torch.int64)
        w = torch.arange(a, a + c.numel(), device=c.device) % 65521 + 1
        s1 += int(c.sum())
        s2 += int((c * w).sum())
    return s1, s2


def tuned_run(torch, label, argv, cfg, expect, count_wire=False):
    """One ``train.run`` with its launch counters set to 0 just before
    and read just after (:func:`drive`), the printed output captured and
    every step's residual digested; returns ``(launches, records,
    digests, printed, peak, wire)`` (``wire``: the
    ``step_cost.ByteCountingWire`` around the run's wire, when asked)."""
    import contextlib
    import io

    from repro_torch.launch import step_cost, train
    digests, wires = [], []

    def probe(rank, resid=None, means=None, **kw):
        if rank is None and resid is not None:
            digests.append(device_digest(torch, resid))

    make_wire = train.make_wire

    def counted(*a, **k):
        wire, device, started = make_wire(*a, **k)
        wires.append(step_cost.ByteCountingWire(wire))
        return wires[-1], device, started

    buf = io.StringIO()
    once = {"threefry_bits": init_draws(cfg)}
    torch.cuda.reset_peak_memory_stats()
    if count_wire:
        train.make_wire = counted
    try:
        with contextlib.redirect_stdout(buf):
            launches, records = drive(label, lambda: train.run(
                argv + ["--steps", str(TUNE_STEPS), "--log-every", "1"],
                probe=probe, cfg=cfg), expect, TUNE_STEPS, once)
    finally:
        train.make_wire = make_wire
    peak = torch.cuda.max_memory_allocated()
    printed = buf.getvalue()
    log(printed.rstrip())
    return (launches, records, digests, printed, peak,
            wires[0] if wires else None)


def phase13d(torch, by_path, llama, topo_path) -> tuple:
    import tempfile

    from repro_torch.benchmarks.tuner_decision import cases
    from repro_torch.core.compressors import get_compressor
    from repro_torch.dist.layout import build_layout
    from repro_torch.dist.tuner import choose_strategy
    from repro_torch.launch.topo import load_topology, save_topology
    from repro_torch.models import init_params
    asym = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "asym.json")
    save_topology(cases()[0][3], asym)
    cells = (("4x1", [("data", 4)], topo_path, 16, 48, None),
             ("2x2x1", [("pod", 2), ("data", 2)], asym, 4, 96,
              "hier_gtopk"))
    out, cost_in = {}, None
    def decide(layers, axes, topo):
        cfg = llama_layers(layers)
        layout = build_layout(init_params(cfg, 0, "meta"), 1, RATIO,
                              get_compressor("gaussiank"))
        return cfg, layout, choose_strategy(layout, axes,
                                            load_topology(topo))

    for mesh_s, axes, topo, layers, per_step, must in cells:
        cfg, layout, want = decide(layers, axes, topo)
        if want.strategy != "allgather" and layers > 4:
            # 5b's cut: a gTop-k worker's buffers of 16 layers exceed
            # the card
            layers = 4
            cfg, layout, want = decide(layers, axes, topo)
        if must:
            assert want.strategy == must, (mesh_s, want.to_dict())
        argv = llama + ["--host-devices", "4", "--mesh", mesh_s]
        expect = {n: per_step for n in MAIN_KERNELS}
        log(f"phase 13d: --mesh {mesh_s} --strategy auto --topology "
            f"{topo}, full width with {layers} layers, {TUNE_STEPS} steps")
        label = f"13d auto {mesh_s}"
        by_path[label], recs, dig, printed, peak, _ = tuned_run(
            torch, label, argv + ["--strategy", "auto", "--topology", topo],
            cfg, expect)
        chosen = printed.split("-> strategy=")[1].split()[0]
        assert chosen == want.strategy, (label, chosen, want.to_dict())
        assert f" tuner={chosen} " in printed, label
        torch.cuda.empty_cache()
        label2 = f"13d {chosen} {mesh_s}"
        by_path[label2], recs2, dig2, _, peak2, wire = tuned_run(
            torch, label2, argv + ["--strategy", chosen], cfg, expect,
            count_wire=mesh_s == "4x1")
        assert [r["loss"] for r in recs] == [r["loss"] for r in recs2], (
            label, recs, recs2)
        assert dig == dig2 and len(dig) == TUNE_STEPS, (label, dig, dig2)
        assert peak < 80e9 and peak2 < 80e9, (label, peak, peak2)
        out[mesh_s] = {"chosen": chosen, "layers": layers,
                       "predictions": want.to_dict()["predictions"],
                       "losses": [r["loss"] for r in recs],
                       "step_ms_auto": [r["ms"] for r in recs],
                       "step_ms_explicit": [r["ms"] for r in recs2],
                       "peak_mem_gib": peak / 2**30,
                       "launches_per_step": per_step}
        log(f"  13d {mesh_s}: auto chose {chosen} (choose_strategy on the "
            f"run's layout agrees); losses and {len(dig)} residual digests "
            f"bitwise the explicit run's; step ms auto "
            f"{[round(r['ms'], 1) for r in recs]} explicit "
            f"{[round(r['ms'], 1) for r in recs2]}; peak "
            f"{peak / 2**30:.2f} GiB; {per_step} launches a step of each "
            "Gaussian-k kernel")
        if wire is not None:
            from repro_torch.launch.step_cost import count_wire_collectives
            cost_in = {"cfg": cfg, "layout": layout, "strategy": chosen,
                       "step_ms":
                       recs2[-1]["ms"], "wire": count_wire_collectives(
                           wire, TUNE_STEPS),
                       "topo": load_topology(topo)}
        del recs, recs2
        torch.cuda.empty_cache()
    return out, cost_in


def phase13e(torch, cost_in) -> dict:
    from repro_torch import tree
    from repro_torch.data import batch_for
    from repro_torch.dist.tuner import MSGS_PER_PAIR
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import step_cost
    from repro_torch.launch.topo import H100_SXM
    from repro_torch.models import init_params, loss_fn
    cfg, layout = cost_in["cfg"], cost_in["layout"]
    batch, seq, workers = 8, 128, 4
    cost = step_cost.step_cost(cfg, batch=batch, seq=seq, layout=layout,
                               workers=workers,
                               wire_counts=cost_in["wire"])
    n = cost["n_params"]
    total, active = rl.active_params(init_params(cfg, 0, "meta"), cfg)
    mf = rl.model_flops(cfg, total, active, "train", batch, seq)
    strategy = cost_in["strategy"]
    assert cost_in["wire"]["bytes"] * 8 == layout.comm_bits_sparse(
        strategy, workers), ("13e wire bytes", cost_in["wire"])
    assert cost_in["wire"]["messages"] == layout.collectives(
        strategy, workers), cost_in["wire"]
    terms = rl.roofline_terms(
        cost["flops"], cost["bytes_accessed"], cost["coll_bytes"], mf,
        hw=H100_SXM, link=cost_in["topo"].link("data"),
        n_messages=cost["n_messages"] * MSGS_PER_PAIR)
    # the forward plus backward alone, world 1, at full depth, between
    # CUDA events
    full = llama_layers(16)
    params = init_params(full, 0, "cuda")
    leaves = tree.leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    b = batch_for(full, 0, global_batch=batch, seq_len=seq, device="cuda")

    def fwd_bwd():
        loss, _ = loss_fn(params, full, b)
        torch.autograd.grad(loss, leaves)

    fb_ms = time_ms(fwd_bwd, 5)
    w1 = step_cost.count_flops(full, batch, seq, params=params,
                               device="cuda")
    n_full, _ = rl.active_params(params, full)
    del params, leaves
    torch.cuda.empty_cache()
    mf_full = rl.model_flops(full, n_full, n_full, "train", batch, seq)
    peak = H100_SXM.peak_flops
    share_fb = mf_full / (fb_ms / 1e3 * peak)
    counted_fb = w1["flops"] / (fb_ms / 1e3 * peak)
    share_step = mf / (cost_in["step_ms"] / 1e3 * peak)
    out = {"layers_4x1": cfg.num_layers, "strategy_4x1": strategy,
           "flops_counted": cost["flops"], "model_flops_6NT": mf,
           "counted_over_6NT": cost["flops"] / mf,
           "uncounted_ops": cost["uncounted_ops"],
           "bytes_accessed": cost["bytes_accessed"],
           "state_bytes": cost["state_bytes"],
           "coll_bytes": cost["coll_bytes"],
           "n_messages": cost["n_messages"], "roofline": terms.to_dict(),
           "step_ms_4x1": cost_in["step_ms"],
           "f32_peak_share_step_4x1": share_step,
           "fwd_bwd_ms_16_layers": fb_ms,
           "flops_counted_16_layers": w1["flops"],
           "model_flops_6NT_16_layers": mf_full,
           "f32_peak_share_fwd_bwd": share_fb,
           "counted_f32_share_fwd_bwd": counted_fb, "n_params": n}
    log(f"phase 13e: llama3.2-1b ({cfg.num_layers} layers) step at 4x1 "
        f"({strategy}), 8 x 128: counted {cost['flops']:.4e} FLOPs "
        f"(6·N·tokens {mf:.4e}, ratio {cost['flops'] / mf:.4f}); bytes "
        f"{cost['bytes_accessed']:.4e}; wire {cost['coll_bytes']:.0f} B in "
        f"{cost['n_messages']:.0f} call(s); roofline under H100_SXM and "
        f"13c's link: compute {terms.compute_s * 1e3:.2f} ms, memory "
        f"{terms.memory_s * 1e3:.2f} ms, collective "
        f"{terms.collective_s * 1e3:.3f} ms ({terms.dominant}); the step "
        f"{cost_in['step_ms']:.1f} ms -> {share_step:.3f} of the f32 peak. "
        f"At 16 layers, world 1: forward + backward {fb_ms:.1f} ms, "
        f"6·N·tokens {mf_full:.4e} -> {share_fb:.3f} of the f32 peak "
        f"(counted {w1['flops']:.4e} -> {counted_fb:.3f}); {nvidia_smi()}")
    return out


def phase13f() -> dict:
    import tempfile

    from repro_torch.benchmarks import table2_scaling
    from repro_torch.launch import dryrun
    t0 = time.time()
    recs = dryrun.run_all(mesh="4x2")
    bad = [(r["arch"], r["shape"], r.get("error")) for r in recs
           if r["status"] == "FAIL"]
    assert not bad, ("13f dryrun", bad)
    ok = sum(r["status"] == "OK" for r in recs)
    t1 = time.time()
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"),
                        "dryrun.json")
    with open(path, "w") as f:
        json.dump(recs, f)
    rows = table2_scaling.run(smoke=False, device="cuda", dryrun_json=path)
    merge = [r for r in rows if r[0].startswith("table2/merge/")]
    eff = [r for r in rows if r[0].startswith("table2/eff/")]
    assert len(eff) == 10 and len(merge) == 2, rows
    log(f"phase 13f: dryrun at 4x2 on meta: {ok} OK, "
        f"{len(recs) - ok} SKIP, 0 FAIL ({t1 - t0:.1f} s); table2 "
        f"{len(rows)} rows ({time.time() - t1:.1f} s); merge rows {merge}")
    return {"ok": ok, "skip": len(recs) - ok, "dryrun_s": t1 - t0,
            "merge_rows": merge, "eff_rows": eff,
            "flops_methods": {f"{r['arch']}/{r['shape']}":
                              r["flops"]["method"] for r in recs
                              if r["status"] == "OK"}}


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check runs on a "
              "GPU", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repo", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import numpy as np

    from repro_torch import tree
    from repro_torch.kernels import cuda_build

    kernels_only = "--kernels-only" in argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    t_start = time.time()

    # -- phase 1: environment + build --
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    build_s = build(cuda_build, torch)
    log(f"kernels built in {build_s:.1f} s (nvcc -> "
        f"{cuda_build.build_dir()}, Triton JIT)")
    if "--serve-only" in argv:
        log(json.dumps({"phase10": phase10_serve(torch, {})}))
        log("serve-only run: phases 2-9 skipped")
        return 0
    rows = {n: {"name": v[0], "route": v[1], "source": v[2],
                "replaces": v[3], "library_ms": None}
            for n, v in KERNELS.items()}
    if "--arch-only" in argv:
        by_path = {}
        log(json.dumps({"phase11": phase11_archs(torch, by_path, rows),
                        "launches_by_path": by_path}))
        log("arch-only run: phases 2-10 skipped")
        return 0
    llama = ["--arch", "llama3.2-1b", "--mesh", "1x1", "--density-policy",
             "none", "--batch", "8", "--seq", "128"]
    if "--model-axis-only" in argv:
        check_model_rows(torch)
        by_path = {}
        log(json.dumps({"phase12": phase12_model_axis(torch, by_path,
                                                      llama),
                        "launches_by_path": by_path}))
        log("model-axis-only run: phases 2-11 skipped (phase 2's M = 2 "
            "rows run)")
        return 0
    if "--tuner-only" in argv:
        by_path = {}
        log(json.dumps({"phase13": phase13_tuner(torch, by_path, llama),
                        "launches_by_path": by_path}))
        log("tuner-only run: phases 2-12 skipped")
        return 0
    if "--tensor-parallel-only" in argv:
        by_path = {}
        log(json.dumps({"phase12b": phase12b(torch, by_path, llama),
                        "launches_by_path": by_path}))
        log("tensor-parallel-only run: phase 12b alone")
        return 0

    # -- phase 2: kernels against their plain versions --
    sizes = (2048, 1_000_003) if kernels_only else (2048, 1_000_003,
                                                    BIG_LEAF)
    log("phase 2: kernels against their plain versions on the card")
    for n, d in enumerate(sizes):
        check_kernels(d, n, rows, timed=d == sizes[-1])
        torch.cuda.empty_cache()
    log("phase 2: K1-K3 on the rows of a bucket at a model axis of 2")
    check_model_rows(torch)
    pipelines = rows.pop("pipelines", None)
    if kernels_only:
        phase7a_prng(torch, rows, timed=False)
        log(json.dumps({"kernels": list(rows.values()),
                        "pipelines": pipelines}))
        log("kernels-only run: phases 3-10 skipped (7a run untimed)")
        return 0

    # -- phase 3: the paths at full width --
    by_path = {}
    log("phase 3: llama3.2-1b at full width, Gaussian-k (fused), 3 steps")
    by_path["gaussiank fused"], records, peak, bnd, _ = train_path(
        "gaussiank fused", llama,
        {"fused_moments": 12, "tree_count": 12, "compact_stage": 12,
         "compact_resid": 12}, 3, torch)
    step_ms = [r["ms"] for r in records]
    tok_s = 8 * 128 / (statistics.median(step_ms[1:]) / 1e3)
    main_path = {"arch": "llama3.2-1b", "steps": 3, "batch": 8, "seq": 128,
                 "losses": [r["loss"] for r in records], "step_ms": step_ms,
                 "tokens_per_s": tok_s, "peak_mem_gib": peak / 2**30,
                 "density": [r["density"] for r in records],
                 "density_cap": records[0]["density_cap"],
                 "step_bound_ms": bnd}
    log(f"  {tok_s:.0f} tokens/s (median of steps 1-2)")
    del records
    torch.cuda.empty_cache()

    log("phase 3b: path A, hist-k on the fused backend, 3 steps")
    by_path["histk fused"], records, peak, bnd, _ = train_path(
        "histk fused", llama + ["--compressor", "histk"],
        {"fused_moments_hist": 12, "compact_stage": 12,
         "compact_resid": 12}, 3, torch)
    path_a = {"losses": [r["loss"] for r in records],
              "step_ms": [r["ms"] for r in records],
              "peak_mem_gib": peak / 2**30,
              "density": [r["density"] for r in records],
              "step_bound_ms": bnd}
    del records
    torch.cuda.empty_cache()

    log("phase 3c: path B, hist-k on the reference backend, 2 steps")
    by_path["histk reference"], records, peak, bnd, _ = train_path(
        "histk reference",
        llama + ["--compressor", "histk", "--backend", "reference"],
        {"abs_histogram": 12, "threshold_compact": 12}, 2, torch)
    path_b = {"losses": [r["loss"] for r in records],
              "step_ms": [r["ms"] for r in records],
              "peak_mem_gib": peak / 2**30,
              "density": [r["density"] for r in records],
              "step_bound_ms": bnd}
    assert peak < 80e9, ("path B peak memory", peak)
    del records
    torch.cuda.empty_cache()

    log("phase 3d: path C, unfused_compress_ef on the 268,435,456-element "
        "leaf (gaussiank, histk)")
    from repro_torch.core import codec
    from repro_torch.kernels.ef_fused import unfused_compress_ef
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    g = torch.randn(BIG_LEAF, generator=gen, device="cuda").mul_(1e-3)
    e = torch.randn(BIG_LEAF, generator=gen, device="cuda").mul_(5e-4)
    kk = math.ceil(RATIO * BIG_LEAF)

    def path_c():
        out = []
        for name in ("gaussiank", "histk"):
            v, i, ne = unfused_compress_ef(g, e, name, kk)
            assert torch.equal(codec.decode(v, i, BIG_LEAF) + ne, g + e), (
                "path C conservation", name)
            out.append(int(codec.nnz(i)))
        return out

    by_path["unfused"], nnzs = drive(
        "unfused", path_c, {"moments": 1, "count_gt": 4,
                            "threshold_compact": 2, "abs_histogram": 1}, 1)
    log(f"  unfused gaussiank and histk conserve bitwise; nnz {nnzs}; "
        f"launches {by_path['unfused']}")
    del g, e
    torch.cuda.empty_cache()

    log("phase 3e: path D, trimmed-k (plain torch), 2 steps")
    by_path["trimmedk"], records, peak, bnd, _ = train_path(
        "trimmedk", llama + ["--compressor", "trimmedk"], {}, 2, torch)
    path_d = {"losses": [r["loss"] for r in records],
              "step_ms": [r["ms"] for r in records],
              "peak_mem_gib": peak / 2**30,
              "density": [r["density"] for r in records]}
    assert peak < 80e9, ("path D peak memory", peak)
    del records
    torch.cuda.empty_cache()

    # -- phase 4: card against CPU on a small config --
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data import lm_batch
    from repro_torch.dist.layout import build_layout
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.optim import constant, sgd_momentum
    from repro_torch.train import init_train_state, make_train_step

    from repro_torch.kernels.ef_fused import tuning
    cfg = ModelConfig(name="sys", arch_type="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=64).validate()
    base = init_params(cfg, 0, "cpu")
    small = {}
    for name, backend in (("gaussiank", "auto"), ("histk", "fused"),
                          ("histk", "reference"),
                          ("trimmedk", "reference")):
        comp = CompressionConfig(compressor=name, ratio=0.01,
                                 backend=backend)
        out = {}
        for dev in ("cuda", "cpu"):
            params = tree.tree_map(lambda x: x.clone().to(dev), base)
            layout = build_layout(params, 1, comp)
            opt = sgd_momentum(0.9)
            state = init_train_state(params, opt, workers=1, model_size=1,
                                     compression=comp, layout=layout)
            step = make_train_step(cfg, (1, 1), opt, constant(0.1),
                                   compression=comp, layout=layout)
            ls = []
            # the CPU run takes the card's block geometry, so both stage
            # (and truncate) alike
            with tuning.geometry_of("cuda"):
                for i in range(2):
                    b = lm_batch(i, global_batch=4, seq_len=16,
                                 vocab=cfg.vocab_size, device=dev)
                    state, m = step(state, b)
                    ls.append(float(m["loss"]))
            out[dev] = ls
        np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4)
        small[f"{name} {backend}"] = out
        log(f"phase 4: {name} ({backend}): card {out['cuda']} vs CPU "
            f"{out['cpu']} within rtol 1e-4")

    # -- phase 5: the data-parallel wire --
    phase5 = {}
    per4 = {n: 48 for n in MAIN_KERNELS}     # 12 leaves x 4 workers
    log("phase 5a: llama3.2-1b at full width and depth, 4 workers in this "
        "process (--host-devices 4 --mesh 4x1), allgather, 3 steps")
    by_path["5a allgather W=4"], records, peak, bnd, extra = train_path(
        "allgather W=4", llama + ["--host-devices", "4", "--mesh", "4x1",
                                  "--strategy", "allgather"],
        per4, 3, torch, workers=4)
    phase5["5a"] = {"losses": [r["loss"] for r in records],
                    "step_ms": [r["ms"] for r in records],
                    "wire_ms": extra["wire_ms"],
                    "peak_mem_gib": peak / 2**30,
                    "density": [r["density"] for r in records],
                    "comm_bits_sparse": records[0]["comm_bits_sparse"],
                    "step_bound_ms": bnd}
    assert peak < 80e9, ("5a peak memory", peak)
    del records
    torch.cuda.empty_cache()

    from repro_torch.core.compressors import get_compressor
    from repro_torch.models import init_params as _init
    cfg4 = llama_layers(4)
    lay4 = build_layout(_init(cfg4, 0, "meta"), 1, RATIO,
                        get_compressor("gaussiank"))
    for strategy, mesh_s, n_pods in (("gtopk", "4x1", 1),
                                     ("hierarchical", "2x2x1", 2),
                                     ("hier_gtopk", "2x2x1", 2)):
        levels = 2 if n_pods > 1 else 1
        log(f"phase 5b: {strategy}, --mesh {mesh_s}, full width with 4 "
            "layers, 2 steps")
        label = f"5b {strategy} W=4"
        by_path[label], records, peak, bnd, extra = train_path(
            label, llama + ["--host-devices", "4", "--mesh", mesh_s,
                            "--strategy", strategy],
            {n: 48 * levels for n in MAIN_KERNELS}, 2, torch, workers=4,
            cfg=cfg4, global_check=strategy == "gtopk", levels=levels)
        bits = lay4.comm_bits_sparse(strategy, 4, n_pods)
        coll = lay4.collectives(strategy, 4, n_pods)
        for r in records:
            assert r["comm_bits_sparse"] == bits, (label, r, bits)
            assert r["collectives_per_step"] == coll, (label, r, coll)
        log(f"  {label}: comm_bits_sparse {bits:.0f} and "
            f"collectives_per_step {coll} equal the layout's accounting")
        phase5[label] = {"losses": [r["loss"] for r in records],
                         "step_ms": [r["ms"] for r in records],
                         "wire_ms": extra["wire_ms"],
                         "peak_mem_gib": peak / 2**30,
                         "comm_bits_sparse": bits,
                         "collectives_per_step": coll,
                         "conservation": extra["conservation"],
                         "step_bound_ms": bnd}
        assert peak < 80e9, (label, "peak memory", peak)
        del records
        torch.cuda.empty_cache()

    log("phase 5c: the process-group wire on the card, 2 ranks, full width "
        "with 2 layers, 2 steps of allgather and of gtopk")
    phase5["5c"], ref5c = phase5c(torch, by_path, llama_layers(2))

    from repro_torch.dist.wire import LocalWire
    from repro_torch.launch.mesh import parse_mesh
    for strategy, mesh_s in (("allgather", "4x1"), ("gtopk", "4x1"),
                             ("hierarchical", "2x2x1"),
                             ("hier_gtopk", "2x2x1")):
        comp = CompressionConfig(ratio=0.01, strategy=strategy)
        out = {}
        for dev in ("cuda", "cpu"):
            params = tree.tree_map(lambda x: x.clone().to(dev), base)
            layout = build_layout(params, 1, comp)
            opt = sgd_momentum(0.9)
            state = init_train_state(params, opt, workers=4, model_size=1,
                                     compression=comp, layout=layout)
            step = make_train_step(cfg, mesh_s, opt, constant(0.1),
                                   compression=comp, layout=layout,
                                   wire=LocalWire(parse_mesh(mesh_s)))
            ls = []
            with tuning.geometry_of("cuda"):
                for i in range(2):
                    b = lm_batch(i, global_batch=8, seq_len=16,
                                 vocab=cfg.vocab_size, device=dev)
                    state, m = step(state, b)
                    ls.append(float(m["loss"]))
            out[dev] = ls
        np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4)
        small[f"W=4 {strategy}"] = out
        log(f"phase 5d: {strategy} ({mesh_s}, W=4): card {out['cuda']} vs "
            f"CPU {out['cpu']} within rtol 1e-4")

    # -- phase 6: adaptive layer-wise density --
    phase6 = phase6_adaptive(torch, by_path, llama_adaptive=[
        "--arch", "llama3.2-1b", "--mesh", "1x1", "--batch", "8", "--seq",
        "128"], fixed_step_ms=main_path["step_ms"], fixed_peak=main_path[
            "peak_mem_gib"], base=base, cfg=cfg)

    # -- phase 7: the PRNG, the keyed compressors, momentum correction --
    phase7 = phase7_keyed(torch, by_path, rows, base, cfg)

    # -- phase 8: the paper's experiments --
    phase8 = phase8_paper(torch, by_path)

    # -- phase 9: the chunked schedule and the per-leaf loop --
    phase9 = phase9_chunked(torch, by_path, ref5c, cfg, base)

    # -- phase 10: serving and the weight-delta stream --
    phase10 = phase10_serve(torch, by_path)

    # -- phase 11: the other architectures --
    phase11 = phase11_archs(torch, by_path, rows)

    # -- phase 12: the model axis --
    phase12 = phase12_model_axis(torch, by_path, llama)

    # -- phase 13: the launch and tuning stack --
    phase13 = phase13_tuner(torch, by_path, llama)

    for n, row in rows.items():
        row["launches_by_path"] = {p: c[n] for p, c in by_path.items()
                                   if c[n]}
        row["launches"] = sum(row["launches_by_path"].values())
        assert row["launches"] > 0, (n, "never launched on a path")
    log(json.dumps({"pipelines": pipelines, "main_path": main_path,
                    "path_a": path_a, "path_b": path_b, "path_d": path_d,
                    "small": small, "phase5": phase5, "phase6": phase6,
                    "phase7": phase7, "phase8": phase8,
                    "phase9": phase9, "phase10": phase10,
                    "phase11": phase11, "phase12": phase12,
                    "phase13": phase13, "build_s": build_s,
                    "total_s": time.time() - t_start}))
    log(json.dumps({"kernels": list(rows.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
