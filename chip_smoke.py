#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --kernels-only  # phases 1-2 at small sizes

Phases (any failure exits non-zero; nothing is wrapped to pass):

1. environment: card name and power limit, torch/CUDA versions, the
   kernels built from this checkout's sources (``nvcc`` for the CUDA
   C++, Triton's JIT for the rest) and the build time;
2. every kernel of the main path against its plain PyTorch version on
   the card, at d in {2048, 1,000,003, 268,435,456} (the last is the
   largest llama3.2-1b leaf, ``stack/0/ffn/w_gate``), timed with CUDA
   events (median after warm-up), plus the whole fused Gaussian-k
   pipeline beside exact top-k (``torch.topk``, the paper's yardstick);
3. the main path at full width: ``repro_torch.launch.train.run`` on
   llama3.2-1b (16 layers, d_model 2048, vocab 128256, random weights
   from seed 0) for 3 steps of Gaussian-k at 0.001, fixed-k, bucketed,
   allgather, world 1 — with every kernel's launch counter set to 0
   just before and read just after;
4. card against CPU on a small config (2 layers, d_model 64): 2 steps
   on each from the same params and batches, losses within rtol 1e-4.

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
BIG_LEAF = 268_435_456        # llama3.2-1b stack/0/ffn/w_gate (16x2048x8192)
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


def build(cuda_build, fm, tc, torch) -> float:
    """Build the CUDA library (one nvcc per source, in a thread) while
    Triton compiles K1/K2 on tiny inputs; returns the seconds taken."""
    t0 = time.time()
    err, reports = [], {}

    def nvcc():
        try:
            reports.update(cuda_build.build_all())
        except Exception as ex:  # noqa: BLE001 — re-raised below
            err.append(ex)

    th = threading.Thread(target=nvcc)
    th.start()
    x = torch.ones(4096, device="cuda")
    for d in (4096, 4095):
        fm.fused_moments(x[:d], x[:d], block=1024)
        tc.tree_count(x[:d], x[:d], torch.ones(15, device="cuda"),
                      block=1024)
    torch.cuda.synchronize()
    th.join()
    if err:
        raise err[0]
    for src, rep in reports.items():
        log(f"nvcc {src}: ptxas report follows")
        log(rep.strip())
    return time.time() - t0


def check_kernels(d: int, seed: int, rows: dict, timed: bool):
    """Phase 2 at one size: each kernel against its plain version on the
    card (K1 within tolerance, K2/K3 bitwise), pipeline conservation,
    and (``timed``) the times that go into the kernels line."""
    import torch

    from repro_torch.core import codec
    from repro_torch.core.compressors import gaussiank_cap
    from repro_torch.kernels.ef_fused import compact_residual as cr
    from repro_torch.kernels.ef_fused import fused_moments as fm
    from repro_torch.kernels.ef_fused import ops, tuning
    from repro_torch.kernels.ef_fused import tree_count as tc

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    g = torch.randn(d, generator=gen, device="cuda").mul_(1e-3)
    e = torch.randn(d, generator=gen, device="cuda").mul_(5e-4)
    k = max(1, math.ceil(RATIO * d))
    cfg = tuning.resolve_config(d, "cuda")
    sb, block = cfg.stats_block, cfg.block
    k_cap = gaussiank_cap(k, d)
    bcap = ops.fused_default_bcap(k_cap, d, block, cfg.bcap_slack)
    nb, nbs = -(-d // block), -(-d // sb)

    # K1
    s, sq, mx = fm.fused_moments(g, e, block=sb)
    ps, psq, pmx = fm.fused_moments_plain(g, e, block=sb)
    sum_abs = float((g + e).abs().double().sum())
    err_s, err_sq = abs(float(s) - float(ps)), abs(float(sq) - float(psq))
    assert err_s <= 1e-5 * sum_abs, (d, "K1 s", float(s), float(ps))
    assert err_sq <= 1e-5 * abs(float(psq)), (d, "K1 sq", float(sq),
                                              float(psq))
    assert float(mx) == float(pmx), (d, "K1 absmax", float(mx), float(pmx))
    k1_err = max(err_s, err_sq)
    # K2 at the refinement tree of the plain moments
    t0 = ops.gaussian_t0(ps, psq, d, k, False)
    heap, n_cnt = ops._tree_thresholds(t0, 4)
    thr = torch.from_numpy(heap[:n_cnt]).cuda()
    cnt_k = tc.tree_count(g, e, thr, block=sb)
    cnt_p = tc.tree_count_plain(g, e, thr, block=sb)
    assert torch.equal(cnt_k, cnt_p), (d, "K2", cnt_k, cnt_p)
    thres = float(ops._replay_refinement(heap, cnt_p.cpu().numpy(), k, 4))
    # K3 at that same threshold
    vk, ok, ck = cr.compact_stage(g, e, thres, block=block, bcap=bcap)
    vp, op, cp = cr.compact_stage_plain(g, e, thres, block=block, bcap=bcap)
    assert torch.equal(ck, cp), (d, "K3 counts")
    assert torch.equal(ok, op), (d, "K3 offsets")
    assert torch.equal(vk.view(torch.int32), vp.view(torch.int32)), (
        d, "K3 staged values")
    enc = cr.exclusive_enc(cp, bcap)
    rk = cr.compact_resid(g, e, thres, enc, block=block, bcap=bcap,
                          k_cap=k_cap)
    rp = cr.compact_resid_plain(g, e, thres, enc, block=block, bcap=bcap,
                                k_cap=k_cap)
    assert torch.equal(rk.view(torch.int32), rp.view(torch.int32)), (
        d, "K3 residual")
    # the pipeline: conservation decode(v, i) + e' == g + e, bitwise
    v, i, ne = ops.fused_compress_ef(g, e, "gaussiank", k)
    assert torch.equal(codec.decode(v, i, d) + ne, g + e), (d, "conserve")
    nnz = int(codec.nnz(i))
    log(f"  d={d:>11,}: K1 |ds|={err_s:.3g} |dsq|={err_sq:.3g} absmax "
        f"exact; K2 counts exact {cnt_k.tolist()[:3]}...; K3 staging + "
        f"residual bitwise (block {block}, bcap {bcap}, {int(ck.sum())} "
        f"over threshold {thres:.6g}); pipeline conserves bitwise, "
        f"{nnz}/{k_cap} slots for k={k}")
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
    u_abs = (g + e).abs()
    ms = {
        "fused_moments": (time_ms(lambda: fm.fused_moments(g, e, block=sb),
                                  it),
                          time_ms(lambda: fm.fused_moments_plain(
                              g, e, block=sb), pit)),
        "tree_count": (time_ms(lambda: tc.tree_count(g, e, thr, block=sb),
                               it),
                       time_ms(lambda: tc.tree_count_plain(g, e, thr,
                                                           block=sb), pit)),
        "compact_stage": (time_ms(lambda: cr.compact_stage(
            g, e, thres, block=block, bcap=bcap), it),
            time_ms(lambda: cr.compact_stage_plain(
                g, e, thres, block=block, bcap=bcap), pit)),
        "compact_resid": (time_ms(lambda: cr.compact_resid(
            g, e, thres, enc, block=block, bcap=bcap, k_cap=k_cap,
            out=out), it),
            time_ms(lambda: cr.compact_resid_plain(
                g, e, thres, enc, block=block, bcap=bcap, k_cap=k_cap),
                pit)),
    }
    pipe = (time_ms(lambda: ops.fused_compress_ef(g, e, "gaussiank", k), it),
            time_ms(pipeline_plain, pit),
            time_ms(lambda: torch.topk(u_abs, k), it))
    del u_abs, out
    nt = 16
    work = {   # (bytes each input read once + each output written once, ops)
        "fused_moments": (8 * d + 12 * nbs, 5 * d),
        "tree_count": (8 * d + 4 * nt * nbs, 17 * d),
        "compact_stage": (8 * d + 8 * nb * bcap + 4 * nb, 3 * d),
        "compact_resid": (12 * d + 8 * nb, 3 * d),
    }
    errs = {"fused_moments": k1_err, "tree_count": 0.0,
            "compact_stage": 0.0, "compact_resid": 0.0}
    for name, (k_ms, p_ms) in ms.items():
        b_ms, b_by = bound(*work[name])
        rows[name].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                          bound_by=b_by, max_abs_err=errs[name], d=d)
    b_ms, b_by = bound(12 * d + 8 * k_cap, 25 * d)
    rows["pipeline"] = {
        "name": "fused_compress_ef (gaussiank: K1+K2+K3 + glue)", "d": d,
        "k": k, "ms": pipe[0], "plain_ms": pipe[1], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": pipe[2],
        "library": "torch.topk(|u|, k) on a precomputed |u|: exact top-k, "
                   "the paper's yardstick"}
    log(f"  times at d={d:,} (ms, median): " + ", ".join(
        f"{n} {a:.4f} (plain {b:.3f})" for n, (a, b) in ms.items())
        + f"; pipeline {pipe[0]:.3f} (plain {pipe[1]:.3f}, torch.topk "
        f"{pipe[2]:.3f})")


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
    from repro_torch.kernels.ef_fused import compact_residual as cr
    from repro_torch.kernels.ef_fused import fused_moments as fm
    from repro_torch.kernels.ef_fused import tree_count as tc

    kernels_only = "--kernels-only" in argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()

    # -- phase 1: environment + build --
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")
    build_s = build(cuda_build, fm, tc, torch)
    log(f"kernels built in {build_s:.1f} s (nvcc -> "
        f"{cuda_build.build_dir()}, Triton JIT)")

    # -- phase 2: kernels against their plain versions --
    rows = {
        "fused_moments": {"name": "fused_moments (K1)", "route": "triton",
                          "source": "src/repro_torch/kernels/ef_fused/"
                                    "fused_moments.py",
                          "replaces": "src/repro/kernels/ef_fused/"
                                      "fused_moments.py:144"},
        "tree_count": {"name": "tree_count (K2)", "route": "triton",
                       "source": "src/repro_torch/kernels/ef_fused/"
                                 "tree_count.py",
                       "replaces": "src/repro/kernels/ef_fused/"
                                   "tree_count.py:93"},
        "compact_stage": {"name": "compact_residual stage (K3)",
                          "route": "cuda",
                          "source": "src/repro_torch/csrc/"
                                    "compact_residual.cu",
                          "replaces": "src/repro/kernels/ef_fused/"
                                      "compact_residual.py:191"},
        "compact_resid": {"name": "compact_residual residual (K3)",
                          "route": "cuda",
                          "source": "src/repro_torch/csrc/"
                                    "compact_residual.cu",
                          "replaces": "src/repro/kernels/ef_fused/"
                                      "compact_residual.py:208"},
    }
    sizes = (2048, 1_000_003) if kernels_only else (2048, 1_000_003,
                                                    BIG_LEAF)
    log("phase 2: kernels against their plain versions on the card")
    for n, d in enumerate(sizes):
        check_kernels(d, n, rows, timed=d == sizes[-1])
        torch.cuda.empty_cache()
    if kernels_only:
        log(json.dumps(rows))
        log("kernels-only run: phases 3-4 skipped")
        return 0

    # -- phase 3: the main path at full width --
    from repro_torch.launch import train
    counters = {"fused_moments": fm.fused_moments,
                "tree_count": tc.tree_count,
                "compact_stage": cr.compact_stage,
                "compact_resid": cr.compact_resid}
    per_step = {"fused_moments": 12, "tree_count": 12, "compact_stage": 12,
                "compact_resid": 12}
    seen = []

    def probe(G, values, indices, mean, new_E):
        seen.append({n: f.launches for n, f in counters.items()})
        if len(seen) == 1:   # step 0: the residual was zero, u == G
            step = 1 << 28       # compare in 1 GiB slices, not one 6 GB sum
            for a in range(0, G.shape[1], step):
                cols = slice(a, a + step)
                assert torch.equal(mean[:, cols] + new_E[:, cols],
                                   G[:, cols]), ("bucket conservation", a)
            log(f"  step 0 bucket conserves bitwise: decode(v, i) + e' == "
                f"g over {G.numel():,} columns")

    steps, batch, seq = 3, 8, 128
    log("phase 3: llama3.2-1b at full width, 3 steps")
    torch.cuda.reset_peak_memory_stats()
    for f in counters.values():
        f.launches = 0
    records = train.run(["--arch", "llama3.2-1b", "--density-policy", "none",
                         "--steps", str(steps), "--batch", str(batch),
                         "--seq", str(seq), "--log-every", "1"],
                        probe=probe)
    launches = {n: f.launches for n, f in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for n, c in launches.items():
        assert c == per_step[n] * steps and c > 0, (n, c)
    for s, snap in enumerate(seen):
        for n, c in snap.items():
            assert c == per_step[n] * (s + 1), ("per-step launches", s, n, c)
    losses = [r["loss"] for r in records]
    assert all(math.isfinite(x) for x in losses), losses
    for r in records:
        assert r["density"] <= r["density_cap"], r
    step_ms = [r["ms"] for r in records]
    tok_s = batch * seq / (statistics.median(step_ms[1:]) / 1e3)
    log(f"  losses {losses}; step ms {[round(x, 1) for x in step_ms]} "
        f"(median of steps 1-2: {statistics.median(step_ms[1:]):.1f}); "
        f"{tok_s:.0f} tokens/s; peak memory {peak / 2**30:.2f} GiB; "
        f"launches {launches} = 12/12/12/12 per step")
    for n in counters:
        rows[n]["launches"] = launches[n]
        rows[n]["library_ms"] = None
    rows["pipeline"]["launches"] = None
    main_path = {"arch": "llama3.2-1b", "steps": steps, "batch": batch,
                 "seq": seq, "losses": losses, "step_ms": step_ms,
                 "tokens_per_s": tok_s, "peak_mem_gib": peak / 2**30,
                 "density": [r["density"] for r in records],
                 "density_cap": records[0]["density_cap"]}
    del records
    torch.cuda.empty_cache()

    # -- phase 4: card against CPU on a small config --
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data import lm_batch
    from repro_torch.dist.layout import build_layout
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.optim import constant, sgd_momentum
    from repro_torch.train import init_train_state, make_train_step

    cfg = ModelConfig(name="sys", arch_type="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=64).validate()
    comp = CompressionConfig(compressor="gaussiank", ratio=0.01)
    base = init_params(cfg, 0, "cpu")
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
        for i in range(2):
            b = lm_batch(i, global_batch=4, seq_len=16,
                         vocab=cfg.vocab_size, device=dev)
            state, m = step(state, b)
            ls.append(float(m["loss"]))
        out[dev] = ls
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4)
    log(f"phase 4: card {out['cuda']} vs CPU {out['cpu']} within rtol 1e-4")

    log(json.dumps({"pipeline": rows["pipeline"], "main_path": main_path,
                    "build_s": build_s}))
    log(json.dumps({"kernels": [rows[n] for n in counters]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
