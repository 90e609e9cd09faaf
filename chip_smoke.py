#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --kernels-only  # phases 1-2 at small sizes
    python3 chip_smoke.py --serve-only    # phases 1 and 10
    python3 chip_smoke.py --arch-only     # phases 1 and 11
    python3 chip_smoke.py --model-axis-only  # phase 1, 2's M = 2 rows, 12
    python3 chip_smoke.py --tensor-parallel-only  # phases 1, 12b, 12c
                                          # (NCCL when two cards are visible)
    python3 chip_smoke.py --tensor-parallel-cards  # phase 1 and the TP
                                          # step at 1x4 on four cards
    python3 chip_smoke.py --tuner-only    # phases 1 and 13
    python3 chip_smoke.py --serve-placement-only  # phases 1 and 14
    python3 chip_smoke.py --remat-table-only  # phases 1 and 15
    python3 chip_smoke.py --long-seq-only  # phases 1 and 16 (with four
                                          # cards visible, 16c at 1x4)
    python3 chip_smoke.py --bf16-only     # phases 1, 17 and 18

Phases (any failure exits non-zero; nothing is wrapped to pass):

1. environment: card name and power limit, torch/CUDA versions, the
   kernels built from this checkout's sources (``nvcc`` for the CUDA
   C++, Triton's JIT for the rest) and the build time;
2. every kernel against its plain PyTorch version on the card, at d in
   {2048, 1,000,003, 268,435,456} (the last is the largest llama3.2-1b
   leaf, ``stack/0/ffn/w_gate``; jamba-1.5-large's 536,870,912-element
   ``embed`` is phase 11a's, and the largest one-card leaf, gemma3-4b's
   671,088,640-element ``embed`` and ``lm_head``, phase 11b's; command-r-
   35b's 2,097,152,000-element ``embed`` runs as rows of 524,288,000 at
   M = 4 on four cards):
   K1 ``fused_moments`` with and without
   its histogram, K2 ``tree_count``, the K3 stage and residual launches,
   and the unfused pipeline's K4a ``moments``, K4b ``count_gt``, K4c
   ``threshold_compact`` and K4d ``abs_histogram`` (integer outputs and
   copies of ``u`` bitwise, moments within tolerance); the unfused
   pipeline against the fused one, bitwise, for gaussiank, gaussiank2
   and histk; the K3 stage, the K3 residual (``k_cap`` whole and
   halved, in place too), K4c and K4d bitwise on views at storage
   offsets 1 and 3 (the scalar-load path), blocks 1024/2048/4096/1001,
   thresholds 0 (blocks overflow) and above ``max|u|`` (nothing
   selected), and K1 with its histogram and K4d on one-bin, all-zero
   and zero/subnormal/inf/``>= edge[127]`` inputs, with NaNs too (K1
   also on views at offsets 1 and 3 and on ``g``, ``e`` misaligned
   apart; its histogram bitwise, absmax exact, the same bits twice); K1, K2, the K3 sweep and both K3 launches
   on every row of an ``(M, d_row_total)`` bucket at M = 2 (the
   1,000,003- and the 268,435,456-element leaves' rows, at ``ceil(k /
   2)`` each, as segment windows at their storage offsets).  At the
   largest size each kernel is timed with CUDA events (median after
   warm-up), K4c at block 2048 too, and
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
       launches a step of K1, K2 and the K3 sweep;
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
   1's, compared on the card; 12 launches a step of K1, K2 and the K3 sweep;
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
11. slices 8 and 16, the MoE, Mamba-hybrid, xLSTM, sliding-window and
   parallel blocks and the ``embeds`` frontend (``phase11_archs``): 11a
   K1 (with and without its histogram), K2, the K3 sweep and both K3
   launches at d = 536,870,912 (jamba-1.5-large's ``embed``) bitwise
   their plain versions (moments within tolerance), timed; 11b
   ``launch.train.run`` at full width, Gaussian-k fused, on
   deepseek-moe-16b (2 layers), jamba-1.5-large (1 layer: Mamba + MLP),
   musicgen-medium, xlstm-125m and stablelm-1.6b whole, phi3.5-moe (1
   layer, its config's ``absmax`` adaptive density) and llava-next-34b
   (2 layers, the ``embeds`` batch's three draws a step), 8 x 128, and
   gemma3-4b (6 layers: its 5:1 window pattern) at 2 x 2048 (the
   1024-token window masking keys, the query-chunked attention): one
   K1, K2 and K3 sweep a leaf a step, every step-0 bucket conserving
   bitwise, and gemma3-4b's 671,088,640-element ``embed`` row (the
   largest one-card leaf) through K1, K2 and the K3 launches bitwise
   their plain versions on the card; 11c ``launch.serve.run`` on the
   same eight, each at the deepest depth whose params fit the card
   twice (8 sequences, prompt 64, 8 new tokens), and one gemma3-4b
   request past its window (the ring cache wrapping; every step's logits
   against the whole sequence's forward); 11d the smoke variants card
   against CPU (losses, prefill and decode logits, greedy tokens; nine
   archs, gemma3-4b's window cut to 4) and jamba-smoke at chunks 3 and
   per leaf bitwise its bucketed run; 11e the dry run's count of each
   11b step (``step_cost.count_temp_bytes`` with the gradients' pack)
   within 25% of the card's;
12. slice 2c, the model axis (``phase12_model_axis``): 12a
   ``train.run`` at ``--mesh 4x2 --host-devices 8``, the reference's
   default mesh, at full llama3.2-1b width and depth (96 launches a
   step of each Gaussian-k kernel, every worker's two-row bucket
   conserving bitwise; step ms, peak memory); 12b the tensor-parallel
   step at ``--mesh 1x2`` in two processes (NCCL with a card each, else
   gloo on the one card) at full width with 2 layers (cut from 16 for
   the smoke's time), each rank holding its shards: 12 launches a
   step a rank of each kernel, the losses the one-process ``--mesh
   1x2`` run's within rtol 1e-6, step ms, relayout ms and each rank's
   peak memory; on one shared random gradient, the relayout both ways
   and each row's compression bitwise the one-process bucket's row; 12c
   the tensor-parallel step of the MoE, Mamba and xLSTM blocks at full
   width, ``--mesh 1x2``, 2 steps: deepseek-moe-16b (1 layer),
   jamba-1.5-large (1 layer) and xlstm-125m (2 layers), each against
   its one-process ``--mesh 1x2`` run (losses within rtol 1e-6, the wire
   accounting equal, one K1, K2 and K3 sweep a leaf a step a rank), and
   xlstm-125m's per-leaf loop bitwise its bucketed TP run; step ms,
   relayout ms and its share of the step, peak memory a rank;
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
   13f ``dryrun`` on meta for all ten archs at ``4x2`` (no card: in a
   process of its own, started after the build, since PR 28) and
   ``table2_scaling``'s rows;
14. slice 7.2, serving placed over the mesh and the tensor-parallel
   publisher (``phase14_placed``; two processes on the card, gloo): 14a
   ``launch.serve.run`` at ``--mesh 1x2`` on llama3.2-1b at full width
   with 2 layers (cut from 16 for the smoke's time), 10a's traffic,
   frozen and streaming, each rank holding half of every weight and of the KV cache: the prefill's and first
   decode's logits within 1e-4 of the largest one-process |logit|, the
   greedy tokens the one-process run's or near ties, at every publish
   each rank's pieces the cut of ``pub`` bitwise; prefill, decode-step,
   broadcast and apply ms, tokens/s, each rank's peak; 14b ``--mesh
   2x1`` in mode ``2d`` (half of every weight at rest a rank, half the
   batch) at 2 layers, the gathers' share of the decode step; 14c the
   tensor-parallel trainer at ``1x2`` with ``--publish-every 1
   --resync-every 2``, 4 steps at full width with 2 layers (cut from 16
   to keep the smoke inside its time; 12 launches a
   step a rank of K1, K2 and the K3 sweep; its records' publish kinds and bits
   and the ``published`` line the one-process ``1x2`` run's; on shared
   params the rows bitwise the one-process publisher's); 14d the smoke
   variants of deepseek-moe-16b, jamba-1.5-large, xlstm-125m and
   gemma3-4b (a sliding-window ring that wraps) at ``1x2`` against their
   one-process card runs.  ``--tensor-parallel-cards`` (four cards,
   NCCL) adds serving at ``1x4`` and ``2x2`` (llama3.2-1b,
   deepseek-moe-16b at 8 layers, command-r-35b at full width and depth)
   and the TP trainer's publisher at ``2x2`` (data replicas' rows
   equal), and trains command-r-35b at full width with 4 layers at
   ``1x4`` (its bucket fits int32 indices only in rows of a quarter;
   each rank's row and its compression bitwise the one-process bucket's
   on a shared random gradient);
15. slice 10, rematerialised training and the kernel-configuration
   table (``phase15_remat_table``): 15a ``train.run`` on llama3.2-1b at
   full width and depth, batch 8: at ``--seq 512`` 3 steps without and
   3 with rematerialisation (losses and the final params, momentum and
   residuals bitwise equal), then at ``--seq 1024`` 3 steps with it (the
   run without it would not fit the card and is not launched); losses,
   step ms and peak memory of each; 15b every leaf of phase 3's path
   resolving from the checked-in table (``source == "table"``), and K1,
   K2 and both K3 launches at the 268,435,456-element leaf at the
   table's config held against their plain versions and timed beside
   the heuristic config (block 1024), with the fused pipeline;
16. slice 11, long sequences (``phase16_long``): 16a ``models.prefill``
   of one 32,768-token prompt on llama3.2-1b at full width and depth
   (query-chunked attention: one block's f32 logits, 128 GiB a layer,
   would not fit), then 4 decode steps from its cache; prefill and
   decode-step ms, peak memory; 16b ``train.run`` with remat at 8 x 2048
   and 2 x 4096, 3 steps each (12 launches a step of K1, K2 and both
   K3), each step's memory, and at 8 x 2048 the one-block attention
   too (both peaks, the losses' bitwise equality a step); 16c
   ``shard_activations`` on the tensor-parallel llama3.2-1b at ``1x2``
   (gloo on one card, 2 x 1024): the loss and every gradient shard
   bitwise the run without, the memory kept at the end of the forward
   falling by the carries' ``(1 - 1/M)`` within 10%, the peaks and the
   dry run's count of their change; 16d ``step_cost.count_temp_bytes``
   of 16b's 8 x 2048 step and 16a's prefill within 25% of the card's
   peak above the memory allocated before them.
   ``--tensor-parallel-cards`` runs 16c at ``1x4`` over NCCL, 8 x 2048.
17. slice 12, bf16 operands (``phase17_bf16``): 17a every EF kernel at
   d = 268,435,456 with ``(g, e)`` in (bf16, bf16), (bf16, f32) and
   (bf16, None) at the table's bf16 geometry, bitwise its plain version
   (K4a-K4d on the pair's ``u`` in its promoted dtype; ``e'`` compared
   as int16 at bf16, in place over ``e``), the fused and unfused
   pipelines' conservation in that dtype, timed at (bf16, bf16) beside
   the plain versions and the bytes' bound; 17b llama3.2-1b at full
   width and depth in bf16 (params, activations, residual: the
   reference dry run's train step) at ``4x2`` in this process, 8 x 512
   with remat, 3 steps: 96 launches a step of K1, K2 and the K3 sweep, ``e'``
   written into the state's bf16 residual in place, every worker's
   step-0 bucket conserving bitwise in bf16, step ms and peak memory;
   17c row 0 of that step-0 bucket compressed on the CPU at the card's
   geometry, bitwise the card's pair and ``e'``, and the bf16 smoke
   variant 2 steps card against CPU (losses within rtol 2.5e-4).
18. slice 15, bf16 state end to end (``phase18_bf16_state``): 18a the
   dry run's count at the reference's bf16 dtypes
   (``step_cost.count_temp_bytes`` on the bf16 config, the dry run's
   ``_bf16``) within 25% of the card's peak above the memory allocated
   before: llama3.2-1b in bf16 at full width and depth, one worker, 8 x
   2048 with remat, 2 steps (12 launches a step of K1, K2 and the K3
   sweep), and a bf16 prefill of 1 x 32,768; 18b a bf16 train state
   (params, momentum, residual) of llama3.2-1b at full width with 2
   layers saved and loaded on the card (a temporary file, removed
   after): the loaded state bitwise the saved one, its next step
   bitwise the straight run's; 18c ``launch.serve.run`` in bf16 at full
   width and depth (8 requests, prompt 64, gen 16, the bf16 KV cache;
   the CLI's ``topk`` publisher, 1 resync and 3 deltas; tokens/s,
   prefill, decode, publish and apply ms), bf16-stream ``topk`` and
   ``gaussiank`` publishers through the library (``pub`` bitwise the
   packed replica after every message; K1, K2 and the K3 sweep 12 a
   ``gaussiank`` delta at bf16), and the bf16 smoke variant card
   against CPU (logits within 4 bf16 ulps of the largest |logit|,
   greedy tokens equal but near ties).  Each of its numbers is logged
   beside the card's name and power limit, and so is the whole smoke's
   time.

Every trainer path at full width trains as ``launch.train`` does
without ``--smoke``: each layer-pattern period rematerialised in the
backward.  Every kernel runs at the geometry ``kernels/ef_fused/
tuning.py`` resolves, the checked-in table's on the card.

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
                           "cuda", "src/repro_torch/csrc/abs_histogram.cu",
                           "src/repro/kernels/ef_fused/fused_moments.py:144"),
    "tree_count": ("tree_count (K2)", "cuda",
                   "src/repro_torch/csrc/tree_count.cu",
                   "src/repro/kernels/ef_fused/tree_count.py:93"),
    "compact_stage": ("compact_residual stage (K3)", "cuda",
                      "src/repro_torch/csrc/compact_residual.cu",
                      "src/repro/kernels/ef_fused/compact_residual.py:191"),
    "compact_resid": ("compact_residual residual (K3)", "cuda",
                      "src/repro_torch/csrc/compact_residual.cu",
                      "src/repro/kernels/ef_fused/compact_residual.py:208"),
    "compact_sweep": ("compact_residual one sweep (K3)", "cuda",
                      "src/repro_torch/csrc/compact_residual.cu",
                      "src/repro/kernels/ef_fused/compact_residual.py:237"),
    "moments": ("moments (K4a)", "triton",
                "src/repro_torch/kernels/moments/moments.py",
                "src/repro/kernels/moments/moments.py:48"),
    "count_gt": ("count_gt (K4b)", "cuda",
                 "src/repro_torch/csrc/tree_count.cu",
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
MAIN_KERNELS = ("fused_moments", "tree_count", "compact_sweep")
# the sweep's cross-check: the stage and residual launches (the
# reference's GPU lowering) run in phases 2, 11a, 15b and 17a, on no path
CROSS_CHECK_KERNELS = ("compact_stage", "compact_resid")


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
            "compact_sweep": cr.compact_sweep,
            "moments": mom.moments,
            "count_gt": cg.count_gt,
            "threshold_compact": thc.threshold_compact,
            "abs_histogram": hist.abs_histogram,
            "threefry_bits": threefry.threefry_bits}


def build(cuda_build, torch) -> float:
    """Build the CUDA libraries (one nvcc per source, all started
    together, from a thread) while Triton compiles every specialisation
    of the Triton kernels (K1 without its histogram and K4a,
    ``threefry_bits``) on tiny inputs; returns the seconds taken."""
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
    xb = x.bfloat16()
    # every operand-dtype specialisation of the Triton kernels: f32, and
    # bf16 with an e of either dtype or none
    for d in (4096, 4095):
        for g, e in ((x, x), (xb, xb), (xb, x), (x, xb), (xb, None)):
            k["fused_moments"](g[:d], None if e is None else e[:d],
                               block=1024)
        for u in (x, xb):
            k["moments"](u[:d], block=1024)
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


def check_k1_hist(label, g, e, sb) -> float:
    """K1 with its histogram on ``(g, e)`` (views allowed) against its
    plain version on the card: the histogram bitwise and summing to
    ``d``, absmax exact, ``s`` and ``sq`` within :func:`check_moments`'
    tolerances, the same bits on a second launch, one launch counted a
    call.  Where a plain moment is not finite: ``sq`` (a sum of
    non-negative terms) the same inf or NaN, ``s`` NaN where ``u`` holds
    a NaN and else not finite (an inf that meets f32 overflow gives inf
    or NaN by the order of the sum); absmax always exact.  Returns the
    moments' larger error (0 where one is not finite)."""
    import torch

    from repro_torch.kernels.ef_fused import fused_moments as fm
    n0 = fm.fused_moments_hist.launches
    got = fm.fused_moments_hist(g, e, block=sb)
    assert fm.fused_moments_hist.launches == n0 + 1, (label, "K1 launches")
    want = fm.fused_moments_hist_plain(g, e, block=sb)
    assert torch.equal(got[3], want[3]), (label, "K1 histogram")
    assert int(got[3].sum()) == g.shape[0], (label, "K1 histogram total")
    again = fm.fused_moments_hist(g, e, block=sb)
    assert all(same_bits(a, b) for a, b in zip(got, again)), (
        label, "K1 histogram rerun")
    u = g.double() if e is None else g.double() + e.double()
    if all(math.isfinite(float(x)) for x in want[:3]):
        return check_moments(label, "K1 hist", got[:3], want[:3],
                             float(u.abs().sum()))
    (s, sq, mx), (ps, psq, pmx) = ([float(x) for x in t[:3]]
                                   for t in (got, want))
    assert mx == pmx or (math.isnan(mx) and math.isnan(pmx)), (
        label, "K1 hist absmax", mx, pmx)
    if math.isfinite(psq):
        assert abs(sq - psq) <= 1e-5 * abs(psq), (label, "K1 hist sq")
    else:
        assert sq == psq or (math.isnan(sq) and math.isnan(psq)), (
            label, "K1 hist sq", sq, psq)
    if math.isfinite(ps):
        assert abs(s - ps) <= 1e-5 * float(u.abs().sum()), (
            label, "K1 hist s", s, ps)
    elif bool(u.isnan().any()):
        assert math.isnan(s) and math.isnan(ps), (label, "K1 hist s", s)
    else:
        assert not math.isfinite(s), (label, "K1 hist s", s, ps)
    return 0.0


def same_bits(a, b) -> bool:
    """Bitwise equality: same shape and dtype, f32 compared as int32,
    bf16 as int16."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def check_edge_cases(d, g, e, u, thres, bcap, ubcap) -> str:
    """K3 stage, the K3 residual launch, K4c and K4d against their plain
    versions, bitwise, on the cases the kernels treat apart: contiguous
    views at storage offsets 0, 1 and 3 (1 and 3 take the scalar-load
    path), blocks 1024, 2048, 4096 and 1001 (not a multiple of 4), at
    the final threshold, at 0 (every non-zero element is counted; nearly
    every block overflows its staging width) and just above ``max|u|``
    (nothing selected); the residual also at a ``k_cap`` that cuts the
    staged elements in half and in place over (a copy of) ``e``; K1 with
    its histogram (with ``e`` and without) and K4d also on one magnitude
    (one bin), all zeros, zeros, subnormals, infinities and values at or
    above ``edge[127]``, and the same with NaNs (:func:`check_k1_hist`).
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
                enc = cr.exclusive_enc(want[2], bcap)
                staged = int(enc[-1]) + min(int(want[2][-1]), bcap)
                for k_cap, inplace in ((max(1, staged), False),
                                       (max(1, staged // 2), True)):
                    rp = cr.compact_resid_plain(gv, ev, t, enc, block=block,
                                                bcap=bcap, k_cap=k_cap)
                    dst = ev.clone() if inplace else None
                    rk = cr.compact_resid(gv, ev if dst is None else dst, t,
                                          enc, block=block, bcap=bcap,
                                          k_cap=k_cap, out=dst)
                    assert same_bits(rk, rp), (d, "K3 residual", off, block,
                                               t, k_cap, inplace)
                    del rp, rk, dst
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
    nans = mixed.clone()
    nans[5::12] = math.nan
    inputs = {"u": u, "one magnitude": torch.full_like(u, 0.37),
              "zeros": torch.zeros_like(u), "mixed": mixed, "nan": nans}
    for name, x in inputs.items():
        for off in (0, 1, 3):
            h = hist.abs_histogram(x[off:])
            assert torch.equal(h, hist.abs_histogram_plain(x[off:],
                                                           block=4096)), (
                d, "K4d", name, off)
            assert int(h.sum()) == d - off, (d, "K4d total", name, off)
            if name != "u":
                for ev in (None, e[off:]):
                    check_k1_hist((d, "edge", name, off, ev is None),
                                  x[off:], ev, 4096)
        check_k1_hist((d, "edge", name, "g, e offset 0/1"), x[:d - 1],
                      e[1:], 4096)
    del mixed, nans, inputs
    return (f"K3 stage, the K3 residual (k_cap whole and halved, in place "
            f"too), K4c and K4d bitwise at storage offsets 0/1/3, "
            f"blocks 1024/2048/4096/1001, thresholds final/0/above max "
            f"({full} overflowing rows at threshold 0); K1 with its "
            f"histogram (views at offsets 0/1/3 and g, e misaligned "
            f"apart) and K4d on one magnitude, zeros, "
            f"zeros/subnormals/inf/>= edge[127], and with NaNs")


def check_main_kernels(g, e, k: int, label):
    """K1, K2, the K3 sweep and both K3 launches of the Gaussian-k path
    on ``(g, e)`` (views allowed) at budget ``k`` against their plain
    versions on the card: moments within tolerance, counts, staging and
    residual bitwise, the sweep bitwise the two launches and the
    assembly (:func:`check_sweep`), and the fused pipeline's
    conservation bitwise.  Returns
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
    sb, block, w = cfg.stats_block, cfg.block, cfg.num_warps
    k_cap = gaussiank_cap(k, d)
    bcap = ops.fused_default_bcap(k_cap, d, block, cfg.bcap_slack)
    # K1
    s, sq, mx = fm.fused_moments(g, e, block=sb, num_warps=w)
    ps, psq, pmx = fm.fused_moments_plain(g, e, block=sb)
    sum_abs = float((g + e).abs().double().sum())
    k1_err = check_moments(label, "K1", (s, sq, mx), (ps, psq, pmx),
                           sum_abs)
    # K2 at the refinement tree of the plain moments
    t0 = ops.gaussian_t0(ps, psq, d, k, False)
    heap, n_cnt = ops._tree_thresholds(t0, 4)
    thr = torch.from_numpy(heap[:n_cnt])   # on the host, as ops passes it
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
    check_sweep(torch, g, e, thres, block, bcap, k_cap, label)
    # the pipeline: conservation decode(v, i) + e' == g + e, bitwise
    v, i, ne = ops.fused_compress_ef(g, e, "gaussiank", k)
    assert torch.equal(codec.decode(v, i, d) + ne, g + e), (label,
                                                            "conserve")
    nnz = int(codec.nnz(i))
    log(f"  {label}: K1 max error {k1_err:.3g}, absmax exact; K2 counts "
        f"exact {cnt_k.tolist()[:3]}...; K3 staging + residual bitwise "
        f"(block {block}, bcap {bcap}, {int(ck.sum())} over threshold "
        f"{thres:.6g}); the K3 sweep bitwise the two launches and the "
        f"assembly, in place too; pipeline conserves bitwise, "
        f"{nnz}/{k_cap} slots for k={k}; K1/K2 at stats block {sb}, K1 "
        f"{w} warps ({cfg.source})")
    return types.SimpleNamespace(
        sb=sb, block=block, k_cap=k_cap, bcap=bcap, warps=w, cfg=cfg,
        ubcap=gops.default_bcap(k_cap, d, block), s=s, sq=sq, ps=ps,
        psq=psq, pmx=pmx, sum_abs=sum_abs, k1_err=k1_err, heap=heap,
        thr=thr, cnt_k=cnt_k, thres=thres, vk=vk, ok=ok, ck=ck, enc=enc)


SWEEP_OUTS = ("vals", "offs", "cnt", "e'", "wire values", "wire indices")


def check_sweep(torch, g, e, thres, block, bcap, k_cap, label):
    """The K3 one sweep bitwise the stage and residual launches plus
    ``assemble_staging``: the staging rows, the counts, ``e'`` and the
    wire pair compared as integer bits; then again with ``e'`` written
    in place over (a copy of) ``e``, or of ``g`` without ``e``.  Returns
    the two-launch form's outputs."""
    from repro_torch.kernels.ef_fused import compact_residual as cr
    vk, ok, ck = cr.compact_stage(g, e, thres, block=block, bcap=bcap)
    rk = cr.compact_resid(g, e, thres, cr.exclusive_enc(ck, bcap),
                          block=block, bcap=bcap, k_cap=k_cap)
    want = (vk, ok, ck, rk) + cr.assemble_staging(
        vk, ok, ck, k_cap, block=block, out_dtype=rk.dtype)
    got = cr.compact_sweep(g, e, thres, block=block, bcap=bcap,
                           k_cap=k_cap)
    for a, b, what in zip(got, want, SWEEP_OUTS):
        assert same_bits(a, b), (label, "K3 sweep", what)
    del got
    inplace = e if e is not None and e.dtype == rk.dtype else (
        g if e is None else None)
    if inplace is not None:
        dst = inplace.clone()
        got = cr.compact_sweep(dst if e is None else g,
                               None if e is None else dst, thres,
                               block=block, bcap=bcap, k_cap=k_cap, out=dst)
        assert got[3].data_ptr() == dst.data_ptr(), (label, "in place")
        for a, b, what in zip(got, want, SWEEP_OUTS):
            assert same_bits(a, b), (label, "K3 sweep in place", what)
        del got, dst
    return want


def two_launch_times(torch, g, e, thres, block, bcap, k_cap, out, it):
    """CUDA-event medians of the K3 sweep and of the form it replaced on
    the path (the stage and residual launches, the exact cumsum between
    them and ``assemble_staging``), in turns: two-launch, sweep, sweep,
    two-launch.  Returns ``(sweep ms, two-launch ms)``, two runs each."""
    from repro_torch.kernels.ef_fused import compact_residual as cr

    def two():
        v, o, c, ne = cr.compact_residual(g, e, thres, block=block,
                                          bcap=bcap, k_cap=k_cap, out=out)
        return cr.assemble_staging(v, o, c, k_cap, block=block,
                                   out_dtype=ne.dtype)

    def sweep():
        return cr.compact_sweep(g, e, thres, block=block, bcap=bcap,
                                k_cap=k_cap, out=out)

    runs = {"two": [], "sweep": []}
    for name in ("two", "sweep", "sweep", "two"):
        runs[name].append(time_ms(two if name == "two" else sweep, it))
    return runs["sweep"], runs["two"]


def check_model_rows(torch, model_size: int = 2) -> None:
    """Phase 2 at a model axis of ``model_size``: K1, K2, both K3
    launches and the K3 sweep against their plain versions on every row
    of an ``(M,
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
    w, cfg = c.warps, c.cfg
    s, sq, ps, psq, pmx = c.s, c.sq, c.ps, c.psq, c.pmx
    sum_abs, k1_err, heap, thr, cnt_k = (c.sum_abs, c.k1_err, c.heap,
                                         c.thr, c.cnt_k)
    thres, vk, ok, ck, enc = c.thres, c.vk, c.ok, c.ck, c.enc
    nb, nbs = -(-d // block), -(-d // sb)
    del c

    # K1 with its histogram, and K4d on the materialised u
    u = g + e
    k1h_err = check_k1_hist(d, g, e, sb)
    hp = hist.abs_histogram_plain(u, block=sb)
    h4 = hist.abs_histogram(u, block=sb)
    assert torch.equal(h4, hp), (d, "K4d histogram")
    # K4a: the same per-block sums as K1, so bitwise K1's
    m4 = mom.moments(u, block=sb, num_warps=w)
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
    # per-block selection); at the table's blocks (at most 8192) both are
    # 64 at these sizes, so they truncate alike.
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
        "fused_moments": (
            lambda: fm.fused_moments(g, e, block=sb, num_warps=w),
            lambda: fm.fused_moments_plain(g, e, block=sb)),
        "fused_moments_hist": (
            lambda: fm.fused_moments_hist(g, e, block=sb),
            lambda: fm.fused_moments_hist_plain(g, e, block=sb)),
        "tree_count": (
            lambda: tc.tree_count(g, e, thr, block=sb),
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
        "compact_sweep": (
            lambda: cr.compact_sweep(g, e, thres, block=block, bcap=bcap,
                                     k_cap=k_cap, out=out),
            lambda: cr.compact_sweep_plain(g, e, thres, block=block,
                                           bcap=bcap, k_cap=k_cap)),
        "moments": (lambda: mom.moments(u, block=sb, num_warps=w),
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
    # the sweep beside the form it replaces on the path, timed in turns
    sweep_ms, two_ms = two_launch_times(torch, g, e, thres, block, bcap,
                                        k_cap, out, it)
    nt = thr.numel()
    # (bytes: each input of the function read once and each of its
    # outputs written once; ops; bytes of the per-program partial rows
    # the design writes and folds — for K4d and K1 with its histogram the
    # 1 KB of integer atomic adds each of their CTAs, at most one per SM,
    # makes into the output, and K1's 24-byte row a CTA — an overhead of
    # the design that the bound does not count)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    work = {
        "fused_moments": (8 * d + 12, 5 * d, 12 * nbs),
        # g and e read; the histogram and one f64 moments row an SM
        # written (the kernel's own reads and writes)
        "fused_moments_hist": (8 * d + 8 * 128 + 24 * sms, 20 * d,
                               (24 + 8 * 128) * sms),
        # the counts: one int32 atomic a CTA and threshold, folded into
        # the output (the bound counts the output once)
        "tree_count": (8 * d + 8 * nt, 17 * d, 0),
        "compact_stage": (8 * d + 8 * nb * bcap + 4 * nb, 3 * d, 0),
        "compact_resid": (12 * d + 8 * nb, 3 * d, 0),
        # g, e read; e', the rows, the counts and the pair written (the
        # status words, 8 bytes a group of blocks, are its design's)
        "compact_sweep": (12 * d + 8 * nb * bcap + 4 * nb + 8 * k_cap,
                          3 * d, 0),
        "moments": (4 * d + 12, 5 * d, 12 * nbs),
        "count_gt": (4 * d + 8, 3 * d, 0),
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
        if name in MAIN_KERNELS + ("fused_moments_hist",):
            rows[name]["config"] = {
                "block": block, "stats_block": sb, "num_warps": w,
                "bcap": bcap, "source": cfg.source}
    rows["compact_sweep"].update(
        turns_ms=sweep_ms, two_launch_ms=two_ms,
        two_launch_bound_share=rows["compact_sweep"]["bound_ms"]
        / statistics.median(two_ms))
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
        "fused gaussiank (K1, K2, K3 sweep)": (
            lambda: ops.fused_compress_ef(g, e, "gaussiank", k), ef, 28),
        "fused histk (K1 with histogram, K3 sweep)": (
            lambda: ops.fused_compress_ef(g, e, "histk", k), ef, 20),
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
              "compact_stage": 8, "compact_resid": 12, "compact_sweep": 12,
              "moments": 4,
              "count_gt": 4, "threshold_compact": 4, "abs_histogram": 4,
              "threefry_bits": 8}
# adaptive density compresses u = G + E in place: the kernels read u alone
ADAPTIVE_LEAF_BYTES = {"fused_moments": 4, "fused_moments_hist": 4,
                       "tree_count": 4, "compact_stage": 4,
                       "compact_resid": 8, "compact_sweep": 8}


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
    """``decode(values, indices) + new_E == G`` bitwise in ``new_E``'s
    dtype (f32, or bf16 for a bf16 residual), one 1 GiB column slice at
    a time (not one 6 GB decode); ``G`` may be a host copy."""
    step = 1 << 28
    D = G.shape[1]
    dev = new_E.device
    for m in range(G.shape[0]):
        v, i = values[m].to(new_E.dtype), indices[m].long()
        for a in range(0, D, step):
            b = min(a + step, D)
            sel = (i >= a) & (i < b)
            dec = torch.zeros(b - a, device=dev, dtype=new_E.dtype)
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


class StepMemory:
    """Wraps ``repro_torch.train.make_train_step`` while active: each
    step synchronised before and after, and its ``(memory allocated
    before it, the peak since the last reset before it, its own peak)``
    appended to ``steps`` (the peak counters reset at its start)."""

    def __init__(self, torch):
        self.torch, self.steps = torch, []

    def __enter__(self):
        from repro_torch import train
        self.mod, self.orig = train, train.make_train_step
        cuda = self.torch.cuda

        def measured(*a, **k):
            step = self.orig(*a, **k)

            def run(state, batch):
                cuda.synchronize()
                mem = [cuda.memory_allocated(), cuda.max_memory_allocated()]
                cuda.reset_peak_memory_stats()
                out = step(state, batch)
                cuda.synchronize()
                self.steps.append((*mem, cuda.max_memory_allocated()))
                return out
            return run

        train.make_train_step = measured
        return self

    def __exit__(self, *exc):
        self.mod.make_train_step = self.orig


def train_path(label, argv, expect, steps, torch, workers=1, cfg=None,
               global_check=False, levels=1, leaf_bytes=None, bounds=None,
               runner=None, mc_check="", leaves=12, step_memory=False,
               keep=None):
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
    returns the records (momentum correction has no flag).  ``leaves``
    is the model's leaf count (llama3.2-1b's 12 by default).  ``mc_check``
    holds, at step 0, momentum correction's zeroing at every index a
    worker sent: ``"v"`` of the velocities ``resid2``, ``"ev"`` of the
    residual too (not under gTop-k, whose merge drops land in it).
    The per-step ``bucket_compress`` ms (CUDA events) come back in
    ``extra["compress_ms"]``.

    ``step_memory`` wraps the train step (:class:`StepMemory`) and
    returns each step's ``(memory allocated before it, its own peak)``
    in ``extra["step_memory"]`` (step 0's own peak starts at the
    probe's reset, after its checks); ``keep`` (a column range ``(a,
    b)`` of row 0, fixed-k) returns worker 0's step-0 gradient and
    ``e'`` in it, copied to the host, as ``extra["kept"]``."""
    import contextlib

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
            if keep is not None and rank == 0:
                a, b = keep
                acc["kept"] = tuple(x[0, a:b].to("cpu", copy=True)
                                    for x in (G, new_E))
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
    mem = StepMemory(torch)
    with timer, mem if step_memory else contextlib.nullcontext():
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
    # each leaf's launches read and write its columns once
    step_bound = {n: (leaf_bytes or LEAF_BYTES)[n] * cols * (c // leaves)
                  / HBM_BYTES_PER_S * 1e3 for n, c in expect.items()}
    peak = max([peaks["after0"], peaks["step0"]]
               + [x for m in mem.steps for x in m[1:]])
    if step_memory:
        assert len(mem.steps) == steps, (label, mem.steps)
        peaks["after0"] = max([peaks["after0"]]
                              + [m[2] for m in mem.steps[1:]])
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
        "allocs": allocs, "peak_after0": peaks["after0"],
        "step_memory": [(m[0], m[2]) for m in mem.steps],
        "kept": acc.get("kept")}
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


def spawn_ranks(torch, target, args_of, world=2, deadline_s=600,
                **kw) -> tuple:
    """``world`` ranks of ``target(rank, world, backend, port,
    *args_of(backend, port), queue, **kw)`` spawned (NCCL with a card
    each when there are ``world`` cards, else gloo on the one card), each
    putting ``(rank, results)`` on the queue within ``deadline_s``;
    returns ``(backend, results by rank)``."""
    import multiprocessing as mp
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=target,
                         args=(r, world, backend, port,
                               *args_of(backend, port), queue), kwargs=kw)
             for r in range(world)]
    for p in procs:
        p.start()
    import queue as queue_mod
    got, deadline = {}, time.time() + deadline_s
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
            {"fused_moments_hist": 12, "compact_sweep": 12}, 3, torch,
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
                "compact_sweep", "moments", "count_gt",
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
            want -= 2
        assert r["passes"] == want, ("8c passes", r, want)
    out["8c"] = {"rows": rows, "bench": data["rows"]}
    log(f"phase 8c: fig4 smoke launched {launched}; passes "
        f"{[(r['method'], r['passes']) for r in data['rows'][:5]]} "
        "(baseline: unfused equal, fused two more for the interpret "
        "backend's operand add and residual scatter)")
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
        L), K1, K2 and the K3 sweep launches 12 a step; step ms, peak GiB and
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
         launches a step of K1, K2 and the K3 sweep (the ``topk`` publisher
         launches none), 2 deltas + 2 resyncs of the layout's bits; the
         checkpoint and resume on the small config on the card: 3 steps
         and a resumed fourth save what 4 straight steps save, bitwise
         (a full-width checkpoint of params, momentum, residual and the
         publisher's two buckets would be ~30 GB);
    10c. a ``gaussiank`` publisher through the library on llama3.2-1b,
         3 ticks (resync, delta, delta): K1, K2 and the K3 sweep launched 12
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
    log(f"  10b: K1, K2 and the K3 sweep 12 a step; published 2 deltas + 2 "
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


# the configs of phase 11b at full width: (arch, num_layers kept or None
# for the whole model, train steps, batch, seq).  The depths keep each
# bucket below 2**31 columns and the one-worker f32 state on one card;
# gemma3-4b's 2 x 2048 passes its 1024-token window, so the window masks
# keys and the query-chunked attention runs; phi3.5-moe trains under its
# config's own density policy (absmax), as the CLI does by default
ARCH_PATHS = (("deepseek-moe-16b", 2, 3, 8, 128),
              ("jamba-1.5-large-398b", 1, 2, 8, 128),
              ("musicgen-medium", None, 3, 8, 128),
              ("xlstm-125m", None, 3, 8, 128),
              ("stablelm-1.6b", None, 3, 8, 128),
              ("gemma3-4b", 6, 3, 2, 2048),
              ("phi3.5-moe-42b-a6.6b", 1, 3, 8, 128),
              ("llava-next-34b", 2, 3, 8, 128))
# 11c serves each arch at the deepest depth (at most its own) whose f32
# params, twice over (``serve.run``'s trainer and its replica), fit this
SERVE_PARAM_BYTES = 60 * 2 ** 30
# 11c: gemma3-4b's one request whose prompt and generated tokens pass its
# 1024-token window, so that the decode cache's ring (``pos % window``)
# wraps at full width
WRAP_PROMPT, WRAP_GEN = 1020, 16
# 11d: the smoke variants (arch, sliding window cut so that the prefill
# of 8 tokens and 4 decode steps wrap the ring, or None)
SMOKE_ARCHS = (("deepseek-moe-16b", None), ("phi3.5-moe-42b-a6.6b", None),
               ("jamba-1.5-large-398b", None), ("xlstm-125m", None),
               ("musicgen-medium", None), ("gemma3-4b", 4),
               ("stablelm-1.6b", None), ("llava-next-34b", None),
               ("command-r-35b", None))
# the largest one-card leaf: gemma3-4b's embed and lm_head (262144 x 2560)
GEMMA_EMBED = 671_088_640


def full_width(arch, layers):
    """``arch``'s config at full width, ``num_layers`` cut to ``layers``
    (None: the whole model)."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers).validate()
    return cfg


def serve_layers(arch) -> int:
    """The deepest ``num_layers`` of ``arch`` (at most its own) whose f32
    params, twice over, fit ``SERVE_PARAM_BYTES`` (counted on meta)."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    best = None
    for n in range(1, get_config(arch).num_layers + 1):
        meta = init_params(full_width(arch, n), 0, "meta")
        if 2 * 4 * sum(x.numel() for x in tree.leaves(meta)) > \
                SERVE_PARAM_BYTES:
            break
        best = n
    assert best, (arch, "no layer fits")
    return best


def embed_row_check(torch, kept, seg, label) -> dict:
    """11b's direct check of gemma3-4b's ``embed`` row at step 0
    (``GEMMA_EMBED`` elements, the largest one-card leaf): the row's
    gradient and the residual it met (zero before step 0) through K1,
    K2, the K3 sweep and both K3 launches against their plain versions
    on the card (:func:`check_main_kernels`: counts, staging and ``e'``
    bitwise, the moments within tolerance, conservation), then the
    fused pipeline on the row alone bitwise the path's step-0 ``e'``."""
    from repro_torch.kernels.ef_fused import ops
    g_host, e_path = kept
    assert g_host.numel() == seg.size == GEMMA_EMBED, (label, seg)
    g = g_host.to("cuda")
    del g_host
    e = torch.zeros_like(g)
    got = check_main_kernels(g, e, seg.k_row, f"{label} embed row")
    assert got.k_cap == seg.k_cap, (label, got.k_cap, seg.k_cap)
    k1_err = got.k1_err
    del got
    _, _, ne = ops.fused_compress_ef(g, e, "gaussiank", seg.k_row,
                                     k_cap=seg.k_cap)
    assert same_bits(ne, e_path.to("cuda")), (label, "the path's e'")
    del g, e, ne
    torch.cuda.empty_cache()
    log(f"  {label}: the {GEMMA_EMBED:,}-element embed row's step-0 e' "
        f"bitwise the fused pipeline on the row alone")
    return {"d": GEMMA_EMBED, "k": seg.k_row, "k_cap": seg.k_cap,
            "k1_max_err": k1_err}


def gemma_wrap(torch) -> dict:
    """11c: one request to ``launch.serve.run`` on the whole gemma3-4b at
    full width, a prompt of ``WRAP_PROMPT`` tokens and up to
    ``WRAP_GEN`` new ones, so that the decode steps pass its 1024-token
    window and write its ring's slots ``pos % window`` over the
    prompt's; each step's logits held against ``models.forward`` of the
    whole sequence on the same weights (the prompt redrawn from the
    CLI's key) within ``TIE`` of its largest |logit|."""
    from repro_torch import prng
    from repro_torch.launch import serve
    from repro_torch.models import forward, init_params
    cfg = full_width("gemma3-4b", None)
    steps = {}

    def keep(wave, step, logits):
        steps[step] = logits[:, -1].clone()

    launches, got = zeroed(lambda: serve.run(
        ["--arch", "gemma3-4b", "--mesh", "1x1", "--requests", "1",
         "--max-batch", "1", "--prompt-len", str(WRAP_PROMPT), "--gen",
         str(WRAP_GEN)], cfg=cfg, on_logits=keep))
    want = {n: 0 for n in launches}
    want["threefry_bits"] = init_draws(cfg) + 2
    assert launches == want, ("11c wrap", launches, want)
    toks = got["tokens"][0]
    last = WRAP_PROMPT + toks.shape[1] - 2      # the last decode position
    assert last >= cfg.sliding_window, ("11c wrap", last)
    assert sorted(steps) == list(range(toks.shape[1])), sorted(steps)
    params = init_params(cfg, 0, "cuda")
    _, pk = prng.split(prng.PRNGKey(0))
    prompt = prng.randint(pk, (1, WRAP_PROMPT), 0, cfg.vocab_size,
                          device="cuda")
    seq = torch.cat([prompt, toks[:, :-1].cuda()], dim=1)
    with torch.no_grad():
        full = forward(params, cfg, seq, remat=False)[0]
    err = scale = 0.0
    for step, lg in steps.items():
        ref = full[WRAP_PROMPT - 1 + step]
        scale = max(scale, float(ref.abs().max()))
        err = max(err, float((lg[0] - ref).abs().max()))
    assert err <= TIE * scale, ("11c wrap logits", err, scale)
    del params, full, steps
    torch.cuda.empty_cache()
    out = {"prompt": WRAP_PROMPT, "generated": int(toks.shape[1]),
           "last_position": last, "ring_slots_rewritten": last + 1
           - cfg.sliding_window, "max_abs_logit_err": err,
           "logit_scale": scale, "decode_ms_median": med(
               got["times"]["decode"]), "prefill_ms": got["times"]["prefill"]}
    log(f"  11c gemma3-4b wrap: prompt {WRAP_PROMPT} + {toks.shape[1]} "
        f"tokens, decoded up to position {last} (ring of "
        f"{cfg.sliding_window}: {out['ring_slots_rewritten']} slots "
        f"rewritten); every step's logits within {err:.3g} of the "
        f"forward's (tolerance {TIE} x {scale:.3g}); prefill "
        f"{got['times']['prefill'][0]:.1f} ms, decode step median "
        f"{out['decode_ms_median']:.2f} ms")
    return out


def phase11e(torch, counts) -> dict:
    """11e: the dry run's count of each 11b step
    (``step_cost.count_temp_bytes`` on meta, rematerialised, with the
    gradients' pack into the f32 bucket) against the card: the step's
    peak above the memory allocated before it, the largest over the
    steps after step 0 (step 0's peak holds the conservation check's
    buffers); each within ``COUNT_TOLERANCE``, all logged first."""
    from repro_torch.launch import step_cost
    out = {}
    for label, (cfg, B, T, measured) in counts.items():
        counted = step_cost.count_temp_bytes(cfg, B, T, remat=True)
        ratio = counted["temp_bytes"] / measured
        out[label] = {"counted": counted["temp_bytes"],
                      "method": counted["method"], "measured": measured,
                      "ratio": ratio}
        log(f"phase 11e: {label}: counted "
            f"{counted['temp_bytes'] / 2 ** 30:.3f} GiB "
            f"({counted['method']}), measured {measured / 2 ** 30:.3f} GiB "
            f"on the card (count / card {ratio:.3f})")
    for label, row in out.items():
        assert abs(row["ratio"] - 1) <= COUNT_TOLERANCE, ("11e", label, row)
    return out


def phase11a_huge_leaf(torch, rows) -> dict:
    """11a: K1 (with and without its histogram), K2, both K3 launches and
    the K3 sweep at d = ``HUGE_LEAF`` (jamba's ``embed``; the largest
    one-card leaf, gemma3-4b's ``embed``, is checked in 11b by
    :func:`embed_row_check`) against their plain versions on the card — counts,
    the histogram, staging and residual bitwise,
    the sweep bitwise the two launches and the assembly (in place too),
    the moments within tolerance, the pipeline conserving — then each
    timed with CUDA events beside its plain version and its bound, the
    sweep in turns with the two-launch form; the times go into the
    kernel rows as ``*_536m``."""
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
    sb, block, w = cfg.stats_block, cfg.block, cfg.num_warps
    k_cap = gaussiank_cap(k, d)
    bcap = ops.fused_default_bcap(k_cap, d, block, cfg.bcap_slack)
    nb, nbs = -(-d // block), -(-d // sb)

    s, sq, mx = fm.fused_moments(g, e, block=sb, num_warps=w)
    ps, psq, pmx = fm.fused_moments_plain(g, e, block=sb)
    sum_abs = float((g + e).abs().double().sum())
    k1_err = check_moments(d, "K1", (s, sq, mx), (ps, psq, pmx), sum_abs)
    k1h_err = check_k1_hist(d, g, e, sb)
    t0 = ops.gaussian_t0(ps, psq, d, k, False)
    heap, n_cnt = ops._tree_thresholds(t0, 4)
    thr = torch.from_numpy(heap[:n_cnt])
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
    check_sweep(torch, g, e, thres, block, bcap, k_cap, f"11a d={d:,}")
    torch.cuda.empty_cache()
    v, i, ne = ops.fused_compress_ef(g, e, "gaussiank", k)
    assert torch.equal(codec.decode(v, i, d) + ne, g + e), (d, "conserve")
    nnz = int(codec.nnz(i))
    del v, i, ne
    torch.cuda.empty_cache()
    log(f"  d={d:,}: K1 max error {k1_err:.3g}, absmax exact; K1 with its "
        f"histogram bitwise (moments' max error {k1h_err:.3g}); K2 counts "
        f"exact {cnt_k.tolist()[:3]}...; K3 staging + residual bitwise "
        f"(block {block}, bcap {bcap}, {int(ck.sum())} over threshold "
        f"{thres:.6g}); the K3 sweep bitwise the two launches and the "
        f"assembly, in place too; pipeline conserves bitwise, "
        f"{nnz}/{k_cap} slots; K1/K2 at stats block {sb}, K1 {w} warps "
        f"({cfg.source})")

    out = torch.empty_like(g)
    ms = {
        "fused_moments": (
            lambda: fm.fused_moments(g, e, block=sb, num_warps=w),
            lambda: fm.fused_moments_plain(g, e, block=sb)),
        "fused_moments_hist": (
            lambda: fm.fused_moments_hist(g, e, block=sb),
            lambda: fm.fused_moments_hist_plain(g, e, block=sb)),
        "tree_count": (
            lambda: tc.tree_count(g, e, thr, block=sb),
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
        "compact_sweep": (
            lambda: cr.compact_sweep(g, e, thres, block=block, bcap=bcap,
                                     k_cap=k_cap, out=out),
            lambda: cr.compact_sweep_plain(g, e, thres, block=block,
                                           bcap=bcap, k_cap=k_cap)),
    }
    ms = {n: (time_ms(a, 10), time_ms(b, 3)) for n, (a, b) in ms.items()}
    sweep_ms, two_ms = two_launch_times(torch, g, e, thres, block, bcap,
                                        k_cap, out, 10)
    nt = thr.numel()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    work = {"fused_moments": (8 * d + 12, 5 * d),
            "fused_moments_hist": (8 * d + 8 * 128 + 24 * sms, 20 * d),
            "tree_count": (8 * d + 8 * nt, 17 * d),
            "compact_stage": (8 * d + 8 * nb * bcap + 4 * nb, 3 * d),
            "compact_resid": (12 * d + 8 * nb, 3 * d),
            "compact_sweep": (12 * d + 8 * nb * bcap + 4 * nb + 8 * k_cap,
                              3 * d)}
    res = {}
    for name, (k_ms, p_ms) in ms.items():
        b_ms, b_by = bound(*work[name])
        res[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
        rows[name].update(ms_536m=k_ms, plain_ms_536m=p_ms,
                          bound_ms_536m=b_ms, d_536m=d)
    rows["fused_moments"]["max_abs_err_536m"] = k1_err
    rows["fused_moments_hist"]["max_abs_err_536m"] = k1h_err
    res["compact_sweep"].update(turns_ms=sweep_ms, two_launch_ms=two_ms)
    rows["compact_sweep"].update(turns_ms_536m=sweep_ms,
                                 two_launch_ms_536m=two_ms)
    log(f"  times at d={d:,} (ms, median): " + ", ".join(
        f"{n} {r['ms']:.4f} (plain {r['plain_ms']:.3f}, bound "
        f"{r['bound_ms']:.4f})" for n, r in res.items()))
    del g, e, out
    torch.cuda.empty_cache()
    return {"d": d, "k": k, "nnz": nnz, "k1_max_err": k1_err,
            "k1_hist_max_err": k1h_err,
            "config": {"block": block, "stats_block": sb, "num_warps": w,
                       "bcap": bcap, "source": cfg.source},
            "kernels": res}


def phase11_archs(torch, by_path, rows) -> dict:
    """Phase 11, slices 8 and 16: the MoE, Mamba-hybrid, xLSTM,
    sliding-window and parallel blocks and the ``embeds`` frontend, each
    path with the launch counters set to 0 just before it and read just
    after.

    11a. K1, K2, the K3 sweep and both K3 launches at d = 536,870,912
         against their plain versions, timed (``phase11a_huge_leaf``);
    11b. ``launch.train.run`` at full width, Gaussian-k fused at 0.001
         (the CLI's default), world 1, each of ``ARCH_PATHS`` at its
         depth, batch and sequence (:func:`train_path`): one K1, K2 and
         K3 sweep launch a leaf a step (and an ``embeds`` batch's three
         draws a step), every step-0 bucket conserving bitwise; step ms
         and the compression's ms within it (CUDA events around
         ``bucket_compress``), losses, peak memory and each step's
         memory.  gemma3-4b at 2 x 2048 runs ``layers._sdpa_chunked``
         with its 1024-token window and without (its global layer), and
         its step-0 ``embed`` row goes through :func:`embed_row_check`;
         phi3.5-moe trains under its config's ``absmax`` (K1 as pass A
         once a segment row, ``k_total`` the host's budget every step,
         ``sum(k) == K_eff``, every ``k`` within its bounds);
    11c. ``launch.serve.run`` on the same archs, each at the deepest
         depth whose two copies of the params fit ``SERVE_PARAM_BYTES``
         (:func:`serve_layers`): 8 sequences, prompt 64, up to 8 new
         tokens (KV, ring, Mamba and xLSTM caches, the embeddings
         prompts); prefill ms, decode ms a step, peak memory; the
         launches the params' and the prompts' draws; then gemma3-4b's
         window ring wrapping (:func:`gemma_wrap`);
    11d. card against CPU on the smoke variants of ``SMOKE_ARCHS`` (MoE,
         Mamba, attention, MLP, xLSTM, sliding-window and parallel
         blocks, the embeddings frontend): 2 train steps each (the CPU at
         the card's block geometry), losses within rtol 1e-4; prefill
         and 4 decode steps, logits within rtol 1e-5 (atol 1e-5), the
         greedy tokens equal; jamba-smoke at chunks 3 and per leaf
         bitwise its bucketed run on the card;
    11e. the dry run's count of each 11b step against the card
         (:func:`phase11e`)."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.core import adaptk
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.compressors import get_compressor
    from repro_torch.data import batch_for
    from repro_torch.dist.layout import build_layout
    from repro_torch.kernels.ef_fused import tuning
    from repro_torch.launch import serve, train
    from repro_torch.models import decode_step, init_params, layers, prefill
    t_start = time.time()
    out = {}

    log(f"phase 11a: K1, K2, the K3 sweep and both K3 launches at "
        f"d={HUGE_LEAF:,} (jamba-1.5-large's embed) against their plain "
        f"versions; the largest one-card leaf, gemma3-4b's embed and "
        f"lm_head ({GEMMA_EMBED:,}), is held in 11b, and command-r-35b's "
        f"embed (2,097,152,000) runs as rows of 524,288,000 at M = 4 on "
        f"four cards")
    out["11a"] = phase11a_huge_leaf(torch, rows)
    out["11a_s"] = time.time() - t_start

    chunked = {}
    one_block = layers._sdpa_chunked

    def count_chunked(q, k, v, cfg, window, chunk):
        chunked[window] = chunked.get(window, 0) + 1
        return one_block(q, k, v, cfg, window, chunk)

    t0 = time.time()
    out["11b"], counts = {}, {}
    for arch, depth, steps, B, T in ARCH_PATHS:
        t_path = time.time()
        cfg = full_width(arch, depth)
        meta = init_params(cfg, 0, "meta")
        n_leaves = len(tree.leaves(meta))
        label = f"11b {arch}" + (f" ({depth} layers)" if depth else "")
        argv = ["--arch", arch, "--mesh", "1x1", "--batch", str(B),
                "--seq", str(T)]
        pol, policy = train.density_policy_of(train.parse_args(argv), cfg)
        lay = build_layout(meta, 1, RATIO, get_compressor("gaussiank"),
                           density_policy=pol)
        log(f"phase {label}: train.run at full width, Gaussian-k fused, "
            f"{steps} steps of {B} x {T}, {n_leaves} leaves, "
            f"{lay.d_row_total:,} bucket columns, density policy "
            f"{policy or 'none'}")
        expect = {n: n_leaves for n in MAIN_KERNELS}
        if batch_draws(cfg):
            expect["threefry_bits"] = batch_draws(cfg)
        kw = {}
        if pol is not None:
            kw = {"leaf_bytes": ADAPTIVE_LEAF_BYTES,
                  "bounds": ([s.k_lo for s in lay.segments],
                             [s.k_hi for s in lay.segments])}
        embed = {s.name: s for s in lay.segments}["embed"]
        if embed.size == GEMMA_EMBED:
            kw["keep"] = (embed.row_off, embed.row_off + embed.size)
        chunked.clear()
        layers._sdpa_chunked = count_chunked
        try:
            by_path[label], recs, peak, _, extra = train_path(
                label, argv, expect, steps, torch, cfg=cfg,
                leaves=n_leaves, step_memory=True, **kw)
        finally:
            layers._sdpa_chunked = one_block
        res = {"num_layers": cfg.num_layers, "batch": B, "seq": T,
               "leaves": n_leaves, "bucket_columns": lay.d_row_total,
               "params": sum(x.numel() for x in tree.leaves(meta)),
               "density_policy": policy or None,
               "losses": [r["loss"] for r in recs],
               "step_ms": [r["ms"] for r in recs],
               "compress_ms": extra["compress_ms"],
               "peak_gib": peak / 2 ** 30,
               "step_memory": extra["step_memory"],
               "launches": by_path[label]}
        if pol is not None:
            K = int(adaptk.budget([s.size for s in lay.segments], RATIO,
                                  pol))
            assert [k for _, k in extra["allocs"]] == [K] * steps, (
                label, extra["allocs"], K)
            res["k_total"] = [r["k_total"] for r in recs]
            log(f"  {label}: k_total {K} every step (the host's budget), "
                f"sum(k) == K_eff, every k within its bounds")
        if T > layers._SDPA_CHUNK and T % layers._SDPA_CHUNK == 0:
            want = {cfg.sliding_window if cfg.block_kind(i) == "swa" else 0
                    for i in range(cfg.num_layers)
                    if cfg.block_kind(i) in ("attn", "swa")}
            assert set(chunked) == want and all(chunked.values()), (
                label, "chunked attention", chunked, want)
            res["chunked_calls"] = dict(chunked)
            log(f"  {label}: query-chunked attention calls by window "
                f"{chunked}")
        if extra["kept"] is not None:
            torch.cuda.empty_cache()
            res["embed_row"] = embed_row_check(torch, extra["kept"], embed,
                                               label)
        counts[label] = (cfg, B, T, max(p - b for b, p in
                                        extra["step_memory"][1:]))
        res["seconds"] = time.time() - t_path
        out["11b"][arch] = res
        log(f"  {label}: step ms {[round(x, 1) for x in res['step_ms']]} "
            f"(compression {[round(x, 1) for x in res['compress_ms']]}); "
            f"peak {res['peak_gib']:.2f} GiB; {res['seconds']:.1f} s")
        del recs, extra
        torch.cuda.empty_cache()
    out["11b_s"] = time.time() - t0

    t0 = time.time()
    out["11c"] = {}
    for arch, *_ in ARCH_PATHS:
        depth = serve_layers(arch)
        cfg = full_width(arch, depth)
        label = f"11c {arch} ({depth} of {full_width(arch, None).num_layers}"\
            " layers)"
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
        out["11c"][arch] = {"num_layers": depth,
                            "prefill_ms": times["prefill"],
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
    log("phase 11c gemma3-4b: one request past the 1024-token window")
    out["11c"]["gemma3-4b wrap"] = gemma_wrap(torch)
    out["11c_s"] = time.time() - t0

    t0 = time.time()
    out["11d"] = {}
    comp = CompressionConfig(compressor="gaussiank", ratio=0.01)
    for arch, window in SMOKE_ARCHS:
        cfg = smoke_cfg(arch, window)
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
        out["11d"][arch] = {"losses": losses, "max_abs_logit_err": err,
                            "sliding_window": cfg.sliding_window
                            if window else None}
        log(f"phase 11d {cfg.name}" + (f" (window {window})" if window
                                       else "") +
            f": card {losses['cuda']} vs CPU {losses['cpu']} within rtol "
            f"1e-4; prefill + 4 decode logits within rtol 1e-5, atol 1e-5 "
            f"(largest difference {err:.3g}), greedy tokens equal")
        del caches

    cfg = smoke_cfg("jamba-1.5-large-398b")
    n_leaves = len(tree.leaves(init_params(cfg, 0, "meta")))
    comp = CompressionConfig(ratio=RATIO)
    out["11d"]["jamba chunks"] = variant_runs(
        torch, by_path, "11d jamba-smoke", cfg,
        [("chunks 1", comp, False),
         ("chunks 3", CompressionConfig(ratio=RATIO, chunks=3), False),
         ("per leaf", comp, True)],
        steps=2, expect={n: n_leaves for n in MAIN_KERNELS})
    out["11d_s"] = time.time() - t0
    t0 = time.time()
    out["11e"] = phase11e(torch, counts)
    out["11e_s"] = time.time() - t0
    out["phase11_s"] = time.time() - t_start
    log(f"phase 11 took {out['phase11_s']:.1f} s (11a {out['11a_s']:.1f}, "
        f"11b {out['11b_s']:.1f}, 11c {out['11c_s']:.1f}, 11d "
        f"{out['11d_s']:.1f}, 11e {out['11e_s']:.1f})")
    return out


TP_STEPS = 3


def tp_shared_gradient(torch, rank, backend, port, world=2,
                       cfg=None) -> dict:
    """12b's check of the relayout and of the row's compression at full
    width, in a process group of ``world`` ranks of its own on ``port``:
    one shared random gradient of ``cfg`` (llama3.2-1b by default; drawn
    alike on every rank from one seed) cut to this rank's shards and
    moved into its row by ``ModelRow``, held against the one-process
    ``(world, d_row_total)`` bucket bitwise: the row equal to the
    bucket's row ``rank``, the bucket's row moved back equal to the
    shards, and ``bucket_compress`` of the row (K1-K3) equal to the whole
    bucket's row ``rank`` in values, indices, ``e'`` and nnz.  Returns
    the relayout's ms each way and the row's nnz."""
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
    init_process_group(backend, rank=rank, world_size=world,
                       local_rank=rank, local_world_size=world)
    try:
        cfg = cfg or get_config("llama3.2-1b")
        meta = init_params(cfg, 0, "meta")
        tp = tpm.TensorParallel(cfg, ProcessGroupWire(
            parse_mesh(f"1x{world}")), meta)
        M, r = tp.axis.size, tp.axis.rank
        comp = CompressionConfig(compressor="gaussiank", ratio=RATIO)
        layout = build_layout(meta, M, comp)
        dev = torch.device("cuda", torch.cuda.current_device())
        gen = torch.Generator(device=dev)
        gen.manual_seed(29)
        grads = [torch.randn(p.shape, generator=gen, device=dev).mul_(1e-3)
                 for p in tree.leaves(meta)]
        full = pack_grads(layout, grads, torch.float32)
        local = [tpm.shard(g, pl, r, M)
                 for g, pl in zip(grads, tp.placements)]
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
        del back, local
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


def tp_train(torch, argv, cfg=None, on_publish=None) -> dict:
    """One tensor-parallel rank's ``train.run(argv, cfg=cfg)`` (under a
    ``torchrun``-style environment set by the caller): its launches
    counted from 0, the relayout's ms a step (CUDA events around
    ``ModelRow.pack`` and ``ModelRow.unpack``), its peak memory and,
    with ``--publish-every``, each record's publish kind and bits and
    the ``published`` line rank 0 printed."""
    import contextlib
    import io
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
    funcs = counters()
    for f in funcs.values():
        f.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            recs = train.run(argv, cfg=cfg, on_publish=on_publish)
    finally:
        for n, f in origs.items():
            setattr(tpm.ModelRow, n, f)
    print(buf.getvalue(), end="", flush=True)
    torch.cuda.synchronize()
    launches = {n: f.launches for n, f in funcs.items()}
    ms = {n: [a.elapsed_time(b) for a, b in ev]
          for n, ev in events.items()}
    return {"losses": [r["loss"] for r in recs],
            "step_ms": [r["ms"] for r in recs],
            "density": [r["density"] for r in recs],
            "density_cap": recs[0]["density_cap"],
            "comm_bits_sparse": [r["comm_bits_sparse"] for r in recs],
            "collectives": [r["collectives_per_step"] for r in recs],
            "launches": launches,
            "pack_ms": ms["pack"], "unpack_ms": ms["unpack"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "device": torch.cuda.current_device(),
            "publish": [(r["publish_kind"], r["publish_bits"])
                        for r in recs if "publish_kind" in r],
            "published": [ln for ln in buf.getvalue().splitlines()
                          if ln.startswith("published")]}


def _tp_env(torch, rank, world, backend, port) -> None:
    sys.path.insert(0, os.path.join(HERE, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if backend == "nccl":
        torch.cuda.set_device(rank)


def tp_child(rank, world, backend, port, argv, check_port, queue,
             cfg=None, shared_cfg=None):
    """One rank of a tensor-parallel launch (12b's at ``--mesh 1x2``,
    the four-card command-r-35b's at ``1x4``): :func:`tp_train` of
    ``argv`` on ``cfg`` (12b's llama3.2-1b at ``TP_LAYERS`` by default),
    then :func:`tp_shared_gradient` of ``shared_cfg`` on ``check_port``;
    puts ``(rank, results)`` on ``queue``."""
    import traceback
    try:
        import torch
        _tp_env(torch, rank, world, backend, port)
        out = tp_train(torch, argv + ["--steps", str(TP_STEPS),
                                      "--dist-backend", backend],
                       cfg=cfg or llama_layers(TP_LAYERS))
        torch.cuda.empty_cache()
        out["shared_gradient"] = tp_shared_gradient(
            torch, rank, backend, check_port, world, shared_cfg)
        queue.put((rank, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def tp_blocks_child(rank, world, backend, port, runs, queue):
    """Phase 12c, one rank: :func:`tp_train` of each ``(label, argv, cfg,
    port)`` of ``runs`` in order, each on its own ``MASTER_PORT``; puts
    ``(rank, {label: results})`` on ``queue``."""
    import traceback
    try:
        import torch
        _tp_env(torch, rank, world, backend, port)
        out = {}
        for label, argv, cfg, run_port in runs:
            os.environ["MASTER_PORT"] = str(run_port)
            out[label] = tp_train(torch, argv + ["--dist-backend", backend],
                                  cfg)
        queue.put((rank, out))
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
         steps: 96 launches a step of K1, K2 and the K3 sweep (4 workers x 12
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
         one-process bucket's row (:func:`tp_shared_gradient`);
    12c. the tensor-parallel step of the MoE, Mamba and xLSTM blocks at
         ``--mesh 1x2`` (:func:`phase12c`)."""
    return {"12a": phase12a(torch, by_path, llama),
            "12b": phase12b(torch, by_path, llama),
            "12c": phase12c(torch, by_path)}


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


# 12b's trainers at full width and this depth (cut from 16 for the
# smoke's time): their relayout through gloo's host staging scales with
# the layers; the shared-gradient check keeps the whole model
TP_LAYERS = 2


def phase12b(torch, by_path, llama) -> dict:
    """12b of :func:`phase12_model_axis`, the trainers at ``TP_LAYERS``
    layers."""
    import numpy as np
    cfg = llama_layers(TP_LAYERS)
    label = "12b one process, mesh 1x2"
    log("phase 12b: the one-process --mesh 1x2 run the tensor-parallel "
        f"ranks are held to, {TP_LAYERS} layers, 3 steps")
    by_path[label], records, peak1, _, _ = train_path(
        label, llama + ["--host-devices", "2", "--mesh", "1x2"],
        {n: 24 for n in MAIN_KERNELS}, TP_STEPS, torch, cfg=cfg)
    ref = [r["loss"] for r in records]
    del records
    torch.cuda.empty_cache()
    log("phase 12b: the tensor-parallel step, --mesh 1x2 in 2 processes, "
        f"full width with {TP_LAYERS} layers, 3 steps")
    argv = llama + ["--mesh", "1x2", "--log-every", "1"]
    t0 = time.time()
    check_port = []

    def args_of(backend, port):
        # one port for both ranks' check group, not the launch's
        while not check_port or check_port[0] == port:
            check_port[:] = [free_port()]
        return argv, check_port[0]

    backend, got = spawn_ranks(torch, tp_child, args_of)
    draws = init_draws(cfg)
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


# the configs of phase 12c at full width: (arch, num_layers kept or None
# for the whole model); xlstm-125m also runs the per-leaf loop, at 2 of
# its 12 layers (one mLSTM/sLSTM period: its recurrences are host-bound,
# twice over with remat, and the whole model's 4 runs took ~35 s); the
# depths are cut for the smoke's time, every layer kind kept
TP_ARCHS = (("deepseek-moe-16b", 1), ("jamba-1.5-large-398b", 1),
            ("xlstm-125m", 2))
TP_BLOCK_STEPS = 2


def phase12c(torch, by_path) -> dict:
    """Phase 12c, slice 2d: the tensor-parallel step of the MoE, Mamba
    and xLSTM blocks at full width, ``--mesh 1x2``, Gaussian-k fixed-k at
    0.001, 8 x 128, 2 steps: deepseek-moe-16b at 1 of its 28 layers (MoE
    with shared experts), jamba-1.5-large at 1 of its 72 (Mamba + MLP)
    and xlstm-125m at 2 of its 12 (mLSTM + sLSTM), and xlstm-125m's
    per-leaf loop.
    Each first in one process (``--host-devices 2``: two rows a leaf,
    each worker's step-0 bucket conserving bitwise), then in two
    processes (``tp_blocks_child``; NCCL with a card each when two are
    visible, else gloo on the one card), each rank holding its shards:
    one K1, K2 and K3 sweep a leaf a step a rank (and the params' draws),
    the losses the one-process run's within rtol 1e-6, the wire
    accounting equal; the per-leaf run's losses, densities and wire
    bits bitwise the bucketed TP run's, one collective a leaf.  Step
    ms, relayout ms and each rank's peak memory."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.models import init_params
    t_start = time.time()
    out = {"one_process": {}, "ranks": {}}
    runs, want = [], {}
    for arch, layers in TP_ARCHS:
        cfg = full_width(arch, layers)
        n_leaves = len(tree.leaves(init_params(cfg, 0, "meta")))
        argv = ["--arch", arch, "--density-policy", "none", "--batch", "8",
                "--seq", "128", "--log-every", "1"]
        label = f"12c {arch}" + (f" ({layers} layers)" if layers else "")
        log(f"phase {label}: the one-process --mesh 1x2 run, "
            f"{TP_BLOCK_STEPS} steps, {n_leaves} leaves")
        by_path[label + " one process"], recs, peak, _, _ = train_path(
            label, argv + ["--host-devices", "2", "--mesh", "1x2"],
            {n: 2 * n_leaves for n in MAIN_KERNELS}, TP_BLOCK_STEPS, torch,
            cfg=cfg, leaves=n_leaves)
        out["one_process"][arch] = {
            "losses": [r["loss"] for r in recs],
            "step_ms": [r["ms"] for r in recs], "peak_gib": peak / 2**30,
            "comm_bits_sparse": [r["comm_bits_sparse"] for r in recs],
            "collectives": [r["collectives_per_step"] for r in recs]}
        del recs
        torch.cuda.empty_cache()
        tp_argv = argv + ["--mesh", "1x2", "--steps", str(TP_BLOCK_STEPS)]
        runs.append((label, tp_argv, cfg))
        want[label] = (arch, n_leaves, init_draws(cfg), None)
        if arch == "xlstm-125m":
            runs.append((label + " per leaf",
                         tp_argv + ["--pipeline", "perleaf"], cfg))
            want[label + " per leaf"] = (arch, n_leaves, init_draws(cfg),
                                         label)
    ports = []

    def args_of(backend, port):
        # a port a run for both ranks, none the launch's
        while len(ports) < len(runs):
            p = free_port()
            if p != port and p not in ports:
                ports.append(p)
        return ([r + (p,) for r, p in zip(runs, ports)],)

    log(f"phase 12c: the tensor-parallel step, --mesh 1x2 in 2 processes, "
        f"{len(runs)} runs of {TP_BLOCK_STEPS} steps")
    t0 = time.time()
    backend, got = spawn_ranks(torch, tp_blocks_child, args_of)
    out.update(backend=backend, cards=torch.cuda.device_count(),
               tp_wall_s=time.time() - t0)
    for label, (arch, n_leaves, draws, bucketed) in want.items():
        ref = out["one_process"][arch]
        for rank in range(2):
            res = got[rank][label]
            expect = {n: (n_leaves * TP_BLOCK_STEPS if n in MAIN_KERNELS
                          else draws if n == "threefry_bits" else 0)
                      for n in res["launches"]}
            assert res["launches"] == expect, (label, rank, res["launches"],
                                               expect)
            assert all(math.isfinite(x) for x in res["losses"]), label
            np.testing.assert_allclose(res["losses"], ref["losses"],
                                       rtol=1e-6, err_msg=label)
            if bucketed is None:
                assert res["comm_bits_sparse"] == ref["comm_bits_sparse"], \
                    label
                assert res["collectives"] == ref["collectives"], label
            else:
                base = got[rank][bucketed]
                for k in ("losses", "density", "comm_bits_sparse"):
                    assert res[k] == base[k], (label, rank, k)
                assert res["collectives"] == [float(n_leaves)] * len(
                    res["collectives"]), (label, res["collectives"])
            assert len(res["pack_ms"]) == len(res["unpack_ms"]) == (
                TP_BLOCK_STEPS * (n_leaves if bucketed else 1))
            by_path[f"{label}, rank {rank}"] = res["launches"]
            per = len(res["pack_ms"]) // TP_BLOCK_STEPS
            relayout = [sum(res["pack_ms"][i * per:(i + 1) * per])
                        + sum(res["unpack_ms"][i * per:(i + 1) * per])
                        for i in range(TP_BLOCK_STEPS)]
            share = [a / b for a, b in zip(relayout, res["step_ms"])]
            out["ranks"].setdefault(label, {})[rank] = {
                k: res[k] for k in ("losses", "step_ms", "peak_gib",
                                    "density", "device")}
            out["ranks"][label][rank].update(relayout_ms=relayout,
                                             relayout_share=share)
            log(f"  {label} rank {rank} (cuda:{res['device']}, {backend}): "
                f"losses {res['losses']} (one process {ref['losses']}); "
                f"step ms {[round(x, 1) for x in res['step_ms']]} (one "
                f"process {[round(x, 1) for x in ref['step_ms']]}); "
                f"relayout ms {[round(x, 1) for x in relayout]} "
                f"({[round(x, 3) for x in share]} of the step); peak "
                f"{res['peak_gib']:.2f} GiB (one process "
                f"{ref['peak_gib']:.2f}); launches "
                f"{({n: c for n, c in res['launches'].items() if c})}")
    out["phase12c_s"] = time.time() - t_start
    log(f"phase 12c took {out['phase12c_s']:.1f} s (the two processes "
        f"{out['tp_wall_s']:.1f} s)")
    return out


# the four-card measurement (``--tensor-parallel-cards``, not a phase):
# (arch, num_layers kept) at --mesh 1x4 over NCCL, and the profiler's
# tensor-parallel breakdown of the first
TP_CARD_ARCHS = (("deepseek-moe-16b", 8), ("jamba-1.5-large-398b", 1))
TP_CARD_STEPS = 3


def tp_cards_child(rank, world, backend, port, runs, prof, queue):
    """One rank of the four-card measurement: :func:`tp_train` of each
    ``(label, argv, cfg, port)`` of ``runs``, then ``launch.profile``'s
    tensor-parallel breakdown of ``prof`` (its printed lines and its
    JSON line); puts ``(rank, results)`` on ``queue``."""
    import contextlib
    import io
    import traceback
    try:
        import torch
        _tp_env(torch, rank, world, backend, port)
        out = {}
        for label, argv, cfg, run_port in runs:
            os.environ["MASTER_PORT"] = str(run_port)
            out[label] = tp_train(torch, argv + ["--dist-backend", backend],
                                  cfg)
        from repro_torch.launch import profile
        argv, cfg, run_port = prof
        os.environ["MASTER_PORT"] = str(run_port)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            profile.main(argv + ["--dist-backend", backend], cfg=cfg)
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("{")]
        out["profile"] = {"text": buf.getvalue(),
                          "json": json.loads(lines[-1]) if lines else None}
        queue.put((rank, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def tensor_parallel_cards(torch) -> dict:
    """The tensor-parallel step on four cards over NCCL, ``--mesh 1x4``,
    Gaussian-k fixed-k at 0.001, 8 x 128, ``TP_CARD_STEPS`` steps:
    deepseek-moe-16b at 8 of its 28 layers (5.1 B params, ~19 GiB of
    state a rank) and jamba-1.5-large at 1 of its 72, each rank holding a
    quarter of every split leaf: one K1, K2 and K3 sweep a leaf a step a
    rank, the same losses on every rank; jamba's losses within rtol 1e-6
    of its one-process ``--mesh 1x4`` run on card 0 (deepseek's 8 layers
    do not fit one card).  Step ms, relayout ms and its share, peak a
    rank; then ``launch.profile``'s tensor-parallel breakdown of the
    deepseek config (rank 0 prints every rank's and the slowest); then
    command-r-35b trained at ``1x4`` (:func:`command_r_cards`), serving
    (:func:`placed_cards`) and 16c at ``1x4``."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.models import init_params
    cards = torch.cuda.device_count()
    assert cards >= 4, ("--tensor-parallel-cards needs four cards", cards)
    t_start = time.time()
    out = {"one_process": {}, "ranks": {}}
    runs, want = [], {}
    for arch, layers in TP_CARD_ARCHS:
        cfg = full_width(arch, layers)
        n_leaves = len(tree.leaves(init_params(cfg, 0, "meta")))
        argv = ["--arch", arch, "--density-policy", "none", "--batch", "8",
                "--seq", "128", "--log-every", "1"]
        label = f"4 cards {arch} ({layers} layers)"
        if arch == "jamba-1.5-large-398b":
            log(f"{label}: the one-process --mesh 1x4 run on card 0")
            _, recs, peak, _, _ = train_path(
                label, argv + ["--host-devices", "4", "--mesh", "1x4"],
                {n: 4 * n_leaves for n in MAIN_KERNELS}, TP_CARD_STEPS,
                torch, cfg=cfg, leaves=n_leaves)
            out["one_process"][label] = {
                "losses": [r["loss"] for r in recs],
                "step_ms": [r["ms"] for r in recs],
                "peak_gib": peak / 2**30}
            del recs
            torch.cuda.empty_cache()
        runs.append((label, argv + ["--mesh", "1x4", "--steps",
                                    str(TP_CARD_STEPS)], cfg))
        want[label] = (n_leaves, init_draws(cfg))
    prof_cfg = full_width(*TP_CARD_ARCHS[0])
    prof_argv = ["--arch", TP_CARD_ARCHS[0][0], "--density-policy", "none",
                 "--batch", "8", "--seq", "128", "--mesh", "1x4",
                 "--steps", str(TP_CARD_STEPS)]
    ports = []

    def args_of(backend, port):
        while len(ports) < len(runs) + 1:
            p = free_port()
            if p != port and p not in ports:
                ports.append(p)
        return ([r + (p,) for r, p in zip(runs, ports)],
                (prof_argv, prof_cfg, ports[-1]))

    log(f"four cards: the tensor-parallel step, --mesh 1x4 in 4 processes, "
        f"{len(runs)} runs of {TP_CARD_STEPS} steps, then the profiler")
    backend, got = spawn_ranks(torch, tp_cards_child, args_of, world=4)
    assert backend == "nccl", backend
    for label, (n_leaves, draws) in want.items():
        for rank in range(4):
            res = got[rank][label]
            expect = {n: (n_leaves * TP_CARD_STEPS if n in MAIN_KERNELS
                          else draws if n == "threefry_bits" else 0)
                      for n in res["launches"]}
            assert res["launches"] == expect, (label, rank, res["launches"])
            assert all(math.isfinite(x) for x in res["losses"]), label
            assert res["losses"] == got[0][label]["losses"], (label, rank)
            if label in out["one_process"]:
                np.testing.assert_allclose(
                    res["losses"], out["one_process"][label]["losses"],
                    rtol=1e-6, err_msg=label)
            relayout = [a + b for a, b in zip(res["pack_ms"],
                                              res["unpack_ms"])]
            share = [a / b for a, b in zip(relayout, res["step_ms"])]
            out["ranks"].setdefault(label, {})[rank] = {
                k: res[k] for k in ("losses", "step_ms", "peak_gib",
                                    "density", "device")}
            out["ranks"][label][rank].update(relayout_ms=relayout,
                                             relayout_share=share)
            log(f"  {label} rank {rank} (cuda:{res['device']}, {backend}): "
                f"losses {res['losses']}; step ms "
                f"{[round(x, 1) for x in res['step_ms']]}; relayout ms "
                f"{[round(x, 1) for x in relayout]} "
                f"({[round(x, 3) for x in share]} of the step); peak "
                f"{res['peak_gib']:.2f} GiB")
    prof = got[0]["profile"]
    assert prof["json"] is not None, prof["text"][-2000:]
    for line in prof["text"].splitlines():
        if not line.startswith("{"):
            log("  profile: " + line)
    out["profile"] = prof["json"]
    out["command-r-35b"] = command_r_cards(torch)
    out["serving"] = placed_cards(torch)
    out["16c"] = phase16c(torch, 4)
    out["seconds"] = time.time() - t_start
    log(f"four cards took {out['seconds']:.1f} s")
    return out


# the four-card training of command-r-35b (``--tensor-parallel-cards``):
# full width at this depth, --mesh 1x4 over NCCL.  Its 256000 x 8192
# embed (2,097,152,000 elements) puts its bucket over the int32 index
# range at a model axis below 4 (4,898,971,648 columns at one layer); at
# 1x4 a row is 1,753,237,504 columns, the embed's 524,288,000 of them
CMDR_TRAIN_LAYERS = 4


def command_r_cards(torch) -> dict:
    """command-r-35b (parallel attention and FFN blocks) trained on four
    cards: ``train.run`` at ``--mesh 1x4`` over NCCL, full width with
    ``CMDR_TRAIN_LAYERS`` layers, Gaussian-k fixed-k at 0.001, 8 x 128,
    ``TP_STEPS`` steps, each rank holding a quarter of every split leaf:
    one K1, K2 and K3 sweep a leaf a step a rank, the same finite losses
    on every rank; then :func:`tp_shared_gradient` at 1x4 (the model does
    not fit one card, its ``(4, 1,753,237,504)`` f32 bucket does): each
    rank's relayout and its row's compression bitwise the one-process
    bucket's.  Step ms, relayout ms and each rank's peak."""
    from repro_torch import tree
    from repro_torch.models import init_params
    assert torch.cuda.device_count() >= 4, "command-r-35b needs four cards"
    t0 = time.time()
    cfg = full_width("command-r-35b", CMDR_TRAIN_LAYERS)
    n_leaves = len(tree.leaves(init_params(cfg, 0, "meta")))
    argv = ["--arch", "command-r-35b", "--density-policy", "none",
            "--batch", "8", "--seq", "128", "--mesh", "1x4", "--log-every",
            "1"]
    check_port = []

    def args_of(backend, port):
        while not check_port or check_port[0] == port:
            check_port[:] = [free_port()]
        return argv, check_port[0]

    label = f"4 cards command-r-35b ({CMDR_TRAIN_LAYERS} layers)"
    log(f"{label}: the tensor-parallel step, --mesh 1x4 in 4 processes, "
        f"{TP_STEPS} steps, then the shared-gradient check")
    backend, got = spawn_ranks(torch, tp_child, args_of, world=4,
                               cfg=cfg, shared_cfg=cfg)
    assert backend == "nccl", backend
    draws = init_draws(cfg)
    ranks = {}
    for rank in range(4):
        res = got[rank]
        want = {n: (n_leaves * TP_STEPS if n in MAIN_KERNELS else
                    draws if n == "threefry_bits" else 0)
                for n in res["launches"]}
        assert res["launches"] == want, (rank, res["launches"], want)
        assert all(math.isfinite(x) for x in res["losses"]), res["losses"]
        assert res["losses"] == got[0]["losses"], (rank, res["losses"])
        assert len(res["pack_ms"]) == len(res["unpack_ms"]) == TP_STEPS
        relayout = [a + b for a, b in zip(res["pack_ms"],
                                          res["unpack_ms"])]
        ranks[rank] = {k: res[k] for k in ("losses", "step_ms", "peak_gib",
                                           "density", "device",
                                           "launches", "shared_gradient")}
        ranks[rank].update(relayout_ms=relayout, relayout_share=[
            a / b for a, b in zip(relayout, res["step_ms"])])
        log(f"  {label} rank {rank} (cuda:{res['device']}, {backend}): "
            f"losses {res['losses']}; step ms "
            f"{[round(x, 1) for x in res['step_ms']]}; relayout ms "
            f"{[round(x, 1) for x in relayout]}; peak "
            f"{res['peak_gib']:.2f} GiB; launches {res['launches']}; "
            f"shared gradient bitwise (relayout and row compression): "
            f"{res['shared_gradient']}")
    out = {"backend": backend, "num_layers": CMDR_TRAIN_LAYERS,
           "leaves": n_leaves, "ranks": ranks, "seconds": time.time() - t0}
    log(f"{label} took {out['seconds']:.1f} s")
    return out


# -- phase 13: the launch and tuning stack (slice 9) --

TUNE_STEPS = 2


def phase13_tuner(torch, by_path, llama, dry=None) -> dict:
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
         launches a step of K1, K2 and the K3 sweep), and ``--mesh 2x2x1
         --host-devices 4 --topology <the reference's asym>`` at 4
         layers (5b's cut: the per-worker gTop-k buffers of 16 layers
         exceed the card), which must choose ``hier_gtopk`` (96 a step:
         the pod means are compressed again, 5b's count); the printed
         decision ``choose_strategy``'s on the run's layout, the losses
         and every step's residual digests bitwise; step ms, peak
         memory;
    13e. ``launch.step_cost`` and ``launch.roofline`` on 13d's 4x1 step:
         the counted FLOPs (rematerialised, as 13d trains) against
         6·N·tokens, the wire counted through
         ``ByteCountingWire`` during the explicit run, the roofline
         under ``H100_SXM``, and the share of the f32 peak,
         ``model_flops / (s x 67e12)``, of the forward plus backward
         alone at world 1 (CUDA events) and of the 4x1 step;
    13f. ``launch.dryrun`` on the meta device for all ten archs x their
         input shapes at ``4x2`` (every applicable cell ``OK``) and
         ``benchmarks.table2_scaling``'s rows (merge rows on the card).
         The dry run uses no card: it runs in a process of its own,
         ``dry`` (:func:`start_dryrun`, started after the build by a
         whole run, so that its minutes on the host overlap the card's
         phases; else here)."""
    out = {"13a": phase13a(), "13b": phase13b(torch)}
    out["13c"], topo_path = phase13c(torch)
    out["13d"], cost_in = phase13d(torch, by_path, llama, topo_path)
    out["13e"] = phase13e(torch, cost_in)
    out["13f"] = phase13f(dry or start_dryrun())
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
                               wire_counts=cost_in["wire"], remat=True)
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
    # CUDA events, not rematerialised (comparable with earlier runs)
    full = llama_layers(16)
    params = init_params(full, 0, "cuda")
    leaves = tree.leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    b = batch_for(full, 0, global_batch=batch, seq_len=seq, device="cuda")

    def fwd_bwd():
        loss, _ = loss_fn(params, full, b, remat=False)
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


# 13f's dry run in a process of its own: meta tensors, no card, one thread
# (the records to the path table2_scaling reads, the seconds to stdout)
DRYRUN_CODE = ("import json, sys, time, torch; torch.set_num_threads(1); "
               "from repro_torch.launch import dryrun; t = time.time(); "
               "json.dump(dryrun.run_all(mesh='4x2'), open(sys.argv[1], 'w'));"
               " print('dryrun seconds', time.time() - t)")
_DRYRUNS = []   # started dry-run processes, stopped at exit


def start_dryrun():
    """Start 13f's ``dryrun.run_all(mesh="4x2")`` in a process of its own
    (the card hidden from it, one thread): returns ``(process, json
    path)``.  :func:`stop_dryruns` ends any still running."""
    import tempfile
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"),
                        "dryrun.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", DRYRUN_CODE, path],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    _DRYRUNS.append(proc)
    return proc, path


def stop_dryruns() -> None:
    for proc in _DRYRUNS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase13f(dry) -> dict:
    from repro_torch.benchmarks import table2_scaling
    proc, path = dry
    t0 = time.time()
    log_out, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, ("13f dryrun process", proc.returncode,
                                  log_out[-3000:])
    seconds = [float(ln.split()[-1]) for ln in log_out.splitlines()
               if ln.startswith("dryrun seconds ")]
    assert len(seconds) == 1, ("13f dryrun output", log_out[-3000:])
    with open(path) as f:
        recs = json.load(f)
    bad = [(r["arch"], r["shape"], r.get("error")) for r in recs
           if r["status"] == "FAIL"]
    assert not bad, ("13f dryrun", bad)
    ok = sum(r["status"] == "OK" for r in recs)
    t1 = time.time()
    rows = table2_scaling.run(smoke=False, device="cuda", dryrun_json=path)
    merge = [r for r in rows if r[0].startswith("table2/merge/")]
    eff = [r for r in rows if r[0].startswith("table2/eff/")]
    assert len(eff) == 10 and len(merge) == 2, rows
    log(f"phase 13f: dryrun at 4x2 on meta: {ok} OK, "
        f"{len(recs) - ok} SKIP, 0 FAIL ({seconds[0]:.1f} s in its "
        f"own process, {t1 - t0:.1f} s of it waited for here); table2 "
        f"{len(rows)} rows ({time.time() - t1:.1f} s); merge rows {merge}")
    return {"ok": ok, "skip": len(recs) - ok,
            "dryrun_s": seconds[0], "dryrun_waited_s": t1 - t0,
            "merge_rows": merge, "eff_rows": eff,
            "flops_methods": {f"{r['arch']}/{r['shape']}":
                              r["flops"]["method"] for r in recs
                              if r["status"] == "OK"}}


# -- phase 14: serving placed over the mesh (slice 7.2) --

# 14d: the smoke variants served at 1x2 (arch, sliding window cut so that
# 14a's prompt of 64 and 16 new tokens wrap the ring, or None)
PLACED_SMOKE = (("deepseek-moe-16b", None), ("jamba-1.5-large-398b", None),
                ("xlstm-125m", None), ("gemma3-4b", 32))
# 14b: each decode step gathers the other half of every weight over
# gloo (0.33 GB/s on one card), so the vocabulary-wide embedding and
# head with this many layers, one wave of 8 requests of up to 8 tokens
PLACED_2D_LAYERS = 2
PLACED_2D_TRAFFIC = ["--requests", "8", "--gen", "8"]
# 14a's serving at full width and this depth (cut from 16 for the
# smoke's time): each decode step's collectives over gloo scale with the
# layers
PLACED_LAYERS = 2
# 14c's shared-params check at full width: rank 0 holds the whole params
# and the one-process publisher beside its own row's, so this depth
SHARED_LAYERS = 2
# 14c's trainers at full width and this depth: their relayout through
# gloo's host staging scales with the layers, and at 16 they took
# 98.5-141.8 s of the smoke
PUBLISH_LAYERS = 2
# a near tie: the one-process logits' top two within TIE of the row's
# largest |logit|; the placed logits within TIE of the step's
TIE = 1e-4


def placed_argv(mesh, arch="llama3.2-1b"):
    """14a's traffic (12 requests, waves of 8, prompt 64, gen 16) at
    ``mesh``."""
    return ["--arch", arch, "--mesh", mesh] + SERVE_ARGV[4:]


def smoke_cfg(arch, window=None):
    """``arch``'s smoke variant, its sliding window cut to ``window``."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window).validate()
    return cfg


def logit_log(keep_all):
    """``(on_logits, store)``: the last position's logits of each wave's
    steps (every step, or steps 0 and 1) as ``{(wave, step): (B, V)}``
    float32 numpy arrays."""
    store = {}

    def on_logits(wave, step, logits):
        if keep_all or step < 2:
            store[(wave, step)] = logits[:, -1].float().cpu().numpy()

    return on_logits, store


def hold_tokens(label, got, ref, ref_logits) -> list:
    """The placed run's greedy tokens ``got`` against the one-process
    run's ``ref`` (a (B, L) array a wave): equal, or at a row's first
    differing token a near tie in the one-process logits of that step
    (top-two gap <= ``TIE`` of the row's largest |logit|).  Returns the
    near ties as ``(wave, row, step, gap, scale)``."""
    import numpy as np
    ties = []
    assert len(got) == len(ref), (label, "waves")
    for w, (a, b) in enumerate(zip(got, ref)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (label, w, a.shape, b.shape)
        for row in range(b.shape[0]):
            diff = np.nonzero(a[row] != b[row])[0]
            if not len(diff):
                continue
            col = int(diff[0])
            lg = ref_logits[(w, col)][row]
            top = np.sort(lg)[-2:]
            gap, scale = float(top[1] - top[0]), float(np.abs(lg).max())
            assert gap <= TIE * scale, (label, "token", w, row, col, gap,
                                        scale)
            ties.append((w, row, col, gap, scale))
    return ties


def hold_logits(label, got, ref, ties) -> float:
    """The prefill's and first decode's logits of every wave within
    ``TIE`` of the step's largest one-process |logit| (a row whose
    prefill token was a near tie decodes another token: its first
    decode is skipped); returns the largest error over its scale."""
    import numpy as np
    worst = 0.0
    tied = {(w, r) for w, r, c, _, _ in ties if c == 0}
    for (w, step), g in sorted(got.items()):
        want = ref[(w, step)]
        rows = [i for i in range(g.shape[0])
                if step == 0 or (w, i) not in tied]
        err = float(np.abs(g[rows] - want[rows]).max())
        scale = float(np.abs(want[rows]).max())
        assert err <= TIE * scale, (label, "logits", w, step, err, scale)
        worst = max(worst, err / scale)
    return worst


def placed_checker(torch, counts):
    """A probe for every publish of a placed run, outside its timed
    window: every rank's pieces against the cut of rank 0's ``pub``
    (the packed one-process replica, 10a's invariant) under that rank's
    placement, rank 0's own bitwise (``torch.equal``), the others' by
    ``device_digest`` (the pieces stay on their ranks); ``counts``
    collects the kinds and each publish's peak since the previous one."""
    import torch.distributed as dist

    from repro_torch import tree

    def probe(event, msg, layout, state, trainer, replica, placed):
        counts.setdefault("peaks", []).append(
            torch.cuda.max_memory_allocated())
        pairs = tree.flatten_with_path(replica)[0]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (placed.model_rank, placed.data_rank,
                                       [device_digest(torch, x)
                                        for _, x in pairs]))
        if state is not None:
            pub = state["pub"][0]
            for i, (seg, (path, x)) in enumerate(zip(layout.segments,
                                                     pairs)):
                whole = pub[seg.row_off:seg.row_off + seg.size].view(
                    seg.shape)
                assert torch.equal(placed.cut(path, whole), x), (
                    "placed piece", seg.name, msg.seq)
                for r, j, digs in every[1:]:
                    want = device_digest(torch, placed.cut(
                        path, whole, model_rank=r, data_rank=j))
                    assert digs[i] == want, ("placed piece", seg.name, r, j,
                                             msg.seq)
        counts.setdefault("kinds", []).append(msg.kind)
        torch.cuda.reset_peak_memory_stats()

    return probe


def serve_placed_child(rank, world, backend, port, runs, queue):
    """One rank of the placed serving launches: ``launch.serve.run`` of
    each ``(label, argv, cfg, port, streaming)`` of ``runs`` in order
    (``cfg`` None: ``argv``'s arch), its launches counted from 0, the
    prefill's and first decode's logits of every wave, its times and
    peak memory, and with ``streaming`` :func:`placed_checker` at every
    publish; puts ``(rank, {label: results})`` on ``queue``."""
    import traceback
    try:
        # rank 0's publisher and a resync's leaves are transients of many
        # sizes beside the other rank on the one card
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        import torch
        _tp_env(torch, rank, world, backend, port)
        from repro_torch.launch import serve
        out = {}
        for label, argv, cfg, run_port, streaming in runs:
            t0 = time.time()
            os.environ["MASTER_PORT"] = str(run_port)
            counts = {}
            on_logits, store = logit_log(False)
            funcs = counters()
            for f in funcs.values():
                f.launches = 0
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            got = serve.run(argv + ["--dist-backend", backend], cfg=cfg,
                            on_logits=on_logits,
                            probe=(placed_checker(torch, counts)
                                   if streaming else None))
            torch.cuda.synchronize()
            res = {k: got[k] for k in ("done", "waves", "tokens_out",
                                       "decode_steps", "deltas", "resyncs",
                                       "wire_bits", "seconds", "tok_s")}
            res.update(tokens=[t.numpy() for t in got["tokens"]],
                       times=got["times"], logits=store,
                       launches={n: f.launches for n, f in funcs.items()},
                       peak_gib=max([torch.cuda.max_memory_allocated()]
                                    + counts.get("peaks", [])) / 2**30,
                       kinds=counts.get("kinds", []),
                       device=torch.cuda.current_device())
            out[label] = res
            del got
            if rank == 0:
                log(f"  {label}: served in {time.time() - t0:.1f} s, peak "
                    f"{res['peak_gib']:.2f} GiB on rank 0")
        queue.put((rank, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def rounded(rep, key):
    """``rep[key]``'s ms to one decimal (empty when absent)."""
    return [round(x, 1) for x in rep.get(key, [])]


def placed_report(label, res, ref, ref_logits, draws, rank) -> dict:
    """Hold one rank's placed serving run against the one-process run
    ``ref`` (its tokens and every step's logits): the counters equal,
    the tokens equal or near ties, the prefill's and first decode's
    logits within ``TIE`` (rank 0's), the launches the params' draws and
    two ``threefry_bits`` a wave (the prompts); returns the summary."""
    want = {n: 0 for n in res["launches"]}
    want["threefry_bits"] = draws + 2 * res["waves"]
    assert res["launches"] == want, (label, rank, res["launches"], want)
    for k in ("done", "waves", "tokens_out", "decode_steps", "deltas",
              "resyncs", "wire_bits"):
        assert res[k] == ref[k], (label, rank, k, res[k], ref[k])
    ties = hold_tokens(label, res["tokens"], [t.numpy()
                                               for t in ref["tokens"]],
                       ref_logits)
    err = (hold_logits(label, res["logits"], ref_logits, ties)
           if res["logits"] else None)
    t = res["times"]
    out = {"prefill_ms": t["prefill"], "decode_ms_median": med(t["decode"]),
           "tok_s": res["tok_s"], "seconds": res["seconds"],
           "peak_gib": res["peak_gib"], "near_ties": ties,
           "logit_err_over_scale": err, "device": res["device"]}
    for k in ("publish_delta", "publish_resync", "apply_delta",
              "apply_resync", "broadcast", "gather_prefill",
              "gather_decode"):
        if k in t:
            out[k + "_ms"] = t[k]
    if "gather_decode" in t:
        # the decode steps' gathers, step by step, over the step's ms
        per = len(t["gather_decode"]) // max(1, len(t["decode"]))
        out["gather_share_of_decode"] = med([
            sum(t["gather_decode"][i * per:(i + 1) * per]) / d
            for i, d in enumerate(t["decode"])])
    return out


def phase14_placed(torch, by_path) -> dict:
    """Phase 14, slice 7.2: serving placed over the mesh and the
    tensor-parallel publisher, two processes on the one card over gloo
    (NCCL with a card each when two are visible), each run held against
    its one-process run (here, on the card) and each path's launches
    counted from 0:

    14a. ``launch.serve.run`` at ``--mesh 1x2`` on llama3.2-1b at full
         width with ``PLACED_LAYERS`` layers, 12 requests, waves of 8,
         prompt 64, gen 16,
         frozen and with ``--publish-every 4 --publish-ratio 0.01
         --resync-every 3``: each rank holds half of every weight and of
         the KV cache; the prefill's and first decode's logits within
         ``TIE`` of the largest one-process |logit| (the row-parallel
         sums reassociate), the greedy tokens equal or, at a row's first
         difference, a near tie in the one-process logits (reported);
         at every publish each rank's pieces are the cut of ``pub``
         bitwise (:func:`placed_checker`); prefill and decode-step ms,
         publish, broadcast and apply ms, tokens/s, each rank's peak;
    14b. ``--mesh 2x1``, mode ``2d``, frozen, at ``PLACED_2D_LAYERS``
         layers (the embedding and head at full width), one wave of 8
         requests of up to 8 tokens (``PLACED_2D_TRAFFIC``): half of every
         weight at rest on each rank (gathered a block at a time over
         the data group), half the batch each; held as 14a against the
         one-process run at that depth; the gathers' share of the decode
         step;
    14c. the tensor-parallel trainer at ``--mesh 1x2`` with
         ``--publish-every 1 --resync-every 2``, llama3.2-1b at full
         width with ``PUBLISH_LAYERS`` layers, 4 steps
         (:func:`phase14c`);
    14d. the smoke variants of deepseek-moe-16b, jamba-1.5-large,
         xlstm-125m and gemma3-4b (its sliding window cut to 32, so the
         ring wraps) served at ``1x2`` against their one-process card
         runs, held as 14a."""
    from repro_torch.launch import serve
    t_start = time.time()
    out = {"runs": {}}
    placed = llama_layers(PLACED_LAYERS)
    refs = {}
    log("phase 14: the one-process runs the placed ones are held to "
        "(llama3.2-1b frozen and streaming, the 14d smoke variants), "
        "every step's logits kept")
    for name, argv, cfg in (
            [("frozen", SERVE_ARGV + ["--publish-every", "0"], placed),
             ("streaming", SERVE_ARGV + STREAM_ARGV, placed),
             ("frozen cut", SERVE_ARGV + ["--publish-every", "0"]
              + PLACED_2D_TRAFFIC, llama_layers(PLACED_2D_LAYERS))]
            + [(arch, placed_argv("1x1", arch) + ["--smoke"],
                smoke_cfg(arch, window)) for arch, window in PLACED_SMOKE]):
        on_logits, store = logit_log(True)
        got = serve.run(argv, cfg=cfg, on_logits=on_logits)
        refs[name] = (got, store)
        out.setdefault("one_process", {})[name] = {
            "decode_ms_median": med(got["times"]["decode"]),
            "tok_s": got["tok_s"]}
        torch.cuda.empty_cache()
    runs = [("14a frozen 1x2", placed_argv("1x2"), placed, "frozen",
             placed),
            ("14a streaming 1x2", placed_argv("1x2") + STREAM_ARGV, placed,
             "streaming", placed),
            ("14b 2d 2x1", placed_argv("2x1") + PLACED_2D_TRAFFIC,
             llama_layers(PLACED_2D_LAYERS), "frozen cut",
             llama_layers(PLACED_2D_LAYERS))]
    runs += [(f"14d {arch} 1x2", placed_argv("1x2", arch) + ["--smoke"],
              smoke_cfg(arch, window), arch, smoke_cfg(arch, window))
             for arch, window in PLACED_SMOKE]
    ports = []

    def args_of(backend, port):
        while len(ports) < len(runs):
            p = free_port()
            if p != port and p not in ports:
                ports.append(p)
        return ([(label, argv, cfg, p, "--publish-every" in argv)
                 for (label, argv, cfg, _, _), p in zip(runs, ports)],)

    log("phase 14a, 14b, 14d: the placed runs, 2 processes, "
        + ", ".join(r[0] for r in runs))
    t0 = time.time()
    backend, got = spawn_ranks(torch, serve_placed_child, args_of,
                               deadline_s=900)
    out.update(backend=backend, placed_wall_s=time.time() - t0)
    for label, _, _, ref_name, cfg in runs:
        ref, ref_logits = refs[ref_name]
        for rank in range(2):
            res = got[rank][label]
            if rank:
                res["logits"] = {}      # rank 0's are the whole batch's
            rep = placed_report(label, res, ref, ref_logits,
                                init_draws(cfg), rank)
            if "streaming" in label:
                assert res["kinds"] and res["kinds"][0] == 0, res["kinds"]
                rep["publishes_checked"] = len(res["kinds"])
            out["runs"].setdefault(label, {})[rank] = rep
            by_path[f"{label}, rank {rank}"] = res["launches"]
            log(f"  {label} rank {rank} (cuda:{rep['device']}, {backend}): "
                f"{ref['waves']} waves, tokens "
                f"{rep['near_ties'] or 'equal'}; "
                f"logits within {rep['logit_err_over_scale']} of the "
                f"scale; prefill ms "
                f"{[round(x, 1) for x in rep['prefill_ms']]}, decode step "
                f"median {rep['decode_ms_median']:.2f} (one process "
                f"{med(ref['times']['decode']):.2f}); tokens/s "
                f"{rep['tok_s']:.1f} (one process {ref['tok_s']:.1f}); "
                f"peak {rep['peak_gib']:.2f} GiB"
                + (f"; gathers {rep['gather_share_of_decode']:.3f} of the "
                   f"decode step" if "gather_share_of_decode" in rep
                   else "")
                + (f"; {rep['publishes_checked']} publishes checked, "
                   f"broadcast ms {rounded(rep, 'broadcast_ms')}, apply ms "
                   f"delta {rounded(rep, 'apply_delta_ms')} resync "
                   f"{rounded(rep, 'apply_resync_ms')}"
                   if "publishes_checked" in rep else ""))
    del refs, got
    torch.cuda.empty_cache()
    out["14c"] = phase14c(torch, by_path)
    out["phase14_s"] = time.time() - t_start
    log(f"phase 14 took {out['phase14_s']:.1f} s (the placed serving "
        f"processes {out['placed_wall_s']:.1f} s, 14c "
        f"{out['14c']['seconds']:.1f} s)")
    return out


def tp_publish_shared(torch, rank, backend, port) -> dict:
    """14c's check of the tensor-parallel publisher on one shared set of
    params at full width (``SHARED_LAYERS`` layers), in a process group
    of its own on ``port``: every rank draws llama3.2-1b whole from seed
    0 and cuts its shards;
    over 3 ticks (resync, delta, delta) of ``launch.serve.drift`` (an
    elementwise step, so the shards' drift is the drift's shards) rank 0
    runs the one-process publisher on the whole params (``(2,
    d_row_total)`` rows) and every rank its own row's publisher on its
    shards (``rows=``); the message, ``pub`` and residual rows equal the
    one-process ones bitwise (rank 0's by ``torch.equal``, rank 1's by
    ``device_digest``).  Returns each tick's publish ms of the row."""
    import torch.distributed as dist

    from repro_torch import prng
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.dist import tensor_parallel as tpm
    from repro_torch.dist.layout import build_layout
    from repro_torch.dist.wire import ProcessGroupWire, init_process_group
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import parse_mesh
    from repro_torch.models import init_params
    from repro_torch.serve import init_publisher_state, publish

    os.environ["MASTER_PORT"] = str(port)
    init_process_group(backend, rank=rank, world_size=2, local_rank=rank,
                       local_world_size=2)
    try:
        cfg = llama_layers(SHARED_LAYERS)
        whole = init_params(cfg, 0, "cuda")
        tp = tpm.TensorParallel(cfg, ProcessGroupWire(parse_mesh("1x2")),
                                whole)
        r = tp.axis.rank
        mine = tp.shard(whole)
        if r:
            del whole
        config = CompressionConfig(compressor="topk", ratio=0.01)
        layout = build_layout(tp.whole, 2, config)
        rows = tp.rows(layout)
        state = init_publisher_state(layout, rows=1)
        one = init_publisher_state(layout) if r == 0 else None
        key = prng.PRNGKey(5)
        ms = []
        for t in range(3):
            mine = serve.drift(mine, t)
            ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
            ev[0].record()
            state, msg = publish(state, mine, layout, config, key,
                                 resync_every=3, rows=rows)
            ev[1].record()
            got = [x for x in msg[2:] if x is not None] + [state["pub"],
                                                           state["resid"]]
            digs = [device_digest(torch, x[0]) for x in got]
            every = [None, None]
            dist.all_gather_object(every, digs)
            if r == 0:
                whole = serve.drift(whole, t)
                one, want = publish(one, whole, layout, config, key,
                                    resync_every=3)
                wants = [x for x in want[2:] if x is not None] + [
                    one["pub"], one["resid"]]
                for a, b in zip(got, wants):
                    assert torch.equal(a[0], b[0]), ("14c shared row 0", t)
                assert every[1] == [device_digest(torch, b[1])
                                    for b in wants], ("14c shared row 1", t)
                del want, wants
            del got, msg
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        return {"publish_ms": ms}
    finally:
        torch.distributed.destroy_process_group()


def tp_publish_child(rank, world, backend, port, argv, check_port, queue):
    """Phase 14c, one rank: :func:`tp_train` of ``argv`` (the
    tensor-parallel trainer with ``--publish-every``), then
    :func:`tp_publish_shared` on ``check_port``."""
    import traceback
    try:
        # the publishers' transients of many sizes beside the other rank
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        import torch
        _tp_env(torch, rank, world, backend, port)
        out = tp_train(torch, argv + ["--dist-backend", backend],
                       cfg=llama_layers(PUBLISH_LAYERS))
        torch.cuda.empty_cache()
        out["shared"] = tp_publish_shared(torch, rank, backend, check_port)
        queue.put((rank, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def phase14c(torch, by_path) -> dict:
    """14c of :func:`phase14_placed`, at full width with
    ``PUBLISH_LAYERS`` layers: the one-process ``--mesh 1x2`` trainer
    with ``--publish-every 1 --resync-every 2`` (24 launches a step of
    K1, K2 and the K3 sweep; its records' publish kinds and bits), then the
    tensor-parallel one in two processes: 12 launches a step a rank of
    each (and the params' draws), the losses within rtol 1e-6, every
    record's publish kind and bits and the ``published`` line the
    one-process run's; then :func:`tp_publish_shared`."""
    import numpy as np

    cfg = llama_layers(PUBLISH_LAYERS)
    t0 = time.time()
    argv = ["--arch", "llama3.2-1b", "--density-policy", "none", "--batch",
            "8", "--seq", "128", "--publish-every", "1", "--resync-every",
            "2", "--steps", "4", "--log-every", "1"]
    log("phase 14c: the one-process --mesh 1x2 trainer with "
        f"--publish-every 1 --resync-every 2, {PUBLISH_LAYERS} layers, 4 "
        "steps")
    by_path["14c one process, mesh 1x2"], records, peak1, _, _ = train_path(
        "14c one process", argv[:-4] + ["--host-devices", "2", "--mesh",
                                        "1x2", "--log-every", "1"],
        {n: 24 for n in MAIN_KERNELS}, 4, torch, cfg=cfg)
    ref_pub = [(r["publish_kind"], r["publish_bits"]) for r in records]
    ref_losses = [r["loss"] for r in records]
    assert [k for k, _ in ref_pub] == [0, 1, 0, 1], ref_pub
    bits = sum(b for _, b in ref_pub)
    line = (f"published 2 deltas + 2 resyncs ({bits / 8 / 2 ** 20:.3f} MiB "
            f"on the wire)")
    del records
    torch.cuda.empty_cache()
    log("phase 14c: the tensor-parallel trainer, --mesh 1x2 in 2 "
        "processes, then the shared-params publisher check")
    check_port = []

    def args_of(backend, port):
        while not check_port or check_port[0] == port:
            check_port[:] = [free_port()]
        return argv + ["--mesh", "1x2"], check_port[0]

    backend, got = spawn_ranks(torch, tp_publish_child, args_of)
    draws = init_draws(cfg)
    out = {"backend": backend, "one_process_losses": ref_losses,
           "one_process_peak_gib": peak1 / 2**30, "line": line, "ranks": {}}
    for rank in range(2):
        res = got[rank]
        want = {n: (12 * 4 if n in MAIN_KERNELS else
                    draws if n == "threefry_bits" else 0)
                for n in res["launches"]}
        assert res["launches"] == want, (rank, res["launches"], want)
        np.testing.assert_allclose(res["losses"], ref_losses, rtol=1e-6)
        assert [tuple(x) for x in res["publish"]] == ref_pub, (
            rank, res["publish"], ref_pub)
        if rank == 0:
            assert res["published"] == [line], (res["published"], line)
        by_path[f"14c tensor parallel publisher, rank {rank}"] = \
            res["launches"]
        out["ranks"][rank] = {k: res[k] for k in (
            "losses", "step_ms", "peak_gib", "pack_ms", "shared")}
        log(f"  14c rank {rank}: losses {res['losses']} (one process "
            f"{ref_losses}); publish kinds and bits the one-process run's"
            f"{'; ' + line if rank == 0 else ''}; step ms "
            f"{[round(x, 1) for x in res['step_ms']]}; peak "
            f"{res['peak_gib']:.2f} GiB; launches {res['launches']}; shared "
            f"params: the row's messages, pub and resid bitwise the "
            f"one-process publisher's rows, publish ms "
            f"{[round(x, 1) for x in res['shared']['publish_ms']]}")
    out["seconds"] = time.time() - t0
    return out


# the four-card serving runs (``--tensor-parallel-cards``): command-r-35b
# at full width and this depth, 2x2 (2d); its rank peak stays under
# ~70 GiB (32.4 B params: 30.2 GiB a rank at rest, plus the whole
# embedding's draw and a gathered block)
CMDR_LAYERS = 40


def tp_replicas_child(rank, world, backend, port, argv, queue):
    """One rank of the four-card tensor-parallel trainer at ``2x2`` with
    ``--publish-every``: :func:`tp_train`, and at every publish the
    ``device_digest`` of the rank's message row, ``pub`` and residual;
    puts ``(rank, results)`` on ``queue``."""
    import traceback
    try:
        import torch
        _tp_env(torch, rank, world, backend, port)
        digests = []

        def on_publish(msg, layout, state, params, tp):
            digests.append([device_digest(torch, x) for x in
                            [x for x in msg[2:] if x is not None]
                            + [state["pub"], state["resid"]]])

        out = tp_train(torch, argv + ["--dist-backend", backend],
                       on_publish=on_publish)
        out["digests"] = digests
        queue.put((rank, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def placed_cards(torch) -> dict:
    """Serving placed on four cards over NCCL, 14a's traffic, frozen:
    llama3.2-1b at ``1x4`` and ``2x2`` (2d) and deepseek-moe-16b at 8
    layers at ``1x4``, each held against its one-process run on card 0
    as 14a (tokens, the prefill's and first decode's logits);
    command-r-35b at full width and ``CMDR_LAYERS`` layers at ``2x2``
    (2d), which no one card holds: its tokens in the vocabulary, the
    counters the queue's, each rank's peak under 70 GiB.  Then the
    tensor-parallel trainer at ``2x2`` with ``--publish-every 1
    --resync-every 2``: the two data replicas of each model rank publish
    the same row, message, ``pub`` and residual (``device_digest``).
    Decode-step and prefill ms, tokens/s and each rank's peak."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    t0 = time.time()
    out = {"runs": {}}
    ds, cmdr = full_width("deepseek-moe-16b", 8), full_width(
        "command-r-35b", CMDR_LAYERS)
    llama = get_config("llama3.2-1b")
    refs = {}
    for name, cfg in (("llama", None), ("deepseek", ds)):
        log(f"four cards: the one-process {name} run on card 0, frozen")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        on_logits, store = logit_log(True)
        argv = placed_argv("1x1", cfg.name if cfg else "llama3.2-1b")
        got = serve.run(argv, cfg=cfg, on_logits=on_logits)
        refs[name] = (got, store)
        out.setdefault("one_process", {})[name] = {
            "decode_ms_median": med(got["times"]["decode"]),
            "prefill_ms": got["times"]["prefill"], "tok_s": got["tok_s"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    runs = [("4 cards llama3.2-1b 1x4", placed_argv("1x4"), None, "llama",
             llama),
            ("4 cards llama3.2-1b 2x2 2d", placed_argv("2x2"), None,
             "llama", llama),
            ("4 cards deepseek-moe-16b (8 layers) 1x4",
             placed_argv("1x4", "deepseek-moe-16b"), ds, "deepseek", ds),
            (f"4 cards command-r-35b ({CMDR_LAYERS} layers) 2x2 2d",
             placed_argv("2x2", "command-r-35b"), cmdr, None, cmdr)]
    ports = []

    def args_of(backend, port):
        while len(ports) < len(runs):
            p = free_port()
            if p != port and p not in ports:
                ports.append(p)
        return ([(label, argv, cfg, p, False)
                 for (label, argv, cfg, _, _), p in zip(runs, ports)],)

    log("four cards: placed serving, " + ", ".join(r[0] for r in runs))
    backend, got = spawn_ranks(torch, serve_placed_child, args_of, world=4)
    assert backend == "nccl", backend
    for label, _, _, ref_name, cfg in runs:
        for rank in range(4):
            res = got[rank][label]
            if rank:
                res["logits"] = {}
            if ref_name is not None:
                ref, ref_logits = refs[ref_name]
                rep = placed_report(label, res, ref, ref_logits,
                                    init_draws(cfg), rank)
            else:
                want = {n: 0 for n in res["launches"]}
                want["threefry_bits"] = init_draws(cfg) + 2 * res["waves"]
                assert res["launches"] == want, (label, res["launches"])
                assert res["done"] == 12 and res["waves"] == 2, res
                for t in res["tokens"]:
                    assert t.min() >= 0 and t.max() < cfg.vocab_size, label
                assert all(bool((t == got[0][label]["tokens"][w]).all())
                           for w, t in enumerate(res["tokens"])), label
                assert res["peak_gib"] < 70, (label, res["peak_gib"])
                rep = {"prefill_ms": res["times"]["prefill"],
                       "decode_ms_median": med(res["times"]["decode"]),
                       "tok_s": res["tok_s"], "seconds": res["seconds"],
                       "peak_gib": res["peak_gib"], "device": res["device"]}
                if "gather_decode" in res["times"]:
                    rep["gather_decode_ms_total"] = sum(
                        res["times"]["gather_decode"])
            out["runs"].setdefault(label, {})[rank] = rep
            log(f"  {label} rank {rank} (cuda:{rep['device']}): prefill ms "
                f"{[round(x, 1) for x in rep['prefill_ms']]}, decode step "
                f"median {rep['decode_ms_median']:.2f}, tokens/s "
                f"{rep['tok_s']:.1f}, peak {rep['peak_gib']:.2f} GiB"
                + (f", tokens {rep['near_ties'] or 'equal'}, logits "
                   f"within {rep['logit_err_over_scale']} of the scale"
                   if "near_ties" in rep else ""))
    del got, refs
    torch.cuda.empty_cache()
    log("four cards: the tensor-parallel trainer at 2x2 with "
        "--publish-every 1 --resync-every 2, 4 steps")
    argv = ["--arch", "llama3.2-1b", "--density-policy", "none", "--batch",
            "8", "--seq", "128", "--publish-every", "1", "--resync-every",
            "2", "--steps", "4", "--log-every", "1", "--mesh", "2x2"]
    backend, got = spawn_ranks(torch, tp_replicas_child,
                               lambda backend, port: (argv,), world=4)
    for rank in range(4):
        res = got[rank]
        assert res["losses"] == got[0]["losses"], rank
        # global rank w·M + r: data replica w of model rank r
        assert res["digests"] == got[rank % 2]["digests"], (
            "data replicas publish the same row", rank)
        assert len(res["digests"]) == 4, res["digests"]
    out["publish_2x2"] = {rank: {k: got[rank][k] for k in (
        "losses", "step_ms", "peak_gib", "publish")} for rank in range(4)}
    log(f"  the data replicas of each model rank published the same rows "
        f"(4 publishes); step ms "
        f"{[[round(x, 1) for x in got[r]['step_ms']] for r in range(4)]}; "
        f"{got[0]['published']}")
    out["seconds"] = time.time() - t0
    return out


# -- phase 15: rematerialised training and the kernel-config table --

REMAT_STEPS = 3


def remat_run(torch, label, argv, cfg, remat, by_path,
              step_memory=False) -> dict:
    """One ``train.run`` of ``argv`` on ``cfg`` for ``REMAT_STEPS`` steps,
    its launch counters set to 0 just before it and read just after
    (12 a step of K1, K2 and the K3 sweep; the params' draws once), with
    rematerialisation (the trainer's default) or without it (the
    trainer's own switch, ``--smoke``, which with ``cfg`` given changes
    nothing else).  ``--checkpoint`` hands the final state to
    ``repro_torch.checkpoint.save_state``, which is swapped for a digest
    of every leaf on the card.  Returns the losses, step ms, peak
    memory and the digests; with ``step_memory`` also each step's
    ``(memory allocated before it, its own peak)`` in bytes, the train
    step wrapped for it (``repro_torch.train.make_train_step``)."""
    import contextlib

    from repro_torch import checkpoint, tree
    from repro_torch.launch import train
    digests = {}
    mem = StepMemory(torch)

    def digest(path, state):
        for p, leaf in tree.flatten_with_path(state)[0]:
            digests[tree.path_name(p)] = (
                device_digest(torch, leaf) if torch.is_tensor(leaf)
                and leaf.element_size() == 4 else repr(leaf))

    save = checkpoint.save_state
    checkpoint.save_state = digest
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        with mem if step_memory else contextlib.nullcontext():
            by_path[label], records = drive(
                label, lambda: train.run(
                    argv + ["--steps", str(REMAT_STEPS), "--log-every",
                            "1", "--checkpoint", "state.npz"]
                    + ([] if remat else ["--smoke"]), cfg=cfg),
                {n: 12 for n in MAIN_KERNELS}, REMAT_STEPS,
                {"threefry_bits": init_draws(cfg)})
    finally:
        checkpoint.save_state = save
    # the peak before, during and after every step
    peak = max([torch.cuda.max_memory_allocated()]
               + [x for m in mem.steps for x in m[1:]])
    ms = [r["ms"] for r in records]
    losses = [r["loss"] for r in records]
    assert all(math.isfinite(x) for x in losses), (label, losses)
    assert digests, (label, "no state digested")
    out = {"losses": losses, "step_ms": ms,
           "steady_ms": statistics.median(ms[1:]),
           "peak_gib": peak / 2 ** 30, "digests": digests}
    if step_memory:
        assert len(mem.steps) == REMAT_STEPS, (label, mem.steps)
        out["step_memory"] = [(m[0], m[2]) for m in mem.steps]
    log(f"  {label}: losses {losses}, step ms {[round(x, 1) for x in ms]}, "
        f"peak {out['peak_gib']:.2f} GiB")
    return out


def phase15a(torch, by_path) -> dict:
    """15a: llama3.2-1b at full width and depth (16 layers), batch 8,
    Gaussian-k fused at 0.001, fixed-k, through ``train.run``: at ``--seq
    512`` 3 steps without rematerialisation and 3 with it (losses and the
    final params, momentum and residuals bitwise equal: the recompute
    runs the same operations on the same inputs), then at ``--seq 1024``
    3 steps with it (without, the activations, ~3 GB a layer, do not fit
    beside the training state: that run is not launched).  Step ms,
    steady ms (the median of steps 1-2), peak memory, and the
    recompute's share of the step at 512."""
    from repro_torch.configs import get_config
    cfg = get_config("llama3.2-1b")
    base = ["--arch", "llama3.2-1b", "--mesh", "1x1", "--density-policy",
            "none", "--batch", "8"]
    out = {}
    log("phase 15a: llama3.2-1b at full width and depth, 8 x 512, 3 steps "
        "without and 3 with rematerialisation")
    out["seq512_off"] = remat_run(torch, "15a seq 512 remat off",
                                  base + ["--seq", "512"], cfg, False,
                                  by_path)
    out["seq512_on"] = remat_run(torch, "15a seq 512 remat on",
                                 base + ["--seq", "512"], cfg, True, by_path)
    off, on = out["seq512_off"], out["seq512_on"]
    assert off["losses"] == on["losses"], ("15a losses", off["losses"],
                                           on["losses"])
    assert off["digests"] == on["digests"], "15a final state"
    out["recompute_share_512"] = (
        (on["steady_ms"] - off["steady_ms"]) / on["steady_ms"])
    log(f"  remat on == off bitwise at 512 (losses, {len(on['digests'])} "
        f"state leaves); steady step {off['steady_ms']:.1f} -> "
        f"{on['steady_ms']:.1f} ms (the recompute "
        f"{out['recompute_share_512']:.1%} of the step), peak "
        f"{off['peak_gib']:.2f} -> {on['peak_gib']:.2f} GiB")
    log("phase 15a: llama3.2-1b, 8 x 1024, 3 steps with rematerialisation")
    out["seq1024_on"] = remat_run(torch, "15a seq 1024 remat on",
                                  base + ["--seq", "1024"], cfg, True,
                                  by_path)
    for run in out.values():
        if isinstance(run, dict):
            run.pop("digests", None)
    return out


def phase15b(torch) -> dict:
    """15b: the kernel-configuration ladder on the card against the
    checked-in table (``kernels/ef_fused/kernelconfig.cuda.json``): every
    leaf of phase 3's path (llama3.2-1b's 12 bucket segments) resolves
    with ``source == "table"``; at the 268,435,456-element leaf K1, K2,
    both K3 launches and the K3 sweep at the table's config are held
    against their plain versions (:func:`check_main_kernels`) and timed
    with CUDA events beside the heuristic config (block 1024, stats
    block 4096, K1's own warps), in the order heuristic, table, table,
    heuristic; so is the whole fused pipeline."""
    from repro_torch.configs import get_config
    from repro_torch.core.compressors import gaussiank_cap, get_compressor
    from repro_torch.dist.layout import build_layout
    from repro_torch.kernels.ef_fused import compact_residual as cr
    from repro_torch.kernels.ef_fused import fused_moments as fm
    from repro_torch.kernels.ef_fused import ops, tuning
    from repro_torch.kernels.ef_fused import tree_count as tc
    from repro_torch.models import init_params

    layout = build_layout(init_params(get_config("llama3.2-1b"), 0, "meta"),
                          1, RATIO, get_compressor("gaussiank"))
    leaves = {}
    for seg in layout.segments:
        cfg = tuning.resolve_config(seg.d_row, "cuda")
        assert cfg.source == "table", (seg.name, cfg)
        leaves[seg.name] = {"d": seg.d_row, "block": cfg.block,
                            "stats_block": cfg.stats_block,
                            "num_warps": cfg.num_warps}
    log(f"phase 15b: the {len(leaves)} leaves of phase 3's path resolve "
        f"from the table: " + "; ".join(
            f"{n} ({v['d']:,}) block {v['block']} stats {v['stats_block']} "
            f"warps {v['num_warps']}" for n, v in leaves.items()))
    d = BIG_LEAF
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    g = torch.randn(d, generator=gen, device="cuda").mul_(1e-3)
    e = torch.randn(d, generator=gen, device="cuda").mul_(5e-4)
    k = math.ceil(RATIO * d)
    c = check_main_kernels(g, e, k, f"15b d={d:,} at the table's config")
    thres, thr = c.thres, c.thr
    k_cap = gaussiank_cap(k, d)
    configs = {"table": tuning.resolve_config(d, "cuda"),
               "heuristic": tuning.heuristic_config("cuda", d)}
    out = torch.empty_like(g)

    def launches(cfg):
        sb, block, w = cfg.stats_block, cfg.block, cfg.num_warps
        bcap = ops.fused_default_bcap(k_cap, d, block, cfg.bcap_slack)
        _, _, cnt = cr.compact_stage(g, e, thres, block=block, bcap=bcap)
        enc = cr.exclusive_enc(cnt, bcap)
        return bcap, {
            "fused_moments": lambda: fm.fused_moments(g, e, block=sb,
                                                      num_warps=w),
            "tree_count": lambda: tc.tree_count(g, e, thr, block=sb),
            "compact_stage": lambda: cr.compact_stage(
                g, e, thres, block=block, bcap=bcap),
            "compact_resid": lambda: cr.compact_resid(
                g, e, thres, enc, block=block, bcap=bcap, k_cap=k_cap,
                out=out),
            "compact_sweep": lambda: cr.compact_sweep(
                g, e, thres, block=block, bcap=bcap, k_cap=k_cap, out=out),
            "pipeline": lambda: ops.fused_compress_ef(
                g, e, "gaussiank", k, block=block, stats_block=sb,
                num_warps=w)}

    fns = {name: launches(cfg) for name, cfg in configs.items()}
    times = {name: {n: [] for n in fns[name][1]} for name in configs}
    for name in ("heuristic", "table", "table", "heuristic"):
        for n, fn in fns[name][1].items():
            times[name][n].append(time_ms(fn, 10))
    res = {}
    for name, cfg in configs.items():
        ms = {n: statistics.mean(t) for n, t in times[name].items()}
        res[name] = {"block": cfg.block, "stats_block": cfg.stats_block,
                     "num_warps": cfg.num_warps, "bcap": fns[name][0],
                     "ms": ms, "runs_ms": times[name]}
    nb = -(-d // configs["table"].block)
    sweep_bound = bound(12 * d + 8 * nb * fns["table"][0] + 4 * nb
                        + 8 * k_cap, 3 * d)[0]
    res["table"]["one_sweep_bound_ms"] = sweep_bound
    res["table"]["one_sweep_share_of_bound"] = (
        sweep_bound / res["table"]["ms"]["compact_sweep"])
    log(f"phase 15b: d={d:,}, ms (mean of two medians): " + "; ".join(
        f"{name} (block {r['block']}, stats {r['stats_block']}, warps "
        f"{r['num_warps']}): " + ", ".join(
            f"{n} {t:.4f}" for n, t in r["ms"].items())
        for name, r in res.items())
        + f"; K3's one sweep at the table's config at "
        f"{res['table']['one_sweep_share_of_bound']:.1%} of its bound "
        f"({sweep_bound:.4f} ms); {nvidia_smi()}")
    del g, e, out, fns, c
    torch.cuda.empty_cache()
    return {"leaves": leaves, "d": d, "k": k, "configs": res}


def phase15_remat_table(torch, by_path) -> dict:
    """Phase 15, slice 10: rematerialised training at full width
    (:func:`phase15a`) and the kernel-configuration table
    (:func:`phase15b`)."""
    t0 = time.time()
    out = {"15a": phase15a(torch, by_path)}
    t1 = time.time()
    out["15b"] = phase15b(torch)
    out["phase15_s"] = time.time() - t0
    log(f"phase 15 took {out['phase15_s']:.1f} s (15a {t1 - t0:.1f}, 15b "
        f"{time.time() - t1:.1f})")
    return out


# -- phase 16: long sequences (slice 11) --

LONG_PREFILL = 32_768        # prefill_32k's sequence, one prompt
LONG_DECODE = 4              # decode steps from its cache
LONG_TRAIN = ((8, 2048), (2, 4096))      # 16b: batch x seq
# 16c: ranks -> batch x seq (gloo on one card at 2, NCCL on four at 4)
ACTSHARD_SHAPES = {2: (2, 1024), 4: (8, 2048)}
COUNT_TOLERANCE = 0.25       # 16d: the count against the card


def phase16a(torch) -> dict:
    """16a: llama3.2-1b at full width and depth, f32, random weights from
    seed 0: ``models.prefill`` of one 32,768-token prompt (query-chunked
    attention; one block's f32 logits, 128 GiB a layer, would not fit
    the card), then 4 decode steps from its cache.  Prefill and
    decode-step ms (CUDA events), the memory allocated before the
    prefill (params and prompt) and the prefill's peak."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, prefill
    cfg = get_config("llama3.2-1b")
    params = init_params(cfg, 0, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    toks = torch.randint(0, cfg.vocab_size, (1, LONG_PREFILL),
                         generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True)
          for _ in range(2 + LONG_DECODE)]
    ev[0].record()
    logits, cache, pos = prefill(params, cfg, toks,
                                 s_max=LONG_PREFILL + LONG_DECODE)
    ev[1].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    assert pos == LONG_PREFILL
    for i in range(LONG_DECODE):
        assert logits.shape == (1, 1, cfg.vocab_size), logits.shape
        assert bool(torch.isfinite(logits).all()), ("16a logits", i)
        logits, cache = decode_step(params, cfg, cache, pos + i,
                                    logits.argmax(-1))
        ev[2 + i].record()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(logits).all()), "16a last decode logits"
    out = {"prefill_ms": ev[0].elapsed_time(ev[1]),
           "decode_ms": [ev[1 + i].elapsed_time(ev[2 + i])
                         for i in range(LONG_DECODE)],
           "before_bytes": before, "peak_bytes": peak,
           "peak_gib": peak / 2 ** 30}
    log(f"phase 16a: llama3.2-1b prefill of 1 x {LONG_PREFILL:,} in "
        f"{out['prefill_ms']:.1f} ms, decode steps "
        f"{[round(x, 2) for x in out['decode_ms']]} ms; peak "
        f"{out['peak_gib']:.2f} GiB ({before / 2 ** 30:.2f} GiB before "
        f"the prefill)")
    del params, cache, logits
    torch.cuda.empty_cache()
    return out


def phase16b(torch, by_path) -> dict:
    """16b: the trainer (``train.run``, remat on) on llama3.2-1b at full
    width and depth, Gaussian-k fused at 0.001, fixed-k, 3 steps at
    each of ``LONG_TRAIN`` (12 launches a step of K1, K2 and the K3 sweep),
    each step's memory recorded; at 8 x 2048 also with the one-block
    attention (``layers._SDPA_CHUNK`` raised above T for that run):
    both peaks and whether the losses are bitwise equal."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers
    cfg = get_config("llama3.2-1b")
    out = {}
    for B, T in LONG_TRAIN:
        argv = ["--arch", "llama3.2-1b", "--mesh", "1x1",
                "--density-policy", "none", "--batch", str(B), "--seq",
                str(T)]
        log(f"phase 16b: llama3.2-1b, {B} x {T}, 3 steps with "
            f"rematerialisation, chunked attention")
        out[f"{B}x{T}"] = remat_run(torch, f"16b {B} x {T}", argv, cfg,
                                    True, by_path, step_memory=True)
        if (B, T) != LONG_TRAIN[0]:
            continue
        log(f"phase 16b: llama3.2-1b, {B} x {T}, the one-block attention")
        chunk = layers._SDPA_CHUNK
        layers._SDPA_CHUNK = 1 << 30
        try:
            one = remat_run(torch, f"16b {B} x {T} one block", argv, cfg,
                            True, by_path)
        finally:
            layers._SDPA_CHUNK = chunk
        mine = out[f"{B}x{T}"]
        one["losses_bitwise"] = [a == b for a, b in
                                 zip(mine["losses"], one["losses"])]
        out[f"{B}x{T} one block"] = one
        log(f"  {B} x {T}: peak chunked {mine['peak_gib']:.2f} GiB, one "
            f"block {one['peak_gib']:.2f} GiB; losses bitwise a step: "
            f"{one['losses_bitwise']}")
    for run in out.values():
        run.pop("digests", None)
    return out


def actshard_child(rank, world, backend, port, batch, seq, queue):
    """16c, one rank: the tensor-parallel llama3.2-1b at full width and
    depth on its shards, one forward and backward (``loss_fn``, remat)
    of ``batch`` x ``seq`` without and with ``shard_activations``: the
    loss's and every gradient's digest on the card, the memory live at
    the end of the forward and the peak, each above what was allocated
    before; puts ``(rank, {False: ..., True: ...})`` on ``queue``."""
    import dataclasses
    import traceback
    try:
        import torch
        _tp_env(torch, rank, world, backend, port)
        from repro_torch import tree
        from repro_torch.configs import get_config
        from repro_torch.data import lm_batch
        from repro_torch.dist import tensor_parallel as tpm
        from repro_torch.dist.wire import (ProcessGroupWire,
                                           init_process_group)
        from repro_torch.launch.mesh import parse_mesh
        from repro_torch.models import init_params, loss_fn
        init_process_group(backend, rank=rank, world_size=world,
                           local_rank=rank, local_world_size=world)
        out = {}
        try:
            cfg = get_config("llama3.2-1b")
            tp = tpm.TensorParallel(cfg, ProcessGroupWire(parse_mesh(
                f"1x{world}")), init_params(cfg, 0, "meta"))
            dev = torch.device("cuda", torch.cuda.current_device())
            shards, td = tree.flatten(tp.shard(init_params(cfg, 0, dev)))
            torch.cuda.empty_cache()
            data = lm_batch(0, global_batch=batch, seq_len=seq,
                            vocab=cfg.vocab_size, device=dev)
            ps = [p.requires_grad_(True) for p in shards]
            # cuBLAS takes its workspace (32 MiB) from the caching
            # allocator at the first matmul: before the first run counts
            torch.ones((8, 8), device=dev) @ torch.ones((8, 8), device=dev)
            for on in (False, True):
                c = dataclasses.replace(cfg, shard_activations=on)
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                loss, _ = loss_fn(tree.unflatten(td, ps), c, data, tp.axis,
                                  remat=True)
                torch.cuda.synchronize()
                kept = torch.cuda.memory_allocated() - before
                grads = torch.autograd.grad(loss, ps)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                peak = torch.cuda.max_memory_allocated() - before
                out[on] = {"loss": float(loss.detach()), "ms": ms,
                           "kept": kept,
                           "peak": peak, "digests": [
                               device_digest(torch, t)
                               for t in [loss] + list(grads)]}
                del loss, grads
                torch.cuda.empty_cache()
        finally:
            torch.distributed.destroy_process_group()
        queue.put((rank, out))
    except BaseException:  # noqa: BLE001 — reported to the parent
        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def phase16c(torch, world) -> dict:
    """16c: ``shard_activations`` on the tensor-parallel llama3.2-1b
    (16 layers, remat) at ``--mesh 1x{world}``: 2 ranks over gloo on
    one card at 2 x 1024, or 4 over NCCL on four cards at 8 x 2048
    (:func:`actshard_child`).  The loss and every gradient shard bitwise
    the run without; each rank's memory at the end of the forward falls
    by the period inputs it keeps as ``1 / M`` slices, ``reps x B x T x
    D x 4 x (1 - 1/M)`` bytes, within 10%; its peak change printed
    beside the dry run's count of it (``step_cost.count_temp_bytes``:
    the peak falls by that much only where the carries are all live at
    it)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import step_cost
    cfg = get_config("llama3.2-1b")
    B, T = ACTSHARD_SHAPES[world]
    carries = cfg.num_layers * B * T * cfg.d_model * 4 * (world - 1) // world
    counted = [step_cost.count_temp_bytes(
        dataclasses.replace(cfg, shard_activations=on), B, T, remat=True,
        model_size=world)["temp_bytes"] for on in (False, True)]
    log(f"phase 16c: shard_activations, llama3.2-1b at --mesh 1x{world} "
        f"in {world} processes, {B} x {T}, one forward and backward "
        f"without and with")
    backend, got = spawn_ranks(torch, actshard_child,
                               lambda backend, port: (B, T), world=world)
    out = {"backend": backend, "batch": B, "seq": T, "carries": carries,
           "counted_peak_drop": counted[0] - counted[1], "ranks": {}}
    for rank in range(world):
        off, on = got[rank][False], got[rank][True]
        assert on["digests"] == off["digests"], (
            "16c shard_activations changed a bit", rank)
        assert on["digests"][0] == got[0][False]["digests"][0], (
            "16c the loss differs between ranks", rank)
        kept_drop = off["kept"] - on["kept"]
        assert abs(kept_drop - carries) <= 0.1 * carries, (
            "16c the forward's kept bytes", rank, kept_drop, carries)
        out["ranks"][rank] = {
            "loss": on["loss"], "ms": [off["ms"], on["ms"]],
            "kept": [off["kept"], on["kept"]],
            "peak": [off["peak"], on["peak"]],
            "kept_drop": kept_drop, "peak_drop": off["peak"] - on["peak"]}
        log(f"  rank {rank} ({backend}): loss {on['loss']!r} and "
            f"{len(on['digests']) - 1} gradient shards bitwise; forward "
            f"keeps {off['kept'] / 2 ** 20:.1f} -> "
            f"{on['kept'] / 2 ** 20:.1f} MiB (falls "
            f"{kept_drop / 2 ** 20:.1f}, the carries "
            f"{carries / 2 ** 20:.1f}); peak above the params "
            f"{off['peak'] / 2 ** 20:.1f} -> {on['peak'] / 2 ** 20:.1f} "
            f"MiB (falls {(off['peak'] - on['peak']) / 2 ** 20:.1f}, "
            f"counted {(counted[0] - counted[1]) / 2 ** 20:.1f}); ms "
            f"{off['ms']:.1f} / {on['ms']:.1f}")
    return out


def phase16d(torch, a, b) -> dict:
    """16d: the dry run's count (``step_cost.count_temp_bytes`` on meta)
    of 16b's 8 x 2048 train step (remat) and of 16a's prefill against
    the card: the step's peak above the memory allocated before it (the
    train state, the batch), its largest over the 3 steps, and the
    prefill's peak above the params; each within 25%."""
    from repro_torch.configs import get_config
    from repro_torch.launch import step_cost
    cfg = get_config("llama3.2-1b")
    B, T = LONG_TRAIN[0]
    step = max(peak - before for before, peak in b[f"{B}x{T}"][
        "step_memory"])
    rows = {
        f"train {B} x {T}": (step_cost.count_temp_bytes(
            cfg, B, T, remat=True)["temp_bytes"], step),
        f"prefill 1 x {LONG_PREFILL}": (step_cost.count_temp_bytes(
            cfg, 1, LONG_PREFILL, kind="prefill")["temp_bytes"],
            a["peak_bytes"] - a["before_bytes"])}
    out = {}
    for label, (counted, measured) in rows.items():
        ratio = counted / measured
        out[label] = {"counted": counted, "measured": measured,
                      "ratio": ratio}
        log(f"phase 16d: {label}: counted {counted / 2 ** 30:.3f} GiB, "
            f"measured {measured / 2 ** 30:.3f} GiB on the card "
            f"(count / card {ratio:.3f})")
        assert abs(ratio - 1) <= COUNT_TOLERANCE, ("16d", label, ratio)
    return out


def phase16_long(torch, by_path) -> dict:
    """Phase 16, slice 11, long sequences: 16a the prefill, 16b the
    trainer, 16c ``shard_activations`` at ``1x2``, 16d the dry run's
    count against 16a and 16b."""
    t0 = time.time()
    out = {"16a": phase16a(torch)}
    t1 = time.time()
    out["16b"] = phase16b(torch, by_path)
    t2 = time.time()
    out["16c"] = phase16c(torch, 2)
    t3 = time.time()
    out["16d"] = phase16d(torch, out["16a"], out["16b"])
    out["phase16_s"] = time.time() - t0
    log(f"phase 16 took {out['phase16_s']:.1f} s (16a {t1 - t0:.1f}, 16b "
        f"{t2 - t1:.1f}, 16c {t3 - t2:.1f}, 16d {time.time() - t3:.1f})")
    return out


# -- phase 17: bf16 operands (slice 12) --

# the (g, e) dtypes of 17a; the single-operand kernels (K4a-K4d) take the
# u of the pair in its promoted dtype, as the unfused pipeline forms it
BF16_PAIRS = (("bfloat16", "bfloat16"), ("bfloat16", "float32"),
              ("bfloat16", None))
# bytes an element of each kernel's operands and outputs at bf16/bf16
# (K4a-K4d read a bf16 u; K3's residual writes a bf16 e')
BF16_LEAF_BYTES = {"fused_moments": 4, "fused_moments_hist": 4,
                   "tree_count": 4, "compact_stage": 4, "compact_resid": 6,
                   "compact_sweep": 6,
                   "moments": 2, "count_gt": 2, "threshold_compact": 2,
                   "abs_histogram": 2}
BF16_BATCH, BF16_SEQ = 8, 512


def bf16_cfg(cfg):
    """``cfg`` with the reference's dry-run dtypes
    (``launch/dryrun.py:_bf16``): bf16 params and activations."""
    import dataclasses
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               activation_dtype="bfloat16")


def phase17a(torch, rows) -> dict:
    """17a: every EF kernel at d = 268,435,456 with ``(g, e)`` in (bf16,
    bf16), (bf16, f32) and (bf16, None), at the geometry the table pins
    for a bf16 ``g``: K1 (with and without its histogram), K2, both K3
    launches and the K3 sweep (bitwise the two launches and the
    assembly, in place too) on ``(g, e)``, K4a-K4d on the pair's ``u``
    in its promoted dtype, each against its plain version on the card
    (moments within
    tolerance; counts, histograms, staging rows and offsets, indices and
    ``e'`` bitwise, bf16 as int16), ``e'`` in place over ``e`` where it
    has the promoted dtype, the fused and unfused pipelines' conservation
    in that dtype, and unfused == fused where ``u`` is f32.  At (bf16,
    bf16) each kernel is timed (CUDA events, median) beside its plain
    version and its bound: the bytes of its operands and outputs at the
    memory rate."""
    from repro_torch.core import codec
    from repro_torch.core.compressors import gaussiank_cap
    from repro_torch.kernels.ef_fused import compact_residual as cr
    from repro_torch.kernels.ef_fused import fused_moments as fm
    from repro_torch.kernels.ef_fused import ops, tuning
    from repro_torch.kernels.ef_fused import tree_count as tc
    from repro_torch.kernels.gaussian_topk import count_gt as cg
    from repro_torch.kernels.gaussian_topk import threshold_compact as thc
    from repro_torch.kernels.histk import hist
    from repro_torch.kernels.moments import moments as mom

    d = BIG_LEAF
    k = math.ceil(RATIO * d)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    g = torch.randn(d, generator=gen, device="cuda").mul_(1e-3)
    e32 = torch.randn(d, generator=gen, device="cuda").mul_(5e-4)
    g = g.bfloat16()
    operands = {"bfloat16": e32.bfloat16(), "float32": e32, None: None}
    cfg = tuning.resolve_config(d, "cuda", torch.bfloat16)
    sb, block, w = cfg.stats_block, cfg.block, cfg.num_warps
    k_cap = gaussiank_cap(k, d)
    bcap = ops.fused_default_bcap(k_cap, d, block, cfg.bcap_slack)
    out = {"d": d, "k": k, "config": {"block": block, "stats_block": sb,
                                      "num_warps": w, "bcap": bcap,
                                      "source": cfg.source}}
    t0 = time.time()
    for gname, ename in BF16_PAIRS:
        e = operands[ename]
        label = f"17a g {gname} e {ename}"
        u = g if e is None else g + e
        sum_abs = float((g.double() if e is None else g.double()
                         + e.double()).abs().sum())
        errs = {}
        # K1, with and without its histogram
        s, sq, mx = fm.fused_moments(g, e, block=sb, num_warps=w)
        ps, psq, pmx = fm.fused_moments_plain(g, e, block=sb)
        errs["fused_moments"] = check_moments(label, "K1", (s, sq, mx),
                                              (ps, psq, pmx), sum_abs)
        errs["fused_moments_hist"] = check_k1_hist(label, g, e, sb)
        # K2 at the plain moments' refinement tree
        heap, n_cnt = ops._tree_thresholds(ops.gaussian_t0(ps, psq, d, k,
                                                           False), 4)
        thr = torch.from_numpy(heap[:n_cnt])
        cnt = tc.tree_count(g, e, thr, block=sb)
        assert torch.equal(cnt, tc.tree_count_plain(g, e, thr, block=sb)), (
            label, "K2")
        thres = float(ops._replay_refinement(heap, cnt.cpu().numpy(), k, 4))
        # K3: staging rows and offsets, counts, e' (in place where e has
        # the promoted dtype)
        stage = cr.compact_stage(g, e, thres, block=block, bcap=bcap)
        plain = cr.compact_stage_plain(g, e, thres, block=block, bcap=bcap)
        for a, b, what in zip(stage, plain, ("values", "offsets",
                                             "counts")):
            assert same_bits(a, b), (label, "K3 stage", what)
        enc = cr.exclusive_enc(plain[2], bcap)
        want = cr.compact_resid_plain(g, e, thres, enc, block=block,
                                      bcap=bcap, k_cap=k_cap)
        assert want.dtype == u.dtype, (label, want.dtype)
        target = e.clone() if e is not None and e.dtype == u.dtype else None
        got = cr.compact_resid(g, e, thres, enc, block=block, bcap=bcap,
                               k_cap=k_cap, out=target)
        if target is not None:
            assert got.data_ptr() == target.data_ptr(), (label, "in place")
        assert same_bits(got, want), (label, "K3 residual")
        del target, got, want, stage, plain
        check_sweep(torch, g, e, thres, block, bcap, k_cap, label)
        # the fused pipeline's pair and e', and conservation in u's dtype
        fv, fi, fne = ops.fused_compress_ef(g, e, "gaussiank", k)
        assert fv.dtype == fne.dtype == u.dtype, (label, fv.dtype)
        assert torch.equal(codec.decode(fv, fi, d) + fne, u), (
            label, "fused conservation")
        nnz = int(codec.nnz(fi))
        # K4a-K4d on u in its promoted dtype
        m4 = mom.moments(u, block=sb, num_warps=w)
        errs["moments"] = check_moments(label, "K4a", m4,
                                        fm.moments_plain(u, sb), sum_abs)
        for t in (float(heap[0]), thres):
            assert torch.equal(cg.count_gt(u, t, block=sb),
                               cg.count_gt_plain(u, t, block=sb)), (
                label, "K4b", t)
        ubcap = ops.fused_default_bcap(k_cap, d, block, 4.0)
        for a, b, what in zip(
                thc.threshold_compact(u, thres, block=block, bcap=ubcap),
                thc.threshold_compact_plain(u, thres, block=block,
                                            bcap=ubcap),
                ("values", "offsets", "counts")):
            assert same_bits(a, b), (label, "K4c", what)
        assert torch.equal(hist.abs_histogram(u, block=sb),
                           hist.abs_histogram_plain(u, block=sb)), (
            label, "K4d")
        # the unfused pipeline: conservation, and == fused where u is f32
        uv, ui, une = ops.unfused_compress_ef(g, e, "gaussiank", k,
                                              bcap=bcap)
        assert torch.equal(codec.decode(uv, ui, d) + une, u), (
            label, "unfused conservation")
        if e is None or u.dtype == torch.float32:   # the same u
            assert all(same_bits(a, b) for a, b in ((fv, uv), (fi, ui),
                                                    (fne, une))), (
                label, "unfused == fused")
        del fv, fi, fne, uv, ui, une
        out[label] = {"max_abs_err": errs, "threshold": thres, "nnz": nnz}
        log(f"  {label}: K1 (max error {errs['fused_moments']:.3g}), K1 "
            f"histogram, K2, K3 stage and e' ({u.dtype}), the K3 sweep "
            f"(rows, e', pair, in place) bitwise; K4a-K4d "
            f"on u ({u.dtype}) bitwise; fused and unfused conserve in "
            f"{u.dtype}; {nnz}/{k_cap} slots at threshold {thres:.6g}")
        if (gname, ename) == ("bfloat16", "bfloat16"):
            timed = (g, e, u, thres, thr, enc, errs)
        del u
        torch.cuda.empty_cache()
    checked_s = time.time() - t0
    # times at (bf16, bf16)
    g, e, u, thres, thr, enc, errs = timed
    nb, nbs, nt = -(-d // block), -(-d // sb), thr.numel()
    ubcap = ops.fused_default_bcap(k_cap, d, block, 4.0)
    e_out = e.clone()
    fns = {
        "fused_moments": (
            lambda: fm.fused_moments(g, e, block=sb, num_warps=w),
            lambda: fm.fused_moments_plain(g, e, block=sb)),
        "fused_moments_hist": (
            lambda: fm.fused_moments_hist(g, e, block=sb),
            lambda: fm.fused_moments_hist_plain(g, e, block=sb)),
        "tree_count": (
            lambda: tc.tree_count(g, e, thr, block=sb),
            lambda: tc.tree_count_plain(g, e, thr, block=sb)),
        "compact_stage": (
            lambda: cr.compact_stage(g, e, thres, block=block, bcap=bcap),
            lambda: cr.compact_stage_plain(g, e, thres, block=block,
                                           bcap=bcap)),
        "compact_resid": (
            lambda: cr.compact_resid(g, e, thres, enc, block=block,
                                     bcap=bcap, k_cap=k_cap, out=e_out),
            lambda: cr.compact_resid_plain(g, e, thres, enc, block=block,
                                           bcap=bcap, k_cap=k_cap)),
        "compact_sweep": (
            lambda: cr.compact_sweep(g, e, thres, block=block, bcap=bcap,
                                     k_cap=k_cap, out=e_out),
            lambda: cr.compact_sweep_plain(g, e, thres, block=block,
                                           bcap=bcap, k_cap=k_cap)),
        "moments": (lambda: mom.moments(u, block=sb, num_warps=w),
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    extra = {   # bytes beyond the leaf-sized operands and outputs
        "fused_moments": 12, "fused_moments_hist": 8 * 128 + 24 * sms,
        "tree_count": 8 * nt, "compact_stage": 8 * nb * bcap + 4 * nb,
        "compact_resid": 8 * nb,
        "compact_sweep": 8 * nb * bcap + 4 * nb + 6 * k_cap,
        "moments": 12, "count_gt": 8,
        "threshold_compact": 8 * nb * ubcap + 4 * nb,
        "abs_histogram": 8 * 128}
    nops = {"fused_moments": 5, "fused_moments_hist": 20, "tree_count": 17,
            "compact_stage": 3, "compact_resid": 3, "compact_sweep": 3,
            "moments": 5,
            "count_gt": 3, "threshold_compact": 3, "abs_histogram": 15}
    times = {}
    for name, (kern, plain) in fns.items():
        k_ms, p_ms = time_ms(kern, 10), time_ms(plain, 3)
        b_ms, b_by = bound(BF16_LEAF_BYTES[name] * d + extra[name],
                           nops[name] * d)
        times[name] = k_ms
        rows[name]["bf16"] = {
            "g": "bfloat16", "e": "bfloat16", "d": d, "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": errs.get(name, 0.0),
            "pairs_checked": [f"{a}/{b}" for a, b in BF16_PAIRS],
            "config": out["config"]}
    log("  17a times at d={:,}, g and e bf16 (ms, median; bound by bytes "
        "at {:.2f} TB/s): ".format(d, HBM_BYTES_PER_S / 1e12) + "; ".join(
            f"{n} {rows[n]['bf16']['ms']:.4f} (bound "
            f"{rows[n]['bf16']['bound_ms']:.4f}, plain "
            f"{rows[n]['bf16']['plain_ms']:.3f})" for n in fns))
    sweep_ms, two_ms = two_launch_times(torch, g, e, thres, block, bcap,
                                        k_cap, e_out, 10)
    rows["compact_sweep"]["bf16"].update(turns_ms=sweep_ms,
                                         two_launch_ms=two_ms)
    log(f"  17a K3 at bf16: the sweep {sweep_ms} ms against the two "
        f"launches and the assembly {two_ms} ms, in turns")
    out["times_ms"] = times
    out["checked_s"] = checked_s
    del g, e, u, e_out, operands, e32
    torch.cuda.empty_cache()
    return out


def bf16_runner(torch, cfg, mesh, workers, model_size, batch, seq,
                capture):
    """``runner`` for :func:`train_path`: the reference dry run's bf16
    train step (``launch/dryrun.py:lower_train``) through the library
    entry points: ``init_params`` of the bf16 ``cfg``,
    ``init_train_state(..., resid_dtype=torch.bfloat16)``, Gaussian-k at
    ``RATIO`` bucketed over allgather, SGD with momentum 0.9, on
    ``mesh``'s ``LocalWire`` with remat.  Every compression must write
    ``e'`` into the state's bf16 residual in place; ``capture`` receives
    the layout, then row 0 of rank 0's step-0 bucket ``G``, of its
    residual before the compression (``E``, zero) and of the card's pair
    and ``e'``, on the host."""
    def run(steps, probe):
        from repro_torch.core.compression import CompressionConfig
        from repro_torch.data import batch_for
        from repro_torch.dist.layout import build_layout
        from repro_torch.dist.wire import LocalWire
        from repro_torch.launch.mesh import parse_mesh
        from repro_torch.models import init_params
        from repro_torch.optim import constant, sgd_momentum
        from repro_torch.train import init_train_state, make_train_step
        comp = CompressionConfig(compressor="gaussiank", ratio=RATIO)
        params = init_params(cfg, 0, "cuda")
        assert all(p.dtype == torch.bfloat16 for p in
                   __import__("repro_torch").tree.leaves(params))
        layout = build_layout(params, model_size, comp)
        opt = sgd_momentum(0.9)
        state = init_train_state(params, opt, workers=workers,
                                 model_size=model_size, compression=comp,
                                 layout=layout, resid_dtype=torch.bfloat16)
        resid = state["resid"]
        assert resid.dtype == torch.bfloat16, resid.dtype
        step_no = [0]

        def host(t):
            return t.to("cpu", copy=True)

        def watch(rank, **kw):
            ne = kw.get("new_E")
            if ne is not None:
                assert ne.dtype == torch.bfloat16, ne.dtype
                assert ne.data_ptr() == resid[rank].data_ptr(), (
                    "e' not written into the state's residual", rank)
                if rank == 0 and step_no[0] == 0:    # row 0 alone
                    capture.append({"step": step_no[0], "E": capture_e[0],
                                    **{n: host(kw[n][:1]) for n in (
                                        "G", "values", "indices")},
                                    "new_E": host(ne[:1])})
            probe(rank, **kw)

        step = make_train_step(cfg, mesh, opt, constant(0.1),
                               compression=comp, layout=layout, probe=watch,
                               wire=LocalWire(parse_mesh(mesh)), remat=True)
        capture_e = [None]
        capture.append({"layout": layout})
        records = []
        for i in range(steps):
            step_no[0] = i
            if i == 0:
                capture_e[0] = host(resid[0].view(model_size, -1)[:1])
            b = batch_for(cfg, i, global_batch=batch, seq_len=seq,
                          device="cuda")
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            rec = {"step": i, "ms": (time.perf_counter() - t0) * 1e3}
            rec.update({k: float(v) for k, v in m.items()})
            records.append(rec)
            assert state["resid"] is resid, "the residual was replaced"
        assert all(p.dtype == torch.bfloat16 for p in
                   __import__("repro_torch").tree.leaves(state["params"]))
        return records
    return run


def phase17b(torch, by_path) -> tuple:
    """17b: llama3.2-1b at full width and depth in bf16 (params and
    activations), the reference dry run's train step: the trainer's
    default mesh 4x2 in this process (4 workers, 2 bucket rows each),
    8 x 512 with remat, Gaussian-k at 0.001 bucketed over allgather,
    SGD momentum 0.9, a bf16 residual; 3 steps.  Finite losses, one K1,
    K2 and K3 pair a leaf a bucket row a worker a step (96 each), ``e'``
    written into the state's bf16 residual in place, every worker's
    step-0 bucket conserving bitwise in bf16; step ms and peak memory
    beside PR 25's f32 run at 8 x 512 with remat (one worker)."""
    from repro_torch.configs import get_config
    cfg = bf16_cfg(get_config("llama3.2-1b"))
    label = "17b bf16 mesh 4x2"
    capture = []
    log(f"phase 17b: llama3.2-1b at full width and depth in bf16, --mesh "
        f"4x2 in this process, {BF16_BATCH} x {BF16_SEQ} with remat, "
        f"Gaussian-k at {RATIO}, a bf16 residual, 3 steps")
    by_path[label], records, peak, bnd, extra = train_path(
        label, [], {n: 96 for n in MAIN_KERNELS}, 3, torch, workers=4,
        cfg=cfg, leaf_bytes=BF16_LEAF_BYTES,
        runner=bf16_runner(torch, cfg, "4x2", 4, 2, BF16_BATCH, BF16_SEQ,
                           capture))
    assert peak < 80e9, (label, "peak memory", peak)
    ms = [r["ms"] for r in records]
    out = {"losses": [r["loss"] for r in records], "step_ms": ms,
           "steady_ms": statistics.median(ms[1:]),
           "compress_ms": extra["compress_ms"], "wire_ms": extra["wire_ms"],
           "peak_gib": peak / 2 ** 30,
           "density": [r["density"] for r in records],
           "step_bound_ms": bnd,
           "f32_1x1_remat_512_pr25": {"steady_ms": [905.8, 910.5],
                                      "peak_gib": 28.14}}
    log(f"  {label}: steady step {out['steady_ms']:.1f} ms, peak "
        f"{out['peak_gib']:.2f} GiB (PR 25, f32, one worker, 8 x 512 with "
        f"remat: 905.8-910.5 ms, 28.14 GiB); e' written in place into the "
        f"bf16 residual at every compression")
    return out, capture


def phase17c(torch, capture) -> dict:
    """17c: the card's compression against the CPU's: row 0 of rank 0's
    step-0 bucket ``G`` and residual ``E`` (17b's, on the host) through
    the plain pipeline on the CPU at the card's block geometry, segment
    by segment, on the segments of at most 2^25 columns (the rest would
    take minutes on the host): the pair and ``e'`` bitwise the card's.
    Then the bf16 ``.reduced()`` variant 2 steps on the card and on the
    CPU from the same params (drawn on the CPU), the CPU at the card's
    block geometry: losses within rtol 2.5e-4, the tolerance of
    ``tests/test_torch_bf16.py``'s bf16 step."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data import batch_for
    from repro_torch.dist.layout import build_layout
    from repro_torch.kernels.ef_fused import segmented_compress_ef, tuning
    from repro_torch.models import init_params
    from repro_torch.optim import constant, sgd_momentum
    from repro_torch.train import init_train_state, make_train_step
    layout = capture[0]["layout"]
    segs = [s for s in layout.segments if s.d_row <= 1 << 25]
    out = {"segments": [s.name for s in segs],
           "columns": sum(s.d_row for s in segs)}
    t0 = time.time()
    for cap in capture[1:]:
        G, E = cap["G"][:1], cap["E"][:1].clone()
        assert G.dtype == E.dtype == torch.bfloat16
        with tuning.geometry_of("cuda"):
            triples = segmented_compress_ef(
                G, E, [(s.row_off, s.d_row) for s in segs], "gaussiank",
                [s.k_row for s in segs], [s.k_cap for s in segs], out2d=E)
        for s, (v, i, ne) in zip(segs, triples):
            cols = slice(s.row_off, s.row_off + s.d_row)
            caps = slice(s.cap_off, s.cap_off + s.k_cap)
            ci = cap["indices"][0, caps]
            ci = torch.where(ci >= 0, ci - s.row_off, ci)
            assert same_bits(v[0], cap["values"][0, caps]), (
                "17c values", cap["step"], s.name)
            assert torch.equal(i[0], ci), ("17c indices", cap["step"],
                                           s.name)
            assert same_bits(ne[0], cap["new_E"][0, cols]), (
                "17c e'", cap["step"], s.name)
        log(f"  17c step {cap['step']}: rank 0's row 0, {len(segs)} "
            f"segments ({out['columns']:,} columns): the CPU's pair and e' "
            f"bitwise the card's")
    out["compare_s"] = time.time() - t0
    cfg = bf16_cfg(get_config("llama3.2-1b").reduced())
    base = init_params(cfg, 0, "cpu")
    comp = CompressionConfig(compressor="gaussiank", ratio=0.01)
    losses = {}
    for dev in ("cuda", "cpu"):
        params = tree.tree_map(lambda x: x.clone().to(dev), base)
        lay = build_layout(params, 1, comp)
        opt = sgd_momentum(0.9)
        state = init_train_state(params, opt, workers=1, model_size=1,
                                 compression=comp, layout=lay,
                                 resid_dtype=torch.bfloat16)
        step = make_train_step(cfg, (1, 1), opt, constant(0.1),
                               compression=comp, layout=lay)
        ls = []
        with tuning.geometry_of("cuda"):
            for i in range(2):
                b = batch_for(cfg, i, global_batch=8, seq_len=64, device=dev)
                state, m = step(state, b)
                ls.append(float(m["loss"]))
        assert state["resid"].dtype == torch.bfloat16
        losses[dev] = ls
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=2.5e-4)
    out["reduced_losses"] = losses
    log(f"  17c reduced bf16 variant, 2 steps: card {losses['cuda']} vs CPU "
        f"{losses['cpu']} within rtol 2.5e-4")
    return out


def phase17_bf16(torch, by_path, rows) -> dict:
    """Phase 17, slice 12, bf16 operands: 17a the kernels at bf16, 17b the
    bf16 train step at full width, 17c card against CPU."""
    t0 = time.time()
    log("phase 17a: the EF kernels at d = 268,435,456 with bf16 operands")
    out = {"17a": phase17a(torch, rows)}
    t1 = time.time()
    out["17b"], capture = phase17b(torch, by_path)
    torch.cuda.empty_cache()
    t2 = time.time()
    log("phase 17c: the card's bf16 compression and the reduced variant "
        "against the CPU")
    out["17c"] = phase17c(torch, capture)
    del capture
    out["phase17_s"] = time.time() - t0
    log(f"phase 17 took {out['phase17_s']:.1f} s (17a {t1 - t0:.1f}, 17b "
        f"{t2 - t1:.1f}, 17c {time.time() - t2:.1f})")
    return out


# -- phase 18: bf16 state end to end (slice 15) --

BF16_LONG = (8, 2048)        # 18a: the bf16 train step's batch x seq
BF16_STATE_LAYERS = 2        # 18b: llama3.2-1b at full width, 2 layers
# 18c: the serve CLI's default traffic (8 requests of 64 prompt tokens,
# up to 16 generated), a topk delta every 4 decode steps, no resync after
# the first: 1 resync + 3 deltas (the one wave decodes 14 steps)
BF16_SERVE_ARGV = ["--arch", "llama3.2-1b", "--mesh", "1x1", "--requests",
                   "8", "--max-batch", "8", "--prompt-len", "64", "--gen",
                   "16", "--publish-every", "4", "--publish-ratio", "0.01",
                   "--resync-every", "0"]


def bf16_tol(ref) -> float:
    """4 bf16 ulps of the largest magnitude of ``ref`` (a float32 numpy
    array): the tolerance ``tests/test_torch_bf16_state.py`` holds bf16
    logits to (``_bf16_tol``)."""
    import numpy as np
    top = float(np.abs(ref).max())
    return 4 * 2.0 ** (math.floor(math.log2(top)) - 7)


def bf16_train_state(torch, cfg, comp, device):
    """llama's bf16 train state as the reference's dry run builds it: the
    bf16 ``cfg``'s params drawn on ``device``, SGD momentum 0.9, a bf16
    residual bucket; ``(state, step, layout)``, the step rematerialised."""
    from repro_torch.dist.layout import build_layout
    from repro_torch.models import init_params
    from repro_torch.optim import constant, sgd_momentum
    from repro_torch.train import init_train_state, make_train_step
    params = init_params(cfg, 0, device)
    layout = build_layout(params, 1, comp)
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=1, model_size=1,
                             compression=comp, layout=layout,
                             resid_dtype=torch.bfloat16)
    step = make_train_step(cfg, "1x1", opt, constant(0.1), compression=comp,
                           layout=layout, remat=True)
    return state, step, layout


def phase18a(torch, by_path, smi) -> dict:
    """18a: the dry run's count at the reference's bf16 dtypes against the
    card.  llama3.2-1b at full width and depth in bf16 (params,
    activations, residual), one worker, ``BF16_LONG`` with remat, 2 steps
    (12 launches a step of K1, K2 and the K3 sweep): each step's peak
    above the memory allocated before it; then a bf16 prefill of 1 x
    32,768, its peak above the params and prompt.  Each within
    ``COUNT_TOLERANCE`` of ``step_cost.count_temp_bytes`` on the bf16
    config (:func:`bf16_cfg`, the dry run's ``_bf16``), as 16d holds the
    f32 count."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data import batch_for
    from repro_torch.launch import step_cost
    from repro_torch.models import init_params, prefill
    cfg = bf16_cfg(get_config("llama3.2-1b"))
    B, T = BF16_LONG
    comp = CompressionConfig(compressor="gaussiank", ratio=RATIO)
    mem, ms, losses = [], [], []

    def run():
        state, step, _ = bf16_train_state(torch, cfg, comp, "cuda")
        for i in range(2):
            b = batch_for(cfg, i, global_batch=B, seq_len=T, device="cuda")
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, m = step(state, b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            mem.append((before, torch.cuda.max_memory_allocated()))
            losses.append(float(m["loss"]))
        assert state["resid"].dtype == torch.bfloat16
        del state, step

    label = f"18a bf16 train {B} x {T}"
    log(f"phase 18a: llama3.2-1b in bf16 at full width and depth, {B} x "
        f"{T} with remat, 2 steps, a bf16 residual")
    by_path[label], _ = drive(label, run, {n: 12 for n in MAIN_KERNELS}, 2,
                              {"threefry_bits": init_draws(cfg)})
    assert all(math.isfinite(x) for x in losses), (label, losses)
    torch.cuda.empty_cache()
    params = init_params(cfg, 0, "cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(18)
    toks = torch.randint(0, cfg.vocab_size, (1, LONG_PREFILL),
                         generator=gen, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    logits, cache, _ = prefill(params, cfg, toks, s_max=LONG_PREFILL)
    ev[1].record()
    torch.cuda.synchronize()
    pre_peak = torch.cuda.max_memory_allocated() - before
    assert logits.dtype == torch.bfloat16 and all(
        c.dtype == torch.bfloat16 for c in tree.leaves(cache))
    assert bool(torch.isfinite(logits).all()), "18a prefill logits"
    prefill_ms = ev[0].elapsed_time(ev[1])
    del params, cache, logits, toks
    torch.cuda.empty_cache()
    rows = {
        f"train {B} x {T}": (step_cost.count_temp_bytes(
            cfg, B, T, remat=True)["temp_bytes"],
            max(peak - b for b, peak in mem)),
        f"prefill 1 x {LONG_PREFILL}": (step_cost.count_temp_bytes(
            cfg, 1, LONG_PREFILL, kind="prefill")["temp_bytes"], pre_peak)}
    out = {"losses": losses, "step_ms": ms, "prefill_ms": prefill_ms,
           "step_memory": mem, "peak_gib": max(p for _, p in mem) / 2 ** 30,
           "counts": {}}
    for name, (counted, measured) in rows.items():
        ratio = counted / measured
        out["counts"][name] = {"counted": counted, "measured": measured,
                               "ratio": ratio}
        log(f"  18a {name} bf16: counted {counted / 2 ** 30:.3f} GiB, "
            f"measured {measured / 2 ** 30:.3f} GiB on the card (count / "
            f"card {ratio:.3f}) [{smi}]")
        assert abs(ratio - 1) <= COUNT_TOLERANCE, ("18a", name, ratio)
    log(f"  18a: train losses {losses}, step ms "
        f"{[round(x, 1) for x in ms]}, peak {out['peak_gib']:.2f} GiB; "
        f"prefill 1 x {LONG_PREFILL} {prefill_ms:.1f} ms [{smi}]")
    return out


def phase18b(torch, by_path, smi) -> dict:
    """18b: a bf16 train state through a checkpoint on the card.
    llama3.2-1b at full width with ``BF16_STATE_LAYERS`` layers, bf16
    params, momentum and residual, Gaussian-k at 0.001, 8 x 128: one
    step, ``save_state`` into a temporary directory (removed after),
    then a second step of the straight run; a fresh state loads the file
    (every leaf bitwise the saved state's) and takes that second step:
    its loss, params, momentum and residual bitwise the straight run's.
    12 launches a step of K1, K2 and the K3 sweep at bf16 (3 steps)."""
    import tempfile

    from repro_torch import tree
    from repro_torch.checkpoint import load_state, save_state
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data import batch_for
    cfg = bf16_cfg(llama_layers(BF16_STATE_LAYERS))
    comp = CompressionConfig(compressor="gaussiank", ratio=RATIO)
    batches = [batch_for(cfg, i, global_batch=8, seq_len=128,
                         device="cuda") for i in range(2)]
    out = {}

    def host(state):
        return [(tree.path_name(p), x.to("cpu", copy=True)
                 if torch.is_tensor(x) else x)
                for p, x in tree.flatten_with_path(state)[0]]

    def run():
        state, step, _ = bf16_train_state(torch, cfg, comp, "cuda")
        state, _ = step(state, batches[0])
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "bf16.npz")
            t0 = time.perf_counter()
            save_state(path, state)
            out["save_s"] = time.perf_counter() - t0
            out["file_gib"] = os.path.getsize(path) / 2 ** 30
            saved = host(state)
            state, m = step(state, batches[1])
            straight = float(m["loss"])
            torch.cuda.synchronize()
            want = host(state)
            del state, step
            torch.cuda.empty_cache()
            fresh, step, _ = bf16_train_state(torch, cfg, comp, "cuda")
            t0 = time.perf_counter()
            fresh = load_state(path, fresh)
            out["load_s"] = time.perf_counter() - t0
        for (name, a), (_, b) in zip(saved, host(fresh)):
            assert (same_bits(a, b) if torch.is_tensor(a) else a == b), (
                "18b loaded", name)
        fresh, m = step(fresh, batches[1])
        assert float(m["loss"]) == straight, ("18b loss", m["loss"],
                                              straight)
        for (name, a), (_, b) in zip(want, host(fresh)):
            if torch.is_tensor(a):
                assert a.dtype == torch.bfloat16 or name == "step", name
                assert same_bits(a, b), ("18b resumed step", name)
            else:
                assert a == b, ("18b resumed step", name)
        out["loss"] = straight

    label = f"18b bf16 checkpoint {BF16_STATE_LAYERS} layers"
    log(f"phase 18b: a bf16 train state of llama3.2-1b at full width with "
        f"{BF16_STATE_LAYERS} layers saved, loaded and stepped on the card")
    t0 = time.time()
    by_path[label], _ = drive(label, run, {n: 12 for n in MAIN_KERNELS}, 3,
                              {"threefry_bits": 2 * init_draws(cfg)})
    out["seconds"] = time.time() - t0
    log(f"  18b: {out['file_gib']:.2f} GiB file (save {out['save_s']:.1f} "
        f"s, load {out['load_s']:.1f} s); the loaded state bitwise the "
        f"saved one, the resumed step (loss {out['loss']!r}) bitwise the "
        f"straight run's; launches {by_path[label]} [{smi}]")
    return out


def bf16_stream_checker(torch, counts):
    """A probe for 18c's CLI run (a bf16 replica, the CLI's f32 stream):
    at a resync the replica equals the trainer bitwise; at every publish
    the message is the layout's size and the largest difference between
    the replica and ``pub`` (bf16 leaves against an f32 view, which do not
    round alike) is recorded."""
    from repro_torch import tree
    from repro_torch.dist.layout import pack_grads
    from repro_torch.serve import RESYNC, message_bits

    def probe(event, msg, layout, state, trainer, replica):
        assert all(x.dtype == torch.bfloat16 for x in tree.leaves(replica))
        assert state["pub"].dtype == torch.float32
        if msg.kind == RESYNC:
            for a, b in zip(tree.leaves(replica), tree.leaves(trainer)):
                assert same_bits(a, b), ("18c resync", msg.seq)
            assert message_bits(msg) == layout.d_row_total * 32
        else:
            assert message_bits(msg) == layout.pair_bits()
        gap = pack_grads(layout, replica, torch.float32).sub_(
            state["pub"]).abs_().max().item()
        counts.setdefault("gaps", []).append(gap)
        counts.setdefault("kinds", []).append(msg.kind)

    return probe


def bf16_publisher(torch, trainer, compressor, ticks):
    """``ticks`` publishes of a bf16-stream publisher (``compressor`` at
    0.01) from the bf16 ``trainer`` (drifted a tick) into a bf16
    replica: after each, ``pub`` bitwise the packed replica (leaf and
    stream dtypes match).  Returns the kinds, the launches a tick and the
    publish and apply ms (CUDA events)."""
    from repro_torch import prng, tree
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.dist.layout import build_layout, pack_grads
    from repro_torch.launch import serve
    from repro_torch.serve import apply_message, init_publisher_state, \
        publish
    config = CompressionConfig(compressor=compressor, ratio=0.01)
    layout = build_layout(trainer, 1, config)
    state = init_publisher_state(layout, dtype=torch.bfloat16)
    replica = tree.tree_map(torch.zeros_like, trainer)
    kinds, per, ms = [], [], []
    for t in range(ticks):
        trainer = serve.drift(trainer, 4 * t)
        before = {n: f.launches for n, f in counters().items()}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        state, msg = publish(state, trainer, layout, config,
                             prng.PRNGKey(5), resync_every=0)
        ev[1].record()
        replica = apply_message(replica, layout, msg)
        ev[2].record()
        torch.cuda.synchronize()
        per.append({n: f.launches - before[n]
                    for n, f in counters().items()})
        assert state["pub"].dtype == torch.bfloat16
        assert same_bits(state["pub"], pack_grads(layout, replica,
                                                  torch.bfloat16)), (
            "18c pub == pack(replica)", compressor, t)
        kinds.append(msg.kind)
        ms.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])))
    return kinds, per, ms


def phase18c(torch, by_path, smi) -> dict:
    """18c: bf16 serving.  ``launch.serve.run`` on llama3.2-1b at full
    width and depth in bf16 (params, activations and the KV cache) with
    ``BF16_SERVE_ARGV``: 1 resync and 3 deltas of the CLI's ``topk``
    publisher (f32 stream), the replica equal to the trainer at the
    resync; tokens/s, prefill, decode, publish and apply ms.  Then
    through the library at full width, bf16 streams: ``topk`` (1 resync
    + 3 deltas) and ``gaussiank`` (1 resync + 2 deltas, each delta 12
    launches of K1, K2 and the K3 sweep at bf16), ``pub`` bitwise the
    packed replica after every message.  Then the bf16 smoke variant
    card against CPU from the same params: prefill of 2 x 8 and 8 greedy
    decode steps, both fed the CPU's tokens: logits within
    :func:`bf16_tol` of the step's largest CPU |logit|, the card's greedy
    token the CPU's (or a near tie: the CPU's top two within that
    tolerance, counted)."""
    import numpy as np

    from repro_torch import prng, tree
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, init_params, prefill
    cfg = bf16_cfg(get_config("llama3.2-1b"))
    out = {}
    counts = {}
    log("phase 18c: launch.serve.run on llama3.2-1b in bf16 at full width "
        "and depth, 8 requests, prompt 64, gen 16, a topk delta every 4 "
        "decode steps")
    torch.cuda.reset_peak_memory_stats()
    launches, got = zeroed(lambda: serve.run(
        BF16_SERVE_ARGV, probe=bf16_stream_checker(torch, counts), cfg=cfg))
    want = {n: 0 for n in launches}
    want["threefry_bits"] = init_draws(cfg) + 2 * got["waves"]
    assert launches == want, ("18c launches", launches, want)
    by_path["18c serve bf16, topk stream"] = launches
    assert counts["kinds"] == [0, 1, 1, 1], counts["kinds"]
    assert got["done"] == 8 and (got["resyncs"], got["deltas"]) == (1, 3)
    assert all(t.shape[0] == 8 for t in got["tokens"])
    times = got["times"]
    out["serve"] = {
        "tok_s": got["tok_s"], "prefill_ms": times["prefill"],
        "decode_ms_median": med(times["decode"]),
        "publish_delta_ms": times.get("publish_delta", []),
        "apply_delta_ms": times.get("apply_delta", []),
        "publish_resync_ms": times.get("publish_resync", []),
        "apply_resync_ms": times.get("apply_resync", []),
        "replica_vs_pub": counts["gaps"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    s = out["serve"]
    log(f"  18c serve bf16: {s['tok_s']:.1f} tokens/s, prefill ms "
        f"{[round(x, 2) for x in s['prefill_ms']]}, decode step median "
        f"{s['decode_ms_median']:.3f} ms, publish ms delta "
        f"{[round(x, 1) for x in s['publish_delta_ms']]} resync "
        f"{[round(x, 1) for x in s['publish_resync_ms']]}, apply ms delta "
        f"{[round(x, 2) for x in s['apply_delta_ms']]} resync "
        f"{[round(x, 2) for x in s['apply_resync_ms']]}; peak "
        f"{s['peak_gib']:.2f} GiB; replica == trainer at the resync; "
        f"|replica - pub| {[float(f'{g:.3g}') for g in counts['gaps']]} "
        f"(bf16 leaves, f32 stream) [{smi}]")
    del got
    torch.cuda.empty_cache()

    trainer = init_params(cfg, 0, "cuda")
    for compressor, ticks in (("topk", 4), ("gaussiank", 3)):
        label = f"18c {compressor} publisher bf16 stream"
        launches, (kinds, per, ms) = zeroed(
            lambda: bf16_publisher(torch, trainer, compressor, ticks))
        by_path[label] = launches
        assert kinds == [0] + [1] * (ticks - 1), (label, kinds)
        want = {n: (12 if compressor == "gaussiank" and n in MAIN_KERNELS
                    else 0) for n in per[0]}
        assert per[0] == {n: 0 for n in per[0]}, (label, per[0])
        for p in per[1:]:
            assert p == want, (label, p, want)
        out[compressor] = {"publish_ms": [m[0] for m in ms],
                           "apply_ms": [m[1] for m in ms]}
        log(f"  {label}: pub bitwise the packed bf16 replica after each "
            f"of {ticks} messages; launches a tick {per[1]}; publish ms "
            f"{[round(m[0], 1) for m in ms]}, apply ms "
            f"{[round(m[1], 2) for m in ms]} [{smi}]")
    del trainer
    torch.cuda.empty_cache()

    small = bf16_cfg(get_config("llama3.2-1b").reduced())
    base = init_params(small, 0, "cpu")
    prompt = prng.randint(prng.PRNGKey(4), (2, 8), 0, small.vocab_size,
                          device="cpu")
    res = {}
    for dev in ("cpu", "cuda"):
        p = tree.tree_map(lambda v: v.to(dev), base)
        logits, cache, _ = prefill(p, small, prompt.to(dev), s_max=16)
        steps = [logits[:, -1].float().cpu().numpy()]
        for pos in range(8, 16):
            # both fed the CPU's greedy tokens (the CPU runs first)
            tok = (steps[-1].argmax(-1) if dev == "cpu"
                   else res["cpu"][pos - 8].argmax(-1))
            logits, cache = decode_step(
                p, small, cache, pos,
                torch.from_numpy(tok[:, None]).long().to(dev))
            steps.append(logits[:, -1].float().cpu().numpy())
        res[dev] = steps
    worst, ties = 0.0, []
    for i, (a, b) in enumerate(zip(res["cpu"], res["cuda"])):
        tol = bf16_tol(a)
        err = float(np.abs(a - b).max())
        assert err <= tol, ("18c card vs CPU logits", i, err, tol)
        worst = max(worst, err / tol)
        for row in range(a.shape[0]):
            if a[row].argmax() != b[row].argmax():
                top = np.sort(a[row])[-2:]
                assert top[1] - top[0] <= tol, ("18c token", i, row)
                ties.append((i, row))
    out["reduced"] = {"largest_err_over_tol": worst, "near_ties": ties}
    log(f"  18c bf16 smoke variant card vs CPU: prefill + 8 decode steps' "
        f"logits within 4 bf16 ulps of the largest |logit| (largest "
        f"error {worst:.2f} of it), greedy tokens equal but {len(ties)} "
        f"near ties")
    return out


def phase18_bf16_state(torch, by_path, smi) -> dict:
    """Phase 18, slice 15, bf16 state end to end: 18a the dry run's bf16
    count against the card, 18b a bf16 checkpoint, 18c bf16 serving."""
    t0 = time.time()
    out = {"18a": phase18a(torch, by_path, smi)}
    t1 = time.time()
    out["18b"] = phase18b(torch, by_path, smi)
    t2 = time.time()
    out["18c"] = phase18c(torch, by_path, smi)
    out["phase18_s"] = time.time() - t0
    out["sub_s"] = {"18a": t1 - t0, "18b": t2 - t1, "18c": time.time() - t2}
    log(f"phase 18 took {out['phase18_s']:.1f} s (18a {t1 - t0:.1f}, 18b "
        f"{t2 - t1:.1f}, 18c {time.time() - t2:.1f})")
    return out


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
    # the operand dtypes each kernel is checked at (phases 2 and 17;
    # threefry_bits: its outputs')
    rows = {n: {"name": v[0], "route": v[1], "source": v[2],
                "replaces": v[3], "library_ms": None,
                "dtypes": (["int32", "int64"] if n == "threefry_bits"
                           else ["float32", "bfloat16"])}
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
    if "--tensor-parallel-cards" in argv:
        log(json.dumps({"four_cards": tensor_parallel_cards(torch)},
                       default=str))
        log("tensor-parallel-cards run: the four-card measurement alone")
        return 0
    if "--serve-placement-only" in argv:
        by_path = {}
        log(json.dumps({"phase14": phase14_placed(torch, by_path),
                        "launches_by_path": by_path}, default=str))
        log("serve-placement-only run: phases 2-13 skipped")
        return 0
    if "--remat-table-only" in argv:
        by_path = {}
        log(json.dumps({"phase15": phase15_remat_table(torch, by_path),
                        "launches_by_path": by_path}, default=str))
        log("remat-table-only run: phases 2-14 skipped")
        return 0
    if "--long-seq-only" in argv:
        by_path = {}
        if torch.cuda.device_count() >= 4:
            res = {"16c": phase16c(torch, 4)}
            log(json.dumps({"phase16": res}, default=str))
            log("long-seq-only run on four cards: 16c at 1x4 alone")
            return 0
        log(json.dumps({"phase16": phase16_long(torch, by_path),
                        "launches_by_path": by_path}, default=str))
        log("long-seq-only run: phases 2-15 skipped")
        return 0
    if "--bf16-only" in argv:
        by_path = {}
        log(json.dumps({"phase17": phase17_bf16(torch, by_path, rows),
                        "phase18": phase18_bf16_state(torch, by_path, smi),
                        "launches_by_path": by_path}, default=str))
        log(json.dumps({"kernels": [dict(name=r["name"], **r.get(
            "bf16", {})) for r in rows.values()]}, default=str))
        log(f"bf16-only run: phases 2-16 skipped; "
            f"{time.time() - t_start:.1f} s in all [{smi}]")
        return 0
    if "--tensor-parallel-only" in argv:
        by_path = {}
        log(json.dumps({"phase12b": phase12b(torch, by_path, llama),
                        "phase12c": phase12c(torch, by_path),
                        "launches_by_path": by_path}))
        log("tensor-parallel-only run: phases 12b and 12c alone")
        return 0

    # 13f's dry run needs no card: its minutes on the host overlap
    # phases 2-13
    dry = None if kernels_only else start_dryrun()

    # -- phase 2: kernels against their plain versions --
    log(f"-- phase 2 starts at {time.time() - t_start:.1f} s")
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
    log(f"-- phase 3 starts at {time.time() - t_start:.1f} s")
    by_path = {}
    log("phase 3: llama3.2-1b at full width, Gaussian-k (fused), 3 steps")
    by_path["gaussiank fused"], records, peak, bnd, _ = train_path(
        "gaussiank fused", llama, {n: 12 for n in MAIN_KERNELS}, 3, torch)
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
        {"fused_moments_hist": 12, "compact_sweep": 12}, 3, torch)
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
    log(f"-- phase 4 starts at {time.time() - t_start:.1f} s")
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
    log(f"-- phase 5 starts at {time.time() - t_start:.1f} s")
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
    log(f"-- phase 6 starts at {time.time() - t_start:.1f} s")
    phase6 = phase6_adaptive(torch, by_path, llama_adaptive=[
        "--arch", "llama3.2-1b", "--mesh", "1x1", "--batch", "8", "--seq",
        "128"], fixed_step_ms=main_path["step_ms"], fixed_peak=main_path[
            "peak_mem_gib"], base=base, cfg=cfg)

    # -- phase 7: the PRNG, the keyed compressors, momentum correction --
    log(f"-- phase 7 starts at {time.time() - t_start:.1f} s")
    phase7 = phase7_keyed(torch, by_path, rows, base, cfg)

    # -- phase 8: the paper's experiments --
    log(f"-- phase 8 starts at {time.time() - t_start:.1f} s")
    phase8 = phase8_paper(torch, by_path)

    # -- phase 9: the chunked schedule and the per-leaf loop --
    log(f"-- phase 9 starts at {time.time() - t_start:.1f} s")
    phase9 = phase9_chunked(torch, by_path, ref5c, cfg, base)

    # -- phase 10: serving and the weight-delta stream --
    log(f"-- phase 10 starts at {time.time() - t_start:.1f} s")
    phase10 = phase10_serve(torch, by_path)

    # -- phase 11: the other architectures --
    log(f"-- phase 11 starts at {time.time() - t_start:.1f} s")
    phase11 = phase11_archs(torch, by_path, rows)

    # -- phase 12: the model axis --
    log(f"-- phase 12 starts at {time.time() - t_start:.1f} s")
    phase12 = phase12_model_axis(torch, by_path, llama)

    # -- phase 13: the launch and tuning stack --
    log(f"-- phase 13 starts at {time.time() - t_start:.1f} s")
    phase13 = phase13_tuner(torch, by_path, llama, dry)

    # -- phase 14: serving placed over the mesh --
    log(f"-- phase 14 starts at {time.time() - t_start:.1f} s")
    phase14 = phase14_placed(torch, by_path)

    # -- phase 15: rematerialised training, the kernel-config table --
    log(f"-- phase 15 starts at {time.time() - t_start:.1f} s")
    phase15 = phase15_remat_table(torch, by_path)

    # -- phase 16: long sequences --
    log(f"-- phase 16 starts at {time.time() - t_start:.1f} s")
    phase16 = phase16_long(torch, by_path)

    # -- phase 17: bf16 operands --
    log(f"-- phase 17 starts at {time.time() - t_start:.1f} s")
    phase17 = phase17_bf16(torch, by_path, rows)

    # -- phase 18: bf16 state end to end --
    log(f"-- phase 18 starts at {time.time() - t_start:.1f} s")
    phase18 = phase18_bf16_state(torch, by_path, smi)

    for n, row in rows.items():
        row["launches_by_path"] = {p: c[n] for p, c in by_path.items()
                                   if c[n]}
        row["launches"] = sum(row["launches_by_path"].values())
        # the two K3 launches are the sweep's cross-check alone: no
        # path may launch them (drive() holds each path to its kernels)
        assert (row["launches"] == 0) == (n in CROSS_CHECK_KERNELS), (
            n, "launches on the paths", row["launches"])
    log(json.dumps({"pipelines": pipelines, "main_path": main_path,
                    "path_a": path_a, "path_b": path_b, "path_d": path_d,
                    "small": small, "phase5": phase5, "phase6": phase6,
                    "phase7": phase7, "phase8": phase8,
                    "phase9": phase9, "phase10": phase10,
                    "phase11": phase11, "phase12": phase12,
                    "phase13": phase13, "phase14": phase14,
                    "phase15": phase15, "phase16": phase16,
                    "phase17": phase17, "phase18": phase18,
                    "build_s": build_s,
                    "total_s": time.time() - t_start}, default=str))
    log(f"the whole smoke took {time.time() - t_start:.1f} s [{smi}]")
    log(json.dumps({"kernels": list(rows.values())}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    finally:
        stop_dryruns()
    sys.exit(code)
