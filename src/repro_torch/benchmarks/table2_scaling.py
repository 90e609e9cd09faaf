"""Paper Table 2: scaling efficiency of Dense-SGD against sparsified SGD
(port of the JAX package's ``benchmarks/table2_scaling.py``).  Rows of
``(name, us_per_call, derived)``:

* ``table2/comm/{arch}`` — the closed-form per-worker wire volume of
  every strategy at P = 16 workers (4 pods x 4 for the two-level ones),
  ratio 0.001 (``dist.layout.strategy_wire_pairs``);
* ``table2/collectives/{arch}`` — codec-pair collectives a step, the
  per-leaf loop (L leaves) against the bucketed pipeline;
* ``table2/adaptk/{arch}`` — adaptive against fixed-k wire accounting
  under the ``variance`` policy on a seeded synthetic signal
  (``core.adaptk.allocate``): the budget, its exactness, floor, ceiling,
  capacity inflation and occupancy;
* ``table2/merge/...`` — one gTop-k merge round (two decodes, an exact
  top-k re-selection, a re-encode) against the allgather path's P-pair
  decode-average, at d = 2**20 (2**16 with ``smoke``), timed between
  CUDA events on the card (on the CPU with the host clock);
* ``table2/eff/{arch}/{compressor}`` — the scaling efficiency
  ``max(compute, memory) / (max(compute, memory) + collective)`` of each
  ``train_4k`` record of the port's dry run (``launch/dryrun.py``), read
  from ``dryrun_json`` when given.

The first three groups depend on no device: their row strings equal the
reference's, arch for arch (params counted on the meta device).
"""
from __future__ import annotations

import json
import math
import os

P_WORKERS = 16       # data-parallel workers (the paper's worker count)
N_PODS = 4           # pod split for the two-level strategies (4 x 4)
RATIO = 0.001


def _archs(limit=None):
    from repro_torch.configs import ARCHS
    return sorted(ARCHS.items())[:limit]


def _sizes(cfg) -> list:
    from repro_torch import tree
    from repro_torch.models import init_params
    return [int(x.numel()) for x in tree.leaves(init_params(cfg, 0, "meta"))]


def _closed_form_rows(limit=None):
    from repro_torch.dist.layout import strategy_wire_pairs

    rows = []
    ag_pairs = strategy_wire_pairs("allgather", P_WORKERS)
    gt_pairs = strategy_wire_pairs("gtopk", P_WORKERS)
    hi_pairs = strategy_wire_pairs("hierarchical", P_WORKERS, N_PODS)
    hg_pairs = strategy_wire_pairs("hier_gtopk", P_WORKERS, N_PODS)
    for name, cfg in _archs(limit):
        d = sum(_sizes(cfg))
        dense_bytes = 2 * d * 2                      # bf16 ring all-reduce
        k_cap = math.ceil(4 * RATIO * d / 3)
        pair_bytes = k_cap * 8                       # values f32 + idx s32
        ag_bytes = ag_pairs * pair_bytes
        gt_bytes = gt_pairs * pair_bytes
        hg_bytes = hg_pairs * pair_bytes
        rows.append((f"table2/comm/{name}", 0.0,
                     f"dense_MB={dense_bytes/2**20:.1f};"
                     f"allgather_MB={ag_bytes/2**20:.1f};"
                     f"gtopk_MB={gt_bytes/2**20:.1f};"
                     f"hier_MB={hi_pairs * pair_bytes/2**20:.1f};"
                     f"hier_gtopk_MB={hg_bytes/2**20:.1f};"
                     f"allgather_red={dense_bytes/ag_bytes:.0f}x;"
                     f"gtopk_red={dense_bytes/gt_bytes:.0f}x;"
                     f"hier_gtopk_red={dense_bytes/hg_bytes:.0f}x"))
    return rows


def _collectives_rows(limit=None):
    from repro_torch.dist.layout import collective_count

    rows = []
    for name, cfg in _archs(limit):
        L = len(_sizes(cfg))
        ag_pl = collective_count("allgather", P_WORKERS, leaves=L)
        gt_pl = collective_count("gtopk", P_WORKERS, leaves=L)
        hg_pl = collective_count("hier_gtopk", P_WORKERS, N_PODS, leaves=L)
        ag_b = collective_count("allgather", P_WORKERS)
        gt_b = collective_count("gtopk", P_WORKERS)
        hg_b = collective_count("hier_gtopk", P_WORKERS, N_PODS)
        rows.append((f"table2/collectives/{name}", 0.0,
                     f"leaves={L};"
                     f"allgather={ag_pl}->{ag_b};"
                     f"gtopk={gt_pl}->{gt_b};"
                     f"hier_gtopk={hg_pl}->{hg_b};"
                     f"bucketed_red={ag_pl / ag_b:.0f}x"))
    return rows


def _adaptk_rows(limit=None):
    import numpy as np

    from repro_torch.core import adaptk

    policy = adaptk.make_policy("variance")
    rows = []
    for name, cfg in _archs(limit):
        dims = _sizes(cfg)
        lo, hi = zip(*(adaptk.leaf_bounds(d, RATIO, policy) for d in dims))
        K = int(round(RATIO * sum(dims)))
        rng = np.random.default_rng(0)
        w = rng.random(len(dims)) * np.asarray(dims)   # synthetic d·Var
        k, K_eff = adaptk.allocate(K, np.asarray(w, np.float32), lo, hi)
        k = np.asarray(k)
        exact = int(k.sum()) == int(K_eff)
        cap_fixed = sum(math.ceil(4 * max(1, math.ceil(RATIO * d)) / 3)
                        for d in dims)
        cap_adapt = sum(min(d, math.ceil(4 * h / 3))
                        for d, h in zip(dims, hi))
        rows.append((f"table2/adaptk/{name}", 0.0,
                     f"K={int(K_eff)};exact={exact};"
                     f"floor={sum(lo)};ceil={sum(hi)};"
                     f"cap_x={cap_adapt / cap_fixed:.2f};"
                     f"occ={int(K_eff) / cap_adapt:.2f}"))
    return rows


def _time_us(fn, device, iters: int = 5, warmup: int = 2) -> float:
    """Mean microseconds a call: CUDA events around ``iters`` calls on
    the card, the host clock on the CPU."""
    import time

    import torch
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters * 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def _merge_cost_rows(d=1 << 20, device="cuda"):
    """Measured cost of one gTop-k merge round (two decodes, their sum,
    an exact top-``k_cap`` re-selection and re-encode) and of the
    allgather path's decode-average of ``P_WORKERS`` pairs, on a
    ``d``-element leaf at ``RATIO``."""
    import torch

    from repro_torch.core import codec
    from repro_torch.devices import resolve_device
    from repro_torch.dist.aggregate import encode_rows_topk

    device = resolve_device(device)
    k_cap = math.ceil(4 * RATIO * d / 3)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def enc():
        return encode_rows_topk(torch.randn((1, d), generator=gen,
                                            device=device), k_cap)

    (v1, i1), (v2, i2) = enc(), enc()
    pairs = [enc() for _ in range(P_WORKERS)]

    def gtopk_round():
        dense = codec.decode(v1[0], i1[0], d) + codec.decode(v2[0], i2[0],
                                                             d)
        return encode_rows_topk(dense[None], k_cap)

    def allgather_decode():
        total = codec.decode(pairs[0][0][0], pairs[0][1][0], d)
        for v, i in pairs[1:]:
            total = total + codec.decode(v[0], i[0], d)
        return total / P_WORKERS

    rounds = int(math.log2(P_WORKERS))
    us_merge = _time_us(gtopk_round, device)
    us_ag = _time_us(allgather_decode, device)
    return [
        (f"table2/merge/gtopk_round/d={d}", round(us_merge, 1),
         f"k_cap={k_cap};rounds@P{P_WORKERS}={rounds};"
         f"step_total_us={rounds * us_merge:.0f};device={device.type}"),
        (f"table2/merge/allgather_decode/d={d}", round(us_ag, 1),
         f"k_cap={k_cap};pairs={P_WORKERS};step_total_us={us_ag:.0f};"
         f"device={device.type}"),
    ]


def eff_rows(records: list) -> list:
    """The scaling-efficiency rows of the dry run's ``train_4k`` records."""
    rows = []
    for r in records:
        if r.get("status") != "OK" or r["shape"] != "train_4k":
            continue
        rf = r["roofline"]
        t_cm = max(rf["compute_s"], rf["memory_s"])
        t_iter = t_cm + rf["collective_s"]
        eff = t_cm / t_iter if t_iter else 0.0
        rows.append((f"table2/eff/{r['arch']}/{r['compressor']}",
                     round(t_iter * 1e6, 1),
                     f"scaling_eff={eff:.3f};dom={rf['dominant']};"
                     f"hw={rf.get('hardware', '?')}"))
    return rows


def run(smoke: bool = False, device="cuda", dryrun_json=None):
    limit = 3 if smoke else None
    rows = _closed_form_rows(limit)
    rows += _collectives_rows(limit)
    rows += _adaptk_rows(limit)
    rows += _merge_cost_rows(1 << 16 if smoke else 1 << 20, device)
    if not dryrun_json or not os.path.exists(dryrun_json):
        rows.append(("table2/roofline", 0.0, "dryrun json missing; SKIP"))
        return rows
    with open(dryrun_json) as f:
        rows += eff_rows(json.load(f))
    return rows
