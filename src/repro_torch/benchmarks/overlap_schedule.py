"""The chunked overlapped schedule (port of the JAX package's
``benchmarks/overlap_schedule.py``).  Two groups of rows, each ``(name,
us_per_call, derived)``:

* ``dispatch-chunked{N}`` — collectives a step of the chunked
  aggregation at N chunks, counted from the wire's own calls
  (``common.CountingWire`` around a ``LocalWire`` of W = 8 workers in
  this process) at the reference's layout, six leaves: N all-gathers
  for allgather, 2N for hierarchical, N·log2(W) gTop-k rounds.  They
  do not depend on the machine; the reference's are pinned in
  ``benchmarks/baselines/overlap.json``.
* ``step-unchunked`` / ``step-chunked`` — the train step at ``--chunks
  1`` against ``--chunks 4``: eight leaves, W = 8 workers in this
  process (``LocalWire``), d = 4096 (smoke) or 65536, top-k at 0.01,
  the reference's quadratic loss.  With every worker in one process the
  wire cannot overlap the backward, so this row shows what the per-chunk
  dispatch costs, not what the overlap gains.

``run()`` only reports; ``python -m
repro_torch.benchmarks.overlap_schedule --json PATH`` writes the
document (schema ``overlap/v1``: rows of ``{shape, method, passes,
ms}``), and only to ``PATH``.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import prng
from repro_torch.benchmarks.common import CountingWire, stamp_meta, timeit
from repro_torch.core.compression import CompressionConfig
from repro_torch.devices import resolve_device
from repro_torch.dist import aggregate
from repro_torch.dist.layout import build_chunk_plan, build_layout
from repro_torch.dist.wire import LocalWire
from repro_torch.launch.mesh import parse_mesh
from repro_torch.optim import constant, sgd_momentum
from repro_torch.train import init_train_state, make_train_step

# the JAX benchmark's artifact, named in the report row so the two packages'
# rows line up; this module never writes it
REFERENCE_ARTIFACT = "BENCH_overlap.json"
SCHEMA = "overlap/v1"
CHUNKS = (1, 2, 4)
STEP_CHUNKS = 4


def _dispatch_rows(device):
    L, W, ratio = 6, 8, 0.02
    params = {f"layer{i}": torch.zeros(96 + 16 * i, device=device)
              for i in range(L)}
    layout = build_layout(params, 1, CompressionConfig(compressor="topk",
                                                       ratio=ratio))
    cases = (("allgather", f"{W}x1"), ("hierarchical", f"2x{W // 2}x1"),
             ("gtopk", f"{W}x1"))
    rows, bench = [], []
    for strategy, mesh in cases:
        config = CompressionConfig(compressor="topk", ratio=ratio,
                                   strategy=strategy, backend="reference")
        with_r2 = strategy == "hierarchical"
        for n in CHUNKS:
            wire = CountingWire(LocalWire(parse_mesh(mesh)))
            flat = torch.zeros((W, layout.flat_size), device=device)
            aggregate.aggregate_bucketed_chunked(
                [params] * W, flat, layout, build_chunk_plan(layout, n),
                config, wire=wire,
                resid2=torch.zeros_like(flat) if with_r2 else None)
            shape = f"L{L}-W{W}-{strategy}"
            bench.append({"shape": shape, "method": f"dispatch-chunked{n}",
                          "passes": wire.messages, "ms": 0.0})
            rows.append((f"overlap/dispatch-chunked{n}/{shape}", 0.0,
                         f"collectives={wire.messages}"))
    return rows, bench


def _step_rows(smoke: bool, device):
    W, L, ratio = 8, 8, 0.01
    d = 4096 if smoke else 65536
    key = prng.PRNGKey(0)
    params = {f"layer{i}": 0.01 * prng.normal(prng.fold_in(key, i),
                                              (d + 128 * i,), device=device)
              for i in range(L)}
    mesh = parse_mesh(f"{W}x1")
    opt = sgd_momentum(0.9)

    def loss_fn(p, b):
        loss = sum(torch.sum((leaf * b["x"][0, 0]) ** 2)
                   for leaf in p.values())
        return loss, {"loss": loss}

    batch = {"x": torch.ones((W, 1), device=device)}
    iters = 3 if smoke else 10
    rows, bench, times = [], [], {}
    for n_chunks, method in ((1, "step-unchunked"),
                             (STEP_CHUNKS, "step-chunked")):
        comp = CompressionConfig(compressor="topk", ratio=ratio,
                                 chunks=n_chunks)
        layout = build_layout(params, 1, comp)
        state = init_train_state({k: v.clone() for k, v in params.items()},
                                 opt, workers=W, model_size=1,
                                 compression=comp, layout=layout)
        step = make_train_step(None, mesh, opt, constant(0.1),
                               compression=comp, layout=layout,
                               wire=LocalWire(mesh), loss_fn=loss_fn)
        _, m = step(state, batch)
        coll = int(m["collectives_per_step"])
        ms = timeit(step, state, batch, warmup=1, iters=iters) / 1e3
        shape = f"L{L}-W{W}-allgather-d{d}"
        times[method] = ms
        bench.append({"shape": shape, "method": method, "passes": coll,
                      "ms": round(ms, 3)})
        rows.append((f"overlap/{method}/{shape}", round(ms * 1e3, 1),
                     f"chunks={n_chunks};collectives={coll}"))
    ratio_t = times["step-chunked"] / times["step-unchunked"]
    rows.append((f"overlap/step-ratio/L{L}-W{W}", 0.0,
                 f"chunked_vs_unchunked={ratio_t:.3f}x"))
    return rows, bench


def collect(smoke: bool = False, device="cuda"):
    device = resolve_device(device)
    d_rows, d_bench = _dispatch_rows(device)
    s_rows, s_bench = _step_rows(smoke, device)
    return (d_rows + s_rows,
            stamp_meta({"schema": SCHEMA, "smoke": smoke,
                        "rows": d_bench + s_bench}))


def run(smoke: bool = False, device="cuda"):
    # harness entry point: report only
    rows, data = collect(smoke, device)
    rows.append((f"overlap/{REFERENCE_ARTIFACT}", 0.0,
                 f"rows={len(data['rows'])};smoke={smoke};not-written"))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="small shapes")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None,
                    help="write the result document to this path "
                         "(default: write nothing)")
    args = ap.parse_args(argv)
    rows, data = collect(args.smoke, args.device)
    for r in rows:
        print(",".join(str(x) for x in r), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(data, f, indent=1)
        print(f"wrote {args.json} ({len(data['rows'])} rows)")


if __name__ == "__main__":
    main()
