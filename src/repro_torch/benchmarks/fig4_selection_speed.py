"""Paper Fig. 4: selection-operator compute cost vs dimension — extended
with the fused error-feedback pipeline (port of the JAX package's
``benchmarks/fig4_selection_speed.py``).  On the card this is the
paper's headline systems claim: Gaussian_k's threshold selection against
exact top-k on a GPU, and the path on which the TPU kernels'
counterparts (K1-K4d) run at the Fig. 4 shapes.

Three groups of rows, each ``(name, us_per_call, derived)``:

* **selection**: the registry's ``topk`` (a stable full sort, kept for
  ``lax.top_k``'s tie order — it times what training runs, not
  ``torch.topk``), ``gaussiank``, ``dgck`` and ``trimmedk``, plus
  ``histk_select_kernel`` (K4d, then K4c);
* **EF pipeline**: fused and unfused Gaussian-k and hist-k, each with
  its ``count_passes`` total, plus the plain-torch
  ``compress_with_ef(..., backend="reference")`` (the row keeps the
  reference's name, ``gaussiank-jnp``, so the two packages' rows line
  up);
* **dispatch**: collectives a step of the per-leaf aggregation against
  the bucketed one (eight leaves, W = 4 workers of a ``LocalWire`` in
  this process, allgather and gtopk), counted from the wire's own calls
  (``common.CountingWire``; the reference counts a jaxpr).  The
  reference's mesh has a model axis of 2, which the port does not run
  yet (slice 2c): the port counts at model size 1, which the count does
  not depend on, and says so in the row.

On the card the full mode adds d = 268,435,456 (llama3.2-1b's largest
leaf) to both shape lists, and each of those rows gets its bytes bound
(``bound_ms``: each input read once, each output written once, at the
H100's 3.35 TB/s).

``run()`` only reports; ``python -m
repro_torch.benchmarks.fig4_selection_speed --json PATH`` writes the
document (schema ``fig4/v1``: rows of ``{shape, method, passes, ms}``),
and only to ``PATH``.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import prng
from repro_torch.benchmarks.common import (CountingWire, bytes_bound_ms,
                                           stamp_meta, timeit)
from repro_torch.core import compress_with_ef, get_compressor
from repro_torch.core.compression import CompressionConfig
from repro_torch.devices import resolve_device
from repro_torch.dist import aggregate
from repro_torch.dist.layout import build_layout
from repro_torch.dist.wire import LocalWire
from repro_torch.launch.mesh import parse_mesh
from repro_torch.kernels.ef_fused import (count_passes, fused_compress_ef,
                                          unfused_compress_ef)
from repro_torch.kernels.histk import histk_select_kernel

# the JAX benchmark's artifact, named in the report row so the two packages'
# rows line up; this module never writes it
REFERENCE_ARTIFACT = "BENCH_fig4.json"
SCHEMA = "fig4/v1"
BIG_LEAF = 268_435_456   # llama3.2-1b stack/0/ffn/w_gate (16x2048x8192)

# (selection-speed ds, EF-pipeline ds) per mode, the reference's; the
# smoke run uses the paper's delta x10 (k = d/100)
_SELECT_DS = {False: (1_000_000, 4_000_000, 8_000_000),
              True: (250_000,)}
_EF_DS = {False: (2 ** 20, 2 ** 22), True: (2 ** 16, 2 ** 18)}
_EF_KDIV = {False: 1000, True: 100}


def _shapes(table, smoke, device):
    ds = table[smoke]
    return ds + (BIG_LEAF,) if device.type == "cuda" and not smoke else ds


def _selection_rows(smoke: bool, device):
    rows = []
    for d in _shapes(_SELECT_DS, smoke, device):
        u = prng.normal(prng.PRNGKey(0), (d,), device=device) * 0.01
        k = max(1, d // 1000)
        key = prng.PRNGKey(1)
        # u read once; the pair written once
        bound = (f";bound_ms={bytes_bound_ms(4 * d + 8 * k):.3f}"
                 if d == BIG_LEAF else "")
        times = {}
        for name in ("topk", "gaussiank", "dgck", "trimmedk"):
            spec = get_compressor(name)
            times[name] = timeit(lambda s=spec: s.select(u, k, key),
                                 warmup=1, iters=2)
            rows.append((f"fig4/{name}/d={d}", round(times[name], 1),
                         f"k={k}{bound}"))
        # beyond-paper histogram selector: K4d, then K4c, at block 2048
        times["histk"] = timeit(lambda: histk_select_kernel(u, k),
                                warmup=1, iters=2)
        rows.append((f"fig4/histk/d={d}", round(times["histk"], 1),
                     f"k={k};beyond-paper{bound}"))
        rows.append((f"fig4/speedup/d={d}", 0.0,
                     f"gaussiank_vs_topk="
                     f"{times['topk'] / times['gaussiank']:.2f}x"))
        del u
    return rows


def _ef_pipeline_rows(smoke: bool, device):
    """Fused vs unfused EF compression: measured passes + wall time."""
    rows, bench = [], []
    iters = 2 if smoke else 3
    for d in _shapes(_EF_DS, smoke, device):
        k = max(1, d // _EF_KDIV[smoke])
        g = prng.normal(prng.PRNGKey(2), (d,), device=device) * 0.02
        e = prng.normal(prng.PRNGKey(3), (d,), device=device) * 0.01
        # g and e read once, e' written once, the (4k/3)-slot pair
        nbytes = 12 * d + 8 * -(-4 * k // 3)
        bound = (f";bound_ms={bytes_bound_ms(nbytes):.3f}"
                 if d == BIG_LEAF else "")
        for comp in ("gaussiank", "histk"):
            for method, fn in (("fused", fused_compress_ef),
                               ("unfused", unfused_compress_ef)):
                with count_passes() as log:
                    fn(g, e, comp, k)
                ms = timeit(lambda f=fn, c=comp: f(g, e, c, k), warmup=1,
                            iters=iters) / 1e3
                bench.append({"shape": d, "method": f"{comp}-{method}",
                              "passes": log.total(), "ms": round(ms, 3)})
                rows.append((f"fig4/ef-{comp}-{method}/d={d}",
                             round(ms * 1e3, 1),
                             f"k={k};passes={log.total()}{bound}"))
        # the plain-torch reference branch (no kernel pass accounting)
        spec = get_compressor("gaussiank")
        ms = timeit(lambda: compress_with_ef(g, spec, k, e=e,
                                             backend="reference"),
                    warmup=1, iters=iters) / 1e3
        bench.append({"shape": d, "method": "gaussiank-jnp",
                      "passes": None, "ms": round(ms, 3)})
        rows.append((f"fig4/ef-gaussiank-jnp/d={d}", round(ms * 1e3, 1),
                     f"k={k}{bound}"))
        del g, e
    return rows, bench


def _dispatch_rows(device):
    """Collectives a step of the per-leaf against the bucketed
    aggregation: L per wire level against 1."""
    L, W, ratio = 8, 4, 0.01
    params = {f"layer{i}": torch.zeros(64 + 8 * i, device=device)
              for i in range(L)}
    layout = build_layout(params, 1, CompressionConfig(compressor="topk",
                                                       ratio=ratio))
    rows, bench = [], []
    for strategy in ("allgather", "gtopk"):
        config = CompressionConfig(compressor="topk", ratio=ratio,
                                   strategy=strategy, backend="reference")
        for method in ("dispatch-perleaf", "dispatch-bucketed"):
            wire = CountingWire(LocalWire(parse_mesh(f"{W}x1")))
            if method == "dispatch-perleaf":
                aggregate.aggregate_compressed(
                    [params] * W, aggregate.init_residuals(params, 1,
                                                           workers=W),
                    config, wire=wire)
            else:
                aggregate.aggregate_bucketed(
                    [params] * W, torch.zeros((W, layout.flat_size),
                                              device=device),
                    layout, config, wire=wire)
            shape = f"L{L}-W{W}-{strategy}"
            bench.append({"shape": shape, "method": method,
                          "passes": wire.messages, "ms": 0.0})
            rows.append((f"fig4/{method}/{shape}", 0.0,
                         f"collectives={wire.messages};model_size=1 (the "
                         "reference's 2 waits for slice 2c)"))
    return rows, bench


def collect(smoke: bool = False, device="cuda"):
    device = resolve_device(device)
    rows = _selection_rows(smoke, device)
    ef_rows, bench = _ef_pipeline_rows(smoke, device)
    d_rows, d_bench = _dispatch_rows(device)
    return (rows + ef_rows + d_rows,
            stamp_meta({"schema": SCHEMA, "smoke": smoke,
                        "rows": bench + d_bench}))


def run(smoke: bool = False, device="cuda"):
    # harness entry point: report only
    rows, data = collect(smoke, device)
    rows.append((f"fig4/{REFERENCE_ARTIFACT}", 0.0,
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
