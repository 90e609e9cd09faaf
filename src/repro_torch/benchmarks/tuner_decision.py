"""Wire-strategy tuner decisions (port of the JAX package's
``benchmarks/tuner_decision.py``).  Rows of schema ``tuner/v1``:

* ``decide`` — the strategy ``dist.tuner.choose_strategy`` picks in each
  (synthetic topology, mesh) cell, with the winner's predicted wire time
  (``ms``) and message count (``passes``);
* ``predict-{strategy}`` — every candidate's predicted time and messages.

All of it is closed-form alpha-beta pricing at the reference's layout
geometry (three leaves, model axis 2, top-k at 0.01, built on the meta
device): no device, no clock.  The rows equal the reference's, pinned in
``benchmarks/baselines/tuner.json`` (read, never written here).  The
four topologies are the reference's: a fat flat link, a slow flat link,
a high-latency flat link and the asymmetric two-level fabric.

``run()`` only reports; ``python -m repro_torch.benchmarks.tuner_decision
--json PATH`` writes the document, and only to ``PATH``.
"""
from __future__ import annotations

import argparse
import json

SCHEMA = "tuner/v1"
REFERENCE_ARTIFACT = "BENCH_tuner.json"


def cases():
    """The reference's four topologies and four meshes."""
    from repro_torch.launch.topo import HardwareSpec, LinkSpec, Topology

    hw = HardwareSpec(name="bench-hw", peak_flops=197e12, hbm_bw=819e9)
    topos = [
        Topology(hardware=hw, default_link=LinkSpec(1e-7, 4e11),
                 name="fat-flat"),
        Topology(hardware=hw, default_link=LinkSpec(1e-6, 1e8),
                 name="slow-flat"),
        Topology(hardware=hw, default_link=LinkSpec(5e-3, 5e10),
                 name="high-alpha"),
        Topology(hardware=hw,
                 links=(("data", LinkSpec(1e-6, 5e10)),
                        ("pod", LinkSpec(1e-3, 1e8))),
                 default_link=LinkSpec(1e-6, 5e10), name="asym"),
    ]
    meshes = [
        [("data", 4)], [("data", 8)],
        [("pod", 2), ("data", 2)], [("pod", 2), ("data", 4)],
    ]
    return topos, meshes


def bench_layout():
    """The reference's medium geometry: multi-KB pairs, so the grid
    reaches both the alpha and the beta regime."""
    import torch

    from repro_torch.core.compressors import get_compressor
    from repro_torch.dist.layout import build_layout

    params = {k: torch.empty(s, device="meta") for k, s in
              (("a", (256, 128)), ("b", (1024,)), ("c", (64, 64)))}
    return build_layout(params, 2, 0.01, get_compressor("topk"))


def collect(smoke: bool = False, device=None):
    """``(rows, document)``; ``device`` is accepted for the harness and
    unused (nothing runs on a device)."""
    from repro_torch.benchmarks.common import stamp_meta
    from repro_torch.dist import tuner

    layout = bench_layout()
    topos, meshes = cases()
    rows, bench = [], []
    for topo in topos:
        for axes in meshes:
            shape = f"{topo.name}/{'x'.join(f'{a}{n}' for a, n in axes)}"
            decision = tuner.choose_strategy(layout, axes, topo)
            best = decision.best
            bench.append({"shape": shape, "method": "decide",
                          "choice": decision.strategy,
                          "passes": best.messages,
                          "ms": best.total_s * 1e3})
            rows.append((f"tuner/decide/{shape}", best.total_s * 1e6,
                         f"choice={decision.strategy};"
                         f"messages={best.messages}"))
            for p in decision.predictions:
                bench.append({"shape": shape,
                              "method": f"predict-{p.strategy}",
                              "passes": p.messages,
                              "ms": p.total_s * 1e3})
                rows.append((f"tuner/predict-{p.strategy}/{shape}",
                             p.total_s * 1e6, f"messages={p.messages}"))
    return rows, stamp_meta({"schema": SCHEMA, "smoke": smoke,
                             "rows": bench})


def baseline_mismatches(rows: list, baseline: list) -> list:
    """Rows that differ from the baseline's: the choice and ``passes``
    exactly, ``ms`` within 1e-12 relative; ``[]`` when all agree."""
    if len(rows) != len(baseline):
        return [("row count", len(rows), len(baseline))]
    bad = []
    for got, want in zip(rows, baseline):
        same = (got["shape"], got["method"], got.get("choice"),
                got["passes"]) == (want["shape"], want["method"],
                                   want.get("choice"), want["passes"])
        if not same or abs(got["ms"] - want["ms"]) > 1e-12 * abs(
                want["ms"]):
            bad.append((got, want))
    return bad


def run(smoke: bool = False, device=None):
    # harness entry point: report only
    rows, data = collect(smoke, device)
    rows.append((f"tuner/{REFERENCE_ARTIFACT}", 0.0,
                 f"rows={len(data['rows'])};smoke={smoke};not-written"))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="accepted for uniformity (the pricing is "
                         "closed-form either way)")
    ap.add_argument("--json", default=None,
                    help="write the result document to this path "
                         "(default: write nothing)")
    args = ap.parse_args(argv)
    rows, data = collect(args.smoke)
    for r in rows:
        print(",".join(str(x) for x in r), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(data, f, indent=1)
        print(f"wrote {args.json} ({len(data['rows'])} rows)")


if __name__ == "__main__":
    main()
