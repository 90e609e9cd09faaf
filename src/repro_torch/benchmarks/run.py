"""Benchmark harness of the port — one module per paper table/figure
(port of the JAX package's ``benchmarks/run.py`` over the modules this
slice ports).  Prints ``name,us_per_call,derived`` CSV rows.

    python -m repro_torch.benchmarks.run [module] [--smoke] [--device cpu]

``module`` is any substring of a module name (all of them when
omitted); ``--smoke`` runs each on reduced shapes/steps.  The modules
run in this process, one after the other, on the card unless
``--device cpu``.  Nothing is written to disk.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time

MODULES = ["fig5_bound", "fig2_histograms", "fig1_fig6_convergence",
           "fig4_selection_speed", "fig10_sensitivity", "fig_rtopk",
           "overlap_schedule", "serve_staleness", "tuner_decision",
           "table2_scaling"]


def run_module(name: str, smoke: bool = False, device="cuda") -> int:
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    t0 = time.time()
    try:
        rows = mod.run(smoke=smoke, device=device)
    except Exception as e:  # noqa: BLE001 — one module's failure is reported
        print(f"{name},0,ERROR:{type(e).__name__}:{e}", flush=True)
        return 1
    for r in rows:
        print(",".join(str(x) for x in r), flush=True)
    print(f"{name}/_wall_s,{(time.time() - t0) * 1e6:.0f},"
          f"wall={time.time() - t0:.1f}s", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("module", nargs="?", default="",
                    help="run the modules whose name contains this")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.devices import resolve_device
    device = resolve_device(args.device)
    names = [m for m in MODULES if args.module in m]
    if not names:
        ap.error(f"no module matches {args.module!r}; have {MODULES}")
    print("name,us_per_call,derived", flush=True)
    failures = sum(run_module(n, args.smoke, device) for n in names)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
