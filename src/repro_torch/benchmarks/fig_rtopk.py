"""rTop-k density-vs-accuracy rows + the convergence-aware global-k
controller run (port of the JAX package's ``benchmarks/fig_rtopk.py``).

rTop-k (Barnes et al. 2020) ranks inside a strided r-sample instead of
the full vector, so unlike Gaussian_k its wire volume is EXACT: every
step communicates precisely the configured ``k`` per leaf, never the
threshold-dependent over/under-shoot of Fig. 10.  The density sweep
pins that exactness and checks the accuracy cost against exact top-k at
the same density stays small.

The global-k rows train the same adaptive (variance-policy) run twice —
once with ``global_policy="none"``, once with the ``"normdecay"``
controller — and pin the controller's defining invariant: its scale
never exceeds 1, so the scaled run can never communicate MORE than the
unscaled one on any step, while tail accuracy must not collapse.

``run()`` only reports; ``python -m repro_torch.benchmarks.fig_rtopk
--json PATH`` writes the document, and only to ``PATH``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.benchmarks.common import simulate_sparsified_sgd, stamp_meta

# the JAX benchmark's artifact, named in the report row so the two packages'
# rows line up; this module never writes it
REFERENCE_ARTIFACT = "BENCH_rtopk.json"
SCHEMA = "rtopk/v1"


def _density_rows(smoke, device):
    from repro_torch import prng, tree
    from repro_torch.core import get_compressor
    from repro_torch.models.fnn import init_fnn

    workers, steps = (2, 30) if smoke else (8, 120)
    densities = (0.005, 0.01) if smoke else (0.001, 0.005, 0.01)
    dims = [x.numel() for x in tree.leaves(init_fnn(prng.PRNGKey(0),
                                                    device=device))]
    spec_r = get_compressor("rtopk")    # hoisted: one spec, every sweep
    spec_t = get_compressor("topk")
    rows, bench = [], {}
    for ratio in densities:
        _, accs_r, comm_r, _ = simulate_sparsified_sgd(
            "rtopk", spec=spec_r, workers=workers, ratio=ratio, steps=steps,
            device=device)
        _, accs_t, _, _ = simulate_sparsified_sgd(
            "topk", spec=spec_t, workers=workers, ratio=ratio, steps=steps,
            device=device)
        k_conf = sum(min(d, max(1, int(np.ceil(ratio * d))))
                     for d in dims) * workers
        comm_exact = all(c == k_conf for c in comm_r)
        tail_r = float(np.mean(accs_r[-10:]))
        tail_t = float(np.mean(accs_t[-10:]))
        rows.append((f"rtopk/ratio={ratio}", 0.0,
                     f"tail_acc={tail_r:.4f};topk={tail_t:.4f};"
                     f"comm_exact={comm_exact}"))
        bench[str(ratio)] = {
            "tail_acc_rtopk": tail_r,
            "tail_acc_topk": tail_t,
            "comm_exact": bool(comm_exact),
            "k_conf": int(k_conf),
            "comm_mean": float(np.mean(comm_r)),
        }
    return rows, bench, (workers, steps)


def _globalk_rows(smoke, run_cfg, device):
    from repro_torch.core import adaptk, get_compressor

    workers, steps = run_cfg
    ratio = 0.005
    spec = get_compressor("rtopk")
    base_pol = adaptk.make_policy("variance")
    ctrl_pol = adaptk.make_policy("variance", global_policy="normdecay",
                                  global_ema=0.5, global_floor=0.25)
    _, accs_b, comm_b, _ = simulate_sparsified_sgd(
        "rtopk", spec=spec, workers=workers, ratio=ratio, steps=steps,
        density_policy=base_pol, device=device)
    _, accs_g, comm_g, _ = simulate_sparsified_sgd(
        "rtopk", spec=spec, workers=workers, ratio=ratio, steps=steps,
        density_policy=ctrl_pol, device=device)
    # scale <= 1 by construction: the controller may never send MORE
    # than the uncontrolled twin on any step (same floors/ceilings)
    never_above = all(g <= b for g, b in zip(comm_g, comm_b))
    tail_b = float(np.mean(accs_b[-10:]))
    tail_g = float(np.mean(accs_g[-10:]))
    rows = [("rtopk/globalk/normdecay", 0.0,
             f"tail_acc={tail_g:.4f};base={tail_b:.4f};"
             f"comm={np.mean(comm_g):.0f}/{np.mean(comm_b):.0f};"
             f"never_above_base={never_above}")]
    bench = {"tail_acc": tail_g, "tail_acc_base": tail_b,
             "comm_mean": float(np.mean(comm_g)),
             "comm_mean_base": float(np.mean(comm_b)),
             "never_above_base": bool(never_above),
             "ratio": ratio}
    return rows, bench


def collect(smoke: bool = False, device="cuda"):
    from repro_torch.devices import resolve_device

    device = resolve_device(device)
    rows, bench_d, run_cfg = _density_rows(smoke, device)
    grows, bench_g = _globalk_rows(smoke, run_cfg, device)
    data = stamp_meta({"schema": SCHEMA, "smoke": smoke,
                       "workers": run_cfg[0], "steps": run_cfg[1],
                       "densities": bench_d, "globalk": bench_g})
    return rows + grows, data


def run(smoke: bool = False, device="cuda"):
    # harness entry point: report only
    rows, data = collect(smoke, device)
    rows.append((f"rtopk/{REFERENCE_ARTIFACT}", 0.0,
                 f"densities={len(data['densities'])};smoke={smoke};"
                 "not-written"))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="reduced workers/steps")
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
        print(f"wrote {args.json} ({len(data['densities'])} densities)")


if __name__ == "__main__":
    main()
