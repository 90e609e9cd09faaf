"""Paper Fig. 10 + Fig. 11: Gaussian_k under-/over-sparsification and
sensitivity to k — plus the adaptive layer-wise density rows (port of
the JAX package's ``benchmarks/fig10_sensitivity.py``).

Fig. 10 claim: early in training Gaussian_k under-sparsifies (selects and
communicates MORE than k), later it over-sparsifies (fewer than k), with
little accuracy loss.  Fig. 11 claim: GaussianK-SGD converges across
k = 0.001d / 0.005d / 0.01d.

Adaptive rows: the fixed-k trajectory's per-step pass-A moments are
recorded ONCE and every adaptk policy replays its allocation on those
shared stats (no retraining per policy), plus one true adaptive training
run for the accuracy/wire comparison.  The compressor spec is built once
and threaded through every sweep point.

``run()`` only reports; ``python -m repro_torch.benchmarks.fig10_sensitivity
--json PATH`` writes the document, and only to ``PATH``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.benchmarks.common import simulate_sparsified_sgd, stamp_meta

# the JAX benchmark's artifact, named in the report row so the two packages'
# rows line up; this module never writes it
REFERENCE_ARTIFACT = "BENCH_adaptk.json"
SCHEMA = ["policy", "k_total_final", "budget_exact", "share_spread",
          "tail_acc", "comm_mean"]


def _fig10_fig11_rows(spec, smoke, stats_out, device):
    from repro_torch import prng, tree
    from repro_torch.models.fnn import init_fnn

    rows = []
    workers, steps = (2, 30) if smoke else (8, 120)
    # Fig. 10: communicated elements vs configured k over training.  The
    # per-step pass-A moments of this run feed the adaptive replay below.
    ratio = 0.005
    _, accs0, comm, _ = simulate_sparsified_sgd(
        "gaussiank", spec=spec, workers=workers, ratio=ratio, steps=steps,
        stats_out=stats_out, device=device)
    dims = [x.numel() for x in tree.leaves(init_fnn(prng.PRNGKey(0),
                                                    device=device))]
    k_conf = sum(max(1, int(np.ceil(ratio * s))) for s in dims) * workers
    early = np.mean(comm[:10]) / k_conf
    late = np.mean(comm[-10:]) / k_conf
    rows.append(("fig10/comm_ratio_early", 0.0,
                 f"selected/k={early:.2f}"))
    rows.append(("fig10/comm_ratio_late", 0.0,
                 f"selected/k={late:.2f}"))
    # Fig. 11: k sensitivity (same hoisted spec for every sweep point)
    finals = {}
    for r in (0.005, 0.01) if smoke else (0.001, 0.005, 0.01):
        losses, accs, _, _ = simulate_sparsified_sgd(
            "gaussiank", spec=spec, workers=workers, ratio=r, steps=steps,
            device=device)
        finals[r] = sum(accs[-10:]) / 10
        rows.append((f"fig11/gaussiank/ratio={r}", 0.0,
                     f"tail_acc={finals[r]:.4f}"))
    spread = max(finals.values()) - min(finals.values())
    rows.append(("fig11/k_insensitive", 0.0,
                 f"acc_spread={spread:.4f};ok={spread < 0.15}"))
    fixed = {"ratio": ratio, "workers": workers, "steps": steps,
             "dims": dims, "tail_acc": float(np.mean(accs0[-10:])),
             "comm_mean": float(np.mean(comm))}
    return rows, fixed, (workers, steps, ratio, dims)


def _adaptive_rows(spec, smoke, stats_trace, run_cfg, device):
    """Adaptive-vs-fixed rows: replay every policy's allocation on the
    recorded stats trace (shared — computed once), then one true
    adaptive training run."""
    from repro_torch.core import adaptk

    workers, steps, ratio, dims = run_cfg
    rows, bench_pol = [], {}
    for pol_name in adaptk.POLICIES:
        policy = adaptk.make_policy(pol_name, warmup_steps=steps // 4,
                                    warmup_mult=4.0)
        lo_hi = [adaptk.leaf_bounds(d, ratio, policy) for d in dims]
        lo = [b[0] for b in lo_hi]
        hi = [b[1] for b in lo_hi]
        k_hist, exact = [], True
        for t, stats in enumerate(stats_trace):
            sig = np.asarray([
                [float(adaptk.leaf_signal(pol_name, dims[li],
                                          *stats[w, li]))
                 for li in range(len(dims))]
                for w in range(stats.shape[0])]).mean(axis=0)
            K = adaptk.budget(dims, ratio, policy, t)
            k, K_eff = adaptk.allocate(K, np.asarray(sig, np.float32),
                                       lo, hi)
            k = np.asarray(k)
            exact &= int(k.sum()) == int(K_eff)
            k_hist.append(k)
        k_hist = np.asarray(k_hist)
        share = k_hist[-1] / max(1, k_hist[-1].sum())
        uni = np.asarray(dims) / sum(dims)
        spread = float(np.abs(share - uni).sum())
        rows.append((f"fig10/adaptk/{pol_name}", 0.0,
                     f"budget_exact={exact};k_final={int(k_hist[-1].sum())};"
                     f"share_vs_uniform_L1={spread:.3f}"))
        bench_pol[pol_name] = {
            "budget_exact": bool(exact),
            "k_total_final": int(k_hist[-1].sum()),
            "k_total_warmup_peak": int(k_hist[0].sum()),
            "final_share": [float(x) for x in share],
            "share_vs_uniform_L1": spread,
        }
    # one true adaptive run (variance policy) — accuracy + measured wire
    policy = adaptk.make_policy("variance", warmup_steps=steps // 4,
                                warmup_mult=4.0)
    _, accs_a, comm_a, _ = simulate_sparsified_sgd(
        "gaussiank", spec=spec, workers=workers, ratio=ratio, steps=steps,
        density_policy=policy, device=device)
    adaptive_run = {"tail_acc": float(np.mean(accs_a[-10:])),
                    "comm_mean": float(np.mean(comm_a))}
    rows.append(("fig10/adaptk/train_variance", 0.0,
                 f"tail_acc={adaptive_run['tail_acc']:.4f};"
                 f"comm_mean={adaptive_run['comm_mean']:.0f}"))
    return rows, bench_pol, adaptive_run


def collect(smoke: bool = False, device="cuda"):
    from repro_torch.core import get_compressor
    from repro_torch.devices import resolve_device

    device = resolve_device(device)
    spec = get_compressor("gaussiank")   # hoisted: one spec, every sweep
    stats_trace = []
    rows, fixed, run_cfg = _fig10_fig11_rows(spec, smoke, stats_trace,
                                             device)
    arows, bench_pol, adaptive_run = _adaptive_rows(
        spec, smoke, stats_trace, run_cfg, device)
    data = stamp_meta({"schema": SCHEMA, "smoke": smoke, "fixed": fixed,
                       "policies": bench_pol,
                       "adaptive_run": adaptive_run})
    return rows + arows, data


def run(smoke: bool = False, device="cuda"):
    # harness entry point: report only
    rows, data = collect(smoke, device)
    rows.append((f"fig10/{REFERENCE_ARTIFACT}", 0.0,
                 f"policies={len(data['policies'])};smoke={smoke};"
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
        print(f"wrote {args.json} ({len(data['policies'])} policies)")


if __name__ == "__main__":
    main()
