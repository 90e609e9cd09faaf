"""Paper Fig. 1 + Fig. 6: convergence of Dense-SGD vs TopK-SGD vs
RandK-SGD vs GaussianK-SGD with 16 workers and k = 0.001d-scale
sparsity, on the paper's FNN-3 (synthetic MNIST-like data; port of the
JAX package's ``benchmarks/fig1_fig6_convergence.py``).

Claims checked (reported, not enforced):
  (1) TopK ≈ Dense  (within a small accuracy gap, paper reports 0.6-0.8%)
  (2) GaussianK ≈ TopK  (the approximate selector preserves convergence)
  (3) RandK ≪ TopK  (the (1-k/d) bound cannot explain Top-k — Fig. 1)
"""
from __future__ import annotations

from repro_torch.benchmarks.common import simulate_sparsified_sgd

STEPS = 120
RATIO = 0.005  # 0.001 needs many more steps on the small FNN; same regime


def run(smoke: bool = False, device="cuda"):
    rows = []
    finals = {}
    workers, steps = (4, 30) if smoke else (16, STEPS)
    for comp in ("none", "topk", "gaussiank", "randk"):
        losses, accs, comm, _ = simulate_sparsified_sgd(
            comp, workers=workers, ratio=RATIO, steps=steps, device=device)
        tail_acc = sum(accs[-10:]) / 10
        finals[comp] = tail_acc
        rows.append((f"fig1_6/{comp}", 0.0,
                     f"final_loss={losses[-1]:.4f};tail_acc={tail_acc:.4f}"))
    ok1 = finals["topk"] >= finals["none"] - 0.05
    ok2 = abs(finals["gaussiank"] - finals["topk"]) <= 0.05
    ok3 = finals["randk"] <= finals["topk"] + 0.01
    rows.append(("fig1_6/claims", 0.0,
                 f"topk~dense={ok1};gaussiank~topk={ok2};randk<=topk={ok3}"))
    return rows
