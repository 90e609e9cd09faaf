"""The reference's first train steps, from the seed: the loss and
gradients of the plain model, Gaussian-k with error feedback for every
leaf, the mean over the workers (``torch.distributed`` when there are
several, one process a worker), and SGD with momentum, in the dtypes the
configuration states (parameters, momentum and residual).

Returns the readings the comparison takes: each step's loss (the mean
over the workers), the norm of every leaf of the first step's mean as
the optimizer takes it (its momentum after one step), of every leaf of
the first step's new residual (this worker's), of every leaf of the
first step's dense gradient (which leaves the gradient reaches), and of
every leaf's change after the steps.

``precision="fp8"`` computes every product with float8 operands: the
control, the reference in the program's place a precision below the
configuration's."""
from __future__ import annotations

import torch
import torch.distributed as dist

from perfbench.bench.traffic import make_batch
from perfbench.bench.weights import make_leaf, make_weights
from perfbench.reference import gaussiank
from perfbench.reference.model import loss, param_shapes


def _sum_workers(x: torch.Tensor, world: int) -> torch.Tensor:
    if world > 1:
        dist.all_reduce(x)
    return x


def readings(config: dict, traffic: dict, seed: int, device, *,
             precision: str = "bf16", rank: int = 0, world: int = 1,
             steps: int = 3) -> dict:
    m, tr = config["model"], config["train"]
    shapes = param_shapes(m)
    pdt = getattr(torch, m["param_dtype"])
    rdt = getattr(torch, tr["resid_dtype"])
    w = make_weights(seed, shapes, pdt, device)
    mom = {n: torch.zeros_like(x) for n, x in w.items()}
    resid = {n: torch.zeros(x.numel(), dtype=rdt, device=device)
             for n, x in w.items()}
    per = int(traffic["batch_per_worker"])
    out = {"loss": []}
    for t in range(steps):
        b = make_batch(seed, traffic, m["vocab_size"], device, t)
        tok = b["tokens"][rank * per:(rank + 1) * per]
        lab = b["labels"][rank * per:(rank + 1) * per]
        leaves = {n: x.detach().requires_grad_(True) for n, x in w.items()}
        l, _, _ = loss(leaves, m, tok, lab, precision)
        grads = torch.autograd.grad(l, list(leaves.values()))
        del leaves
        lm = _sum_workers(l.detach().float().clone(), world) / world
        out["loss"].append(float(lm))
        if t == 0:
            out["dense"] = {n: float(g.float().norm())
                            for n, g in zip(w, grads)}
        with torch.no_grad():
            for (n, x), g in zip(w.items(), grads):
                d = x.numel()
                k, k_cap = gaussiank.budgets(d, tr["ratio"])
                vals, idx, resid[n] = gaussiank.compress(
                    g.reshape(-1), resid[n], k, k_cap)
                dense = torch.zeros(d, dtype=torch.float32, device=device)
                dense[idx] = vals.float()
                mean = (_sum_workers(dense, world) / world).to(
                    g.dtype).view_as(x)
                mom[n].mul_(tr["momentum"]).add_(mean)
                x.sub_((mom[n] * tr["lr"]).to(x.dtype))
                del dense, mean
        del grads
        if t == 0:
            out["grad"] = {n: float(v.float().norm()) for n, v in mom.items()}
            out["resid"] = {n: float(v.float().norm())
                            for n, v in resid.items()}
    out["update"] = {}
    with torch.no_grad():
        for i, (n, shape) in enumerate(shapes):
            p0 = make_leaf(seed, i, n, shape, pdt, device)
            out["update"][n] = float((w[n].float() - p0.float()).norm())
    return out
