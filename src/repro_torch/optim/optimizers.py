"""Optimizers (port of ``repro.optim.optimizers``): SGD with momentum
0.9 is the paper's setting (Table 1); AdamW for the transformer configs.

Same functional interface as the reference — ``init(params) -> state``,
``update(params, state, grads, lr) -> (new_params, new_state)`` — but
the update runs IN PLACE on the param and state tensors (and returns
them): on llama3.2-1b a functional copy would cost two more 6 GB
buffers.  The arithmetic follows the reference's operation order
(``momentum·m + g``, then ``p - lr·step``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import tree


class Optimizer(NamedTuple):
    name: str
    init: Callable
    update: Callable


def sgd_momentum(momentum: float = 0.9, weight_decay: float = 0.0,
                 nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"m": tree.tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update(params, state, grads, lr):
        lr = float(lr)
        for p, m, g in zip(tree.leaves(params), tree.leaves(state["m"]),
                           tree.leaves(grads)):
            if weight_decay:
                g = g + weight_decay * p
            m.mul_(momentum).add_(g)
            step = momentum * m + g if nesterov else m
            p.sub_(step.to(p.dtype) * lr)
        return params, state

    return Optimizer("sgd_momentum", init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": tree.tree_map(torch.zeros_like, params),
                "v": tree.tree_map(torch.zeros_like, params),
                "t": 0}

    @torch.no_grad()
    def update(params, state, grads, lr):
        t = state["t"] + 1
        lr = float(lr)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        for p, m, v, g in zip(tree.leaves(params), tree.leaves(state["m"]),
                              tree.leaves(state["v"]), tree.leaves(grads)):
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p
            p.sub_((lr * upd).to(p.dtype))
        state["t"] = t
        return params, state

    return Optimizer("adamw", init, update)
