"""FNN-3 — the paper's own feed-forward model (Table 1): three hidden
fully-connected ReLU layers on MNIST-scale inputs (port of
``repro/models/fnn.py``).  Used by the paper-fidelity benchmarks
(``repro_torch.benchmarks``).

The params are the reference's tree, a list of ``{"w", "b"}`` dicts with
``w`` shaped ``(in, out)``, so ``tree.flatten`` orders the leaves as
``jax.tree.flatten`` does (``b0, w0, b1, w1, ...``) and every per-leaf
key and budget of the simulation agrees with the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.devices import resolve_device


def init_fnn(key, input_dim=784, hidden=(128, 96, 64), num_classes=10,
             dtype=torch.float32, device="cuda"):
    """Xavier-uniform weights and zero biases on ``device`` (the card
    unless told ``"cpu"``), drawn from ``repro_torch.prng`` with the
    reference's keys: bit for bit ``repro.models.fnn.init_fnn``."""
    device = resolve_device(device)
    dims = (input_dim,) + tuple(hidden) + (num_classes,)
    keys = prng.split(key, len(dims) - 1)
    params = []
    for k, din, dout in zip(keys, dims[:-1], dims[1:]):
        # jnp.sqrt(6.0 / (din + dout)): the f32 root of the f32 quotient
        lim = np.sqrt(np.float32(6.0 / (din + dout)))
        w = prng.uniform(k, (din, dout), -lim, lim, device=device)
        params.append({"w": w.to(dtype),
                       "b": torch.zeros((dout,), dtype=dtype,
                                        device=device)})
    return params


def fnn_forward(params, x: torch.Tensor) -> torch.Tensor:
    h = x
    for i, p in enumerate(params):
        h = h @ p["w"] + p["b"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def fnn_loss(params, batch) -> tuple:
    """Mean cross-entropy of ``batch = {"x", "y"}``: ``(loss, {"loss",
    "acc"})``."""
    logits = fnn_forward(params, batch["x"]).to(torch.float32)
    logp = torch.log_softmax(logits, -1)
    ll = torch.gather(logp, -1, batch["y"].long()[:, None])[:, 0]
    loss = -torch.mean(ll)
    acc = torch.mean((torch.argmax(logits, -1) == batch["y"]).to(
        torch.float32))
    return loss, {"loss": loss, "acc": acc}


def from_jax_fnn(np_params, device="cuda"):
    """The reference's FNN params as numpy arrays (``jax.tree.map(
    np.asarray, params)``) -> the port's, on ``device``."""
    from repro_torch.models.model import from_jax_params
    return from_jax_params(np_params, device)
