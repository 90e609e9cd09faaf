"""The weights, made from the seed on the device: one generator a leaf,
one draw a leaf in the type the model trains in, so that both sides of
the comparison (and any single leaf, again) are made alike."""
from __future__ import annotations

import math

import torch

from perfbench.bench.traffic import seeded

WEIGHT_SALT = 1 << 20


def leaf_scale(name: str, shape) -> float:
    """``1/sqrt(fan_in)``, the fan-in the matrix's input width (its
    second-to-last dim, a stacked leaf's leading dims aside); the
    embedding's rows unit normal; 0 marks a norm's scale (ones)."""
    if name.endswith("scale"):
        return 0.0
    if name == "embed":
        return 1.0
    return 1.0 / math.sqrt(shape[-2])


def make_leaf(seed: int, index: int, name: str, shape, dtype, device):
    scale = leaf_scale(name, shape)
    if scale == 0.0:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = seeded(seed, WEIGHT_SALT + index, device)
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return x.mul_(scale)


def make_weights(seed: int, shapes: list, dtype, device) -> dict:
    """``{name: tensor}`` for ``shapes``, a list of ``(name, shape)`` in
    the program's leaf order."""
    return {name: make_leaf(seed, i, name, shape, dtype, device)
            for i, (name, shape) in enumerate(shapes)}
