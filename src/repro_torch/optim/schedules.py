"""Learning-rate schedules, ``step -> lr`` as Python floats, and the DGC
density warmup, ``step -> multiplier`` in f32 (port of
``repro.optim.schedules``)."""
from __future__ import annotations

import math

import numpy as np

from repro_torch import f32


def constant(lr: float):
    return lambda step: float(lr)


def step_decay(lr: float, decay: float = 0.1, every: int = 1000):
    """The paper's CIFAR schedule shape: decay at fixed boundaries."""
    return lambda step: float(lr) * decay ** (int(step) // every)


def cosine(lr: float, total_steps: int, min_frac: float = 0.1):
    def f(step):
        t = min(max(step / total_steps, 0.0), 1.0)
        return float(lr) * (min_frac + (1 - min_frac) *
                            0.5 * (1 + math.cos(math.pi * t)))
    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  min_frac: float = 0.1):
    base = cosine(lr, max(total_steps - warmup, 1), min_frac)

    def f(step):
        if step < warmup:
            return float(lr) * min(max(step / max(warmup, 1), 0.0), 1.0)
        return base(step - warmup)
    return f


def density_warmup(start_mult: float, warmup: int):
    """DGC-style exponential density warmup multiplier (decays
    geometrically from ``start_mult`` to 1 over ``warmup`` steps), an
    ``np.float32``.  All f32, in the reference's order and with its
    ``log``/``exp`` (``repro_torch.f32``): ``log_m = log(max(m, 1))``,
    ``t = clip(step / max(w, 1), 0, 1)``, ``exp(log_m·(1 − t))``."""
    log_m = f32.log(max(start_mult, 1.0))
    w = np.float32(max(warmup, 1))

    def f(step):
        t = np.clip(np.float32(step) / w, np.float32(0.0), np.float32(1.0))
        return f32.exp(log_m * (np.float32(1.0) - t))
    return f
