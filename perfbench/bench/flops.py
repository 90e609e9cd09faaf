"""The yardstick's arithmetic: a step's model FLOPs, the compression's
least bytes, and the card's peaks (NVIDIA's data sheet, H100 SXM, dense
rates).  Sizes come from the configuration file alone."""
from __future__ import annotations

import math

from perfbench.reference.model import param_shapes

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
ROUTED = ("ffn/w_gate", "ffn/w_up", "ffn/w_down")


def active_params(model: dict) -> float:
    """Parameters a token runs through, the input embedding aside:
    routed experts at ``experts_per_token / num_experts``."""
    n = 0.0
    frac = (model["experts_per_token"] / model["num_experts"]
            if model.get("num_experts") else 1.0)
    for name, shape in param_shapes(model):
        if name == "embed":
            continue
        size = math.prod(shape)
        routed = "moe" in model["ffn_pattern"] and name.endswith(ROUTED)
        n += size * (frac if routed else 1.0)
    return n


def model_flops(model: dict, tokens: int, seq_len: int) -> float:
    """Training FLOPs of ``tokens`` tokens in sequences of ``seq_len``:
    ``6·N`` a token plus attention's ``12·L·T·d_attn`` (forward and
    backward; no recompute, no causal discount)."""
    hd = model.get("head_dim") or model["d_model"] // model["num_heads"]
    attn = 12.0 * model["num_layers"] * seq_len * model["num_heads"] * hd
    return (6.0 * active_params(model) + attn) * tokens


def leaf_budgets(model: dict, ratio: float) -> list:
    """``(name, d, k, k_cap)`` of every gradient leaf under fixed-k
    Gaussian-k: ``k = ceil(ratio·d)``, ``k_cap = min(d, ceil(4k/3))``."""
    out = []
    for name, shape in param_shapes(model):
        d = math.prod(shape)
        k = max(1, math.ceil(ratio * d))
        out.append((name, d, k, min(d, math.ceil(4.0 * k / 3.0))))
    return out


def ef_least_bytes(model: dict, ratio: float, elem_bytes: int = 2,
                   value_bytes: int = 2, index_bytes: int = 4) -> float:
    """The least bytes one worker's compression moves: ``g`` and ``e``
    read once, ``e'`` written once, the ``k_cap`` pairs written."""
    total = 0.0
    for _, d, _, k_cap in leaf_budgets(model, ratio):
        total += 3 * elem_bytes * d + k_cap * (value_bytes + index_bytes)
    return total
