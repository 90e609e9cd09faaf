"""Roofline terms of a step (port of ``repro/launch/roofline.py``:
``Roofline``, ``roofline_terms``, ``overlapped_collective_s``,
``overlap_report``, ``model_flops``, ``active_params`` and the legacy
aliases).

Pricing takes an explicit hardware and link model (``launch/topo.py``):
the compute and memory terms come from a ``HardwareSpec``, the wire term
from the alpha-beta model ``n_messages * alpha + bytes / beta`` of a
``LinkSpec``.  The defaults are the reference's (``DEFAULT_HW``,
``DEFAULT_LINK``), kept for parity with it; callers pricing the card
pass ``topo.H100_SXM``.  The step's FLOPs, bytes and collectives come
from ``launch/step_cost.py`` (the reference parses compiled HLO; torch
has none).  Per-card inputs give per-card terms.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

from repro_torch.launch.env import describe_env
from repro_torch.launch.topo import (DEFAULT_HW, DEFAULT_LINK, HardwareSpec,
                                     LinkSpec)

PEAK_FLOPS = DEFAULT_HW.peak_flops   # legacy aliases of the defaults
HBM_BW = DEFAULT_HW.hbm_bw
LINK_BW = DEFAULT_LINK.beta_Bps


@dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    n_messages: float = 0.0
    hardware: str = DEFAULT_HW.name
    # the launch environment the numbers were priced under
    # (launch.env.describe_env)
    env: Dict[str, str] = field(default_factory=dict)

    def to_dict(self):
        return asdict(self)


def roofline_terms(flops: float, bytes_accessed: float, coll_bytes: float,
                   model_flops_per_chip: float,
                   hw: Optional[HardwareSpec] = None,
                   link: Optional[LinkSpec] = None,
                   n_messages: float = 0.0) -> Roofline:
    """Price a step: compute and memory terms under ``hw`` and the wire
    term ``n_messages * link.alpha_s + coll_bytes / link.beta_Bps``;
    ``n_messages=0`` gives the bandwidth-only estimate."""
    hw = DEFAULT_HW if hw is None else hw
    link = DEFAULT_LINK if link is None else link
    c = flops / hw.peak_flops
    m = bytes_accessed / hw.hbm_bw
    n = link.time_s(n_messages, coll_bytes)
    dom = max(("compute", c), ("memory", m), ("collective", n),
              key=lambda t: t[1])[0]
    return Roofline(flops, bytes_accessed, coll_bytes, c, m, n, dom,
                    model_flops_per_chip,
                    model_flops_per_chip / flops if flops else 0.0,
                    n_messages, hw.name, describe_env())


def overlapped_collective_s(compute_s: float, collective_s: float,
                            n_chunks: int = 1,
                            chunk_alpha_s: float = 0.0) -> float:
    """Step seconds of the chunked overlapped schedule: serial (``N <=
    1``) compute + wire; with N chunks ``max + min/N`` plus ``(N - 1) *
    chunk_alpha_s``, the latency each extra chunk re-pays."""
    if n_chunks <= 1:
        return compute_s + collective_s
    lo, hi = sorted((float(compute_s), float(collective_s)))
    return hi + lo / n_chunks + (n_chunks - 1) * chunk_alpha_s


def overlap_report(r: Roofline, n_chunks: int,
                   link: Optional[LinkSpec] = None) -> Dict[str, float]:
    """Serial against overlapped step seconds of a priced step at
    ``n_chunks`` and the share the pipeline hides; compute is the larger
    of the FLOP and memory terms.  With a link, each extra chunk
    re-pays ``r.n_messages`` alphas."""
    compute_s = max(r.compute_s, r.memory_s)
    serial = compute_s + r.collective_s
    chunk_alpha = (r.n_messages * link.alpha_s) if link is not None else 0.0
    overlapped = overlapped_collective_s(compute_s, r.collective_s,
                                         n_chunks, chunk_alpha)
    return {"n_chunks": float(n_chunks), "serial_s": serial,
            "overlapped_s": overlapped,
            "hidden_frac": ((serial - overlapped) / serial
                            if serial > 0 else 0.0)}


def model_flops(cfg, n_params: int, n_active: int, kind: str,
                global_batch: int, seq_len: int) -> float:
    """6·N·D for training, 2·N·D forward only (all cards together)."""
    if kind == "train":
        return 6.0 * n_active * global_batch * seq_len
    if kind == "prefill":
        return 2.0 * n_active * global_batch * seq_len
    return 2.0 * n_active * global_batch  # decode: one token


def active_params(params_shapes, cfg) -> tuple:
    """``(total, active)`` param counts of a param tree (meta tensors
    do): a routed expert stack (``w_gate``/``w_up``/``w_down`` of 3+
    dims, not under ``shared``) counts at ``experts_per_token /
    num_experts``."""
    from repro_torch import tree

    total = 0
    active = 0.0
    for path, leaf in tree.flatten_with_path(params_shapes)[0]:
        n = int(leaf.numel())
        total += n
        name = path[-1] if path and isinstance(path[-1], str) else ""
        in_shared = "shared" in path
        if (name in ("w_gate", "w_up", "w_down") and leaf.dim() >= 3
                and not in_shared and cfg.num_experts):
            active += n * cfg.experts_per_token / cfg.num_experts
        else:
            active += n
    return total, int(active)
