"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``repro/models/moe.py``, lines 24-95): top-k routing, the Switch-style
load-balance loss, a stable sort of the assignments by expert, a
per-expert capacity ``C`` with the overflow sent to a scratch slot
``E*C``, one batched product per expert matrix, shared experts.

The reference computes this with plain jnp (no Pallas), so the port
does with plain torch ops, and keeps the card's runs reproducible: the
tokens are gathered into the ``(E*C, D)`` buffer with ``F.embedding``
(whose backward is deterministic on the CPU and on the card, where an
indexing's ``index_put_`` with accumulate is not), and the combine
gathers each token's K slots and adds them, times their router
weights, in ascending expert order — the order in which the
reference's scatter-add of the slots (sorted by expert) adds them —
instead of scattering with atomics.

Under tensor parallelism (``axis``) every model rank routes, dispatches
and computes the combine's integers from the whole replicated router,
so they are the same on every rank; each rank runs its ``F/M`` hidden
units of every expert (and of the shared experts), and the combined and
shared outputs' partial sums are all-reduced once.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.dist.tensor_parallel import copy_to_model, reduce_from_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, init_mlp, mlp_partial


def init_moe(key, cfg: ModelConfig, dtype, device=None):
    D, Fh, E = cfg.d_model, cfg.expert_d_ff(), cfg.num_experts
    ks = prng.split(key, 5)
    # the reference's fan-in is shape[0]: E for the (E, D, F) stacks
    p = {
        "router": dense_init(ks[0], (D, E), dtype, fan_in=D, device=device),
        "w_gate": dense_init(ks[1], (E, D, Fh), dtype, fan_in=E,
                             device=device),
        "w_up": dense_init(ks[2], (E, D, Fh), dtype, fan_in=E,
                           device=device),
        "w_down": dense_init(ks[3], (E, Fh, D), dtype, fan_in=E,
                             device=device),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(ks[4], D, Fh * cfg.num_shared_experts, dtype,
                               device)
    return p


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``n_tokens`` tokens (those one worker sees),
    rounded up to a multiple of 8, at least 8."""
    c = math.ceil(n_tokens * cfg.experts_per_token /
                  max(cfg.num_experts, 1) * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(p, xt, cfg: ModelConfig):
    """``(gate (N, K) normalised, eidx (N, K) int64, aux)`` of the tokens
    ``xt`` (N, D)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    logits = (xt @ p["router"]).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, K, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # load-balance auxiliary loss (Switch-style): the top-1 choice's
    # share of the tokens against the mean router probability
    me = probs.mean(dim=0)
    ce = F.one_hot(eidx[:, 0], E).to(torch.float32).mean(dim=0)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)
    return gate, eidx, aux


def dispatch(eidx: torch.Tensor, C: int, E: int) -> dict:
    """The sort-based dispatch of the ``(N, K)`` assignments ``eidx``
    into ``E`` experts of ``C`` slots: ``order`` (the stable sort by
    expert: token-major in ties), ``slot`` (each sorted assignment's
    slot, ``E*C`` when past its expert's capacity), ``buf_tok`` (the
    token each of the ``E*C`` slots holds, ``N`` when empty) and
    ``slot_of`` ``(N, K)`` (each assignment's slot, in ``eidx``'s
    order)."""
    N, K = eidx.shape
    dev = eidx.device
    flat_e = eidx.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos_in_e = torch.arange(N * K, device=dev) - seg_start[sorted_e]
    slot = torch.where(pos_in_e < C, sorted_e * C + pos_in_e,
                       torch.full_like(pos_in_e, E * C))
    token_of = order // K
    # the scratch slot E*C takes every dropped assignment, then goes
    buf_tok = torch.full((E * C + 1,), N, dtype=torch.int64, device=dev)
    buf_tok[slot] = token_of
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot
    return {"order": order, "slot": slot, "buf_tok": buf_tok[:E * C],
            "slot_of": slot_of.view(N, K)}


def moe_ffn(p, x, cfg: ModelConfig, axis=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, D) -> (out, aux_loss); the capacity is that of the
    ``B·T`` tokens given.  With ``axis``, this model rank's hidden units
    of the experts (module docstring): the routing reads ``x`` as it is,
    the experts read it through ``copy_to_model``, and the router
    weights enter the rank's partial combine through it too, so that
    both gradients are the model group's sums."""
    B, T, D = x.shape
    E = cfg.num_experts
    N = B * T
    xt = x.reshape(N, D)
    gate, eidx, aux = route(p, xt, cfg)
    gate = copy_to_model(gate, axis)
    xt = copy_to_model(xt, axis)
    C = capacity(N, cfg)
    dsp = dispatch(eidx, C, E)

    # gather the tokens into the (E*C, D) buffer (row N is zeros)
    xpad = torch.cat([xt, xt.new_zeros((1, D))], 0)
    expert_in = F.embedding(dsp["buf_tok"], xpad).view(E, C, D)

    # batched expert MLP, one product per matrix
    h = F.silu(torch.einsum("ecd,edf->ecf", expert_in, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", expert_in, p["w_up"])
    eo = torch.einsum("ecf,efd->ecd", h, p["w_down"])

    # combine: each token's slots in ascending expert order (the order in
    # which the reference's scatter-add over the expert-sorted slots adds
    # them), each output times its router weight; a dropped assignment
    # reads the zero row E*C
    by_e = torch.argsort(eidx, dim=1)
    eo = torch.cat([eo.reshape(E * C, D), eo.new_zeros((1, D))], 0)
    parts = (F.embedding(torch.gather(dsp["slot_of"], 1, by_e), eo)
             * torch.gather(gate, 1, by_e)[..., None].to(eo.dtype))
    out = parts[:, 0]
    for k in range(1, parts.shape[1]):
        out = out + parts[:, k]

    if cfg.num_shared_experts:
        out = out + mlp_partial(p["shared"], xt)
    return reduce_from_model(out, axis).reshape(B, T, D).to(x.dtype), aux
