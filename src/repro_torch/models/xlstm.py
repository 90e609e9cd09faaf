"""xLSTM blocks (port of ``repro/models/xlstm.py``, lines 20-135): mLSTM
(matrix memory, covariance update) and sLSTM (scalar memory with a
hidden-to-gate recurrence), both with exponential gating and the
stabiliser state ``m``.

The reference runs each recurrence as a ``lax.scan`` over time; the
port runs the same steps in a Python loop over time, over ``unbind``'s
views of the inputs (whose backward stacks the steps' gradients once,
where indexing a step would fill a sequence-sized zero gradient a
step).  A ``*_forward`` with ``state=`` continues from that state:
one-token decode is a forward of length 1.  The states are f32 dicts
with the reference's keys; the ``*_forward``s return new tensors.

Under tensor parallelism (``axis``) a model rank holds ``H / M`` heads
of both blocks (``dist/tensor_parallel.py``'s placement): the columns of
the input projections and gates of its heads, its heads' recurrent
matrices (sLSTM) and its slice of the per-head biases; the recurrences
are per head, so they run on the rank's heads alone, and ``out_proj``
(row-parallel) all-reduces the block's output once.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import prng
from repro_torch.dist.tensor_parallel import (copy_to_model, local_columns,
                                              reduce_from_model)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def init_mlstm(key, cfg: ModelConfig, dtype, device=None):
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.hd
    ks = prng.split(key, 7)

    def w(i, shape):
        return dense_init(ks[i], shape, dtype, fan_in=shape[0],
                          device=device)

    return {
        "wq": w(0, (D, H * hd)),
        "wk": w(1, (D, H * hd)),
        "wv": w(2, (D, H * hd)),
        "wi": w(3, (D, H)),
        "wf": w(4, (D, H)),
        "wo_gate": w(5, (D, H * hd)),
        "out_proj": w(6, (H * hd, D)),
        "bi": torch.zeros((H,), dtype=dtype, device=device),
        "bf": torch.full((H,), 3.0, dtype=dtype, device=device),  # open
    }


def mlstm_init_state(B: int, cfg: ModelConfig, device=None, lead=(),
                     heads=None):
    """The zero mLSTM state of ``B`` sequences, ``lead`` dims first, of
    ``heads`` heads (all of them by default)."""
    H, hd = heads or cfg.num_heads, cfg.hd
    lead = tuple(lead)

    def z(*shape):
        return torch.zeros(lead + (B,) + shape, dtype=torch.float32,
                           device=device)

    return {"C": z(H, hd, hd), "n": z(H, hd), "m": z(H)}


def _mlstm_step(state, q, k, v, it, ft):
    """One time step: q, k, v (B, H, hd); it, ft (B, H)."""
    C, n, m = state["C"], state["n"], state["m"]
    m_new = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + m - m_new)
    C = f_p[..., None, None] * C + i_p[..., None, None] * (
        v[..., :, None] * k[..., None, :])              # (B, H, hdv, hdk)
    n = f_p[..., None] * n + i_p[..., None] * k
    num = torch.einsum("bhvk,bhk->bhv", C, q)
    den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), min=1.0)
    h = num / den[..., None]
    return {"C": C, "n": n, "m": m_new}, h


def mlstm_forward(p, x, cfg: ModelConfig, state=None, axis=None):
    """x: (B, T, D) -> (out, final state).  With ``axis``, this model
    rank's heads (module docstring)."""
    B, T, D = x.shape
    H, hd = p["wi"].shape[-1], cfg.hd
    if state is None:
        state = mlstm_init_state(B, cfg, x.device, heads=H)
    x = copy_to_model(x, axis)
    sc = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    q = (x @ p["wq"]).reshape(B, T, H, hd) * sc
    k = (x @ p["wk"]).reshape(B, T, H, hd) * sc
    v = (x @ p["wv"]).reshape(B, T, H, hd)
    it = (x @ p["wi"] + local_columns(p["bi"], axis)).to(torch.float32)
    ft = (x @ p["wf"] + local_columns(p["bf"], axis)).to(torch.float32)
    steps = zip(*(a.to(torch.float32).unbind(1) for a in (q, k, v, it, ft)))
    hs = []
    for q_t, k_t, v_t, i_t, f_t in steps:
        state, h = _mlstm_step(state, q_t, k_t, v_t, i_t, f_t)
        hs.append(h)
    h = torch.stack(hs, 1).to(x.dtype).reshape(B, T, H * hd)
    o = torch.sigmoid(x @ p["wo_gate"])
    return reduce_from_model((o * h) @ p["out_proj"], axis), state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

_GATES = ("i", "f", "z", "o")


def init_slstm(key, cfg: ModelConfig, dtype, device=None):
    D, H, hd = cfg.d_model, cfg.num_heads, cfg.hd
    ks = prng.split(key, 9)
    p = {"out_proj": dense_init(ks[8], (H * hd, D), dtype, fan_in=H * hd,
                                device=device)}
    for i, g in enumerate(_GATES):
        p[f"w{g}"] = dense_init(ks[i], (D, H * hd), dtype, fan_in=D,
                                device=device)
        p[f"r{g}"] = dense_init(ks[4 + i], (H, hd, hd), dtype, fan_in=H,
                                scale=1.0 / hd ** 0.5, device=device)
        p[f"b{g}"] = torch.full((H * hd,), 3.0 if g == "f" else 0.0,
                                dtype=dtype, device=device)
    return p


def slstm_init_state(B: int, cfg: ModelConfig, device=None, lead=(),
                     heads=None):
    """The sLSTM state of ``B`` sequences (``n`` ones, the rest zeros),
    ``lead`` dims first, of ``heads`` heads (all of them by default)."""
    H, hd = heads or cfg.num_heads, cfg.hd
    shape = tuple(lead) + (B, H, hd)

    def z():
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"h": z(), "c": z(), "n": z() + 1.0, "m": z()}


def slstm_forward(p, x, cfg: ModelConfig, state=None, axis=None):
    """x: (B, T, D) -> (out, final state).  With ``axis``, this model
    rank's heads (module docstring)."""
    B, T, D = x.shape
    H, hd = p["ri"].shape[-3], cfg.hd
    if state is None:
        state = slstm_init_state(B, cfg, x.device, heads=H)
    x = copy_to_model(x, axis)
    pre = [(x @ p[f"w{g}"] + local_columns(p[f"b{g}"], axis))
           .reshape(B, T, H, hd).to(torch.float32).unbind(1)
           for g in _GATES]
    s = state
    hs = []
    for pi, pf, pz, po in zip(*pre):
        # the f32 state times the recurrent weights promoted to it, as
        # the reference's einsum promotes a bf16 operand
        rec = {g: torch.einsum("bhk,hkj->bhj", s["h"],
                               p[f"r{g}"].to(s["h"].dtype))
               .to(torch.float32) for g in _GATES}
        it = pi + rec["i"]
        ft = pf + rec["f"]
        zt = torch.tanh(pz + rec["z"])
        ot = torch.sigmoid(po + rec["o"])
        m_new = torch.maximum(ft + s["m"], it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + s["m"] - m_new)
        c = f_p * s["c"] + i_p * zt
        n = f_p * s["n"] + i_p
        h = ot * c / torch.clamp(n, min=1.0)
        s = {"h": h, "c": c, "n": n, "m": m_new}
        hs.append(h)
    h = torch.stack(hs, 1).to(x.dtype).reshape(B, T, H * hd)
    return reduce_from_model(h @ p["out_proj"], axis), s
