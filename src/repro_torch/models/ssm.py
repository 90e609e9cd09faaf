"""Mamba selective-SSM block, as used by Jamba (port of
``repro/models/ssm.py``, lines 20-130): the causal depthwise conv, the
selective scan in chunks of 128 time steps, and the one-token decode
against the ``(ssm, conv)`` state.

The reference scans each chunk with ``jax.lax.associative_scan``; torch
has none, so each chunk's time steps run in order, carrying the state
``h`` ``(B, d_inner, n)`` in f32: the same recurrence ``h_t = dA_t ·
h_{t-1} + dBx_t``, within f32 reassociation of the reference's.  The
chunking bounds the live ``(chunk, B, d_inner, n)`` discretised tensors
as the reference's does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.dist.tensor_parallel import (copy_to_model, local_columns,
                                              reduce_from_model)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init


def init_mamba(key, cfg: ModelConfig, dtype, device=None):
    D, di, n, W, dtr = (cfg.d_model, cfg.d_inner, cfg.ssm_state_dim,
                        cfg.ssm_conv_width, cfg.dt_rank)
    ks = prng.split(key, 6)
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                   device=device)).repeat(di, 1).to(dtype)
    return {
        "in_proj": dense_init(ks[0], (D, 2 * di), dtype, fan_in=D,
                              device=device),
        # the reference's fan-in is shape[0], here overridden by 1/W
        "conv_w": dense_init(ks[1], (W, di), dtype, fan_in=W, scale=1.0 / W,
                             device=device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": dense_init(ks[2], (di, dtr + 2 * n), dtype, fan_in=di,
                             device=device),
        "dt_proj": dense_init(ks[3], (dtr, di), dtype, fan_in=dtr,
                              device=device),
        "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=device),
        "A_log": a_log,
        "D": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": dense_init(ks[4], (di, D), dtype, fan_in=di,
                               device=device),
    }


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_depthwise_conv(x, w, b):
    """x: (B, T, di); w: (W, di): depthwise causal conv along T."""
    W, T = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + T, :] * w[i]
    return out + b


def _ssm_chunk(h, dA, dBx, Cm):
    """One chunk of the selective scan, time step by time step.
    h: (B, di, n) f32; dA, dBx: (ch, B, di, n); Cm: (ch, B, n).
    Returns ``(h at the chunk's end, y (ch, B, di))``.  The steps take
    ``unbind``'s views: their backward stacks the steps' gradients once,
    where indexing ``dA[t]`` would fill a chunk-sized zero gradient a
    step."""
    hs = []
    for dA_t, dBx_t in zip(dA.unbind(0), dBx.unbind(0)):
        h = dA_t * h + dBx_t
        hs.append(h)
    y = torch.einsum("tbdn,tbn->tbd", torch.stack(hs), Cm)
    return h, y


def _split_bcdt(bcdt, cfg: ModelConfig):
    n, dtr = cfg.ssm_state_dim, cfg.dt_rank
    return bcdt[..., :dtr], bcdt[..., dtr:dtr + n], bcdt[..., dtr + n:]


def mamba_forward(p, x, cfg: ModelConfig, *, chunk: int = 128,
                  axis=None):
    """x: (B, T, D) -> (y, final state (B, di, n) f32, conv tail (B,
    min(W-1, T), di): the last pre-conv activations).  With ``axis``,
    this model rank's channels (module docstring; the state and the
    tail of those channels)."""
    B, T, D = x.shape
    n = cfg.ssm_state_dim
    xz = copy_to_model(x, axis) @ p["in_proj"]
    di = xz.shape[-1] // 2                                    # this rank's
    xs, z = xz[..., :di], xz[..., di:]
    conv_tail = xs[:, -(cfg.ssm_conv_width - 1):, :]
    xs = F.silu(_causal_depthwise_conv(xs, p["conv_w"],
                                       local_columns(p["conv_b"], axis)))

    bcdt = copy_to_model(reduce_from_model(xs @ p["x_proj"], axis), axis)
    dtr, Bm, Cm = _split_bcdt(bcdt, cfg)
    dt = softplus(dtr @ p["dt_proj"]
                  + local_columns(p["dt_bias"], axis))       # (B, T, di)
    A = -torch.exp(p["A_log"].to(torch.float32))              # (di, n)

    ch = min(chunk, T)
    assert T % ch == 0, (T, ch)
    h = torch.zeros((B, di, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, T, ch):
        # (B, ch, ...) -> time-major (ch, B, ...); the scan runs in f32
        dt_i = dt[:, c0:c0 + ch].transpose(0, 1)
        xs_i = xs[:, c0:c0 + ch].transpose(0, 1)
        B_i = Bm[:, c0:c0 + ch].transpose(0, 1)
        C_i = Cm[:, c0:c0 + ch].transpose(0, 1)
        dA = torch.exp(dt_i[..., None].to(torch.float32) * A)
        dBx = ((dt_i * xs_i)[..., None] * B_i[:, :, None, :]).to(
            torch.float32)
        h, y = _ssm_chunk(h, dA, dBx, C_i.to(torch.float32))
        ys.append(y)
    y = torch.cat(ys, 0).transpose(0, 1)                      # (B, T, di)
    y = y + xs.to(torch.float32) * local_columns(p["D"], axis).to(
        torch.float32)
    y = y.to(x.dtype)
    out = reduce_from_model((y * F.silu(z)) @ p["out_proj"], axis)
    return out, h, conv_tail


def mamba_decode(p, x, ssm_state, conv_state, cfg: ModelConfig,
                 axis=None):
    """One-token decode.  x: (B, 1, D); ssm_state: (B, di, n);
    conv_state: (B, W, di), the rolling buffer of pre-conv activations
    (slot W-1 the newest).  Returns ``(y (B, 1, D), new ssm state, new
    conv state)``, new tensors.  With ``axis``, this model rank's
    channels and their states (``di / M`` of them), split as
    :func:`mamba_forward` splits them."""
    xz = copy_to_model(x[:, 0], axis) @ p["in_proj"]
    di = xz.shape[-1] // 2                                    # this rank's
    xs, z = xz[..., :di], xz[..., di:]                        # (B, di)
    conv_state = torch.cat([conv_state[:, 1:], xs[:, None]], dim=1)
    xc = torch.einsum("bwd,wd->bd", conv_state, p["conv_w"]) + \
        local_columns(p["conv_b"], axis)
    xc = F.silu(xc)

    bcdt = copy_to_model(reduce_from_model(xc @ p["x_proj"], axis), axis)
    dtr, Bm, Cm = _split_bcdt(bcdt, cfg)
    dt = softplus(dtr @ p["dt_proj"]
                  + local_columns(p["dt_bias"], axis))        # (B, di)
    A = -torch.exp(p["A_log"].to(torch.float32))
    dA = torch.exp(dt[..., None].to(torch.float32) * A)      # (B, di, n)
    dBx = ((dt * xc)[..., None] * Bm[:, None, :]).to(torch.float32)
    h = dA * ssm_state + dBx
    y = torch.einsum("bdn,bn->bd", h, Cm.to(torch.float32))
    y = y + xc.to(torch.float32) * local_columns(p["D"], axis).to(
        torch.float32)
    y = y.to(x.dtype)
    out = reduce_from_model((y * F.silu(z)) @ p["out_proj"], axis)
    return out[:, None], h, conv_state
