"""The decoder's loss in plain PyTorch, from a configuration file's
``model``: token embedding, layers of causal multi-head attention (RoPE
over the whole head, half-split) and a SwiGLU MLP or a mixture of
experts (softmax router, top-k, gates renormalised, a Switch-style
load-balance loss, a capacity of ``ceil(N·K/E·capacity_factor)``
rounded up to 8 slots an expert, assignments kept in token order and
the rest dropped, shared experts), pre-norm RMSNorm, an untied head,
cross-entropy plus the balance losses.

Computed in blocks so that it fits the card at the timed sizes: each
layer is recomputed in the backward (``torch.utils.checkpoint``), the
attention runs a block of queries at a time, and the head and the
cross-entropy run a block of tokens at a time.  ``precision="fp8"``
rounds both operands of every matrix product to float8 (e4m3, one scale
a tensor) on the way forward: the control that a comparison has to
fail.  The weights are a ``{name: tensor}`` dict named as the program's
parameter tree is (:func:`param_shapes`)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 1024
TOKEN_BLOCK = 4096
FP8_MAX = 448.0


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def _period(m: dict) -> int:
    return math.lcm(len(m["block_pattern"]), len(m["ffn_pattern"]))


def _block_shapes(m: dict, layer: int, lead=()) -> dict:
    D, H, KV, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        head_dim(m)
    if m["block_pattern"][layer % len(m["block_pattern"])] != "attn":
        raise ValueError("the reference has attention blocks only")
    b = {"norm1": {"scale": lead + (D,)},
         "core": {"wq": lead + (D, H * hd), "wk": lead + (D, KV * hd),
                  "wv": lead + (D, KV * hd), "wo": lead + (H * hd, D)}}
    ffn = m["ffn_pattern"][layer % len(m["ffn_pattern"])]
    if ffn == "mlp":
        F_ = m["d_ff"]
        b["ffn"] = {"w_gate": lead + (D, F_), "w_up": lead + (D, F_),
                    "w_down": lead + (F_, D)}
    elif ffn == "moe":
        E, Fe = m["num_experts"], m.get("moe_d_ff") or m["d_ff"]
        b["ffn"] = {"router": lead + (D, E), "w_gate": lead + (E, D, Fe),
                    "w_up": lead + (E, D, Fe), "w_down": lead + (E, Fe, D)}
        S = m.get("num_shared_experts", 0)
        if S:
            b["ffn"]["shared"] = {"w_gate": lead + (D, Fe * S),
                                  "w_up": lead + (D, Fe * S),
                                  "w_down": lead + (Fe * S, D)}
    else:
        raise ValueError(f"ffn {ffn!r}")
    if ffn != "none":
        b["norm2"] = {"scale": lead + (D,)}
    return b


def _flat(tree, prefix, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat(tree[k], prefix + (k,), out)
    elif isinstance(tree, list):
        for i, c in enumerate(tree):
            _flat(c, prefix + (i,), out)
    else:
        out.append(("/".join(str(p) for p in prefix), tuple(tree)))


def param_shapes(m: dict) -> list:
    """``[(name, shape)]`` of every parameter, in the order and with the
    names of the program's tree: each position of the layer pattern one
    leaf stacked over its repetitions, the remaining layers a tail."""
    if m.get("use_bias") or m.get("parallel_block"):
        raise ValueError("the reference has no biases and no parallel "
                         "blocks")
    D, V, L = m["d_model"], m["vocab_size"], m["num_layers"]
    period = _period(m)
    reps, tail = divmod(L, period)
    tree = {"embed": (V, D), "final_norm": {"scale": (D,)},
            "lm_head": (D, V),
            "stack": [_block_shapes(m, pos, (reps,))
                      for pos in range(period if reps else 0)],
            "tail": [_block_shapes(m, reps * period + i)
                     for i in range(tail)]}
    out: list = []
    _flat(tree, (), out)
    return out


def layer_params(m: dict, w: dict, layer: int) -> dict:
    """Layer ``layer``'s weights, ``{"core/wq": tensor, ...}``: views
    into the stacked leaves, or a tail layer's own."""
    period = _period(m)
    reps = m["num_layers"] // period
    if layer < reps * period:
        pre, r = f"stack/{layer % period}/", layer // period
        return {k[len(pre):]: v[r] for k, v in w.items()
                if k.startswith(pre)}
    pre = f"tail/{layer - reps * period}/"
    return {k[len(pre):]: v for k, v in w.items() if k.startswith(pre)}


class Ops:
    """Matrix products in the stated precision or, for the control, with
    float8 operands (forward only; the gradients pass straight)."""

    def __init__(self, precision: str = "bf16"):
        if precision not in ("bf16", "fp8"):
            raise ValueError(precision)
        self.fp8 = precision == "fp8"

    def q(self, x):
        if not self.fp8:
            return x
        scale = x.detach().abs().amax().float().clamp(min=1e-12) / FP8_MAX
        y = (x.detach().float() / scale).to(torch.float8_e4m3fn)
        y = (y.float() * scale).to(x.dtype)
        return x + (y - x).detach()

    def mm(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


def rmsnorm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return (x32 * scale.float()).to(x.dtype)


def rope(x, theta: float):
    """Half-split rotary embedding of ``x`` ``(B, T, heads, hd)``."""
    T, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, device=x.device,
                                        dtype=torch.float32) / hd))
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] \
        * inv[None]
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], -1).to(x.dtype)


def attention(x, p, m: dict, ops: Ops):
    B, T, D = x.shape
    H, KV, hd = m["num_heads"], m["num_kv_heads"], head_dim(m)
    q = rope(ops.mm(x, p["core/wq"]).view(B, T, H, hd), m["rope_theta"])
    k = rope(ops.mm(x, p["core/wk"]).view(B, T, KV, hd), m["rope_theta"])
    v = ops.mm(x, p["core/wv"]).view(B, T, KV, hd)
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))     # (B, H, T, hd)
    kpos = torch.arange(T, device=x.device)
    outs = []
    for lo in range(0, T, Q_BLOCK):
        hi = min(T, lo + Q_BLOCK)
        s = ops.mm(q[:, :, lo:hi], k.transpose(-1, -2)) / math.sqrt(hd)
        s = s.float().masked_fill(
            kpos[None, :] > torch.arange(lo, hi, device=x.device)[:, None],
            float("-inf"))
        outs.append(ops.mm(torch.softmax(s, -1).to(x.dtype), v))
    o = torch.cat(outs, 2).transpose(1, 2).reshape(B, T, H * hd)
    return ops.mm(o, p["core/wo"])


def swiglu(x, wg, wu, wd, ops: Ops):
    return ops.mm(F.silu(ops.mm(x, wg)) * ops.mm(x, wu), wd)


def capacity(n_tokens: int, m: dict) -> int:
    c = math.ceil(n_tokens * m["experts_per_token"] / m["num_experts"]
                  * m.get("capacity_factor", 1.25))
    return max(8, -(-c // 8) * 8)


def moe(x, p, m: dict, ops: Ops):
    B, T, D = x.shape
    E, K = m["num_experts"], m["experts_per_token"]
    N = B * T
    xt = x.reshape(N, D)
    probs = torch.softmax(ops.mm(xt, p["ffn/router"]).float(), -1)
    gate, idx = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    top1 = F.one_hot(idx[:, 0], E).float().mean(0)
    aux = m.get("router_aux_coef", 0.01) * E * torch.sum(probs.mean(0)
                                                         * top1)
    # assignments in token order, each expert keeping its first C
    flat = idx.reshape(-1)
    C = capacity(N, m)
    onehot = F.one_hot(flat, E)
    rank_in_e = (torch.cumsum(onehot, 0) - 1).gather(1, flat[:, None])[:, 0]
    kept = rank_in_e < C
    out = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    gates = gate.reshape(-1)
    for e in range(E):
        a = torch.nonzero((flat == e) & kept)[:, 0]
        if a.numel() == 0:
            continue
        tok = a // K
        y = swiglu(xt[tok], p["ffn/w_gate"][e], p["ffn/w_up"][e],
                   p["ffn/w_down"][e], ops)
        out = out.index_add(0, tok, y.float() * gates[a][:, None])
    out = out.to(x.dtype)
    if "ffn/shared/w_gate" in p:
        out = out + swiglu(xt, p["ffn/shared/w_gate"], p["ffn/shared/w_up"],
                           p["ffn/shared/w_down"], ops)
    return out.view(B, T, D), aux


def block(h, p, m: dict, layer: int, ops: Ops):
    h = h + attention(rmsnorm(h, p["norm1/scale"]), p, m, ops)
    ffn = m["ffn_pattern"][layer % len(m["ffn_pattern"])]
    x = rmsnorm(h, p["norm2/scale"])
    if ffn == "moe":
        f, aux = moe(x, p, m, ops)
    else:
        f = swiglu(x, p["ffn/w_gate"], p["ffn/w_up"], p["ffn/w_down"], ops)
        aux = torch.zeros((), device=h.device)
    return h + f, aux


def loss(w: dict, m: dict, tokens, labels, precision: str = "bf16"):
    """``(loss, ce, aux)``: the mean cross-entropy over the tokens plus
    the layers' balance losses."""
    ops = Ops(precision)
    act = getattr(torch, m.get("activation_dtype", "bfloat16"))
    h = F.embedding(tokens, w["embed"]).to(act)
    aux = torch.zeros((), device=h.device)
    for layer in range(m["num_layers"]):
        p = layer_params(m, w, layer)
        h, a = checkpoint(lambda h, p=p, l=layer: block(h, p, m, l, ops), h,
                          use_reentrant=False)
        aux = aux + a
    h = rmsnorm(h, w["final_norm/scale"]).reshape(-1, h.shape[-1])
    lab = labels.reshape(-1)

    def nll(hc, lc):
        logits = ops.mm(hc, w["lm_head"]).float()
        ll = logits.gather(1, lc[:, None])[:, 0] - torch.logsumexp(logits,
                                                                    -1)
        return -ll.sum()
    total = torch.zeros((), device=h.device)
    for lo in range(0, h.shape[0], TOKEN_BLOCK):
        sl = slice(lo, lo + TOKEN_BLOCK)
        total = total + checkpoint(nll, h[sl], lab[sl], use_reentrant=False)
    ce = total / lab.numel()
    return ce + aux, ce, aux
