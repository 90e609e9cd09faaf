"""Adaptive layer-wise density (port of ``repro/core/adaptk.py``).

A global per-step element budget ``K_total`` is split across the
gradient leaves from each leaf's pass-A moments of ``u = g + e`` (sum,
sum of squares, abs-max: what the fused pipeline's K1 computes), under
per-leaf ``[k_lo, k_hi]`` clamps.  Every static shape (the codec
capacity ``k_cap``, the staging widths, the wire volume) is sized from
the ceiling ``k_hi``, so the per-step ``k`` moves without a shape
change.  ``allocate`` is budget-exact: the integer budgets sum to
``K_eff = clip(K_total, Σ k_lo, Σ k_hi)`` every step.

The controller runs on the host, in numpy f32, once a step: the
reference's functions as written, operation by operation in f32, with
XLA's ``exp``/``log`` where the warmup needs them (``repro_torch.f32``).
(Compiled inside the reference's jitted train step, XLA may fuse a
multiply into the next add and turn a division by a constant into a
multiplication by its reciprocal, which can move a result by one ulp;
the port follows the functions as written.)  The budgets it returns
are ``np.int32``, the counterpart of the reference's traced int32:
threshold glue handed such a ``k`` computes in f32
(``kernels/ef_fused/ops.py``, ``core/compressors.py``), as the
reference does on a traced ``k``.  The controller state is a dict of
numpy arrays, like the reference's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core.compressors import (CompressorSpec, above,
                                         gaussian_threshold)

F32 = np.float32

POLICIES = ("uniform", "variance", "absmax")

# global-budget controllers: "none" keeps K_total at ratio × warmup;
# "normdecay" also scales it by the estimated gradient-norm decay
GLOBALK_POLICIES = ("none", "normdecay")

# compressors with a dynamic-k path (the reference's list); dgck and
# trimmedk bake k into static shapes and stay fixed-k
DYNAMIC_COMPRESSORS = ("topk", "randk", "rtopk", "gaussiank", "gaussiank2",
                       "histk")


class DensityPolicy(NamedTuple):
    """How the global element budget is spread across leaves per step
    (the reference's fields and meaning): ``policy`` the weights
    (``uniform`` leaf size, ``variance`` ``d·Var[u]``, ``absmax``
    ``d·max|u|``); ``floor_mult``/``ceil_mult`` the per-leaf clamps
    around the fixed-k budget; ``ema`` the signal's EMA factor;
    ``warmup_steps``/``warmup_mult`` the DGC density warmup;
    ``global_policy``/``global_ema``/``global_floor`` the norm-decay
    global-k controller."""
    policy: str = "variance"
    floor_mult: float = 0.25
    ceil_mult: float = 4.0
    ema: float = 0.0
    warmup_steps: int = 0
    warmup_mult: float = 1.0
    global_policy: str = "none"
    global_ema: float = 0.9
    global_floor: float = 0.25

    @property
    def cap_mult(self) -> float:
        """Static ceiling multiplier: the warmup peak must fit under it."""
        return max(self.ceil_mult, self.warmup_mult)


def make_policy(policy: str = "variance", *, floor_mult: float = 0.25,
                ceil_mult: float = 4.0, ema: float = 0.0,
                warmup_steps: int = 0,
                warmup_mult: float = 1.0,
                global_policy: str = "none",
                global_ema: float = 0.9,
                global_floor: float = 0.25) -> DensityPolicy:
    """Validated :class:`DensityPolicy` (the reference's errors)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown density policy {policy!r}; have {POLICIES}")
    if not 0.0 < floor_mult <= 1.0:
        raise ValueError(f"floor_mult must be in (0, 1], got {floor_mult}")
    if ceil_mult < 1.0:
        raise ValueError(f"ceil_mult must be >= 1, got {ceil_mult}")
    if not 0.0 <= ema < 1.0:
        raise ValueError(f"ema must be in [0, 1), got {ema}")
    if warmup_steps < 0 or warmup_mult < 1.0:
        raise ValueError("warmup_steps must be >= 0 and warmup_mult >= 1, "
                         f"got {warmup_steps}, {warmup_mult}")
    if global_policy not in GLOBALK_POLICIES:
        raise ValueError(f"unknown global-k policy {global_policy!r}; "
                         f"have {GLOBALK_POLICIES}")
    if not 0.0 <= global_ema < 1.0:
        raise ValueError(f"global_ema must be in [0, 1), got {global_ema}")
    if not 0.0 < global_floor <= 1.0:
        raise ValueError(f"global_floor must be in (0, 1], got "
                         f"{global_floor}")
    return DensityPolicy(policy, float(floor_mult), float(ceil_mult),
                         float(ema), int(warmup_steps), float(warmup_mult),
                         global_policy, float(global_ema),
                         float(global_floor))


def supports_dynamic(spec: CompressorSpec) -> bool:
    return spec.name in DYNAMIC_COMPRESSORS


def _sum(x) -> np.float32:
    """f32 sum, left to right: XLA's CPU order for the reference's short
    per-leaf vectors (measured equal up to 32 elements; the port's
    models have 12 leaves)."""
    acc = F32(0.0)
    for v in np.asarray(x, F32).reshape(-1):
        acc = F32(acc + v)
    return acc


# ---------------------------------------------------------------------------
# static bounds and per-step budget
# ---------------------------------------------------------------------------


def leaf_bounds(d: int, ratio: float, policy: DensityPolicy):
    """Static ``(k_floor, k_ceil)`` clamp of a ``d``-element leaf, from
    the fixed-k budget ``ceil(ratio·d)``; the ceiling sizes every static
    capacity."""
    k_u = max(1, math.ceil(ratio * d))
    k_lo = max(1, min(d, math.ceil(policy.floor_mult * k_u)))
    k_hi = max(k_lo, min(d, math.ceil(policy.cap_mult * k_u)))
    return k_lo, k_hi


def budget(dims: Sequence[int], ratio: float, policy: DensityPolicy,
           step=None) -> np.int32:
    """Global element budget ``K_total`` of one step: ``round(ratio ·
    d_total)`` times the warmup multiplier (which needs ``step``), as
    the reference: the f64 base rounded to f32, an f32 product, rounded
    half to even."""
    base = F32(float(ratio) * float(sum(dims)))
    if policy.warmup_steps > 0:
        if step is None:
            raise ValueError("density warmup needs the step index; pass "
                             "step= to aggregate_compressed / budget()")
        from repro_torch.optim.schedules import density_warmup
        base = F32(base * density_warmup(policy.warmup_mult,
                                          policy.warmup_steps)(step))
    return np.int32(np.round(base))


# ---------------------------------------------------------------------------
# allocation signal (from the pass-A moments)
# ---------------------------------------------------------------------------


def leaf_signal(policy_name: str, d: int, s, sq, mx) -> np.float32:
    """Allocation weight of one leaf from its pass-A moments of ``u``."""
    if policy_name == "uniform":
        return F32(d)
    if policy_name == "variance":
        s = F32(s)
        return max(F32(F32(sq) - F32(s * s) / F32(d)), F32(0.0))
    if policy_name == "absmax":
        return F32(F32(d) * F32(mx))
    raise ValueError(f"unknown density policy {policy_name!r}; "
                     f"have {POLICIES}")


# ---------------------------------------------------------------------------
# controller state (EMA over the signal; lives in the train state)
# ---------------------------------------------------------------------------


def init_controller_state(n_leaves: int, global_k: bool = False) -> dict:
    """Zero EMA state: ``signal`` the smoothed per-leaf weights, ``count``
    the cold-start gate; with ``global_k`` the :func:`global_scale`
    scalars ``gnorm`` and ``gnorm0`` (both self-seed from their first
    positive observation, so zero-filled state is exact)."""
    state = {"signal": np.zeros((n_leaves,), F32),
             "count": np.zeros((), np.int32)}
    if global_k:
        state["gnorm"] = np.zeros((), F32)
        state["gnorm0"] = np.zeros((), F32)
    return state


def blend_signal(state: Optional[dict], fresh, ema: float):
    """EMA-smooth the allocation signal: ``(blended, new_state)``.
    ``state=None`` runs stateless.  The first observation seeds the EMA:
    ``ema·s + (1 − ema)·fresh`` from the second on."""
    fresh = np.asarray(fresh, F32)
    if state is None:
        return fresh, None
    if ema > 0.0 and state["count"] > 0:
        blended = (F32(ema) * state["signal"]).astype(F32) + \
            (F32(1.0 - ema) * fresh).astype(F32)
    else:
        blended = fresh
    blended = np.asarray(blended, F32)
    return blended, {**state, "signal": blended,
                     "count": np.asarray(state["count"] + 1, np.int32)}


# ---------------------------------------------------------------------------
# convergence-aware global-k controller
# ---------------------------------------------------------------------------


def global_scale(state: Optional[dict], sq_total, policy: DensityPolicy):
    """Global-budget scale ``clip(sqrt(EMA[Σu²] / Σu²_first),
    global_floor, 1)`` under ``"normdecay"`` (1 under ``"none"``).
    Returns ``(scale, state_updates)``."""
    if policy.global_policy == "none":
        return F32(1.0), {}
    if state is None or "gnorm" not in state:
        raise ValueError(
            f"global-k policy {policy.global_policy!r} is stateful; "
            "allocate the controller scalars via "
            "init_controller_state(n, global_k=True) (init_train_state "
            "does this when density_policy.global_policy is set)")
    n = max(F32(sq_total), F32(0.0))
    g, g0 = F32(state["gnorm"]), F32(state["gnorm0"])
    sm = (F32(F32(F32(policy.global_ema) * g)
              + F32(F32(1.0 - policy.global_ema) * n))
          if g > 0.0 else n)
    ref = g0 if g0 > 0.0 else n
    ratio = F32(sm / ref) if ref > 0.0 else F32(1.0)
    scale = np.clip(np.sqrt(ratio), F32(policy.global_floor), F32(1.0))
    return F32(scale), {"gnorm": np.asarray(sm, F32),
                        "gnorm0": np.asarray(ref, F32)}


def scale_budget(K, scale) -> np.int32:
    """Apply a :func:`global_scale` factor to an int32 element budget."""
    return np.int32(np.round(F32(F32(K) * F32(scale))))


# ---------------------------------------------------------------------------
# budget-exact integer apportionment
# ---------------------------------------------------------------------------


def allocate(K_total, weights, lo, hi, *, bisect_iters: int = 48):
    """Split ``K_total`` over leaves in proportion to ``weights`` under
    per-leaf ``[lo, hi]`` clamps, budget-EXACT: ``(k, K_eff)`` int32 with
    ``sum(k) == K_eff == clip(K_total, sum(lo), sum(hi))`` and ``lo <= k
    <= hi``.  The reference's algorithm in its f32 arithmetic: a
    fixed-iteration bisection for the water-filling scale, the floor,
    then a largest-remainder fix-up (stable argsorts: ties break by leaf
    order), at most 4096 rounds.  All-zero weights fall back to
    capacity-proportional."""
    lo = np.asarray(lo, np.int32)
    hi = np.asarray(hi, np.int32)
    if lo.shape != hi.shape or lo.ndim != 1:
        raise ValueError(f"lo/hi must be matching 1-D, got {lo.shape} "
                         f"{hi.shape}")
    K_eff = np.int32(min(max(int(K_total), int(lo.sum(dtype=np.int32))),
                         int(hi.sum(dtype=np.int32))))
    cap = (hi - lo) > 0
    w = np.maximum(np.asarray(weights, F32), F32(0.0))
    if not _sum(w) > 0.0:
        w = (hi - lo).astype(F32)
    w = (w / np.maximum(w.max(), F32(1e-30))).astype(F32)
    w = (w + F32(1e-6) * cap.astype(F32)).astype(F32)
    lo_f, hi_f = lo.astype(F32), hi.astype(F32)
    Kf = F32(K_eff)
    lam_hi = F32(np.max(np.where(cap, hi_f / np.maximum(w, F32(1e-30)),
                                 F32(0.0))) + F32(1.0))
    a, b = F32(0.0), lam_hi
    for _ in range(bisect_iters):
        m = F32(F32(0.5) * F32(a + b))
        if _sum(np.clip((m * w).astype(F32), lo_f, hi_f)) < Kf:
            a = m
        else:
            b = m
    kc = np.clip((b * w).astype(F32), lo_f, hi_f)
    fl = np.floor(kc)
    k = np.clip(fl.astype(np.int32), lo, hi)
    prio = ((kc - fl).astype(F32) + w).astype(F32)
    it = 0
    while int(k.sum(dtype=np.int64)) != int(K_eff) and it < 4096:
        rem = int(K_eff) - int(k.sum(dtype=np.int64))
        can_g = k < hi
        rg = np.argsort(np.argsort(np.where(can_g, -prio, F32(np.inf)),
                                   kind="stable"), kind="stable")
        k = k + (can_g & (rg < max(rem, 0))).astype(np.int32)
        can_t = k > lo
        rt = np.argsort(np.argsort(np.where(can_t, prio, F32(np.inf)),
                                   kind="stable"), kind="stable")
        k = k - (can_t & (rt < max(-rem, 0))).astype(np.int32)
        it += 1
    return k.astype(np.int32), K_eff


# ---------------------------------------------------------------------------
# dynamic-k selection (per-step budget, static capacity)
# ---------------------------------------------------------------------------


def select_dynamic(spec: CompressorSpec, u: torch.Tensor, k, k_cap: int,
                   key=None):
    """Fixed-capacity selection with a per-step budget ``k`` (an int32
    scalar in ``[1, k_cap]``): sentinel-padded ``(values, indices)`` of
    shape ``(min(k_cap, d),)``.  Threshold compressors take ``k`` into
    their f32 threshold math; ``topk``, ``randk`` and ``rtopk`` (the
    last two with the row's ``key``) rank at the capacity and sentinel
    out ranks ``>= k``.  Raises for compressors without a dynamic
    path."""
    name = spec.name
    if name not in DYNAMIC_COMPRESSORS:
        raise ValueError(
            f"compressor {name!r} bakes its per-step budget k into static "
            f"sample/candidate shapes, so it has no dynamic-k (traced "
            f"budget) path; adaptive density policies support "
            f"{DYNAMIC_COMPRESSORS}.  Run {name!r} fixed-k instead: drop "
            f"--density-policy on the CLI (density_policy=None in "
            f"aggregate_compressed / make_train_step).")
    k = np.int32(k)
    d = u.shape[0]
    k_cap = min(k_cap, d)
    if name in ("topk", "randk", "rtopk"):
        # rank at the capacity (rtopk: its sample sized from it too) and
        # sentinel out ranks >= k
        values, idx = spec.select(u, k_cap, key)
        keep = torch.arange(k_cap, device=u.device) < int(k)
        values = torch.where(keep, values,
                             torch.zeros((), dtype=u.dtype, device=u.device))
        indices = torch.where(keep, idx, codec.SENTINEL)
        return values, indices
    if name in ("gaussiank", "gaussiank2"):
        thres = gaussian_threshold(u, k, two_sided=(name == "gaussiank2"))
        return codec.compact_by_mask(u, above(u, thres), k_cap)
    # histk: the histogram in plain torch ops over the port's integer
    # bins (the reference's is plain jnp too; the fused pipeline reads
    # K1's histogram instead)
    from repro_torch.kernels.histk.hist import BINS, bin_of
    from repro_torch.kernels.histk.ops import threshold_from_histogram
    h = torch.bincount(bin_of(torch.abs(u)).reshape(-1).long(),
                       minlength=BINS)
    thres = threshold_from_histogram(h, k)
    return codec.compact_by_mask(u, torch.abs(u) > float(thres), k_cap)
