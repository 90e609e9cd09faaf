"""Shared helpers for the paper-fidelity benchmarks (port of the JAX
package's ``benchmarks/common.py``): ``timeit``, the measurement
provenance ``bench_meta``/``stamp_meta``, the message-counting wire
``CountingWire``, and ``simulate_sparsified_sgd``, the single-process
simulation of paper Eq. (2) on FNN-3 that Fig. 1/2/5/6/10/11 and rTop-k
drive."""
from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch import prng, tree
from repro_torch.core import codec, get_compressor
from repro_torch.devices import resolve_device
from repro_torch.models.fnn import fnn_loss, init_fnn
from repro_torch.optim import sgd_momentum

# H100 SXM data sheet: the memory rate every bytes bound is taken at
HBM_BYTES_PER_S = 3.35e12


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit(fn, *args, warmup=2, iters=5):
    """Mean wall microseconds per call, device-complete.

    The device is synchronised INSIDE the timed loop, after every call:
    synchronising only after the loop would let every call but the last
    overlap its successor's launches, timing the launch queue instead of
    the work (methods with different launch counts would then compare
    dishonestly).
    """
    for _ in range(warmup):
        fn(*args)
        _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
        _sync()
    return (time.perf_counter() - t0) / iters * 1e6  # us


class CountingWire:
    """A wire that counts the codec-pair collectives it is asked for:
    each ``all_gather`` and ``ppermute`` call is one message (the
    reference counts the same primitives in a jaxpr); ``pmean`` (the
    metrics' and the allocator's) is not a message.  Everything else is
    the wrapped wire's."""

    def __init__(self, inner):
        self.inner, self.messages = inner, 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def all_gather(self, xs, axis, async_op: bool = False):
        self.messages += 1
        return self.inner.all_gather(xs, axis, async_op=async_op)

    def ppermute(self, xs, axis, perm):
        self.messages += 1
        return self.inner.ppermute(xs, axis, perm)


def bytes_bound_ms(nbytes: float) -> float:
    """Least ms to move ``nbytes`` at the H100's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def bench_meta() -> dict:
    """Measurement-provenance fields every result document records: the
    platform, the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, and
    the torch and CUDA versions, and the launch environment
    (``launch.env.describe_env``)."""
    from repro_torch.launch.env import describe_env
    meta = {"platform": "gpu" if torch.cuda.is_available() else "cpu",
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "python": sys.version.split()[0], "gpu": None,
            "env": describe_env()}
    if torch.cuda.is_available():
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout
        meta["gpu"] = out.strip().splitlines()[0].strip()
    return meta


def stamp_meta(doc: dict) -> dict:
    """Add :func:`bench_meta` to a benchmark's JSON document in place."""
    doc.update(bench_meta())
    return doc


def simulate_sparsified_sgd(compressor: str, *, workers=16, ratio=0.001,
                            steps=150, lr=0.05, seed=0, batch=64,
                            collect_u_hist_at=(), k_override=None,
                            spec=None, density_policy=None, stats_out=None,
                            device="cuda"):
    """Single-process simulation of paper Eq. (2) on FNN-3 with synthetic
    MNIST-like data, on ``device`` (the card unless told ``"cpu"``).
    Returns (losses, accs, comm_elems_per_step, hists).

    Step for step the reference's computation: per-worker batches
    ``mnist_like(t*workers + w, batch, seed=seed+17)``, a residual per
    leaf and worker, the per-leaf key ``fold_in(PRNGKey(seed+99),
    t*1000 + w*10 + li)``, ``spec.select`` (or ``adaptk.select_dynamic``)
    then ``codec.decode`` and ``nnz``, and ``sgd_momentum(0.9)``.  The
    compressors run their reference branch (never the fused pipeline,
    whose per-block staging caps would change what is measured).

    ``spec`` reuses an already-built ``CompressorSpec``.  ``stats_out``
    (a list) receives one ``(workers, n_leaves, 3)`` f32 array of
    per-worker pass-A moments ``(sum, sumsq, absmax)`` of ``u`` per
    step.  ``density_policy`` (``core.adaptk.DensityPolicy``) switches
    the per-leaf budgets to the adaptive controller: worker-mean signal,
    budget-exact allocation, per-step ``k`` against the static ceiling
    capacity; a ``global_policy`` beyond ``"none"`` scales the budget
    by the norm-decay controller fed the worker-mean total second
    moment.
    """
    from repro_torch.core import adaptk
    from repro_torch.data import mnist_like

    device = resolve_device(device)
    params = init_fnn(prng.PRNGKey(seed), device=device)
    opt = sgd_momentum(0.9)
    mom = opt.init(params)
    leaves, treedef = tree.flatten(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    dims = [leaf.numel() for leaf in leaves]
    dense = compressor == "none"
    if spec is None and not dense:
        spec = get_compressor(compressor)
    adaptive = density_policy is not None and not dense
    want_stats = adaptive or stats_out is not None
    resid = [torch.zeros((workers, d), device=device) for d in dims]

    ks, k_caps, bounds = {}, {}, {}
    if not dense:
        for li, d in enumerate(dims):
            k = (k_override(d) if k_override
                 else max(1, int(np.ceil(ratio * d))))
            ks[li] = min(k, d)
            if adaptive:
                lo, hi = adaptk.leaf_bounds(d, ratio, density_policy)
                bounds[li] = (lo, hi)
                k_caps[li] = min(d, spec.k_cap(hi, d))
    if adaptive:
        lo_v = [bounds[li][0] for li in range(len(dims))]
        hi_v = [bounds[li][1] for li in range(len(dims))]
    ema_sig = None
    gstate = None
    if adaptive and density_policy.global_policy != "none":
        gstate = adaptk.init_controller_state(len(dims), global_k=True)
    losses, accs, comm, hists = [], [], [], {}
    for t in range(steps):
        # phase 1: per-worker grads and accumulated u (residual folded in)
        tot_loss = tot_acc = 0.0
        us = []
        for w in range(workers):
            b = mnist_like(t * workers + w, batch=batch, seed=seed + 17,
                           device=device)
            loss, m = fnn_loss(params, b)
            g_leaves = torch.autograd.grad(loss, leaves)
            tot_loss += float(loss.detach()) / workers
            tot_acc += float(m["acc"]) / workers
            if dense:
                us.append([gl.reshape(-1) for gl in g_leaves])
            else:
                us.append([resid[li][w] + gl.reshape(-1)
                           for li, gl in enumerate(g_leaves)])
        if want_stats:
            stats = torch.stack([
                torch.stack([torch.stack([u.sum(), (u * u).sum(),
                                          u.abs().max()]) for u in row])
                for row in us]).cpu().numpy()
            if stats_out is not None:
                stats_out.append(stats)
        # phase 2: allocation (adaptive), as the mesh path does it — one
        # worker-mean signal, one budget-exact integer allocation
        k_alloc = None
        if adaptive:
            sig = np.asarray([
                [float(adaptk.leaf_signal(density_policy.policy, dims[li],
                                          *stats[w, li]))
                 for li in range(len(dims))] for w in range(workers)])
            fresh = np.asarray(sig.mean(axis=0), np.float32)
            if density_policy.ema > 0.0 and ema_sig is not None:
                fresh = (np.float32(density_policy.ema) * ema_sig
                         + np.float32(1.0 - density_policy.ema) * fresh)
            ema_sig = fresh
            K = adaptk.budget(dims, ratio, density_policy, t)
            if gstate is not None:
                # worker-mean total second moment, the extra lane the
                # mesh path rides on the allocation collective
                sq_tot = stats[:, :, 1].mean(axis=0).sum()
                scale, upd = adaptk.global_scale(gstate, sq_tot,
                                                 density_policy)
                gstate = {**gstate, **upd}
                K = adaptk.scale_budget(K, scale)
            k_alloc, _ = adaptk.allocate(K, fresh, lo_v, hi_v)
        # phase 3: compress, update residuals, aggregate
        gsum = [torch.zeros((d,), device=device) for d in dims]
        n_sel = 0
        with torch.no_grad():
            for w in range(workers):
                for li, d in enumerate(dims):
                    u = us[w][li]
                    if dense:
                        gsum[li] = gsum[li] + u
                        n_sel += d
                        continue
                    if w == 0 and li == 1 and t in collect_u_hist_at:
                        hists[t] = np.histogram(u.cpu().numpy(), bins=60)
                    key = prng.fold_in(prng.PRNGKey(seed + 99),
                                       t * 1000 + w * 10 + li)
                    if adaptive:
                        v, i = adaptk.select_dynamic(spec, u, k_alloc[li],
                                                     k_caps[li], key)
                    else:
                        v, i = spec.select(u, ks[li], key)
                    dec = codec.decode(v, i, d)
                    resid[li][w] = u - dec
                    gsum[li] = gsum[li] + dec
                    n_sel += int(codec.nnz(i))
        agg = tree.unflatten(treedef, [
            (s / workers).reshape(leaf.shape)
            for s, leaf in zip(gsum, leaves)])
        params, mom = opt.update(params, mom, agg, np.float32(lr))
        losses.append(tot_loss)
        accs.append(tot_acc)
        comm.append(n_sel)
    return losses, accs, comm, hists
