"""Where one training step's time goes on the card.

    python -m repro_torch.launch.profile --arch llama3.2-1b \\
        --steps 3 --batch 8 --seq 128 [--density-policy none] \\
        [--mesh 4x1 --strategy gtopk]     # --mesh defaults to 4x2

    # one worker per card over NCCL
    torchrun --nproc-per-node 4 -m repro_torch.launch.profile ... --mesh 4x1

Runs the train step's phases with CUDA events between them, for
``--steps`` steps after one warm-up step, and prints each phase's median
ms: per worker this process runs (all W of the mesh, ``LocalWire``; or
its own one under ``torchrun``, ``ProcessGroupWire``, where rank 0
prints) its forward + backward and its compression (pack, the EF
kernels, the staging assembly; under adaptive density, the arch default
of llama3.2-1b, split into each worker's pack and pass A, the
allocation, and the workers' threshold and compaction); then the
wire (the gather or the gTop-k rounds and the decode, and for the
two-level strategies the pod mean's second compression and the second
level); the unpack and metrics; the
optimizer.  The forward + backward rematerialises each layer-pattern
period unless ``--smoke``, as the trainer's step does.  Then it traces
one more step with ``torch.profiler`` and
prints the device time by kernel name, the kernel count, the host
syncs (the CUDA runtime's synchronize calls) and the device's idle
share of that step's wall time.  The last line is one
JSON object with all of it.  Needs a GPU.

With ``--chunks N`` (N > 1) or ``--pipeline perleaf`` it times the
train step itself (``make_train_step``) instead of its phases: the step,
each worker's backward, and for the chunked schedule the moment each
chunk's hook released its gradients, as a fraction of that worker's
backward span (CUDA events recorded when the hook fires and at the
backward's ends); then the same trace.

The mesh's model axis ``M`` makes every worker's buckets ``M`` rows, as
in the trainer.  A tensor-parallel ``torchrun`` launch (``M > 1``: one
model rank a process, ``dist/tensor_parallel.py``) times each rank's
forward + backward on its shards, the relayout of its gradient shards
into its row (``ModelRow.pack``), the row's compression, the wire, the
relayout of the mean row back into the shards (``ModelRow.unpack``),
the metrics and the optimizer; every rank's medians are gathered, and
rank 0 prints each rank's and the slowest rank's (the largest of each
phase over the ranks).  ``--chunks N`` and ``--pipeline perleaf`` time
the tensor-parallel train step as above:

    torchrun --nproc-per-node 2 -m repro_torch.launch.profile \
        --arch deepseek-moe-16b --mesh 1x2 --steps 3 \
        [--dist-backend gloo]   # two ranks on one card
"""
from __future__ import annotations

import json
import statistics
import sys
import time

# CUDA runtime calls that block the host until the card catches up
_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
          "cudaEventSynchronize")


def main(argv=None, cfg=None) -> int:
    """Parse ``argv`` (the trainer's flags) and profile; ``cfg``, a
    ModelConfig, replaces ``--arch``'s (a depth-cut copy, say), as in
    ``launch.train.run``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.wire import LocalWire, torchrun_env
    from repro_torch.launch.train import (density_policy_of, make_wire,
                                          parse_args, require_ported)

    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a GPU")
    if cfg is None:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = cfg.reduced()
    mesh, strategy = require_ported(args, cfg)
    policy, _ = density_policy_of(args, cfg)
    if torchrun_env() is None:
        wire, dev, started = LocalWire(mesh), torch.device(args.device), False
    else:
        wire, dev, started = make_wire(args, mesh)
    try:
        if args.chunks > 1 or args.pipeline == "perleaf":
            return _profile_step(args, cfg, strategy, policy, wire, dev)
        if wire.tensor_parallel:
            return _profile_tp(args, cfg, strategy, policy, wire, dev)
        return _profile(args, cfg, strategy, policy, wire, dev)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _profile(args, cfg, strategy, policy, wire, dev) -> int:
    import torch

    from repro_torch import tree
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data import batch_for
    from repro_torch.dist import aggregate
    from repro_torch.dist.layout import build_layout
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import adamw, sgd_momentum
    from repro_torch.train import init_train_state
    from repro_torch.train.step import step_keys

    W, L = wire.world, wire.local_workers
    say = print if _lead(wire) else (lambda *a, **k: None)
    params = init_params(cfg, args.seed, dev)
    comp = CompressionConfig(compressor=args.compressor, ratio=args.ratio,
                             strategy=strategy, backend=args.backend,
                             density_policy=policy)
    layout = build_layout(params, wire.model_size, comp)
    opt = sgd_momentum(0.9) if args.optimizer == "sgd" else adamw()
    state = init_train_state(params, opt, workers=L,
                             model_size=wire.model_size, compression=comp,
                             layout=layout)
    leaves, td = tree.flatten(params)
    per = args.batch // W

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def step(i):
        """One step; returns its events by phase."""
        batch = batch_for(cfg, i, global_batch=args.batch, seq_len=args.seq,
                          seed=args.seed, device=dev)
        ev = {"start": event(), "fb": [], "pass_a": [], "comp": []}

        def grads_of(w):
            rank = wire.ranks[w]
            rows = slice(rank * per, (rank + 1) * per)
            local = {k: v[rows] for k, v in batch.items()}
            ps = [p.detach().requires_grad_(True) for p in leaves]
            loss, _ = loss_fn(tree.unflatten(td, ps), cfg, local,
                              remat=not args.smoke)
            grads = tree.unflatten(td, list(torch.autograd.grad(loss, ps)))
            ev["fb"].append(event())
            return grads

        def probe(rank, **kw):
            if rank is None:
                ev["alloc" if "k_alloc" in kw else "wire"] = event()
            else:
                ev["pass_a" if "u" in kw else "comp"].append(event())

        res = aggregate.aggregate_bucketed(
            [lambda w=w: grads_of(w) for w in range(L)], state["resid"],
            layout, comp, wire=wire, resid2=state.get("resid2"),
            probe=probe, adapt_state=state.get("adaptk"), step=i,
            keys=step_keys(args.seed, i, wire.ranks))
        if res.adapt_state is not None:
            state["adaptk"] = res.adapt_state
        ev["agg"] = event()
        opt.update(params, state["opt"], res.agg, args.lr)
        ev["opt"] = event()
        return ev

    def phases(ev) -> dict:
        out = {"forward_backward": 0.0}
        prev = ev["start"]
        if ev["pass_a"]:
            # adaptive: fwd+bwd and pass A per worker, the allocation,
            # then every worker's threshold + compaction
            out["pass_a"] = 0.0
            for a, b in zip(ev["fb"], ev["pass_a"]):
                out["forward_backward"] += prev.elapsed_time(a)
                out["pass_a"] += a.elapsed_time(b)
                prev = b
            out["allocation"] = prev.elapsed_time(ev["alloc"])
            out["threshold_compaction"] = ev["alloc"].elapsed_time(
                ev["comp"][-1])
            out["compress"] = (out["pass_a"] + out["allocation"]
                               + out["threshold_compaction"])
        else:
            out["compress"] = 0.0
            for a, b in zip(ev["fb"], ev["comp"]):
                out["forward_backward"] += prev.elapsed_time(a)
                out["compress"] += a.elapsed_time(b)
                prev = b
        out.update({"wire": ev["comp"][-1].elapsed_time(ev["wire"]),
                    "unpack_metrics": ev["wire"].elapsed_time(ev["agg"]),
                    "optimizer": ev["agg"].elapsed_time(ev["opt"]),
                    "step": ev["start"].elapsed_time(ev["opt"])})
        return out

    times = {}
    for i in range(args.steps + 1):
        ev = step(i)
        torch.cuda.synchronize()
        if i == 0:
            continue            # warm-up: Triton JIT, cuBLAS handles
        for p, v in phases(ev).items():
            times.setdefault(p, []).append(v)
    med = {p: statistics.median(v) for p, v in times.items()}
    say(f"mesh {args.mesh} ({W} workers, {L} in this process, wire "
        f"{wire.name}, {wire.backend}), strategy {strategy}; phase medians "
        "(ms, summed over this process's workers): "
        + ", ".join(f"{p} {v:.2f}" for p, v in med.items()))

    say(json.dumps(dict(_trace(lambda: step(args.steps + 1), say),
                        arch=cfg.name, batch=args.batch, seq=args.seq,
                        mesh=args.mesh, workers=W,
                        compressor=args.compressor,
                        density_policy=policy.policy if policy else None,
                        wire=wire.name, dist_backend=wire.backend,
                        strategy=strategy, phase_ms=med)))
    return 0


def _trace(run, say) -> dict:
    """Trace one more ``run()`` with ``torch.profiler``: prints and
    returns its wall ms, device busy ms, host syncs and top kernels."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    syncs = sum(e.count for e in prof.key_averages() if e.key in _SYNCS)
    kernels = device_kernels(prof)
    busy = sum(k[1] for k in kernels)
    say(f"profiled step: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"(idle share {1 - busy / wall_ms:.3f}), {len(kernels)} kernel "
        f"names, {syncs} host syncs (the step's closing one included)")
    for name, ms, n in kernels[:25]:
        say(f"  {ms:9.3f} ms  x{n:<5d} {name[:100]}")
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy,
            "host_syncs": syncs,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "top_kernels": kernels[:25],
            "device": torch.cuda.get_device_name(0)}


def release_fractions(events: list) -> dict:
    """A step's chunk releases as fractions of the backward's span, per
    worker: ``events`` holds ``(rank, what, cuda event)`` in order,
    ``what`` ``"start"``, ``"end"`` or a chunk index.  Returns
    ``{rank: {"backward_ms", "released": {chunk: fraction}}}``."""
    out, start = {}, {}
    for rank, what, ev in events:
        if what == "start":
            start[rank] = ev
            out[rank] = {"released": {}}
        elif what == "end":
            out[rank]["backward_ms"] = start[rank].elapsed_time(ev)
    for rank, what, ev in events:
        if what not in ("start", "end"):
            span = out[rank]["backward_ms"]
            out[rank]["released"][what] = (
                start[rank].elapsed_time(ev) / span if span else 0.0)
    return out


def _profile_step(args, cfg, strategy, policy, wire, dev) -> int:
    import torch

    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data import batch_for
    from repro_torch.dist.layout import build_layout
    from repro_torch.models import init_params
    from repro_torch.optim import adamw, constant, sgd_momentum
    from repro_torch.train import init_train_state, make_train_step

    W = wire.world
    say = print if _lead(wire) else (lambda *a, **k: None)
    params = init_params(cfg, args.seed, dev)
    comp = CompressionConfig(compressor=args.compressor, ratio=args.ratio,
                             strategy=strategy, backend=args.backend,
                             density_policy=policy, chunks=args.chunks)
    layout = (None if args.pipeline == "perleaf"
              else build_layout(params, wire.model_size, comp))
    tp = None
    if wire.tensor_parallel:
        from repro_torch.dist.tensor_parallel import TensorParallel
        tp = TensorParallel(cfg, wire, params)
        params = tp.shard(params)
    opt = sgd_momentum(0.9) if args.optimizer == "sgd" else adamw()
    state = init_train_state(params, opt, workers=wire.local_workers,
                             model_size=wire.model_size, compression=comp,
                             layout=layout, rows=1 if tp else None,
                             whole=tp.whole if tp else None)
    events = []

    def probe(rank, backward=None, release=None, **_):
        if backward is not None or release is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            what = (release if release is not None
                    else "start" if backward else "end")
            events.append((rank, what, ev))

    step_fn = make_train_step(cfg, args.mesh, opt, constant(args.lr),
                              compression=comp, layout=layout, probe=probe,
                              wire=wire, seed=args.seed, tensor_parallel=tp,
                              remat=not args.smoke)

    def step(i):
        nonlocal state
        batch = batch_for(cfg, i, global_batch=args.batch, seq_len=args.seq,
                          seed=args.seed, device=dev)
        state, m = step_fn(state, batch)
        return m

    step_ms, backward_ms, fracs = [], [], []
    for i in range(args.steps + 1):
        events.clear()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        m = step(i)
        b.record()
        torch.cuda.synchronize()
        if i == 0:
            continue            # warm-up: Triton JIT, cuBLAS handles
        step_ms.append(a.elapsed_time(b))
        rel = release_fractions(events)
        if rel:
            backward_ms.append(sum(r["backward_ms"] for r in rel.values()))
            fracs.append(rel)
    say(f"mesh {args.mesh} ({W} workers, wire {wire.name}, "
        f"{wire.backend}), strategy {strategy}, pipeline {args.pipeline}, "
        f"chunks {args.chunks}: collectives a step "
        f"{int(m['collectives_per_step'])}; step ms "
        f"{[round(x, 2) for x in step_ms]}"
        + (f", backward ms {[round(x, 2) for x in backward_ms]}"
           if backward_ms else ""))
    for rank, r in (fracs[-1].items() if fracs else ()):
        rel = r["released"]
        say(f"  worker {rank}: chunks released at fractions of its "
            f"backward {[round(rel[c], 3) for c in sorted(rel)]}")
    say(json.dumps(dict(_trace(lambda: step(args.steps + 1), say),
                        arch=cfg.name, batch=args.batch, seq=args.seq,
                        mesh=args.mesh, workers=W, strategy=strategy,
                        pipeline=args.pipeline, chunks=args.chunks,
                        collectives_per_step=m["collectives_per_step"],
                        wire=wire.name, dist_backend=wire.backend,
                        step_ms=step_ms, backward_ms=backward_ms,
                        release_fractions=fracs[-1] if fracs else {})))
    return 0


def _lead(wire) -> bool:
    """Whether this process prints: data rank 0, model rank 0."""
    return wire.ranks[0] == 0 and getattr(wire, "model_rank", 0) == 0


# the tensor-parallel step's phases, in order, each between two events
TP_PHASES = ("forward_backward", "relayout_in", "compress", "wire",
             "relayout_back", "unpack_metrics", "optimizer")


def _profile_tp(args, cfg, strategy, policy, wire, dev) -> int:
    """The tensor-parallel rank's breakdown (module docstring): the
    bucketed pipeline in one chunk, its phases between CUDA events."""
    import torch
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data import batch_for
    from repro_torch.dist import aggregate
    from repro_torch.dist.layout import build_layout
    from repro_torch.dist.tensor_parallel import TensorParallel
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import adamw, sgd_momentum
    from repro_torch.train import init_train_state
    from repro_torch.train.step import step_keys

    W, M = wire.world, wire.model_size
    say = print if _lead(wire) else (lambda *a, **k: None)
    params = init_params(cfg, args.seed, dev)
    comp = CompressionConfig(compressor=args.compressor, ratio=args.ratio,
                             strategy=strategy, backend=args.backend,
                             density_policy=policy)
    layout = build_layout(params, M, comp)
    tp = TensorParallel(cfg, wire, params)
    params = tp.shard(params)
    opt = sgd_momentum(0.9) if args.optimizer == "sgd" else adamw()
    state = init_train_state(params, opt, workers=1, model_size=M,
                             compression=comp, layout=layout, rows=1)
    leaves, td = tree.flatten(params)
    per = args.batch // W
    rank = wire.ranks[0]
    rows = tp.rows(layout)
    ev = {}

    def event(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        ev[name] = e

    def timed(fn, before, after):
        def call(*a, **k):
            event(before)
            out = fn(*a, **k)
            event(after)
            return out
        return call

    rows.pack = timed(rows.pack, "forward_backward", "relayout_in")
    rows.unpack = timed(rows.unpack, "wire", "relayout_back")

    def probe(r, **kw):
        if r is not None and "u" not in kw:
            event("compress")           # after the row's compression

    def step(i):
        ev.clear()
        batch = batch_for(cfg, i, global_batch=args.batch, seq_len=args.seq,
                          seed=args.seed, device=dev)
        event("start")
        local = {k: v[rank * per:(rank + 1) * per] for k, v in batch.items()}
        ps = [p.detach().requires_grad_(True) for p in leaves]
        loss, _ = loss_fn(tree.unflatten(td, ps), cfg, local, tp.axis,
                          remat=not args.smoke)
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
        grads = tree.unflatten(td, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(ps, grads)])
        res = aggregate.aggregate_bucketed(
            [grads], state["resid"], layout, comp, wire=wire,
            resid2=state.get("resid2"), probe=probe,
            adapt_state=state.get("adaptk"), step=i,
            keys=step_keys(args.seed, i, wire.ranks), rows=rows)
        del grads
        if res.adapt_state is not None:
            state["adaptk"] = res.adapt_state
        event("unpack_metrics")
        opt.update(params, state["opt"], res.agg, args.lr)
        event("optimizer")
        return dict(ev)

    times = {p: [] for p in TP_PHASES + ("step",)}
    for i in range(args.steps + 1):
        got = step(i)
        torch.cuda.synchronize()
        if i == 0:
            continue            # warm-up: Triton JIT, cuBLAS handles
        prev = got["start"]
        for p in TP_PHASES:
            times[p].append(prev.elapsed_time(got[p]))
            prev = got[p]
        times["step"].append(got["start"].elapsed_time(got["optimizer"]))
    med = {p: statistics.median(v) for p, v in times.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {"phase_ms": med, "peak_mem_gib": peak,
                                   "data_rank": rank,
                                   "model_rank": wire.model_rank})
    slowest = {p: max(r["phase_ms"][p] for r in every) for p in med}
    say(f"mesh {args.mesh} ({W} workers x {M} model ranks, tensor "
        f"parallel, wire {wire.name}, {wire.backend}), strategy "
        f"{strategy}; phase medians (ms):")
    for r in every:
        say(f"  data rank {r['data_rank']} model rank {r['model_rank']}: "
            + ", ".join(f"{p} {v:.2f}" for p, v in r["phase_ms"].items())
            + f"; peak {r['peak_mem_gib']:.2f} GiB")
    say("  slowest rank (each phase's largest): "
        + ", ".join(f"{p} {v:.2f}" for p, v in slowest.items()))
    say(json.dumps(dict(_trace(lambda: step(args.steps + 1), say),
                        arch=cfg.name, batch=args.batch, seq=args.seq,
                        mesh=args.mesh, workers=W, model_size=M,
                        compressor=args.compressor,
                        density_policy=policy.policy if policy else None,
                        wire=wire.name, dist_backend=wire.backend,
                        strategy=strategy, tensor_parallel=True,
                        phase_ms_by_rank=every, phase_ms_slowest=slowest)))
    return 0


def device_kernels(prof) -> list:
    """``(name, device ms, launches)`` of every kernel a
    ``torch.profiler`` run recorded, the longest first."""
    import torch
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue            # host-side ops; their kernels are listed
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt and dt > 0:
            kernels.append((e.key, dt / 1e3, e.count))
    return sorted(kernels, key=lambda x: -x[1])


if __name__ == "__main__":
    sys.exit(main())
