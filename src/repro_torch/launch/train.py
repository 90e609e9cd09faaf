"""Training entry point of the port (port of ``repro/launch/train.py``).

  python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 3 --batch 8 --seq 128 --mesh 1x1
  # the reference's default mesh: four data-parallel workers of two
  # model rows each, in this process, on one card
  python -m repro_torch.launch.train ... --host-devices 8 --mesh 4x2
  # one worker per process
  torchrun --nproc-per-node 2 -m repro_torch.launch.train ... --mesh 2x1
  # tensor parallel: one model rank per process
  torchrun --nproc-per-node 2 -m repro_torch.launch.train ... --mesh 1x2

Same flags as the JAX trainer, plus ``--device {cuda,cpu}`` (default
``cuda``) and ``--dist-backend`` (the process group's backend under
``torchrun``: ``nccl`` by default on ``--device cuda``, which needs one
card per process, ``gloo`` on ``--device cpu``).  Without a GPU the
trainer exits with an error unless ``--device cpu`` is given; it never
drops to the CPU by itself.  The mesh defaults to the reference's
``4x2``.

A mesh ``DxM`` or ``PxDxM`` has ``W = D`` (``P·D``) data-parallel
workers and a model axis of ``M``: each worker's buckets are ``M`` rows,
each selecting its own ``ceil(k / M)`` (the reference's row-wise
selection).  The workers run either all in this process
(``--host-devices N`` with ``N >= W·M``, the count of the JAX flag:
``LocalWire``, each worker holding the whole model and all ``M`` rows) or
under ``torchrun`` with ``WORLD_SIZE = W·M``, one process a (worker,
model rank) pair (``ProcessGroupWire``; with ``M > 1`` tensor-parallel:
each process holds its model rank's shards of the params and one row,
``dist/tensor_parallel.py``, every block kind).  With neither, a
mesh of ``W·M > 1`` raises naming both.  The startup line prints the
mesh, W, the wire and its backend.

The port trains with the ``bucketed`` pipeline, its chunked schedule
(``--chunks N``: N leaf-aligned chunk groups, each compressed and sent
as the backward releases its gradients; bitwise the unchunked run, N
collectives a wire level) or the per-leaf loop (``--pipeline perleaf``:
one chain a leaf, bitwise the bucketed run), the four wire
strategies (``--strategy allgather|gtopk|hierarchical|hier_gtopk``;
``--hierarchical`` is the old spelling of the third) and
``--compressor`` ``topk``, ``gaussiank``, ``gaussiank2``, ``histk``
(``--backend fused``: K1 with its histogram and K3; ``reference``: the
K4d histogram and K4c compaction), ``trimmedk`` (plain torch, the
reference backend) or the key-sampled ``randk``, ``dgck`` and ``rtopk``
(the reference backend, keyed from ``--seed`` as the reference keys
them; ``randk`` draws through the ``threefry_bits`` kernel); fixed-k, or
with adaptive layer-wise density
(``--density-policy uniform|variance|absmax``, ``--density-floor``,
``--density-ceil``, ``--density-ema``, ``--density-warmup[-mult]``,
``--global-k-policy normdecay`` with ``--global-k-ema`` and
``--global-k-floor``).  As in the reference, a dynamic-k compressor
takes the arch config's ``density_policy`` unless the flag is given
(llama3.2-1b: ``variance``; ``--density-policy none`` trains fixed-k),
so ``randk`` and ``rtopk`` train adaptive by default there while
``dgck``, which has no dynamic-k path, trains fixed-k.  DGC momentum
correction has no flag, as in the reference: it is
``CompressionConfig(momentum_correction=...)``.
``--checkpoint`` saves the final state and ``--resume`` starts from one
(``checkpoint/npz.py``, the JAX package's keys; a per-leaf checkpoint
resumes into the bucketed pipeline).  ``--publish-every N`` publishes a
compressed weight delta for serving replicas after every N-th step of
the run (``serve/publish.py``: top-k at ``--publish-ratio`` over
``params - pub`` with its own residual, on the training layout
re-budgeted; every ``--resync-every``-th publish ships the dense
bucket) and prints ``published D deltas + R resyncs (X MiB on the
wire)``; the publisher's state rides in the checkpoint under
``publish/``.  ``--strategy auto`` picks the wire strategy with the
topology tuner (``dist/tuner.choose_strategy``) over the mesh's data
axes, from the ``--topology`` JSON descriptor or, without one, from
``launch/topo.measure_topology`` over this run's own wire (under
``torchrun`` rank 0's measurement, broadcast, so every rank decides
alike; in one process ``LocalWire`` crosses no link and every axis keeps
the default link); it prints ``tuner: topology=... -> strategy=...``,
tags each log line with ``tuner=<strategy>`` and then trains exactly as
that strategy given explicitly.  Under tensor parallelism each rank
publishes its model row: the params' shards packed into row ``r`` by
the gradients' relayout (``ModelRow.pack``) and encoded at ``ceil(k /
M)``, so the rows, the bits on the wire and the ``published`` line are
the one-process ``--mesh 1xM`` publisher's on the same params; the
checkpoint's ``publish/`` buckets gather to its ``(M, d_row_total)``.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke variant of the arch")
    ap.add_argument("--compressor", default="gaussiank",
                    help="none|topk|gaussiank|gaussiank2|histk|trimmedk|"
                         "randk|dgck|rtopk")
    ap.add_argument("--ratio", type=float, default=0.001)
    ap.add_argument("--strategy", default="allgather",
                    choices=["allgather", "gtopk", "hierarchical",
                             "hier_gtopk", "auto"])
    ap.add_argument("--hierarchical", action="store_true",
                    help="deprecated alias for --strategy hierarchical")
    ap.add_argument("--topology", default="",
                    help="JSON topology descriptor (launch/topo.py) that "
                         "--strategy auto prices; default: measured over "
                         "this run's wire")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "fused", "reference"],
                    help="compression pipeline: the fused Hopper kernels "
                         "(their plain versions on --device cpu) or the "
                         "torch reference")
    ap.add_argument("--pipeline", default="bucketed",
                    choices=["bucketed", "perleaf"],
                    help="one wire chain a step over the flat bucket, or "
                         "one a gradient leaf (bitwise the same results)")
    ap.add_argument("--chunks", type=int, default=1,
                    help="cut the bucket into N leaf-aligned chunks, each "
                         "compressed and sent as the backward releases its "
                         "gradients (needs --pipeline bucketed and a "
                         "sparse compressor; bitwise the same results)")
    ap.add_argument("--density-policy", default="",
                    choices=["", "none", "uniform", "variance", "absmax"],
                    help="adaptive layer-wise density; default: the arch "
                         "config's density_policy, else fixed-k")
    ap.add_argument("--density-floor", type=float, default=0.25)
    ap.add_argument("--density-ceil", type=float, default=4.0)
    ap.add_argument("--density-ema", type=float, default=0.0)
    ap.add_argument("--density-warmup", type=int, default=0)
    ap.add_argument("--density-warmup-mult", type=float, default=16.0)
    ap.add_argument("--global-k-policy", default="none",
                    choices=["none", "normdecay"])
    ap.add_argument("--global-k-ema", type=float, default=0.9)
    ap.add_argument("--global-k-floor", type=float, default=0.25)
    ap.add_argument("--publish-every", type=int, default=0)
    ap.add_argument("--publish-ratio", type=float, default=0.01)
    ap.add_argument("--resync-every", type=int, default=8)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"])
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--schedule", default="constant",
                    choices=["constant", "cosine", "step"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="4x2", help="DxM or PxDxM")
    ap.add_argument("--host-devices", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--resume", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train; cuda needs a GPU")
    ap.add_argument("--dist-backend", default="", choices=["", "nccl",
                                                           "gloo"],
                    help="process-group backend under torchrun (default: "
                         "nccl on --device cuda, gloo on cpu)")
    return ap


def parse_args(argv=None):
    return _parser().parse_args(argv)


def require_ported(args, cfg):
    """Check the flags against each other; returns the mesh and the
    strategy (``"auto"`` for the tuner to decide)."""
    from repro_torch.core.compressors import get_compressor
    from repro_torch.dist.layout import resolve_strategy
    from repro_torch.launch.mesh import parse_mesh

    mesh = parse_mesh(args.mesh)
    if args.strategy == "auto":
        if args.compressor == "none":
            raise SystemExit(
                "--strategy auto tunes the sparse wire pattern; it is "
                "meaningless with --compressor none (dense all-reduce)")
        strategy = "auto"
    else:
        strategy = resolve_strategy(args.strategy, args.hierarchical)
    if args.compressor != "none":
        get_compressor(args.compressor)
    if args.chunks < 1:
        raise SystemExit(f"--chunks must be >= 1, got {args.chunks}")
    if args.chunks > 1 and (args.pipeline != "bucketed"
                            or args.compressor == "none"):
        raise SystemExit(
            "--chunks > 1 needs the bucketed sparse pipeline: use "
            "--pipeline bucketed with a sparse compressor (the chunked "
            "schedule re-dispatches the flat wire block)")
    return mesh, strategy


def density_policy_of(args, cfg):
    """The adaptive density policy of this launch, as the reference's CLI
    picks it: an explicit ``--density-policy`` wins; else a dynamic-k
    compressor (``adaptk.DYNAMIC_COMPRESSORS``) takes the arch config's
    default.  Returns ``(policy or None, name)``; ``--global-k-policy``
    without an adaptive policy exits."""
    from repro_torch.core.adaptk import DYNAMIC_COMPRESSORS, make_policy

    name = args.density_policy
    if not name and args.compressor in DYNAMIC_COMPRESSORS:
        name = cfg.density_policy
    if name and name != "none" and args.compressor != "none":
        return make_policy(
            name, floor_mult=args.density_floor,
            ceil_mult=args.density_ceil, ema=args.density_ema,
            warmup_steps=args.density_warmup,
            warmup_mult=args.density_warmup_mult if args.density_warmup
            else 1.0,
            global_policy=args.global_k_policy,
            global_ema=args.global_k_ema,
            global_floor=args.global_k_floor), name
    if args.global_k_policy != "none":
        raise SystemExit(
            "--global-k-policy scales the adaptive global budget, so it "
            "needs an adaptive --density-policy (uniform|variance|absmax) "
            "and a sparse dynamic-k compressor")
    return None, name


def make_wire(args, mesh):
    """The wire of this launch and this process's device: under
    ``torchrun`` a ``ProcessGroupWire`` (the process group initialised
    here; the caller destroys it), else a ``LocalWire`` when
    ``--host-devices`` covers the mesh's ``W·M`` devices.  Returns
    ``(wire, device, started)``, ``started`` true under ``torchrun``."""
    import torch

    from repro_torch.dist.wire import (LocalWire, ProcessGroupWire,
                                       init_process_group, torchrun_env)
    from repro_torch.launch.mesh import data_world_size, model_axis_size

    W, M = data_world_size(mesh), model_axis_size(mesh)
    env = torchrun_env()
    if env is None:
        if W * M > max(args.host_devices, 1):
            raise SystemExit(
                f"--mesh {args.mesh} has {W} data-parallel workers x {M} "
                f"model ranks: run them in this process with "
                f"--host-devices {W * M}, or one per process with torchrun "
                f"--nproc-per-node {W * M}")
        return LocalWire(mesh), torch.device(args.device), False
    rank, world, local_rank, local_world = env
    if world != W * M:
        raise SystemExit(f"torchrun started {world} processes; --mesh "
                         f"{args.mesh} has {W} data-parallel workers x {M} "
                         "model ranks")
    backend = args.dist_backend or ("nccl" if args.device == "cuda"
                                    else "gloo")
    init_process_group(backend, rank=rank, world_size=world,
                       local_rank=local_rank, local_world_size=local_world)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
    return ProcessGroupWire(mesh), device, True


def run(argv=None, *, probe: Optional[Callable] = None,
        cfg=None, on_publish: Optional[Callable] = None) -> list:
    """Parse ``argv``, train, print one line per logged step and return
    the per-step records ``[{"step", "loss", "ms", ...metrics}]``.
    ``probe`` reaches the train step and the aggregation; ``cfg``, a
    ModelConfig, replaces ``--arch``'s (a depth-cut copy, say);
    ``on_publish(msg=, layout=, state=, params=, tp=)`` runs after each
    publish (``tp`` the rank's ``TensorParallel`` or None).  Under
    ``torchrun`` only rank 0 prints, and the process group this call
    starts is destroyed before it returns."""
    args = parse_args(argv)
    import torch

    from repro_torch.configs import get_config

    if cfg is None:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = cfg.reduced()
    mesh, strategy = require_ported(args, cfg)
    density = density_policy_of(args, cfg)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no GPU is visible; pass --device "
                         "cpu to train on the CPU")
    wire, device, started = make_wire(args, mesh)
    try:
        return _train(args, cfg, mesh, strategy, density, wire, device,
                      probe, on_publish)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(args, cfg, mesh, strategy, density, wire, device, probe,
           on_publish=None) -> list:
    import torch

    from repro_torch import tree
    from repro_torch.checkpoint import load_state, save_state
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.compressors import get_compressor
    from repro_torch.data import batch_for
    from repro_torch.dist.layout import build_layout
    from repro_torch.dist.tensor_parallel import TensorParallel
    from repro_torch.launch.mesh import model_axis_size
    from repro_torch.models import init_params
    from repro_torch.optim import (adamw, constant, cosine, sgd_momentum,
                                   step_decay)
    from repro_torch.train import init_train_state, make_train_step

    opt = sgd_momentum(0.9) if args.optimizer == "sgd" else adamw()
    lr_fn = {"constant": lambda: constant(args.lr),
             "cosine": lambda: cosine(args.lr, args.steps),
             "step": lambda: step_decay(args.lr, 0.1,
                                        max(args.steps // 2, 1))}[
        args.schedule]()
    policy, pol_name = density
    M = model_axis_size(mesh)
    params = init_params(cfg, args.seed, device)
    layout = None
    if args.pipeline == "bucketed" and args.compressor != "none":
        layout = build_layout(params, M, args.ratio,
                              get_compressor(args.compressor),
                              density_policy=policy)
    lead = wire.ranks[0] == 0 and getattr(wire, "model_rank", 0) == 0
    say = print if lead else (lambda *a, **k: None)
    decision = None
    if strategy == "auto":
        decision = tune_strategy(args, mesh, wire, device, params, layout,
                                 policy)
        strategy = decision.strategy
        preds = " ".join(f"{p.strategy}={p.total_s * 1e6:.1f}us"
                         for p in decision.predictions)
        say(f"tuner: topology={decision.topology} "
            f"axes={dict(data_axes_pairs(mesh))} -> strategy={strategy} "
            f"({preds})", flush=True)
    config = CompressionConfig(compressor=args.compressor, ratio=args.ratio,
                               strategy=strategy, backend=args.backend,
                               density_policy=policy, chunks=args.chunks)
    # a tensor-parallel rank's model axis and its params' checked
    # placements, made once from the whole params
    tp = TensorParallel(cfg, wire, params) if wire.tensor_parallel \
        else None
    if tp is not None:
        params = tp.shard(params)
    state = init_train_state(params, opt, workers=wire.local_workers,
                             model_size=M, compression=config,
                             layout=layout, rows=1 if tp else None,
                             whole=tp.whole if tp else None)
    pub = _publisher(args, params, layout, device, M, tp)
    if args.resume:
        # layout= loads a per-leaf checkpoint's residuals into the
        # buckets; the publisher's state rides under "publish/"
        # (zero-filled when the checkpoint has none: seq 0 resyncs
        # first); a tensor-parallel rank takes its shards and row
        full = load_state(args.resume, dict(state, publish=pub["state"])
                          if pub else state, worker_rows=wire.ranks,
                          layout=layout,
                          shard=None if tp is None else tp.state_shard())
        if pub:
            pub["state"] = full.pop("publish")
        state = full
    step = make_train_step(cfg, mesh, opt, lr_fn, compression=config,
                           layout=layout, probe=probe, wire=wire,
                           seed=args.seed, tensor_parallel=tp,
                           remat=not args.smoke)
    say(f"arch={cfg.name} compressor={args.compressor} ratio={args.ratio} "
        f"strategy={strategy}{'(auto)' if decision is not None else ''} "
        f"backend={args.backend} mesh={args.mesh} "
        f"workers={wire.world} wire={wire.name} "
        f"dist_backend={wire.backend} model={M} "
        f"tensor_parallel={int(tp is not None)} pipeline={args.pipeline} "
        f"chunks={args.chunks} "
        f"density_policy={pol_name or 'fixed-k'} "
        f"global_k={args.global_k_policy} device={device} "
        f"steps={args.steps}",
        flush=True)
    records = []
    t0 = time.time()
    first = state["step"]
    for i in range(first, first + args.steps):
        batch = batch_for(cfg, i, global_batch=args.batch, seq_len=args.seq,
                          seed=args.seed, device=device)
        ts = time.perf_counter()
        state, m = step(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - ts) * 1e3
        rec = {"step": i, "ms": ms}
        rec.update({k: float(v) for k, v in m.items()})
        if pub and (i - first + 1) % args.publish_every == 0:
            rec.update(_publish_tick(args, pub, state["params"],
                                     on_publish, tp))
        records.append(rec)
        if i % args.log_every == 0 or i == first + args.steps - 1:
            comm = ""
            if "comm_bits_sparse" in m:
                r = rec["comm_bits_sparse"] / rec["comm_bits_dense"]
                comm = (f" comm_frac={r:.4f} coll="
                        f"{int(rec['collectives_per_step'])}"
                        f" density={rec['density']:.6f}")
            if "k_total" in m:
                comm += f" k_total={int(rec['k_total'])}"
            if decision is not None:
                comm += (f" tuner={decision.strategy}"
                         f" pred_wire_us={decision.best.total_s * 1e6:.1f}")
            say(f"step {i:5d} loss={rec['loss']:.4f} lr={rec['lr']:.4g}"
                f"{comm} step_ms={ms:.1f} ({time.time() - t0:.1f}s)",
                flush=True)
    if pub:
        say(f"published {pub['deltas']} deltas + {pub['resyncs']} resyncs "
            f"({pub['bits'] / 8 / 2 ** 20:.3f} MiB on the wire)", flush=True)
    if args.checkpoint:
        out = state if not pub else dict(state, publish=pub["state"])
        if tp is not None:
            # the model group's shards and rows, as one whole state
            out = tp.gather_state(out)
        if wire.local_workers != wire.world:
            # every worker's residual rows, gathered in rank order
            out = dict(out)
            for key in ("resid", "resid2"):
                if key in out:
                    out[key] = tree.tree_map(
                        lambda r: wire.all_gather([r[0]],
                                                  wire.data_axes)[0],
                        out[key])
        if lead:
            save_state(args.checkpoint, out)
            say(f"saved -> {args.checkpoint}")
    return records


def data_axes_pairs(mesh) -> list:
    """The mesh's data axes as ``(name, size)`` pairs, outermost first."""
    from repro_torch.launch.mesh import data_axes_of
    return [(ax, mesh.sizes[ax]) for ax in data_axes_of(mesh)]


def tune_strategy(args, mesh, wire, device, params, layout, policy):
    """``--strategy auto``: the ``TunerDecision`` of
    ``dist.tuner.choose_strategy`` over the mesh's data axes, on the
    ``--topology`` descriptor or on one measured over ``wire``.  The
    per-leaf pipeline has no layout of its own; the tuner only needs the
    bucket's geometry, so it builds one (with the run's density policy)
    from the whole params."""
    from repro_torch.core.compressors import get_compressor
    from repro_torch.dist.layout import build_layout
    from repro_torch.dist.tuner import choose_strategy
    from repro_torch.launch.mesh import model_axis_size
    from repro_torch.launch.topo import load_topology, measure_topology

    topo = (load_topology(args.topology) if args.topology
            else measure_topology(mesh, wire, device=device))
    if layout is None:
        layout = build_layout(params, model_axis_size(mesh), args.ratio,
                              get_compressor(args.compressor),
                              density_policy=policy)
    return choose_strategy(layout, data_axes_pairs(mesh), topo)


def _publisher(args, params, layout, device, model_size: int, tp=None
               ) -> Optional[dict]:
    """The weight-delta publisher of ``--publish-every`` (None without):
    top-k at ``--publish-ratio`` on the training layout re-budgeted
    (``build_layout`` of the whole params at the mesh's model axis
    without one), its state, its key ``fold_in(PRNGKey(seed), 0x9B)``
    and its counters.  A tensor-parallel rank (``tp``) holds its model
    row of the state and packs its shards into it (``rows``)."""
    if args.publish_every <= 0:
        return None
    from repro_torch import prng
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.compressors import get_compressor
    from repro_torch.dist.layout import build_layout, rebudget_layout
    from repro_torch.serve import init_publisher_state

    config = CompressionConfig(compressor="topk", ratio=args.publish_ratio,
                               backend=args.backend)
    pub_layout = (rebudget_layout(layout, args.publish_ratio,
                                  get_compressor("topk"))
                  if layout is not None
                  else build_layout(tp.whole if tp else params, model_size,
                                    config))
    return {"config": config, "layout": pub_layout,
            "state": init_publisher_state(pub_layout, device=device,
                                          rows=1 if tp else None),
            "rows": tp.rows(pub_layout) if tp else None,
            "key": prng.fold_in(prng.PRNGKey(args.seed), 0x9B),
            "bits": 0, "deltas": 0, "resyncs": 0}


def _publish_tick(args, pub, params, on_publish=None, tp=None) -> dict:
    """One publish of the trainer's params; returns the record's
    ``publish_kind`` (``RESYNC`` 0 / ``DELTA`` 1) and ``publish_bits``
    (of every model row: a tensor-parallel rank's message is its row)."""
    import torch

    from repro_torch.serve import RESYNC, message_bits, publish

    with torch.no_grad():
        pub["state"], msg = publish(pub["state"], params, pub["layout"],
                                    pub["config"], pub["key"],
                                    resync_every=args.resync_every,
                                    rows=pub["rows"])
    bits = message_bits(msg) * (pub["layout"].model_size
                                // pub["state"]["pub"].shape[0])
    pub["bits"] += bits
    pub["resyncs" if msg.kind == RESYNC else "deltas"] += 1
    if on_publish is not None:
        on_publish(msg=msg, layout=pub["layout"], state=pub["state"],
                   params=params, tp=tp)
    return {"publish_kind": msg.kind, "publish_bits": bits}


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
