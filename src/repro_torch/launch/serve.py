"""Continuous-batching serving driver with train-to-serve delta streaming
(port of ``repro/launch/serve.py``).

Requests are admitted in waves (admission control: at most
``--max-batch`` slots a wave, each request with its own generation
length), prefilled together, then decoded token by token.  Between
decode steps the replica polls an in-process trainer: every
``--publish-every`` decode steps the trainer takes a drift step and
publishes a compressed weight delta (``serve/publish.py``), which the
replica scatter-adds into its live params (``serve/subscribe.py``)
without stopping decode.  Every ``--resync-every``-th publish ships the
dense bucket: replica params equal trainer params exactly at those
epochs.

  python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --requests 12 --max-batch 8 --prompt-len 64 --gen 16 \\
      --publish-every 4 --publish-ratio 0.01
  python -m repro_torch.launch.serve --arch llama3.2-1b --smoke \\
      --device cpu --requests 4 --max-batch 2 --prompt-len 8 --gen 4 \\
      --publish-every 2 --resync-every 2

Same flags and defaults as the JAX driver, plus ``--device {cuda,cpu}``
(default ``cuda``; without a GPU it exits unless ``--device cpu``),
``--placement {2d,model-only}`` and ``--dist-backend``; ``--mesh``
defaults to the reference's ``4x2``.  In one process a mesh ``DxM`` is
the same function as the batch sharded over D devices and the params
over M, computed on the whole batch with the whole model on one device
(the startup line says so; ``--host-devices`` is accepted for the
reference's command lines and changes nothing).  Under ``torchrun
--nproc-per-node D·M`` each process is one rank of the mesh (model rank
``r`` of data group ``w`` is global rank ``w·M + r``; NCCL with a card a
rank, else gloo, or ``--dist-backend``), placed by
``serve/steps.ServePlacement``: it holds model rank ``r``'s shards of
every weight and of the cache, and with ``--placement 2d`` (the
reference's default) only ``1 / D`` of its shard of each weight at rest,
gathering a block's pieces over its data group before the block runs;
the batch is split over the data groups where D divides it.  The
in-process trainer and its publisher live on rank 0 alone; every message
is broadcast to all ranks, and each applies what lands in its pieces.
Every rank draws the same prompts and queue and ends with the whole
batch's tokens; rank 0 alone prints::

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
      --arch llama3.2-1b --mesh 2x2 --publish-every 4

The delta stream's layout has model size 1, as the reference's driver
builds it.  ``--publish-every 0`` freezes the weights
(pure serving, no trainer).  The queue is ``np.random.default_rng(seed)``
and the prompts ``randint`` draws of ``repro_torch.prng`` from
``PRNGKey(seed)`` (for an ``embeds`` frontend, ``normal`` draws of (B, T,
d_model) embeddings), as the reference draws them; the generated tokens
enter through ``embed`` either way; tokens are the argmax,
or with ``--temperature > 0`` ``prng.categorical`` samples.

``run(argv, probe=, on_logits=)`` returns the emitted tokens, the
counters and the per-phase times (CUDA events on the card; placed, also
``broadcast`` and each block's ``gather_prefill`` / ``gather_decode``);
``probe("publish", ...)`` is called after each message is applied to the
replica, ``on_logits`` after each step.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8,
                    help="total requests in the synthetic queue")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="admission control: slots per decode wave")
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16,
                    help="max generation length; requests draw from "
                         "[gen//2, gen]")
    ap.add_argument("--mesh", default="4x2", help="DxM or PxDxM")
    ap.add_argument("--host-devices", type=int, default=0,
                    help="accepted for the reference's command lines; "
                         "unused")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--publish-every", type=int, default=0,
                    help="trainer publishes a weight delta every N decode "
                         "steps (0 = frozen weights)")
    ap.add_argument("--publish-ratio", type=float, default=0.01,
                    help="density of the delta stream")
    ap.add_argument("--resync-every", type=int, default=8,
                    help="every Nth publish ships the dense bucket")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to serve; cuda needs a GPU")
    ap.add_argument("--placement", default="2d",
                    choices=["2d", "model-only"],
                    help="under torchrun: also cut every model shard over "
                         "the data axis at rest (2d, the reference's "
                         "default), or keep it whole on each rank")
    ap.add_argument("--dist-backend", default="", choices=["", "nccl",
                                                           "gloo"],
                    help="process-group backend under torchrun (default: "
                         "nccl on --device cuda, gloo on cpu)")
    return ap


class _Timer:
    """Per-phase times in ms: CUDA events on the card (read once, at the
    end, so timing adds no sync), the host clock on the CPU."""

    def __init__(self, device):
        import torch
        self.torch, self.cuda = torch, device.type == "cuda"
        self.spans = {}

    def mark(self):
        if self.cuda:
            ev = self.torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, name: str, start) -> None:
        self.spans.setdefault(name, []).append((start, self.mark()))

    def ms(self) -> dict:
        if self.cuda:
            self.torch.cuda.synchronize()
            return {n: [a.elapsed_time(b) for a, b in v]
                    for n, v in self.spans.items()}
        return {n: [(b - a) * 1e3 for a, b in v]
                for n, v in self.spans.items()}


def drift(params, i: int):
    """The in-process trainer's stand-in for an optimizer step, out of
    place: ``x + 1e-3 · sin(x · (1 + 0.1·i))`` in f32."""
    import numpy as np
    import torch

    from repro_torch import tree
    f = float(np.float32(1.0) + np.float32(0.1) * np.float32(i))
    return tree.tree_map(lambda x: x + 1e-3 * torch.sin(x * f), params)


def norm(x) -> float:
    """The 2-norm of ``x`` (the reference's ``jnp.linalg.norm``), summed
    in f64 over chunks of 2**26 elements: torch's f32 ``vector_norm`` on
    the CPU is off by ~2e-5 relative at a million elements, and a whole
    f64 copy of a 6 GB bucket would not be small."""
    import torch
    flat = x.reshape(-1)
    step = 1 << 26
    parts = [torch.linalg.vector_norm(flat[a:a + step], dtype=torch.float64)
             for a in range(0, flat.numel(), step)]
    return float(torch.linalg.vector_norm(torch.stack(parts)))


def run(argv=None, *, probe: Optional[Callable] = None, cfg=None,
        on_logits: Optional[Callable] = None) -> dict:
    """Parse ``argv``, serve the queue, print the ``stream:`` (when
    streaming) and ``serve:`` lines, and return ``{"tokens": one (B,
    wave_gen) int64 tensor a wave, the counters, "times": per-phase ms
    lists}``.  ``cfg``, a ModelConfig, replaces ``--arch``'s.
    ``probe("publish", msg=, layout=, state=, trainer=, replica=)`` runs
    after each message is applied (placed over the mesh: on every rank,
    with ``placed=`` the rank's ``ServePlacement``, ``replica`` its
    pieces, and ``state`` and ``trainer`` None but on rank 0);
    ``on_logits(wave, step, logits)`` after each prefill (step 0) and
    decode step, with the whole batch's logits; their time is left out
    of the reported seconds and tokens/s.  Under ``torchrun`` every rank
    returns the same tokens and counters, rank 0 alone prints, and the
    process group this call starts is destroyed before it returns."""
    args = _parser().parse_args(argv)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.wire import torchrun_env
    from repro_torch.launch.mesh import parse_mesh

    if cfg is None:
        cfg = get_config(args.arch)
        if args.smoke:
            cfg = cfg.reduced()
    mesh = parse_mesh(args.mesh)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no GPU is visible; pass --device "
                         "cpu to serve on the CPU")
    if torchrun_env() is None:
        return _serve(args, cfg, mesh, torch.device(args.device), None,
                      probe, on_logits)
    from repro_torch.launch.train import make_wire
    wire, device, _ = make_wire(args, mesh)
    try:
        return _serve(args, cfg, mesh, device, wire, probe, on_logits)
    finally:
        torch.distributed.destroy_process_group()


def _broadcast_message(wire, msg, layout, seq: int, resync_every: int,
                       device):
    """Rank 0's delta on every rank (its own on rank 0).  A resync's
    bucket is not sent here but a leaf at a time by
    :func:`_broadcast_leaves`: another rank's message holds a ``meta``
    bucket of its shape."""
    import torch

    from repro_torch.serve import DELTA, RESYNC, DeltaMessage, resyncs_at
    rows = layout.model_size
    if resyncs_at(seq, resync_every):
        return msg or DeltaMessage(seq, RESYNC, None, None, torch.empty(
            (rows, layout.d_row_total), device="meta"))
    shape = (rows, layout.k_cap_total)
    values = wire.broadcast(msg.values if msg is not None else
                            torch.empty(shape, device=device))
    indices = wire.broadcast(msg.indices if msg is not None else
                             torch.empty(shape, dtype=torch.int32,
                                         device=device))
    return msg or DeltaMessage(seq, DELTA, values, indices, None)


def _broadcast_leaves(wire, msg, layout, device):
    """Rank 0's resync bucket on every rank, one whole leaf at a time
    (the transient is a leaf, not the bucket)."""
    import torch

    from repro_torch.serve.subscribe import bucket_leaves
    if msg.bucket.device.type != "meta":
        for flat in bucket_leaves(layout, msg.bucket):
            yield wire.broadcast(flat)
        return
    for seg in layout.segments:
        yield wire.broadcast(torch.empty((seg.size,), device=device))


def _serve(args, cfg, mesh, device, wire, probe, on_logits) -> dict:
    """The serving loop of :func:`run`: on one device (``wire`` None),
    or on this rank of a ``torchrun`` launch, placed by a
    ``ServePlacement``."""
    import numpy as np
    import torch

    from repro_torch import prng, tree
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.dist.layout import build_layout
    from repro_torch.launch.mesh import data_world_size, model_axis_size
    from repro_torch.models import init_params
    from repro_torch.serve import (RESYNC, ServePlacement, apply_resync,
                                   init_publisher_state, make_apply_delta,
                                   make_decode_step, make_prefill_step,
                                   message_bits, publish)
    from repro_torch.serve.subscribe import resync_pieces

    key = prng.PRNGKey(args.seed)
    streaming = args.publish_every > 0
    B, T = args.max_batch, args.prompt_len
    s_max = T + args.gen
    D, M = data_world_size(mesh), model_axis_size(mesh)
    placed, lead = None, True
    if wire is None:
        trainer = init_params(cfg, args.seed, device)
        # the replica starts in sync, in storage of its own
        params = tree.tree_map(torch.clone, trainer)
        where = (f"data={D} (the whole batch on one {device.type} device) "
                 f"model={M} (the whole model)")
    else:
        meta = init_params(cfg, args.seed, "meta")
        placed = ServePlacement(cfg, wire, meta, args.placement)
        lead = wire.global_rank == 0
        # the in-process trainer lives on rank 0 alone; every other rank
        # draws its replica leaf by leaf, keeping its pieces
        trainer = (init_params(cfg, args.seed, device)
                   if streaming and lead else None)
        params = (placed.cut_tree(trainer) if trainer is not None else
                  init_params(cfg, args.seed, device, cut=placed.cut))
        rows = (f"{B // D} sequences a data group" if placed.splits(B)
                else "the whole batch in every data group")
        where = (f"data={D} ({rows}) model={M} (a shard a rank, mode "
                 f"{args.placement}) ranks={D * M} "
                 f"dist_backend={wire.backend}")
    say = print if lead else (lambda *a, **k: None)

    if streaming:
        pub_config = CompressionConfig(compressor="topk",
                                       ratio=args.publish_ratio)
        # the delta layout keeps model size 1, as the reference's driver
        layout = build_layout(meta if placed else trainer, 1, pub_config)
        pub_state = (init_publisher_state(layout, device=device) if lead
                     else None)
        apply_delta = make_apply_delta(layout, device, placed)
        pub_key = prng.fold_in(key, 0x5EEDED)
    prefill_step = make_prefill_step(cfg, device, s_max=s_max,
                                     placed=placed)
    decode = make_decode_step(cfg, device, placed=placed)
    say(f"arch={cfg.name} mesh={args.mesh} {where} device={device} "
        f"requests={args.requests} max_batch={B} prompt_len={T} "
        f"gen={args.gen} publish_every={args.publish_every}"
        + (f" publish_ratio={args.publish_ratio} resync_every="
           f"{args.resync_every}" if streaming else ""), flush=True)

    rng = np.random.default_rng(args.seed)
    queue = [int(rng.integers(max(1, args.gen // 2), args.gen + 1))
             for _ in range(args.requests)]
    timer = _Timer(device)
    if placed is not None:
        placed.timer = timer
    waves_tokens = []
    done = tokens_out = slot_steps = slot_busy = 0
    deltas = resyncs = wire_bits = decode_steps = 0
    probe_s = 0.0

    def watch(wave, step, logits):
        nonlocal probe_s
        if on_logits is not None:
            tp = time.time()
            on_logits(wave, step, logits)
            probe_s += time.time() - tp

    t_start = time.time()
    wave = 0
    while queue:
        admit, queue = queue[:args.max_batch], queue[args.max_batch:]
        nact = len(admit)
        gens = admit + [0] * (B - nact)     # padded slots generate nothing
        wave_gen = max(admit)
        key, pk = prng.split(key)
        if cfg.frontend == "embeds":
            prompt = prng.normal(pk, (B, T, cfg.d_model), device=device)
        else:
            prompt = prng.randint(pk, (B, T), 0, cfg.vocab_size,
                                  device=device)
        t0 = timer.mark()
        logits, cache = prefill_step(params, prompt)
        timer.add("prefill", t0)
        watch(wave, 0, logits)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks = [tok]
        tokens_out += sum(1 for g in gens if g >= 1)
        for i in range(wave_gen - 1):
            if streaming and decode_steps % args.publish_every == 0:
                msg = None
                if lead:
                    t0 = timer.mark()
                    trainer = drift(trainer, decode_steps)
                    timer.add("drift", t0)
                    t0 = timer.mark()
                    pub_state, msg = publish(pub_state, trainer, layout,
                                             pub_config, pub_key,
                                             resync_every=args.resync_every)
                    kind = "resync" if msg.kind == RESYNC else "delta"
                    timer.add(f"publish_{kind}", t0)
                if placed is not None:
                    t0 = timer.mark()
                    msg = _broadcast_message(wire, msg, layout,
                                             deltas + resyncs,
                                             args.resync_every, device)
                    timer.add("broadcast", t0)
                kind = "resync" if msg.kind == RESYNC else "delta"
                wire_bits += message_bits(msg)
                t0 = timer.mark()
                if msg.kind == RESYNC and placed is not None:
                    params = resync_pieces(params, layout, _broadcast_leaves(
                        wire, msg, layout, device), placed)
                    resyncs += 1
                elif msg.kind == RESYNC:
                    params = apply_resync(params, layout, msg.bucket)
                    resyncs += 1
                else:
                    params = apply_delta(params, msg.values, msg.indices)
                    deltas += 1
                timer.add(f"apply_{kind}", t0)
                if probe is not None:
                    tp = time.time()
                    extra = {} if placed is None else {"placed": placed}
                    probe("publish", msg=msg, layout=layout,
                          state=pub_state, trainer=trainer, replica=params,
                          **extra)
                    probe_s += time.time() - tp
            t0 = timer.mark()
            logits, cache = decode(params, cache, T + i, tok)
            timer.add("decode", t0)
            watch(wave, i + 1, logits)
            if args.temperature > 0:
                key, sk = prng.split(key)
                tok = prng.categorical(sk, logits[:, -1] / args.temperature
                                       )[:, None]
            else:
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            toks.append(tok)
            decode_steps += 1
            emitted = sum(1 for g in gens if g >= i + 2)
            tokens_out += emitted
            slot_busy += emitted
            slot_steps += B
        waves_tokens.append(torch.cat(toks, dim=1))
        done += nact
        wave += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t_start - probe_s

    out = {"tokens": [t.cpu() for t in waves_tokens], "done": done,
           "requests": args.requests, "waves": wave,
           "tokens_out": tokens_out, "decode_steps": decode_steps,
           "deltas": deltas, "resyncs": resyncs, "wire_bits": wire_bits,
           "slot_util": slot_busy / max(1, slot_steps), "seconds": dt,
           "tok_s": tokens_out / max(dt, 1e-9), "times": timer.ms()}
    if streaming:
        out["wire_mib"] = wire_bits / 8 / 2 ** 20
    if streaming and lead:
        # the staleness gap is the delta stream's residual
        gap = norm(pub_state["resid"])
        out["staleness"] = gap
        say(f"stream: {deltas} deltas + {resyncs} resyncs, "
            f"{wire_bits / 8 / 2 ** 20:.3f} MiB on the wire, "
            f"staleness |resid| = {gap:.3e}")
    say(f"serve: {done}/{args.requests} requests in {wave} waves, "
        f"{tokens_out} tokens in {dt:.2f}s "
        f"({out['tok_s']:.1f} tok/s), "
        f"slot utilization {out['slot_util']:.2f}", flush=True)
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
