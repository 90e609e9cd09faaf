"""Where one training step's time goes on the card.

    python -m repro_torch.launch.profile --arch llama3.2-1b \\
        --density-policy none --steps 3 --batch 8 --seq 128

Runs the train step's three phases — loss + gradients by autograd,
``aggregate_bucketed`` (pack, fused EF compression, decode), the
optimizer — with CUDA events between them, for ``--steps`` steps after
one warm-up step, and prints each phase's median ms.  Then it traces one
more step with ``torch.profiler`` and prints the device time by kernel
name, the kernel count, and the device's idle share of that step's wall
time.  The last line is one JSON object with all of it.  Needs a GPU.
"""
from __future__ import annotations

import json
import statistics
import sys
import time


def main(argv=None) -> int:
    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.compressors import get_compressor
    from repro_torch.data import batch_for
    from repro_torch.dist import aggregate
    from repro_torch.dist.layout import build_layout
    from repro_torch.launch.train import _require_slice1, parse_args
    from repro_torch.models import init_params, loss_fn
    from repro_torch.optim import adamw, sgd_momentum
    from repro_torch.train import init_train_state

    args = parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a GPU")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    _require_slice1(args, cfg)
    dev = torch.device("cuda")
    params = init_params(cfg, args.seed, dev)
    comp = CompressionConfig(compressor=args.compressor, ratio=args.ratio,
                             backend=args.backend)
    layout = build_layout(params, 1, args.ratio,
                          get_compressor(args.compressor))
    opt = sgd_momentum(0.9) if args.optimizer == "sgd" else adamw()
    state = init_train_state(params, opt, workers=1, model_size=1,
                             compression=comp, layout=layout)
    leaves, td = tree.flatten(params)

    def step(i, ev):
        batch = batch_for(cfg, i, global_batch=args.batch, seq_len=args.seq,
                          seed=args.seed, device=dev)
        ev[0].record()
        ps = [p.detach().requires_grad_(True) for p in leaves]
        loss, _ = loss_fn(tree.unflatten(td, ps), cfg, batch)
        grads = tree.unflatten(td, list(torch.autograd.grad(loss, ps)))
        ev[1].record()
        res = aggregate.aggregate_bucketed(grads, state["resid"][0], layout,
                                           comp)
        ev[2].record()
        opt.update(params, state["opt"], res.agg, args.lr)
        ev[3].record()

    phases = ("forward_backward", "aggregate", "optimizer", "step")
    times = {p: [] for p in phases}
    for i in range(args.steps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        step(i, ev)
        torch.cuda.synchronize()
        if i == 0:
            continue            # warm-up: Triton JIT, cuBLAS handles
        for j, p in enumerate(phases[:3]):
            times[p].append(ev[j].elapsed_time(ev[j + 1]))
        times["step"].append(ev[0].elapsed_time(ev[3]))
    med = {p: statistics.median(v) for p, v in times.items()}
    print("phase medians (ms): " + ", ".join(f"{p} {v:.2f}"
                                              for p, v in med.items()))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(args.steps + 1, ev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue            # host-side ops; their kernels are listed
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt and dt > 0:
            kernels.append((e.key, dt / 1e3, e.count))
    kernels.sort(key=lambda x: -x[1])
    busy = sum(k[1] for k in kernels)
    print(f"profiled step: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"(idle share {1 - busy / wall_ms:.3f}), {len(kernels)} kernel "
          "names")
    for name, ms, n in kernels[:25]:
        print(f"  {ms:9.3f} ms  x{n:<5d} {name[:100]}")
    print(json.dumps({"arch": cfg.name, "batch": args.batch,
                      "seq": args.seq, "phase_ms": med,
                      "profiled_wall_ms": wall_ms, "device_busy_ms": busy,
                      "top_kernels": kernels[:25],
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
