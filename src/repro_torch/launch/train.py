"""Training entry point of the port (port of ``repro/launch/train.py``).

  python -m repro_torch.launch.train --arch llama3.2-1b \\
      --density-policy none --steps 3 --batch 8 --seq 128

Same flags as the JAX trainer, plus ``--device {cuda,cpu}`` (default
``cuda``).  Without a GPU the trainer exits with an error unless
``--device cpu`` is given; it never drops to the CPU by itself.  The
mesh defaults to ``1x1``.  The port trains fixed-k with the
``bucketed`` pipeline and the ``allgather`` wire on one card, with
``--compressor`` ``topk``, ``gaussiank``, ``gaussiank2``, ``histk``
(``--backend fused``: K1 with its histogram and K3; ``reference``: the
K4d histogram and K4c compaction) or ``trimmedk`` (plain torch, the
reference backend).  Every flag value it does not carry raises an error
naming the slice that ports it: other meshes or strategies, the
key-sampled compressors, an adaptive ``--density-policy`` (llama3.2-1b's
config defaults to ``variance``, so pass ``none``),
``--global-k-policy``, ``--chunks > 1``, ``--publish-every``,
``--checkpoint``/``--resume``, ``--pipeline perleaf``, and any value but
the default of the flags only those features read, such as
``--density-floor``, ``--host-devices`` or ``--topology``.
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
                    help="none|topk|gaussiank|gaussiank2|histk|trimmedk "
                         "(randk|dgck|rtopk: a later slice)")
    ap.add_argument("--ratio", type=float, default=0.001)
    ap.add_argument("--strategy", default="allgather",
                    choices=["allgather", "gtopk", "hierarchical",
                             "hier_gtopk", "auto"])
    ap.add_argument("--hierarchical", action="store_true",
                    help="deprecated alias for --strategy hierarchical")
    ap.add_argument("--topology", default="")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "fused", "reference"],
                    help="compression pipeline: the fused Hopper kernels "
                         "(their plain versions on --device cpu) or the "
                         "torch reference")
    ap.add_argument("--pipeline", default="bucketed",
                    choices=["bucketed", "perleaf"])
    ap.add_argument("--chunks", type=int, default=1)
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
    ap.add_argument("--mesh", default="1x1", help="DxM or PxDxM")
    ap.add_argument("--host-devices", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--resume", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to train; cuda needs a GPU")
    return ap


def parse_args(argv=None):
    return _parser().parse_args(argv)


# compressors whose default --density-policy comes from the arch config
# (the reference's core.adaptk.DYNAMIC_COMPRESSORS)
_DYNAMIC = ("topk", "gaussiank", "gaussiank2", "histk", "trimmedk", "rtopk")

# flags that only a later slice reads -> the LATER key of that slice; any
# value but the default raises rather than being ignored
_LATER_FLAGS = {
    "host_devices": "mesh", "topology": "auto",
    "density_floor": "density_policy", "density_ceil": "density_policy",
    "density_ema": "density_policy", "density_warmup": "density_policy",
    "density_warmup_mult": "density_policy",
    "global_k_ema": "global_k", "global_k_floor": "global_k",
    "publish_ratio": "publish", "resync_every": "publish",
}


def _require_slice1(args, cfg) -> None:
    """Raise for every flag value this slice does not carry."""
    from repro_torch.core.compressors import get_compressor
    from repro_torch.slices import not_ported
    from repro_torch.train.step import mesh_sizes

    mesh_sizes(tuple(int(x) for x in args.mesh.split("x")))
    strategy = "hierarchical" if args.hierarchical else args.strategy
    if strategy != "allgather":
        raise not_ported(f"--strategy {strategy}", strategy)
    if args.compressor != "none":
        get_compressor(args.compressor)
    pol = args.density_policy
    if not pol and args.compressor in _DYNAMIC:
        pol = cfg.density_policy
    if pol and pol != "none" and args.compressor != "none":
        raise not_ported(
            f"adaptive --density-policy {pol} (the {cfg.name} default is "
            f"{cfg.density_policy or 'fixed-k'}; pass --density-policy "
            "none for fixed-k)", "density_policy")
    if args.global_k_policy != "none":
        raise not_ported("--global-k-policy", "global_k")
    if args.chunks != 1:
        raise not_ported("--chunks > 1", "chunks")
    if args.publish_every:
        raise not_ported("--publish-every", "publish")
    if args.checkpoint or args.resume:
        raise not_ported("--checkpoint/--resume", "checkpoint")
    if args.pipeline != "bucketed":
        raise not_ported("--pipeline perleaf", "perleaf")
    defaults = _parser()
    for dest, key in _LATER_FLAGS.items():
        if getattr(args, dest) != defaults.get_default(dest):
            raise not_ported(f"--{dest.replace('_', '-')}", key)


def run(argv=None, *, probe: Optional[Callable] = None) -> list:
    """Parse ``argv``, train, print one line per logged step and return
    the per-step records ``[{"step", "loss", "ms", ...metrics}]``.
    ``probe`` reaches ``dist.aggregate.aggregate_bucketed``."""
    args = parse_args(argv)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.core.compressors import get_compressor
    from repro_torch.data import batch_for
    from repro_torch.dist.layout import build_layout
    from repro_torch.models import init_params
    from repro_torch.models.model import require_dense
    from repro_torch.optim import (adamw, constant, cosine, sgd_momentum,
                                   step_decay)
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    require_dense(cfg)
    _require_slice1(args, cfg)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no GPU is visible; pass --device "
                         "cpu to train on the CPU")
    device = torch.device(args.device)
    mesh = tuple(int(x) for x in args.mesh.split("x"))

    opt = sgd_momentum(0.9) if args.optimizer == "sgd" else adamw()
    lr_fn = {"constant": lambda: constant(args.lr),
             "cosine": lambda: cosine(args.lr, args.steps),
             "step": lambda: step_decay(args.lr, 0.1,
                                        max(args.steps // 2, 1))}[
        args.schedule]()
    params = init_params(cfg, args.seed, device)
    layout = None
    if args.compressor != "none":
        layout = build_layout(params, 1, args.ratio,
                              get_compressor(args.compressor))
    config = CompressionConfig(compressor=args.compressor, ratio=args.ratio,
                               backend=args.backend)
    state = init_train_state(params, opt, workers=1, model_size=1,
                             compression=config, layout=layout)
    step = make_train_step(cfg, mesh, opt, lr_fn, compression=config,
                           layout=layout, probe=probe)
    print(f"arch={cfg.name} compressor={args.compressor} ratio={args.ratio} "
          f"strategy=allgather backend={args.backend} mesh={args.mesh} "
          f"pipeline={args.pipeline} chunks=1 density_policy=fixed-k "
          f"device={device} steps={args.steps}", flush=True)
    records = []
    t0 = time.time()
    for i in range(args.steps):
        batch = batch_for(cfg, i, global_batch=args.batch, seq_len=args.seq,
                          seed=args.seed, device=device)
        ts = time.perf_counter()
        state, m = step(state, batch)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - ts) * 1e3
        rec = {"step": i, "ms": ms}
        rec.update({k: float(v) for k, v in m.items()})
        records.append(rec)
        if i % args.log_every == 0 or i == args.steps - 1:
            comm = ""
            if "comm_bits_sparse" in m:
                r = rec["comm_bits_sparse"] / rec["comm_bits_dense"]
                comm = (f" comm_frac={r:.4f} coll="
                        f"{int(rec['collectives_per_step'])}"
                        f" density={rec['density']:.6f}")
            print(f"step {i:5d} loss={rec['loss']:.4f} lr={rec['lr']:.4g}"
                  f"{comm} step_ms={ms:.1f} ({time.time() - t0:.1f}s)",
                  flush=True)
    return records


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
