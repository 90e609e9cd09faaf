"""The multi-process legs of the port: coordination and the tuner's
validation (port of ``repro/launch/multihost.py``).  ``torchrun`` spawns
the processes, as the reference's ``tools/launch_multihost.py`` does;
each reads its coordinates from ``wire.torchrun_env()``:

  torchrun --nproc-per-node 2 -m repro_torch.launch.multihost \\
      --mode coordinate [--device cpu]
  torchrun --nproc-per-node 2 -m repro_torch.launch.multihost \\
      --mode validate [--device cpu] [--json report.json]

* ``--mode coordinate`` — each process starts the process group
  (``wire.init_process_group``: NCCL with a card a rank when there are
  enough cards, else gloo) and asserts the launch is coherent: its rank
  and the world size are the environment's, every rank counts one
  device, the group sums every rank's ``rank + 1`` right, and under NCCL
  the cards visible cover ``LOCAL_WORLD_SIZE``.  Prints ``COORDINATE OK
  p<rank>``.
* ``--mode validate`` — a mesh whose data world is the process count
  (``--mesh``, default ``<processes>x1``) over ``ProcessGroupWire``:
  measure the topology (``launch.topo.measure_topology``), price every
  candidate (``dist.tuner.choose_strategy``), time each candidate's bare
  collective pattern (``dist.tuner.measure_wire_pattern``), then assert

  1. the chosen strategy's predicted wire time is within ``--factor``
     (default 2) of its measured time,
  2. every candidate is within ``--loose-factor`` (default 4), and
  3. every pair of candidates whose predictions are more than
     ``--factor`` apart is measured in the same order (a tie-aware
     ranking that never asserts an order the model calls a coin flip).

  Rank 0 prints the rows and ``VALIDATE OK mesh=... chosen=...`` and
  writes the report (the reference's keys) to ``--json``.  Passing
  ``--factor inf --loose-factor inf`` reports without asserting a
  timing.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

__all__ = ["start", "coordination_report", "validate_tuner"]


def start(device: str = "cuda"):
    """Start the process group of a ``torchrun`` launch on ``device``:
    ``(rank, world, local_rank, local_world, torch device)``.  The
    backend is NCCL on the card when this host has a card for every
    local rank, else gloo."""
    import torch

    from repro_torch.dist.wire import init_process_group, torchrun_env

    env = torchrun_env()
    if env is None:
        raise SystemExit("multihost: run under torchrun (RANK and "
                         "WORLD_SIZE are not set)")
    rank, world, local_rank, local_world = env
    cuda = device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no GPU is visible; pass --device "
                         "cpu to run on the CPU")
    backend = ("nccl" if cuda and torch.cuda.device_count() >= local_world
               else "gloo")
    init_process_group(backend, rank=rank, world_size=world,
                       local_rank=local_rank, local_world_size=local_world)
    dev = torch.device(device)
    if cuda:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return rank, world, local_rank, local_world, dev


def coordination_report(rank: int, world: int, local_world: int, device
                        ) -> dict:
    """Assert the process group is coherent; return a summary with the
    reference's keys plus the backend and the card count."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.wire import ProcessGroupWire
    from repro_torch.launch.mesh import parse_mesh

    wire = ProcessGroupWire(parse_mesh(f"{world}x1"))
    one = wire._staged(torch.ones((1,), dtype=torch.int64))
    devices = one.clone()
    dist.all_reduce(devices)
    ranks = wire._staged(torch.tensor([rank + 1], dtype=torch.int64))
    dist.all_reduce(ranks)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    rep = {"process_id": rank, "process_index": dist.get_rank(),
           "process_count": dist.get_world_size(), "local_devices": 1,
           "global_devices": int(devices.item()),
           "platform": "gpu" if device.type == "cuda" else "cpu",
           "backend": dist.get_backend(), "local_world_size": local_world,
           "cards_visible": cards, "rank_sum": int(ranks.item())}
    assert rep["process_index"] == rank, rep
    assert rep["process_count"] == world, rep
    assert rep["global_devices"] == world * rep["local_devices"], rep
    assert rep["rank_sum"] == world * (world + 1) // 2, rep
    if rep["backend"] == "nccl":
        assert cards >= local_world, rep
    return rep


def _validate_layout(ratio: float):
    """The reference's payload: ~2.1M params at ``ratio``, top-k, built
    on the meta device, so the wire dominates scheduling noise."""
    import torch

    from repro_torch.core.compressors import get_compressor
    from repro_torch.dist.layout import build_layout

    params = {k: torch.empty(s, device="meta") for k, s in
              (("a", (1024, 1024)), ("b", (1024, 1024)), ("c", (4096,)))}
    return build_layout(params, 1, ratio, get_compressor("topk"))


def validate_tuner(mesh, wire, *, ratio: float = 0.05, factor: float = 2.0,
                   loose_factor: float = 4.0, reps: int = 7,
                   device="cuda") -> dict:
    """Predicted against measured wire time over ``wire`` (the module
    docstring, mode ``validate``); returns the report, raises
    AssertionError with the numbers on a violation.  Every rank runs it
    (the measurements are collective) and gets the same report."""
    from repro_torch.dist import tuner
    from repro_torch.launch import topo as topo_mod
    from repro_torch.launch.train import data_axes_pairs

    layout = _validate_layout(ratio)
    pair_bytes = layout.pair_bits(None) / 8.0
    topo = topo_mod.measure_topology(mesh, wire, reps=reps, device=device)
    decision = tuner.choose_strategy(layout, data_axes_pairs(mesh), topo)

    rows = []
    for p in decision.predictions:
        meas = tuner.measure_wire_pattern(mesh, wire, pair_bytes, p.strategy,
                                          reps=reps, device=device)
        ratio_pm = max(p.wire_s / meas, meas / p.wire_s)
        rows.append({"strategy": p.strategy, "predicted_s": p.wire_s,
                     "measured_s": meas, "ratio": ratio_pm})
    by_strategy = {r["strategy"]: r for r in rows}
    rep = {
        "mesh": "x".join(str(n) for n in mesh.shape),
        "topology": topo.to_dict(),
        "decision": decision.to_dict(),
        "pair_bytes": pair_bytes,
        "factor": factor,
        "loose_factor": loose_factor,
        "strategies": rows,
        "predicted_order": [p.strategy for p in sorted(
            decision.predictions, key=lambda p: p.wire_s)],
        "measured_order": [r["strategy"] for r in sorted(
            rows, key=lambda r: r["measured_s"])],
    }
    chosen = by_strategy[decision.strategy]
    assert chosen["ratio"] <= factor, (
        f"chosen strategy {decision.strategy!r}: predicted "
        f"{chosen['predicted_s']*1e6:.1f}us vs measured "
        f"{chosen['measured_s']*1e6:.1f}us — ratio {chosen['ratio']:.2f} "
        f"exceeds {factor}", rep)
    for r in rows:
        assert r["ratio"] <= loose_factor, (
            f"{r['strategy']}: predicted/measured ratio {r['ratio']:.2f} "
            f"exceeds loose factor {loose_factor}", rep)
    violations = [(a["strategy"], b["strategy"]) for a in rows for b in rows
                  if a["predicted_s"] * factor < b["predicted_s"]
                  and a["measured_s"] >= b["measured_s"]]
    assert not violations, (
        f"predicted ranking != measured ranking for separated pairs: "
        f"{violations}", rep)
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["coordinate", "validate"],
                    required=True)
    ap.add_argument("--mesh", default="",
                    help="DxM or PxDxM (default: <processes>x1)")
    ap.add_argument("--ratio", type=float, default=0.05)
    ap.add_argument("--factor", type=float, default=2.0)
    ap.add_argument("--loose-factor", type=float, default=4.0)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default="",
                    help="write the validate-mode report here (rank 0)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from repro_torch.dist.wire import ProcessGroupWire
    from repro_torch.launch.mesh import parse_mesh

    rank, world, _, local_world, dev = start(args.device)
    try:
        if args.mode == "coordinate":
            rep = coordination_report(rank, world, local_world, dev)
            print(f"coordinate p{rank}: {json.dumps(rep)}", flush=True)
            print(f"COORDINATE OK p{rank}", flush=True)
            return 0
        mesh = parse_mesh(args.mesh or f"{world}x1")
        wire = ProcessGroupWire(mesh)
        rep = validate_tuner(mesh, wire, ratio=args.ratio,
                             factor=args.factor,
                             loose_factor=args.loose_factor, reps=args.reps,
                             device=dev)
        if rank == 0:
            for r in rep["strategies"]:
                print(f"  {r['strategy']}: predicted "
                      f"{r['predicted_s']*1e6:.1f}us measured "
                      f"{r['measured_s']*1e6:.1f}us ratio {r['ratio']:.2f}")
            print(f"  predicted order: {rep['predicted_order']}")
            print(f"  measured order:  {rep['measured_order']}")
            if args.json:
                os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
                with open(args.json, "w") as f:
                    json.dump(rep, f, indent=1)
            print(f"VALIDATE OK mesh={rep['mesh']} "
                  f"chosen={rep['decision']['strategy']} "
                  f"backend={wire.backend}", flush=True)
        return 0
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
