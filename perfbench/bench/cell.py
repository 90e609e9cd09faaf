"""One process's part of a run: set-up, the first steps, the window,
the reference and the comparison; rank 0 prints the result line."""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import sys
import time
from typing import Optional

import torch

from perfbench.bench import check, env
from perfbench.bench.metrics import collect
from perfbench.bench.probe import Probe
from perfbench.bench.spec import ROOT, load_cell
from perfbench.bench.train import Program, window
from perfbench.reference.train import readings as reference_readings


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: object
    gpu: bool             # a device number is read only from the card
    seconds: float
    trace: bool
    setup_s: float
    peak_bytes: int
    setup_peak_bytes: int  # set-up's peak alone: weights, ring, 3 steps
    step_s: list          # a step's seconds, the slowest rank's
    profiled: list
    window_s: float
    layer_ms: dict        # a layer's ms a step, the slowest rank's
    traces: list          # every rank's trace reduction
    counters: dict
    tokens_per_step: int

    @property
    def model(self) -> dict:
        return self.cell.config["model"]

    @property
    def train(self) -> dict:
        return self.cell.config["train"]

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


def _gather(obj, world: int) -> list:
    if world == 1:
        return [obj]
    import torch.distributed as dist
    out = [None] * world
    dist.all_gather_object(out, obj)
    return out


def _slowest(lists: list) -> list:
    return [max(xs) for xs in zip(*lists)]


def run_process(workload: str, seed: int, seconds: float, trace: bool, *,
                t_start: float, rank: int = 0, world: int = 1,
                device=None, fault: Optional[str] = None,
                root: str = ROOT, out=None, err=None) -> int:
    """Runs this rank's part; rank 0 writes the result line to ``out``
    and the comparison's lines to ``err``.  Returns the exit code."""
    out, err = out or sys.stdout, err or sys.stderr
    cell = load_cell(workload, root)
    device = torch.device(device) if device else torch.device("cuda", rank)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    probe = Probe(device) if trace else None
    program = Program(cell, seed, device, rank, world, probe, fault)
    prog = program.first_steps()
    setup_peak = 0
    if cuda:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    opened = []
    w = window(program, seconds, trace, probe,
               on_open=lambda: opened.append(time.time()))
    setup_s = opened[0] - t_start
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    peak = max(setup_peak, window_peak)
    loaded = env.forbidden_loaded()
    counters = program.counters()
    tokens = (cell.traffic["workers"] * cell.traffic["batch_per_worker"]
              * cell.traffic["seq_len"])
    program.free()
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.time()
    ref = reference_readings(cell.config, cell.traffic, seed, device,
                             rank=rank, world=world)
    ref_s = time.time() - t_ref
    nums = check.numbers(prog, ref)
    loaded = sorted(set(loaded) | set(env.forbidden_loaded()))
    mine = {"w": dataclasses.asdict(w), "nums": nums, "peak": peak,
            "setup_peak": setup_peak, "loaded": loaded}
    every = _gather(mine, world)
    if rank != 0:
        return 0

    bad = sorted({m for e in every for m in e["loaded"]})
    if bad:
        print("forbidden modules loaded: " + ", ".join(bad), file=err)
        return 3
    ws = [e["w"] for e in every]
    run = Run(cell, cuda, seconds, trace, setup_s,
              max(e["peak"] for e in every),
              max(e["setup_peak"] for e in every),
              _slowest([x["step_s"] for x in ws]), ws[0]["profiled"],
              max(x["window_s"] for x in ws),
              {k: _slowest([x["layer_ms"][k] for x in ws])
               for k in ws[0]["layer_ms"]},
              [x["trace"] for x in ws], counters, tokens)
    worst = {n: check.worst([e["nums"] for e in every], n)
             for n in check.NUMBERS}
    correct, lines = check.judge({n: v for n, (v, _) in worst.items()},
                                 cell.limits)
    metrics = collect(cell.per_layer if trace else cell.end_to_end, run,
                      root)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if cuda
                            else "cpu"),
                   "count": world, "memory_peak_bytes": int(run.peak_bytes)}
    result = {"correct": bool(correct), "attempted": len(run.step_s),
              "failed": 0, "metrics": metrics, "device": device_info}
    traces = [t for t in run.traces if t]
    if trace and traces:
        device_info["busy_s"] = statistics.fmean(t["busy_s"] for t in traces)
        device_info["window_s"] = statistics.fmean(t["window_s"]
                                                   for t in traces)
        result["breakdown"] = {"device_ops": traces[0]["device_ops"],
                               "idle_gaps": traces[0]["idle_gaps"]}
    result["check"] = {n: {"value": v, "limit": lim} for n, v, lim in lines}
    print(f"timing setup_s={setup_s:.3f} window_s={run.window_s:.3f} "
          f"steps={len(run.step_s)} median_step_ms="
          f"{1e3 * statistics.median(run.step_s):.3f} "
          f"reference_s={ref_s:.3f}", file=err)
    print(f"memory peak_gib setup={run.setup_peak_bytes / 2 ** 30:.4f} "
          f"all={run.peak_bytes / 2 ** 30:.4f}", file=err)
    for n in check.NUMBERS:
        if n not in cell.limits:
            v, detail = worst[n]
            print(f"reading {n}: {v!r} not compared"
                  + (f" (leaf {detail})" if detail else ""), file=err)
    for n, v, lim in lines:
        detail = worst[n][1]
        print(f"check {n}: {v!r} limit {lim!r}"
              + (f" (leaf {detail})" if detail else ""), file=err)
    if env.forbidden_loaded():
        print("forbidden modules loaded: "
              + ", ".join(env.forbidden_loaded()), file=err)
        return 3
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
