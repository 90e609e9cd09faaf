"""Readings for the comparison's limits, on the chip at a cell's own
size (not run by the benchmark's runs):

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \
        --modes program,fp8,half_batch,no_exchange [--out file.jsonl]

For each seed the reference's first steps are the base, and each mode
stands in the program's place: ``program`` is the program's own first
steps (the sound runs that give a limit's lower reading), ``fp8`` the
reference with float8 operands in every product (the control: the
precision below the configuration's bf16), and ``stale``,
``half_batch`` and ``no_exchange`` the program with that fault planted
in its timed path, as the harness's tests plant it.  One JSON line a
seed and mode with each number compared, the worst worker's.  A cell on
several cards starts one process a card, as ``run.py`` does."""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench.bench import env  # noqa: E402

env.prepare()

MODES = ("program", "fp8", "stale", "half_batch", "no_exchange")


def readings_of(mode, cell, seed, device, rank, world):
    import torch

    from perfbench.bench.train import Program
    from perfbench.reference.train import readings
    if mode == "fp8":
        out = readings(cell.config, cell.traffic, seed, device,
                       precision="fp8", rank=rank, world=world)
    else:
        prog = Program(cell, seed, device, rank, world,
                       fault=None if mode == "program" else mode)
        out = prog.first_steps()
        prog.free()
        del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def control(workload, seeds, modes, rank=0, world=1, device=None,
            root=None, write=print):
    import torch

    from perfbench.bench import check
    from perfbench.bench.cell import _gather
    from perfbench.bench.spec import ROOT, load_cell
    from perfbench.reference.train import readings
    cell = load_cell(workload, root or ROOT)
    device = torch.device(device) if device else torch.device("cuda", rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    lines = []
    for seed in seeds:
        ref = readings(cell.config, cell.traffic, seed, device, rank=rank,
                       world=world)
        for mode in modes:
            nums = check.numbers(readings_of(mode, cell, seed, device, rank,
                                             world), ref)
            every = _gather(nums, world)
            line = {"workload": workload, "seed": seed, "mode": mode}
            for n in check.NUMBERS:
                value, leaf = check.worst(every, n)
                line[n] = value
                if leaf:
                    line[n + "_leaf"] = leaf
            lines.append(line)
            if rank == 0:
                write(json.dumps(line))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,fp8")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    modes = args.modes.split(",")
    for m in modes:
        if m not in MODES:
            raise SystemExit(f"unknown mode {m!r}; have {MODES}")

    from perfbench.bench import launch
    from perfbench.bench.spec import load_cell
    chips = load_cell(args.workload).chips
    sink = open(args.out, "a") if args.out else None

    def write(line):
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
    me = launch.my_rank()
    if me is not None:
        rank, world, port = me
        launch.init(rank, world, port)
        try:
            control(args.workload, seeds, modes, rank, world)
        finally:
            launch.close()
        return 0
    if chips == 1:
        control(args.workload, seeds, modes, write=write)
        return 0
    port, kids = launch.start(chips)
    failed = True
    try:
        launch.init(0, chips, port)
        control(args.workload, seeds, modes, 0, chips, write=write)
        failed = False
    finally:
        launch.close()
        rc = launch.finish(kids, failed)
    return rc


if __name__ == "__main__":
    sys.exit(main())
