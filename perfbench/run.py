"""The benchmark's entry:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints one JSON line (the contract's
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` and,
traced, ``breakdown``, then ``check``) as the last line of standard
output, and the numbers compared beside their limits as the last lines
of standard error.  A cell on several cards starts one process a card.
Exits non-zero, printing no result, without as many cards as the cell
asks for."""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench.bench import env  # noqa: E402

T_START = env.process_start()
env.prepare()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench.bench import launch
    from perfbench.bench.cell import run_process
    from perfbench.bench.spec import load_cell

    chips = load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); {seen} visible",
              file=sys.stderr)
        return 2
    me = launch.my_rank()
    if me is not None:
        rank, world, port = me
        launch.init(rank, world, port)
        try:
            return run_process(args.workload, args.seed, args.seconds,
                               bool(args.trace), t_start=T_START,
                               rank=rank, world=world)
        finally:
            launch.close()
    if chips == 1:
        return run_process(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_start=T_START)
    port, kids = launch.start(chips)
    rc, failed = 1, True
    try:
        launch.init(0, chips, port)
        rc = run_process(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=T_START, world=chips)
        failed = rc != 0
    finally:
        launch.close()
        rc = launch.finish(kids, failed) or rc
    return rc


if __name__ == "__main__":
    sys.exit(main())
