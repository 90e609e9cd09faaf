"""One of two gloo processes of a tiny two-worker cell on the CPU (the
four-card cell's path at its smallest); prints rank 0's result line.

    python _pb_two_workers.py <root> <workload> <fault or ->"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from perfbench.bench import env  # noqa: E402

env.prepare()


def main():
    import torch.distributed as dist

    from perfbench.bench import launch
    from perfbench.bench.cell import run_process
    root, workload, fault = sys.argv[1], sys.argv[2], sys.argv[3]
    me = launch.my_rank()
    if me is None:
        port, kids = launch.start(2)
        rank, world = 0, 2
    else:
        (rank, world, port), kids = me, []
    launch.init(rank, world, port, backend="gloo")
    rc = run_process(workload, 2 ** 31 + 99, 0.5, False, t_start=0.0,
                     rank=rank, world=world, device="cpu", root=root,
                     fault=None if fault == "-" else fault)
    dist.destroy_process_group()
    return launch.finish(kids, rc != 0) or rc


if __name__ == "__main__":
    sys.exit(main())
