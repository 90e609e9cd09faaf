"""Subprocess body for tests/test_torch_dist.py (gloo) and
tests/test_torch_cuda.py (NCCL): one rank of a ``torchrun``-style
launch of the port's trainer.  ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and ``MASTER_ADDR``
come from the environment; each ``strategy:mesh:port`` argument trains
2 steps on ``DEVICE`` (``cpu``: gloo; ``cuda``: NCCL, a card per rank)
on that mesh with that ``MASTER_PORT``, checkpoints the final state to
``<out>/<strategy>-<mesh>.npz`` and, on rank 0, writes the step records
to ``<out>/<strategy>-<mesh>.json``.  Arguments after ``--`` are added
to every case's trainer flags (``--density-policy variance``, say).

    RANK=0 WORLD_SIZE=2 ... python tests/_torch_dist_pg.py OUT cpu \\
        allgather:2x1:29500 gtopk:2x1:29501 [-- --density-policy variance]
"""
import json
import os
import sys

import torch

from repro_torch.launch import train as cli

COMMON = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1",
          "--density-policy", "none",
          "--steps", "2", "--batch", "4", "--seq", "16", "--log-every", "1"]


def main(out, device, cases):
    torch.set_num_threads(1)
    extra = []
    if "--" in cases:
        cases, extra = (cases[:cases.index("--")],
                        cases[cases.index("--") + 1:])
    for case in cases:
        strategy, mesh, port = case.split(":")
        os.environ["MASTER_PORT"] = port
        name = f"{strategy}-{mesh}"
        recs = cli.run(COMMON + ["--device", device, "--mesh", mesh,
                                 "--strategy", strategy,
                                 "--checkpoint",
                                 os.path.join(out, name + ".npz")]
                      + extra)
        if os.environ["RANK"] == "0":
            with open(os.path.join(out, name + ".json"), "w") as f:
                json.dump(recs, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3:])
