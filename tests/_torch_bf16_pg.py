"""Subprocess body for tests/test_torch_bf16.py: one rank of a two-process
gloo run of the bf16 llama3.2-1b smoke model (bf16 params and
activations, a bf16 residual, fused Gaussian-k at 0.01, ``--mesh 2x1``,
2 steps, bucketed or chunked), and the same two workers on ``LocalWire``
in one process (:func:`run_steps` with ``wire=None``).  ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` come from the
environment; rank ``r`` writes its losses and the bits of its params and
residual row to ``<out>/rank<r>.json``.

    RANK=0 WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
        python tests/_torch_bf16_pg.py OUT CHUNKS
"""
import dataclasses
import json
import os
import sys

import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core.compression import CompressionConfig
from repro_torch.data import batch_for
from repro_torch.dist.layout import build_layout
from repro_torch.dist.wire import (LocalWire, ProcessGroupWire,
                                   init_process_group)
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models import init_params
from repro_torch.optim import constant, sgd_momentum
from repro_torch.train import init_train_state, make_train_step

MESH = "2x1"


def run_steps(chunks: int, wire=None, steps: int = 2):
    """Train ``steps`` steps on ``wire`` (``None``: both workers on a
    ``LocalWire`` here); returns the losses and the final state."""
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    wire = wire or LocalWire(parse_mesh(MESH))
    params = init_params(cfg, 0, "cpu")
    comp = CompressionConfig(compressor="gaussiank", ratio=0.01,
                             chunks=chunks)
    layout = build_layout(params, 1, comp)
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=wire.local_workers,
                             model_size=1, compression=comp, layout=layout,
                             resid_dtype=torch.bfloat16)
    step = make_train_step(cfg, MESH, opt, constant(0.1), compression=comp,
                           layout=layout, wire=wire)
    losses = []
    for i in range(steps):
        b = batch_for(cfg, i, global_batch=8, seq_len=32, device="cpu")
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, state


def main(out: str, chunks: int) -> None:
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    init_process_group("gloo", rank=rank, world_size=2,
                       init_method="tcp://{}:{}".format(
                           os.environ["MASTER_ADDR"],
                           os.environ["MASTER_PORT"]))
    try:
        losses, state = run_steps(chunks, ProcessGroupWire(parse_mesh(MESH)))
    finally:
        torch.distributed.destroy_process_group()
    resid = state["resid"][0]
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"losses": losses, "resid_dtype": str(resid.dtype),
                   "resid": resid.view(torch.uint16).numpy().tobytes().hex(),
                   "params": [x.view(torch.uint16).numpy().tobytes().hex()
                              for x in tree.leaves(state["params"])]}, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
