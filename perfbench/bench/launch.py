"""Several cards: this process is rank 0 and starts one more process of
the same command a further card, each with the rank, the world and a
free port for the rendezvous in its environment; it waits for every one
and ends any still running when it fails."""
from __future__ import annotations

import os
import socket
import subprocess
import sys

RANK, WORLD, PORT = "PB_RANK", "PB_WORLD", "PB_PORT"


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def my_rank():
    """``(rank, world, port)`` of a started process, or None in the
    first."""
    if RANK not in os.environ:
        return None
    return (int(os.environ[RANK]), int(os.environ[WORLD]),
            int(os.environ[PORT]))


def start(world: int, argv=None):
    """Starts ranks 1..world-1 of ``argv`` (this command by default);
    returns ``(port, children)``."""
    port = free_port()
    argv = argv or [sys.executable] + sys.argv
    kids = []
    for r in range(1, world):
        e = dict(os.environ, **{RANK: str(r), WORLD: str(world),
                                PORT: str(port)})
        kids.append(subprocess.Popen(argv, env=e,
                                     stdout=subprocess.DEVNULL))
    return port, kids


def init(rank: int, world: int, port: int, backend: str = "nccl") -> None:
    """The process group over NCCL, one card a rank (gloo: the CPU
    rehearsal's)."""
    from repro_torch.dist.wire import init_process_group
    init_process_group(backend, rank=rank, world_size=world,
                       local_rank=rank, local_world_size=world,
                       init_method=f"tcp://127.0.0.1:{port}")


def close() -> None:
    """Ends this rank's process group, if it has one."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def finish(kids, failed: bool, timeout: float = 120.0) -> int:
    """Waits for the started ranks (ends them first when this one
    failed); the worst exit code."""
    rc = 0
    for k in kids:
        if failed:
            k.terminate()
        try:
            code = k.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            k.kill()
            code = k.wait()
        rc = rc or code
    return rc
