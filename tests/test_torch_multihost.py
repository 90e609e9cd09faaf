"""The port's multi-process legs (``repro_torch.launch.multihost``) in 2
gloo processes on the CPU, launched as ``torchrun`` launches them (each
process given ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``).

``coordinate``: every rank prints ``COORDINATE OK p<rank>`` and a
coherent report.  ``validate``: the report has the reference's keys, and
its decision is ``dist.tuner.choose_strategy``'s on the topology it
measured, field for field.  No timing ratio is asserted here (``--factor
inf --loose-factor inf``): on a shared host the CPU's collectives are
too unsteady for a suite; the card's ratios are asserted by
``chip_smoke.py`` phase 13c at the reference's factors.
"""
import json
import os
import socket
import subprocess
import sys

import torch

from repro_torch.dist import tuner
from repro_torch.launch.multihost import _validate_layout
from repro_torch.launch.topo import Topology

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(args, world=2) -> list:
    port = str(_free_port())
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=SRC, RANK=str(r),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.multihost",
             "--device", "cpu"] + args, env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def test_coordinate_leg_in_two_gloo_processes():
    logs = _launch(["--mode", "coordinate"])
    for rank, log in enumerate(logs):
        assert f"COORDINATE OK p{rank}" in log
        line = next(ln for ln in log.splitlines()
                    if ln.startswith(f"coordinate p{rank}: "))
        rep = json.loads(line.split(": ", 1)[1])
        assert rep["process_id"] == rep["process_index"] == rank
        assert rep["process_count"] == 2 and rep["global_devices"] == 2
        assert rep["backend"] == "gloo" and rep["platform"] == "cpu"
        assert rep["rank_sum"] == 3


def test_validate_leg_decides_as_the_tuner_on_its_topology(tmp_path):
    out = str(tmp_path / "report.json")
    logs = _launch(["--mode", "validate", "--reps", "2", "--factor", "inf",
                    "--loose-factor", "inf", "--json", out])
    assert "VALIDATE OK mesh=2x1" in logs[0] and "backend=gloo" in logs[0]
    with open(out) as f:
        rep = json.load(f)
    assert set(rep) == {"mesh", "topology", "decision", "pair_bytes",
                        "factor", "loose_factor", "strategies",
                        "predicted_order", "measured_order"}
    layout = _validate_layout(0.05)
    assert rep["pair_bytes"] == layout.pair_bits(None) / 8.0
    topo = Topology.from_dict(rep["topology"])
    assert topo.name == "measured" and topo.hardware.name == "measured-cpu"
    want = tuner.choose_strategy(layout, [("data", 2)], topo)
    assert rep["decision"] == json.loads(json.dumps(want.to_dict()))
    assert [r["strategy"] for r in rep["strategies"]] == list(
        want.considered)
    for r in rep["strategies"]:
        assert r["measured_s"] > 0 and r["ratio"] >= 1.0
    assert sorted(rep["measured_order"]) == sorted(rep["predicted_order"])


def test_multihost_needs_torchrun(monkeypatch):
    import pytest

    from repro_torch.launch import multihost
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        multihost.main(["--mode", "coordinate", "--device", "cpu"])
    assert torch.distributed.is_initialized() is False


def test_auto_under_torchrun_decides_alike_and_trains_as_named(tmp_path):
    """``--strategy auto`` without ``--topology`` in 2 gloo processes:
    the topology is measured over the process-group wire and rank 0's is
    broadcast, so both ranks decide alike and finish.  At W = 2
    ``allgather`` and ``gtopk`` price the same and the tie rank picks
    ``allgather`` on any link, so the run's losses and final state are
    those of ``allgather`` with every worker in one process, bitwise."""
    import numpy as np

    from repro_torch.launch import train as cli
    port = str(_free_port())
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=SRC, RANK=str(r), WORLD_SIZE="2",
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "_torch_dist_pg.py"),
             str(tmp_path), "cpu", f"auto:2x1:{port}"], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert "tuner: topology=measured axes={'data': 2} -> strategy=" \
        "allgather" in logs[0]
    assert "strategy=allgather(auto)" in logs[0]
    with open(tmp_path / "auto-2x1.json") as f:
        recs = json.load(f)
    local = tmp_path / "local.npz"
    want = cli.run(["--arch", "llama3.2-1b", "--smoke", "--density-policy",
                    "none", "--device", "cpu", "--steps", "2", "--batch",
                    "4", "--seq", "16", "--mesh", "2x1", "--host-devices",
                    "2", "--strategy", "allgather", "--checkpoint",
                    str(local)])
    assert [r["loss"] for r in recs] == [r["loss"] for r in want]
    with np.load(local) as a, np.load(tmp_path / "auto-2x1.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].tobytes() == b[key].tobytes(), key
