"""Cells by name: ``BENCHMARK.json`` names each workload's configuration
file, traffic file and chips; a limits file per workload holds the
comparison's limits.  Nothing here knows a cell: a new one is new files
and new entries."""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "perfbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    limits: dict          # name -> limit of each number compared
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: str = ROOT,
              bench: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` (or of ``bench``,
    the parsed file), its files read from under ``root``."""
    if not NAME.match(workload):
        raise SystemExit(f"bad workload name {workload!r}")
    bench = bench or _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load(os.path.join(root, "perfbench", "traffic",
                                 w["traffic"] + ".json"))
    limits = _load(os.path.join(root, "perfbench", "limits",
                                workload + ".json"))["limits"]
    if traffic["workers"] != w["chips"]:
        raise SystemExit(f"{workload}: traffic {w['traffic']} has "
                         f"{traffic['workers']} workers, the cell "
                         f"{w['chips']} chips")
    return Cell(workload, int(w["chips"]), config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])


def model_config(config: dict):
    """The port's ModelConfig of a configuration file's ``model``."""
    from repro_torch.models.config import ModelConfig
    m = dict(config["model"])
    for key in ("block_pattern", "ffn_pattern"):
        if key in m:
            m[key] = tuple(m[key])
    return ModelConfig(**m).validate()
