"""Metrics by name: ``perfbench/metrics/<name>.py`` holds a reader
``read(run) -> number or None`` for each metric ``BENCHMARK.json``
lists; a reader that finds nothing to read returns None and the metric
is left out of the line."""
from __future__ import annotations

import importlib.util
import os

from perfbench.bench.spec import ROOT


def reader(name: str, root: str = ROOT):
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def collect(entries: list, run, root: str = ROOT) -> dict:
    out = {}
    for m in entries:
        v = reader(m["name"], root)(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
