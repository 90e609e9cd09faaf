"""Shared by the benchmark's CPU tests: a checkout-like root with tiny
cells, made of files only, beside the real harness (the ``root``
fixture, imported by the tests that use it)."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
if os.path.join(REPO, "src") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "src"))

TINY_MOE = {"name": "tiny-moe", "arch_type": "moe", "num_layers": 2,
            "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "d_ff": 96,
            "vocab_size": 256, "block_pattern": ["attn"],
            "ffn_pattern": ["moe"], "rope_theta": 10000.0, "num_experts": 4,
            "experts_per_token": 2, "num_shared_experts": 1, "moe_d_ff": 32,
            "capacity_factor": 1.25, "router_aux_coef": 0.01,
            "param_dtype": "bfloat16", "activation_dtype": "bfloat16"}
TINY_DENSE = {"name": "tiny-dense", "arch_type": "dense", "num_layers": 2,
              "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "d_ff": 96,
              "vocab_size": 256, "block_pattern": ["attn"],
              "ffn_pattern": ["mlp"], "rope_theta": 10000.0,
              "param_dtype": "bfloat16", "activation_dtype": "bfloat16"}
TRAIN = {"compressor": "gaussiank", "ratio": 0.001, "density": "fixed-k",
         "strategy": "allgather", "chunks": 1, "optimizer": "sgd_momentum",
         "momentum": 0.9, "lr": 0.1, "resid_dtype": "bfloat16",
         "remat": True}
TRAFFIC = {"kind": "train", "seq_len": 32, "batch_per_worker": 2,
           "workers": 1, "ring": 4, "loop": "closed", "profile_after": 1,
           "profile_steps": 2}
LIMITS = {"loss": 5e-4, "grad": 0.6, "resid": 0.01, "update": 0.6}


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def add_cell(root, model, traffic_name="tiny", traffic=None, limits=None,
             train=None):
    """Adds a configuration, a mix and a cell to ``root`` as files and
    entries only; returns the cell's name."""
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    cfg = model["name"]
    _write(os.path.join(root, "perfbench", "configs", cfg + ".json"),
           {"name": cfg, "source": "test", "model": model,
            "train": dict(TRAIN, **(train or {})), "reduced": []})
    _write(os.path.join(root, "perfbench", "traffic", traffic_name + ".json"),
           dict(TRAFFIC, **(traffic or {})))
    name = f"{cfg}.{traffic_name}"
    _write(os.path.join(root, "perfbench", "limits", name + ".json"),
           {"limits": dict(LIMITS, **(limits or {}))})
    if cfg not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({"name": cfg, "source": "test",
                                 "file": f"perfbench/configs/{cfg}.json",
                                 "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": cfg,
                               "traffic": traffic_name, "chips": 1,
                               "why": "test"})
    _write(os.path.join(root, "BENCHMARK.json"), bench)
    return name


@pytest.fixture
def root(tmp_path):
    """A copy of the benchmark's data and readers under ``tmp_path``,
    with the tiny cells added as files; every metric applies to every
    cell there (the real cells' lists dropped)."""
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    _write(str(tmp_path / "BENCHMARK.json"), bench)
    shutil.copytree(os.path.join(REPO, "perfbench", "metrics"),
                    tmp_path / "perfbench" / "metrics")
    add_cell(str(tmp_path), TINY_MOE)
    add_cell(str(tmp_path), TINY_DENSE)
    return str(tmp_path)


def run_cell(root, workload, trace=False, fault=None, seed=2 ** 31 + 77,
             seconds=0.5):
    """The harness's run of ``workload`` on the CPU: ``(rc, line,
    stderr lines)``."""
    import io

    from perfbench.bench import env
    from perfbench.bench.cell import run_process
    env.prepare()
    out, err = io.StringIO(), io.StringIO()
    rc = run_process(workload, seed, seconds, trace,
                     t_start=env.process_start(), device="cpu", fault=fault,
                     root=root, out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), \
        err.getvalue().strip().splitlines()
