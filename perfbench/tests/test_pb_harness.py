"""The harness end to end on the CPU at tiny sizes: cells, mixes and
metrics found by name from files alone, the result line's keys, and
``correct`` failing under each fault a training cell can have."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench.tests._pb_cells import (REPO, TINY_DENSE, TINY_MOE, add_cell,
                                      root, run_cell)  # noqa: F401

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(root, trace):
    rc, line, err = run_cell(root, "tiny-dense.tiny", trace=trace)
    assert rc == 0
    keys = list(line)
    assert keys[-1] == "check"
    assert keys[:-1] == KEYS + (["breakdown"] if trace else [])
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # on the CPU no device metric is read: none but the host's
        assert set(line["metrics"]) == set()
    else:
        # on the CPU no device memory is read, so no peak
        assert set(line["metrics"]) == {"tokens_per_s", "step_ms_p95",
                                        "setup_s"}
    # the numbers compared, beside their limits, end standard error
    assert [ln.split(":")[0] for ln in err[-4:]] == [
        "check loss", "check grad", "check resid", "check update"]
    for name, entry in line["check"].items():
        assert set(entry) == {"value", "limit"}


def test_limits_file_names_the_numbers(root):
    """A cell compares the numbers its limits file names, and prints the
    others before them, not compared; a stale step fails the median
    leaf's change as it fails the worst leaf's (a leaf under the median
    reads its share of the median, not 1)."""
    name = add_cell(root, dict(TINY_DENSE, name="tiny-median"))
    path = os.path.join(root, "perfbench", "limits", name + ".json")
    lim = json.load(open(path))
    lim["limits"]["update_median"] = lim["limits"].pop("update")
    with open(path, "w") as f:
        json.dump(lim, f)
    rc, line, err = run_cell(root, name)
    assert rc == 0 and line["correct"] is True
    assert list(line["check"]) == ["loss", "grad", "resid", "update_median"]
    assert err[-5].startswith("reading update: ")
    rc, line, _ = run_cell(root, name, fault="stale")
    assert rc == 0 and line["correct"] is False
    assert line["check"]["update_median"]["value"] > 0.5


def test_added_files_only(root):
    """A configuration, a mix and a per-layer metric added as files and
    entries, with no edit to a file that is there, are found and run."""
    model = dict(TINY_DENSE, name="tiny-deeper", num_layers=3)
    name = add_cell(root, model, traffic_name="tiny-b1",
                    traffic={"batch_per_worker": 1, "seq_len": 48})
    with open(os.path.join(root, "perfbench", "metrics",
                           "tokens_per_step.py"), "w") as f:
        f.write("def read(run):\n    return run.tokens_per_step\n")
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["per_layer"].append({"name": "tokens_per_step", "unit": "tokens",
                               "better": "higher", "source": "host_clock",
                               "layer": "train step and models",
                               "moves": "tokens_per_s",
                               "workloads": [name]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    rc, line, _ = run_cell(root, name, trace=True)
    assert rc == 0 and line["correct"] is True
    assert line["metrics"]["tokens_per_step"]["value"] == 48


@pytest.mark.parametrize("fault", ["stale", "half_batch"])
@pytest.mark.parametrize("cell", ["tiny-moe.tiny", "tiny-dense.tiny"])
def test_faults_fail(root, cell, fault):
    """The timed path broken underneath: a step that returns its state
    unchanged, or half of the batch left out with the mean over the
    rest, and ``correct`` comes out false."""
    rc, line, _ = run_cell(root, cell, fault=fault)
    assert rc == 0
    assert line["correct"] is False


def test_control_readings_through_the_program(root):
    """``control.py`` reads the program's own first steps, the fp8
    control and each fault planted in the program's timed path: the
    first within the limits, every other outside them."""
    from perfbench.bench import check
    from perfbench.control import control
    from perfbench.tests._pb_cells import LIMITS
    lines = control("tiny-dense.tiny", [2 ** 31 + 5],
                    ["program", "fp8", "stale", "half_batch"],
                    device="cpu", root=root, write=lambda line: None)
    ok = {ln["mode"]: check.judge(ln, LIMITS)[0] for ln in lines}
    assert ok == {"program": True, "fp8": False, "stale": False,
                  "half_batch": False}


def test_sound_moe_is_correct(root):
    rc, line, _ = run_cell(root, "tiny-moe.tiny")
    assert rc == 0 and line["correct"] is True


def _bare_copy(tmp_path):
    """A directory holding only BENCHMARK.json and the files under the
    benchmark's paths."""
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    for p in bench["paths"]:
        shutil.copytree(os.path.join(REPO, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__",
                                                      ".cache"))
    return tmp_path


def test_bare_checkout_fails(tmp_path):
    """Without the program beside it the benchmark exits non-zero and
    prints no result, whether or not a card is visible."""
    d = _bare_copy(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys; sys.path.insert(0, '.');"
            "from perfbench.bench import env; env.prepare();"
            "from perfbench.bench.cell import run_process;"
            "sys.exit(run_process('deepseek-moe-16b.train4k-b1', 1, 1.0,"
            " False, t_start=0.0, device='cpu'))")
    p = subprocess.run([sys.executable, "-c", code], cwd=d, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "repro_torch" in p.stderr


def test_no_card_fails(tmp_path):
    """With fewer cards than the cell asks for (none here, or a
    ``CUDA_VISIBLE_DEVICES`` that hides them), no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "deepseek-moe-16b.train4k-b1", "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("fault", [None, "no_exchange", "half_batch"])
def test_two_workers(root, fault):
    """Two workers, one process each over gloo: sound, the run is
    correct; with the exchange between them left out, or half of the
    batch, it is not (at f32, where sound runs agree to round-off)."""
    model = dict(TINY_MOE, name="tiny-moe-f32", param_dtype="float32",
                 activation_dtype="float32")
    name = add_cell(root, model, traffic_name="tiny-dp2",
                    traffic={"workers": 2, "batch_per_worker": 1},
                    train={"resid_dtype": "float32"},
                    limits={n: 1e-4 for n in ("loss", "grad", "resid",
                                              "update")})
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    for w in bench["workloads"]:
        if w["name"] == name:
            w["chips"] = 2
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PB_")}
    p = subprocess.run([sys.executable, os.path.join(
        os.path.dirname(__file__), "_pb_two_workers.py"), root, name,
        fault or "-"], env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["device"]["count"] == 2
    assert line["correct"] is (fault is None)


@pytest.mark.cuda
def test_tiny_cell_on_card(root):
    """The harness on the card at a tiny size: the program's kernels,
    the probe's CUDA events and the profiler's device trace."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from perfbench.bench import env
    from perfbench.bench.cell import run_process
    import io
    env.prepare()
    for trace in (False, True):
        out, err = io.StringIO(), io.StringIO()
        rc = run_process("tiny-moe.tiny", 5, 1.0, trace, t_start=0.0,
                         root=root, out=out, err=err)
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        assert rc == 0 and line["correct"] is True
        assert line["device"]["platform"] == "gpu"
        if trace:
            assert line["device"]["busy_s"] > 0
            assert "ef_roofline" in line["metrics"]
