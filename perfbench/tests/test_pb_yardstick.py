"""The yardstick's arithmetic on closed forms, the traffic's scan, the
weights, the limits' files and the check for JAX modules."""
from __future__ import annotations

import json
import math
import os

import torch

from perfbench.bench import check, env, flops, traffic, weights
from perfbench.bench.spec import NAME
from perfbench.bench.trace import reduce_trace
from perfbench.tests._pb_cells import REPO, TINY_DENSE, TINY_MOE


def test_forbidden_modules_by_whole_top_level_name():
    names = ["repro_torch.x", "repro_torch", "jaxtyping", "reproducible",
             "numpy"]
    assert env.forbidden_loaded(names) == []
    assert env.forbidden_loaded(names + ["repro.x"]) == ["repro.x"]
    assert env.forbidden_loaded(["jax.numpy", "jaxlib", "flax.linen",
                                 "repro"]) == ["flax.linen", "jax.numpy",
                                               "jaxlib", "repro"]


def test_active_params_and_flops_closed_form():
    D, V, F, L, H = 64, 256, 96, 2, 4
    per_layer = 4 * D * D + 3 * D * F + 2 * D
    n = D * V + D + L * per_layer
    assert flops.active_params(TINY_DENSE) == n
    T = 32
    want = (6 * n + 12 * L * T * H * (D // H)) * 100
    assert flops.model_flops(TINY_DENSE, 100, T) == want
    E, K, Fe, S = 4, 2, 32, 1
    moe_layer = 4 * D * D + D * E + 3 * D * Fe * E * K / E \
        + 3 * D * Fe * S + 2 * D
    assert math.isclose(flops.active_params(TINY_MOE),
                        D * V + D + L * moe_layer)


def test_ef_least_bytes_closed_form():
    total = 0
    from perfbench.reference.model import param_shapes
    for _, shape in param_shapes(TINY_DENSE):
        d = math.prod(shape)
        k = max(1, math.ceil(0.001 * d))
        total += 6 * d + min(d, math.ceil(4 * k / 3)) * 6
    assert flops.ef_least_bytes(TINY_DENSE, 0.001) == total


def test_roofline_and_mfu_readers():
    from types import SimpleNamespace

    from perfbench.bench.metrics import reader
    least = flops.ef_least_bytes(TINY_DENSE, 0.001)
    run = SimpleNamespace(
        gpu=True, model=TINY_DENSE, train={"ratio": 0.001},
        traces=[{"compress_device_s": 2 * least / flops.PEAK_HBM_BYTES,
                 "steps": 2, "busy_s": 0.75, "window_s": 1.0}],
        step_s=[0.5, 9.0, 0.5], profiled=[False, True, False],
        tokens_per_step=64, traffic={"seq_len": 32},
        cell=SimpleNamespace(chips=1))
    assert math.isclose(reader("ef_roofline")(run), 100.0)
    want = 100 * flops.model_flops(TINY_DENSE, 64, 32) * 2 / 1.0 \
        / flops.PEAK_BF16_FLOPS
    assert math.isclose(reader("mfu")(run), want)
    assert math.isclose(reader("device_idle_share")(run), 25.0)


def test_trace_reduction_closed_form():
    """Kernels counted by the span they were launched in; the busy time
    is the union over streams; the harness's own sync is not counted."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "pb.step", "ts": 0,
         "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb.sync", "ts": 100,
         "dur": 20, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "pb.compress",
         "ts": 10, "dur": 30, "tid": 2},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 12, "dur": 1, "tid": 2, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 50, "dur": 1, "tid": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
         "ts": 20, "dur": 5, "tid": 2, "args": {}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
         "ts": 101, "dur": 5, "tid": 1, "args": {}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 15, "dur": 10,
         "tid": 7, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 40,
         "tid": 8, "args": {"correlation": 8}},
    ]
    r = reduce_trace(ev, 1)
    assert math.isclose(r["busy_s"], 45e-6)
    assert math.isclose(r["window_s"], 120e-6)
    assert r["syncs_per_step"] == 1
    assert math.isclose(r["compress_device_s"], 10e-6)
    assert r["compress_kernels"] == 1
    assert r["device_ops"][0][0] == "k2"


def _loop(start, eps, hit, vocab):
    """The recurrence one position at a time."""
    t, out = start[:, 0], []
    for i in range(eps.shape[1]):
        t = (t * traffic.MULT + traffic.INC + eps[:, i] * hit[:, i]) % vocab
        out.append(t)
    return torch.stack(out, dim=1)


def test_token_scan_matches_the_recurrence():
    g = traffic.seeded(2 ** 31 + 5, 1, "cpu")
    got = traffic.token_rows(g, 3, 300, 1009, "cpu")
    g = traffic.seeded(2 ** 31 + 5, 1, "cpu")
    start = torch.randint(0, 1009, (3, 1), generator=g)
    hit = torch.rand((3, 300), generator=g) < traffic.NOISE_P
    eps = torch.randint(0, 1009, (3, 300), generator=g)
    assert torch.equal(got, _loop(start, eps, hit, 1009))
    ring = traffic.make_ring(7, {"workers": 1, "batch_per_worker": 2,
                                 "seq_len": 16, "ring": 3}, 1009, "cpu")
    rows = torch.cat([b["tokens"] for b in ring])
    assert len({tuple(r.tolist()) for r in rows}) == 6
    assert torch.equal(ring[0]["labels"][:, :-1], ring[0]["tokens"][:, 1:])


def test_weights_leaf_by_leaf():
    shapes = [("embed", (8, 4)), ("a/scale", (4,)), ("w", (2, 4, 6))]
    w = weights.make_weights(3, shapes, torch.bfloat16, "cpu")
    assert torch.equal(w["a/scale"], torch.ones(4, dtype=torch.bfloat16))
    again = weights.make_leaf(3, 2, "w", (2, 4, 6), torch.bfloat16, "cpu")
    assert torch.equal(w["w"], again)
    assert not torch.equal(w["w"], weights.make_leaf(4, 2, "w", (2, 4, 6),
                                                     torch.bfloat16, "cpu"))


def test_benchmark_file_names_and_limits():
    bench = json.load(open(os.path.join(REPO, "BENCHMARK.json")))
    for w in bench["workloads"]:
        assert NAME.match(w["name"])
        lim = json.load(open(os.path.join(REPO, "perfbench", "limits",
                                          w["name"] + ".json")))
        names = set(lim["limits"])
        assert names <= set(check.NUMBERS)
        assert {"loss", "grad", "resid"} <= names
        assert names & {"update", "update_median"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(REPO, "perfbench", "metrics",
                                           m["name"] + ".py"))


def test_update_median_steady_against_one_leaf():
    """One leaf's change far off moves the worst leaf's gap and not the
    median leaf's; every leaf unmoved reads 1 in both; a NaN is kept."""
    ref = {"loss": [2.0, 1.9, 1.8],
           "grad": {n: 1.0 for n in "abcde"},
           "resid": {n: 1.0 for n in "abcde"},
           "dense": {n: 1.0 for n in "abcde"},
           "update": {"a": 1.0, "b": 2.0, "c": 3.0, "d": 4.0, "e": 5.0}}
    prog = dict(ref, update=dict(ref["update"], c=3.6))
    nums = check.numbers(prog, ref)
    assert nums["update"][1] == "c"
    assert math.isclose(nums["update"][0], 0.2)
    assert nums["update_median"][0] == 0.0
    stale = check.numbers(dict(ref, update={n: 0.0 for n in "abcde"}), ref)
    assert stale["update"][0] == 1.0 and stale["update_median"][0] == 1.0
    bad = check.numbers(dict(ref, update=dict(ref["update"], a=math.nan)),
                        ref)
    assert math.isnan(bad["update_median"][0])
    ok, lines = check.judge({n: v for n, (v, _) in nums.items()},
                            {"loss": 1.0, "update_median": 0.01})
    assert ok and [ln[0] for ln in lines] == ["loss", "update_median"]
