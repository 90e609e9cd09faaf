"""Slice 4b, the paper's experiments, on the port against the JAX
package's ``benchmarks/`` (on the CPU).

* ``simulate_sparsified_sgd`` against ``benchmarks.common``'s at W = 2,
  3 steps, ratio 0.005: losses within rtol 1e-4, accuracies equal, the
  wire (``comm``) equal, the pass-A statistics within rtol 1e-5 (the sum
  within 1e-5 of ``sqrt(d · sumsq) >= sum |u|``: it cancels), and the
  Fig. 2 histogram's edges within 1e-5 of its range with at most 5 of
  the leaf's 100,352 elements in another bin.
* Each benchmark's ``run(smoke=True)`` gives the reference benchmark's row
  names, and calls the simulation with the reference's arguments.  The
  simulation is stubbed on both sides here (it is held above; the real
  smoke runs on the card, ``chip_smoke.py`` phase 8b); fig4's port rows
  are real CPU runs.
* The port's fig4 pass counts, and its dispatch rows' collectives (per
  leaf against bucketed), against ``benchmarks/baselines/fig4.json``;
  the overlap benchmark's rows and its dispatch rows' collectives
  (chunked at 1, 2, 4) against ``benchmarks/baselines/overlap.json``.
  The reference's dispatch rows count a jaxpr traced over an
  ``AbstractMesh`` that this jax version does not construct, so the
  committed baselines stand for them.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_prng_flag import threefry_partitionable  # noqa: F401
from repro.core import adaptk as j_adaptk
from repro.kernels.ef_fused import count_passes as j_count_passes
from repro.kernels.ef_fused import fused_compress_ef as j_fused
from repro_torch.benchmarks import common
from repro_torch.core import adaptk
from repro_torch.kernels.ef_fused import count_passes, fused_compress_ef

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)   # the JAX package's benchmarks live at the root

import benchmarks.common as j_common  # noqa: E402

torch.set_num_threads(2)

VN = dict(global_policy="normdecay", global_ema=0.5, global_floor=0.25)
SIM_CASES = {   # name: (compressor, density policy kwargs or None, extras)
    "none": ("none", None, False),
    "topk": ("topk", None, True),
    "gaussiank": ("gaussiank", None, False),
    "randk": ("randk", None, False),
    "rtopk": ("rtopk", None, False),
    "gaussiank-variance-normdecay": ("gaussiank", VN, True),
    "rtopk-variance-normdecay": ("rtopk", VN, False),
}


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_simulation_matches_reference(case):
    comp, pol, extras = SIM_CASES[case]
    kw = dict(workers=2, ratio=0.005, steps=3)
    jkw, tkw = dict(kw), dict(kw)
    if pol is not None:
        jkw["density_policy"] = j_adaptk.make_policy("variance", **pol)
        tkw["density_policy"] = adaptk.make_policy("variance", **pol)
    if extras:
        jkw.update(collect_u_hist_at=(2,), stats_out=[])
        tkw.update(collect_u_hist_at=(2,), stats_out=[])
    jl, ja, jc, jh = j_common.simulate_sparsified_sgd(comp, **jkw)
    tl, ta, tc, th = common.simulate_sparsified_sgd(comp, device="cpu",
                                                    **tkw)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert ta == ja
    assert tc == jc
    if not extras:
        return
    for js, ts in zip(jkw["stats_out"], tkw["stats_out"]):
        assert ts.shape == js.shape == (2, 8, 3) and ts.dtype == np.float32
        np.testing.assert_allclose(ts[..., 1:], js[..., 1:], rtol=1e-5)
        dims = np.asarray([128, 784 * 128, 96, 128 * 96, 64, 96 * 64,
                           10, 64 * 10])
        scale = np.sqrt(dims * js[..., 1])
        assert np.all(np.abs(ts[..., 0] - js[..., 0]) <= 1e-5 * scale)
    (jcnt, jedge), (tcnt, tedge) = jh[2], th[2]
    np.testing.assert_allclose(tedge, jedge, rtol=0,
                               atol=1e-5 * np.ptp(jedge))
    assert tcnt.sum() == jcnt.sum() == 784 * 128
    assert np.abs(tcnt - jcnt).sum() <= 10


# -- the benchmarks' rows, with the simulation stubbed on both sides --

def _stub(calls):
    def sim(compressor, *, workers=16, ratio=0.001, steps=150, lr=0.05,
            seed=0, batch=64, collect_u_hist_at=(), k_override=None,
            spec=None, density_policy=None, stats_out=None, device=None):
        calls.append({"compressor": compressor, "workers": workers,
                      "ratio": ratio, "steps": steps, "lr": lr,
                      "seed": seed, "batch": batch,
                      "hist_at": tuple(collect_u_hist_at),
                      "k_override": k_override,
                      "spec": None if spec is None else spec.name,
                      "policy": None if density_policy is None
                      else tuple(density_policy),
                      "stats_out": stats_out is not None})
        rng = np.random.default_rng(len(calls))
        if stats_out is not None:
            # a two-step trace: fig10's replay reads its first and last
            stats_out.extend(
                np.abs(rng.standard_normal((workers, 8, 3))).astype(
                    np.float32) + 1 for _ in range(min(steps, 2)))
        hists = {t: np.histogram(rng.standard_normal(1000), bins=60)
                 for t in collect_u_hist_at}
        return [1.0] * steps, [0.5] * steps, [100] * steps, hists
    return sim


BENCHES = ["fig5_bound", "fig2_histograms", "fig1_fig6_convergence",
           "fig10_sensitivity", "fig_rtopk"]


@pytest.mark.parametrize("name", BENCHES)
def test_benchmark_rows_are_the_references(name, monkeypatch):
    import importlib
    jmod = importlib.import_module(f"benchmarks.{name}")
    tmod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    jcalls, tcalls = [], []
    monkeypatch.setattr(jmod, "simulate_sparsified_sgd", _stub(jcalls))
    monkeypatch.setattr(tmod, "simulate_sparsified_sgd", _stub(tcalls))
    jrows = jmod.run(smoke=True)
    trows = tmod.run(smoke=True, device="cpu")
    assert [r[0] for r in trows] == [r[0] for r in jrows]
    assert tcalls == jcalls and tcalls
    if name == "fig5_bound":
        # the Gaussian rows are real on both sides
        for jr, tr in zip(jrows[:3], trows[:3]):
            assert tr[2] == jr[2]


@pytest.fixture(scope="module")
def fig4_port():
    from repro_torch.benchmarks import fig4_selection_speed as tfig4
    return tfig4.collect(smoke=True, device="cpu")


def _baseline_dispatch(name):
    """A baseline's dispatch rows as the reference's ``_dispatch_rows``
    returns them: ``(rows, bench)``."""
    with open(os.path.join(ROOT, f"benchmarks/baselines/{name}.json")) as f:
        bench = [r for r in json.load(f)["rows"]
                 if r["method"].startswith("dispatch")]
    rows = [(f"{name}/{r['method']}/{r['shape']}", 0.0,
             f"collectives={r['passes']}") for r in bench]
    return rows, bench


def test_fig4_rows_are_the_references(fig4_port, monkeypatch):
    """Names of the selection, EF and dispatch rows.  The reference's
    timings and pipelines are stubbed (only its row names are read), and
    its dispatch rows are the baseline's: the reference counts them over
    a jaxpr traced on an ``AbstractMesh`` this jax does not construct."""
    import benchmarks.fig4_selection_speed as jfig4
    monkeypatch.setattr(jfig4, "timeit", lambda *a, **k: 1.0)
    monkeypatch.setattr(jfig4, "fused_compress_ef", lambda *a, **k: None)
    monkeypatch.setattr(jfig4, "unfused_compress_ef", lambda *a, **k: None)
    monkeypatch.setattr(jfig4, "_dispatch_rows",
                        lambda: _baseline_dispatch("fig4"))
    jrows, jdata = jfig4.collect(smoke=True)
    trows, tdata = fig4_port
    assert [r[0] for r in trows] == [r[0] for r in jrows]
    assert ([(r["shape"], r["method"]) for r in tdata["rows"]]
            == [(r["shape"], r["method"]) for r in jdata["rows"]])
    for r in trows:
        assert r[1] > 0 or r[0].startswith(("fig4/speedup",
                                            "fig4/dispatch")), r


def test_fig4_pass_counts_match_baseline(fig4_port):
    """Unfused and the plain reference row: the baseline's counts, and
    the dispatch rows' collectives (per leaf 8 and 16, bucketed 1 and 2).
    Fused: the baseline's less two.  The baseline was taken on the
    reference's interpret backend, which adds ``u = g + e`` as a pass of
    its own and writes ``e'`` by a scatter after its compaction; the
    port's K1 reads ``g`` and ``e``, and K3 stages, writes ``e'`` and
    assembles the pair in one sweep, as the reference's sequential
    lowering does (``src/repro/kernels/ef_fused/ops.py``:
    ``compact+residual``).  The labels are those of the reference's
    ``backend="mosaic"`` run, pass for pass."""
    with open(os.path.join(ROOT, "benchmarks/baselines/fig4.json")) as f:
        base = {(r["shape"], r["method"]): r["passes"]
                for r in json.load(f)["rows"]}
    _, tdata = fig4_port
    for r in tdata["rows"]:
        want = base[(r["shape"], r["method"])]
        if r["method"].endswith("-fused"):
            want -= 2
        assert r["passes"] == want, r
    d, k = 4096, 41
    g = np.random.default_rng(0).standard_normal(d).astype(np.float32)
    e = np.random.default_rng(1).standard_normal(d).astype(np.float32)
    for comp in ("gaussiank", "histk"):
        with j_count_passes() as jlog:
            jax.block_until_ready(j_fused(jnp.asarray(g), jnp.asarray(e),
                                          comp, k, backend="mosaic"))
        with count_passes() as tlog:
            fused_compress_ef(torch.from_numpy(g), torch.from_numpy(e),
                              comp, k)
        assert jlog.by_label()["compact+residual"] == 1
        assert tlog.by_label() == jlog.by_label()


def test_overlap_rows_match_baseline():
    """The overlap benchmark on the CPU: its rows' shapes and methods are
    the baseline's, the dispatch rows' collectives equal the baseline's
    (allgather 1/2/4, hierarchical 2/4/8, gtopk 3/6/12) and the step rows
    count 1 and 4 collectives; the row names are the reference's."""
    from repro_torch.benchmarks import overlap_schedule as tover
    with open(os.path.join(ROOT, "benchmarks/baselines/overlap.json")) as f:
        base = json.load(f)["rows"]
    rows, data = tover.collect(smoke=True, device="cpu")
    assert [(r["shape"], r["method"]) for r in data["rows"]] == \
        [(r["shape"], r["method"]) for r in base]
    for got, want in zip(data["rows"], base):
        assert got["passes"] == want["passes"], got
        assert (got["ms"] > 0) == (want["ms"] > 0), got
    names = [f"overlap/{r['method']}/{r['shape']}" for r in base]
    assert [r[0] for r in rows] == names + ["overlap/step-ratio/L8-W8"]


def test_harness_runs_a_benchmark_on_the_cpu(capsys):
    """``python -m repro_torch.benchmarks.run fig5 --smoke --device
    cpu``: the header, the benchmark's rows (the real simulation) and its
    wall-time row."""
    from repro_torch.benchmarks import run
    assert run.main(["fig5", "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert "fig5/bounds_hold_gaussian,0.0,ok=True" in out
    assert out[-1].startswith("fig5_bound/_wall_s,")
    with pytest.raises(SystemExit):
        run.main(["no_such_figure", "--device", "cpu"])


@pytest.mark.parametrize("name", ["fig10_sensitivity", "fig_rtopk",
                                  "fig4_selection_speed",
                                  "overlap_schedule"])
def test_main_writes_only_the_named_path(name, tmp_path, monkeypatch):
    """No file unless ``--json`` names one (the JAX benchmarks' defaults,
    ``BENCH_*.json``, are committed artifacts), then exactly that one."""
    import importlib
    mod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    if hasattr(mod, "simulate_sparsified_sgd"):
        monkeypatch.setattr(mod, "simulate_sparsified_sgd", _stub([]))
    monkeypatch.chdir(tmp_path)
    mod.main(["--smoke", "--device", "cpu"])
    assert os.listdir(tmp_path) == []
    mod.main(["--smoke", "--device", "cpu", "--json", "out.json"])
    assert os.listdir(tmp_path) == ["out.json"]
    with open(tmp_path / "out.json") as f:
        doc = json.load(f)
    assert doc["schema"] == mod.SCHEMA and doc["smoke"] is True
    assert doc["platform"] == "cpu" and doc["torch"] == torch.__version__
