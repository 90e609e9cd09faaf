"""The port's wire-strategy tuner and topology descriptors
(``repro_torch.dist.tuner``, ``repro_torch.launch.topo``) against the
reference's (``repro.dist.tuner``, ``repro.launch.topo``).

The pricing is float arithmetic in the reference's order, so every
prediction field and every decision is held with ``==`` (no tolerance)
over the reference's test grid: its four geometries, its four synthetic
topologies and the 1-, 2- and 3-axis meshes.  The topology JSON written
by either package loads in the other to an equal dict, and the
``tuner_decision`` benchmark's rows equal ``benchmarks/baselines/tuner.json``
(the choice and ``passes`` exactly, ``ms`` within 1e-12 relative).
"""
import json
import os

import jax.numpy as jnp
import pytest
import torch

from repro.core.compressors import get_compressor as j_get
from repro.dist import tuner as jt
from repro.dist.layout import build_layout as j_build
from repro.launch import topo as jtopo
from repro_torch.benchmarks import tuner_decision
from repro_torch.core.compressors import get_compressor
from repro_torch.dist import tuner as pt
from repro_torch.dist.layout import build_layout
from repro_torch.launch import topo as ptopo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GEOMS = [
    ({"a": (40, 30), "b": (17,)}, 1, 0.01),
    ({"a": (40, 30), "b": (17,)}, 1, 0.05),
    ({"a": (256, 128), "b": (1024,), "c": (64, 64)}, 2, 0.01),
    ({"a": (256, 128), "b": (1024,), "c": (64, 64)}, 2, 0.05),
]

MESHES = [[("data", 2)], [("data", 4)], [("data", 8)], [("data", 5)],
          [("pod", 2), ("data", 2)], [("pod", 2), ("data", 4)],
          [("pod", 4), ("data", 2)], [("pod", 3), ("data", 2)],
          [("pod", 2), ("data", 2), ("x", 2)],
          [("pod", 2), ("data", 3), ("x", 2)]]


def _topos(mod):
    """The reference test's topologies, built from ``mod``'s classes."""
    hw = mod.HardwareSpec(name="test-hw", peak_flops=197e12, hbm_bw=819e9)
    L = mod.LinkSpec
    return [
        mod.Topology(hardware=hw, default_link=L(1e-7, 4e11),
                     name="fat-flat"),
        mod.Topology(hardware=hw, default_link=L(1e-6, 1e8),
                     name="slow-flat"),
        mod.Topology(hardware=hw, default_link=L(5e-3, 5e10),
                     name="high-alpha"),
        mod.Topology(hardware=hw, links=(("data", L(1e-6, 5e10)),
                                         ("pod", L(1e-3, 1e8))),
                     default_link=L(1e-6, 5e10), name="asym"),
    ]


def _layouts(geom):
    shapes, msize, ratio = geom
    j = j_build({k: jnp.zeros(s) for k, s in shapes.items()}, msize, ratio,
                j_get("topk"))
    p = build_layout({k: torch.empty(s, device="meta")
                      for k, s in shapes.items()}, msize, ratio,
                     get_compressor("topk"))
    return j, p


@pytest.mark.parametrize("geom", GEOMS, ids=["s.01", "s.05", "m.01", "m.05"])
def test_decisions_and_predictions_equal_the_reference(geom):
    """Every decision, its order and every prediction field (wire, merge,
    total, messages, bytes, per-axis seconds) equal the reference's."""
    jl, pl = _layouts(geom)
    assert (pl.pair_bits(None), pl.model_size, pl.d_row_total) == (
        jl.pair_bits(None), jl.model_size, jl.d_row_total)
    for jtp, ptp in zip(_topos(jtopo), _topos(ptopo)):
        for axes in MESHES:
            want = jt.choose_strategy(jl, axes, jtp)
            got = pt.choose_strategy(pl, axes, ptp)
            assert got.to_dict() == want.to_dict(), (ptp.name, axes)
            assert got.considered == want.considered
            for s in want.considered:
                args = (axes, pl.pair_bits(None) / 8.0,
                        pl.model_size * pl.d_row_total * 4.0)
                assert pt.predict_wire_time(s, *args, ptp,
                                            d_row=pl.d_row_total
                                            ).to_dict() == \
                    jt.predict_wire_time(s, *args, jtp,
                                         d_row=pl.d_row_total).to_dict()


def test_candidates_and_constants_equal_the_reference():
    for sizes in ([1], [2], [4], [5], [3, 2], [4, 2], [2, 4], [2, 2, 2],
                  [2, 3, 2], []):
        assert pt.candidate_strategies(sizes) == \
            jt.candidate_strategies(sizes), sizes
    assert (pt.MSGS_PER_PAIR, pt.TOPK_PASSES_PER_LOG2D, pt.COMPRESS_PASSES,
            pt.TIE_RANK) == (jt.MSGS_PER_PAIR, jt.TOPK_PASSES_PER_LOG2D,
                             jt.COMPRESS_PASSES, jt.TIE_RANK)
    with pytest.raises(ValueError):
        pt.predict_wire_time("hierarchical", [("data", 4)], 1e3, 1e6,
                             ptopo.DEFAULT_TOPOLOGY)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_topology_json_loads_in_the_other_package(tmp_path, writer):
    """A descriptor saved by one package loads in the other to an equal
    dict, and the two files are byte for byte the same."""
    jasym, pasym = _topos(jtopo)[3], _topos(ptopo)[3]
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    if writer == "jax":
        jtopo.save_topology(jasym, a)
        back = ptopo.load_topology(a)
        assert back == pasym
    else:
        ptopo.save_topology(pasym, a)
        back = jtopo.load_topology(a)
        assert back == jasym
    assert back.to_dict() == pasym.to_dict() == jasym.to_dict()
    jtopo.save_topology(jasym, b)
    ptopo.save_topology(pasym, a)
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()
    assert ptopo.DEFAULT_TOPOLOGY.to_dict() == jtopo.DEFAULT_TOPOLOGY.to_dict()
    (tmp_path / "bad.json").write_text("[1, 2, 3]")
    with pytest.raises(ValueError, match="JSON object"):
        ptopo.load_topology(str(tmp_path / "bad.json"))


def test_decision_benchmark_rows_equal_the_baseline():
    """``tuner_decision``'s rows equal the committed reference baseline:
    the choice and ``passes`` exactly, ``ms`` within 1e-12 relative."""
    _, doc = tuner_decision.collect()
    with open(os.path.join(ROOT, "benchmarks/baselines/tuner.json")) as f:
        base = json.load(f)
    assert doc["schema"] == base["schema"]
    assert tuner_decision.baseline_mismatches(doc["rows"],
                                              base["rows"]) == []
    decide = {r["shape"]: r["choice"] for r in doc["rows"]
              if r["method"] == "decide"}
    assert decide["asym/pod2xdata2"] == "hier_gtopk"
    assert "env" in doc and doc["platform"] in ("cpu", "gpu")


def test_measured_topology_over_local_wire_is_the_default_link():
    """In one process ``LocalWire.ppermute`` is a reindexing: no byte
    crosses a link, so every data axis keeps ``DEFAULT_LINK`` — and the
    measured hardware names the CPU."""
    from repro_torch.dist.wire import LocalWire
    from repro_torch.launch.mesh import parse_mesh
    mesh = parse_mesh("2x2x1")
    topo = ptopo.measure_topology(mesh, LocalWire(mesh), reps=1, rounds=2,
                                  large_bytes=1 << 16, device="cpu")
    assert topo.link("pod") == topo.link("data") == ptopo.DEFAULT_LINK
    assert topo.hardware.name == "measured-cpu"
    assert topo.hardware.peak_flops > 0 and topo.hardware.hbm_bw > 0


@pytest.mark.parametrize("strategy", ["allgather", "gtopk", "hierarchical",
                                      "hier_gtopk"])
def test_measure_wire_over_local_wire(strategy):
    """The measuring half runs over ``LocalWire`` on the CPU and returns
    a positive time for every strategy (no timing is asserted)."""
    from repro_torch.dist.wire import LocalWire
    from repro_torch.launch.mesh import parse_mesh
    mesh = parse_mesh("2x2x1")
    wire = LocalWire(mesh)
    pl = build_layout({"a": torch.zeros(256, 128), "b": torch.zeros(1024),
                       "c": torch.zeros(64, 64)}, 1, 0.01,
                      get_compressor("topk"))
    t = pt.measure_wire_time(mesh, wire, pl, get_compressor("topk"),
                             strategy, reps=1, device="cpu")
    p = pt.measure_wire_pattern(mesh, wire, pl.pair_bits() / 8.0, strategy,
                                reps=1, device="cpu")
    assert t > 0 and p > 0
