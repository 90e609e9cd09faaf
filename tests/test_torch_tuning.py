"""The kernel-configuration ladder of the port
(``repro_torch/kernels/ef_fused/tuning.py``), the cases of the
reference's ``tests/test_tuning.py:169-300`` on the port's two
backends, on the CPU:

* the in-process cache makes a second resolve of the same shape class
  free (a stub timer counts the measurements) and a cleared cache
  re-derives the same winner;
* the ``torch`` backend never measures and keeps the reference's
  interpret heuristic; ``cuda`` on a machine without a card, and under
  ``geometry_of``, never measures either;
* the candidate grid is the reference's: blocks 1024..8192 within the
  class, ``num_warps`` 4 and 8;
* the table is consulted before a measurement; another schema raises;
* by default nothing measures, with a card or without;
* the checked-in ``kernelconfig.cuda.json`` is valid: every class
  2^0..2^30, each row the heuristic or the candidate that beat it by
  more than the spread of their alternating rounds, measured on the
  card; ``confirm`` keeps the heuristic within that spread;
* ``KernelConfig`` round-trips through a dict and ignores unknown keys;
* ``ops._resolve``: explicit blocks skip the ladder; otherwise it goes
  through it, and the config's ``num_warps`` reaches K1 and K2;
* in 2 gloo processes a stub timer that prefers another candidate on
  each rank gives the ranks different winners alone, and one config
  inside the group (``tests/_torch_tp_pg.py``).
"""
import json
import os

import pytest
import torch

from _torch_tp_pg import launch
from repro_torch.kernels.ef_fused import ops, tuning
from repro_torch.kernels.ef_fused.tuning import (KernelConfig, candidates,
                                                 choose_block,
                                                 choose_stats_block,
                                                 resolve_config, shape_class)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Each test sees a clean cache and no table override."""
    monkeypatch.delenv(tuning.ENV_TABLE_DIR, raising=False)
    tuning.clear_cache()
    yield
    tuning.clear_cache()


@pytest.fixture
def no_table(tmp_path, monkeypatch):
    monkeypatch.setenv(tuning.ENV_TABLE_DIR, str(tmp_path))
    tuning.clear_cache()
    return tmp_path


def _counting_timer(calls):
    def timer(cfg, d):
        calls.append(cfg)
        # deterministic scoring: prefer the largest block, 8 warps
        return 1.0 / (cfg.block * (2 if cfg.num_warps == 8 else 1))
    return timer


def test_autotune_cache_determinism(no_table):
    calls = []
    timer = _counting_timer(calls)
    cfg1 = resolve_config(5000, "cuda", measure=True, timer=timer)
    n_first = len(calls)
    assert n_first == len(candidates(5000))
    assert cfg1.source == "autotune" and cfg1.backend == "cuda"
    assert (cfg1.block, cfg1.num_warps) == (8192, 8)
    # cache hit: the same shape class resolves with no further timing
    assert resolve_config(4097, "cuda", measure=True, timer=timer) == cfg1
    assert len(calls) == n_first
    # another shape class measures again
    resolve_config(2 ** 14, "cuda", measure=True, timer=timer)
    assert len(calls) > n_first
    # a cleared cache re-derives the same winner
    tuning.clear_cache()
    assert resolve_config(5000, "cuda", measure=True,
                          timer=_counting_timer([])) == cfg1


def test_cpu_resolution_never_measures(no_table):
    calls = []
    timer = _counting_timer(calls)
    cfg = resolve_config(65536, "torch", measure=True, timer=timer)
    assert calls == [] and cfg.source == "heuristic"
    assert (cfg.block, cfg.stats_block) == (choose_block(65536, "torch"),
                                            choose_stats_block(65536,
                                                               "torch"))
    assert cfg.num_warps is None
    # no card here: cuda's ladder ends at the heuristic, untimed
    assert not torch.cuda.is_available()
    cuda = resolve_config(65536, "cuda", timer=timer)
    assert calls == [] and cuda.source == "heuristic"
    assert (cuda.block, cuda.stats_block) == (1024, 4096)
    # geometry_of hands a CPU call the card's config, never a measurement
    tuning.clear_cache()
    with tuning.geometry_of("cuda"):
        got = resolve_config(65536, "torch", measure=True, timer=timer)
    assert calls == [] and got == cuda


def test_candidate_grid_shape():
    cands = candidates(2 ** 16)
    assert all(c.backend == "cuda" and c.source == "autotune"
               for c in cands)
    assert {c.num_warps for c in cands} == {4, 8}
    assert sorted({c.block for c in cands}) == [1024, 2048, 4096, 8192]
    for c in cands:
        assert c.stats_block == max(c.block, min(4 * c.block, 2 ** 16))
    assert sorted({c.block for c in candidates(3000)}) == [1024, 2048,
                                                           4096]
    # a leaf below the floor still gets the floor candidate
    tiny = candidates(7)
    assert [(c.block, c.stats_block) for c in tiny] == [(1024, 1024)] * 2


def test_table_consulted_before_autotune(no_table):
    pinned = KernelConfig("cuda", 4096, 8192, num_warps=8)
    table = {"schema": tuning.TABLE_SCHEMA, "platform": "cuda",
             "configs": {tuning.config_key("cuda", 5000):
                         pinned.to_dict()}}
    path = no_table / "kernelconfig.cuda.json"
    path.write_text(json.dumps(table))
    assert tuning.table_path("cuda") == str(path)
    calls = []
    cfg = resolve_config(5000, "cuda", measure=True,
                         timer=_counting_timer(calls))
    assert calls == []                 # table hit: no timing at all
    assert cfg.source == "table"
    assert (cfg.block, cfg.stats_block, cfg.num_warps) == (4096, 8192, 8)
    # a class not in the table falls through to the stub-timed autotune
    cfg2 = resolve_config(2 ** 16, "cuda", measure=True,
                          timer=_counting_timer(calls))
    assert calls and cfg2.source == "autotune"
    # the torch backend reads no cuda table
    assert resolve_config(5000, "torch").source == "heuristic"


def test_table_schema_mismatch_is_loud(no_table):
    (no_table / "kernelconfig.cuda.json").write_text(
        json.dumps({"schema": "bogus/v0", "configs": {}}))
    with pytest.raises(ValueError, match="unexpected schema"):
        resolve_config(5000, "cuda", measure=False)


def test_checked_in_cuda_table_is_valid():
    """The committed table parses, carries the schema and pins every
    class 2^0..2^30 at each dtype of ``TABLE_DTYPES`` (f32 and bf16),
    measured on an H100 (each dtype's run recorded under ``runs``): each
    row the class's heuristic config at its dtype, or the fastest of its
    candidate grid where that beat the heuristic by more than the spread
    of their alternating rounds (``tuning.confirm``), and resolves as
    ``table``."""
    path = tuning.table_path("cuda")
    assert os.path.dirname(path) == os.path.dirname(tuning.__file__)
    with open(path) as f:
        data = json.load(f)
    assert data["schema"] == tuning.TABLE_SCHEMA
    assert data["platform"] == "cuda" and "H100" in data["device"]
    assert tuning.TABLE_DTYPES == ("float32", "bfloat16")
    assert sorted(data["runs"]) == sorted(tuning.TABLE_DTYPES)
    assert all("H100" in r["device"] for r in data["runs"].values())
    assert sorted(data["configs"]) == sorted(
        tuning.config_key("cuda", c, dt) for dt in tuning.TABLE_DTYPES
        for c in tuning.TABLE_CLASSES)
    for key, row in data["configs"].items():
        backend, dtype, sclass = key.split("/")
        assert backend == "cuda" and dtype in tuning.TABLE_DTYPES
        d = int(sclass)
        cfg = KernelConfig.from_dict(row)
        timed = data["timings_ms"][key]
        assert len(timed["grid"]) == len(candidates(d, dtype))
        assert len(timed["heuristic_ms"]) == len(timed["winner_ms"]) == (
            tuning.ROUNDS)
        kept = timed["margin_ms"] > timed["spread_ms"]
        if kept:
            best = min(timed["grid"], key=lambda t: t["ms"])
            assert cfg.source == "autotune" and cfg in candidates(
                d, dtype), key
            assert (best["block"], best["stats_block"],
                    best["num_warps"]) == (cfg.block, cfg.stats_block,
                                           cfg.num_warps), key
        else:
            assert cfg == tuning.heuristic_config("cuda", d, dtype), key
        got = resolve_config(d, "cuda", dtype)
        assert got.source == "table"
        assert (got.block, got.stats_block, got.num_warps) == (
            cfg.block, cfg.stats_block, cfg.num_warps)


@pytest.mark.parametrize("winner_ms,kept", [(0.5, True), (0.9, False)])
def test_confirm_keeps_the_heuristic_within_the_spread(winner_ms, kept):
    """``confirm`` times the heuristic and the grid's winner in
    alternating rounds and keeps the winner only if the heuristic's
    median less the winner's exceeds the larger range of the rounds
    (here 0.2 ms: the heuristic's rounds 0.9–1.1)."""
    winner = KernelConfig("cuda", 4096, 16384, num_warps=4,
                          source="autotune")
    base = tuning.heuristic_config("cuda", 2 ** 20)
    heur = iter([1.0, 1.1, 0.9, 1.0, 1.0])
    order = []

    def timer(cfg, d):
        order.append("h" if cfg == base else "w")
        return next(heur) if cfg == base else winner_ms

    got, record = tuning.confirm(winner, 2 ** 20, None, timer=timer)
    assert order == ["h", "w", "w", "h", "h", "w", "w", "h", "h", "w"]
    assert record["spread_ms"] == pytest.approx(0.2)
    assert record["margin_ms"] == pytest.approx(1.0 - winner_ms)
    assert got == (winner if kept else base)


def test_default_resolution_never_measures(no_table, monkeypatch):
    """With a card visible and no table, ``resolve_config`` by default
    times nothing and takes the heuristic, as every process of a group
    does: only ``measure=True`` measures."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    calls = []
    cfg = resolve_config(2 ** 20, "cuda", timer=_counting_timer(calls))
    assert calls == [] and cfg == tuning.heuristic_config("cuda", 2 ** 20)


def test_kernelconfig_roundtrip_ignores_unknown_keys():
    cfg = KernelConfig("cuda", 1024, 4096, bcap_slack=1.5, num_warps=8)
    d = cfg.to_dict()
    d["num_stages"] = 2                # the reference's field
    d["future_field"] = 7
    assert KernelConfig.from_dict(d) == cfg


def test_ops_resolve_explicit_blocks_skip_ladder(no_table):
    (no_table / "kernelconfig.cuda.json").write_text("not json")
    g = torch.zeros(4096)
    with tuning.geometry_of("cuda"):
        d, k_cap, block, stats, bcap, cfg = ops._resolve(
            g, None, "gaussiank", 40, None, 2048, 4096, None)
    assert (block, stats) == (2048, 4096)
    assert cfg.source == "explicit" and cfg.backend == "torch"
    assert bcap == ops.fused_default_bcap(k_cap, d, 2048)


def test_ops_resolve_uses_config_ladder(no_table, monkeypatch):
    g = torch.zeros(65536)
    *_, cfg = ops._resolve(g, None, "gaussiank", 100, None, None, None,
                           None)
    assert cfg.backend == "torch" and cfg.source == "heuristic"
    assert cfg.block == choose_block(65536, "torch")
    pinned = KernelConfig("cuda", 2048, 8192, num_warps=8)
    (no_table / "kernelconfig.cuda.json").write_text(json.dumps({
        "schema": tuning.TABLE_SCHEMA, "platform": "cuda", "configs": {
            tuning.config_key("cuda", 65536): pinned.to_dict()}}))
    tuning.clear_cache()
    warps = []

    def spy(fn):
        def call(*a, num_warps=None, **k):
            warps.append((fn.__name__, num_warps))
            return fn(*a, **k)
        return call

    monkeypatch.setattr(ops, "fused_moments", spy(ops.fused_moments))
    monkeypatch.setattr(ops, "tree_count", spy(ops.tree_count))
    g = torch.linspace(-1.0, 1.0, 65536)
    with tuning.geometry_of("cuda"):
        *_, block, stats, bcap, cfg = ops._resolve(
            g, None, "gaussiank", 100, None, None, None, None)
        got = ops.fused_compress_ef(g, None, "gaussiank", 100)
    assert cfg.source == "table" and (block, stats) == (2048, 8192)
    # the table's warps reach K1; K2's CUDA kernel takes none
    assert warps == [("fused_moments", 8), ("tree_count", None)]
    want = ops.fused_compress_ef(g, None, "gaussiank", 100, block=2048,
                                 stats_block=8192)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_ranks_agree_on_a_config(tmp_path):
    """2 gloo processes, no table but one row (class 2^17): alone, a
    stub timer that prefers another candidate on each rank makes each
    rank measure and pick its own; in the process group the same call
    times nothing and every rank resolves the heuristic, and the row's
    class the row."""
    table = tmp_path / "table"
    table.mkdir()
    row = KernelConfig("cuda", 4096, 16384, num_warps=8)
    (table / "kernelconfig.cuda.json").write_text(json.dumps({
        "schema": tuning.TABLE_SCHEMA, "platform": "cuda", "configs": {
            tuning.config_key("cuda", 70000): row.to_dict()}}))
    launch(tmp_path, 2, [{"name": "tuning", "argv": [str(table)]}],
           timeout=120)
    ranks = json.loads((tmp_path / "tuning.json").read_text())
    alone = [KernelConfig.from_dict(r["alone"]) for r in ranks]
    assert alone[0] != alone[1]
    assert all(r["timed_alone"] == len(candidates(5000)) for r in ranks)
    assert all(r["timed_shared"] == 0 for r in ranks)
    shared = [KernelConfig.from_dict(r["shared"]) for r in ranks]
    assert shared[0] == shared[1] == tuning.heuristic_config("cuda", 5000)
    pinned = [KernelConfig.from_dict(r["pinned"]) for r in ranks]
    assert pinned[0] == pinned[1]
    assert (pinned[0].source, pinned[0].block, pinned[0].num_warps) == (
        "table", 4096, 8)
    assert shape_class(70000) == 2 ** 17
