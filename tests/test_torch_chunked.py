"""Slice 6, the chunked overlapped schedule, against the JAX package and
against the port's own bucketed path, on the CPU.

* The chunk plan: ``build_chunk_plan`` equal to the reference's on the
  same layouts (the small config, llama3.2-1b, the overlap benchmark's
  six leaves) at 1, 2, 3 and more chunks than leaves; ``chunk_view``
  equal; the reference's validation errors, word for word.
* Bitwise: the chunked step (N = 2, 3 and more than the 12 leaves)
  against the bucketed one after 3 steps (params, optimizer state,
  ``resid``, ``resid2``, the controller state, every metric but
  ``collectives_per_step``, which is N) for topk, gaussiank on both
  backends, histk, randk, rtopk, ``variance`` and momentum correction
  0.9; at W = 4 for the four strategies; under adaptive density one
  allocation a step, the unchunked one's.
* ``LocalWire`` at chunks 3 against the JAX mesh run at chunks 3
  (``tests/_torch_chunked_ref.py``, 4 forced host devices, the config,
  compressor and batches of ``tests/_torch_dist_ref.py``), at
  ``test_torch_dist.py``'s tolerances; ``collectives_per_step`` exact.
* The hooks: chunks are released during the backward (the chunk of
  ``final_norm`` and ``lm_head`` compressed before ``embed``'s
  gradient exists), once each a step; a group the loss never reaches
  releases zeros; a hook that fails raises out of the step.
* ``ProcessGroupWire`` over gloo in 2 and 4 processes at chunks 3,
  bitwise against ``LocalWire`` (``tests/_torch_dist_pg.py``).
* A checkpoint written at chunks 1 resumes at chunks 4 bitwise.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_steps import (CFG, MESHES, MODES, SRC, TESTS, assert_same,
                          config, mesh_run, pg_run, train)
from repro.core.compressors import get_compressor as j_get
from repro.dist import layout as jl
from repro.models import ModelConfig as JModelConfig
from repro.models import init_params as j_init
from repro_torch.checkpoint import load_state, save_state
from repro_torch.configs import get_config
from repro_torch.core.compressors import get_compressor
from repro_torch.dist import layout as tl
from repro_torch.launch import train as cli
from repro_torch.models import init_params
from repro_torch.optim import constant, sgd_momentum
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(2)



def _layouts():
    """(port layout, JAX layout) pairs over the same shapes."""
    out = {}
    jp = j_init(JModelConfig(**{k: getattr(CFG, k) for k in (
        "name", "arch_type", "num_layers", "d_model", "num_heads",
        "num_kv_heads", "d_ff", "vocab_size")}).validate(),
        jax.random.PRNGKey(0))
    out["small"] = (tl.build_layout(init_params(CFG, 0, "cpu"), 1, 0.02,
                                    get_compressor("topk")),
                    jl.build_layout(jp, 1, 0.02, j_get("topk")))
    from repro.configs import get_config as j_config
    jshapes = jax.eval_shape(lambda: j_init(j_config("llama3.2-1b"),
                                            jax.random.PRNGKey(0)))
    out["llama3.2-1b"] = (
        tl.build_layout(init_params(get_config("llama3.2-1b"), 0, "meta"),
                        1, 0.001, get_compressor("gaussiank")),
        jl.build_layout(jshapes, 1, 0.001, j_get("gaussiank")))
    sizes = [96 + 16 * i for i in range(6)]
    out["six leaves"] = (
        tl.build_layout({f"layer{i}": torch.zeros(n)
                         for i, n in enumerate(sizes)}, 1, 0.02,
                        get_compressor("topk")),
        jl.build_layout({f"layer{i}": jax.numpy.zeros(n)
                         for i, n in enumerate(sizes)}, 1, 0.02,
                        j_get("topk")))
    return out


LAYOUTS = _layouts()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 100])
@pytest.mark.parametrize("which", list(LAYOUTS))
def test_chunk_plan_matches_reference(which, n):
    tlay, jlay = LAYOUTS[which]
    tp, jp = tl.build_chunk_plan(tlay, n), jl.build_chunk_plan(jlay, n)
    assert (tp.n_chunks, tp.requested) == (jp.n_chunks, jp.requested)
    assert tp.n_chunks == min(n, len(tlay.segments))
    assert [tuple(g) for g in tp.groups] == [tuple(g) for g in jp.groups]
    for strategy, world, pods in (("allgather", 8, 1), ("gtopk", 8, 1),
                                  ("hierarchical", 8, 2),
                                  ("hier_gtopk", 8, 2)):
        assert tp.collectives(strategy, world, pods) == \
            jp.collectives(strategy, world, pods)
    tl.validate_chunk_plan(tlay, tp)
    for g, jg in zip(tp.groups, jp.groups):
        tv, jv = tl.chunk_view(tlay, g), jl.chunk_view(jlay, jg)
        assert (tv.d_row_total, tv.k_cap_total, tv.model_size,
                tv.adaptive) == (jv.d_row_total, jv.k_cap_total,
                                 jv.model_size, jv.adaptive)
        for ts, js in zip(tv.segments, jv.segments):
            assert (ts.name, ts.size, ts.d_pad, ts.d_row, ts.row_off,
                    ts.k_row, ts.k_cap, ts.cap_off, ts.salt) == \
                (js.name, js.size, js.d_pad, js.d_row, js.row_off,
                 js.k_row, js.k_cap, js.cap_off,
                 jl.leaf_key_salt(js.name))


def _bad_plans(plan, other):
    g = plan.groups
    return {
        "count": plan._replace(n_chunks=plan.n_chunks + 1),
        "order": plan._replace(groups=(g[1], g[0]) + g[2:]),
        "empty": plan._replace(groups=(g[0]._replace(seg_hi=g[0].seg_lo),)
                               + g[1:]),
        "other layout": other,
        "no groups": plan._replace(n_chunks=0, groups=()),
    }


@pytest.mark.parametrize("case", ["count", "order", "empty",
                                  "other layout", "no groups"])
def test_validate_chunk_plan_errors_are_the_references(case):
    (tlay, jlay), (tsix, jsix) = LAYOUTS["small"], LAYOUTS["six leaves"]
    tbad = _bad_plans(tl.build_chunk_plan(tlay, 3),
                      tl.build_chunk_plan(tsix, 3))[case]
    jbad = _bad_plans(jl.build_chunk_plan(jlay, 3),
                      jl.build_chunk_plan(jsix, 3))[case]
    with pytest.raises(ValueError) as terr:
        tl.validate_chunk_plan(tlay, tbad)
    with pytest.raises(ValueError) as jerr:
        jl.validate_chunk_plan(jlay, jbad)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="n_chunks must be >= 1"):
        tl.build_chunk_plan(tlay, 0)


_BASE = {}


def _bucketed(mode, strategy="allgather", mesh="1x1"):
    key = (mode, strategy, mesh)
    if key not in _BASE:
        _BASE[key] = train(config(mode, strategy), mesh=mesh)
    return _BASE[key]


@pytest.mark.parametrize("n", [2, 3, 100])
@pytest.mark.parametrize("mode", list(MODES))
def test_chunked_bitwise_bucketed(mode, n):
    state, ms, layout = _bucketed(mode)
    cs, cms, _ = train(config(mode, chunks=n))
    assert_same(state, cs, layout, ms, cms)
    want = min(n, len(layout.segments))
    assert [m["collectives_per_step"] for m in cms] == [float(want)] * 3


@pytest.mark.parametrize("variant", ["chunks3", "perleaf"])
@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "deepseek-moe-16b",
                                  "musicgen-medium"])
def test_new_archs_chunked_and_perleaf_bitwise_bucketed(arch, variant):
    """The smoke variants of the Mamba hybrid, the MoE model and the
    ``embeds`` model, 2 steps of fused Gaussian-k at chunks 3 and per
    leaf: bitwise the bucketed run.  musicgen never reads ``embed``: its
    gradient is zero in the bucket (the group released after the
    backward), so ``embed`` and its residual stay as they were."""
    cfg = get_config(arch).reduced()
    comp = config("gaussiank-fused")
    a, ma, layout = train(comp, steps=2, cfg=cfg)
    if variant == "chunks3":
        b, mb, _ = train(config("gaussiank-fused", chunks=3), steps=2,
                         cfg=cfg)
        assert [m["collectives_per_step"] for m in mb] == [3.0, 3.0]
    else:
        b, mb, _ = train(comp, pipeline="perleaf", steps=2, cfg=cfg)
    assert_same(a, b, layout, ma, mb)
    if cfg.frontend == "embeds":
        (seg,) = [s for s in layout.segments if s.name == "embed"]
        assert torch.equal(a["params"]["embed"],
                           init_params(cfg, 0, "cpu")["embed"])
        assert not a["resid"][:, seg.row_off:seg.row_off + seg.d_row].any()


@pytest.mark.parametrize("strategy", list(MESHES))
def test_chunked_strategies_bitwise_bucketed(strategy):
    mesh = MESHES[strategy]
    state, ms, layout = _bucketed("topk", strategy, mesh)
    cs, cms, _ = train(config("topk", strategy, chunks=3), mesh=mesh)
    assert_same(state, cs, layout, ms, cms)
    levels = {"allgather": 1, "gtopk": 2, "hierarchical": 2,
              "hier_gtopk": 2}[strategy]
    assert [m["collectives_per_step"] for m in cms] == [3.0 * levels] * 3
    assert [m["collectives_per_step"] for m in ms] == [1.0 * levels] * 3


def test_chunked_adaptive_makes_one_allocation_a_step():
    """``variance`` at chunks 4: one allocation a step, its budgets,
    ``K_eff`` and controller state those of the unchunked step."""
    allocs = {1: [], 4: []}

    def recorder(n):
        def probe(rank, k_alloc=None, K_eff=None, **_):
            if k_alloc is not None:
                allocs[n].append((np.asarray(k_alloc).copy(), int(K_eff)))
        return probe

    a, ma, layout = train(config("variance"), probe=recorder(1))
    b, mb, _ = train(config("variance", chunks=4), probe=recorder(4))
    assert len(allocs[1]) == len(allocs[4]) == 3
    for (ka, Ka), (kb, Kb) in zip(allocs[1], allocs[4]):
        np.testing.assert_array_equal(ka, kb)
        assert Ka == Kb == int(ka.sum())
    assert [m["k_total"] for m in ma] == [m["k_total"] for m in mb]
    assert_same(a, b, layout, ma, mb)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX mesh run of every strategy at chunks 3, one subprocess."""
    out = tmp_path_factory.mktemp("jax_mesh") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable,
                        os.path.join(TESTS, "_torch_chunked_ref.py"),
                        str(out), "chunks3"],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    with np.load(out) as data:
        return dict(data)


@pytest.mark.parametrize("strategy", list(MESHES))
def test_local_wire_chunked_matches_jax_mesh(ref, strategy):
    m = mesh_run(ref, "chunks3", strategy, chunks=3)
    per_level = {"allgather": 1, "gtopk": 2, "hierarchical": 2,
                 "hier_gtopk": 2}[strategy]
    assert m["collectives_per_step"] == 3 * per_level


def _events(chunks, loss_fn=None, params=None, fail_at=None):
    """One step at ``chunks``: the ordered probe events."""
    events = []

    def probe(rank, backward=None, release=None, chunk=None, values=None,
              **kw):
        if release is not None:
            if release == fail_at:
                raise RuntimeError(f"hook of chunk {release} failed")
            events.append(("release", release))
        elif backward is not None:
            events.append(("backward", backward))
        elif rank is not None and values is not None:
            events.append(("compressed", chunk))

    comp = config("topk", chunks=chunks)
    params = params if params is not None else init_params(CFG, 0, "cpu")
    layout = tl.build_layout(params, 1, comp)
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=1, model_size=1,
                             compression=comp, layout=layout)
    step = make_train_step(CFG, "1x1", opt, constant(0.05),
                           compression=comp, layout=layout, probe=probe,
                           loss_fn=loss_fn)
    from repro_torch.data import batch_for
    batch = (batch_for(CFG, 0, global_batch=8, seq_len=16, device="cpu")
             if loss_fn is None else {"x": torch.ones(1, 1)})
    state, m = step(state, batch)
    return events, layout, tl.build_chunk_plan(layout, chunks), state, m


def test_hooks_release_chunks_during_the_backward():
    """One chunk a leaf: the chunk of ``lm_head`` (and of ``final_norm``)
    is released and compressed while the backward runs, before ``embed``'s
    gradient exists (its chunk's release); every chunk once."""
    events, layout, plan, _, _ = _events(len(LAYOUTS["small"][0].segments))
    names = [s.name for s in layout.segments]
    chunk_of = {names[g.seg_lo]: g.index for g in plan.groups}
    end = events.index(("backward", False))
    assert events[0] == ("backward", True)
    releases = [e[1] for e in events if e[0] == "release"]
    assert sorted(releases) == list(range(plan.n_chunks))
    pos = {c: events.index(("release", c)) for c in releases}
    for name in ("lm_head", "final_norm/scale"):
        c = chunk_of[name]
        assert pos[c] < end
        assert pos[c] < events.index(("compressed", c)) < \
            pos[chunk_of["embed"]], (name, events)
    # the stacked leaves' gradients complete at the end of the backward,
    # with embed's, but still inside it: every chunk is compressed there
    assert max(events.index(("compressed", c)) for c in releases) < end


def test_unreached_group_releases_zeros_after_the_backward():
    """A leaf the loss never reaches, in a group of its own: its gradient
    hook never fires, so the group is released with zeros after the
    backward; the step is the bucketed step's, bitwise."""
    params = {"a": torch.linspace(-1, 1, 40), "b": torch.linspace(2, 3, 30),
              "c": torch.linspace(0, 1, 20)}

    def loss_fn(p, batch):
        loss = torch.sum(p["a"] ** 2) + torch.sum(p["b"] ** 3)
        return loss, {"loss": loss}

    runs = {}
    for chunks in (1, 3):
        events, layout, plan, state, m = _events(
            chunks, loss_fn, {k: v.clone() for k, v in params.items()})
        runs[chunks] = (state, m)
    end = events.index(("backward", False))
    assert events.index(("compressed", 2)) > events.index(("release", 2)) \
        > end > events.index(("compressed", 0))
    assert_same(runs[1][0], runs[3][0], layout,
                [{k: float(v) for k, v in runs[1][1].items()}],
                [{k: float(v) for k, v in runs[3][1].items()}])


def test_a_failing_hook_raises():
    with pytest.raises(RuntimeError, match="hook of chunk 1 failed"):
        _events(3, fail_at=1)


def test_chunks_need_the_bucketed_sparse_pipeline():
    comp = config("topk", chunks=2)
    opt = sgd_momentum(0.9)
    with pytest.raises(ValueError, match="chunks > 1 needs the bucketed"):
        make_train_step(CFG, "1x1", opt, constant(0.1), compression=comp)
    with pytest.raises(ValueError, match="chunks > 1 needs the bucketed"):
        make_train_step(CFG, "1x1", opt, constant(0.1),
                        compression=comp.replace(compressor="none"))
    base = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1", "--device",
            "cpu",
            "--steps", "1"]
    for extra, msg in ((["--chunks", "0"], "must be >= 1"),
                       (["--chunks", "2", "--pipeline", "perleaf"],
                        "needs the bucketed sparse pipeline"),
                       (["--chunks", "2", "--compressor", "none"],
                        "needs the bucketed sparse pipeline")):
        with pytest.raises(SystemExit, match=msg):
            cli.run(base + extra)


def test_checkpoint_at_chunks_1_resumes_at_chunks_4(tmp_path):
    """The state does not depend on the chunk count: 2 steps at chunks 1,
    saved, loaded into a fresh state and 2 more at chunks 4 equal 4
    straight steps, bitwise."""
    straight, ms, layout = train(config("gaussiank-fused"), steps=4)
    first, _, _ = train(config("gaussiank-fused"), steps=2)
    save_state(str(tmp_path / "c1.npz"), first)
    comp = config("gaussiank-fused", chunks=4)
    fresh = init_train_state(init_params(CFG, 1, "cpu"), sgd_momentum(0.9),
                             workers=1, model_size=1, compression=comp,
                             layout=layout)
    fresh = load_state(str(tmp_path / "c1.npz"), fresh)
    resumed, rms, _ = train(comp, state=fresh, steps=2, first_step=2)
    assert_same(straight, resumed, layout, ms[2:], rms)


@pytest.mark.parametrize("W", [2, 4])
def test_process_group_wire_gloo_chunked_bitwise_local(tmp_path, W):
    logs = pg_run(tmp_path, W, ["--chunks", "3"])
    assert "chunks=3" in logs[0]
