"""Slice 3, adaptive layer-wise density, as a whole: the port against the
JAX package on the CPU, at the 2-layer config (d_model 64).

* Pass A (``fused_pass_a``, ``segmented_pass_a``) against the
  reference's in interpret mode: sums within f32 reassociation (``s``
  within ``1e-5 · Σ|u|``, ``sq`` within rtol 1e-5, as
  ``test_torch_kernels.py``), ``max|u|`` bitwise, the hist-k thresholds
  read off the histograms equal.
* ``bucket_compress(k_alloc=, seg_stats=)`` on both backends against
  the composed JAX chain (pass A, the signal, the budget and
  ``allocate``, ``bucket_compress(backend=, k_alloc=, seg_stats=)``,
  outside ``shard_map``): the allocation equal, values, indices and the
  new residual bitwise, conservation bitwise.  The port forms ``u = G +
  E`` in the residual bucket first (its memory-saving worker order);
  that order is also held bitwise against compressing ``(G, E)``.
* Three training steps per policy (uniform, variance, absmax, with EMA,
  with the DGC warmup, with the norm-decay global-k controller) against
  the same composed chain around ``jax.value_and_grad`` and
  ``sgd_momentum``: losses within rtol 1e-4, params within rtol 1e-4 /
  atol 1e-5 (the gradients differ from XLA's by f32 summation order, as
  in ``test_torch_train.py``), the per-step ``k_alloc`` equal as
  integers, ``sum(k) == K_eff`` every step.
* W = 4 workers (allgather, gtopk, hierarchical, hier_gtopk) against
  the JAX mesh train step on 4 forced host devices
  (``tests/_torch_adaptive_ref.py``, ``backend="reference"``, topk at
  0.02, ``variance``): as ``test_torch_dist.py``, plus ``k_total`` and
  the allocation (recomputed from the reference's pmean'd signal) equal.
* ``ProcessGroupWire`` over gloo in 2 processes bitwise equal to
  ``LocalWire`` under adaptive density.
* Checkpoints with ``adaptk/*`` keys both ways, the ``gnorm`` zero-fill,
  resume equal to a straight run bitwise.
* The CLI: the llama3.2-1b default trains ``variance``; trimmed-k
  without a policy trains fixed-k (it is not a dynamic-k compressor);
  an adaptive policy with a fixed-k compressor fails with the
  reference's words; ``--global-k-policy`` without a policy exits.
"""
import functools
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_state as j_load
from repro.checkpoint import save_state as j_save
from repro.core import adaptk as ja
from repro.core import codec as jcodec
from repro.core.compression import CompressionConfig as JCompression
from repro.core.compressors import get_compressor as j_get
from repro.dist import aggregate as jagg
from repro.dist import layout as jl
from repro.kernels.ef_fused import ops as jops
from repro.kernels.ef_fused.segmented import segmented_pass_a as j_spa
from repro.models import init_params as j_init
from repro.models import loss_fn as j_loss
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import sgd_momentum as j_sgd
from repro.train import init_train_state as j_state
from repro_torch import tree
from repro_torch.checkpoint import load_state, save_state
from repro_torch.configs import get_config
from repro_torch.core import adaptk as ta
from repro_torch.core import codec
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.compressors import get_compressor
from repro_torch.dist import aggregate as tagg
from repro_torch.dist.layout import build_layout, init_flat_residual
from repro_torch.kernels.ef_fused import ops as tops
from repro_torch.kernels.ef_fused.segmented import (segmented_pass_a,
                                                    stats_to_host)
from repro_torch.kernels.histk.ops import threshold_from_histogram
from repro_torch.launch import train as cli
from repro_torch.launch.mesh import data_world_size, parse_mesh
from repro_torch.models import ModelConfig, from_jax_params, init_params
from repro_torch.optim import constant, sgd_momentum
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
_CFG = dict(name="sys", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
JCFG = JModelConfig(**_CFG).validate()
TCFG = ModelConfig(**_CFG).validate()
RATIO, LR, STEPS = 0.02, 0.1, 3


@functools.lru_cache(maxsize=None)
def _jparams():
    return j_init(JCFG, jax.random.PRNGKey(0))


def _tparams():
    return from_jax_params(jax.tree.map(np.asarray, _jparams()), "cpu")


def _layouts(name, jpol):
    jlay = jl.build_layout(_jparams(), 1, RATIO, j_get(name),
                           density_policy=jpol)
    tlay = build_layout(_tparams(), 1, RATIO, get_compressor(name),
                        density_policy=ta.DensityPolicy(*jpol))
    return jlay, tlay


def _ranges(lay):
    return [(s.row_off, s.d_row) for s in lay.segments]


@functools.lru_cache(maxsize=None)
def _jax_fns(name, backend, jlay):
    """The reference's pass A and bucket compression for one layout,
    compiled once."""
    pass_a = jax.jit(lambda G, E: j_spa(G, E, _ranges(jlay), name))
    compress = jax.jit(lambda G, E, k, st: jagg.bucket_compress(
        G, E, jlay, j_get(name), None, backend=backend, k_alloc=k,
        seg_stats=st))
    return pass_a, compress


def _jax_allocation(jlay, name, backend, G, E, jpol, state, step):
    """The reference's pass A -> signal -> budget -> allocation of
    ``_aggregate_bucketed`` at world 1 (the pmean of one worker is the
    identity), composed from its public functions."""
    pass_a, _ = _jax_fns(name, backend, jlay)
    if backend == "fused":
        st = pass_a(G, E)
        moments = [jagg._stats_reduce(rs) for rs in st]
    else:
        st = None
        moments = [jagg.pass_a_stats_rows(G[:, a:a + n], E[:, a:a + n], name,
                                          False)[1]
                   for a, n in _ranges(jlay)]
    segs = jlay.segments
    sigs = [ja.leaf_signal(jpol.policy, s.size, *m)
            for s, m in zip(segs, moments)]
    red = jnp.stack(sigs)
    globalk = jpol.global_policy != "none"
    if globalk:
        red = jnp.concatenate(
            [red, jnp.asarray(sum(m[1] for m in moments),
                              jnp.float32).reshape(1)])
    signal = red[:-1] if globalk else red
    signal, new_state = ja.blend_signal(state, signal, jpol.ema)
    K = ja.budget([s.size for s in segs], RATIO, jpol, jnp.int32(step))
    if globalk:
        scale, upd = ja.global_scale(new_state, red[-1], jpol)
        K = ja.scale_budget(K, scale)
        new_state = {**new_state, **upd}
    k, K_eff = ja.allocate(K, signal, [s.k_lo for s in segs],
                           [s.k_hi for s in segs])
    return st, k, K_eff, new_state


# ---------------------------------------------------------------------------
# pass A and the dynamic-k bucket compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["gaussiank", "histk"])
def test_pass_a_matches_reference(name):
    jlay, tlay = _layouts(name, ja.make_policy())
    rng = np.random.default_rng(3)
    G = rng.standard_normal((1, jlay.d_row_total)).astype(np.float32)
    E = (0.2 * rng.standard_normal(G.shape)).astype(np.float32)
    pass_a, _ = _jax_fns(name, "fused", jlay)
    jst = pass_a(jnp.asarray(G), jnp.asarray(E))
    tst = stats_to_host(segmented_pass_a(torch.from_numpy(G),
                                         torch.from_numpy(E),
                                         _ranges(tlay), name))
    for s, jrows, trows in zip(tlay.segments, jst, tst):
        (js, jsq, jmx, jh), (ts, tsq, tmx, th) = jrows[0], trows[0]
        u = (G + E)[0, s.row_off:s.row_off + s.d_row]
        assert abs(float(ts) - float(js)) <= 1e-5 * float(np.abs(u).sum())
        np.testing.assert_allclose(float(tsq), float(jsq), rtol=1e-5)
        assert np.float32(tmx) == np.float32(jmx)
        if name == "histk":
            pad = (-s.d_row) % tops.tuning.resolve_config(
                s.d_row, "torch").stats_block
            k = s.k_hi
            assert threshold_from_histogram(th, k) == np.float32(
                jops.threshold_from_histogram(jh, k, pad))
        else:
            assert jh is None and th is None
    # one row on its own: fused_pass_a is the row's entry
    row = tops.fused_pass_a(torch.from_numpy(G[0, :4096]),
                            torch.from_numpy(E[0, :4096]), name)
    assert row[0].shape == () and (row[3] is None) == (name != "histk")


@pytest.mark.parametrize("name,backend", [
    ("gaussiank", "fused"), ("gaussiank2", "fused"), ("histk", "fused"),
    ("topk", "reference"), ("gaussiank", "reference"),
    ("histk", "reference")])
def test_bucket_compress_dynamic_matches_composed_chain(name, backend):
    jpol = ja.make_policy("variance")
    jlay, tlay = _layouts(name, jpol)
    assert [(s.k_lo, s.k_hi, s.k_row, s.k_cap) for s in tlay.segments] == \
        [(s.k_lo, s.k_hi, s.k_row, s.k_cap) for s in jlay.segments]
    rng = np.random.default_rng(5)
    G = rng.standard_normal((1, jlay.d_row_total)).astype(np.float32)
    E = (0.2 * rng.standard_normal(G.shape)).astype(np.float32)
    jst, jk, jK, _ = _jax_allocation(jlay, name, backend, jnp.asarray(G),
                                     jnp.asarray(E), jpol, None, 0)
    _, compress = _jax_fns(name, backend, jlay)
    jv, ji, jE, _ = compress(jnp.asarray(G), jnp.asarray(E), jk, jst)
    # the port: u in the residual bucket, pass A on u, the allocation
    spec = get_compressor(name)
    Et = torch.from_numpy(E.copy())
    u = Et.add_(torch.from_numpy(G))
    st, moments = tagg._pass_a(u, tlay, spec, backend == "fused")
    sigs = [ta.leaf_signal("variance", s.size, *m)
            for s, m in zip(tlay.segments, moments)]
    tk, tK = ta.allocate(ta.budget([s.size for s in tlay.segments], RATIO,
                                   ta.DensityPolicy(*jpol)), sigs,
                         [s.k_lo for s in tlay.segments],
                         [s.k_hi for s in tlay.segments])
    np.testing.assert_array_equal(tk, np.asarray(jk))
    assert int(tK) == int(jK) == int(tk.sum())
    tv, ti, tE = tagg.bucket_compress(None, Et, tlay, spec, backend=backend,
                                      k_alloc=tk, seg_stats=st)
    assert tE is Et
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tE.numpy(), np.asarray(jE))
    dec = codec.decode(tv[0], ti[0], tlay.d_row_total)
    assert torch.equal(dec + tE[0], torch.from_numpy(G[0] + E[0]))
    assert int(codec.nnz(ti)) <= tlay.k_cap_total


@pytest.mark.parametrize("backend", ["fused", "reference"])
@pytest.mark.parametrize("strategy,mesh", [("allgather", "4x1"),
                                           ("hierarchical", "2x2x1")])
def test_u_in_place_order_equals_keeping_G(backend, strategy, mesh):
    """The aggregation's worker order (``E += G`` in place, pass A on
    ``u``, ``G`` dropped, ``u`` compressed after the allocation) against
    the order that keeps every ``G_w`` and compresses ``(G_w, E_w)``:
    every worker's pair and residual, and the mean, bitwise."""
    name = "gaussiank" if backend == "fused" else "topk"
    pol = ta.make_policy("absmax")
    spec = get_compressor(name)
    tlay = build_layout(_tparams(), 1, RATIO, spec, density_policy=pol)
    W = 4
    rng = np.random.default_rng(6)
    Gs = [rng.standard_normal((1, tlay.d_row_total)).astype(np.float32)
          for _ in range(W)]
    E0 = (0.1 * rng.standard_normal((W, tlay.flat_size))).astype(np.float32)
    grads = [_unpack(tlay, G) for G in Gs]
    seen, k_seen = {}, {}

    def probe(rank, **kw):
        if rank is not None and "values" in kw:
            seen[rank] = (kw["values"].clone(), kw["indices"].clone(),
                          kw["new_E"].clone())
        elif "k_alloc" in kw:
            k_seen["k"] = kw["k_alloc"]
    resid = torch.from_numpy(E0.copy())
    comp = CompressionConfig(compressor=name, ratio=RATIO, backend=backend,
                             density_policy=pol)
    from repro_torch.dist.wire import LocalWire
    wire = LocalWire(parse_mesh(mesh))
    R2 = (init_flat_residual(tlay, workers=W, device="cpu")
          if strategy == "hierarchical" else None)
    res = tagg.aggregate_bucketed(grads, resid, tlay, comp.replace(
        strategy=strategy), wire=wire, resid2=R2, probe=probe)
    # the other order: stats of (G_w, E_w), one allocation, compress each
    fused = backend == "fused"
    stats, sigs = [], []
    for w in range(W):
        G = torch.from_numpy(Gs[w])
        E = torch.from_numpy(E0[w].reshape(1, -1).copy())
        if fused:
            st = stats_to_host(segmented_pass_a(G, E, _ranges(tlay), name))
            moments = [tagg._stats_reduce(r) for r in st]
        else:
            st, moments = tagg._pass_a(E + G, tlay, spec, False)
        stats.append(st)
        sigs.append([ta.leaf_signal("absmax", s.size, *m)
                     for s, m in zip(tlay.segments, moments)])
    k, _, _ = tagg._adaptive_allocation(
        None, sigs, [[0.0]] * W, [s.size for s in tlay.segments], RATIO,
        pol, 0, [s.k_lo for s in tlay.segments],
        [s.k_hi for s in tlay.segments], wire)
    np.testing.assert_array_equal(k, k_seen["k"])
    for w in range(W):
        E = torch.from_numpy(E0[w].reshape(1, -1).copy())
        v, i, nE = tagg.bucket_compress(torch.from_numpy(Gs[w]), E, tlay,
                                        spec, backend=backend, k_alloc=k,
                                        seg_stats=stats[w])
        assert torch.equal(v, seen[w][0]) and torch.equal(i, seen[w][1])
        assert torch.equal(nE, seen[w][2])
    assert res.metrics["k_total"] == float(k.sum())


def _unpack(lay, G):
    like = _tparams()
    return tree.unflatten(tree.flatten(like)[1], [
        torch.from_numpy(G[0, s.row_off:s.row_off + s.size].copy()).view(
            s.shape) for s in lay.segments])


# ---------------------------------------------------------------------------
# three training steps per policy against the composed reference
# ---------------------------------------------------------------------------


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, JCFG.vocab_size, (4, 16)).astype(np.int32)
        out.append({"tokens": toks, "labels": np.roll(toks, -1, axis=1)})
    return out


def _jax_train(name, backend, jpol):
    jlay = jl.build_layout(_jparams(), 1, RATIO, j_get(name),
                           density_policy=jpol)
    _, compress = _jax_fns(name, backend, jlay)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda q, b: j_loss(q, JCFG, b, remat=False), has_aux=True))
    opt = j_sgd(0.9)
    p = _jparams()
    ostate = opt.init(p)
    D = jlay.d_row_total
    E = jnp.zeros((1, D), jnp.float32)
    astate = ja.init_controller_state(
        len(jlay.segments), global_k=jpol.global_policy != "none")
    losses, ks = [], []
    for step, b in enumerate(_batches()):
        (loss, _), g = grad_fn(p, {k: jnp.asarray(v) for k, v in b.items()})
        G = jl.pack_grads(jlay, g, jnp.float32)
        st, k, K_eff, astate = _jax_allocation(jlay, name, backend, G, E,
                                               jpol, astate, step)
        v, i, E, _ = compress(G, E, k, st)
        g = jl.unpack_tree(jlay, jcodec.decode(v[0], i[0], D)[None], like=g)
        p, ostate = opt.update(p, ostate, g, jnp.float32(LR))
        losses.append(float(loss))
        ks.append((np.asarray(k), int(K_eff)))
    return losses, ks, p


_POLICIES = {
    "variance": dict(),
    "uniform": dict(),
    "absmax": dict(),
    "variance-ema": dict(ema=0.5),
    "uniform-warmup": dict(warmup_steps=2, warmup_mult=16.0),
    "variance-normdecay": dict(global_policy="normdecay", global_ema=0.5,
                               global_floor=0.3),
}


@pytest.mark.parametrize("name,backend,case", [
    ("gaussiank", "fused", c) for c in _POLICIES] + [
    ("histk", "fused", "absmax"), ("topk", "reference", "variance-ema"),
    ("gaussiank2", "fused", "uniform-warmup")])
def test_three_steps_match_composed_reference(name, backend, case):
    jpol = ja.make_policy(case.split("-")[0], **_POLICIES[case])
    jlosses, jks, jfinal = _jax_train(name, backend, jpol)
    tpol = ta.DensityPolicy(*jpol)
    params = _tparams()
    comp = CompressionConfig(compressor=name, ratio=RATIO, backend=backend,
                             density_policy=tpol)
    layout = build_layout(params, 1, comp)
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=1, model_size=1,
                             compression=comp, layout=layout)
    assert sorted(state["adaptk"]) == sorted(
        ["signal", "count"] + (["gnorm", "gnorm0"] if "normdecay" in case
                               else []))
    tks = []
    step = make_train_step(TCFG, (1, 1), opt, constant(LR),
                           compression=comp, layout=layout,
                           probe=lambda rank, **kw: tks.append(
                               kw["k_alloc"]) if "k_alloc" in kw else None)
    tlosses = []
    for b in _batches():
        state, m = step(state, {k: torch.from_numpy(v).long()
                                for k, v in b.items()})
        tlosses.append(float(m["loss"]))
        assert m["density"] <= m["density_cap"]
        assert m["k_total"] == float(tks[-1].sum())
    for (jk, jK), tk in zip(jks, tks):
        np.testing.assert_array_equal(tk, jk)
        assert int(tk.sum()) == jK
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(jfinal), tree.leaves(state["params"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)
    assert state["step"] == STEPS and int(state["adaptk"]["count"]) == STEPS
    if case == "uniform-warmup":
        # 16x at step 0, 4x at step 1, 1x from step 2 on
        assert [int(k.sum()) for k in tks] == [jK for _, jK in jks]
        assert int(tks[0].sum()) > int(tks[1].sum()) > int(tks[2].sum())


def test_step_needs_the_controller_state_for_ema():
    pol = ta.make_policy(ema=0.5)
    params = _tparams()
    comp = CompressionConfig(ratio=RATIO, density_policy=pol)
    layout = build_layout(params, 1, comp)
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=1, model_size=1,
                             compression=comp, layout=layout)
    del state["adaptk"]
    step = make_train_step(TCFG, (1, 1), opt, constant(LR),
                           compression=comp, layout=layout)
    b = {k: torch.from_numpy(v).long() for k, v in _batches()[0].items()}
    with pytest.raises(ValueError, match="needs the controller state"):
        step(state, b)
    with pytest.raises(ValueError, match="density mode"):
        make_train_step(TCFG, (1, 1), opt, constant(LR), compression=comp,
                        layout=build_layout(params, 1, RATIO,
                                            get_compressor("gaussiank")))


# ---------------------------------------------------------------------------
# W = 4 against the JAX mesh run, and the process-group wire
# ---------------------------------------------------------------------------

MESHES = {"allgather": "4x1", "gtopk": "4x1", "hierarchical": "2x2x1",
          "hier_gtopk": "2x2x1"}
METRICS = ("density", "density_cap", "comm_bits_sparse", "comm_bits_dense",
           "wire_bytes", "collectives_per_step", "k_total",
           "density_budget")


@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    """The JAX mesh run of every strategy, one subprocess (~45 s)."""
    out = tmp_path_factory.mktemp("jax_adaptive_mesh") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable,
                        os.path.join(TESTS, "_torch_adaptive_ref.py"),
                        str(out)], env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    with np.load(out) as data:
        return dict(data)


@pytest.mark.parametrize("strategy", list(MESHES))
def test_local_wire_matches_jax_mesh(mesh_ref, strategy):
    ref = mesh_ref
    tcfg = ModelConfig(**dict(_CFG, name="t")).validate()
    params = from_jax_params(jax.tree.map(np.asarray, j_init(
        JModelConfig(**dict(_CFG, name="t")).validate(),
        jax.random.PRNGKey(0))), "cpu")
    for i, leaf in enumerate(tree.leaves(params)):
        np.testing.assert_array_equal(leaf.numpy(), ref[f"init/{i}"])
    pol = ta.make_policy("variance")
    comp = CompressionConfig(compressor="topk", ratio=0.02,
                             strategy=strategy, backend="reference",
                             density_policy=pol)
    layout = build_layout(params, 1, comp)
    mesh = parse_mesh(MESHES[strategy])
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=data_world_size(mesh),
                             model_size=1, compression=comp, layout=layout)
    tks = []
    step = make_train_step(tcfg, mesh, opt, constant(0.05),
                           compression=comp, layout=layout,
                           probe=lambda rank, **kw: tks.append(
                               kw["k_alloc"]) if "k_alloc" in kw else None)
    segs = layout.segments
    for s in range(2):
        batch = {k: torch.from_numpy(ref[f"batch/{s}/{k}"]).long()
                 for k in ("tokens", "labels")}
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]),
                                   ref[f"{strategy}/{s}/loss"], rtol=1e-4)
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]),
                                       ref[f"{strategy}/{s}/{k}"],
                                       rtol=1e-6, err_msg=k)
        jsig = ref[f"{strategy}/{s}/signal"]
        np.testing.assert_allclose(state["adaptk"]["signal"], jsig,
                                   rtol=1e-4)
        jk, _ = ja.allocate(
            ja.budget([x.size for x in segs], 0.02, ja.make_policy()),
            jnp.asarray(jsig), [x.k_lo for x in segs],
            [x.k_hi for x in segs])
        np.testing.assert_array_equal(tks[-1], np.asarray(jk))
    for i, leaf in enumerate(tree.leaves(state["params"])):
        np.testing.assert_allclose(leaf.numpy(),
                                   ref[f"{strategy}/params/{i}"],
                                   rtol=1e-4, atol=1e-5)
    for key in ["resid"] + (["resid2"] if strategy.startswith("hier")
                            else []):
        np.testing.assert_allclose(state[key].numpy(),
                                   ref[f"{strategy}/{key}"], rtol=1e-4,
                                   atol=1e-5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_PG = {"allgather": "2x1", "gtopk": "2x1", "hierarchical": "2x1x1",
       "hier_gtopk": "2x1x1"}
_ADAPTIVE = ["--density-policy", "variance", "--density-ema", "0.5",
             "--global-k-policy", "normdecay"]


def test_process_group_wire_gloo_bitwise_local(tmp_path):
    """Two ranks over gloo against the same two workers in one process,
    adaptive (``variance`` with EMA and norm decay): params, momentum,
    residuals, the controller state and the losses bitwise."""
    W = 2
    cases = [f"{s}:{m}:{_free_port()}" for s, m in _PG.items()]
    procs = []
    for r in range(W):
        env = dict(os.environ, PYTHONPATH=SRC, RANK=str(r),
                   WORLD_SIZE=str(W), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(W), MASTER_ADDR="127.0.0.1",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "_torch_dist_pg.py"),
             str(tmp_path), "cpu"] + cases + ["--"] + _ADAPTIVE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert "density_policy=variance global_k=normdecay" in logs[0]
    for strategy, mesh in _PG.items():
        name = f"{strategy}-{mesh}"
        local = tmp_path / f"local-{name}.npz"
        recs = cli.run(["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1",
                        "--device",
                        "cpu", "--steps", "2", "--batch", "4", "--seq",
                        "16", "--mesh", mesh, "--strategy", strategy,
                        "--host-devices", str(W), "--checkpoint",
                        str(local)] + _ADAPTIVE)
        with np.load(local) as a, np.load(tmp_path / f"{name}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            assert {"adaptk/signal", "adaptk/count", "adaptk/gnorm",
                    "adaptk/gnorm0"} <= set(a.files)
            for key in a.files:
                assert a[key].tobytes() == b[key].tobytes(), key
        with open(tmp_path / f"{name}.json") as f:
            pg = json.load(f)
        for k in ("loss", "density", "k_total"):
            assert [r[k] for r in recs] == [r[k] for r in pg], k


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _jax_state(global_policy):
    jpol = ja.make_policy(ema=0.5, global_policy=global_policy)
    jcomp = JCompression(ratio=RATIO, density_policy=jpol)
    jlay = jl.build_layout(_jparams(), 1, RATIO, j_get("gaussiank"),
                           density_policy=jpol)
    st = j_state(_jparams(), j_sgd(0.9), workers=1, model_size=1,
                 compression=jcomp, layout=jlay)
    rng = np.random.default_rng(12)
    st["adaptk"] = {k: jnp.asarray(rng.uniform(0.1, 5, np.shape(v)).astype(
        np.asarray(v).dtype)) for k, v in st["adaptk"].items()}
    st["adaptk"]["count"] = jnp.int32(7)
    return st, jpol


def _port_state(jpol):
    comp = CompressionConfig(ratio=RATIO,
                             density_policy=ta.DensityPolicy(*jpol))
    params = _tparams()
    return init_train_state(params, sgd_momentum(0.9), workers=1,
                            model_size=1, compression=comp,
                            layout=build_layout(params, 1, comp))


def test_checkpoint_adaptk_both_ways(tmp_path):
    jst, jpol = _jax_state("normdecay")
    j_save(str(tmp_path / "j.npz"), jst)
    tst = load_state(str(tmp_path / "j.npz"), _port_state(jpol))
    for k, v in jst["adaptk"].items():
        assert isinstance(tst["adaptk"][k], np.ndarray)
        np.testing.assert_array_equal(tst["adaptk"][k], np.asarray(v))
        assert tst["adaptk"][k].dtype == np.asarray(v).dtype
    save_state(str(tmp_path / "t.npz"), tst)
    back = j_load(str(tmp_path / "t.npz"), jst)
    with np.load(tmp_path / "t.npz") as f:
        assert {"adaptk/signal", "adaptk/count", "adaptk/gnorm",
                "adaptk/gnorm0"} <= set(f.files)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jst)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_without_gnorm_is_zero_filled(tmp_path):
    """A checkpoint from before the global-k controller (no
    ``adaptk/gnorm``/``gnorm0``) loads into a ``normdecay`` state with
    both zero, in the port as in the reference."""
    jst, _ = _jax_state("none")
    j_save(str(tmp_path / "old.npz"), jst)
    _, jpol = _jax_state("normdecay")
    tst = load_state(str(tmp_path / "old.npz"), _port_state(jpol))
    assert float(tst["adaptk"]["gnorm"]) == float(tst["adaptk"]["gnorm0"]) \
        == 0.0
    np.testing.assert_array_equal(tst["adaptk"]["signal"],
                                  np.asarray(jst["adaptk"]["signal"]))
    jnew, _ = _jax_state("normdecay")
    jback = j_load(str(tmp_path / "old.npz"), jnew)
    assert float(jback["adaptk"]["gnorm"]) == 0.0
    with pytest.raises(KeyError):
        load_state(str(tmp_path / "old.npz"),
                   dict(_port_state(jpol), extra=np.zeros(2, np.float32)))


_SMOKE = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1", "--device",
          "cpu",
          "--batch", "4", "--seq", "16", "--log-every", "1"]


@pytest.mark.parametrize("extra", [
    ["--density-ema", "0.5", "--global-k-policy", "normdecay"],
    ["--density-policy", "uniform", "--density-warmup", "3",
     "--host-devices", "2", "--mesh", "2x1", "--strategy", "gtopk"]])
def test_resume_equals_straight_run(tmp_path, extra):
    """2 steps, saved, resumed for 1 step: the same as 3 steps straight,
    bitwise, the controller state included."""
    a, b, c = (str(tmp_path / n) for n in ("a.npz", "b.npz", "c.npz"))
    cli.run(_SMOKE + extra + ["--steps", "2", "--checkpoint", a])
    recs = cli.run(_SMOKE + extra + ["--steps", "1", "--resume", a,
                                     "--checkpoint", b])
    assert [r["step"] for r in recs] == [2]
    cli.run(_SMOKE + extra + ["--steps", "3", "--checkpoint", c])
    with np.load(b) as x, np.load(c) as y:
        assert sorted(x.files) == sorted(y.files)
        assert int(x["step"]) == 3 and int(x["adaptk/count"]) == 3
        for k in x.files:
            assert x[k].tobytes() == y[k].tobytes(), k


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_llama_default_trains_variance(capsys):
    """llama3.2-1b's config defaults to ``variance``: with no
    ``--density-policy`` the trainer runs it, every step's ``k_total``
    the budget reckoned from the layout."""
    recs = cli.run(_SMOKE + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "density_policy=variance global_k=none" in out
    assert "k_total=" in out
    cfg = get_config("llama3.2-1b").reduced()
    lay = build_layout(init_params(cfg, 0, "meta"), 1, 0.001,
                       get_compressor("gaussiank"),
                       density_policy=ta.make_policy())
    K = int(ta.budget([s.size for s in lay.segments], 0.001,
                      ta.make_policy()))
    for r in recs:
        assert r["k_total"] == K
        assert 0 < r["density"] <= r["density_cap"]
        assert np.isfinite(r["loss"])


def test_cli_trimmedk_without_a_policy_trains_fixed_k(capsys):
    """Trimmed-k is not a dynamic-k compressor, so the arch default does
    not apply to it (the reference's DYNAMIC_COMPRESSORS): it trains
    fixed-k, as in the reference, instead of raising on the adaptive
    path."""
    recs = cli.run(_SMOKE + ["--steps", "2", "--compressor", "trimmedk"])
    out = capsys.readouterr().out
    assert "density_policy=fixed-k" in out
    assert all("k_total" not in r for r in recs)
    assert all(np.isfinite(r["loss"]) for r in recs)


def test_cli_adaptive_with_a_fixed_k_compressor_fails_as_the_reference():
    with pytest.raises(ValueError) as jerr:
        jagg._wire_config("allgather", ("data",), None, 1, 0.0, True,
                          j_get("trimmedk"))
    with pytest.raises(ValueError) as terr:
        cli.run(_SMOKE + ["--steps", "1", "--compressor", "trimmedk",
                          "--density-policy", "variance"])
    assert str(terr.value) == str(jerr.value)
    # dgck has no dynamic-k path: the reference's words too
    with pytest.raises(ValueError) as jerr:
        jagg._wire_config("allgather", ("data",), None, 1, 0.0, True,
                          j_get("dgck"))
    with pytest.raises(ValueError) as terr:
        cli.run(_SMOKE + ["--steps", "1", "--compressor", "dgck",
                          "--density-policy", "variance"])
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="fixed-k only"):
        tagg._wire_config("allgather", tagg._one_data_axis_wire(1), False,
                          0.5, True, get_compressor("gaussiank"))


def test_cli_global_k_needs_an_adaptive_policy():
    with pytest.raises(SystemExit, match="needs an adaptive"):
        cli.run(_SMOKE + ["--steps", "1", "--global-k-policy", "normdecay",
                          "--density-policy", "none"])
