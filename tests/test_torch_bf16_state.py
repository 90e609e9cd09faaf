"""bf16 state end to end on the CPU, against the JAX package: the dry run
counted at the reference's bf16 dtypes, checkpoints of bf16 state, and
serving (prefill, decode, the publisher and the replica) at bf16.

* The dry run (``launch/dryrun.py``): a record's param, momentum,
  residual and cache bytes equal the reference's closed forms, exactly:
  the ``nbytes`` of ``jax.eval_shape`` of ``repro.models.init_params``
  on the reference's ``_bf16`` config, of ``repro.train.init_train_state
  (..., resid_dtype=jnp.bfloat16)`` and of ``repro.models.init_cache(...,
  jnp.bfloat16)``, each leaf divided by the reference's
  ``dist.sharding`` specs (``param_specs``, ``serve_param_specs`` in
  mode 2d, ``cache_specs``) at ``2x2``; a dense llama, an MoE and an
  embeds frontend, at their smoke variants.
* Checkpoints (``checkpoint/npz.py``): a bf16 train state (bf16
  params, momentum and residual) round-trips bitwise, bucketed and per
  leaf; a file the reference's ``save_state`` writes from a bf16 state
  loads bitwise, and the port's file of that state has the same entries
  (dtype strings and bytes); a per-leaf bf16 checkpoint migrates into
  the buckets bitwise; the tensor-parallel ``shard`` cut at bf16 is
  bitwise the cut of the whole leaves; a ``|V2`` entry into a non-bf16
  leaf raises naming the key; resume at bf16 equals the straight run
  bitwise (port against port: the reference's bf16 train step does not
  run on this jax, ROADMAP's reference caveats).
* Serving at bf16 params and activations: prefill and decode with a
  bf16 cache against the reference's ``prefill`` and ``decode_step``
  (llama3.2-1b's smoke variant, batch 2, prompt 8, 8 decode steps): the
  greedy tokens equal, and the logits and every cache leaf within
  :func:`_bf16_tol`, 4 bf16 ulps of the largest magnitude (XLA and
  torch round the bf16 activations at other points: 1-2 ulps seen).
  xlstm-125m's smoke forward at bf16 (its sLSTM's f32 state times the
  bf16 recurrent weights) within the same tolerance.  The ``topk``
  publisher at model size 1 and 2, with the default f32 stream and a
  bf16 stream, over a drift that makes equal magnitudes common: every
  message, ``pub``, ``resid`` and the replica after
  ``apply_message`` bitwise the reference's.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import save_state as j_save
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.core.compression import CompressionConfig as JCC
from repro.dist import sharding as jshd
from repro.dist.layout import build_layout as j_build_layout
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init
from repro.models import prefill as j_prefill
from repro.optim import sgd_momentum as j_sgd
from repro.serve import apply_message as j_apply_message
from repro.serve import init_publisher_state as j_init_pub
from repro.serve import publish as j_publish
from repro.serve.steps import serve_param_specs as j_serve_specs
from repro.train import init_train_state as j_state
from repro_torch import prng, tree
from repro_torch.checkpoint import load_state, save_state
from repro_torch.configs import get_config
from repro_torch.core.compression import CompressionConfig
from repro_torch.dist.layout import build_layout
from repro_torch.dist.tensor_parallel import (check_split, shard_params,
                                              state_shard_fn)
from repro_torch.launch import dryrun
from repro_torch.models import (decode_step, forward, from_jax_params,
                                init_params, prefill)
from repro_torch.optim import constant, sgd_momentum
from repro_torch.serve import (RESYNC, apply_message, init_publisher_state,
                               publish)
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(2)

BF16 = dict(param_dtype="bfloat16", activation_dtype="bfloat16")


def _cfgs(arch):
    return (dataclasses.replace(j_get_config(arch).reduced(), **BF16),
            dataclasses.replace(get_config(arch).reduced(), **BF16))


def _bits(x):
    """numpy bits of a jax array or a tensor (bf16 as int16, f32 as
    int32; integers as they are)."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    if x.dtype == np.float32:
        return x.view(np.int32)
    return x


# ---------------------------------------------------------------------------
# the dry run at the reference's bf16 dtypes
# ---------------------------------------------------------------------------

# a stand-in for the reference's 2x2 mesh: its spec helpers read only the
# axis names and the device grid's shape
_MESH = types.SimpleNamespace(axis_names=("data", "model"),
                              devices=np.empty((2, 2)))
W = M = 2


def _per_card(shapes, specs) -> float:
    """Per-card bytes of a tree of shape structs under ``specs``: a dim
    on ``model`` divides by M, one on the data axis by W."""
    total = 0.0
    for leaf, spec in zip(jax.tree.leaves(shapes), jax.tree.leaves(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))):
        div = 1
        for entry in spec:
            if entry == "model":
                div *= M
            elif entry is not None:
                div *= W
        total += leaf.size * leaf.dtype.itemsize / div
    return total


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b",
                                  "musicgen-medium"])
def test_dryrun_bytes_equal_the_references_bf16_closed_forms(arch):
    """Train, prefill and decode records at ``2x2``: the param,
    momentum, residual and cache bytes the reference's bf16 shapes and
    specs give, exactly; ``--codec-dtype`` unset keeps the wire's f32
    values, as the reference's ``pair_bits``."""
    jcfg, _ = _cfgs(arch)
    pshapes = jax.eval_shape(lambda k: j_init(jcfg, k),
                             jax.random.PRNGKey(0))
    assert {str(x.dtype) for x in jax.tree.leaves(pshapes)} == {"bfloat16"}
    pspecs = jshd.param_specs(pshapes, "model", M)
    jcomp = JCC(compressor="gaussiank", ratio=0.001)
    sshapes = jax.eval_shape(lambda p: j_state(
        p, j_sgd(0.9), workers=W, model_size=M, compression=jcomp,
        resid_dtype=jnp.bfloat16), pshapes)
    resid = jax.tree.leaves(sshapes["resid"])   # per leaf: (W, d_pad)
    assert {str(x.dtype) for x in resid} == {"bfloat16"}

    rec = dryrun.run_one(arch, "train_4k", "2x2", smoke=True)
    assert rec["status"] == "OK", rec.get("traceback")
    mem = rec["memory"]
    assert mem["param_bytes"] == _per_card(pshapes, pspecs)
    assert mem["momentum_bytes"] == _per_card(sshapes["opt"]["m"], pspecs)
    # P(joint, "model"): a card holds one (worker, model row) cell
    assert mem["resid_bytes"] == sum(x.size * 2 for x in resid) / (W * M)
    assert mem["total_per_device"] == sum(
        v for k, v in mem.items() if k != "total_per_device")

    serve = j_serve_specs(pshapes, _MESH, mode="2d")
    for name in ("prefill_32k", "decode_32k"):
        rec = dryrun.run_one(arch, name, "2x2", smoke=True)
        assert rec["status"] == "OK", rec.get("traceback")
        assert rec["memory"]["param_bytes"] == _per_card(pshapes, serve)
    shape = J_SHAPES["decode_32k"]
    cshapes = jax.eval_shape(lambda: j_init_cache(
        jcfg, shape.global_batch, shape.seq_len, jnp.bfloat16))
    cspecs = jshd.cache_specs(cshapes, ("data",), W, "model", M)
    assert rec["memory"]["cache_bytes"] == _per_card(cshapes, cspecs)


def test_dryrun_embeds_batch_is_bf16(monkeypatch):
    """An embeds frontend's train batch reaches the counts in bf16, as
    the reference's ``input_specs(..., activation_dtype=DTYPE)``."""
    from repro_torch.launch import step_cost
    seen = []
    real = step_cost._inputs

    def spy(cfg, batch, seq, kind, device):
        out = real(cfg, batch, seq, kind, device)
        seen.append(out["embeds"].dtype)
        return out

    monkeypatch.setattr(step_cost, "_inputs", spy)
    rec = dryrun.run_one("musicgen-medium", "train_4k", "2x2", smoke=True)
    assert rec["status"] == "OK", rec.get("traceback")
    assert seen and set(seen) == {torch.bfloat16}


# ---------------------------------------------------------------------------
# checkpoints of bf16 state
# ---------------------------------------------------------------------------

_SMALL = dict(name="t", arch_type="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64, **BF16)


def _fill_bits(state, seed):
    """Random bits in every tensor of ``state`` (bf16 leaves random
    finite bf16 values, rounded from f32 normals)."""
    rng = np.random.default_rng(seed)
    for leaf in tree.leaves(state):
        if isinstance(leaf, torch.Tensor):
            leaf.copy_(torch.from_numpy(rng.standard_normal(
                tuple(leaf.shape)).astype(np.float32)))
    state["step"] = 5
    return state


def _port_state(bucketed=True, workers=2, model_size=1, seed=0):
    from repro_torch.models import ModelConfig
    cfg = ModelConfig(**_SMALL).validate()
    params = init_params(cfg, 0, "cpu")
    comp = CompressionConfig(ratio=0.01)
    layout = build_layout(params, model_size, comp) if bucketed else None
    state = init_train_state(params, sgd_momentum(0.9), workers=workers,
                             model_size=model_size, compression=comp,
                             layout=layout, resid_dtype=torch.bfloat16)
    return cfg, layout, _fill_bits(state, seed)


def _same_bits(a, b):
    pa, pb = tree.flatten_with_path(a)[0], tree.flatten_with_path(b)[0]
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (p, x), (_, y) in zip(pa, pb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype, p
            assert np.array_equal(_bits(x), _bits(y)), p
        else:
            assert x == y, p


@pytest.mark.parametrize("bucketed", [True, False],
                         ids=["bucketed", "perleaf"])
def test_bf16_state_round_trips_bitwise(tmp_path, bucketed):
    _, _, state = _port_state(bucketed)
    leaves = [x for x in tree.leaves(state) if isinstance(x, torch.Tensor)]
    assert {x.dtype for x in leaves} == {torch.bfloat16}
    path = str(tmp_path / "ck.npz")
    save_state(path, state)
    with np.load(path) as f:
        assert {f[k].dtype.str for k in f.files if k != "step"} == {"|V2"}
    _, _, fresh = _port_state(bucketed, seed=1)
    loaded = load_state(path, fresh)
    assert loaded["step"] == 5
    _same_bits(state, loaded)


def _reference_bf16_state():
    """A 2-worker bf16 train state of the reference (bf16 params,
    momentum and bucketed residual) with random values, step 5."""
    from repro.models.config import ModelConfig as JModelConfig
    jparams = j_init(JModelConfig(**_SMALL).validate(),
                     jax.random.PRNGKey(0))
    jcomp = JCC(ratio=0.01)
    js = j_state(jparams, j_sgd(0.9), workers=2, model_size=1,
                 compression=jcomp, resid_dtype=jnp.bfloat16,
                 layout=j_build_layout(jparams, 1, jcomp))
    rng = np.random.default_rng(3)
    js = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
        x.shape).astype(np.float32)).astype(x.dtype)
        if x.dtype == jnp.bfloat16 else x, js)
    js["step"] = jnp.int32(5)
    return js


def test_reference_bf16_checkpoint_loads_bitwise(tmp_path):
    """The reference's ``save_state`` of a bf16 state (``|V2`` entries)
    loads bit for bit into the port's bf16 state; the port's file of the
    loaded state has the same entries: names, dtype strings and bytes."""
    js = _reference_bf16_state()
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j_save(jpath, js)
    _, _, ts = _port_state(workers=2, seed=1)
    loaded = load_state(jpath, ts)
    assert loaded["step"] == 5
    jpairs = jax.tree_util.tree_flatten_with_path(js)[0]
    tpairs = tree.flatten_with_path(loaded)[0]
    assert len(jpairs) == len(tpairs)
    for (_, a), (p, b) in zip(jpairs, tpairs):
        if isinstance(b, torch.Tensor):
            assert b.dtype == torch.bfloat16, p
            assert np.array_equal(_bits(a), _bits(b)), p
    save_state(tpath, loaded)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype.str == b[k].dtype.str, k
            assert a[k].tobytes() == b[k].tobytes(), k


def test_per_leaf_bf16_checkpoint_migrates_into_the_buckets(tmp_path):
    """A per-leaf bf16 checkpoint (``resid/<leaf path>`` entries) loads
    into the bucketed state through ``layout=``, bitwise the buckets of
    the same per-leaf residuals packed."""
    from repro_torch.dist.layout import pack_residual_arrays
    _, _, leafy = _port_state(bucketed=False)
    path = str(tmp_path / "leaf.npz")
    save_state(path, leafy)
    _, layout, bucketed = _port_state(bucketed=True, seed=1)
    loaded = load_state(path, bucketed, layout=layout)
    want = pack_residual_arrays(layout, [
        _bits(x) for x in tree.leaves(leafy["resid"])])
    assert loaded["resid"].dtype == torch.bfloat16
    assert np.array_equal(_bits(loaded["resid"]), want)
    _same_bits(leafy["params"], loaded["params"])


@pytest.mark.parametrize("bucketed", [True, False],
                         ids=["bucketed", "perleaf"])
def test_tensor_parallel_shard_cut_at_bf16(tmp_path, bucketed):
    """A whole one-process bf16 checkpoint at model size 2, bucketed or
    per leaf, cut to each rank's bucketed state by ``state_shard_fn``:
    the params and momentum bitwise the rank's shards of the whole
    leaves, the residual its bucket row (a per-leaf one packed first)."""
    from repro_torch.dist.layout import pack_residual_arrays
    cfg, _, whole = _port_state(bucketed, workers=1, model_size=2)
    path = str(tmp_path / "whole.npz")
    save_state(path, whole)
    params = whole["params"]
    placements = check_split(cfg, params, 2)
    by_name = dict(zip((tree.path_name(p) for p, _ in
                        tree.flatten_with_path(params)[0]), placements))
    comp = CompressionConfig(ratio=0.01)
    layout = build_layout(params, 2, comp)
    resid = (_bits(whole["resid"]) if bucketed else pack_residual_arrays(
        layout, [_bits(x) for x in tree.leaves(whole["resid"])]))
    for rank in range(2):
        mine = shard_params(params, placements, rank, 2)
        like = init_train_state(
            tree.tree_map(torch.zeros_like, mine), sgd_momentum(0.9),
            workers=1, model_size=2, compression=comp, layout=layout,
            rows=1, resid_dtype=torch.bfloat16)
        got = load_state(path, like, layout=layout,
                         shard=state_shard_fn(by_name, rank, 2))
        _same_bits(mine, got["params"])
        _same_bits(shard_params(whole["opt"]["m"], placements, rank, 2),
                   got["opt"]["m"])
        assert np.array_equal(_bits(got["resid"]),
                              resid.reshape(1, 2, -1)[:, rank])


def test_bf16_entry_into_another_dtype_raises(tmp_path):
    """A ``|V2`` entry is never reinterpreted: into an f32 leaf it
    raises, naming the key; an f32 entry into a bf16 leaf rounds to
    nearest even, as the reference's ``astype``."""
    _, _, state = _port_state()
    path = str(tmp_path / "bf16.npz")
    save_state(path, state)
    from repro_torch.models import ModelConfig
    cfg = ModelConfig(**{**_SMALL, "param_dtype": "float32",
                         "activation_dtype": "float32"}).validate()
    params = init_params(cfg, 0, "cpu")
    comp = CompressionConfig(ratio=0.01)
    f32 = init_train_state(params, sgd_momentum(0.9), workers=2,
                           model_size=1, compression=comp,
                           layout=build_layout(params, 1, comp),
                           resid_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"opt/m/embed: .*\|V2"):
        load_state(path, f32)
    f32 = _fill_bits(f32, 4)
    f32["resid"] = f32["resid"].float()
    fpath = str(tmp_path / "f32.npz")
    save_state(fpath, f32)
    _, _, into = _port_state(seed=5)
    got = load_state(fpath, into)
    for a, b in zip(tree.leaves(f32), tree.leaves(got)):
        if isinstance(a, torch.Tensor):
            assert b.dtype == torch.bfloat16
            assert torch.equal(b, a.to(torch.bfloat16))


def test_bf16_resume_equals_straight_run(tmp_path):
    """bf16 params, momentum and residual, two workers on
    ``LocalWire``, fused Gaussian-k: 2 steps, save, load into a fresh
    state, 1 step == 3 steps straight, bitwise (params, momentum,
    residual, losses)."""
    from repro_torch.models import ModelConfig
    cfg = ModelConfig(**_SMALL).validate()
    comp = CompressionConfig(ratio=0.01)
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, 64, (8, 16)))
        batches.append({"tokens": toks, "labels": torch.roll(toks, -1, 1)})

    def fresh():
        params = init_params(cfg, 0, "cpu")
        layout = build_layout(params, 1, comp)
        opt = sgd_momentum(0.9)
        state = init_train_state(params, opt, workers=2, model_size=1,
                                 compression=comp, layout=layout,
                                 resid_dtype=torch.bfloat16)
        return state, make_train_step(cfg, "2x1", opt, constant(0.1),
                                      compression=comp, layout=layout)

    straight, step = fresh()
    losses = [float(step(straight, b)[1]["loss"]) for b in batches]
    first, step = fresh()
    for b in batches[:2]:
        step(first, b)
    path = str(tmp_path / "ck.npz")
    save_state(path, first)
    resumed, step = fresh()
    resumed = load_state(path, resumed)
    assert resumed["step"] == 2
    assert float(step(resumed, batches[2])[1]["loss"]) == losses[2]
    assert straight["resid"].dtype == torch.bfloat16
    assert bool(straight["resid"].any())
    _same_bits(straight, resumed)


# ---------------------------------------------------------------------------
# serving at bf16
# ---------------------------------------------------------------------------


def _bf16_tol(ref) -> float:
    """4 bf16 ulps of the largest magnitude of ``ref``."""
    top = float(np.abs(np.asarray(ref, np.float32)).max())
    return 4 * 2.0 ** (np.floor(np.log2(top)) - 7)


def _close(a, b, what):
    a32, b32 = np.asarray(a, np.float32), b.float().numpy()
    assert str(a.dtype) == "bfloat16" and b.dtype == torch.bfloat16, what
    assert np.abs(a32 - b32).max() <= _bf16_tol(a32), what


def test_bf16_prefill_and_decode_match_reference():
    """Prompt 8 into a bf16 cache of 16, then 8 greedy decode steps,
    each package fed its own greedy tokens: the tokens equal, logits and
    cache leaves within :func:`_bf16_tol`."""
    jcfg, tcfg = _cfgs("llama3.2-1b")
    jp = j_init(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    prompt = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    T, S = 8, 16
    jl, jc, _ = j_prefill(jp, jcfg, tokens=jnp.asarray(prompt), s_max=S)
    tl, tc, _ = prefill(tp, tcfg, torch.from_numpy(prompt).long(), s_max=S)
    _close(jl, tl, "prefill logits")
    for a, b in zip(jax.tree.leaves(jc), tree.leaves(tc)):
        _close(a, b, "prefill cache")
    for pos in range(T, S):
        jtok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)
        ttok = tl[:, -1].float().argmax(-1).numpy()
        assert np.array_equal(jtok, ttok), pos
        jl, jc = j_decode(jp, jcfg, jc, jnp.int32(pos),
                          tokens=jnp.asarray(jtok[:, None]))
        tl, tc = decode_step(tp, tcfg, tc, pos,
                             torch.from_numpy(ttok[:, None]).long())
        _close(jl, tl, f"logits at {pos}")
    for a, b in zip(jax.tree.leaves(jc), tree.leaves(tc)):
        _close(a, b, "cache after decode")


def test_bf16_xlstm_forward_matches_reference():
    """xlstm-125m's smoke forward with bf16 params and activations: its
    sLSTM multiplies the f32 state by the bf16 recurrent weights
    promoted to f32, as the reference's ``einsum`` promotes them."""
    jcfg, tcfg = _cfgs("xlstm-125m")
    jp = j_init(jcfg, jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    ja = j_forward(jp, jcfg, jnp.asarray(toks))
    ta = forward(tp, tcfg, torch.from_numpy(toks).long(), remat=False)
    ja = ja[0] if isinstance(ja, tuple) else ja
    ta = ta[0] if isinstance(ta, tuple) else ta
    _close(ja, ta, "xlstm logits")


def _tie_drift(np_tree, t):
    """A weight move in whole bf16 steps of 2**-6 on every third
    element: many deltas share one magnitude, so the top-k selection
    breaks ties by its order."""
    def move(x):
        x32 = x.astype(np.float32)
        step = np.where(np.arange(x.size).reshape(x.shape) % 3 == t % 3,
                        np.float32(2.0 ** -6) * np.sign(np.sin(
                            x32 * np.float32(t + 1))), np.float32(0.0))
        return (x32 + step).astype(x.dtype)
    return jax.tree.map(move, np_tree)


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("msize", [1, 2])
def test_bf16_topk_stream_matches_reference_bitwise(stream, msize):
    """bf16 params of llama3.2-1b's smoke variant, a ``topk`` publisher
    at 0.01 (both CLIs' compressor), 6 ticks with resyncs at 0 and 4:
    each message's values and indices (or bucket), ``pub``, ``resid``,
    and the replica after the reference's and the port's
    ``apply_message``, bitwise; a delta's values in the stream's
    dtype."""
    jcfg, _ = _cfgs("llama3.2-1b")
    jp = j_init(jcfg, jax.random.PRNGKey(0))
    np_p = jax.tree.map(np.asarray, jp)
    jcc, tcc = (JCC(compressor="topk", ratio=0.01),
                CompressionConfig(compressor="topk", ratio=0.01))
    jl = j_build_layout(jp, msize, jcc)
    tl = build_layout(from_jax_params(np_p, "cpu"), msize, tcc)
    jdt, tdt = ((jnp.float32, torch.float32) if stream == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    js = j_init_pub(jl, dtype=jdt)
    ts = init_publisher_state(tl, dtype=tdt, device="cpu")
    jrep = jax.tree.map(jnp.zeros_like, jp)
    trep = tree.tree_map(torch.zeros_like, from_jax_params(np_p, "cpu"))
    cur, kinds = np_p, []
    for t in range(6):
        cur = _tie_drift(cur, t)
        js, jm = j_publish(js, jax.tree.map(jnp.asarray, cur), jl, jcc,
                           jax.random.PRNGKey(7), resync_every=4)
        ts, tm = publish(ts, from_jax_params(cur, "cpu"), tl, tcc,
                         prng.PRNGKey(7), resync_every=4)
        kinds.append(tm.kind)
        assert (tm.kind, tm.seq) == (jm.kind, jm.seq), t
        if tm.kind == RESYNC:
            assert np.array_equal(_bits(jm.bucket), _bits(tm.bucket)), t
        else:
            assert tm.values.dtype == tdt
            assert np.array_equal(_bits(jm.values), _bits(tm.values)), t
            assert np.array_equal(_bits(jm.indices), _bits(tm.indices)), t
        assert ts["pub"].dtype == ts["resid"].dtype == tdt
        assert np.array_equal(_bits(js["pub"]), _bits(ts["pub"])), t
        assert np.array_equal(_bits(js["resid"]), _bits(ts["resid"])), t
        jrep = j_apply_message(jrep, jl, jm)
        trep = apply_message(trep, tl, tm)
        for a, b in zip(jax.tree.leaves(jrep), tree.leaves(trep)):
            assert b.dtype == torch.bfloat16
            assert np.array_equal(_bits(a), _bits(b)), t
    assert kinds == [0, 1, 1, 1, 0, 1]
