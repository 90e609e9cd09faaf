"""Slice 4, DGC momentum correction, against the JAX package on the CPU
(``jax.random`` partitionable, ``_torch_prng_flag``):

* ``mc_compress_leaf`` bitwise the reference's (values, indices, ``v'``,
  ``u'``), and ``init_mc_state``'s shapes;
* ``bucket_compress(momentum=0.9, V=)`` on the same buckets as the
  reference's (called op by op: under ``jit`` XLA fuses ``μ·v + g`` into
  one FMA): values, indices, ``e'`` and ``v'`` bitwise, for topk,
  gaussiank, histk (``histk_select``'s K4d and K4c, their plain
  versions here) and randk; conservation ``decode + e' == e + v'_pre``
  bitwise and ``v'`` and ``e'`` zero at every selected index;
* 6 training steps with momentum correction 0.9 and ``sgd_momentum(0.0)``
  on the server, for topk, gaussiank, histk and randk, both packages
  from the same params (``from_jax_params``): every step's wire pair,
  ``e'`` and ``v'`` bitwise the reference's ``bucket_compress`` of the
  port's packed gradients; losses within rtol 1e-4 and params within
  rtol 1e-4 / atol 1e-5 of the reference's ``make_train_step`` (histk:
  of the composed chain, since the reference's Pallas histogram fails
  inside ``shard_map`` under jax 0.9) — ``test_torch_train.py``'s
  tolerances;
* the reference's three refusals, word for word: with adaptive density,
  with the two-level strategies, without ``resid2``;
* ``init_train_state`` allocates ``resid2``, and a checkpoint resume
  equals the straight run bitwise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_prng_flag import threefry_partitionable  # noqa: F401
from repro.core import codec as jcodec
from repro.core.compression import CompressionConfig as JCompression
from repro.core.compressors import get_compressor as j_get
from repro.dist import aggregate as jagg
from repro.dist import layout as jl
from repro.launch.mesh import make_mesh as j_mesh
from repro.models import init_params as j_init
from repro.models import loss_fn as j_loss
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import constant as j_constant
from repro.optim import sgd_momentum as j_sgd
from repro.train import init_train_state as j_state
from repro.train import make_train_step as j_step
from repro.train.momentum_correction import init_mc_state as j_init_mc
from repro.train.momentum_correction import mc_compress_leaf as j_mc_leaf
from repro_torch import prng, tree
from repro_torch.checkpoint import load_state, save_state
from repro_torch.core import adaptk as ta
from repro_torch.core import codec
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.compressors import get_compressor
from repro_torch.dist import aggregate as tagg
from repro_torch.dist.layout import build_layout
from repro_torch.launch.mesh import parse_mesh
from repro_torch.dist.wire import LocalWire
from repro_torch.models import ModelConfig, from_jax_params
from repro_torch.optim import constant, sgd_momentum
from repro_torch.train import init_train_state, make_train_step
from repro_torch.train.momentum_correction import (init_mc_state,
                                                   mc_compress_leaf)

torch.set_num_threads(2)

_CFG = dict(name="mc", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
JCFG = JModelConfig(**_CFG).validate()
TCFG = ModelConfig(**_CFG).validate()
RATIO, LR, MU, SEED, STEPS = 0.01, 0.1, 0.9, 3, 6
MC_NAMES = ("topk", "gaussiank", "histk", "randk")


def _jkey(key):
    return jax.random.wrap_key_data(np.asarray(key, np.uint32))


@functools.lru_cache(maxsize=None)
def _jparams():
    return j_init(JCFG, jax.random.PRNGKey(0))


def _tparams():
    return from_jax_params(jax.tree.map(np.asarray, _jparams()), "cpu")


@pytest.mark.parametrize("name", ["topk", "gaussiank", "randk"])
def test_mc_compress_leaf_matches_reference(name):
    rng = np.random.default_rng(2)
    d, k = 4096, 40
    g, v, u = (rng.standard_normal(d).astype(np.float32) * s
               for s in (1.0, 0.5, 0.3))
    key = prng.PRNGKey(6)
    jout = j_mc_leaf(jnp.asarray(g), jnp.asarray(v), jnp.asarray(u),
                     j_get(name), k, MU, _jkey(key))
    tout = mc_compress_leaf(torch.from_numpy(g), torch.from_numpy(v),
                            torch.from_numpy(u), get_compressor(name), k, MU,
                            key)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    sel = tout[1][tout[1] != codec.SENTINEL].long()
    assert bool((tout[2][sel] == 0).all()) and bool((tout[3][sel] == 0).all())


def test_init_mc_state_matches_reference():
    jv, ju = j_init_mc(_jparams(), 2)
    tv, tu = init_mc_state(_tparams(), 2)
    for a, b in zip(jax.tree.leaves((jv, ju)), tree.leaves((tv, tu))):
        assert tuple(b.shape) == a.shape and not bool(b.any())


def _layouts(name):
    return (jl.build_layout(_jparams(), 1, RATIO, j_get(name)),
            build_layout(_tparams(), 1, RATIO, get_compressor(name)))


@pytest.mark.parametrize("name", MC_NAMES)
def test_mc_bucket_compress_matches_reference(name):
    jlay, tlay = _layouts(name)
    rng = np.random.default_rng(4)
    D = tlay.d_row_total
    G, E, V = ((s * rng.standard_normal((1, D))).astype(np.float32)
               for s in (1e-2, 3e-3, 5e-3))
    key = prng.fold_in(prng.PRNGKey(SEED), 1)
    jv, ji, jE, jV = jagg.bucket_compress(
        jnp.asarray(G), jnp.asarray(E), jlay, j_get(name), _jkey(key),
        momentum=MU, V=jnp.asarray(V), backend="auto")
    tE, tV = torch.from_numpy(E.copy()), torch.from_numpy(V.copy())
    tv, ti, nE = tagg.bucket_compress(torch.from_numpy(G), tE, tlay,
                                      get_compressor(name), key,
                                      momentum=MU, V=tV)
    assert nE is tE
    for a, b in ((jv, tv), (ji, ti), (jE, tE), (jV, tV)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # u = e + (μ·v + g): conservation bitwise, and what was sent is gone
    # from both e' and v'
    u = torch.from_numpy(E) + (MU * torch.from_numpy(V) + torch.from_numpy(G))
    assert torch.equal(codec.decode(tv[0], ti[0], D) + tE[0], u[0])
    sel = ti[0][ti[0] != codec.SENTINEL].long()
    assert sel.numel() > 0
    assert bool((tE[0, sel] == 0).all()) and bool((tV[0, sel] == 0).all())


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 64, (4, 16)).astype(np.int32)
        out.append({"tokens": toks, "labels": np.roll(toks, -1, axis=1)})
    return out


def _step_key(step):
    return jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(SEED), np.uint32(step)), np.uint32(0))


def _jax_run(name, batches):
    """Losses and final params of the reference: its ``make_train_step``
    (seed=SEED, ``backend="reference"``) on a (1, 1) mesh; for histk the
    same step composed outside ``shard_map``."""
    comp = JCompression(compressor=name, ratio=RATIO, backend="reference",
                        momentum_correction=MU)
    layout = jl.build_layout(_jparams(), 1, comp)
    opt = j_sgd(0.0)
    if name != "histk":
        state = j_state(_jparams(), opt, workers=1, model_size=1,
                        compression=comp, layout=layout)
        step = j_step(JCFG, j_mesh((1, 1), ("data", "model")), opt,
                      j_constant(LR), compression=comp, remat=False,
                      layout=layout, seed=SEED)
        losses = []
        for b in batches:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        return losses, state["params"]
    D = layout.d_row_total
    E = jnp.zeros((1, D), jnp.float32)
    V = jnp.zeros((1, D), jnp.float32)
    p = _jparams()
    st = opt.init(p)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda q, b: j_loss(q, JCFG, b, remat=False), has_aux=True))
    losses = []
    for s, b in enumerate(batches):
        (loss, _), g = grad_fn(p, {k: jnp.asarray(v) for k, v in b.items()})
        G = jl.pack_grads(layout, g, jnp.float32)
        v, i, E, V = jagg.bucket_compress(G, E, layout, j_get(name),
                                          _step_key(s), momentum=MU, V=V)
        mean = jcodec.decode(v[0], i[0], D)[None]
        p, st = opt.update(p, st, jl.unpack_tree(layout, mean, like=g),
                           jnp.float32(LR))
        losses.append(float(loss))
    return losses, p


def _port(name, steps, probe=None, state=None, first=0):
    comp = CompressionConfig(compressor=name, ratio=RATIO,
                             momentum_correction=MU)
    params = _tparams()
    layout = build_layout(params, 1, comp)
    opt = sgd_momentum(0.0)
    if state is None:
        state = init_train_state(params, opt, workers=1, model_size=1,
                                 compression=comp, layout=layout)
    step = make_train_step(TCFG, (1, 1), opt, constant(LR),
                           compression=comp, layout=layout, probe=probe,
                           seed=SEED)
    losses = []
    for b in _batches()[first:first + steps]:
        state, m = step(state, {k: torch.from_numpy(v).long()
                                for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, state


@pytest.mark.parametrize("name", MC_NAMES)
def test_mc_train_matches_reference(name):
    seen = []

    def probe(rank, G=None, values=None, indices=None, new_E=None,
              resid2=None, **_):
        if indices is not None:
            seen.append([x.numpy().copy()
                         for x in (G, values, indices, new_E)])
        elif resid2 is not None:
            seen[-1].append(resid2.numpy().copy())

    tlosses, state = _port(name, STEPS, probe)
    assert len(seen) == STEPS
    jlay = jl.build_layout(_jparams(), 1, RATIO, j_get(name))
    E = jnp.zeros((1, jlay.d_row_total), jnp.float32)
    V = jnp.zeros_like(E)
    for s, (G, v, i, new_E, new_V) in enumerate(seen):
        jv, ji, E, V = jagg.bucket_compress(
            jnp.asarray(G), E, jlay, j_get(name), _step_key(s), momentum=MU,
            V=V)
        for a, b in ((jv, v), (ji, i), (E, new_E), (V, new_V.reshape(1, -1))):
            np.testing.assert_array_equal(b, np.asarray(a))
    jlosses, jfinal = _jax_run(name, _batches())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(jfinal), tree.leaves(state["params"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)


def test_mc_refuses_adaptive_density():
    with pytest.raises(ValueError) as jerr:
        jagg._wire_config("allgather", ("data",), None, 1, 0.9, True,
                          j_get("gaussiank"))
    with pytest.raises(ValueError) as terr:
        tagg._wire_config("allgather", tagg._one_data_axis_wire(1), True,
                          0.9, True, get_compressor("gaussiank"))
    assert str(terr.value) == str(jerr.value)
    comp = CompressionConfig(momentum_correction=MU,
                             density_policy=ta.make_policy("variance"))
    params = _tparams()
    layout = build_layout(params, 1, comp)
    with pytest.raises(ValueError, match="fixed-k only"):
        make_train_step(TCFG, (1, 1), sgd_momentum(0.0), constant(LR),
                        compression=comp, layout=layout)(
            init_train_state(params, sgd_momentum(0.0), workers=1,
                             model_size=1, compression=comp, layout=layout),
            {k: torch.from_numpy(v).long()
             for k, v in _batches()[0].items()})


def test_mc_refuses_two_level_strategies():
    mesh = j_mesh((1, 1, 1), ("pod", "data", "model"))
    comp = JCompression(momentum_correction=MU, strategy="hierarchical")
    with pytest.raises(ValueError) as jerr:
        with jax.sharding.use_mesh(mesh) if hasattr(
                jax.sharding, "use_mesh") else mesh:
            jagg._wire_config(comp.strategy, ("pod", "data"),
                              jnp.zeros(4), 1, MU, False,
                              j_get("gaussiank"))
    wire = LocalWire(parse_mesh("1x1x1"))
    with pytest.raises(ValueError) as terr:
        tagg._wire_config("hierarchical", wire, True, MU, False,
                          get_compressor("gaussiank"))
    assert "not hierarchical aggregation" in str(terr.value)
    assert str(terr.value) == str(jerr.value)


def test_mc_refuses_a_missing_resid2():
    with pytest.raises(ValueError) as jerr:
        jagg._wire_config("allgather", ("data",), None, 1, MU, False,
                          j_get("gaussiank"))
    with pytest.raises(ValueError) as terr:
        tagg._wire_config("allgather", tagg._one_data_axis_wire(1), False,
                          MU, False, get_compressor("gaussiank"))
    assert str(terr.value) == str(jerr.value)
    comp = CompressionConfig(momentum_correction=MU)
    params = _tparams()
    layout = build_layout(params, 1, comp)
    state = init_train_state(params, sgd_momentum(0.0), workers=1,
                             model_size=1, compression=comp, layout=layout)
    del state["resid2"]
    with pytest.raises(ValueError, match="needs a velocity state"):
        make_train_step(TCFG, (1, 1), sgd_momentum(0.0), constant(LR),
                        compression=comp, layout=layout)(
            state, {k: torch.from_numpy(v).long()
                    for k, v in _batches()[0].items()})


def test_init_train_state_allocates_resid2_under_mc():
    for mc, want in ((0.0, False), (MU, True)):
        comp = CompressionConfig(momentum_correction=mc)
        jcomp = JCompression(momentum_correction=mc)
        params = _tparams()
        layout = build_layout(params, 1, comp)
        state = init_train_state(params, sgd_momentum(0.0), workers=2,
                                 model_size=1, compression=comp,
                                 layout=layout)
        jstate = j_state(_jparams(), j_sgd(0.0), workers=2, model_size=1,
                         compression=jcomp,
                         layout=jl.build_layout(_jparams(), 1, jcomp))
        assert ("resid2" in state) == want == ("resid2" in jstate)
        if want:
            assert tuple(state["resid2"].shape) == jstate["resid2"].shape


def test_mc_checkpoint_resume_equals_straight_run(tmp_path):
    """3 steps, save (``resid2`` under the reference's key), load into a
    fresh state, 3 more: params, residual and velocities bitwise the
    6-step run's."""
    _, straight = _port("randk", 6)
    _, half = _port("randk", 3)
    path = str(tmp_path / "mc.npz")
    save_state(path, half)
    with np.load(path) as data:
        assert "resid2" in data and "resid" in data
    comp = CompressionConfig(compressor="randk", ratio=RATIO,
                             momentum_correction=MU)
    params = _tparams()
    fresh = init_train_state(params, sgd_momentum(0.0), workers=1,
                             model_size=1, compression=comp,
                             layout=build_layout(params, 1, comp))
    fresh = load_state(path, fresh)
    assert fresh["step"] == 3
    _, resumed = _port("randk", 3, state=fresh, first=3)
    for a, b in zip(tree.leaves(straight["params"]),
                    tree.leaves(resumed["params"])):
        assert torch.equal(a, b)
    for key in ("resid", "resid2"):
        assert torch.equal(straight[key], resumed[key])
