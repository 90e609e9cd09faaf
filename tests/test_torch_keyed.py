"""Slice 4, the key-sampled compressors (``randk``, ``dgck``, ``rtopk``),
against the JAX package on the CPU, with ``jax.random`` in its
partitionable threefry scheme (``_torch_prng_flag``):

* each selection from the same key, values and indices bitwise,
  including inputs full of equal magnitudes (``lax.top_k``'s tie order);
  the dynamic-k ``randk``/``rtopk`` against ``repro.core.adaptk
  .select_dynamic``; ``dgck`` has no dynamic-k path in either package;
* ``bucket_compress`` with a key over the multi-segment layout of the
  2-layer config (M = 1), with and without ``key_fold=1``, fixed-k and
  dynamic-k: values, indices and the new residual bitwise, conservation
  bitwise;
* 3 training steps of each against the reference: every step's wire
  pair and new residual bitwise the reference's ``bucket_compress`` of
  the port's packed gradients with the step's key ``fold_in(fold_in(
  PRNGKey(seed), step), 0)``; losses within rtol 1e-4 of the composed
  JAX chain (``value_and_grad``, ``pack_grads``, ``bucket_compress``,
  ``sgd_momentum``) and of the reference's ``make_train_step(seed=...)``,
  params within rtol 1e-4 / atol 1e-5 of the chain's
  (``test_torch_train.py``'s tolerances: the gradients differ from XLA's
  by f32 summation order);
* W = 4 ``LocalWire`` against the reference's mesh train step on 4
  forced host devices (``tests/_torch_keyed_ref.py``): ``randk`` with
  allgather and with hierarchical, and Gaussian-k with momentum
  correction 0.9 over gTop-k, with ``test_torch_dist.py``'s tolerances
  (hierarchical ``randk``: see the test for the replicas the reference
  lets drift apart);
* the CLI: on llama3.2-1b ``randk`` and ``rtopk`` take the arch's
  ``variance`` policy, ``--density-policy none`` trains them fixed-k,
  and ``dgck`` trains fixed-k.
"""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_prng_flag import threefry_partitionable  # noqa: F401
from repro.core import adaptk as ja
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
from repro_torch import prng, tree
from repro_torch.core import adaptk as ta
from repro_torch.core import codec
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.compressors import get_compressor
from repro_torch.dist import aggregate as tagg
from repro_torch.dist.layout import build_layout, init_flat_residual
from repro_torch.launch import train as cli
from repro_torch.launch.mesh import data_world_size, parse_mesh
from repro_torch.models import ModelConfig, from_jax_params
from repro_torch.optim import constant, sgd_momentum
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
KEYED = ("randk", "dgck", "rtopk")
_CFG = dict(name="sys", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
JCFG = JModelConfig(**_CFG).validate()
TCFG = ModelConfig(**_CFG).validate()
RATIO, LR, SEED, STEPS = 0.02, 0.1, 3, 3


def _jkey(key):
    return jax.random.wrap_key_data(np.asarray(key, np.uint32))


def _u(d, ties, seed):
    u = np.random.default_rng(seed).standard_normal(d).astype(np.float32)
    if ties:
        # quarter steps and a block of zeros: most magnitudes repeat
        u = np.round(u * 4) / 4
        u[: d // 3] = 0.0
    return u


@functools.lru_cache(maxsize=None)
def _jparams():
    return j_init(JCFG, jax.random.PRNGKey(0))


def _tparams():
    return from_jax_params(jax.tree.map(np.asarray, _jparams()), "cpu")


@pytest.mark.parametrize("name", KEYED)
@pytest.mark.parametrize("d,k,ties", [(1000, 10, False), (5001, 50, True),
                                      (200000, 2000, False), (64, 64, True),
                                      (3, 1, False)])
def test_selection_matches_reference(name, d, k, ties):
    u = _u(d, ties, d)
    for seed in (0, 5):
        key = prng.fold_in(prng.PRNGKey(seed), 3)
        jv, ji = j_get(name).select(jnp.asarray(u), k, _jkey(key))
        tv, ti = get_compressor(name).select(torch.from_numpy(u), k, key)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("name", ["randk", "rtopk"])
@pytest.mark.parametrize("d,k_cap,k", [(1000, 40, 10), (5001, 200, 50),
                                       (64, 64, 3), (300, 300, 300)])
def test_dynamic_selection_matches_reference(name, d, k_cap, k):
    u = _u(d, d % 2 == 1, d)
    key = prng.PRNGKey(4)
    jv, ji = ja.select_dynamic(j_get(name), jnp.asarray(u), jnp.int32(k),
                               k_cap, _jkey(key))
    tv, ti = ta.select_dynamic(get_compressor(name), torch.from_numpy(u),
                               np.int32(k), k_cap, key)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int((ti != codec.SENTINEL).sum()) == min(k, k_cap)


def test_dgck_has_no_dynamic_path():
    u = _u(100, False, 0)
    with pytest.raises(ValueError) as jerr:
        ja.select_dynamic(j_get("dgck"), jnp.asarray(u), jnp.int32(3), 8,
                          jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as terr:
        ta.select_dynamic(get_compressor("dgck"), torch.from_numpy(u),
                          np.int32(3), 8, prng.PRNGKey(0))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("name", KEYED)
def test_registry_needs_key_and_caps(name):
    j, t = j_get(name), get_compressor(name)
    assert t.needs_key and j.needs_key
    for k, d in ((1, 1), (10, 1000), (50, 60), (5, 3)):
        assert t.k_cap(k, d) == j.k_cap(k, d)


def _buckets(lay, seed):
    rng = np.random.default_rng(seed)
    D = lay.d_row_total
    G = rng.standard_normal((1, D)).astype(np.float32)
    E = (0.2 * rng.standard_normal((1, D))).astype(np.float32)
    return G, E


@pytest.mark.parametrize("name", KEYED)
@pytest.mark.parametrize("key_fold", [None, 1])
def test_bucket_compress_keys_match_reference(name, key_fold):
    """Each segment folds its salt (then ``key_fold``) into the worker's
    key and its one row takes ``split(·, 1)[0]``, as the reference's."""
    jlay = jl.build_layout(_jparams(), 1, RATIO, j_get(name))
    tlay = build_layout(_tparams(), 1, RATIO, get_compressor(name))
    assert len(tlay.segments) > 4
    G, E = _buckets(tlay, 7)
    key = prng.fold_in(prng.fold_in(prng.PRNGKey(SEED), 2), 0)
    jv, ji, jE, jV = jagg.bucket_compress(
        jnp.asarray(G), jnp.asarray(E), jlay, j_get(name), _jkey(key),
        backend="reference", key_fold=key_fold)
    tv, ti, tE = tagg.bucket_compress(
        torch.from_numpy(G), torch.from_numpy(E.copy()), tlay,
        get_compressor(name), key, key_fold=key_fold)
    assert jV is None
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tE.numpy(), np.asarray(jE))
    dec = codec.decode(tv[0], ti[0], tlay.d_row_total)
    assert torch.equal(dec + tE[0], torch.from_numpy(G[0] + E[0]))


@pytest.mark.parametrize("name", ["randk", "rtopk"])
def test_dynamic_bucket_compress_keys_match_reference(name):
    """Under adaptive density the rows' dynamic-k selections take the
    same row keys."""
    jpol = ja.make_policy("variance")
    jlay = jl.build_layout(_jparams(), 1, RATIO, j_get(name),
                           density_policy=jpol)
    tlay = build_layout(_tparams(), 1, RATIO, get_compressor(name),
                        density_policy=ta.DensityPolicy(*jpol))
    G, E = _buckets(tlay, 9)
    k = [int(np.clip((s.k_lo + s.k_hi) // 3, s.k_lo, s.k_hi))
         for s in tlay.segments]
    key = prng.fold_in(prng.PRNGKey(SEED), 11)
    jv, ji, jE, _ = jagg.bucket_compress(
        jnp.asarray(G), jnp.asarray(E), jlay, j_get(name), _jkey(key),
        backend="reference", k_alloc=jnp.asarray(k, jnp.int32))
    tv, ti, tE = tagg.bucket_compress(
        torch.from_numpy(G), torch.from_numpy(E.copy()), tlay,
        get_compressor(name), key, k_alloc=np.asarray(k, np.int32))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tE.numpy(), np.asarray(jE))


def test_keyed_aggregation_needs_keys():
    params = _tparams()
    comp = CompressionConfig(compressor="randk", ratio=RATIO)
    layout = build_layout(params, 1, comp)
    with pytest.raises(ValueError, match="keys="):
        tagg.aggregate_bucketed(params, init_flat_residual(layout,
                                                           device="cpu"),
                                layout, comp)


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, 64, (4, 16)).astype(np.int32)
        out.append({"tokens": toks, "labels": np.roll(toks, -1, axis=1)})
    return out


def _jax_chain(name, batches):
    """The reference's world-1 step composed from its public functions,
    keyed as ``make_train_step(seed=SEED)`` keys worker 0: returns the
    losses and the final params."""
    spec = j_get(name)
    layout = jl.build_layout(_jparams(), 1, RATIO, spec)
    D = layout.d_row_total
    E = jnp.zeros((1, D), jnp.float32)
    opt = j_sgd(0.9)
    p = _jparams()
    st = opt.init(p)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda q, b: j_loss(q, JCFG, b, remat=False), has_aux=True))
    losses = []
    for s, b in enumerate(batches):
        (loss, _), g = grad_fn(p, {k: jnp.asarray(v) for k, v in b.items()})
        G = jl.pack_grads(layout, g, jnp.float32)
        v, i, E, _ = jagg.bucket_compress(G, E, layout, spec, _step_key(s),
                                          backend="reference")
        mean = jcodec.decode(v[0], i[0], D)[None]
        p, st = opt.update(p, st, jl.unpack_tree(layout, mean, like=g),
                           jnp.float32(LR))
        losses.append(float(loss))
    return losses, p


def _step_key(step):
    return jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(SEED), np.uint32(step)), np.uint32(0))


def _jax_step_losses(name, batches):
    """The reference's own ``make_train_step(seed=SEED)`` on a (1, 1)
    mesh, ``backend="reference"``."""
    comp = JCompression(compressor=name, ratio=RATIO, backend="reference")
    layout = jl.build_layout(_jparams(), 1, comp)
    opt = j_sgd(0.9)
    state = j_state(_jparams(), opt, workers=1, model_size=1,
                    compression=comp, layout=layout)
    step = j_step(JCFG, j_mesh((1, 1), ("data", "model")), opt,
                  j_constant(LR), compression=comp, remat=False,
                  layout=layout, seed=SEED)
    losses = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("name", KEYED)
def test_three_steps_match_reference(name):
    """The port's step against the reference's: each step's packed
    gradients, as the port computed them, replayed through the
    reference's ``bucket_compress`` with the step's key give the port's
    wire pair and new residual bitwise (its gradients differ from XLA's
    in the last bits, which can flip a near-tie at dgck's and rtopk's
    thresholds); losses and params against the JAX chain and step."""
    batches = _batches()
    jlosses, jfinal = _jax_chain(name, batches)
    comp = CompressionConfig(compressor=name, ratio=RATIO)
    params = _tparams()
    layout = build_layout(params, 1, comp)
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=1, model_size=1,
                             compression=comp, layout=layout)
    seen = []

    def probe(rank, G=None, values=None, indices=None, new_E=None, **_):
        if indices is not None:
            seen.append([x.numpy().copy()
                         for x in (G, values, indices, new_E)])

    step = make_train_step(TCFG, (1, 1), opt, constant(LR),
                           compression=comp, layout=layout, probe=probe,
                           seed=SEED)
    tlosses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v).long()
                                for k, v in b.items()})
        tlosses.append(float(m["loss"]))
    assert len(seen) == STEPS
    jlay = jl.build_layout(_jparams(), 1, RATIO, j_get(name))
    E = jnp.zeros((1, jlay.d_row_total), jnp.float32)
    for s, (G, v, i, new_E) in enumerate(seen):
        jv, ji, E, _ = jagg.bucket_compress(jnp.asarray(G), E, jlay,
                                            j_get(name), _step_key(s),
                                            backend="reference")
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_array_equal(v, np.asarray(jv))
        np.testing.assert_array_equal(new_E, np.asarray(E))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(tlosses, _jax_step_losses(name, batches),
                               rtol=1e-4)
    for a, b in zip(jax.tree.leaves(jfinal), tree.leaves(state["params"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)


CASES = {"randk/allgather": ("4x1", "allgather", "randk", 0.0),
         "randk/hierarchical": ("2x2x1", "hierarchical", "randk", 0.0),
         "gaussiank_mc/gtopk": ("4x1", "gtopk", "gaussiank", 0.9)}
METRICS = ("loss", "density", "density_cap", "comm_bits_sparse",
           "comm_bits_dense", "wire_bytes", "collectives_per_step")


@pytest.fixture(scope="module")
def mesh_ref(tmp_path_factory):
    """The JAX mesh runs of ``CASES``, one subprocess."""
    out = tmp_path_factory.mktemp("jax_keyed") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable,
                        os.path.join(TESTS, "_torch_keyed_ref.py"), str(out)],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    with np.load(out) as data:
        return dict(data)


@pytest.mark.parametrize("case", list(CASES))
def test_local_wire_matches_jax_mesh(mesh_ref, case):
    """Under hierarchical ``randk`` the workers of a pod compress the pod
    mean with their own keys, so the second level hands the reference's
    data-index-1 workers another mean than worker 0's and their replicas
    of the params drift apart (the reference returns worker 0's).  The
    port's ``LocalWire`` workers share one copy, updated with worker 0's
    mean: from step 1 on, the residuals of workers 0 and 2 (data index
    0) are the comparable ones."""
    mesh_s, strategy, name, mc = CASES[case]
    params = _tparams()
    comp = CompressionConfig(compressor=name, ratio=0.02, strategy=strategy,
                             backend="reference", momentum_correction=mc)
    layout = build_layout(params, 1, comp)
    mesh = parse_mesh(mesh_s)
    opt = sgd_momentum(0.0 if mc else 0.9)
    state = init_train_state(params, opt, workers=data_world_size(mesh),
                             model_size=1, compression=comp, layout=layout)
    step = make_train_step(TCFG, mesh, opt, constant(0.05),
                           compression=comp, layout=layout, seed=SEED)
    rng = np.random.default_rng(1)
    for s in range(2):
        toks = rng.integers(0, 64, (8, 16)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(toks).long(),
                 "labels": torch.from_numpy(np.roll(toks, -1, 1)).long()}
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]),
                                   mesh_ref[f"{case}/{s}/loss"], rtol=1e-4)
        for k in METRICS[1:]:
            np.testing.assert_allclose(float(m[k]),
                                       mesh_ref[f"{case}/{s}/{k}"],
                                       rtol=1e-6, err_msg=k)
        rows = [0, 2] if case == "randk/hierarchical" and s > 0 else \
            [0, 1, 2, 3]
        for key in ("resid", "resid2"):
            assert (key in state) == (f"{case}/{s}/{key}" in mesh_ref), key
            if key in state:
                np.testing.assert_allclose(
                    state[key].numpy()[rows],
                    mesh_ref[f"{case}/{s}/{key}"][rows], rtol=1e-4,
                    atol=1e-5, err_msg=f"{key} step {s}")
    for i, leaf in enumerate(tree.leaves(state["params"])):
        np.testing.assert_allclose(leaf.numpy(),
                                   mesh_ref[f"{case}/params/{i}"],
                                   rtol=1e-4, atol=1e-5)


_SMOKE = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1", "--device",
          "cpu", "--steps",
          "1", "--batch", "2", "--seq", "16", "--log-every", "1"]


@pytest.mark.parametrize("name,policy,adaptive", [
    ("randk", [], True), ("rtopk", [], True),
    ("randk", ["--density-policy", "none"], False),
    ("rtopk", ["--density-policy", "none"], False), ("dgck", [], False)])
def test_cli_keyed_density_default(capsys, name, policy, adaptive):
    """llama3.2-1b's ``variance`` default reaches the dynamic-k ``randk``
    and ``rtopk``; ``dgck`` has no dynamic-k path and trains fixed-k."""
    recs = cli.run(_SMOKE + ["--compressor", name] + policy)
    out = capsys.readouterr().out
    assert f"compressor={name}" in out
    assert ("density_policy=variance" in out) == adaptive
    fixed = ("density_policy=fixed-k" in out
             or "density_policy=none" in out)
    assert fixed == (not adaptive)
    assert all(("k_total" in r) == adaptive for r in recs)
    # randk and rtopk send exactly their capacity: density is the cap,
    # up to the f32 rounding of nnz / d
    assert all(np.isfinite(r["loss"]) and 0 < r["density"] <=
               r["density_cap"] * (1 + 1e-6) for r in recs)
