"""Slice 2b, the per-leaf aggregation (``--pipeline perleaf``), against
the JAX package and against the port's own bucketed path, on the CPU.

* ``init_residuals`` shapes the reference's; one leaf's compression
  (``bucket_compress`` on the leaf's one-segment layout, which the
  per-leaf loop runs) bitwise the reference's ``compress_worker`` (topk,
  randk keyed with the leaf's salted key) and ``compress_worker_dynamic``
  (topk at a per-step budget), on the reference backend.
* Bitwise: the per-leaf step against the bucketed one after 3 steps
  (params, optimizer state, the per-leaf residual tree packed with
  ``pack_residual_arrays`` against the flat buckets, ``resid2``, the
  controller state, every metric but ``collectives_per_step``, which is
  L = 12 a wire level) for topk, gaussiank on both backends, histk,
  randk, rtopk, ``variance`` and momentum correction 0.9; at W = 4 for
  the four strategies.
* ``LocalWire`` per leaf against the JAX mesh run with ``layout=None``
  (``tests/_torch_chunked_ref.py``), at ``test_torch_dist.py``'s
  tolerances; ``collectives_per_step`` exact.
* Checkpoints: a per-leaf checkpoint resumes into the bucketed pipeline
  bitwise (``load_state(..., layout=)``, and the CLI's ``--resume``);
  without ``layout`` it is refused.
* ``ProcessGroupWire`` over gloo in 2 processes, per leaf, bitwise
  against ``LocalWire``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_prng_flag import threefry_partitionable  # noqa: F401
from _torch_steps import (CFG, MESHES, MODES, SRC, TESTS, assert_same,
                          config, flat, mesh_run, pg_run, train)
from repro.core.compressors import get_compressor as j_get
from repro.dist import aggregate as jagg
from repro.dist.layout import leaf_key_salt as j_salt
from repro_torch import prng, tree
from repro_torch.checkpoint import load_state, save_state
from repro_torch.core.adaptk import make_policy
from repro_torch.core.compressors import get_compressor
from repro_torch.dist import aggregate as tagg
from repro_torch.dist.layout import build_layout, pack_grads
from repro_torch.launch import train as cli
from repro_torch.models import init_params
from repro_torch.optim import sgd_momentum
from repro_torch.train import init_train_state

torch.set_num_threads(2)


def test_init_residuals_matches_reference():
    params = {"a": torch.zeros(7, 3), "b": {"c": torch.zeros(5)}}
    jres = jagg.init_residuals({"a": jnp.zeros((7, 3)),
                                "b": {"c": jnp.zeros(5)}}, 2)
    tres = tagg.init_residuals(params, 2)
    assert [tuple(x.shape) for x in tree.leaves(tres)] == \
        [x.shape for x in jax.tree.leaves(jres)] == [(22,), (6,)]
    rows = tagg.init_residuals(params, 1, workers=3)
    assert [tuple(x.shape) for x in tree.leaves(rows)] == [(3, 21), (3, 5)]
    assert all(not x.any() for x in tree.leaves(rows))


@pytest.mark.parametrize("name,dynamic", [("topk", False), ("randk", False),
                                          ("topk", True)])
def test_one_leaf_compression_matches_compress_worker(name, dynamic):
    """The per-leaf loop compresses a leaf as ``bucket_compress`` on its
    one-segment layout; the reference's per-leaf functions give the same
    pair and residual, bitwise."""
    rng = np.random.default_rng(5)
    g = rng.standard_normal((40, 25)).astype(np.float32)
    e = (0.1 * rng.standard_normal(1000)).astype(np.float32)
    ratio, k = 0.01, 23
    policy = make_policy("variance") if dynamic else None
    layout = build_layout({"w": torch.from_numpy(g)}, 1, ratio,
                          get_compressor(name), density_policy=policy)
    (seg,) = layout.segments
    jkey = jax.random.fold_in(jax.random.PRNGKey(3), j_salt("w"))
    G = pack_grads(layout, [torch.from_numpy(g)], torch.float32)
    E = torch.from_numpy(e.copy()).view(1, -1)
    tv, ti, tE = tagg.bucket_compress(
        G, E, layout, get_compressor(name), prng.PRNGKey(3),
        backend="reference", k_alloc=[np.int32(k)] if dynamic else None)
    if dynamic:
        jv, ji, je = jagg.compress_worker_dynamic(
            jnp.asarray(g.reshape(-1)), jnp.asarray(e), j_get(name),
            jnp.int32(k), 1, jkey, k_cap=seg.k_cap, backend="reference")
    else:
        jv, ji, je, _ = jagg.compress_worker(
            jnp.asarray(g), jnp.asarray(e), j_get(name), ratio, 1, jkey,
            backend="reference")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tE.numpy().reshape(-1), np.asarray(je))


_BASE = {}


def _bucketed(mode, strategy="allgather", mesh="1x1"):
    key = (mode, strategy, mesh)
    if key not in _BASE:
        _BASE[key] = train(config(mode, strategy), mesh=mesh)
    return _BASE[key]


@pytest.mark.parametrize("mode", list(MODES))
def test_perleaf_bitwise_bucketed(mode):
    state, ms, layout = _bucketed(mode)
    ps, pms, _ = train(config(mode), pipeline="perleaf")
    assert isinstance(ps["resid"], dict)
    assert [tuple(x.shape) for x in tree.leaves(ps["resid"])] == \
        [(1, s.d_pad) for s in layout.segments]
    assert_same(state, ps, layout, ms, pms)
    assert [m["collectives_per_step"] for m in pms] == \
        [float(len(layout.segments))] * 3


@pytest.mark.parametrize("strategy", list(MESHES))
def test_perleaf_strategies_bitwise_bucketed(strategy):
    mesh = MESHES[strategy]
    state, ms, layout = _bucketed("topk", strategy, mesh)
    ps, pms, _ = train(config("topk", strategy), pipeline="perleaf",
                       mesh=mesh)
    assert_same(state, ps, layout, ms, pms)
    levels = {"allgather": 1, "gtopk": 2, "hierarchical": 2,
              "hier_gtopk": 2}[strategy]
    assert [m["collectives_per_step"] for m in pms] == \
        [float(levels * len(layout.segments))] * 3


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX mesh run of every strategy per leaf, one subprocess."""
    out = tmp_path_factory.mktemp("jax_mesh") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable,
                        os.path.join(TESTS, "_torch_chunked_ref.py"),
                        str(out), "perleaf"],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    with np.load(out) as data:
        return dict(data)


@pytest.mark.parametrize("strategy", list(MESHES))
def test_local_wire_perleaf_matches_jax_mesh(ref, strategy):
    m = mesh_run(ref, "perleaf", strategy, pipeline="perleaf")
    per_level = {"allgather": 1, "gtopk": 2, "hierarchical": 2,
                 "hier_gtopk": 2}[strategy]
    assert m["collectives_per_step"] == 12 * per_level


@pytest.mark.parametrize("mode", ["gaussiank-fused", "momentum-correction"])
def test_perleaf_checkpoint_resumes_bucketed(tmp_path, mode):
    """2 per-leaf steps, saved (``resid/<leaf path>`` entries), loaded
    into a bucketed state with ``layout=`` and 2 more bucketed steps
    equal 4 straight bucketed steps, bitwise; the per-leaf residuals
    packed equal the bucketed buffers after the same steps."""
    straight, ms, layout = train(config(mode), steps=4)
    two, _, _ = train(config(mode), steps=2)
    first, _, _ = train(config(mode), pipeline="perleaf", steps=2)
    for key in ("resid", "resid2"):
        if key in two:
            assert flat(first[key], layout).tobytes() == \
                two[key].numpy().tobytes()
    path = str(tmp_path / "perleaf.npz")
    save_state(path, first)
    with np.load(path) as data:
        assert "resid" not in data.files
        assert f"resid/{layout.segments[0].name}" in data.files
    fresh = init_train_state(init_params(CFG, 1, "cpu"), sgd_momentum(0.0),
                             workers=1, model_size=1, compression=config(mode),
                             layout=layout)
    with pytest.raises(KeyError, match="no entry 'resid'"):
        load_state(path, fresh)
    fresh = load_state(path, fresh, layout=layout)
    resumed, rms, _ = train(config(mode), state=fresh, steps=2, first_step=2)
    assert_same(straight, resumed, layout, ms[2:], rms)


def test_cli_resumes_a_perleaf_checkpoint_bucketed(tmp_path):
    base = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1",
            "--density-policy", "none",
            "--device", "cpu", "--batch", "4", "--seq", "16",
            "--log-every", "1"]
    straight = cli.run(base + ["--steps", "3", "--checkpoint",
                               str(tmp_path / "s.npz")])
    cli.run(base + ["--steps", "2", "--pipeline", "perleaf",
                    "--checkpoint", str(tmp_path / "p.npz")])
    resumed = cli.run(base + ["--steps", "1", "--resume",
                              str(tmp_path / "p.npz"), "--checkpoint",
                              str(tmp_path / "r.npz")])
    assert resumed[0]["step"] == 2
    assert resumed[0]["loss"] == straight[2]["loss"]
    with np.load(tmp_path / "s.npz") as a, np.load(tmp_path / "r.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].tobytes() == b[key].tobytes(), key


def test_process_group_wire_gloo_perleaf_bitwise_local(tmp_path):
    logs = pg_run(tmp_path, 2, ["--pipeline", "perleaf"])
    assert "pipeline=perleaf" in logs[0]
