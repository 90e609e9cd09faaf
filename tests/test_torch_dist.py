"""The port's data-parallel wire against the JAX package, on the CPU.

* The four wire strategies, ``LocalWire`` (all workers in this process),
  against the JAX mesh train step on 4 forced host devices
  (``tests/_torch_dist_ref.py`` in a subprocess, ``backend="reference"``,
  compressor ``topk`` at 0.02, the 2-layer config of
  ``tests/_dist_check.py``, 2 steps): ``(4, 1)`` for allgather and gtopk,
  ``(2, 2, 1)`` for hierarchical and hier_gtopk.  Losses, params and
  residuals within slice 1's rtol 1e-4 / atol 1e-5
  (``test_torch_train.py``): the gradients differ from XLA's by f32
  summation order.  The wire accounting is equal.
* The gTop-k pieces on numpy partials: the round plan equal, and
  ``gtopk_simulate`` bitwise the reference's.  The port's re-encode
  reproduces ``lax.top_k``'s tie order (the lower index wins a tie at the
  k-th magnitude), so the zero-valued slots of a row with fewer non-zeros
  than ``k_cap`` carry the reference's indices too.
* deepseek-moe-16b's smoke variant at ``(4, 1)``, allgather, against
  the same JAX mesh run: the MoE capacity is each worker's.
* The model axis (``M2_CASES`` of the same subprocess, on 8 forced host
  devices): a model axis of 2 in one process, each worker's buckets two
  rows selecting ``ceil(k / 2)`` each, at ``(2, 2)`` for allgather,
  gtopk, adaptive density (``variance``) and ``randk``, at ``(2, 1, 2)``
  for hierarchical and hier_gtopk, and at the reference's default
  ``(4, 2)``; the tolerances above.  The same at ``(2, 2)`` on the smoke
  variants of jamba-1.5-large and xlstm-125m (``M2_BLOCKS``: Mamba,
  MoE, mLSTM and sLSTM layers), params and residuals within them but at
  near-tie swaps of a selection.
* The rank-order decode of gathered pairs with cross-rank duplicates,
  bitwise a sequential numpy sum.
* ``_wire_cast_fixup`` for bf16 and fp16, bitwise the reference's.
* ``ProcessGroupWire`` over gloo in 2 and 4 processes (the trainer under
  a ``torchrun``-style environment, ``tests/_torch_dist_pg.py``), bitwise
  equal to ``LocalWire``: params, optimizer state, residuals and losses.
"""
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

from repro.dist import aggregate as jagg
from repro.models import ModelConfig as JModelConfig
from repro.models import init_params as j_init
from _torch_steps import near_tie_swaps as _near_tie_swaps
from repro_torch import tree
from repro_torch.core import codec
from repro_torch.core.compression import CompressionConfig
from repro_torch.dist import aggregate as tagg
from repro_torch.dist.layout import build_layout
from repro_torch.dist.wire import LocalWire
from repro_torch.launch import train as cli
from repro_torch.launch.mesh import (data_world_size, parse_mesh,
                                     worker_coords, worker_index)
from repro_torch.models import ModelConfig, from_jax_params
from repro_torch.optim import constant, sgd_momentum
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
_CFG = dict(name="t", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
MESHES = {"allgather": "4x1", "gtopk": "4x1", "hierarchical": "2x2x1",
          "hier_gtopk": "2x2x1"}
METRICS = ("loss", "density", "density_cap", "comm_bits_sparse",
           "comm_bits_dense", "wire_bytes", "collectives_per_step")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX mesh run of every strategy, one subprocess."""
    out = tmp_path_factory.mktemp("jax_mesh") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable,
                        os.path.join(TESTS, "_torch_dist_ref.py"), str(out)],
                       env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    with np.load(out) as data:
        return dict(data)


@pytest.mark.parametrize("strategy", list(MESHES))
def test_local_wire_matches_jax_mesh(ref, strategy):
    jparams = j_init(JModelConfig(**_CFG).validate(), jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    for i, leaf in enumerate(jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(leaf, ref[f"init/{i}"])
    params = from_jax_params(np_params, "cpu")
    comp = CompressionConfig(compressor="topk", ratio=0.02,
                             strategy=strategy, backend="reference")
    layout = build_layout(params, 1, comp)
    mesh = parse_mesh(MESHES[strategy])
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=data_world_size(mesh),
                             model_size=1, compression=comp, layout=layout)
    step = make_train_step(ModelConfig(**_CFG).validate(), mesh, opt,
                           constant(0.05), compression=comp, layout=layout)
    for s in range(2):
        batch = {k: torch.from_numpy(ref[f"batch/{s}/{k}"]).long()
                 for k in ("tokens", "labels")}
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]),
                                   ref[f"{strategy}/{s}/loss"], rtol=1e-4)
        for k in METRICS[1:]:
            np.testing.assert_allclose(float(m[k]),
                                       ref[f"{strategy}/{s}/{k}"],
                                       rtol=1e-6, err_msg=k)
    for i, leaf in enumerate(tree.leaves(state["params"])):
        np.testing.assert_allclose(leaf.numpy(), ref[f"{strategy}/params/{i}"],
                                   rtol=1e-4, atol=1e-5)
    keys = ["resid"] + (["resid2"] if strategy.startswith("hier") else [])
    assert sorted(k for k in ("resid", "resid2") if k in state) == keys
    for key in keys:
        np.testing.assert_allclose(state[key].numpy(),
                                   ref[f"{strategy}/{key}"], rtol=1e-4,
                                   atol=1e-5)


M2_MESHES = {"m2_allgather": ("2x2", "allgather", "topk", None),
             "m2_gtopk": ("2x2", "gtopk", "topk", None),
             "m2_hierarchical": ("2x1x2", "hierarchical", "topk", None),
             "m2_hier_gtopk": ("2x1x2", "hier_gtopk", "topk", None),
             "m2_variance": ("2x2", "allgather", "topk", "variance"),
             "m2_randk": ("2x2", "allgather", "randk", None),
             "m2_4x2": ("4x2", "allgather", "topk", None)}


@pytest.mark.parametrize("case", list(M2_MESHES))
def test_local_wire_model_axis_matches_jax_mesh(ref, case):
    """A model axis of 2 in one process (``LocalWire``, the buckets
    ``(2, d_row_total)``) against the JAX mesh step at the same mesh:
    losses, the wire accounting (and ``k_total`` under adaptive
    density) and the final params and residuals ``(D, 2·d_row_total)``
    at the tolerances of the model axis of 1."""
    from repro_torch.core.adaptk import make_policy
    mesh_s, strategy, compressor, policy = M2_MESHES[case]
    jparams = j_init(JModelConfig(**_CFG).validate(), jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    for i, leaf in enumerate(jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(leaf, ref[f"m2/init/{i}"])
    params = from_jax_params(np_params, "cpu")
    comp = CompressionConfig(compressor=compressor, ratio=0.02,
                             strategy=strategy, backend="reference",
                             density_policy=policy and make_policy(policy))
    layout = build_layout(params, 2, comp)
    mesh = parse_mesh(mesh_s)
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=data_world_size(mesh),
                             model_size=2, compression=comp, layout=layout)
    step = make_train_step(ModelConfig(**_CFG).validate(), mesh, opt,
                           constant(0.05), compression=comp, layout=layout)
    for s in range(2):
        batch = {k: torch.from_numpy(ref[f"m2/batch/{s}/{k}"]).long()
                 for k in ("tokens", "labels")}
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), ref[f"{case}/{s}/loss"],
                                   rtol=1e-4)
        for k in METRICS[1:] + (("k_total",) if policy else ()):
            np.testing.assert_allclose(float(m[k]), ref[f"{case}/{s}/{k}"],
                                       rtol=1e-6, err_msg=k)
    for i, leaf in enumerate(tree.leaves(state["params"])):
        np.testing.assert_allclose(leaf.numpy(), ref[f"{case}/params/{i}"],
                                   rtol=1e-4, atol=1e-5)
    keys = ["resid"] + (["resid2"] if strategy.startswith("hier") else [])
    for key in keys:
        assert state[key].shape == (data_world_size(mesh),
                                    2 * layout.d_row_total)
        np.testing.assert_allclose(state[key].numpy(), ref[f"{case}/{key}"],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["m2_jamba", "m2_xlstm"])
def test_local_wire_model_axis_blocks_match_jax_mesh(ref, case):
    """A model axis of 2 in one process at ``2x2`` on the smoke variants
    of jamba-1.5-large (Mamba, attention, MLP, MoE) and xlstm-125m
    (mLSTM, sLSTM) against the JAX mesh step (allgather, ``topk``):
    losses and the wire accounting at the tolerances above; params and
    the ``(2, 2·d_row_total)`` residuals within them but at near-tie
    swaps of the top-k selection (``_near_tie_swaps``)."""
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config
    arch = {"m2_jamba": "jamba-1.5-large-398b",
            "m2_xlstm": "xlstm-125m"}[case]
    jparams = j_init(j_get_config(arch).reduced(), jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    for i, leaf in enumerate(jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(leaf, ref[f"{case}/init/{i}"])
    cfg = get_config(arch).reduced()
    params = from_jax_params(np_params, "cpu")
    comp = CompressionConfig(compressor="topk", ratio=0.02,
                             backend="reference")
    layout = build_layout(params, 2, comp)
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=2, model_size=2,
                             compression=comp, layout=layout)
    step = make_train_step(cfg, "2x2", opt, constant(0.05),
                           compression=comp, layout=layout,
                           wire=LocalWire(parse_mesh("2x2")))
    for s in range(2):
        batch = {k: torch.from_numpy(ref[f"{case}/batch/{s}/{k}"]).long()
                 for k in ("tokens", "labels")}
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), ref[f"{case}/{s}/loss"],
                                   rtol=1e-4)
        for k in METRICS[1:]:
            np.testing.assert_allclose(float(m[k]), ref[f"{case}/{s}/{k}"],
                                       rtol=1e-6, err_msg=k)
    swapped = _near_tie_swaps(state["resid"].numpy(), ref[f"{case}/resid"])
    skip = {}
    for col in swapped:
        r, c = divmod(col, layout.d_row_total)
        (seg,) = [g for g in layout.segments
                  if g.row_off <= c < g.row_off + g.d_row]
        skip.setdefault(seg.name, []).append(r * seg.d_row + c - seg.row_off)
    for i, (path, leaf) in enumerate(
            tree.flatten_with_path(state["params"])[0]):
        got = leaf.numpy().reshape(-1).copy()
        want = ref[f"{case}/params/{i}"].reshape(-1).copy()
        at = [j for j in skip.get(tree.path_name(path), []) if j < got.size]
        got[at] = want[at]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=tree.path_name(path))


def test_local_wire_moe_matches_jax_mesh(ref):
    """deepseek-moe-16b's smoke variant on 4 workers (``--host-devices 4
    --mesh 4x1``, allgather): each worker's MoE layers dispatch its own
    2 rows at the capacity of its own 32 tokens, as each device of the
    reference's mesh does; losses at the tolerances above, the wire
    accounting equal, and params and residuals within them but at
    near-tie swaps of the top-k selection (``_near_tie_swaps``): two
    of worker 0's gradient elements of equal magnitude to f32 rounding
    order one way in XLA's sums and the other in torch's."""
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config
    jparams = j_init(j_get_config("deepseek-moe-16b").reduced(),
                     jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    for i, leaf in enumerate(jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(leaf, ref[f"moe/init/{i}"])
    cfg = get_config("deepseek-moe-16b").reduced()
    params = from_jax_params(np_params, "cpu")
    comp = CompressionConfig(compressor="topk", ratio=0.02,
                             backend="reference")
    layout = build_layout(params, 1, comp)
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=4, model_size=1,
                             compression=comp, layout=layout)
    step = make_train_step(cfg, "4x1", opt, constant(0.05),
                           compression=comp, layout=layout)
    for s in range(2):
        batch = {k: torch.from_numpy(ref[f"moe/batch/{s}/{k}"]).long()
                 for k in ("tokens", "labels")}
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), ref[f"moe/{s}/loss"],
                                   rtol=1e-4)
        for k in METRICS[1:]:
            np.testing.assert_allclose(float(m[k]), ref[f"moe/{s}/{k}"],
                                       rtol=1e-6, err_msg=k)
    swapped = _near_tie_swaps(state["resid"].numpy(), ref["moe/resid"])
    skip = {}
    for col in swapped:
        (seg,) = [g for g in layout.segments
                  if g.row_off <= col < g.row_off + g.size]
        skip.setdefault(seg.name, []).append(col - seg.row_off)
    for i, (path, leaf) in enumerate(
            tree.flatten_with_path(state["params"])[0]):
        got = leaf.numpy().reshape(-1).copy()
        want = ref[f"moe/params/{i}"].reshape(-1).copy()
        at = skip.get(tree.path_name(path), [])
        got[at] = want[at]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("sizes", [(1,), (2,), (4,), (8,), (2, 2), (2, 4),
                                   (4, 2), (2, 1, 2)])
def test_gtopk_round_plan_matches_reference(sizes):
    assert tagg.gtopk_round_plan(sizes) == jagg.gtopk_round_plan(sizes)


def test_gtopk_round_plan_needs_powers_of_two():
    for sizes in [(3,), (2, 3)]:
        with pytest.raises(ValueError, match="power-of-two"):
            tagg.gtopk_round_plan(sizes)
        with pytest.raises(ValueError, match="power-of-two"):
            jagg.gtopk_round_plan(sizes)


def _partials(W, rows=2, d_row=64, nnz=10, seed=0):
    """Sparse per-worker partials whose supports overlap across workers."""
    rng = np.random.default_rng(seed + W)
    out = []
    for _ in range(W):
        p = np.zeros((rows, d_row), np.float32)
        for r in range(rows):
            idx = rng.choice(d_row // 2, nnz, replace=False)
            p[r, idx] = rng.standard_normal(nnz).astype(np.float32)
        out.append(p)
    return out


@pytest.mark.parametrize("W", [2, 4, 8])
def test_gtopk_simulate_matches_reference(W):
    parts, k_cap = _partials(W), 12
    jfinal, jdrops = jagg.gtopk_simulate([jnp.asarray(p) for p in parts],
                                         k_cap)
    tfinal, tdrops = tagg.gtopk_simulate([torch.from_numpy(p)
                                          for p in parts], k_cap)
    np.testing.assert_array_equal(tfinal.numpy(), np.asarray(jfinal))
    for a, b in zip(tdrops, jdrops):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("W", [2, 4, 8])
def test_gtopk_rounds_match_simulate(W):
    """The wire's in-place rounds over ``LocalWire`` against the dense
    simulation, bitwise; conservation Σ e'_w + final = Σ partials."""
    parts, k_cap = _partials(W), 12
    pairs = [tagg.encode_rows_topk(torch.from_numpy(p), k_cap)
             for p in parts]
    wire = LocalWire(parse_mesh(f"{W}x1"))
    sums, drops = tagg._gtopk_reduce_rounds(
        [v for v, _ in pairs], [i for _, i in pairs], ("data",), 64,
        lambda dense: tagg.encode_rows_topk(dense, k_cap), wire)
    final, sim_drops = tagg.gtopk_simulate([torch.from_numpy(p)
                                            for p in parts], k_cap)
    for s in sums:
        assert torch.equal(s, final)
    for d, sd in zip(drops, sim_drops):
        assert torch.equal(torch.zeros_like(sd) if d is None else d, sd)
    total = sum(torch.from_numpy(p).double() for p in parts)
    credit = sum(sd.double() for sd in sim_drops)
    np.testing.assert_allclose((final.double() + credit).numpy(),
                               total.numpy(), atol=1e-6)


def test_encode_rows_topk_matches_lax_ties():
    """Rows with fewer non-zeros than ``k_cap`` and tied magnitudes: the
    slots equal ``lax.top_k``'s, values and indices."""
    row = np.zeros((3, 50), np.float32)
    row[0, [3, 9, 20]] = [0.5, -0.5, 0.25]
    row[1, :] = 1.0
    row[2, [40, 2, 7]] = [-2.0, 2.0, 2.0]
    jv, ji = jagg.encode_rows_topk(jnp.asarray(row), 8)
    tv, ti = tagg.encode_rows_topk(torch.from_numpy(row), 8)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_decode_sum_rank_order_with_cross_rank_duplicates():
    rng = np.random.default_rng(3)
    n, rows, k, d = 4, 2, 16, 40
    vals = rng.standard_normal((n, rows, k)).astype(np.float32)
    idx = np.stack([np.stack([rng.choice(d, k, replace=False)
                              for _ in range(rows)]) for _ in range(n)])
    idx = idx.astype(np.int32)
    idx[:, :, -3:] = codec.SENTINEL          # padding slots
    vals[:, :, -3:] = 0.0
    assert len(np.unique(idx[:, 0, :-3])) < n * (k - 3)   # duplicates
    want = np.zeros((rows, d), np.float32)
    for r in range(n):
        for m in range(rows):
            for v, i in zip(vals[r, m], idx[r, m]):
                if i != codec.SENTINEL:
                    want[m, i] = np.float32(want[m, i] + v)
    got = codec.decode_sum(torch.from_numpy(vals), torch.from_numpy(idx), d)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("wire", ["bfloat16", "float16"])
def test_wire_cast_fixup_matches_reference(wire):
    rng = np.random.default_rng(7)
    rows, k, d = 2, 24, 200
    idx = np.stack([rng.choice(d, k, replace=False) for _ in range(rows)])
    idx = idx.astype(np.int32)
    idx[:, -4:] = codec.SENTINEL
    vals = (1e-3 * rng.standard_normal((rows, k))).astype(np.float32)
    vals[:, -4:] = 0.0
    e = (1e-4 * rng.standard_normal((rows, d))).astype(np.float32)
    for m in range(rows):
        e[m, idx[m, :-4]] = 0.0               # the selected slots of e'
    jw, ji, je = jagg._wire_cast_fixup(jnp.asarray(vals), jnp.asarray(idx),
                                       jnp.asarray(e), getattr(jnp, wire))
    te = torch.from_numpy(e.copy())
    tw, ti, te2 = tagg._wire_cast_fixup(torch.from_numpy(vals),
                                        torch.from_numpy(idx), te,
                                        getattr(torch, wire))
    assert te2 is te and tw.dtype == getattr(torch, wire)
    np.testing.assert_array_equal(tw.float().numpy(),
                                  np.asarray(jw).astype(np.float32))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # decode(cast v) + e' == v + e (the uncast wire), bitwise
    for m in range(rows):
        dec = codec.decode(tw[m].float(), ti[m], d)
        ref = codec.decode(torch.from_numpy(vals[m]), ti[m], d) + \
            torch.from_numpy(e[m])
        assert torch.equal(dec + te[m], ref)


def test_mesh_parse_and_joint_rank():
    m = parse_mesh("2x4x1")
    assert m.axis_names == ("pod", "data", "model") and m.shape == (2, 4, 1)
    assert data_world_size(m) == 8
    for r in range(8):
        c = worker_coords(m, r)
        assert c == {"pod": r // 4, "data": r % 4}
        assert worker_index(m, c) == r
    wire = LocalWire(m)
    assert wire.group(5, "data") == [4, 5, 6, 7]
    assert wire.group(5, "pod") == [1, 5]
    assert wire.group(5, ("pod", "data")) == list(range(8))
    assert parse_mesh("4x1").axis_names == ("data", "model")
    with pytest.raises(ValueError):
        parse_mesh("4")


def test_local_wire_collectives():
    wire = LocalWire(parse_mesh("2x2x1"))
    xs = [torch.full((2,), float(r)) for r in range(4)]
    g = wire.all_gather(xs, "data")
    assert g[0] is g[1] and torch.equal(g[2], torch.tensor([[2.0] * 2,
                                                            [3.0] * 2]))
    p = wire.ppermute(xs, "pod", [(0, 1), (1, 0)])
    assert [float(t[0]) for t in p] == [2.0, 3.0, 0.0, 1.0]
    mean = wire.pmean(xs, ("pod", "data"))
    assert all(torch.equal(t, torch.full((2,), 1.5)) for t in mean)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_PG_MESHES = {2: {"allgather": "2x1", "gtopk": "2x1",
                  "hierarchical": "2x1x1", "hier_gtopk": "2x1x1"},
              4: MESHES}


@pytest.mark.parametrize("W", [2, 4])
def test_process_group_wire_gloo_bitwise_local(tmp_path, W):
    meshes = _PG_MESHES[W]
    cases = [f"{s}:{m}:{_free_port()}" for s, m in meshes.items()]
    procs = []
    for r in range(W):
        env = dict(os.environ, PYTHONPATH=SRC, RANK=str(r),
                   WORLD_SIZE=str(W), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(W), MASTER_ADDR="127.0.0.1",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "_torch_dist_pg.py"),
             str(tmp_path), "cpu"] + cases, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert "wire=process_group dist_backend=gloo" in logs[0]
    for strategy, mesh in meshes.items():
        name = f"{strategy}-{mesh}"
        local = tmp_path / f"local-{name}.npz"
        recs = cli.run(["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1",
                        "--density-policy", "none", "--device", "cpu",
                        "--steps", "2", "--batch", "4", "--seq", "16",
                        "--mesh", mesh, "--strategy", strategy,
                        "--host-devices", str(W), "--checkpoint",
                        str(local)])
        with np.load(local) as a, np.load(tmp_path / f"{name}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            assert ("resid2" in a.files) == strategy.startswith("hier")
            for key in a.files:
                assert a[key].shape[:1] == b[key].shape[:1]
                assert a[key].tobytes() == b[key].tobytes(), key
            assert a["resid"].shape[0] == W
        with open(tmp_path / f"{name}.json") as f:
            pg = json.load(f)
        assert [r["loss"] for r in recs] == [r["loss"] for r in pg]
        assert [r["density"] for r in recs] == [r["density"] for r in pg]


def test_nccl_needs_a_card_per_rank(monkeypatch):
    """Two NCCL ranks on one card raise before any process group starts;
    nothing swaps in another backend."""
    from repro_torch.dist import wire
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card per rank: 2 ranks"):
        wire.init_process_group("nccl", rank=1, world_size=2,
                                local_rank=1)
    assert not torch.distributed.is_initialized()
