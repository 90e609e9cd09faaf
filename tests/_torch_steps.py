"""Shared helpers of ``tests/test_torch_chunked.py`` and
``tests/test_torch_perleaf.py``: train the port's small config (the
2-layer config of ``tests/_dist_check.py``) through ``make_train_step``
at a dispatch granularity (bucketed, chunked, per-leaf), compare two
states bitwise, hold ``LocalWire`` against the JAX mesh run of
``tests/_torch_chunked_ref.py``, and run the trainer over gloo against
``LocalWire``; and the near-tie swap check of ``tests/test_torch_dist.py``
and ``tests/test_torch_tp.py``."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.adaptk import make_policy
from repro_torch.core.compression import CompressionConfig
from repro_torch.data import batch_for
from repro_torch.dist.layout import build_layout, pack_residual_arrays
from repro_torch.dist.wire import LocalWire
from repro_torch.launch import train as cli
from repro_torch.launch.mesh import (data_world_size, model_axis_size,
                                     parse_mesh)
from repro_torch.models import ModelConfig, from_jax_params, init_params
from repro_torch.optim import constant, sgd_momentum
from repro_torch.train import init_train_state, make_train_step

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
_CFG = dict(name="t", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
CFG = ModelConfig(**_CFG).validate()
METRICS = ("loss", "density", "density_cap", "comm_bits_sparse",
           "comm_bits_dense", "wire_bytes", "collectives_per_step")
MESHES = {"allgather": "4x1", "gtopk": "4x1", "hierarchical": "2x2x1",
          "hier_gtopk": "2x2x1"}
# compressor and mode: CompressionConfig fields (density_policy by name)
MODES = {
    "topk": dict(compressor="topk"),
    "gaussiank-fused": dict(compressor="gaussiank", backend="fused"),
    "gaussiank-reference": dict(compressor="gaussiank",
                                backend="reference"),
    "histk": dict(compressor="histk"),
    "randk": dict(compressor="randk"),
    "rtopk": dict(compressor="rtopk"),
    "variance": dict(compressor="gaussiank", density_policy="variance"),
    "momentum-correction": dict(compressor="gaussiank",
                                momentum_correction=0.9),
}


def config(mode, strategy="allgather", chunks=1, ratio=0.02):
    kw = dict(MODES[mode])
    if kw.get("density_policy"):
        kw["density_policy"] = make_policy(kw["density_policy"], ema=0.5)
    return CompressionConfig(ratio=ratio, strategy=strategy, chunks=chunks,
                             **kw)


def train(comp, *, pipeline="bucketed", mesh="1x1", steps=3, probe=None,
          state=None, first_step=0, params=None, cfg=CFG):
    """``steps`` steps of ``cfg`` (default ``CFG``) from ``init_params(cfg,
    0)`` (or ``params``, or ``state``) on ``batch_for``'s batches of 8 x
    16, at the mesh's model axis; returns ``(state, metrics per step,
    layout)``."""
    if params is None:
        params = init_params(cfg, 0, "cpu")
    mesh = parse_mesh(mesh)
    M = model_axis_size(mesh)
    layout = (build_layout(params, M, comp) if pipeline == "bucketed"
              else None)
    wire = LocalWire(mesh)
    opt = sgd_momentum(0.0 if comp.momentum_correction else 0.9)
    if state is None:
        state = init_train_state(params, opt, workers=wire.local_workers,
                                 model_size=M, compression=comp,
                                 layout=layout)
    step = make_train_step(cfg, mesh, opt, constant(0.05),
                           compression=comp, layout=layout, probe=probe,
                           wire=wire)
    out = []
    for i in range(first_step, first_step + steps):
        state, m = step(state, batch_for(cfg, i, global_batch=8, seq_len=16,
                                         device="cpu"))
        out.append({k: float(v) for k, v in m.items()})
    return state, out, layout or build_layout(params, M, comp)


def flat(resid, layout):
    """A residual as the flat ``(workers, flat)`` numpy bucket (per-leaf
    trees packed with ``pack_residual_arrays``)."""
    if isinstance(resid, torch.Tensor):
        return resid.numpy()
    return pack_residual_arrays(layout, [x.numpy()
                                         for x in tree.leaves(resid)])


def assert_same(a, b, layout, ma=None, mb=None):
    """Two train states (and their step metrics) bitwise equal: params,
    optimizer state, ``resid``, ``resid2`` and the controller state; the
    metrics but ``collectives_per_step``."""
    for key in ("params", "opt"):
        la, lb = tree.leaves(a[key]), tree.leaves(b[key])
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert torch.equal(x, y), key
    assert a["step"] == b["step"]
    for key in ("resid", "resid2"):
        assert (key in a) == (key in b), key
        if key in a:
            assert flat(a[key], layout).tobytes() == \
                flat(b[key], layout).tobytes(), key
    assert ("adaptk" in a) == ("adaptk" in b)
    for k in a.get("adaptk", {}):
        np.testing.assert_array_equal(a["adaptk"][k], b["adaptk"][k])
    for x, y in zip(ma or [], mb or []):
        assert set(x) == set(y)
        for k in x:
            if k != "collectives_per_step":
                assert x[k] == y[k], (k, x[k], y[k])


def pg_run(tmp_path, W, extra):
    """``tests/_torch_dist_pg.py`` in ``W`` gloo processes, each strategy
    of the mesh, with ``extra`` trainer flags; returns the logs."""
    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    meshes = ({"allgather": "2x1", "gtopk": "2x1", "hierarchical": "2x1x1",
               "hier_gtopk": "2x1x1"} if W == 2 else MESHES)
    cases = [f"{s}:{m}:{free_port()}" for s, m in meshes.items()]
    procs = []
    for r in range(W):
        env = dict(os.environ, PYTHONPATH=SRC, RANK=str(r),
                   WORLD_SIZE=str(W), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(W), MASTER_ADDR="127.0.0.1",
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "_torch_dist_pg.py"),
             str(tmp_path), "cpu"] + cases + ["--"] + extra, env=env,
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
                        str(local)] + extra)
        with np.load(local) as a, np.load(tmp_path / f"{name}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].tobytes() == b[key].tobytes(), key
        with open(tmp_path / f"{name}.json") as f:
            pg = json.load(f)
        assert [r["loss"] for r in recs] == [r["loss"] for r in pg]
        for r, q in zip(recs, pg):
            assert r["collectives_per_step"] == q["collectives_per_step"]
    return logs


def mesh_run(ref, variant, strategy, pipeline="bucketed", chunks=1):
    """The port's ``LocalWire`` run of ``tests/_torch_dist_ref.py``'s
    case against the JAX mesh run ``ref[variant/strategy]``."""
    import jax

    from repro.models import ModelConfig as JModelConfig
    from repro.models import init_params as j_init
    jparams = j_init(JModelConfig(**_CFG).validate(), jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    comp = CompressionConfig(compressor="topk", ratio=0.02,
                             strategy=strategy, backend="reference",
                             chunks=chunks)
    layout = (build_layout(params, 1, comp) if pipeline == "bucketed"
              else None)
    mesh = parse_mesh(MESHES[strategy])
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=data_world_size(mesh),
                             model_size=1, compression=comp, layout=layout)
    step = make_train_step(CFG, mesh, opt, constant(0.05), compression=comp,
                           layout=layout)
    rng = np.random.default_rng(1)      # tests/_torch_dist_ref.batches
    tag = f"{variant}/{strategy}"
    for s in range(2):
        toks = rng.integers(0, 64, (8, 16)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(toks).long(),
                 "labels": torch.from_numpy(np.roll(toks, -1, 1)).long()}
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), ref[f"{tag}/{s}/loss"],
                                   rtol=1e-4)
        for k in METRICS[1:]:
            want = ref[f"{tag}/{s}/{k}"]
            if k == "collectives_per_step":
                assert float(m[k]) == float(want), (k, float(m[k]), want)
            else:
                np.testing.assert_allclose(float(m[k]), want, rtol=1e-6,
                                           err_msg=k)
    for i, leaf in enumerate(tree.leaves(state["params"])):
        np.testing.assert_allclose(leaf.numpy(), ref[f"{tag}/params/{i}"],
                                   rtol=1e-4, atol=1e-5)
    keys = ["resid"] + (["resid2"] if strategy.startswith("hier") else [])
    assert sorted(k for k in ("resid", "resid2") if k in state) == keys
    for key in keys:
        leaves = ([state[key]] if isinstance(state[key], torch.Tensor)
                  else tree.leaves(state[key]))
        for i, leaf in enumerate(leaves):
            np.testing.assert_allclose(leaf.numpy(), ref[f"{tag}/{key}/{i}"],
                                       rtol=1e-4, atol=1e-5)
    return m


def near_tie_swaps(got, want, limit=4):
    """The bucket columns where two runs' residuals ``(W, D)`` differ
    beyond rtol 1e-4 / atol 1e-5; each must be a near-tie swap of a
    top-k selection: in each row the columns pair up, one run sent
    (residual 0) what the other kept, and the kept magnitudes agree
    within rtol 1e-5 — elements at the k-th magnitude whose order f32
    summation flipped.  At most ``limit`` a row."""
    bad = ~np.isclose(got, want, rtol=1e-4, atol=1e-5)
    cols = []
    for w in range(got.shape[0]):
        c = np.flatnonzero(bad[w])
        assert len(c) <= limit, (w, c)
        sent_here = c[got[w, c] == 0]
        sent_there = c[want[w, c] == 0]
        assert len(sent_here) + len(sent_there) == len(c), (w, c)
        assert len(sent_here) == len(sent_there), (w, c)
        np.testing.assert_allclose(
            np.sort(np.abs(want[w, sent_here])),
            np.sort(np.abs(got[w, sent_there])), rtol=1e-5)
        cols += list(c)
    return sorted(set(cols))
