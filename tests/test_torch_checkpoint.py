"""Checkpoints: the port's ``checkpoint/npz.py`` against the JAX
package's, both ways, on a 4-worker state with both residual levels; and
a resumed run against a straight one, bitwise."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_state as j_load
from repro.checkpoint import save_state as j_save
from repro.core.compression import CompressionConfig as JCompression
from repro.core.compressors import get_compressor as j_get
from repro.dist.layout import build_layout as j_build_layout
from repro.models import ModelConfig as JModelConfig
from repro.models import init_params as j_init
from repro.optim import adamw as j_adamw
from repro.optim import sgd_momentum as j_sgd
from repro.train import init_train_state as j_state
from repro_torch import tree
from repro_torch.checkpoint import load_state, save_state
from repro_torch.core.compression import CompressionConfig
from repro_torch.dist.layout import build_layout
from repro_torch.models import ModelConfig, from_jax_params, init_params
from repro_torch.optim import adamw, constant, sgd_momentum
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(2)

_CFG = dict(name="t", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)


def _states(opt_name):
    """The same 4-worker hierarchical state in both packages (random
    residuals, params and optimizer state, step 5)."""
    jparams = j_init(JModelConfig(**_CFG).validate(), jax.random.PRNGKey(0))
    jopt = j_sgd(0.9) if opt_name == "sgd" else j_adamw()
    jcomp = JCompression(strategy="hierarchical")
    jlay = j_build_layout(jparams, 1, 0.001, j_get("gaussiank"))
    js = j_state(jparams, jopt, workers=4, model_size=1, compression=jcomp,
                 layout=jlay)
    rng = np.random.default_rng(0)
    js = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32))
        if x.dtype == jnp.float32 else x, js)
    js["step"] = jnp.int32(5)
    if opt_name == "adamw":
        js["opt"]["t"] = jnp.int32(5)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    topt = sgd_momentum(0.9) if opt_name == "sgd" else adamw()
    comp = CompressionConfig(strategy="hierarchical")
    ts = init_train_state(params, topt, workers=4, model_size=1,
                          compression=comp,
                          layout=build_layout(params, 1, comp))
    return js, ts


def _same(js, ts):
    jpairs = jax.tree_util.tree_flatten_with_path(js)[0]
    tpairs = tree.flatten_with_path(ts)[0]
    assert len(jpairs) == len(tpairs)
    for (jp, a), (tp, b) in zip(jpairs, tpairs):
        assert "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                        for e in jp) == "/".join(map(str, tp))
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_jax_checkpoint_loads_into_the_port(tmp_path, opt_name):
    js, ts = _states(opt_name)
    path = str(tmp_path / "jax.npz")
    j_save(path, js)
    loaded = load_state(path, ts)
    assert loaded["resid"].shape == (4, js["resid"].shape[1])
    assert loaded["step"] == 5
    _same(js, loaded)


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_port_checkpoint_loads_into_jax(tmp_path, opt_name):
    js, ts = _states(opt_name)
    rng = np.random.default_rng(1)
    for leaf in tree.leaves(ts):
        if isinstance(leaf, torch.Tensor):
            leaf.copy_(torch.from_numpy(
                rng.standard_normal(tuple(leaf.shape)).astype(np.float32)))
    ts["step"] = 7
    if opt_name == "adamw":
        ts["opt"]["t"] = 7
    path = str(tmp_path / "port.npz")
    save_state(path, ts)
    loaded = j_load(path, js)
    assert int(loaded["step"]) == 7
    _same(loaded, ts)


def test_load_picks_worker_rows_and_checks_shapes(tmp_path):
    js, ts = _states("sgd")
    path = str(tmp_path / "jax.npz")
    j_save(path, js)
    params = tree.tree_map(torch.clone, ts["params"])
    comp = CompressionConfig(strategy="hierarchical")
    one = init_train_state(params, sgd_momentum(0.9), workers=1,
                           model_size=1, compression=comp,
                           layout=build_layout(params, 1, comp))
    got = load_state(path, one, worker_rows=[2])
    np.testing.assert_array_equal(got["resid"].numpy(),
                                  np.asarray(js["resid"])[2:3])
    np.testing.assert_array_equal(got["resid2"].numpy(),
                                  np.asarray(js["resid2"])[2:3])
    with pytest.raises(ValueError, match="resid"):
        load_state(path, one)


@pytest.mark.parametrize("strategy,mesh", [("gtopk", "4x1"),
                                           ("hier_gtopk", "2x2x1")])
def test_resume_equals_straight_run(tmp_path, strategy, mesh):
    """2 steps, save, load into a fresh state, 1 step == 3 steps
    straight, bitwise (params, momentum, residuals, losses)."""
    cfg = ModelConfig(**_CFG).validate()
    comp = CompressionConfig(ratio=0.01, strategy=strategy)
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, 64, (8, 16)))
        batches.append({"tokens": toks, "labels": torch.roll(toks, -1, 1)})

    def fresh():
        params = init_params(cfg, 0, "cpu")
        layout = build_layout(params, 1, comp)
        opt = sgd_momentum(0.9)
        state = init_train_state(params, opt, workers=4, model_size=1,
                                 compression=comp, layout=layout)
        return state, make_train_step(cfg, mesh, opt, constant(0.1),
                                      compression=comp, layout=layout)

    straight, step = fresh()
    losses = [float(step(straight, b)[1]["loss"]) for b in batches]
    first, step = fresh()
    for b in batches[:2]:
        step(first, b)
    save_state(str(tmp_path / "ck.npz"), first)
    resumed, step = fresh()
    resumed = load_state(str(tmp_path / "ck.npz"), resumed)
    assert resumed["step"] == 2
    last = float(step(resumed, batches[2])[1]["loss"])
    assert last == losses[2]
    for a, b in zip(tree.leaves(resumed), tree.leaves(straight)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        else:
            assert a == b


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "deepseek-moe-16b"])
def test_cli_resume_equals_straight_run_new_archs(tmp_path, arch):
    """The Mamba hybrid's and the MoE model's smoke variants through the
    CLI (fused Gaussian-k): 2 steps saved and resumed for a third save
    what 3 straight steps save, bitwise, with the same last loss."""
    from repro_torch.launch import train as cli
    base = ["--arch", arch, "--smoke", "--mesh", "1x1", "--device", "cpu",
            "--batch", "4",
            "--seq", "16"]
    a, b, c = (str(tmp_path / n) for n in ("a.npz", "b.npz", "c.npz"))
    cli.run(base + ["--steps", "2", "--checkpoint", a])
    (last,) = cli.run(base + ["--steps", "1", "--resume", a, "--checkpoint",
                              b])
    straight = cli.run(base + ["--steps", "3", "--checkpoint", c])
    assert last["step"] == 2 and last["loss"] == straight[2]["loss"]
    with np.load(b) as x, np.load(c) as y:
        assert sorted(x.files) == sorted(y.files)
        assert int(x["step"]) == 3
        for k in x.files:
            assert x[k].tobytes() == y[k].tobytes(), k


def test_tensor_parallel_checkpoint_round_trip(tmp_path):
    """A tensor-parallel run's checkpoint (2 gloo processes at ``1x2``,
    ``tests/_torch_tp_pg.py``) has the one-process run's keys and
    shapes (the shards and the residual rows gathered into the
    ``(workers, M·d_row_total)`` buckets), and it resumes a one-process
    run; a one-process checkpoint resumes the tensor-parallel run.
    Either resumed third step has the loss of 3 straight one-process
    steps within rtol 1e-5, and its final state their checkpoint's
    within the tolerances of ``tests/test_torch_tp.py``."""
    from _torch_tp_pg import CFG, launch
    from repro_torch.launch import train as cli
    from test_torch_tp import compare_checkpoints
    base = ["--arch", "llama3.2-1b", "--mesh", "1x2", "--compressor",
            "gaussiank", "--ratio", "0.02", "--density-policy", "none",
            "--batch", "4", "--seq", "16"]
    one = ["--device", "cpu", "--host-devices", "2"]
    p = {n: str(tmp_path / f"{n}.npz") for n in ("one2", "one3", "back")}
    cli.run(base + one + ["--steps", "2", "--checkpoint", p["one2"]],
            cfg=CFG)
    straight = cli.run(base + one + ["--steps", "3", "--checkpoint",
                                     p["one3"]], cfg=CFG)
    launch(tmp_path, 2, [
        {"name": "tp2", "argv": base + ["--steps", "2"]},
        {"name": "tp3", "argv": base + ["--steps", "1", "--resume",
                                        p["one2"]]}], timeout=300)
    (back,) = cli.run(base + one + ["--steps", "1", "--resume",
                                    str(tmp_path / "tp2.npz"),
                                    "--checkpoint", p["back"]], cfg=CFG)
    with open(tmp_path / "tp3.json") as f:
        (resumed,) = json.load(f)
    for rec in (back, resumed):
        assert rec["step"] == 2
        np.testing.assert_allclose(rec["loss"], straight[2]["loss"],
                                   rtol=1e-5)
    with np.load(p["one2"]) as a, np.load(tmp_path / "tp2.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].shape == b[k].shape for k in a.files)
    for got in (p["back"], str(tmp_path / "tp3.npz")):
        with np.load(p["one3"]) as want, np.load(got) as g:
            assert int(g["step"]) == 3
            compare_checkpoints(want, g, "1x2", base)


def test_tensor_parallel_blocks_resume_either_form(tmp_path):
    """jamba-1.5-large's smoke variant (Mamba with ``in_proj`` placed as
    ``(D, 2, d_inner)``, attention, MLP and MoE layers) under tensor
    parallelism at ``1x2`` resumes a one-process per-leaf checkpoint
    into either form: the bucketed TP state (the per-leaf residuals
    packed into the bucket, then cut to the rank's row) and the per-leaf
    TP state (each leaf's residual cut to its row).  Each resumed third
    step has the loss of 3 straight one-process steps within rtol 1e-5;
    the per-leaf TP run saves the per-leaf checkpoint's keys and shapes
    (``resid/<leaf path>`` gathered to ``(workers, d_pad)``)."""
    from _torch_tp_pg import launch
    from repro_torch.launch import train as cli
    base = ["--arch", "jamba-1.5-large-398b", "--smoke", "--mesh", "1x2",
            "--compressor", "gaussiank", "--ratio", "0.02",
            "--density-policy", "none", "--batch", "4", "--seq", "16"]
    one = ["--device", "cpu", "--host-devices", "2"]
    leaf2 = str(tmp_path / "leaf2.npz")
    cli.run(base + one + ["--steps", "2", "--pipeline", "perleaf",
                          "--checkpoint", leaf2])
    straight = cli.run(base + one + ["--steps", "3"])
    launch(tmp_path, 2, [
        {"name": "bucketed", "argv": base + ["--steps", "1", "--resume",
                                             leaf2]},
        {"name": "perleaf", "argv": base + ["--steps", "1", "--resume",
                                            leaf2, "--pipeline",
                                            "perleaf"]}], timeout=300)
    for name in ("bucketed", "perleaf"):
        with open(tmp_path / f"{name}.json") as f:
            (rec,) = json.load(f)
        assert rec["step"] == 2, name
        np.testing.assert_allclose(rec["loss"], straight[2]["loss"],
                                   rtol=1e-5, err_msg=name)
    with np.load(leaf2) as a, np.load(tmp_path / "perleaf.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].shape == b[k].shape for k in a.files)
        assert int(b["step"]) == 3
