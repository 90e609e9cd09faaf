"""The slice as a whole: the port's train step against the JAX main path
composed outside ``shard_map`` from public functions (world size 1):

    jax.value_and_grad(loss_fn) -> pack_grads -> bucket_compress(fused)
    -> codec.decode -> unpack_tree -> sgd_momentum(0.9).update

and the port's training CLI on the CPU: world size 1, the four wire
strategies on several workers in this process (``--host-devices``),
checkpoints, the density flags, and the flags it does not carry yet.
(Adaptive density against the reference is in
``test_torch_adaptive.py``.)  (The multi-worker
step against the JAX mesh run is in ``test_torch_dist.py``.)

Tolerances: losses within rtol 1e-4 and params within rtol 1e-4, atol
1e-5 after 3 steps — the gradients differ from XLA's by f32 summation
order (see test_torch_model.py), which moves the Gaussian threshold by
ulps.  A selection flip at the threshold edge would move one element by
up to ``lr·|g|``; none happens on these inputs (checked, not loosened).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_prng_flag import threefry_partitionable  # noqa: F401
from repro.configs import get_config as j_get_config
from repro.core import codec as jcodec
from repro.core.compressors import get_compressor as j_get
from repro.data.synthetic import batch_for as j_batch_for
from repro.dist import aggregate as jagg
from repro.dist import layout as jl
from repro.models import init_params as j_init
from repro.models import loss_fn as j_loss
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import sgd_momentum as j_sgd
from repro_torch import tree
from repro_torch.core.compression import CompressionConfig
from repro_torch.dist.layout import build_layout
from repro_torch.launch import train as cli
from repro_torch.models import ModelConfig, from_jax_params
from repro_torch.optim import constant, sgd_momentum
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(2)

_CFG = dict(name="sys", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
STEPS, LR = 3, 0.1


def _batches(vocab):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (4, 16)).astype(np.int32)
        out.append({"tokens": toks, "labels": np.roll(toks, -1, axis=1)})
    return out


def _jax_reference(cfg, jparams, batches, compressor, ratio, backend):
    opt = j_sgd(0.9)
    state = opt.init(jparams)
    p = jparams
    layout = None
    if compressor != "none":
        spec = j_get(compressor)
        layout = jl.build_layout(jparams, 1, ratio, spec)
        D = layout.d_row_total
        E = jnp.zeros((1, D), jnp.float32)
        compress = jax.jit(lambda G, E: jagg.bucket_compress(
            G, E, layout, spec, None, backend=backend))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda q, b: j_loss(q, cfg, b, remat=False), has_aux=True))
    losses = []
    for b in batches:
        (loss, _), g = grad_fn(p, {k: jnp.asarray(v) for k, v in b.items()})
        if layout is not None:
            G = jl.pack_grads(layout, g, jnp.float32)
            v, i, E, _ = compress(G, E)
            mean = jcodec.decode(v[0], i[0], D)[None] / 1
            g = jl.unpack_tree(layout, mean, like=g)
        p, state = opt.update(p, state, g, jnp.float32(LR))
        losses.append(float(loss))
    return losses, p


@pytest.mark.parametrize("compressor,ratio,backend", [
    ("gaussiank", 0.01, "fused"), ("gaussiank", 0.001, "fused"),
    ("gaussiank2", 0.01, "fused"), ("topk", 0.01, "reference"),
    ("histk", 0.01, "fused"), ("histk", 0.01, "reference"),
    ("trimmedk", 0.01, "reference"), ("none", 0.01, "auto")])
def test_three_steps_match_composed_reference(compressor, ratio, backend):
    jcfg = JModelConfig(**_CFG).validate()
    tcfg = ModelConfig(**_CFG).validate()
    jparams = j_init(jcfg, jax.random.PRNGKey(0))
    batches = _batches(jcfg.vocab_size)
    jlosses, jfinal = _jax_reference(jcfg, jparams, batches, compressor,
                                     ratio, backend)

    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    comp = CompressionConfig(compressor=compressor, ratio=ratio,
                             backend=backend)
    layout = None if comp.dense else build_layout(params, 1, comp)
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=1, model_size=1,
                             compression=comp, layout=layout)
    step = make_train_step(tcfg, (1, 1), opt, constant(LR),
                           compression=comp, layout=layout)
    tlosses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v).long()
                                for k, v in b.items()})
        tlosses.append(float(m["loss"]))
        if not comp.dense:
            assert m["density"] <= m["density_cap"]
            assert m["collectives_per_step"] == 1.0
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(jfinal), tree.leaves(state["params"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)
    assert state["step"] == STEPS


def test_cli_smoke_on_cpu(capsys):
    argv = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1",
            "--density-policy", "none",
            "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
            "--log-every", "1"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "step     1 loss=" in out and "coll=1" in out
    recs = cli.run(argv)
    assert len(recs) == 2
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert all(r["density"] <= r["density_cap"] for r in recs)


@pytest.mark.parametrize("extra", [
    ["--compressor", "histk"],
    ["--compressor", "histk", "--backend", "reference"],
    ["--compressor", "trimmedk"]])
def test_cli_smoke_slice5_compressors_on_cpu(extra):
    recs = cli.run(["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1",
                    "--density-policy",
                    "none", "--device", "cpu", "--steps", "2", "--batch",
                    "2", "--seq", "16", "--log-every", "1"] + extra)
    assert len(recs) == 2
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert all(0 < r["density"] <= r["density_cap"] for r in recs)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-1.5-large-398b",
                                  "xlstm-125m", "musicgen-medium",
                                  "llava-next-34b"])
def test_cli_trains_each_family_on_cpu(arch):
    """One step of the CLI's default (fused Gaussian-k, bucketed) on the
    smoke variant of each family slice 8 ported (MoE, Mamba hybrid,
    xLSTM, audio and VLM ``embeds`` frontends): its loss is the
    reference's loss of the reference's ``init_params(PRNGKey(0))`` on
    ``batch_for``'s step-0 batch, within rtol 1e-5 (the weights and the
    embeddings agree within ``prng.normal``'s rtol 1e-5)."""
    jcfg = j_get_config(arch).reduced()
    jl, _ = j_loss(j_init(jcfg, jax.random.PRNGKey(0)), jcfg,
                   j_batch_for(jcfg, 0, global_batch=2, seq_len=16),
                   remat=False)
    (rec,) = cli.run(["--arch", arch, "--smoke", "--mesh", "1x1", "--device",
                      "cpu",
                      "--steps", "1", "--batch", "2", "--seq", "16"])
    np.testing.assert_allclose(rec["loss"], float(jl), rtol=1e-5)
    assert 0 < rec["density"] <= rec["density_cap"]
    assert rec["collectives_per_step"] == 1


def test_cli_needs_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.run(["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1",
                 "--density-policy",
                 "none", "--steps", "1"])


@pytest.mark.parametrize("extra,slice_no", [
    (["--pipeline", "perleaf"], "slice 2b"),
    (["--mesh", "2x2", "--host-devices", "4"], "slice 2c"),
    (["--compressor", "randk"], "slice 4"),
    (["--compressor", "dgck"], "slice 4"),
    (["--chunks", "2"], "slice 6"),
    (["--publish-every", "2"], "slice 7"),
    (["--strategy", "auto"], "slice 9"),
    (["--topology", "topo.json"], "slice 9"),
    (["--resync-every", "4"], "slice 7"),
])
def test_cli_names_the_slice_of_what_it_lacks(extra, slice_no, tmp_path,
                                              capsys):
    """Each flag a later slice carries raises naming that slice.  Slices
    4, 2b, 2c, 6, 7 and 9 have landed, so their cases (``--compressor
    randk``/``dgck``, ``--pipeline perleaf``, ``--mesh 2x2
    --host-devices 4``, ``--chunks 2``, ``--publish-every 2``,
    ``--resync-every 4``, ``--strategy auto``, ``--topology``) now train
    a step, with the collectives a step of their dispatch (12 leaves);
    slice 7's one step publishes nothing (``--publish-every 2``
    publishes after the second); slice 2c's buckets are two rows a
    worker.  Slice 9's two cases tune at ``--mesh 4x1 --host-devices 4``
    on a topology JSON the test writes (``--strategy auto`` on the slow
    flat link, ``--topology`` on the asymmetric fabric): the printed
    decision is the reference's ``choose_strategy`` on the reference's
    layout of the same params, and the losses are those of the run that
    names that strategy, bitwise."""
    argv = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1",
            "--density-policy", "none",
            "--device", "cpu", "--steps", "1"] + extra
    if slice_no == "slice 9":
        _tunes_as_the_reference(argv, extra, tmp_path, capsys)
        return
    if slice_no in ("slice 4", "slice 2b", "slice 2c", "slice 6",
                    "slice 7"):
        recs = cli.run(argv + ["--batch", "2", "--seq", "16"])
        assert len(recs) == 1 and np.isfinite(recs[0]["loss"])
        assert 0 < recs[0]["density"] <= recs[0]["density_cap"] * (1 + 1e-6)
        assert "publish_kind" not in recs[0]
        coll = {"slice 4": 1, "slice 2b": 12, "slice 2c": 1, "slice 6": 2,
                "slice 7": 1}[slice_no]
        assert recs[0]["collectives_per_step"] == coll
        return
    with pytest.raises(NotImplementedError, match=slice_no):
        cli.run(argv)


_TOPOLOGIES = {   # the reference tuner test's slow flat and asymmetric
    "--strategy": {"name": "slow-flat", "default_link": {
        "alpha_s": 1e-6, "beta_Bps": 1e8}},
    "--topology": {"name": "asym", "links": {
        "data": {"alpha_s": 1e-6, "beta_Bps": 5e10},
        "pod": {"alpha_s": 1e-3, "beta_Bps": 1e8}},
        "default_link": {"alpha_s": 1e-6, "beta_Bps": 5e10}},
}


def _tunes_as_the_reference(argv, extra, tmp_path, capsys):
    import json

    from repro.dist.tuner import choose_strategy
    from repro.launch.topo import load_topology
    path = str(tmp_path / "topo.json")
    desc = dict(_TOPOLOGIES[extra[0]], hardware={
        "name": "test-hw", "peak_flops": 197e12, "hbm_bw": 819e9})
    with open(path, "w") as f:
        json.dump(desc, f)
    base = [a for a in argv if a not in extra] + [
        "--mesh", "4x1", "--host-devices", "4", "--batch", "4", "--seq",
        "16"]
    recs = cli.run(base + ["--strategy", "auto", "--topology", path])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("tuner: "))
    chosen = line.split("-> strategy=")[1].split()[0]
    cfg = j_get_config("llama3.2-1b").reduced()
    shapes = jax.eval_shape(lambda k: j_init(cfg, k), jax.random.PRNGKey(0))
    want = choose_strategy(jl.build_layout(shapes, 1, 0.001,
                                           j_get("gaussiank")),
                           [("data", 4)], load_topology(path))
    assert chosen == want.strategy, (line, want.to_dict())
    assert f"strategy={chosen}(auto)" in out
    assert f" tuner={chosen} " in out
    explicit = cli.run(base + ["--strategy", chosen])
    assert [r["loss"] for r in recs] == [r["loss"] for r in explicit]
    assert [r["collectives_per_step"] for r in recs] == [
        r["collectives_per_step"] for r in explicit]


@pytest.mark.parametrize("extra", [
    ["--density-policy", "variance"],
    ["--density-policy", "variance", "--density-floor", "0.5"],
    ["--density-policy", "absmax", "--global-k-policy", "normdecay",
     "--global-k-floor", "0.5"],
    ["--global-k-policy", "normdecay", "--density-policy", "none"],
])
def test_cli_runs_the_density_flags(extra):
    """Slice 3's flags, which slice 1 refused naming slice 3: an adaptive
    policy, its floor and the global-k controller's floor train; the
    global-k controller without an adaptive policy exits, as the
    reference's CLI does."""
    argv = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1", "--device",
            "cpu",
            "--steps", "1", "--batch", "2", "--seq", "16"] + extra
    if "none" in extra:
        with pytest.raises(SystemExit, match="needs an adaptive"):
            cli.run(argv)
        return
    (rec,) = cli.run(argv)
    assert np.isfinite(rec["loss"]) and rec["k_total"] > 0


_SMOKE = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1",
          "--density-policy", "none",
          "--device", "cpu", "--steps", "2", "--batch", "4", "--seq", "16",
          "--log-every", "1"]


@pytest.mark.parametrize("extra,workers,coll", [
    (["--strategy", "gtopk", "--mesh", "2x1", "--host-devices", "2"], 2, 1),
    (["--mesh", "2x1", "--host-devices", "2"], 2, 1),
    (["--host-devices", "8"], 1, 1),
    (["--host-devices", "4", "--mesh", "4x1", "--strategy", "allgather"],
     4, 1),
    (["--host-devices", "4", "--mesh", "4x1", "--strategy", "gtopk"], 4, 2),
    (["--host-devices", "4", "--mesh", "2x2x1", "--strategy",
      "hierarchical"], 4, 2),
    (["--host-devices", "4", "--mesh", "2x2x1", "--strategy",
      "hier_gtopk"], 4, 2),
    (["--host-devices", "4", "--mesh", "2x2x1", "--hierarchical"], 4, 2),
])
def test_cli_runs_the_wire_strategies_on_cpu(capsys, extra, workers, coll):
    """Several workers in this process (``--host-devices``, the JAX
    flag's counterpart: N device slots, the mesh uses W of them).  The
    two-level strategies send a second pair a step, so their density
    (both levels' slots, as the reference counts it) may reach twice
    the one-level cap."""
    recs = cli.run(_SMOKE + extra)
    out = capsys.readouterr().out
    assert f"workers={workers} wire=local dist_backend=none" in out
    levels = 2 if "2x2x1" in extra else 1
    assert len(recs) == 2
    for r in recs:
        assert np.isfinite(r["loss"])
        assert 0 < r["density"] <= levels * r["density_cap"]
        assert r["collectives_per_step"] == coll


@pytest.mark.parametrize("extra", [["--mesh", "4x1"],
                                   ["--mesh", "2x2x1", "--host-devices", "2"]])
def test_cli_mesh_needs_its_workers(extra):
    """A mesh of W > 1 workers runs W workers or none: it names both ways
    to get them."""
    with pytest.raises(SystemExit, match="--host-devices 4.*torchrun "
                                         "--nproc-per-node 4"):
        cli.run(_SMOKE + extra)


def test_cli_checkpoint_and_resume(tmp_path):
    """2 steps, saved, resumed for 1 step: the same as 3 steps straight,
    bitwise (4 workers, gtopk)."""
    base = [a for a in _SMOKE if a not in ("--steps", "2")] + [
        "--host-devices", "4", "--mesh", "4x1", "--strategy", "gtopk"]
    a, b, c = (str(tmp_path / n) for n in ("a.npz", "b.npz", "c.npz"))
    cli.run(base + ["--steps", "2", "--checkpoint", a])
    recs = cli.run(base + ["--steps", "1", "--resume", a, "--checkpoint",
                           b])
    assert [r["step"] for r in recs] == [2]
    cli.run(base + ["--steps", "3", "--checkpoint", c])
    with np.load(b) as x, np.load(c) as y:
        assert sorted(x.files) == sorted(y.files)
        assert int(x["step"]) == 3 and x["resid"].shape[0] == 4
        for k in x.files:
            assert x[k].tobytes() == y[k].tobytes(), k


def test_llama_default_density_policy_is_rejected(capsys):
    """(Named for slice 1, which refused it.)  llama3.2-1b defaults to
    adaptive density: with no ``--density-policy`` the trainer runs
    ``variance`` and reports ``k_total``; ``--density-policy none`` is
    fixed-k."""
    argv = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1", "--device",
            "cpu",
            "--steps", "1", "--batch", "2", "--seq", "16"]
    (rec,) = cli.run(argv)
    assert "density_policy=variance" in capsys.readouterr().out
    assert rec["k_total"] > 0
    (rec,) = cli.run(argv + ["--density-policy", "none"])
    assert "density_policy=none" in capsys.readouterr().out
    assert "k_total" not in rec


def test_cli_auto_needs_a_sparse_compressor():
    """``--strategy auto`` tunes the sparse wire: with ``--compressor
    none`` it exits with the reference's message."""
    with pytest.raises(SystemExit, match="meaningless with --compressor "
                                         "none"):
        cli.run(_SMOKE + ["--strategy", "auto", "--compressor", "none"])
