"""Rematerialised training in the port (``models.loss_fn(remat=True)``,
``make_train_step(remat=True)``, the trainer's ``remat=not --smoke``) on
the CPU.

* On and off give the same loss, MoE aux loss and gradients, bit for
  bit, on the smoke variant of every assigned architecture: attention,
  sliding-window attention, the parallel block, MoE, Mamba, mLSTM,
  sLSTM and the ``embeds`` frontend; with remat each period's layers run
  twice (the forward and the backward's recompute), the tail once.
* The same through ``make_train_step``: bucketed, ``--chunks 2`` (the
  hooks still release each chunk group during the backward) and the
  per-leaf loop, 2 steps each, losses, params, momentum and residuals
  bitwise; and in 2 gloo processes under tensor parallelism
  (``tests/_torch_tp_pg.py``): the loss and gradients on the shards of
  every arch, and the trainer at ``1x2`` bucketed, chunked and per leaf.
* The port with remat against the reference with remat, within the
  tolerances its other tests use (``tests/test_torch_archs.py``,
  ``tests/test_torch_train.py``): the loss within rtol 1e-5 and the
  gradients within rtol 1e-4, atol 1e-6 of ``loss_fn(remat=True)``;
  3 steps of the reference's ``make_train_step(remat=True)`` on a
  (1, 1) mesh (the ``reference`` compression backend): losses within
  rtol 1e-4, params within rtol 1e-4, atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_prng_flag import threefry_partitionable  # noqa: F401
from _torch_tp_pg import launch
from repro.configs import get_config as j_get_config
from repro.core.compression import CompressionConfig as JCompression
from repro.dist import layout as jl
from repro.launch.mesh import make_mesh as j_mesh
from repro.models import init_params as j_init
from repro.models import loss_fn as j_loss
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import constant as j_constant
from repro.optim import sgd_momentum as j_sgd
from repro.train import init_train_state as j_state
from repro.train import make_train_step as j_step
from repro_torch import tree
from repro_torch.configs import get_config, list_archs
from repro_torch.core.compression import CompressionConfig
from repro_torch.data import batch_for
from repro_torch.dist.layout import build_layout
from repro_torch.models import ModelConfig, from_jax_params, init_params
from repro_torch.models import loss_fn
from repro_torch.models import model as mdl
from repro_torch.optim import constant, sgd_momentum
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(2)

ALL = list_archs()
# one smoke variant a block kind: attention, sliding-window attention,
# MoE, Mamba (with attention and MoE), mLSTM and sLSTM, embeds
KINDS = ["llama3.2-1b", "gemma3-4b", "deepseek-moe-16b",
         "jamba-1.5-large-398b", "xlstm-125m", "musicgen-medium"]
_CFG = dict(name="sys", arch_type="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)


def _grads(params, cfg, batch, remat):
    leaves, td = tree.flatten(params)
    ps = [p.detach().clone().requires_grad_(True) for p in leaves]
    loss, m = loss_fn(tree.unflatten(td, ps), cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), m["aux"].detach(), [
        torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]


@pytest.mark.parametrize("arch", ALL)
def test_remat_is_bitwise_and_recomputes_each_period(arch, monkeypatch):
    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0, "cpu")
    batch = batch_for(cfg, 0, global_batch=2, seq_len=16, device="cpu")
    blocks = []
    apply_block = mdl._apply_block

    def counted(p, h, cfg, kind, *a, **k):
        blocks.append(kind)
        return apply_block(p, h, cfg, kind, *a, **k)

    monkeypatch.setattr(mdl, "_apply_block", counted)
    off = _grads(params, cfg, batch, False)
    n_off = len(blocks)
    on = _grads(params, cfg, batch, True)
    stacked = (cfg.num_layers // cfg.pattern_period) * cfg.pattern_period
    assert stacked > 0 and n_off == cfg.num_layers
    assert len(blocks) - n_off == cfg.num_layers + stacked
    for what, a, b in (("loss", off[0], on[0]), ("aux", off[1], on[1])):
        assert torch.equal(a, b), what
    names = [tree.path_name(p) for p, _ in tree.flatten_with_path(params)[0]]
    for name, a, b in zip(names, off[2], on[2]):
        assert torch.equal(a, b), name
    assert (float(on[1]) > 0) == ("moe" in cfg.ffn_pattern)


def _state_digest(state):
    out = {"params": tree.leaves(state["params"]),
           "opt": tree.leaves(state["opt"])}
    for key in ("resid", "resid2"):
        if key in state:
            out[key] = tree.leaves(state[key])
    return out


def _train(cfg, comp, remat, perleaf=False, steps=2):
    params = init_params(cfg, 0, "cpu")
    layout = None if perleaf else build_layout(params, 1, comp)
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=1, model_size=1,
                             compression=comp, layout=layout)
    events = []

    def probe(rank, backward=None, release=None, **_):
        if backward is not None or release is not None:
            events.append(release if release is not None else
                          "start" if backward else "end")

    step = make_train_step(cfg, (1, 1), opt, constant(0.1),
                           compression=comp, layout=layout, probe=probe,
                           remat=remat)
    losses = []
    for i in range(steps):
        state, m = step(state, batch_for(cfg, i, global_batch=2, seq_len=16,
                                         device="cpu"))
        losses.append(m["loss"])
    return losses, _state_digest(state), events


@pytest.mark.parametrize("mode", ["bucketed", "chunks2", "perleaf"])
def test_train_step_remat_is_bitwise(mode):
    """jamba-1.5-large's smoke variant (Mamba, attention, MLP and MoE
    layers): 2 steps with and without remat, bitwise; the chunked
    schedule releases its 2 chunk groups inside the backward either
    way, in the same order."""
    cfg = get_config("jamba-1.5-large-398b").reduced()
    comp = CompressionConfig(compressor="gaussiank", ratio=0.01,
                             chunks=2 if mode == "chunks2" else 1)
    off = _train(cfg, comp, False, mode == "perleaf")
    on = _train(cfg, comp, True, mode == "perleaf")
    for a, b in zip(off[0], on[0]):
        assert torch.equal(a, b), "loss"
    for key in off[1]:
        for a, b in zip(off[1][key], on[1][key]):
            assert torch.equal(a, b), key
    assert off[2] == on[2]
    if mode == "chunks2":
        for s in range(2):
            ev = on[2][4 * s:4 * s + 4]
            assert ev[0] == "start" and ev[-1] == "end", on[2]
            assert sorted(ev[1:3]) == [0, 1], on[2]


def test_tensor_parallel_remat_is_bitwise(tmp_path):
    """2 gloo processes at ``1x2``: on the shards of every arch's smoke
    variant, loss and gradients with remat bitwise without; the trainer
    (remat on, and off by ``--smoke``) on jamba bucketed, deepseek at
    ``--chunks 2`` and xlstm per leaf: the losses and the gathered
    checkpoints bitwise."""
    common = ["--compressor", "gaussiank", "--ratio", "0.02",
              "--density-policy", "none", "--steps", "2", "--batch", "4",
              "--seq", "16", "--log-every", "1", "--mesh", "1x2"]
    runs = {"jamba": ("jamba-1.5-large-398b", []),
            "deepseek": ("deepseek-moe-16b", ["--chunks", "2"]),
            "xlstm": ("xlstm-125m", ["--pipeline", "perleaf"])}
    cases = [{"name": "remat", "argv": ["1x2", ALL]}]
    for name, (arch, extra) in runs.items():
        for tag, flag in (("on", []), ("off", ["--smoke"])):
            cases.append({"name": f"{name}-{tag}", "reduced": arch,
                          "argv": ["--arch", arch] + common + extra + flag})
    launch(tmp_path, 2, cases, timeout=600)
    import json
    for name in runs:
        recs = [json.loads((tmp_path / f"{name}-{t}.json").read_text())
                for t in ("on", "off")]
        assert [r["loss"] for r in recs[0]] == [r["loss"] for r in recs[1]]
        on, off = (np.load(tmp_path / f"{name}-{t}.npz") for t in ("on",
                                                                   "off"))
        assert sorted(on.files) == sorted(off.files)
        for key in on.files:
            np.testing.assert_array_equal(on[key], off[key], err_msg=key)


@pytest.mark.parametrize("arch", KINDS)
def test_remat_loss_and_grads_match_reference_remat(arch):
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp = j_init(jcfg, jax.random.PRNGKey(1))
    rng = np.random.default_rng(2)
    labs = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    if jcfg.frontend == "embeds":
        x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
        jb = {"embeds": jnp.asarray(x)}
        tb = {"embeds": torch.from_numpy(x)}
    else:
        x = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
        jb = {"tokens": jnp.asarray(x)}
        tb = {"tokens": torch.from_numpy(x).long()}
    jb["labels"] = jnp.asarray(labs)
    tb["labels"] = torch.from_numpy(labs).long()
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss(p, jcfg, jb, remat=True), has_aux=True))(jp)
    tloss, taux, grads = _grads(
        from_jax_params(jax.tree.map(np.asarray, jp), "cpu"), tcfg, tb, True)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(taux), float(jm["aux"]), rtol=1e-5,
                               atol=1e-7)
    names = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for name, a, g in zip(names, jax.tree.leaves(jg), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_remat_steps_match_reference_step():
    """3 steps of Gaussian-k at 0.01 on the dense 2-layer config: the
    port's ``make_train_step`` (remat by default) against the
    reference's ``make_train_step(remat=True)`` on a (1, 1) mesh, both
    on the ``reference`` compression backend (the reference's Pallas
    kernels do not lower inside its ``shard_map`` on this jax, as in
    ``tests/test_torch_keyed.py``)."""
    jcfg = JModelConfig(**_CFG).validate()
    tcfg = ModelConfig(**_CFG).validate()
    jparams = j_init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        toks = rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
        batches.append({"tokens": toks, "labels": np.roll(toks, -1, axis=1)})
    jcomp = JCompression(compressor="gaussiank", ratio=0.01,
                         backend="reference")
    jlayout = jl.build_layout(jparams, 1, jcomp)
    jopt = j_sgd(0.9)
    jstate = j_state(jparams, jopt, workers=1, model_size=1,
                     compression=jcomp, layout=jlayout)
    jstep = j_step(jcfg, j_mesh((1, 1), ("data", "model")), jopt,
                   j_constant(0.1), compression=jcomp, remat=True,
                   layout=jlayout)
    jlosses = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jlosses.append(float(m["loss"]))

    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    comp = CompressionConfig(compressor="gaussiank", ratio=0.01,
                             backend="reference")
    layout = build_layout(params, 1, comp)
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=1, model_size=1,
                             compression=comp, layout=layout)
    step = make_train_step(tcfg, (1, 1), opt, constant(0.1),
                           compression=comp, layout=layout)
    tlosses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v).long()
                                for k, v in b.items()})
        tlosses.append(float(m["loss"]))
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(jstate["params"]),
                    tree.leaves(state["params"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)


def test_step_cost_counts_the_recompute():
    """``step_cost.count_flops(remat=True)`` counts the step as trained:
    the recompute adds one forward of every rematerialised period but
    its last projection (the recompute stops at the last tensor the
    backward keeps, the input of the period's ``w_down``).  On the dense
    2-layer config (two periods of one layer): the extra FLOPs are the
    forward of the layers (the model's forward less the head's) less
    ``2·B·S·d_ff·d_model`` a period.  A recurrent arch's piecewise count
    equals its whole count with remat, as without."""
    from repro_torch.launch import step_cost
    cfg = ModelConfig(**_CFG).validate()
    B, S = 4, 16
    off = step_cost.count_flops(cfg, B, S)["flops"]
    on = step_cost.count_flops(cfg, B, S, remat=True)["flops"]
    fwd = step_cost.count_flops(cfg, B, S, kind="prefill")["flops"]
    head = 2 * B * S * cfg.d_model * cfg.vocab_size
    last = 2 * B * S * cfg.d_ff * cfg.d_model
    assert on - off == (fwd - head) - cfg.num_layers * last
    x = get_config("xlstm-125m").reduced()
    params = init_params(x, 0, "meta")
    for leaf in tree.leaves(params):
        leaf.requires_grad_(True)
    meta = torch.device("meta")
    whole = step_cost._whole(x, params, 1, 64, "train", meta, set(), True)
    piece = step_cost._piecewise(x, params, 1, 64, True, meta, set(), True)
    plain = step_cost._whole(x, params, 1, 64, "train", meta, set())
    assert piece == whole > plain
    for leaf in tree.leaves(params):
        leaf.requires_grad_(False)


@pytest.mark.parametrize("arch,layers", [("xlstm-125m", 4),
                                         ("jamba-1.5-large-398b", 16)])
def test_step_cost_piecewise_recompute_at_every_rep(arch, layers):
    """With two periods or more (``reps >= 2``) the piecewise count with
    remat still equals the whole count: each period's last piece is
    counted under its own checkpoint in every one of its ``reps``
    repetitions, not only in the last."""
    from repro_torch.launch import step_cost
    x = dataclasses.replace(get_config(arch).reduced(),
                            num_layers=layers).validate()
    assert x.num_layers // x.pattern_period >= 2
    params = init_params(x, 0, "meta")
    for leaf in tree.leaves(params):
        leaf.requires_grad_(True)
    meta = torch.device("meta")
    whole = step_cost._whole(x, params, 1, 64, "train", meta, set(), True)
    piece = step_cost._piecewise(x, params, 1, 64, True, meta, set(), True)
    plain = step_cost._whole(x, params, 1, 64, "train", meta, set())
    assert piece == whole > plain
