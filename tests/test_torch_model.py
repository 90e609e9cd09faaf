"""The port's dense model against ``repro.models``: loss and gradients
from the same params (carried across by ``from_jax_params``) on the same
numpy batch.

Tolerances: loss within rtol 1e-5; gradients within rtol 1e-4, atol
1e-6 — f32 matmuls and reductions sum in another order in XLA and torch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_prng_flag import threefry_partitionable  # noqa: F401
from repro.configs import get_config as j_get_config
from repro.data.synthetic import batch_for as j_batch_for
from repro.models import init_params as j_init
from repro.models import loss_fn as j_loss
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core.compressors import get_compressor
from repro_torch.data import batch_for, embeds_batch, lm_batch
from repro_torch.dist.layout import build_layout, init_flat_residual
from repro_torch.models import (ModelConfig, from_jax_params, init_cache,
                                init_params, loss_fn, to_numpy_tree)

torch.set_num_threads(2)

_SMALL = dict(name="sys", arch_type="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
_SWA = dict(_SMALL, name="swa", num_layers=3, block_pattern=("swa", "attn"),
            sliding_window=5)                 # reps 1 + a tail layer
_PAR = dict(_SMALL, name="par", parallel_block=True, use_bias=True,
            rope_theta=500_000.0)


def _configs(name):
    if name == "llama3.2-1b-smoke":
        return (j_get_config("llama3.2-1b").reduced(),
                get_config("llama3.2-1b").reduced())
    kw = {"sys": _SMALL, "swa": _SWA, "par": _PAR}[name]
    return JModelConfig(**kw).validate(), ModelConfig(**kw).validate()


@pytest.mark.parametrize("name", ["sys", "swa", "par", "llama3.2-1b-smoke"])
def test_loss_and_grads_match_reference(name):
    jcfg, tcfg = _configs(name)
    jparams = j_init(jcfg, jax.random.PRNGKey(1))
    np_params = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    labs = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss(p, jcfg, jbatch, remat=False), has_aux=True))(
            jparams)

    tparams = from_jax_params(np_params, "cpu")
    leaves, td = tree.flatten(tparams)
    ps = [p.requires_grad_(True) for p in leaves]
    tbatch = {"tokens": torch.from_numpy(toks).long(),
              "labels": torch.from_numpy(labs).long()}
    tl, metrics = loss_fn(tree.unflatten(td, ps), tcfg, tbatch)
    grads = [torch.zeros_like(p) if g is None else g for p, g in
             zip(ps, torch.autograd.grad(tl, ps, allow_unused=True))]
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(metrics["ce"].detach()) == float(tl.detach())
    for a, b in zip(jax.tree.leaves(jg), grads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "stablelm-1.6b",
                                  "gemma3-4b", "command-r-35b"])
def test_init_matches_reference_tree(arch):
    """Same leaves, shapes and dtypes as the JAX init (reduced configs)."""
    jshapes = jax.eval_shape(lambda: j_init(j_get_config(arch).reduced(),
                                            jax.random.PRNGKey(0)))
    tparams = init_params(get_config(arch).reduced(), 0, "cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    tleaves = tree.flatten_with_path(tparams)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] == \
        ["".join(f"[{k!r}]" for k in p) for p, _ in tleaves]
    for (_, a), (_, b) in zip(jleaves, tleaves):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")


def test_converter_roundtrip():
    jparams = j_init(JModelConfig(**_SMALL).validate(), jax.random.PRNGKey(3))
    np_params = jax.tree.map(np.asarray, jparams)
    back = to_numpy_tree(from_jax_params(np_params, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(np_params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["xlstm-125m", "deepseek-moe-16b",
                                  "musicgen-medium", "jamba-1.5-large-398b"])
def test_non_dense_archs_name_their_slice(arch):
    """(Named for the slice that ported them, slice 8, which these
    architectures raised for before.)  The port builds them: from
    ``--seed`` alone the reference's tree within rtol 1e-5, and the loss
    of ``batch_for``'s step-0 batch (tokens, or embeddings for
    musicgen) the reference's within rtol 1e-5."""
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = j_init(jcfg, jax.random.PRNGKey(0))
    tparams = init_params(tcfg, 0, "cpu")
    for a, b in zip(jax.tree.leaves(jparams), tree.leaves(tparams)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5)
    jb = j_batch_for(jcfg, 0, global_batch=2, seq_len=16)
    tb = batch_for(tcfg, 0, global_batch=2, seq_len=16, device="cpu")
    assert sorted(jb) == sorted(tb)
    jl, _ = j_loss(jparams, jcfg, jb, remat=False)
    with torch.no_grad():
        tl, _ = loss_fn(tparams, tcfg, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def _default_device_calls():
    cfg = ModelConfig(**_SMALL).validate()
    np_params = to_numpy_tree(init_params(cfg, 0, "cpu"))
    layout = build_layout(from_jax_params(np_params, "cpu"), 1, 0.01,
                          get_compressor("gaussiank"))
    return {
        "init_params": lambda: init_params(cfg, 0),
        "from_jax_params": lambda: from_jax_params(np_params),
        "lm_batch": lambda: lm_batch(0, global_batch=2, seq_len=4, vocab=64),
        "batch_for": lambda: batch_for(cfg, 0, global_batch=2, seq_len=4),
        "init_flat_residual": lambda: init_flat_residual(layout),
        "embeds_batch": lambda: embeds_batch(0, global_batch=2, seq_len=4,
                                             d_model=8, vocab=64),
        "init_cache": lambda: init_cache(cfg, 2, 8),
    }


@pytest.mark.parametrize("entry", ["init_params", "from_jax_params",
                                   "lm_batch", "batch_for",
                                   "init_flat_residual", "embeds_batch",
                                   "init_cache"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without a ``device`` the entry points put their tensors on the
    card, and raise when there is none instead of using the CPU."""
    call = _default_device_calls()[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
