"""The port's partition specs (``repro_torch/dist/sharding.py``,
``repro_torch/serve/steps.py``) against the JAX package's
``PartitionSpec``s, leaf for leaf, for the ten assigned architectures at
their published widths and model axes of 1, 2, 4, 8 and 16.  Shapes
only: ``jax.eval_shape`` on the reference's side, meta tensors on the
port's.  Also the split check of the tensor-parallel step
(``dist/tensor_parallel.check_split``): llama3.2-1b's placement splits
each leaf on the dim its spec shards at 2, 4 and 8 (on head
boundaries), and at 16 its KV projections would split inside a head,
which it refuses naming the leaf; and at M = 2 and 4 every arch's
placement agrees with its specs but on the leaves the port places
itself (``OWN_PLACEMENT``: Mamba's, sLSTM's and the router).
"""
import functools
import types

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as j_get_config
from repro.dist import sharding as jshd
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init
from repro.serve.steps import serve_param_specs as j_serve_param_specs
from repro_torch.configs import get_config, list_archs
from repro_torch.dist import sharding as tshd
from repro_torch.dist.tensor_parallel import check_split
from repro_torch.models import init_params
from repro_torch.serve import decode_specs, serve_param_specs

MODEL_SIZES = (1, 2, 4, 8, 16)
BATCH, S_MAX, DATA = 8, 64, 4


def _name(path) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                    for e in path)


def _named(specs) -> dict:
    """A tree of ``PartitionSpec``s as ``{path name: tuple}``."""
    pairs = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {_name(p): tuple(s) for p, s in pairs}


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    cfg = j_get_config(arch)
    return (jax.eval_shape(functools.partial(j_init, cfg),
                           jax.random.PRNGKey(0)),
            jax.eval_shape(functools.partial(j_init_cache, cfg, BATCH,
                                             S_MAX)))


def _mesh(model_size):
    """What the reference's spec functions read of a ``(4, M)`` mesh."""
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((DATA, model_size)))


@pytest.mark.parametrize("model_size", MODEL_SIZES)
@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_specs_match_reference(arch, model_size):
    """``param_specs``, ``serve_param_specs`` (``2d``, on a ``(4, M)``
    mesh) and the decode caches' ``cache_specs`` equal the reference's,
    leaf for leaf and in flatten order; the stacked dim is never
    sharded."""
    jparams, jcache = _jax_shapes(arch)
    cfg = get_config(arch)
    meta = init_params(cfg, 0, "meta")
    got = tshd.param_specs(meta, "model", model_size)
    want = _named(jshd.param_specs(jparams, "model", model_size))
    assert list(got.items()) == list(want.items())
    for name, spec in got.items():
        if name.startswith("stack/") and spec:
            assert spec[0] is None, name
    got = serve_param_specs(meta, f"{DATA}x{model_size}")
    want = _named(j_serve_param_specs(jparams, _mesh(model_size)))
    assert list(got.items()) == list(want.items())
    pspecs, cspecs, tok = decode_specs(cfg, f"{DATA}x{model_size}", BATCH,
                                       S_MAX)
    assert pspecs == got
    want = _named(jshd.cache_specs(jcache, ("data",), DATA, "model",
                                   model_size))
    assert list(cspecs.items()) == list(want.items())
    assert tok == ("data",)


def test_state_and_batch_specs_match_reference():
    """``train_state_specs`` (the residuals over the joint data axes,
    everything else replicated) and ``batch_specs`` on a two-axis data
    mesh equal the reference's."""
    state = {"params": {"w": np.zeros((4, 2))}, "opt": {"m": {"w": 0}},
             "step": 0, "resid": np.zeros((2, 8)),
             "resid2": np.zeros((2, 8)),
             "adaptk": {"signal": np.zeros(3), "count": 0}}
    joint = ("pod", "data")
    assert tshd.train_state_specs(state, joint) == _named(
        jshd.train_state_specs(state, joint))
    batch = {"tokens": np.zeros((8, 4)), "labels": np.zeros((8, 4))}
    assert tshd.batch_specs(batch, joint) == _named(
        jshd.batch_specs(batch, joint))
    assert tshd.param_spec(("embed",), (7, 5), "model", 2) == ()


@pytest.mark.parametrize("model_size", [2, 4, 8, 16])
def test_tensor_parallel_split_is_refused_inside_a_head(model_size):
    """llama3.2-1b's Megatron split falls on head boundaries at M = 2,
    4 and 8 (32 query heads, 8 KV heads of 64, ffn 8192, vocab 128256);
    at M = 16 ``wk``'s 512 columns split into 32, inside a head of 64,
    and the check refuses, naming the leaf."""
    cfg = get_config("llama3.2-1b")
    meta = init_params(cfg, 0, "meta")
    if model_size < 16:
        placements = check_split(cfg, meta, model_size)
        assert [pl.dim for pl in placements] == [
            tshd.sharded_dim(s) for s in tshd.param_specs(
                meta, "model", model_size).values()]
        return
    with pytest.raises(ValueError, match="stack/0/core/wk.*inside an "
                                         "attention head of 64"):
        check_split(cfg, meta, model_size)


# the leaves whose placement is not their spec's split (block kind, leaf
# name): the reference's specs give them no local computation (Mamba's
# in_proj would put all of x on one rank and all of z on the other;
# x_proj's output, dt_proj's dt_rank and A_log's state dim are not
# channels; sLSTM's output-gate projection wo takes the attention wo's
# input split, its recurrent matrices split inside a head), and the
# router stays whole so that every rank routes alike
OWN_PLACEMENT = {("mamba", "in_proj"), ("mamba", "x_proj"),
                 ("mamba", "dt_proj"), ("mamba", "A_log"),
                 ("slstm", "wo"), ("slstm", "ri"), ("slstm", "rf"),
                 ("slstm", "rz"), ("slstm", "ro"), ("moe", "router")}


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("arch", list_archs())
def test_placement_agrees_with_specs_but_where_named(arch, model_size):
    """At the published widths the placement splits every leaf on the
    dim its spec shards (the same view) except the leaves of
    ``OWN_PLACEMENT``, and each of those differs from its spec."""
    from repro_torch import tree
    from repro_torch.dist.tensor_parallel import leaf_kind
    cfg = get_config(arch)
    meta = init_params(cfg, 0, "meta")
    placements = check_split(cfg, meta, model_size)
    specs = tshd.param_specs(meta, "model", model_size)
    for (path, _), pl, spec in zip(tree.flatten_with_path(meta)[0],
                                   placements, specs.values()):
        own = (leaf_kind(cfg, path), path[-1]) in OWN_PLACEMENT
        same = pl.view == pl.shape and pl.dim == tshd.sharded_dim(spec)
        assert same != own, (tree.path_name(path), pl, spec)
