"""The port's bucket layout against ``repro.dist.layout``: field for
field on llama3.2-1b ``reduced()``, fixed-k and adaptive, the wire
accounting of every
strategy, pack/unpack of grads and of residual arrays bitwise, unpack as
views, and the full llama3.2-1b bucket inside the int32 index range."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import adaptk as ja
from repro.core.compressors import get_compressor as j_get
from repro.dist import layout as jl
from repro.models import init_params as j_init
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core.adaptk import make_policy
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.compressors import get_compressor
from repro_torch.dist import layout as tl
from repro_torch.models import from_jax_params, init_params

torch.set_num_threads(2)

REDUCED_ORDER = [
    "embed", "final_norm/scale", "lm_head",
    "stack/0/core/wk", "stack/0/core/wo", "stack/0/core/wq",
    "stack/0/core/wv", "stack/0/ffn/w_down", "stack/0/ffn/w_gate",
    "stack/0/ffn/w_up", "stack/0/norm1/scale", "stack/0/norm2/scale"]


@pytest.fixture(scope="module")
def reduced():
    cfg = j_get_config("llama3.2-1b").reduced()
    jparams = j_init(cfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return jparams, from_jax_params(np_params, "cpu")


@pytest.mark.parametrize("compressor,ratio,model_size", [
    ("gaussiank", 0.001, 1), ("gaussiank", 0.01, 1), ("topk", 0.05, 1),
    ("gaussiank2", 0.001, 4)])
def test_build_layout_field_for_field(reduced, compressor, ratio,
                                      model_size):
    jparams, tparams = reduced
    jlay = jl.build_layout(jparams, model_size, ratio, j_get(compressor))
    tlay = tl.build_layout(tparams, model_size, ratio,
                           get_compressor(compressor))
    assert [s.name for s in tlay.segments] == REDUCED_ORDER
    assert len(jlay.segments) == len(tlay.segments)
    for js, ts in zip(jlay.segments, tlay.segments):
        assert js._asdict() == ts._asdict()
    for f in ("model_size", "ratio", "spec_name", "adaptive", "d_row_total",
              "k_cap_total"):
        assert getattr(jlay, f) == getattr(tlay, f), f
    assert jlay.d_total == tlay.d_total
    assert jlay.pair_bits() == tlay.pair_bits()
    assert jlay.comm_bits_sparse("allgather", 1) == \
        tlay.comm_bits_sparse("allgather", 1)
    assert jlay.comm_bits_dense() == tlay.comm_bits_dense()
    assert jlay.collectives("allgather", 1) == tlay.collectives("allgather",
                                                                1)


def test_build_layout_config_spelling(reduced):
    _, tparams = reduced
    a = tl.build_layout(tparams, 1, CompressionConfig(ratio=0.01))
    b = tl.build_layout(tparams, 1, 0.01, get_compressor("gaussiank"))
    assert a == b
    # an adaptive-density layout (slice 3), both spellings alike
    pol = make_policy("variance")
    a = tl.build_layout(tparams, 1, CompressionConfig(ratio=0.01,
                                                      density_policy=pol))
    b = tl.build_layout(tparams, 1, 0.01, get_compressor("gaussiank"),
                        density_policy=pol)
    assert a == b and a.adaptive and a.k_cap_total > b.k_cap_total / 2
    with pytest.raises(TypeError, match="not both"):
        tl.build_layout(tparams, 1, CompressionConfig(ratio=0.01),
                        density_policy=pol)


@pytest.mark.parametrize("compressor,ratio,model_size,policy", [
    ("gaussiank", 0.001, 1, dict()),
    ("gaussiank", 0.01, 1, dict(floor_mult=0.5, ceil_mult=2.0)),
    ("topk", 0.05, 1, dict(warmup_steps=5, warmup_mult=16.0)),
    ("histk", 0.001, 4, dict(policy="absmax")),
    ("gaussiank2", 0.3, 2, dict(floor_mult=1.0, ceil_mult=1.0))])
def test_adaptive_layout_matches_reference(reduced, compressor, ratio,
                                           model_size, policy):
    """``build_layout(..., density_policy=)`` field for field the
    reference's: every segment's ``k_lo``, ``k_hi`` and the
    ceiling-sized ``k_row``/``k_cap``, and ``leaf_plan_adaptive``."""
    jparams, tparams = reduced
    jpol = ja.make_policy(**policy)
    jlay = jl.build_layout(jparams, model_size, ratio, j_get(compressor),
                           density_policy=jpol)
    tlay = tl.build_layout(tparams, model_size, ratio,
                           get_compressor(compressor),
                           density_policy=make_policy(**policy))
    for js, ts in zip(jlay.segments, tlay.segments):
        assert js._asdict() == ts._asdict()
        assert tl.leaf_plan_adaptive(ts.size, model_size, ratio,
                                     get_compressor(compressor),
                                     make_policy(**policy)) == \
            jl.leaf_plan_adaptive(js.size, model_size, ratio,
                                  j_get(compressor), jpol)
    for f in ("model_size", "ratio", "spec_name", "adaptive", "d_row_total",
              "k_cap_total"):
        assert getattr(jlay, f) == getattr(tlay, f), f
    assert tlay.adaptive
    assert tlay.pair_bits() == jlay.pair_bits()


@pytest.mark.parametrize("strategy", ["gtopk", "hierarchical",
                                      "hier_gtopk"])
def test_wire_accounting_matches_reference(reduced, strategy):
    """Wire pairs, bits (f32, bf16 and fp16 values) and collectives of
    each strategy equal ``repro.dist.layout``'s, over worlds and pod
    counts; non-powers of two raise alike for the gTop-k strategies."""
    jparams, tparams = reduced
    jlay = jl.build_layout(jparams, 1, 0.01, j_get("gaussiank"))
    lay = tl.build_layout(tparams, 1, 0.01, get_compressor("gaussiank"))
    for world, n_pods in [(1, 1), (2, 1), (4, 1), (4, 2), (8, 2), (8, 4),
                          (16, 4)]:
        assert tl.strategy_wire_pairs(strategy, world, n_pods) == \
            jl.strategy_wire_pairs(strategy, world, n_pods)
        assert lay.collectives(strategy, world, n_pods) == \
            jlay.collectives(strategy, world, n_pods)
        for t, j in [(None, None), (torch.bfloat16, jnp.bfloat16),
                     (torch.float16, jnp.float16)]:
            assert lay.comm_bits_sparse(strategy, world, n_pods, t) == \
                jlay.comm_bits_sparse(strategy, world, n_pods, j)
    bad = (3, 1) if strategy == "gtopk" else (6, 3)
    if strategy != "hierarchical":
        with pytest.raises(ValueError, match="power-of-two"):
            lay.comm_bits_sparse(strategy, *bad)
        with pytest.raises(ValueError, match="power-of-two"):
            jlay.comm_bits_sparse(strategy, *bad)
    with pytest.raises(ValueError, match="unknown strategy"):
        lay.collectives("ring", 4)
    assert tl.resolve_strategy("allgather", True) == "hierarchical"
    assert tl.resolve_strategy(strategy, True) == strategy


def test_pack_unpack_residual_arrays_match_reference(reduced):
    jparams, tparams = reduced
    jlay = jl.build_layout(jparams, 2, 0.01, j_get("gaussiank"))
    lay = tl.build_layout(tparams, 2, 0.01, get_compressor("gaussiank"))
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal((3, s.d_pad)).astype(np.float32)
              for s in lay.segments]
    flat = tl.pack_residual_arrays(lay, arrays)
    np.testing.assert_array_equal(flat,
                                  jl.pack_residual_arrays(jlay, arrays))
    assert flat.shape == (3, lay.flat_size)
    for a, b in zip(tl.unpack_residual_arrays(lay, flat), arrays):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="d_pad"):
        tl.pack_residual_arrays(lay, [a[:, 1:] for a in arrays])


@pytest.mark.parametrize("model_size", [1, 2])
def test_pack_unpack_bitwise(reduced, model_size):
    jparams, tparams = reduced
    jlay = jl.build_layout(jparams, model_size, 0.01, j_get("gaussiank"))
    tlay = tl.build_layout(tparams, model_size, 0.01,
                           get_compressor("gaussiank"))
    rng = np.random.default_rng(model_size)
    grads_np = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), jparams)
    jG = jl.pack_grads(jlay, jax.tree.map(jnp.asarray, grads_np),
                       jnp.float32)
    tG = tl.pack_grads(tlay, from_jax_params(grads_np, "cpu"), torch.float32)
    np.testing.assert_array_equal(np.asarray(jG), tG.numpy())
    jback = jl.unpack_tree(jlay, jG, like=jparams)
    tback = tl.unpack_tree(tlay, tG, like=tparams)
    for a, b in zip(jax.tree.leaves(jback), tree.leaves(tback)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_unpack_returns_views(reduced):
    _, tparams = reduced
    lay = tl.build_layout(tparams, 1, 0.01, get_compressor("gaussiank"))
    bucket = torch.arange(lay.d_row_total, dtype=torch.float32)[None]
    out = tl.unpack_tree(lay, bucket, like=tparams)
    for seg, leaf in zip(lay.segments, tree.leaves(out)):
        assert leaf.data_ptr() == bucket[0, seg.row_off:].data_ptr()
        assert tuple(leaf.shape) == seg.shape


def test_leaf_salts_and_names(reduced):
    jparams, tparams = reduced
    jnames = [jl.leaf_path_name(p)
              for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    tnames = [tl.leaf_path_name(p)
              for p, _ in tree.flatten_with_path(tparams)[0]]
    assert jnames == tnames == REDUCED_ORDER
    for n in tnames:
        assert jl.leaf_key_salt(n) == tl.leaf_key_salt(n)


def test_flatten_order_is_key_sorted():
    """Insertion order would give [1, 2, 3, 4]; JAX's sorted keys give
    [2, 1, 4, 3] (ROADMAP Queue 1 item 4)."""
    t = {"b": 1, "a": 2, "c": {"z": 3, "y": 4}}
    assert tree.leaves(t) == jax.tree.leaves(t) == [2, 1, 4, 3]
    leaves, td = tree.flatten(t)
    assert tree.unflatten(td, leaves) == t


def test_full_llama_bucket_fits_int32():
    """llama3.2-1b at full width: shapes from the port's own init on the
    meta device — the bucket is 1,498,482,688 columns, below 2**31."""
    cfg = get_config("llama3.2-1b")
    params = init_params(cfg, 0, "meta")
    lay = tl.build_layout(params, 1, 0.001, get_compressor("gaussiank"))
    assert lay.d_row_total == 1_498_482_688 < 2 ** 31
    assert len(lay.segments) == 12
    sizes = {s.name: s.size for s in lay.segments}
    assert max(sizes.values()) == sizes["stack/0/ffn/w_gate"] == 268_435_456
    jshapes = jax.eval_shape(lambda: j_init(j_get_config("llama3.2-1b"),
                                            jax.random.PRNGKey(0)))
    assert [tuple(x.shape) for x in jax.tree.leaves(jshapes)] == \
        [s.shape for s in lay.segments]
