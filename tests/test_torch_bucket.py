"""``bucket_compress`` of the port against the JAX package's, outside
``shard_map`` on the CPU (the fused branch runs the reference's kernels
in interpret mode).  The packed bucket is random; its wire pair, global
indices and new residual are held bitwise, and at world size 1 the
decoded mean plus the residual equals ``G + E`` bitwise.  A down-cast
wire (bf16, fp16) is held bitwise the reference's too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compressors import get_compressor as j_get
from repro.dist import aggregate as jagg
from repro.dist import layout as jl
from repro.dist.layout import build_layout as j_build_layout
from repro.models import init_params as j_init
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.core import codec
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.compressors import get_compressor
from repro_torch.dist import aggregate as tagg
from repro_torch.dist.layout import build_layout, init_flat_residual
from repro_torch.models import ModelConfig, from_jax_params, init_params

torch.set_num_threads(2)


_SMALL = dict(name="sys", arch_type="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
CFG = JModelConfig(**_SMALL).validate()
_TCFG = ModelConfig(**_SMALL).validate()


@pytest.mark.parametrize("compressor,backend", [
    ("gaussiank", "fused"), ("gaussiank2", "fused"),
    ("gaussiank", "reference"), ("topk", "reference")])
def test_bucket_compress_matches_reference(compressor, backend):
    """Whole-bucket compression of the small system config's grads-shaped
    random values: wire, global indices and residual bitwise."""
    jparams = j_init(CFG, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    ratio = 0.01
    jlayout = j_build_layout(jparams, 1, ratio, j_get(compressor))
    tlayout = build_layout(from_jax_params(np_params, "cpu"), 1, ratio,
                           get_compressor(compressor))
    assert tlayout.d_row_total == jlayout.d_row_total
    rng = np.random.default_rng(5)
    G = rng.standard_normal((1, jlayout.d_row_total)).astype(np.float32)
    E = (0.2 * rng.standard_normal(G.shape)).astype(np.float32)
    jv, ji, jE, _ = jax.jit(lambda a, b: jagg.bucket_compress(
        a, b, jlayout, j_get(compressor), None, backend=backend))(
            jnp.asarray(G), jnp.asarray(E))
    tv, ti, tE = tagg.bucket_compress(
        torch.from_numpy(G), torch.from_numpy(E.copy()), tlayout,
        get_compressor(compressor), backend=backend)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jE), tE.numpy())
    wire = tagg._one_data_axis_wire(1)
    (mean,) = tagg._gather_mean([tv], [ti], "data", 1, tlayout.d_row_total,
                                wire)
    assert torch.equal(mean + tE, torch.from_numpy(G + E))


@pytest.mark.parametrize("wire", ["bfloat16", "float16"])
def test_down_cast_wire_conserves(wire):
    """A ``codec_dtype`` wire (fused backend): the cast values, indices
    and residual bitwise the reference's ``bucket_compress``;
    ``decode(cast values) + e' == G + E`` bitwise; the accounting counts
    16-bit values, as ``repro.dist.layout``'s."""
    jparams = j_init(CFG, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    jlayout = j_build_layout(jparams, 1, 0.01, j_get("gaussiank"))
    tlayout = build_layout(from_jax_params(np_params, "cpu"), 1, 0.01,
                           get_compressor("gaussiank"))
    rng = np.random.default_rng(11)
    D = tlayout.d_row_total
    G = (1e-3 * rng.standard_normal((1, D))).astype(np.float32)
    E = (2e-4 * rng.standard_normal((1, D))).astype(np.float32)
    jv, ji, jE, _ = jax.jit(lambda a, b: jagg.bucket_compress(
        a, b, jlayout, j_get("gaussiank"), None, backend="fused",
        codec_dtype=getattr(jnp, wire)))(jnp.asarray(G), jnp.asarray(E))
    tv, ti, tE = tagg.bucket_compress(
        torch.from_numpy(G), torch.from_numpy(E.copy()), tlayout,
        get_compressor("gaussiank"), backend="fused",
        codec_dtype=getattr(torch, wire))
    assert tv.dtype == getattr(torch, wire)
    np.testing.assert_array_equal(np.asarray(jv).astype(np.float32),
                                  tv.float().numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jE), tE.numpy())
    dec = codec.decode(tv[0].float(), ti[0], D)
    assert torch.equal(dec + tE[0], torch.from_numpy(G[0] + E[0]))
    config = CompressionConfig(codec_dtype=getattr(torch, wire), ratio=0.01)
    params = init_params(_TCFG, 0, "cpu")
    layout = build_layout(params, 1, 0.01, get_compressor("gaussiank"))
    res = tagg.aggregate_bucketed(
        params, init_flat_residual(layout, device="cpu"), layout, config)
    assert res.metrics["comm_bits_sparse"] == \
        layout.pair_bits(config.codec_dtype) == \
        layout.model_size * layout.k_cap_total * (16 + 32)
    assert layout.pair_bits(getattr(torch, wire)) == jl.build_layout(
        jparams, 1, 0.01, j_get("gaussiank")).pair_bits(getattr(jnp, wire))
