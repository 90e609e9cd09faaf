"""The port's fused EF pipeline against the JAX package (interpret mode
on the CPU).

* The Gaussian threshold is held within rtol 1e-5: ``jax.scipy``'s
  ``norm.ppf`` and ``torch.special.ndtri`` may differ by an ulp, and so
  may the block sums feeding them.
* Given the JAX threshold the wire pair and the new residual are
  bitwise the reference's (same block, bcap and k_cap).
* Conservation ``decode(v, i) + e' == g + e`` is bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ef_fused import ops as jops
from repro.kernels.ef_fused import tuning as jtuning
from repro_torch.core import codec
from repro_torch.kernels.ef_fused import ops, passes, tuning

torch.set_num_threads(2)


def _jax_threshold(u, d, k, name, sb):
    """The reference's fused threshold on the materialized ``u`` — what
    its interpret-mode pipeline computes."""
    pad = (-d) % sb
    a_s = jnp.asarray(np.pad(u, (0, pad)).reshape(-1, sb))
    kcfg = jtuning.KernelConfig(backend="interpret", block=sb,
                                stats_block=sb)
    t = jops._gaussian_threshold_fused(
        a_s, None, d, k, block=sb, refine_iters=4,
        two_sided=name == "gaussiank2", kcfg=kcfg, interpret=True)
    return np.float32(max(float(t), 0.0))


CASES = [  # (d, k, scale, bcap)
    (33, 1, 1.0, None), (5001, 50, 1.0, None), (70001, 70, 1.0, None),
    (5000, 5, 0.0, None),                    # all-zero: threshold 0
    (20000, 400, 1.0, 64),                   # staging overflow (bcap 64)
]


@pytest.mark.parametrize("name", ["gaussiank", "gaussiank2"])
@pytest.mark.parametrize("d,k,scale,bcap", CASES)
def test_fused_compress_ef_matches_reference(d, k, scale, bcap, name):
    rng = np.random.default_rng(d + k)
    g = (scale * rng.standard_normal(d)).astype(np.float32)
    e = (0.5 * scale * rng.standard_normal(d)).astype(np.float32)
    block = tuning.choose_block(d, "torch")
    sb = tuning.choose_stats_block(d, "torch")
    jv, ji, je = jops.fused_compress_ef(
        jnp.asarray(g), jnp.asarray(e), name, k, bcap=bcap,
        backend="interpret")
    tg, te = torch.from_numpy(g), torch.from_numpy(e)
    with passes.count_passes() as log:
        tv, ti, tne = ops.fused_compress_ef(tg, te, name, k, bcap=bcap)
    assert log.by_label() == {"moments": 1, "tree_count": 1, "compact": 1,
                              "residual_write": 1}
    # conservation, bitwise
    assert torch.equal(codec.decode(tv, ti, d) + tne, tg + te)
    # threshold within tolerance
    t_port = ops._gaussian_threshold_fused(
        tg, te, d, k, stats_block=sb, refine_iters=4,
        two_sided=name == "gaussiank2")
    t_jax = _jax_threshold(g + e, d, k, name, sb)
    np.testing.assert_allclose(t_port, t_jax, rtol=1e-5, atol=0)
    # the wire, bitwise, given the JAX threshold
    k_cap = -(-4 * k // 3)
    bc = bcap or ops.fused_default_bcap(k_cap, d, block)
    wv, wi, wne = ops.compress_at_threshold(tg, te, t_jax, k_cap=k_cap,
                                            block=block, bcap=bc)
    np.testing.assert_array_equal(np.asarray(jv), wv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), wi.numpy())
    np.testing.assert_array_equal(np.asarray(je), wne.numpy())
    if t_port == t_jax:   # then the port's own run is the reference's
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy())


def test_fused_in_place_residual():
    """``out=e`` writes the new residual over the old one."""
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.standard_normal(9000).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal(9000).astype(np.float32))
    u = g + e
    v, i, ne = ops.fused_compress_ef(g, e, "gaussiank", 9, out=e)
    assert ne.data_ptr() == e.data_ptr()
    assert torch.equal(codec.decode(v, i, 9000) + e, u)


def test_histk_names_its_slice():
    g = torch.zeros(10)
    with pytest.raises(NotImplementedError, match="slice 5"):
        ops.fused_compress_ef(g, None, "histk", 1)
