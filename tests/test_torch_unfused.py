"""The unfused pipeline: K4a ``moments``, K4b ``count_gt`` and K4c
``threshold_compact`` (plain versions), the Gaussian-k threshold loop and
``unfused_compress_ef``, against the JAX package (Pallas kernels in
interpret mode), and the port's unfused pipeline against its fused one.

Tolerances:
* K4a ``s`` within ``1e-5·Σ|u|``, ``sq`` within rtol 1e-5, absmax exact
  (XLA orders the in-block sums its own way); the port's K4a sums are
  bitwise its K1 sums on the same ``u``.  ``mean_std_absmax``'s variance
  ``sq/d − mean²`` cancels, so it is held to ``1e-5·sq/d``.
* K4b counts, K4c staging rows: exact.
* Gaussian thresholds within rtol 1e-5 (``norm.ppf`` against
  ``torch.special.ndtri`` on sums that differ by reassociation); the
  wire bitwise given the JAX threshold.
* Port unfused against port fused: bitwise ``values``, ``indices`` and
  ``e'`` — the threshold glue is the same f32 host arithmetic on the
  same sums and counts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ef_fused import ops as jef
from repro.kernels.gaussian_topk import ops as jg
from repro.kernels.gaussian_topk.count_gt import count_gt as j_count
from repro.kernels.gaussian_topk.threshold_compact import \
    threshold_compact as j_compact
from repro.kernels.moments.moments import moments as j_moments
from repro.kernels.moments.ops import mean_std_absmax as j_msa
from repro_torch.core import codec
from repro_torch.kernels.ef_fused import fused_moments as fm
from repro_torch.kernels.ef_fused import ops, passes, tuning
from repro_torch.kernels.gaussian_topk import count_gt as cg
from repro_torch.kernels.gaussian_topk import ops as gops
from repro_torch.kernels.gaussian_topk import threshold_compact as thc
from repro_torch.kernels.moments import mean_std_absmax
from repro_torch.kernels.moments import moments as mom

torch.set_num_threads(2)

DS = [1, 33, 2048, 5001, 65536]


def _u(d, seed=0):
    rng = np.random.default_rng(seed + d)
    return (rng.standard_normal(d) * 0.01 + 0.001).astype(np.float32)


def _pad2d(x, block):
    pad = (-x.shape[0]) % block
    return jnp.asarray(np.pad(x, (0, pad)).reshape(-1, block))


@pytest.mark.parametrize("d", DS)
def test_moments_plain_matches_pallas(d):
    u = _u(d)
    block = tuning.choose_stats_block(d, "torch")
    js, jsq, jmx = j_moments(_pad2d(u, block), block=block, interpret=True)
    tu = torch.from_numpy(u)
    ts, tsq, tmx = mom.moments(tu, block=block)
    assert abs(float(ts) - float(js)) <= 1e-5 * float(np.abs(u).sum())
    np.testing.assert_allclose(float(tsq), float(jsq), rtol=1e-5)
    assert float(tmx) == float(jmx)
    # the same per-block sums as K1 applies to g + e
    k1 = fm.fused_moments(tu, None, block=block)
    assert all(torch.equal(a, b) for a, b in zip((ts, tsq, tmx), k1))
    jm, jsd, _ = j_msa(jnp.asarray(u), block=block, interpret=True)
    tm, tsd, _ = mean_std_absmax(tu, block=block)
    np.testing.assert_allclose(float(tm), float(jm), rtol=1e-4, atol=1e-9)
    # var = sq/d - mean² cancels: hold it to 1e-5 of sq/d
    assert abs(float(tsd) ** 2 - float(jsd) ** 2) <= 1e-5 * float(tsq) / d
    assert mom.moments.launches == 0


@pytest.mark.parametrize("d", DS)
def test_count_gt_plain_matches_pallas(d):
    u = _u(d)
    block = tuning.choose_stats_block(d, "torch")
    x2d = _pad2d(u, block)
    for q in (0.0, 0.5, 0.99, 1.0):
        t = np.float32(np.quantile(np.abs(u), q))
        jc = int(j_count(x2d, t, block=block, interpret=True))
        tc = cg.count_gt(torch.from_numpy(u), float(t), block=block)
        assert tc.dtype == torch.int32 and tc.dim() == 0
        assert int(tc) == jc
    assert cg.count_gt.launches == 0


@pytest.mark.parametrize("bcap", [8, 64])
@pytest.mark.parametrize("d", DS)
def test_threshold_compact_plain_matches_pallas(d, bcap):
    u = _u(d)
    block = 2048
    t = np.float32(np.quantile(np.abs(u), 0.98)) if d > 1 else \
        np.float32(0.0)
    jv, jo, jc = j_compact(_pad2d(u, block), t, bcap=bcap, block=block,
                           interpret=True)
    tv, to, tc = thc.threshold_compact(torch.from_numpy(u), float(t),
                                       block=block, bcap=bcap)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert thc.threshold_compact.launches == 0


@pytest.mark.parametrize("off", [0, 1, 3])
@pytest.mark.parametrize("block", [1001, 2048])
@pytest.mark.parametrize("case", ["zero", "above max"])
@pytest.mark.parametrize("d", [33, 5001])
def test_threshold_compact_plain_edge_cases(d, case, block, off):
    """Threshold 0 on a ``u`` with no zeros (every full block overflows
    ``bcap`` and keeps its lowest indices) and a threshold above
    ``max|u|`` (nothing selected), on ``d`` not a multiple of ``block``
    and on a view at storage offset ``off``: bitwise the reference."""
    base = _u(d + off, seed=9)
    u = base[off:]
    assert np.all(u != 0)
    t = np.float32(0.0) if case == "zero" else np.nextafter(
        np.abs(u).max(), np.float32(np.inf))
    bcap = 64
    jv, jo, jc = j_compact(_pad2d(u, block), t, bcap=bcap, block=block,
                           interpret=True)
    tu = torch.from_numpy(base)[off:]
    assert tu.storage_offset() == off
    tv, to, tc = thc.threshold_compact(tu, float(t), block=block, bcap=bcap)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    real = np.minimum(d - block * np.arange(tc.shape[0]), block)
    if case == "zero":
        np.testing.assert_array_equal(tc.numpy(), real)
        full = real >= bcap
        np.testing.assert_array_equal(to.numpy()[full],
                                      np.tile(np.arange(bcap), (full.sum(),
                                                                1)))
    else:
        assert int(tc.max()) == 0 and bool((to == -1).all())
    assert thc.threshold_compact.launches == 0


def test_threshold_compact_takes_multiples_of_8():
    with pytest.raises(ValueError, match="multiple of 8"):
        thc.threshold_compact(torch.zeros(64), 0.0, block=64, bcap=12)


@pytest.mark.parametrize("two_sided", [False, True])
@pytest.mark.parametrize("d,k", [(100, 1), (5001, 50), (65537, 66)])
def test_gaussiank_select_kernel_matches(d, k, two_sided):
    u = _u(d, seed=5)
    jt = float(jg.gaussian_threshold_kernel(jnp.asarray(u), k,
                                            two_sided=two_sided))
    tt = gops.gaussian_threshold_kernel(torch.from_numpy(u), k,
                                        two_sided=two_sided)
    assert isinstance(tt, np.float32)
    np.testing.assert_allclose(float(tt), jt, rtol=1e-5)
    # the wire, bitwise, given the JAX threshold
    k_cap = -(-4 * k // 3)
    jv, ji = jg.select_by_threshold(jnp.asarray(u), jnp.float32(jt), k_cap)
    tv, ti = gops.select_by_threshold(torch.from_numpy(u), jt, k_cap)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    if float(tt) == jt:
        kv, ki = jg.gaussiank_select_kernel(jnp.asarray(u), k,
                                            two_sided=two_sided)
        pv, pi = gops.gaussiank_select_kernel(torch.from_numpy(u), k,
                                              two_sided=two_sided)
        np.testing.assert_array_equal(np.asarray(ki), pi.numpy())
        np.testing.assert_array_equal(np.asarray(kv), pv.numpy())


def test_default_bcap_matches():
    for k_cap, d, block in [(4, 33, 2048), (1335, 1_000_003, 1024),
                            (134, 10_000, 2048), (10_000, 20_000, 2048)]:
        assert gops.default_bcap(k_cap, d, block) == \
            jg.default_bcap(k_cap, d, block)


def _inputs(d, scale=1.0, seed=0):
    rng = np.random.default_rng(seed + d)
    g = (scale * rng.standard_normal(d)).astype(np.float32)
    e = (0.5 * scale * rng.standard_normal(d)).astype(np.float32)
    return g, e


UNFUSED = {"gaussiank": {"residual_add": 1, "moments": 1, "count_gt": 4,
                         "compact": 1, "dense_decode": 1,
                         "residual_subtract": 1},
           "histk": {"residual_add": 1, "hist": 1, "compact": 1,
                     "dense_decode": 1, "residual_subtract": 1}}


@pytest.mark.parametrize("name", ["gaussiank", "gaussiank2", "histk"])
@pytest.mark.parametrize("d,k", [(33, 1), (5001, 50), (70001, 70)])
def test_unfused_compress_ef_matches_reference(d, k, name):
    g, e = _inputs(d)
    jv, ji, je = jef.unfused_compress_ef(jnp.asarray(g), jnp.asarray(e),
                                         name, k, backend="interpret")
    tg, te = torch.from_numpy(g), torch.from_numpy(e)
    with passes.count_passes() as log:
        tv, ti, tne = ops.unfused_compress_ef(tg, te, name, k)
    assert log.by_label() == UNFUSED["histk" if name == "histk"
                                     else "gaussiank"]
    assert torch.equal(codec.decode(tv, ti, d) + tne, tg + te)
    # the thresholds agree to the bit on these inputs: the whole wire does
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(je), tne.numpy())


@pytest.mark.parametrize("name", ["gaussiank", "gaussiank2", "histk"])
@pytest.mark.parametrize("d,k,scale", [(33, 1, 1.0), (5001, 50, 1.0),
                                       (70001, 70, 1.0), (200_000, 200, 1.0),
                                       (5000, 5, 0.0)])
def test_unfused_equals_fused(d, k, scale, name):
    """Bitwise at the same staging width (the fused default handed to the
    unfused pipeline); with each pipeline's own default width (2× and 4×
    the expected per-block selection) too wherever neither truncates."""
    g, e = _inputs(d, scale, seed=1)
    tg, te = torch.from_numpy(g), torch.from_numpy(e)
    fused = ops.fused_compress_ef(tg, te, name, k)
    block = tuning.choose_block(d, "torch")
    k_cap = fused[0].shape[0]
    bcap = ops.fused_default_bcap(k_cap, d, block)
    same = ops.unfused_compress_ef(tg, te, name, k, bcap=bcap)
    for a, b in zip(fused, same):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    sb = tuning.choose_stats_block(d, "torch")
    t = (ops._hist_threshold_fused(tg, te, d, k, stats_block=sb)
         if name == "histk" else ops._gaussian_threshold_fused(
             tg, te, d, k, stats_block=sb, refine_iters=4,
             two_sided=name == "gaussiank2"))
    per_block = thc.threshold_compact(tg + te, float(t), block=block,
                                      bcap=8 * (block // 8))[2]
    if int(per_block.max()) <= bcap:
        own = ops.unfused_compress_ef(tg, te, name, k)
        for a, b in zip(fused, own):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
