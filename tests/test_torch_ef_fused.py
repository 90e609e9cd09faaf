"""The port's fused EF pipeline against the JAX package (interpret mode
on the CPU).

* The Gaussian threshold is held within rtol 1e-5: ``jax.scipy``'s
  ``norm.ppf`` and ``torch.special.ndtri`` may differ by an ulp, and so
  may the block sums feeding them.  The hist-k threshold is equal: the
  histograms may differ only on elements within ulps of a bin edge, and
  none of these inputs has one across an edge that decides it.
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
from repro.kernels.ef_fused.compact_residual import \
    compact_residual as j_compact
from repro_torch.core import codec
from repro_torch.kernels.ef_fused import compact_residual as cr
from repro_torch.kernels.ef_fused import ops, passes, tuning

torch.set_num_threads(2)


def _jax_threshold(u, d, k, name, sb):
    """The reference's fused threshold on the materialized ``u`` — what
    its interpret-mode pipeline computes."""
    pad = (-d) % sb
    a_s = jnp.asarray(np.pad(u, (0, pad)).reshape(-1, sb))
    kcfg = jtuning.KernelConfig(backend="interpret", block=sb,
                                stats_block=sb)
    if name == "histk":
        t = jops._hist_threshold_fused(a_s, None, d, k, pad, block=sb,
                                       kcfg=kcfg, interpret=True)
    else:
        t = jops._gaussian_threshold_fused(
            a_s, None, d, k, block=sb, refine_iters=4,
            two_sided=name == "gaussiank2", kcfg=kcfg, interpret=True)
    return np.float32(max(float(t), 0.0))


def _port_threshold(g, e, d, k, name, sb):
    if name == "histk":
        return ops._hist_threshold_fused(g, e, d, k, stats_block=sb)
    return ops._gaussian_threshold_fused(
        g, e, d, k, stats_block=sb, refine_iters=4,
        two_sided=name == "gaussiank2")


# K3 is one sweep (staging rows, residual and the pair), labelled as the
# reference's sequential lowering labels it
PASSES = {"gaussiank": {"moments": 1, "tree_count": 1,
                        "compact+residual": 1},
          "histk": {"moments+hist": 1, "compact+residual": 1}}


CASES = [  # (d, k, scale, bcap)
    (33, 1, 1.0, None), (5001, 50, 1.0, None), (70001, 70, 1.0, None),
    (5000, 5, 0.0, None),                    # all-zero: threshold 0
    (20000, 400, 1.0, 64),                   # staging overflow (bcap 64)
]


@pytest.mark.parametrize("name", ["gaussiank", "gaussiank2", "histk"])
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
    assert log.by_label() == PASSES["histk" if name == "histk"
                                    else "gaussiank"]
    # conservation, bitwise
    assert torch.equal(codec.decode(tv, ti, d) + tne, tg + te)
    # threshold within tolerance
    t_port = _port_threshold(tg, te, d, k, name, sb)
    t_jax = _jax_threshold(g + e, d, k, name, sb)
    np.testing.assert_allclose(t_port, t_jax, rtol=1e-5, atol=0)
    if name == "histk":
        assert t_port == t_jax
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


def test_histk_runs_and_conserves():
    """The fused hist-k pipeline: one K1-with-histogram pass, no K2, and
    ``decode(v, i) + e' == g + e`` bitwise, also in place."""
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal(9000).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal(9000).astype(np.float32))
    u = g + e
    with passes.count_passes() as log:
        v, i, ne = ops.fused_compress_ef(g, e, "histk", 90, out=e)
    assert log.by_label() == PASSES["histk"]
    assert ne.data_ptr() == e.data_ptr()
    assert torch.equal(codec.decode(v, i, 9000) + e, u)
    assert 0 < int(codec.nnz(i)) <= v.shape[0]


def test_geometry_of_gives_the_cards_geometry_on_the_cpu():
    """Under ``geometry_of("cuda")`` a CPU call stages with the card's
    block and bcap (the checked-in table's): bitwise the same call with
    that geometry spelled out."""
    rng = np.random.default_rng(4)
    d, k = 70001, 700
    g = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    cfg = tuning.resolve_config(d, "cuda")
    assert cfg.source == "table"
    assert tuning.resolve_config(d, "torch") != cfg
    with tuning.geometry_of("cuda"):
        assert tuning.resolve_config(d, "torch").block == cfg.block
        got = ops.fused_compress_ef(g, e, "histk", k)
    assert tuning.resolve_config(d, "torch").block != cfg.block
    want = ops.fused_compress_ef(g, e, "histk", k, block=cfg.block,
                                 stats_block=cfg.stats_block)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _pad2d(x, block):
    pad = (-x.shape[0]) % block
    return jnp.asarray(np.pad(x, (0, pad)).reshape(-1, block))


@pytest.mark.parametrize("off", [0, 1, 3])
@pytest.mark.parametrize("block", [1001, 2048])
@pytest.mark.parametrize("case", ["zero", "above max"])
@pytest.mark.parametrize("d", [33, 5001])
def test_compact_stage_plain_edge_cases(d, case, block, off):
    """The K3 stage and residual at threshold 0 (``u = g + e`` has no
    zeros: every full block overflows ``bcap`` and keeps its lowest
    indices) and above ``max|u|`` (nothing staged, ``e' = u``), on ``d``
    not a multiple of ``block`` and on views at storage offset ``off``:
    bitwise the reference in interpret mode."""
    rng = np.random.default_rng(d + off)
    gb = rng.standard_normal(d + off).astype(np.float32)
    eb = (0.5 * rng.standard_normal(d + off)).astype(np.float32)
    g, e = gb[off:], eb[off:]
    u = g + e
    assert np.all(u != 0)
    t = np.float32(0.0) if case == "zero" else np.nextafter(
        np.abs(u).max(), np.float32(np.inf))
    bcap, k_cap = 64, 100
    jv, jo, jn, je = j_compact(_pad2d(g, block), _pad2d(e, block), t,
                               bcap=bcap, k_cap=k_cap, block=block,
                               with_resid=True, backend="interpret",
                               interpret=True)
    tg, te = torch.from_numpy(gb)[off:], torch.from_numpy(eb)[off:]
    assert tg.storage_offset() == te.storage_offset() == off
    tv, to, tn = cr.compact_stage(tg, te, float(t), block=block, bcap=bcap)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    ne = cr.compact_resid(tg, te, float(t), cr.exclusive_enc(tn, bcap),
                          block=block, bcap=bcap, k_cap=k_cap)
    np.testing.assert_array_equal(np.asarray(je).reshape(-1)[:d],
                                  ne.numpy())
    real = np.minimum(d - block * np.arange(tn.shape[0]), block)
    if case == "zero":
        np.testing.assert_array_equal(tn.numpy(), real)
        full = real >= bcap
        np.testing.assert_array_equal(to.numpy()[full],
                                      np.tile(np.arange(bcap), (full.sum(),
                                                                1)))
    else:
        assert int(tn.max()) == 0 and torch.equal(ne, tg + te)
    assert cr.compact_stage.launches == 0
