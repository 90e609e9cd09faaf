"""Hist-k: the port's bins, edges, histograms (K4d and K1's), threshold
and selection against the JAX package (Pallas kernels in interpret mode,
or their pure-jnp oracle where the input is large).

Tolerances:
* Edges: bitwise (the exact f32 rounding of ``2^(b/4 − 16)``).
* Bins: the port bins ``|x|`` by its exact position among the f32
  edges; the reference by ``floor((log2|x| + 16)·4)`` in f32.  They may
  disagree on at most ``1e-5·d`` elements, each by one bin, each on an
  element whose ``log2`` lies within 2 f32 ulps of the edge's (one ulp of
  ``log2``'s own rounding and one of the scaling).  The count is printed.
* Histograms: L1 distance at most twice the bin disagreements.
* Thresholds: equal (``threshold_from_histogram`` is bitwise on the same
  histogram; the seeded inputs put no element across an edge that
  decides a threshold).
* The hist-k wire: bitwise, given the same threshold.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ef_fused.fused_moments import fused_moments as j_fused
from repro.kernels.histk import hist as jhist
from repro.kernels.histk import ops as jops
from repro.kernels.histk.ref import abs_histogram_ref
from repro_torch.kernels.ef_fused import fused_moments as fm
from repro_torch.kernels.ef_fused import tuning
from repro_torch.kernels.histk import hist, ops

torch.set_num_threads(2)

DS = [1, 33, 2048, 5001, 70001]


def _u(d, seed=0, scale=1e-3):
    rng = np.random.default_rng(seed + d)
    return (scale * rng.standard_normal(d)).astype(np.float32)


def _pad2d(x, block):
    pad = (-x.shape[0]) % block
    return jnp.asarray(np.pad(x, (0, pad)).reshape(-1, block)), pad


def test_edges_and_mantissas_are_the_references():
    ref = np.asarray(jhist.bin_lower_edge(jnp.arange(128, dtype=jnp.float32)))
    assert ref.dtype == np.float32
    np.testing.assert_array_equal(hist.EDGES.view(np.int32),
                                  ref.view(np.int32))
    # the Triton kernel's literals are these edge mantissas
    man = tuple(int(hist.EDGES[q].view(np.int32)) & 0x7FFFFF
                for q in (1, 2, 3))
    assert man == hist.EDGE_MANTISSAS == (0x1837F0, 0x3504F3, 0x5744FD)
    for b in (0, 1, 64, 127):
        assert hist.bin_lower_edge(b) == ref[b]


def test_bin_is_the_exact_edge_position():
    """Every edge, its f32 neighbours, zero, subnormals, the clamps."""
    e = hist.EDGES
    x = np.concatenate([e, np.nextafter(e, np.float32(0)),
                        np.nextafter(e, np.float32(np.inf)),
                        np.array([0.0, 1e-45, 1e-38, 2.0 ** -17, 2.0 ** 16,
                                  3e38, np.inf], np.float32)])
    x = np.concatenate([x, -x]).astype(np.float32)
    got = hist.bin_of(torch.from_numpy(x)).numpy()
    want = np.clip(np.searchsorted(e, np.abs(x), side="right") - 1, 0, 127)
    np.testing.assert_array_equal(got, want)


def test_bins_against_log2_reference(record_property):
    d = 4_000_000
    x = _u(d, seed=11)
    jb = np.asarray(jhist._bin_of(jnp.abs(jnp.asarray(x))))
    tb = hist.bin_of(torch.from_numpy(x)).numpy()
    dis = np.flatnonzero(jb != tb)
    edge = hist.EDGES[np.maximum(jb[dis], tb[dis])]
    ulps = np.abs(np.abs(x[dis]).view(np.int32).astype(np.int64)
                  - edge.view(np.int32))
    print(f"bin disagreements with the log2 reference: {dis.size} of {d}, "
          f"{ulps.max(initial=0)} f32 ulps of |x| from the edge at most")
    record_property("bin_disagreements", int(dis.size))
    assert dis.size <= 1e-5 * d
    assert np.all(np.abs(jb[dis] - tb[dis]) == 1)
    lg = np.log2(np.abs(x[dis]).astype(np.float64))
    ulp = np.spacing(np.log2(edge.astype(np.float64)).astype(np.float32))
    assert np.all(np.abs(lg - np.log2(edge.astype(np.float64)))
                  <= 2 * np.abs(ulp))
    # the histograms of the same data differ by at most 2 per disagreement
    jh = np.asarray(abs_histogram_ref(jnp.asarray(x))).astype(np.int64)
    th = hist.abs_histogram(torch.from_numpy(x), block=2048).numpy()
    assert th.sum() == d
    assert np.abs(jh - th).sum() <= 2 * dis.size


@pytest.mark.parametrize("block", [2048, 4096])
@pytest.mark.parametrize("d", DS)
def test_abs_histogram_plain_matches_pallas(d, block):
    x = _u(d)
    x2d, pad = _pad2d(x, block)
    jh = np.asarray(jhist.abs_histogram(x2d, block=block, interpret=True))
    jh = jh.astype(np.int64)
    jh[0] -= pad                       # the port counts real elements only
    th = hist.abs_histogram(torch.from_numpy(x), block=block)
    assert th.dtype == torch.int64 and th.shape == (128,)
    dis = int((np.asarray(jhist._bin_of(jnp.abs(jnp.asarray(x))))
               != hist.bin_of(torch.from_numpy(x)).numpy()).sum())
    assert np.abs(jh - th.numpy()).sum() <= 2 * dis
    assert hist.abs_histogram.launches == 0


def _kind(kind, d, seed=0):
    """Histogram inputs: Gaussian magnitudes; one magnitude (one bin);
    zeros, subnormals, ``edge[127]`` and larger magnitudes, infinities,
    between Gaussian values."""
    x = _u(d, seed)
    if kind == "one magnitude":
        x = np.full(d, 0.37, np.float32)
    elif kind == "mixed":
        x[0::6] = 0.0
        x[1::6] = -1e-40
        x[2::6] = hist.EDGES[127]
        x[3::6] = -3e38
        x[4::12] = np.inf
    return x


@pytest.mark.parametrize("kind", ["gaussian", "one magnitude", "mixed"])
@pytest.mark.parametrize("d", [1, 33, 5001, 70001])
def test_abs_histogram_plain_is_block_independent(d, kind):
    """The counts do not depend on ``block`` (what the card's kernel, whose
    geometry ignores ``block``, relies on): equal for blocks 16, 2048 and
    4096, and to one ``bincount`` of the bins; within ``2·disagreements``
    of the reference run in interpret mode."""
    x = _kind(kind, d)
    tx = torch.from_numpy(x)
    want = torch.bincount(hist.bin_of(tx), minlength=hist.BINS)
    for block in (16, 2048, 4096):
        assert torch.equal(hist.abs_histogram_plain(tx, block=block), want)
    if kind == "one magnitude":
        assert int(want[hist.bin_of(tx[:1])]) == d
    x2d, pad = _pad2d(x, 2048)
    jh = np.asarray(jhist.abs_histogram(x2d, block=2048, interpret=True))
    jh = jh.astype(np.int64)
    jh[0] -= pad
    dis = int((np.asarray(jhist._bin_of(jnp.abs(jnp.asarray(x))))
               != hist.bin_of(tx).numpy()).sum())
    assert np.abs(jh - want.numpy()).sum() <= 2 * dis


@pytest.mark.parametrize("with_e", [True, False])
@pytest.mark.parametrize("d", [33, 5001, 70001])
def test_fused_moments_hist_plain_matches_pallas(d, with_e):
    rng = np.random.default_rng(d)
    g = rng.standard_normal(d).astype(np.float32)
    e = (0.3 * rng.standard_normal(d)).astype(np.float32) if with_e else None
    sb = tuning.choose_stats_block(d, "torch")
    g2d, pad = _pad2d(g, sb)
    e2d = _pad2d(e, sb)[0] if with_e else None
    js, jsq, jmx, jh = j_fused(g2d, e2d, block=sb, with_hist=True,
                               backend="interpret", interpret=True)
    ts, tsq, tmx, th = fm.fused_moments_hist(
        torch.from_numpy(g), None if e is None else torch.from_numpy(e),
        block=sb)
    u = g if e is None else g + e
    assert abs(float(ts) - float(js)) <= 1e-5 * float(np.abs(u).sum())
    np.testing.assert_allclose(float(tsq), float(jsq), rtol=1e-5)
    assert float(tmx) == float(jmx)
    jh = np.asarray(jh).astype(np.int64)
    jh[0] -= pad
    dis = int((np.asarray(jhist._bin_of(jnp.abs(jnp.asarray(u))))
               != hist.bin_of(torch.from_numpy(u)).numpy()).sum())
    assert np.abs(jh - th.numpy()).sum() <= 2 * dis
    # K1's histogram is K4d's on the same u, bitwise
    assert torch.equal(th, hist.abs_histogram(torch.from_numpy(u), block=sb))
    assert fm.fused_moments_hist.launches == 0


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("pad", [0, 7])
def test_threshold_from_histogram_is_bitwise(seed, pad):
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 5000, 128).astype(np.int64)
    h[0] += pad
    for k in (1, 50, 1000, int(h.sum()) - pad, int(h.sum()) + 10):
        jt = np.float32(jops.threshold_from_histogram(
            jnp.asarray(h, jnp.float32), k, pad))
        tt = ops.threshold_from_histogram(torch.from_numpy(h), k, pad)
        assert isinstance(tt, np.float32)
        assert tt.view(np.int32) == jt.view(np.int32), (k, tt, jt)


def test_threshold_from_histogram_counts_beyond_f32():
    """Bins above 2^24 counts: the port's int64 search stays exact."""
    h = np.zeros(128, np.int64)
    h[10] = 2 ** 24 + 1
    h[11] = 2 ** 24 + 3
    h[100] = 5
    exact = lambda k: hist.EDGES[max(  # noqa: E731
        b for b in range(128) if h[b:].sum() >= k)]
    for k in (3, 5, 6, 2 ** 24 + 3, 2 ** 24 + 8, 2 ** 24 + 9,
              2 ** 25 + 9):
        assert ops.threshold_from_histogram(torch.from_numpy(h), k) == \
            exact(k), k
    # beyond the total: bin 0's edge, as in the reference
    assert ops.threshold_from_histogram(torch.from_numpy(h), 2 ** 26) == \
        hist.EDGES[0]


@pytest.mark.parametrize("d,k", [(33, 1), (5001, 50), (70001, 70),
                                 (200_000, 2000)])
def test_histk_select_kernel_matches(d, k):
    u = _u(d, seed=3, scale=1.0)
    jt = np.float32(jops.histk_threshold(jnp.asarray(u), k, block=2048))
    tt = ops.histk_threshold(torch.from_numpy(u), k, block=2048)
    assert tt == jt
    jv, ji = jops.histk_select_kernel(jnp.asarray(u), k, block=2048)
    tv, ti = ops.histk_select_kernel(torch.from_numpy(u), k, block=2048)
    assert ti.shape[0] == ops.histk_cap(k, d) == jops.histk_cap(k, d)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
