"""The port's compressor registry, EF dispatch and compression config
against ``repro.core``.

* ``topk``: exact, bitwise, including lax.top_k's lower-index-first tie
  order (``torch.topk`` alone breaks ties otherwise).
* ``gaussiank``/``gaussiank2`` reference selection: threshold within
  rtol 1e-5 (population std and ppf computed by different libraries);
  the selected pair bitwise when the thresholds agree to the bit.
* ``trimmedk``: threshold within rtol 1e-6 (``mean(|u|)`` is summed in
  another order), and the test checks that no element lies within that
  tolerance of it, so the selections are equal; ``histk`` through the
  registry bitwise (its kernels are held in ``test_torch_histk.py``).
* ``compress_with_ef`` conserves bitwise on both backends.
* The key-sampled ``randk``, ``dgck`` and ``rtopk`` are registered with
  the reference's caps (their selections are held in
  ``test_torch_keyed.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jc
from repro.core import error_feedback as jef
from repro.core.compression import CompressionConfig as JCompressionConfig
from repro_torch.core import codec
from repro_torch.core import compressors as tc
from repro_torch.core.adaptk import make_policy
from repro_torch.core.compression import CompressionConfig, as_config
from repro_torch.core.error_feedback import compress_with_ef

torch.set_num_threads(2)


def test_topk_tie_order_matches_lax():
    u = np.array([3, 1, 3, 2, 3], np.float32)
    jv, ji = jc.topk_select(jnp.asarray(u), 2)
    tv, ti = tc.topk_select(torch.from_numpy(u), 2)
    assert ti.tolist() == np.asarray(ji).tolist() == [0, 2]
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("d,k", [(10, 3), (1000, 10), (4097, 41)])
def test_topk_matches(d, k):
    rng = np.random.default_rng(d)
    u = np.round(rng.standard_normal(d), 1).astype(np.float32)  # many ties
    jv, ji = jc.topk_select(jnp.asarray(u), k)
    tv, ti = tc.topk_select(torch.from_numpy(u), k)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("two_sided", [False, True])
@pytest.mark.parametrize("d,k", [(100, 1), (5000, 50), (65537, 66)])
def test_gaussiank_reference_matches(d, k, two_sided):
    rng = np.random.default_rng(d + two_sided)
    u = (rng.standard_normal(d) * 0.01 + 0.001).astype(np.float32)
    jt = float(jc.gaussian_threshold(jnp.asarray(u), k, 4, two_sided))
    tt = float(tc.gaussian_threshold(torch.from_numpy(u), k, 4, two_sided))
    np.testing.assert_allclose(tt, jt, rtol=1e-5)
    name = "gaussiank2" if two_sided else "gaussiank"
    jv, ji = jc.get_compressor(name).select(jnp.asarray(u), k, None)
    tv, ti = tc.get_compressor(name).select(torch.from_numpy(u), k, None)
    assert ti.shape[0] == jc.gaussiank_cap(k, d) == tc.gaussiank_cap(k, d)
    if tt == jt:
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("backend", ["fused", "reference"])
@pytest.mark.parametrize("name", ["gaussiank", "gaussiank2", "topk",
                                  "histk", "trimmedk"])
def test_compress_with_ef_conserves(name, backend):
    if backend == "fused" and name in ("topk", "trimmedk"):
        with pytest.raises(ValueError, match="no fused pipeline"):
            compress_with_ef(torch.zeros(4), tc.get_compressor(name), 1,
                             e=torch.zeros(4), backend=backend)
        return
    rng = np.random.default_rng(7)
    g = torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
    e = torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
    v, i, r = compress_with_ef(g, tc.get_compressor(name), 30, e=e,
                               backend=backend)
    assert torch.equal(codec.decode(v, i, 3000) + r, g + e)
    assert bool(jef.resolve_backend(backend, jc.get_compressor(name))) == \
        (backend == "fused")


@pytest.mark.parametrize("name,slice_no", [
    ("randk", "slice 4"), ("dgck", "slice 4"), ("rtopk", "slice 4")])
def test_later_compressors_name_their_slice(name, slice_no):
    """Slice 4 has landed: the key-sampled compressors are registered as
    the reference registers them (``needs_key``, the same caps), and no
    later slice is named for them."""
    from repro_torch.slices import LATER
    j, t = jc.get_compressor(name), tc.get_compressor(name)
    assert t.name == name and t.needs_key and j.needs_key
    for k, d in ((1, 1), (3, 10), (10, 1000), (64, 64), (50, 20)):
        assert t.k_cap(k, d) == j.k_cap(k, d)
    assert name not in LATER
    assert not any(slice_no in v and name in v for v in LATER.values())


@pytest.mark.parametrize("name", ["randk", "dgck", "rtopk"])
def test_config_names_the_slice_of_later_compressors(name):
    """A config of a key-sampled compressor now builds (the port refuses
    no config field since slice 6); its spec is the registry's."""
    cfg = CompressionConfig(compressor=name)
    assert cfg.spec is tc.get_compressor(name) and cfg.spec.needs_key


def test_registry_and_unknown_name():
    assert tc.available() == ["dgck", "gaussiank", "gaussiank2", "histk",
                              "randk", "rtopk", "topk", "trimmedk"]
    assert set(tc.available()) == set(jc.available())
    with pytest.raises(KeyError):
        tc.get_compressor("nope")


@pytest.mark.parametrize("d,k", [(10, 3), (1000, 10), (5001, 50),
                                 (65537, 66)])
def test_trimmedk_matches(d, k):
    """Threshold within rtol 1e-6 (``mean(|u|)`` sums in another order);
    no element lies within that tolerance of it, so the selections are
    equal."""
    rng = np.random.default_rng(d + 1)
    u = (rng.standard_normal(d) * 0.01 + 0.001).astype(np.float32)
    abs_u = np.abs(u)
    # the reference's bisection, replayed in numpy f32 to read its threshold
    lo, hi = np.float32(np.asarray(jnp.mean(jnp.asarray(abs_u)))), \
        abs_u.max()
    k_f = np.float32(k)
    for _ in range(16):
        mid = np.float32(0.5) * (lo + hi)
        est = np.float32((abs_u > mid).sum())
        lo = mid if est > np.float32(1.25) * k_f else lo
        hi = mid if est < k_f else hi
    t_port = tc.trimmed_threshold(torch.from_numpy(u), k)
    assert t_port.dtype == torch.float32
    np.testing.assert_allclose(float(t_port), float(lo), rtol=1e-6)
    assert not np.any(np.abs(abs_u - lo) <= 1e-6 * abs(float(lo)))
    jv, ji = jc.get_compressor("trimmedk").select(jnp.asarray(u), k, None)
    tv, ti = tc.get_compressor("trimmedk").select(torch.from_numpy(u), k,
                                                  None)
    assert ti.shape[0] == min(d, 2 * k) == \
        tc.get_compressor("trimmedk").k_cap(k, d)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("d,k", [(100, 1), (5001, 50), (70001, 70)])
def test_histk_registry_matches(d, k):
    rng = np.random.default_rng(d + 2)
    u = (rng.standard_normal(d) * 0.01 + 0.001).astype(np.float32)
    jv, ji = jc.get_compressor("histk").select(jnp.asarray(u), k, None)
    tv, ti = tc.get_compressor("histk").select(torch.from_numpy(u), k, None)
    assert ti.shape[0] == tc.get_compressor("histk").k_cap(k, d)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())


def test_compression_config_validation():
    assert as_config(None) == CompressionConfig()
    for bad in (dict(strategy="ring"), dict(backend="x"), dict(chunks=0),
                dict(ratio=0.0), dict(momentum_correction=1.0),
                dict(compressor="none", momentum_correction=0.5)):
        with pytest.raises(ValueError):
            CompressionConfig(**bad)
    c = CompressionConfig(compressor=None)
    assert c.dense and c.spec is None
    for strategy in ("allgather", "gtopk", "hierarchical", "hier_gtopk"):
        assert CompressionConfig(strategy=strategy).strategy == strategy
    assert CompressionConfig(codec_dtype="bfloat16").codec_dtype == \
        torch.bfloat16
    assert CompressionConfig(
        codec_dtype=torch.float16).codec_dtype == torch.float16
    with pytest.raises(ValueError, match="codec_dtype"):
        CompressionConfig(codec_dtype="int8")
    # chunks > 1 is ported (slice 6): the config carries it
    assert CompressionConfig(chunks=2).chunks == 2
    # adaptive density is ported: a DensityPolicy passes, a bare name
    # is refused as the reference refuses it
    pol = make_policy("variance")
    assert CompressionConfig(density_policy=pol).adaptive
    with pytest.raises(TypeError, match="DensityPolicy"):
        CompressionConfig(density_policy="variance")
    with pytest.raises(TypeError) as jerr:
        JCompressionConfig(density_policy="variance")
    with pytest.raises(TypeError) as terr:
        CompressionConfig(density_policy="variance")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(TypeError):
        as_config("gaussiank")
