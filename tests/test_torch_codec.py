"""The port's sparse codec against ``repro.core.codec``, bitwise.

Every comparison is exact (``assert_array_equal`` on the raw values):
the codec only moves and adds f32 values, and on the CPU both packages
add duplicates in slot order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro_torch.core import codec as tcodec

torch.set_num_threads(2)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


@pytest.mark.parametrize("d,k_cap,density", [
    (1, 1, 1.0), (37, 8, 0.1), (257, 16, 0.5),   # 0.5: heavy overflow
    (1000, 64, 0.0), (1000, 1000, 0.3)])
def test_compact_by_mask(d, k_cap, density):
    rng = np.random.default_rng(d + k_cap)
    u = rng.standard_normal(d).astype(np.float32)
    mask = rng.random(d) < density
    jv, ji = jcodec.compact_by_mask(jnp.asarray(u), jnp.asarray(mask), k_cap)
    tv, ti = tcodec.compact_by_mask(torch.from_numpy(u),
                                    torch.from_numpy(mask), k_cap)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert ti.dtype == torch.int32


def _pair(rng, k, d, sentinel_frac, dup):
    idx = rng.integers(0, d, k).astype(np.int32)
    if dup:
        idx[: k // 2] = idx[0]            # one coordinate named many times
    idx[rng.random(k) < sentinel_frac] = tcodec.SENTINEL
    vals = rng.standard_normal(k).astype(np.float32)
    vals[idx == tcodec.SENTINEL] = 0.0
    return vals, idx


@pytest.mark.parametrize("sentinel_frac,dup", [
    (0.0, False), (0.3, False), (1.0, False), (0.2, True), (0.0, True)])
def test_decode_and_decode_add(sentinel_frac, dup):
    rng = np.random.default_rng(int(sentinel_frac * 10) + dup)
    d, k = 97, 40
    vals, idx = _pair(rng, k, d, sentinel_frac, dup)
    jv, tv = _both(vals)
    ji, ti = _both(idx)
    np.testing.assert_array_equal(np.asarray(jcodec.decode(jv, ji, d)),
                                  tcodec.decode(tv, ti, d).numpy())
    base = rng.standard_normal(d).astype(np.float32)
    jb, tb = _both(base)
    np.testing.assert_array_equal(
        np.asarray(jcodec.decode_add(jb, jv, ji)),
        tcodec.decode_add(tb, tv, ti).numpy())
    assert int(jcodec.nnz(ji)) == int(tcodec.nnz(ti))


@pytest.mark.parametrize("offset", [0, 5, 1_498_000_000])
def test_offset_indices(offset):
    idx = np.array([3, -1, 0, 7, -1], np.int32)
    ji, ti = _both(idx)
    np.testing.assert_array_equal(
        np.asarray(jcodec.offset_indices(ji, offset)),
        tcodec.offset_indices(ti, offset).numpy())


def test_roundtrip_conserves():
    """decode(compact(u, mask)) + residual == u for the port alone."""
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.standard_normal(500).astype(np.float32))
    mask = u.abs() > 1.5
    v, i = tcodec.compact_by_mask(u, mask, 20)
    dec = tcodec.decode(v, i, 500)
    resid = torch.where(dec != 0, torch.zeros_like(u), u)
    assert torch.equal(dec + resid, u)


def test_sentinel_slots_scatter_to_their_own_scratch_columns():
    """Each sentinel slot of a pair scatters to a scratch column of its
    own past ``d`` (a mostly-sentinel adaptive-density wire block must
    not pile its atomics onto one address); the real slots keep their
    indices and ``decode_sum`` of several ranks is unchanged: the
    sequential sum of the ranks' decodes, bitwise."""
    idx = torch.tensor([4, -1, 0, -1, -1, 9], dtype=torch.int32)
    vals = torch.tensor([1.5, 0.0, -2.0, 0.0, 0.0, 3.0])
    safe, v = tcodec._safe(vals, idx, 10)
    assert safe.tolist() == [4, 11, 0, 13, 14, 9]
    assert len(set(safe[idx == -1].tolist())) == 3
    assert torch.equal(v, vals)
    rng = np.random.default_rng(4)
    n, k, d = 3, 6, 12
    V = torch.from_numpy(rng.standard_normal((n, 1, k)).astype(np.float32))
    I = torch.stack([torch.from_numpy(np.concatenate([
        rng.choice(d, 4, replace=False), [-1, -1]]).astype(np.int32))[None]
        for _ in range(n)])
    V = torch.where(I == -1, torch.zeros_like(V), V)
    want = torch.zeros(d)
    for r in range(n):
        want = want + tcodec.decode(V[r, 0], I[r, 0], d)
    assert torch.equal(tcodec.decode_sum(V, I, d)[0], want)
