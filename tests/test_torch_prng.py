"""``repro_torch.prng`` against ``jax.random`` (partitionable threefry,
pinned by ``_torch_prng_flag``), on the CPU: keys, integers, ``uniform``
and ``bernoulli`` bit for bit; ``normal`` within rtol 1e-5 / atol 1e-6
(torch's ``erfinv`` against XLA's f32 ``erf_inv`` polynomial: up to
~6e-6 relative on a million draws).  The ``threefry_bits`` wrapper's
chunked plain version against the unchunked one, the rank keys against
``lax.top_k``, the known answers ``chip_smoke.py`` hard-codes, and the
port's ``lm_batch`` against the reference's, token for token."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_prng_flag import threefry_partitionable  # noqa: F401
from repro.data.synthetic import lm_batch as j_lm_batch
from repro_torch import prng
from repro_torch.data.synthetic import lm_batch
from repro_torch.kernels.prng import threefry, threefry_bits
from repro_torch.kernels.prng import threefry_bits_plain

torch.set_num_threads(2)


def _kd(key):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)))


def _jkey(key):
    return jax.random.wrap_key_data(np.asarray(key, np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -1])
def test_prng_key(seed):
    assert prng.PRNGKey(seed) == _kd(jax.random.PRNGKey(seed))


@pytest.mark.parametrize("data", [0, 5, 2 ** 31 + 7, 2 ** 32 - 1])
def test_fold_in(data):
    for seed in (0, 9):
        assert prng.fold_in(prng.PRNGKey(seed), data) == _kd(
            jax.random.fold_in(jax.random.PRNGKey(seed), np.uint32(data)))


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_split(n):
    for seed in (0, 11):
        got = prng.split(prng.PRNGKey(seed), n)
        assert got == [_kd(k) for k in jax.random.split(
            jax.random.PRNGKey(seed), n)]


@pytest.mark.parametrize("shape", [(), (4,), (1000,), (3, 5, 7)])
def test_bits(shape):
    key = prng.fold_in(prng.PRNGKey(42), 3)
    want = np.asarray(jax.random.bits(_jkey(key), shape), np.int64)
    got = prng.bits(key, shape, device="cpu")
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 3.0), (0.5, 0.75),
                                   (prng.NORMAL_LO, 1.0)])
def test_uniform_bitwise(lo, hi):
    key = prng.PRNGKey(0)
    want = np.asarray(jax.random.uniform(_jkey(key), (20000,), minval=lo,
                                         maxval=hi))
    got = prng.uniform(key, (20000,), lo, hi, device="cpu").numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("lo,hi", [(0, 2), (0, 7), (0, 64), (3, 1000),
                                   (0, 1 << 16), (0, 65537), (0, 100000),
                                   (-50, 1 << 20), (0, 128256),
                                   (0, 262668288), (5, 5)])
def test_randint(lo, hi):
    key = prng.PRNGKey(7)
    want = np.asarray(jax.random.randint(_jkey(key), (3000,), lo, hi))
    got = prng.randint(key, (3000,), lo, hi, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert prng.randint_scalar(key, lo, hi) == int(
        jax.random.randint(_jkey(key), (), lo, hi))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_bernoulli(p):
    key = prng.PRNGKey(3)
    want = np.asarray(jax.random.bernoulli(_jkey(key), p, (50, 41)))
    got = prng.bernoulli(key, p, (50, 41), device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_normal_within_tolerance():
    for seed in (0, 1):
        key = prng.PRNGKey(seed)
        want = np.asarray(jax.random.normal(_jkey(key), (200000,)))
        got = prng.normal(key, (200000,), device="cpu").numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_known_answers():
    """The partitionable column chip_smoke.py checks on the card."""
    k = prng.PRNGKey(0)
    assert prng.split(k, 3)[1] == (928981903, 3453687069)
    assert prng.fold_in(k, 5) == (1524306142, 1887795613)
    assert prng.bits(prng.PRNGKey(42), (4,), device="cpu").tolist() == [
        2098992034, 2919706841, 2646866425, 2409546199]
    assert prng.randint(prng.PRNGKey(7), (4,), 0, 262668288,
                        device="cpu").tolist() == [10325791, 133713254,
                                                   116150652, 246431725]
    u = prng.uniform(k, (3,), device="cpu").numpy()
    np.testing.assert_array_equal(u, np.asarray(
        jax.random.uniform(jax.random.PRNGKey(0), (3,))))
    np.testing.assert_allclose(u, [0.9476670, 0.9785799, 0.3322915],
                               rtol=0, atol=5e-8)


@pytest.mark.parametrize("chunk", [1, 1000, 4096, 1 << 22])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_plain_equals_chunked(monkeypatch, chunk, dtype):
    """The wrapper's CPU path hashes ``CHUNK`` counters at a time; any
    chunking gives the one-piece plain version's values."""
    monkeypatch.setattr(threefry, "CHUNK", chunk)
    key = (0x9E3779B9, 12345)
    n = 10007 if chunk > 1 else 300
    out = torch.empty(n, dtype=dtype)
    threefry_bits(key, out)
    want = threefry_bits_plain(key, 0, n, rank=dtype == torch.int64)
    assert torch.equal(out, want)
    # a counter offset continues the same stream
    assert torch.equal(threefry_bits_plain(key, 17, n - 17,
                                           rank=dtype == torch.int64),
                       want[17:])


def test_threefry_bits_checks_its_output():
    with pytest.raises(ValueError, match="int32"):
        threefry_bits((0, 1), torch.empty(4, dtype=torch.float32))
    with pytest.raises(ValueError, match="1-D"):
        threefry_bits((0, 1), torch.empty(2, 2, dtype=torch.int32))


@pytest.mark.parametrize("n,k", [(5000, 300), (200000, 20000), (7, 7)])
def test_rank_keys_order_as_lax_top_k(n, k):
    """Equal uniforms put the lower index first: 200,000 draws of 2^23
    values hold thousands of ties."""
    key = prng.fold_in(prng.PRNGKey(1), n)
    u = prng.uniform(key, (n,), device="cpu")
    _, want = jax.lax.top_k(jnp.asarray(u.numpy()), k)
    got = torch.topk(prng.rank_keys(key, n, device="cpu"), k).indices
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,step,B,S,V", [
    (0, 0, 4, 16, 64), (3, 17, 8, 128, 128256), (-1, 2 ** 31 + 5, 2, 5, 7),
    (42, 1, 1, 1, 2), (0, 9, 8, 128, 64)])
def test_lm_batch_matches_reference(seed, step, B, S, V):
    want = j_lm_batch(step, global_batch=B, seq_len=S, vocab=V, seed=seed)
    got = lm_batch(step, global_batch=B, seq_len=S, vocab=V, seed=seed,
                   device="cpu")
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
