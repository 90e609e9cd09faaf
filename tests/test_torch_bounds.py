"""The contraction bounds of §3.2 on the port against
``repro.core.bounds``: the scalar bounds equal, ``gamma_exact`` (f32 and
f64) and ``pi_squared`` within 1e-6 of the reference on the same numpy
``u``, and Theorem 1's ordering exact <= paper <= classic over several
``k``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bounds as jb
from repro_torch.core import bounds

torch.set_num_threads(2)

KD = [(1, 10), (10, 1000), (500, 1000), (999, 1000), (37, 20_000)]


@pytest.mark.parametrize("k,d", KD)
def test_scalar_bounds_equal(k, d):
    assert bounds.bound_classic(k, d) == jb.bound_classic(k, d)
    assert bounds.bound_paper(k, d) == jb.bound_paper(k, d)
    assert bounds.delta_paper(k, d) == jb.delta_paper(k, d)


@pytest.mark.parametrize("c", [1.0, 2.5, 40.0])
@pytest.mark.parametrize("paper", [False, True])
def test_iterations_to_dense_rate_equal(c, paper):
    assert (bounds.iterations_to_dense_rate(c, paper)
            == jb.iterations_to_dense_rate(c, paper))


def _u(seed, d=20_000):
    return np.random.default_rng(seed).standard_normal(d)


@pytest.mark.parametrize("k", [1, 10, 1000, 19_999])
def test_gamma_exact_f32(k):
    u = _u(k).astype(np.float32)
    got = bounds.gamma_exact(torch.from_numpy(u), k)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got),
                               float(jb.gamma_exact(jnp.asarray(u), k)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 10, 1000, 19_999])
def test_gamma_exact_f64(k):
    u = _u(k + 1)
    got = bounds.gamma_exact(torch.from_numpy(u), k)
    assert got.dtype == torch.float64
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        want = jb.gamma_exact(jnp.asarray(u), k)
        assert want.dtype == jnp.float64
        want = float(want)
    finally:
        jax.config.update("jax_enable_x64", old)
    np.testing.assert_allclose(float(got), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_pi_squared(seed):
    u = _u(seed, 5000).astype(np.float32)
    np.testing.assert_allclose(
        bounds.pi_squared(torch.from_numpy(u)).numpy(),
        np.asarray(jb.pi_squared(jnp.asarray(u))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_theorem1_ordering(dtype):
    """exact <= (1 - k/d)^2 <= 1 - k/d on a Gaussian vector, every k."""
    d = 20_000
    u = torch.from_numpy(_u(3, d)).to(dtype)
    for k in (1, 10, 100, 1000, 5000, 10_000, 19_000):
        exact = float(bounds.gamma_exact(u, k))
        assert exact <= bounds.bound_paper(k, d) + 1e-6
        assert bounds.bound_paper(k, d) <= bounds.bound_classic(k, d)
