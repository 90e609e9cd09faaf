"""The threefry scheme the port follows (``repro_torch.prng``), pinned for
the tests that compare it with ``jax.random``: the partitionable scheme,
jax's default from 0.5 on.  Importing :func:`threefry_partitionable`
into a test module switches it on for that module and restores the old
value after."""
import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def threefry_partitionable():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)
