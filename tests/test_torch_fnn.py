"""The paper's FNN-3 and its data on the port against the JAX package:
``init_fnn`` bit for bit (``prng.uniform`` is the reference's draw);
forward, loss, accuracy and gradients from converted params within rtol
1e-5 (f32 matmuls sum in another order); ``mnist_like``'s labels exactly
and its inputs within ``prng.normal``'s rtol 1e-5 of each term; the
``FNN3`` config; and the LM's ``init_params(cfg, seed)`` within rtol
1e-5 of ``repro.models.init_params(cfg, PRNGKey(seed))``, leaf for leaf
(``_dense_init``'s ``normal`` draws)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_prng_flag import threefry_partitionable  # noqa: F401
from repro.configs import get_config as j_get_config
from repro.configs.paper_fnn3 import FNN3 as J_FNN3
from repro.data.synthetic import mnist_like as j_mnist_like
from repro.models import init_params as j_init_params
from repro.models.fnn import fnn_forward as j_forward
from repro.models.fnn import fnn_loss as j_loss
from repro.models.fnn import init_fnn as j_init_fnn
from repro_torch import prng, tree
from repro_torch.configs import get_config
from repro_torch.configs.paper_fnn3 import FNN3
from repro_torch.data import mnist_like
from repro_torch.models import init_params
from repro_torch.models.fnn import (fnn_forward, fnn_loss, from_jax_fnn,
                                    init_fnn)

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 7])
def test_init_fnn_bitwise(seed):
    jp = j_init_fnn(jax.random.PRNGKey(seed))
    tp = init_fnn(prng.PRNGKey(seed), device="cpu")
    jl, tl = jax.tree.leaves(jp), tree.leaves(tp)
    # jax.tree.flatten's order: b0, w0, b1, w1, ...
    assert [tuple(x.shape) for x in jl] == [tuple(x.shape) for x in tl]
    assert tuple(tl[1].shape) == (784, 128)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _batch(seed, n=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 784)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


@pytest.mark.parametrize("seed", [1, 2])
def test_forward_loss_and_grads_match_reference(seed):
    jp = j_init_fnn(jax.random.PRNGKey(seed))
    x, y = _batch(seed)
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    (jl, jm), jg = jax.value_and_grad(j_loss, has_aux=True)(jp, jb)
    tp = from_jax_fnn(jax.tree.map(np.asarray, jp), "cpu")
    leaves = tree.leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()}
    np.testing.assert_allclose(
        fnn_forward(tp, tb["x"]).detach().numpy(),
        np.asarray(j_forward(jp, jb["x"])), rtol=1e-5, atol=1e-6)
    tl, tm = fnn_loss(tp, tb)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(tm["acc"]) == float(jm["acc"])
    for a, b in zip(jax.tree.leaves(jg), tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("seed", [0, 17])
@pytest.mark.parametrize("step", [0, 5])
def test_mnist_like_matches_reference(seed, step):
    jb = j_mnist_like(step, batch=64, seed=seed)
    tb = mnist_like(step, batch=64, seed=seed, device="cpu")
    np.testing.assert_array_equal(tb["y"].numpy(), np.asarray(jb["y"]))
    # x = means[y] + 0.8 * noise: each normal term within rtol 1e-5
    means = np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                         (10, 784)))
    jx = np.asarray(jb["x"])
    terms = np.abs(means[np.asarray(jb["y"])]) + np.abs(
        jx - means[np.asarray(jb["y"])])
    assert np.all(np.abs(tb["x"].numpy() - jx) <= 1e-5 * terms + 1e-7)
    assert tb["x"].dtype == torch.float32 and tuple(tb["x"].shape) == (
        64, 784)


def test_fnn3_config_is_the_references():
    assert FNN3 == J_FNN3


@pytest.mark.parametrize("arch,seed", [("llama3.2-1b", 0),
                                       ("llama3.2-1b", 5),
                                       ("gemma3-4b", 1)])
def test_init_params_matches_reference(arch, seed):
    """``--seed`` alone gives the reference's LM weights: the key tree of
    ``split(key, 3)``, a key a layer, a key a weight matrix."""
    jp = j_init_params(j_get_config(arch).reduced(),
                       jax.random.PRNGKey(seed))
    tp = init_params(get_config(arch).reduced(), seed, "cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = tree.flatten_with_path(tp)[0]
    assert len(jl) == len(tl)
    for (jpath, a), (tpath, b) in zip(jl, tl):
        assert jax.tree_util.keystr(jpath) == "".join(
            f"[{k!r}]" for k in tpath)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=0)


@pytest.mark.parametrize("entry", ["init_fnn", "mnist_like"])
def test_paper_entry_points_default_to_the_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"init_fnn": lambda: init_fnn(prng.PRNGKey(0)),
            "mnist_like": lambda: mnist_like(0, batch=2)}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
