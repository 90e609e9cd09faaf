"""The other architectures in the port (``models/moe.py``, ``ssm.py``,
``xlstm.py``, the generalised ``models/model.py``, ``embeds_batch`` and
``configs/shapes.py``) against the JAX package, on the CPU, on the
``reduced()`` variants of the assigned architectures.

Tolerances:
* ``init_params`` from the seed within rtol 1e-5 (``prng.normal``
  against ``jax.random.normal``), the same tree;
* the MoE dispatch integers (``eidx``, ``slot``, ``buf_tok``) bitwise
  given the reference's router input; ``moe_ffn``, ``mamba_forward``/
  ``mamba_decode``, ``mlstm_forward`` and ``slstm_forward`` within rtol
  1e-5 (atol 1e-6): f32 matmuls sum in another order in XLA and torch,
  and the port's selective scan runs time step by time step where the
  reference's runs an associative scan;
* loss within rtol 1e-5 and gradients within rtol 1e-4, atol 1e-6
  (``tests/test_torch_model.py``'s);
* prefill and decode logits and every cache leaf within rtol 1e-5, atol
  1e-5 (``tests/test_torch_serve.py``'s);
* ``embeds_batch`` labels bitwise, embeddings within rtol 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_prng_flag import threefry_partitionable  # noqa: F401
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import applicable as j_applicable
from repro.configs import get_config as j_get_config
from repro.configs import input_specs as j_input_specs
from repro.data.synthetic import embeds_batch as j_embeds_batch
from repro.models import decode_step as j_decode
from repro.models import init_params as j_init
from repro.models import loss_fn as j_loss
from repro.models import moe as jM
from repro.models import prefill as j_prefill
from repro.models import ssm as jS
from repro.models import xlstm as jX
from repro_torch import tree
from repro_torch.configs import (INPUT_SHAPES, applicable, get_config,
                                 input_specs, list_archs)
from repro_torch.data import batch_for, embeds_batch
from repro_torch.models import (decode_step, forward, from_jax_params,
                                init_params, loss_fn, prefill)
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X

torch.set_num_threads(2)

NEW = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b",
       "xlstm-125m", "musicgen-medium"]
ALL = list_archs()


@functools.lru_cache(maxsize=None)
def _pair(arch, seed=1):
    """(JAX config, port config, JAX params, the port's copy of them)."""
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp = j_init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)


def _tparams(np_params):
    return from_jax_params(np_params, "cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(want, got, **tol):
    tol = tol or dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


def _scale(a):
    """The largest magnitude of ``a`` (at least 1)."""
    return max(1.0, float(np.abs(np.asarray(a)).max()))


def _batch(cfg, B=2, T=16, seed=2):
    """The same numpy batch for both packages."""
    rng = np.random.default_rng(seed)
    labs = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    if cfg.frontend == "embeds":
        x = ("embeds", rng.standard_normal((B, T, cfg.d_model)).astype(
            np.float32))
    else:
        x = ("tokens", rng.integers(0, cfg.vocab_size, (B, T)).astype(
            np.int32))
    jb = {x[0]: jnp.asarray(x[1]), "labels": jnp.asarray(labs)}
    tb = {x[0]: _t(x[1]) if x[0] == "embeds" else _t(x[1]).long(),
          "labels": _t(labs).long()}
    return jb, tb


@pytest.mark.parametrize("arch", NEW)
def test_init_params_matches_reference(arch):
    """``--seed`` alone gives the reference's weights and tree: the MoE
    stacks' fan-in ``E``, ``conv_w``'s scale ``1/W``, ``A_log``,
    ``dt_bias``, ``bf`` and the 5/6/7/9-way key splits."""
    jp = j_init(j_get_config(arch).reduced(), jax.random.PRNGKey(3))
    tp = init_params(get_config(arch).reduced(), 3, "cpu")
    jl = jax.tree_util.tree_flatten_with_path(jp)[0]
    tl = tree.flatten_with_path(tp)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [
        "".join(f"[{k!r}]" for k in p) for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=0, err_msg=jax.tree_util.keystr(p))


def _jax_dispatch(eidx, E, C):
    """The reference's dispatch integers (``moe.py:66-79``, verbatim)."""
    N, K = eidx.shape
    flat_e = eidx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = jnp.searchsorted(sorted_e, jnp.arange(E))
    pos_in_e = jnp.arange(N * K) - seg_start[sorted_e]
    keep = pos_in_e < C
    slot = jnp.where(keep, sorted_e * C + pos_in_e, E * C)
    token_of = order // K
    buf_tok = jnp.full((E * C + 1,), N, jnp.int32).at[slot].set(
        token_of.astype(jnp.int32), mode="drop")[: E * C]
    return order, slot, buf_tok


@pytest.mark.parametrize("case", ["deepseek", "phi", "overflow"])
def test_moe_ffn_matches_reference(case):
    """Routing and the sort-based dispatch bitwise the reference's
    (``overflow``: capacity factor 0.5, so experts overflow into the
    scratch slot); the output and the aux loss within rtol 1e-5, and the
    gradients of both within rtol 1e-4.  The expert stacks' fan-in is
    ``E`` (the reference's ``_dense_init``), so the outputs reach
    hundreds and the sums of products cancel: the absolute tolerance is
    1e-6 of the array's largest magnitude (at least 1)."""
    arch = "phi3.5-moe-42b-a6.6b" if case == "phi" else "deepseek-moe-16b"
    over = {"capacity_factor": 0.5} if case == "overflow" else {}
    jcfg = j_get_config(arch).reduced(**over)
    tcfg = get_config(arch).reduced(**over)
    jp = jM.init_moe(jax.random.PRNGKey(4), jcfg, jnp.float32)
    tp = _tparams(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(5).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32)
    N, E, K = 32, jcfg.num_experts, jcfg.experts_per_token
    C = jM.capacity(N, jcfg)
    assert M.capacity(N, tcfg) == C

    probs = jax.nn.softmax((x.reshape(N, -1) @ jp["router"]).astype(
        jnp.float32), axis=-1)
    _, jeidx = jax.lax.top_k(probs, K)
    _, teidx, _ = M.route(tp, _t(x).reshape(N, -1), tcfg)
    np.testing.assert_array_equal(teidx.numpy(), np.asarray(jeidx))
    order, slot, buf_tok = _jax_dispatch(jeidx, E, C)
    got = M.dispatch(teidx, C, E)
    np.testing.assert_array_equal(got["order"].numpy(), np.asarray(order))
    np.testing.assert_array_equal(got["slot"].numpy(), np.asarray(slot))
    np.testing.assert_array_equal(got["buf_tok"].numpy(),
                                  np.asarray(buf_tok))
    dropped = int((np.asarray(slot) == E * C).sum())
    assert (dropped > 0) == (case == "overflow"), dropped

    def j_fn(p, xx):
        out, aux = jM.moe_ffn(p, xx, jcfg)
        return jnp.sum(out * jnp.cos(xx)) + aux, (out, aux)

    (_, (jout, jaux)), jg = jax.value_and_grad(j_fn, argnums=(0, 1),
                                               has_aux=True)(jp, x)
    leaves, td = tree.flatten(tp)
    ps = [p.requires_grad_(True) for p in leaves]
    xt = _t(x).requires_grad_(True)
    tout, taux = M.moe_ffn(tree.unflatten(td, ps), xt, tcfg)
    grads = torch.autograd.grad(torch.sum(tout * torch.cos(xt)) + taux,
                                ps + [xt])
    _close(jout, tout, rtol=1e-5, atol=1e-6 * _scale(jout))
    _close(jaux, taux)
    for a, b in zip(jax.tree.leaves(jg), grads):
        _close(a, b, rtol=1e-4, atol=1e-6 * _scale(a))


@pytest.mark.parametrize("T", [16, 256])
def test_mamba_matches_reference(T):
    """``mamba_forward`` (T = 256: two chunks of 128) and then four
    ``mamba_decode`` steps from its state: outputs, SSM states and conv
    buffers within rtol 1e-5, atol 1e-6."""
    jcfg = j_get_config("jamba-1.5-large-398b").reduced()
    tcfg = get_config("jamba-1.5-large-398b").reduced()
    jp = jS.init_mamba(jax.random.PRNGKey(6), jcfg, jnp.float32)
    tp = _tparams(jax.tree.map(np.asarray, jp))
    x = 0.5 * np.random.default_rng(7).standard_normal(
        (2, T + 4, jcfg.d_model)).astype(np.float32)
    jy, jh, jtail = jS.mamba_forward(jp, x[:, :T], jcfg)
    ty, th, ttail = S.mamba_forward(tp, _t(x[:, :T]), tcfg)
    for a, b in ((jy, ty), (jh, th), (jtail, ttail)):
        assert a.shape == tuple(b.shape)
        _close(a, b)
    W = jcfg.ssm_conv_width
    jconv = jnp.zeros((2, W, jcfg.d_inner)).at[:, 1:].set(jtail)
    tconv = torch.zeros((2, W, tcfg.d_inner))
    tconv[:, 1:] = ttail
    for t in range(T, T + 4):
        jy, jh, jconv = jS.mamba_decode(jp, x[:, t:t + 1], jh, jconv, jcfg)
        ty, th, tconv = S.mamba_decode(tp, _t(x[:, t:t + 1]), th, tconv,
                                       tcfg)
        for a, b in ((jy, ty), (jh, th), (jconv, tconv)):
            _close(a, b)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_matches_reference(kind):
    """``mlstm_forward``/``slstm_forward`` over 16 steps, then 2 more
    from the returned state (the decode path): outputs and states within
    rtol 1e-5, atol 1e-6."""
    jcfg = j_get_config("xlstm-125m").reduced()
    tcfg = get_config("xlstm-125m").reduced()
    j_init_fn, j_fwd = {"mlstm": (jX.init_mlstm, jX.mlstm_forward),
                        "slstm": (jX.init_slstm, jX.slstm_forward)}[kind]
    t_fwd = {"mlstm": X.mlstm_forward, "slstm": X.slstm_forward}[kind]
    jp = j_init_fn(jax.random.PRNGKey(8), jcfg, jnp.float32)
    tp = _tparams(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(9).standard_normal(
        (2, 18, jcfg.d_model)).astype(np.float32)
    jy, js = j_fwd(jp, x[:, :16], jcfg)
    ty, ts = t_fwd(tp, _t(x[:, :16]), tcfg)
    _close(jy, ty)
    assert sorted(js) == sorted(ts)
    for k in js:
        _close(js[k], ts[k])
    for t in (16, 17):
        jy, js = j_fwd(jp, x[:, t:t + 1], jcfg, state=js)
        ty, ts = t_fwd(tp, _t(x[:, t:t + 1]), tcfg, state=ts)
        _close(jy, ty)
        for k in js:
            _close(js[k], ts[k])


@pytest.mark.parametrize("arch", ALL)
def test_loss_and_grads_match_reference(arch):
    """Every assigned architecture's reduced variant: loss (cross-entropy
    plus the MoE aux loss) within rtol 1e-5, every gradient within rtol
    1e-4, atol 1e-6 (an ``embeds`` model's ``embed`` gradient is zero, as
    under ``jax.grad``)."""
    jcfg, tcfg, jp, npp = _pair(arch)
    jb, tb = _batch(jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: j_loss(p, jcfg, jb, remat=False), has_aux=True))(jp)
    leaves, td = tree.flatten(_tparams(npp))
    ps = [p.requires_grad_(True) for p in leaves]
    tl, tm = loss_fn(tree.unflatten(td, ps), tcfg, tb)
    grads = torch.autograd.grad(tl, ps, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"].detach()), float(jm["aux"]),
                               rtol=1e-5, atol=1e-7)
    has_moe = "moe" in jcfg.ffn_pattern
    assert (float(tm["aux"].detach()) > 0) == has_moe
    names = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(jg)[0]]
    for name, a, p, g in zip(names, jax.tree.leaves(jg), ps, grads):
        if g is None:
            g = torch.zeros_like(p)
        if jcfg.frontend == "embeds" and name == "['embed']":
            assert not np.asarray(a).any() and not g.any()
        np.testing.assert_allclose(g.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def _cache_names(jc):
    return ["/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                     for e in p)
            for p, _ in jax.tree_util.tree_flatten_with_path(jc)[0]]


@pytest.mark.parametrize("arch", ALL)
def test_prefill_and_decode_match_reference(arch):
    """Prompt 8 (tokens, or embeddings for an ``embeds`` model), ``s_max``
    12, then 4 decode steps of tokens: logits and every cache leaf (KV,
    ring, Mamba ``ssm``/``conv``, xLSTM states) within rtol 1e-5, atol
    1e-5; the cache tree the reference's; decode updates the cache in
    place and returns it."""
    jcfg, tcfg, jp, npp = _pair(arch)
    tp = _tparams(npp)
    jb, tb = _batch(jcfg, T=12, seed=3)
    nxt = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    T, s_max = 8, 12
    kw = "embeds" if jcfg.frontend == "embeds" else "tokens"
    jl, jc, jn = j_prefill(jp, jcfg, s_max=s_max, **{kw: jb[kw][:, :T]})
    tl, tc, tn = prefill(tp, tcfg, s_max=s_max, **{kw: tb[kw][:, :T]})
    assert tn == jn == T and tuple(tl.shape) == jl.shape
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(jl, tl, **tol)
    assert [tree.path_name(p) for p, _ in tree.flatten_with_path(tc)[0]] \
        == _cache_names(jc)
    for a, b in zip(jax.tree.leaves(jc), tree.leaves(tc)):
        assert a.shape == tuple(b.shape) and str(a.dtype) == str(
            b.dtype).replace("torch.", "")
        _close(a, b, **tol)
    ptrs = [x.data_ptr() for x in tree.leaves(tc)]
    if kw == "tokens":
        nxt = tb["tokens"].numpy()
    for pos in range(T, s_max):
        tok = nxt[:, pos:pos + 1]
        jl, jc = j_decode(jp, jcfg, jc, jnp.int32(pos),
                          tokens=jnp.asarray(tok))
        tl, tc2 = decode_step(tp, tcfg, tc, pos, _t(tok).long())
        assert tc2 is tc
        _close(jl, tl, err_msg=f"pos {pos}", **tol)
        for a, b in zip(jax.tree.leaves(jc), tree.leaves(tc)):
            _close(a, b, err_msg=f"cache at pos {pos}", **tol)
    assert [x.data_ptr() for x in tree.leaves(tc)] == ptrs


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-125m",
                                  "musicgen-medium"])
def test_decode_matches_forward(arch):
    """The port alone, as ``tests/test_consistency.py``: prefill 14
    positions, decode two more — the logits are the full forward's at
    those positions (rtol 1e-4, atol 1e-5); the decoded inputs are
    tokens, or for an ``embeds`` model embeddings."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, 0, "cpu")
    b = batch_for(cfg, 0, global_batch=2, seq_len=16, device="cpu")
    kw = "embeds" if cfg.frontend == "embeds" else "tokens"
    x = b[kw]
    with torch.no_grad():
        full = forward(params, cfg, **{kw: x})
    last, cache, _ = prefill(params, cfg, s_max=16, **{kw: x[:, :14]})
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, 13].numpy(),
                               **tol)
    for p in (14, 15):
        logits, cache = decode_step(params, cfg, cache, p,
                                    **{kw: x[:, p:p + 1]})
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, p].numpy(),
                                   err_msg=f"pos {p}", **tol)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5)])
def test_embeds_batch_matches_reference(seed, step):
    """``fold_in(PRNGKey(seed), step)`` then ``split``: labels bitwise,
    embeddings within rtol 1e-5; ``batch_for`` takes it for an ``embeds``
    frontend."""
    kw = dict(global_batch=3, seq_len=7, d_model=40, vocab=2048, seed=seed)
    want = j_embeds_batch(step, **kw)
    got = embeds_batch(step, device="cpu", **kw)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    assert got["labels"].dtype == torch.int64
    np.testing.assert_allclose(got["embeds"].numpy(),
                               np.asarray(want["embeds"]), rtol=1e-5,
                               atol=1e-6)
    cfg = get_config("musicgen-medium").reduced()
    b = batch_for(cfg, step, global_batch=2, seq_len=5, seed=seed,
                  device="cpu")
    assert sorted(b) == ["embeds", "labels"]
    assert tuple(b["embeds"].shape) == (2, 5, cfg.d_model)


@pytest.mark.parametrize("shape", sorted(J_SHAPES))
@pytest.mark.parametrize("arch", ALL)
def test_input_specs_match_reference(arch, shape):
    """``input_specs`` gives the reference's names and shapes (meta
    tensors; tokens and labels int64 where the reference's are int32),
    and ``applicable`` the reference's verdict."""
    assert sorted(INPUT_SHAPES) == sorted(J_SHAPES)
    assert INPUT_SHAPES[shape].__dict__ == J_SHAPES[shape].__dict__
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    assert applicable(tcfg, INPUT_SHAPES[shape]) == j_applicable(
        jcfg, J_SHAPES[shape])
    want = j_input_specs(jcfg, J_SHAPES[shape])
    got = input_specs(tcfg, INPUT_SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert got[k].device.type == "meta"
        want_dt = ("int64" if spec.dtype == jnp.int32
                   else str(spec.dtype))
        assert str(got[k].dtype).replace("torch.", "") == want_dt, k
