"""bf16 operands through the port's EF pipelines, its kernels' plain
versions, the bucketed wire and the train state, on the CPU, against the
JAX package.

Oracles:

* The fused pipeline (``fused_compress_ef``, ``fused_pass_a``) against
  the reference's FUSED SHAPE, ``backend="mosaic"`` (``g`` and ``e``
  streamed unsummed, ``u = f32(g) + f32(e)`` selected on in f32, ``e'``
  written in ``result_type(g, e)``), at one explicit geometry (block
  2048, stats block 8192, bcap 64): the geometry decides which elements
  reach the wire when a block overflows its staging.  Never the
  reference's interpret default: at bf16/bf16 it rounds ``u`` to bf16
  before selecting and picks other elements (ROADMAP, reference
  caveats).  Indices, integer outputs, and ``values`` and ``e'`` in
  their dtype are held bitwise (bf16 compared as its 16-bit pattern);
  the moments within reassociation (``s`` within ``1e-5·Σ|u|``, ``sq``
  within rtol 1e-5, absmax exact), the histograms exact.
* The unfused pipeline against the reference's ``unfused_compress_ef``
  (which forms ``u`` in the promoted dtype), bitwise.
* K4a-K4d's plain versions at bf16 against the reference's Pallas
  kernels in interpret mode (the reference's own bf16 cases,
  ``tests/test_kernels.py`` ``DTYPES``): sums within reassociation,
  counts, staging rows and histograms exact.
* The kernel configuration's dtype axis (``config_key``, the heuristic,
  the candidate grid) against the reference's ``tuning``: the card's
  as its GPU lowering's, the CPU's as its interpret floor's.
* ``bucket_compress`` on a bf16 bucket against the reference's fused
  ``bucket_compress`` under ``use_backend("mosaic")``, both at the
  mosaic heuristic's geometry (the port's card heuristic, taken through
  ``tuning.geometry_of("cuda")`` with no table), bitwise.
* ``init_train_state(resid_dtype=, with_residual=)`` against the
  reference's state: keys, shapes and dtypes.
* ``from_jax_params`` / ``to_numpy_tree`` on a bf16 tree: bits out equal
  bits in.
* The bf16 train step of llama3.2-1b ``.reduced()`` (bf16 params and
  activations, a bf16 residual, fused Gaussian-k, mesh (1, 1)) against
  the reference's step composed from its public functions, as
  ``tests/test_torch_train.py`` composes it.  See that test's docstring
  for why not the reference's ``make_train_step`` and for the
  tolerance.
* The per-leaf loop with bf16 leaves and an f32 residual (the mixed
  pair), the chunked schedule on a bf16 bucket, and two workers on
  ``LocalWire`` and on ``ProcessGroupWire`` over gloo
  (``tests/_torch_bf16_pg.py``): each bitwise the port's own bucketed
  run.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bf16_pg import run_steps
from _torch_steps import flat
from repro.configs import get_config as j_get_config
from repro.core import codec as jcodec
from repro.core.compression import CompressionConfig as JCompression
from repro.core.compressors import get_compressor as j_get
from repro.data.synthetic import batch_for as j_batch_for
from repro.dist import aggregate as jagg
from repro.dist import layout as jl
from repro.kernels.ef_fused import ops as jops
from repro.kernels.ef_fused import tuning as jtuning
from repro.kernels.gaussian_topk.count_gt import count_gt as j_count
from repro.kernels.gaussian_topk.threshold_compact import \
    threshold_compact as j_compact
from repro.kernels.histk.hist import abs_histogram as j_hist
from repro.kernels.moments.moments import moments as j_moments
from repro.models import init_params as j_init
from repro.models import loss_fn as j_loss
from repro.optim import sgd_momentum as j_sgd
from repro.train import init_train_state as j_state
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import codec
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.compressors import get_compressor
from repro_torch.dist import aggregate as tagg
from repro_torch.dist.layout import build_layout
from repro_torch.dist.wire import LocalWire
from repro_torch.kernels.ef_fused import fused_moments as fm
from repro_torch.kernels.ef_fused import ops, tuning
from repro_torch.kernels.gaussian_topk import count_gt as cg
from repro_torch.kernels.gaussian_topk import threshold_compact as thc
from repro_torch.kernels.histk import hist
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models import from_jax_params, to_numpy_tree
from repro_torch.optim import constant, sgd_momentum
from repro_torch.train import init_train_state, make_train_step

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")

TORCH = {"bf16": torch.bfloat16, "f32": torch.float32}
PAIRS = [("bf16", "bf16"), ("bf16", "f32"), ("f32", "bf16"), ("bf16", None)]
PAIR_IDS = ["bf16-bf16", "bf16-f32", "f32-bf16", "bf16-none"]
FUSED = ("gaussiank", "gaussiank2", "histk")
GEOMETRY = dict(block=2048, stats_block=8192, bcap=64)


def _operands(d, gdt, edt, seed=0, overflow=False):
    """``(g, e)`` drawn in f32 with numpy and rounded to their dtypes by
    torch (round to nearest even, as XLA's cast); ``overflow`` puts 300
    large elements in the second 2048-block, beyond its staging."""
    rng = np.random.default_rng(seed + d)
    g = (0.02 * rng.standard_normal(d)).astype(np.float32)
    e = (0.01 * rng.standard_normal(d)).astype(np.float32)
    if overflow:
        g[2100:2400] = 5.0
    tg = torch.from_numpy(g).to(TORCH[gdt])
    te = None if edt is None else torch.from_numpy(e).to(TORCH[edt])
    return tg, te


def _jax(t):
    """The same bits as a jax array (bf16 through its 16-bit pattern)."""
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.uint16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _bits(x):
    """numpy bits of a jax array or a tensor: f32 as uint32, bf16 as
    uint16, integers as they are."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy()
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    if x.dtype == np.float32:
        return x.view(np.uint32)
    return x


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


def _same(jx, tx, what):
    assert _dtype_name(jx) == _dtype_name(tx), (what, jx.dtype, tx.dtype)
    np.testing.assert_array_equal(_bits(jx), _bits(tx), err_msg=what)


def _conserves(g, e, v, i, ne):
    """``decode(values, indices) + e' == g + e`` bitwise in the promoted
    dtype: torch's ``g + e`` is the f32 sum rounded once, as the kernels
    form it."""
    u = g if e is None else g + e
    assert torch.equal(codec.decode(v, i, g.shape[0]) + ne, u)


# ---------------------------------------------------------------------------
# the fused pipeline against the reference's fused shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("d", [4096, 65536])
@pytest.mark.parametrize("name", FUSED)
def test_fused_matches_reference_fused_shape(name, d, pair):
    """Values and ``e'`` come back in ``result_type(g, e)`` (bf16 for
    bf16/bf16 and bf16/None, where the port returned f32 before) and
    equal the reference's bits; the indices equal; conservation holds
    bitwise in that dtype."""
    g, e = _operands(d, *pair)
    k = d // 100
    jv, ji, je = jops.fused_compress_ef(_jax(g), _jax(e), name, k,
                                        backend="mosaic", **GEOMETRY)
    v, i, ne = ops.fused_compress_ef(g, e, name, k, **GEOMETRY)
    want = torch.promote_types(g.dtype, e.dtype) if e is not None \
        else g.dtype
    assert v.dtype == ne.dtype == want and i.dtype == torch.int32
    _same(ji, i, "indices")
    _same(jv, v, "values")
    _same(je, ne, "e'")
    _conserves(g, e, v, i, ne)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("name", FUSED)
def test_fused_overflow_matches_reference_fused_shape(name, pair):
    """A block that selects more than ``bcap`` (300 large elements in one
    2048-block, staging 64): the block keeps its lowest indices and the
    rest stay in ``e'``, bitwise the reference's; in place at bf16
    (``out=e``) as well."""
    d, k = 4096, 40
    g, e = _operands(d, *pair, seed=3, overflow=True)
    jv, ji, je = jops.fused_compress_ef(_jax(g), _jax(e), name, k,
                                        backend="mosaic", **GEOMETRY)
    u = g if e is None else g + e
    out = e if e is not None and e.dtype == u.dtype else None
    e_in = None if e is None else e.clone()
    v, i, ne = ops.fused_compress_ef(g, e_in if out is None else e, name,
                                     k, out=out, **GEOMETRY)
    if out is not None:
        assert ne.data_ptr() == e.data_ptr()
    _same(ji, i, "indices")
    _same(jv, v, "values")
    _same(je, ne, "e'")
    assert int(codec.nnz(i)) <= 64 + 64        # the two blocks' staging
    assert torch.equal(codec.decode(v, i, d) + ne, u)
    assert int((ne.float().abs() > 1.0).sum()) >= 300 - 64


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("d", [4096, 65536])
@pytest.mark.parametrize("name", FUSED)
def test_fused_pass_a_matches_reference_fused_shape(name, d, pair):
    """Pass A's moments of ``f32(g) + f32(e)`` within reassociation, the
    absmax and the histogram exact, at the stats block the port resolves
    on the CPU for ``g``'s dtype; handed back through ``stats=`` it
    gives the compression that runs its own K1, bitwise."""
    g, e = _operands(d, *pair, seed=1)
    sb = tuning.resolve_config(d, "torch", g.dtype).stats_block
    js, jsq, jmx, jh = jops.fused_pass_a(_jax(g), _jax(e), name,
                                         stats_block=sb, backend="mosaic")
    ts, tsq, tmx, th = ops.fused_pass_a(g, e, name)
    u = g.double() if e is None else g.double() + e.double()
    assert abs(float(ts) - float(js)) <= 1e-5 * float(u.abs().sum())
    np.testing.assert_allclose(float(tsq), float(jsq), rtol=1e-5)
    assert np.float32(tmx) == np.float32(jmx)
    if name == "histk":
        jh = np.asarray(jh, dtype=np.float64).astype(np.int64)
        jh[0] -= (-d) % sb                      # its padding zeros
        np.testing.assert_array_equal(th.numpy(), jh)
    else:
        assert jh is None and th is None
    k = d // 100
    a = ops.fused_compress_ef(g, e, name, k, stats=(ts, tsq, tmx, th))
    b = ops.fused_compress_ef(g, e, name, k)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the unfused pipeline against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("d", [4096, 65536])
@pytest.mark.parametrize("name", FUSED)
def test_unfused_matches_reference(name, d, pair):
    """``u`` formed in the promoted dtype (bf16 rounds it, where the port
    formed it in f32 before), selected from, decoded and subtracted in
    it: bitwise the reference's ``unfused_compress_ef``."""
    g, e = _operands(d, *pair, seed=2)
    k = d // 100
    jv, ji, je = jops.unfused_compress_ef(_jax(g), _jax(e), name, k,
                                          backend="mosaic", **GEOMETRY)
    v, i, ne = ops.unfused_compress_ef(g, e, name, k, **GEOMETRY)
    _same(ji, i, "indices")
    _same(jv, v, "values")
    _same(je, ne, "e'")


# ---------------------------------------------------------------------------
# K4a-K4d's plain versions at bf16 (the reference's DTYPES cases)
# ---------------------------------------------------------------------------


def _u_bf16(d, seed):
    rng = np.random.default_rng(seed + d)
    return torch.from_numpy((0.02 * rng.standard_normal(d)).astype(
        np.float32)).to(torch.bfloat16)


def _pad2d(t, block):
    pad = (-t.shape[0]) % block
    return _jax(torch.nn.functional.pad(t, (0, pad)).view(-1, block))


@pytest.mark.parametrize("d", [257, 2048, 5000, 65536])
def test_k4_plain_versions_match_pallas_at_bf16(d):
    """K4a moments (f32 sums of the widened elements), K4b counts and K4c
    staging rows (f32 copies of the widened elements) of a bf16 vector
    against the reference's kernels on the same bits."""
    x = _u_bf16(d, 0)
    block = tuning.choose_stats_block(d, "torch", x.dtype)
    js, jsq, jmx = j_moments(_pad2d(x, block), block=block, interpret=True)
    ts, tsq, tmx = fm.moments_plain(x, block)
    assert abs(float(ts) - float(js)) <= 1e-5 * float(x.double().abs().sum())
    np.testing.assert_allclose(float(tsq), float(jsq), rtol=1e-5)
    assert float(tmx) == float(jmx)
    thres = 0.02
    assert int(j_count(_pad2d(x, block), jnp.float32(thres), block=block,
                       interpret=True)) == int(
        cg.count_gt(x, thres, block=block))
    cblock = tuning.choose_block(d, "torch", x.dtype)
    jv, jo, jn = j_compact(_pad2d(x, cblock), jnp.float32(thres), bcap=64,
                           block=cblock, interpret=True)
    tv, to, tn = thc.threshold_compact(x, thres, block=cblock, bcap=64)
    _same(jv, tv, "K4c values")
    _same(jo, to, "K4c offsets")
    _same(jn, tn, "K4c counts")


@pytest.mark.parametrize("d", [4096, 100_000])
def test_abs_histogram_plain_matches_pallas_at_bf16(d):
    """K4d's integer bins of a bf16 vector equal the reference's ``log2``
    bins: a bf16 value sits thousands of f32 ulps from every irrational
    edge, so the two bin functions cannot part on one."""
    x = _u_bf16(d, 5)
    block = 2048
    jh = np.asarray(j_hist(_pad2d(x, block), block=block),
                    dtype=np.float64).astype(np.int64)
    jh[0] -= (-d) % block
    np.testing.assert_array_equal(hist.abs_histogram(x, block=block).numpy(),
                                  jh)


# ---------------------------------------------------------------------------
# the dtype axis of the kernel configuration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtype_axis_matches_reference_tuning(dtype, monkeypatch, tmp_path):
    """``config_key``, the heuristic and the candidate grid by dtype: the
    card's (``cuda``) those of the reference's GPU lowering
    (``triton``: 4 KiB of operand a block, 1024 f32 and 2048 bf16), the
    CPU's (``torch``) those of its interpret floor (2048 for every
    dtype), for every shape class; ``ops._resolve`` keys by ``g``'s
    dtype."""
    monkeypatch.setenv(tuning.ENV_TABLE_DIR, str(tmp_path))
    tuning.clear_cache()
    tdt = getattr(torch, dtype)
    for c in tuning.TABLE_CLASSES:
        assert tuning.config_key("cuda", c, tdt) == jtuning.config_key(
            "cuda", c, dtype)
        for ours, theirs in (("cuda", "triton"), ("torch", "interpret")):
            a = tuning.heuristic_config(ours, c, tdt)
            b = jtuning.heuristic_config(theirs, c, dtype)
            assert (a.block, a.stats_block) == (b.block, b.stats_block), (
                ours, c)
        assert [(x.block, x.stats_block, x.num_warps)
                for x in tuning.candidates(c, tdt)] == [
            (x.block, x.stats_block, x.num_warps)
            for x in jtuning.candidates("triton", c, dtype)]
    g = torch.zeros(70001, dtype=tdt)
    with tuning.geometry_of("cuda"):
        *_, cfg = ops._resolve(g, None, "gaussiank", 70, None, None, None,
                               None)
    assert (cfg.block, cfg.stats_block) == (
        jtuning.min_block("triton", dtype),
        jtuning.heuristic_config("triton", 70001, dtype).stats_block)
    tuning.clear_cache()


# ---------------------------------------------------------------------------
# the bucket, the train state, the params
# ---------------------------------------------------------------------------


def _bf16_cfgs():
    bf = dict(param_dtype="bfloat16", activation_dtype="bfloat16")
    return (dataclasses.replace(j_get_config("llama3.2-1b").reduced(), **bf),
            dataclasses.replace(get_config("llama3.2-1b").reduced(), **bf))


@pytest.mark.parametrize("name", FUSED)
def test_bucket_compress_bf16_matches_reference(name, monkeypatch, tmp_path):
    """A bf16 bucket (G and E) of the bf16 llama3.2-1b smoke model's
    leaves: values, indices and the new residual bitwise the reference's
    fused ``bucket_compress`` on the mosaic lowering, both at the mosaic
    heuristic's geometry; ``E`` is updated in place, bf16."""
    monkeypatch.setenv(tuning.ENV_TABLE_DIR, str(tmp_path))
    tuning.clear_cache()
    jtuning.clear_cache()
    jcfg, _ = _bf16_cfgs()
    jparams = j_init(jcfg, jax.random.PRNGKey(0))
    spec = j_get(name)
    jlay = jl.build_layout(jparams, 1, 0.01, spec)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    tlay = build_layout(params, 1, 0.01, get_compressor(name))
    D = jlay.d_row_total
    assert tlay.d_row_total == D
    rng = np.random.default_rng(4)
    G = torch.from_numpy((0.02 * rng.standard_normal((1, D))).astype(
        np.float32)).to(torch.bfloat16)
    E = torch.from_numpy((0.01 * rng.standard_normal((1, D))).astype(
        np.float32)).to(torch.bfloat16)
    with jtuning.use_backend("mosaic"):
        jv, ji, jE, _ = jagg.bucket_compress(_jax(G), _jax(E), jlay, spec,
                                             None, backend="fused")
    E_in, ptr = E.clone(), E.data_ptr()
    with tuning.geometry_of("cuda"):
        v, i, E2 = tagg.bucket_compress(G, E, tlay, get_compressor(name),
                                        backend="fused")
    tuning.clear_cache()
    assert E2.data_ptr() == ptr and E2.dtype == torch.bfloat16
    _same(ji, i, "indices")
    _same(jv, v, "values")
    _same(jE, E2, "E'")
    assert torch.equal(codec.decode(v[0], i[0], D) + E2[0], (G + E_in)[0])


@pytest.mark.parametrize("k", [3, 41, np.int32(97)], ids=["3", "41",
                                                          "int32-97"])
@pytest.mark.parametrize("two_sided", [False, True])
def test_gaussian_threshold_bf16_matches_reference(two_sided, k):
    """``gaussian_threshold`` of a bf16 ``u`` runs on the CPU (it raised
    ``NotImplementedError`` for a bf16 ``ndtri``) and gives the
    reference's threshold at bf16: an f32 threshold within rtol 1e-5
    (the f32 test's tolerance: torch's ``ndtri`` and sums part from
    XLA's in the last f32 bits), and the same selection."""
    from repro.core import compressors as jc
    from repro_torch.core import compressors as tc
    rng = np.random.default_rng(7 + two_sided)
    x = (rng.standard_normal(4097) * 0.02 + 0.001).astype(np.float32)
    u = torch.from_numpy(x).to(torch.bfloat16)
    ju = _jax(u)
    jt = np.asarray(jc.gaussian_threshold(ju, k, 4, two_sided))
    tt = tc.gaussian_threshold(u, k, 4, two_sided)
    assert tt.dtype == torch.float32 and jt.dtype == np.float32
    np.testing.assert_allclose(float(tt), float(jt), rtol=1e-5)
    name = "gaussiank2" if two_sided else "gaussiank"
    jv, ji = jc.get_compressor(name).select(ju, int(k), None)
    tv, ti = tc.get_compressor(name).select(u, int(k), None)
    _same(ji, ti, "indices")
    _same(jv, tv, "values")


def test_gaussian_threshold_f32_unchanged():
    """The f32 threshold is the mean/std/``ndtri`` arithmetic it always
    was, bit for bit."""
    from repro_torch.core import compressors as tc
    rng = np.random.default_rng(3)
    u = torch.from_numpy((rng.standard_normal(5000) * 0.01).astype(
        np.float32))
    mu = torch.mean(u)
    sigma = torch.std(u, unbiased=False) + 1e-12
    q = torch.special.ndtri(torch.tensor(float(np.float32(1.0 - 5 / 5000)),
                                         dtype=torch.float32))
    thres = torch.abs(q * sigma + mu)
    lo, hi = (torch.tensor(float(b), dtype=torch.float32)
              for b in tc.accept_band(5))
    done = torch.zeros((), dtype=torch.bool)
    for _ in range(4):
        est = torch.sum(torch.abs(u) > thres).to(torch.float32)
        new = torch.where(est < lo, 0.5 * thres,
                          torch.where(est > hi, 1.5 * thres, thres))
        thres = torch.where(done, thres, new)
        done = done | ((est >= lo) & (est <= hi))
    got = tc.gaussian_threshold(u, 5)
    assert got.dtype == torch.float32
    assert got.view(torch.int32).item() == thres.view(torch.int32).item()


@pytest.mark.parametrize("name", ["gaussiank", "gaussiank2"])
def test_bucket_compress_bf16_reference_backend_matches_reference(name):
    """``bucket_compress(backend="reference")`` on a bf16 bucket (G and E
    bf16, the bf16 llama3.2-1b smoke model's leaves) against the
    reference's on the same bits: values, indices and the new bf16
    residual bitwise."""
    jcfg, _ = _bf16_cfgs()
    jparams = j_init(jcfg, jax.random.PRNGKey(0))
    spec = j_get(name)
    jlay = jl.build_layout(jparams, 1, 0.01, spec)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    tlay = build_layout(params, 1, 0.01, get_compressor(name))
    D = jlay.d_row_total
    rng = np.random.default_rng(5)
    G = torch.from_numpy((0.02 * rng.standard_normal((1, D))).astype(
        np.float32)).to(torch.bfloat16)
    E = torch.from_numpy((0.01 * rng.standard_normal((1, D))).astype(
        np.float32)).to(torch.bfloat16)
    jv, ji, jE, _ = jagg.bucket_compress(_jax(G), _jax(E), jlay, spec,
                                         None, backend="reference")
    v, i, E2 = tagg.bucket_compress(G, E, tlay, get_compressor(name),
                                    backend="reference")
    assert E2.dtype == torch.bfloat16
    _same(ji, i, "indices")
    _same(jv, v, "values")
    _same(jE, E2, "E'")


@pytest.mark.parametrize("strategy,with_residual", [
    ("allgather", True), ("hierarchical", True), ("allgather", False)])
def test_init_train_state_resid_dtype_matches_reference(strategy,
                                                        with_residual):
    """``resid_dtype`` sets the residuals' dtype (``resid2`` too);
    ``with_residual=False`` allocates neither them nor ``adaptk``: the
    reference's keys, shapes and dtypes, bucketed and per leaf."""
    from repro.core.adaptk import make_policy as j_policy
    from repro_torch.core.adaptk import make_policy
    jcfg, _ = _bf16_cfgs()
    jparams = j_init(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    jcomp = JCompression(compressor="gaussiank", ratio=0.01,
                         strategy=strategy, density_policy=j_policy())
    comp = CompressionConfig(compressor="gaussiank", ratio=0.01,
                             strategy=strategy, density_policy=make_policy())
    for bucketed in (True, False):
        jlay = jl.build_layout(jparams, 1, jcomp) if bucketed else None
        tlay = build_layout(params, 1, comp) if bucketed else None
        js = j_state(jparams, j_sgd(0.9), workers=2, model_size=1,
                     compression=jcomp, with_residual=with_residual,
                     resid_dtype=jnp.bfloat16, layout=jlay)
        ts = init_train_state(params, sgd_momentum(0.9), workers=2,
                              model_size=1, compression=comp,
                              with_residual=with_residual,
                              resid_dtype=torch.bfloat16, layout=tlay)
        assert sorted(js) == sorted(ts)
        for key in ("resid", "resid2"):
            if key not in js:
                continue
            jleaves, tleaves = jax.tree.leaves(js[key]), tree.leaves(ts[key])
            assert len(jleaves) == len(tleaves)
            for a, b in zip(jleaves, tleaves):
                assert tuple(a.shape) == tuple(b.shape)
                assert _dtype_name(a) == _dtype_name(b) == "bfloat16"
                assert not bool(b.any())


def test_from_jax_params_round_trips_bf16_bits():
    """A bf16 param tree into the port and back: the leaves are bf16
    tensors with the same bits, and ``to_numpy_tree`` returns the same
    bits as bf16 arrays (``ml_dtypes``'s, which JAX loaded)."""
    jcfg, _ = _bf16_cfgs()
    np_tree = jax.tree.map(np.asarray, j_init(jcfg, jax.random.PRNGKey(0)))
    params = from_jax_params(np_tree, "cpu")
    back = to_numpy_tree(params)
    for a, t, b in zip(jax.tree.leaves(np_tree), tree.leaves(params),
                       jax.tree.leaves(back)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(_bits(t), a.view(np.uint16))
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b.view(np.uint16), a.view(np.uint16))


# ---------------------------------------------------------------------------
# the bf16 train step
# ---------------------------------------------------------------------------

STEPS, LR, RATIO = 2, 0.1, 0.01


def _batches(jcfg):
    return [{k: np.asarray(v) for k, v in j_batch_for(
        jcfg, i, global_batch=8, seq_len=64).items()} for i in range(STEPS)]


def _jax_bf16_steps(jcfg, jparams, batches):
    """The reference's bucketed step composed from its public functions
    (``value_and_grad(loss_fn)``, ``pack_grads(layout, grads,
    resid.dtype)``, ``bucket_compress(backend="reference")``, the f32
    decode of the gather mean, ``unpack_tree``, ``sgd_momentum``), with
    a bf16 residual."""
    spec = j_get("gaussiank")
    layout = jl.build_layout(jparams, 1, RATIO, spec)
    D = layout.d_row_total
    E = jnp.zeros((1, D), jnp.bfloat16)
    opt = j_sgd(0.9)
    ost, p = opt.init(jparams), jparams
    grad_fn = jax.jit(jax.value_and_grad(
        lambda q, b: j_loss(q, jcfg, b, remat=True), has_aux=True))
    compress = jax.jit(lambda G, E: jagg.bucket_compress(
        G, E, layout, spec, None, backend="reference"))
    losses = []
    for b in batches:
        (loss, _), g = grad_fn(p, {k: jnp.asarray(v) for k, v in b.items()})
        G = jl.pack_grads(layout, g, E.dtype)
        v, i, E, _ = compress(G, E)
        mean = jcodec.decode(v[0].astype(jnp.float32), i[0], D)[None]
        p, ost = opt.update(p, ost, jl.unpack_tree(layout, mean, like=g), LR)
        losses.append(float(loss))
    return losses, p, E


def _port_steps(tcfg, params, batches, *, comp, resid_dtype, mesh="1x1",
                workers=1, pipeline="bucketed"):
    layout = None if pipeline == "perleaf" else build_layout(params, 1, comp)
    opt = sgd_momentum(0.9)
    state = init_train_state(params, opt, workers=workers, model_size=1,
                             compression=comp, layout=layout,
                             resid_dtype=resid_dtype)
    wire = LocalWire(parse_mesh(mesh)) if workers > 1 else None
    step = make_train_step(tcfg, mesh, opt, constant(LR), compression=comp,
                           layout=layout, wire=wire)
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v).long()
                                for k, v in b.items()})
        losses.append(float(m["loss"]))
        assert m["density"] <= m["density_cap"]
    return losses, state


def test_bf16_train_step_matches_reference():
    """2 steps of the bf16 llama3.2-1b smoke model (bf16 params and
    activations, ``init_train_state(resid_dtype=torch.bfloat16)``, fused
    Gaussian-k at 0.01, bucketed, mesh (1, 1), SGD momentum 0.9) against
    the reference's step composed from its public functions on the
    ``reference`` compression backend.

    Not the reference's ``make_train_step``: on bf16 params it stops at
    the first step on this jax (0.9.0), its layer scan's bf16 carry
    meeting an f32 output (``TypeError`` in ``lax.scan``); its
    ``sgd_momentum`` update ``p - lr·s`` also promotes bf16 params to f32
    under a strongly typed f32 ``lr``.  The composed step passes ``lr``
    as a Python float, so the params stay bf16, as the port's update
    keeps them (ROADMAP, reference caveats).

    Tolerance: losses within rtol 2.5e-4.  Basis: at the same params the
    two packages' bf16 losses of this model part by XLA's and torch's
    bf16 roundings of the activations, which average over the tokens:
    over six ``batch_for`` batches at 8 × 64 they parted by 1.9e-6 to
    6.2e-5 (at 4 × 32 up to 1.4e-4, at 2 × 16 up to 3.2e-4; the issue's
    probe gave 1.0e-4), and 2.5e-4 is four times the most seen at this
    size.  The reference backend selects on a bf16 ``u`` and the port's
    fused pipeline on the f32 one, so step 1's params can differ in a
    few selected elements too; the state's dtypes are held exactly."""
    jcfg, tcfg = _bf16_cfgs()
    jparams = j_init(jcfg, jax.random.PRNGKey(0))
    batches = _batches(jcfg)
    jlosses, jfinal, jE = _jax_bf16_steps(jcfg, jparams, batches)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    comp = CompressionConfig(compressor="gaussiank", ratio=RATIO)
    tlosses, state = _port_steps(tcfg, params, batches, comp=comp,
                                 resid_dtype=torch.bfloat16)
    np.testing.assert_allclose(tlosses, jlosses, rtol=2.5e-4)
    assert state["resid"].dtype == torch.bfloat16 == getattr(
        torch, _dtype_name(jE))
    assert state["resid"].shape == tuple(jE.shape)
    for a, b in zip(jax.tree.leaves(jfinal), tree.leaves(state["params"])):
        assert _dtype_name(a) == _dtype_name(b) == "bfloat16"
        assert bool(torch.isfinite(b).all())


@pytest.mark.parametrize("variant", ["perleaf f32 residual", "chunks 2",
                                     "2 workers LocalWire"])
def test_bf16_paths_bitwise_bucketed(variant):
    """The per-leaf loop with bf16 leaves and an f32 residual against the
    bucketed run of the same pair; the chunked schedule on a bf16 bucket
    against the bucketed one; two workers on ``LocalWire`` (bf16
    buckets on the wire) deterministic: losses, params and residuals
    bitwise."""
    jcfg, tcfg = _bf16_cfgs()
    np_params = jax.tree.map(np.asarray, j_init(jcfg, jax.random.PRNGKey(0)))
    batches = _batches(jcfg)

    def run(**kw):
        comp = CompressionConfig(compressor="gaussiank", ratio=RATIO,
                                 chunks=kw.pop("chunks", 1))
        return _port_steps(tcfg, from_jax_params(np_params, "cpu"), batches,
                           comp=comp, **kw)

    if variant == "perleaf f32 residual":
        a = run(resid_dtype=torch.float32, pipeline="perleaf")
        b = run(resid_dtype=torch.float32)
        layout = build_layout(from_jax_params(np_params, "cpu"), 1,
                              CompressionConfig(compressor="gaussiank",
                                                ratio=RATIO))
        assert b[1]["resid"].dtype == torch.float32
        assert flat(a[1]["resid"], layout).tobytes() == \
            flat(b[1]["resid"], layout).tobytes()
    elif variant == "chunks 2":
        a = run(resid_dtype=torch.bfloat16, chunks=2)
        b = run(resid_dtype=torch.bfloat16)
        assert torch.equal(a[1]["resid"], b[1]["resid"])
    else:
        a = run(resid_dtype=torch.bfloat16, mesh="2x1", workers=2)
        b = run(resid_dtype=torch.bfloat16, mesh="2x1", workers=2)
        assert a[1]["resid"].dtype == torch.bfloat16
        assert torch.equal(a[1]["resid"], b[1]["resid"])
    assert a[0] == b[0]
    for x, y in zip(tree.leaves(a[1]["params"]), tree.leaves(b[1]["params"])):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("chunks", [1, 2])
def test_bf16_bucket_over_gloo_bitwise_local_wire(tmp_path, chunks):
    """Two processes over gloo (``ProcessGroupWire``: a bf16 bucket's
    pairs on the wire) train the bf16 smoke model 2 steps, bucketed and
    chunked: each rank's losses, params and bf16 residual row bitwise
    the two-worker ``LocalWire`` run in this process."""
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, PYTHONPATH=SRC, RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "_torch_bf16_pg.py"),
             str(tmp_path), str(chunks)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    # one thread, as the ranks run: a bf16 matmul's sums on the CPU
    # follow the thread count
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        losses, state = run_steps(chunks, wire=None)
    finally:
        torch.set_num_threads(threads)
    for r in range(2):
        with open(tmp_path / f"rank{r}.json") as f:
            got = json.load(f)
        assert got["losses"] == losses
        assert got["resid_dtype"] == "torch.bfloat16"
        assert got["resid"] == state["resid"][r].view(
            torch.uint16).numpy().tobytes().hex()
        assert got["params"] == [x.view(torch.uint16).numpy().tobytes().hex()
                                 for x in tree.leaves(state["params"])]
