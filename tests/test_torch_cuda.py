"""The Hopper kernels against their plain versions on the card.

These tests need a CUDA device: each is marked ``cuda`` and skips
without one (decided inside the fixture, never at import).  On a GPU
machine run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports no JAX: the card's machine has none.  Tolerances: K1
and K4a ``s`` within ``1e-5·Σ|u|``, ``sq`` within rtol 1e-5, absmax
exact (the Triton and torch reductions sum in other orders); K2 and K4b
counts, the K1 and K4d histograms, K3 and K4c staging and the residual
exact (integer work and copies of ``u``); the unfused pipeline bitwise
the fused one.  The K3 stage, K4c and K4d are also held bitwise on
views at storage offsets 1 and 3 (their scalar-load paths), blocks that
are not multiples of 4, thresholds of 0 and above ``max|u|``, and
one-bin, all-zero and zero/subnormal/inf/``>= edge[127]`` inputs.
Adaptive density's pass A on the card: K1 on its own against its plain
version, and a compression handed its statistics back launches no
second K1 and is bitwise the one that runs its own.  The data-parallel
wire on the card: the rank-order decode of gathered
pairs and the gTop-k re-encode bitwise the CPU's, and four workers in
one process deterministic, with losses within rtol 1e-4 of the CPU's.
The chunked schedule and the per-leaf loop on the card, bitwise the
bucketed run there.  Slice 4: the ``threefry_bits`` kernel bitwise its
plain version, the
PRNG's known answers drawn on the card, and the key-sampled selections
on the card bitwise the CPU's.  Slice 4b: FNN-3's init bitwise and the
LM's within rtol 1e-5 (``erfinv``) drawn on the card against the CPU,
and the paper's simulation on the card against the CPU (losses within
rtol 1e-4, the wire equal).  Slice 7: prefill and decode on the card
against the CPU from the same weights (a sliding-window ring that
wraps; logits within rtol 1e-4, atol 1e-5, tokens equal), the weight-
delta publisher on the card bitwise the CPU's (``topk``, and the fused
``gaussiank`` at the card's block geometry) with ``pub`` equal to the
packed replica at every tick, and the serving CLI on the card.
Slice 8: the MoE, Mamba-hybrid, xLSTM and ``embeds`` smoke models' loss
and gradients on the card against the CPU (rtol 1e-4, atol 1e-6), and
two backwards on the card bitwise equal.  Slice 2d: the profiler's
tensor-parallel breakdown (two ranks of smoke deepseek-moe-16b under
``torchrun``), every phase of every rank present and finite.  Slice
7.2: serving placed at ``1x2`` on the card (two ranks under
``torchrun``, gloo on one card), its tokens and counters those of the
one-process run on the card.  Slice 11: query-chunked attention at
T = 2048 on the card against the one-block run there.  Slice 12: every
EF kernel at (f32, f32), (bf16, bf16), (bf16, f32) and (f32, bf16)
operands (K4a-K4d on ``u`` in the promoted dtype; the K3 stage and K4c
at storage offsets that break the bf16 vector path's 16-byte
alignment, K4d on bf16 heads of up to 7 elements), bitwise its plain
version with ``e'`` and the wire values in the promoted dtype (bf16
compared as int16), and a ``TypeError`` on f16 or f64 operands.
Slice 13: the CUDA K2 and K4b bitwise their plain versions at 1 to 128
thresholds with duplicates and ``+inf``, on views at storage offsets;
the K3 one sweep bitwise the stage and residual launches plus
``assemble_staging``, in place too; the fused path launching one K1,
one K2 and one sweep and no stage or residual launch.  Slice 14: K1
with its histogram (CUDA) at every operand pair, on views at storage
offsets, on one-bin, all-zero, zero/subnormal/inf/``>= edge[127]`` and
NaN inputs, its histogram bitwise, absmax exact and the same bits on a
second launch; the K3 residual launch (a warp a block) bitwise its
plain version and the sweep's ``e'``, in place too.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.core import codec
from repro_torch.core.compressors import gaussiank_cap
from repro_torch.kernels.ef_fused import compact_residual as cr
from repro_torch.kernels.ef_fused import fused_moments as fm
from repro_torch.kernels.ef_fused import ops, tuning
from repro_torch.kernels.ef_fused import tree_count as tc
from repro_torch.kernels.gaussian_topk import count_gt as cg
from repro_torch.kernels.gaussian_topk import ops as gops
from repro_torch.kernels.gaussian_topk import threshold_compact as thc
from repro_torch.kernels.histk import hist
from repro_torch.kernels.moments import moments as mom

pytestmark = pytest.mark.cuda

DS = [1, 33, 4097, 1_000_003]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# operand dtypes (g, e) the EF kernels take: each forms u in f32
BF16 = torch.bfloat16
F32 = torch.float32
PAIRS = [(F32, F32), (BF16, BF16), (BF16, F32), (F32, BF16)]
PAIR_IDS = ["f32-f32", "bf16-bf16", "bf16-f32", "f32-bf16"]


def _inputs(d, dev, seed=0, pair=(F32, F32)):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + d)
    g = torch.randn(d, generator=gen, device=dev)
    e = torch.randn(d, generator=gen, device=dev).mul_(0.3)
    return g.to(pair[0]), e.to(pair[1])


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("d", DS)
def test_kernels_match_plain_versions(dev, d, pair):
    g, e = _inputs(d, dev, pair=pair)
    cfg = tuning.resolve_config(d, "cuda", g.dtype)
    n0 = (fm.fused_moments.launches, tc.tree_count.launches,
          cr.compact_stage.launches, cr.compact_resid.launches)
    s, sq, mx = fm.fused_moments(g, e, block=cfg.stats_block)
    ps, psq, pmx = fm.fused_moments_plain(g, e, block=cfg.stats_block)
    assert abs(float(s) - float(ps)) <= 1e-5 * float(
        (g.double() + e.double()).abs().sum())
    assert math.isclose(float(sq), float(psq), rel_tol=1e-5)
    assert float(mx) == float(pmx)
    k = max(1, d // 1000)
    heap, n_t = ops._tree_thresholds(ops.gaussian_t0(ps, psq, d, k, False),
                                     4)
    thr = torch.from_numpy(heap[:n_t]).to(dev)
    c = tc.tree_count(g, e, thr, block=cfg.stats_block)
    assert torch.equal(c, tc.tree_count_plain(g, e, thr,
                                              block=cfg.stats_block))
    thres = float(ops._replay_refinement(heap, c.cpu().numpy(), k, 4))
    k_cap = gaussiank_cap(k, d)
    bcap = ops.fused_default_bcap(k_cap, d, cfg.block)
    got = cr.compact_residual(g, e, thres, block=cfg.block, bcap=bcap,
                              k_cap=k_cap)
    vp, op, cp = cr.compact_stage_plain(g, e, thres, block=cfg.block,
                                        bcap=bcap)
    rp = cr.compact_resid_plain(g, e, thres, cr.exclusive_enc(cp, bcap),
                                block=cfg.block, bcap=bcap, k_cap=k_cap)
    assert got[3].dtype == torch.promote_types(g.dtype, e.dtype)
    for a, b in zip(got, (vp, op, cp, rp)):
        assert _same_bits(a, b)
    n1 = (fm.fused_moments.launches, tc.tree_count.launches,
          cr.compact_stage.launches, cr.compact_resid.launches)
    assert [b - a for a, b in zip(n0, n1)] == [1, 1, 1, 1]
    # the one sweep: bitwise the two launches plus the assembly
    sw = cr.compact_sweep(g, e, thres, block=cfg.block, bcap=bcap,
                          k_cap=k_cap)
    pair = cr.assemble_staging(vp, op, cp, k_cap, block=cfg.block,
                               out_dtype=rp.dtype)
    for a, b in zip(sw, (vp, op, cp, rp) + pair):
        assert _same_bits(a, b)
    # the fused path: one K1, one K2 and one sweep; no stage or residual
    main = (fm.fused_moments, tc.tree_count, cr.compact_sweep,
            cr.compact_stage, cr.compact_resid)
    n0 = [f.launches for f in main]
    ops.fused_compress_ef(g, e, "gaussiank", k)
    assert [f.launches - n for f, n in zip(main, n0)] == [1, 1, 1, 0, 0]


@pytest.mark.parametrize("pair", PAIRS[:3], ids=PAIR_IDS[:3])
@pytest.mark.parametrize("d", DS)
def test_pipeline_conserves_in_place(dev, d, pair):
    """In place over ``e`` (of the promoted dtype): ``decode + e' == g +
    e`` bitwise, in bf16 for bf16 operands (the f32 sum rounded once)."""
    g, e = _inputs(d, dev, seed=1, pair=pair)
    u = g + e
    v, i, ne = ops.fused_compress_ef(g, e, "gaussiank",
                                     max(1, d // 1000), out=e)
    torch.cuda.synchronize()
    assert ne.data_ptr() == e.data_ptr()
    assert torch.equal(codec.decode(v, i, d) + e, u)


@pytest.mark.parametrize("name", ["gaussiank", "gaussiank2", "histk"])
@pytest.mark.parametrize("d", DS)
def test_pass_a_and_stats_match_plain_and_one_k1(dev, d, name):
    """Adaptive density's pass A on the card: ``fused_pass_a`` (K1, with
    its histogram for hist-k) against the plain version on the card;
    then ``u`` compressed in place with those statistics handed back
    (``stats=``, on the host) and a per-step ``np.int32`` k launches no
    second K1 and is bitwise the pipeline that runs its own K1 on
    ``(g, e)``."""
    import numpy as np
    g, e = _inputs(d, dev, seed=4)
    u = g + e
    sb = tuning.resolve_config(d, "cuda").stats_block
    n0 = fm.fused_moments.launches + fm.fused_moments_hist.launches
    st = ops.fused_pass_a(u, None, name)
    assert fm.fused_moments.launches + fm.fused_moments_hist.launches \
        == n0 + 1
    ps, psq, pmx = fm.fused_moments_plain(u, None, block=sb)
    assert abs(float(st[0]) - float(ps)) <= 1e-5 * float(u.abs().sum())
    assert math.isclose(float(st[1]), float(psq), rel_tol=1e-5)
    assert float(st[2]) == float(pmx)
    if name == "histk":
        assert torch.equal(st[3], fm.fused_moments_hist_plain(
            u, None, block=sb)[3])
    host = tuple(None if x is None else x.cpu() for x in st)
    k = np.int32(max(1, d // 500))
    k_cap = gaussiank_cap(4 * int(k), d)
    want = ops.fused_compress_ef(g, e.clone(), name, k, k_cap=k_cap,
                                 stats=None)
    counts = (fm.fused_moments.launches, fm.fused_moments_hist.launches,
              tc.tree_count.launches, cr.compact_sweep.launches)
    uu = u.clone()
    v, i, ne = ops.fused_compress_ef(uu, None, name, k, k_cap=k_cap,
                                     out=uu, stats=host)
    after = (fm.fused_moments.launches, fm.fused_moments_hist.launches,
             tc.tree_count.launches, cr.compact_sweep.launches)
    assert [b - a for a, b in zip(counts, after)] == [
        0, 0, 0 if name == "histk" else 1, 1]
    assert ne.data_ptr() == uu.data_ptr()
    for a, b in zip((v, i, ne), want):
        assert torch.equal(a, b)
    assert torch.equal(codec.decode(v, i, d) + ne, u)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("d", DS)
def test_k4_kernels_match_plain_versions(dev, d, pair):
    """K1 with its histogram on ``(g, e)`` and K4a-K4d on ``u = g + e`` in
    the promoted dtype (bf16 for bf16 operands)."""
    g, e = _inputs(d, dev, seed=2, pair=pair)
    u = g + e
    cfg = tuning.resolve_config(d, "cuda", g.dtype)
    sb, block = cfg.stats_block, cfg.block
    wrappers = (fm.fused_moments_hist, mom.moments, cg.count_gt,
                thc.threshold_compact, hist.abs_histogram)
    n0 = [f.launches for f in wrappers]
    s, sq, mx, h = fm.fused_moments_hist(g, e, block=sb)
    assert torch.equal(h, fm.fused_moments_hist_plain(g, e, block=sb)[3])
    assert int(h.sum()) == d
    hp = hist.abs_histogram_plain(u, block=sb)
    pk1 = fm.fused_moments_plain(g, e, block=sb)
    ps, psq, pmx = fm.moments_plain(u, sb)
    for got, want in (((s, sq, mx), pk1), (mom.moments(u, block=sb),
                                           (ps, psq, pmx))):
        assert abs(float(got[0]) - float(want[0])) <= 1e-5 * float(
            u.double().abs().sum())
        assert math.isclose(float(got[1]), float(want[1]), rel_tol=1e-5)
        assert float(got[2]) == float(want[2])
    t = float(u.float().abs().kthvalue(
        max(1, d - max(1, d // 1000))).values)
    assert torch.equal(cg.count_gt(u, t, block=sb),
                       cg.count_gt_plain(u, t, block=sb))
    bcap = gops.default_bcap(gaussiank_cap(max(1, d // 1000), d), d, block)
    for a, b in zip(thc.threshold_compact(u, t, block=block, bcap=bcap),
                    thc.threshold_compact_plain(u, t, block=block,
                                                bcap=bcap)):
        assert _same_bits(a, b)
    assert torch.equal(hist.abs_histogram(u, block=sb), hp)
    n1 = [f.launches for f in wrappers]
    assert [b - a for a, b in zip(n0, n1)] == [1, 1, 1, 1, 1]


@pytest.mark.parametrize("pair", [PAIRS[0], PAIRS[2], PAIRS[3]],
                         ids=[PAIR_IDS[0], PAIR_IDS[2], PAIR_IDS[3]])
@pytest.mark.parametrize("name", ["gaussiank", "gaussiank2", "histk"])
@pytest.mark.parametrize("d", DS)
def test_unfused_equals_fused(dev, d, name, pair):
    """Bitwise wherever both pipelines select on the same f32 ``u`` (one
    operand f32); at bf16/bf16 the unfused ``u`` is rounded to bf16
    first, as the reference's is."""
    g, e = _inputs(d, dev, seed=3, pair=pair)
    k = max(1, d // 1000)
    f = ops.fused_compress_ef(g, e, name, k)
    u = ops.unfused_compress_ef(g, e, name, k)
    torch.cuda.synchronize()
    for a, b in zip(f, u):
        assert torch.equal(a, b)
    assert torch.equal(codec.decode(f[0], f[1], d) + f[2], g + e)


def _same_bits(a, b):
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("off", [0, 1, 3, 4])
@pytest.mark.parametrize("block", [1024, 2048, 4096, 1001])
@pytest.mark.parametrize("d", [33, 4097, 1_000_003])
def test_stage_kernels_edge_cases(dev, d, block, off, pair):
    """The K3 stage and K4c, bitwise their plain versions, on views at
    storage offsets 1 and 3 (the scalar-load path) and 4 (16-byte
    aligned for f32, not for bf16), at blocks that are and are not
    multiples of the vector group (4 f32, 8 bf16), at a mid threshold,
    at 0 (every full block overflows bcap) and just above ``max|u|``
    (nothing staged)."""
    g, e = _inputs(d + off, dev, seed=4, pair=pair)
    gv, ev = g[off:], e[off:]
    uv = gv + ev
    top = uv.float().abs().max()
    above = float(torch.nextafter(top, torch.full_like(top, math.inf)))
    mid = float(uv.float().abs().kthvalue(max(1, d * 9 // 10)).values)
    n0 = (cr.compact_stage.launches, thc.threshold_compact.launches)
    for t in (mid, 0.0, above):
        for a, b in zip(cr.compact_stage(gv, ev, t, block=block, bcap=64),
                        cr.compact_stage_plain(gv, ev, t, block=block,
                                               bcap=64)):
            assert _same_bits(a, b), (t, "K3 stage")
        for a, b in zip(thc.threshold_compact(uv, t, block=block, bcap=64),
                        thc.threshold_compact_plain(uv, t, block=block,
                                                    bcap=64)):
            assert _same_bits(a, b), (t, "K4c")
    n1 = (cr.compact_stage.launches, thc.threshold_compact.launches)
    assert [b - a for a, b in zip(n0, n1)] == [3, 3]


COUNT_DS = [1, 4095, 4096, (1 << 20) + 3]
COUNT_PAIRS = PAIRS + [(BF16, None), (F32, None)]
COUNT_IDS = PAIR_IDS + ["bf16-none", "f32-none"]


def _thresholds(n, a, dev):
    """``n`` thresholds in heap order over ``|u| = a``: the refinement
    tree's own 15 (which repeat values) for n = 15, else quantiles of
    ``a`` each repeated twice, the last one ``+inf`` (the heap's
    padding)."""
    if n == 15:
        heap, _ = ops._tree_thresholds(np.float32(float(a.max())) * 0.25, 4)
        return torch.from_numpy(heap[:15])
    q = torch.linspace(0.05, 0.999, max(1, (n + 1) // 2))
    t = torch.quantile(a.float().cpu()[:1 << 16], q).repeat_interleave(2)
    t = t[:n].contiguous()
    if n > 1:
        t[-1] = math.inf
    return t


@pytest.mark.parametrize("pair", COUNT_PAIRS, ids=COUNT_IDS)
@pytest.mark.parametrize("d", COUNT_DS)
def test_count_kernels_match_plain(dev, d, pair):
    """K2 (and K4b on ``u`` with no ``e``) bitwise its plain version at
    1, 2, 15, 16, 127 and 128 thresholds with duplicates and ``+inf``,
    on contiguous tensors, on views at storage offsets 1 and 3 (the
    scalar head) and on a ``g`` and an ``e`` at offsets 0 and 1 (no
    common alignment: every element scalar); thresholds given on the
    host or on the card."""
    for off, eoff in ((0, 0), (1, 1), (3, 3), (0, 1)):
        g, e = _inputs(d + 1 + off, dev, seed=8,
                       pair=(pair[0], pair[1] or F32))
        gv = g[off:off + d]
        ev = None if pair[1] is None else e[eoff:eoff + d]
        a = (gv.float() if ev is None else gv.float() + ev.float()).abs()
        for n in (1, 2, 15, 16, 127, 128):
            t = _thresholds(n, a, dev)
            n0 = tc.tree_count.launches
            got = tc.tree_count(gv, ev, t, block=4096)
            assert tc.tree_count.launches == n0 + 1
            want = tc.tree_count_plain(gv, ev, t, block=4096)
            assert torch.equal(got, want), (off, n)
            assert torch.equal(tc.tree_count(gv, ev, t.to(dev), block=4096),
                               want)
        if ev is None:
            for t in (0.0, float(a.median()), math.inf):
                assert torch.equal(cg.count_gt(gv, t, block=2048),
                                   cg.count_gt_plain(gv, t, block=2048)), t


@pytest.mark.parametrize("pair", COUNT_PAIRS[:5], ids=COUNT_IDS[:5])
@pytest.mark.parametrize("d", COUNT_DS)
def test_sweep_matches_two_launches(dev, d, pair):
    """The one sweep bitwise the stage and residual launches plus
    ``assemble_staging`` (rows, ``e'``, the pair), in place over ``e``
    (or ``g`` without ``e``) too where it has ``e'``'s dtype: at blocks 1024, 2048 and 1001, on views
    at storage offsets 1 and 3, at a mid threshold with ``k_cap`` below
    the staged count (the global cut), at 0 (every block overflows
    bcap) and just above ``max|u|`` (nothing staged)."""
    for off in (0, 1, 3):
        g, e = _inputs(d + off, dev, seed=9, pair=(pair[0], pair[1] or F32))
        gv, ev = g[off:], None if pair[1] is None else e[off:]
        a = (gv.float() if ev is None else gv.float() + ev.float()).abs()
        top = a.max()
        above = float(torch.nextafter(top, torch.full_like(top, math.inf)))
        mid = float(a.kthvalue(max(1, d * 99 // 100)).values)
        for block in (1024, 2048, 1001):
            for t, k_cap in ((mid, max(1, d // 200)), (0.0, d), (above, 5)):
                vp, op, cp = cr.compact_stage(gv, ev, t, block=block,
                                              bcap=64)
                rp = cr.compact_resid(gv, ev, t, cr.exclusive_enc(cp, 64),
                                      block=block, bcap=64, k_cap=k_cap)
                want = (vp, op, cp, rp) + cr.assemble_staging(
                    vp, op, cp, k_cap, block=block, out_dtype=rp.dtype)
                got = cr.compact_sweep(gv, ev, t, block=block, bcap=64,
                                       k_cap=k_cap)
                for x, y, what in zip(got, want, ("vals", "offs", "cnt",
                                                  "e'", "values",
                                                  "indices")):
                    assert _same_bits(x, y), (off, block, t, what)
                src = gv if ev is None else ev
                if src.dtype != rp.dtype:
                    continue   # e' is not e's dtype: no in-place form
                dst = src.clone()
                ins = cr.compact_sweep(gv if ev is not None else dst,
                                       ev if ev is None else dst, t,
                                       block=block, bcap=64, k_cap=k_cap,
                                       out=dst)
                assert ins[3].data_ptr() == dst.data_ptr()
                for x, y in zip(ins, want):
                    assert _same_bits(x, y), (off, block, t, "in place")


def _hist_input(kind, n, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(n)
    x = torch.randn(n, generator=gen, device=dev).mul_(1e-3)
    if kind == "one magnitude":
        x.fill_(0.37)
    elif kind == "zeros":
        x.zero_()
    elif kind == "mixed":
        x[0::6] = 0.0
        x[1::6] = -1e-40
        x[2::6] = float(hist.EDGES[127])
        x[3::6] = -3e38
        x[4::12] = math.inf
    return x


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["gaussian", "one magnitude", "zeros",
                                  "mixed"])
@pytest.mark.parametrize("off", [0, 1, 3, 5])
@pytest.mark.parametrize("d", [1, 33, 4097, 1_000_003])
def test_abs_histogram_edge_cases(dev, d, off, kind, dtype):
    """K4d bitwise its plain version at any block, on views at storage
    offsets 1, 3 and 5 (the scalar head: up to 3 f32 or 7 bf16
    elements), on one bin, all zeros, and zeros, subnormals, infinities
    and values at or above ``edge[127]``; a bf16 element binned by its
    exact f32 value."""
    x = _hist_input(kind, d + off, dev).to(dtype)[off:]
    n0 = hist.abs_histogram.launches
    h = hist.abs_histogram(x)
    assert hist.abs_histogram.launches - n0 == 1
    for block in (16, 2048, 4096):
        assert torch.equal(h, hist.abs_histogram_plain(x, block=block))
    assert int(h.sum()) == d


K1_DS = [1, 7, 4095, 4096, (1 << 20) + 3]


def _k1_input(kind, n, dev):
    """:func:`_hist_input`'s kinds, and ``nan``: ``mixed`` with a NaN at
    every twelfth element."""
    if kind != "nan":
        return _hist_input(kind, n, dev)
    x = _hist_input("mixed", n, dev)
    x[5::12] = math.nan
    return x


@pytest.mark.parametrize("kind", ["gaussian", "one magnitude", "zeros",
                                  "mixed", "nan"])
@pytest.mark.parametrize("pair", COUNT_PAIRS, ids=COUNT_IDS)
@pytest.mark.parametrize("d", K1_DS)
def test_fused_moments_hist_matches_plain(dev, d, pair, kind):
    """K1 with its histogram (the CUDA kernel) at every operand pair, on
    contiguous tensors and views at storage offsets 1 and 3 (the scalar
    head), and on one bin, all zeros, zeros/subnormals/inf/``>=
    edge[127]`` and NaN: the histogram bitwise the plain version's and
    summing to ``d``, absmax exact, ``s`` within ``1e-5·Σ|u|`` and
    ``sq`` within rtol 1e-5, the same bits on a second launch, one
    launch counted a call.  Where a plain moment is not finite: ``sq``
    (a sum of non-negative terms) the same inf or NaN, ``s`` NaN where
    ``u`` holds a NaN and else not finite (an inf that meets f32
    overflow of the ``-3e38`` elements gives inf or NaN by the order of
    the sum); absmax always exact."""
    for off in (0, 1, 3):
        g = _k1_input(kind, d + off, dev).to(pair[0])[off:]
        e = None if pair[1] is None else _hist_input(
            "gaussian", d + off + 1, dev)[1 + off:].mul_(0.5).to(pair[1])
        n0 = fm.fused_moments_hist.launches
        got = fm.fused_moments_hist(g, e, block=4096)
        assert fm.fused_moments_hist.launches == n0 + 1
        want = fm.fused_moments_hist_plain(g, e, block=4096)
        assert torch.equal(got[3], want[3]), off
        assert int(got[3].sum()) == d
        again = fm.fused_moments_hist(g, e, block=4096)
        for a, b in zip(got, again):
            assert _same_bits(a, b), (off, "rerun")
        (s, sq, mx), (ps, psq, pmx) = ([float(x) for x in t[:3]]
                                       for t in (got, want))
        u = g.double() if e is None else g.double() + e.double()
        assert mx == pmx or (math.isnan(mx) and math.isnan(pmx)), off
        if math.isfinite(psq):
            assert math.isclose(sq, psq, rel_tol=1e-5), off
        else:
            assert sq == psq or (math.isnan(sq) and math.isnan(psq)), off
        if math.isfinite(ps):
            assert abs(s - ps) <= 1e-5 * float(u.abs().sum()), off
        elif bool(u.isnan().any()):
            assert math.isnan(s) and math.isnan(ps), off
        else:
            assert not math.isfinite(s), (off, s, ps)


@pytest.mark.parametrize("pair", COUNT_PAIRS[:5], ids=COUNT_IDS[:5])
@pytest.mark.parametrize("d", COUNT_DS)
def test_residual_launch_matches_plain_and_sweep(dev, d, pair):
    """The K3 residual launch (a warp a selection block) bitwise its plain
    version and the one sweep's ``e'``: at blocks 1024, 2048 and 1001, on
    views at storage offsets 1 and 3, at a mid threshold with ``k_cap``
    below the staged count and above it, at 0 (every block overflows
    bcap) and just above ``max|u|``; in place over ``e`` (or ``g``
    without ``e``) where it has ``e'``'s dtype; one launch counted a
    call."""
    for off in (0, 1, 3):
        g, e = _inputs(d + off, dev, seed=10,
                       pair=(pair[0], pair[1] or F32))
        gv, ev = g[off:], None if pair[1] is None else e[off:]
        a = (gv.float() if ev is None else gv.float() + ev.float()).abs()
        top = a.max()
        above = float(torch.nextafter(top, torch.full_like(top, math.inf)))
        mid = float(a.kthvalue(max(1, d * 99 // 100)).values)
        for block in (1024, 2048, 1001):
            for t, k_cap in ((mid, max(1, d // 200)), (mid, d), (0.0, d),
                             (above, 5)):
                cnt = cr.compact_stage_plain(gv, ev, t, block=block,
                                             bcap=64)[2]
                enc = cr.exclusive_enc(cnt, 64)
                n0 = cr.compact_resid.launches
                got = cr.compact_resid(gv, ev, t, enc, block=block, bcap=64,
                                       k_cap=k_cap)
                assert cr.compact_resid.launches == n0 + 1
                want = cr.compact_resid_plain(gv, ev, t, enc, block=block,
                                              bcap=64, k_cap=k_cap)
                assert _same_bits(got, want), (off, block, t, k_cap)
                sweep = cr.compact_sweep(gv, ev, t, block=block, bcap=64,
                                         k_cap=k_cap)
                assert _same_bits(got, sweep[3]), (off, block, t, "sweep")
                src = gv if ev is None else ev
                if src.dtype != want.dtype:
                    continue   # e' is not e's dtype: no in-place form
                dst = src.clone()
                ins = cr.compact_resid(dst if ev is None else gv,
                                       None if ev is None else dst, t, enc,
                                       block=block, bcap=64, k_cap=k_cap,
                                       out=dst)
                assert ins.data_ptr() == dst.data_ptr()
                assert _same_bits(ins, want), (off, block, t, "in place")


def test_cuda_kernels_take_float32_and_bfloat16_only(dev):
    """Every EF kernel launches on bf16 operands (and no e) and equals its
    plain version there; each raises ``TypeError`` on f16 (or f64), and
    the residual launch on an ``out`` of another dtype than the promoted
    one."""
    g, e = _inputs(4097, dev, seed=6, pair=(BF16, BF16))
    t = float(g.float().abs().median())
    thr = torch.tensor([t, 2 * t], device=dev)
    n0 = {f: f.launches for f in (fm.fused_moments, fm.fused_moments_hist,
                                  tc.tree_count, cr.compact_stage,
                                  cr.compact_resid, cr.compact_sweep,
                                  mom.moments,
                                  cg.count_gt, thc.threshold_compact,
                                  hist.abs_histogram)}
    assert float(fm.fused_moments(g, None, block=2048)[2]) == float(
        fm.fused_moments_plain(g, None, block=2048)[2])
    assert torch.equal(fm.fused_moments_hist(g, None, block=2048)[3],
                       fm.fused_moments_hist_plain(g, None, block=2048)[3])
    assert torch.equal(tc.tree_count(g, None, thr, block=2048),
                       tc.tree_count_plain(g, None, thr, block=2048))
    got = cr.compact_residual(g, None, t, block=2048, bcap=64, k_cap=500)
    vp, op, cp = cr.compact_stage_plain(g, None, t, block=2048, bcap=64)
    rp = cr.compact_resid_plain(g, None, t, cr.exclusive_enc(cp, 64),
                                block=2048, bcap=64, k_cap=500)
    assert got[3].dtype == BF16
    for a, b in zip(got, (vp, op, cp, rp)):
        assert _same_bits(a, b)
    sw = cr.compact_sweep(g, None, t, block=2048, bcap=64, k_cap=500)
    for a, b in zip(sw, (vp, op, cp, rp) + cr.assemble_staging(
            vp, op, cp, 500, block=2048, out_dtype=BF16)):
        assert _same_bits(a, b)
    assert float(mom.moments(g, block=2048)[2]) == float(
        fm.moments_plain(g, 2048)[2])
    assert torch.equal(cg.count_gt(g, t, block=2048),
                       cg.count_gt_plain(g, t, block=2048))
    for a, b in zip(thc.threshold_compact(g, t, block=2048, bcap=64),
                    thc.threshold_compact_plain(g, t, block=2048, bcap=64)):
        assert _same_bits(a, b)
    assert torch.equal(hist.abs_histogram(g),
                       hist.abs_histogram_plain(g, block=2048))
    assert all(f.launches == n + 1 for f, n in n0.items())
    for bad in (torch.float16, torch.float64):
        x = g.to(bad)
        calls = (lambda: fm.fused_moments(x, None, block=1024),
                 lambda: fm.fused_moments_hist(g, x, block=1024),
                 lambda: tc.tree_count(x, None, thr, block=1024),
                 lambda: cr.compact_stage(x, None, t, block=1024, bcap=64),
                 lambda: cr.compact_stage(g, x, t, block=1024, bcap=64),
                 lambda: cr.compact_sweep(x, None, t, block=1024, bcap=64,
                                          k_cap=10),
                 lambda: mom.moments(x, block=1024),
                 lambda: cg.count_gt(x, t, block=1024),
                 lambda: thc.threshold_compact(x, t, block=1024, bcap=64),
                 lambda: hist.abs_histogram(x))
        for call in calls:
            with pytest.raises(TypeError, match="float32 or bfloat16"):
                call()
    enc = torch.zeros(3, dtype=torch.int64, device=dev)
    with pytest.raises(TypeError, match="promoted"):
        cr.compact_resid(g, e, t, enc, block=2048, bcap=64, k_cap=500,
                         out=torch.empty_like(g, dtype=F32))


def test_decode_sum_deterministic_on_card(dev):
    """The rank-order decode of gathered pairs that repeat indices across
    ranks: two runs on the card, and the card against the CPU, bitwise."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    n, k, d = 8, 20_000, 1_000_003
    idx = torch.stack([torch.randperm(d, generator=gen)[:k]
                       for _ in range(n)]).to(torch.int32)[:, None]
    idx[:, :, -100:] = codec.SENTINEL
    vals = torch.randn((n, 1, k), generator=gen)
    vals[:, :, -100:] = 0.0
    assert torch.unique(idx).numel() < n * k   # duplicates across ranks
    a = codec.decode_sum(vals.to(dev), idx.to(dev), d)
    b = codec.decode_sum(vals.to(dev), idx.to(dev), d)
    c = codec.decode_sum(vals, idx, d)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(a.cpu().view(torch.int32), c.view(torch.int32))


def test_gtopk_encode_on_card_matches_cpu(dev):
    from repro_torch.dist import aggregate as agg
    gen = torch.Generator(device="cpu")
    gen.manual_seed(6)
    rows = torch.zeros((2, 100_000))
    rows[0, torch.randperm(100_000, generator=gen)[:3000]] = 1.0  # ties
    rows[1] = torch.randn(100_000, generator=gen)
    rows[1, ::7] = 0.0
    for k_cap in (2000, 5000):
        v, i = agg.encode_rows_topk(rows.to(dev), k_cap)
        cv, ci = agg.encode_rows_topk(rows, k_cap)
        assert torch.equal(i.cpu(), ci) and torch.equal(v.cpu(), cv)


@pytest.mark.parametrize("strategy,mesh", [
    ("allgather", "4x1"), ("gtopk", "4x1"), ("hierarchical", "2x2x1"),
    ("hier_gtopk", "2x2x1")])
def test_local_wire_on_card(dev, strategy, mesh):
    """Four workers in one process on the card (fused kernels): two runs
    bitwise equal; the card against the CPU at the card's block
    geometry within rtol 1e-4 (losses) — the f32 GEMMs sum in other
    orders."""
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data import lm_batch
    from repro_torch.dist.layout import build_layout
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.optim import constant, sgd_momentum
    from repro_torch.train import init_train_state, make_train_step
    cfg = ModelConfig(name="sys", arch_type="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=64).validate()
    comp = CompressionConfig(ratio=0.01, strategy=strategy)
    base = init_params(cfg, 0, "cpu")

    def run(device):
        params = tree.tree_map(lambda x: x.clone().to(device), base)
        layout = build_layout(params, 1, comp)
        opt = sgd_momentum(0.9)
        state = init_train_state(params, opt, workers=4, model_size=1,
                                 compression=comp, layout=layout)
        step = make_train_step(cfg, mesh, opt, constant(0.1),
                               compression=comp, layout=layout)
        losses = []
        with tuning.geometry_of("cuda"):
            for i in range(2):
                b = lm_batch(i, global_batch=8, seq_len=16,
                             vocab=cfg.vocab_size, device=device)
                state, m = step(state, b)
                losses.append(float(m["loss"]))
        return losses, state

    l1, s1 = run(dev)
    l2, s2 = run(dev)
    lc, _ = run("cpu")
    assert l1 == l2
    assert torch.equal(s1["resid"].view(torch.int32),
                       s2["resid"].view(torch.int32))
    assert torch.allclose(torch.tensor(l1), torch.tensor(lc), rtol=1e-4)


@pytest.mark.parametrize("strategy,mesh,policy", [
    ("allgather", "1x1", "variance"), ("allgather", "4x1", None),
    ("gtopk", "4x1", None), ("hierarchical", "2x2x1", "variance"),
    ("hier_gtopk", "2x2x1", None)])
def test_chunked_and_perleaf_on_card(dev, strategy, mesh, policy):
    """The chunked schedule (chunks 3: the hooks release each chunk during
    the backward on the card) and the per-leaf loop on the card (fused
    kernels), bitwise the bucketed run on the card: params, momentum and
    residuals (the per-leaf tree packed); collectives a step 3 or 12
    a wire level."""
    from repro_torch.core.adaptk import make_policy
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.data import lm_batch
    from repro_torch.dist.layout import build_layout, pack_residual_arrays
    from repro_torch.launch.mesh import data_world_size, parse_mesh
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.optim import constant, sgd_momentum
    from repro_torch.train import init_train_state, make_train_step
    cfg = ModelConfig(name="sys", arch_type="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=64).validate()
    pol = make_policy(policy, ema=0.5) if policy else None
    W = data_world_size(parse_mesh(mesh))

    def run(chunks, perleaf):
        comp = CompressionConfig(ratio=0.01, strategy=strategy,
                                 density_policy=pol, chunks=chunks)
        params = init_params(cfg, 0, dev)
        layout = build_layout(params, 1, comp)
        opt = sgd_momentum(0.9)
        state = init_train_state(params, opt, workers=W, model_size=1,
                                 compression=comp,
                                 layout=None if perleaf else layout)
        step = make_train_step(cfg, mesh, opt, constant(0.1),
                               compression=comp,
                               layout=None if perleaf else layout)
        out = []
        for i in range(2):
            b = lm_batch(i, global_batch=8, seq_len=16,
                         vocab=cfg.vocab_size, device=dev)
            state, m = step(state, b)
            out.append({k: float(v) for k, v in m.items()})
        resid = {k: (state[k].cpu().numpy() if not perleaf else
                     pack_residual_arrays(layout, [
                         x.cpu().numpy() for x in tree.leaves(state[k])]))
                 for k in ("resid", "resid2") if k in state}
        return out, state, resid

    base, s0, r0 = run(1, False)
    levels = 2 if strategy != "allgather" else 1
    for chunks, perleaf, coll in ((3, False, 3), (1, True, 12)):
        ms, s, r = run(chunks, perleaf)
        for key in ("params", "opt"):
            for a, b in zip(tree.leaves(s0[key]), tree.leaves(s[key])):
                assert torch.equal(a, b), (chunks, perleaf, key)
        assert sorted(r) == sorted(r0)
        for key in r0:
            assert r[key].tobytes() == r0[key].tobytes(), key
        for a, b in zip(base, ms):
            assert b.pop("collectives_per_step") == coll * levels
            a = dict(a)
            a.pop("collectives_per_step")
            assert a == b


def test_process_group_wire_nccl_bitwise_local(dev, tmp_path):
    """One worker per card over NCCL (2 or 4 cards, the trainer under a
    ``torchrun``-style environment, ``tests/_torch_dist_pg.py``) against
    the same workers in one process on card 0: checkpoints (params,
    momentum, every worker's residuals) and losses bitwise equal."""
    import json
    import os
    import socket
    import subprocess
    import sys

    import numpy as np

    from repro_torch.launch import train as cli
    W = min(4, torch.cuda.device_count())
    if W < 2:
        pytest.skip("needs two CUDA devices")
    meshes = {"allgather": f"{W}x1", "gtopk": f"{W}x1",
              "hierarchical": f"2x{W // 2}x1", "hier_gtopk": f"2x{W // 2}x1"}
    tests = os.path.dirname(os.path.abspath(__file__))
    cases = []
    for s, m in meshes.items():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            cases.append(f"{s}:{m}:{sock.getsockname()[1]}")
    procs = []
    for r in range(W):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(W),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(W),
                   MASTER_ADDR="127.0.0.1",
                   PYTHONPATH=os.path.join(os.path.dirname(tests), "src"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(tests, "_torch_dist_pg.py"),
             str(tmp_path), "cuda"] + cases, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=900)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    assert "wire=process_group dist_backend=nccl" in logs[0]
    for strategy, mesh in meshes.items():
        name = f"{strategy}-{mesh}"
        local = tmp_path / f"local-{name}.npz"
        recs = cli.run(["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1",
                        "--density-policy", "none", "--steps", "2",
                        "--batch", "4", "--seq", "16", "--mesh", mesh,
                        "--strategy", strategy, "--host-devices", str(W),
                        "--checkpoint", str(local)])
        with np.load(local) as a, np.load(tmp_path / f"{name}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].tobytes() == b[key].tobytes(), (name, key)
        with open(tmp_path / f"{name}.json") as f:
            pg = json.load(f)
        assert [r["loss"] for r in recs] == [r["loss"] for r in pg]


@pytest.mark.parametrize("n", [1, 1023, 1025, 4_000_037])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_threefry_bits_matches_plain_version(dev, n, dtype):
    """Slice 4's PRNG kernel: the draws (int32) and the rank keys (int64)
    bitwise its plain version, at counts that are not multiples of the
    block."""
    from repro_torch.kernels.prng import threefry_bits, threefry_bits_plain
    key = (0x9E3779B9, 0xFFFFFFFF)
    out = torch.empty(n, dtype=dtype, device=dev)
    before = threefry_bits.launches
    threefry_bits(key, out)
    assert threefry_bits.launches == before + 1
    torch.cuda.synchronize()
    want = threefry_bits_plain(key, 0, n, rank=dtype == torch.int64)
    assert torch.equal(out.cpu(), want)


def test_prng_known_answers_on_card(dev):
    """jax.random's partitionable known answers, drawn on the card."""
    from repro_torch import prng
    assert prng.bits(prng.PRNGKey(42), (4,), device=dev).tolist() == [
        2098992034, 2919706841, 2646866425, 2409546199]
    assert prng.randint(prng.PRNGKey(7), (4,), 0, 262668288,
                        device=dev).tolist() == [10325791, 133713254,
                                                 116150652, 246431725]
    u = prng.uniform(prng.PRNGKey(0), (3,), device=dev).cpu()
    assert torch.equal(u, prng.uniform(prng.PRNGKey(0), (3,), device="cpu"))


@pytest.mark.parametrize("name", ["randk", "dgck", "rtopk"])
@pytest.mark.parametrize("d,k", [(4097, 41), (1_000_003, 1000)])
def test_keyed_compressors_on_card_match_cpu(dev, name, d, k):
    """The key-sampled selections on the card bitwise the CPU's from the
    same key (randk through the threefry_bits kernel)."""
    from repro_torch import prng
    from repro_torch.core.compressors import get_compressor
    from repro_torch.kernels.prng import threefry_bits
    g, _ = _inputs(d, dev, seed=5)
    key = prng.fold_in(prng.PRNGKey(3), d)
    before = threefry_bits.launches
    v, i = get_compressor(name).select(g, k, key)
    assert (threefry_bits.launches > before) == (name == "randk")
    cv, ci = get_compressor(name).select(g.cpu(), k, key)
    assert torch.equal(i.cpu(), ci) and torch.equal(v.cpu(), cv)


def test_paper_inits_on_card_match_cpu(dev):
    """``init_fnn`` (``uniform``) bitwise and ``init_params`` (``normal``)
    within rtol 1e-5, the card's ``threefry_bits`` against the CPU."""
    from repro_torch import prng
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.models.fnn import init_fnn
    for a, b in zip(tree.leaves(init_fnn(prng.PRNGKey(3), device=dev)),
                    tree.leaves(init_fnn(prng.PRNGKey(3), device="cpu"))):
        assert torch.equal(a.cpu(), b)
    cfg = ModelConfig(name="sys", arch_type="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=64).validate()
    for a, b in zip(tree.leaves(init_params(cfg, 5, dev)),
                    tree.leaves(init_params(cfg, 5, "cpu"))):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", ["topk", "gaussiank", "randk", "rtopk"])
def test_paper_simulation_on_card_matches_cpu(dev, name):
    """FNN-3's Eq. (2) simulation, W = 2, 3 steps: losses within rtol
    1e-4 of the CPU's, the wire equal (Gaussian-k within 1% a step)."""
    from repro_torch.benchmarks.common import simulate_sparsified_sgd
    lc, _, cc, _ = simulate_sparsified_sgd(name, workers=2, ratio=0.005,
                                           steps=3, device=dev)
    lh, _, ch, _ = simulate_sparsified_sgd(name, workers=2, ratio=0.005,
                                           steps=3, device="cpu")
    torch.testing.assert_close(torch.tensor(lc), torch.tensor(lh),
                               rtol=1e-4, atol=0)
    for a, b in zip(cc, ch):
        assert abs(a - b) <= (0.01 * b if name == "gaussiank" else 0)


def _serve_cfg():
    from repro_torch.models import ModelConfig
    return ModelConfig(name="sw", arch_type="dense", num_layers=2,
                       d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                       vocab_size=64, block_pattern=("swa", "attn"),
                       sliding_window=4).validate()


def test_prefill_and_decode_on_card_match_cpu(dev):
    """Prompt 8 over a window of 4, then 6 decode steps: logits within
    rtol 1e-4, atol 1e-5 of the CPU's from the same weights, the argmax
    tokens equal."""
    from repro_torch import prng
    from repro_torch.models import decode_step, init_params, prefill
    cfg = _serve_cfg()
    base = init_params(cfg, 0, "cpu")
    prompt = prng.randint(prng.PRNGKey(4), (2, 8), 0, 64, device="cpu")
    out = {}
    for d in (dev, torch.device("cpu")):
        p = tree.tree_map(lambda x: x.to(d), base)
        logits, cache, _ = prefill(p, cfg, prompt.to(d), s_max=14)
        ls = [logits.cpu()]
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks = [tok.cpu()]
        for pos in range(8, 14):
            logits, cache = decode_step(p, cfg, cache, pos, tok)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            ls.append(logits.cpu())
            toks.append(tok.cpu())
        out[d.type] = (ls, toks)
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("compressor,backend", [("topk", "auto"),
                                                ("gaussiank", "fused")])
def test_publisher_on_card_matches_cpu(dev, compressor, backend):
    """Six publishes of the same drifting params (resyncs at 0 and 4) on
    the card and on the CPU at the card's block geometry: the messages,
    ``pub`` and ``resid`` bitwise; on the card ``pub`` equals the packed
    replica bitwise at every tick."""
    from repro_torch import prng
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.dist.layout import build_layout, pack_grads
    from repro_torch.models import init_params
    from repro_torch.serve import (apply_message, init_publisher_state,
                                   publish)
    cfg = _serve_cfg()
    params = init_params(cfg, 0, "cpu")
    config = CompressionConfig(compressor=compressor, ratio=0.01,
                               backend=backend)
    layout = build_layout(params, 1, config)
    st = {d: init_publisher_state(layout, device=d) for d in ("cuda", "cpu")}
    rep = tree.tree_map(lambda x: torch.zeros_like(x, device=dev), params)
    with tuning.geometry_of("cuda"):
        for t in range(6):
            params = tree.tree_map(
                lambda x: x + 0.01 * torch.sin(x * float(t + 1)), params)
            msgs = {}
            for d in ("cuda", "cpu"):
                p = tree.tree_map(lambda x: x.to(d), params)
                st[d], msgs[d] = publish(st[d], p, layout, config,
                                         prng.PRNGKey(7), resync_every=4)
            for a, b in zip(msgs["cuda"][2:], msgs["cpu"][2:]):
                assert (a is None) == (b is None)
                if a is not None:
                    assert torch.equal(a.cpu(), b), t
            for k in ("pub", "resid"):
                assert torch.equal(st["cuda"][k].cpu(), st["cpu"][k]), (t, k)
            rep = apply_message(rep, layout, msgs["cuda"])
            assert torch.equal(pack_grads(layout, rep, torch.float32),
                               st["cuda"]["pub"]), t


def test_serve_cli_on_card(dev, capsys):
    """``launch.serve.run`` on the card: the stream's counters as on the
    CPU, ``pub`` equal to the packed replica at every publish."""
    from repro_torch.dist.layout import pack_grads
    from repro_torch.launch import serve
    seen = []

    def probe(event, msg, layout, state, trainer, replica):
        seen.append(torch.equal(state["pub"], pack_grads(
            layout, replica, torch.float32)))

    argv = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1", "--requests",
            "4",
            "--max-batch", "2", "--prompt-len", "8", "--gen", "6",
            "--publish-every", "2", "--resync-every", "3"]
    got = serve.run(argv, probe=probe)
    ref = serve.run(argv + ["--device", "cpu"])
    for k in ("done", "waves", "tokens_out", "deltas", "resyncs",
              "wire_bits"):
        assert got[k] == ref[k], k
    assert seen and all(seen)
    capsys.readouterr()


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-1.5-large-398b",
                                  "xlstm-125m", "musicgen-medium"])
def test_new_archs_on_card_match_cpu(dev, arch):
    """Slice 8's smoke variants: the loss and every gradient on the card
    within rtol 1e-4, atol 1e-6 of the CPU's from the same weights and
    batch; a second backward on the card is bitwise the first (the MoE
    dispatch and combine have no atomic scatter)."""
    from repro_torch.configs import get_config
    from repro_torch.data import batch_for
    from repro_torch.models import init_params, loss_fn
    cfg = get_config(arch).reduced()
    base = init_params(cfg, 0, "cpu")
    batch = batch_for(cfg, 0, global_batch=4, seq_len=16, device="cpu")
    out = {}
    for d, rep in ((dev, 0), (dev, 1), (torch.device("cpu"), 0)):
        leaves, td = tree.flatten(tree.tree_map(lambda x: x.to(d), base))
        ps = [p.requires_grad_(True) for p in leaves]
        loss, _ = loss_fn(tree.unflatten(td, ps), cfg,
                          {k: v.to(d) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
        out[(d.type, rep)] = (loss.detach().cpu(), [
            (torch.zeros_like(p) if g is None else g).cpu()
            for p, g in zip(ps, grads)])
    torch.testing.assert_close(out[("cuda", 0)][0], out[("cpu", 0)][0],
                               rtol=1e-4, atol=0)
    for a, b, c in zip(out[("cuda", 0)][1], out[("cuda", 1)][1],
                       out[("cpu", 0)][1]):
        assert torch.equal(a, b)
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-6)


def test_profile_tensor_parallel_on_card(dev):
    """``launch/profile.py`` under ``torchrun --nproc-per-node 2 ...
    --mesh 1x2`` (NCCL with two cards, else gloo on the one): its JSON
    line holds both ranks' and the slowest rank's medians of every
    phase of the tensor-parallel step and of the step, each finite and
    >= 0."""
    import json
    import os
    import subprocess
    import sys

    from repro_torch.launch.profile import TP_PHASES
    tests = os.path.dirname(os.path.abspath(__file__))
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(os.path.dirname(tests), "src"))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.profile",
         "--arch", "deepseek-moe-16b", "--smoke", "--mesh", "1x2",
         "--steps", "2", "--batch", "4", "--seq", "16",
         "--dist-backend", backend],
        env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    doc = json.loads([ln for ln in r.stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert doc["tensor_parallel"] and doc["model_size"] == 2
    assert len(doc["phase_ms_by_rank"]) == 2
    for ms in [r["phase_ms"] for r in doc["phase_ms_by_rank"]] + [
            doc["phase_ms_slowest"]]:
        assert set(ms) == set(TP_PHASES) | {"step"}
        assert all(math.isfinite(v) and v >= 0 for v in ms.values()), ms


def test_sharded_decode_on_card(dev, tmp_path):
    """``launch.serve`` under ``torchrun --nproc-per-node 2 ... --mesh
    1x2`` (NCCL with two cards, else gloo on the one), streaming: each
    rank prefills and decodes on its half of every weight and of the KV
    cache, and rank 0's tokens and counters equal the one-process run's
    on the card."""
    import json
    import os
    import subprocess
    import sys

    from repro_torch.launch import serve
    tests = os.path.dirname(os.path.abspath(__file__))
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    argv = ["--arch", "llama3.2-1b", "--smoke", "--requests", "3",
            "--max-batch", "2", "--prompt-len", "8", "--gen", "6",
            "--publish-every", "2", "--resync-every", "2"]
    script = tmp_path / "serve_tokens.py"
    script.write_text(
        "import json, os, sys\n"
        "from repro_torch.launch import serve\n"
        "got = serve.run(sys.argv[1:])\n"
        "if os.environ['RANK'] == '0':\n"
        "    print(json.dumps({'tokens': [t.tolist() for t in "
        "got['tokens']], 'counts': [got[k] for k in ('tokens_out', "
        "'deltas', 'resyncs', 'wire_bits')]}))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(os.path.dirname(tests), "src"))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", str(script), "--mesh", "1x2",
         "--dist-backend", backend] + argv,
        env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "model=2 (a shard a rank, mode 2d)" in r.stdout
    got = json.loads([ln for ln in r.stdout.splitlines()
                      if ln.startswith("{")][-1])
    ref = serve.run(argv + ["--mesh", "1x1"])
    assert got["tokens"] == [t.tolist() for t in ref["tokens"]]
    assert got["counts"] == [ref[k] for k in ("tokens_out", "deltas",
                                              "resyncs", "wire_bits")]


@pytest.mark.parametrize("window", [0, 300])
def test_chunked_attention_on_card(dev, window, monkeypatch):
    """Query-chunked attention at T = 2048 (two blocks of 1024) on the
    card against the one-block run there: the output and the cached
    keys and values within rtol 1e-5, atol 1e-6 (cuBLAS may tile a
    shorter GEMM another way), every gradient within 2**-20 of its
    largest magnitude (the blocks' contributions to the keys' and
    values' gradients are summed block by block); prints whether each
    is bitwise."""
    from repro_torch.models import ModelConfig
    from repro_torch.models import layers as L
    cfg = ModelConfig(name="attn", arch_type="dense", num_layers=1,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=64).validate()
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    shapes = {"wq": (64, 64), "wk": (64, 32), "wv": (64, 32),
              "wo": (64, 64)}
    p = {k: torch.randn(s, generator=gen, device=dev) / 8
         for k, s in shapes.items()}
    x = torch.randn((2, 2048, 64), generator=gen, device=dev)
    ct = torch.randn((2, 2048, 64), generator=gen, device=dev) / 4096

    def run():
        ps = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        tx = x.clone().requires_grad_(True)
        out, (k, v) = L.attention(ps, tx, cfg, window=window)
        grads = torch.autograd.grad(out, [tx] + [ps[n] for n in shapes],
                                    ct)
        return [out.detach(), k.detach(), v.detach()] + list(grads)

    chunked = run()
    monkeypatch.setattr(L, "_SDPA_CHUNK", 4096)
    one = run()
    names = ("out", "k", "v", "x") + tuple(shapes)
    print({n: torch.equal(a, b) for n, a, b in zip(names, chunked, one)})
    for n, a, b in zip(names[:3], chunked, one):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=n)
    for n, a, b in zip(names[3:], chunked[3:], one[3:]):
        bound = 2.0 ** -20 * float(b.abs().max())
        assert float((a - b).abs().max()) <= bound, n
