"""The port's adaptive-density controller (``repro_torch.core.adaptk``, the
f32 warmup of ``optim/schedules.py`` and the f32 helpers of
``repro_torch.f32``) against ``repro.core.adaptk`` on the same inputs.

Tolerance: none.  Every comparison is bitwise: the budgets, bounds,
signals, EMA blends, global scales, allocations and warmup multipliers
are the reference's own f32 arithmetic repeated on the host, against
the reference's functions called as written (op by op; compiled inside
a jitted step, XLA fuses multiply-adds and multiplies by reciprocals of
constants, which can move a result by one ulp).  XLA's f32 ``exp`` and
``log`` are not numpy's: ``f32.exp``/``f32.log`` are held bitwise
against ``jnp.exp``/``jnp.log`` here.

One case cannot be bitwise and says so: ``allocate`` over more than 32
leaves, where XLA sums the leaves' clipped shares in another order than
the left-to-right sum the port uses (which equals XLA's up to 32; the
port's models have 12 leaves).  There ``sum(k) == K_eff`` exactly and
each ``k`` is within 1 of the reference's.  The Gaussian thresholds
(``ndtri`` against ``norm.ppf``) are within rtol 1e-6, and the pairs
are compared where they agree to the bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptk as ja
from repro.core import compressors as jc
from repro.kernels.ef_fused import ops as jops
from repro.optim.schedules import density_warmup as j_warmup
from repro_torch import f32
from repro_torch.configs import get_config
from repro_torch.core import adaptk as ta
from repro_torch.core import compressors as tc
from repro_torch.core.compressors import get_compressor
from repro_torch.kernels.ef_fused import ops as tops
from repro_torch.models import init_params
from repro_torch.optim import density_warmup

torch.set_num_threads(2)


def _llama_sizes():
    """The 12 segment sizes of llama3.2-1b at full width and depth."""
    params = init_params(get_config("llama3.2-1b"), 0, "meta")
    from repro_torch import tree
    return [int(x.numel()) for x in tree.leaves(params)]


# ---------------------------------------------------------------------------
# f32 helpers and the warmup
# ---------------------------------------------------------------------------


def test_f32_exp_log_fma_are_xlas():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(0, 7, 200_000),
                        rng.uniform(-10, 10, 100_000)]).astype(np.float32)
    np.testing.assert_array_equal(f32.exp(x), np.asarray(jnp.exp(x)))
    xs = np.concatenate([rng.uniform(1, 1e4, 200_000),
                         rng.uniform(1e-3, 1, 50_000),
                         rng.uniform(1, 2, 50_000)]).astype(np.float32)
    np.testing.assert_array_equal(f32.log(xs), np.asarray(jnp.log(xs)))
    a, b, c = (rng.standard_normal(200_000).astype(np.float32)
               for _ in range(3))
    # XLA's compiled a·b + c is one fused multiply-add
    np.testing.assert_array_equal(
        f32.fma(a, b, c),
        np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c)))
    with pytest.raises(ValueError, match="positive normal"):
        f32.log(np.float32(0.0))


@pytest.mark.parametrize("mult,warmup", [(16.0, 10), (16.0, 3), (4.0, 7),
                                         (1000.0, 20), (2.5, 1), (1.0, 5),
                                         (0.5, 4), (32.0, 0)])
def test_density_warmup_is_the_references_f32(mult, warmup):
    """The multiplier is the reference's f32 value, bitwise, at steps
    0-20 (an f64 version differs at 9 of steps 0-11 of ``(16.0, 10)``:
    15.999999999999998 at step 0)."""
    j, t = j_warmup(mult, warmup), density_warmup(mult, warmup)
    for step in range(21):
        want = np.float32(j(jnp.int32(step)))
        got = t(step)
        assert isinstance(got, np.float32)
        assert got.tobytes() == want.tobytes(), (step, got, want)


# ---------------------------------------------------------------------------
# policy, bounds, budget, signal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(policy="bogus"), dict(floor_mult=0.0), dict(floor_mult=1.5),
    dict(ceil_mult=0.5), dict(ema=1.0), dict(ema=-0.1),
    dict(warmup_steps=-1), dict(warmup_mult=0.5),
    dict(global_policy="bogus"), dict(global_ema=1.0),
    dict(global_floor=0.0), dict(global_floor=2.0)])
def test_make_policy_errors_match(kwargs):
    with pytest.raises(ValueError) as jerr:
        ja.make_policy(**kwargs)
    with pytest.raises(ValueError) as terr:
        ta.make_policy(**kwargs)
    assert str(terr.value) == str(jerr.value)


def test_vocabulary_and_policy_fields_match():
    assert ta.POLICIES == ja.POLICIES
    assert ta.GLOBALK_POLICIES == ja.GLOBALK_POLICIES
    assert ta.DYNAMIC_COMPRESSORS == ja.DYNAMIC_COMPRESSORS
    assert "trimmedk" not in ta.DYNAMIC_COMPRESSORS
    kw = dict(floor_mult=0.5, ceil_mult=3.0, ema=0.5, warmup_steps=4,
              warmup_mult=8.0, global_policy="normdecay", global_ema=0.8,
              global_floor=0.3)
    assert tuple(ta.make_policy("absmax", **kw)) == \
        tuple(ja.make_policy("absmax", **kw))
    assert ta.make_policy("absmax", **kw).cap_mult == 8.0
    for name in ("topk", "gaussiank", "gaussiank2", "histk", "trimmedk"):
        assert ta.supports_dynamic(get_compressor(name)) == \
            ja.supports_dynamic(jc.get_compressor(name))


def test_leaf_bounds_match():
    rng = np.random.default_rng(1)
    pols = [ja.make_policy(), ja.make_policy(floor_mult=1.0, ceil_mult=1.0),
            ja.make_policy(floor_mult=0.1, warmup_steps=3,
                           warmup_mult=16.0)]
    for d in list(rng.integers(1, 10**9, 200)) + [1, 2, 3, 1000, 2**24 + 3]:
        for ratio in (0.001, 0.01, 0.3, 1.0):
            for p in pols:
                tp = ta.DensityPolicy(*p)
                assert ta.leaf_bounds(int(d), ratio, tp) == \
                    ja.leaf_bounds(int(d), ratio, p)


@pytest.mark.parametrize("dims_name", ["llama", "small", "odd"])
def test_budget_matches_with_and_without_warmup(dims_name):
    """Bitwise at steps 0-20: the f64 base rounded to f32, times the f32
    multiplier, rounded half to even (at llama3.2-1b's 1,498,482,688
    columns f64 arithmetic gives 23,975,723 at step 0 of a 16x
    warmup; the reference gives 23,975,724)."""
    dims = {"llama": _llama_sizes(), "small": [4096, 64, 8192, 8192],
            "odd": [16_777_219, 3, 12_345_677]}[dims_name]
    for ratio in (0.001, 0.01, 0.0137):
        p = ja.make_policy()
        assert int(ta.budget(dims, ratio, ta.DensityPolicy(*p))) == \
            int(ja.budget(dims, ratio, p))
        for mult, warm in ((16.0, 10), (4.0, 3), (100.0, 7)):
            p = ja.make_policy(warmup_steps=warm, warmup_mult=mult)
            tp = ta.DensityPolicy(*p)
            for step in range(21):
                assert int(ta.budget(dims, ratio, tp, step)) == \
                    int(ja.budget(dims, ratio, p, jnp.int32(step))), step
    if dims_name == "llama":
        p = ja.make_policy(warmup_steps=10, warmup_mult=16.0)
        assert int(ta.budget(dims, 0.001, ta.DensityPolicy(*p), 0)) == \
            23_975_724
    with pytest.raises(ValueError, match="step="):
        ta.budget(dims, 0.001, ta.make_policy(warmup_steps=2))


def test_leaf_signal_matches():
    rng = np.random.default_rng(2)
    for _ in range(300):
        d = int(rng.choice([7, 4096, 2**24 + 3, 268_435_456, 12_345_677]))
        s = np.float32(rng.standard_normal() * 10.0 ** rng.integers(-4, 3))
        sq = np.float32(abs(rng.standard_normal()) * 10.0 **
                        rng.integers(-6, 4))
        mx = np.float32(abs(rng.standard_normal()))
        for pol in ta.POLICIES:
            want = np.float32(ja.leaf_signal(pol, d, jnp.float32(s),
                                             jnp.float32(sq),
                                             jnp.float32(mx)))
            got = ta.leaf_signal(pol, d, s, sq, mx)
            assert np.float32(got).tobytes() == want.tobytes(), (pol, d)
    with pytest.raises(ValueError):
        ta.leaf_signal("bogus", 3, 1.0, 1.0, 1.0)


# ---------------------------------------------------------------------------
# controller state: EMA blend, global-k scale
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ema", [0.0, 0.5, 0.9, 0.77])
def test_blend_signal_matches(ema):
    rng = np.random.default_rng(3)
    n = 12
    jstate = ja.init_controller_state(n)
    tstate = ta.init_controller_state(n)
    for step in range(5):
        fresh = (np.abs(rng.standard_normal(n)) * 1e3).astype(np.float32)
        jb, jstate = ja.blend_signal(jstate, jnp.asarray(fresh), ema)
        tb, tstate = ta.blend_signal(tstate, fresh, ema)
        np.testing.assert_array_equal(tb, np.asarray(jb))
        np.testing.assert_array_equal(tstate["signal"],
                                      np.asarray(jstate["signal"]))
        assert int(tstate["count"]) == int(jstate["count"]) == step + 1
    fresh = np.ones(n, np.float32)
    assert ta.blend_signal(None, fresh, ema)[1] is None


def test_global_scale_matches():
    rng = np.random.default_rng(4)
    for ge, floor in ((0.9, 0.25), (0.5, 0.6), (0.0, 1.0)):
        jp = ja.make_policy(global_policy="normdecay", global_ema=ge,
                            global_floor=floor)
        tp = ta.DensityPolicy(*jp)
        js = ja.init_controller_state(3, global_k=True)
        ts = ta.init_controller_state(3, global_k=True)
        for sq in [0.0, 5.0] + list(np.abs(rng.standard_normal(6)) * 3.0):
            jscale, jupd = ja.global_scale(js, jnp.float32(sq), jp)
            tscale, tupd = ta.global_scale(ts, sq, tp)
            assert np.float32(tscale).tobytes() == \
                np.float32(jscale).tobytes()
            for key in ("gnorm", "gnorm0"):
                assert np.float32(tupd[key]).tobytes() == \
                    np.float32(jupd[key]).tobytes()
            js, ts = {**js, **jupd}, {**ts, **tupd}
            K = np.int32(23_975_724)
            assert int(ta.scale_budget(K, tscale)) == \
                int(ja.scale_budget(jnp.int32(K), jscale))
    assert ta.global_scale(None, 1.0, ta.make_policy())[0] == 1.0
    with pytest.raises(ValueError, match="global_k=True"):
        ta.global_scale(ta.init_controller_state(3), 1.0,
                        ta.make_policy(global_policy="normdecay"))


# ---------------------------------------------------------------------------
# allocate
# ---------------------------------------------------------------------------


def _bounds(dims, ratio, pol):
    lo, hi = zip(*(ja.leaf_bounds(d, ratio, pol) for d in dims))
    return list(lo), list(hi)


def _check_alloc(K, w, lo, hi, exact=True):
    jk, jK = ja.allocate(jnp.int32(K), jnp.asarray(w, jnp.float32), lo, hi)
    tk, tK = ta.allocate(np.int32(K), np.asarray(w, np.float32), lo, hi)
    jk = np.asarray(jk)
    assert tk.dtype == np.int32 and int(tK) == int(jK)
    assert int(tk.sum()) == int(tK)
    assert np.all(tk >= np.asarray(lo)) and np.all(tk <= np.asarray(hi))
    if exact:
        np.testing.assert_array_equal(tk, jk)
    else:
        assert np.max(np.abs(tk.astype(np.int64) - jk)) <= 1
    return tk


@pytest.mark.parametrize("seed", range(12))
def test_allocate_seeded_cases_bitwise(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.choice([1, 2, 5, 12, 20, 32]))
    dims = [int(x) for x in rng.integers(1, 3_000_000, n)]
    ratio = float(rng.choice([0.001, 0.01, 0.05]))
    pol = ja.make_policy(floor_mult=float(rng.choice([0.1, 0.25, 1.0])),
                         ceil_mult=float(rng.choice([1.0, 2.0, 4.0])))
    lo, hi = _bounds(dims, ratio, pol)
    K = int(ja.budget(dims, ratio, pol))
    w = np.exp(rng.normal(0, 3, n)).astype(np.float32) * 1e-3
    for KK in (K, int(K * 1.7), int(K * 0.6) + 1):
        _check_alloc(KK, w, lo, hi)


def test_allocate_property_cases_bitwise():
    rng = np.random.default_rng(7)
    dims = [4096, 64, 8192, 8192, 3, 1, 500_000, 12_345]
    pol = ja.make_policy()
    lo, hi = _bounds(dims, 0.01, pol)
    K = int(ja.budget(dims, 0.01, pol))
    w = rng.uniform(0, 5, len(dims)).astype(np.float32)
    cases = {
        "some zero weights": np.where(np.arange(len(dims)) % 3 == 0, 0.0,
                                      w),
        "all zero weights": np.zeros(len(dims)),
        "negative weights": -w,
        "one weight": np.eye(len(dims))[2] * 3.0,
        "equal weights": np.ones(len(dims)),
        "huge spread": np.array([1e-30, 1e30, 1.0, 0.0, 5e-20, 7.0, 1e10,
                                 2.0]),
    }
    for name, ww in cases.items():
        for KK in (K, 0, sum(lo) - 1, sum(lo), sum(hi), sum(hi) + 10**6,
                   K // 3, 2 * K):
            _check_alloc(KK, ww, lo, hi)
    # lo == hi leaves (nothing to move) beside movable ones
    lo2 = [5, 5, 1, 7, 2]
    hi2 = [5, 9, 1, 30, 2]
    for KK in range(18, 50, 3):
        _check_alloc(KK, [1.0, 2.0, 3.0, 0.5, 9.0], lo2, hi2)
        _check_alloc(KK, [0.0] * 5, lo2, hi2)


def test_allocate_llama_segments_bitwise():
    dims = _llama_sizes()
    assert len(dims) == 12
    rng = np.random.default_rng(8)
    for pol in (ja.make_policy(), ja.make_policy(floor_mult=0.5,
                                                 ceil_mult=2.0),
                ja.make_policy(warmup_steps=10, warmup_mult=16.0)):
        lo, hi = _bounds(dims, 0.001, pol)
        for step in (0, 3, 10):
            K = int(ja.budget(dims, 0.001, pol, jnp.int32(step)))
            for _ in range(4):
                w = (np.asarray(dims) * np.exp(rng.normal(0, 2, 12)) *
                     1e-9).astype(np.float32)
                _check_alloc(K, w, lo, hi)


@pytest.mark.parametrize("n", [33, 64, 150])
def test_allocate_many_leaves_budget_exact(n):
    """More than 32 leaves: XLA's f32 sum of the clipped shares runs in
    another order than the port's left-to-right one, so the bisection
    may end an ulp apart; ``sum(k) == K_eff`` still holds exactly and
    each ``k`` is within 1 of the reference's."""
    rng = np.random.default_rng(n)
    dims = [int(x) for x in rng.integers(100, 1_000_000, n)]
    pol = ja.make_policy()
    lo, hi = _bounds(dims, 0.01, pol)
    K = int(ja.budget(dims, 0.01, pol))
    for _ in range(5):
        w = np.exp(rng.normal(0, 2, n)).astype(np.float32)
        _check_alloc(K, w, lo, hi, exact=False)


def test_allocate_rejects_bad_bounds():
    with pytest.raises(ValueError, match="matching 1-D"):
        ta.allocate(3, [1.0, 1.0], [1, 1], [2, 2, 2])


# ---------------------------------------------------------------------------
# per-step k in the threshold glue (f32, as a traced int32)
# ---------------------------------------------------------------------------

# leaf sizes that are not f32-exact (above 2^24, not a multiple of a
# power of two) and llama3.2-1b's own
_DS = [16_777_219, 50_331_657, 268_435_457, 1_498_482_689, 268_435_456,
       33_554_432]


def test_dynamic_k_threshold_terms_are_f32():
    """``p`` and the accept band for an ``np.int32`` k are the reference's
    f32 values for a traced int32 (the expressions of
    ``ops.py:125-126,154`` and ``compressors.py:86-90`` on a
    ``jnp.int32``); a static int keeps the one-rounding f64 value.  On
    these sizes the two differ, which is why the port tells them
    apart."""
    rng = np.random.default_rng(9)
    differ = 0
    for d in _DS:
        ks = np.concatenate([rng.integers(1, 4 * d // 1000, 300),
                             [1, 7]]).astype(np.int32)
        kj = jnp.asarray(ks)
        for two_sided in (False, True):
            want = np.asarray(1.0 - (kj / (2.0 * d) if two_sided
                                     else kj / d))
            for k, w in zip(ks, want):
                got = tc.gaussian_ppf_p(k, d, two_sided)
                assert got.tobytes() == w.tobytes(), (d, k, two_sided)
                differ += got != tc.gaussian_ppf_p(int(k), d, two_sided)
        jlo, jhi = np.asarray(2.0 * kj / 3.0), np.asarray(4.0 * kj / 3.0)
        for k, wl, wh in zip(ks, jlo, jhi):
            lo, hi = tc.accept_band(k)
            assert (lo.tobytes(), hi.tobytes()) == (wl.tobytes(),
                                                   wh.tobytes()), k
    assert differ > 0


def test_dynamic_k_replay_matches_reference():
    """The refinement replay with an ``np.int32`` k against the
    reference's with a ``jnp.int32``, counts placed at the band
    edges."""
    rng = np.random.default_rng(10)
    heap = np.asarray(jops._tree_thresholds(jnp.float32(0.37), 4)[0])
    for k in list(rng.integers(1, 3_000_000, 60)) + [1, 2, 3, 4095]:
        k = int(k)
        lo, hi = 2.0 * k / 3.0, 4.0 * k / 3.0
        picks = [np.floor(lo), np.ceil(lo), np.floor(hi), np.ceil(hi),
                 lo - 1, hi + 1, k]
        counts = rng.choice(picks, 15).astype(np.int64).clip(0)
        want = np.float32(jops._replay_refinement(
            jnp.asarray(heap), jnp.asarray(counts), jnp.int32(k), 4))
        got = tops._replay_refinement(heap, counts, np.int32(k), 4)
        assert got.tobytes() == want.tobytes(), (k, counts)


def test_dynamic_k_gaussian_threshold_large_leaf():
    """``gaussian_threshold`` with an ``np.int32`` k on a leaf of
    2^24 + 3 elements (``k/d`` not f32-exact) within rtol 1e-6 of the
    reference's with a traced int32 (``ndtri`` against ``norm.ppf``)."""
    d = 16_777_219
    rng = np.random.default_rng(11)
    u = (rng.standard_normal(d) * 1e-3).astype(np.float32)
    for two_sided in (False, True):
        for k in (16_778, 5_000, 70_001):
            want = float(jc.gaussian_threshold(jnp.asarray(u), jnp.int32(k),
                                               4, two_sided))
            got = float(tc.gaussian_threshold(torch.from_numpy(u),
                                              np.int32(k), 4, two_sided))
            np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# select_dynamic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["topk", "gaussiank", "gaussiank2",
                                  "histk"])
@pytest.mark.parametrize("d,k_cap", [(5000, 120), (70_001, 1_000),
                                     (300, 400)])
def test_select_dynamic_matches(name, d, k_cap):
    """The pair for several per-step ``k`` in ``[1, k_cap]``, bitwise (the
    Gaussian thresholds are checked to agree to the bit first: the
    selections then must; at ``k == d`` both are infinite and nothing is
    kept)."""
    rng = np.random.default_rng(d + k_cap)
    u = np.round(rng.standard_normal(d) * 1e-2, 5).astype(np.float32)
    jspec, tspec = jc.get_compressor(name), get_compressor(name)
    two = name == "gaussiank2"
    for k in (1, k_cap // 4, k_cap // 2, min(k_cap, d)):
        if name.startswith("gaussiank"):
            jt = float(jc.gaussian_threshold(jnp.asarray(u), jnp.int32(k),
                                             4, two))
            tt = float(tc.gaussian_threshold(torch.from_numpy(u),
                                             np.int32(k), 4, two))
            np.testing.assert_allclose(tt, jt, rtol=1e-6)
            if tt != jt:
                continue
        jv, ji = ja.select_dynamic(jspec, jnp.asarray(u), jnp.int32(k),
                                   k_cap)
        tv, ti = ta.select_dynamic(tspec, torch.from_numpy(u), np.int32(k),
                                   k_cap)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_select_dynamic_refuses_fixed_k_compressors():
    u = torch.zeros(10)
    with pytest.raises(ValueError) as terr:
        ta.select_dynamic(get_compressor("trimmedk"), u, 2, 4)
    with pytest.raises(ValueError) as jerr:
        ja.select_dynamic(jc.get_compressor("trimmedk"), jnp.zeros(10), 2,
                          4)
    assert str(terr.value) == str(jerr.value)
