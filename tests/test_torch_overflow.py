"""K1 with its histogram on inputs whose sum overflows f32: the card's
kernel (``csrc/abs_histogram.cu``) adds f32 round partials into f64
sums and returns ``s = +inf`` (or ``-inf``) where the reference's f32
per-block fold (``repro/kernels/ef_fused/fused_moments.py``), and the
plain version that repeats it, give NaN: ``+inf`` beside ``-3e38``, for
example.  No consumer of ``s`` gives another output for the two forms:

* hist-k's threshold reads the histogram alone
  (``histk/ops.threshold_from_histogram``);
* the adaptive signal (``core/adaptk.leaf_signal``) reads ``s`` only
  under ``variance``, as ``max(sq - s·s/d, 0)``.  Wherever ``s`` is
  ``±inf`` or NaN, ``sq`` is ``+inf`` or NaN on both sides: an f32 sum
  of ``d`` elements overflows only if one element exceeds
  ``FLT_MAX / d``, whose f32 square is ``+inf`` in any order (``d`` is
  far below ``2**64``), and an infinite element's square is ``+inf``.
  So the signal is NaN for either form; ``uniform`` and ``absmax`` do
  not read ``s``; the global-k scale reads ``sq`` only.

The tests feed both forms through each consumer, and through the whole
adaptive aggregation (hist-k, ``variance`` with its EMA, two workers),
and find the same outputs (NaN equal to NaN)."""
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.core import adaptk
from repro_torch.core.compression import CompressionConfig
from repro_torch.dist import aggregate as agg
from repro_torch.dist.layout import build_layout
from repro_torch.dist.wire import LocalWire
from repro_torch.kernels.ef_fused import fused_moments as fm
from repro_torch.kernels.ef_fused import ops
from repro_torch.kernels.histk.ops import threshold_from_histogram
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models import ModelConfig, init_params

torch.set_num_threads(2)

F32_MAX = np.float32(3e38)


def _overflowing(d, seed):
    """``g`` with ``+inf`` beside ``-3e38`` (the card check's input),
    ``e`` small."""
    rng = np.random.default_rng(seed)
    g = (1e-3 * rng.standard_normal(d)).astype(np.float32)
    g[3] = np.inf
    g[d // 2:d // 2 + 4] = -F32_MAX
    return torch.from_numpy(g), torch.from_numpy(
        (1e-4 * rng.standard_normal(d)).astype(np.float32))


def _card_form(g, e, *, block):
    """K1 with its histogram as the plain version computes it, with
    ``s`` the card kernel's wherever that one is infinite: the f32
    ``u``'s elements widened to f64, summed, rounded once to f32 (the
    kernel's lanes add f32 partials of a few elements into f64; with one
    large element a partial, as here, they are the elements).  Where
    both sums are finite they agree within f32 reassociation, which the
    parity contract covers; only the overflow is at issue here."""
    s, sq, mx, h = fm.fused_moments_hist_plain(g, e, block=block)
    u = (g.float() + (0 if e is None else e.float())).double()
    card = u.sum().float()
    return (s if torch.isfinite(card) else card), sq, mx, h


def test_plain_and_card_forms_differ_only_in_s():
    g, e = _overflowing(4096, 0)
    plain = fm.fused_moments_hist_plain(g, e, block=1024)
    card = _card_form(g, e, block=1024)
    assert torch.isnan(plain[0]) and card[0] == float("inf")
    # the square of any element above FLT_MAX / d is +inf in f32, in
    # either summation
    u = g + e
    assert plain[1] == card[1] == float("inf")
    assert (u * u).double().sum() == float("inf")
    assert plain[2] == card[2] and torch.equal(plain[3], card[3])


@pytest.mark.parametrize("policy", adaptk.POLICIES)
def test_each_consumer_gives_the_same_output(policy):
    """Each form of ``s`` (``+inf``, ``-inf``, NaN) with ``sq = +inf``:
    the signal of every policy, the rows' reduction into the leaf's
    moments, the global-k scale and hist-k's threshold."""
    d, mx = 4096, np.float32(np.inf)
    forms = [np.float32(np.inf), np.float32(-np.inf), np.float32(np.nan)]
    sq = np.float32(np.inf)
    outs = [adaptk.leaf_signal(policy, d, s, sq, mx) for s in forms]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    reduced = [agg._stats_reduce([(s, sq, mx), (np.float32(1.0), sq,
                                                np.float32(2.0))])
               for s in forms]
    signals = [adaptk.leaf_signal(policy, d, *r) for r in reduced]
    for out in signals[1:]:
        np.testing.assert_array_equal(out, signals[0])
    pol = adaptk.make_policy(policy, global_policy="normdecay")
    state = adaptk.init_controller_state(1, global_k=True)
    scales = {str(adaptk.global_scale(state, r[1], pol)) for r in reduced}
    assert len(scales) == 1
    g, e = _overflowing(4096, 1)
    hist = _card_form(g, e, block=1024)[3]
    assert threshold_from_histogram(hist, 41) == threshold_from_histogram(
        fm.fused_moments_hist_plain(g, e, block=1024)[3], 41)


def _run(monkeypatch, card: bool):
    """Two steps of the hist-k adaptive aggregation (``variance``, EMA
    0.5, two workers on ``LocalWire``), worker 1's second gradient
    overflowing in one leaf; K1 with its histogram in the plain form or
    the card's."""
    swapped = []
    if card:
        def form(g, e, *, block):
            out = _card_form(g, e, block=block)
            swapped.append(bool(torch.isinf(out[0])))
            return out
        monkeypatch.setattr(ops, "fused_moments_hist", form)
    cfg = ModelConfig(name="t", arch_type="dense", num_layers=1, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=64).validate()
    params = init_params(cfg, 0, "cpu")
    pol = adaptk.make_policy("variance", ema=0.5)
    comp = CompressionConfig(compressor="histk", ratio=0.01,
                             backend="fused", density_policy=pol)
    layout = build_layout(params, 1, comp)
    wire = LocalWire(parse_mesh("2x1"))
    resid = torch.zeros((2, layout.flat_size))
    state = adaptk.init_controller_state(len(layout.segments))
    leaves, td = tree.flatten(params)
    out = []
    for step in range(2):
        grads = []
        for w in range(2):
            rng = np.random.default_rng(10 * step + w)
            gs = [torch.from_numpy((1e-2 * rng.standard_normal(
                tuple(x.shape))).astype(np.float32)) for x in leaves]
            if step == 1 and w == 1:
                big, _ = _overflowing(gs[0].numel(), 2)
                gs[0] = big.view(gs[0].shape)
            grads.append(tree.unflatten(td, gs))
        res = agg.aggregate_bucketed(grads, resid, layout, comp, wire=wire,
                                     adapt_state=state, step=step)
        state = res.adapt_state
        out.append((tree.leaves(res.agg), res.resid.clone(),
                    {k: np.asarray(v) for k, v in state.items()},
                    res.metrics["k_total"]))
    # the card's form gave s = +inf on the overflowing leaf's row
    assert any(swapped) == card
    return out


def test_adaptive_aggregation_same_for_both_forms(monkeypatch):
    plain = _run(monkeypatch, card=False)
    card = _run(monkeypatch, card=True)
    assert np.isnan(plain[1][2]["signal"]).any()
    for (pa, pr, ps, pk), (ca, cr, cs, ck) in zip(plain, card):
        for a, b in zip(pa, ca):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(pr.numpy(), cr.numpy())
        assert sorted(ps) == sorted(cs)
        for k in ps:
            np.testing.assert_array_equal(ps[k], cs[k])
        np.testing.assert_array_equal(pk, ck)
