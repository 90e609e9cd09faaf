"""The Hopper kernels against their plain versions on the card.

These tests need a CUDA device: each is marked ``cuda`` and skips
without one (decided inside the fixture, never at import).  On a GPU
machine run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports no JAX: the card's machine has none.  Tolerances: K1
``s`` within ``1e-5·Σ|u|``, ``sq`` within rtol 1e-5, absmax exact (the
Triton and torch reductions sum in other orders); K2 counts and K3
staging/residual exact (integer work and copies of ``u``).
"""
import math

import pytest
import torch

from repro_torch.core import codec
from repro_torch.core.compressors import gaussiank_cap
from repro_torch.kernels.ef_fused import compact_residual as cr
from repro_torch.kernels.ef_fused import fused_moments as fm
from repro_torch.kernels.ef_fused import ops, tuning
from repro_torch.kernels.ef_fused import tree_count as tc

pytestmark = pytest.mark.cuda

DS = [1, 33, 4097, 1_000_003]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(d, dev, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + d)
    g = torch.randn(d, generator=gen, device=dev)
    e = torch.randn(d, generator=gen, device=dev).mul_(0.3)
    return g, e


@pytest.mark.parametrize("d", DS)
def test_kernels_match_plain_versions(dev, d):
    g, e = _inputs(d, dev)
    cfg = tuning.resolve_config(d, "cuda")
    n0 = (fm.fused_moments.launches, tc.tree_count.launches,
          cr.compact_stage.launches, cr.compact_resid.launches)
    s, sq, mx = fm.fused_moments(g, e, block=cfg.stats_block)
    ps, psq, pmx = fm.fused_moments_plain(g, e, block=cfg.stats_block)
    assert abs(float(s) - float(ps)) <= 1e-5 * float((g + e).abs().sum())
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
    for a, b in zip(got, (vp, op, cp, rp)):
        assert torch.equal(a, b)
    n1 = (fm.fused_moments.launches, tc.tree_count.launches,
          cr.compact_stage.launches, cr.compact_resid.launches)
    assert [b - a for a, b in zip(n0, n1)] == [1, 1, 1, 1]


@pytest.mark.parametrize("d", DS)
def test_pipeline_conserves_in_place(dev, d):
    g, e = _inputs(d, dev, seed=1)
    u = g + e
    v, i, ne = ops.fused_compress_ef(g, e, "gaussiank",
                                     max(1, d // 1000), out=e)
    torch.cuda.synchronize()
    assert ne.data_ptr() == e.data_ptr()
    assert torch.equal(codec.decode(v, i, d) + e, u)


def test_cuda_kernels_take_float32_only(dev):
    g = torch.zeros(64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        fm.fused_moments(g, None, block=1024)
    with pytest.raises(TypeError, match="float32"):
        cr.compact_stage(g, None, 0.0, block=1024, bcap=64)
