"""K1/K2/K3 plain versions against the JAX package's Pallas kernels run
in interpret mode on the same numpy inputs.

Tolerances:
* K1 ``s`` within ``1e-5 · Σ|u|`` — XLA and torch order the in-block
  sum differently, and the sum of a near-zero-mean vector has no useful
  relative error; ``sq`` within rtol 1e-5 (same reason, all terms
  positive); ``absmax`` exact (max is order-free).
* K2 counts, K3 staging values/offsets/counts and the residual ``e'``
  exact: integer work, and values that are copies of ``u = g + e``.

On CPU tensors the wrappers take the plain versions and never touch a
launch counter.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ef_fused.compact_residual import \
    compact_residual as j_compact
from repro.kernels.ef_fused.fused_moments import fused_moments as j_moments
from repro.kernels.ef_fused.tree_count import tree_count as j_tree_count
from repro_torch.kernels.ef_fused import compact_residual as cr
from repro_torch.kernels.ef_fused import fused_moments as fm
from repro_torch.kernels.ef_fused import ops, tuning
from repro_torch.kernels.ef_fused import tree_count as tc

torch.set_num_threads(2)

DS = [1, 33, 257, 5000, 65536]


def _inputs(d, with_e, seed=0):
    rng = np.random.default_rng(seed + d)
    g = rng.standard_normal(d).astype(np.float32)
    e = (0.3 * rng.standard_normal(d)).astype(np.float32) if with_e else None
    return g, e


def _pad2d(x, block):
    if x is None:
        return None
    pad = (-x.shape[0]) % block
    return jnp.asarray(np.pad(x, (0, pad)).reshape(-1, block))


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("with_e", [True, False])
@pytest.mark.parametrize("d", DS)
def test_fused_moments_plain_matches_pallas(d, with_e):
    g, e = _inputs(d, with_e)
    block = tuning.choose_stats_block(d, "torch")
    js, jsq, jmx, _ = j_moments(_pad2d(g, block), _pad2d(e, block),
                                block=block, backend="interpret",
                                interpret=True)
    ts, tsq, tmx = fm.fused_moments(_t(g), _t(e), block=block)
    u = g if e is None else g + e
    assert abs(float(ts) - float(js)) <= 1e-5 * float(np.abs(u).sum())
    np.testing.assert_allclose(float(tsq), float(jsq), rtol=1e-5)
    assert float(tmx) == float(jmx)
    assert fm.fused_moments.launches == 0


@pytest.mark.parametrize("with_e", [True, False])
@pytest.mark.parametrize("d", DS)
def test_tree_count_plain_matches_pallas(d, with_e):
    g, e = _inputs(d, with_e)
    block = tuning.choose_stats_block(d, "torch")
    u = g if e is None else g + e
    t0 = np.float32(np.quantile(np.abs(u), 0.9))
    heap, n_t = ops._tree_thresholds(t0, 4)
    jc = j_tree_count(_pad2d(g, block), _pad2d(e, block),
                      jnp.asarray(heap[:n_t]), n_t=n_t, block=block,
                      backend="interpret", interpret=True)
    tcnt = tc.tree_count(_t(g), _t(e), torch.from_numpy(heap[:n_t]),
                         block=block)
    assert tcnt.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jc), tcnt.numpy())
    assert tc.tree_count.launches == 0


def _compare_compact(g, e, thres, block, bcap, k_cap):
    jv, jo, jn, je = j_compact(_pad2d(g, block), _pad2d(e, block),
                               jnp.float32(thres), bcap=bcap, k_cap=k_cap,
                               block=block, with_resid=True,
                               backend="interpret", interpret=True)
    tv, to, tn, te = cr.compact_residual(_t(g), _t(e), thres, block=block,
                                         bcap=bcap, k_cap=k_cap)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    d = g.shape[0]
    np.testing.assert_array_equal(np.asarray(je).reshape(-1)[:d],
                                  te.numpy())
    assert cr.compact_stage.launches == 0
    assert cr.compact_resid.launches == 0
    return tn


@pytest.mark.parametrize("with_e", [True, False])
@pytest.mark.parametrize("d", DS)
def test_compact_residual_plain_matches_pallas(d, with_e):
    g, e = _inputs(d, with_e)
    block = tuning.choose_block(d, "torch")
    k = max(1, d // 100)
    k_cap = -(-4 * k // 3)
    bcap = ops.fused_default_bcap(k_cap, d, block)
    u = g if e is None else g + e
    thres = float(np.quantile(np.abs(u), 1 - k / d)) if d > 1 else 0.0
    _compare_compact(g, e, thres, block, bcap, k_cap)


def test_compact_residual_staging_overflow():
    """Blocks select more than ``bcap`` (staging truncation) and the
    running count passes ``k_cap`` (global truncation): both cuts are
    bitwise the reference's, and the dropped mass stays in ``e'``."""
    g, e = _inputs(5000, True, seed=7)
    thres = float(np.quantile(np.abs(g + e), 0.9))   # ~200 per block
    cnt = _compare_compact(g, e, thres, block=2048, bcap=8, k_cap=12)
    assert int(cnt.max()) > 8


def _jax_bits(t):
    """A tensor's bits as a jax array (bf16 through its 16-bit pattern)."""
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.uint16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _bits(x):
    """numpy bits of a jax array or a tensor: 4-byte types as uint32,
    bf16 as uint16."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.uint16) if x.dtype == torch.bfloat16 else x
        a = x.numpy()
    else:
        a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


SWEEP_PAIRS = [(torch.float32, torch.float32),
               (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32), (torch.bfloat16, None)]
SWEEP_IDS = ["f32-f32", "bf16-bf16", "bf16-f32", "bf16-none"]
SWEEP_CASES = [  # (d, block, bcap, k_cap or None, quantile of |u|)
    (5001, 2048, 64, None, 0.99),    # d not a multiple of the block
    (5000, 2048, 8, 12, 0.9),        # blocks over bcap; k_cap cut mid-block
    (65536, 4096, 64, None, 0.999),
]


@pytest.mark.parametrize("case", SWEEP_CASES,
                         ids=["ragged", "overflow-kcap", "whole"])
@pytest.mark.parametrize("pair", SWEEP_PAIRS, ids=SWEEP_IDS)
def test_compact_sweep_plain_matches_sequential_pallas(pair, case):
    """The one sweep's plain version (the stage rows, their exclusive
    cumsum, the residual and the assembly, composed) against the
    reference's sequential ``_kernel`` (``compact_residual.py:237``, on
    its mosaic lowering in interpret mode): ``vals``, ``offs``, ``cnt``
    and ``e'`` bitwise, and the pair bitwise the reference's
    ``gaussian_topk.ops.assemble_staging`` of those rows; also in place
    over ``e`` (or ``g`` without ``e``)."""
    from repro.kernels.gaussian_topk.ops import \
        assemble_staging as j_assemble
    d, block, bcap, k_cap, q = case
    g32, e32 = _inputs(d, True, seed=11)
    g = torch.from_numpy(g32).to(pair[0])
    e = None if pair[1] is None else torch.from_numpy(e32).to(pair[1])
    u = g.float() if e is None else g.float() + e.float()
    thres = float(np.float32(np.quantile(u.abs().numpy(), q)))
    if k_cap is None:
        k_cap = -(-4 * int(round((1 - q) * d)) // 3)
    odt = fm.out_dtype(g, e)
    jname = "bfloat16" if odt == torch.bfloat16 else "float32"
    jv, jo, jn, je = j_compact(
        _pad2d_bits(g, block), _pad2d_bits(e, block), jnp.float32(thres),
        bcap=bcap, k_cap=k_cap, block=block, out_dtype=jname,
        with_resid=True, backend="mosaic", interpret=True)
    jwv, jwi = j_assemble(jv, jo, jn, d, k_cap, block=block,
                          out_dtype=jname)
    got = cr.compact_sweep(g, e, thres, block=block, bcap=bcap, k_cap=k_cap)
    want = (jv, jo, jn, np.asarray(je).reshape(-1)[:d], jwv, jwi)
    for a, b, what in zip(want, got, ("vals", "offs", "cnt", "e'",
                                      "values", "indices")):
        assert str(np.asarray(a).dtype) == {
            torch.float32: "float32", torch.int32: "int32",
            torch.bfloat16: "bfloat16"}[b.dtype], what
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=what)
    if bcap == 8:
        assert int(got[2].max()) > bcap and int(
            torch.clamp(got[2], max=bcap).sum()) > k_cap
    inplace = (e if e is not None else g).clone()
    again = cr.compact_sweep(g if e is not None else inplace,
                             inplace if e is not None else None, thres,
                             block=block, bcap=bcap, k_cap=k_cap, out=inplace)
    assert again[3].data_ptr() == inplace.data_ptr()
    for a, b in zip(got, again):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert cr.compact_sweep.launches == 0


def _pad2d_bits(t, block):
    """``t``'s bits zero-padded to whole blocks, as a jax array."""
    if t is None:
        return None
    pad = (-t.shape[0]) % block
    return _jax_bits(torch.nn.functional.pad(t, (0, pad))).reshape(-1, block)


@pytest.mark.parametrize("kernel,i", [("stage", i) for i in range(5)]
                         + [("hist", i) for i in range(5)])
def test_tune_kernels_variants_apply(kernel, i):
    """Each variant that ``launch/tune_kernels.py`` builds on the card is
    the kernel's source with exactly its own change: the ``#define``
    values it names, or the one replaced ``count`` function."""
    from repro_torch.kernels import cuda_build
    from repro_torch.launch import tune_kernels as tk
    source = "compact_residual.cu" if kernel == "stage" else \
        "abs_histogram.cu"
    label, defines, *count = (tk.STAGE if kernel == "stage" else tk.HIST)[i]
    count = count[0] if count else None
    with open(f"{cuda_build.CSRC}/{source}") as f:
        base = f.read()
    text = tk._variant(source, defines, count)
    for name, value in defines.items():
        assert f"\n#define {name} {value}" in text
    if count is not None:
        assert count in text and count not in base
    if not defines and count is None:
        assert text == base, label
    else:
        assert text != base, label
