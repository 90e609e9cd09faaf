"""The model axis in one process (``--mesh DxM``, M > 1, ``LocalWire``):
each worker's buckets are ``(M, d_row_total)`` rows, each selecting its
own ``ceil(k / M)``, as the reference's ``bucket_compress`` does.

* ``bucket_compress`` on an ``(2, d_row_total)`` bucket against the JAX
  package's (outside ``shard_map``; the fused branch runs its kernels in
  interpret mode): values, indices and the new residual bitwise, fixed-k
  (fused Gaussian-k and reference), dynamic-k (each row ``ceil(k / 2)``)
  and keyed (``randk``, each row keyed ``split(segment key, 2)[r]``).
* The dispatch granularities at ``2x2``: the chunked schedule and the
  per-leaf loop bitwise the bucketed run, for fixed-k, adaptive density,
  ``randk``, DGC momentum correction and hierarchical's ``resid2``.
* The CLI: ``--mesh`` defaults to the reference's ``4x2``, and
  ``--host-devices`` counts ``D·M`` devices, as the JAX flag does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_prng_flag import threefry_partitionable  # noqa: F401
from _torch_steps import assert_same, config, train
from repro.core.compressors import get_compressor as j_get
from repro.dist import aggregate as jagg
from repro.dist.layout import build_layout as j_build_layout
from repro.models import init_params as j_init
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import prng
from repro_torch.core import codec
from repro_torch.core.compressors import get_compressor
from repro_torch.dist import aggregate as tagg
from repro_torch.dist.layout import build_layout
from repro_torch.launch import train as cli
from repro_torch.models import ModelConfig, init_params

torch.set_num_threads(2)

_SMALL = dict(name="sys", arch_type="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)


@pytest.mark.parametrize("compressor,backend,dynamic", [
    ("gaussiank", "fused", False), ("topk", "reference", False),
    ("topk", "reference", True), ("randk", "reference", False)])
def test_bucket_compress_two_rows_matches_reference(compressor, backend,
                                                    dynamic):
    """One worker's ``(2, d_row_total)`` bucket of random values: the
    wire pair, its bucket-global indices and the new residual rows
    bitwise the reference's, and conservation row by row."""
    M, ratio = 2, 0.01
    jparams = j_init(JModelConfig(**_SMALL).validate(),
                     jax.random.PRNGKey(0))
    jlay = j_build_layout(jparams, M, ratio, j_get(compressor))
    tlay = build_layout(init_params(ModelConfig(**_SMALL).validate(), 0,
                                    "meta"), M, ratio,
                        get_compressor(compressor))
    assert tlay.d_row_total == jlay.d_row_total
    assert [s.k_row for s in tlay.segments] == [s.k_row
                                                for s in jlay.segments]
    rng = np.random.default_rng(3)
    G = rng.standard_normal((M, jlay.d_row_total)).astype(np.float32)
    E = (0.2 * rng.standard_normal(G.shape)).astype(np.float32)
    k = (np.asarray([max(1, s.k_row * M - 3) for s in jlay.segments],
                    np.int32) if dynamic else None)
    jkey = jax.random.PRNGKey(5) if compressor == "randk" else None
    jv, ji, jE, _ = jax.jit(lambda a, b: jagg.bucket_compress(
        a, b, jlay, j_get(compressor), jkey, backend=backend,
        k_alloc=None if k is None else jnp.asarray(k)))(
            jnp.asarray(G), jnp.asarray(E))
    tkey = prng.PRNGKey(5) if compressor == "randk" else None
    tv, ti, tE = tagg.bucket_compress(
        torch.from_numpy(G), torch.from_numpy(E.copy()), tlay,
        get_compressor(compressor), tkey, backend=backend, k_alloc=k)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_array_equal(np.asarray(jE), tE.numpy())
    for r in range(M):
        dec = codec.decode(tv[r], ti[r], tlay.d_row_total)
        assert torch.equal(dec + tE[r], torch.from_numpy(G[r] + E[r]))


@pytest.mark.parametrize("mode,strategy,variant", [
    ("topk", "allgather", "chunks3"), ("topk", "allgather", "perleaf"),
    ("variance", "allgather", "chunks3"), ("randk", "allgather", "perleaf"),
    ("momentum-correction", "allgather", "chunks3"),
    ("momentum-correction", "allgather", "perleaf"),
    ("topk", "hierarchical", "chunks3")])
def test_model_axis_dispatch_bitwise_bucketed(mode, strategy, variant):
    """At a model axis of 2 (``2x2``, or ``2x1x2`` for hierarchical) the
    chunked schedule (3 chunks) and the per-leaf loop give the bucketed
    run's params, optimizer state, residuals (``resid2`` of the
    velocities and of the second level too) and metrics, bitwise."""
    mesh = "2x1x2" if strategy == "hierarchical" else "2x2"
    a, ma, layout = train(config(mode, strategy), mesh=mesh)
    assert layout.model_size == 2
    assert a["resid"].shape == (2, 2 * layout.d_row_total)
    if variant == "chunks3":
        b, mb, _ = train(config(mode, strategy, chunks=3), mesh=mesh)
    else:
        b, mb, _ = train(config(mode, strategy), pipeline="perleaf",
                         mesh=mesh)
    assert_same(a, b, layout, ma, mb)


def test_cli_mesh_default_and_host_devices():
    """``--mesh`` defaults to ``4x2``; a mesh of ``D·M`` devices needs
    ``--host-devices D·M`` in one process, and trains with it."""
    assert cli.parse_args(["--arch", "llama3.2-1b"]).mesh == "4x2"
    argv = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
            "--density-policy", "none", "--steps", "1", "--batch", "4",
            "--seq", "16"]
    for extra in ([], ["--mesh", "2x2", "--host-devices", "2"]):
        with pytest.raises(SystemExit, match="--host-devices"):
            cli.run(argv + extra)
    (rec,) = cli.run(argv + ["--mesh", "2x2", "--host-devices", "4"])
    assert np.isfinite(rec["loss"]) and rec["collectives_per_step"] == 1.0
