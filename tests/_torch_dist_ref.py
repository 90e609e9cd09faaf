"""Subprocess body for tests/test_torch_dist.py: the JAX package's mesh
train step on forced host devices, ``backend="reference"``, for the
four wire strategies, allgather on deepseek-moe-16b's smoke variant
(``moe``: each device's MoE layers dispatch its own 2 rows at their own
capacity), and the model axis (``M2_CASES``: a model axis of 2 at
``(2, 2)`` and ``(2, 1, 2)`` for the four strategies, adaptive density,
``randk``, and the default ``(4, 2)`` on 8 devices; ``M2_BLOCKS``:
allgather at ``(2, 2)`` on the smoke variants of jamba-1.5-large and
xlstm-125m, the Mamba, MoE and xLSTM blocks at a model axis of 2);
writes everything the port is held against to one npz (argv[1]).

Under jax 0.9.0 the mesh step at a model axis above 1 raises in
``constrain_params``; its constraint is a layout hint only, so the
model-axis cases switch it off (``compat.supports_auto_axis_constraints``
returning False), here and nowhere else.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_torch_dist_ref.py out.npz
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.core import adaptk
from repro.core.compressors import get_compressor
from repro.core.compression import CompressionConfig
from repro.dist.layout import build_layout
from repro.launch.mesh import data_world_size, make_mesh
from repro.models import ModelConfig, init_params
from repro.optim import constant, sgd_momentum
from repro.train import init_train_state, make_train_step

# the 2-layer config of tests/_dist_check.py
CFG = ModelConfig(name="t", arch_type="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=64).validate()
CASES = {   # name: (mesh shape, axes, strategy)
    "allgather": ((4, 1), ("data", "model"), "allgather"),
    "gtopk": ((4, 1), ("data", "model"), "gtopk"),
    "hierarchical": ((2, 2, 1), ("pod", "data", "model"), "hierarchical"),
    "hier_gtopk": ((2, 2, 1), ("pod", "data", "model"), "hier_gtopk"),
}
# name: (mesh shape, axes, strategy, compressor, density policy)
M2_CASES = {
    "m2_allgather": ((2, 2), ("data", "model"), "allgather", "topk", None),
    "m2_gtopk": ((2, 2), ("data", "model"), "gtopk", "topk", None),
    "m2_hierarchical": ((2, 1, 2), ("pod", "data", "model"),
                        "hierarchical", "topk", None),
    "m2_hier_gtopk": ((2, 1, 2), ("pod", "data", "model"), "hier_gtopk",
                      "topk", None),
    "m2_variance": ((2, 2), ("data", "model"), "allgather", "topk",
                    "variance"),
    "m2_randk": ((2, 2), ("data", "model"), "allgather", "randk", None),
    "m2_4x2": ((4, 2), ("data", "model"), "allgather", "topk", None),
}
# name: arch, whose smoke variant runs M2_CASES["m2_allgather"]
M2_BLOCKS = {"m2_jamba": "jamba-1.5-large-398b", "m2_xlstm": "xlstm-125m"}
COMPRESSOR, RATIO, LR, STEPS = "topk", 0.02, 0.05, 2
METRICS = ("loss", "density", "density_cap", "comm_bits_sparse",
           "comm_bits_dense", "wire_bytes", "collectives_per_step")


MOE = get_config("deepseek-moe-16b").reduced()


def batches(vocab=CFG.vocab_size):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, vocab, (8, 16)).astype(np.int32)
        out.append({"tokens": toks, "labels": np.roll(toks, -1, axis=1)})
    return out


def main(path):
    out = {}
    run_cases(CFG, CASES, "", out)
    run_cases(MOE, {"moe": CASES["allgather"]}, "moe/", out)
    from repro.dist import compat
    compat.supports_auto_axis_constraints = lambda: False
    run_cases(CFG, M2_CASES, "m2/", out)
    for name, arch in M2_BLOCKS.items():
        run_cases(get_config(arch).reduced(),
                  {name: M2_CASES["m2_allgather"]}, f"{name}/", out)
    np.savez(path, **out)
    print("REF OK")


def run_cases(cfg, cases, prefix, out):
    """Every case of ``cases`` from ``init_params(cfg, PRNGKey(0))``;
    the init, the batches and the results under ``prefix``."""
    params = init_params(cfg, jax.random.PRNGKey(0))
    for i, leaf in enumerate(jax.tree.leaves(params)):
        out[f"{prefix}init/{i}"] = np.asarray(leaf)
    bs = batches(cfg.vocab_size)
    for i, b in enumerate(bs):
        out[f"{prefix}batch/{i}/tokens"] = b["tokens"]
        out[f"{prefix}batch/{i}/labels"] = b["labels"]
    for name, (shape, axes, strategy, *more) in cases.items():
        compressor, policy = more if more else (COMPRESSOR, None)
        policy = policy and adaptk.make_policy(policy)
        M = shape[-1]
        mesh = make_mesh(shape, axes)
        comp = CompressionConfig(compressor=compressor, ratio=RATIO,
                                 strategy=strategy, backend="reference",
                                 density_policy=policy)
        layout = build_layout(params, M, RATIO, get_compressor(compressor),
                              density_policy=policy)
        opt = sgd_momentum(0.9)
        state = init_train_state(params, opt,
                                 workers=data_world_size(mesh),
                                 model_size=M, compression=comp,
                                 layout=layout)
        step = make_train_step(cfg, mesh, opt, constant(LR), remat=False,
                               compression=comp, layout=layout)
        # randk's draws in the scheme the port follows (jax >= 0.5's
        # default), for this case alone
        old = jax.config.jax_threefry_partitionable
        jax.config.update("jax_threefry_partitionable",
                          old or compressor == "randk")
        for s, b in enumerate(bs):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            for k in METRICS + (("k_total",) if policy else ()):
                out[f"{name}/{s}/{k}"] = np.asarray(m[k], np.float64)
        jax.config.update("jax_threefry_partitionable", old)
        for i, leaf in enumerate(jax.tree.leaves(state["params"])):
            out[f"{name}/params/{i}"] = np.asarray(leaf)
        out[f"{name}/resid"] = np.asarray(state["resid"])
        if "resid2" in state:
            out[f"{name}/resid2"] = np.asarray(state["resid2"])
        print(name, [float(out[f"{name}/{s}/loss"]) for s in range(STEPS)],
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
