"""Subprocess body for tests/test_torch_dist.py: the JAX package's mesh
train step on 4 forced host devices, ``backend="reference"``, for the
four wire strategies, and allgather on deepseek-moe-16b's smoke variant
(``moe``: each device's MoE layers dispatch its own 2 rows at their own
capacity); writes everything the port is held against to one npz
(argv[1]).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_dist_ref.py out.npz
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
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
    for name, (shape, axes, strategy) in cases.items():
        mesh = make_mesh(shape, axes)
        comp = CompressionConfig(compressor=COMPRESSOR, ratio=RATIO,
                                 strategy=strategy, backend="reference")
        layout = build_layout(params, 1, RATIO, get_compressor(COMPRESSOR))
        opt = sgd_momentum(0.9)
        state = init_train_state(params, opt,
                                 workers=data_world_size(mesh),
                                 model_size=1, compression=comp,
                                 layout=layout)
        step = make_train_step(cfg, mesh, opt, constant(LR), remat=False,
                               compression=comp, layout=layout)
        for s, b in enumerate(bs):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            for k in METRICS:
                out[f"{name}/{s}/{k}"] = np.asarray(m[k], np.float64)
        for i, leaf in enumerate(jax.tree.leaves(state["params"])):
            out[f"{name}/params/{i}"] = np.asarray(leaf)
        out[f"{name}/resid"] = np.asarray(state["resid"])
        if "resid2" in state:
            out[f"{name}/resid2"] = np.asarray(state["resid2"])
        print(name, [float(out[f"{name}/{s}/loss"]) for s in range(STEPS)],
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
