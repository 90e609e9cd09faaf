"""Subprocess body for tests/test_torch_keyed.py: the JAX package's mesh
train step on 4 forced host devices, ``backend="reference"``, for the
key-sampled compressors and DGC momentum correction (``seed=3``); writes
what the port is held against to one npz (argv[1]): per step the
metrics and every worker's residuals, and the final params (worker 0's
replica, as ``out_specs=P()`` returns it).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_keyed_ref.py out.npz
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

from _torch_dist_ref import CFG, METRICS, batches
from repro.core.compression import CompressionConfig
from repro.dist.layout import build_layout
from repro.launch.mesh import data_world_size, make_mesh
from repro.models import init_params
from repro.optim import constant, sgd_momentum
from repro.train import init_train_state, make_train_step

CASES = {   # name: (mesh shape, axes, strategy, compressor, momentum corr.)
    "randk/allgather": ((4, 1), ("data", "model"), "allgather", "randk",
                        0.0),
    "randk/hierarchical": ((2, 2, 1), ("pod", "data", "model"),
                           "hierarchical", "randk", 0.0),
    "gaussiank_mc/gtopk": ((4, 1), ("data", "model"), "gtopk", "gaussiank",
                           0.9),
}
RATIO, LR, SEED = 0.02, 0.05, 3


def main(path):
    jax.config.update("jax_threefry_partitionable", True)
    params = init_params(CFG, jax.random.PRNGKey(0))
    out = {}
    bs = batches()
    for name, (shape, axes, strategy, compressor, mc) in CASES.items():
        mesh = make_mesh(shape, axes)
        comp = CompressionConfig(compressor=compressor, ratio=RATIO,
                                 strategy=strategy, backend="reference",
                                 momentum_correction=mc)
        layout = build_layout(params, 1, comp)
        opt = sgd_momentum(0.0 if mc else 0.9)
        state = init_train_state(params, opt,
                                 workers=data_world_size(mesh),
                                 model_size=1, compression=comp,
                                 layout=layout)
        step = make_train_step(CFG, mesh, opt, constant(LR), remat=False,
                               compression=comp, layout=layout, seed=SEED)
        for s, b in enumerate(bs):
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            for k in METRICS:
                out[f"{name}/{s}/{k}"] = np.asarray(m[k], np.float64)
            for key in ("resid", "resid2"):
                if key in state:
                    out[f"{name}/{s}/{key}"] = np.asarray(state[key])
        for i, leaf in enumerate(jax.tree.leaves(state["params"])):
            out[f"{name}/params/{i}"] = np.asarray(leaf)
        print(name, [float(out[f"{name}/{s}/loss"]) for s in range(len(bs))],
              flush=True)
    np.savez(path, **out)
    print("REF OK")


if __name__ == "__main__":
    main(sys.argv[1])
