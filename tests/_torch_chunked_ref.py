"""Subprocess body for tests/test_torch_chunked.py and
tests/test_torch_perleaf.py: the JAX package's mesh train step on 4
forced host devices, ``backend="reference"``, for the four wire
strategies, at ``chunks=3`` (the chunked schedule) and at
``layout=None`` (the per-leaf loop), on the config, compressor, batches
and steps of ``tests/_torch_dist_ref.py``; writes what the port is held
against to one npz (argv[1]), for the variants named after it (default:
both).

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/_torch_chunked_ref.py out.npz [chunks3] [perleaf]
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np

from _torch_dist_ref import (CASES, CFG, COMPRESSOR, LR, METRICS, RATIO,
                             batches)
from repro.core.compression import CompressionConfig
from repro.dist.layout import build_layout
from repro.launch.mesh import data_world_size, make_mesh
from repro.models import init_params
from repro.optim import constant, sgd_momentum
from repro.train import init_train_state, make_train_step

VARIANTS = {"chunks3": dict(chunks=3), "perleaf": dict(chunks=1)}


def main(path, variants):
    params = init_params(CFG, jax.random.PRNGKey(0))
    out = {}
    bs = batches()
    for variant in variants or list(VARIANTS):
        kw = VARIANTS[variant]
        for name, (shape, axes, strategy) in CASES.items():
            mesh = make_mesh(shape, axes)
            comp = CompressionConfig(compressor=COMPRESSOR, ratio=RATIO,
                                     strategy=strategy, backend="reference",
                                     **kw)
            layout = (None if variant == "perleaf"
                      else build_layout(params, 1, comp))
            opt = sgd_momentum(0.9)
            state = init_train_state(params, opt,
                                     workers=data_world_size(mesh),
                                     model_size=1, compression=comp,
                                     layout=layout)
            step = make_train_step(CFG, mesh, opt, constant(LR),
                                   remat=False, compression=comp,
                                   layout=layout)
            tag = f"{variant}/{name}"
            for s, b in enumerate(bs):
                state, m = step(state, {k: jnp.asarray(v)
                                        for k, v in b.items()})
                for k in METRICS:
                    out[f"{tag}/{s}/{k}"] = np.asarray(m[k], np.float64)
            for i, leaf in enumerate(jax.tree.leaves(state["params"])):
                out[f"{tag}/params/{i}"] = np.asarray(leaf)
            for key in ("resid", "resid2"):
                if key in state:
                    for i, leaf in enumerate(jax.tree.leaves(state[key])):
                        out[f"{tag}/{key}/{i}"] = np.asarray(leaf)
            print(tag, [float(out[f"{tag}/{s}/loss"])
                        for s in range(len(bs))], flush=True)
    np.savez(path, **out)
    print("REF OK")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
