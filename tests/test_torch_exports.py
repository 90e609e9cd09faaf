"""The port's public names against the reference's: every name in the
``__all__`` of each ``repro`` package exists in the matching
``repro_torch`` package and its ``__all__``, apart from the deliberate
differences below, each with its reason; and the parity of the two
names ported for it, ``models.param_count`` and
``core.init_residual``, on the same init tree.
"""
import ast
import importlib
import pathlib

import jax
import numpy as np
import pytest
import torch

from _torch_prng_flag import threefry_partitionable  # noqa: F401
from repro.configs import get_config as j_get_config
from repro.core import init_residual as j_init_residual
from repro.models import init_params as j_init
from repro.models import param_count as j_param_count
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core import init_residual
from repro_torch.models import from_jax_params, init_params, param_count

SRC = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro"

# names of the reference's packages the port leaves out on purpose
DIFFERENCES = {
    "repro.dist": {"compat": "a shim over jax's shard_map API across jax "
                             "versions; torch has no shard_map"},
    "repro.kernels.ef_fused": {
        "use_backend": "switches jax's kernel lowering (Mosaic, Triton, "
                       "the interpreter); the card has one backend"},
    "repro.serve": {"decode_shardings": "builds jax NamedShardings; the "
                                        "port's specs are decode_specs"},
}


def _reference_all():
    """``{package: its __all__}`` of every ``repro`` package that has
    one, read from the source."""
    out = {}
    for init in sorted(SRC.rglob("__init__.py")):
        for node in ast.parse(init.read_text()).body:
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == "__all__"
                    for t in node.targets):
                pkg = ".".join(init.parent.relative_to(SRC.parent).parts)
                out[pkg] = ast.literal_eval(node.value)
    return out


REFERENCE_ALL = _reference_all()


def test_the_differences_name_reference_exports():
    for pkg, names in DIFFERENCES.items():
        assert set(names) <= set(REFERENCE_ALL[pkg]), pkg


@pytest.mark.parametrize("pkg", sorted(REFERENCE_ALL))
def test_port_exports_every_reference_name(pkg):
    port = importlib.import_module(pkg.replace("repro", "repro_torch", 1))
    missing = [n for n in REFERENCE_ALL[pkg]
               if n not in DIFFERENCES.get(pkg, {})
               and (not hasattr(port, n) or n not in port.__all__)]
    assert not missing, (pkg, missing)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b",
                                  "jamba-1.5-large-398b", "xlstm-125m"])
def test_param_count_matches_reference(arch):
    jparams = j_init(j_get_config(arch).reduced(), jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced()
    assert param_count(init_params(cfg, 0, "cpu")) == \
        j_param_count(jparams)
    assert param_count(init_params(get_config(arch), 0, "meta")) == \
        sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jax.eval_shape(
            lambda: j_init(j_get_config(arch), jax.random.PRNGKey(0)))))


def test_init_residual_matches_reference():
    jparams = j_init(j_get_config("llama3.2-1b").reduced(),
                     jax.random.PRNGKey(1))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    want = j_init_residual(jparams)
    got = init_residual(params)
    assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
        jax.tree.structure(tree.tree_map(lambda t: t.numpy(), got))
    for a, b in zip(jax.tree.leaves(want), tree.leaves(got)):
        assert b.shape == a.shape and str(b.dtype).endswith(str(a.dtype))
        assert b.device == torch.device("cpu")
        assert not torch.any(b)
