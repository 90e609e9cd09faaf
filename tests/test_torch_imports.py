"""The PyTorch port imports neither jax nor the JAX package, nor
``ml_dtypes`` (the card's machine may not have it).

Each check runs in a fresh interpreter with ``sys.modules["jax"]``,
``sys.modules["repro"]`` and ``sys.modules["ml_dtypes"]`` set to
``None``, so any ``import jax...``, ``import repro...`` or ``import
ml_dtypes`` anywhere in the imported code raises ImportError.
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["ml_dtypes"] = None
"""

_PACKAGE = _PRELUDE + """
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = [m for m, mod in sys.modules.items() if mod is not None
       and (m in ("jax", "repro", "ml_dtypes")
            or m.startswith(("jax.", "repro.", "ml_dtypes.")))]
assert not bad, bad
assert len(names) >= 30, names
assert {"repro_torch.dist.wire", "repro_torch.launch.mesh",
        "repro_torch.checkpoint.npz", "repro_torch.core.adaptk",
        "repro_torch.f32",
        "repro_torch.benchmarks.overlap_schedule",
        "repro_torch.serve", "repro_torch.serve.publish",
        "repro_torch.serve.subscribe", "repro_torch.serve.steps",
        "repro_torch.launch.serve",
        "repro_torch.benchmarks.serve_staleness",
        "repro_torch.models.moe", "repro_torch.models.ssm",
        "repro_torch.models.xlstm",
        "repro_torch.configs.shapes", "repro_torch.dist.sharding",
        "repro_torch.dist.tensor_parallel",
        "repro_torch.dist.tuner", "repro_torch.launch.topo",
        "repro_torch.launch.multihost", "repro_torch.launch.env",
        "repro_torch.launch.step_cost", "repro_torch.launch.roofline",
        "repro_torch.launch.dryrun",
        "repro_torch.benchmarks.tuner_decision",
        "repro_torch.benchmarks.table2_scaling"} <= set(names), names
print(len(names))
"""

_SMOKE = _PRELUDE + """
spec = importlib.util.spec_from_file_location("chip_smoke", {path!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
assert callable(mod.main)
print("ok")
"""


@pytest.mark.parametrize("target", ["package", "chip_smoke"])
def test_port_imports_without_jax(target):
    code = (_PACKAGE if target == "package" else
            _SMOKE.format(path=os.path.join(ROOT, "chip_smoke.py")))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
