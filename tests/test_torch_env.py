"""The port's pinned launch environment (``repro_torch.launch.env``):
``pinned_env``'s merge rules (caller-set values win, tcmalloc appended
to ``LD_PRELOAD`` once), ``describe_env``'s recorded variables, the
``--shell`` CLI, and the benchmark provenance that carries it."""
import os
import subprocess
import sys

import pytest

from repro_torch.launch import env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("tcmalloc", [None, "/x/libtcmalloc.so.4"])
def test_pinned_env_merge_rules(monkeypatch, tcmalloc):
    monkeypatch.setattr(env, "find_tcmalloc", lambda: tcmalloc)
    delta = env.pinned_env({})
    assert delta["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == "60000000000"
    assert delta.get("LD_PRELOAD") == tcmalloc
    # caller-set values win; LD_PRELOAD keeps what it has
    base = {"TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD": "1",
            "LD_PRELOAD": "/a.so"}
    delta = env.pinned_env(base)
    assert "TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD" not in delta
    if tcmalloc:
        assert delta["LD_PRELOAD"] == f"/a.so:{tcmalloc}"
        assert "LD_PRELOAD" not in env.pinned_env(
            {"LD_PRELOAD": f"/a.so:{tcmalloc}"})
    else:
        assert "LD_PRELOAD" not in delta
    # nothing the port's numbers depend on is pinned
    assert not set(env.ENV_DEFAULTS) & {
        "PYTORCH_CUDA_ALLOC_CONF", "CUBLAS_WORKSPACE_CONFIG",
        "OMP_NUM_THREADS", "NCCL_ALGO", "NCCL_PROTO", "CUDA_VISIBLE_DEVICES"}


def test_apply_pinned_env_updates_os_environ(monkeypatch):
    monkeypatch.setattr(env, "find_tcmalloc", lambda: None)
    monkeypatch.delenv("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD",
                       raising=False)
    delta = env.apply_pinned_env()
    assert os.environ["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] == \
        delta["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"]
    assert env.apply_pinned_env() == {}


def test_describe_env_records_the_allocator_and_nccl_variables():
    base = {"NCCL_ALGO": "Ring", "PYTORCH_CUDA_ALLOC_CONF":
            "expandable_segments:True", "OMP_NUM_THREADS": "4",
            "UNRELATED": "x", "LD_PRELOAD": "/a.so"}
    assert env.describe_env(base) == {
        "NCCL_ALGO": "Ring", "PYTORCH_CUDA_ALLOC_CONF":
        "expandable_segments:True", "OMP_NUM_THREADS": "4",
        "LD_PRELOAD": "/a.so"}
    assert set(env.RECORDED_VARS) >= {
        "PYTORCH_CUDA_ALLOC_CONF", "CUBLAS_WORKSPACE_CONFIG",
        "CUDA_VISIBLE_DEVICES", "NCCL_ALGO", "NCCL_PROTO",
        "NCCL_P2P_DISABLE", "NCCL_IB_DISABLE", "OMP_NUM_THREADS",
        "LD_PRELOAD"}


def test_bench_meta_records_the_environment(monkeypatch):
    from repro_torch.benchmarks.common import bench_meta
    monkeypatch.setenv("NCCL_PROTO", "Simple")
    assert bench_meta()["env"]["NCCL_PROTO"] == "Simple"


def test_shell_cli_prints_exports_without_importing_torch():
    code = ("import sys; sys.modules['torch'] = None; "
            "from repro_torch.launch import env; "
            "raise SystemExit(env.main(['--shell']))")
    e = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    e.pop("TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD", None)
    out = subprocess.run([sys.executable, "-c", code], env=e,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "export TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD='60000000000'" in \
        lines
    assert lines == sorted(lines)
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.env"],
                         env=dict(e, NCCL_ALGO="Tree"), capture_output=True,
                         text=True, timeout=60)
    assert "NCCL_ALGO=Tree" in out.stdout.splitlines()
