"""The port's cost layer against the reference's: ``launch/roofline.py``
(equal to ``repro.launch.roofline`` field for field), ``launch/step_cost.py``
(the counterpart of ``repro.launch.hlo_cost``: the wire counted through
a counting wire against the layout's closed forms, the FLOPs against
the analytic count of a small dense decoder), a dry-run record
(``launch/dryrun.py``) and ``benchmarks/table2_scaling.py``'s closed-form,
collective and adaptive rows against the reference benchmark's strings.

Tolerances: the pricing and the closed forms are compared with ``==``.
The counted FLOPs of a 2-layer dense decoder are held within 10% of
``6 * N_matmul * tokens + 12 * layers * batch * seq**2 * heads *
head_dim`` (the matmul params' forward and backward plus attention's two
batched matmuls; ``FlopCounterMode`` counts matmuls only).
"""
import functools
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.launch import roofline as jr
from repro.launch.topo import HardwareSpec as JHardwareSpec
from repro.launch.topo import LinkSpec as JLinkSpec
from repro.models import init_params as j_init
from repro_torch import tree
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.compression import CompressionConfig
from repro_torch.dist.layout import (build_layout, collective_count,
                                     strategy_wire_pairs)
from repro_torch.dist.wire import LocalWire
from repro_torch.launch import dryrun, step_cost
from repro_torch.launch import roofline as pr
from repro_torch.launch.mesh import parse_mesh
from repro_torch.launch.topo import H100_SXM, LinkSpec
from repro_torch.models import ModelConfig, init_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

torch.set_num_threads(2)

_TERMS = [(1e12, 1e9, 1e6, 5e11, 0.0), (3e9, 8e10, 2e8, 1e9, 7.0),
          (0.0, 1.0, 0.0, 0.0, 2.0), (5e14, 1e6, 1e10, 4e14, 12.0)]


def _strip_env(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "env"}


@pytest.mark.parametrize("terms", _TERMS)
def test_roofline_terms_equal_the_reference(terms):
    flops, nbytes, coll, mf, msgs = terms
    for hw_args, link in (((), None),
                          ((H100_SXM,), LinkSpec(2e-5, 1e10))):
        got = pr.roofline_terms(flops, nbytes, coll, mf, *hw_args,
                                link=link, n_messages=msgs)
        jhw = (JHardwareSpec(H100_SXM.name, H100_SXM.peak_flops,
                             H100_SXM.hbm_bw) if hw_args else None)
        jlink = (None if link is None
                 else JLinkSpec(link.alpha_s, link.beta_Bps))
        want = jr.roofline_terms(flops, nbytes, coll, mf, jhw, jlink,
                                 n_messages=msgs)
        assert _strip_env(got.to_dict()) == _strip_env(want.to_dict())
        for n in (1, 2, 4, 16):
            assert pr.overlap_report(got, n, link) == jr.overlap_report(
                want, n, jlink)
            assert pr.overlapped_collective_s(1.5, 0.25, n, 1e-3) == \
                jr.overlapped_collective_s(1.5, 0.25, n, 1e-3)
    assert (pr.PEAK_FLOPS, pr.HBM_BW, pr.LINK_BW) == (
        jr.PEAK_FLOPS, jr.HBM_BW, jr.LINK_BW)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_active_params_and_model_flops_equal_the_reference(arch):
    """``active_params`` on the port's meta tree equals the reference's
    on ``jax.eval_shape`` of its init, for each full config."""
    cfg = get_config(arch)
    jshapes = jax.eval_shape(functools.partial(j_init, J_ARCHS[arch]),
                             jax.random.PRNGKey(0))
    want = jr.active_params(jshapes, J_ARCHS[arch])
    got = pr.active_params(init_params(cfg, 0, "meta"), cfg)
    assert got == want
    for kind in ("train", "prefill", "decode"):
        assert pr.model_flops(cfg, *got, kind, 256, 4096) == \
            jr.model_flops(J_ARCHS[arch], *want, kind, 256, 4096)


_SMALL = dict(name="sys", arch_type="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)


@pytest.mark.parametrize("strategy,mesh", [
    ("allgather", "4x1"), ("gtopk", "4x1"), ("hierarchical", "2x2x1"),
    ("hier_gtopk", "2x2x1")])
def test_step_cost_wire_equals_the_closed_forms(strategy, mesh):
    """One bucketed aggregation through the counting wire: one worker
    receives ``pair_bits * strategy_wire_pairs`` bits in
    ``collective_count`` codec-pair calls."""
    cfg = ModelConfig(**_SMALL).validate()
    params = init_params(cfg, 0, "cpu")
    comp = CompressionConfig(compressor="gaussiank", ratio=0.01,
                             strategy=strategy)
    layout = build_layout(params, 1, comp)
    m = parse_mesh(mesh)
    n_pods = m.sizes.get("pod", 1)
    gen = torch.Generator().manual_seed(0)
    grads = [tree.tree_map(lambda p: torch.randn(p.shape, generator=gen),
                           params) for _ in range(4)]
    got = step_cost.wire_cost(grads, layout, comp, LocalWire(m))
    assert got["bytes"] * 8 == layout.pair_bits() * strategy_wire_pairs(
        strategy, 4, n_pods)
    assert got["messages"] == collective_count(strategy, 4, n_pods)


def test_step_cost_flops_match_the_analytic_count():
    cfg = ModelConfig(**_SMALL).validate()
    B, S = 4, 16
    params = init_params(cfg, 0, "meta")
    leaves = tree.flatten_with_path(params)[0]
    n_mm = sum(int(x.numel()) for p, x in leaves
               if x.dim() >= 2 and p[-1] != "embed" or p[-1] == "lm_head")
    hd = cfg.d_model // cfg.num_heads
    analytic = (6 * n_mm * B * S
                + 12 * cfg.num_layers * B * S * S * cfg.num_heads * hd)
    got = step_cost.count_flops(cfg, B, S, params=params)
    assert got["method"] == "whole"
    assert abs(got["flops"] - analytic) <= 0.1 * analytic, (got, analytic)
    assert "embedding" in got["uncounted_ops"]
    cost = step_cost.step_cost(cfg, batch=B, seq=S, workers=2,
                               layout=build_layout(
                                   init_params(cfg, 0, "cpu"), 1, 0.01,
                                   CompressionConfig(ratio=0.01).spec))
    assert cost["flops"] == 2 * step_cost.count_flops(
        cfg, B // 2, S, params=params)["flops"]
    assert cost["bytes_accessed"] == cost["state_bytes"]["total"] > 0


def test_step_cost_piecewise_equals_whole_on_a_recurrent_arch():
    """A recurrent arch's piecewise count (cores extended linearly from
    two short sequences) equals the whole-model count where both run."""
    cfg = get_config("xlstm-125m").reduced()
    params = init_params(cfg, 0, "meta")
    for leaf in tree.leaves(params):
        leaf.requires_grad_(True)
    ops = set()
    whole = step_cost._whole(cfg, params, 1, 64, "train",
                             torch.device("meta"), ops)
    piece = step_cost._piecewise(cfg, params, 1, 64, True,
                                 torch.device("meta"), ops)
    assert piece == whole
    for leaf in tree.leaves(params):
        leaf.requires_grad_(False)


def test_dryrun_record_of_a_smoke_arch():
    rec = dryrun.run_one("llama3.2-1b", "train_4k", "2x2", smoke=True)
    assert rec["status"] == "OK", rec.get("traceback")
    for key in ("arch", "shape", "mesh", "kind", "compressor", "strategy",
                "chips", "memory", "collectives", "collective_messages",
                "roofline", "params_total", "params_active", "flops"):
        assert key in rec, key
    assert rec["chips"] == 4 and rec["mesh"] == "2x2"
    cfg = get_config("llama3.2-1b").reduced()
    params = init_params(cfg, 0, "meta")
    layout = build_layout(params, 2, 0.001,
                          CompressionConfig(ratio=0.001).spec)
    assert rec["collectives"]["total"] * 8 * 2 == \
        layout.comm_bits_sparse("allgather", 2)
    assert rec["roofline"]["hardware"] == "h100-sxm"
    assert rec["flops"]["per_chip"] * 4 == rec["flops"]["total"]
    total, active = pr.active_params(params, cfg)
    assert rec["params_total"] == total
    skip = dryrun.run_one("llama3.2-1b", "long_500k", "2x2", smoke=True)
    assert skip["status"] == "SKIP"


@pytest.mark.parametrize("group", ["_closed_form_rows", "_collectives_rows",
                                   "_adaptk_rows"])
def test_table2_rows_equal_the_reference(group):
    import benchmarks.table2_scaling as jt2
    from repro_torch.benchmarks import table2_scaling as pt2
    assert getattr(pt2, group)(limit=3) == getattr(jt2, group)(limit=3)


def test_table2_merge_and_eff_rows_on_cpu():
    from repro_torch.benchmarks import table2_scaling as pt2
    rows = pt2._merge_cost_rows(1 << 12, device="cpu")
    assert [r[0] for r in rows] == ["table2/merge/gtopk_round/d=4096",
                                    "table2/merge/allgather_decode/d=4096"]
    assert all(r[1] > 0 and "device=cpu" in r[2] for r in rows)
    rec = dryrun.run_one("llama3.2-1b", "train_4k", "2x2", smoke=True)
    (row,) = pt2.eff_rows([rec])
    rf = rec["roofline"]
    t_cm = max(rf["compute_s"], rf["memory_s"])
    assert row[0] == "table2/eff/llama3.2-1b/gaussiank"
    assert math.isclose(row[1], round((t_cm + rf["collective_s"]) * 1e6, 1))
    assert np.isfinite(row[1])
