"""The plain reference against the program on the CPU at tiny sizes:
at f32 the two agree to round-off; at the configurations' bf16 they stay
within the harness's limits; float8 operands (the control) do not."""
from __future__ import annotations

import pytest
import torch

from perfbench.bench import check
from perfbench.bench.spec import Cell
from perfbench.bench.train import Program
from perfbench.reference import gaussiank
from perfbench.reference.train import readings
from perfbench.tests._pb_cells import LIMITS, TINY_DENSE, TINY_MOE, TRAFFIC, \
    TRAIN


def _cell(model, dtype):
    m = dict(model, param_dtype=dtype, activation_dtype=dtype)
    cfg = {"model": m, "train": dict(TRAIN, resid_dtype=dtype)}
    return Cell("t", 1, cfg, dict(TRAFFIC), dict(LIMITS), [], [])


def _numbers(cell, seed, **kw):
    prog = Program(cell, seed, torch.device("cpu")).first_steps()
    ref = readings(cell.config, cell.traffic, seed, "cpu")
    other = readings(cell.config, cell.traffic, seed, "cpu", **kw) \
        if kw else None
    return (check.numbers(prog, ref),
            None if other is None else check.numbers(other, ref))


@pytest.mark.parametrize("model", [TINY_DENSE, TINY_MOE])
def test_reference_matches_program_f32(model):
    nums, _ = _numbers(_cell(model, "float32"), 11)
    for name in check.NUMBERS:
        assert nums[name][0] < 1e-5, (name, nums[name])


@pytest.mark.parametrize("model", [TINY_DENSE, TINY_MOE])
def test_control_fails_where_program_passes(model):
    nums, ctl = _numbers(_cell(model, "bfloat16"), 12, precision="fp8")
    ok, _ = check.judge({n: v for n, (v, _) in nums.items()}, LIMITS)
    bad, _ = check.judge({n: v for n, (v, _) in ctl.items()}, LIMITS)
    assert ok and not bad


def test_selection_rule_closed_form():
    """Threshold, per-block staging cap and global cap, conserving."""
    g = torch.zeros(4096, dtype=torch.bfloat16)
    g[:100] = 5.0                    # one block, far past its staging cap
    g[3000] = -7.0
    e = torch.zeros_like(g)
    k, k_cap = 3, 4
    vals, idx, new_e = gaussiank.compress(g, e, k, k_cap)
    bcap = gaussiank.bcap_of(k_cap, 4096, 2048)
    assert bcap == 64
    assert idx.tolist() == [0, 1, 2, 3]     # the first k_cap staged
    dense = torch.zeros(4096)
    dense[idx] = vals.float()
    assert torch.equal(dense + new_e.float(), g.float() + e.float())
