"""The tensor-parallel train step (``dist/tensor_parallel.py``,
``model.loss_fn`` on a rank's shards) on the CPU: ``D·M`` gloo processes
(``tests/_torch_tp_pg.py``), each holding its model rank's shards of the
2-layer config of ``tests/_torch_dist_ref.py``, against the one-process
run at the same mesh (``--host-devices D·M``, every worker holding the
whole model and both rows).

* ``1x2`` (2 processes) and ``2x2``/``2x1x2`` (4): the loss of each of
  3 steps within rtol 1e-5; the gathered checkpoint's keys and shapes
  the one-process run's, its params and optimizer state within atol
  1e-5 and its residuals within rtol 1e-4 / atol 1e-5, except at near-tie
  swaps of a selection, held as swaps (``_torch_steps.near_tie_swaps``):
  the all-reduces sum the gradient in another order than one process.
  Fixed-k and adaptive Gaussian-k (fused), the chunked schedule,
  hierarchical and gTop-k with ``randk``.
* The compression bitwise when both are fed one shared gradient: the
  relayout of the shards into the rank's row and back, pass A over the
  model group, the row's values, indices and ``e'``, and the nnz; and
  the loss and every replicated leaf's gradient the same bits on every
  model rank.
* The other dense paths (``ARCHS``' smoke variants: sliding-window
  attention, the parallel block, the ``embeds`` frontend, the biased
  projections): the loss on
  the shards within rtol 1e-5 of the whole model's, the gathered
  gradients within rtol 1e-4 / atol 1e-6.
* The refusals: a split inside an attention head, the blocks without a
  tensor-parallel form.
"""
import json

import numpy as np
import pytest
import torch

from _torch_steps import near_tie_swaps
from _torch_tp_pg import CFG, launch
from repro_torch.configs import get_config
from repro_torch.core.compression import CompressionConfig
from repro_torch.dist.layout import build_layout
from repro_torch.dist.tensor_parallel import check_split, require_dense
from repro_torch.launch import train as cli
from repro_torch.models import init_params

torch.set_num_threads(2)

COMMON = ["--arch", "llama3.2-1b", "--compressor", "gaussiank", "--ratio",
          "0.02", "--density-policy", "none", "--steps", "3", "--batch", "4",
          "--seq", "16", "--log-every", "1"]
CASES = {
    2: {"fixed": ["--mesh", "1x2"],
        "variance": ["--mesh", "1x2", "--density-policy", "variance",
                     "--chunks", "3"]},
    4: {"variance": ["--mesh", "2x2", "--density-policy", "variance",
                     "--chunks", "3"],
        "hierarchical": ["--mesh", "2x1x2", "--strategy", "hierarchical"],
        "randk": ["--mesh", "2x2", "--strategy", "gtopk", "--compressor",
                  "randk"]},
}
BITWISE = {2: ["1x2", "gaussiank", 0.02, False],
           4: ["2x2", "gaussiank", 0.02, True]}
# dense archs whose other paths the TP forward takes: sliding-window
# attention, the parallel block, the embeds frontend, the biases
ARCHS = ["gemma3-4b", "command-r-35b", "musicgen-medium",
         "llama3.2-1b+bias"]


def compare_checkpoints(one, tp, mesh, argv):
    """The TP run's gathered checkpoint against the one-process run's:
    the same keys and shapes; residuals within rtol 1e-4 / atol 1e-5 but
    at near-tie swaps, params and optimizer leaves within atol 1e-5 but
    at the swapped coordinates."""
    assert sorted(one.files) == sorted(tp.files)
    for key in one.files:
        assert one[key].shape == tp[key].shape, key
    args = cli.parse_args(argv)
    M = int(mesh.split("x")[-1])
    layout = build_layout(init_params(CFG, 0, "cpu"), M, CompressionConfig(
        compressor=args.compressor, ratio=args.ratio))
    skip = {}
    for key in ("resid", "resid2"):
        if key not in one.files:
            continue
        for col in near_tie_swaps(tp[key], one[key]):
            m, c = divmod(col, layout.d_row_total)
            (seg,) = [s for s in layout.segments
                      if s.row_off <= c < s.row_off + s.d_row]
            skip.setdefault(seg.name, []).append(m * seg.d_row + c
                                                 - seg.row_off)
    for key in one.files:
        if key.split("/")[0] not in ("params", "opt"):
            continue
        name = "/".join(key.split("/")[1 if key.startswith("params")
                                       else 2:])
        got = tp[key].reshape(-1).copy()
        want = one[key].reshape(-1).copy()
        at = [i for i in skip.get(name, []) if i < got.size]
        got[at] = want[at]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("procs", [2, 4])
def test_tp_step_matches_one_process(tmp_path, procs):
    cases = [{"name": "bitwise", "argv": BITWISE[procs]}] + [
        {"name": name, "argv": COMMON + extra}
        for name, extra in CASES[procs].items()]
    if procs == 2:
        cases.append({"name": "archs", "argv": ["1x2", ARCHS]})
    logs = launch(tmp_path, procs, cases, timeout=300)
    assert "dist_backend=gloo model=2 tensor_parallel=1" in logs[0]
    for name, extra in CASES[procs].items():
        argv = COMMON + extra
        mesh = extra[1]
        recs = cli.run(argv + ["--device", "cpu", "--host-devices",
                               str(procs), "--checkpoint",
                               str(tmp_path / f"one-{name}.npz")], cfg=CFG)
        with open(tmp_path / f"{name}.json") as f:
            tp = json.load(f)
        np.testing.assert_allclose([r["loss"] for r in tp],
                                   [r["loss"] for r in recs], rtol=1e-5,
                                   err_msg=name)
        for a, b in zip(tp, recs):
            assert a["collectives_per_step"] == b["collectives_per_step"]
            assert a["comm_bits_sparse"] == b["comm_bits_sparse"]
            assert a["comm_bits_dense"] == b["comm_bits_dense"]
        with np.load(tmp_path / f"one-{name}.npz") as one, \
                np.load(tmp_path / f"{name}.npz") as got:
            compare_checkpoints(one, got, mesh, argv)


def test_tp_refuses_a_split_inside_a_head():
    """At M = 4 the small config's KV projections (2 heads of 16) would
    split into shards of 8 columns: refused, naming the leaf; M = 2
    splits on head boundaries."""
    meta = init_params(CFG, 0, "meta")
    assert len(check_split(CFG, meta, 2)) == 12
    with pytest.raises(ValueError, match="'stack/0/core/wk'.*inside an "
                                         "attention head of 16"):
        check_split(CFG, meta, 4)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b",
                                  "deepseek-moe-16b", "xlstm-125m"])
def test_tp_refuses_blocks_without_a_split(arch):
    """The MoE, Mamba and xLSTM blocks raise naming the slice that
    carries them; the dense archs pass."""
    with pytest.raises(NotImplementedError, match="later slice of the "
                                                  "model axis"):
        require_dense(get_config(arch).reduced())
    for dense in ("llama3.2-1b", "gemma3-4b", "command-r-35b",
                  "musicgen-medium"):
        require_dense(get_config(dense))
        require_dense(get_config(dense).reduced(use_bias=True))
