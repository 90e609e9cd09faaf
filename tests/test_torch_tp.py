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
* The other paths (``ARCHS``' smoke variants: sliding-window
  attention, the parallel block, the ``embeds`` frontend, the biased
  projections, the MoE, Mamba, mLSTM and sLSTM blocks with nonzero
  biases): the loss on the shards within rtol 1e-5 of the whole
  model's, the gathered gradients within rtol 1e-4 / atol 1e-6.
* The blocks at the CLI (``ARCH_CASES``): the smoke variants of
  jamba-1.5-large (Mamba, attention, MLP and MoE layers),
  deepseek-moe-16b (MoE with a shared expert) and xlstm-125m (mLSTM and
  sLSTM) at ``1x2``, deepseek and xlstm at ``1x4``, each against the
  one-process run at its mesh as above; and xlstm's per-leaf loop at
  ``1x2`` bitwise its bucketed TP run (losses, params, optimizer state
  and the residuals packed into the bucket).
* The placement (``dist/tensor_parallel.check_split``): whole leaf ->
  shards -> rows -> shards bitwise for the smoke variants of all ten
  archs at M = 2 and 4 (M threads in this process), each row the whole
  leaf's flat slice, the shards gathered and cut back; the full configs
  admitted at M = 2 and 4.
* The refusals: a split inside an attention head, xlstm-125m's four
  heads at M = 8.
"""
import json
import threading

import numpy as np
import pytest
import torch

from _torch_steps import near_tie_swaps
from _torch_tp_pg import CFG, launch
from repro_torch import tree
from repro_torch.configs import get_config, list_archs
from repro_torch.core.compression import CompressionConfig
from repro_torch.dist import tensor_parallel as tpm
from repro_torch.dist.layout import (build_layout, pack_grads,
                                     pack_residual_arrays)
from repro_torch.dist.tensor_parallel import check_split
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
# archs whose other paths the TP forward takes: sliding-window
# attention, the parallel block, the embeds frontend, the biases, the
# MoE (with and without shared experts), Mamba and xLSTM blocks
ARCHS = ["gemma3-4b", "command-r-35b", "musicgen-medium",
         "llama3.2-1b+bias", "jamba-1.5-large-398b", "deepseek-moe-16b",
         "phi3.5-moe-42b-a6.6b", "xlstm-125m"]
# the blocks at the CLI: name -> (processes, argv); smoke variants
ARCH_COMMON = ["--smoke", "--compressor", "gaussiank", "--ratio", "0.02",
               "--density-policy", "none", "--steps", "3", "--batch", "4",
               "--seq", "16", "--log-every", "1"]
ARCH_CASES = {
    "jamba-1x2": (2, ["--arch", "jamba-1.5-large-398b", "--mesh", "1x2"]),
    "deepseek-1x2": (2, ["--arch", "deepseek-moe-16b", "--mesh", "1x2",
                         "--density-policy", "variance", "--chunks", "3"]),
    "xlstm-1x2": (2, ["--arch", "xlstm-125m", "--mesh", "1x2"]),
    "deepseek-1x4": (4, ["--arch", "deepseek-moe-16b", "--mesh", "1x4"]),
    "xlstm-1x4": (4, ["--arch", "xlstm-125m", "--mesh", "1x4"]),
}
PERLEAF = ("xlstm-1x2-perleaf", ARCH_CASES["xlstm-1x2"][1]
           + ["--pipeline", "perleaf"])


def compare_checkpoints(one, tp, mesh, argv, cfg=CFG):
    """The TP run's gathered checkpoint against the one-process run's:
    the same keys and shapes; residuals within rtol 1e-4 / atol 1e-5 but
    at near-tie swaps, params and optimizer leaves within atol 1e-5 but
    at the swapped coordinates."""
    assert sorted(one.files) == sorted(tp.files)
    for key in one.files:
        assert one[key].shape == tp[key].shape, key
    args = cli.parse_args(argv)
    M = int(mesh.split("x")[-1])
    layout = build_layout(init_params(cfg, 0, "meta"), M, CompressionConfig(
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


@pytest.fixture(scope="module")
def arch_runs(tmp_path_factory):
    """The ``ARCH_CASES`` (and ``PERLEAF``) launches, one a process
    count, made once and read by each case: ``{name: (records, path of
    the gathered checkpoint)}``."""
    out = tmp_path_factory.mktemp("tp_archs")
    got = {}
    for procs in (2, 4):
        cases = [{"name": n, "argv": ARCH_COMMON + argv}
                 for n, (p, argv) in ARCH_CASES.items() if p == procs]
        if procs == 2:
            cases.append({"name": PERLEAF[0],
                          "argv": ARCH_COMMON + PERLEAF[1]})
        logs = launch(out, procs, cases, timeout=600)
        assert f"model={procs} tensor_parallel=1" in logs[0]
        for c in cases:
            with open(out / f"{c['name']}.json") as f:
                got[c["name"]] = (json.load(f), out / f"{c['name']}.npz")
    return got


@pytest.mark.parametrize("name", list(ARCH_CASES))
def test_tp_blocks_match_one_process(tmp_path, arch_runs, name):
    """The MoE, Mamba and xLSTM blocks tensor-parallel at the CLI
    against the one-process run at the same mesh (module docstring)."""
    procs, extra = ARCH_CASES[name]
    argv = ARCH_COMMON + extra
    args = cli.parse_args(argv)
    cfg = get_config(args.arch).reduced()
    recs = cli.run(argv + ["--device", "cpu", "--host-devices", str(procs),
                           "--checkpoint", str(tmp_path / "one.npz")])
    tp, path = arch_runs[name]
    np.testing.assert_allclose([r["loss"] for r in tp],
                               [r["loss"] for r in recs], rtol=1e-5,
                               err_msg=name)
    for a, b in zip(tp, recs):
        for k in ("collectives_per_step", "comm_bits_sparse",
                  "comm_bits_dense"):
            assert a[k] == b[k], (name, k)
    with np.load(tmp_path / "one.npz") as one, np.load(path) as got:
        compare_checkpoints(one, got, args.mesh, argv, cfg)


def test_tp_perleaf_bitwise_bucketed(arch_runs):
    """xlstm's per-leaf loop under tensor parallelism (one chunk a leaf,
    each leaf's shards relaid into its row) is bitwise the bucketed TP
    run: the losses, the params and optimizer state, and the per-leaf
    residuals packed into the bucket; L collectives a step."""
    bucketed, b_path = arch_runs["xlstm-1x2"]
    perleaf, p_path = arch_runs[PERLEAF[0]]
    assert [r["loss"] for r in perleaf] == [r["loss"] for r in bucketed]
    cfg = get_config("xlstm-125m").reduced()
    meta = init_params(cfg, 0, "meta")
    layout = build_layout(meta, 2, CompressionConfig(compressor="gaussiank",
                                                     ratio=0.02))
    assert perleaf[0]["collectives_per_step"] == len(layout.segments)
    with np.load(b_path) as b, np.load(p_path) as p:
        for key in b.files:
            if key.split("/")[0] in ("params", "opt", "step"):
                assert b[key].tobytes() == p[key].tobytes(), key
        packed = pack_residual_arrays(layout, [p[f"resid/{s.name}"]
                                               for s in layout.segments])
        assert packed.tobytes() == b["resid"].tobytes()


class ThreadAxis:
    """A model axis of ``size`` threads in this process (the
    collectives ``dist/tensor_parallel.LeafRelayout`` calls, through a
    shared barrier): rank ``rank``'s view of ``box``."""

    def __init__(self, rank, size, box):
        self.rank, self.size, self.box = rank, size, box

    def _exchange(self, x):
        self.box["slots"][self.rank] = x
        self.box["barrier"].wait()
        every = list(self.box["slots"])
        self.box["barrier"].wait()
        return every

    def gather(self, t):
        return torch.stack(self._exchange(t))

    def all_to_all(self, send, out_splits, in_splits):
        every = self._exchange(list(torch.split(send, list(in_splits))))
        return torch.cat([every[q][self.rank] for q in range(self.size)])


def _round_trip(cfg, M):
    """Every rank's shards of random whole leaves through the relayout
    into its row and back, on ``M`` threads; raises on a difference."""
    meta = init_params(cfg, 0, "meta")
    placements = check_split(cfg, meta, M)
    rng = np.random.default_rng(5)
    whole = [torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(
        np.float32)) for p in tree.leaves(meta)]
    layout = build_layout(meta, M, CompressionConfig(ratio=0.01))
    full = pack_grads(layout, whole, torch.float32)
    by_name = {s.name: pl for s, pl in zip(layout.segments, placements)}
    box = {"slots": [None] * M, "barrier": threading.Barrier(M)}
    errors = []

    def rank(r):
        try:
            axis = ThreadAxis(r, M, box)
            local = [tpm.shard(x, pl, r, M) for x, pl in zip(whole,
                                                             placements)]
            cut = tpm.state_shard_fn(by_name, r, M)
            for seg, x, mine, pl in zip(layout.segments, whole, local,
                                        placements):
                assert tuple(mine.shape) == pl.shard_shape, seg.name
                assert torch.equal(tpm.gather_leaf(mine, pl, axis), x), \
                    ("gathered", seg.name)
                assert np.array_equal(cut(f"params/{seg.name}", x.numpy()),
                                      mine.numpy()), ("cut", seg.name)
            rows = tpm.ModelRow(layout, placements, axis)
            row = rows.pack(layout, 0, local, torch.float32)
            assert torch.equal(row[0], full[r]), "the row"
            back = rows.unpack(layout, 0, row, local)
            for seg, a, b in zip(layout.segments, back, local):
                assert torch.equal(a, b), ("back into the shards",
                                           seg.name)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            box["barrier"].abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(M)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    real = [e for e in errors
            if not isinstance(e, threading.BrokenBarrierError)]
    if errors:
        raise (real or errors)[0]


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("arch", list_archs())
def test_placement_round_trip(arch, model_size):
    """Whole leaf -> shards -> the rank's row -> shards, bitwise, for the
    smoke variant of every arch: each rank's row is the whole leaf's
    flat slice (the one-process bucket's row), the mean row relaid back
    is the shard, the shards gather to the whole leaf and the checkpoint
    cut is the shard.  The full config is admitted at the same M."""
    check_split(get_config(arch), init_params(get_config(arch), 0, "meta"),
                model_size)
    _round_trip(get_config(arch).reduced(), model_size)


def test_placement_refuses_xlstm_at_m8():
    """xlstm-125m has four heads of 192: at M = 8 its mLSTM projections
    would split inside a head, which the check refuses, naming the
    first such leaf; M = 4 is admitted."""
    cfg = get_config("xlstm-125m")
    meta = init_params(cfg, 0, "meta")
    check_split(cfg, meta, 4)
    with pytest.raises(ValueError, match="'stack/0/core/out_proj'.*inside "
                                         "an mLSTM head of 192"):
        check_split(cfg, meta, 8)
