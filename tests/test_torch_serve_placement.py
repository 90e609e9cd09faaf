"""Serving placed over the mesh's model and data axes
(``serve/steps.ServePlacement``, ``models.prefill``/``decode_step``
given the model axis, ``serve/subscribe.py`` on a placed replica,
``launch/serve.py`` under ``torchrun``) and the tensor-parallel
trainer's ``--publish-every``, on the CPU: gloo processes
(``tests/_torch_serve_pg.py``) at small sizes.

* The placed CLI at ``1x2``, ``2x1`` and ``2x2`` (modes ``2d`` and
  ``model-only``), frozen and streaming, on the smoke variants of
  llama3.2-1b, deepseek-moe-16b (MoE, the batch split at ``2x1``),
  jamba-1.5-large (Mamba and MoE), xlstm-125m (mLSTM, sLSTM) and
  gemma3-4b with a sliding window of 4 (a ring that wraps): every step's
  whole-batch logits within rtol 1e-5 of the one-process port's, and
  within 1e-5 of the step's largest |logit| near zero (the row-parallel
  sums reassociate), the tokens and counters equal; at ``1x2`` and ``2x2`` the
  tokens, counters and printed lines equal the replay of the JAX driver
  (``tests/_torch_serve_ref.py``).  Mode ``2d`` is bitwise mode
  ``model-only`` (a gather is a copy).
* After every message each rank's pieces are bitwise the cut of the
  one-process replica after the same message (``apply_delta``,
  ``apply_resync``), and the gathered pieces pack to the publisher's
  ``pub`` bitwise (checked in the subprocesses, counted here).
* The placement: every flat index of every leaf is located in exactly
  one rank's piece at the element the cut puts there; the data dim at
  rest is the reference's ``serve_param_specs``' wherever the port's
  model placement is the reference's spec (all ten archs at their
  published widths), but never a stacked dim; serving refuses the splits
  training refuses.
* The tensor-parallel trainer's ``--publish-every`` at ``1x2``: every
  message, ``pub`` and residual bitwise the one-process publisher's row
  on the same params, the records' kinds and bits and the ``published``
  line equal the one-process ``--mesh 1x2`` run's, the gathered
  checkpoint's ``publish/`` keys the one-process publisher's state
  bitwise, and a resumed run's checkpoint bitwise a straight run's.
"""
import dataclasses
import functools
import json
import re
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_serve_pg import launch, serve_cfg
from _torch_serve_ref import replay
from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init
from repro.serve.steps import serve_param_specs as j_serve_param_specs
from repro_torch import tree
from repro_torch.configs import get_config, list_archs
from repro_torch.dist.tensor_parallel import check_split
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import ModelConfig, init_params
from repro_torch.serve import ServePlacement
from repro_torch.serve.steps import at_rest_data_dim

torch.set_num_threads(2)

TRAFFIC = ["--smoke", "--requests", "3", "--max-batch", "2",
           "--prompt-len", "8", "--gen", "4"]
STREAM = ["--publish-every", "2", "--resync-every", "2"]
# name -> (processes, arch, mesh, extra flags, sliding window)
SERVE = {
    "llama-1x2-stream": (2, "llama3.2-1b", "1x2", STREAM, None),
    "llama-2x1-stream": (2, "llama3.2-1b", "2x1", STREAM, None),
    "deepseek-1x2": (2, "deepseek-moe-16b", "1x2", [], None),
    "deepseek-2x1": (2, "deepseek-moe-16b", "2x1", [], None),
    "jamba-1x2-stream": (2, "jamba-1.5-large-398b", "1x2", STREAM, None),
    "xlstm-1x2": (2, "xlstm-125m", "1x2", [], None),
    "gemma-1x2-swa": (2, "gemma3-4b", "1x2", [], 4),
    "llama-2x2-frozen": (4, "llama3.2-1b", "2x2", [], None),
    "llama-2x2-stream": (4, "llama3.2-1b", "2x2", STREAM, None),
    "llama-2x2-stream-model-only": (4, "llama3.2-1b", "2x2",
                                    STREAM + ["--placement", "model-only"],
                                    None),
    "jamba-2x2": (4, "jamba-1.5-large-398b", "2x2", [], None),
}
REPLAYED = ("llama-1x2-stream", "llama-2x2-frozen", "llama-2x2-stream")

TRAIN = ["--arch", "llama3.2-1b", "--smoke", "--compressor", "gaussiank",
         "--ratio", "0.02", "--density-policy", "none", "--batch", "4",
         "--seq", "16", "--log-every", "1", "--mesh", "1x2",
         "--publish-every", "1", "--resync-every", "2",
         "--publish-ratio", "0.05"]
TRAIN_CASES = [
    {"name": "tp-publish", "kind": "train", "argv": TRAIN + ["--steps", "4"]},
    {"name": "tp-publish-a", "kind": "train",
     "argv": TRAIN + ["--steps", "3"]},
    {"name": "tp-publish-b", "kind": "train",
     "argv": TRAIN + ["--steps", "1"], "resume": "tp-publish-a"},
]
# at 2x2 (four processes): the data replicas publish the same rows
TRAIN_2X2 = {"name": "tp-publish-2x2", "kind": "train",
             "argv": TRAIN[:-8] + ["--mesh", "2x2"] + TRAIN[-6:]
             + ["--steps", "2"]}


def _argv(arch, mesh, extra):
    return ["--arch", arch, "--mesh", mesh] + TRAFFIC + list(extra)


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    """Every placed launch, one a process count, made once: ``{name:
    (the rank-0 record, the logits of every step)}``."""
    out = tmp_path_factory.mktemp("serve_placed")
    got = {}
    for procs in (2, 4):
        cases = [{"name": n, "kind": "serve",
                  "argv": _argv(arch, mesh, extra), "window": window}
                 for n, (p, arch, mesh, extra, window) in SERVE.items()
                 if p == procs]
        cases += TRAIN_CASES if procs == 2 else [TRAIN_2X2]
        launch(out, procs, cases, timeout=600)
        for c in cases:
            with open(out / f"{c['name']}.json") as f:
                rec = json.load(f)
            if c["kind"] == "serve":
                with np.load(out / f"{c['name']}.npz") as z:
                    rec["logits"] = [z[k] for k in sorted(
                        z.files, key=lambda k: int(k.split("_")[1]))]
            got[c["name"]] = rec
    got["dir"] = out
    return got


def _one_process(name):
    """The one-process port's run of case ``name`` (``--mesh 1x1``):
    its result and every step's logits."""
    _, arch, _, extra, window = SERVE[name]
    argv = _argv(arch, "1x1", [x for x in extra if x not in (
        "--placement", "model-only")])
    logits = []
    got = serve_cli.run(argv + ["--device", "cpu"],
                        cfg=serve_cfg(argv, window),
                        on_logits=lambda w, s, x: logits.append(x.numpy()))
    return got, logits


@pytest.mark.parametrize("name", list(SERVE))
def test_placed_serving_matches_one_process(placed, name):
    """Every step's whole-batch logits within rtol 1e-5 of the
    one-process port's, the tokens and counters equal, every publish's
    replica checked in the ranks, and the startup line states the
    placement."""
    procs, arch, mesh, extra, _ = SERVE[name]
    rec = placed[name]
    want, logits = _one_process(name)
    assert len(rec["logits"]) == len(logits)
    for a, b in zip(rec["logits"], logits):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)
    assert rec["tokens"] == [t.tolist() for t in want["tokens"]]
    for k in ("done", "waves", "tokens_out", "decode_steps", "deltas",
              "resyncs", "wire_bits", "slot_util"):
        assert rec[k] == want[k], (name, k)
    assert rec["checked"] == want["deltas"] + want["resyncs"]
    D, M = (int(x) for x in mesh.split("x"))
    rows = ("1 sequences a data group" if D == 2 else
            "the whole batch in every data group")
    mode = "model-only" if "model-only" in extra else "2d"
    assert f"data={D} ({rows}) model={M} (a shard a rank, mode {mode}) " \
           f"ranks={procs} dist_backend=gloo" in rec["out"]
    # 2d gathers every block's pieces over a data group of 2
    assert (rec["gathers"] > 0) == (D > 1 and mode == "2d"), name


@pytest.mark.parametrize("name", REPLAYED)
def test_placed_cli_matches_jax_replay(placed, name):
    """The placed CLI's tokens, counters and printed ``stream:`` /
    ``serve:`` lines equal the replay of the JAX driver's."""
    _, arch, _, extra, _ = SERVE[name]
    kw = dict(requests=3, max_batch=2, prompt_len=8, gen=4)
    if "--publish-every" in extra:
        kw.update(publish_every=2, resync_every=2)
    ref = replay(arch, **kw)
    rec = placed[name]
    assert rec["tokens"] == [np.asarray(t).tolist() for t in ref["tokens"]]
    for k in ("done", "requests", "waves", "tokens_out", "decode_steps",
              "deltas", "resyncs", "wire_bits", "slot_util"):
        assert rec[k] == ref[k], k
    lines = rec["out"].splitlines()
    (serve_line,) = [x for x in lines if x.startswith("serve:")]
    assert serve_line.startswith(
        f"serve: {ref['done']}/{ref['requests']} requests in "
        f"{ref['waves']} waves, {ref['tokens_out']} tokens")
    stream = [x for x in lines if x.startswith("stream:")]
    if "publish_every" in kw:
        (line,) = stream
        assert line.startswith(
            f"stream: {ref['deltas']} deltas + {ref['resyncs']} resyncs, "
            f"{ref['wire_mib']:.3f} MiB on the wire")
        np.testing.assert_allclose(rec["staleness"], ref["staleness"],
                                   rtol=1e-4)
    else:
        assert not stream


def test_2d_bitwise_model_only(placed):
    """At ``2x2`` the data axis's gathers change no bit: every logit of
    mode ``2d`` equals mode ``model-only``'s, and so do the tokens."""
    a, b = placed["llama-2x2-stream"], placed["llama-2x2-stream-model-only"]
    assert a["gathers"] > 0 == b["gathers"]
    assert a["tokens"] == b["tokens"]
    for x, y in zip(a["logits"], b["logits"]):
        assert x.tobytes() == y.tobytes()


class _Wire:
    """What ``ServePlacement`` reads of a launch's wire, for rank ``(j,
    r)`` of a ``D x M`` mesh (no process group)."""

    def __init__(self, D, M, j=0, r=0):
        self.world, self.model_size, self.rank, self.model_rank = D, M, j, r
        self.tensor_parallel = M > 1
        self.data_axes = ("data",)


def _places(cfg, D, M, mode="2d"):
    meta = init_params(cfg, 0, "meta")
    return [[ServePlacement(cfg, _Wire(D, M, j, r), meta, mode)
             for r in range(M)] for j in range(D)]


@pytest.mark.parametrize("D,M", [(2, 1), (1, 2), (2, 2), (2, 4)])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "jamba-1.5-large-398b",
                                  "xlstm-125m", "deepseek-moe-16b"])
def test_locate_inverts_the_cut(arch, D, M):
    """For every leaf of the smoke variant, the pieces of all ``D·M``
    ranks tile the whole leaf: each flat index is located in one rank's
    piece (in every rank's along an axis that keeps the leaf whole) at
    the element the cut put there (what a delta's pairs are mapped
    through)."""
    cfg = get_config(arch).reduced()
    ranks = [p for row in _places(cfg, D, M) for p in row]
    gen = torch.Generator().manual_seed(0)
    for path, leaf in tree.flatten_with_path(init_params(cfg, 0, "meta"))[0]:
        name = tree.path_name(path)
        whole = torch.randn(leaf.shape, generator=gen)
        idx = torch.arange(whole.numel())
        hits = torch.zeros(whole.numel(), dtype=torch.int64)
        for pl in ranks:
            piece = pl.cut(path, whole).reshape(-1)
            loc = pl.locate(name, idx)
            mine = loc >= 0
            hits += mine
            assert torch.equal(piece[loc[mine]], whole.reshape(-1)[mine]), \
                name
            assert int(mine.sum()) == piece.numel(), name
        place = ranks[0].places[name]
        copies = (M if place.pl.replicated else 1) * (
            D if place.data_dim is None else 1)
        assert bool((hits == copies).all()), name


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.eval_shape(functools.partial(j_init, j_get_config(arch)),
                          jax.random.PRNGKey(0))


def _jax_specs(arch, D, M):
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((D, M)))
    specs = j_serve_param_specs(_jax_params(arch), mesh)
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))]


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_at_rest_data_dim_matches_reference(arch):
    """At ``(D, M)`` in {(4, 1), (2, 2), (4, 2), (2, 4)}, at the
    published widths: wherever the port's model placement is the
    reference's spec, the data dim at rest is the one the reference's
    ``serve_param_specs`` (mode ``2d``) picks, unless that is a stacked
    dim; everywhere it is a dim of the model shard that ``D`` divides,
    besides the model's and never the stacked one."""
    from repro_torch.dist import sharding as shd
    cfg = get_config(arch)
    meta = init_params(cfg, 0, "meta")
    pairs = tree.flatten_with_path(meta)[0]
    for D, M in ((4, 1), (2, 2), (4, 2), (2, 4)):
        placements = check_split(cfg, meta, M)
        for (path, leaf), pl, ref in zip(pairs, placements,
                                         _jax_specs(arch, D, M)):
            name, shape = tree.path_name(path), tuple(leaf.shape)
            d = at_rest_data_dim(path, shape, pl, D, M)
            same = pl.view == pl.shape and pl.dim == shd.sharded_dim(
                shd.param_spec(path, shape, "model", M))
            ref_dim = ref.index("data") if "data" in ref else None
            stacked = str(path[0]) == "stack"
            if same and not (stacked and ref_dim == 0):
                assert d == ref_dim, (name, D, M, d, ref)
            if d is not None:
                assert pl.shard_shape[d] % D == 0, (name, d)
                assert not (stacked and d == 0), name
                assert pl.replicated or pl.shard_shape[d] == shape[d], name


def test_serving_refuses_the_splits_training_refuses():
    """At M = 4 the 2-layer config's KV projections (2 heads of 16)
    would split inside a head: the placement refuses, naming the leaf,
    as ``check_split`` does for training."""
    cfg = ModelConfig(name="t", arch_type="dense", num_layers=2, d_model=64,
                      num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=64).validate()
    with pytest.raises(ValueError, match="'stack/0/core/wk'.*inside an "
                                         "attention head of 16"):
        ServePlacement(cfg, _Wire(1, 4), init_params(cfg, 0, "meta"))
    with pytest.raises(ValueError, match="serving mode"):
        ServePlacement(cfg, _Wire(2, 1), init_params(cfg, 0, "meta"), "1d")


def test_tp_publisher_matches_one_process(placed, tmp_path):
    """The tensor-parallel trainer's ``--publish-every 1`` at ``1x2``:
    every publish checked bitwise in the ranks against the one-process
    publisher's row on the same params; the records' kinds and bits and
    the ``published`` line equal the one-process ``--mesh 1x2`` run's;
    the gathered checkpoint has its keys and shapes, and its
    ``publish/pub`` and ``publish/resid`` are the one-process
    publisher's state bitwise."""
    rec = placed["tp-publish"]
    assert rec["checked"] == 4
    one = train_cli.run(TRAIN + ["--steps", "4", "--device", "cpu",
                                 "--host-devices", "2", "--checkpoint",
                                 str(tmp_path / "one.npz")])
    for a, b in zip(rec["records"], one):
        assert a["publish_kind"] == b["publish_kind"]
        assert a["publish_bits"] == b["publish_bits"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
    (line,) = [x for x in rec["out"].splitlines()
               if x.startswith("published")]
    assert re.fullmatch(r"published 2 deltas \+ 2 resyncs \(\d+\.\d{3} MiB "
                        r"on the wire\)", line)
    bits = sum(r["publish_bits"] for r in one)
    assert line == (f"published 2 deltas + 2 resyncs "
                    f"({bits / 8 / 2 ** 20:.3f} MiB on the wire)")
    d = placed["dir"]
    with np.load(d / "tp-publish.npz") as tp, \
            np.load(tmp_path / "one.npz") as ref, \
            np.load(d / "tp-publish-shadow.npz") as shadow:
        assert sorted(tp.files) == sorted(ref.files)
        for k in ref.files:
            assert tp[k].shape == ref[k].shape, k
        for k in ("pub", "resid"):
            assert tp[f"publish/{k}"].tobytes() == shadow[k].tobytes(), k
        assert int(tp["publish/seq"]) == 4


def test_tp_publisher_resumes_bitwise(placed):
    """Three steps, a checkpoint, and one resumed step save what four
    straight steps save under tensor parallelism, ``publish/`` included,
    bitwise."""
    d = placed["dir"]
    assert placed["tp-publish-b"]["checked"] == 1
    assert [r["publish_kind"] for r in placed["tp-publish-b"]["records"]] \
        == [1]
    with np.load(d / "tp-publish.npz") as s, \
            np.load(d / "tp-publish-b.npz") as r:
        assert sorted(s.files) == sorted(r.files)
        for k in s.files:
            assert s[k].tobytes() == r[k].tobytes(), k


def test_draw_with_cut_is_the_cut_of_the_draw():
    """``init_params(cut=)`` keeps, leaf by leaf and rep by rep, what the
    cut of the whole draw keeps, bitwise (jamba's smoke variant at
    ``2x2``, mode ``2d``, every rank)."""
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced())
    whole = init_params(cfg, 3, "cpu")
    for row in _places(cfg, 2, 2):
        for pl in row:
            kept = init_params(cfg, 3, "cpu", cut=pl.cut)
            for a, b in zip(tree.leaves(kept),
                            tree.leaves(pl.cut_tree(whole))):
                assert torch.equal(a, b)


def test_tp_publisher_data_replicas_agree(placed):
    """At ``2x2`` every publish of every rank is the one-process
    publisher's row on the same params, and both data replicas of each
    model rank publish the same message, ``pub`` and residual (checked
    in the ranks)."""
    rec = placed["tp-publish-2x2"]
    assert rec["checked"] == 2
    assert [r["publish_kind"] for r in rec["records"]] == [0, 1]
