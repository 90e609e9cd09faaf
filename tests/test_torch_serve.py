"""Serving in the port (``models.prefill``/``decode_step`` and the KV
cache, ``serve/steps.py``, ``prng.gumbel``/``categorical``,
``launch/serve.py`` and the ``serve_staleness`` benchmark) against the
JAX package, on the CPU.

Tolerances: prefill and decode logits and caches within rtol 1e-5,
atol 1e-5 of the reference's from the same weights (f32 matmuls sum in
another order in XLA and torch); decode against the port's own forward
within rtol 1e-4, atol 1e-5; ``gumbel`` draws within rtol 1e-5, atol
1e-6 (torch's ``log`` against XLA's, an ulp apart), samples equal; the
serving CLI's tokens, counters and wire size equal the replay's
(``tests/_torch_serve_ref.py``), its staleness within rtol 1e-4.
"""
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import decode_step as j_decode
from repro.models import init_params as j_init
from repro.models import prefill as j_prefill
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import prng, tree
from repro_torch.configs import get_config
from repro_torch.launch import serve as cli
from repro_torch.models import (ModelConfig, decode_step, forward,
                                from_jax_params, init_cache, init_params,
                                prefill)
from repro_torch.serve import make_decode_step, make_prefill_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_serve_ref import replay  # noqa: E402

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BASE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             d_ff=128, vocab_size=64)
CASES = {
    "attn": dict(_BASE, name="s-attn", arch_type="dense"),
    # window 4 below the prompt's 8: the ring wraps in the prefill and
    # again in the decode; reps 1 + a tail layer
    "swa": dict(_BASE, name="s-swa", arch_type="dense", num_layers=3,
                block_pattern=("swa", "attn"), sliding_window=4),
    "parallel": dict(_BASE, name="s-par", arch_type="dense",
                     parallel_block=True, use_bias=True),
}


def _pair(case):
    kw = CASES[case]
    jcfg, tcfg = JModelConfig(**kw).validate(), ModelConfig(**kw).validate()
    jp = j_init(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, from_jax_params(jax.tree.map(np.asarray, jp),
                                           "cpu")


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), **tol)


@pytest.mark.parametrize("case", ["attn", "swa"])
def test_prefill_and_decode_match_reference(case):
    """Prompt 8, ``s_max`` 12, then 4 decode steps (the swa ring wraps):
    logits and every cache leaf within rtol 1e-5, atol 1e-5; the cache
    tree the reference's."""
    jcfg, tcfg, jp, tp = _pair(case)
    toks = np.random.default_rng(3).integers(0, 64, (2, 12)).astype(
        np.int32)
    T, s_max = 8, 12
    jl, jc, jn = j_prefill(jp, jcfg, tokens=jnp.asarray(toks[:, :T]),
                           s_max=s_max)
    tl, tc, tn = prefill(tp, tcfg, torch.from_numpy(toks[:, :T]).long(),
                         s_max=s_max)
    assert tn == jn == T and tuple(tl.shape) == jl.shape == (2, 1, 64)
    tol = dict(rtol=1e-5, atol=1e-5)
    _close(jl, tl, **tol)
    jleaves, jtd = jax.tree_util.tree_flatten_with_path(jc)
    tleaves = tree.flatten_with_path(tc)[0]
    assert [tree.path_name(p) for p, _ in tleaves] == [
        "/".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in p)
        for p, _ in jleaves]
    for (_, a), (_, b) in zip(jleaves, tleaves):
        assert a.shape == tuple(b.shape)
        _close(a, b, **tol)
    for pos in range(T, s_max):
        jl, jc = j_decode(jp, jcfg, jc, jnp.int32(pos),
                          tokens=jnp.asarray(toks[:, pos:pos + 1]))
        tl, tc = decode_step(tp, tcfg, tc, pos,
                             torch.from_numpy(toks[:, pos:pos + 1]).long())
        _close(jl, tl, err_msg=f"pos {pos}", **tol)
        for a, b in zip(jax.tree.leaves(jc), tree.leaves(tc)):
            _close(a, b, err_msg=f"cache at pos {pos}", **tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_matches_forward(case):
    """The port alone, as ``tests/test_consistency.py``: prefill T-2
    tokens, decode positions T-2 and T-1 — the logits are the full
    forward's at those positions (rtol 1e-4, atol 1e-5)."""
    _, cfg, _, params = _pair(case)
    B, T = 2, 16
    toks = prng.randint(prng.PRNGKey(1), (B, T), 0, cfg.vocab_size,
                        device="cpu")
    with torch.no_grad():
        full = forward(params, cfg, toks)
    last, cache, pos = prefill(params, cfg, toks[:, :T - 2], s_max=T)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, T - 3].numpy(),
                               **tol)
    for p in range(T - 2, T):
        logits, cache = decode_step(params, cfg, cache, p, toks[:, p:p + 1])
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, p].numpy(), err_msg=f"pos {p}",
                                   **tol)


def test_swa_ring_long_decode():
    """Decode to three windows past the prompt: the ring-buffer
    attention equals the full forward's last position."""
    cfg = ModelConfig(**dict(CASES["swa"], num_layers=2,
                             block_pattern=("swa",), sliding_window=8)
                      ).validate()
    params = init_params(cfg, 0, "cpu")
    W = cfg.sliding_window
    toks = prng.randint(prng.PRNGKey(2), (1, 3 * W), 0, cfg.vocab_size,
                        device="cpu")
    _, cache, _ = prefill(params, cfg, toks[:, :W], s_max=W)
    for p in range(W, 3 * W):
        logits, cache = decode_step(params, cfg, cache, p, toks[:, p:p + 1])
    with torch.no_grad():
        full = forward(params, cfg, toks)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=1e-4, atol=1e-5)


def test_serve_steps_and_cache_tree():
    """``make_prefill_step``/``make_decode_step`` are the model functions
    on the step's device; ``init_cache`` keeps the reference's tree (a
    (reps, B, n, KV, hd) leaf a stacked position, ring length
    ``min(window, s_max)``)."""
    _, cfg, _, params = _pair("swa")
    cache = init_cache(cfg, 3, 10, device="cpu")
    assert [tuple(c["k"].shape) for c in cache["stack"]] == [
        (1, 3, 4, 2, 16), (1, 3, 10, 2, 16)]
    assert [tuple(c["v"].shape) for c in cache["tail"]] == [(3, 4, 2, 16)]
    toks = torch.arange(24).reshape(3, 8) % cfg.vocab_size
    pre = make_prefill_step(cfg, "cpu", s_max=10)
    dec = make_decode_step(cfg, "cpu")
    a, ca = pre(params, toks)
    b, cb, _ = prefill(params, cfg, toks, s_max=10)
    assert torch.equal(a, b)
    a, _ = dec(params, ca, 8, toks[:, :1])
    b, _ = decode_step(params, cfg, cb, 8, toks[:, :1])
    assert torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_decode_step(cfg)


@pytest.mark.parametrize("seed", [0, 5])
def test_gumbel_and_categorical_match_jax(seed):
    """``prng.gumbel`` within rtol 1e-5 (atol 1e-6) of
    ``jax.random.gumbel``; ``prng.categorical`` samples equal
    ``jax.random.categorical``'s over 30 keys."""
    key = jax.random.PRNGKey(seed)
    shape = (16, 4099)
    np.testing.assert_allclose(
        prng.gumbel(prng.PRNGKey(seed), shape, device="cpu").numpy(),
        np.asarray(jax.random.gumbel(key, shape)), rtol=1e-5, atol=1e-6)
    logits = (3 * np.random.default_rng(seed).standard_normal(
        (8, 5000))).astype(np.float32)
    for s in range(30):
        a = np.asarray(jax.random.categorical(
            jax.random.fold_in(key, s), jnp.asarray(logits)))
        b = prng.categorical(prng.fold_in(prng.PRNGKey(seed), s),
                             torch.from_numpy(logits))
        np.testing.assert_array_equal(b.numpy(), a)


_CLI_CASES = {
    "frozen": dict(requests=5, max_batch=2, prompt_len=8, gen=6),
    "streaming": dict(requests=5, max_batch=2, prompt_len=8, gen=6,
                      publish_every=2, resync_every=3),
    "sampled": dict(requests=3, max_batch=4, prompt_len=6, gen=5,
                    publish_every=1, resync_every=2, temperature=0.7),
}


def _argv(kw):
    argv = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1", "--device",
            "cpu"]
    for k, v in kw.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    return argv


def _numbers(line):
    return [float(x) for x in re.findall(r"\d+\.?\d*(?:e[-+]\d+)?", line)]


@pytest.mark.parametrize("case", sorted(_CLI_CASES))
def test_serve_cli_matches_reference_replay(case, capsys):
    """``python -m repro_torch.launch.serve --device cpu`` against the
    replay of the JAX driver through its library calls: the emitted
    tokens of every wave, the counters and the wire bits equal, the
    staleness within rtol 1e-4, and the ``stream:``/``serve:`` lines'
    counts equal (requests, waves, tokens, deltas, resyncs, MiB)."""
    kw = _CLI_CASES[case]
    ref = replay(**kw)
    got = cli.run(_argv(kw))
    out = capsys.readouterr().out
    assert len(got["tokens"]) == len(ref["tokens"]) == ref["waves"]
    for a, b in zip(ref["tokens"], got["tokens"]):
        np.testing.assert_array_equal(b.numpy(), a)
    for k in ("done", "requests", "waves", "tokens_out", "decode_steps",
              "deltas", "resyncs", "wire_bits", "slot_util"):
        assert got[k] == ref[k], k
    (serve_line,) = [x for x in out.splitlines() if x.startswith("serve:")]
    n = _numbers(serve_line)
    assert n[:4] == [ref["done"], ref["requests"], ref["waves"],
                     ref["tokens_out"]]
    stream = [x for x in out.splitlines() if x.startswith("stream:")]
    if "publish_every" not in kw:
        assert not stream and "staleness" not in got
        return
    (stream_line,) = stream
    assert _numbers(stream_line)[:3] == [
        ref["deltas"], ref["resyncs"], round(ref["wire_mib"], 3)]
    np.testing.assert_allclose(got["staleness"], ref["staleness"],
                               rtol=1e-4)


def test_serve_cli_acceptance_line(capsys):
    """The acceptance command prints the ``stream:`` and ``serve:``
    lines and reports per-phase times."""
    got = cli.run(["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1",
                   "--device", "cpu",
                   "--requests", "4", "--max-batch", "2", "--prompt-len",
                   "8", "--gen", "4", "--publish-every", "2",
                   "--resync-every", "2"])
    out = capsys.readouterr().out
    assert re.search(r"^stream: \d+ deltas \+ \d+ resyncs", out, re.M)
    assert re.search(r"^serve: 4/4 requests in 2 waves", out, re.M)
    assert "data=1 (the whole batch on one cpu device)" in out
    assert {"prefill", "decode", "drift", "publish_resync",
            "apply_resync"} <= set(got["times"])


@pytest.mark.parametrize("extra,err,match", [
    (["--mesh", "2x2"], None, None),
    (["--arch", "jamba-1.5-large-398b"], None, None),
])
def test_serve_cli_names_what_it_lacks(extra, err, match):
    """Nothing of these is missing any more.  In one process a model
    axis above 1 (slice 2c, which it raised for before) serves the whole
    batch on one device, as a data axis above 1 does: the model axis
    shards the reference's params but changes no token; under
    ``torchrun`` the mesh is placed on the ranks
    (``tests/test_torch_serve_placement.py``).  jamba-1.5-large (slice 8)
    serves too.  Each run's tokens equal the replay of the JAX driver's
    (``tests/_torch_serve_ref.py``)."""
    argv = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1", "--device",
            "cpu",
            "--requests", "2", "--max-batch", "2", "--prompt-len", "4",
            "--gen", "2"] + extra
    if err is None:
        got = cli.run(argv)
        arch = [argv[i + 1] for i, a in enumerate(argv) if a == "--arch"][-1]
        ref = replay(arch, requests=2, max_batch=2, prompt_len=4, gen=2)
        for a, b in zip(ref["tokens"], got["tokens"]):
            np.testing.assert_array_equal(b.numpy(), a)
        assert got["tokens_out"] == ref["tokens_out"]
        return
    with pytest.raises(err, match=match):
        cli.run(argv)


def _port_normal(shape):
    """``embed_prompt`` for the replay: the port's ``prng.normal`` draw
    of ``shape`` from the JAX key's two words."""
    def draw(pk):
        key = tuple(int(x) for x in np.asarray(pk))
        return prng.normal(key, shape, device="cpu").numpy()
    return draw


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "xlstm-125m",
                                  "musicgen-medium"])
def test_serve_cli_new_archs_match_reference_replay(arch):
    """The MoE, xLSTM and ``embeds`` smoke models served by the CLI in two
    waves (MoE layers over KV caches, the mLSTM and sLSTM states;
    musicgen prefills embeddings and decodes tokens): the tokens of every
    wave and the counters equal the replay's, which is fed the
    embeddings the port drew."""
    kw = dict(requests=3, max_batch=2, prompt_len=8, gen=4)
    cfg = get_config(arch).reduced()
    ref = replay(arch, embed_prompt=_port_normal((2, 8, cfg.d_model)), **kw)
    argv = ["--arch", arch, "--smoke", "--mesh", "1x1", "--device", "cpu"]
    for k, v in kw.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    got = cli.run(argv)
    assert len(got["tokens"]) == ref["waves"] == 2
    for a, b in zip(ref["tokens"], got["tokens"]):
        np.testing.assert_array_equal(b.numpy(), a)
    for k in ("done", "tokens_out", "decode_steps", "slot_util"):
        assert got[k] == ref[k], k


def test_serve_cli_data_axis_and_gpu_check(monkeypatch, capsys):
    """``--mesh 4x1`` is the same function on one device; without a GPU
    ``--device cuda`` (the default) exits."""
    argv = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1", "--requests",
            "3",
            "--max-batch", "2", "--prompt-len", "4", "--gen", "3"]
    a = cli.run(argv + ["--device", "cpu"])
    b = cli.run(argv + ["--device", "cpu", "--mesh", "4x1",
                        "--host-devices", "4"])
    assert "data=4 (the whole batch on one cpu device)" in \
        capsys.readouterr().out
    for x, y in zip(a["tokens"], b["tokens"]):
        assert torch.equal(x, y)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.run(argv)


def test_serve_staleness_rows_match_baseline():
    """The port's ``serve_staleness`` driver at smoke size on the CPU:
    its deterministic rows (the delta wire at three ratios, exact
    resyncs, staleness == residual) equal ``benchmarks/baselines/
    serve.json``'s, and its token rows name the baseline's shapes and
    counts."""
    from repro_torch.benchmarks import serve_staleness as sv
    rows, data = sv.collect(smoke=True, device="cpu")
    with open(os.path.join(ROOT, "benchmarks", "baselines",
                           "serve.json")) as f:
        base = json.load(f)["rows"]
    got = {(r["shape"], r["method"]): r["passes"] for r in data["rows"]}
    for r in base:
        assert got[(r["shape"], r["method"])] == r["passes"], r
    assert [r[0] for r in rows][:5] == [
        "serve/delta-wire-r0.002/L6-M2", "serve/delta-wire-r0.01/L6-M2",
        "serve/delta-wire-r0.05/L6-M2", "serve/resync-exact/L6-M2",
        "serve/gap-vs-resid/L6-M2"]
    assert rows[-1][0] == "serve/stream-ratio/sv-B4-g8"
