"""The port's long-sequence memory path on the CPU, against the
reference (``repro.models``) and against itself.

* Query-chunked attention (``models/layers.py``: ``_sdpa_chunked``
  above ``_SDPA_CHUNK`` = 1024 tokens when it divides T, the
  reference's condition) at T = 2048, with and without a sliding
  window, against the port's one-block run (``_SDPA_CHUNK`` raised
  above T): the output, the cached keys and values and the gradients
  of ``wq`` and ``wo`` bitwise; the gradients through the keys and
  values (of x, ``wk`` and ``wv``), which add up the blocks'
  contributions block by block as the reference's scan does, within
  2**-20 of their largest magnitude; against the reference's
  ``attention`` (which scans query blocks there too) within rtol 1e-5,
  atol 1e-6 in the output and rtol 1e-4, atol 1e-6 in the gradients
  (``tests/test_torch_model.py``'s tolerance: XLA and torch sum in
  another order).
* T = 1536: one block in both packages, the same tolerances.
* ``models.prefill`` on llama3.2-1b's smoke variant at 1 x 2048 against
  the reference's ``prefill``: the last position's logits and the
  cached values within rtol 1e-5, atol 1e-5; the cached post-RoPE keys
  within rtol 1e-5 and two ulps of the f32 rotary angle at position
  2048 times the largest key (XLA's jitted prefill rounds the angle its
  own way).
* The dry run (``launch/dryrun.py``): its four options
  (``--serve-mode``, ``--codec-dtype``, ``--shard-activations``,
  ``--hierarchical``) land in the record; the wire with a bf16 codec is
  ``pairs x k_cap x 6`` bytes; every OK record's
  ``memory.temp_bytes`` is in ``total_per_device``; a chunked
  prefill's ``temp_bytes`` is below the one-block count, and
  ``--shard-activations`` lowers a tensor-parallel train cell's (at
  the dry run's bf16) by the carries it no longer keeps whole; the
  dispatch-mode
  counter behind it counts each new storage once, views and in-place
  results not again, the caller's storages not at all.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_params as j_init
from repro.models import layers as JL
from repro.models import prefill as j_prefill
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.core.compressors import get_compressor
from repro_torch.dist.layout import build_layout, strategy_wire_pairs
from repro_torch.launch import dryrun
from repro_torch.models import ModelConfig, from_jax_params, prefill
from repro_torch.models import layers as L

torch.set_num_threads(2)

_ATTN = dict(name="attn", arch_type="dense", num_layers=1, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
NAMES = ("wq", "wk", "wv", "wo")


def _inputs(T, seed=0):
    rng = np.random.default_rng(seed)
    D, H, KV, hd = 64, 4, 2, 16
    p = {"wq": (D, H * hd), "wk": (D, KV * hd), "wv": (D, KV * hd),
         "wo": (H * hd, D)}
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in p.items()}
    x = rng.standard_normal((2, T, D)).astype(np.float32)
    # the cotangent of a mean over the 2·T tokens, as a loss's is
    ct = (rng.standard_normal((2, T, D)) / (2 * T)).astype(np.float32)
    return p, x, ct


def _port(p, x, ct, window, calls):
    cfg = ModelConfig(**_ATTN).validate()
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, (k, v) = L.attention(tp, tx, cfg, window=window)
    grads = torch.autograd.grad(out, [tx] + [tp[n] for n in NAMES],
                                torch.from_numpy(ct))
    return [out.detach(), k.detach(), v.detach()] + list(grads)


def _spy_sdpa(monkeypatch):
    calls = []
    real = L._sdpa

    def spy(*a, **k):
        calls.append(a[0].shape[1])
        return real(*a, **k)
    monkeypatch.setattr(L, "_sdpa", spy)
    return calls


@pytest.mark.parametrize("window", [0, 300])
def test_chunked_attention_is_bitwise_the_one_block_run(window, monkeypatch):
    p, x, ct = _inputs(2048)
    calls = _spy_sdpa(monkeypatch)
    chunked = _port(p, x, ct, window, calls)
    assert calls == [1024, 1024], calls     # two query blocks
    monkeypatch.setattr(L, "_SDPA_CHUNK", 4096)
    del calls[:]
    one = _port(p, x, ct, window, calls)
    assert calls == [2048], calls
    got = dict(zip(("out", "k", "v", "x") + NAMES, chunked))
    want = dict(zip(("out", "k", "v", "x") + NAMES, one))
    for what in ("out", "k", "v", "wq", "wo"):
        assert torch.equal(got[what], want[what]), what
    # the gradients through k and v sum the blocks' contributions one
    # block after the other, as the reference's scan sums them, where
    # one block reduces over all T rows at once: the same sums, rounded
    # in another order
    for what in ("x", "wk", "wv"):
        bound = 2.0 ** -20 * float(want[what].abs().max())
        assert float((got[what] - want[what]).abs().max()) <= bound, what


def _reference(p, x, ct, window):
    jcfg = JModelConfig(**_ATTN).validate()

    def f(jp, jx):
        return jnp.sum(JL.attention(jp, jx, jcfg, window=window)[0] * ct)
    out = JL.attention(p, jnp.asarray(x), jcfg, window=window)[0]
    gp, gx = jax.grad(f, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    return np.asarray(out), [np.asarray(gx)] + [np.asarray(gp[n])
                                                for n in NAMES]


@pytest.mark.parametrize("T,window", [(2048, 0), (2048, 300), (1536, 0)])
def test_attention_matches_reference(T, window, monkeypatch):
    p, x, ct = _inputs(T, seed=1)
    if T % L._SDPA_CHUNK:
        # one block in both packages
        def refuse(*a, **k):
            raise AssertionError("the reference chunked at T=1536")
        monkeypatch.setattr(JL, "_sdpa_chunked", refuse)
    calls = _spy_sdpa(monkeypatch)
    got = _port(p, x, ct, window, calls)
    assert calls == ([T] if T % 1024 else [1024] * (T // 1024)), calls
    want, wgrads = _reference(p, x, ct, window)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-6)
    for g, w, what in zip(got[3:], wgrads, ("x",) + NAMES):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6,
                                   err_msg=what)


def test_prefill_matches_reference_at_2048():
    jcfg = j_get_config("llama3.2-1b").reduced()
    cfg = get_config("llama3.2-1b").reduced()
    jparams = j_init(jcfg, jax.random.PRNGKey(4))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 2048)).astype(np.int32)
    jlogits, jcache, jpos = j_prefill(jparams, jcfg, jnp.asarray(toks))
    logits, cache, pos = prefill(params, cfg, torch.from_numpy(toks).long())
    assert pos == int(jpos) == 2048
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    jleaves = jax.tree.leaves(jcache)
    pairs = tree.flatten_with_path(cache)[0]
    assert len(jleaves) == len(pairs)
    for a, (path, b) in zip(jleaves, pairs):
        a = np.asarray(a)
        # the keys are cached after RoPE: XLA's jitted prefill rounds the
        # f32 angle pos * inv_freq its own way (its op-by-op angles are
        # the port's bits), 2 ulps of an angle near T = 2048 at most
        atol = (2 * 2.0 ** -23 * 2048 * np.abs(a).max()
                if path[-1] == "k" else 1e-5)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=atol,
                                   err_msg=tree.path_name(path))


def test_dryrun_options_land_in_the_record(tmp_path):
    out = tmp_path / "dry.json"
    rc = dryrun.main(["--arch", "llama3.2-1b", "--shape",
                      "train_4k,prefill_32k", "--mesh", "2x2x2", "--smoke",
                      "--hierarchical", "--codec-dtype", "bfloat16",
                      "--serve-mode", "model-only", "--shard-activations",
                      "--out", str(out)])
    assert rc == 0
    recs = json.loads(out.read_text())
    assert [r["status"] for r in recs] == ["OK", "OK"]
    for r in recs:
        assert r["strategy"] == "hierarchical" and r["hierarchical"]
        assert r["codec_dtype"] == "bfloat16"
        assert r["serve_mode"] == "model-only"
        assert r["shard_activations"] is True
        mem = r["memory"]
        assert mem["temp_bytes"] > 0
        assert mem["total_per_device"] == sum(
            v for k, v in mem.items() if k != "total_per_device")
        assert r["temp_method"] == "whole"


def test_dryrun_wire_in_the_codec_dtype():
    cfg = get_config("llama3.2-1b").reduced()
    from repro_torch.models import init_params
    layout = build_layout(init_params(cfg, 0, "meta"), 2, 0.001,
                          get_compressor("gaussiank"))
    pairs = strategy_wire_pairs("allgather", 2)
    for dtype, per in ((None, 8), ("bfloat16", 6)):
        rec = dryrun.run_one("llama3.2-1b", "train_4k", "2x2", smoke=True,
                             codec_dtype=dtype)
        assert rec["status"] == "OK", rec.get("traceback")
        assert rec["collectives"]["total"] == pairs * layout.k_cap_total * per


def test_dryrun_serve_mode_places_the_params():
    recs = {mode: dryrun.run_one("llama3.2-1b", "prefill_32k", "2x2",
                                 smoke=True, serve_mode=mode)
            for mode in ("2d", "model-only")}
    # 2d also splits the params over the data axis at rest
    assert recs["model-only"]["memory"]["param_bytes"] > \
        recs["2d"]["memory"]["param_bytes"]


def test_dryrun_temp_bytes_of_a_chunked_prefill(monkeypatch):
    chunked = dryrun.run_one("llama3.2-1b", "prefill_32k", "2x2",
                             smoke=True)
    monkeypatch.setattr(L, "_SDPA_CHUNK", 1 << 20)
    one = dryrun.run_one("llama3.2-1b", "prefill_32k", "2x2", smoke=True)
    a, b = chunked["memory"]["temp_bytes"], one["memory"]["temp_bytes"]
    # one block holds (B, H/M, T, T) f32 logits: 16 x 2 x 32768^2 x 4
    assert b > 16 * 2 * 32768 ** 2 * 4 > a > 0


def test_dryrun_shard_activations_lowers_the_train_temp():
    off, on = (dryrun.run_one("llama3.2-1b", "train_4k", "1x4", smoke=True,
                              shard_activations=s) for s in (False, True))
    cfg = get_config("llama3.2-1b").reduced()
    reps, M = cfg.num_layers, 4
    h = 256 * 4096 * cfg.d_model * 2        # one (B/D, T, D) bf16 carry
    # the dry run counts at bf16; the peak falls in the last period's
    # backward, where each of the reps periods keeps a quarter of its
    # input.  The recompute's RMSNorm keeps its own f32 copy of the
    # period's input in both runs, so the gathered bf16 input is dead by
    # then (at f32 the norm's input IS the gathered tensor, and the
    # difference was h * (reps * (M - 1) - M) // M)
    assert off["memory"]["temp_bytes"] - on["memory"]["temp_bytes"] == \
        h * reps * (M - 1) // M


def test_live_bytes_counts_each_new_storage_once():
    from repro_torch.launch.step_cost import LiveBytes
    x = torch.empty(256, device="meta")          # the caller's: 0 bytes
    with LiveBytes() as mode:
        y = x * 2                                # 1 KiB
        view = y.view(16, 16)                    # y's storage
        y.add_(1)
        z = torch.cat([y, view.reshape(-1)])     # 2 KiB
        assert (mode.live, mode.peak) == (3072, 3072)
        del z
        head = x[:10]                            # the caller's storage
        assert (mode.live, mode.peak) == (1024, 3072)
    del y, view, head
    assert mode.live == 0
