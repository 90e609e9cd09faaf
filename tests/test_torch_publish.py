"""The train-to-serve weight-delta stream of the port (``serve/publish.py``,
``serve/subscribe.py``, ``dist/layout.rebudget_layout``, the
checkpoint's ``publish/`` keys and the trainer's ``--publish-every``)
against the JAX package's, on the CPU.

Tolerances: the publisher's wire pairs, ``pub``, ``resid`` and message
sizes bitwise (``topk``, and the fused ``gaussiank`` whose
``bucket_compress`` ``tests/test_torch_bucket.py`` holds bitwise);
``pub`` equal to the packed replica bitwise at every tick; at a delta
the staleness ``pack(trainer) - pack(replica)`` within 1e-5 of the
residual; the train CLI's saved ``publish/pub`` within the trainer's
tolerance (rtol 1e-4, atol 1e-5, as ``tests/test_torch_train.py``).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_state as j_load_state
from repro.checkpoint import save_state as j_save_state
from repro.core.adaptk import make_policy as j_make_policy
from repro.core.compression import CompressionConfig as JCC
from repro.core.compressors import get_compressor as j_get
from repro.dist.layout import build_layout as j_build_layout
from repro.dist.layout import rebudget_layout as j_rebudget
from repro.models import init_params as j_init
from repro.models.config import ModelConfig as JModelConfig
from repro.serve import apply_message as j_apply_message
from repro.serve import init_publisher_state as j_init_pub
from repro.serve import message_bits as j_message_bits
from repro.serve import publish as j_publish
from repro.serve import publisher_config as j_publisher_config
from repro_torch import prng, tree
from repro_torch.checkpoint import load_state, save_state
from repro_torch.core.adaptk import make_policy
from repro_torch.core.compression import CompressionConfig
from repro_torch.core.compressors import get_compressor
from repro_torch.dist.layout import build_layout, pack_grads, rebudget_layout
from repro_torch.launch import train as cli
from repro_torch.models import from_jax_params
from repro_torch.serve import (RESYNC, apply_message, apply_resync,
                               init_publisher_state, message_bits, publish,
                               publisher_config)

torch.set_num_threads(2)

_SMALL = dict(name="sys", arch_type="dense", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64)
TICKS, RESYNC_EVERY = 6, 4


def _params():
    jcfg = JModelConfig(**_SMALL).validate()
    jp = j_init(jcfg, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _drift(np_tree, t):
    """A deterministic weight move, in numpy f32, fed to both packages."""
    return jax.tree.map(lambda x: (x + np.float32(0.01) * np.sin(
        x * np.float32(t + 1))).astype(np.float32), np_tree)


@pytest.mark.parametrize("ratio", [0.002, 0.01, 0.05])
@pytest.mark.parametrize("base", ["fixed", "adaptive"])
@pytest.mark.parametrize("msize", [1, 2])
def test_rebudget_layout_matches_reference(ratio, base, msize):
    """Field for field against the reference, from a fixed-k and from an
    adaptive training layout; a CompressionConfig raises TypeError."""
    jp, np_p = _params()
    tp = from_jax_params(np_p, "cpu")
    if base == "fixed":
        jl = j_build_layout(jp, msize, 0.001, j_get("gaussiank"))
        tl = build_layout(tp, msize, 0.001, get_compressor("gaussiank"))
    else:
        jl = j_build_layout(jp, msize, 0.001, j_get("gaussiank"),
                            density_policy=j_make_policy("variance"))
        tl = build_layout(tp, msize, 0.001, get_compressor("gaussiank"),
                          density_policy=make_policy("variance"))
    jr = j_rebudget(jl, ratio, j_get("topk"))
    tr = rebudget_layout(tl, ratio, get_compressor("topk"))
    assert [tuple(s) for s in tr.segments] == [tuple(s)
                                               for s in jr.segments]
    assert (tr.model_size, tr.ratio, tr.spec_name, tr.adaptive,
            tr.d_row_total, tr.k_cap_total) == (
        jr.model_size, jr.ratio, jr.spec_name, jr.adaptive, jr.d_row_total,
        jr.k_cap_total)
    assert tr.pair_bits() == jr.pair_bits()
    with pytest.raises(TypeError, match="plain ratio"):
        rebudget_layout(tl, CompressionConfig(compressor="topk"),
                        get_compressor("topk"))
    with pytest.raises(TypeError, match="plain ratio"):
        j_rebudget(jl, JCC(compressor="topk"), j_get("topk"))


@pytest.mark.parametrize("kw,match", [
    (dict(compressor="none"), "sparse"),
    (dict(compressor="topk", density_policy="variance"), "adaptive"),
    (dict(compressor="topk", momentum_correction=0.9), "momentum"),
])
def test_publisher_config_rejections(kw, match):
    """The reference's three rejections, with the same messages."""
    jkw, tkw = dict(kw), dict(kw)
    if "density_policy" in kw:
        jkw["density_policy"] = j_make_policy(kw["density_policy"])
        tkw["density_policy"] = make_policy(kw["density_policy"])
    with pytest.raises(ValueError, match=match):
        j_publisher_config(JCC(**jkw))
    with pytest.raises(ValueError, match=match):
        publisher_config(CompressionConfig(**tkw))
    assert publisher_config(None).compressor == "gaussiank"
    with pytest.raises(TypeError):
        publisher_config("topk")


def _stream(compressor, backend, msize):
    """TICKS publishes of both packages from the same drifting params,
    each message applied to a zero replica; yields per tick the JAX and
    port states, messages and replicas."""
    jp, np_p = _params()
    jcfg = JCC(compressor=compressor, ratio=0.01, backend=backend)
    tcfg = CompressionConfig(compressor=compressor, ratio=0.01,
                             backend=backend)
    jl = j_build_layout(jp, msize, jcfg)
    tl = build_layout(from_jax_params(np_p, "cpu"), msize, tcfg)
    js, ts = j_init_pub(jl), init_publisher_state(tl, device="cpu")
    jrep = jax.tree.map(jnp.zeros_like, jp)
    trep = tree.tree_map(torch.zeros_like, from_jax_params(np_p, "cpu"))
    key = jax.random.PRNGKey(7)
    cur = np_p
    for t in range(TICKS):
        cur = _drift(cur, t)
        js, jm = j_publish(js, jax.tree.map(jnp.asarray, cur), jl, jcfg,
                           key, resync_every=RESYNC_EVERY)
        trainer = from_jax_params(cur, "cpu")
        ts, tm = publish(ts, trainer, tl, tcfg, prng.PRNGKey(7),
                         resync_every=RESYNC_EVERY)
        jrep = j_apply_message(jrep, jl, jm)
        trep = apply_message(trep, tl, tm)
        yield t, tl, (js, jm, jrep), (ts, tm, trep, trainer)


@pytest.mark.parametrize("compressor,backend", [
    ("topk", "auto"), ("gaussiank", "fused"), ("gaussiank", "reference")])
@pytest.mark.parametrize("msize", [1, 2])
def test_stream_matches_reference_bitwise(compressor, backend, msize):
    """A 6-tick stream (resyncs at ticks 0 and 4): every message's kind,
    sequence number, values, indices and size, ``pub``, ``resid`` and
    the replica, bitwise the reference's."""
    kinds = []
    for t, _, (js, jm, jrep), (ts, tm, trep, _) in _stream(
            compressor, backend, msize):
        kinds.append(tm.kind)
        assert (tm.kind, tm.seq, ts["seq"]) == (jm.kind, jm.seq,
                                                int(js["seq"])), t
        assert message_bits(tm) == j_message_bits(jm), t
        if tm.kind == RESYNC:
            np.testing.assert_array_equal(tm.bucket.numpy(),
                                          np.asarray(jm.bucket))
        else:
            np.testing.assert_array_equal(tm.values.numpy(),
                                          np.asarray(jm.values))
            np.testing.assert_array_equal(tm.indices.numpy(),
                                          np.asarray(jm.indices))
        np.testing.assert_array_equal(ts["pub"].numpy(),
                                      np.asarray(js["pub"]))
        np.testing.assert_array_equal(ts["resid"].numpy(),
                                      np.asarray(js["resid"]))
        for a, b in zip(jax.tree.leaves(jrep), tree.leaves(trep)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert kinds == [0, 1, 1, 1, 0, 1]


def _storage(x):
    base = x.untyped_storage()
    return base.data_ptr(), base.data_ptr() + base.nbytes()


def _disjoint(groups):
    """No storage range of one named group overlaps another's."""
    spans = [(name, _storage(x)) for name, ts in groups.items()
             for x in ts]
    for i, (na, (a0, a1)) in enumerate(spans):
        for nb, (b0, b1) in spans[i + 1:]:
            if na != nb:
                assert a1 <= b0 or b1 <= a0, (na, nb)


@pytest.mark.parametrize("msize", [1, 2])
def test_replica_invariants_and_no_shared_storage(msize):
    """At every tick ``pub`` equals the packed replica bitwise; at a
    resync the replica equals the trainer bitwise; at a delta the
    staleness equals the residual within 1e-5 and the message is
    ``pair_bits`` (a resync ``M · d_row_total · 32``).  Trainer,
    replica, ``pub``, ``resid`` and the message's tensors share no
    storage (``data_ptr`` ranges)."""
    for t, tl, _, (ts, tm, trep, trainer) in _stream("topk", "auto",
                                                      msize):
        R = pack_grads(tl, trep, torch.float32)
        assert torch.equal(ts["pub"], R), t
        if tm.kind == RESYNC:
            for a, b in zip(tree.leaves(trep), tree.leaves(trainer)):
                assert torch.equal(a, b), t
            assert message_bits(tm) == msize * tl.d_row_total * 32
            msg = [tm.bucket]
        else:
            P = pack_grads(tl, trainer, torch.float32)
            assert float((P - R - ts["resid"]).abs().max()) <= 1e-5, t
            assert message_bits(tm) == tl.pair_bits()
            msg = [tm.values, tm.indices]
        _disjoint({"trainer": tree.leaves(trainer),
                   "replica": tree.leaves(trep), "pub": [ts["pub"]],
                   "resid": [ts["resid"]], "message": msg})


def test_resync_copies_the_bucket():
    """``apply_resync`` at model size 1, where ``unpack_tree`` would
    return views: the replica's leaves are not views of the message's
    bucket, so writing into the bucket leaves the replica unchanged."""
    _, np_p = _params()
    tp = from_jax_params(np_p, "cpu")
    tl = build_layout(tp, 1, CompressionConfig(compressor="topk"))
    bucket = pack_grads(tl, tp, torch.float32)
    rep = apply_resync(tree.tree_map(torch.zeros_like, tp), tl, bucket)
    before = [x.clone() for x in tree.leaves(rep)]
    bucket.add_(1.0)
    for a, b in zip(before, tree.leaves(rep)):
        assert torch.equal(a, b)
    _disjoint({"bucket": [bucket], "replica": tree.leaves(rep)})


def test_checkpoint_zero_fills_publish_keys(tmp_path):
    """A checkpoint written without the publisher loads into a state with
    one in both packages: ``publish/pub`` and ``publish/resid`` zero,
    ``publish/seq`` 0 (the next publish resyncs).  A publisher state
    saved by the JAX package loads into the port bitwise."""
    jp, np_p = _params()
    tp = from_jax_params(np_p, "cpu")
    cfg = CompressionConfig(compressor="topk", ratio=0.01)
    tl = build_layout(tp, 1, cfg)
    jl = j_build_layout(jp, 1, JCC(compressor="topk", ratio=0.01))
    path = str(tmp_path / "old.npz")
    save_state(path, {"params": tp, "step": 3})
    like = {"params": tree.tree_map(torch.zeros_like, tp), "step": 0,
            "publish": init_publisher_state(tl, device="cpu")}
    like["publish"]["pub"].fill_(5.0)
    like["publish"]["seq"] = 9
    got = load_state(path, like)
    jgot = j_load_state(path, {"params": jp, "step": jnp.int32(0),
                               "publish": j_init_pub(jl)})
    assert got["publish"]["seq"] == 0 == int(jgot["publish"]["seq"])
    for k in ("pub", "resid"):
        assert not bool(got["publish"][k].any())
        np.testing.assert_array_equal(got["publish"][k].numpy(),
                                      np.asarray(jgot["publish"][k]))
    assert got["step"] == 3

    # a JAX publisher state, three ticks in, loads bitwise
    js = j_init_pub(jl)
    for t in range(3):
        js, _ = j_publish(js, jax.tree.map(jnp.asarray, _drift(np_p, t)),
                          jl, JCC(compressor="topk", ratio=0.01),
                          jax.random.PRNGKey(1), resync_every=4)
    jpath = str(tmp_path / "jax.npz")
    j_save_state(jpath, {"params": jp, "publish": js})
    got = load_state(jpath, {"params": tree.tree_map(torch.zeros_like, tp),
                             "publish": init_publisher_state(
                                 tl, device="cpu")})
    assert got["publish"]["seq"] == int(js["seq"]) == 3
    for k in ("pub", "resid"):
        np.testing.assert_array_equal(got["publish"][k].numpy(),
                                      np.asarray(js[k]))


_TRAIN = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1",
          "--density-policy", "none",
          "--steps", "4", "--batch", "4", "--seq", "32", "--log-every", "1",
          "--publish-every", "1", "--resync-every", "2", "--backend",
          "reference"]


def _published(text):
    (line,) = [x for x in text.splitlines() if x.startswith("published")]
    return line


def test_train_cli_publishes_as_the_reference(tmp_path, capsys):
    """``--publish-every 1 --resync-every 2``, 4 steps: the port's
    ``published`` line equals the JAX trainer's (2 deltas + 2 resyncs,
    the same MiB), the records name each publish, and the saved
    ``publish/pub`` matches the JAX trainer's within the trainer's
    tolerance (``publish/seq`` equal)."""
    from repro.launch import train as j_cli
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_cli.main(_TRAIN + ["--mesh", "1x1", "--checkpoint", jpath])
    jline = _published(capsys.readouterr().out)
    recs = cli.run(_TRAIN + ["--device", "cpu", "--checkpoint", tpath])
    tline = _published(capsys.readouterr().out)
    assert tline == jline
    assert re.match(r"published 2 deltas \+ 2 resyncs \(\d+\.\d{3} MiB",
                    tline)
    assert [r["publish_kind"] for r in recs] == [0, 1, 0, 1]
    with np.load(jpath) as j, np.load(tpath) as t:
        assert int(t["publish/seq"]) == int(j["publish/seq"]) == 4
        np.testing.assert_allclose(t["publish/pub"], j["publish/pub"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(t["publish/resid"], j["publish/resid"],
                                   rtol=1e-4, atol=1e-5)


def test_train_cli_resumes_the_publisher(tmp_path, capsys):
    """``--checkpoint`` then ``--resume``: 3 steps and a resumed fourth
    save what 4 straight steps save, bitwise (params, momentum,
    residual and the publisher's ``publish/pub``, ``publish/resid``,
    ``publish/seq``); a resume from a checkpoint without ``publish/``
    starts the publisher at seq 0, a resync first."""
    x, a, b, c = (str(tmp_path / n) for n in ("x.npz", "a.npz", "b.npz",
                                              "c.npz"))
    plain = ["--arch", "llama3.2-1b", "--smoke", "--mesh", "1x1",
             "--density-policy",
             "none", "--device", "cpu", "--batch", "2", "--seq", "16"]
    base = plain + ["--publish-every", "1", "--resync-every", "2"]
    cli.run(base + ["--steps", "4", "--checkpoint", x])
    cli.run(base + ["--steps", "3", "--checkpoint", a])
    recs = cli.run(base + ["--steps", "1", "--resume", a, "--checkpoint",
                           b])
    assert [r["publish_kind"] for r in recs] == [1]     # seq 3: a delta
    with np.load(x) as straight, np.load(b) as resumed:
        assert sorted(straight.files) == sorted(resumed.files)
        assert int(resumed["publish/seq"]) == 4
        for k in straight.files:
            np.testing.assert_array_equal(resumed[k], straight[k], k)
    cli.run(plain + ["--steps", "1", "--checkpoint", c])
    recs = cli.run(base + ["--steps", "1", "--resume", c])
    assert [r["publish_kind"] for r in recs] == [0]
    capsys.readouterr()
