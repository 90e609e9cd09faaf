"""A replay of the JAX serving driver (``repro/launch/serve.py:main``)
through the JAX library calls, without a mesh.

The JAX driver's jitted, sharded prefill does not run on the CPU under
the jax these tests run with (``ShardingTypeError`` in
``repro.serve.steps.make_prefill_step`` even at a 1x1 mesh), so this
helper makes the same calls in the same order with the library
functions it wraps: ``repro.models.prefill`` and ``decode_step`` (each
jitted without shardings), ``repro.serve.publish``, ``apply_resync`` and
``apply_delta``, the drift step, the queue and the prompt draws.
Every architecture's cache (KV, ring, Mamba, xLSTM) is the library's;
an ``embeds`` model's prompts are ``jax.random.normal`` draws of (B, T,
d_model) embeddings, or ``embed_prompt(pk)``'s (a numpy array from the
wave's prompt key ``pk``), so that a test can feed the replay the very
embeddings the port drew.  Returns what
``repro_torch.launch.serve.run`` returns, minus the times.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.core.compression import CompressionConfig
from repro.dist.layout import build_layout
from repro.models import decode_step, init_params, prefill
from repro.serve import (RESYNC, apply_delta, apply_resync,
                         init_publisher_state, message_bits, publish)


def replay(arch="llama3.2-1b", *, smoke=True, requests=8, max_batch=8,
           prompt_len=64, gen=16, seed=0, temperature=0.0,
           publish_every=0, publish_ratio=0.01, resync_every=8, cfg=None,
           embed_prompt=None):
    if cfg is None:
        cfg = get_config(arch)
        if smoke:
            cfg = cfg.reduced()
    key = jax.random.PRNGKey(seed)
    trainer = init_params(cfg, key)
    params = jax.tree.map(lambda x: x, trainer)
    B, T = max_batch, prompt_len
    s_max = T + gen
    streaming = publish_every > 0
    if streaming:
        pub_config = CompressionConfig(compressor="topk", ratio=publish_ratio)
        layout = build_layout(trainer, 1, pub_config)
        pub_state = init_publisher_state(layout)
        apply_jit = jax.jit(lambda p, v, i: apply_delta(p, layout, v, i))
        pub_key = jax.random.fold_in(key, 0x5EEDED)

        @jax.jit
        def drift(p, i):
            return jax.tree.map(
                lambda x: x + 1e-3 * jnp.sin(x * (1.0 + 0.1 * i)), p)

    kw = "embeds" if cfg.frontend == "embeds" else "tokens"
    prefill_step = jax.jit(lambda p, prompt: prefill(
        p, cfg, s_max=s_max, **{kw: prompt})[:2])
    decode = jax.jit(lambda p, c, pos, tok: decode_step(p, cfg, c, pos,
                                                        tokens=tok))
    rng = np.random.default_rng(seed)
    queue = [int(rng.integers(max(1, gen // 2), gen + 1))
             for _ in range(requests)]
    done = tokens_out = slot_steps = slot_busy = 0
    deltas = resyncs = wire_bits = decode_steps = 0
    waves_tokens = []
    wave = 0
    while queue:
        admit, queue = queue[:max_batch], queue[max_batch:]
        nact = len(admit)
        gens = admit + [0] * (B - nact)
        wave_gen = max(admit)
        key, pk = jax.random.split(key)
        if kw == "tokens":
            prompt = jax.random.randint(pk, (B, T), 0, cfg.vocab_size)
        elif embed_prompt is not None:
            prompt = jnp.asarray(embed_prompt(pk))
        else:
            prompt = jax.random.normal(pk, (B, T, cfg.d_model))
        logits, cache = prefill_step(params, prompt)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks = [tok]
        tokens_out += sum(1 for g in gens if g >= 1)
        for i in range(wave_gen - 1):
            if streaming and decode_steps % publish_every == 0:
                trainer = drift(trainer, jnp.float32(decode_steps))
                pub_state, msg = publish(pub_state, trainer, layout,
                                         pub_config, pub_key,
                                         resync_every=resync_every)
                wire_bits += message_bits(msg)
                if msg.kind == RESYNC:
                    params = apply_resync(params, layout, msg.bucket)
                    resyncs += 1
                else:
                    params = apply_jit(params, msg.values, msg.indices)
                    deltas += 1
            logits, cache = decode(params, cache, jnp.int32(T + i), tok)
            if temperature > 0:
                key, sk = jax.random.split(key)
                tok = jax.random.categorical(
                    sk, logits[:, -1] / temperature).astype(
                        jnp.int32)[:, None]
            else:
                tok = jnp.argmax(logits[:, -1],
                                 axis=-1).astype(jnp.int32)[:, None]
            toks.append(tok)
            decode_steps += 1
            emitted = sum(1 for g in gens if g >= i + 2)
            tokens_out += emitted
            slot_busy += emitted
            slot_steps += B
        waves_tokens.append(np.asarray(jnp.concatenate(toks, axis=1)))
        done += nact
        wave += 1
    out = {"tokens": waves_tokens, "done": done, "requests": requests,
           "waves": wave, "tokens_out": tokens_out,
           "decode_steps": decode_steps, "deltas": deltas,
           "resyncs": resyncs, "wire_bits": wire_bits,
           "slot_util": slot_busy / max(1, slot_steps)}
    if streaming:
        out.update(staleness=float(jnp.linalg.norm(pub_state["resid"])),
                   wire_mib=wire_bits / 8 / 2 ** 20,
                   pub=np.asarray(pub_state["pub"]),
                   params=jax.tree.map(np.asarray, params))
    return out
