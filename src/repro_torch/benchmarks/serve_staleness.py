"""Train-to-serve delta streaming (port of the JAX package's
``benchmarks/serve_staleness.py``).  Rows ``(name, us_per_call,
derived)``, the reference's names and shapes:

* ``delta-wire-r{ratio}/L6-M2`` — wire bits of ONE delta publish at
  publish ratios 0.002, 0.01, 0.05, from the layout's geometry (six
  leaves, model size 2); they do not depend on the machine, and the
  reference's are pinned in ``benchmarks/baselines/serve.json``.
* ``resync-exact`` — 1 iff the replica equals the trainer bitwise at
  every resync of a 12-tick stream and ``pub`` equals the packed
  replica bitwise at every tick.
* ``gap-vs-resid`` — 1 iff the staleness ``pack(trainer) -
  pack(replica)`` equals the publisher's residual within 1e-5 at every
  delta.
* ``tokens-frozen`` / ``tokens-streaming`` on the ``sv`` config
  (2 layers, d_model 64), batch 4, a 16-token prompt, 8 (smoke) or 32
  tokens a sequence: decode with frozen weights against a delta
  published and applied every other decode step, the layout at model
  size 2.  The reference shards this over a (4, 2) mesh; here one
  device computes it (the layout keeps its two rows), so the rows are
  the same geometry and its own times.

``run()`` only reports; ``python -m
repro_torch.benchmarks.serve_staleness --json PATH`` writes the
document (schema ``serve/v1``: rows of ``{shape, method, passes,
ms}``), and only to ``PATH``.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import prng, tree
from repro_torch.benchmarks.common import stamp_meta
from repro_torch.core.compression import CompressionConfig
from repro_torch.devices import resolve_device
from repro_torch.dist.layout import build_layout, pack_grads
from repro_torch.launch.serve import drift
from repro_torch.models import ModelConfig, init_params
from repro_torch.serve import (RESYNC, apply_message, init_publisher_state,
                               make_apply_delta, make_decode_step,
                               make_prefill_step, message_bits, publish)

# the JAX benchmark's artifact, named in the report row so the two
# packages' rows line up; this module never writes it
REFERENCE_ARTIFACT = "BENCH_serve.json"
SCHEMA = "serve/v1"
RATIOS = (0.002, 0.01, 0.05)
PUBLISH_TICKS = 12
RESYNC_EVERY = 4


def _stream_rows(device):
    """Publisher/subscriber invariants and per-ratio wire bits over a
    simulated publish stream."""
    msize = 2
    key = prng.PRNGKey(0)
    params = {f"layer{i}": 0.1 * prng.normal(prng.fold_in(key, i),
                                             (96 + 16 * i,), device=device)
              for i in range(6)}
    shape = f"L6-M{msize}"
    rows, bench = [], []
    exact, gap_ok = 1, 1
    for ratio in RATIOS:
        config = CompressionConfig(compressor="topk", ratio=ratio,
                                   backend="reference")
        layout = build_layout(params, msize, config)
        st = init_publisher_state(layout, device=device)
        replica = tree.tree_map(torch.zeros_like, params)
        trainer = params
        delta_bits = 0
        for t in range(PUBLISH_TICKS):
            trainer = tree.tree_map(
                lambda x, s=t: x + 0.01 * torch.sin(x * float(s + 1)),
                trainer)
            st, msg = publish(st, trainer, layout, config, key,
                              resync_every=RESYNC_EVERY)
            replica = apply_message(replica, layout, msg)
            P = pack_grads(layout, trainer, torch.float32)
            R = pack_grads(layout, replica, torch.float32)
            if msg.kind == RESYNC:
                for a, b in zip(tree.leaves(replica), tree.leaves(trainer)):
                    if not torch.equal(a, b):
                        exact = 0
            else:
                delta_bits = message_bits(msg)
                if not torch.allclose(P - R, st["resid"], rtol=0,
                                      atol=1e-5):
                    gap_ok = 0
            if not torch.equal(st["pub"], R):
                exact = 0   # pub must track the replica bitwise always
        bench.append({"shape": shape, "method": f"delta-wire-r{ratio}",
                      "passes": delta_bits, "ms": 0.0})
        rows.append((f"serve/delta-wire-r{ratio}/{shape}", 0.0,
                     f"bits={delta_bits}"))
    bench.append({"shape": shape, "method": "resync-exact",
                  "passes": exact, "ms": 0.0})
    bench.append({"shape": shape, "method": "gap-vs-resid",
                  "passes": gap_ok, "ms": 0.0})
    rows.append((f"serve/resync-exact/{shape}", 0.0, f"exact={exact}"))
    rows.append((f"serve/gap-vs-resid/{shape}", 0.0, f"ok={gap_ok}"))
    return rows, bench


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _decode_rows(smoke: bool, device):
    """Decode throughput, frozen weights against a delta ingested every
    other decode step."""
    cfg = ModelConfig(name="sv", arch_type="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=64).validate()
    key = prng.PRNGKey(0)
    B, T = 4, 16
    gen = 8 if smoke else 32
    s_max = T + gen
    trainer = init_params(cfg, 0, device)
    config = CompressionConfig(compressor="topk", ratio=0.01)
    layout = build_layout(trainer, 2, config)
    prefill_step = make_prefill_step(cfg, device, s_max=s_max)
    decode = make_decode_step(cfg, device)
    apply_delta = make_apply_delta(layout, device)
    prompt = prng.randint(key, (B, T), 0, cfg.vocab_size, device=device)
    shape = f"{cfg.name}-B{B}-g{gen}"
    rows, bench, times = [], [], {}
    for method in ("tokens-frozen", "tokens-streaming"):
        params = tree.tree_map(torch.clone, trainer)
        st = init_publisher_state(layout, device=device)
        logits, cache = prefill_step(params, prompt)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        _sync(device)
        tr = trainer
        t0 = time.perf_counter()
        for i in range(gen - 1):
            if method == "tokens-streaming" and i % 2 == 0:
                tr = drift(tr, i)
                st, msg = publish(st, tr, layout, config, key,
                                  resync_every=RESYNC_EVERY)
                params = (apply_message(params, layout, msg)
                          if msg.kind == RESYNC else
                          apply_delta(params, msg.values, msg.indices))
            logits, cache = decode(params, cache, T + i, tok)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        toks = B * gen
        times[method] = ms
        bench.append({"shape": shape, "method": method, "passes": toks,
                      "ms": round(ms, 3)})
        rows.append((f"serve/{method}/{shape}", round(ms, 1),
                     f"tokens={toks};tok_s={toks / (ms / 1e3):.1f}"))
    ratio_t = times["tokens-streaming"] / times["tokens-frozen"]
    rows.append((f"serve/stream-ratio/{shape}", 0.0,
                 f"streaming_vs_frozen={ratio_t:.3f}x"))
    return rows, bench


def collect(smoke: bool = False, device="cuda"):
    device = resolve_device(device)
    with torch.no_grad():
        s_rows, s_bench = _stream_rows(device)
        d_rows, d_bench = _decode_rows(smoke, device)
    return (s_rows + d_rows,
            stamp_meta({"schema": SCHEMA, "smoke": smoke,
                        "rows": s_bench + d_bench}))


def run(smoke: bool = False, device="cuda"):
    # harness entry point: report only
    rows, data = collect(smoke, device)
    rows.append((f"serve/{REFERENCE_ARTIFACT}", 0.0,
                 f"rows={len(data['rows'])};smoke={smoke};not-written"))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="short decode loop")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None,
                    help="write the result document to this path "
                         "(default: write nothing)")
    args = ap.parse_args(argv)
    rows, data = collect(args.smoke, args.device)
    for r in rows:
        print(",".join(str(x) for x in r), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(data, f, indent=1)
        print(f"wrote {args.json} ({len(data['rows'])} rows)")


if __name__ == "__main__":
    main()
