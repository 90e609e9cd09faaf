"""Subprocess body for tests/test_torch_serve_placement.py: one rank of a
``torchrun``-style launch (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` from the environment) that serves
or trains placed over the mesh, on the CPU over gloo.

``python tests/_torch_serve_pg.py OUT CASES.json`` runs, for each case
``{"name", "kind", "argv", "port"}`` of the JSON list, with that
``MASTER_PORT``:

* ``kind == "serve"``: ``launch.serve.run(argv + ["--device", "cpu"])``
  (the smoke variant of ``argv``'s arch; with ``"window"``, its sliding
  window cut to that). Every rank checks, after each delta, that its
  pieces are bitwise the cut of a whole replica that applied the same
  messages in one process (``apply_message`` without a placement), after
  each resync that the gathered pieces are the trainer's params (on rank
  0, which holds them), and after each message that the gathered pieces
  pack to the publisher's ``pub`` bitwise; rank 0 writes the tokens, the
  counters, the number of publishes checked and the printed lines to
  ``OUT/<name>.json`` and every step's whole-batch logits to
  ``OUT/<name>.npz``.
* ``kind == "train"``: ``launch.train.run(argv + ["--device", "cpu",
  "--checkpoint", OUT/<name>.npz])`` under tensor parallelism.  After
  each publish every rank gathers the whole params, runs the one-process
  publisher (all ``M`` rows) on them from its own state, and checks that
  its message, ``pub`` and residual are that publisher's row, bitwise,
  and the same on every data replica of its model rank;
  rank 0 writes the step records, the checks and the printed lines to
  ``OUT/<name>.json`` and the one-process publisher's final state to
  ``OUT/<name>-shadow.npz``.  A case with ``"resume"`` resumes from that
  case's checkpoint.

:func:`launch` starts such a launch from a test.
"""
import contextlib
import hashlib
import io
import json
import os
import sys

import numpy as np
import torch

from repro_torch import prng, tree
from repro_torch.configs import get_config
from repro_torch.core.compression import CompressionConfig
from repro_torch.dist.layout import pack_grads
from repro_torch.dist.tensor_parallel import gather_leaf
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import init_params
from repro_torch.serve import (RESYNC, apply_message, init_publisher_state,
                               publish)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_tp_pg import _free_port  # noqa: E402


def gather_params(placed, pieces):
    """Every rank's pieces back into the whole params, on every rank (a
    collective, leaf by leaf): the data pieces concatenated over the
    data group, then the model shards over the model group."""
    pairs, td = tree.flatten_with_path(pieces)
    out = []
    for path, x in pairs:
        place = placed.places[tree.path_name(path)]
        if place.data_dim is not None:
            (g,) = placed.wire.all_gather([x.contiguous()],
                                          placed.wire.data_axes)
            x = torch.cat(list(g.unbind(0)), dim=place.data_dim)
        if placed.axis is not None:
            x = gather_leaf(x, place.pl, placed.axis)
        out.append(x)
    return tree.unflatten(td, out)


def serve_cfg(argv, window=None):
    """The smoke variant of ``argv``'s arch, with a sliding window of
    ``window`` when given (a ring that wraps at the tests' lengths)."""
    import dataclasses
    cfg = get_config(serve_cli._parser().parse_args(argv).arch).reduced()
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window).validate()
    return cfg


def serve_case(out, name, argv, window=None):
    args = serve_cli._parser().parse_args(argv)
    cfg = serve_cfg(argv, window)
    shadow = {"params": init_params(cfg, args.seed, "cpu"), "checked": 0}
    logits = []

    def probe(event, msg, layout, state, trainer, replica, placed):
        gathered = gather_params(placed, replica)
        if msg.kind == RESYNC:
            # rank 0 alone holds the bucket (the others took it a leaf at
            # a time): the gathered pieces are the trainer's params there
            shadow["params"] = gathered
            if trainer is not None:
                for a, b in zip(tree.leaves(gathered),
                                tree.leaves(trainer)):
                    assert torch.equal(a, b), ("resync", msg.seq)
        else:
            shadow["params"] = apply_message(shadow["params"], layout, msg)
        for (path, mine), whole in zip(
                tree.flatten_with_path(replica)[0],
                tree.leaves(shadow["params"])):
            assert torch.equal(mine, placed.cut(path, whole)), (
                "piece", tree.path_name(path), msg.seq)
        if state is not None:
            assert torch.equal(pack_grads(layout, gathered, torch.float32),
                               state["pub"]), ("pub", msg.seq)
        shadow["checked"] += 1

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = serve_cli.run(argv + ["--device", "cpu"], probe=probe,
                            cfg=cfg, on_logits=lambda w, s, x: logits.append(
                                x.numpy().copy()))
    if os.environ["RANK"] == "0":
        rec = {k: v for k, v in got.items() if k not in ("tokens", "times")}
        rec.update(tokens=[t.tolist() for t in got["tokens"]],
                   checked=shadow["checked"], out=buf.getvalue(),
                   gathers=len(got["times"].get("gather_decode", [])))
        with open(os.path.join(out, name + ".json"), "w") as f:
            json.dump(rec, f)
        np.savez(os.path.join(out, name + ".npz"), *logits)


def train_case(out, name, argv, resume=None):
    args = train_cli.parse_args(argv)
    config = CompressionConfig(compressor="topk", ratio=args.publish_ratio,
                               backend=args.backend)
    key = prng.fold_in(prng.PRNGKey(args.seed), 0x9B)
    shadow = {"checked": 0}

    def on_publish(msg, layout, state, params, tp):
        whole = [gather_leaf(p, pl, tp.axis) for p, pl in
                 zip(tree.leaves(params), tp.placements)]
        if "state" not in shadow:
            shadow["state"] = init_publisher_state(layout, device="cpu")
            if resume:
                with np.load(os.path.join(out, resume + ".npz")) as ck:
                    for k in ("pub", "resid"):
                        shadow["state"][k].copy_(torch.from_numpy(
                            ck[f"publish/{k}"]))
                    shadow["state"]["seq"] = int(ck["publish/seq"])
        shadow["state"], want = publish(
            shadow["state"], whole, layout, config, key,
            resync_every=args.resync_every)
        r = tp.axis.rank
        assert msg.kind == want.kind and msg.seq == want.seq
        for a, b in zip(msg[2:], want[2:]):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a[0], b[r]), ("message row", msg.seq)
        for k in ("pub", "resid"):
            assert torch.equal(state[k][0], shadow["state"][k][r]), (
                k, msg.seq)
        # every data replica of model rank r publishes the same row
        h = hashlib.sha256()
        for x in [x for x in msg[2:] if x is not None] + [state["pub"],
                                                          state["resid"]]:
            h.update(x.numpy().tobytes())
        every = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(every, (r, h.hexdigest()))
        assert all(d == h.hexdigest() for q, d in every if q == r), every
        shadow["checked"] += 1

    extra = ["--device", "cpu", "--checkpoint",
             os.path.join(out, name + ".npz")]
    if resume:
        extra += ["--resume", os.path.join(out, resume + ".npz")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        recs = train_cli.run(argv + extra, on_publish=on_publish)
    if os.environ["RANK"] == "0":
        with open(os.path.join(out, name + ".json"), "w") as f:
            json.dump({"records": recs, "checked": shadow["checked"],
                       "out": buf.getvalue()}, f)
        np.savez(os.path.join(out, name + "-shadow.npz"),
                 **{k: shadow["state"][k].numpy() for k in ("pub",
                                                             "resid")})


def launch(out, procs: int, cases: list, timeout: float = 300) -> list:
    """Run ``cases`` in ``procs`` gloo processes writing to ``out``;
    returns their logs and fails unless every process exits 0."""
    import subprocess
    path = os.path.join(str(out), "cases.json")
    with open(path, "w") as f:
        json.dump([dict(c, port=_free_port()) for c in cases], f)
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    running = []
    for r in range(procs):
        env = dict(os.environ, PYTHONPATH=src, RANK=str(r),
                   WORLD_SIZE=str(procs), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(procs), MASTER_ADDR="127.0.0.1",
                   OMP_NUM_THREADS="1")
        running.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(out), path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = [p.communicate(timeout=timeout)[0] for p in running]
    for p, log in zip(running, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def main(out, cases_path):
    torch.set_num_threads(1)
    with open(cases_path) as f:
        cases = json.load(f)
    for case in cases:
        os.environ["MASTER_PORT"] = str(case["port"])
        if case["kind"] == "serve":
            serve_case(out, case["name"], case["argv"], case.get("window"))
        else:
            train_case(out, case["name"], case["argv"], case.get("resume"))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
