"""Subprocess body for tests/test_torch_tp.py and
tests/test_torch_checkpoint.py: one rank of a ``torchrun``-style
tensor-parallel launch (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` from the environment).

``python tests/_torch_tp_pg.py OUT CASES.json`` runs, for each case
``{"name", "argv"}`` of the JSON list, the port's trainer on the
2-layer config of ``tests/_torch_dist_ref.py`` (on its arch's smoke
variant when ``argv`` has ``--smoke``; ``argv`` plus ``--device cpu
--checkpoint OUT/<name>.npz``) with a ``MASTER_PORT`` that rank 0 takes
just before the case (:func:`_case_port`), and on rank 0 writes the
step records to ``OUT/<name>.json``.  A case
named ``bitwise`` (its ``argv`` the mesh and the compressor) instead
holds the relayout and the compression of one shared random gradient
against the one-process bucket of every model row, bitwise, checks that
the loss and the replicated leaves' gradients are the same bits on every
model rank, and raises on a difference; one named ``archs`` holds the
loss and gradients on the shards of other archs (the other dense paths,
a biased config, and the MoE, Mamba and xLSTM blocks with nonzero
biases) against the whole model's; one named ``remat`` holds the loss
and gradients on the shards with each layer-pattern period
rematerialised bitwise those without (``tests/test_torch_remat.py``);
one named ``actshard`` holds them with ``shard_activations`` bitwise
those without and each period's saved input model-sharded
(``tests/test_torch_shard_activations.py``); one named ``tuning``
resolves kernel configs in the process group
(``tests/test_torch_tuning.py``).  A case with a ``reduced`` arch name
trains that arch's smoke variant given as ``cfg``, so that ``--smoke``
in its ``argv`` switches the rematerialisation off and nothing else;
one with ``"shard_activations": true`` trains its config with that
option set.
:func:`launch` starts such a launch from a test.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.compression import CompressionConfig
from repro_torch.dist import aggregate
from repro_torch.dist.layout import build_layout, pack_grads
from repro_torch.dist.tensor_parallel import TensorParallel
from repro_torch.dist.wire import ProcessGroupWire, init_process_group
from repro_torch.launch import train as cli
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models import ModelConfig, init_params, loss_fn

CFG = ModelConfig(name="t", arch_type="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128,
                  vocab_size=64).validate()
# the replicated vectors that the column-parallel blocks take a slice of
# (attention's, xLSTM's and Mamba's)
BIASES = ("bq", "bk", "bv", "bo", "bi", "bf", "bz", "conv_b", "dt_bias", "D")


def bitwise(mesh, compressor, ratio, policy):
    """One shared gradient: the TP rank's row (relayout of its shards),
    its compression and the inverse relayout against the one-process
    ``(M, d_row_total)`` bucket's row, bitwise."""
    init_process_group("gloo", rank=int(os.environ["RANK"]),
                       world_size=int(os.environ["WORLD_SIZE"]))
    try:
        params = init_params(CFG, 0, "cpu")
        tp = TensorParallel(CFG, ProcessGroupWire(parse_mesh(mesh)), params)
        axis = tp.axis
        M, r = axis.size, axis.rank
        comp = CompressionConfig(compressor=compressor, ratio=ratio)
        layout = build_layout(params, M, comp)
        rng = np.random.default_rng(7)
        grads = tree.tree_map(lambda p: torch.from_numpy(
            rng.standard_normal(tuple(p.shape)).astype(np.float32)), params)
        E = torch.from_numpy((0.1 * rng.standard_normal(
            (M, layout.d_row_total))).astype(np.float32))
        full = pack_grads(layout, tree.leaves(grads), torch.float32)
        rows = tp.rows(layout)
        local = tree.leaves(tp.shard(grads))
        mine = rows.pack(layout, 0, local, torch.float32)
        assert torch.equal(mine[0], full[r]), "relayout into the row"
        back = rows.unpack(layout, 0, full[r:r + 1], local)
        for a, b in zip(back, local):
            assert torch.equal(a, b), "relayout back into the shards"
        spec = comp.spec
        if policy:
            # the allocation from every row's pass A, as one process
            one = E + full
            _, moments = aggregate._pass_a(one, layout, spec, True)
            st, tp_moments = aggregate._pass_a(E[r:r + 1] + mine, layout,
                                               spec, True, rows)
            assert tp_moments == moments, "pass A over the model group"
            k = np.asarray([max(1, s.k_row * M // 2)
                            for s in layout.segments], np.int32)
            kw = dict(k_alloc=k)
        else:
            kw = {}
        want = aggregate.bucket_compress(full, E.clone(), layout, spec,
                                         **kw)
        got = aggregate.bucket_compress(mine, E[r:r + 1].clone(), layout,
                                        spec, row=r, **kw)
        for a, b, what in zip(got, want, ("values", "indices", "e'")):
            assert torch.equal(a[0], b[r]), what
        assert torch.equal(rows.total(aggregate.codec.nnz(got[1]).float()),
                           aggregate.codec.nnz(want[1]).float()), "nnz"
        # the forward and backward on the shards: every model rank holds
        # the same loss and the same gradient of each replicated leaf
        ps = [p.requires_grad_(True) for p in tree.leaves(
            tp.shard(params))]
        toks = torch.from_numpy(rng.integers(0, CFG.vocab_size, (2, 8)))
        loss, _ = loss_fn(tree.unflatten(tree.flatten(params)[1], ps),
                          CFG, {"tokens": toks, "labels": toks.roll(-1, 1)},
                          axis)
        gs = torch.autograd.grad(loss, ps)
        for t in [loss.detach()] + [g for g, pl in zip(gs, tp.placements)
                                    if pl.replicated]:
            every = axis.gather(t)
            assert all(torch.equal(every[0], x) for x in every), \
                "replicated on every model rank"
    finally:
        torch.distributed.destroy_process_group()


def archs(mesh, names):
    """``model.loss_fn`` on the shards of the smoke variants of ``names``
    (sliding-window attention, the parallel block, the ``embeds``
    frontend, the MoE, Mamba and xLSTM blocks; a name ending ``+bias``
    with the biased projections; every vector of ``BIASES`` made
    nonzero) against it on the whole params: the loss within rtol 1e-5, every
    gathered gradient within rtol 1e-4 / atol 1e-6 (the all-reduces sum
    in another order)."""
    from repro_torch.configs import get_config
    from repro_torch.dist.tensor_parallel import gather_leaf
    init_process_group("gloo", rank=int(os.environ["RANK"]),
                       world_size=int(os.environ["WORLD_SIZE"]))
    try:
        wire = ProcessGroupWire(parse_mesh(mesh))
        for name in names:
            arch, _, bias = name.partition("+")
            cfg = get_config(arch).reduced(use_bias=bool(bias))
            params = init_params(cfg, 0, "cpu")
            gen = torch.Generator().manual_seed(3)
            for path, p in tree.flatten_with_path(params)[0]:
                if path[-1] in BIASES:
                    # nonzero biases, so that each rank's slice matters
                    p.add_(0.01 * torch.randn(p.shape, generator=gen))
            tp = TensorParallel(cfg, wire, params)
            axis = tp.axis
            rng = np.random.default_rng(1)
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
            batch = {"labels": toks.roll(-1, 1)}
            if cfg.frontend == "embeds":
                batch["embeds"] = torch.from_numpy(rng.standard_normal(
                    (2, 8, cfg.d_model)).astype(np.float32))
            else:
                batch["tokens"] = toks
            leaves, td = tree.flatten(params)
            full = [p.clone().requires_grad_(True) for p in leaves]
            want, _ = loss_fn(tree.unflatten(td, full), cfg, batch)
            wgrads = torch.autograd.grad(want, full, allow_unused=True)
            ps = [p.requires_grad_(True) for p in tree.leaves(
                tp.shard(params))]
            got, _ = loss_fn(tree.unflatten(td, ps), cfg, batch, axis)
            grads = torch.autograd.grad(got, ps, allow_unused=True)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                       err_msg=name)
            for g, w, pl, p, whole in zip(grads, wgrads, tp.placements, ps,
                                          leaves):
                g = torch.zeros_like(p) if g is None else g
                w = torch.zeros_like(whole) if w is None else w
                np.testing.assert_allclose(
                    gather_leaf(g, pl, axis).numpy(), w.numpy(),
                    rtol=1e-4, atol=1e-6, err_msg=name)
    finally:
        torch.distributed.destroy_process_group()


def remat(mesh, names):
    """On the shards of the smoke variants of ``names``, the loss, the
    MoE aux loss and every gradient of ``model.loss_fn(remat=True)``
    bitwise those of ``remat=False``: the recompute re-issues each
    period's forward all-reduces inside the backward, in the same order
    on every rank."""
    from repro_torch.configs import get_config
    init_process_group("gloo", rank=int(os.environ["RANK"]),
                       world_size=int(os.environ["WORLD_SIZE"]))
    try:
        wire = ProcessGroupWire(parse_mesh(mesh))
        for name in names:
            cfg = get_config(name).reduced()
            params = init_params(cfg, 0, "cpu")
            tp = TensorParallel(cfg, wire, params)
            rng = np.random.default_rng(5)
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
            batch = {"labels": toks.roll(-1, 1)}
            if cfg.frontend == "embeds":
                batch["embeds"] = torch.from_numpy(rng.standard_normal(
                    (2, 8, cfg.d_model)).astype(np.float32))
            else:
                batch["tokens"] = toks
            shards, td = tree.flatten(tp.shard(params))
            out = []
            for on in (False, True):
                ps = [p.clone().requires_grad_(True) for p in shards]
                loss, m = loss_fn(tree.unflatten(td, ps), cfg, batch,
                                  tp.axis, remat=on)
                grads = torch.autograd.grad(loss, ps, allow_unused=True)
                out.append([loss.detach(), m["aux"].detach()] + [
                    torch.zeros_like(p) if g is None else g
                    for p, g in zip(ps, grads)])
            for a, b in zip(*out):
                assert torch.equal(a, b), (name, "remat changed a bit")
    finally:
        torch.distributed.destroy_process_group()


def actshard(mesh, names):
    """On the shards of the 2-layer config and of the smoke variants of
    ``names``, ``model.loss_fn(remat=True)`` with ``shard_activations``
    against it without: the loss and every gradient bitwise; and each
    checkpoint's input, as its own saved tensor, this rank's ``d_model
    / M`` slice of the period's ``h``, in a storage of its own size."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as mdl
    init_process_group("gloo", rank=int(os.environ["RANK"]),
                       world_size=int(os.environ["WORLD_SIZE"]))
    try:
        wire = ProcessGroupWire(parse_mesh(mesh))
        for name in ["dense"] + list(names):
            cfg = CFG if name == "dense" else get_config(name).reduced()
            params = init_params(cfg, 0, "cpu")
            tp = TensorParallel(cfg, wire, params)
            M = tp.axis.size
            rng = np.random.default_rng(9)
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
            batch = {"labels": toks.roll(-1, 1)}
            if cfg.frontend == "embeds":
                batch["embeds"] = torch.from_numpy(rng.standard_normal(
                    (2, 8, cfg.d_model)).astype(np.float32))
            else:
                batch["tokens"] = toks
            shards, td = tree.flatten(tp.shard(params))
            out = []
            for on in (False, True):
                c = dataclasses.replace(cfg, shard_activations=on)
                ps = [p.clone().requires_grad_(True) for p in shards]
                carries, saved = [], {}
                real = mdl.checkpoint

                def spy(fn, h, *a, **k):
                    carries.append(h)
                    return real(fn, h, *a, **k)

                def pack(t):
                    saved[id(t)] = t.untyped_storage().nbytes()
                    return t

                mdl.checkpoint = spy
                try:
                    with torch.autograd.graph.saved_tensors_hooks(
                            pack, lambda t: t):
                        loss, m = loss_fn(tree.unflatten(td, ps), c, batch,
                                          tp.axis, remat=True)
                finally:
                    mdl.checkpoint = real
                reps = cfg.num_layers // cfg.pattern_period
                assert len(carries) == reps, (name, len(carries))
                width = cfg.d_model // M if on else cfg.d_model
                for h in carries:
                    assert h.shape == (2, 8, width), (name, on, h.shape)
                    assert saved.get(id(h)) == h.numel() * h.element_size(), \
                        (name, on, "the carry is saved in its own storage")
                del carries, saved
                grads = torch.autograd.grad(loss, ps, allow_unused=True)
                out.append([loss.detach(), m["aux"].detach()] + [
                    torch.zeros_like(p) if g is None else g
                    for p, g in zip(ps, grads)])
            for a, b in zip(*out):
                assert torch.equal(a, b), (name, "shard_activations "
                                           "changed a bit")
    finally:
        torch.distributed.destroy_process_group()


def tuning(out, table_dir):
    """Kernel configs resolved in a gloo group of ``WORLD_SIZE``: before
    the group, a stub timer that prefers a different candidate on each
    rank picks different winners; inside it, a class missing from the
    table (``table_dir``) resolves to the heuristic on every rank
    without timing anything, a class in it to the table's row; rank 0
    writes every rank's picks to ``out/tuning.json``."""
    from repro_torch.kernels.ef_fused import tuning as tn
    os.environ[tn.ENV_TABLE_DIR] = table_dir
    rank = int(os.environ["RANK"])
    calls = []

    def timer(cfg, d):
        calls.append(cfg)
        # each rank scores a different candidate fastest
        best = tn.candidates(d)[rank % len(tn.candidates(d))]
        return 0.0 if cfg == best else 1.0

    alone = tn.resolve_config(5000, "cuda", measure=True, timer=timer)
    n_alone = len(calls)
    tn.clear_cache()
    init_process_group("gloo", rank=rank,
                       world_size=int(os.environ["WORLD_SIZE"]))
    try:
        shared = tn.resolve_config(5000, "cuda", measure=True, timer=timer)
        pinned = tn.resolve_config(70000, "cuda", measure=True, timer=timer)
        mine = {"alone": alone.to_dict(), "timed_alone": n_alone,
                "shared": shared.to_dict(), "pinned": pinned.to_dict(),
                "timed_shared": len(calls) - n_alone}
        every = [None] * int(os.environ["WORLD_SIZE"])
        torch.distributed.all_gather_object(every, mine)
        if rank == 0:
            with open(os.path.join(out, "tuning.json"), "w") as f:
                json.dump(every, f)
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _case_port(out, index: int) -> int:
    """Case ``index``'s ``MASTER_PORT``: rank 0 takes a free port just
    before the case and writes it to ``out``, the other ranks read it.
    A port taken minutes ahead may be in use by then (another launch's
    store, or one end of a gloo connection), and a rank whose store
    cannot bind leaves the others waiting for it."""
    path = os.path.join(out, f"port.{os.environ['TP_LAUNCH']}.{index}")
    if os.environ["RANK"] == "0":
        with open(path + ".tmp", "w") as f:
            f.write(str(_free_port()))
        os.replace(path + ".tmp", path)
    deadline = time.time() + 120
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(f"no port for case {index} from rank 0")
        time.sleep(0.05)
    with open(path) as f:
        return int(f.read())


def launch(out, procs: int, cases: list, timeout: float = 300) -> list:
    """Run ``cases`` (``{"name", "argv"}``) in ``procs`` gloo processes
    writing to ``out``; returns their logs and fails unless every
    process exits 0 (at once, killing the others, when one fails)."""
    path = os.path.join(str(out), "cases.json")
    with open(path, "w") as f:
        json.dump(cases, f)
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    running, logs = [], []
    token = f"{os.getpid()}-{time.time_ns()}"   # this launch's port files
    for r in range(procs):
        env = dict(os.environ, PYTHONPATH=src, RANK=str(r),
                   WORLD_SIZE=str(procs), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(procs), MASTER_ADDR="127.0.0.1",
                   OMP_NUM_THREADS="1", TP_LAUNCH=token)
        # output to a file: a pipe nobody reads while we poll can fill
        logs.append(open(os.path.join(str(out), f"rank{r}.log"), "w+"))
        running.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(out), path],
            env=env, stdout=logs[-1], stderr=subprocess.STDOUT, text=True))
    deadline = time.time() + timeout
    while any(p.poll() is None for p in running):
        failed = any(p.poll() not in (None, 0) for p in running)
        if failed or time.time() > deadline:
            for p in running:
                p.kill()
            break
        time.sleep(0.2)
    for p in running:
        p.wait()
    for i, f in enumerate(logs):
        f.seek(0)
        logs[i] = f.read()
        f.close()
    for p, log in zip(running, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def main(out, cases_path):
    torch.set_num_threads(1)
    with open(cases_path) as f:
        cases = json.load(f)
    for index, case in enumerate(cases):
        os.environ["MASTER_PORT"] = str(_case_port(out, index))
        if case["name"] in ("bitwise", "archs", "remat", "actshard"):
            {"bitwise": bitwise, "archs": archs, "remat": remat,
             "actshard": actshard}[case["name"]](*case["argv"])
            continue
        if case["name"] == "tuning":
            tuning(out, *case["argv"])
            continue
        name = case["name"]
        # a case with --smoke trains its arch's smoke variant; one with
        # "reduced" that variant given as cfg (--smoke: remat off)
        cfg = None if "--smoke" in case["argv"] else CFG
        if "reduced" in case:
            from repro_torch.configs import get_config
            cfg = get_config(case["reduced"]).reduced()
        if case.get("shard_activations"):
            cfg = dataclasses.replace(cfg, shard_activations=True)
        recs = cli.run(case["argv"] + [
            "--device", "cpu", "--checkpoint",
            os.path.join(out, name + ".npz")], cfg=cfg)
        if os.environ["RANK"] == "0":
            with open(os.path.join(out, name + ".json"), "w") as f:
                json.dump(recs, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
