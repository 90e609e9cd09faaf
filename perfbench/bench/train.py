"""A training cell: the program's train step built as its trainer builds
it, driven from the seed through its first steps (the readings the
comparison takes), then handed, the same object, to the timed window.

The program is ``repro_torch``: ``make_train_step`` over the bucketed
pipeline in one chunk, ``init_train_state`` with the configuration's
residual dtype, SGD with momentum at a constant rate, remat on, and a
``LocalWire`` on one card or a ``ProcessGroupWire`` over NCCL with one
process a card.  The harness hands it weights and batches it made from
the seed, and takes from it only its step, its probe and its state."""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from perfbench.bench import trace as tracing
from perfbench.bench.probe import SYNC_SPAN, Probe, Span
from perfbench.bench.spec import Cell, model_config
from perfbench.bench.traffic import make_ring
from perfbench.bench.weights import make_leaf, make_weights
from perfbench.reference.model import param_shapes

FIRST_STEPS = 3


@dataclasses.dataclass
class Window:
    """What a run measured: the window's steps (host seconds each, the
    profiled ones flagged), its length, the probe's layer times, the
    trace's reduction, the program's counters."""
    step_s: list
    profiled: list
    window_s: float
    layer_ms: dict
    trace: dict
    counters: dict


def half_mask(labels: torch.Tensor) -> torch.Tensor:
    """The ``half_batch`` fault's loss mask: each row's second half out,
    the mean taken over the rest."""
    m = torch.ones_like(labels, dtype=torch.float32)
    m[:, labels.shape[1] // 2:] = 0.0
    return m


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Lonely:
    """The ``no_exchange`` fault: a wire whose gathers of the pairs bring
    back this worker's own pairs, once for every worker."""

    def __init__(self, wire):
        self.real = wire.all_gather
        self.wire = wire

    def __call__(self, xs, axis, async_op: bool = False):
        if not isinstance(xs[0], tuple):
            return self.real(xs, axis, async_op=async_op)
        n = self.wire.axis_size(axis)
        out = [tuple(torch.stack([t] * n) for t in x) for x in xs]

        class Done:
            def wait(self):
                return out
        return Done() if async_op else out


class Program:
    """The program's step and state for one cell on this process.

    ``fault`` breaks the timed path underneath, for the checks that
    ``correct`` catches it: ``"stale"`` (a step that returns its state
    unchanged), ``"half_batch"`` (half of each row left out of the loss,
    the mean taken over the rest) or ``"no_exchange"`` (the gathers of
    the pairs bring back this worker's own, once for every worker)."""

    def __init__(self, cell: Cell, seed: int, device, rank: int = 0,
                 world: int = 1, probe: Optional[Probe] = None,
                 fault: Optional[str] = None):
        from repro_torch import tree
        from repro_torch.core.compression import CompressionConfig
        from repro_torch.core.compressors import get_compressor
        from repro_torch.dist.layout import build_layout
        from repro_torch.dist.wire import LocalWire, ProcessGroupWire
        from repro_torch.launch.mesh import parse_mesh
        from repro_torch.models import init_params
        from repro_torch.models import loss_fn as model_loss
        from repro_torch.optim import constant, sgd_momentum
        from repro_torch.train import init_train_state, make_train_step

        self.cell, self.seed, self.device = cell, seed, device
        self.rank, self.world = rank, world
        cfg = model_config(cell.config)
        tr = cell.config["train"]
        if tr["optimizer"] != "sgd_momentum" or tr["density"] != "fixed-k":
            raise SystemExit("this harness trains fixed-k SGD with momentum")
        pairs, td = tree.flatten_with_path(init_params(cfg, device="meta"))
        self.shapes = [(tree.path_name(p), tuple(x.shape)) for p, x in pairs]
        if self.shapes != param_shapes(cell.config["model"]):
            raise SystemExit("the program's parameter tree is not the "
                             "reference's")
        self.pdt = getattr(torch, cfg.param_dtype)
        w = make_weights(seed, self.shapes, self.pdt, device)
        params = tree.unflatten(td, [w[n] for n, _ in self.shapes])
        del w
        self.layout = build_layout(params, 1, tr["ratio"],
                                   get_compressor(tr["compressor"]))
        config = CompressionConfig(compressor=tr["compressor"],
                                   ratio=tr["ratio"],
                                   strategy=tr["strategy"],
                                   chunks=tr["chunks"])
        mesh = parse_mesh(f"{world}x1")
        self.wire = LocalWire(mesh) if world == 1 else ProcessGroupWire(mesh)
        if fault == "no_exchange":
            self.wire.all_gather = _Lonely(self.wire)
        opt = sgd_momentum(tr["momentum"])
        self.state = init_train_state(
            params, opt, workers=self.wire.local_workers, model_size=1,
            compression=config, resid_dtype=getattr(torch,
                                                    tr["resid_dtype"]),
            layout=self.layout)
        self.step = make_train_step(cfg, mesh, opt, constant(tr["lr"]),
                                    compression=config, layout=self.layout,
                                    probe=probe, wire=self.wire, seed=seed,
                                    remat=tr["remat"])
        if fault == "stale":
            def stale(state, batch):
                per = batch["tokens"].shape[0] // world
                rows = slice(rank * per, (rank + 1) * per)
                with torch.no_grad():
                    l, _ = model_loss(state["params"], cfg,
                                      {k: v[rows] for k, v in batch.items()},
                                      remat=False)
                return state, {"loss": self.wire.pmean(
                    [l], self.wire.data_axes)[0]}
            self.step = stale
        self.ring = make_ring(seed, cell.traffic, cfg.vocab_size, device)
        if fault == "half_batch":
            for b in self.ring:
                b["loss_mask"] = half_mask(b["labels"])
        self.names = [n for n, _ in self.shapes]
        self.steps_done = 0
        self.metrics = {}

    def run_step(self) -> None:
        batch = self.ring[self.steps_done % len(self.ring)]
        self.state, self.metrics = self.step(self.state, batch)
        self.steps_done += 1

    def leaf_norms(self, leaves) -> dict:
        return {n: float(x.float().norm()) for n, x in zip(self.names,
                                                           leaves)}

    def first_steps(self) -> dict:
        """Steps 1-3 through the window's own call and feed, with the
        readings the comparison takes."""
        from repro_torch import tree
        out = {"loss": []}
        for t in range(FIRST_STEPS):
            self.run_step()
            out["loss"].append(float(self.metrics["loss"]))
            if t == 0:
                out["grad"] = self.leaf_norms(
                    tree.leaves(self.state["opt"]["m"]))
                resid = self.state["resid"][0]
                out["resid"] = {s.name: float(resid[s.row_off:s.row_off
                                                    + s.size].float().norm())
                                for s in self.layout.segments}
        leaves = tree.leaves(self.state["params"])
        out["update"] = {}
        with torch.no_grad():
            for i, ((n, shape), x) in enumerate(zip(self.shapes, leaves)):
                p0 = make_leaf(self.seed, i, n, shape, self.pdt, self.device)
                out["update"][n] = float((x.float() - p0.float()).norm())
        _sync(self.device)
        return out

    def counters(self) -> dict:
        m = self.metrics
        return {k: float(m[k]) for k in ("comm_bits_sparse",
                                          "comm_bits_dense",
                                          "collectives_per_step", "density")
                if k in m}

    def free(self) -> None:
        self.state = self.step = self.ring = self.layout = None
        self.metrics = {}


def _stop(elapsed: float, seconds: float, world: int, device) -> bool:
    """Whether the window is over, agreed by every rank (the slowest's
    clock decides)."""
    if world == 1:
        return elapsed >= seconds
    import torch.distributed as dist
    t = torch.tensor([elapsed], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t) >= seconds


def window(program: Program, seconds: float, trace: bool,
           probe: Optional[Probe], on_open=None) -> Window:
    """Closed-loop steps for ``seconds``: each step starts when the last
    has ended on the device.  With ``trace``, the probe marks every step
    and the profiler covers ``profile_steps`` of them from
    ``profile_after`` on."""
    dev, traffic = program.device, program.cell.traffic
    after = int(traffic.get("profile_after", 2))
    count = int(traffic.get("profile_steps", 3))
    prof, events = None, None
    step_s, profiled = [], []
    if probe is not None:
        probe.steps = []
    if on_open is not None:
        on_open()
    t0 = time.perf_counter()
    i = 0
    while True:
        in_prof = trace and after <= i < after + count
        if trace and i == after:
            prof = tracing.profiler(dev)
            prof.__enter__()
        ts = time.perf_counter()
        if probe is not None:
            probe.begin()
        program.run_step()
        if probe is not None:
            probe.end()
        span = Span(SYNC_SPAN)
        _sync(dev)
        span.close()
        te = time.perf_counter()
        step_s.append(te - ts)
        profiled.append(in_prof)
        i += 1
        if prof is not None and i == after + count:
            prof.__exit__(None, None, None)
            events = tracing.export_events(prof, program.rank)
            prof = None
        if _stop(te - t0, seconds, program.world, dev) and (
                not trace or i >= after + count):
            break
    window_s = time.perf_counter() - t0
    skip = {j for j, p in enumerate(profiled) if p}
    layer_ms = probe.layer_ms(skip) if probe is not None else {}
    red = tracing.reduce_trace(events, count) if events else {}
    return Window(step_s, profiled, window_s, layer_ms, red,
                  program.counters())
