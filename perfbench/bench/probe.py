"""Layer boundaries of a train step, from the program's probe.

``make_train_step(probe=...)`` calls ``probe(rank, release=c)`` when the
backward releases a chunk of gradients (before it is packed and
compressed), ``probe(rank, chunk=c, G=...)`` after each compression and
``probe(None, means=...)`` once the wire's means are unpacked.  The
harness marks the step's start and end.  Each mark records a CUDA event
on the current stream (a host time on the CPU), so a layer's time is the
device's between two marks; the compression is also a
``record_function`` range, opened at the release and closed after the
compression on the same thread, by which the trace reader attributes
the kernels launched inside it."""
from __future__ import annotations

import threading
import time

import torch

COMPRESS_SPAN = "pb.compress"
STEP_SPAN = "pb.step"
SYNC_SPAN = "pb.sync"

# (name, from mark, to mark) of each layer's time a step
LAYERS = (("fwd_bwd", "start", "release"), ("compress", "release", "chunk"),
          ("wire", "chunk", "means"), ("update", "means", "end"),
          ("step", "start", "end"))


class Span:
    """A ``record_function`` range entered and exited by hand."""

    def __init__(self, name: str):
        self.rf = torch.autograd.profiler.record_function(name)
        self.rf.__enter__()

    def close(self) -> None:
        self.rf.__exit__(None, None, None)


class Probe:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.steps: list = []
        self.cur = None
        self.open: dict = {}

    def _mark(self, name: str, first: bool = False) -> None:
        if first and name in self.cur:
            return
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = time.perf_counter()
        self.cur[name] = ev

    def begin(self) -> None:
        self.cur = {}
        self._mark("start")
        self.open[STEP_SPAN] = Span(STEP_SPAN)

    def end(self) -> None:
        """The step's last mark; the caller synchronises after it."""
        self._mark("end")
        self.open.pop(STEP_SPAN).close()
        self.steps.append(self.cur)
        self.cur = None

    def __call__(self, rank, **kw) -> None:
        # the release and the compression's mark come from the autograd
        # engine's thread, while the caller's waits in the backward
        if self.cur is None:
            return
        if "release" in kw:
            self._mark("release", first=True)
            self.open[(threading.get_ident(), COMPRESS_SPAN)] = Span(
                COMPRESS_SPAN)
        elif "chunk" in kw and "G" in kw:
            span = self.open.pop((threading.get_ident(), COMPRESS_SPAN), None)
            if span is not None:
                span.close()
            self._mark("chunk")
        elif "means" in kw:
            self._mark("means")

    def layer_ms(self, skip=()) -> dict:
        """``{layer: [ms a step]}`` over the recorded steps but those in
        ``skip`` (indices); call after the last step's synchronise."""
        out = {name: [] for name, _, _ in LAYERS}
        for i, marks in enumerate(self.steps):
            if i in skip:
                continue
            for name, a, b in LAYERS:
                if a in marks and b in marks:
                    out[name].append(_elapsed_ms(marks[a], marks[b]))
        return out


def _elapsed_ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    return float(a.elapsed_time(b))
