"""One profiler window over a few steps, reduced to what the per-layer
readers need: the device's busy time against the window's wall time,
the host's synchronising calls, the device time of the kernels launched
inside the compression's span (by the span they were launched in, never
by name) and the ``breakdown``.

The trace is ``torch.profiler``'s chrome trace, written to ``TMPDIR``,
read and deleted.  A kernel is tied to the host call that launched it
by its correlation id (runtime or driver API); a kernel whose launch is
not in the trace falls back to the device-side copy of the span
(``gpu_user_annotation``), where the profiler records one."""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

from perfbench.bench.probe import COMPRESS_SPAN, STEP_SPAN, SYNC_SPAN

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize", "cuMemcpyDtoH_v2")
TOP = 10


def profiler(device):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False)


def export_events(prof, rank: int) -> list:
    fd, path = tempfile.mkstemp(prefix=f"pb_trace_{rank}_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def reduce_trace(events: list, steps: int) -> dict:
    """``{busy_s, window_s, syncs_per_step, compress_device_s,
    compress_kernels, unattributed, device_ops, idle_gaps}`` of a
    profiler window of ``steps`` train steps (each inside a
    ``pb.step`` range, followed by the harness's ``pb.sync``)."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    by_cat = collections.defaultdict(list)
    for e in xs:
        by_cat[e.get("cat", "")].append(e)
    ann = by_cat["user_annotation"]
    step_spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in ann
                        if e["name"] == STEP_SPAN)
    sync_spans = [(e["ts"], e["ts"] + e["dur"]) for e in ann
                  if e["name"] == SYNC_SPAN]
    if not step_spans:
        return {}
    lo = step_spans[0][0]
    hi = max([b for _, b in sync_spans] + [step_spans[-1][1]])
    dev = [e for c in DEVICE_CATS for e in by_cat[c]]
    busy = _union(_clip([(e["ts"], e["ts"] + e["dur"]) for e in dev], lo,
                        hi))
    busy_us = sum(b - a for a, b in busy)

    # host syncs inside the steps, the harness's own sync excluded
    def inside(t, spans):
        return any(a <= t <= b for a, b in spans)
    syncs = sum(1 for c in LAUNCH_CATS for e in by_cat[c]
                if e["name"].split("_ptsz")[0] in SYNC_CALLS
                and inside(e["ts"], step_spans)
                and not inside(e["ts"], sync_spans))

    # kernels launched inside the compression's span, by correlation
    launches = {}
    for c in LAUNCH_CATS:
        for e in by_cat[c]:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    spans = collections.defaultdict(list)
    for e in ann:
        if e["name"] == COMPRESS_SPAN:
            spans[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
    gpu_spans = [(e["ts"], e["ts"] + e["dur"])
                 for e in by_cat["gpu_user_annotation"]
                 if e["name"] == COMPRESS_SPAN]
    comp_us, comp_n, unattributed = 0.0, 0, 0
    for e in by_cat["kernel"]:
        if not lo <= e["ts"] <= hi:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            hit = inside(launch["ts"], spans.get(launch["tid"], ()))
        else:
            unattributed += 1
            hit = inside(e["ts"], gpu_spans)
        if hit:
            comp_us += e["dur"]
            comp_n += 1

    ops = collections.Counter()
    for e in dev:
        if lo <= e["ts"] <= hi:
            ops[e["name"][:120]] += e["dur"] * 1e-6
    gaps = collections.Counter()
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"])
                   for c in HOST_CATS for e in by_cat[c]
                   if not e["name"].startswith("pb.")), key=lambda h: h[0])
    mine = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in ann
            if e["name"].startswith("pb.")]
    starts = [h[0] for h in host]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps[_host_label(host, starts, mine, a)] += (b - a) * 1e-6
    return {"busy_s": busy_us * 1e-6, "window_s": (hi - lo) * 1e-6,
            "steps": steps, "syncs_per_step": syncs / max(steps, 1),
            "compress_device_s": comp_us * 1e-6,
            "compress_kernels": comp_n, "unattributed": unattributed,
            "device_ops": [[n, s] for n, s in ops.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(TOP)]}


def _host_label(host, starts, mine, t) -> str:
    """What the host was doing at ``t``: the benchmark's innermost span,
    and the innermost operation or runtime call then running (looked for
    among the last few thousand to start)."""
    spans = [h for h in mine if h[0] <= t <= h[1]]
    span = min(spans, key=lambda h: h[1] - h[0])[2] if spans else "host"
    i = bisect.bisect_right(starts, t)
    ops = [h for h in host[max(0, i - 4000):i] if h[1] >= t]
    if not ops:
        return span
    return span + " / " + min(ops, key=lambda h: h[1] - h[0])[2][:80]
