"""Topology descriptors for the wire cost model (port of
``repro/launch/topo.py``).

* :class:`HardwareSpec` — a card's compute model: peak FLOP/s and memory
  rate.
* :class:`LinkSpec` — an alpha-beta link model: ``alpha_s`` seconds a
  message, ``beta_Bps`` bytes a second; ``n`` messages of ``B`` bytes in
  all take ``n * alpha + B / beta``.
* :class:`Topology` — a :class:`HardwareSpec` plus one :class:`LinkSpec`
  a mesh axis (with a default for unlisted axes), loaded from a JSON
  descriptor (``--topology topo.json``) or measured by
  :func:`measure_topology` over the run's own wire.

The JSON schema is the reference's, so a descriptor written by either
package loads in the other to an equal dict::

    {"name": "my-cluster",
     "hardware": {"name": "h100-sxm", "peak_flops": 6.7e13,
                  "hbm_bw": 3.35e12},
     "links": {"pod": {"alpha_s": 1e-4, "beta_Bps": 1e9},
               "data": {"alpha_s": 1e-6, "beta_Bps": 5e10}},
     "default_link": {"alpha_s": 1e-6, "beta_Bps": 5e10}}

:data:`DEFAULT_HW` is the reference's default spec, kept only so that
the port prices a descriptor without a ``hardware`` entry as the
reference does (parity); it describes no card the port runs on.
:data:`H100_SXM` is the card's: f32 outside the tensor cores (the port
trains f32 with TF32 off) and the HBM3 rate, from NVIDIA's data sheet.
Only the stdlib is imported at module scope; torch comes in with the
``measure_*`` microbenchmarks.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = [
    "HardwareSpec", "LinkSpec", "Topology",
    "DEFAULT_HW", "DEFAULT_LINK", "DEFAULT_TOPOLOGY", "H100_SXM",
    "load_topology", "save_topology",
    "measure_hardware", "measure_topology",
]


@dataclass(frozen=True)
class HardwareSpec:
    """A card's compute model, used to price roofline terms.  The
    defaults are the reference's (parity only: see the module
    docstring)."""
    name: str = "tpu-v5e"
    peak_flops: float = 197e12   # FLOP/s
    hbm_bw: float = 819e9        # bytes/s

    def to_dict(self) -> dict:
        return {"name": self.name, "peak_flops": self.peak_flops,
                "hbm_bw": self.hbm_bw}

    @classmethod
    def from_dict(cls, d: dict) -> "HardwareSpec":
        return cls(name=str(d.get("name", "unnamed")),
                   peak_flops=float(d["peak_flops"]),
                   hbm_bw=float(d["hbm_bw"]))


@dataclass(frozen=True)
class LinkSpec:
    """alpha-beta model of one mesh axis's link: ``alpha_s`` is charged
    once a message (one collective call moves one array; a codec pair is
    two), ``beta_Bps`` is the sustained point-to-point rate.  The
    defaults are the reference's."""
    alpha_s: float = 1e-6        # seconds per message
    beta_Bps: float = 50e9       # bytes per second

    def time_s(self, n_messages: float, nbytes: float) -> float:
        """Wire seconds for ``n_messages`` totalling ``nbytes``."""
        return n_messages * self.alpha_s + nbytes / self.beta_Bps

    def to_dict(self) -> dict:
        return {"alpha_s": self.alpha_s, "beta_Bps": self.beta_Bps}

    @classmethod
    def from_dict(cls, d: dict) -> "LinkSpec":
        return cls(alpha_s=float(d["alpha_s"]),
                   beta_Bps=float(d["beta_Bps"]))


# the reference's default spec, kept for parity (see the module docstring)
DEFAULT_HW = HardwareSpec()
DEFAULT_LINK = LinkSpec()
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3
H100_SXM = HardwareSpec("h100-sxm", 67e12, 3.35e12)


@dataclass(frozen=True)
class Topology:
    """A hardware spec plus one link spec a mesh axis, stored as sorted
    ``(axis_name, LinkSpec)`` pairs so the descriptor stays hashable;
    unlisted axes take ``default_link``."""
    hardware: HardwareSpec = DEFAULT_HW
    links: Tuple[Tuple[str, LinkSpec], ...] = ()
    default_link: LinkSpec = DEFAULT_LINK
    name: str = "default"

    def link(self, axis: str) -> LinkSpec:
        for ax, spec in self.links:
            if ax == axis:
                return spec
        return self.default_link

    def link_map(self) -> Dict[str, LinkSpec]:
        return dict(self.links)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "hardware": self.hardware.to_dict(),
            "links": {ax: spec.to_dict() for ax, spec in self.links},
            "default_link": self.default_link.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Topology":
        hw = (HardwareSpec.from_dict(d["hardware"])
              if "hardware" in d else DEFAULT_HW)
        default = (LinkSpec.from_dict(d["default_link"])
                   if "default_link" in d else DEFAULT_LINK)
        links = tuple(sorted(
            (ax, LinkSpec.from_dict(spec))
            for ax, spec in d.get("links", {}).items()))
        return cls(hardware=hw, links=links, default_link=default,
                   name=str(d.get("name", "unnamed")))


DEFAULT_TOPOLOGY = Topology()


def load_topology(path: str) -> Topology:
    """Parse a JSON topology descriptor (schema in the module docstring)."""
    with open(path) as f:
        d = json.load(f)
    if not isinstance(d, dict):
        raise ValueError(f"{path}: topology descriptor must be a JSON object")
    return Topology.from_dict(d)


def save_topology(topo: Topology, path: str) -> None:
    with open(path, "w") as f:
        json.dump(topo.to_dict(), f, indent=2, sort_keys=True)
        f.write("\n")


# ---------------------------------------------------------------------------
# startup microbenchmarks (ping/ramp)
# ---------------------------------------------------------------------------

def _sync(device) -> None:
    import torch
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _process_group(wire):
    """``torch.distributed`` when ``wire`` spans processes, else None."""
    return getattr(wire, "dist", None)


def _slowest(dt: float, wire) -> float:
    """The largest of every process's ``dt`` (``dt`` itself in one
    process): a collective is as slow as its slowest rank."""
    dist = _process_group(wire)
    if dist is None:
        return dt
    import torch
    t = wire._staged(torch.tensor([dt], dtype=torch.float64))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _best_of(fn, reps: int, device=None, wire=None) -> float:
    """Least seconds of ``fn()`` over ``reps`` timed runs after one
    warm-up.  Each run ends in a synchronisation of ``device`` before the
    clock is read (a CUDA call returns before the card has done the
    work); under a process-group wire every run starts after a barrier
    and counts the slowest rank's time."""
    import time
    dist = _process_group(wire)
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        if dist is not None:
            dist.barrier()
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, _slowest(time.perf_counter() - t0, wire))
    return best


def measure_hardware(reps: int = 3, n: int = 1024, copy_mb: int = 32,
                     device="cuda") -> HardwareSpec:
    """Measure the f32 FLOP/s of an ``n x n`` matmul (TF32 off) and the
    memory rate of ``x + 1.0`` over ``copy_mb`` MiB (read plus write) on
    ``device`` (the card unless told ``"cpu"``), named ``measured-gpu``
    or ``measured-cpu``.  Crude on purpose: a CPU run prices itself as a
    CPU.  The defaults are the reference's; on the card pass a copy of at
    least 1024 MiB and ``n`` of several thousand: the default copy reads
    and writes 64 MiB, which half fits the H100's 50 MB L2, so its rate
    reads above the HBM's, and a 1024-square matmul times its launch."""
    import torch

    from repro_torch.devices import resolve_device
    device = resolve_device(device)
    cuda = device.type == "cuda"
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a = torch.ones((n, n), dtype=torch.float32, device=device)
        t_mm = _best_of(lambda: a @ a, reps, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    peak = 2.0 * n ** 3 / max(t_mm, 1e-9)
    del a
    words = copy_mb * (1 << 20) // 4
    buf = torch.ones((words,), dtype=torch.float32, device=device)
    t_cp = _best_of(lambda: buf + 1.0, reps, device)
    hbm = 2.0 * words * 4 / max(t_cp, 1e-9)   # read + write
    return HardwareSpec(name=f"measured-{'gpu' if cuda else 'cpu'}",
                        peak_flops=peak, hbm_bw=hbm)


def _axis_ring_time(wire, axis: str, nbytes: int, rounds: int, reps: int,
                    device) -> float:
    """Seconds a ring-shift round of ``nbytes`` along ``axis`` takes:
    ``rounds`` chained ``wire.ppermute`` calls, each a completed call
    that sends what the last one received (so no two can merge), minus
    the same with zero rounds, divided out.  The subtraction keeps the
    call's own overhead (the payload's creation, the synchronisation)
    out of alpha."""
    import torch

    n = wire.mesh.sizes[axis]
    if n < 2:
        return 0.0
    words = max(1, nbytes // 4)
    perm = [(j, (j + 1) % n) for j in range(n)]

    def run(r):
        def body():
            xs = [torch.ones((words,), dtype=torch.float32, device=device)
                  for _ in range(wire.local_workers)]
            for _ in range(r):
                xs = wire.ppermute(xs, axis, perm)
            return [x * 1.0 for x in xs]
        return body

    times = [_best_of(run(r), reps, device, wire) for r in (0, rounds)]
    return max(0.0, times[1] - times[0]) / rounds


def measure_topology(mesh, wire, *, small_bytes: int = 1 << 12,
                     large_bytes: int = 1 << 22, rounds: int = 8,
                     reps: int = 3,
                     hardware: Optional[HardwareSpec] = None,
                     device="cuda") -> Topology:
    """Ping/ramp microbenchmark over ``wire``'s data axes.

    For each data axis, times a small (``small_bytes``, latency-bound)
    and a large (``large_bytes``, bandwidth-bound) ring round and solves
    the alpha-beta model::

        t(S) = alpha + S/beta ;  t(L) = alpha + L/beta
        beta = (L - S) / (t_L - t_S) ;  alpha = t_S - S/beta

    Axes of size 1 keep :data:`DEFAULT_LINK`, and so does an axis whose
    large round is not slower than its small one.  Under ``LocalWire``
    every worker is in this process and ``ppermute`` is a reindexing: no
    byte crosses a link, a timing would read noise, so every axis keeps
    :data:`DEFAULT_LINK` untimed — the honest answer, not a cost.  Real links
    come from ``ProcessGroupWire`` (NCCL, or gloo staged through the
    host), where every rank runs this together and takes rank 0's
    result, so all reach the same decision.  ``hardware`` defaults to
    :func:`measure_hardware` on ``device`` (a 1024 MiB copy and an
    8192-square matmul on the card, the reference's sizes on the CPU)."""
    from repro_torch.devices import resolve_device
    from repro_torch.launch.mesh import data_axes_of

    device = resolve_device(device)
    if hardware is None:
        hardware = (measure_hardware(reps, 8192, 1024, device)
                    if device.type == "cuda"
                    else measure_hardware(reps, device=device))
    links = []
    dist = _process_group(wire)
    for axis in data_axes_of(mesh):
        if dist is None:
            # LocalWire: a reindexing in this process, no link to time
            links.append((axis, DEFAULT_LINK))
            continue
        t_s = _axis_ring_time(wire, axis, small_bytes, rounds, reps, device)
        t_l = _axis_ring_time(wire, axis, large_bytes, rounds, reps, device)
        if t_l <= t_s:
            # degenerate timing (noise swamped the ramp): keep the default
            links.append((axis, DEFAULT_LINK))
            continue
        beta = (large_bytes - small_bytes) / (t_l - t_s)
        alpha = max(0.0, t_s - small_bytes / beta)
        links.append((axis, LinkSpec(alpha_s=alpha, beta_Bps=beta)))
    topo = Topology(hardware=hardware, links=tuple(sorted(links)),
                    name="measured")
    if dist is not None:
        box = [topo.to_dict()]
        dist.broadcast_object_list(box, src=0)
        topo = Topology.from_dict(box[0])
    return topo
