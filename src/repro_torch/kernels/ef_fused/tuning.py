"""Kernel backend resolution + block configuration (port of
``repro.kernels.ef_fused.tuning``).

Two backends, resolved from the DEVICE OF THE TENSOR and nothing else:

* ``cuda``  — the hand-written Hopper kernels (K1 in Triton, K1 with
  its histogram, K2 and K3 in CUDA C++) for tensors on the card;
* ``torch`` — the kernels' plain PyTorch versions, for tensors on the
  CPU.  They repeat each kernel's block structure, so the CPU path is
  the arithmetic the card runs.

There is no fallback from one to the other: a CUDA tensor launches its
kernel or raises.

Each leaf's geometry is a :class:`KernelConfig`, resolved per
``(backend, dtype, shape class)`` by the reference's ladder
(``tuning.py:22-34``):

1. explicit ``block``/``stats_block``/``bcap`` at the call site win
   (``ops._resolve`` skips the ladder);
2. else the checked-in table ``kernelconfig.<backend>.json`` beside this
   module (``REPRO_KERNELCONFIG_DIR`` names another directory), schema
   ``kernelconfig/v1``, keyed ``"cuda/<dtype>/<shape class>"`` with the
   dtype of ``g`` (``float32`` or ``bfloat16``, :data:`TABLE_DTYPES`):
   the configs the card's measurement kept (:func:`write_table`),
   written by ``python -m repro_torch.kernels.ef_fused.tuning`` on the
   card;
3. else the in-process cache of what the ladder resolved before;
4. else, on ``cuda`` and only when the caller asks (``measure=True``),
   a measured autotune over the reference's candidate grid
   (:func:`candidates`: K3's block, K1/K2's stats block and K1's
   Triton ``num_warps``), each candidate one
   ``fused_compress_ef`` timed with CUDA events, the median of 5;
5. else the heuristic:

   * ``cuda``: ``block`` the reference's Triton minimum of 4 KiB of
     operand a block (``tuning.py:228-231``: 1024 in f32, 2048 in bf16),
     ``stats_block = max(block, min(4·block, shape_class(d)))``
     (``tuning.py:261``) and K1's own ``num_warps``;
   * ``torch``: the reference's ``interpret`` heuristic — a 2048 floor
     for every dtype, at most 64 compaction blocks and at most 4 stats
     blocks (``tuning.py:219-225,247,260``) — so CPU geometry, and with
     it every staging truncation, equals the JAX reference run on the
     CPU.  The ``torch`` backend has no table and never measures.

The geometry follows the backend, so a CPU run and a card run of the
same call may stage differently: where a block selects more than its
staging width, the two keep different elements.  :func:`geometry_of`
makes a CPU run take the card's geometry, from the table or the cache
and never from a fresh measurement, for a like-for-like comparison of
the two.  It exists for that check alone (the card-vs-CPU phases of
``chip_smoke.py`` and their tests); training never sets it.

Ranks of one ``torch.distributed`` job (world > 1) must stage every
bucket row under one geometry, and a one-process ``LocalWire`` run of
the same mesh must stage as they do.  So no training or serving call
measures: a shape class missing from the table takes the deterministic
heuristic in every process, one or many.  A measurement happens only
where the caller asks for one, in a process alone (in a process group
of more than one process ``measure=True`` takes the heuristic too: a
measurement's winner may differ from rank to rank, and a broadcast
would hang wherever one rank compresses alone, as serving's publisher
on rank 0 does).  The checked-in table covers every class up to 2^30
(the port's leaves reach 2^29, jamba-1.5-large's ``embed``), so on the
card every leaf resolves from the table.

The table writer (:func:`write_table`) keeps the heuristic's config
for a class unless the grid's fastest candidate beats it by more than
the spread of repeated runs of the two, timed in alternating order: a
candidate's one 5-run median cannot tell apart configs that differ by
less than the spread between calls.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
from contextlib import contextmanager
from typing import Dict, Optional

import torch

BACKENDS = ("cuda", "torch")
ENV_TABLE_DIR = "REPRO_KERNELCONFIG_DIR"
TABLE_SCHEMA = "kernelconfig/v1"
# the dtypes of g the table pins (fused_moments.KERNEL_DTYPES)
TABLE_DTYPES = ("float32", "bfloat16")
# every shape class the table pins: 2^0 .. 2^30
TABLE_CLASSES = tuple(2 ** i for i in range(31))

# reference interpret-mode grid bounds (kept so CPU geometry matches)
MAX_INTERPRET_BLOCKS = 64
MAX_INTERPRET_STATS_BLOCKS = 4
INTERPRET_MIN_BLOCK = 2048


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One resolved configuration of the fused EF pipeline.

    ``block`` drives K3 (compaction + residual), ``stats_block`` the
    reduction K1 (and K2's plain version on the CPU: the CUDA count
    kernel's grid is its own), ``bcap_slack`` the staging-width
    multiplier of ``ops.fused_default_bcap``, ``num_warps`` K1's Triton
    launch (``None``: its own choice).  ``source`` records
    where it came from: ``heuristic``, ``table``, ``autotune`` (a
    cached config keeps its first source) or ``explicit`` (the call
    site's, ``ops._resolve``)."""
    backend: str
    block: int
    stats_block: int
    bcap_slack: float = 2.0
    num_warps: Optional[int] = None
    source: str = "heuristic"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "KernelConfig":
        """Ignores keys it does not know (the reference's
        ``num_stages``, later fields)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def resolve_backend(x: torch.Tensor) -> str:
    """``cuda`` for a tensor on the card, ``torch`` for one on the CPU;
    raises on any other device."""
    if x.device.type == "cuda":
        return "cuda"
    if x.device.type == "cpu":
        return "torch"
    raise ValueError(f"no kernel backend for device {x.device}")


def shape_class(d: int) -> int:
    """pow2 ceiling of ``d`` — shapes in the same class share a config."""
    return max(1, 1 << (int(d) - 1).bit_length()) if d > 1 else 1


def bounded_block(d: int, max_blocks: int, base: int) -> int:
    """Smallest pow2 multiple of ``base`` with ``<= max_blocks`` blocks."""
    block = base
    while d > block * max_blocks:
        block *= 2
    return block


def dtype_name(dtype) -> str:
    """The name of a torch dtype (``"float32"``, ``"bfloat16"``), or the
    name itself."""
    return dtype if isinstance(dtype, str) else str(dtype).replace(
        "torch.", "")


def min_block(backend: str, dtype="float32") -> int:
    """Smallest block of ``backend`` at ``dtype`` (the reference's
    ``min_block``, ``tuning.py:213-231``): ``torch`` the interpret floor
    of 2048 for every dtype, ``cuda`` the Triton rule of 4 KiB of
    operand a block (1024 f32, 2048 bf16)."""
    if backend == "torch":
        return INTERPRET_MIN_BLOCK
    _check(backend)
    itemsize = getattr(torch, dtype_name(dtype)).itemsize
    return 4096 // max(1, min(4, itemsize))


def choose_block(d: int, backend: str, dtype="float32") -> int:
    """Heuristic compaction (K3) block size for a ``d``-element leaf."""
    base = min_block(backend, dtype)
    if backend == "torch":
        return bounded_block(d, MAX_INTERPRET_BLOCKS, base)
    return base


def choose_stats_block(d: int, backend: str, dtype="float32") -> int:
    """Heuristic reduction (K1/K2) block size for a ``d``-element leaf."""
    base = min_block(backend, dtype)
    if backend == "torch":
        return bounded_block(d, MAX_INTERPRET_STATS_BLOCKS, base)
    return max(base, min(4 * base, shape_class(d)))


def heuristic_config(backend: str, d: int, dtype="float32") -> KernelConfig:
    return KernelConfig(backend=backend,
                        block=choose_block(d, backend, dtype),
                        stats_block=choose_stats_block(d, backend, dtype))


def _check(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"have {BACKENDS}")


_GEOMETRY: list = []   # backends whose geometry geometry_of() imposes


@contextmanager
def geometry_of(backend: str):
    """Inside the block, :func:`resolve_config` gives ``backend``'s
    geometry whatever device the tensors are on (the kernels still run
    by device: CPU tensors take the plain versions), from its table or
    the cache, never from a fresh measurement.

    For the card-vs-CPU comparison only.  The override is one
    process-wide stack, not per thread: it is not thread-safe, and
    every caller in the process sees it while the block is open."""
    _check(backend)
    _GEOMETRY.append(backend)
    try:
        yield
    finally:
        _GEOMETRY.pop()


# ---------------------------------------------------------------------------
# the checked-in table, the cache and the measured autotune
# ---------------------------------------------------------------------------

_CACHE: Dict[tuple, KernelConfig] = {}   # (table path, config key) -> cfg


def config_key(backend: str, d: int, dtype="float32") -> str:
    return f"{backend}/{dtype_name(dtype)}/{shape_class(d)}"


def clear_cache() -> None:
    """Drop the in-process cache and the parsed tables (tests)."""
    _CACHE.clear()
    _load_table.cache_clear()


def table_dir() -> str:
    return os.environ.get(ENV_TABLE_DIR, "") or os.path.dirname(
        os.path.abspath(__file__))


def table_path(backend: str = "cuda") -> str:
    return os.path.join(table_dir(), f"kernelconfig.{backend}.json")


@functools.lru_cache(maxsize=None)
def _load_table(path: str) -> tuple:
    """The table's ``(config key, KernelConfig dict)`` pairs, sorted
    (empty when there is no file); raises on another schema."""
    if not os.path.exists(path):
        return ()
    with open(path) as f:
        data = json.load(f)
    if data.get("schema") != TABLE_SCHEMA:
        raise ValueError(f"{path}: unexpected schema "
                         f"{data.get('schema')!r} (want {TABLE_SCHEMA!r})")
    return tuple(sorted((k, tuple(sorted(v.items())))
                        for k, v in data.get("configs", {}).items()))


def _table_config(path: str, key: str, backend: str
                  ) -> Optional[KernelConfig]:
    for tkey, row in _load_table(path):
        if tkey == key:
            return dataclasses.replace(KernelConfig.from_dict(dict(row)),
                                       backend=backend, source="table")
    return None


def candidates(d: int, dtype="float32") -> list:
    """The reference's candidate grid (``tuning.py:325-343``): K3 blocks
    1, 2, 4 and 8 times the dtype's minimum (:func:`min_block`: 1024 f32,
    2048 bf16) within the leaf's pow2 envelope (at least the minimum),
    K1/K2's ``stats_block = max(block, min(4·block, class))``, and
    ``num_warps`` 4 and 8."""
    base = min_block("cuda", dtype)
    hi = max(base, shape_class(d))
    out = []
    for block in (base * m for m in (1, 2, 4, 8)):
        if block > hi:
            break
        stats = max(block, min(4 * block, hi))
        out.extend(KernelConfig("cuda", block, stats, num_warps=w,
                                source="autotune") for w in (4, 8))
    return out


def _operands(d: int, seed: int = 0, dtype="float32"):
    """``(g, e, k)`` on the card: the reference's timing inputs,
    ``0.02·N(0,1)`` and ``0.01·N(0,1)`` (torch's generator, not
    jax's) drawn in f32 and cast to ``dtype`` (both operands, as the
    reference's ``_time_config`` casts them), at budget ``max(1, d //
    1000)``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dt = getattr(torch, dtype_name(dtype))
    g = torch.randn(d, generator=gen, device="cuda").mul_(0.02).to(dt)
    e = torch.randn(d, generator=gen, device="cuda").mul_(0.01).to(dt)
    return g, e, max(1, d // 1000)


def _time_config(cfg: KernelConfig, d: int, iters: int = 5, *,
                 operands=None) -> float:
    """Median ms of one ``fused_compress_ef`` at ``cfg`` on the card
    (CUDA events around each call; the first call, which compiles,
    outside the clock)."""
    from repro_torch.kernels.ef_fused.ops import fused_compress_ef
    g, e, k = operands or _operands(d)

    def run():
        return fused_compress_ef(g, e, "gaussiank", k, block=cfg.block,
                                 stats_block=cfg.stats_block,
                                 num_warps=cfg.num_warps)

    run()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def autotune_measure(d: int, timer=None, dtype="float32") -> KernelConfig:
    """Time the candidate grid once (``timer(cfg, d)``, default
    :func:`_time_config` on one set of operands of ``dtype``) and return
    the fastest, the first of equals."""
    cands = candidates(d, dtype)
    if timer is None:
        timer = functools.partial(_time_config,
                                  operands=_operands(d, dtype=dtype))
    timed = [(timer(c, d), i) for i, c in enumerate(cands)]
    return cands[min(timed)[1]]


def _world() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def resolve_config(d: int, backend: str, dtype="float32", *,
                   measure: bool = False, timer=None) -> KernelConfig:
    """The :class:`KernelConfig` of a ``d``-element leaf of ``dtype``
    (``g``'s: ``float32`` or ``bfloat16``, a torch dtype or its name) on
    ``backend`` (the innermost :func:`geometry_of` backend's, when one is
    active): the table, the cache, a measurement, the heuristic — the
    module docstring's ladder.

    ``measure=True`` measures a class missing from the table on
    ``cuda`` (tests pass a stub ``timer(cfg, d)``), but never under
    :func:`geometry_of`, on ``torch``, or in a process group of more
    than one process; by default nothing measures."""
    if _GEOMETRY:
        backend, measure = _GEOMETRY[-1], False
    _check(backend)
    key = config_key(backend, d, dtype)
    path = table_path(backend)
    hit = _CACHE.get((path, key))
    if hit is not None:
        return hit
    cfg = _table_config(path, key, backend)
    if cfg is None:
        if measure and backend == "cuda" and _world() == 1:
            cfg = autotune_measure(d, timer, dtype)
        else:
            cfg = heuristic_config(backend, d, dtype)
    _CACHE[(path, key)] = cfg
    return cfg


# ---------------------------------------------------------------------------
# the table writer (on the card)
# ---------------------------------------------------------------------------


def _same_bits(a, b) -> bool:
    """Same shape and dtype and the same bits (f32 compared as int32,
    bf16 as int16)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def hold_config(cfg: KernelConfig, g, e, k: int) -> str:
    """K1, K2 and the K3 sweep at ``cfg`` on the card against their
    plain versions on the same operands: the moments within ``1e-5·Σ|u|``
    (sum) and rtol 1e-5 (sum of squares), absmax exact; the counts, the
    staging rows, the residual and the wire pair bitwise; the pipeline's
    conservation
    ``decode + e' == g + e`` bitwise.  Raises on a difference; returns a
    summary."""
    from repro_torch.core import codec
    from repro_torch.core.compressors import gaussiank_cap
    from repro_torch.kernels.ef_fused import compact_residual as cr
    from repro_torch.kernels.ef_fused import fused_moments as fm
    from repro_torch.kernels.ef_fused import ops
    from repro_torch.kernels.ef_fused import tree_count as tc

    d = g.numel()
    sb, block, w = cfg.stats_block, cfg.block, cfg.num_warps
    k_cap = gaussiank_cap(k, d)
    bcap = ops.fused_default_bcap(k_cap, d, block, cfg.bcap_slack)
    got = fm.fused_moments(g, e, block=sb, num_warps=w)
    want = fm.fused_moments_plain(g, e, block=sb)
    sum_abs = float((g.double() + e.double()).abs().sum())
    (s, sq, mx), (ps, psq, pmx) = ([float(x) for x in t]
                                   for t in (got, want))
    if not (abs(s - ps) <= 1e-5 * sum_abs and abs(sq - psq) <= 1e-5 * psq
            and mx == pmx):
        raise AssertionError(f"{cfg}: K1 {got} against plain {want}")
    heap, n_cnt = ops._tree_thresholds(
        ops.gaussian_t0(want[0], want[1], d, k, False), 4)
    thr = torch.from_numpy(heap[:n_cnt]).to(g.device)
    cnt = tc.tree_count(g, e, thr, block=sb)
    if not torch.equal(cnt, tc.tree_count_plain(g, e, thr, block=sb)):
        raise AssertionError(f"{cfg}: K2 counts")
    t = float(ops._replay_refinement(heap, cnt.cpu().numpy(), k, 4))
    got = cr.compact_sweep(g, e, t, block=block, bcap=bcap, k_cap=k_cap)
    want = cr.compact_sweep_plain(g, e, t, block=block, bcap=bcap,
                                  k_cap=k_cap)
    for a, b, what in zip(got, want, ("values", "offsets", "counts",
                                      "residual", "wire values",
                                      "wire indices")):
        if not _same_bits(a, b):
            raise AssertionError(f"{cfg}: K3 sweep {what}")
    v, i, ne = ops.fused_compress_ef(g, e, "gaussiank", k, block=block,
                                     stats_block=sb, num_warps=w)
    if not torch.equal(codec.decode(v, i, d) + ne, g + e):
        raise AssertionError(f"{cfg}: conservation")
    return (f"K1 within tolerance, K2 and the K3 sweep bitwise, "
            f"conserves (bcap {bcap}, {int(codec.nnz(i))}/{k_cap} slots)")


ROUNDS = 5   # alternating rounds of the heuristic against the winner


def confirm(winner: KernelConfig, d: int, operands, rounds: int = ROUNDS,
            timer=None, dtype="float32") -> tuple:
    """Keep ``winner`` over the heuristic only if it is faster by more
    than the spread: ``rounds`` rounds of both (``timer(cfg, d)``,
    default one :func:`_time_config` median on ``operands``), in
    alternating order (heuristic first in even rounds, the winner
    first in odd ones); the winner stays if the heuristic's median less
    its own exceeds the larger of the two ranges of their rounds.
    Returns ``(config, record)``."""
    base = heuristic_config("cuda", d, dtype)
    if timer is None:
        timer = functools.partial(_time_config, operands=operands)
    ms = {"heuristic": [], "winner": []}
    for r in range(rounds):
        order = ("heuristic", "winner") if r % 2 == 0 else (
            "winner", "heuristic")
        for name in order:
            ms[name].append(timer(base if name == "heuristic" else winner,
                                  d))
    spread = max(max(t) - min(t) for t in ms.values())
    margin = statistics.median(ms["heuristic"]) - statistics.median(
        ms["winner"])
    record = {"heuristic_ms": ms["heuristic"], "winner_ms": ms["winner"],
              "spread_ms": spread, "margin_ms": margin}
    return (winner if margin > spread else base), record


def _run_meta() -> dict:
    """The card, its power limit and the software of this run."""
    import subprocess

    from repro_torch.launch.env import describe_env
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    return {"device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi[0] if smi else "",
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "env": describe_env()}


def write_table(path: Optional[str] = None, *, classes=TABLE_CLASSES,
                measure: bool = True, dtypes=TABLE_DTYPES) -> str:
    """Resolve every shape class of ``classes`` at every dtype of
    ``dtypes`` on the card — the grid's fastest candidate where
    :func:`confirm` keeps it, else the heuristic; the heuristic alone
    with ``measure=False`` — hold each chosen config against the plain
    versions (:func:`hold_config`), and write the table the ladder reads
    first.  The rows of the other dtypes come unchanged from the
    checked-in table (``runs`` keeps each dtype's card and software;
    the top-level ``device`` and ``nvidia_smi`` are this run's).  Needs
    a GPU."""
    from repro_torch.devices import resolve_device
    resolve_device("cuda")
    dtypes = tuple(dtype_name(dt) for dt in dtypes)
    meta = _run_meta()
    configs, timings, runs = {}, {}, {}
    old_path = table_path("cuda")
    if os.path.exists(old_path):
        with open(old_path) as f:
            old = json.load(f)
        if old.get("schema") == TABLE_SCHEMA:
            keep = {k for k in old.get("configs", {})
                    if k.split("/")[1] not in dtypes}
            configs = {k: old["configs"][k] for k in keep}
            timings = {k: v for k, v in old.get("timings_ms", {}).items()
                       if k in keep}
            runs = {dt: r for dt, r in old.get("runs", {}).items()
                    if dt not in dtypes}
            if "runs" not in old and keep:
                # a table written before the dtype axis: its run is f32's
                runs["float32"] = {n: old.get(n) for n in meta}
    for dt in dtypes:
        runs[dt] = meta
        for c in classes:
            key = config_key("cuda", c, dt)
            g, e, k = _operands(c, dtype=dt)
            cfg = heuristic_config("cuda", c, dt)
            if measure:
                ms = {}

                def timer(cand, d):
                    ms[cand] = _time_config(cand, d, operands=(g, e, k))
                    return ms[cand]

                cfg, record = confirm(autotune_measure(c, timer, dt), c,
                                      (g, e, k), dtype=dt)
                grid = [dict(block=x.block, stats_block=x.stats_block,
                             num_warps=x.num_warps, ms=t)
                        for x, t in ms.items()]
                timings[key] = {"grid": grid, **record}
            summary = hold_config(cfg, g, e, k)
            configs[key] = cfg.to_dict()
            print(f"{key}: block {cfg.block}, stats_block "
                  f"{cfg.stats_block}, num_warps {cfg.num_warps} "
                  f"({cfg.source}); {summary}", flush=True)
            if key in timings and measure:
                t = timings[key]
                for x in t["grid"]:
                    print(f"    block {x['block']:>5} stats "
                          f"{x['stats_block']:>6} warps {x['num_warps']}: "
                          f"{x['ms']:.4f} ms", flush=True)
                print(f"    heuristic {t['heuristic_ms']} ms, winner "
                      f"{t['winner_ms']} ms: margin {t['margin_ms']:.4f}, "
                      f"spread {t['spread_ms']:.4f}", flush=True)
            del g, e
            torch.cuda.empty_cache()
    path = path or os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "kernelconfig.cuda.json")
    data = {"schema": TABLE_SCHEMA, "platform": "cuda",
            "device": meta["device"], "nvidia_smi": meta["nvidia_smi"],
            "runs": runs, "configs": configs, "timings_ms": timings}
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="",
                    help="output path (default: kernelconfig.cuda.json "
                         "beside this module)")
    ap.add_argument("--heuristic", action="store_true",
                    help="write the heuristic configs instead of measuring")
    ap.add_argument("--dtype", action="append", choices=TABLE_DTYPES,
                    help="the dtypes to measure (repeatable; default all); "
                         "the other dtypes' rows are kept from the "
                         "checked-in table")
    args = ap.parse_args(argv)
    path = write_table(args.out or None, measure=not args.heuristic,
                       dtypes=tuple(args.dtype or TABLE_DTYPES))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
