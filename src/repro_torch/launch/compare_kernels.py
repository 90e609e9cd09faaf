"""Time this tree's K2 and K4b (the CUDA count kernel) against another
tree's Triton count kernel, and the K3 one sweep against the stage and
residual launches plus the staging assembly, on one card.

    git archive <commit> | tar -x -C build/parent
    PYTHONPATH=src python -m repro_torch.launch.compare_kernels \\
        [--parent build/parent] [--json compare_kernels.json]

The other tree's ``kernels/ef_fused/tree_count.py`` (the Triton count
kernel, ``launch_counts(name, g, e, thresholds, *, block, num_warps)``)
is loaded from its file; it imports this tree's ``fused_moments``
helpers.  Inputs are ``chip_smoke.py``'s at the 268,435,456-element
leaf: ``g`` and ``e`` from seed 2, ``1e-3`` and ``5e-4`` of N(0, 1),
drawn in f32 and cast (f32/f32 and bf16/bf16), the refinement tree of
their moments at ``k = d / 1000``, the table's geometry.  Every kernel
is first held bitwise against its plain version (and the other tree's
counts against this tree's); then each pair is timed in 4 rounds of
old, new, new, old (CUDA-event medians of 20 launches): the Triton K2
against the CUDA K2 with the 15 heap thresholds, the Triton K4b against
the CUDA K4b at the heap's root on ``u = g + e`` in the promoted dtype,
and the two K3 launches with ``assemble_staging`` against
``compact_sweep``, at 2^28 in both dtypes and at 2^29 in f32 (phase
11a's size).  With ``--sweep-blocks 1,2,4,8`` the sweep is also built
from this tree's source with each ``SWEEP_BLOCKS`` (selection blocks a
warp takes with one ticket) and every variant, held bitwise first, is
timed twice at 2^28 in both dtypes, in order and in reverse order.
Needs a GPU.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess


def _time_ms(fn, n: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _rounds(old, new) -> dict:
    ms = {"old": [], "new": []}
    for _ in range(4):
        for which in ("old", "new", "new", "old"):
            ms[which].append(_time_ms(old if which == "old" else new))
    return {"ms": ms, "median_old": statistics.median(ms["old"]),
            "median_new": statistics.median(ms["new"])}


def _load_parent(parent: str):
    path = os.path.join(parent, "src", "repro_torch", "kernels", "ef_fused",
                        "tree_count.py")
    spec = importlib.util.spec_from_file_location("parent_tree_count", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_bits(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def _build_variants(blocks: list) -> dict:
    """``{SWEEP_BLOCKS: loaded library}`` of this tree's
    ``compact_residual.cu`` with each value."""
    import ctypes

    from repro_torch.launch.tune_kernels import _build, _variant
    libs = _build({f"sweep{n}": _variant("compact_residual.cu",
                                         {"SWEEP_BLOCKS": n})
                   for n in blocks})
    p, f, i, ll = (ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                   ctypes.c_longlong)
    out = {}
    for n in blocks:
        lib = libs[f"sweep{n}"]
        lib.compact_sweep.argtypes = [p, p, i, i, ll, f, i, i, ll, ll, p, p,
                                      p, p, p, p, p, p]
        lib.compact_sweep.restype = i
        out[n] = lib
    return out


def _time_variants(variants, tag, g, e, thres, block, bcap, k_cap, out,
                   want) -> dict:
    """Each ``SWEEP_BLOCKS`` variant through its C entry point, bitwise
    ``want`` (the two launches and the assembly), then timed in order
    and in reverse order."""
    import torch

    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.ef_fused.fused_moments import dtype_code
    nb = -(-g.shape[0] // block)
    rows = [torch.empty_like(x) for x in want[:3]]
    pair = [torch.empty_like(x) for x in want[4:]]
    scratch = torch.empty(nb + 1, dtype=torch.int64, device=g.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib):
        return lambda: cuda_build.check(lib.compact_sweep(
            g.data_ptr(), e.data_ptr(), dtype_code(g), dtype_code(e),
            g.shape[0], thres, block, bcap, k_cap, nb,
            *(x.data_ptr() for x in rows), out.data_ptr(),
            *(x.data_ptr() for x in pair), scratch.data_ptr(), stream),
            "compact_sweep")

    for n, lib in variants.items():
        call(lib)()
        got = rows + [out] + pair
        assert all(_same_bits(a, b) for a, b in zip(want, got)), (tag, n)
    ms = {n: [] for n in variants}
    order = list(variants)
    for n in order + order[::-1]:
        ms[n].append(_time_ms(call(variants[n])))
    print(f"K3 sweep variants {tag} (SWEEP_BLOCKS: ms in order, in "
          f"reverse): " + ", ".join(f"{n}: {[round(x, 4) for x in v]}"
                                    for n, v in ms.items()), flush=True)
    return {"kernel": "K3 sweep SWEEP_BLOCKS variants", "case": tag,
            "ms": {str(n): v for n, v in ms.items()}}


def main(argv=None) -> int:
    import torch

    from repro_torch.core.compressors import gaussiank_cap
    from repro_torch.kernels.ef_fused import compact_residual as cr
    from repro_torch.kernels.ef_fused import fused_moments as fm
    from repro_torch.kernels.ef_fused import ops, tuning
    from repro_torch.kernels.ef_fused import tree_count as tc
    from repro_torch.kernels.gaussian_topk import count_gt as cg
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="build/parent",
                    help="root of the other tree (its src/repro_torch)")
    ap.add_argument("--d", type=int, default=268_435_456)
    ap.add_argument("--json", default="")
    ap.add_argument("--sweep-blocks", default="",
                    help="comma-separated SWEEP_BLOCKS variants to time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare_kernels: needs a GPU")
    old_k2 = _load_parent(args.parent)
    variants = _build_variants(
        [int(x) for x in args.sweep_blocks.split(",") if x])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    rows = []
    for d, dt in ((args.d, torch.float32), (args.d, torch.bfloat16),
                  (2 * args.d, torch.float32)):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        g = torch.randn(d, generator=gen, device="cuda").mul_(1e-3).to(dt)
        e = torch.randn(d, generator=gen, device="cuda").mul_(5e-4).to(dt)
        cfg = tuning.resolve_config(d, "cuda", dt)
        sb, block = cfg.stats_block, cfg.block
        k = max(1, d // 1000)
        s, sq, _ = fm.fused_moments(g, e, block=sb, num_warps=cfg.num_warps)
        heap, n_t = ops._tree_thresholds(ops.gaussian_t0(s, sq, d, k, False),
                                         4)
        host = heap[:n_t].copy()
        dev = torch.from_numpy(host).cuda()
        tag = f"d={d} {str(dt).replace('torch.', '')}"
        if d == args.d:
            plain = tc.tree_count_plain(g, e, dev, block=sb)
            new = tc.tree_count(g, e, host, block=sb)
            old = old_k2.launch_counts("tree_count", g, e, dev, block=sb,
                                       num_warps=cfg.num_warps)
            assert torch.equal(new, plain) and torch.equal(old, plain), tag
            r = _rounds(lambda: old_k2.launch_counts(
                "tree_count", g, e, dev, block=sb, num_warps=cfg.num_warps),
                lambda: tc.tree_count(g, e, host, block=sb))
            rows.append({"kernel": "K2 tree_count", "case": tag,
                         "old": "Triton (other tree)", "new": "CUDA", **r})
            u = g + e
            t = float(heap[0])
            t1 = torch.tensor([t], device="cuda")
            want = cg.count_gt_plain(u, t, block=sb)
            assert int(cg.count_gt(u, t, block=sb)) == int(want), tag
            assert int(old_k2.launch_counts("count_gt", u, None, t1,
                                            block=sb)[0]) == int(want), tag
            r = _rounds(lambda: old_k2.launch_counts(
                "count_gt", u, None, t1, block=sb),
                lambda: cg.count_gt(u, t, block=sb))
            rows.append({"kernel": "K4b count_gt", "case": tag,
                         "old": "Triton (other tree)", "new": "CUDA", **r})
            del u
        cnt = tc.tree_count(g, e, host, block=sb)
        thres = float(ops._replay_refinement(heap, cnt.cpu().numpy(), k, 4))
        k_cap = gaussiank_cap(k, d)
        bcap = ops.fused_default_bcap(k_cap, d, block, cfg.bcap_slack)
        out = torch.empty_like(g, dtype=fm.out_dtype(g, e))

        def two():
            v, o, c, ne = cr.compact_residual(g, e, thres, block=block,
                                              bcap=bcap, k_cap=k_cap,
                                              out=out)
            return (v, o, c, ne) + cr.assemble_staging(
                v, o, c, k_cap, block=block, out_dtype=out.dtype)

        def sweep():
            return cr.compact_sweep(g, e, thres, block=block, bcap=bcap,
                                    k_cap=k_cap, out=out)

        want = [x.clone() for x in two()]
        got = sweep()
        assert all(_same_bits(a, b) for a, b in zip(want, got)), tag
        r = _rounds(two, sweep)
        if variants and d == args.d:
            rows.append(_time_variants(variants, tag, g, e, thres, block,
                                       bcap, k_cap, out, want))
        rows.append({"kernel": "K3", "case": tag, "bcap": bcap,
                     "k_cap": k_cap, "block": block,
                     "old": "stage + residual + assemble_staging",
                     "new": "compact_sweep", **r})
        del g, e, out, want, got
        torch.cuda.empty_cache()
        for row in rows:
            if row["case"] == tag and "median_old" in row:
                print(f"{row['kernel']} {tag}: {row['old']} "
                      f"{row['median_old']:.4f} ms, {row['new']} "
                      f"{row['median_new']:.4f} ms "
                      f"(rounds {[round(x, 4) for x in row['ms']['old']]} / "
                      f"{[round(x, 4) for x in row['ms']['new']]})",
                      flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
