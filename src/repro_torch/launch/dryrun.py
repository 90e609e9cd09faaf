"""Dry run of every (architecture x input shape) at a mesh, on the meta
device (port of ``repro/launch/dryrun.py``): nothing is allocated, no
kernel runs, and one record a cell says what a card of the mesh would
hold, compute and send.

  python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh 4x2 [--hardware h100-sxm|tpu-v5e | --topology topo.json] \\
      [--serve-mode 2d|model-only] [--codec-dtype bfloat16] \\
      [--shard-activations] [--out dryrun.json]

The reference lowers and compiles each cell with XLA and reads the
compiled program's memory and cost analysis.  Torch compiles nothing
here, so a record is assembled from the port's own pieces:

* memory: the per-card bytes of the params (``dist.sharding`` specs over
  the model axis for training, ``serve.steps.serve_param_specs`` in
  ``--serve-mode`` for serving), the momentum and the residual row of a
  train step, the decode cache (``dist.sharding.cache_specs``), and
  ``temp_bytes``, the live bytes the call allocates
  (``launch.step_cost.count_temp_bytes`` at the per-card batch on model
  rank 0's shards; a train step rematerialised, its gradients' pack
  into the bucket row counted beside them; the record's
  ``temp_method`` says whether it was counted whole or piecewise), where
  the reference reads XLA's ``temp_size_in_bytes``;
* FLOPs: ``launch.step_cost.count_flops`` of the global batch, divided
  over the cards (the reference's per-card SPMD program); a train step
  rematerialised, as the reference lowers it (``remat=True``) and the
  trainer runs it at full width;
* collectives: the layout's closed forms (``pair_bits`` in
  ``--codec-dtype``, ``strategy_wire_pairs``, ``collective_count``): one
  card holds one of the bucket's ``M`` rows;
* the roofline (``launch.roofline``) under ``--hardware`` (default the
  H100's) or the ``--topology`` descriptor's.

Every cell counts at the reference's dtypes (its ``DTYPE``): the
config goes through :func:`_bf16` (bf16 params and activations), so
the params and the momentum (``sgd_momentum``'s ``zeros_like``) are
bf16, the residual row is :data:`RESID_DTYPE`'s 2 bytes an element
(the reference's ``resid_dtype=jnp.bfloat16``), an embeds frontend's
batch or prompt and the decode cache are bf16, and ``temp_bytes`` and
the FLOPs are counted on the bf16 config.  The wire stays the layout's
closed form (``pair_bits``: f32 values unless ``--codec-dtype``), as
the reference's ``pair_bits``.  An f32 count is
``launch.step_cost.step_cost`` called on an f32 config.  The layout's
totals are computed leaf by leaf as ``build_layout`` computes them,
without its int32 limit on the bucket's width, which a row of a model
above 2**31 parameters at a small model axis exceeds.  A record has
the reference's keys (``arch``, ``shape``, ``mesh``, ``kind``,
``compressor``, ``strategy``, ``codec_dtype``, ``serve_mode``,
``shard_activations``, ``status`` — ``OK``, ``SKIP`` or ``FAIL``
— and for ``OK`` ``chips``, ``memory``, ``collectives``,
``collective_messages``, ``roofline``, ``params_total``,
``params_active``) plus ``flops`` (the count, its method and the ops it
leaves out) and ``temp_method``, so ``benchmarks/table2_scaling.py`` reads it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback

import torch

from repro_torch.launch import topo as topo_mod

# --hardware: the card's spec, or the reference's default (parity)
HARDWARE = {"h100-sxm": topo_mod.H100_SXM, "tpu-v5e": topo_mod.DEFAULT_HW}

# the reference dry run's dtype: params, activations, the residual, an
# embeds batch and the decode cache
DTYPE = "bfloat16"
RESID_DTYPE = torch.bfloat16


def _bf16(cfg):
    """``cfg`` with bf16 params and activations (the reference's
    ``_bf16``)."""
    return dataclasses.replace(cfg, param_dtype=DTYPE,
                               activation_dtype=DTYPE)


def _layout_totals(params, model_size: int, ratio: float, spec) -> tuple:
    """``(d_row_total, k_cap_total)`` of ``build_layout(params,
    model_size, ratio, spec)``, leaf by leaf, without its int32 check."""
    from repro_torch import tree
    from repro_torch.dist.layout import leaf_plan
    d_row = k_cap = 0
    for leaf in tree.leaves(params):
        _, dr, _, kc = leaf_plan(int(leaf.numel()), model_size, ratio, spec)
        d_row += dr
        k_cap += kc
    return d_row, k_cap


def _sharded_bytes(params, specs: dict, model_size: int,
                   data_size: int = 1) -> float:
    """Per-card bytes of a tree under ``specs`` (``{path name: spec}``):
    a dim sharded over ``model`` divides by ``model_size``, one over the
    data axes by ``data_size``."""
    from repro_torch import tree
    total = 0.0
    for path, leaf in tree.flatten_with_path(params)[0]:
        div = 1
        for entry in specs[tree.path_name(path)]:
            if entry == "model":
                div *= model_size
            elif entry is not None:
                div *= data_size
        total += leaf.numel() * leaf.element_size() / div
    return total


def run_one(arch: str, shape_name: str, mesh="4x2",
            compressor: str = "gaussiank", strategy: str = "allgather",
            ratio: float = 0.001, topo=None, smoke: bool = False,
            hierarchical: bool = False, codec_dtype=None,
            serve_mode: str = "2d", shard_activations: bool = False
            ) -> dict:
    """The record of one cell (see the module docstring); ``topo``
    defaults to the H100 with the reference's default link; ``smoke``
    takes the arch's reduced variant; ``hierarchical`` promotes the
    default strategy (the reference's deprecated flag);
    ``codec_dtype`` the wire's value dtype (f32 by default);
    ``serve_mode`` the serving params' placement (``2d`` or
    ``model-only``); ``shard_activations`` sets the config's."""
    from repro_torch.configs import INPUT_SHAPES, applicable, get_config
    from repro_torch.core.compressors import get_compressor
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.layout import (BucketLayout, _dtype_name,
                                         collective_count, resolve_strategy,
                                         strategy_wire_pairs)
    from repro_torch.dist.tuner import MSGS_PER_PAIR
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import step_cost
    from repro_torch.launch.mesh import (data_axes_of, data_world_size,
                                         model_axis_size, parse_mesh)
    from repro_torch.models import init_cache, init_params
    from repro_torch.serve.steps import serve_param_specs

    strategy = resolve_strategy(strategy, hierarchical)
    topo = topology_of() if topo is None else topo
    mesh = parse_mesh(mesh)
    cfg = _bf16(get_config(arch).reduced() if smoke else get_config(arch))
    if shard_activations:
        cfg = dataclasses.replace(cfg, shard_activations=True)
    shape = INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "x".join(str(n) for n in mesh.shape), "kind": shape.kind,
           "compressor": compressor, "strategy": strategy,
           "hierarchical": strategy in ("hierarchical", "hier_gtopk"),
           "codec_dtype": _dtype_name(codec_dtype) if codec_dtype else None,
           "serve_mode": serve_mode, "shard_activations": shard_activations,
           "hardware": topo.hardware.name}
    ok, why = applicable(cfg, shape)
    if not ok:
        rec.update(status="SKIP", reason=why)
        return rec
    try:
        W, M = data_world_size(mesh), model_axis_size(mesh)
        chips = W * M
        axes = data_axes_of(mesh)
        n_pods = mesh.sizes[axes[0]] if len(axes) > 1 else 1
        params = init_params(cfg, 0, "meta")
        total_p, active_p = rl.active_params(params, cfg)
        B, S = shape.global_batch, shape.seq_len
        cost = step_cost.count_flops(cfg, B, S, kind=shape.kind,
                                     params=params, remat=True)
        flops_chip = cost["flops"] / chips
        coll, msgs = 0.0, 0.0
        memory = {}
        if shape.kind == "train":
            d_row, k_cap = _layout_totals(params, M, ratio,
                                          get_compressor(compressor))
            pbytes = _sharded_bytes(params, shd.param_specs(
                params, "model", M), M)
            psize = getattr(torch, DTYPE).itemsize
            rsize = RESID_DTYPE.itemsize
            # the momentum is zeros_like(params); one residual row a card
            memory.update(param_bytes=pbytes, momentum_bytes=pbytes,
                          resid_bytes=float(d_row * rsize))
            # a card sends its row's share of each pair: k_cap values in
            # the codec dtype and int32 indices, strategy_wire_pairs
            # times a step
            pair = BucketLayout((), M, ratio, compressor, False, d_row,
                                k_cap).pair_bits(codec_dtype)
            coll = float(strategy_wire_pairs(strategy, W, n_pods)
                         * pair / M / 8)
            msgs = float(collective_count(strategy, W, n_pods)
                         * MSGS_PER_PAIR)
            bytes_chip = step_cost.state_bytes(
                pbytes / psize, d_row, param_bytes=psize,
                bucket_bytes=rsize)["total"]
        else:
            pbytes = _sharded_bytes(params, serve_param_specs(
                params, mesh, serve_mode), M, W)
            memory.update(param_bytes=pbytes)
            bytes_chip = pbytes
            if shape.kind == "decode":
                cache = init_cache(cfg, B, S, getattr(torch, DTYPE),
                                   device="meta")
                cbytes = _sharded_bytes(cache, shd.cache_specs(
                    cache, axes, W, "model", M), M, W)
                memory.update(cache_bytes=cbytes)
                bytes_chip += cbytes
        temp = step_cost.count_temp_bytes(
            cfg, -(-B // W), S, kind=shape.kind, params=params, remat=True,
            model_size=M)
        memory["temp_bytes"] = float(temp["temp_bytes"])
        memory["total_per_device"] = sum(memory.values())
        mf_global = rl.model_flops(cfg, total_p, active_p, shape.kind, B, S)
        terms = rl.roofline_terms(flops_chip, bytes_chip, coll,
                                  mf_global / chips, hw=topo.hardware,
                                  link=topo.default_link, n_messages=msgs)
        rec.update(status="OK", chips=chips, memory=memory,
                   collectives={"total": coll},
                   collective_messages={"total": msgs},
                   flops={"total": cost["flops"], "per_chip": flops_chip,
                          "method": cost["method"],
                          "uncounted_ops": cost["uncounted_ops"]},
                   roofline=terms.to_dict(), params_total=total_p,
                   params_active=active_p, temp_method=temp["method"])
    except Exception as e:  # noqa: BLE001 — a failed cell is data
        rec.update(status="FAIL", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


def run_all(archs=None, shapes=None, mesh="4x2", **kw) -> list:
    """:func:`run_one` over ``archs`` x ``shapes`` (default all)."""
    from repro_torch.configs import INPUT_SHAPES, list_archs
    return [run_one(a, s, mesh, **kw)
            for a in (archs or list_archs())
            for s in (shapes or list(INPUT_SHAPES))]


def topology_of(hardware: str = "h100-sxm", topology: str = ""):
    """The pricing topology: a ``--topology`` descriptor, else
    ``--hardware``'s spec with the reference's default link."""
    if topology:
        return topo_mod.load_topology(topology)
    return topo_mod.Topology(hardware=HARDWARE[hardware], name=hardware)


def main(argv=None) -> int:
    from repro_torch.configs import INPUT_SHAPES, list_archs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="4x2", help="DxM or PxDxM")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced variant of each arch")
    ap.add_argument("--compressor", default="gaussiank")
    ap.add_argument("--strategy", default="allgather",
                    choices=["allgather", "gtopk", "hierarchical",
                             "hier_gtopk"])
    ap.add_argument("--hierarchical", action="store_true",
                    help="deprecated alias for --strategy hierarchical")
    ap.add_argument("--ratio", type=float, default=0.001)
    ap.add_argument("--codec-dtype", default=None,
                    help="wire dtype for codec values, e.g. bfloat16")
    ap.add_argument("--serve-mode", default="2d",
                    choices=["2d", "model-only"])
    ap.add_argument("--shard-activations", action="store_true",
                    help="keep each rematerialised period's input "
                         "model-sharded (the config's shard_activations)")
    ap.add_argument("--hardware", default="h100-sxm", choices=sorted(HARDWARE))
    ap.add_argument("--topology", default="",
                    help="JSON topology descriptor (launch/topo.py) that "
                         "prices the roofline; replaces --hardware")
    ap.add_argument("--out", default=None,
                    help="write the records here (default: write nothing)")
    args = ap.parse_args(argv)
    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    topo = topology_of(args.hardware, args.topology)
    results = []
    for arch in archs:
        for shape in shapes:
            rec = run_one(arch, shape, args.mesh, compressor=args.compressor,
                          strategy=args.strategy, ratio=args.ratio,
                          topo=topo, smoke=args.smoke,
                          hierarchical=args.hierarchical,
                          codec_dtype=args.codec_dtype,
                          serve_mode=args.serve_mode,
                          shard_activations=args.shard_activations)
            extra = ""
            if rec["status"] == "OK":
                r = rec["roofline"]
                extra = (f" dom={r['dominant']} c={r['compute_s']:.3e} "
                         f"m={r['memory_s']:.3e} n={r['collective_s']:.3e} "
                         f"mem/dev="
                         f"{rec['memory']['total_per_device'] / 2**30:.1f}GiB"
                         f" flops={rec['flops']['method']}")
            elif rec["status"] == "FAIL":
                extra = " " + rec["error"][:200]
            print(f"{arch} x {shape} x {rec['mesh']} -> {rec['status']}"
                  f"{extra}", flush=True)
            results.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    counts = {s: sum(r["status"] == s for r in results)
              for s in ("OK", "SKIP", "FAIL")}
    print(f"done: {counts['OK']} OK, {counts['SKIP']} SKIP, "
          f"{counts['FAIL']} FAIL{' -> ' + args.out if args.out else ''}")
    return 1 if counts["FAIL"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
