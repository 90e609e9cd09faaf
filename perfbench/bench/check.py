"""The comparison that decides ``correct``: the program's first steps
against the reference's, from the same weights and batches.

Numbers compared, each against the limit of the workload's limits file:

- ``loss``: the largest gap of the three steps' losses, over the
  reference's loss;
- ``grad``: the worst leaf's gap between the norms of the first step's
  mean as the optimizer takes it (its momentum after one step);
- ``resid``: the worst leaf's gap between the norms of the first step's
  new residual;
- ``update``: the worst leaf's gap between the norms of the change
  after the three steps;
- ``update_median``: the median leaf's gap of that change, steady where
  one leaf's threshold refinement may take another branch on either
  side by round-off at a later step.

A cell compares the numbers its limits file names.  On several workers
each number is the worst worker's.

A leaf's gap is ``|a - b|`` over the larger of the reference's norm of
that leaf and of the median leaf.  The change leaves out the leaves
whose first dense gradient in the reference is under a thousandth of
the median leaf's: those move by round-off alone."""
from __future__ import annotations

import math
import statistics

NUMBERS = ("loss", "grad", "resid", "update", "update_median")
MOVES = 1e-3


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Every leaf's gap, in the reference's order."""
    med = statistics.median(ref[n] for n in ref)
    gaps = {}
    for n in ref:
        if keep is not None and n not in keep:
            continue
        den = max(ref[n], med)
        gaps[n] = abs(prog[n] - ref[n]) / den if den > 0 else (
            0.0 if prog[n] == 0 else float("inf"))
    return gaps


def leaf_gap(prog: dict, ref: dict, keep=None):
    """``(gap, leaf)`` of the worst leaf."""
    worst, at = 0.0, None
    for n, gap in leaf_gaps(prog, ref, keep).items():
        if at is None or gap > worst:
            worst, at = gap, n
    return worst, at


def numbers(prog: dict, ref: dict) -> dict:
    """``{name: (value, detail)}`` of one worker's readings."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                    ref["loss"]))
    med = statistics.median(ref["dense"].values())
    keep = {n for n, v in ref["dense"].items() if v >= MOVES * med}
    out = {"loss": (loss, "")}
    for name in ("grad", "resid"):
        out[name] = leaf_gap(prog[name], ref[name])
    out["update"] = leaf_gap(prog["update"], ref["update"], keep)
    gaps = list(leaf_gaps(prog["update"], ref["update"], keep).values())
    out["update_median"] = (math.nan if any(map(math.isnan, gaps))
                            else statistics.median(gaps), "")
    return out


def worst(every: list, name: str):
    """``(value, detail)`` of ``name`` from the worker that reads it
    largest (a NaN counts as the largest); ``every`` holds each worker's
    :func:`numbers`."""
    return max((e[name] for e in every),
               key=lambda x: math.inf if math.isnan(x[0]) else x[0])


def judge(values: dict, limits: dict):
    """``(correct, lines)``: every number that ``limits`` names at or
    under its limit; a line a number compared, with its limit."""
    ok, lines = True, []
    for name in NUMBERS:
        lim = limits.get(name)
        if lim is None:
            continue
        v = values[name]
        if not v <= lim:
            ok = False
        lines.append((name, v, lim))
    return ok, lines
