"""The comparison that decides ``correct``: the program's first steps
against the plain reference's, from the same weights and raw batches.

Six numbers; the cell's file gives each a limit, or null where the
number is not compared (it is then printed beside no limit):

- ``loss_gap``: the largest |loss_p - loss_r| / |loss_r| over the steps;
- ``loss1_gap``: the same at the first step alone, which no update has
  touched yet;
- ``grad_gap``: over the leaves, the largest gap between the norms of
  the program's and the reference's step-1 gradient, |n_p - n_r|, over
  the larger of the reference's norm of that leaf and of the median
  leaf;
- ``leaf_grad_gap``: the same gap over the reference's norm of that
  leaf alone, over the leaves of more than one element (a one-element
  leaf's gradient is one sum over the batch, whose terms may cancel far
  below their size, so its own norm is no scale for its rounding);
- ``grad_median_gap``: the median over the leaves of that gap over the
  leaf's own norm. The worst leaf's gap swings from seed to seed where
  bf16 towers take their inputs from f32 sums: a change in the order of
  those sums alone (the reference with its attention pools summed in
  float64) moves DIN's worst leaf as far as the program does, up to
  8e-3 in sound runs, while the median leaf stays near 1e-4;
- ``change_gap``: the gap of each leaf's change after the steps, as
  ``grad_gap`` takes it; every leaf counts, so a leaf that the program
  leaves unmoved or moves twice reads about 1."""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

NUMBERS = ("loss_gap", "loss1_gap", "grad_gap", "leaf_grad_gap", "grad_median_gap", "change_gap")


def _leaf_gap(p: Dict[str, float], r: Dict[str, float], names, own: bool = False) -> Tuple[float, str]:
    """The worst leaf's |p - r| over max(r, the median leaf's r), or over
    r alone when ``own``."""
    med = 0.0 if own or not names else statistics.median(r[n] for n in names)
    worst, which = 0.0, ""
    for n in names:
        if n not in p:
            return math.inf, n
        den = max(r[n], med)
        gap = abs(p[n] - r[n]) / den if den > 0 else (0.0 if p[n] == 0 else math.inf)
        if not gap <= worst:  # NaN counts as the worst
            worst, which = gap, n
    return worst, which


def _median_gap(p: Dict[str, float], r: Dict[str, float], names) -> Tuple[float, str]:
    """The median leaf's |p - r| / r (NaN counts as infinite), and that
    leaf (the upper middle one of an even count)."""
    own = []
    for n in names:
        if n not in p:
            return math.inf, n
        gap = abs(p[n] - r[n]) / r[n] if r[n] > 0 else (0.0 if p[n] == 0 else math.inf)
        own.append((gap if gap == gap else math.inf, n))
    if not own:
        return math.inf, ""
    own.sort()
    return statistics.median(g for g, _ in own), own[len(own) // 2][1]


def gaps(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """{number: (value, where)} for the six numbers."""
    losses = [abs(a - b) / abs(b) if b else abs(a - b) for a, b in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]):
        losses.append(math.inf)
    worst = max(range(len(losses)), key=lambda i: losses[i] if losses[i] == losses[i] else math.inf)
    leaves = sorted(ref["grad"])
    many = [n for n in leaves if ref["numel"][n] > 1]
    return {
        "loss_gap": (losses[worst], f"step {worst + 1}"),
        "loss1_gap": (losses[0], "step 1"),
        "grad_gap": _leaf_gap(prog["grad"], ref["grad"], leaves),
        "leaf_grad_gap": _leaf_gap(prog["grad"], ref["grad"], many, own=True),
        "grad_median_gap": _median_gap(prog["grad"], ref["grad"], leaves),
        "change_gap": _leaf_gap(prog["change"], ref["change"], sorted(ref["change"])),
    }


def judge(values: Dict[str, Tuple[float, str]], limits: Dict) -> Tuple[bool, List]:
    """(correct, [(number, value, limit, where)]): correct when every
    compared number lies at or under its limit. A number the cell's file
    does not name fails, and so does a cell that compares none: no cell
    is correct by default. A number named with a null limit is not
    compared (limit None in its row)."""
    rows, ok = [], any(limits.get(n) is not None for n in NUMBERS)
    for name in NUMBERS:
        value, where = values[name]
        limit = limits.get(name)
        if name not in limits or (limit is not None and not value <= limit):
            ok = False
        rows.append((name, value, limit, where))
    return ok, rows
