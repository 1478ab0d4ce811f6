"""The comparisons that decide ``correct``, and the numbers they print.

Every compared number has a limit, set in the cell's file from readings
of sound runs and of the control (``PERF.md`` gives both).  A run is
correct when every number is at or under its limit.
"""

from __future__ import annotations

import math
import statistics

import torch


def loss_gap(prog: list, ref: list, terms) -> tuple[float, str]:
    """Worst gap over the steps' ``terms`` (``[{term: value}]``), each
    against the larger of its own reference value and the median of the
    reference's values of those terms: a loss near 0 (a softplus of a large
    logit) is measured against the typical loss, not against itself."""
    worst, where = 0.0, ""
    scale = statistics.median(abs(r[t]) for r in ref for t in r
                              if t in terms)
    for k, (p, r) in enumerate(zip(prog, ref)):
        if set(p) != set(r):
            return math.inf, f"step {k}: terms {sorted(p)} vs {sorted(r)}"
        for term in (t for t in r if t in terms):
            gap = abs(p[term] - r[term]) / max(abs(r[term]), scale, 1e-30)
            if not gap <= worst:           # NaN counts as worst
                worst, where = gap, f"step {k} {term}"
    return worst, where


def leaf_gaps(prog: dict, ref: dict, skip=()) -> list:
    """Each leaf's |‖prog‖ - ‖ref‖| over max(its ‖ref‖, the median leaf's)."""
    med = statistics.median(ref.values())
    return [abs(prog[n] - r) / max(r, med, 1e-30) for n, r in ref.items()
            if n not in skip]


def norm_gap(prog: dict, ref: dict, skip=()) -> tuple[float, str]:
    """Worst leaf of |‖prog‖ - ‖ref‖| over max(‖ref‖ of the leaf, the
    median leaf's ‖ref‖); ``skip`` names leaves left out."""
    if set(prog) != set(ref):
        return math.inf, f"leaves differ: {sorted(set(prog) ^ set(ref))[:4]}"
    med = statistics.median(ref.values())
    worst, where = 0.0, ""
    for name, r in ref.items():
        if name in skip:
            continue
        gap = abs(prog[name] - r) / max(r, med, 1e-30)
        if not gap <= worst:
            worst, where = gap, name
    return worst, where


def rescaled(prog: dict, ref: dict) -> dict:
    """``prog``'s leaf norms scaled so that their total (L2 over leaves)
    equals ``ref``'s."""
    tp = math.sqrt(sum(v * v for v in prog.values()))
    tr = math.sqrt(sum(v * v for v in ref.values()))
    return {n: v * tr / max(tp, 1e-30) for n, v in prog.items()}


def leaf_sines(prog: dict, ref: dict, skip=()) -> dict:
    """{leaf: the sine of the angle between ``prog``'s tensor and
    ``ref``'s}, in float64 on ``ref``'s device; 1 where the program has no
    tensor for the leaf or either is zero.  ``skip`` names leaves left
    out."""
    out = {}
    for name, r in ref.items():
        if name in skip:
            continue
        p = prog.get(name)
        if p is None:
            out[name] = 1.0
            continue
        p = p.to(r.device, torch.float64).flatten()
        r = r.to(torch.float64).flatten()
        den = float(p.norm() * r.norm())
        if not den > 0:
            out[name] = 1.0
            continue
        cos = float(p @ r) / den
        out[name] = math.sqrt(max(0.0, 1.0 - cos * cos))
    return out


def quiet_leaves(first_grad: dict, share: float = 1e-3) -> set:
    """Leaves whose reference gradient is under ``share`` of the median
    leaf's: rounding moves them under Adam, so their change is left out."""
    med = statistics.median(first_grad.values())
    return {n for n, v in first_grad.items() if v < share * med}
