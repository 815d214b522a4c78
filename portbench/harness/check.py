"""The comparison that decides ``correct``: the numbers a path compares
with the plain reference, each against its limit from
``limits/<cell>.json``."""
from __future__ import annotations

import json
import statistics
from pathlib import Path

import numpy as np

LIMITS = Path(__file__).resolve().parent.parent / "limits"
# a leaf whose reference gradient lies under this share of the median
# leaf's moves under Adam by round-off alone: left out of the change
STILL_LEAF = 1e-3


def load_limits(cell: str) -> dict:
    return json.loads((LIMITS / f"{cell}.json").read_text())["limits"]


def norm_gap(prog: dict, ref: dict, keep=None) -> tuple:
    """(worst gap, its leaf): per leaf |norm_prog - norm_ref| over the
    larger of the reference leaf's norm and the median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    worst, at = 0.0, None
    for k in names:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if not np.isfinite(gap):
            gap = float("inf")
        if at is None or gap > worst:
            worst, at = gap, k
    return worst, at


def moving_leaves(grad_norms: dict) -> set:
    """The leaves whose reference gradient is not nought to rounding."""
    med = statistics.median(grad_norms.values())
    return {k for k, v in grad_norms.items() if v >= STILL_LEAF * med}


def map_gap(prog: dict, ref: dict) -> tuple:
    """(widest gap, its map) over every map both sides give: the largest
    absolute difference over the larger of 1 and the map's largest
    reference magnitude; for a boolean map the share of rays that
    differ. A missing or non-finite map reads infinite."""
    worst, at = 0.0, None
    for k, r in ref.items():
        p = prog.get(k)
        if p is None or np.shape(p) != np.shape(r):
            return float("inf"), k
        r = np.asarray(r)
        p = np.asarray(p)
        if r.dtype == bool:
            gap = float(np.mean(p != r))
        else:
            r64, p64 = r.astype(np.float64), p.astype(np.float64)
            if not np.all(np.isfinite(p64)):
                return float("inf"), k
            gap = float(np.max(np.abs(p64 - r64), initial=0.0)
                        / max(1.0, float(np.max(np.abs(r64), initial=0.0))))
        if at is None or gap > worst:
            worst, at = gap, k
    return worst, at


def verdict(numbers: list) -> bool:
    """Every number (name, value, limit) at or under its limit."""
    return all(np.isfinite(v) and v <= lim for _, v, lim in numbers)
