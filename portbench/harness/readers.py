"""What the metric readers of ``metrics/`` share. Each takes the run's
context (``main.run_cell``) and returns a number, or None where the run
has nothing to read (the metric is then left out of the line)."""
from __future__ import annotations

from portbench.harness.bounds import F32_FLOPS_PER_S


def window_rate(ctx) -> float:
    """Camera rays completed over the whole window, per second."""
    w = ctx["window"]
    return w["rays"] / w["seconds"]


def mfu_pct(ctx) -> float:
    """The model's operations over the window (``harness/flops.py``, from
    each unit's surface rays), less its traced span and counted unit, per
    second of the host's clock, against the float32 peak."""
    w = ctx["window"]
    seconds = w["seconds"] - w.get("traced_s", 0.0)
    return ctx["flops"] / seconds / F32_FLOPS_PER_S * 100.0


def range_ms(ctx, names, per_krays: bool):
    """Device ms of the kernels launched inside the first of the program's
    ranges ``names`` the span recorded: per step, or per 1,000 camera
    rays."""
    span = ctx["span"]
    for name in names:
        if span["range_ms"].get(name):
            ms = span["range_ms"][name]
            return (ms / span["rays"] * 1e3 if per_krays
                    else ms / span["units"])
    return None


def roofline_pct(ctx, kernel: str):
    """Sum of the kernel's least times over one counted step or chunk, over
    its device time per step or chunk in the span."""
    span, b = ctx["span"], ctx["bounds"]
    dev_ms = span[f"{kernel}_ms"] / span["units"]
    if not dev_ms or not b[f"{kernel}_launches"]:
        return None
    return b[f"{kernel}_ms"] / dev_ms * 100.0


def launches(ctx, per_krays: bool) -> float:
    span = ctx["span"]
    return (span["launches"] / span["rays"] * 1e3 if per_krays
            else span["launches"] / span["units"])


def idle_pct(ctx) -> float:
    span = ctx["span"]
    return (1.0 - span["busy_s"] / span["wall_s"]) * 100.0


def busy_ms(ctx, per_krays: bool) -> float:
    """Device-busy ms (the union of operation intervals) per step or per
    1,000 camera rays: the host's speed does not move it."""
    span = ctx["span"]
    ms = span["busy_s"] * 1e3
    return ms / span["rays"] * 1e3 if per_krays else ms / span["units"]
