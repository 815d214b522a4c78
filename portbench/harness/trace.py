"""The traced span of a ``--trace 1`` run: a few whole steps or chunks
inside the window under ``torch.profiler``, reduced to what the per-layer
metrics read.

- busy: the union of the device's operation intervals (kernels, copies,
  sets) inside the span, so that overlapping kernels count once;
- wall: the span's own length on the profiler's clock, from its first
  launch to the synchronize that ends it;
- launches: kernels (not copies or sets) run in the span;
- per kernel name, device seconds; K1 (``row_gather*``) and K2
  (``row_scatter_add*``) apart;
- per range of the program (``record_function``), the device time of the
  kernels launched inside it;
- the longest idle gaps, each named by the host operation that was running
  at its middle.
"""
from __future__ import annotations

from collections import defaultdict

import torch

SPAN = "portbench_span"
# the program's record_function ranges (train/step.py, render/*.py)
RANGES = ("forward", "backward", "adam", "primary", "derived_normals",
          "brdf_render", "bake", "secondary_march", "app_stage_global",
          "visibility", "all_reduce")
K1, K2 = "row_gather", "row_scatter_add"
# the profiler's own work on the host: not what the program was doing
PROFILER_OPS = ("Activity Buffer Request",)


def _device_time(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _is_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def profile_span(run_units, n_units: int) -> dict:
    """Run ``run_units(n_units)`` (whole steps or chunks; the device
    drained before and after) under the profiler; returns the reduction."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            rays = run_units(n_units)
            torch.cuda.synchronize()
    red = reduce_events(prof.events(), prof.key_averages())
    red.update(units=n_units, rays=rays)
    return red


def reduce_events(events, averages) -> dict:
    cpu = [e for e in events if not _is_device(e)]
    span = [e for e in cpu if e.name == SPAN]
    if not span:
        raise RuntimeError("the profiler recorded no span")
    s0, s1 = span[0].time_range.start, span[0].time_range.end
    names = set(RANGES) | {SPAN} | {
        e.name for e in cpu if getattr(e, "is_user_annotation", False)}
    dev = [e for e in events if _is_device(e) and e.name not in names
           and e.time_range.end > e.time_range.start]
    if not dev:
        raise RuntimeError("the profiler recorded no device operation: "
                           "the card was not traced")
    iv = sorted((e.time_range.start, e.time_range.end) for e in dev)
    merged = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_us = sum(b - a for a, b in merged)
    first = min(s0, merged[0][0])
    last = max(s1, merged[-1][1])
    wall_us = last - first
    gaps = [(merged[0][0] - first, first, merged[0][0])]
    gaps += [(b2 - a1, a1, b2) for (_, a1), (b2, _) in zip(merged, merged[1:])]
    gaps.append((last - merged[-1][1], merged[-1][1], last))
    gaps = sorted((g for g in gaps if g[0] > 0), reverse=True)[:10]
    host_ops = [e for e in cpu
                if e.name not in names and e.name not in PROFILER_OPS]
    idle = [[_host_at(host_ops, 0.5 * (a + b)), g / 1e6] for g, a, b in gaps]

    by_name = defaultdict(float)
    launches = 0
    k_us = {K1: 0.0, K2: 0.0}
    for e in dev:
        d = e.time_range.end - e.time_range.start
        by_name[e.name[:120]] += d
        if not e.name.startswith(("Memcpy", "Memset")):
            launches += 1
        for k in k_us:
            if k in e.name:
                k_us[k] += d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    ranges = defaultdict(float)
    for a in averages:
        if a.key in RANGES and not _is_device(a):
            ranges[a.key] += _device_time(a) / 1e3
    return {"busy_s": busy_us / 1e6, "wall_s": wall_us / 1e6,
            "launches": launches, "k1_ms": k_us[K1] / 1e3,
            "k2_ms": k_us[K2] / 1e3, "range_ms": dict(ranges),
            "device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": idle}


def _host_at(host_ops, t: float) -> str:
    """The innermost host operation running at ``t`` (the one that started
    last among those that cover it)."""
    best = None
    for e in host_ops:
        r = e.time_range
        if r.start <= t <= r.end and (best is None
                                      or r.start > best.time_range.start):
            best = e
    return best.name[:120] if best is not None else "host between operations"


class RowBounds:
    """While active, each launch of K1 and K2 adds its least time at the
    HBM rate to ``ms`` (``bounds.gather_bound_ms`` /
    ``bounds.scatter_bound_ms``). Wraps the port's call sites: the module
    functions ``gather_rows`` and the backward call, and the name
    ``models.field`` imports."""

    def __init__(self):
        self.ms = {K1: 0.0, K2: 0.0}
        self.launches = {K1: 0, K2: 0}

    def __enter__(self):
        from portbench.harness import bounds
        from tensoir_tpu_torch.kernels import rows
        from tensoir_tpu_torch.models import field as field_mod
        self._mods = (rows, field_mod)
        self._orig = (rows.row_gather, rows.row_scatter_add)
        gather, scatter = self._orig

        def counted_gather(table, idx):
            if idx.numel():
                self.ms[K1] += bounds.gather_bound_ms(
                    idx, table.shape[1] * table.element_size())
                self.launches[K1] += 1
            return gather(table, idx)

        def counted_scatter(idx, val, num_rows):
            if idx.numel() and val.shape[1]:
                self.ms[K2] += bounds.scatter_bound_ms(
                    idx, val.shape[1] * val.element_size())
                self.launches[K2] += 1
            return scatter(idx, val, num_rows)

        rows.row_gather = field_mod.row_gather = counted_gather
        rows.row_scatter_add = counted_scatter
        return self

    def __exit__(self, *exc):
        rows, field_mod = self._mods
        rows.row_gather = field_mod.row_gather = self._orig[0]
        rows.row_scatter_add = self._orig[1]
        return False
